"""Task construction and the ``train`` entry point (the port's ``training.py``).

``train(config)`` builds the data, the partitions, the model and the engine
the way the JAX package's ``_build_task`` does, then runs the FedAvg
session.  It runs on CUDA unless ``device="cpu"`` is passed (or set in the
config), and raises where no GPU is visible.  Methods other than
``fed_avg`` and executors other than the SPMD session raise
``NotImplementedError``: they are later slices of the port (ROADMAP.md).
"""

import copy
import math

import torch

from .config import DistributedTrainingConfig
from .data import create_dataset_collection
from .engine.engine import ComputeEngine
from .engine.hyper_parameter import HyperParameter
from .ml_type import MachineLearningPhase as Phase
from .models import create_model_context
from .parallel.spmd import SpmdFedAvgSession
from .practitioner import create_practitioners
from .utils.device import resolve_device
from .utils.logging import add_file_handler, get_logger

#: model_kwargs that select a multi-device layout in the JAX package
_LAYOUT_KWARGS = ("sequence_parallel", "expert_parallel", "pipeline_stages")


def _refuse_unported(config: DistributedTrainingConfig) -> None:
    if config.distributed_algorithm != "fed_avg":
        raise NotImplementedError(
            f"method {config.distributed_algorithm!r} is not ported yet (ROADMAP.md);"
            " the port runs fed_avg"
        )
    if str(config.executor or "auto") not in ("auto", "spmd"):
        raise NotImplementedError(
            f"executor {config.executor!r} is not ported yet; the port runs the"
            " SPMD FedAvg session (executor auto or spmd)"
        )
    layouts = [k for k in _LAYOUT_KWARGS if int(config.model_kwargs.get(k, 0) or 0) > 1]
    refused = {
        "model_kwargs": layouts,
        "fault_tolerance": bool(config.fault_tolerance),
        "telemetry": bool(dict(config.telemetry).get("enabled")),
        "profile": config.profile,
        "watchdog_seconds": bool(config.watchdog_seconds),
    }
    named = [k for k, v in refused.items() if v]
    if named:
        raise NotImplementedError(f"{named} are not ported yet (ROADMAP.md)")


def build_session(
    config: DistributedTrainingConfig, practitioners=None, device: str | None = None
) -> SpmdFedAvgSession:
    """The JAX package's ``_build_task`` + ``_make_spmd_session``: data,
    partitions, model and engine, staged on the device, ready to ``run``."""
    config = copy.deepcopy(config)
    if device is not None:
        config.device = device
    target = resolve_device(config.device)
    _refuse_unported(config)
    if not config.save_dir:
        config.load_config_and_process()
    if config.log_file:
        add_file_handler(config.log_file)

    dataset_collection = create_dataset_collection(config)
    if practitioners is None:
        practitioners = create_practitioners(config, dataset_collection)
    if len(practitioners) != config.worker_number:
        raise ValueError(f"{len(practitioners)} practitioners for {config.worker_number} workers")
    model_kwargs = {k: v for k, v in config.model_kwargs.items() if k not in _LAYOUT_KWARGS}
    model_ctx = create_model_context(
        config.model_name, dataset_collection, device=target, **model_kwargs
    )
    if config.use_amp:
        # bf16 compute; the master stays f32 and is cast once per round
        model_ctx.compute_dtype = torch.bfloat16
    train_size = dataset_collection.dataset_size(Phase.Training)
    steps_per_epoch = max(1, math.ceil(train_size / config.worker_number / config.batch_size))
    engine = ComputeEngine(
        model_ctx,
        HyperParameter.from_config(config),
        total_steps=steps_per_epoch * config.epoch,
    )
    return SpmdFedAvgSession(config, dataset_collection, model_ctx, engine, practitioners)


def train(
    config: DistributedTrainingConfig, practitioners=None, device: str | None = None
) -> dict:
    """Run one FedAvg task; returns ``{"performance": {round: row}}``."""
    session = build_session(config, practitioners, device)
    result = session.run()
    get_logger().info(
        "training done on %s (%d rounds)", session.device, len(result["performance"])
    )
    return result
