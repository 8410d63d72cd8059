"""Config system: the port's copy of ``distributed_learning_simulator_tpu.config``.

It loads the same ``conf/<algo>/<dataset>.yaml`` files merged over
``conf/global.yaml``, with hydra-style ``++key=value`` dotted overrides and
the single-key-nesting unwrap (``++fed_avg.round=1``).  The fields are the
JAX package's, so every YAML of the tree loads the same way, plus
``device`` (``"cuda"`` by default; ``"cpu"`` runs the kernels' plain
versions).
"""

import dataclasses
import datetime
import os
import uuid
from typing import Any

import yaml

from .utils.logging import get_logger, set_level

CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")


@dataclasses.dataclass
class DistributedTrainingConfig:
    # dataset / model
    dataset_name: str = ""
    model_name: str = ""
    dataset_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    model_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    # hyper parameters
    optimizer_name: str = "SGD"
    batch_size: int = 64
    epoch: int = 1
    learning_rate: float = 0.01
    learning_rate_scheduler_name: str = "CosineAnnealingLR"
    momentum: float = 0.9
    weight_decay: float = 0.0
    use_amp: bool = False
    extra_hyper_parameters: dict[str, Any] = dataclasses.field(default_factory=dict)
    # federated fields
    distributed_algorithm: str = ""
    worker_number: int = 1
    parallel_number: int = 0
    round: int = 1
    dataset_sampling: str = "iid"
    dataset_sampling_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    distribute_init_parameters: bool = True
    limited_resource: bool = False
    endpoint_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    algorithm_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    exp_name: str = ""
    log_file: str = ""
    # global flags (conf/global.yaml)
    cache_transforms: str = "cpu"
    log_level: str = "INFO"
    debug: bool = False
    save_performance_metric: bool = False
    use_slow_performance_metrics: bool = False
    merge_validation_to_training_set: bool = False
    # run control (the JAX package's framework fields; the port reads
    # seed, executor and save_dir, and refuses the others where set)
    seed: int = 0
    executor: str = "auto"
    save_dir: str = ""
    checkpoint_every_round: bool = True
    checkpoint_every: int = 0
    profile: bool = False
    watchdog_seconds: float = 0.0
    fault_tolerance: dict[str, Any] = dataclasses.field(default_factory=dict)
    multihost_init_retries: int = 0
    telemetry: dict[str, Any] = dataclasses.field(default_factory=dict)
    # the port's own: where tensors live ("cuda" or "cpu")
    device: str = "cuda"

    def load_config_and_process(self) -> None:
        """Derive ``save_dir``/``log_file``:
        ``session/<algo>/<dataset>_<sampling>/<model>/<date>/<uuid>``."""
        if not self.save_dir:
            date = datetime.datetime.now().strftime("%Y-%m-%d_%H_%M_%S")
            task_name = f"{self.dataset_name}_{self.dataset_sampling}"
            if self.exp_name:
                task_name = f"{self.exp_name}_{task_name}"
            self.save_dir = os.path.join(
                "session",
                self.distributed_algorithm,
                task_name,
                self.model_name,
                date,
                str(uuid.uuid4()),
            )
        if not self.log_file:
            self.log_file = os.path.join("log", self.save_dir.replace(os.sep, "_") + ".log")
        set_level(self.log_level)


_FIELD_NAMES = {f.name for f in dataclasses.fields(DistributedTrainingConfig)}
_DICT_FIELDS = {
    f.name
    for f in dataclasses.fields(DistributedTrainingConfig)
    if f.default_factory is dict  # type: ignore[comparison-overlap]
}


def _coerce(value: str) -> Any:
    """Parse a ``++key=value`` override string into a python value."""
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def apply_overrides(config: DistributedTrainingConfig, overrides: dict[str, Any]) -> None:
    for dotted, value in overrides.items():
        parts = dotted.split(".")
        if parts[0] not in _FIELD_NAMES:
            raise KeyError(f"unknown config key: {dotted}")
        if len(parts) == 1:
            setattr(config, parts[0], value)
        else:
            node = getattr(config, parts[0])
            if not isinstance(node, dict):
                raise KeyError(f"cannot set nested key on non-dict field: {dotted}")
            for part in parts[1:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value


def _merge_conf_dict(config: DistributedTrainingConfig, conf: dict[str, Any]) -> None:
    # single-key nesting unwrap
    while "dataset_name" not in conf and len(conf) == 1:
        conf = next(iter(conf.values()))
    for key, value in conf.items():
        if key not in _FIELD_NAMES:
            get_logger().warning("ignoring unknown config key %s", key)
            continue
        if key in _DICT_FIELDS and isinstance(value, dict):
            merged = dict(getattr(config, key))
            merged.update(value)
            setattr(config, key, merged)
        else:
            setattr(config, key, value)


def load_config_from_file(
    config_file: str,
    global_conf_path: str | None = None,
    overrides: dict[str, Any] | None = None,
) -> DistributedTrainingConfig:
    """One YAML file merged over ``conf/global.yaml``."""
    config = DistributedTrainingConfig()
    if global_conf_path is None:
        candidate = os.path.join(CONF_DIR, "global.yaml")
        global_conf_path = candidate if os.path.isfile(candidate) else None
    if global_conf_path:
        with open(global_conf_path, encoding="utf8") as f:
            _merge_conf_dict(config, yaml.safe_load(f) or {})
    with open(config_file, encoding="utf8") as f:
        _merge_conf_dict(config, yaml.safe_load(f) or {})
    if overrides:
        apply_overrides(config, overrides)
    config.load_config_and_process()
    return config


def parse_cli_args(argv: list[str]) -> tuple[str, dict[str, Any]]:
    """Parse ``--config-name <name> ++a.b=c ...`` hydra-style arguments."""
    config_name = ""
    overrides: dict[str, Any] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--config-name":
            config_name = argv[i + 1]
            i += 2
        elif arg.startswith("--config-name="):
            config_name = arg.split("=", 1)[1]
            i += 1
        elif arg.startswith("+"):
            key, _, value = arg.lstrip("+").partition("=")
            overrides[key] = _coerce(value)
            i += 1
        else:
            raise ValueError(f"unrecognized argument: {arg}")
    if not config_name:
        raise ValueError("--config-name is required")
    return config_name, overrides


def load_config(argv: list[str], conf_dir: str | None = None) -> DistributedTrainingConfig:
    """The CLI loader: ``conf/<name>.yaml`` plus overrides, with the
    algorithm prefix of ``++fed_avg.round=1`` style keys stripped."""
    config_name, overrides = parse_cli_args(argv)
    path = os.path.join(conf_dir or CONF_DIR, config_name)
    if not path.endswith(".yaml"):
        path += ".yaml"
    cleaned: dict[str, Any] = {}
    for key, value in overrides.items():
        parts = key.split(".")
        if parts[0] not in _FIELD_NAMES and len(parts) > 1 and parts[1] in _FIELD_NAMES:
            key = ".".join(parts[1:])
        cleaned[key] = value
    return load_config_from_file(path, overrides=cleaned)
