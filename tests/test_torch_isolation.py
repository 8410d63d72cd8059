"""The port stands alone: no JAX, nothing of the JAX package, and no silent
CPU fallback."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "distributed_learning_simulator_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "distributed_learning_simulator_tpu")
PORT_SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where importing JAX or
    the JAX package fails."""
    blocked = "; ".join(f"sys.modules[{name!r}] = None" for name in FORBIDDEN)
    script = (
        "import importlib, pkgutil, sys; "
        f"{blocked}; "
        "import distributed_learning_simulator_tpu_torch as port; "
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]; "
        "[importlib.import_module(n) for n in names]; "
        "import chip_smoke; "
        "print(len(names))"
    )
    out = subprocess.run(
        [sys.executable, "-c", script],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def _tiny_config():
    from distributed_learning_simulator_tpu_torch.config import DistributedTrainingConfig

    return DistributedTrainingConfig(
        dataset_name="CIFAR10",
        model_name="vit_tiny",
        distributed_algorithm="fed_avg",
        worker_number=2,
        batch_size=8,
        dataset_kwargs={"train_size": 16, "val_size": 8, "test_size": 8},
        save_dir="unused",
    )


def test_train_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    from distributed_learning_simulator_tpu_torch.training import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_tiny_config())


def test_resolve_device(monkeypatch):
    from distributed_learning_simulator_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cli_runs_on_the_cpu(tmp_path):
    """``python -m distributed_learning_simulator_tpu_torch`` with the
    config tree and ``++fed_avg.device=cpu``."""
    out = subprocess.run(
        [
            sys.executable,
            "-m",
            "distributed_learning_simulator_tpu_torch",
            "--config-name",
            "fed_avg/cifar10.yaml",
            "++fed_avg.model_name=vit_tiny",
            "++fed_avg.device=cpu",
            "++fed_avg.round=1",
            "++fed_avg.epoch=1",
            "++fed_avg.worker_number=2",
            "++fed_avg.batch_size=8",
            "++fed_avg.dataset_kwargs.train_size=16",
            "++fed_avg.dataset_kwargs.test_size=8",
            f"++fed_avg.save_dir={tmp_path / 'session'}",
            f"++fed_avg.log_file={tmp_path / 'run.log'}",
        ],
        cwd=tmp_path,
        capture_output=True,
        text=True,
        timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    assert "test_accuracy" in out.stdout and "test_macro_f1" in out.stdout
    assert (tmp_path / "session" / "server" / "round_record.json").is_file()
