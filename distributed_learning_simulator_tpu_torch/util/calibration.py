"""``client_chunk: auto``: the read side of the calibration cache (the
port's ``util/calibration.py``).

``calibration.json`` at the repo root holds measured client-chunk winners,
keyed by everything that changes the chunking trade-off: the session
class, the model, the device mesh, the slot count (with padding), the
batch size and the population store.  The port builds its key through the
same :func:`calibration_key`, with its own session class and the mesh
``{}``: its clients are a loop on one card, not a mesh axis.  An entry
that another backend wrote never matches that key.

A hit gives the calibrated chunk, which the session's ``chunk_size``
clamps to a divisor of the slot count as it does a hand-set value.  A
miss is loud: one warning naming the key, then 0, the session's default
(8 clients a chunk).  The writer (the JAX package's ``tools/autotune``)
is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Any

from ..utils.logging import get_logger

#: the repo root's cache
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CALIBRATION_PATH = os.path.join(_REPO_ROOT, "calibration.json")


def calibration_key(
    session: str,
    model_name: str,
    mesh_shape: dict[str, int] | None,
    n_slots: int,
    s_pad: int,
    batch_size: int,
    population_store: str = "device",
) -> str:
    """The cache key; writer and reader build it through this function."""
    mesh = ",".join(f"{k}={v}" for k, v in sorted((mesh_shape or {}).items()))
    return (
        f"{session}|{model_name}|mesh[{mesh}]|slots={n_slots}"
        f"|s_pad={s_pad}|batch={batch_size}|pop={population_store}"
    )


def session_calibration_key(session_obj) -> str:
    """The key of a live session: its class, model, slots and batch; no
    mesh, and the device-resident population (the port's only store)."""
    return calibration_key(
        session=type(session_obj).__name__,
        model_name=getattr(session_obj.config, "model_name", ""),
        mesh_shape={},
        n_slots=int(getattr(session_obj, "n_slots", 0)),
        s_pad=int(getattr(session_obj, "s_pad", 0)),
        batch_size=int(getattr(session_obj.config, "batch_size", 0)),
    )


def load_calibration(path: str | None = None) -> dict[str, Any]:
    """The parsed cache (``{}`` when absent or unreadable: every lookup
    then misses loudly)."""
    try:
        with open(path or DEFAULT_CALIBRATION_PATH, encoding="utf8") as f:
            blob = json.load(f)
    except (OSError, ValueError):
        return {}
    return blob if isinstance(blob, dict) else {}


def resolve_client_chunk(session_obj, path: str | None = None) -> int:
    """``client_chunk: auto`` -> the calibrated chunk of this session's
    shape, or 0 (the session's default) after one warning naming the key."""
    key = session_calibration_key(session_obj)
    entry = load_calibration(path).get("entries", {}).get(key)
    if entry is not None:
        chunk = int(entry.get("client_chunk", 0) or 0)
        if chunk > 0:
            get_logger().info("client_chunk: auto -> %d (calibration %r)", chunk, key)
            return chunk
    get_logger().warning(
        "client_chunk: auto found NO calibration entry for %r in %s: falling back to the"
        " default chunk",
        key,
        path or DEFAULT_CALIBRATION_PATH,
    )
    return 0
