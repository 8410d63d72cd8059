"""Shared resume-state discovery (the port's ``util/resume.py``, a copy of the
JAX package's: the two packages read and write the same files).

One definition of "what can be resumed" for every executor and method
(threaded server, SPMD fed_avg/GNN/OBD sessions): the latest round whose
checkpoint AND record row both exist — and whose checkpoint **actually
loads**.  A crash can leave the newest ``round_N.npz`` torn in ways the
atomic-rename writer cannot prevent (a partially synced filesystem, a
truncated copy, disk corruption); resume must degrade to the previous
checkpointed round with a log line, not crash the recovering run — the
contract ``training.train_with_recovery`` relies on to relaunch
unattended.

The round checkpoint is written asynchronously BEFORE the round's record
entry (and the threaded path records before it caches) — a crash in that
window leaves one side orphaned.  Resuming only from rounds that have both
keeps stats/best-model bookkeeping complete; the orphan is simply
re-trained.

Horizon runs (``algorithm_kwargs.round_horizon`` /
``config.checkpoint_every``) checkpoint AND flush record rows on the same
horizon boundaries, so the latest both-sides round is always a boundary.
A resumed port session starts at ``last + 1`` with nothing to replay: its
random streams are keyed by ``(seed, round, slot)``, not chained.
"""

import json
import os

import numpy as np

from ..utils.logging import get_logger


def _try_load_checkpoint(path: str) -> dict | None:
    """Fully load one ``round_N.npz`` (every array materialized — a torn
    zip member can fail at read time, not just at open).  Returns None with
    a warning on ANY failure so callers fall back to an older round."""
    try:
        with np.load(path) as blob:
            return {k: blob[k] for k in blob.files}
    except Exception as exc:  # noqa: BLE001 — any torn-file shape
        get_logger().warning(
            "checkpoint %s is unloadable (%s); falling back to the "
            "previous checkpointed round",
            path,
            exc,
        )
        return None


#: (abspath, mtime_ns, size) -> loadable?  Validation fully reads the
#: model file, and :func:`resumable_round` is called once per WORKER on
#: the error-feedback resume path plus again by the recovery supervisor —
#: memoizing by file identity keeps a resume at one validating read per
#: distinct checkpoint instead of O(workers) full-model loads.
_VALIDATED: dict[tuple[str, int, int], bool] = {}


def _checkpoint_loadable(path: str) -> bool:
    try:
        stat = os.stat(path)
    except OSError:
        return False
    key = (os.path.abspath(path), stat.st_mtime_ns, stat.st_size)
    cached = _VALIDATED.get(key)
    if cached is None:
        cached = _try_load_checkpoint(path) is not None
        _VALIDATED[key] = cached
    return cached


def _candidate_rounds(
    resume_dir: str, recorded: dict[int, dict] | None = None
) -> list[int]:
    """Rounds with BOTH a checkpoint file and a record row, descending."""
    model_dir = os.path.join(resume_dir, "aggregated_model")
    rounds = (
        sorted(
            int(name.split("_")[1].split(".")[0])
            for name in os.listdir(model_dir)
            if name.startswith("round_") and name.endswith(".npz")
        )
        if os.path.isdir(model_dir)
        else []
    )
    if recorded is None:
        recorded = _recorded_stats(resume_dir)
    return sorted((n for n in rounds if n in recorded), reverse=True)


def load_resume_state(
    resume_dir: str,
) -> tuple[dict | None, dict[int, dict], int]:
    """Return ``(params, recorded_stats, last_round)`` for ``resume_dir``.

    ``params`` is the newest round checkpoint that loads; unloadable
    (torn/corrupt) newer checkpoints are logged and skipped.
    ``recorded_stats`` are the int-keyed record rows with key ≤
    ``last_round`` (plus the round-0 init row when present).
    ``(None, {}, 0)`` when nothing resumable exists.
    """
    model_dir = os.path.join(resume_dir, "aggregated_model")
    recorded = _recorded_stats(resume_dir)
    for last in _candidate_rounds(resume_dir, recorded):
        params = _try_load_checkpoint(
            os.path.join(model_dir, f"round_{last}.npz")
        )
        if params is None:
            continue
        stats = {k: v for k, v in recorded.items() if k <= last}
        return params, stats, last
    return None, {}, 0


def _recorded_stats(resume_dir: str) -> dict[int, dict]:
    record_path = os.path.join(resume_dir, "server", "round_record.json")
    if not os.path.isfile(record_path):
        return {}
    with open(record_path, encoding="utf8") as f:
        return {int(k): v for k, v in json.load(f).items()}


def resumable_round(resume_dir: str) -> int:
    """The round ``load_resume_state`` resumes from (0 when nothing is
    resumable): the latest round with a ``round_N.npz`` checkpoint that
    LOADS and a record row.  Workers use this to validate that per-worker
    side state (e.g. the error-feedback residual) was not written in a
    later, never-checkpointed round; the recovery supervisor uses it to
    pick which attempt directory to resume from.  Validation fully loads
    the newest candidate ONCE per distinct file (memoized by
    path/mtime/size — torn files must not be selected as resume points,
    but W workers asking for the round number must not cost W model
    reads)."""
    model_dir = os.path.join(resume_dir, "aggregated_model")
    for last in _candidate_rounds(resume_dir):
        if _checkpoint_loadable(
            os.path.join(model_dir, f"round_{last}.npz")
        ):
            return last
    return 0


def load_round_checkpoint(resume_dir: str, round_number: int) -> dict | None:
    """Load one specific round checkpoint (e.g. the last KEPT round after a
    resume replay dropped a superseded tail); None when absent OR torn."""
    path = os.path.join(
        resume_dir, "aggregated_model", f"round_{round_number}.npz"
    )
    if not os.path.isfile(path):
        return None
    return _try_load_checkpoint(path)


__all__ = ["load_resume_state", "load_round_checkpoint", "resumable_round"]
