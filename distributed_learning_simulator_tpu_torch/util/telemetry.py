"""roundtrace: structured telemetry spans and counter events for every
executor (the port's ``util/telemetry.py``).

:class:`TraceRecorder` streams a monotonic-clocked series of **span** and
**event** records, appended as JSONL to ``<save_dir>/server/trace.jsonl``
in the JAX package's schema, so ``tools/tracedump`` and ``tools/costview``
read a port run's trace as they read a JAX run's.

What makes it safe to leave on:

* **no device work and no synchronisation** -- every value it records is
  host state the run loop already owns (wall-clock, counters, the metric
  floats read at the round's one existing sync);
* **bit for bit a no-op when off** -- with ``config.telemetry.enabled``
  false (the default) the recorder keeps only the integer counters behind
  the sessions' ``dispatch_count`` / ``host_sync_count`` / ``rounds_run``,
  buffers nothing, writes no file and adds no field to
  ``round_record.json``;
* **a crash-safe sink** -- records are buffered and flushed on a cadence
  and by an exit finalizer (the checkpoint writer's finalizer hook), each
  flush is one whole-line append, and readers skip a torn tail line.

Config surface (``config.telemetry``; an unknown key raises)::

    telemetry:
      enabled: true          # default false
      path: trace.jsonl      # default <save_dir>/server/trace.jsonl;
                             # a relative path anchors there too
      flush_every: 256       # records buffered between appends (0 = auto)
      capture_compile: true  # a `compile` event per kernel library loaded
      capture_cost: true     # price each program at its first dispatch
                             # (`program_cost` events, util/costwatch.py)
      capture_hbm: true      # device memory watermarks at round
                             # boundaries (`hbm` events; none on the CPU)
      profile_rounds: [3, 5] # rounds 3..5 under torch.profiler

Record schema (one JSON object a line):

* every record: ``i`` (its 0-based line offset; ``round_record.json`` rows
  cross-link it as ``trace_offset``), ``t`` (seconds since the recorder's
  monotonic origin), ``ev`` (``meta`` / ``event`` / ``span``), ``kind``;
* spans add ``dur`` (seconds) and fields of their kind (``round`` spans:
  round, accuracy, loss, sent_mb, received_mb, ...);
* ``dispatch_call`` spans time the host-blocking part of a program call
  under the JAX program's name (``round[dense]``, ``run[gather]``, ...);
  on the card the rest of its device time lands at the round's existing
  sync, as on the JAX package's asynchronous backend;
* ``compile`` events: the port has no jit cache; its counterpart is the
  build or load of a kernel library at first use (``ops/build.py``).  One
  event per library, ``program`` the library's name, ``retrace`` false;
* ``program_cost`` events carry the ledger fields of
  ``util/costwatch.py`` for a program priced at its first dispatch;
* ``hbm`` events read ``torch.cuda.memory_stats()`` (allocated bytes,
  current and peak) at round boundaries, on a CUDA device only.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

from ..utils.logging import get_logger

_KNOWN_KEYS = frozenset(
    (
        "enabled",
        "path",
        "flush_every",
        "capture_compile",
        "capture_cost",
        "capture_hbm",
        "profile_rounds",
    )
)

#: schema version stamped into the meta record
TRACE_VERSION = 1

#: the ``torch.profiler.profile`` a recorder's window holds open in this
#: process (a session that died inside its window leaves it behind)
_open_profile = None


class _NullSpan:
    """Shared no-op ``with`` target for the disabled recorder."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **fields) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span: measures a monotonic duration and emits one span
    record at ``__exit__``; ``add()`` attaches fields mid-flight."""

    __slots__ = ("_recorder", "_kind", "_fields", "_start")

    def __init__(self, recorder: "TraceRecorder", kind: str, fields: dict):
        self._recorder = recorder
        self._kind = kind
        self._fields = fields

    def add(self, **fields) -> None:
        self._fields.update(fields)

    def __enter__(self):
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._recorder.span_record(self._kind, time.monotonic() - self._start, **self._fields)
        return False


class TraceRecorder:
    """Structured telemetry recorder (see the module docstring).

    The ``counters`` dict is always kept: it backs the sessions'
    ``dispatch_count`` / ``host_sync_count`` / ``rounds_run`` and costs one
    dict increment whether telemetry is on or off.  Span and event records
    are buffered (and the JSONL file created) only when ``enabled``.
    ``device`` is where the session's tensors live: the ``hbm`` watermark
    and the profiler's CUDA activity need a CUDA device."""

    def __init__(
        self,
        enabled: bool = False,
        path: str | None = None,
        flush_every: int = 0,
        capture_compile: bool = True,
        capture_cost: bool = True,
        capture_hbm: bool = True,
        profile_rounds: tuple[int, int] | None = None,
        meta: dict[str, Any] | None = None,
        device=None,
    ) -> None:
        self.enabled = bool(enabled)
        self.path = path
        self.flush_every = int(flush_every) or 256
        self.capture_compile = bool(capture_compile)
        self.capture_cost = bool(capture_cost)
        self.capture_hbm = bool(capture_hbm)
        self.profile_rounds = profile_rounds
        self.device = device
        self.counters: dict[str, int] = {}
        self._origin = time.monotonic()
        self._buffer: list[str] = []
        self._emitted = 0
        #: programs priced and kernel libraries reported in this trace
        self._priced: set[str] = set()
        self._libraries: set[str] = set()
        self._loads_seen = 0
        self._profiling = False
        self._profile_done = False
        self._profile = None
        self._profile_first = 0
        if self.enabled:
            if not self.path:
                raise ValueError(
                    "telemetry.enabled requires a trace path (set telemetry.path or a config save_dir)"
                )
            # a trace accumulates across sessions sharing its path (resume,
            # train_with_recovery's attempts): offsets CONTINUE from the
            # existing line count, so a row's trace_offset stays the line
            # index (== the record's own `i`) of its span
            self._emitted = self._existing_records()
            meta_record = {"version": TRACE_VERSION}
            meta_record.update(meta or {})
            self._emit("meta", "trace", meta_record)

    def _existing_records(self) -> int:
        """Line count of a trace already at ``path`` (0 when absent or
        empty), terminating a torn tail line of a crashed session first so
        the line positions stay stable.  The programs it priced and the
        libraries it reported are not reported again: a program is priced
        once a trace."""
        try:
            if os.path.getsize(self.path) == 0:
                return 0
        except OSError:
            return 0
        with open(self.path, "rb+") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                f.write(b"\n")  # terminate the torn tail in place
            f.seek(0)
            count = 0
            for line in f:
                count += 1
                if b'"program_cost"' not in line and b'"compile"' not in line:
                    continue
                try:
                    record = json.loads(line)
                except ValueError:
                    continue  # a torn line
                if record.get("kind") == "program_cost":
                    self._priced.add(str(record.get("program")))
                elif record.get("kind") == "compile":
                    self._libraries.add(str(record.get("program")))
            return count

    # ------------------------------------------------------------- config
    @classmethod
    def from_config(cls, config, default_dir: str | None = None, device=None) -> "TraceRecorder":
        """A recorder from ``config.telemetry`` (always one: disabled when
        the knob is absent or false).  ``default_dir`` is where
        ``trace.jsonl`` lands when ``telemetry.path`` is unset; without it,
        ``<config.save_dir>/server``, beside ``round_record.json`` (the
        threaded server passes its own ``save_dir``)."""
        raw = dict(getattr(config, "telemetry", None) or {})
        unknown = set(raw) - _KNOWN_KEYS
        if unknown:
            raise ValueError(f"unknown telemetry key(s): {sorted(unknown)} — known: {sorted(_KNOWN_KEYS)}")
        enabled = bool(raw.get("enabled", False))
        path = raw.get("path")
        if enabled and not (path and os.path.isabs(path)):
            # a relative telemetry.path anchors beside round_record.json,
            # never the process CWD (that would mix unrelated runs' offsets)
            base = default_dir or os.path.join(getattr(config, "save_dir", "") or ".", "server")
            path = os.path.join(base, path or "trace.jsonl")
        window = raw.get("profile_rounds")
        if window is not None:
            window = tuple(int(r) for r in window)
            if len(window) != 2 or window[0] > window[1] or window[0] < 1:
                raise ValueError(
                    f"telemetry.profile_rounds must be [first, last] with 1 <= first <= last, got {list(window)}"
                )
        meta = {
            "algorithm": getattr(config, "distributed_algorithm", ""),
            "executor": getattr(config, "executor", ""),
            "workers": getattr(config, "worker_number", 0),
        }
        return cls(
            enabled=enabled,
            path=path,
            flush_every=int(raw.get("flush_every", 0) or 0),
            capture_compile=bool(raw.get("capture_compile", True)),
            capture_cost=bool(raw.get("capture_cost", True)),
            capture_hbm=bool(raw.get("capture_hbm", True)),
            profile_rounds=window,
            meta=meta,
            device=device,
        )

    # ----------------------------------------------------------- counters
    def count(self, kind: str, n: int = 1) -> None:
        """Bare counter bump: no record, on or off."""
        self.counters[kind] = self.counters.get(kind, 0) + n

    def reset_counters(self, *kinds: str) -> None:
        """Zero the named counters (all when none is named): the
        warmup-then-measure seam (``reset_dispatch_stats``)."""
        for kind in kinds or tuple(self.counters):
            self.counters[kind] = 0

    # ------------------------------------------------------------ records
    def event(self, kind: str, **fields) -> int | None:
        """Counter event: bump ``counters[kind]`` and (when enabled) append
        one event record.  Returns the record's line offset, or None when
        disabled."""
        self.count(kind)
        if not self.enabled:
            return None
        return self._emit("event", kind, fields)

    def span_record(self, kind: str, dur: float, **fields) -> int | None:
        """Append one span record with a duration measured by the caller
        (the run loops already time their rounds: timing them again would
        drift from the recorded ``round_seconds``)."""
        if not self.enabled:
            return None
        fields = dict(fields)
        fields["dur"] = round(float(dur), 9)
        return self._emit("span", kind, fields)

    def span(self, kind: str, **fields):
        """``with``-style span: measures a monotonic duration and emits the
        record at exit.  A shared no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, kind, fields)

    def _emit(self, ev: str, kind: str, fields: dict) -> int:
        record = {
            "i": self._emitted + len(self._buffer),
            "t": round(time.monotonic() - self._origin, 9),
            "ev": ev,
            "kind": kind,
        }
        record.update(fields)
        offset = record["i"]
        self._buffer.append(json.dumps(record, default=str))
        self.note_compile()
        if len(self._buffer) >= self.flush_every:
            self.flush()
        return offset

    # ---------------------------------------------------- compile capture
    def dispatch(self, program: str, fn, args: tuple, cost_args=None):
        """The dispatch tail of every session's program call: run
        ``fn(*args)``; when enabled, time the call into a ``dispatch_call``
        span under ``program`` (the JAX program's name).  The host blocks
        for as long as an eager call blocks; on the card the rest of the
        device time lands at the round's existing sync.  With
        ``capture_cost`` the program's first dispatch in this trace runs
        under ``FlopCounterMode`` and is priced into a ``program_cost``
        event (:func:`~.costwatch.program_cost`); ``cost_args`` (default
        ``args``) are the tensors its argument bytes count."""
        if not self.enabled:
            return fn(*args)
        price = self.capture_cost and program not in self._priced
        start = time.monotonic()
        if price:
            from .costwatch import program_cost

            out, row = program_cost(fn, args, cost_args=cost_args)
        else:
            out = fn(*args)
        self.span_record("dispatch_call", time.monotonic() - start, program=program)
        if price:
            self._priced.add(program)
            if row is not None:
                self._emit("event", "program_cost", {"program": program, **row})
        return out

    def note_compile(self) -> None:
        """One ``compile`` event for each kernel library loaded in this
        process that this trace has not reported yet: the port's
        counterpart of the JAX recorder's jit-cache growth.  A library
        loaded before the recorder existed (an earlier session in the
        process) is reported at the recorder's first record, as the JAX
        recorder reports a cached program at its first dispatch.  Checked
        after every record, gated on ``enabled``: one length compare is
        the whole cost, and no device is touched."""
        if not (self.enabled and self.capture_compile):
            return
        from ..ops import build

        loads = build.loads
        if len(loads) == self._loads_seen:
            return
        fresh = loads[self._loads_seen :]
        self._loads_seen += len(fresh)
        for load in fresh:
            if load["library"] in self._libraries:
                continue
            self._libraries.add(load["library"])
            self.count("compile")
            self._emit(
                "event",
                "compile",
                {
                    "program": load["library"],
                    "cache_size": 1,
                    "retrace": False,
                    "signature": "",
                    "built": load["built"],
                    "seconds": round(load["seconds"], 6),
                },
            )

    def hbm_watermark(self, round_number: int) -> None:
        """``torch.cuda.memory_stats()``'s allocated bytes (current and
        peak) into one ``hbm`` event, at a round boundary the run loop
        already owns: the caching allocator's host-side counters, read
        without a launch or a sync.  Nothing on a CPU device, as the JAX
        recorder emits nothing where PJRT returns no stats."""
        if not (self.enabled and self.capture_hbm):
            return
        device = self.device
        if device is None or getattr(device, "type", str(device).split(":")[0]) != "cuda":
            return
        try:
            import torch

            stats = torch.cuda.memory_stats(device)
        except Exception:  # noqa: BLE001 -- diagnostics must never raise
            return
        if not stats:
            return
        self._emit(
            "event",
            "hbm",
            {
                "round": int(round_number),
                "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0) or 0),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0) or 0),
            },
        )

    # ---------------------------------------------------- profiler window
    def maybe_profile_start(self, first_round: int, last_round: int | None = None) -> None:
        """Open a ``torch.profiler.profile`` (CPU activity, and CUDA's on a
        CUDA device) when the run reaches the ``profile_rounds`` window
        (idempotent; no sync).  A caller running a chunk of rounds passes
        its ``last_round``, so a window that starts mid-chunk opens at the
        chunk (the window snaps outward to chunk boundaries)."""
        global _open_profile
        if last_round is None:
            last_round = first_round
        if (
            not self.enabled
            or self.profile_rounds is None
            or self._profiling
            or self._profile_done
            or last_round < self.profile_rounds[0]
            or first_round > self.profile_rounds[1]
        ):
            return
        import torch

        trace_dir = os.path.join(os.path.dirname(os.path.abspath(self.path)), "profile_rounds")
        os.makedirs(trace_dir, exist_ok=True)
        if _open_profile is not None:
            # a session in this process died inside ITS window without
            # reaching close(): disarm the stale profiler and claim the window
            with contextlib.suppress(Exception):
                _open_profile.stop()
            _open_profile = None
        if torch._C._autograd._profiler_enabled():
            # another profiler runs (``profile: true``): one at a time
            get_logger().warning("telemetry.profile_rounds skipped: another torch.profiler is running")
            self._profile_done = True
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if getattr(self.device, "type", None) == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profile = torch.profiler.profile(activities=activities)
        profile.start()
        _open_profile = self._profile = profile
        self._profiling = True
        self._profile_first = first_round
        self._emit("event", "profile", {"action": "start", "round": first_round, "dir": trace_dir})

    def maybe_profile_stop(self, last_round: int) -> None:
        """Close the window once the run passes its last round (a chunk
        overlapping the window's end closes it at the chunk boundary) and
        export its Chrome trace beside the trace file, under
        ``profile_rounds/``."""
        global _open_profile
        if not self._profiling or last_round < self.profile_rounds[1]:
            return
        trace_dir = os.path.join(os.path.dirname(os.path.abspath(self.path)), "profile_rounds")
        name = f"rounds_{self._profile_first}-{last_round}.{os.getpid()}.pt.trace.json"
        path = os.path.join(trace_dir, name)
        try:
            self._profile.stop()
            self._profile.export_chrome_trace(path)
        except Exception as exc:  # noqa: BLE001 -- diagnostics must never raise
            get_logger().warning("telemetry profile window: %s", exc)
            path = ""
        if _open_profile is self._profile:
            _open_profile = None
        self._profile = None
        self._profiling = False
        self._profile_done = True
        self._emit("event", "profile", {"action": "stop", "round": last_round, "file": path})

    # ------------------------------------------------------------- sink
    def flush(self) -> None:
        """Append the buffered records to the JSONL sink (whole lines, one
        write); registered as the checkpoint writer's finalizer by the run
        loops, so the trace is complete at exit, errors included."""
        if not self._buffer or not self.path:
            self._buffer.clear()
            return
        directory = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(directory, exist_ok=True)
        payload = "\n".join(self._buffer) + "\n"
        with open(self.path, "at", encoding="utf8") as f:
            f.write(payload)
        self._emitted += len(self._buffer)
        self._buffer.clear()

    def close(self) -> None:
        """Exit finalizer: stop a profiler window still open (a crash inside
        the window must not leave the profiler running for the next session
        in this process), then flush the tail of the buffer."""
        if self._profiling:
            self.maybe_profile_stop(self.profile_rounds[1])
        self.flush()
