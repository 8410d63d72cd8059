"""costwatch: the cost ledger behind ``program_cost`` trace events and
the roofline (the port's ``util/costwatch.py``).

* :func:`program_cost` -- a program's first call, run under
  ``torch.utils.flop_counter.FlopCounterMode``, priced into the flat ledger
  schema (:data:`LEDGER_FIELDS`): ``flops`` counted by the mode, and
  ``argument_bytes`` / ``output_bytes`` from the call's tensors.  The
  fields PyTorch has no counterpart for (``bytes_accessed``,
  ``temp_bytes``, ``generated_code_bytes``: XLA's compiled-program
  analyses) are 0, as the JAX package's ``cost_summary`` reports a field
  its backend cannot give;
* :func:`roofline` -- arithmetic intensity against the peak FLOP/s and
  memory-bandwidth tables: compute- or memory-bound, and achieved against
  roofline MFU, in host f64 (``tools/costview`` renders the JAX twin);
* :func:`chip_peak_flops` / :func:`chip_hbm_bandwidth` -- the card's
  published peaks, matched on ``torch.cuda.get_device_name`` by longest
  prefix; 0.0 on an unknown device and on the CPU;
* :func:`normalize_cost`, :func:`merge_ledgers` -- the JAX package's, the
  same arithmetic.

The hand-written kernels are called through ``ctypes``, so
``FlopCounterMode`` does not see them: a program's ``flops`` count the
PyTorch operations around them, not K1-K11.  That matches the reference,
where no Pallas call carries a ``cost_estimate`` and XLA prices K1-K11 at
nothing.  The JAX functions that read XLA's HLO text
(``hlo_op_histogram``, ``hlo_family_bytes``, the ``convert_bytes`` extra)
and ``session_cost_ledger`` (which lowers ``shardcheck_programs()``
without running them) have no counterpart here.

House rules: host-side arithmetic only -- :func:`program_cost` adds no
launch and no sync to the call it prices, and a pricing failure loses the
row, never the call's result.
"""

from __future__ import annotations

from typing import Any, Iterable

#: dense bf16 peak FLOP/s by device name (the MFU denominator): public
#: data-sheet figures of the card, no TPU figure
BF16_PEAK = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # H100 SXM5, 700 W
}

#: memory bandwidth (bytes/s) by device name: the roofline's memory ceiling
HBM_BANDWIDTH = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

#: the flat per-program ledger schema (``program_cost`` trace events and
#: costview rows share it)
LEDGER_FIELDS = (
    "flops",
    "bytes_accessed",
    "argument_bytes",
    "output_bytes",
    "temp_bytes",
    "generated_code_bytes",
)


def _device_name() -> str | None:
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0)


def _match_chip(table: dict[str, float], name: str | None = None, count: int | None = None) -> float:
    """``table``'s entry for the device ``name`` (default: the first
    visible card) by longest prefix, times ``count`` devices (default: the
    visible cards); 0.0 on an unknown device or without one."""
    import torch

    if name is None:
        name = _device_name()
    if name is None:
        return 0.0
    if count is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 1
    for key in sorted(table, key=len, reverse=True):
        if name.startswith(key):
            return table[key] * count
    return 0.0


def chip_peak_flops(name: str | None = None, count: int | None = None) -> float:
    """Aggregate dense bf16 peak FLOP/s across the visible cards (0.0 on an
    unknown device and on the CPU: MFU 0 rather than a guess)."""
    return _match_chip(BF16_PEAK, name, count)


def chip_hbm_bandwidth(name: str | None = None, count: int | None = None) -> float:
    """Aggregate memory bandwidth (bytes/s) across the visible cards (0.0
    on an unknown device and on the CPU)."""
    return _match_chip(HBM_BANDWIDTH, name, count)


# ---------------------------------------------------------------- ledger
def normalize_cost(cost: Any) -> dict[str, float]:
    """A ``cost_analysis()``-shaped dict (or a list of one per computation)
    -> ``{"flops": ..., "bytes_accessed": ...}``; absent keys read 0.0."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    if not isinstance(cost, dict):
        cost = {}
    return {
        "flops": float(cost.get("flops", 0.0) or 0.0),
        "bytes_accessed": float(cost.get("bytes accessed", 0.0) or 0.0),
    }


def tensor_bytes(tree) -> int:
    """Bytes of every tensor and numpy array in a nest of tuples, lists and
    dicts (shape and dtype only: no data is read)."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    numel, size = getattr(tree, "numel", None), getattr(tree, "element_size", None)
    if callable(numel) and callable(size):  # a torch.Tensor
        return int(numel()) * int(size())
    nbytes = getattr(tree, "nbytes", None)
    return int(nbytes) if isinstance(nbytes, int) else 0


def program_cost(fn, args: tuple, cost_args=None) -> tuple[Any, dict[str, float] | None]:
    """Run ``fn(*args)`` once under ``FlopCounterMode`` and price it:
    returns ``(the call's result, a ledger row)``.  The row holds the
    counted ``flops``, the bytes of ``cost_args`` (default ``args``) as
    ``argument_bytes`` and of the result as ``output_bytes``, and 0 in the
    fields PyTorch has no counterpart for; None when the mode could not be
    entered (the call then runs plain).  The call's own errors propagate.
    The mode adds host work to every operation of the call (its cost is
    the priced ``dispatch_call`` span's excess) and no device work."""
    try:
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        counter.__enter__()
    except Exception:  # noqa: BLE001 -- diagnostics must never raise
        return fn(*args), None
    try:
        out = fn(*args)
    finally:
        counter.__exit__(None, None, None)
    row = dict.fromkeys(LEDGER_FIELDS, 0.0)
    row["flops"] = float(counter.get_total_flops())
    row["argument_bytes"] = float(tensor_bytes(args if cost_args is None else cost_args))
    row["output_bytes"] = float(tensor_bytes(out))
    return out, row


# -------------------------------------------------------------- roofline
def roofline(
    flops: float,
    bytes_accessed: float,
    seconds: float = 0.0,
    peak_flops: float = 0.0,
    hbm_bandwidth: float = 0.0,
) -> dict[str, Any]:
    """Classic roofline attribution for one program, all host f64:

    * ``arithmetic_intensity`` = flops / bytes accessed;
    * ``ridge_intensity`` = peak FLOP/s / memory bytes/s: above it the roof
      is compute, below it memory;
    * ``bound_by`` in ``compute`` / ``hbm`` / ``unknown`` (no tables);
    * ``roofline_flops_per_s`` = min(peak, intensity x bandwidth) and
      ``roofline_mfu``: the best this program could do on this card;
    * with ``seconds`` > 0: ``achieved_flops_per_s``, ``achieved_mfu`` and
      ``fraction_of_roofline`` (achieved / attainable)."""
    intensity = flops / bytes_accessed if bytes_accessed > 0 else 0.0
    out: dict[str, Any] = {
        "arithmetic_intensity": intensity,
        "bound_by": "unknown",
        "ridge_intensity": 0.0,
        "roofline_flops_per_s": 0.0,
        "roofline_mfu": 0.0,
    }
    if peak_flops > 0 and hbm_bandwidth > 0:
        ridge = peak_flops / hbm_bandwidth
        attainable = min(peak_flops, intensity * hbm_bandwidth)
        out["ridge_intensity"] = ridge
        out["bound_by"] = "compute" if intensity >= ridge else "hbm"
        out["roofline_flops_per_s"] = attainable
        out["roofline_mfu"] = attainable / peak_flops
    if seconds > 0.0:
        achieved = flops / seconds
        out["achieved_flops_per_s"] = achieved
        if peak_flops > 0:
            out["achieved_mfu"] = achieved / peak_flops
        if out["roofline_flops_per_s"] > 0:
            out["fraction_of_roofline"] = achieved / out["roofline_flops_per_s"]
    return out


def merge_ledgers(rows: Iterable[dict[str, float]]) -> dict[str, float]:
    """Sum ledger rows field-wise (the totals line of a cost table)."""
    total = dict.fromkeys(LEDGER_FIELDS, 0.0)
    for row in rows:
        for field in LEDGER_FIELDS:
            total[field] += float(row.get(field, 0.0) or 0.0)
    return total
