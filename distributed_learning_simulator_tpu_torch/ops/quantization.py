"""The QSGD transport codec over parameter dicts (the port's copy of the
stochastic part of the JAX package's ``ops/quantization.py``).

``stochastic_quantization(level)`` returns ``(quant, dequant)`` over a
``dict[str, Tensor]`` with the JAX codec's three branches and routing:

* **flat** (``flat=True``, no key): the whole dict as ONE ParamVec leaf,
  with per-tensor abs-max scales (a segment max, ``scatter_reduce``);
* **keyed per-leaf** (a ``key``): each leaf rounded with draws from the
  key, split by leaf index or folded by ``fold_indices`` position; a
  :class:`SessionKey` names the SPMD sessions' draws for one upload or
  broadcast (``CodecRandom.session_uniform``), so a threaded encode with
  it distorts a message exactly as the session does;
* **unkeyed per-leaf**: leaves of at least ``16*32*128 = 65,536`` values
  go through kernel K2 (``ops/qsgd.py``) with the seed
  ``(seed * 100003 + i) % 0x7FFFFFFF``, the rest through the consecutive
  packer here.  Each leaf's blob keeps its ``"pallas"`` flag, and decode
  follows it: K3 for the row-grouped layout, the unpacker here for the
  consecutive one.  The two layouts are never mixed.

The JAX package takes the kernel route only on a TPU (``use_pallas``);
the port takes it on both devices, as it does for attention.  The random
numbers come from a :class:`CodecRandom`, passed explicitly; the default
draws from ``torch.Generator``s seeded from the codec's integers, so a
test can hand in one that returns the JAX package's draws instead.
Packed words are int64 tensors holding u32 values on the CPU and int32
tensors of the same bits from the card's kernels; wire sizes count them
as 4-byte words either way.
"""

import dataclasses
import functools
import math
from collections.abc import Mapping

import numpy as np
import torch

from . import qsgd
from .pytree import ParamVecLayout

#: leaves at least this large go through K2/K3 (whole (32, 128) tiles x 16)
KERNEL_MIN_ELEMENTS = 16 * 32 * 128


class CodecRandom:
    """The codec's random source: uniforms in [0, 1) for the consecutive
    packer's rounding and 32-bit words for K2.  These draws are the port's
    own (``torch.Generator``s seeded through ``numpy.random.SeedSequence``
    from the codec's integers); a subclass may return other draws for the
    same requests, such as the JAX package's."""

    @staticmethod
    def _uniform(entropy, shape, device) -> torch.Tensor:
        state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
        gen = torch.Generator(device=device).manual_seed(int(state[0]) & (2**63 - 1))
        return torch.rand(tuple(shape), generator=gen, device=device, dtype=torch.float32)

    def leaf_uniform(self, seed: int, index: int, count: int, shape, device) -> torch.Tensor:
        """Leaf ``index`` of ``count`` of an unkeyed encode with ``seed``."""
        return self._uniform([seed, index, count], shape, device)

    def keyed_uniform(self, key, index: int, count: int, shape, device, fold_index=None):
        """Leaf ``index`` of ``count`` of an encode keyed by ``key``; with
        ``fold_index`` the leaf's position in the full parameter dict."""
        entropy = [int(key), 1, fold_index] if fold_index is not None else [int(key), 2, index, count]
        return self._uniform(entropy, shape, device)

    def flat_uniform(self, seed: int, shape, device) -> torch.Tensor:
        """The flat ParamVec encode with ``seed``."""
        return self._uniform([seed, 3], shape, device)

    def kernel_bits(self, seed: int, rows: int, device):
        """K2's ``[rows, 128]`` random words for ``seed``, or None for
        K2's own draw (Philox on the card, a seeded generator on the CPU)."""
        return None

    def session_uniform(self, seed: int, aggregate: int, slot: int | None, leaf: int, count: int, shape, device):
        """The SPMD sessions' draws (:func:`qsgd_quantize_dequantize`): leaf
        ``leaf`` of ``count``, in the JAX package's key order, of slot
        ``slot``'s upload (None: the broadcast) in the ``aggregate``-th
        aggregate (from 0) of a run seeded ``seed``."""
        return self._uniform([seed, 4, aggregate, 0 if slot is None else slot + 1, leaf, count], shape, device)

    def dropout_uniform(self, seed: int, aggregate: int, slot: int, leaf: int, count: int, shape, device):
        """FedDropoutAvg's keep draws (``parallel/spmd_sparse.py``): an
        element is kept where its uniform is below ``1 - dropout_rate``;
        leaf ``leaf`` of ``count`` in the JAX package's key order, in that
        layout's flat order, of slot ``slot``'s upload in the
        ``aggregate``-th round (from 0) of a run seeded ``seed``."""
        return self._uniform([seed, 5, aggregate, slot, leaf, count], shape, device)

    def leaf_permutation(self, seed: int, aggregate: int, slot: int, count: int) -> np.ndarray:
        """SMAFD's order of the ``count`` leaves (JAX key order) for slot
        ``slot``'s upload in the ``aggregate``-th round: a host array."""
        state = np.random.SeedSequence([seed, 6, aggregate, slot, count]).generate_state(1, np.uint64)
        gen = torch.Generator().manual_seed(int(state[0]) & (2**63 - 1))
        return torch.randperm(count, generator=gen).numpy()


@dataclasses.dataclass(frozen=True)
class SessionKey:
    """The key a threaded role reserves for one round's upload (``slot``
    the worker) or broadcast (``slot`` None): the SPMD sessions' draws of
    the ``aggregate``-th aggregate (from 0) of a run seeded ``seed``.  A
    keyed encode draws leaf ``i`` of ``count`` (or its ``fold_indices``
    position of the whole parameter dict) through
    ``CodecRandom.session_uniform``; FedDropoutAvg and SMAFD read the same
    triple for ``dropout_uniform`` and ``leaf_permutation``.  The JAX
    package reserves a threefry key from its aligned stream instead; the
    port's draws are keyed by these integers, so no chain is replayed."""

    seed: int
    aggregate: int
    slot: int | None


# ---------------------------------------------------------------- bit packing
def _pack_uint(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """Levels below ``2^bits`` packed ``32 // bits`` consecutive values a
    word, value ``j`` of a word at shift ``j·bits`` (int64 holding u32)."""
    lanes = 32 // bits
    flat = levels.reshape(-1).to(torch.int64)
    pad = (-flat.numel()) % lanes
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shifts = torch.arange(lanes, device=flat.device, dtype=torch.int64) * bits
    return (flat.reshape(-1, lanes) << shifts).sum(dim=1)  # disjoint bits: sum == or


def _unpack_uint(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    lanes = 32 // bits
    shifts = torch.arange(lanes, device=packed.device, dtype=torch.int64) * bits
    values = (packed.to(torch.int64)[:, None] >> shifts) & ((1 << bits) - 1)
    return values.reshape(-1)[:n]


def _round(flat: torch.Tensor, scale, rnd: torch.Tensor, level: int) -> torch.Tensor:
    """The QSGD rounding: ``|x| / scale`` on ``level`` levels, up with
    probability equal to the remainder."""
    normalized = flat.abs() / scale * level
    floor = torch.floor(normalized)
    return floor + (rnd < normalized - floor).to(torch.float32)


@functools.lru_cache(maxsize=64)
def _constant(value: float, device: torch.device) -> torch.Tensor:
    """An f32 scalar on ``device``, made once: a divisor on the card must
    be a device tensor (CUDA divides by a host scalar through its
    reciprocal), and a fresh one would be a host-to-device copy a call."""
    return torch.tensor(np.float32(value), device=device)


def qsgd_quantize_dequantize(x: torch.Tensor, uniform: torch.Tensor, level: int) -> torch.Tensor:
    """QSGD's value distortion without packing (the SPMD sessions' codec)
    of one tensor, with one draw a value of ``uniform`` in ``x``'s flat
    order (:func:`qsgd_quantize_dequantize_leaves` over one piece); back in
    ``x``'s dtype."""
    flat = x.reshape(-1).to(torch.float32)
    out = qsgd_quantize_dequantize_leaves(flat, uniform.reshape(-1), [flat.numel()], level)
    return out.reshape(x.shape).to(x.dtype)


def qsgd_quantize_dequantize_leaves(x: torch.Tensor, uniform: torch.Tensor, lengths: list[int], level: int):
    """QSGD's value distortion of each of the consecutive pieces of the flat
    f32 ``x`` that ``lengths`` cut it into, all in a few launches: each
    piece's abs-max scale, the stochastic rounding against ``uniform`` (one
    draw a value, aligned with ``x``), and the JAX package's ``sign(x) * q
    / level * scale`` as its session's compiled program evaluates it,
    ``(sign(x) * q) * (scale * fl(1/level))`` (the reassociation R7 records
    for the packed decode); a one-value piece, whose abs-max XLA folds
    away, as ``((sign(x) * q) * fl(1/level)) * scale``.  Each piece's scale
    is repeated over its elements, so every element takes one piece's
    operations.  QSGD is elementwise but for its scale: the pieces may be
    in any layout as long as ``uniform`` follows it."""
    counts = torch.tensor(lengths, device=x.device)
    scale = torch.clamp(torch.segment_reduce(x.abs(), "max", lengths=counts), min=1e-12)
    scale_e = torch.repeat_interleave(scale, counts, output_size=x.numel())
    q = _round(x, scale_e, uniform, level)
    reciprocal = _constant(np.float32(1.0) / np.float32(level), x.device)  # fl(1/level)
    signed = torch.sign(x) * q
    out = signed * (scale_e * reciprocal)
    if 1 in lengths:
        single = torch.repeat_interleave(counts == 1, counts, output_size=x.numel())
        out = torch.where(single, (signed * reciprocal) * scale_e, out)
    return out


#: NNADQ's closed-form bit choice ``2^b = 32 ln2 std / w``: the constant in
#: f32, as the JAX package's Python float meets its f32 std
_NNADQ_C = np.float32(32.0 * math.log(2.0))
#: ``fl(1 / fl(ln 2))``: the compiled ``log2(v)`` is ``log(v)`` times it
_INV_LN2 = np.float32(1.0) / np.float32(math.log(2.0))


def nnadq_quantize_dequantize(x: torch.Tensor, weight: float) -> tuple[torch.Tensor, torch.Tensor]:
    """NNADQ's value distortion without packing of one tensor
    (:func:`nnadq_quantize_dequantize_leaves` over one piece): ``(dequantized
    in x's dtype, bits)``, ``bits`` an f32 scalar tensor."""
    flat = x.reshape(-1).to(torch.float32)
    out, bits = nnadq_quantize_dequantize_leaves(flat, [flat.numel()], weight)
    return out.reshape(x.shape).to(x.dtype), bits[0]


def nnadq_quantize_dequantize_leaves(x: torch.Tensor, lengths: list[int], weight: float):
    """NNADQ's value distortion without packing of each of the consecutive
    pieces of the flat f32 ``x`` that ``lengths`` cut it into, all in a few
    launches: a piece's bit width ``clip(round(log2(max(32 ln2 std /
    weight, 1) + 1)), 2, 16)`` from its population std (ddof 0), then
    deterministic rounding to ``2^bits - 1`` levels over its ``[min,
    max]``, each piece's values repeated over its elements.  Returns
    ``(dequantized [N], bits [pieces])`` with no host sync.

    The arithmetic is the JAX package's as its session's compiled round
    program evaluates it: ``log2`` as ``log`` times ``fl(1/ln 2)``, and the
    dequantization ``q / levels * span + lo`` with its last multiply and
    add fused (one rounding; taken in f64 here, where the product is exact)."""
    pieces = torch.split(x, lengths)
    std = torch.stack([torch.std(piece, correction=0) for piece in pieces])
    counts = torch.tensor(lengths, device=x.device)
    lo = torch.segment_reduce(x, "min", lengths=counts)
    hi = torch.segment_reduce(x, "max", lengths=counts)
    c, w, inv_ln2 = (_constant(v, x.device) for v in (_NNADQ_C, weight, _INV_LN2))
    b = torch.log(torch.clamp(c * std / w, min=1.0) + 1.0) * inv_ln2
    bits = torch.clamp(torch.round(b), 2.0, 16.0)
    levels = torch.pow(2.0, bits) - 1.0
    span = torch.clamp(hi - lo, min=1e-12)
    lo_e, span_e, levels_e = (torch.repeat_interleave(v, counts, output_size=x.numel()) for v in (lo, span, levels))
    q = torch.round((x - lo_e) / span_e * levels_e)
    out = ((q / levels_e).double() * span_e.double() + lo_e.double()).to(torch.float32)
    return out, bits


def _decode_consecutive(packed, signs, scale, level: int, bits: int, n: int) -> torch.Tensor:
    """The consecutive layout's decode in XLA's order of the JAX package's
    ``q / level * scale``: ``q * (scale * fl(1/level))`` for one scale
    (``ops/qsgd.py::decode_step``), ``(q * fl(1/level)) * scales`` for
    per-element scales, so decodes are bit-equal to the reference's."""
    q = _unpack_uint(packed, bits, n).to(torch.float32)
    s = _unpack_uint(signs, 1, n).to(torch.float32)
    if scale.numel() == 1:
        magnitude = q * qsgd.decode_step(scale, level).reshape(())
    else:
        magnitude = q * qsgd.level_reciprocal(level, q.device) * scale
    return magnitude * (1.0 - 2.0 * s)


def _wire_bytes(enc: dict) -> int:
    """Bytes a leaf puts on the wire: its tensors, u32 words and f32
    scalars (QSGD's words, signs and scales; NNADQ's words, ``lo`` and
    ``span``), 4 bytes a value."""
    return 4 * sum(v.numel() for v in enc.values() if isinstance(v, torch.Tensor))


def stochastic_quantization(quantization_level: int = 255, random: CodecRandom | None = None):
    """``(quant, dequant)`` closures over parameter dicts."""
    level = int(quantization_level)
    bits = max(1, math.ceil(math.log2(level + 1)))
    source = random if random is not None else CodecRandom()

    def quant(tree: Mapping[str, torch.Tensor], seed: int = 0, key=None, fold_indices=None,
              flat: bool = False) -> dict:
        """Encode ``tree``; see the module docstring for the branches.
        ``fold_indices`` maps each name to its position in the FULL
        parameter dict (a kept-block subset still draws by position)."""
        names = sorted(tree)
        if flat and key is None and len(tree) > 1:
            layout = ParamVecLayout.of(tree)
            vec = layout.flatten(tree)
            sizes = [int(np.prod(s)) if s else 1 for s in layout.shapes]
            seg = torch.repeat_interleave(
                torch.arange(len(sizes), device=vec.device), torch.tensor(sizes, device=vec.device)
            )
            scales = torch.zeros(len(sizes), dtype=torch.float32, device=vec.device)
            scales = scales.scatter_reduce(0, seg, vec.abs(), "amax", include_self=False)
            scales = torch.clamp(scales, min=1e-12)
            q = _round(vec, scales[seg], source.flat_uniform(seed, vec.shape, vec.device), level)
            leaf = {
                "packed": _pack_uint(q, bits),
                "signs": _pack_uint(vec < 0, 1),
                "scales": scales,
                "shape": (layout.size,),
                "dtype": torch.float32,
                "pallas": False,
            }
            return {"leaves": [leaf], "level": level, "flat_layout": layout}
        count = max(1, len(names))
        encoded = []
        for i, name in enumerate(names):
            leaf = tree[name]
            flat_leaf = leaf.detach().reshape(-1).to(torch.float32)
            leaf_pallas = key is None and flat_leaf.numel() >= KERNEL_MIN_ELEMENTS
            if leaf_pallas:
                leaf_seed = (seed * 100003 + i) % 0x7FFFFFFF  # int32-safe, as on the TPU
                rows = qsgd.rows_for(flat_leaf.numel(), bits)
                packed, signs, scale = qsgd.qsgd_encode(
                    flat_leaf.contiguous(), leaf_seed, level, bits,
                    rand_bits=source.kernel_bits(leaf_seed, rows, flat_leaf.device),
                )
            else:
                if key is None:
                    rnd = source.leaf_uniform(seed, i, count, flat_leaf.shape, flat_leaf.device)
                elif isinstance(key, SessionKey):
                    index, total = (i, count) if fold_indices is None else (fold_indices[name], len(fold_indices))
                    rnd = source.session_uniform(
                        key.seed, key.aggregate, key.slot, index, total, flat_leaf.shape, flat_leaf.device
                    )
                else:
                    fold = None if fold_indices is None else fold_indices[name]
                    rnd = source.keyed_uniform(key, i, count, flat_leaf.shape, flat_leaf.device, fold)
                scale = torch.clamp(flat_leaf.abs().max(), min=1e-12) if flat_leaf.numel() else (
                    torch.tensor(1e-12, device=flat_leaf.device)
                )
                q = _round(flat_leaf, scale, rnd, level)
                packed, signs = _pack_uint(q, bits), _pack_uint(flat_leaf < 0, 1)
            encoded.append(
                {
                    "packed": packed,
                    "signs": signs,
                    "scale": scale,
                    "shape": tuple(leaf.shape),
                    "dtype": leaf.dtype,
                    "pallas": leaf_pallas,
                }
            )
        return {"keys": names, "leaves": encoded, "level": level}

    def dequant(blob: dict) -> dict[str, torch.Tensor]:
        decoded = []
        for enc in blob["leaves"]:
            n = int(np.prod(enc["shape"])) if enc["shape"] else 1
            if "scales" in enc:
                layout = blob["flat_layout"]
                sizes = [int(np.prod(s)) if s else 1 for s in layout.shapes]
                scales = enc["scales"]
                per_element = torch.repeat_interleave(scales, torch.tensor(sizes, device=scales.device))
                flat = _decode_consecutive(enc["packed"], enc["signs"], per_element, blob["level"], bits, n)
            elif enc["pallas"]:
                flat = qsgd.qsgd_decode(enc["packed"], enc["signs"], enc["scale"], blob["level"], bits, n)
            else:
                flat = _decode_consecutive(enc["packed"], enc["signs"], enc["scale"], blob["level"], bits, n)
            decoded.append(flat.reshape(enc["shape"]).to(enc["dtype"]))
        if "flat_layout" in blob:
            return dict(blob["flat_layout"].split(decoded[0]))
        return dict(zip(blob["keys"], decoded))

    return quant, dequant


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 tensors rounded once to f32, as a fused
    multiply-add rounds it.  The product is exact in f64; the f64 sum is
    rounded to odd (its error found exactly by Knuth's TwoSum, and an
    inexact even result moved one step toward the exact value), and
    rounding a value rounded to odd with 29 more bits to f32 rounds the
    exact value once (Boldo and Melquiond)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).to(torch.float32)


class NNADQ:
    """NNADQ's packed codec over parameter dicts (the threaded FedOBD's
    transport; the JAX package's ``NNADQ``): per leaf, a bit width from
    its population std, ``clip(round(log2(max(32 ln2 std / weight, 1) +
    1)), 2, 16)`` (2 for a std of 0), taken in f64 on the host from the f32
    std as the JAX codec takes it; deterministic rounding of
    ``(x - lo) / span`` to ``2^bits - 1`` levels over the leaf's ``[lo,
    hi]`` (``span = max(hi - lo, 1e-12)``); the levels packed ``32 //
    bits`` to a u32 word.  A leaf's blob holds ``packed``, ``lo``,
    ``span``, ``bits``, ``shape`` and ``dtype``; the wire counts its words
    and its two f32 scalars.

    A message's stds are read in one device-to-host transfer.  Decode is
    the JAX codec's ``q / levels * span + lo`` as XLA compiles it on the
    CPU: ``fma(q, span * fl(1/levels), lo)``, rounded once
    (:func:`_fma_f32`).  (XLA compiles a leaf of one value otherwise, but
    such a leaf always codes level 0 and decodes to ``lo`` either way.)
    (The SPMD session's closed form,
    :func:`nnadq_quantize_dequantize_leaves`, follows its own compiled
    program, which does not reassociate.)  ``flat=True`` codes a
    dict of more than one leaf as one vector in layout order: one width
    for the whole model."""

    def __init__(self, weight: float = 0.01) -> None:
        self.weight = float(weight)

    def _choose_bits(self, std: float) -> int:
        if std <= 0:
            return 2
        b = math.log2(max(32.0 * math.log(2.0) * std / self.weight, 1.0) + 1.0)
        return int(min(16, max(2, round(b))))

    @staticmethod
    def _encode_leaf(flat: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        lo, hi = torch.aminmax(flat)
        span = torch.clamp(hi - lo, min=1e-12)
        q = torch.round((flat - lo) / span * float((1 << bits) - 1))
        return _pack_uint(q, bits), lo, span

    @staticmethod
    def _decode_leaf(packed, lo, span, bits: int, n: int) -> torch.Tensor:
        q = _unpack_uint(packed, bits, n).to(torch.float32)
        step = span * _constant(np.float32(1.0) / np.float32((1 << bits) - 1), span.device)
        return _fma_f32(q, step, lo)

    def quant(self, tree: Mapping[str, torch.Tensor], flat: bool = False) -> dict:
        if flat and len(tree) > 1:
            layout = ParamVecLayout.of(tree)
            blob = self.quant({"__param_vec__": layout.flatten(tree)})
            blob["flat_layout"] = layout
            return blob
        names = sorted(tree)
        leaves = [tree[name].detach().reshape(-1).to(torch.float32) for name in names]
        stds = torch.stack([leaf.std(correction=0) for leaf in leaves]).tolist()  # the message's one sync
        encoded = []
        for name, leaf, std in zip(names, leaves, stds):
            bits = self._choose_bits(std)
            packed, lo, span = self._encode_leaf(leaf, bits)
            encoded.append({"packed": packed, "lo": lo, "span": span, "bits": bits,
                            "shape": tuple(tree[name].shape), "dtype": tree[name].dtype})
        return {"keys": names, "leaves": encoded}

    def dequant(self, blob: dict) -> dict[str, torch.Tensor]:
        decoded = {}
        for name, enc in zip(blob["keys"], blob["leaves"]):
            n = int(np.prod(enc["shape"])) if enc["shape"] else 1
            flat = self._decode_leaf(enc["packed"], enc["lo"], enc["span"], enc["bits"], n)
            decoded[name] = flat.reshape(enc["shape"]).to(enc["dtype"])
        if "flat_layout" in blob:
            return dict(blob["flat_layout"].split(decoded["__param_vec__"]))
        return decoded


def blob_nbytes(blob: dict) -> int:
    """Wire bytes of an encoded blob: every leaf's words and scales (the
    JAX package's ``param_nbytes`` over the blob's arrays)."""
    return sum(_wire_bytes(enc) for enc in blob["leaves"])


def check_compression_ratio(original: Mapping[str, torch.Tensor], encoded: dict) -> float:
    """Compressed bytes / original bytes; a per-leaf scale (NNADQ: ``lo``
    and ``span``) counts 8 bytes, a flat blob's per-tensor scales 4 bytes
    each, as in the JAX package."""
    original_bytes = max(1, sum(t.numel() * t.element_size() for t in original.values()))
    encoded_bytes = 0
    for enc in encoded["leaves"]:
        encoded_bytes += 4 * sum(enc[k].numel() for k in ("packed", "signs") if k in enc)
        encoded_bytes += 4 * enc["scales"].numel() if "scales" in enc else 8
    return encoded_bytes / original_bytes
