"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, all at once) and print the build time and register use;
2. hold each kernel against its plain PyTorch version on the card, at the
   FedAvg ViT-small round's shapes and at the edge shapes the kernels must
   cover, and time kernel, plain version, bound and one library call
   (a yardstick only: the port never calls it);
3. a small FedAvg task (ViT-small, f32) on the card against the same task
   on the CPU, where the kernels' plain versions run;
4. the main path: ``train()`` on the dense-shape configuration (FedAvg,
   CIFAR-10, ViT-small at full width, 10 clients x 512 samples, batch 128,
   ``client_chunk`` 2, ``use_amp``) for 2 rounds, with every launch counter
   set to 0 just before and read just after; then one more training round
   of that configuration under ``torch.profiler``, for where the time goes;
5. one JSON line with every kernel's numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

TF32 is switched off for matrix products and convolutions, so f32 checks
compare f32 arithmetic.  It exits non-zero without a result where
``torch.cuda.is_available()`` is False or the port's package is missing.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "distributed_learning_simulator_tpu_torch"

# the card's published peaks (H100 SXM data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # f32: outside the tensor cores

ROUNDS = 2
WORKERS, SAMPLES, BATCH, CHUNK = 10, 512, 128, 2


def check(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card, by CUDA events around ``iters``
    back-to-back calls (warm L2, as the training step leaves it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def dense_config(save_dir: str, **fields):
    """``bench.py::make_vit_config``: the JAX package's dense-shape cell."""
    from distributed_learning_simulator_tpu_torch.config import DistributedTrainingConfig

    base = dict(
        dataset_name="CIFAR10",
        model_name="vit_small",
        distributed_algorithm="fed_avg",
        executor="spmd",
        worker_number=WORKERS,
        batch_size=BATCH,
        round=ROUNDS,
        epoch=1,
        learning_rate=0.1,
        use_amp=True,
        dataset_kwargs={"train_size": WORKERS * SAMPLES, "val_size": 64, "test_size": 256},
        algorithm_kwargs={"client_chunk": CHUNK},
        save_dir=save_dir,
        log_file=os.path.join(save_dir, "train.log"),
    )
    base.update(fields)
    return DistributedTrainingConfig(**base)


def param_count() -> int:
    import torch

    from distributed_learning_simulator_tpu_torch.data import create_dataset_collection
    from distributed_learning_simulator_tpu_torch.models import create_model_context
    from distributed_learning_simulator_tpu_torch.ops.pytree import ParamVecLayout

    config = dense_config("", dataset_kwargs={"train_size": 8, "val_size": 8, "test_size": 8})
    ctx = create_model_context("vit_small", create_dataset_collection(config), torch.device("cpu"))
    return ParamVecLayout.of(ctx.module.state_dict()).size


def check_weighted_accum(d: int, gen) -> dict:
    """K1 against its plain version: the round's [2, D] chunk in bf16 and
    f32 (rows on a padded stride, as the session lays them out), an
    unaligned stride, and a ragged small case."""
    import torch

    from distributed_learning_simulator_tpu_torch.ops import weighted_accum as wa

    row_stride = -(-d // 64) * 64
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        for c, n, ld in ((CHUNK, d, row_stride), (CHUNK, d, d), (3, 1001, 1003)):
            x = torch.randn(c, ld, generator=gen, device="cuda").to(dtype)[:, :n]
            w = torch.rand(c, generator=gen, device="cuda") * SAMPLES
            out, ref = wa.weighted_accum(x, w), wa.weighted_accum_plain(x, w)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            # f32 accumulation of exact row values in the same order; fma
            # versus multiply-then-add moves the last bit or two
            tol = 1e-6 * max(1.0, float(ref.abs().max()))
            print(f"K1 {str(dtype)[6:]} [{c}, {n}] stride {ld}: max_abs_err {err:.3g} (tol {tol:.3g})")
            check(err <= tol, f"weighted_accum {dtype} [{c},{n}] err {err}")
            if (n, ld) == (d, row_stride) and dtype == torch.bfloat16:
                itemsize = x.element_size()
                bound, by = bound_ms(c * n * itemsize + 4 * c + 4 * n, 2 * c * n, "float32")
                xd = x.contiguous()
                result = {
                    "max_abs_err": err,
                    "ms": cuda_ms(lambda: wa.weighted_accum(x, w)),
                    "plain_ms": cuda_ms(lambda: wa.weighted_accum_plain(x, w)),
                    "bound_ms": bound,
                    "bound_by": by,
                    "library_ms": cuda_ms(lambda: w.to(dtype) @ xd),
                    "shape": f"[{c}, {n}] bf16",
                }
    return result


def check_short_attention(gen) -> tuple[dict, dict]:
    """K4 and K5 against their plain versions at the round's shape (both
    dtypes) and the edge shapes: S = 50 with a kv_mask, Dh = 128, S = 1024."""
    import torch
    import torch.nn.functional as F

    from distributed_learning_simulator_tpu_torch.ops import short_attention as sa

    cases = [
        (BATCH, 64, 6, 64, False, torch.bfloat16),
        (BATCH, 64, 6, 64, False, torch.float32),
        (8, 50, 6, 64, True, torch.bfloat16),
        (8, 50, 6, 64, True, torch.float32),
        (8, 128, 4, 128, False, torch.bfloat16),
        (8, 128, 4, 128, True, torch.float32),
        (2, 1024, 6, 64, True, torch.bfloat16),
        (2, 1024, 6, 64, False, torch.float32),
    ]
    fwd_row, bwd_row = {}, {}
    for b, s, h, dh, masked, dtype in cases:
        d = h * dh
        qkv = torch.randn(b, s, 3 * d, generator=gen, device="cuda").to(dtype)
        dout = torch.randn(b, s, d, generator=gen, device="cuda").to(dtype)
        mask = None
        if masked:
            mask = (torch.rand(b, s, generator=gen, device="cuda") > 0.3).float()
            mask[:, 0] = 1.0
        out, lse = sa.short_attention_fwd(qkv, h, mask)
        ref_out, ref_lse = sa.short_attention_fwd_plain(qkv, h, mask)
        dqkv = sa.short_attention_bwd(qkv, dout, lse, h, mask)
        ref_dqkv = sa.short_attention_bwd_plain(qkv, dout, ref_lse, h, mask)
        torch.cuda.synchronize()
        errs = (max_err(out, ref_out), max_err(lse, ref_lse), max_err(dqkv, ref_dqkv))
        # f32: summation order only.  bf16: p and dS are rounded to bf16 on
        # both sides, so a value at a rounding boundary moves an output by
        # one bf16 ulp (2^-7 at magnitudes 1-2, 2^-5 up to 8)
        tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
        print(
            f"K4/K5 {str(dtype)[6:]} B={b} S={s} H={h} Dh={dh} mask={masked}: max_abs_err "
            f"out {errs[0]:.3g} lse {errs[1]:.3g} dqkv {errs[2]:.3g} (tol {tol:g}, lse 1e-5)"
        )
        check(errs[0] <= tol and errs[2] <= tol and errs[1] <= 1e-5, f"short_attention {b,s,h,dh,dtype}")
        if (b, s, h, dh, dtype) != (BATCH, 64, 6, 64, torch.bfloat16):
            continue
        itemsize, name = qkv.element_size(), "bfloat16"
        mm = 2 * b * h * s * s * dh  # one [S, S] x [S, Dh] product, all heads
        fwd_bound = bound_ms(b * s * 3 * d * itemsize + b * s * d * itemsize + b * h * s * 4, 2 * mm, name)
        bwd_bound = bound_ms(
            b * s * 3 * d * itemsize * 2 + b * s * d * itemsize + b * h * s * 4, 5 * mm, name
        )
        q, k, v = (t.view(b, s, h, dh).transpose(1, 2).contiguous() for t in qkv.split(d, -1))
        do4 = dout.view(b, s, h, dh).transpose(1, 2).contiguous()
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
        fwd_row = {
            "max_abs_err": max(errs[0], errs[1]),
            "ms": cuda_ms(lambda: sa.short_attention_fwd(qkv, h, mask)),
            "plain_ms": cuda_ms(lambda: sa.short_attention_fwd_plain(qkv, h, mask)),
            "bound_ms": fwd_bound[0],
            "bound_by": fwd_bound[1],
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            "shape": f"qkv [{b}, {s}, {3 * d}] bf16",
        }
        bwd_row = {
            "max_abs_err": errs[2],
            "ms": cuda_ms(lambda: sa.short_attention_bwd(qkv, dout, lse, h, mask)),
            "plain_ms": cuda_ms(lambda: sa.short_attention_bwd_plain(qkv, dout, lse, h, mask)),
            "bound_ms": bwd_bound[0],
            "bound_by": bwd_bound[1],
            "library_ms": cuda_ms(
                lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do4, retain_graph=True)
            ),
            "shape": f"qkv, dout [{b}, {s}, {3 * d}], [{b}, {s}, {d}] bf16",
        }
    return fwd_row, bwd_row


def check_small_task_against_cpu(workdir: str) -> None:
    """A small f32 FedAvg task (ViT-small, 2 clients x 32 samples, 1 round)
    from one init, on the card (kernels) and on the CPU (plain versions)."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.data import create_dataset_collection
    from distributed_learning_simulator_tpu_torch.engine.engine import ComputeEngine
    from distributed_learning_simulator_tpu_torch.engine.hyper_parameter import HyperParameter
    from distributed_learning_simulator_tpu_torch.models import convert, create_model_context
    from distributed_learning_simulator_tpu_torch.training import train

    small = dict(
        worker_number=2,
        batch_size=16,
        round=1,
        learning_rate=0.05,
        use_amp=False,
        dataset_kwargs={"train_size": 64, "val_size": 16, "test_size": 32},
    )
    init = os.path.join(workdir, "init.npz")
    config = dense_config(os.path.join(workdir, "init"), **small)
    ctx = create_model_context("vit_small", create_dataset_collection(config), torch.device("cpu"))
    np.savez(init, **convert.to_jax(ComputeEngine(ctx, HyperParameter(), 1).init_params(0)))
    results = {}
    for device in ("cuda", "cpu"):
        cfg = dense_config(
            os.path.join(workdir, device),
            algorithm_kwargs={"client_chunk": CHUNK, "global_model_path": init},
            **small,
        )
        perf = train(cfg, device=device)["performance"][1]
        with np.load(os.path.join(cfg.save_dir, "aggregated_model", "round_1.npz")) as blob:
            results[device] = (perf, {k: blob[k] for k in blob.files})
    (gpu_perf, gpu_params), (cpu_perf, cpu_params) = results["cuda"], results["cpu"]
    param_err = max(float(np.abs(gpu_params[k] - cpu_params[k]).max()) for k in cpu_params)
    loss_rel = abs(gpu_perf["test_loss"] - cpu_perf["test_loss"]) / abs(cpu_perf["test_loss"])
    print(
        f"small task card vs CPU: test loss {gpu_perf['test_loss']:.6f} vs {cpu_perf['test_loss']:.6f}"
        f" (rel {loss_rel:.2g}), accuracy {gpu_perf['test_accuracy']} vs"
        f" {cpu_perf['test_accuracy']}, max |param diff| {param_err:.3g}"
    )
    # f32 on both (TF32 off); 4 SGD steps of a 12-layer model in other
    # summation orders
    check(loss_rel <= 1e-3 and param_err <= 1e-3, "small task: card and CPU disagree")


def _kernel_group(name: str) -> str:
    if any(k in name for k in ("fwd_kernel", "dq_kernel", "dkv_kernel", "weighted_accum_kernel")):
        return "port kernels (K1, K4, K5)"
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "cublas", "gemv", "nvjet")):
        return "matrix products (cuBLAS)"
    if any(k in name.lower() for k in ("conv", "cudnn")):
        return "patch convolution (cuDNN)"
    if "layer_norm" in name.lower() or "gammabeta" in name.lower():
        return "layer norm"
    return "elementwise, reductions, copies"


def profile_round(workdir: str) -> None:
    """Where a steady round's time goes: a warm-up round, one round timed
    alone, then one round under ``torch.profiler``; prints the device's
    busy share and its time by kernel group and by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_learning_simulator_tpu_torch.training import build_session

    session = build_session(dense_config(os.path.join(workdir, "profile"), round=1))
    vec = session._init_global_params()
    weights = session._base_weight_row(1)
    vec = session.run_round(vec, weights)  # warm-up: library handles, autotuning
    torch.cuda.synchronize()
    t0 = time.monotonic()
    vec = session.run_round(vec, weights)
    torch.cuda.synchronize()
    plain_wall = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        vec = session.run_round(vec, weights)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    device = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    print(
        f"profile: training round (no eval) {plain_wall:.3f} s alone, {wall:.3f} s profiled;"
        f" device busy {busy:.3f} s = {busy / wall:.1%} of the profiled round"
    )
    groups: dict[str, float] = {}
    for e in device:
        key = _kernel_group(e.key)
        groups[key] = groups.get(key, 0.0) + e.self_device_time_total / 1e6
    for key, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {key}: {t * 1e3:.1f} ms ({t / busy:.1%} of device time)")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        print(f"{PACKAGE}/ is not beside chip_smoke.py", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: no card to run on", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    import numpy as np

    from distributed_learning_simulator_tpu_torch.ops import build
    from distributed_learning_simulator_tpu_torch.ops import short_attention as sa
    from distributed_learning_simulator_tpu_torch.ops import weighted_accum as wa
    from distributed_learning_simulator_tpu_torch.training import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.monotonic()
    reports = build.build(["weighted_accum", "short_attention"])
    print(f"build: {time.monotonic() - t0:.1f} s")
    for name, text in reports.items():
        regs = [line.split(":", 1)[1].strip() for line in text.splitlines() if "registers" in line]
        print(f"  {name}.cu: {'; '.join(regs)}")

    # 2. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = param_count()
    k1 = check_weighted_accum(d, gen)
    k4, k5 = check_short_attention(gen)

    # 3. a small task on the card against the CPU
    os.makedirs(os.path.join(ROOT, "session"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "session"))
    check_small_task_against_cpu(workdir)

    # 4. the main path
    config = dense_config(os.path.join(workdir, "main"))
    torch.cuda.reset_peak_memory_stats()
    wa.launches = sa.fwd_launches = sa.bwd_launches = 0
    t0 = time.monotonic()
    perf = train(config)["performance"]
    wall = time.monotonic() - t0
    launches = {"K1": wa.launches, "K4": sa.fwd_launches, "K5": sa.bwd_launches}
    last = perf[ROUNDS]
    print(
        f"main path: {ROUNDS} rounds in {wall:.2f} s (setup included); round {ROUNDS}"
        f" {last['round_seconds']:.3f} s = {1 / last['round_seconds']:.3f} rounds/s;"
        f" test loss {last['test_loss']:.4f} accuracy {last['test_accuracy']:.4f};"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}"
    )
    for r, row in perf.items():
        check(np.isfinite(row["test_loss"]), f"round {r} test loss {row['test_loss']}")
        check(0.0 <= row["test_accuracy"] <= 1.0, f"round {r} accuracy {row['test_accuracy']}")
        check(row["test_count"] == 256.0, f"round {r} evaluated {row['test_count']} samples")
    check(launches["K1"] == ROUNDS * WORKERS // CHUNK, f"K1 launches {launches['K1']}")
    check(launches["K4"] > 0 and launches["K5"] > 0, f"attention launches {launches}")
    profile_round(workdir)

    # 5. the record
    src = f"{PACKAGE}/csrc"
    rows = [
        ("weighted_accum", "K1", f"{src}/weighted_accum.cu",
         "distributed_learning_simulator_tpu/ops/pallas_kernels.py:197", k1),
        ("short_attention_fwd", "K4", f"{src}/short_attention.cu",
         "distributed_learning_simulator_tpu/ops/short_attention.py:134", k4),
        ("short_attention_bwd", "K5", f"{src}/short_attention.cu",
         "distributed_learning_simulator_tpu/ops/short_attention.py:159", k5),
    ]
    kernels = [
        {"name": name, "id": kid, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[kid], "status": "ok", **numbers}
        for name, kid, source, replaces, numbers in rows
    ]
    print(json.dumps({"kernels": kernels, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
