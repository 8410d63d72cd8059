"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                    # everything below
    python3 chip_smoke.py --kernels          # phases 1-2 only, with the yardsticks
    python3 chip_smoke.py --checkpoint-cost  # phase 1, then bert_agnews.yaml's round
                                             # times with checkpoint_every 1 and 100
    python3 chip_smoke.py --flop-cost        # phase 1, then FlopCounterMode's cost on
                                             # a bert_agnews.yaml round
    python3 chip_smoke.py --telemetry        # phase 1, then phases 4, 4c and 4i with
                                             # their trace checks, and --flop-cost

Phases (any failure raises and exits non-zero; nothing is caught):

1. build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, all at once) and print the build time and register use; the
   wgmma kernels (``WGMMA_KERNELS``: K6-K8's ``fwd_wgmma_kernel``,
   ``dq_wgmma_kernel``, ``dkv_wgmma_kernel``, K9's, K10's and K11's 3xTF32
   ``fwd_tf32x3_kernel``, ``dq_tf32x3_kernel`` and ``dkv_tf32x3_kernel``, K4's
   ``short_fwd_wgmma_kernel`` and K5's ``short_bwd_wgmma_kernel``) must
   build without spills, and their SASS (``cuobjdump -sass``) must hold
   ``HGMMA`` and ``UTMALDG``;
2. hold each kernel against its plain PyTorch version on the card, at the
   FedAvg ViT-small round's shapes (K1, K4, K5), the DenseNet-40 round's
   K1 chunk (``[5, 578,090]`` f32), ``bert_agnews.yaml``'s K1 chunk
   (``[8, D]`` bf16 rows of ``bert_base``) and evaluation attention shape
   (K4, K5: ``(32, 128, 12, 64)`` with a key-padding mask, K4 on wgmma
   and K5 on FMA, each timed beside SDPA with the mask), the fed_obd_sq
   path's ``vit_base`` attention shape (K4, K5), at the long-context
   round's attention shape (K6-K8) and the f32 round's (K9-K11; also
   the f32 small task's), at the
   ViT-Base leaf sizes of the fed_obd_sq path (K2, K3: bit for bit, K2's
   in-kernel Philox against its own stream, and that stream against its
   plain numpy version), and at the edge shapes
   the kernels must cover (K2/K3 at 1 to 24 bits), and time
   kernel (K2-K5: their device time from the profiler, since a wrapper
   call's host cost is of its size; K1 also at the sign-SGD vote's and the
   Shapley subset's DenseNet-40 shapes, the vote exact, and at the graph
   session's round aggregate, ``[50, 9,231]`` f32, beside an empty
   kernel on the same grid; every K1 case called twice and bit-equal, on
   the variant ``ops/weighted_accum.py::plan`` gives it, with C = 1, 7 and
   50 and ragged ends on padded and unpadded rows), plain version,
   bound and one library
   call where one exists (a yardstick only: the port never calls it); K4,
   K5 and K6-K11 also check which kernel each case ran
   (``short_attention.fwd_route`` / ``bwd_route``: wgmma or FMA;
   ``kernel_route``: wgmma, mma.sync, 3xTF32, FMA; both bf16 families at
   Dh 32), and show the C entries refusing the wgmma and 3xTF32 routes
   off their layouts; faults planted at the graph shape (K1: a plan whose
   row groups miss rows, refused by the C entry, and a row group skipped),
   the ViT-small
   shape (two: K4 and K5), the main attention shape (two) and the f32
   task's shape (1xTF32 products), and two at the largest codec leaf, must
   fail the same comparisons.  ``--kernels`` adds the yardsticks: the
   kernels the Hopper ones replaced, timed beside them (the FMA K4 and
   K5, the mma.sync K6/K7/K8, the FMA K9/K10/K11, both bf16 families at
   Dh 32, K2's encode with a Philox call a value, K3's thread a value, at
   the largest leaf and K3's also at the path's smallest large leaf; K2
   with given bits and its two passes apart), the calls back to back and
   K5's host cost, and the kernels SDPA's f32 forward and backward launch;
3. small FedAvg tasks on the card against the same tasks on the CPU,
   where the kernels' plain versions run: ViT-small in f32, DenseNet-40
   (``conf/fed_avg/cifar10.yaml`` cut to 2 clients x 16 samples), and a narrow
   f32 ``LongContextTransformer`` at max_len 8192, the JAX package's
   stream tier, whose card run is the path of K9-K11 (launch counters set
   to 0 just before and read just after); a DenseNet-40 fed_obd task
   (``conf/fed_obd/cifar10.yaml`` cut to 2 clients x 16 samples, 1 round
   and 1 tuning epoch), held aggregate by aggregate in lockstep and run
   whole (``check_obd_task_against_cpu``); and a DenseNet-40
   fed_dropout_avg and a single_model_afd task (``conf/fed_dropout_avg/cifar10.yaml``
   and ``conf/smafd/cifar10.yaml`` cut the same way, 1 round; their keep
   masks drawn on the host: ``host_draws``); a DenseNet-40 sign_SGD task
   (``conf/sign_sgd/cifar10.yaml`` cut to 2 clients x 16 samples, 2
   epochs: each step's vote in lockstep, differing only by the flips a
   near-zero gradient allows, ``check_sign_sgd_task_against_cpu``) and a
   DenseNet-40 GTG task (``conf/gtg_sv/cifar10.yaml`` cut to 3 clients x 16
   samples and 64 test samples: the trained rows, every subset's metric
   and the Shapley values, ``check_shapley_task_against_cpu``); and a
   fed_gnn task (``conf/fed_gnn/cs.yaml`` cut to 4 workers and a 512-node
   graph, 2 rounds, its minibatches, fan-in priorities and dropout masks
   drawn on the host: every round's parameters and test loss within
   ``GNN_TOL``, ``received_mb`` equal, ``check_gnn_task_against_cpu``);
   and, round by round (``check_rounds_against_cpu``), an f32 BERT task
   (d_model 128, 2 heads, 2 layers, S = 32, dropout 0, 2 clients, 2
   rounds: K4 and K5 through the model) and a buffered LeNet5 task
   (``conf/fed_avg/mnist_buffered.yaml`` cut to 4 rounds, one corrupt
   client, ``update_guard`` on: the flush columns and ``rejected_updates``
   equal), K1 exact every round; then two recovery tasks
   (``check_recovery_against_cpu``): ``conf/fed_avg/mnist.yaml`` cut to 4
   rounds and a DenseNet-40 fed_obd task (1 round and 2 tuning epochs),
   each killed once on the card (``kill_after_rounds``: after round 2, the
   first tuning epoch for fed_obd, so its resume restores
   ``opt_state.npz`` onto the card) and recovered by
   ``train_with_recovery``, against the uninterrupted run on the CPU round
   by round, K1 exact over both attempts; then the threaded executor's
   methods (``check_threaded_tasks_against_cpu``): DenseNet-40 fed_obd
   (NNADQ, ``second_phase_epoch`` 1), fed_dropout_avg and sign_SGD card
   against CPU, and fed_paq threaded against the SPMD session on the card;
   and a keyed threaded fed_obd_sq task (``vit_small``, ``second_phase_epoch``
   1, ``flat_payload: false``) whose K2/K3 launches must be the protocol's
   0 and 0 (``check_keyed_obd_sq_launches``); then the threaded Shapley
   values and graph FL: a threaded GTG task (``conf/gtg_sv/mnist.yaml``
   cut to 3 clients x 64 samples, 1 round: the uploads within ``ROW_TOL``,
   every subset's ``correct`` equal and its test loss within 1e-5 in
   lockstep on the CPU's stack, the SV dicts equal where the subsets
   match, K1 exactly once a subset and once a round,
   ``check_threaded_shapley_task_against_cpu``) and a threaded fed_gnn task
   (``conf/fed_gnn/cs.yaml`` cut to 4 workers and a 512-node graph, 2
   rounds, ``batch_number`` 2, ``num_neighbor`` 4, the models' dropout 0:
   records and every round's npz within ``GNN_TOL``,
   ``graph_worker_stat.json`` equal field for field, no kernel,
   ``check_threaded_gnn_task_against_cpu``); then fault tolerance: a
   threaded LeNet5 FedAvg task (4 workers, 3 rounds, ``dropout_rate`` and
   ``corrupt_rate`` 0.25, stragglers at 0 s, ``update_guard``,
   ``min_client_quorum`` 1) card against CPU, its ``rejected_updates`` and
   ``dropped_clients`` equal, test loss within ``THREADED_LOSS_TOL``, and a
   planted lost quorum that must raise (``check_threaded_faults_against_cpu``);
   and the FedOBD and sign_SGD tasks again under dropout, corruption and
   the update guard, their rejections equal and K1 as without faults
   (``check_spmd_fault_tasks_against_cpu``);
4. the main paths, each with the launch counters set to 0 just before and
   read just after: ``train()`` on the dense-shape configuration (FedAvg,
   CIFAR-10, ViT-small at full width, 10 clients x 512 samples, batch 128,
   ``client_chunk`` 2, ``use_amp``) for 2 rounds; then ``train()`` on the long-context
   configuration (``lc_config``: imdb at max_len 8192, d_model 512, 8
   heads, 6 layers, 8 clients, ``use_amp``) for 2 rounds and on
   ``CausalLMTransformer`` for 1 round, with K6/K7/K8 launches checked
   exactly (and all on the wgmma kernels); then one full-width f32
   long-context round (``use_amp`` off: K9-K11, every forward, dq and
   dk/dv launch on the 3xTF32 kernels) (the profiles of these rounds and
   of 4f's went in PR 13 for the script's time: their numbers stand in
   ``PERF.md`` from earlier runs);
   every K4 and K5 launch of the ViT and
   fed_obd_sq main paths must take the Hopper forward and backward;
   then the threaded executor on ``conf/fed_obd_sq/vit_cifar100.yaml``
   (``vit_base``, 10 workers, 5 selected, QSGD per leaf: ``obd_config``)
   for 1 round and 2 tuning epochs, with K2/K3 launches checked against
   the count the protocol gives (``expected_qsgd_launches``); then
   ``conf/fed_avg/cifar10.yaml`` (DenseNet-40, 10 workers) as shipped
   but for ``round`` (1) and 1 local epoch of its 5, and ``imdb.yaml``
   and ``imagenet.yaml`` (each 1 of 5) and ``mnist.yaml`` for 1 round
   each (``CNN_EPOCHS``), with K1's launches checked exactly; then (4e)
   the SPMD session on the source paper's method as shipped but for
   ``round``, ``second_phase_epoch`` and ``SPMD_OBD_EPOCHS`` local epochs
   of 5 (``SPMD_OBD_RUNS``: ``conf/fed_obd/cifar10.yaml``
   for 1 round and 1 tuning epoch, ``fed_obd/vit_cifar100.yaml`` and
   ``fed_obd_sq/cifar100.yaml`` for 1 and 1, ``fed_paq/cifar10.yaml`` for
   1 round), each record's phase, time, test loss and wire MB printed,
   K1's launches checked exactly (``expected_obd_k1``) and on the ViT file
   every K4 and K5 launch on wgmma; then (4f) the source paper's method at
   its 100-client geometry (``LARGE_OBD_FILES``: ``conf/large_scale/fed_obd/
   {cifar10,cifar100,cifar100_sq,imdb}.yaml``, 100 workers, 50 selected,
   ``round_horizon`` 5, ``remat_policy: dots_saveable``) as shipped but for
   5 rounds and 2 tuning epochs (the DenseNet-40 file) or 1 and 1 (the others),
   each record's phase and K1's launches checked exactly; the horizon's parity (the DenseNet-40 file's run, made
   with cuDNN deterministic, against a run of it at ``round_horizon`` 1:
   every row and the final parameters equal bit for bit) and remat's (one
   phase-1 round of the DenseNet-40 and the classifier files without and
   with ``dots_saveable``: peak memory, round time, and the remat round
   equal to the plain one bit for bit); and the 12 FedDropoutAvg
   and SMAFD files (``SPARSE_FILES``) for one round each (the 100-worker
   ones at 1 local epoch of 5, the others too), K1 checked exactly; then (4g) the three sign_SGD
   files (``SIGN_SGD_FILES``) at 1 local epoch, K1 once a step
   (``round x epoch x n_batches``), and the eight Shapley-value files
   (``SHAPLEY_FILES``: GTG, hierarchical, multi-round) at 1 local epoch
   for 1 round (the two LeNet5 files 2; four DenseNet-40 files on the
   test splits of ``SHAPLEY_TEST_SPLITS``), each round's subsets and their
   seconds printed, K1 once a subset and once a round (no profiled GTG
   round, for the script's time: its numbers stand in ``PERF.md``); then
   (4h) the eight graph files
   (``GNN_FILES``: ``conf/fed_gnn/*``, ``conf/fed_gcn/cs.yaml``,
   ``conf/fed_aas/{cora,PubMed,dblp,reddit}.yaml``) as shipped but for 2
   rounds, each round's time, time a step, ``received_mb`` and accuracy
   and the peak memory printed, K1 once a round; ``conf/fed_aas/yelp.yaml``
   must raise the JAX package's KeyError; and a profiled
   ``fed_gnn/cs.yaml`` round; then (4i) ``large_scale/fed_avg/
   bert_agnews.yaml`` as shipped but for 2 rounds (``bert_base``, 1000
   workers, 100 selected, ``use_amp``, ``client_chunk: auto``, which
   misses the calibration and runs 8) under ``train_with_recovery``,
   killed after round 1: ``round_1.npz`` reloads bit-equal to round 1's
   master and attempt 1 starts from it bit for bit, the last record holds
   both rounds once; each round's time, test loss and accuracy, each
   attempt's setup time, each checkpoint's queue and write seconds, the
   peak memory, K1 exactly 125 a round over both attempts, every K4 launch
   on wgmma (one a layer per test batch per evaluation pass), no K5, and
   round 2's training profiled; and ``fed_avg/mnist_buffered.yaml`` as shipped
   but for 10 of its 20 rounds, each record's flush columns printed and K1 exactly
   ``n_chunks x (depth + 1)`` every round; then (4j) the shipped
   ``conf/{fed_paq,fed_obd,fed_dropout_avg,smafd,sign_sgd}/imdb.yaml``
   under ``executor: sequential`` at full width (``THREADED_FILES``: 1
   round of 1 local epoch, fed_obd's 1 tuning epoch), each record's phase,
   time, test loss and wire MB printed, no kernel launched; and
   ``fed_avg/mnist_buffered.yaml`` under ``executor: sequential`` at full
   width for 4 rounds, killed after round 2 and recovered by
   ``train_with_recovery`` (``run_threaded_buffered_recovery``: rounds 1-2's
   flush columns equal to 4i's replay and round 1 within
   ``BUFFERED_REPLAY_TOL`` of it, the resume from ``round_2.npz`` bit for
   bit, the drained rows after it, K1 once a non-empty flush, each flush's
   K1 mean within ``FLUSH_TOL`` of the plain f32 weighted sum of the same
   uploads on the card, the card's memory printed around the killed
   attempt); then (4k) the
   shipped ``conf/gtg_sv/mnist.yaml``, ``hierarchical_sv/mnist.yaml`` and
   ``multiround_sv/cifar10.yaml`` (``THREADED_SV_FILES``; the latter on the
   test split of ``SHAPLEY_TEST_SPLITS``) and
   ``conf/fed_gnn/cs.yaml``, ``fed_gcn/cs.yaml`` and ``fed_aas/cora.yaml``
   (``THREADED_GNN_FILES``) under ``executor: sequential`` at full width,
   1 round of 1 local epoch each: the round's seconds, the Shapley files'
   subsets and their seconds (K1 exactly ``subsets + 1``, the SV dict over
   every worker, ``shapley_values.json``), the graph files' exchanges and
   communicated MB (``batch_number`` exchanges a worker on fed_gnn and
   fed_gcn, none on fed_aas; no K1), no other kernel (the profiled
   threaded ``fed_gnn/cs.yaml`` run went for the script's time: its
   numbers stand in ``PERF.md``);
5. the script's wall time by phase and in all, one JSON line with every
   kernel's numbers, then, as the last line, ``{"ok": true, "device": {...}}``.

Every phase writes into a directory of its own under ``session/``, removed
when the phase ends (every SPMD round now writes its checkpoint).

Every ``train()`` call runs at the precision the port sets for itself
(``utils/device.py``: TF32 off for f32 matrix products and convolutions),
and phase 2's f32 checks run before any, on PyTorch's default of f32
matrix products, so f32 checks compare f32 arithmetic.  It exits non-zero without a result where
``torch.cuda.is_available()`` is False or the port's package is missing.
"""

import contextlib
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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}  # f32: outside the tensor cores
#: INT32 operations a second: 64 INT32 lanes an SM (H100 white paper) x 132
#: SMs x 1.98 GHz, the boost clock of the 67 TFLOP/s f32 peak (128 lanes x 2)
PEAK_INT32_OPS = 64 * 132 * 1.98e9
#: integer operations of one Philox4x32-10 call: 10 rounds of 2 high and 2
#: low 32-bit products, 4 xors and 2 key additions
PHILOX_OPS = 100

ROUNDS = 2
WORKERS, SAMPLES, BATCH, CHUNK = 10, 512, 128, 2
#: clients per K1 chunk on the shipped conf/fed_avg files: the session's
#: default of 8, lowered to a divisor of their 10 workers
CNN_CHUNK = 5
#: the shipped files of the CNN zoo and the text classifier that 4d runs
CNN_MAIN = "fed_avg/cifar10.yaml"
CNN_EXTRA = ("fed_avg/imdb.yaml", "fed_avg/imagenet.yaml", "fed_avg/mnist.yaml")
#: local epochs of the files that run a round long as shipped (ResNet-18's
#: 5 took 24 s, DenseNet-40's 12.8 s), cut for the script's time
CNN_EPOCHS = {"fed_avg/imagenet.yaml": 1, "fed_avg/cifar10.yaml": 1, "fed_avg/imdb.yaml": 1}
#: the client slots of the shipped sign-SGD and Shapley DenseNet-40 files
SV_SLOTS = 10
#: the client slots of the shipped conf/fed_gnn files (TwoGCN on Coauthor_CS)
GNN_SLOTS = 50


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


def host_ms(fn, iters: int = 200) -> float:
    """Host time per call of ``fn`` over ``iters`` calls back to back after
    a sync: what enqueueing a call costs the host while the card keeps up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e3


def kernel_device_ms(fn, names: tuple[str, ...] | None, iters: int = 20, warmup: int = 3, attempts: int = 3) -> float:
    """Device time per call of ``fn`` spent in the kernels whose names hold
    one of ``names`` (None: every kernel it launches), from
    ``torch.profiler`` over ``iters`` back-to-back calls (warm L2): the
    kernels' own time, without the host's cost of each call.  The
    profiler's schedule traces a warm-up step of ``iters`` calls first and
    keeps only the step after it, since the first kernels of a trace can
    go unrecorded while tracing starts; each step idles 50 ms on the host
    before its first call and after its sync, so kernels whose device
    timestamps lead or lag the host's clock still fall inside the step
    (unpadded traces have kept 0, 0, 14 and 16 of 20 K5 launches).  A step
    counts only if each named kernel ran once a call (None: at least one
    kernel a call); a trace that dropped launches all the same is taken
    again, up to ``attempts`` traces, and then fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        steps = schedule(wait=0, warmup=1, active=1, repeat=1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], schedule=steps) as prof:
            for _ in range(2):  # the warm-up step, then the one kept
                time.sleep(0.05)
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                time.sleep(0.05)
                prof.step()
        # the schedule's step annotation ("ProfilerStep#") spans the step, not device work
        device = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("ProfilerStep")]
        if names is None:
            counts = {"all kernels": sum(n for _, n, _ in device)}
            launched = counts["all kernels"] >= iters
        else:
            device = [d for d in device if any(name in d[0] for name in names)]
            counts = {name: sum(n for k, n, _ in device if name in k) for name in names}
            launched = all(c == iters for c in counts.values())
        total = sum(t for _, _, t in device)
        if launched and total > 0:
            if names is None:
                print("  device work of one profiled step: " + "; ".join(f"{k[:80]} x{n} {t:.1f} us" for k, n, t in device))
            return total / 1e3 / iters
        print(f"  profiled step {attempt} of {attempts}: kernels {counts} of {iters} calls, {total} us")
    check(False, f"profiled kernels {counts}, {total} us in each of {attempts} traces")


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound_ms(nbytes: float, flops: float, dtype: str) -> dict:
    """``bound_ms`` of K6-K11: in f32 the least time of products held to
    f32 accuracy on the tensor cores, three TF32 products for each
    (``max(bytes / 3.35 TB/s, 3 x flops / 495 TFLOP/s)``, ``bound_rate``
    3xTF32), with the FMA units' bound beside it as ``fma_bound_ms``; in
    bf16 the bf16 tensor-core bound."""
    if dtype != "float32":
        bound, by = bound_ms(nbytes, flops, dtype)
        return {"bound_ms": bound, "bound_by": by}
    bound, by = bound_ms(nbytes, 3 * flops, "tf32")
    return {"bound_ms": bound, "bound_by": by, "bound_rate": "3xTF32 at 495 TFLOP/s",
            "fma_bound_ms": bound_ms(nbytes, flops, "float32")[0]}


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


def param_count(model: str = "vit_small", dataset: str = "CIFAR10", **dataset_kwargs) -> int:
    import torch

    from distributed_learning_simulator_tpu_torch.data import create_dataset_collection
    from distributed_learning_simulator_tpu_torch.models import create_model_context
    from distributed_learning_simulator_tpu_torch.ops.pytree import ParamVecLayout

    config = dense_config(
        "", dataset_name=dataset,
        dataset_kwargs={"train_size": 8, "val_size": 8, "test_size": 8, **dataset_kwargs},
    )
    ctx = create_model_context(model, create_dataset_collection(config), torch.device("cpu"))
    return ParamVecLayout.of(ctx.module.state_dict()).size


def _k1_numbers(x, w, err: float, variant: str, device_time: bool = False, yardsticks: bool = True) -> dict:
    """K1's row at one shape: kernel, plain version and ``w @ X``, and the
    bound.  Times by CUDA events around calls back to back; with
    ``device_time`` (a shape whose call costs the host more than the
    card), ``ms`` is the profiler's device time per call and the events'
    time is ``call_ms``; with ``yardsticks`` too, likewise ``plain_ms`` and
    ``library_ms`` (``plain_call_ms``, ``library_call_ms``)."""
    from distributed_learning_simulator_tpu_torch.ops import weighted_accum as wa

    c, n = x.shape
    bound, by = bound_ms(c * n * x.element_size() + 4 * c + 4 * n, 2 * c * n, "float32")
    xd, wd = x.contiguous(), w.to(x.dtype)
    calls = {
        "ms": lambda: wa.weighted_accum(x, w),
        "plain_ms": lambda: wa.weighted_accum_plain(x, w),
        "library_ms": lambda: wd @ xd,
    }
    row = {"max_abs_err": err, "bound_ms": bound, "bound_by": by, "variant": variant}
    for key, fn in calls.items():
        row[key] = cuda_ms(fn)
        if device_time and (key == "ms" or yardsticks):
            row[key.replace("ms", "call_ms")] = row[key]
            names = ("weighted_accum_kernel",) if key == "ms" else None
            row[key] = kernel_device_ms(fn, names)
    dtype = {"torch.bfloat16": "bf16", "torch.float32": "f32"}[str(x.dtype)]
    return {**row, "shape": f"[{c}, {n}] {dtype}"}


def empty_kernel_ms(blocks: int, threads: int) -> float:
    """Device time of a launch of ``csrc/weighted_accum.cu``'s empty kernel
    on ``blocks`` x ``threads`` (the profiler's, calls back to back): the
    floor any kernel on that grid starts from."""
    import ctypes

    import torch

    from distributed_learning_simulator_tpu_torch.ops import build

    fn = build.load("weighted_accum").weighted_accum_empty
    fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        err = fn(blocks, threads, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"empty kernel launch: CUDA error {err}")

    return kernel_device_ms(launch, ("weighted_accum_empty_kernel",))


def _k1_rows(x, n: int, ld: int, padded: bool):
    """``[c, n]`` rows of ``x`` (``[c, ld]``) at row stride ``ld``; where not
    ``padded``, a view whose storage ends at the last row's ``n``-th value,
    so no padding past a row's end can be read."""
    if padded:
        return x[:, :n]
    c = x.shape[0]
    flat = x.reshape(-1)[: (c - 1) * ld + n].clone()
    return flat.as_strided((c, n), (ld, 1))


def check_weighted_accum(d: int, d_cnn: int, d_gnn: int, d_bert: int, gen, yardsticks: bool) -> dict:
    """K1 against its plain version: the ViT round's [2, D] chunk in bf16
    and f32 and the DenseNet-40 round's [5, D] chunk in f32 (rows on a
    padded stride, as the session lays them out), an unaligned stride, a
    ragged small case, the two DenseNet-40 shapes of the sign-SGD and
    Shapley sessions at their 10 slots: a step's vote (bf16 rows of -1, 0
    and +1, 0/1 weights: the sum must be exact) and a subset's stack (f32
    rows, a subset's mask times the dataset sizes), and the graph
    session's round aggregate (``conf/fed_gnn/cs.yaml``: TwoGCN's 9,231
    f32 values on 50 slots, an odd width the row stride pads).  Then the
    edges of the plan (``ops/weighted_accum.py::plan``): C = 1, 7 and 50
    at the graph's width (the split variant) and at DenseNet-40's (the
    stream variant), 7 and 50 rows not dividing among the row groups, and
    both widths' ragged ends (N % W != 0) on a padded stride and on rows
    whose storage ends at the last value (read lane by lane), in f32 and
    bf16.  Every case is called twice and must give the same bits, and
    must take the variant ``plan`` gives (``route_launches``).  A plan
    that skips a row group must be refused by the C entry, and a kernel
    that skips one (its rows' weights at 0) must fail the comparison.  The
    row's numbers are the ViT chunk's in bf16; ``densenet40``,
    ``sign_vote``, ``shapley_subset`` and ``fed_gnn`` hold the others', by
    device time, each with the variant it took, and ``fed_gnn`` also an
    empty kernel's time on the same grid (``empty_ms``); ``bert_base``
    holds ``large_scale/fed_avg/bert_agnews.yaml``'s chunk, ``[8, D]`` bf16
    rows of ``bert_base`` (about 1.76 GB), by events."""
    import torch

    from distributed_learning_simulator_tpu_torch.ops import weighted_accum as wa

    result = {}
    pad = lambda n: -(-n // 64) * 64  # noqa: E731  (the sessions' row stride)
    row_stride = pad(d)
    cases = [(dtype, c, n, ld, True, None) for dtype in (torch.bfloat16, torch.float32)
             for c, n, ld in ((CHUNK, d, row_stride), (CHUNK, d, d), (3, 1001, 1003))]
    cases += [(torch.float32, CNN_CHUNK, d_cnn, pad(d_cnn), True, "densenet40"),
              (torch.bfloat16, SV_SLOTS, d_cnn, pad(d_cnn), True, "sign_vote"),
              (torch.float32, SV_SLOTS, d_cnn, pad(d_cnn), True, "shapley_subset"),
              (torch.float32, GNN_SLOTS, d_gnn, pad(d_gnn), True, "fed_gnn"),
              (torch.bfloat16, BERT_CHUNK, d_bert, pad(d_bert), True, "bert_base")]
    cases += [(torch.float32, c, n, pad(n), True, None) for n in (d_gnn, d_cnn) for c in (1, 7, 50)]
    cases += [(dtype, 7, n, pad(n), padded, None) for dtype in (torch.float32, torch.bfloat16)
              for n in (d_gnn, d_cnn) for padded in (False, True) if dtype == torch.bfloat16 or not padded]
    # the sign-SGD, Shapley and graph shapes draw from their own stream, so
    # the earlier cases' inputs are those of the runs before them
    own = torch.Generator(device="cuda").manual_seed(13)
    for dtype, c, n, ld, padded, label in cases:
        draw = own if label in ("sign_vote", "shapley_subset", "fed_gnn") or c in (1, 7, 50) else gen
        if label == "bert_base":  # drawn in bf16 a row at a time: an f32 draw of all 8 rows is 3.5 GB
            draw = torch.Generator(device="cuda").manual_seed(16)  # its own stream, as for K4/K5
            x = torch.empty(c, ld, dtype=dtype, device="cuda")
            for row in x:
                row.copy_(torch.randn(ld, generator=draw, device="cuda"))
            x = _k1_rows(x, n, ld, padded)
        else:
            x = _k1_rows(torch.randn(c, ld, generator=draw, device="cuda").to(dtype), n, ld, padded)
        w = torch.rand(c, generator=draw, device="cuda") * SAMPLES
        exact = label == "sign_vote"
        if exact:  # a step's vote: gradient signs (in place: the session's padded rows) and 0/1 weights
            x.sign_()
            w = (torch.arange(c, device="cuda") % 4 != 3).float()
        elif label == "shapley_subset":  # a subset's mask times the dataset sizes
            w = torch.where(torch.arange(c, device="cuda") % 3 == 1, 0.0, torch.floor(w))
        elif label == "fed_gnn":  # the slots' node counts
            w = torch.floor(w)
        before = dict(wa.route_launches)
        out, again = wa.weighted_accum(x, w), wa.weighted_accum(x, w)
        ref = wa.weighted_accum_plain(x, w)
        torch.cuda.synchronize()
        took = [v for v, k in wa.route_launches.items() if k != before[v]]
        stride, aligned, extent = wa.layout(x)
        want = wa.plan(c, n, stride, x.dtype, aligned, extent)
        err = max_err(out, ref)
        # f32 accumulation of exact row values; the split variant adds its
        # row groups' partial sums in group order, and fma versus
        # multiply-then-add moves the last bit or two; a vote's sums are
        # small integers, exact in f32 in any order
        tol = 0.0 if exact else 1e-6 * max(1.0, float(ref.abs().max()))
        print(f"K1 {str(dtype)[6:]} [{c}, {n}] stride {ld}{'' if padded else ' (no padding)'}"
              f"{' ' + label if label else ''}: {want.variant} ({want.blocks} x {want.threads} threads, lanes"
              f" {want.lanes}, rows {want.rows}, vectors {want.vectors}, unroll {want.unroll}, padded end"
              f" {want.padded}): max_abs_err {err:.3g} (tol {tol:.3g})")
        check(err <= tol, f"weighted_accum {dtype} [{c},{n}] {label or ''} err {err}")
        check(torch.equal(out, again), f"weighted_accum {dtype} [{c},{n}] {label or ''}: two calls differ")
        check(took == [want.variant] and wa.route_launches[want.variant] == before[want.variant] + 2,
              f"weighted_accum {dtype} [{c},{n}]: took {took}, plan says {want.variant}")
        if (dtype, c, n, ld) == (torch.bfloat16, CHUNK, d, row_stride):
            result.update(_k1_numbers(x, w, err, want.variant))
            # the kernel's own device time, and a device-to-device copy of
            # the bytes K1 reads and writes (the rate the card streams a
            # read and write mix at), by events and by the profiler
            copy_in = torch.empty(c * n * x.element_size(), dtype=torch.uint8, device="cuda")
            copy_out = torch.empty_like(copy_in)
            result["device_ms"] = kernel_device_ms(lambda: wa.weighted_accum(x, w), ("weighted_accum_kernel",))
            result["copy_ms"] = cuda_ms(lambda: copy_out.copy_(copy_in))
            result["copy_device_ms"] = kernel_device_ms(lambda: copy_out.copy_(copy_in), None)
            print(f"  K1 at the ViT chunk: {result['ms']:.6f} ms by events, {result['device_ms']:.6f} ms device; a copy of"
                  f" the same bytes {result['copy_ms']:.6f} / {result['copy_device_ms']:.6f} ms; bound"
                  f" {result['bound_ms']:.6f} ms")
            del copy_in, copy_out
        elif label == "bert_base":  # a chunk of 1.76 GB: events time it well
            result[label] = _k1_numbers(x, w, err, want.variant)
            print(f"  K1 at bert_base's chunk: {result[label]['ms']:.4f} ms, w @ X {result[label]['library_ms']:.4f}"
                  f" ms, plain {result[label]['plain_ms']:.4f} ms, bound {result[label]['bound_ms']:.4f} ms"
                  f" ({result[label]['bound_ms'] / result[label]['ms']:.1%} of it)")
        elif label:
            # the graph shape: the library call by device time too, beside the kernel's
            result[label] = _k1_numbers(x, w, err, want.variant, device_time=True,
                                        yardsticks=yardsticks or label == "fed_gnn")
        if label == "fed_gnn":
            result[label]["empty_ms"] = empty_kernel_ms(want.blocks, want.threads)
            print(f"  K1 at the graph shape: {result[label]['ms']:.6f} ms on {want.blocks} x {want.threads} threads,"
                  f" an empty kernel there {result[label]['empty_ms']:.6f} ms, w @ X {result[label]['library_ms']:.6f}"
                  f" ms, bound {result[label]['bound_ms']:.6f} ms")
            check_k1_planted_faults(x, w, ref, tol, want)
    return result


def check_k1_planted_faults(x, w, ref, tol: float, p) -> None:
    """At the graph shape (the split variant): a plan whose row groups stop
    short of the last rows (a row fewer each) must be refused by the C
    entry before any work; and a kernel that skips row group 0 (the same
    plan, that group's weights at 0) must fail the comparison
    ``check_weighted_accum`` makes."""
    import dataclasses

    from distributed_learning_simulator_tpu_torch.ops import weighted_accum as wa

    short = dataclasses.replace(p, rows=p.rows - 1)
    try:
        wa._launch(x, w, short)
    except RuntimeError as e:
        print(f"planted fault at the graph shape, a plan of {32 // short.lanes} row groups of {short.rows} rows for"
              f" {x.shape[0]} rows: refused ({e})")
    else:
        check(False, "a plan whose row groups miss rows was launched")
    skipped = w.clone()
    skipped[: p.rows] = 0.0
    err = max_err(wa._launch(x, skipped, p), ref)
    print(f"planted fault at the graph shape, a kernel that skips row group 0 ({p.rows} rows): max_abs_err {err:.3g}"
          f" (tol {tol:.3g}; rejected)")
    check(err > tol, "a kernel that skips a row group passes the K1 check")


#: (B, S, H, Dh, masked, dtype) of the K4/K5 checks: the ViT-small round's
#: shape and the fed_obd_sq path's vit_base shape (batch 64, 12 heads, a
#: 2304-wide packed row) in both dtypes, then the edges: S = 50 with a
#: kv_mask (a partial tile, masked keys), Dh 128, S = 1024, and bf16 at
#: S = 128 and at S = 197 with a kv_mask (K4's two-pass walk with a full
#: and a partial last tile; K5 on its FMA route above S = 64), and last
#: bert_base's evaluation shape (``bert_agnews.yaml``: batch 32, S = 128,
#: 12 heads, a key-padding mask; the same routes)
SHORT_MAIN = (BATCH, 64, 6, 64, False, "bfloat16")
SHORT_BERT = (32, 128, 12, 64, True, "bfloat16")
SHORT_CASES = [
    SHORT_MAIN,
    (BATCH, 64, 6, 64, False, "float32"),
    (64, 64, 12, 64, False, "bfloat16"),
    (64, 64, 12, 64, False, "float32"),
    (8, 50, 6, 64, True, "bfloat16"),
    (8, 50, 6, 64, True, "float32"),
    (8, 128, 4, 128, False, "bfloat16"),
    (8, 128, 4, 128, True, "float32"),
    (2, 1024, 6, 64, True, "bfloat16"),
    (2, 1024, 6, 64, False, "float32"),
    (8, 128, 6, 64, False, "bfloat16"),
    (8, 197, 6, 64, True, "bfloat16"),
    SHORT_BERT,
]


def _short_blocks(dqkv, d: int) -> dict:
    """The dq, dk and dv blocks of a packed ``[B, S, 3·D]`` gradient."""
    return dict(zip(("dq", "dk", "dv"), dqkv.split(d, dim=-1)))


def _refused(call, what: str) -> None:
    """``call`` must raise the C entry's refusal (cudaErrorInvalidValue)."""
    try:
        call()
    except RuntimeError as err:
        check(str(err).endswith("CUDA error 1"), f"{what} refused with {err}")
    else:
        raise RuntimeError(f"chip smoke failed: {what} ran")


def check_short_attention(gen, yardsticks: bool) -> tuple[dict, dict]:
    """K4 and K5 against their plain versions at ``SHORT_CASES``; each
    case's kernels checked (``short_attention.fwd_route``: bf16 at Dh 64 the
    Hopper forward; ``bwd_route``: bf16 at Dh 64 and S <= 64 the Hopper
    backward; else FMA), bf16 also by the relative check of
    ``attention_mismatch`` on out and on each of the dq, dk and dv blocks;
    the C entries refuse the wgmma backward off its cases.  At the
    ViT-small shape a planted fault in each kernel (K4: p not rounded; K5:
    p and dS not rounded) must fail that check, and K4, K5 and SDPA's
    forward and backward are timed by their device time (the profiler's; a
    wrapper call's host cost is of the same size).  With ``yardsticks``
    also the FMA kernels they replaced (``fma_ms``), the calls back to back
    (``call_ms``, ``library_call_ms``) and K5's host cost."""
    import torch
    import torch.nn.functional as F

    from distributed_learning_simulator_tpu_torch.ops import short_attention as sa

    fwd_row, bwd_row = {}, {}
    for case in SHORT_CASES:
        b, s, h, dh, masked, dtype_name = case
        dtype, d = getattr(torch, dtype_name), h * dh
        # bert_base's case draws from a stream of its own: the later checks'
        # inputs stay those of the runs before it
        draw = torch.Generator(device="cuda").manual_seed(16) if case == SHORT_BERT else gen
        qkv = torch.randn(b, s, 3 * d, generator=draw, device="cuda").to(dtype)
        dout = torch.randn(b, s, d, generator=draw, device="cuda").to(dtype)
        mask = None
        if masked:
            mask = (torch.rand(b, s, generator=draw, device="cuda") > 0.3).float()
            mask[:, 0] = 1.0
        before = dict(sa.route_launches)
        out, lse = sa.short_attention_fwd(qkv, h, mask)
        ref_out, ref_lse = sa.short_attention_fwd_plain(qkv, h, mask)
        dqkv = sa.short_attention_bwd(qkv, dout, lse, h, mask)
        ref_dqkv = sa.short_attention_bwd_plain(qkv, dout, ref_lse, h, mask)
        torch.cuda.synchronize()
        routes = sorted(key for key, n in sa.route_launches.items() if n != before[key])
        fwd_family = "wgmma" if dtype == torch.bfloat16 and dh == 64 else "fma"
        bwd_family = "wgmma" if fwd_family == "wgmma" and s <= sa.WGMMA_BWD_MAX_S else "fma"
        want = sorted([f"fwd/{fwd_family}", f"bwd/{bwd_family}"])
        check(routes == want, f"short_attention {case} ran {routes}, want {want}")
        if bwd_family == "fma":  # the wgmma backward refuses f32, Dh 128 and S > 64
            _refused(lambda: sa._bwd(qkv, dout, lse, h, mask, "wgmma"), f"the wgmma backward at {case}")
        errs = (max_err(out, ref_out), max_err(lse, ref_lse), max_err(dqkv, ref_dqkv))
        # f32: summation order only.  bf16: p and dS are rounded to bf16 on
        # both sides, so a value at a rounding boundary moves an output by
        # one bf16 ulp (2^-7 at magnitudes 1-2, 2^-5 up to 8)
        tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
        rel = ""
        if dtype == torch.bfloat16:
            parts = [("out", out, ref_out)]
            parts += [(n, got, _short_blocks(ref_dqkv, d)[n]) for n, got in _short_blocks(dqkv, d).items()]
            rel_parts = []
            for name, got, want_t in parts:
                rel_max, rel_rms, ok = attention_mismatch(got, want_t, "bfloat16")
                rel_parts.append(f"{name} {rel_max:.2g}/{rel_rms:.2g}")
                check(ok, f"short_attention {case} {name}: max {rel_max:.3g} rms {rel_rms:.3g} of the reference's")
            rel = (f"; relative max/rms {', '.join(rel_parts)}"
                   f" (tol {ATTN_TOL['bfloat16'][0]:.3g}/{ATTN_TOL['bfloat16'][1]:g})")
        print(
            f"K4/K5 {dtype_name} B={b} S={s} H={h} Dh={dh} mask={masked}: max_abs_err "
            f"out {errs[0]:.3g} lse {errs[1]:.3g} dqkv {errs[2]:.3g} (tol {tol:g}, lse 1e-5){rel}; routes {' '.join(routes)}"
        )
        check(errs[0] <= tol and errs[2] <= tol and errs[1] <= 1e-5, f"short_attention {case}")
        check(bool(torch.isfinite(dqkv.float()).all()), f"short_attention {case} dqkv not finite")
        if case == SHORT_BERT:
            fwd_bert, bwd_bert = _short_numbers(case, qkv, dout, mask, lse, errs, fwd_family, bwd_family)
            print(f"  K4 at bert_base's shape: {fwd_bert['ms']:.5f} ms on {fwd_family} (bound {fwd_bert['bound_ms']:.5f},"
                  f" {fwd_bert['bound_ms'] / fwd_bert['ms']:.1%} of it; SDPA {fwd_bert['library_ms']:.5f});"
                  f" K5 {bwd_bert['ms']:.5f} ms on {bwd_family} (bound {bwd_bert['bound_ms']:.5f}; SDPA"
                  f" {bwd_bert['library_ms']:.5f})")
            continue
        if case != SHORT_MAIN:
            continue
        check_short_planted_faults(qkv, dout, mask, h, ref_out, ref_lse, ref_dqkv)
        fwd_row, bwd_row = _short_numbers(case, qkv, dout, mask, lse, errs, fwd_family, bwd_family)
        if yardsticks:
            q, k, v = (t.view(b, s, h, dh).transpose(1, 2).contiguous() for t in qkv.split(d, -1))
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
            do4 = dout.view(b, s, h, dh).transpose(1, 2).contiguous()

            def sdpa_bwd():
                return torch.autograd.grad(sdpa_out, (qg, kg, vg), do4, retain_graph=True)

            fwd_row.update({
                "call_ms": cuda_ms(lambda: sa.short_attention_fwd(qkv, h, mask)),
                # the FMA kernel this route replaced, on the same inputs
                "fma_ms": kernel_device_ms(lambda: sa._fwd(qkv, h, mask, "fma"), ("fwd_kernel",)),
                "library_call_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            })
            bwd_row.update({
                "call_ms": cuda_ms(lambda: sa.short_attention_bwd(qkv, dout, lse, h, mask)),
                # the FMA kernels this route replaced, on the same inputs
                "fma_ms": kernel_device_ms(lambda: sa._bwd(qkv, dout, lse, h, mask, "fma"), ("dq_kernel", "dkv_kernel")),
                "library_call_ms": cuda_ms(sdpa_bwd),
                # the host's cost of a call: the whole wrapper, and its C entry
                # alone (ctypes, four tensor-map encodes, the launch)
                "host_ms": host_ms(lambda: sa.short_attention_bwd(qkv, dout, lse, h, mask)),
                "entry_host_ms": host_ms(lambda: short_bwd_entry(qkv, dout, lse, h, dqkv)),
            })
            del sdpa_out, qg, kg, vg
    fwd_row["bert_base"], bwd_row["bert_base"] = fwd_bert, bwd_bert
    return fwd_row, bwd_row


def _short_numbers(case, qkv, dout, mask, lse, errs, fwd_family: str, bwd_family: str) -> tuple[dict, dict]:
    """K4's and K5's rows at one bf16 case: device times (the profiler's)
    of the kernels, SDPA's forward and backward (every kernel each
    launches; the key-padding mask, where there is one, as SDPA's boolean
    mask) and the plain versions by events, and the bounds.  The products
    count the valid (query, key) pairs of this case's mask."""
    import torch
    import torch.nn.functional as F

    from distributed_learning_simulator_tpu_torch.ops import short_attention as sa

    b, s, h, dh, _, _ = case
    d = h * dh
    itemsize, name = qkv.element_size(), "bfloat16"
    keys = b * s if mask is None else float(mask.sum())  # valid keys, all rows
    mm = 2 * h * s * keys * dh  # one [S, S] x [S, Dh] product over the valid pairs, all heads
    fwd_bound = bound_ms(b * s * 3 * d * itemsize + b * s * d * itemsize + b * h * s * 4, 2 * mm, name)
    bwd_bound = bound_ms(b * s * 3 * d * itemsize * 2 + b * s * d * itemsize + b * h * s * 4, 5 * mm, name)
    q, k, v = (t.view(b, s, h, dh).transpose(1, 2).contiguous() for t in qkv.split(d, -1))
    do4 = dout.view(b, s, h, dh).transpose(1, 2).contiguous()
    attn_mask = None if mask is None else (mask > 0)[:, None, None, :]
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qg, kg, vg), do4, retain_graph=True)

    kernels = {"wgmma": ("short_bwd_wgmma_kernel",), "fma": ("dq_kernel", "dkv_kernel")}[bwd_family]
    fwd_kernel = {"wgmma": "short_fwd_wgmma_kernel", "fma": "fwd_kernel"}[fwd_family]
    fwd_row = {
        "max_abs_err": max(errs[0], errs[1]),
        "ms": kernel_device_ms(lambda: sa.short_attention_fwd(qkv, h, mask), (fwd_kernel,)),
        "plain_ms": cuda_ms(lambda: sa.short_attention_fwd_plain(qkv, h, mask)),
        "bound_ms": fwd_bound[0],
        "bound_by": fwd_bound[1],
        # every kernel SDPA's forward launches, by the same clock
        "library_ms": kernel_device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask), None),
        "shape": f"qkv [{b}, {s}, {3 * d}] bf16{' masked' if mask is not None else ''}",
        "family": fwd_family,
    }
    bwd_row = {
        "max_abs_err": errs[2],
        "ms": kernel_device_ms(lambda: sa.short_attention_bwd(qkv, dout, lse, h, mask), kernels),
        "plain_ms": cuda_ms(lambda: sa.short_attention_bwd_plain(qkv, dout, lse, h, mask)),
        "bound_ms": bwd_bound[0],
        "bound_by": bwd_bound[1],
        # every kernel SDPA's backward launches (all three gradients), by the same clock
        "library_ms": kernel_device_ms(sdpa_bwd, None),
        "shape": f"qkv, dout [{b}, {s}, {3 * d}], [{b}, {s}, {d}] bf16{' masked' if mask is not None else ''}",
        "family": bwd_family,
    }
    return fwd_row, bwd_row


def short_bwd_entry(qkv, dout, lse, h: int, dqkv) -> None:
    """K5's C entry on the wgmma route, called as the wrapper calls it,
    without the wrapper's checks and allocation."""
    import torch

    from distributed_learning_simulator_tpu_torch.ops import short_attention as sa

    b, s, _ = qkv.shape
    err = sa._library().short_attention_bwd(
        1, sa.ROUTES["wgmma"], qkv.data_ptr(), None, dout.data_ptr(), lse.data_ptr(), None, dqkv.data_ptr(),
        b, s, h, 64, torch.cuda.current_stream().cuda_stream,
    )
    check(err == 0, f"K5's C entry returned {err}")


def check_short_planted_faults(qkv, dout, mask, h: int, ref_out, ref_lse, ref_dqkv) -> None:
    """The relative check of ``check_short_attention`` must reject, at the
    ViT-small shape, a K4 that does not round p to bf16 (out) and a K5
    that rounds neither p nor dS to bf16 (each of dq, dk and dv): the plain
    versions on the f32 values of the same inputs, rounded to bf16 at the
    end; the backward takes the true lse."""
    from distributed_learning_simulator_tpu_torch.ops import short_attention as sa

    d = dout.shape[-1]
    unrounded = sa.short_attention_fwd_plain(qkv.float(), h, mask)[0].to(qkv.dtype)
    rel_max, rel_rms, ok = attention_mismatch(unrounded, ref_out, "bfloat16")
    check(not ok, "a K4 that does not round p passes the check")
    print(f"planted fault at the ViT-small shape, a K4 that does not round p: relative max/rms"
          f" {rel_max:.2g}/{rel_rms:.2g} (rejected)")
    unrounded = sa.short_attention_bwd_plain(qkv.float(), dout.float(), ref_lse, h, mask).to(qkv.dtype)
    rel = []
    for (name, got), want in zip(_short_blocks(unrounded, d).items(), _short_blocks(ref_dqkv, d).values()):
        rel_max, rel_rms, ok = attention_mismatch(got, want, "bfloat16")
        rel.append(f"{name} {rel_max:.2g}/{rel_rms:.2g}")
        check(not ok, f"a K5 that rounds neither p nor dS passes the {name} check")
    print(f"planted fault at the ViT-small shape, a K5 that rounds neither p nor dS: relative max/rms"
          f" {', '.join(rel)} (rejected)")


#: (B, H, T, Dh, dtype name, causal, mask kind) of the K6-K11 checks: the
#: main path's shape first, then the edges the kernels must cover
LC_MAIN = (8, 8, 8192, 64, "bfloat16", False, "pad")
#: the main path's batch at ``LongContextTransformer``'s default width
#: (d_model 256, 8 heads: Dh 32)
LC_DH32 = (8, 8, 8192, 32, "bfloat16", False, "pad")
FUSED_CASES = [
    LC_MAIN,
    (2, 8, 8192, 64, "bfloat16", True, "pad"),  # causal LM
    (1, 8, 8192, 64, "float32", False, "pad"),  # f32 at 8192: the stream tier
    (1, 8, 16384, 64, "bfloat16", False, "pad"),  # past MAX_FUSED_T: stream tier
    (2, 4, 1000, 64, "bfloat16", True, "pad"),  # T not a multiple of 64
    (2, 4, 1000, 20, "float32", False, "pad"),  # ragged Dh (FMA path)
    (2, 4, 1000, 20, "bfloat16", True, "pad"),  # ragged Dh (tensor cores, scalar loads)
    (2, 4, 2048, 32, "bfloat16", False, "pad"),  # Dh 32 (the model's default)
    LC_DH32,
    (2, 4, 2048, 128, "float32", True, "pad"),  # Dh 128
    (2, 4, 2048, 128, "bfloat16", False, "pad"),  # Dh 128 in bf16 (FMA path)
    (2, 4, 1024, 64, "float32", True, "empty"),  # fully masked rows
    (2, 4, 2048, 32, "float32", False, "pad"),  # f32 at Dh 32
    (2, 4, 1000, 64, "float32", True, "pad"),  # f32, T not a multiple of 64, causal
    (2, 4, 1024, 64, "bfloat16", True, "empty"),  # fully masked rows on the wgmma kernels
    (2, 4, 1024, 32, "bfloat16", False, "empty"),  # the same at Dh 32
]
#: the f32 small task's attention shape (batch 2, 2 heads of 64), also the
#: shape of the 3xTF32 planted fault
LC_F32 = (2, 2, 8192, 64, "float32", False, "pad")
#: the full-width f32 round's attention shape (K9-K11's main path): the
#: main path's shape in f32; K9-K11 are timed here
LC_MAIN_F32 = (8, 8, 8192, 64, "float32", False, "pad")
#: the (fwd, dq, dkv) kernel families some cases must run: the packed bf16
#: layouts at Dh 64 and 32 take the wgmma kernels, the ragged Dh 20 the
#: mma.sync kernels; the packed f32 layouts at Dh 32 and 64 the 3xTF32
#: kernels, other f32 (Dh 20, Dh 128) the FMA kernels
F32_WGMMA = ("tf32x3", "tf32x3", "tf32x3")
ROUTE_OF = {
    LC_MAIN: ("wgmma", "wgmma", "wgmma"),
    FUSED_CASES[1]: ("wgmma", "wgmma", "wgmma"),
    FUSED_CASES[2]: F32_WGMMA,
    FUSED_CASES[5]: ("fma", "fma", "fma"),
    FUSED_CASES[6]: ("mma", "mma", "mma"),
    FUSED_CASES[7]: ("wgmma", "wgmma", "wgmma"),
    LC_DH32: ("wgmma", "wgmma", "wgmma"),
    FUSED_CASES[9]: ("fma", "fma", "fma"),
    FUSED_CASES[11]: F32_WGMMA,
    FUSED_CASES[12]: F32_WGMMA,
    FUSED_CASES[13]: F32_WGMMA,
    FUSED_CASES[14]: ("wgmma", "wgmma", "wgmma"),
    FUSED_CASES[15]: ("wgmma", "wgmma", "wgmma"),
    LC_F32: F32_WGMMA,
    LC_MAIN_F32: F32_WGMMA,
}


#: the Hopper kernels (wgmma, TMA) of each library as built, one entry an
#: instantiation: Dh 32 and 64 (fused_attention: bf16 and 3xTF32), one pass
#: and two (the short forward), and the short backward (not a template)
WGMMA_KERNELS = {
    "fused_attention": tuple(
        f"{name}<{dh}>"
        for name in ("fwd_wgmma_kernel", "dkv_wgmma_kernel", "dq_wgmma_kernel", "fwd_tf32x3_kernel",
                     "dkv_tf32x3_kernel", "dq_tf32x3_kernel")
        for dh in (32, 64)
    ),
    "short_attention": ("short_fwd_wgmma_kernel<1>", "short_fwd_wgmma_kernel<2>", "short_bwd_wgmma_kernel"),
}


def _wgmma_name(mangled: str, kernels: tuple[str, ...]) -> str | None:
    """``fwd_wgmma_kernel<64>`` for a mangled instantiation of one of
    ``kernels`` (the name right after its length prefix, then its integer
    template argument if it has one: ``short_bwd_wgmma_kernel`` has none),
    else None."""
    import re

    names = "|".join(sorted({k.split("<")[0] for k in kernels}))
    for found in re.finditer(r"(\d+)(%s)(?:ILi(\d+)E)?" % names, mangled):
        prefix, name, arg = found.groups()
        if prefix.endswith(str(len(name))):
            return f"{name}<{arg}>" if arg else name
    return None


def check_wgmma_build(library: str) -> None:
    """The wgmma kernels of ``library`` as built: ``ptxas``' register,
    shared-memory and spill report (no spills allowed), and the SASS of the
    built library (``cuobjdump -sass``), which must hold ``HGMMA`` (wgmma)
    and ``UTMALDG`` (TMA loads) in each of them."""
    from distributed_learning_simulator_tpu_torch.ops import build

    kernels, report = WGMMA_KERNELS[library], build.report(library)
    ptxas, current = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            current = _wgmma_name(line, kernels)
            if current:
                ptxas[current] = []
        elif current and ("registers" in line or "spill" in line):
            ptxas[current].append(line.replace("ptxas info    :", "").strip())
    check(sorted(ptxas) == sorted(kernels), f"ptxas entries of the wgmma kernels: {sorted(ptxas)}")
    for line in sorted({x.strip() for x in report.splitlines() if "warning" in x.lower()}):
        print(f"  {line}")
    for name, lines in sorted(ptxas.items()):
        print(f"  ptxas {name}: {'; '.join(lines)}")
        check(any("0 bytes spill stores, 0 bytes spill loads" in x for x in lines), f"{name} spills: {lines}")
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", build.library_path(library)], capture_output=True, text=True, check=True
    ).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = _wgmma_name(line, kernels)
            if current:
                counts[current] = dict.fromkeys(("HGMMA", "UTMALDG", "SYNCS", "HMMA"), 0)
        elif current:
            for op in counts[current]:
                counts[current][op] += f" {op}." in line or f" {op} " in line
    check(sorted(counts) == sorted(kernels), f"SASS functions of the wgmma kernels: {sorted(counts)}")
    for name, ops in sorted(counts.items()):
        print(f"  SASS {name}: " + ", ".join(f"{op} x{n}" for op, n in ops.items()))
        check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0, f"{name} has no wgmma or TMA load in its SASS: {ops}")


def _fused_inputs(case, gen):
    """Strided q/k/v views of one packed ``[B, T, 3, H, Dh]`` tensor (the
    model's layout), dO, and the f32 key mask: padding (lengths from T/4 to
    T, as the text data has), or ``empty``: sample 0 has no valid key at
    all and the first key of every other sample is masked, so under causal
    row 0 sees nothing."""
    import torch

    b, h, t, dh, dtype, causal, kind = case
    dtype = getattr(torch, dtype)
    qkv = torch.randn(b, t, 3, h, dh, generator=gen, device="cuda").to(dtype)
    q, k, v = qkv.unbind(dim=2)
    dout = torch.randn(b, t, h, dh, generator=gen, device="cuda").to(dtype)
    lengths = torch.randint(t // 4, t + 1, (b,), generator=gen, device="cuda")
    mask = (torch.arange(t, device="cuda")[None, :] < lengths[:, None]).float()
    if kind == "empty":
        mask[0] = 0.0
        mask[1:, 0] = 0.0
    return q, k, v, mask, dout


#: (max, rms) tolerance of K6-K11 against their plain versions, relative to
#: the plain output's own largest magnitude and RMS.  f32: summation order
#: only (measured max 1.5e-6 absolute).  bf16: both sides round p and ds to
#: bf16 at the same points against the same maximum, so only a value on a
#: rounding boundary differs, by one output ulp (at most 2^-7 of a value);
#: the max allows 2 of those on the largest value.  The RMS bound catches
#: faults that move most values by less than an ulp: without the bf16
#: rounding of p and ds the RMS error is about 2.5e-3 (T 2048 on the CPU),
#: against about 1e-4 for a change of summation order.
ATTN_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2.0**-6, 1e-3)}


def attention_mismatch(got, want, dtype: str) -> tuple[float, float, bool]:
    """``(max |got - want| / max |want|, rms(got - want) / rms(want), ok)``
    under ``ATTN_TOL[dtype]``; a local fault (a tile or row wrong) shows in
    the max, a systematic one (a rounding point missed) in the RMS."""
    err, ref = got.double() - want.double(), want.double()
    rel_max = float(err.abs().max() / ref.abs().max().clamp_min(1e-30))
    rel_rms = float(err.norm() / ref.norm().clamp_min(1e-30))
    tol_max, tol_rms = ATTN_TOL[dtype]
    return rel_max, rel_rms, rel_max <= tol_max and rel_rms <= tol_rms


def _fused_work(case, mask) -> tuple[dict, dict]:
    """Operations (flop) and bytes of the three kernels on one case, as this
    run's data needs them: a masked key, or one after the query under
    ``causal``, gives p = 0 exactly, so only the valid (query, key) pairs
    count (forward 2 products of ``2·Dh`` flop a pair, dq 3, dkv 4), and a
    masked key's k and v rows need not be read.  Each other input is read
    once and each output written once."""
    import torch

    b, h, t, dh, dtype, causal, _ = case
    item = 4 if dtype == "float32" else 2
    valid = mask != 0
    # queries that see key j: all T, or T - j under causal
    seen = t - torch.arange(t, device=mask.device) if causal else t
    pairs = float((valid * seen).sum()) * h
    product = 2 * pairs * dh
    act = b * t * h * dh * item
    kv = float(valid.sum()) * h * dh * item
    row = b * h * t * 4
    flops = {"fwd": 2 * product, "dq": 3 * product, "dkv": 4 * product}
    nbytes = {
        "fwd": act + 2 * kv + b * t * 4 + act + row,
        "dq": 2 * act + 2 * kv + b * t * 4 + 2 * row + act,
        "dkv": 2 * act + 2 * kv + b * t * 4 + 2 * row + 2 * act,
    }
    return flops, nbytes


def check_fused_attention(gen, yardsticks: bool) -> dict[str, dict]:
    """K6-K11's three CUDA kernels against their plain versions at the main
    path's shape and the edge shapes; at the main shape (K6-K8) and at the
    f32 round's shape (K9-K11) also the times of kernel, plain version and
    ``F.scaled_dot_product_attention`` forward / backward (a yardstick: the
    port never calls it), and the bound.  With ``yardsticks`` also the
    kernels the Hopper ones replaced (``mma_sync_ms``, ``fma_ms``), both
    bf16 families at Dh 32 (``dh32_ms``; both are checked either way) and
    the kernels SDPA's f32 calls launch."""
    import torch
    import torch.nn.functional as F

    from distributed_learning_simulator_tpu_torch.ops import fused_attention as fa

    rows = {}
    for case in [*FUSED_CASES, LC_F32, LC_MAIN_F32]:
        b, h, t, dh, dtype, causal, kind = case
        q, k, v, mask, dout = _fused_inputs(case, gen)
        tier = fa.kernel_tier(t, dh, q.element_size(), _perf_gate=False)
        before = dict(fa.route_launches)
        out, lse = fa.attention_fwd(q, k, v, mask, causal, tier)
        delta = fa.attention_delta(dout, out)
        dq = fa.attention_dq(q, k, v, mask, dout, lse, delta, causal, tier)
        dk, dv = fa.attention_dkv(q, k, v, mask, dout, lse, delta, causal, tier)
        routes = sorted(key for key, n in fa.route_launches.items() if n != before[key])
        want = ROUTE_OF.get(case)
        if want is not None:
            check(routes == sorted(f"{kind_}/{r}" for kind_, r in zip(("fwd", "dq", "dkv"), want)),
                  f"fused attention {case} ran {routes}, want {want}")
        if want == ("mma", "mma", "mma"):  # the C entries refuse the wgmma route off its layouts
            _refused(lambda: fa.attention_fwd(q, k, v, mask, causal, tier, route="wgmma"), f"wgmma fwd at {case}")
            _refused(lambda: fa.attention_dkv(q, k, v, mask, dout, lse, delta, causal, tier, route="wgmma"),
                     f"wgmma dk/dv at {case}")
            _refused(lambda: fa.attention_dq(q, k, v, mask, dout, lse, delta, causal, tier, route="wgmma"),
                     f"wgmma dq at {case}")
        # the C entries refuse the 3xTF32 route for f32 off Dh 32/64 (Dh 20,
        # 128) and for bf16
        if want == ("fma", "fma", "fma") or case == FUSED_CASES[7]:
            _refused(lambda: fa.attention_fwd(q, k, v, mask, causal, tier, route="tf32x3"), f"tf32x3 fwd at {case}")
            _refused(lambda: fa.attention_dq(q, k, v, mask, dout, lse, delta, causal, tier, route="tf32x3"),
                     f"tf32x3 dq at {case}")
            _refused(lambda: fa.attention_dkv(q, k, v, mask, dout, lse, delta, causal, tier, route="tf32x3"),
                     f"tf32x3 dk/dv at {case}")
        ref_out, ref_lse = fa.attention_fwd_plain(q, k, v, mask, causal)
        ref = fa.attention_bwd_plain(q, k, v, mask, dout, lse, delta, causal)
        torch.cuda.synchronize()
        errs, rel = {}, []
        for name, got, want in (("out", out, ref_out), ("dq", dq, ref[0]), ("dk", dk, ref[1]), ("dv", dv, ref[2])):
            errs[name] = max_err(got, want)
            rel_max, rel_rms, ok = attention_mismatch(got, want, dtype)
            rel.append(f"{name} {rel_max:.2g}/{rel_rms:.2g}")
            check(bool(torch.isfinite(got.float()).all()), f"fused attention {case} {name} not finite")
            check(ok, f"fused attention {case} {name}: max {rel_max:.3g} rms {rel_rms:.3g} of the reference's")
        errs["lse"] = max_err(lse, ref_lse)
        check(errs["lse"] <= 1e-4, f"fused attention {case} lse err {errs['lse']}")
        if kind == "empty":
            check(float(out[0].float().abs().max()) == 0.0, "a fully masked row gave non-zero output")
            check(float(lse[0].max()) <= -1e29, "a fully masked row's lse is not -1e30")
            check(float(dq[0].float().abs().max()) == 0.0, "a fully masked row gave a non-zero dq")
        print(
            f"K6-K11 {dtype} B={b} H={h} T={t} Dh={dh} causal={causal} mask={kind} tier={tier}:"
            f" max_abs_err " + " ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f"; relative max/rms {', '.join(rel)} (tol {ATTN_TOL[dtype][0]:.3g}/{ATTN_TOL[dtype][1]:g},"
            f" lse 1e-4 absolute); routes {' '.join(routes)}"
        )
        if dtype == "bfloat16" and dh == 32:
            _check_dh32_routes(case, rows, q, k, v, mask, dout, lse, delta, tier, (ref_out, *ref), yardsticks)
        if case not in (LC_MAIN, LC_MAIN_F32):
            continue
        flops, nbytes = _fused_work(case, mask)
        route = fa.kernel_route(q, k, v, dout)
        sdpa = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
        attn_mask = mask.bool()[:, None, None, :]
        qg, kg, vg = (x.detach().requires_grad_(True) for x in sdpa)
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask, is_causal=False)
        do4 = dout.transpose(1, 2).contiguous()
        timed = {
            "fwd": (
                lambda: fa.attention_fwd(q, k, v, mask, causal, tier),
                lambda: fa.attention_fwd_plain(q, k, v, mask, causal),
                lambda: F.scaled_dot_product_attention(*sdpa, attn_mask=attn_mask),
                max(errs["out"], errs["lse"]),
            ),
            "dq": (
                lambda: fa.attention_dq(q, k, v, mask, dout, lse, delta, causal, tier),
                lambda: fa.attention_bwd_plain(q, k, v, mask, dout, lse, delta, causal),
                lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do4, retain_graph=True),
                errs["dq"],
            ),
            "dkv": (
                lambda: fa.attention_dkv(q, k, v, mask, dout, lse, delta, causal, tier),
                lambda: fa.attention_bwd_plain(q, k, v, mask, dout, lse, delta, causal),
                lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do4, retain_graph=True),
                max(errs["dk"], errs["dv"]),
            ),
        }
        ids = {"fwd": fa._FWD_ID[tier], "dq": fa._DQ_ID[tier], "dkv": fa._DKV_ID[tier]}
        # the kernels a Hopper family replaced, on the same inputs (a
        # yardstick within this run): mma.sync for bf16, FMA for f32
        calls = {
            "fwd": lambda r: fa.attention_fwd(q, k, v, mask, causal, tier, route=r),
            "dq": lambda r: fa.attention_dq(q, k, v, mask, dout, lse, delta, causal, tier, route=r),
            "dkv": lambda r: fa.attention_dkv(q, k, v, mask, dout, lse, delta, causal, tier, route=r),
        }
        replaced = {"wgmma": ("mma", "mma_sync_ms"), "tf32x3": ("fma", "fma_ms")}
        for part, (kernel, plain, library, err) in timed.items():
            rows[ids[part]] = {
                "max_abs_err": err,
                "ms": cuda_ms(kernel, iters=5, warmup=1),
                # the plain backward computes dq, dk and dv in one call
                "plain_ms": cuda_ms(plain, iters=2, warmup=1),
                **attention_bound_ms(nbytes[part], flops[part], dtype),
                # SDPA's backward also computes all three gradients
                "library_ms": cuda_ms(library, iters=5, warmup=1),
                "shape": f"q/k/v [{b}, {t}, {h}, {dh}] {dtype}, key mask, causal={causal}",
                "family": route,
            }
            if yardsticks and route in replaced:
                old, key = replaced[route]
                rows[ids[part]][key] = cuda_ms(lambda: calls[part](old), iters=5, warmup=1)
            if yardsticks and dtype == "float32" and part != "dq":  # dq's yardstick is the same backward
                print(f"SDPA's f32 {'forward' if part == 'fwd' else 'backward'} at {case}, by the profiler:")
                kernel_device_ms(library, None, iters=2, warmup=1)
        del sdpa_out, qg, kg, vg
    return rows


def check_tf32x3_refuses_a_misaligned_base(gen) -> None:
    """f32 q/k/v at Dh 64 whose base lies 4 bytes off 16 (strides still
    multiples of 16 bytes): the route rule gives FMA, and the C entries
    refuse the 3xTF32 route."""
    import torch

    from distributed_learning_simulator_tpu_torch.ops import fused_attention as fa

    b, t, h, dh = 2, 1024, 4, 64
    flat = torch.randn(b, t, 3 * h * dh + 4, generator=gen, device="cuda")
    q, k, v = flat[..., 1:1 + 3 * h * dh].view(b, t, 3, h, dh).unbind(dim=2)
    dout = torch.randn(b, t, h, dh, generator=gen, device="cuda")
    lse = torch.zeros(b, h, t, device="cuda")
    check(fa.kernel_route(q, k, v, dout) == "fma", "a misaligned f32 base routes to the 3xTF32 kernels")
    _refused(lambda: fa.attention_fwd(q, k, v, None, False, "fused", route="tf32x3"), "tf32x3 fwd, misaligned base")
    _refused(lambda: fa.attention_dq(q, k, v, None, dout, lse, lse, False, "fused", route="tf32x3"),
             "tf32x3 dq, misaligned base")
    _refused(lambda: fa.attention_dkv(q, k, v, None, dout, lse, lse, False, "fused", route="tf32x3"),
             "tf32x3 dk/dv, misaligned base")
    print("3xTF32 route refused at a misaligned f32 base (fwd, dq, dk/dv)")


def _tf32(x):
    """``x`` (f32) with the low 13 mantissa bits dropped: a TF32 value."""
    import torch

    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _mm_tf32(a, b, passes: int):
    """``a @ b`` as ``passes`` TF32 products summed in f32: 3 adds
    ``a_small b_big + a_big b_small`` to ``a_big b_big`` (the small parts:
    what the big ones dropped), 1 keeps the big parts' product alone."""
    import torch

    ab, bb = _tf32(a), _tf32(b)
    out = torch.matmul(ab, bb)
    if passes == 3:
        out = torch.matmul(a - ab, bb) + torch.matmul(ab, b - bb) + out
    return out


def tf32_products_attention(q, k, v, kv_mask, dout, lse, delta, causal: bool, passes: int):
    """``(out, dq, dk, dv)`` of the f32 attention (the plain versions' function:
    the forward against each row's global maximum, the backward from the
    given lse and delta) with every matrix product taken as ``passes`` TF32
    products (``_mm_tf32``): 3 is the 3xTF32 kernels' arithmetic, 1 a
    kernel that takes f32 products in TF32 alone (a planted fault)."""
    import math

    import torch

    from distributed_learning_simulator_tpu_torch.ops import fused_attention as fa

    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    out, dq, dk, dv = (torch.empty(b, t, h, d, dtype=torch.float32, device=q.device) for _ in range(4))
    for bi, hs in fa._head_groups(b, h, t):
        qf, kf, vf, dof = (fa._heads_first(x, bi, hs) for x in (q, k, v, dout))
        s = _mm_tf32(qf, kf.transpose(-1, -2), passes) * scale
        valid = fa._valid(kv_mask, bi, t, causal, q.device)
        masked = s if valid is None else torch.where(valid, s, fa._NEG_INF)
        m = masked.amax(dim=-1, keepdim=True)
        p = torch.exp(masked - m)
        bp = torch.exp(s - lse[bi, hs][..., None])
        if valid is not None:
            p, bp = torch.where(valid, p, 0.0), torch.where(valid, bp, 0.0)
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        ds = bp * (_mm_tf32(dof, vf.transpose(-1, -2), passes) - delta[bi, hs][..., None])
        values = (
            _mm_tf32(p, vf, passes) / l,
            _mm_tf32(ds, kf, passes) * scale,
            _mm_tf32(ds.transpose(-1, -2), qf, passes) * scale,
            _mm_tf32(bp.transpose(-1, -2), dof, passes),
        )
        for grad, value in zip((out, dq, dk, dv), values):
            grad[bi, :, hs] = value.transpose(0, 1)
    return out, dq, dk, dv


def check_tf32_planted_fault(gen) -> None:
    """At the f32 task's shape the comparison ``check_fused_attention``
    makes passes 3xTF32 products (the 3xTF32 kernels' arithmetic, emulated
    in plain PyTorch) and must reject 1xTF32 products on each of out, dq, dk
    and dv."""
    from distributed_learning_simulator_tpu_torch.ops import fused_attention as fa

    q, k, v, mask, dout = _fused_inputs(LC_F32, gen)
    causal, dtype = LC_F32[5], LC_F32[4]
    out, lse = fa.attention_fwd_plain(q, k, v, mask, causal)
    delta = fa.attention_delta(dout, out)
    ref = (out, *fa.attention_bwd_plain(q, k, v, mask, dout, lse, delta, causal))
    for passes in (3, 1):
        got = tf32_products_attention(q, k, v, mask, dout, lse, delta, causal, passes)
        rel = []
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, ref):
            rel_max, rel_rms, ok = attention_mismatch(g, w, dtype)
            rel.append(f"{name} {rel_max:.2g}/{rel_rms:.2g}")
            check(ok == (passes == 3), f"{passes}xTF32 products at the f32 shape: {name} passes {ok}")
        verdict = "passes" if passes == 3 else "rejected: a planted fault"
        print(f"{passes}xTF32 products at the f32 task's shape: relative max/rms {', '.join(rel)} ({verdict})")


def _check_dh32_routes(case, rows, q, k, v, mask, dout, lse, delta, tier, ref, yardsticks: bool) -> None:
    """The forward, dq and dk/dv on both bf16 kernel families at Dh 32, each
    checked against the plain version (``ref``: out, dq, dk, dv); with
    ``yardsticks`` each also timed in this run (the route rule serves Dh 32
    from the family that is faster here), into K6's, K7's and K8's rows as
    ``dh32_ms``."""
    from distributed_learning_simulator_tpu_torch.ops import fused_attention as fa

    b, h, t, dh, dtype, causal, _ = case
    calls = {
        "fwd": lambda r: fa.attention_fwd(q, k, v, mask, causal, tier, route=r)[:1],
        "dq": lambda r: (fa.attention_dq(q, k, v, mask, dout, lse, delta, causal, tier, route=r),),
        "dkv": lambda r: fa.attention_dkv(q, k, v, mask, dout, lse, delta, causal, tier, route=r),
    }
    wants = {"fwd": ref[:1], "dq": ref[1:2], "dkv": ref[2:]}
    for part, kid in (("fwd", "K6"), ("dq", "K7"), ("dkv", "K8")):
        ms = {}
        for route in ("wgmma", "mma"):
            for got, want in zip(calls[part](route), wants[part]):
                rel_max, rel_rms, ok = attention_mismatch(got, want, dtype)
                check(ok, f"{part} route {route} at {case}: max {rel_max:.3g} rms {rel_rms:.3g}")
            if yardsticks:
                ms[route] = cuda_ms(lambda: calls[part](route), iters=5, warmup=1)
        if not yardsticks:
            print(f"Dh 32 {part} B={b} H={h} T={t}: wgmma and mma.sync checked (route {fa.kernel_route(q, k, v, dout)})")
            continue
        print(f"Dh 32 {part} B={b} H={h} T={t}: wgmma {ms['wgmma']:.4g} ms, mma.sync {ms['mma']:.4g} ms"
              f" (route {fa.kernel_route(q, k, v, dout)})")
        rows[kid].setdefault("dh32_ms", []).append({"shape": f"[{b}, {t}, {h}, {dh}]", **ms})


def check_planted_faults(gen) -> None:
    """The comparison ``check_fused_attention`` makes must reject two faults
    planted at the main path's shape, in each of out, dq, dk and dv: kernels
    that skip one of the 128 key tiles (the kernels run with key tile 0,
    always valid here, masked, held against the plain versions with the true
    mask), and kernels that do not round p and ds to bf16 (the plain
    versions on the f32 values of the same inputs, rounded to bf16 at the
    end).  The backward of both takes the true lse and delta."""
    from distributed_learning_simulator_tpu_torch.ops import fused_attention as fa

    q, k, v, mask, dout = _fused_inputs(LC_MAIN, gen)
    causal, dtype = LC_MAIN[5], LC_MAIN[4]
    out, lse = fa.attention_fwd_plain(q, k, v, mask, causal)
    delta = fa.attention_delta(dout, out)
    ref = (out, *fa.attention_bwd_plain(q, k, v, mask, dout, lse, delta, causal))
    skip = mask.clone()
    skip[:, :64] = 0.0
    skipped = (fa.attention_fwd(q, k, v, skip, causal)[0], *fa.attention_bwd(q, k, v, skip, dout, lse, delta, causal))
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    unrounded = (
        fa.attention_fwd_plain(qf, kf, vf, mask, causal)[0],
        *fa.attention_bwd_plain(qf, kf, vf, mask, dof, lse, delta, causal),
    )
    for plant, outputs in (("skips key tile 0", skipped), ("does not round p, ds", unrounded)):
        rel = []
        for name, got, want in zip(("out", "dq", "dk", "dv"), outputs, ref):
            rel_max, rel_rms, ok = attention_mismatch(got.to(want.dtype), want, dtype)
            rel.append(f"{name} {rel_max:.2g}/{rel_rms:.2g}")
            check(not ok, f"a kernel that {plant} passes the {name} check")
        print(f"planted fault at the main shape, a kernel that {plant}: relative max/rms {', '.join(rel)} (rejected)")


def shipped_config(name: str, save_dir: str, **overrides):
    """``conf/<name>`` through the port's CLI loader (``load_config``) with
    ``++key=value`` overrides (dotted keys), its output under ``save_dir``."""
    from distributed_learning_simulator_tpu_torch.config import load_config

    argv = ["--config-name", name, f"++save_dir={save_dir}", f"++log_file={os.path.join(save_dir, 'train.log')}"]
    return load_config(argv + [f"++{key}={value}" for key, value in overrides.items()])


def check_small_task_against_cpu(workdir: str, label: str, make_config) -> None:
    """A small f32 FedAvg task from one init (the port's own, seed 0,
    through the bridge), on the card (kernels) and on the CPU (plain
    versions), each run by ``train()`` at the precision it sets.
    ``make_config(save_dir, **algorithm_kwargs)`` builds the task."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.models import convert
    from distributed_learning_simulator_tpu_torch.training import build_session, train

    init = os.path.join(workdir, f"{label}_init.npz")
    session = build_session(make_config(os.path.join(workdir, f"{label}_init")), device="cpu")
    np.savez(init, **convert.to_jax(session.engine.init_params(0)))
    results = {}
    for device in ("cuda", "cpu"):
        cfg = make_config(os.path.join(workdir, f"{label}_{device}"), global_model_path=init)
        perf = train(cfg, device=device)["performance"][1]
        with np.load(os.path.join(cfg.save_dir, "aggregated_model", "round_1.npz")) as blob:
            results[device] = (perf, {k: blob[k] for k in blob.files})
    (gpu_perf, gpu_params), (cpu_perf, cpu_params) = results["cuda"], results["cpu"]
    param_err = max(float(np.abs(gpu_params[k] - cpu_params[k]).max()) for k in cpu_params)
    loss_rel = abs(gpu_perf["test_loss"] - cpu_perf["test_loss"]) / abs(cpu_perf["test_loss"])
    print(
        f"small task ({label}) card vs CPU: test loss {gpu_perf['test_loss']:.6f} vs"
        f" {cpu_perf['test_loss']:.6f} (rel {loss_rel:.2g}), accuracy {gpu_perf['test_accuracy']} vs"
        f" {cpu_perf['test_accuracy']}, max |param diff| {param_err:.3g}; TF32 for f32 convolutions"
        f" {torch.backends.cudnn.allow_tf32}, matmuls {torch.backends.cuda.matmul.allow_tf32}"
    )
    # f32 on both (train() keeps TF32 off); a few SGD steps in other
    # summation orders
    check(loss_rel <= 1e-3 and param_err <= 1e-3, f"small task ({label}): card and CPU disagree")


def vit_small_task(save_dir: str, **algorithm_kwargs):
    """ViT-small in f32, 2 clients x 32 samples, 1 round."""
    return dense_config(
        save_dir,
        worker_number=2,
        batch_size=16,
        round=1,
        learning_rate=0.05,
        use_amp=False,
        dataset_kwargs={"train_size": 64, "val_size": 16, "test_size": 32},
        algorithm_kwargs={"client_chunk": CHUNK, **algorithm_kwargs},
    )


def densenet_small_task(save_dir: str, **algorithm_kwargs):
    """``conf/fed_avg/cifar10.yaml`` (DenseNet-40, growth rate 12, f32) cut
    to 2 clients x 16 samples, 2 local epochs (the best-epoch validation
    runs), 1 round."""
    sizes = {"train_size": 32, "val_size": 16, "test_size": 32}
    overrides = {"round": 1, "epoch": 2, "worker_number": 2, "batch_size": 16}
    overrides.update({f"dataset_kwargs.{k}": v for k, v in sizes.items()})
    overrides.update({f"algorithm_kwargs.{k}": v for k, v in algorithm_kwargs.items()})
    return shipped_config(CNN_MAIN, save_dir, **overrides)


def _kernel_group(name: str) -> str:
    if "Layout" in name:  # csrc/fused_attention.cu's kernels take a Layout
        return "port kernels (K6-K11)"
    if any(k in name for k in ("decode_word_kernel", "decode_per_value_kernel")):
        return "port kernels (K3)"
    if any(k in name for k in ("encode_kernel", "absmax_kernel")):
        return "port kernels (K2)"
    if any(k in name for k in ("fwd_kernel", "dq_kernel", "dkv_kernel", "short_fwd_wgmma_kernel",
                               "short_bwd_wgmma_kernel", "weighted_accum_kernel")):
        return "port kernels (K1, K4, K5)"
    # before the GEMMs: cuDNN's convolutions are implicit GEMMs (xmma_fprop, ...)
    if any(k in name.lower() for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")):
        return "convolutions (cuDNN)"
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "cublas", "gemv", "nvjet")):
        return "matrix products (cuBLAS)"
    # GroupNorm's and LayerNorm's kernels share names (GammaBeta...); no
    # path runs both
    if any(k in name.lower() for k in ("layer_norm", "gammabeta", "rowwisemoments", "fusedparams",
                                       "internalgradients")):
        return "norms (LayerNorm, GroupNorm)"
    if "CatArray" in name:
        return "concatenation (torch.cat)"
    if any(k in name for k in ("indexFunc", "indexSelect", "index_elementwise", "scatter_gather", "radixSort",
                               "RadixSort", "segmented_sort", "sort_", "searchsorted")):
        return "gathers, scatters, sorts"
    return "elementwise, reductions, copies"


def _profiled(fn, label: str, alone: str, what: str, host_ops: int = 0) -> float:
    """``fn`` under ``torch.profiler``; prints the device's busy share and
    its time by kernel group and by kernel (and the ``host_ops`` host
    operators with the most time, what they call included), and returns
    the busy share.  ``alone`` says what the unprofiled work took.  The
    sums come from the trace's raw events: ``key_averages()`` builds a
    Python object an event, which over a DenseNet-40 round's trace took
    minutes; the raw events give the same busy sum in seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    device: dict[str, list] = {}
    host: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        on_card = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_card or host_ops:
            row = (device if on_card else host).setdefault(e.name(), [0, 0])
            row[0] += 1
            row[1] += e.duration_ns()
    device = {k: v for k, v in device.items() if v[1] > 0}
    busy = sum(ns for _, ns in device.values()) / 1e9
    print(
        f"profile{label}: {alone}; {what} {wall:.3f} s profiled;"
        f" device busy {busy:.3f} s = {busy / wall:.1%} of it"
    )
    groups: dict[str, float] = {}
    for name, (_, ns) in device.items():
        key = _kernel_group(name)
        groups[key] = groups.get(key, 0.0) + ns / 1e9
    for key, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {key}: {t * 1e3:.1f} ms ({t / busy:.1%} of device time)")
    # the ten largest kernels, then the port's own that are not among them
    ranked = sorted(device.items(), key=lambda kv: -kv[1][1])
    for name, (n, ns) in ranked[:10] + [kv for kv in ranked[10:] if _kernel_group(kv[0]).startswith("port kernels")]:
        print(f"    {ns / 1e6:8.2f} ms  x{n:<5d} {name[:90]}")
    if host_ops:
        print(f"  host: the {host_ops} operators with the most time on all threads (what they call included):")
        for name, (n, ns) in sorted(host.items(), key=lambda kv: -kv[1][1])[:host_ops]:
            print(f"    {ns / 1e6:8.2f} ms  x{n:<6d} {name[:90]}")
    return busy / wall


def check_short_routes(routes: dict[str, int], k4: int, k5: int, path: str) -> None:
    """Every K4 launch of a main path on the Hopper forward, every K5 launch
    on the Hopper backward (``ops/short_attention.py::route_launches``)."""
    want = {"fwd/fma": 0, "fwd/wgmma": k4, "bwd/fma": 0, "bwd/wgmma": k5}
    print(f"  {path} K4/K5 launches by kernel: {routes}")
    check(routes == want, f"{path} K4/K5 kernels {routes}, want {want}")


# ------------------------------------------------------- long-context slice
LC_WORKERS, LC_SAMPLES, LC_TEST, LC_ROUNDS = 8, 16, 32, 2


def lc_config(save_dir: str, model: str = "LongContextTransformer", **fields):
    """``conf/large_scale/fed_avg/imdb_longcontext_sp.yaml`` without
    ``sequence_parallel``/``sp_impl`` (one card holds it whole): fed_avg,
    imdb at max_len 8192, d_model 512, 8 heads, 6 layers, dropout 0.1,
    8 workers, batch 8, use_amp.  ``CausalLMTransformer`` takes
    ``causal_lm_sp.yaml``'s batch 4 and dropout 0.  Cut to size:
    8 x 16 training samples, 32 test samples, 2 rounds (1 for the LM)."""
    from distributed_learning_simulator_tpu_torch.config import DistributedTrainingConfig

    lm = model == "CausalLMTransformer"
    base = dict(
        dataset_name="imdb",
        model_name=model,
        distributed_algorithm="fed_avg",
        worker_number=LC_WORKERS,
        batch_size=4 if lm else 8,
        round=1 if lm else LC_ROUNDS,
        epoch=1,
        learning_rate=0.01,
        use_amp=True,
        dataset_kwargs={
            "max_len": 8192,
            "train_size": LC_WORKERS * LC_SAMPLES,
            "val_size": 8,
            "test_size": LC_TEST,
        },
        model_kwargs={
            "max_len": 8192,
            "d_model": 512,
            "nhead": 8,
            "num_encoder_layer": 6,
            **({"dropout_rate": 0.0} if lm else {}),
        },
        save_dir=save_dir,
        log_file=os.path.join(save_dir, "train.log"),
    )
    base.update(fields)
    return DistributedTrainingConfig(**base)


def _reset_launches() -> None:
    from distributed_learning_simulator_tpu_torch.ops import fused_attention as fa
    from distributed_learning_simulator_tpu_torch.ops import qsgd
    from distributed_learning_simulator_tpu_torch.ops import short_attention as sa
    from distributed_learning_simulator_tpu_torch.ops import weighted_accum as wa

    wa.launches = sa.fwd_launches = sa.bwd_launches = 0
    qsgd.encode_launches = qsgd.decode_launches = 0
    for counts in (fa.launches, fa.route_launches, sa.route_launches):
        for key in counts:
            counts[key] = 0


def _read_launches() -> dict[str, int]:
    from distributed_learning_simulator_tpu_torch.ops import fused_attention as fa
    from distributed_learning_simulator_tpu_torch.ops import qsgd
    from distributed_learning_simulator_tpu_torch.ops import short_attention as sa
    from distributed_learning_simulator_tpu_torch.ops import weighted_accum as wa

    return {
        "K1": wa.launches, "K2": qsgd.encode_launches, "K3": qsgd.decode_launches,
        "K4": sa.fwd_launches, "K5": sa.bwd_launches, **fa.launches,
    }


def check_long_context_f32_against_cpu(workdir: str) -> dict[str, int]:
    """A small f32 long-context FedAvg task at max_len 8192 (2 layers,
    d_model 128, 2 heads, dropout 0, 2 clients x 2 samples, 1 round) from one init, on
    the card and on the CPU.  f32 at T = 8192 is the JAX package's stream
    tier, so this is the path of K9-K11; returns the card run's launches."""
    import numpy as np

    small = dict(
        worker_number=2,
        batch_size=2,
        round=1,
        use_amp=False,
        dataset_kwargs={"max_len": 8192, "train_size": 4, "val_size": 2, "test_size": 2},
        # dropout 0: the card's and the CPU's generators draw other bits
        model_kwargs={
            "max_len": 8192, "d_model": 128, "nhead": 2, "num_encoder_layer": 2, "dropout_rate": 0.0,
        },
    )
    from distributed_learning_simulator_tpu_torch.training import build_session, train

    init = os.path.join(workdir, "lc_init.npz")
    session = build_session(lc_config(os.path.join(workdir, "lc_init"), **small), device="cpu")
    from distributed_learning_simulator_tpu_torch.models import convert

    np.savez(init, **convert.to_jax(session.engine.init_params(0)))
    from distributed_learning_simulator_tpu_torch.ops import fused_attention as fa

    results, launches, routes = {}, {}, {}
    for device in ("cuda", "cpu"):
        cfg = lc_config(
            os.path.join(workdir, f"lc_{device}"), algorithm_kwargs={"global_model_path": init}, **small
        )
        _reset_launches()
        perf = train(cfg, device=device)["performance"][1]
        if device == "cuda":
            launches = _read_launches()
            routes = {key: n for key, n in fa.route_launches.items() if n}
        with np.load(os.path.join(cfg.save_dir, "aggregated_model", "round_1.npz")) as blob:
            results[device] = (perf, {k: blob[k] for k in blob.files})
    (gpu_perf, gpu_params), (cpu_perf, cpu_params) = results["cuda"], results["cpu"]
    param_err = max(float(np.abs(gpu_params[k] - cpu_params[k]).max()) for k in cpu_params)
    loss_rel = abs(gpu_perf["test_loss"] - cpu_perf["test_loss"]) / abs(cpu_perf["test_loss"])
    print(
        f"long-context f32 task card vs CPU (T 8192): test loss {gpu_perf['test_loss']:.6f} vs"
        f" {cpu_perf['test_loss']:.6f} (rel {loss_rel:.2g}), max |param diff| {param_err:.3g};"
        f" card launches {launches}; by kernel family {routes}"
    )
    # f32 on both (TF32 off); 2 SGD steps in other summation orders
    check(loss_rel <= 1e-3 and param_err <= 1e-3, "long-context f32 task: card and CPU disagree")
    # 2 layers x (1 step per client x 2 clients; 1 eval batch)
    check(launches["K9"] == 2 * 3 and launches["K10"] == launches["K11"] == 2 * 2, f"stream-tier launches {launches}")
    check(launches["K6"] == launches["K7"] == launches["K8"] == 0, f"one-level launches on the f32 task {launches}")
    want = {"fwd/tf32x3": launches["K9"], "dq/tf32x3": launches["K10"], "dkv/tf32x3": launches["K11"]}
    check(routes == want, f"f32 task kernel families {routes}, want {want}")
    return launches


def run_long_context_main_path(workdir: str) -> tuple[dict[str, int], float]:
    """``train()`` on the long-context configuration for 2 rounds, then on
    ``CausalLMTransformer`` for 1 round, at full width; checks each run's
    launches exactly.  Returns the launches of both runs and the long-context
    round-2 wall time."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.ops import fused_attention as fa
    from distributed_learning_simulator_tpu_torch.training import build_session, train

    layers = 6
    total = {}
    _reset_launches()
    round_seconds = 0.0
    for model in ("LongContextTransformer", "CausalLMTransformer"):
        config = lc_config(os.path.join(workdir, f"main_{model}"), model=model)
        before, routes_before = _read_launches(), dict(fa.route_launches)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        perf = train(config)["performance"]
        wall = time.monotonic() - t0
        total = _read_launches()
        moved = {kid: total[kid] - before[kid] for kid in total}
        routes = {key: n - routes_before[key] for key, n in fa.route_launches.items() if n != routes_before[key]}
        # every client trains each round; a batch with nothing to count
        # (padding of a client shorter than the longest) is a no-op
        counts = build_session(config)._counts
        steps = config.round * sum(1 for client in counts for n in client if n > 0)
        evals = config.round * (LC_TEST // config.batch_size)
        last = perf[config.round]
        if model == "LongContextTransformer":
            round_seconds = last["round_seconds"]
        print(
            f"main path {model}: {config.round} rounds in {wall:.2f} s (setup included);"
            f" round {config.round} {last['round_seconds']:.3f} s = {1 / last['round_seconds']:.4f}"
            f" rounds/s; test loss {last['test_loss']:.4f} accuracy {last['test_accuracy']:.4f}"
            f" over {last['test_count']:.0f}; peak memory"
            f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {moved}; by kernel family {routes}"
        )
        for r, row in perf.items():
            check(np.isfinite(row["test_loss"]), f"{model} round {r} test loss {row['test_loss']}")
            check(0.0 <= row["test_accuracy"] <= 1.0, f"{model} round {r} accuracy {row['test_accuracy']}")
        check(moved["K6"] == layers * (steps + evals), f"{model} K6 launches {moved['K6']}")
        check(moved["K7"] == moved["K8"] == layers * steps, f"{model} K7/K8 launches {moved}")
        check(moved["K1"] == config.round, f"{model} K1 launches {moved['K1']} (one chunk a round)")
        check(moved["K9"] == moved["K10"] == moved["K11"] == 0, f"{model} stream-tier launches {moved}")
        # the main path runs the wgmma forward, dq and dk/dv
        want = {"fwd/wgmma": moved["K6"], "dq/wgmma": moved["K7"], "dkv/wgmma": moved["K8"]}
        check(routes == want, f"{model} kernel families {routes}, want {want}")
    return total, round_seconds


def run_long_context_f32_round(workdir: str) -> dict[str, int]:
    """One full-width f32 round of the long-context configuration
    (``lc_config`` with ``use_amp`` off: T 8192 in f32 is the stream tier,
    K9-K11 in every attention layer), its launches checked exactly (every
    forward, dq and dk/dv launch on the 3xTF32 kernels).  Returns the
    launches."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.ops import fused_attention as fa
    from distributed_learning_simulator_tpu_torch.training import build_session, train

    layers = 6
    config = lc_config(os.path.join(workdir, "main_f32"), use_amp=False, round=1)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    perf = train(config)["performance"]
    wall = time.monotonic() - t0
    launches = _read_launches()
    routes = {key: n for key, n in fa.route_launches.items() if n}
    last = perf[config.round]
    print(
        f"f32 long-context round: {wall:.2f} s (setup included); round 1 {last['round_seconds']:.3f} s;"
        f" test loss {last['test_loss']:.4f} accuracy {last['test_accuracy']:.4f} over {last['test_count']:.0f};"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches};"
        f" by kernel family {routes}"
    )
    check(np.isfinite(last["test_loss"]) and 0.0 <= last["test_accuracy"] <= 1.0, f"f32 round: {last}")
    session = build_session(lc_config(os.path.join(workdir, "f32_profile"), use_amp=False, round=1))
    steps = sum(1 for client in session._counts for n in client if n > 0)
    evals = LC_TEST // config.batch_size
    check(launches["K9"] == layers * (steps + evals), f"f32 round K9 launches {launches['K9']}")
    check(launches["K10"] == launches["K11"] == layers * steps, f"f32 round K10/K11 launches {launches}")
    check(launches["K6"] == launches["K7"] == launches["K8"] == 0, f"f32 round one-level launches {launches}")
    want = {"fwd/tf32x3": launches["K9"], "dq/tf32x3": launches["K10"], "dkv/tf32x3": launches["K11"]}
    check(routes == want, f"f32 round kernel families {routes}, want {want}")
    return launches


# ------------------------------------------------------- fed_obd_sq slice
#: (n, bits, level, values) of the K2/K3 checks: the main path's leaf sizes
#: (ViT-Base fc1/fc2, qkv, proj, head) first, then the edges
QSGD_MAIN = (2359296, 8, 255, "randn")
#: the path's smallest large leaf (ViT-Base proj, 12 of its 49 K3 leaves)
QSGD_SMALL_LEAF = (589824, 8, 255, "randn")
QSGD_CASES = [
    QSGD_MAIN,
    (1769472, 8, 255, "randn"),
    QSGD_SMALL_LEAF,
    (76800, 8, 255, "randn"),
    (65536, 8, 255, "randn"),  # the smallest leaf the codec sends to K2
    (70001, 8, 255, "randn"),  # not a multiple of 128
    (65536, 8, 255, "zeros"),  # an all-zero leaf: scale 1e-12
    (70001, 4, 15, "randn"),
    (589824, 2, 3, "randn"),
    # level words that do not fill 32 bits: 10 lanes of 3 bits in 160-row
    # groups, 6 lanes of 5 bits in 96-row groups, 4 lanes of 7 bits
    (70001, 3, 7, "randn"),
    (589824, 5, 31, "randn"),
    (65536, 7, 127, "randn"),
    # K3's generic instantiation (5 lanes of 6 bits, 3 of 10), lanes 32,
    # and lanes 2 and 1 (a thread takes 2 and 4 word-rows)
    (70001, 6, 63, "randn"),
    (70001, 1, 1, "randn"),
    (70001, 10, 1023, "randn"),
    (65536, 16, 65535, "randn"),
    (70001, 24, 16777215, "randn"),
]
QSGD_SEEDS = 64


def qsgd_mismatch(got, want) -> list[str]:
    """The parts of two K2 results ``(packed, signs, scale)`` or two K3
    results (one f32 tensor) whose bits differ: words compared as u32,
    floats by their bit patterns."""
    import torch

    def bits(t):
        if t.dtype == torch.float32:
            return t.contiguous().view(torch.int32).to(torch.int64)
        return t.to(torch.int64) & 0xFFFFFFFF

    names = ("packed", "signs", "scale") if isinstance(got, tuple) else ("out",)
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return [
        name for name, (a, b) in zip(names, pairs)
        if a.shape != b.shape or not torch.equal(bits(a), bits(b.to(a.device)))
    ]


def encode_bound_ms(n: int, words: int) -> dict:
    """K2's bound on ``n`` values packed into ``words`` u32 words (levels
    and signs): the larger of the bytes (each value read once, each word
    and the scale written once) over 3.35 TB/s, the f32 operations a value
    takes (abs, divide, multiply, floor, subtract, compare) over 67
    TFLOP/s, and Philox's integer operations at one call per four values
    (``PHILOX_OPS`` a call) over ``PEAK_INT32_OPS``."""
    terms = {
        "bytes": (4 * n + 4 * words + 4) / PEAK_BYTES_PER_S * 1e3,
        "f32": 6 * n / PEAK_FLOPS["float32"] * 1e3,
        "int32": PHILOX_OPS * -(-n // 4) / PEAK_INT32_OPS * 1e3,
    }
    by = max(terms, key=terms.get)
    return {"bound_ms": terms[by], "bound_by": "bytes" if by == "bytes" else "operations", "bound_terms_ms": terms}


def decode_bound_ms(n: int, words: int) -> dict:
    """K3's bound on ``n`` values from ``words`` u32 words (levels and
    signs): the larger of the bytes (each word and the scale read once,
    each value written once) over 3.35 TB/s and its f32 operations (the
    conversion of a level and two products a value) over 67 TFLOP/s."""
    terms = {
        "bytes": (4 * words + 4 + 4 * n) / PEAK_BYTES_PER_S * 1e3,
        "f32": 3 * n / PEAK_FLOPS["float32"] * 1e3,
    }
    by = max(terms, key=terms.get)
    return {"bound_ms": terms[by], "bound_by": "bytes" if by == "bytes" else "operations", "bound_terms_ms": terms}


def decode_per_value(packed, signs, scale, level: int, bits: int, n: int):
    """K3 as the design it replaced ran it (``csrc/qsgd.cu::
    qsgd_decode_per_value``: a thread a value), for timing beside it."""
    import torch

    from distributed_learning_simulator_tpu_torch.ops import qsgd

    out = torch.empty(n, dtype=torch.float32, device=packed.device)
    err = qsgd._library().qsgd_decode_per_value(
        packed.data_ptr(), signs.data_ptr(), scale.data_ptr(), level, bits, n, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    check(err == 0, f"the per-value decode returned {err}")
    return out


def decode_times(encoded, level: int, bits: int, n: int) -> dict:
    """K3's device time on K2's output ``encoded`` (``ms``) and the
    replaced per-value kernel's on the same inputs (``per_value_ms``),
    taken in turns (old, new, new, old; each the mean of its two), with
    the bound; the per-value kernel checked bit-equal first."""
    from distributed_learning_simulator_tpu_torch.ops import qsgd

    packed, signs, scale = encoded
    check(not qsgd_mismatch(decode_per_value(*encoded, level, bits, n), qsgd.qsgd_decode(*encoded, level, bits, n)),
          f"the per-value decode differs from K3 at {n, bits}")

    def new():
        return kernel_device_ms(lambda: qsgd.qsgd_decode(packed, signs, scale, level, bits, n), ("decode_word_kernel",))

    def old():
        return kernel_device_ms(lambda: decode_per_value(packed, signs, scale, level, bits, n),
                                ("decode_per_value_kernel",))

    turns = [old(), new(), new(), old()]
    print(f"K3 n={n} bits={bits}: device ms in turns (per value, word, word, per value) {turns}")
    return {"ms": (turns[1] + turns[2]) / 2, "per_value_ms": (turns[0] + turns[3]) / 2,
            **decode_bound_ms(n, packed.numel() + signs.numel())}


def encode_per_value(x, seed: int, level: int, bits: int):
    """K2 as the design it replaced ran it (``csrc/qsgd.cu::
    qsgd_encode_per_value``: a Philox call a value, an atomicOr a negative
    value, the abs-max into a zeroed word, the scale clamped by a launch of
    its own), for timing beside it: ``(packed, signs, scale)``."""
    import torch

    from distributed_learning_simulator_tpu_torch.ops import qsgd

    n, rows = x.numel(), qsgd.rows_for(x.numel(), bits)
    packed = torch.empty(rows // (32 // bits), qsgd.LANE, dtype=torch.int32, device=x.device)
    signs = torch.empty(rows // 32, qsgd.LANE, dtype=torch.int32, device=x.device)
    amax = torch.zeros(1, dtype=torch.int32, device=x.device)
    err = qsgd._library().qsgd_encode_per_value(
        x.data_ptr(), n, rows, seed & 0xFFFFFFFF, level, bits, amax.data_ptr(), packed.data_ptr(),
        signs.data_ptr(), torch.cuda.current_stream().cuda_stream,
    )
    check(err == 0, f"the per-value encode returned {err}")
    return packed, signs, torch.clamp(amax.view(torch.float32), min=1e-12)


def check_qsgd(gen, yardsticks: bool) -> tuple[dict, dict]:
    """K2 and K3 against their plain versions, bit for bit, at the main
    path's leaf sizes and the edges: the card's encode with given bits
    against the plain encode with the same bits, the card's Philox encode
    against the card's encode of ``philox_fill``'s stream, that stream
    against its plain numpy version (``qsgd.philox_stream``), the card's
    decode against the plain decode; the error under one step; at the
    largest leaf the mean over 64 seeds unbiased, and two planted faults (a
    decode that drops the sign, an encode whose bits are shifted by one
    row) rejected by the same comparison.  Times K2 (Philox), K3 and their
    plain versions at the largest leaf (``ms`` the kernels' device time,
    ``call_ms`` the wrapper's calls back to back); no single PyTorch call
    computes either function.  With ``yardsticks`` also K2's two passes
    apart, K2 with given bits as ``with_bits_ms``, the designs K2 and K3
    replaced as ``per_value_ms`` (each checked first), K3 in turns with
    its replaced design, and K3 at the path's smallest large leaf
    (``small_leaf``)."""
    import torch

    from distributed_learning_simulator_tpu_torch.ops import qsgd

    k2 = k3 = small_leaf = None
    for n, bits, level, kind in QSGD_CASES:
        x = torch.zeros(n, device="cuda")
        if kind == "randn":
            x = torch.randn(n, generator=gen, device="cuda") * 0.02
        seed = n % 1000 + bits
        rows = qsgd.rows_for(n, bits)
        stream = qsgd.philox_fill(seed, rows, "cuda")
        check(torch.equal(stream.cpu(), qsgd.philox_stream(seed, rows)),
              f"philox_fill differs from the plain Philox stream at {n, bits}")
        with_bits = qsgd.qsgd_encode(x, seed, level, bits, rand_bits=stream)
        plain = qsgd.qsgd_encode_plain(x, level, bits, stream)
        philox = qsgd.qsgd_encode(x, seed, level, bits)
        out = qsgd.qsgd_decode(*philox, level, bits, n)
        plain_out = qsgd.qsgd_decode_plain(*philox, level, bits, n)
        torch.cuda.synchronize()
        step = float(philox[2][0]) / level
        # the error's bound: one step, and f32's rounding of |x| / scale *
        # level and of the decode's two products (at most 2.5 x 2^-23 x
        # scale; it matters only where a step nears f32's spacing at the
        # scale: 24 bits)
        rounding = 3 * 2.0**-23 * float(philox[2][0])
        err = float((out - x).abs().max())
        print(
            f"K2/K3 n={n} bits={bits} level={level} {kind}: philox_fill vs plain stream bit-equal;"
            f" encode with bits vs plain"
            f" {qsgd_mismatch(with_bits, plain) or 'bit-equal'}; Philox vs its stream"
            f" {qsgd_mismatch(philox, with_bits) or 'bit-equal'}; decode vs plain"
            f" {qsgd_mismatch(out, plain_out) or 'bit-equal'}; max |x - decoded| {err:.3g}"
            f" (one step {step:.3g}; f32's rounding {rounding:.3g})"
        )
        check(not qsgd_mismatch(with_bits, plain), f"K2 with bits differs from the plain encode at {n, bits}")
        check(not qsgd_mismatch(philox, with_bits), f"K2's Philox differs from philox_fill's stream at {n, bits}")
        check(not qsgd_mismatch(out, plain_out), f"K3 differs from the plain decode at {n, bits}")
        check(err < step + rounding or (kind == "zeros" and err == 0.0),
              f"K2/K3 error {err} not below one step {step} and f32's rounding {rounding}")
        if yardsticks and (n, bits, level, kind) == QSGD_SMALL_LEAF:
            small_leaf = {"n": n, **decode_times(philox, level, bits, n)}
        if (n, bits, level, kind) != QSGD_MAIN:
            continue
        check_qsgd_statistics(x, level, bits, step)
        shifted = qsgd.qsgd_encode(x, seed, level, bits, rand_bits=torch.roll(stream, 1, 0))
        unsigned = qsgd.qsgd_decode_plain(philox[0], torch.zeros_like(philox[1]), philox[2], level, bits, n)
        for plant, got, want in (
            ("an encode whose bits are shifted by one row", shifted, plain),
            ("a decode that drops the sign", unsigned, plain_out),
        ):
            differs = qsgd_mismatch(got, want)
            check(bool(differs), f"{plant} passes the K2/K3 check")
            print(f"planted fault at n={n}, {plant}: {differs} differ (rejected)")
        packed, signs, scale = philox
        words = packed.numel() + signs.numel()
        stream32 = qsgd._u32_view(stream)  # the wrapper's u32 view, made once

        def encode():
            return qsgd.qsgd_encode(x, seed, level, bits)

        def encode_with_bits():
            return qsgd.qsgd_encode(x, seed, level, bits, rand_bits=stream32)

        def decode():
            return qsgd.qsgd_decode(packed, signs, scale, level, bits, n)

        k2 = {
            "max_abs_err": 0.0,  # bit-equal to the plain version
            "ms": kernel_device_ms(encode, ("absmax_kernel", "encode_kernel")),
            "call_ms": cuda_ms(encode),  # the wrapper's calls back to back, host cost included
            "plain_ms": cuda_ms(lambda: qsgd.qsgd_encode_plain(x, level, bits, stream)),
            **encode_bound_ms(n, words),
            "library_ms": None,  # no single PyTorch call quantizes and packs
            "shape": f"[{n}] f32 -> 8-bit levels + signs (Philox bits in the kernel)",
        }
        k3 = {
            "max_abs_err": 0.0,
            "ms": kernel_device_ms(decode, ("decode_word_kernel",)),
            **decode_bound_ms(n, words),
            "call_ms": cuda_ms(decode),
            "plain_ms": cuda_ms(lambda: qsgd.qsgd_decode_plain(packed, signs, scale, level, bits, n)),
            "library_ms": None,  # no single PyTorch call unpacks and scales
            "shape": f"8-bit levels + signs -> [{n}] f32",
        }
        if yardsticks:
            old = encode_per_value(x, seed, level, bits)
            # the replaced design draws other bits; its signs and scale are the same
            check(qsgd_mismatch(old, philox) == ["packed"], f"the per-value encode: {qsgd_mismatch(old, philox)} differ")
            k2.update({
                # the two passes apart: the abs-max read, then the quantize pass
                "absmax_ms": kernel_device_ms(encode, ("absmax_kernel",)),
                "encode_ms": kernel_device_ms(encode, ("encode_kernel",)),
                # the same kernels given the bits: no Philox work, 4 bytes more read a value
                "with_bits_ms": kernel_device_ms(encode_with_bits, ("absmax_kernel", "encode_kernel")),
                # the design this replaced, on the same leaf
                "per_value_ms": kernel_device_ms(lambda: encode_per_value(x, seed, level, bits),
                                                 ("absmax_atomic_kernel", "encode_per_value_kernel")),
                "per_value_call_ms": cuda_ms(lambda: encode_per_value(x, seed, level, bits)),
            })
            # the word-walking kernel and the per-value design it replaced, in turns
            k3.update(decode_times(philox, level, bits, n))
    if yardsticks:
        k3["small_leaf"] = small_leaf  # the same at the path's smallest large leaf
    return k2, k3


def check_qsgd_statistics(x, level: int, bits: int, step: float) -> None:
    """Over 64 seeds the decoded mean is unbiased: the mean over values of
    ``sign(x)·(mean decode - x)`` lies within 6 standard errors of 0 (each
    decode errs by at most one step, so by at most step/2 in standard
    deviation), and every value's mean is within one step."""
    import torch

    from distributed_learning_simulator_tpu_torch.ops import qsgd

    acc = torch.zeros_like(x, dtype=torch.float64)
    for seed in range(QSGD_SEEDS):
        acc += qsgd.qsgd_decode(*qsgd.qsgd_encode(x, seed, level, bits), level, bits, x.numel()).double()
    mean = acc / QSGD_SEEDS
    bias = float(((mean - x.double()) * torch.sign(x.double())).mean())
    stderr = step / 2 / (QSGD_SEEDS * x.numel()) ** 0.5
    worst = float((mean - x.double()).abs().max())
    print(f"K2/K3 over {QSGD_SEEDS} seeds: bias {bias:.3g} ({bias / stderr:.2f} standard errors), max |mean - x| {worst:.3g}")
    check(abs(bias) <= 6 * stderr and worst < step, f"K2/K3 biased: {bias} (stderr {stderr}), max {worst}")


OBD_CONFIG = os.path.join("conf", "fed_obd_sq", "vit_cifar100.yaml")
#: the cuts of the fed_obd_sq main path (the YAML runs 100 rounds of 5
#: epochs and 10 tuning epochs over all of CIFAR-100)
OBD_ROUNDS, OBD_SECOND_PHASE, OBD_SAMPLES, OBD_TEST = 1, 2, 64, 256


def obd_config(save_dir: str, **overrides):
    """``conf/fed_obd_sq/vit_cifar100.yaml`` (fed_obd_sq, CIFAR-100,
    ``vit_base``, 10 workers with 5 selected a round, batch 64, SGD at
    0.05 with the cosine schedule, ``use_amp``, block dropout 0.9) on the
    path of K2/K3: ``executor: sequential`` and ``flat_payload: false`` on
    both sides.  Cut to size: 1 round, 1 epoch, ``second_phase_epoch`` 2
    (1 would take the keyed encodes), 64 training samples a worker (one
    step a client and epoch), 64 validation and 256 test samples."""
    from distributed_learning_simulator_tpu_torch.config import load_config_from_file

    fields = {
        "executor": "sequential",
        "round": OBD_ROUNDS,
        "epoch": 1,
        "algorithm_kwargs.second_phase_epoch": OBD_SECOND_PHASE,
        "endpoint_kwargs.worker.flat_payload": False,
        "endpoint_kwargs.server.flat_payload": False,
        "dataset_kwargs.train_size": 10 * OBD_SAMPLES,
        "dataset_kwargs.val_size": 64,
        "dataset_kwargs.test_size": OBD_TEST,
        "save_dir": save_dir,
        "log_file": os.path.join(save_dir, "train.log"),
        **overrides,
    }
    return load_config_from_file(os.path.join(ROOT, OBD_CONFIG), overrides=fields)


def expected_qsgd_launches(ctx) -> tuple[int, int]:
    """K2 and K3 launches of a finished threaded fed_obd_sq run, from the
    protocol (``method/fed_obd``, ``topology/quantized_endpoint.py``):

    * every leaf of at least 65,536 values of an unkeyed per-leaf encode
      is one K2 launch, and its decode at the receiver one K3 launch;
    * phase 1 (``round`` aggregates): each upload carries the kept blocks
      (``kept_history``), as a diff; every aggregate but the last goes to
      the ``random_client_number`` selected workers, the last (which
      switches phases) to all of them;
    * phase 2 (``second_phase_epoch`` aggregates): every worker uploads
      the whole model each epoch and receives every aggregate;
    * a broadcast is encoded once for all its receivers, and the initial
      model travels unencoded;
    * with ``second_phase_epoch`` 1 every upload and every broadcast is
      keyed with the session's draws, and a keyed encode never takes K2:
      no launch at all."""
    from distributed_learning_simulator_tpu_torch.ops.quantization import KERNEL_MIN_ELEMENTS

    config = ctx.config
    if int(config.algorithm_kwargs["second_phase_epoch"]) == 1:
        return 0, 0
    sizes = {name: t.numel() for name, t in ctx.model_ctx.module.state_dict().items()}
    big = sum(n >= KERNEL_MIN_ELEMENTS for n in sizes.values())
    workers = config.worker_number
    selected = min(workers, int(config.algorithm_kwargs.get("random_client_number") or workers))
    epochs = int(config.algorithm_kwargs["second_phase_epoch"])
    uploads = sum(
        sum(sizes[name] >= KERNEL_MIN_ELEMENTS for name in kept)
        for worker in ctx.workers
        for kept in worker.block_selector.kept_history
    )
    uploads += epochs * workers * big
    broadcasts = (config.round + epochs) * big
    received = ((config.round - 1) * selected + workers + epochs * workers) * big
    return uploads + broadcasts, uploads + received


class HostTimer:
    """Host wall time spent inside chosen functions, summed over the
    threads that call them: ``targets`` maps a label to ``(owner,
    attribute name)``; the functions are wrapped while the timer is
    entered and restored after."""

    def __init__(self, targets: dict) -> None:
        import threading

        self.targets = targets
        self.seconds = dict.fromkeys(targets, 0.0)
        self.calls = dict.fromkeys(targets, 0)
        self._lock = threading.Lock()
        self._saved = {}

    def _wrap(self, label, fn):
        def timed(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                with self._lock:
                    self.seconds[label] += time.monotonic() - t0
                    self.calls[label] += 1

        return timed

    def __enter__(self) -> "HostTimer":
        for label, (owner, name) in self.targets.items():
            self._saved[label] = getattr(owner, name)
            setattr(owner, name, self._wrap(label, self._saved[label]))
        return self

    def __exit__(self, *exc) -> None:
        for label, (owner, name) in self.targets.items():
            setattr(owner, name, self._saved[label])

    def report(self) -> str:
        return ", ".join(f"{k} {v:.2f} s / {self.calls[k]} calls" for k, v in self.seconds.items())


def run_obd_main_path(workdir: str, card: str) -> tuple[dict[str, int], dict]:
    """``build_task`` + ``run_task`` (what ``train()`` runs for
    ``executor: sequential``) on the fed_obd_sq configuration at full
    width with telemetry on, with the launch counters set to 0 just before
    and read just after; K2/K3 launches checked exactly against the
    protocol's count; the server's trace checked (``check_trace``: the
    threaded server samples no hbm, as the JAX one).  Returns the launches
    and the numbers for the record."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.ops import short_attention as sa
    from distributed_learning_simulator_tpu_torch.training import build_task, run_task

    config = obd_config(os.path.join(workdir, "obd_main"), **{"telemetry.enabled": True})
    t0 = time.monotonic()
    ctx = build_task(config)
    setup = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    from distributed_learning_simulator_tpu_torch.engine.engine import ComputeEngine
    from distributed_learning_simulator_tpu_torch.topology import quantized_endpoint as qe

    timer = HostTimer({
        "local training (train_epoch)": (ComputeEngine, "train_epoch"),
        "evaluation": (ComputeEngine, "evaluate"),
        "codec encode": (qe._QuantCodecMixin, "_encode"),
        "codec decode": (qe._QuantCodecMixin, "_decode"),
        "artifact writes (np.savez)": (np, "savez"),
    })
    _reset_launches()
    with timer:
        t0 = time.monotonic()
        perf = run_task(ctx)["performance"]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    launches, short_routes = _read_launches(), dict(sa.route_launches)
    k2, k3 = expected_qsgd_launches(ctx)
    params = sum(t.numel() for t in ctx.model_ctx.module.state_dict().values())
    ratios = [r for e in [ctx.server._endpoint, *(w._endpoint for w in ctx.workers)] for r in e.compression_ratios]
    with open(os.path.join(ctx.server.save_dir, "round_record.json"), encoding="utf8") as f:
        phases = [row.get("phase") for _, row in sorted(json.load(f).items(), key=lambda kv: int(kv[0]))]
    print(
        f"main path fed_obd_sq {config.model_name} ({params} parameters, {config.worker_number} workers,"
        f" {config.algorithm_kwargs['random_client_number']} selected): setup {setup:.2f} s, run {wall:.2f} s;"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}"
        f" (K2/K3 from the protocol: {k2}/{k3}); compression ratio {min(ratios):.4f}-{max(ratios):.4f}"
        f" over {len(ratios)} encodes"
    )
    print(f"  host time inside (summed over the threads; run {wall:.2f} s): {timer.report()}")
    for key, row in sorted(perf.items()):
        print(
            f"  record {key} {row.get('phase')}: {row['round_seconds']:.3f} s, test loss {row['test_loss']:.4f}"
            f" accuracy {row['test_accuracy']:.4f}, received {row['received_mb']:.1f} MB, sent {row['sent_mb']:.1f} MB"
        )
        check(np.isfinite(row["test_loss"]), f"fed_obd_sq record {key} test loss {row['test_loss']}")
        check(0.0 <= row["test_accuracy"] <= 1.0, f"fed_obd_sq record {key} accuracy {row['test_accuracy']}")
    check(params == 85_219_684, f"vit_base has {params} parameters")
    want = ["block_dropout_rounds"] * OBD_ROUNDS + ["epoch_tune"] * OBD_SECOND_PHASE
    check(phases == want, f"phases in round_record.json {phases}")
    check((launches["K2"], launches["K3"]) == (k2, k3), f"K2/K3 launches {launches['K2']}/{launches['K3']}, want {k2}/{k3}")
    check(launches["K4"] > 0 and launches["K5"] > 0, f"attention launches {launches}")
    check_short_routes(short_routes, launches["K4"], launches["K5"], "fed_obd_sq")
    others = [kid for kid in ("K1", "K6", "K7", "K8", "K9", "K10", "K11") if launches[kid]]
    check(not others, f"kernels off this path launched: {others}")
    check(all(0.27 < r < 0.30 for r in ratios), f"compression ratios {min(ratios)}-{max(ratios)}, want about 9/32")
    records = check_trace(os.path.join(ctx.server.save_dir, "trace.jsonl"), ctx.server.save_dir, "fed_obd_sq", hbm=False)
    uploads = sum(r["kind"] == "upload" for r in records)
    barriers = sum(r["kind"] == "round_barrier" for r in records)
    print(f"  fed_obd_sq trace: {len(records)} records, {uploads} uploads, {barriers} round_barrier spans, round spans"
          f" {[round(r['dur'], 3) for r in records if (r['ev'], r['kind']) == ('span', 'round')]} s ({card})")
    check(barriers == len(perf) and uploads == barriers * config.worker_number, f"fed_obd_sq trace: {uploads}/{barriers}")
    record = {
        "run_s": wall, "setup_s": setup, "records": {k: row["round_seconds"] for k, row in perf.items()},
        "host": dict(timer.seconds),
    }
    return launches, record


# ------------------------------- FedOBD, FedOBD-SQ and FedPAQ on the SPMD session
#: (shipped file, rounds, tuning epochs) of phase 4e: each as shipped but
#: for ``round``, ``second_phase_epoch`` (fed_paq has no tuning phase) and
#: ``SPMD_OBD_EPOCHS`` local epochs of their 5 (for the script's time)
SPMD_OBD_EPOCHS = 1
SPMD_OBD_RUNS = (
    ("fed_obd/cifar10.yaml", 1, 1),
    ("fed_obd/vit_cifar100.yaml", 1, 1),
    ("fed_obd_sq/cifar100.yaml", 1, 1),
    ("fed_paq/cifar10.yaml", 1, 0),
)


def expected_obd_k1(aggregates: int, n_slots: int, chunk: int) -> int:
    """K1 launches of an SPMD FedOBD or fed_paq run (``parallel/spmd_obd.py``,
    ``parallel/spmd.py``): one for each chunk of ``chunk`` slots in every
    aggregate (phase-1 rounds and phase-2 epochs), selected or not."""
    return aggregates * (n_slots // chunk)


class CodecSteps:
    """Records every step the SPMD sessions' codec takes while entered, by
    ``(aggregate, slot, JAX key)`` (slot None: the broadcast): NNADQ's
    ``span / (2^bits - 1)``, QSGD's ``scale / level``; and each aggregate's
    weights.  A level flip moves an element of the exact average by one
    client's step times its share of the weight, or by the step of the
    broadcast its clients trained from (:meth:`moves`).  With ``boundary``
    (NNADQ only) it also notes, for each upload's leaf, which elements sat
    within ``boundary`` of a level step from a rounding boundary: the
    elements whose level another device's last-bit differences can flip.
    Reading a step syncs the card: for checks, not for timed runs."""

    def __init__(self, boundary: float | None = None) -> None:
        self.steps: dict[tuple, float] = {}
        self.weights: dict[int, object] = {}
        self.boundary = boundary
        #: ``(aggregate, slot, JAX key)`` -> the JAX-order flat indices near a boundary
        self.near: dict[tuple, object] = {}
        self._saved = []

    def __enter__(self) -> "CodecSteps":
        import torch

        from distributed_learning_simulator_tpu_torch.parallel import spmd, spmd_obd

        obd, avg = spmd_obd.SpmdFedOBDSession, spmd.SpmdFedAvgSession
        code, run_aggregate, paq_upload, run_round = obd._code, obd.run_aggregate, avg._paq_upload, avg.run_round

        def noted_code(session, x, aggregate, slot, kept):
            out, bits = code(session, x, aggregate, slot, kept)
            if self.boundary is not None and session._codec != "nnadq":
                raise NotImplementedError("CodecSteps(boundary=...) knows NNADQ's rounding only")
            for position, i in enumerate(session._layout_order):
                leaf = session._jax_leaves[i]
                piece = x[leaf.start : leaf.stop]
                if session._codec == "nnadq":
                    levels = 2.0 ** bits[position] - 1.0
                    step = (piece.max() - piece.min()) / levels
                    if self.boundary is not None and slot is not None:
                        lo, span = piece.min(), torch.clamp(piece.max() - piece.min(), min=1e-12)
                        v = leaf.to_jax((piece - lo) / span * levels)  # the codec's level positions
                        near = (v - torch.floor(v) - 0.5).abs() < self.boundary
                        self.near[(aggregate, slot, leaf.jax_key)] = torch.nonzero(near).flatten().cpu().numpy()
                else:
                    step = piece.abs().max() / session._level
                self.steps[(aggregate, slot, leaf.jax_key)] = float(step)
            return out, bits

        def noted_aggregate(session, g, weights, key, phase_two, trains=None):
            self.weights[session._aggregates] = weights.copy()
            return run_aggregate(session, g, weights, key, phase_two, trains)

        def noted_paq(session, row, start, aggregate, slot):
            for leaf in session._jax_leaves:
                delta = row[leaf.start : leaf.stop].float() - start[leaf.start : leaf.stop].float()
                self.steps[(aggregate, slot, leaf.jax_key)] = float(delta.abs().max() / session.quantization_level)
            return paq_upload(session, row, start, aggregate, slot)

        def noted_round(session, global_vec, weights, round_number=1, delays=None):
            self.weights[round_number - 1] = weights.copy()
            return run_round(session, global_vec, weights, round_number, delays)

        for owner, name, fn in ((obd, "_code", noted_code), (obd, "run_aggregate", noted_aggregate),
                                (avg, "_paq_upload", noted_paq), (avg, "run_round", noted_round)):
            self._saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, fn)
        return self

    def __exit__(self, *exc) -> None:
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        self._saved.clear()

    def _near(self, aggregate: int, slot: int, key: str, element: int) -> bool:
        import numpy as np

        near = self.near.get((aggregate, slot, key))  # sorted
        if near is None or not len(near):
            return False
        i = int(np.searchsorted(near, element))
        return i < len(near) and int(near[i]) == element

    def moves(self, aggregate: int, key: str, element: int | None = None) -> list[float]:
        """What one level flip moves an element of leaf ``key`` by in the
        exact average of ``aggregate``.  With ``element`` (a JAX-order flat
        index; needs ``boundary``): only the moves of the clients whose
        upload of that element sat near a rounding boundary."""
        weights = self.weights[aggregate]
        total = float(weights.sum())
        moves = [
            float(w) / total * self.steps[(aggregate, slot, key)]
            for slot, w in enumerate(weights) if w > 0 and (aggregate, slot, key) in self.steps
            and (element is None or self._near(aggregate, slot, key, element))
        ]
        if element is None and (aggregate - 1, None, key) in self.steps:
            moves.append(self.steps[(aggregate - 1, None, key)])
        return moves


def flipped_elements(got: dict, want: dict, steps: CodecSteps, aggregate: int, atol: float, rtol: float,
                     match: float, within_tolerance: bool = False, counts: list | None = None) -> dict:
    """Elements of two parameter sets (JAX keys) beyond ``atol +
    rtol·|want|``; each must differ by one level flip of ``aggregate``'s
    codec (:meth:`CodecSteps.moves`): to within ``match`` of the move, or
    with ``within_tolerance``, within ``atol + rtol·|want|`` once the move
    is taken off.  With ``steps.boundary`` only the clients whose upload
    of the element sat near a rounding boundary can have flipped it, and
    it may differ by the moves of ``n`` of those ``k`` clients together:
    by between the sum of their ``n`` smallest and of their ``n`` largest
    moves, within ``atol + rtol·|want|``.  Several clients' uploads of
    one element can sit on a boundary together: where a leaf's gradient
    has one direction for every client (a classifier's last LayerNorm
    bias under a two-class head), every client's delta is that vector
    scaled, and the codec's levels, set by each upload's own range, put
    the element at the same place between them.  ``counts`` gathers each
    flagged element's ``k``.  Returns the masks by key."""
    import numpy as np

    masks = {}
    for key, value in want.items():
        diff = np.abs(got[key] - value)
        tol = atol + rtol * np.abs(value)
        masks[key] = off = diff > tol
        for element, d, t in zip(np.flatnonzero(off), diff[off], tol[off]):
            near = steps.boundary is not None
            moves = [m for m in steps.moves(aggregate, key, int(element) if near else None) if m > 0]
            if counts is not None:
                counts.append(len(moves))
            one = any(abs(d - m) <= match * m or (within_tolerance and abs(d - m) <= t) for m in moves)
            ordered = sorted(moves)
            some = near and any(sum(ordered[:n]) - t <= d <= sum(ordered[-n:]) + t
                                for n in range(2, len(ordered) + 1))
            check(one or some, f"{key}[{element}]: {d} apart, not {'the flips of' if near else 'one flip of'} {moves}")
    return masks


def obd_task_config(save_dir: str, extra: dict | None = None, **algorithm_kwargs):
    """Phase 3's FedOBD task: ``conf/fed_obd/cifar10.yaml`` cut to 2
    clients x 16 samples, 2 local epochs, 1 round and 1 tuning epoch;
    ``extra`` more dotted overrides."""
    overrides = {"round": 1, "epoch": 2, "worker_number": 2, "batch_size": 16,
                 "algorithm_kwargs.second_phase_epoch": 1}
    overrides.update({f"dataset_kwargs.{k}": v for k, v in {"train_size": 32, "val_size": 16, "test_size": 32}.items()})
    overrides.update(extra or {})
    overrides.update({f"algorithm_kwargs.{k}": v for k, v in algorithm_kwargs.items()})
    return shipped_config(SPMD_OBD_RUNS[0][0], save_dir, **overrides)


def check_obd_task_against_cpu(workdir: str) -> None:
    """``conf/fed_obd/cifar10.yaml`` (DenseNet-40, f32, NNADQ at weight
    0.01, block dropout 0.9) cut to 2 clients x 16 samples, 2 local epochs,
    1 round and 1 tuning epoch, from one init on the card (K1) and on the
    CPU (its plain version):

    * the two aggregates in lockstep (``run_aggregate`` of a session on
      each device, both from the CPU's broadcast each time): each exact
      average's values within 1e-3 but for elements one upload level flip
      apart (the few-bit delta codes' steps are far above the two devices'
      last-bit differences in training, so an element on a level boundary
      can flip; each must differ by one client's step times its weight
      share, to 1%; at most 0.1% of them), its test loss within 1e-3 once
      those verified elements take the CPU's values (the raw difference
      is printed: 3.2e-4 with 71 flips in a card run), and its upload and
      broadcast bits within 1e-6 (the same kept blocks and bit widths);
    * ``train()`` on both: the same phases, and every record's test loss
      within 1e-2.  Over a whole run a flip also moves the next broadcast
      by one or two of its steps and the next round trains from there,
      which is why the tight checks are the lockstep ones."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.models import convert
    from distributed_learning_simulator_tpu_torch.training import build_session, train

    make_config = obd_task_config
    init = os.path.join(workdir, "obd_init.npz")
    session = build_session(make_config(os.path.join(workdir, "obd_init")), device="cpu")
    np.savez(init, **convert.to_jax(session.engine.init_params(0)))
    perf = {device: train(make_config(os.path.join(workdir, f"obd_{device}"), global_model_path=init),
                          device=device)["performance"] for device in ("cuda", "cpu")}
    check([r["phase"] for _, r in sorted(perf["cuda"].items())] == ["block_dropout_rounds", "epoch_tune"],
          f"OBD task phases {perf['cuda']}")
    run_rel = max(abs(perf["cuda"][k]["test_loss"] - row["test_loss"]) / abs(row["test_loss"])
                  for k, row in perf["cpu"].items())

    sessions = {device: build_session(make_config(os.path.join(workdir, f"obd_lockstep_{device}"),
                                                  global_model_path=init), device=device)
                for device in ("cuda", "cpu")}
    cpu = sessions["cpu"]
    g = cpu._init_global_params()
    layout = cpu.engine.layout
    flipped, param_err, loss_rel, raw_rel, wire_rel, losses = [], 0.0, 0.0, 0.0, 0.0, []
    for key, phase_two in ((1, False), (2, True)):
        weights = cpu._all_weights() if phase_two else cpu._base_weight_row(key)
        with CodecSteps() as steps:
            exact, bcast, *bits = cpu.run_aggregate(g, weights, key, phase_two)
        card, _, *card_bits = sessions["cuda"].run_aggregate(g.cuda(), weights, key, phase_two)
        wire_rel = max([wire_rel] + [abs(float(a) - float(b)) / float(b) for a, b in zip(card_bits, bits)])
        got, want = convert.to_jax(layout.split(card.cpu())), convert.to_jax(layout.split(exact))
        param_err = max(param_err, float((card.cpu() - exact).abs().max()))
        masks = flipped_elements(got, want, steps, key - 1, 1e-3, 0.0, 1e-2)
        flipped.append(sum(int(m.sum()) for m in masks.values()))
        settled = layout.flatten(convert.from_jax({k: np.where(masks[k], want[k], got[k]) for k in got})).cuda()
        loss = [sessions["cuda"]._evaluate(v)["loss"] for v in (settled, card)] + [cpu._evaluate(exact)["loss"]]
        losses.append(loss)
        loss_rel = max(loss_rel, abs(loss[0] - loss[2]) / abs(loss[2]))
        raw_rel = max(raw_rel, abs(loss[1] - loss[2]) / abs(loss[2]))
        g = bcast
    size = layout.size
    print(
        f"small task (DenseNet-40 fed_obd, 1 round + 1 tuning epoch) card vs CPU, in lockstep: test loss (card with"
        f" the flipped elements at the CPU's values, card, CPU) {losses} (rel {loss_rel:.2g}; raw {raw_rel:.2g}),"
        f" upload and broadcast bits rel {wire_rel:.2g}, exact averages' max |diff| {param_err:.3g}, elements one"
        f" upload level flip apart (beyond 1e-3) {flipped} of {size};"
        f" by train(): test loss {[perf['cuda'][k]['test_loss'] for k in sorted(perf['cuda'])]} vs"
        f" {[perf['cpu'][k]['test_loss'] for k in sorted(perf['cpu'])]} (rel {run_rel:.2g}), wire MB"
        f" {[(perf['cuda'][k]['received_mb'], perf['cuda'][k]['sent_mb']) for k in sorted(perf['cuda'])]};"
        f" TF32 for f32 convolutions {torch.backends.cudnn.allow_tf32}"
    )
    check(loss_rel <= 1e-3, "small task (DenseNet-40 fed_obd): card and CPU losses disagree in lockstep")
    check(wire_rel <= 1e-6, "small task (DenseNet-40 fed_obd): card and CPU wire bits disagree in lockstep")
    check(sum(flipped) <= 1e-3 * size, f"small task (DenseNet-40 fed_obd): {flipped} elements a level apart")
    check(run_rel <= 1e-2, "small task (DenseNet-40 fed_obd): card and CPU runs' losses disagree")


def run_obd_spmd_files(workdir: str) -> tuple[dict[str, int], dict]:
    """``train()`` on each of ``SPMD_OBD_RUNS`` at full width (``SPMD_OBD_EPOCHS``
    local epochs), with the
    launch counters set to 0 just before each and read just after: every
    record's phase, time, test loss and wire MB, the peak memory, K1's
    launches checked exactly (``expected_obd_k1``: the files' 10 workers in
    chunks of ``CNN_CHUNK``), and on the ViT file every K4 and K5 launch on
    the wgmma kernels; no other kernel.  Returns the launches of all runs
    and each file's records."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.ops import short_attention as sa
    from distributed_learning_simulator_tpu_torch.training import train

    total, records = {}, {}
    for name, rounds, tuning in SPMD_OBD_RUNS:
        overrides = {"round": rounds, "epoch": SPMD_OBD_EPOCHS}
        if tuning:
            overrides["algorithm_kwargs.second_phase_epoch"] = tuning
        config = shipped_config(name, os.path.join(workdir, name.replace("/", "_")[:-5]), **overrides)
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by earlier phases, still alive
        t0 = time.monotonic()
        perf = train(config)["performance"]
        wall = time.monotonic() - t0
        launches, routes = _read_launches(), dict(sa.route_launches)
        for kid, n in launches.items():
            total[kid] = total.get(kid, 0) + n
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        print(
            f"main path {name} ({config.distributed_algorithm}, {config.model_name}, {config.worker_number}"
            f" workers, {config.algorithm_kwargs.get('random_client_number')} selected, {config.epoch} epochs):"
            f" {rounds} rounds + {tuning} tuning epochs in {wall:.2f} s (setup included); peak memory"
            f" {peak:.2f} GiB over the {held / 2**30:.2f} GiB held before it; launches {launches}"
        )
        for key, row in sorted(perf.items()):
            print(
                f"  record {key} {row.get('phase')}: {row['round_seconds']:.3f} s, test loss {row['test_loss']:.4f}"
                f" accuracy {row['test_accuracy']:.4f}, received {row['received_mb']:.4f} MB, sent"
                f" {row['sent_mb']:.4f} MB"
            )
            check(np.isfinite(row["test_loss"]), f"{name} record {key} test loss {row['test_loss']}")
            check(0.0 <= row["test_accuracy"] <= 1.0, f"{name} record {key} accuracy {row['test_accuracy']}")
        phases = [row.get("phase") for _, row in sorted(perf.items())]
        want = ["block_dropout_rounds"] * rounds + ["epoch_tune"] * tuning if tuning else [None] * rounds
        check(phases == want, f"{name} phases {phases}, want {want}")
        k1 = expected_obd_k1(len(perf), config.worker_number, CNN_CHUNK)
        check(launches["K1"] == k1, f"{name} K1 launches {launches['K1']}, want {k1}")
        if config.model_name == "vit_base":
            check(launches["K4"] > 0 and launches["K5"] > 0, f"{name} attention launches {launches}")
            check_short_routes(routes, launches["K4"], launches["K5"], name)
        others = [kid for kid, n in launches.items() if n and kid not in ("K1", "K4", "K5")]
        check(not others, f"{name}: kernels off this path launched: {others}")
        check(not torch.backends.cudnn.allow_tf32, f"{name}: f32 convolutions ran in TF32")
        records[name] = {"wall_s": wall, "peak_gib": peak, "records": perf}
    return total, records


# ------------------------------------------- the shipped conf/fed_avg files
def run_shipped_configs(workdir: str) -> dict[str, int]:
    """``train()`` on ``conf/fed_avg/cifar10.yaml`` (DenseNet-40),
    ``imdb.yaml`` (the text classifier), ``imagenet.yaml`` (ResNet-18) and
    ``mnist.yaml`` (LeNet5) as shipped but for ``round`` (1) and the local
    epochs of ``CNN_EPOCHS``, at full
    width; checks each run's K1 launches exactly (a chunk of ``CNN_CHUNK``
    clients at a time) and that no other kernel ran.  Returns the launches
    of all four runs."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.training import train

    _reset_launches()
    total = {}
    for name in (CNN_MAIN, *CNN_EXTRA):
        depth = {"epoch": CNN_EPOCHS[name]} if name in CNN_EPOCHS else {}
        config = shipped_config(name, os.path.join(workdir, name.replace("/", "_")[:-5]), round=1, **depth)
        before = _read_launches()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by earlier phases, still alive
        t0 = time.monotonic()
        perf = train(config)["performance"]
        wall = time.monotonic() - t0
        total = _read_launches()
        moved = {kid: total[kid] - before[kid] for kid in total}
        last = perf[config.round]
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        print(
            f"main path {name} ({config.model_name}, {config.worker_number} workers, batch"
            f" {config.batch_size}, {config.epoch} epochs): {config.round} rounds in {wall:.2f} s (setup"
            f" included); round {config.round} {last['round_seconds']:.3f} s; test loss"
            f" {last['test_loss']:.4f} accuracy {last['test_accuracy']:.4f} over {last['test_count']:.0f};"
            f" peak memory {peak:.2f} GiB over the {held / 2**30:.2f} GiB held before it; launches {moved}"
        )
        for r, row in perf.items():
            check(np.isfinite(row["test_loss"]), f"{name} round {r} test loss {row['test_loss']}")
            check(0.0 <= row["test_accuracy"] <= 1.0, f"{name} round {r} accuracy {row['test_accuracy']}")
        want = config.round * config.worker_number // CNN_CHUNK
        check(moved["K1"] == want, f"{name} K1 launches {moved['K1']}, want {want}")
        others = [kid for kid, n in moved.items() if n and kid != "K1"]
        check(not others, f"{name}: kernels off this path launched: {others}")
        check(not torch.backends.cudnn.allow_tf32, f"{name}: f32 convolutions ran in TF32")
    return total


# ------------------- 4f: round_horizon, remat_policy, FedDropoutAvg and SMAFD
#: the source paper's method at its 100-client geometry: 100 workers, 50
#: selected, ``round_horizon`` 5, ``remat_policy: dots_saveable``; run as
#: shipped but for ``round`` and ``second_phase_epoch``: one phase-1
#: horizon of 5 rounds, then ``LARGE_OBD_TUNING`` tuning epochs, the
#: switch on a boundary: phase 2 runs as one chunk of 2 aggregates (no
#: checkpoint between them, ``opt_state.npz`` at its end), the optimizer
#: states carried from the first to the second, and the horizon parity
#: holds both phases (a host-bound round takes 3-6 s, and the host's speed
#: varies by machine: the depth the script can afford).
#: The DenseNet-40 file's run is also the horizon parity's; the others
#: take ``LARGE_OBD_OTHER_ROUNDS`` phase-1 round, a horizon clamped to 1
#: before the switch, and 1 tuning epoch (for the script's time)
LARGE_OBD_FILES = (
    "large_scale/fed_obd/cifar10.yaml",
    "large_scale/fed_obd/cifar100.yaml",
    "large_scale/fed_obd/cifar100_sq.yaml",
    "large_scale/fed_obd/imdb.yaml",
)
LARGE_OBD_ROUNDS, LARGE_OBD_TUNING, LARGE_OBD_OTHER_ROUNDS = 5, 2, 1
#: the FedDropoutAvg and SMAFD files, one round each as shipped but for 1
#: local epoch of their 5 (``SPARSE_EPOCHS``, for the script's time)
SPARSE_EPOCHS = 1
SPARSE_FILES = tuple(
    f"{family}/{data}.yaml"
    for family in ("fed_dropout_avg", "large_scale/fed_dropout_avg", "smafd", "large_scale/smafd")
    for data in ("cifar10", "cifar100", "imdb")
)


def host_draws():
    """A random source (codec and graph) that makes the port's own draws on
    the host and moves them to the device: a task then draws the same keep
    masks, minibatches, fan-in priorities and dropout masks on the card as
    on the CPU (a generator on the card draws another stream)."""
    from distributed_learning_simulator_tpu_torch.ops.graph_sampling import GraphRandom

    class HostDraws(GraphRandom):
        @staticmethod
        def _uniform(entropy, shape, device):
            return GraphRandom._uniform(entropy, shape, "cpu").to(device)

    return HostDraws()


def sparse_small_task(name: str):
    """``conf/<name>`` (DenseNet-40, f32) cut to 2 clients x 16 samples, 2
    local epochs (the best-epoch validation runs), 1 round, its draws made
    on the host (:func:`host_draws`)."""

    def make_config(save_dir: str, **algorithm_kwargs):
        sizes = {"train_size": 32, "val_size": 16, "test_size": 32}
        overrides = {"round": 1, "epoch": 2, "worker_number": 2, "batch_size": 16}
        overrides.update({f"dataset_kwargs.{k}": v for k, v in sizes.items()})
        overrides.update({f"algorithm_kwargs.{k}": v for k, v in algorithm_kwargs.items()})
        config = shipped_config(name, save_dir, **overrides)
        config.endpoint_kwargs.setdefault("worker", {})["random"] = host_draws()
        return config

    return make_config


def _round_params(save_dir: str, key: int) -> dict:
    """``aggregated_model/round_<key>.npz`` of a run's ``save_dir``."""
    import numpy as np

    with np.load(os.path.join(save_dir, "aggregated_model", f"round_{key}.npz")) as blob:
        return {k: blob[k] for k in blob.files}


def _apart(a: tuple, b: tuple) -> tuple[float, float]:
    """How far two runs (records, final parameters) are apart: the largest
    relative test-loss difference over the rows, and the largest parameter
    difference."""
    import numpy as np

    (perf_a, params_a), (perf_b, params_b) = a, b
    check(sorted(perf_a) == sorted(perf_b), f"runs of {sorted(perf_a)} and {sorted(perf_b)} records")
    rows = max(abs(perf_a[k]["test_loss"] - perf_b[k]["test_loss"]) / abs(perf_b[k]["test_loss"]) for k in perf_b)
    params = max(float(np.abs(params_a[k] - params_b[k]).max()) for k in params_b)
    return rows, params


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN on deterministic algorithms inside: two runs of a DenseNet-40
    task then agree bit for bit, so a check can hold a variant to the
    run-to-run spread, which is 0 (the default weight-gradient algorithms
    need not be deterministic)."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def run_large_scale_obd(workdir: str) -> tuple[dict[str, int], dict]:
    """``train()`` on each of ``LARGE_OBD_FILES`` at full width for
    ``LARGE_OBD_ROUNDS`` rounds and ``LARGE_OBD_TUNING`` tuning epochs (the
    others ``LARGE_OBD_OTHER_ROUNDS`` and 1), the launch counters set to 0
    just before each and read just after: every
    record and its phase, the peak memory, and K1's launches
    checked exactly (``expected_obd_k1``: 100 slots in chunks of
    ``CNN_CHUNK``); no other kernel.  The first file runs with cuDNN on
    deterministic algorithms: it is also the H = 5 run of
    :func:`check_horizon_parity`, and its checkpoints must lie on the
    horizon's boundaries.  Returns the launches of all runs and
    each file's records (the first one's with its final parameters)."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.training import train

    total, records = {}, {}
    for name in LARGE_OBD_FILES:
        parity = name == LARGE_OBD_FILES[0]
        tuning = LARGE_OBD_TUNING if parity else 1
        rounds = LARGE_OBD_ROUNDS if parity else LARGE_OBD_OTHER_ROUNDS
        config = shipped_config(name, os.path.join(workdir, name.replace("/", "_")[:-5]), round=rounds,
                                **{"algorithm_kwargs.second_phase_epoch": tuning})
        check(int(config.algorithm_kwargs["round_horizon"]) == 5, f"{name}: round_horizon {config.algorithm_kwargs}")
        check(config.extra_hyper_parameters == {"remat_policy": "dots_saveable"}, f"{name}: {config.extra_hyper_parameters}")
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by earlier phases, still alive
        t0 = time.monotonic()
        with deterministic_convolutions() if parity else contextlib.nullcontext():
            perf = train(config)["performance"]
        wall = time.monotonic() - t0
        launches = _read_launches()
        for kid, n in launches.items():
            total[kid] = total.get(kid, 0) + n
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        print(
            f"main path {name} ({config.distributed_algorithm}, {config.model_name}, {config.worker_number} workers,"
            f" {config.algorithm_kwargs['random_client_number']} selected, round_horizon 5, remat_policy"
            f" dots_saveable{', deterministic cuDNN' if parity else ''}): {rounds} rounds +"
            f" {tuning} tuning epochs in {wall:.2f} s (setup included); peak"
            f" memory {peak:.2f} GiB over the {held / 2**30:.2f} GiB held before it; launches {launches}"
        )
        for key, row in sorted(perf.items()):
            print(
                f"  record {key} {row['phase']}: {row['round_seconds']:.3f} s, test loss"
                f" {row['test_loss']:.4f} accuracy {row['test_accuracy']:.4f}, received {row['received_mb']:.4f} MB,"
                f" sent {row['sent_mb']:.4f} MB"
            )
            check(np.isfinite(row["test_loss"]), f"{name} record {key} test loss {row['test_loss']}")
            check(0.0 <= row["test_accuracy"] <= 1.0, f"{name} record {key} accuracy {row['test_accuracy']}")
        phases = [row["phase"] for _, row in sorted(perf.items())]
        want = ["block_dropout_rounds"] * rounds + ["epoch_tune"] * tuning
        check(phases == want, f"{name} phases {phases}")
        k1 = expected_obd_k1(len(perf), config.worker_number, CNN_CHUNK)
        check(launches["K1"] == k1, f"{name} K1 launches {launches['K1']}, want {k1}")
        others = [kid for kid, n in launches.items() if n and kid != "K1"]
        check(not others, f"{name}: kernels off this path launched: {others}")
        check(not torch.backends.cudnn.allow_tf32, f"{name}: f32 convolutions ran in TF32")
        records[name] = {"wall_s": wall, "peak_gib": peak, "records": perf}
        if parity:
            records[name]["final"] = _round_params(config.save_dir, max(perf))
            # checkpoints on the horizon's boundaries only: phase 1's end and
            # phase 2's chunk end, the optimizer states saved with the latter
            model_dir = os.path.join(config.save_dir, "aggregated_model")
            saved = sorted(int(f[6:-4]) for f in os.listdir(model_dir) if f.startswith("round_"))
            with np.load(os.path.join(model_dir, "opt_state.npz")) as blob:
                stat_key = int(blob["stat_key"])
            check(saved == [rounds, rounds + tuning] and stat_key == rounds + tuning,
                  f"{name}: checkpoints {saved}, opt_state.npz of aggregate {stat_key}")
    return total, records


def check_horizon_parity(workdir: str, records: dict) -> None:
    """``large_scale/fed_obd/cifar10.yaml`` at ``LARGE_OBD_ROUNDS`` rounds and
    ``LARGE_OBD_TUNING`` tuning epochs with ``round_horizon`` 1, cuDNN on
    deterministic algorithms: the main path's run of the file (H = 5, the
    same algorithms) must equal it bit for bit, every row and the final
    parameters: with those algorithms two runs of the file agree bit for
    bit, so no run-to-run spread is allowed."""
    from distributed_learning_simulator_tpu_torch.training import train

    name = LARGE_OBD_FILES[0]
    with deterministic_convolutions():
        config = shipped_config(name, os.path.join(workdir, "parity_h1"), round=LARGE_OBD_ROUNDS,
                                **{"algorithm_kwargs.second_phase_epoch": LARGE_OBD_TUNING,
                                   "algorithm_kwargs.round_horizon": 1})
        t0 = time.monotonic()
        perf = train(config)["performance"]
    print(f"  horizon parity h1: {len(perf)} aggregates in {time.monotonic() - t0:.2f} s (setup included), test"
          f" loss {[round(perf[k]['test_loss'], 6) for k in sorted(perf)]}")
    fused = _apart((records[name]["records"], records[name]["final"]), (perf, _round_params(config.save_dir, max(perf))))
    print(
        f"horizon parity ({name}, {LARGE_OBD_ROUNDS} rounds + {LARGE_OBD_TUNING} tuning epochs, deterministic"
        f" cuDNN): H = 5 against H = 1 rows rel {fused[0]:.3g}, params {fused[1]:.3g}"
    )
    check(fused == (0.0, 0.0), "the H = 5 run is not the H = 1 run bit for bit")


def check_remat(workdir: str) -> None:
    """One phase-1 round (``run_aggregate``) of ``large_scale/fed_obd/cifar10.yaml``
    and of ``imdb.yaml``, each without remat and with the file's
    ``dots_saveable``, in fresh sessions, cuDNN on deterministic
    algorithms: the peak memory over what the session held before the
    round (remat's below the plain round's: it checkpoints each block of
    the model, so the backward holds one block's recompute at a time), the
    round's time (to a sync), and the remat round's exact average and test
    loss equal to the plain round's bit for bit (with those algorithms two
    plain rounds agree bit for bit, so no run-to-run spread is allowed)."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.training import build_session

    for name in (LARGE_OBD_FILES[0], LARGE_OBD_FILES[3]):
        results = {}
        with deterministic_convolutions():
            for label in ("plain", "remat"):
                config = shipped_config(name, os.path.join(workdir, f"remat_{label}"), round=1,
                                        **{"algorithm_kwargs.second_phase_epoch": 1})
                if label != "remat":
                    config.extra_hyper_parameters = {}
                session = build_session(config)
                check(session.engine.remat == ("dots" if label == "remat" else None), f"{label}: {session.engine.remat}")
                g = session._init_global_params()
                weights = session._base_weight_row(1)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                t0 = time.monotonic()
                exact, *_ = session.run_aggregate(g, weights, 1, phase_two=False)
                torch.cuda.synchronize()
                seconds = time.monotonic() - t0
                peak = (torch.cuda.max_memory_allocated() - held) / 2**30
                loss = session._evaluate(exact)["loss"]
                results[label] = (exact.cpu().numpy(), loss, seconds, peak)
                del session, exact, g
        (plain, loss0, t0_, p0), (remat, loss1, t1, p1) = results["plain"], results["remat"]
        moved = (float(np.abs(remat - plain).max()), abs(loss1 - loss0))
        print(
            f"remat ({name}, one phase-1 round: 50 clients, deterministic cuDNN): peak memory over the session"
            f" plain {p0:.3f} GiB, dots_saveable {p1:.3f} GiB; round {t0_:.3f} s, {t1:.3f} s; remat against"
            f" plain: params {moved[0]:.3g}, test loss {moved[1]:.3g}"
        )
        check(moved == (0.0, 0.0), f"{name}: remat moved the round")
        check(p1 < p0, f"{name}: remat's peak memory {p1:.3f} GiB is not below the plain round's")


def run_sparse_files(workdir: str) -> tuple[dict[str, int], dict]:
    """``train()`` on each of ``SPARSE_FILES`` for one round at full width
    (``SPARSE_EPOCHS`` local epochs), the
    launch counters set to 0 just before each and read just after:
    the record, the peak memory, and K1's launches checked exactly (one a
    chunk of ``CNN_CHUNK`` slots; FedDropoutAvg's over ``[mb, 2·D]``);
    no other kernel.  Returns the launches of all runs and the records."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.training import train

    total, records = {}, {}
    for name in SPARSE_FILES:
        config = shipped_config(name, os.path.join(workdir, name.replace("/", "_")[:-5]), round=1, epoch=SPARSE_EPOCHS)
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        perf = train(config)["performance"]
        wall = time.monotonic() - t0
        launches = _read_launches()
        for kid, n in launches.items():
            total[kid] = total.get(kid, 0) + n
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        row = perf[1]
        print(
            f"main path {name} ({config.distributed_algorithm}, {config.model_name}, {config.worker_number} workers,"
            f" {config.algorithm_kwargs.get('random_client_number')} selected, {config.epoch} epochs): 1 round in"
            f" {wall:.2f} s (setup included), round {row['round_seconds']:.3f} s; test loss {row['test_loss']:.4f}"
            f" accuracy {row['test_accuracy']:.4f}; received {row['received_mb']:.4f} MB, sent {row['sent_mb']:.4f} MB;"
            f" peak memory {peak:.2f} GiB over the {held / 2**30:.2f} GiB held before it; launches {launches}"
        )
        check(sorted(perf) == [1], f"{name} records {sorted(perf)}")
        check(np.isfinite(row["test_loss"]) and 0.0 <= row["test_accuracy"] <= 1.0, f"{name} record {row}")
        k1 = expected_obd_k1(1, config.worker_number, CNN_CHUNK)
        check(launches["K1"] == k1, f"{name} K1 launches {launches['K1']}, want {k1}")
        others = [kid for kid, n in launches.items() if n and kid != "K1"]
        check(not others, f"{name}: kernels off this path launched: {others}")
        check(not torch.backends.cudnn.allow_tf32, f"{name}: f32 convolutions ran in TF32")
        records[name] = {"wall_s": wall, "peak_gib": peak, "records": perf}
    return total, records


# --------------------------- 3 and 4g: sign-SGD and the Shapley-value methods
#: the card's and the CPU's gradients of one DenseNet-40 step part by up
#: to GRAD_TOL of a leaf's largest magnitude (2.65e-3 in a card run:
#: cuDNN's and the CPU's f32 convolutions sum in other orders through 40
#: layers), so a gradient element within FLIP_TAU of its leaf's largest
#: may take either sign on the two devices and flip a vote (measured: up
#: to 1.23e-4)
GRAD_TOL, FLIP_TAU = 1e-2, 1e-3
#: the card's and the CPU's trained rows after a GTG task's 5 local epochs
#: at lr 0.1 part by up to ROW_TOL of a row's largest value (first card
#: runs: 2.14e-4 after 5 epochs, 2.55e-5 after 2: the gradients' parting
#: above, grown through the steps)
ROW_TOL = 1e-3
#: the shipped sign-SGD files, as shipped but for their 100 local epochs
SIGN_SGD_FILES = ("sign_sgd/cifar10.yaml", "sign_sgd/cifar100.yaml", "sign_sgd/imdb.yaml")
SIGN_SGD_EPOCHS = 1
#: the shipped Shapley files and the rounds each runs, at 1 local epoch;
#: the two LeNet5 files run 2 rounds (the between-round truncation and the
#: carried ``last_round_metric``)
SHAPLEY_FILES = (
    ("gtg_sv/cifar10.yaml", 1),
    ("gtg_sv/cifar100.yaml", 1),
    ("gtg_sv/imdb.yaml", 1),
    ("gtg_sv/mnist.yaml", 2),
    ("hierarchical_sv/cifar10.yaml", 1),
    ("hierarchical_sv/mnist.yaml", 2),
    ("multiround_sv/cifar10.yaml", 1),
    ("multiround_sv/cifar100.yaml", 1),
)
#: the test splits cut for the script's time (1024 for CIFAR-10 and 2048
#: for CIFAR-100 as shipped), which every subset metric evaluates: the
#: multi-round files evaluate their 201 subsets at 10 players whatever the
#: metrics, and GTG's CIFAR-10 files 186 of their 214 at 256 samples;
#: ``gtg_sv/cifar100.yaml`` stays as shipped, since on 256 samples its
#: metrics truncate GTG after 1 subset.  Phase 4k's threaded
#: ``multiround_sv/cifar10.yaml`` takes its entry too
SHAPLEY_TEST_SPLITS = {
    "gtg_sv/cifar10.yaml": 256,
    "hierarchical_sv/cifar10.yaml": 256,
    "multiround_sv/cifar10.yaml": 256,
    "multiround_sv/cifar100.yaml": 256,
}


def shapley_test_split(name: str) -> dict:
    """``name``'s cut of ``SHAPLEY_TEST_SPLITS`` as a config override."""
    return {"dataset_kwargs.test_size": SHAPLEY_TEST_SPLITS[name]} if name in SHAPLEY_TEST_SPLITS else {}


def _cut_task(name: str, workers: int, test_size: int, **overrides):
    """``conf/<name>`` cut to ``workers`` clients x 16 samples and a test
    set of ``test_size``, 1 round, its other settings as shipped; the
    config maker takes ``algorithm_kwargs`` entries too."""

    def make_config(save_dir: str, **algorithm_kwargs):
        sizes = {"train_size": 16 * workers, "val_size": 16, "test_size": test_size}
        fields = {"round": 1, "worker_number": workers, **overrides}
        fields.update({f"dataset_kwargs.{k}": v for k, v in sizes.items()})
        fields.update({f"algorithm_kwargs.{k}": v for k, v in algorithm_kwargs.items()})
        return shipped_config(name, save_dir, **fields)

    return make_config


def check_sign_sgd_task_against_cpu(workdir: str) -> None:
    """``conf/sign_sgd/cifar10.yaml`` (DenseNet-40, f32) cut to 2 clients x
    16 samples, batch 8, 2 local epochs, 1 round, from the port's init:

    * in lockstep, every step from the CPU's parameters: each voter's
      gradient on the card within ``GRAD_TOL`` of the CPU's (relative to
      its leaf's largest magnitude); each device's vote (K1 over the bf16
      signs on the card) exactly ``sign(sum_c w_c * sign(g_c))`` of its own
      gradients; where the votes differ (a "flip", counted), a voter's
      gradient signs differ between the devices and its CPU gradient is
      within ``FLIP_TAU`` of its leaf's largest; and the card's update
      from the CPU's direction equal to the CPU's within 1e-6;
    * ``train()`` on both: the record's test loss and train curves within
      1e-2 (relative), as the CPU tests hold the port to JAX through flips."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.training import build_session, train

    make_config = _cut_task(SIGN_SGD_FILES[0], 2, 32, epoch=2, batch_size=8)
    sessions = {device: build_session(make_config(os.path.join(workdir, f"sign_lockstep_{device}")), device=device)
                for device in ("cuda", "cpu")}
    cpu, card = sessions["cpu"], sessions["cuda"]
    layout = cpu.engine.layout
    params = layout.flatten(cpu.engine.init_params(cpu.config.seed))
    velocity = torch.zeros_like(params)
    weights = cpu.round_weights(1)
    votes = {k: s.new_votes(layout.size) for k, s in sessions.items()}
    w = {k: torch.from_numpy(weights).to(s.device) for k, s in sessions.items()}
    schedule = cpu.engine.hyper_parameter.make_schedule(cpu.config.epoch * cpu.n_batches)
    generators = {slot: None for slot in range(cpu.n_slots)}  # DenseNet-40 has no dropout
    flips, ratio, grad_rel, update_err, step = [], 0.0, 0.0, 0.0, 0
    # deterministic cuDNN: the card's gradients taken again for the check
    # are those its vote took
    with deterministic_convolutions():
        for i in [i for _ in range(cpu.config.epoch) for i in range(cpu.n_batches)]:
            want = cpu.vote(params, votes["cpu"], w["cpu"], weights, i, generators)
            got = card.vote(params.cuda(), votes["cuda"], w["cuda"], weights, i, generators).cpu()
            # each voter's gradients on both devices: how far apart, and how
            # near 0 (over its leaf's largest) on the CPU
            near = torch.full_like(params, float("inf"))
            near_views = layout.split(near)
            signs = [torch.zeros_like(params), torch.zeros_like(params)]  # CPU's, card's
            split = torch.zeros_like(params, dtype=torch.bool)  # a voter's signs differ
            for slot in np.flatnonzero(weights):
                if cpu._counts[slot][i] <= 0:
                    continue
                grads = [s.engine.loss_and_grad(p, {k: v[slot, i] for k, v in s._data.items()})[1].cpu()
                         for s, p in ((cpu, params), (card, params.cuda()))]
                for total, grad in zip(signs, grads):
                    total += float(weights[slot]) * torch.sign(grad)
                split |= torch.sign(grads[0]) != torch.sign(grads[1])
                card_views = layout.split(grads[1])
                for key, piece in layout.split(grads[0]).items():
                    scale = piece.abs().max().clamp_min(1e-30)
                    grad_rel = max(grad_rel, float((card_views[key] - piece).abs().max() / scale))
                    torch.minimum(near_views[key], piece.abs() / scale, out=near_views[key])
            check(torch.equal(want, torch.sign(signs[0])), f"sign_SGD step {step}: the CPU's vote is not its signs' vote")
            check(torch.equal(got, torch.sign(signs[1])), f"sign_SGD step {step}: the card's vote is not its signs' vote")
            differ = got != want
            check(not (differ & ~split).any(), f"sign_SGD step {step}: votes differ where no voter's signs do")
            if differ.any():
                ratio = max(ratio, float(near[differ].max()))
            flips.append(int(differ.sum()))
            p, v = params.cuda(), velocity.cuda()
            card.update(p, v, want.cuda(), schedule(step))
            cpu.update(params, velocity, want, schedule(step))
            update_err = max(update_err, float((p.cpu() - params).abs().max()), float((v.cpu() - velocity).abs().max()))
            step += 1
    perf = {device: train(make_config(os.path.join(workdir, f"sign_{device}")), device=device)["performance"][1]
            for device in ("cuda", "cpu")}
    rel = max(
        float(np.max(np.abs(np.atleast_1d(perf["cuda"][key]) - np.atleast_1d(perf["cpu"][key]))
                     / np.maximum(np.abs(np.atleast_1d(perf["cpu"][key])), 1e-6)))
        for key in ("test_loss", "train_loss_per_epoch", "train_accuracy_per_epoch")
    )
    print(
        f"small task (DenseNet-40 sign_SGD, 2 clients, {step} steps) card vs CPU, in lockstep: gradients apart by"
        f" {grad_rel:.3g} of a leaf's largest at most (GRAD_TOL {GRAD_TOL}); vote flips {flips} of {layout.size},"
        f" each where a voter's |g| is within {ratio:.3g} of its leaf's largest (FLIP_TAU {FLIP_TAU}); update max"
        f" |diff| {update_err:.3g}; by train(): test loss {perf['cuda']['test_loss']:.6f} vs"
        f" {perf['cpu']['test_loss']:.6f}, train loss per epoch {perf['cuda']['train_loss_per_epoch']} vs"
        f" {perf['cpu']['train_loss_per_epoch']} (rel {rel:.2g})"
    )
    check(grad_rel <= GRAD_TOL, f"small task (DenseNet-40 sign_SGD): card and CPU gradients {grad_rel} apart")
    check(ratio <= FLIP_TAU, f"small task (DenseNet-40 sign_SGD): a vote differs off the flip rule ({ratio})")
    check(update_err <= 1e-6, f"small task (DenseNet-40 sign_SGD): card and CPU updates disagree ({update_err})")
    check(rel <= 1e-2, f"small task (DenseNet-40 sign_SGD): card and CPU records disagree ({rel})")


# ------------------------------- the threaded executor's other methods
#: phase 4j: the shipped imdb files under ``executor: sequential`` at full
#: width (the classifier: d_model 100, 2 layers, max_len 300, 10 workers),
#: as shipped but for ``THREADED_ROUNDS`` round of ``THREADED_EPOCHS``
#: local epoch (sign_SGD: ``THREADED_EPOCHS`` of its 100) and, for fed_obd,
#: ``second_phase_epoch`` 1
THREADED_FILES = ("fed_paq/imdb.yaml", "fed_obd/imdb.yaml", "fed_dropout_avg/imdb.yaml", "smafd/imdb.yaml",
                  "sign_sgd/imdb.yaml")
THREADED_ROUNDS, THREADED_EPOCHS = 1, 1
#: a threaded FedOBD record past its first aggregate, card against CPU:
#: the bound JAX's ``tests/test_executor_matrix.py`` holds its own two
#: executors to (the codecs round both runs' last-bit differences)
OBD_DRIFT = 5e-3
#: the share of a threaded NNADQ task's first aggregate that level flips
#: may move past 1e-3, card against CPU (3 elements were apart in a run);
#: each by no more than the level steps of its leaf's encodes that round
OBD_FLIPS = 1e-4


@contextlib.contextmanager
def nnadq_steps():
    """Records each ``NNADQ.quant`` call made inside the block, in call
    order: the level step ``span / (2^bits - 1)`` of each leaf, by key
    (read on the host after the block)."""
    from distributed_learning_simulator_tpu_torch.ops.quantization import NNADQ

    quant, calls = NNADQ.quant, []

    def recording(self, tree, flat=False):
        blob = quant(self, tree, flat=flat)
        calls.append({k: (e["span"], e["bits"]) for k, e in zip(blob["keys"], blob["leaves"])})
        return blob

    NNADQ.quant = recording
    steps = []
    try:
        yield steps
    finally:
        NNADQ.quant = quant
        steps.extend({k: float(span) / ((1 << bits) - 1) for k, (span, bits) in call.items()} for call in calls)


def check_nnadq_encode_on_card(tree: dict, weight: float) -> None:
    """``NNADQ.quant`` of one upload (numpy leaves) on the card and on the
    CPU: every leaf's ``bits``, ``lo``, ``span`` and ``packed`` bit-equal,
    and the decoded values too."""
    import torch

    from distributed_learning_simulator_tpu_torch.ops.quantization import NNADQ

    blobs = {d: NNADQ(weight).quant({k: torch.from_numpy(v).to(d) for k, v in tree.items()}) for d in ("cuda", "cpu")}
    same = lambda a, b: a.cpu().numpy().tobytes() == b.numpy().tobytes()
    for key, g, c in zip(blobs["cpu"]["keys"], blobs["cuda"]["leaves"], blobs["cpu"]["leaves"]):
        check(g["bits"] == c["bits"] and same(g["lo"], c["lo"]) and same(g["span"], c["span"])
              and same(g["packed"], c["packed"]), f"NNADQ encode of {key}: card and CPU blobs differ")
    decoded = {d: NNADQ(weight).dequant(blob) for d, blob in blobs.items()}
    check(all(same(decoded["cuda"][k], decoded["cpu"][k]) for k in tree), "NNADQ decode: card and CPU differ")
    print(f"NNADQ encode and decode of one upload ({len(tree)} leaves, bits"
          f" {sorted({e['bits'] for e in blobs['cpu']['leaves']})}): card and CPU bit-equal")


def _port_init(workdir: str, label: str, make_config) -> str:
    """The port's init of a task (seed 0), as a JAX-keyed npz."""
    import numpy as np

    from distributed_learning_simulator_tpu_torch.models import convert
    from distributed_learning_simulator_tpu_torch.training import build_task

    path = os.path.join(workdir, f"{label}_init.npz")
    ctx = build_task(make_config(os.path.join(workdir, f"{label}_init")), device="cpu")
    np.savez(path, **convert.to_jax(ctx.engine.init_params(0)))
    return path


def _params_apart(a: dict, b: dict, atol: float = 1e-5) -> tuple[float, int]:
    """Max |difference| of two parameter dicts and the elements beyond ``atol``."""
    import numpy as np

    return (max(float(np.abs(a[k] - b[k]).max()) for k in b),
            sum(int((np.abs(a[k] - b[k]) > atol).sum()) for k in b))


def check_threaded_tasks_against_cpu(workdir: str) -> None:
    """The threaded executor's new methods on small f32 DenseNet-40 tasks,
    card against CPU, each run by ``train()`` from one init:

    * fed_obd (NNADQ) at ``second_phase_epoch`` 1 (``conf/fed_obd/cifar10.yaml``
      cut to 2 clients x 16 samples, 1 round of 2 epochs and the tuning
      epoch): the codec itself bit-equal on the card and the CPU
      (:func:`check_nnadq_encode_on_card` on the CPU run's first upload
      delta); the first aggregate's test loss within the phase's 1e-3 and
      its parameters within 1e-3 but for ``OBD_FLIPS`` of them at most,
      each of those by no more than 1e-3 and the sum of its leaf's level
      steps over the round's encodes (ROADMAP R10: NNADQ's deterministic
      rounding takes an element whose level sits on a rounding boundary
      to either level, and a 2-bit delta's level is a third of its span);
      the second's test loss within ``OBD_DRIFT``, the elements apart
      counted;
    * fed_dropout_avg (``check_small_task_against_cpu``, the keep masks
      drawn on the host);
    * sign_SGD (``conf/sign_sgd/cifar10.yaml`` cut to 2 clients, 1 epoch
      of batch 8): the record's test loss within 1e-2 (relative), the
      bound of phase 3's SPMD sign_SGD task through vote flips;
    * fed_paq on the card, the threaded run against the port's own SPMD
      session (``conf/fed_paq/cifar10.yaml`` cut to 2 clients, 2 rounds):
      both draw the same values for a (round, slot), so every round's test
      loss and the final parameters agree within the phase's 1e-3."""
    import numpy as np

    from distributed_learning_simulator_tpu_torch.training import train

    check_small_task_against_cpu(
        workdir, "DenseNet-40 threaded fed_dropout_avg",
        lambda d, **kw: _with(sparse_small_task("fed_dropout_avg/cifar10.yaml")(d, **kw), executor="sequential"),
    )
    make = _cut_task("fed_obd/cifar10.yaml", 2, 32, epoch=2, batch_size=16, executor="sequential", **{
        "algorithm_kwargs.second_phase_epoch": 1, "algorithm_kwargs.random_client_number": 2})
    init = _port_init(workdir, "obd", make)
    runs, steps = {}, {}
    for device in ("cuda", "cpu"):
        config = make(os.path.join(workdir, f"threaded_obd_{device}"), global_model_path=init)
        with nnadq_steps() as steps[device]:
            perf = train(config, device=device)["performance"]
        runs[device] = (perf, [_round_params(config.save_dir, k) for k in (1, 2)])
    (gpu, gpu_params), (cpu, cpu_params) = runs["cuda"], runs["cpu"]
    with np.load(init) as blob:
        start = {k: blob[k] for k in blob.files}
    check_nnadq_encode_on_card({k: cpu_params[0][k] - start[k] for k in start},
                               config.endpoint_kwargs["worker"]["weight"])
    check([gpu[k]["phase"] for k in sorted(gpu)] == ["block_dropout_rounds", "epoch_tune"], f"threaded fed_obd {gpu}")
    apart = [_params_apart(g, c) for g, c in zip(gpu_params, cpu_params)]
    loss = [abs(gpu[k]["test_loss"] - cpu[k]["test_loss"]) for k in (1, 2)]
    print(
        f"small task (DenseNet-40 threaded fed_obd, NNADQ, second_phase_epoch 1) card vs CPU: test loss"
        f" {[round(gpu[k]['test_loss'], 6) for k in (1, 2)]} vs {[round(cpu[k]['test_loss'], 6) for k in (1, 2)]};"
        f" aggregates max |diff| {[f'{a:.3g}' for a, _ in apart]}, elements beyond 1e-5 {[n for _, n in apart]};"
        f" wire MB {[round(gpu[k]['received_mb'], 4) for k in (1, 2)]} vs {[round(cpu[k]['received_mb'], 4) for k in (1, 2)]}"
    )
    flips = _params_apart(gpu_params[0], cpu_params[0], atol=1e-3)[1]
    size = sum(v.size for v in cpu_params[0].values())
    # round 1's encodes: the 2 uploads, then the broadcast (its uploads come after it)
    check(all(len(calls) == 6 for calls in steps.values()), f"NNADQ encodes {[len(c) for c in steps.values()]}")
    cap = {k: max(sum(call.get(k, 0.0) for call in calls[:3]) for calls in steps.values()) for k in cpu_params[0]}
    over = {k: float(np.abs(gpu_params[0][k] - v).max()) for k, v in cpu_params[0].items()
            if np.abs(gpu_params[0][k] - v).max() > 1e-3 + cap[k]}
    print(f"  aggregate 1: {flips} of {size} elements beyond 1e-3 (level flips); beyond their leaves' level steps:"
          f" {over}")
    check(loss[0] <= 1e-3 * abs(cpu[1]["test_loss"]), "threaded fed_obd: aggregate 1's test loss disagrees")
    check(flips <= OBD_FLIPS * size, f"threaded fed_obd: aggregate 1 has {flips} elements beyond 1e-3")
    check(not over, f"threaded fed_obd: aggregate 1 apart by more than a level flip in {over}")
    check(loss[1] <= OBD_DRIFT, f"threaded fed_obd: aggregate 2's test loss {loss[1]} apart")

    make = _cut_task(SIGN_SGD_FILES[0], 2, 32, epoch=1, batch_size=8, executor="sequential")
    perf = {device: train(make(os.path.join(workdir, f"threaded_sign_{device}")), device=device)["performance"][1]
            for device in ("cuda", "cpu")}
    rel = abs(perf["cuda"]["test_loss"] - perf["cpu"]["test_loss"]) / abs(perf["cpu"]["test_loss"])
    print(f"small task (DenseNet-40 threaded sign_SGD, 2 clients) card vs CPU: test loss"
          f" {perf['cuda']['test_loss']:.6f} vs {perf['cpu']['test_loss']:.6f} (rel {rel:.2g})")
    check(rel <= 1e-2, f"threaded sign_SGD: card and CPU records disagree ({rel})")

    make = _cut_task("fed_paq/cifar10.yaml", 2, 32, round=2, epoch=2, batch_size=16,
                     **{"algorithm_kwargs.random_client_number": 2})
    init = _port_init(workdir, "paq", make)
    runs = {}
    for executor in ("spmd", "sequential"):
        config = _with(make(os.path.join(workdir, f"paq_{executor}"), global_model_path=init), executor=executor)
        runs[executor] = (train(config, device="cuda")["performance"], _round_params(config.save_dir, 2))
    (spmd, spmd_params), (threaded, threaded_params) = runs["spmd"], runs["sequential"]
    worst, beyond = _params_apart(threaded_params, spmd_params)
    rel = max(abs(threaded[k]["test_loss"] - spmd[k]["test_loss"]) / abs(spmd[k]["test_loss"]) for k in spmd)
    print(f"small task (DenseNet-40 fed_paq, 2 clients, 2 rounds) on the card, threaded vs SPMD: test loss"
          f" {[round(threaded[k]['test_loss'], 6) for k in sorted(threaded)]} vs"
          f" {[round(spmd[k]['test_loss'], 6) for k in sorted(spmd)]} (rel {rel:.2g}); round 2's parameters max |diff|"
          f" {worst:.3g}, {beyond} elements beyond 1e-5")
    check(sorted(threaded) == sorted(spmd) == [1, 2], f"fed_paq records {sorted(threaded)}")
    check(rel <= 1e-3 and worst <= 1e-3, "fed_paq on the card: the threaded run and the SPMD session disagree")


def _with(config, **fields):
    """``config`` with ``fields`` set."""
    for key, value in fields.items():
        setattr(config, key, value)
    return config


def check_keyed_obd_sq_launches(workdir: str) -> None:
    """``expected_qsgd_launches`` on a threaded fed_obd_sq task at
    ``second_phase_epoch`` 1 with ``flat_payload: false`` (``obd_config``
    cut to ``vit_small``, 2 workers x 16 samples, 1 round and the tuning
    epoch), whose leaves of at least 65,536 values an unkeyed encode would
    send through K2: every upload and broadcast is keyed, so the protocol
    gives 0 and 0, checked exactly with the counters set to 0 just before
    the run and read just after."""
    import numpy as np

    from distributed_learning_simulator_tpu_torch.ops.quantization import KERNEL_MIN_ELEMENTS
    from distributed_learning_simulator_tpu_torch.training import build_task, run_task

    config = obd_config(os.path.join(workdir, "keyed_obd_sq"), **{
        "model_name": "vit_small", "worker_number": 2, "algorithm_kwargs.random_client_number": 2,
        "algorithm_kwargs.second_phase_epoch": 1, "dataset_kwargs.train_size": 32, "dataset_kwargs.val_size": 16,
        "dataset_kwargs.test_size": 64, "batch_size": 16,
    })
    ctx = build_task(config)
    big = sum(t.numel() >= KERNEL_MIN_ELEMENTS for t in ctx.model_ctx.module.state_dict().values())
    _reset_launches()
    perf = run_task(ctx)["performance"]
    launches = _read_launches()
    want = expected_qsgd_launches(ctx)
    print(f"threaded fed_obd_sq (vit_small, second_phase_epoch 1, flat_payload false, {big} leaves of >= 65,536"
          f" values): K2/K3 launches {launches['K2']}/{launches['K3']}, from the protocol {want[0]}/{want[1]};"
          f" test loss {[round(row['test_loss'], 4) for _, row in sorted(perf.items())]}")
    check(big > 0 and want == (0, 0), f"keyed fed_obd_sq: {big} large leaves, protocol {want}")
    check((launches["K2"], launches["K3"]) == want, f"keyed fed_obd_sq K2/K3 {launches['K2']}/{launches['K3']}")
    check(all(np.isfinite(row["test_loss"]) for row in perf.values()), f"keyed fed_obd_sq records {perf}")


def run_threaded_files(workdir: str, card: str) -> dict:
    """``build_task`` + ``run_task`` (what ``train()`` runs for
    ``executor: sequential``) on each of ``THREADED_FILES`` at full width,
    the launch counters set to 0 just before each run and read just after:
    each record's phase, time, test loss and wire MB, the run's wall time;
    no kernel of the port on these paths (the classifier takes no K4/K5,
    the threaded aggregation no K1, the keyed and NNADQ codecs no K2/K3).
    Returns each file's numbers."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.training import build_task, run_task

    records = {}
    for name in THREADED_FILES:
        overrides = {"executor": "sequential", "round": THREADED_ROUNDS, "epoch": THREADED_EPOCHS}
        if name.startswith("fed_obd"):
            overrides["algorithm_kwargs.second_phase_epoch"] = 1
        config = shipped_config(name, os.path.join(workdir, name.replace("/", "_")[:-5]), **overrides)
        t0 = time.monotonic()
        ctx = build_task(config)
        setup = time.monotonic() - t0
        _reset_launches()
        t0 = time.monotonic()
        out = run_task(ctx)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = _read_launches()
        perf = out["performance"]
        print(f"main path {name} threaded ({config.distributed_algorithm}, {config.model_name}, {config.worker_number}"
              f" workers): setup {setup:.2f} s, run {wall:.2f} s ({card}); launches {launches}")
        for key, row in sorted(perf.items()):
            seconds = f"{row['round_seconds']:.3f} s, " if "round_seconds" in row else ""
            wire = f", received {row['received_mb']:.3f} MB, sent {row['sent_mb']:.3f} MB" if "received_mb" in row else ""
            print(f"  record {key} {row.get('phase', '')}: {seconds}test loss {row['test_loss']:.4f}"
                  f" accuracy {row['test_accuracy']:.4f}{wire}")
            check(np.isfinite(row["test_loss"]) and 0.0 <= row["test_accuracy"] <= 1.0, f"{name} record {row}")
        want = ["block_dropout_rounds", "epoch_tune"] if name.startswith("fed_obd") else [None]
        check([row.get("phase") for _, row in sorted(perf.items())] == want, f"{name} records {perf}")
        others = [kid for kid, n in launches.items() if n]
        check(not others, f"{name}: kernels off this path launched: {others}")
        records[name] = {"setup_s": setup, "run_s": wall,
                         "records": {k: row.get("round_seconds") for k, row in perf.items()}}
        del ctx, out
        torch.cuda.empty_cache()
    return records


def check_shapley_task_against_cpu(workdir: str) -> None:
    """``conf/gtg_sv/cifar10.yaml`` (DenseNet-40, f32, GTG) cut to 3 clients
    x 16 samples and a test set of 64, 1 round of the shipped 5 local
    epochs, from the port's init, by the session's ``run`` on the CPU and
    on the card:

    * the trained rows (``train_stack``) within ``ROW_TOL`` of the row's
      largest value;
    * in lockstep, every subset the CPU evaluated evaluated again on the
      card on the CPU's stack: equal ``correct`` counts and test losses
      within 1e-5 (relative);
    * how many of the card run's subsets match the CPU's counts is printed,
      and where every one does, the same subsets were visited and the SV
      dicts are equal."""
    import torch

    from distributed_learning_simulator_tpu_torch.training import build_session

    runs = {}
    for device in ("cpu", "cuda"):
        session = build_session(_cut_task(SHAPLEY_FILES[0][0], 3, 64)(os.path.join(workdir, f"gtg_{device}")),
                                device=device)
        stacks = []
        train_stack = session.train_stack
        session.train_stack = lambda g, r, fn=train_stack: stacks.append(fn(g, r)) or stacks[-1]
        result = session.run()
        runs[device] = (session, stacks[0], result)
    (cpu, cpu_stack, cpu_result), (card, card_stack, card_result) = runs["cpu"], runs["cuda"]
    card_stack = card_stack.cpu()
    row_rel = max(float((card_stack[c] - cpu_stack[c]).abs().max() / cpu_stack[c].abs().max())
                  for c in range(cpu_stack.shape[0]))
    want, got = cpu.subset_results[1], card.subset_results.pop(1)
    matched = sum(k in got and got[k][1:] == want[k][1:] for k in want)
    same = matched == len(want) == len(got)
    subsets = sorted(want)
    card._metric_many(cpu_stack.cuda(), card._base_weight_row(1), 1)(subsets)
    again = card.subset_results[1]
    lockstep = sum(again[k][1:] == want[k][1:] for k in subsets)
    loss_rel = max(abs(again[k][0] - want[k][0]) / abs(want[k][0]) for k in subsets)
    print(
        f"small task (DenseNet-40 GTG, 3 clients, 1 round) card vs CPU: trained rows rel {row_rel:.3g} (ROW_TOL"
        f" {ROW_TOL}); in lockstep (the CPU's stack) {lockstep} of {len(subsets)} subsets with equal correct"
        f" counts, test loss rel {loss_rel:.3g}; by run(): {len(got)} vs {len(want)} subsets evaluated, {matched}"
        f" with equal counts; sv {card_result['sv'][1]} vs {cpu_result['sv'][1]}"
    )
    check(row_rel <= ROW_TOL, f"small task (DenseNet-40 GTG): trained rows {row_rel} apart")
    check(lockstep == len(subsets) and loss_rel <= 1e-5, "small task (DenseNet-40 GTG): subset metrics disagree")
    check(not same or (card_result["sv"] == cpu_result["sv"] and card_result["sv_S"] == cpu_result["sv_S"]),
          "small task (DenseNet-40 GTG): equal subset counts but other Shapley values")
    del runs, cpu, card
    torch.cuda.empty_cache()


def run_sign_sgd_files(workdir: str) -> tuple[dict[str, int], dict]:
    """``train()`` on each of ``SIGN_SGD_FILES`` at full width, as shipped
    but for ``SIGN_SGD_EPOCHS`` local epochs, the launch counters set to 0
    just before each and read just after: the round's time and its time a
    step (eval included), the peak memory, the train curves, and K1's
    launches checked exactly (one a step: ``round x epoch x n_batches``);
    no other kernel.  Returns the launches of all runs and the records."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.training import build_session, train

    total, records = {}, {}
    for name in SIGN_SGD_FILES:
        config = shipped_config(name, os.path.join(workdir, name.replace("/", "_")[:-5]), epoch=SIGN_SGD_EPOCHS)
        n_batches = build_session(config).n_batches  # the steps an epoch, from the staged data
        torch.cuda.empty_cache()
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        perf = train(config)["performance"]
        wall = time.monotonic() - t0
        launches = _read_launches()
        for kid, n in launches.items():
            total[kid] = total.get(kid, 0) + n
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        steps = config.round * config.epoch * n_batches
        print(
            f"main path {name} ({config.distributed_algorithm}, {config.model_name}, {config.worker_number} workers,"
            f" {config.epoch} epochs of {n_batches} steps): {config.round} round in {wall:.2f} s (setup included);"
            f" peak memory {peak:.2f} GiB over the {held / 2**30:.2f} GiB held before it; launches {launches}"
        )
        for key, row in sorted(perf.items()):
            print(
                f"  round {key}: {row['round_seconds']:.3f} s, {row['round_seconds'] / (config.epoch * n_batches) * 1e3:.1f}"
                f" ms a step (eval included); test loss {row['test_loss']:.4f} accuracy {row['test_accuracy']:.4f};"
                f" train loss per epoch {[round(v, 4) for v in row['train_loss_per_epoch']]}, accuracy"
                f" {[round(v, 4) for v in row['train_accuracy_per_epoch']]}"
            )
            check(np.isfinite(row["test_loss"]) and 0.0 <= row["test_accuracy"] <= 1.0, f"{name} record {row}")
            check(len(row["train_loss_per_epoch"]) == config.epoch, f"{name} train curve {row}")
        check(sorted(perf) == list(range(1, config.round + 1)), f"{name} records {sorted(perf)}")
        check(launches["K1"] == steps, f"{name} K1 launches {launches['K1']}, want {steps}")
        others = [kid for kid, n in launches.items() if n and kid != "K1"]
        check(not others, f"{name}: kernels off this path launched: {others}")
        check(os.path.isfile(os.path.join(config.save_dir, "server", "best_global_model.npz")), f"{name}: no best model")
        records[name] = {"wall_s": wall, "peak_gib": peak, "records": perf}
    return total, records


def run_shapley_files(workdir: str) -> tuple[dict[str, int], dict]:
    """``train()`` on each of ``SHAPLEY_FILES`` at full width, as shipped but
    for the rounds named there, 1 local epoch and the test splits of
    ``SHAPLEY_TEST_SPLITS`` (the engines' own settings as shipped), the
    launch counters set to 0 just before each and read just after: each
    round's subsets evaluated, the seconds they took and the round's
    seconds, the peak memory, the SV dicts over every worker each round,
    both JSON records written, and K1's launches checked
    exactly (once a subset and once a round's aggregate); no other kernel.
    Returns the launches of all runs and the records."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.training import train

    total, records = {}, {}
    for name, rounds in SHAPLEY_FILES:
        config = shipped_config(name, os.path.join(workdir, name.replace("/", "_")[:-5]), round=rounds, epoch=1,
                                **shapley_test_split(name))
        torch.cuda.empty_cache()
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        result = train(config)
        wall = time.monotonic() - t0
        launches = _read_launches()
        for kid, n in launches.items():
            total[kid] = total.get(kid, 0) + n
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        perf = result["performance"]
        print(
            f"main path {name} ({config.distributed_algorithm}, {config.model_name}, {config.worker_number} workers,"
            f" {config.epoch} epoch, sv_kwargs {config.algorithm_kwargs.get('sv_kwargs', {})}): {config.round} rounds"
            f" in {wall:.2f} s (setup included); peak memory {peak:.2f} GiB over the {held / 2**30:.2f} GiB held"
            f" before it; launches {launches}"
        )
        for key, row in sorted(perf.items()):
            print(
                f"  round {key}: {row['subsets']} subsets evaluated in {row['subset_seconds']:.3f} s, round"
                f" {row['round_seconds']:.3f} s; test loss {row['test_loss']:.4f} accuracy {row['test_accuracy']:.4f};"
                f" sv {({w: round(v, 5) for w, v in result['sv'][key].items()})}"
            )
            check(np.isfinite(row["test_loss"]) and 0.0 <= row["test_accuracy"] <= 1.0, f"{name} record {row}")
            check(sorted(result["sv"][key]) == list(range(config.worker_number)), f"{name} round {key} sv {result['sv']}")
        check(sorted(perf) == list(range(1, config.round + 1)), f"{name} records {sorted(perf)}")
        k1 = sum(row["subsets"] + 1 for row in perf.values())
        check(launches["K1"] == k1, f"{name} K1 launches {launches['K1']}, want {k1}")
        others = [kid for kid, n in launches.items() if n and kid != "K1"]
        check(not others, f"{name}: kernels off this path launched: {others}")
        for record in ("shapley_values.json", "shapley_values_S.json"):
            check(os.path.isfile(os.path.join(config.save_dir, record)), f"{name}: no {record}")
        check(not torch.backends.cudnn.allow_tf32, f"{name}: f32 convolutions ran in TF32")
        records[name] = {"wall_s": wall, "peak_gib": peak, "records": perf}
    return total, records


# ------------------------------------------------------------ graph FL slice
#: the shipped graph files (phase 4h), as shipped but for ``GNN_ROUNDS``
#: (two: fed_aas's between-round resample and the best-model write run);
#: the ninth, ``conf/fed_aas/yelp.yaml``, names a dataset neither package
#: registers and must raise the JAX package's KeyError
GNN_FILES = (
    "fed_gnn/cs.yaml",
    "fed_gnn/yelp.yaml",
    "fed_gnn/amazonproduct.yaml",
    "fed_gcn/cs.yaml",
    "fed_aas/cora.yaml",
    "fed_aas/PubMed.yaml",
    "fed_aas/dblp.yaml",
    "fed_aas/reddit.yaml",
)
GNN_ROUNDS = 2
#: the phase-3 fed_gnn task, card against CPU: every round's parameters
#: (relative to each leaf's largest) and test loss (relative); f32 on both,
#: the scatter-adds summed in other orders (atomics on the card)
GNN_TOL = 1e-4


def gnn_small_task(save_dir: str):
    """``conf/fed_gnn/cs.yaml`` cut to 4 workers and a 512-node graph, 2
    rounds of 1 epoch, with ``batch_number``, ``num_neighbor``,
    ``edge_drop_rate`` and ``share_feature`` as shipped and every draw
    (minibatches, fan-in priorities, dropout) made on the host."""
    config = shipped_config(GNN_FILES[0], save_dir, round=2, worker_number=4, **{"dataset_kwargs.num_nodes_": 512})
    config.endpoint_kwargs.setdefault("worker", {})["random"] = host_draws()
    return config


def check_gnn_task_against_cpu(workdir: str) -> None:
    """:func:`gnn_small_task` by ``train()`` on the card and on the CPU
    (K1's plain version), from the port's own init (drawn on the CPU):
    every round's ``aggregated_model/round_N.npz`` and test loss within
    ``GNN_TOL``, ``received_mb`` equal."""
    import numpy as np

    from distributed_learning_simulator_tpu_torch.training import train

    results = {}
    for device in ("cuda", "cpu"):
        config = gnn_small_task(os.path.join(workdir, f"gnn_{device}"))
        perf = train(config, device=device)["performance"]
        results[device] = (perf, {r: _round_params(config.save_dir, r) for r in perf})
    (gpu_perf, gpu_params), (cpu_perf, cpu_params) = results["cuda"], results["cpu"]
    check(sorted(gpu_perf) == sorted(cpu_perf) == [1, 2], f"fed_gnn task records {sorted(gpu_perf)}")
    params = max(
        float(np.abs(gpu_params[r][k] - want).max() / np.abs(want).max())
        for r in cpu_params for k, want in cpu_params[r].items()
    )
    loss = max(abs(gpu_perf[r]["test_loss"] - cpu_perf[r]["test_loss"]) / abs(cpu_perf[r]["test_loss"])
               for r in cpu_perf)
    mb = [(gpu_perf[r]["received_mb"], cpu_perf[r]["received_mb"]) for r in cpu_perf]
    print(
        f"small task (fed_gnn Coauthor_CS, 4 workers, 512 nodes) card vs CPU: test loss"
        f" {[round(gpu_perf[r]['test_loss'], 6) for r in (1, 2)]} vs"
        f" {[round(cpu_perf[r]['test_loss'], 6) for r in (1, 2)]} (rel {loss:.3g}), parameters {params:.3g} apart"
        f" (relative, every round), received_mb {mb}"
    )
    check(all(a == b > 0 for a, b in mb), f"fed_gnn task received_mb {mb}")
    check(params <= GNN_TOL and loss <= GNN_TOL, "fed_gnn task: card and CPU disagree")


def run_gnn_files(workdir: str) -> tuple[dict[str, int], dict]:
    """``train()`` on each of ``GNN_FILES`` at full width, as shipped but for
    ``GNN_ROUNDS``, the launch counters set to 0 just before each and read
    just after: each round's time and its time a step (eval included), the
    peak memory, ``received_mb``, the test accuracy, every round's npz
    written, and K1's launches checked exactly (once a round); no other
    kernel.  Then ``conf/fed_aas/yelp.yaml`` must raise the JAX package's
    KeyError.  Returns the launches of all runs and the records."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.training import train

    total, records = {}, {}
    for name in GNN_FILES:
        config = shipped_config(name, os.path.join(workdir, name.replace("/", "_")[:-5]), round=GNN_ROUNDS)
        steps = config.epoch * int(config.algorithm_kwargs.get("batch_number") or 1)
        torch.cuda.empty_cache()
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        perf = train(config)["performance"]
        wall = time.monotonic() - t0
        launches = _read_launches()
        for kid, n in launches.items():
            total[kid] = total.get(kid, 0) + n
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        print(
            f"main path {name} ({config.distributed_algorithm}, {config.dataset_name}, {config.model_name},"
            f" {config.worker_number} workers, {config.epoch} epochs of {steps // config.epoch} lockstep steps):"
            f" {config.round} rounds in {wall:.2f} s (setup included); peak memory {peak:.2f} GiB over the"
            f" {held / 2**30:.2f} GiB held before it; launches {launches}"
        )
        for key, row in sorted(perf.items()):
            print(
                f"  round {key}: {row['round_seconds']:.3f} s, {row['round_seconds'] / steps * 1e3:.1f} ms a step"
                f" (eval included); received_mb {row['received_mb']}; test loss {row['test_loss']:.4f}"
                f" accuracy {row['test_accuracy']:.4f}"
            )
            check(np.isfinite(row["test_loss"]) and 0.0 <= row["test_accuracy"] <= 1.0, f"{name} record {row}")
            check((row["received_mb"] > 0) == (config.distributed_algorithm != "fed_aas"), f"{name} record {row}")
            npz = os.path.join(config.save_dir, "aggregated_model", f"round_{key}.npz")
            check(os.path.isfile(npz), f"{name}: no {npz}")
        check(sorted(perf) == list(range(1, config.round + 1)), f"{name} records {sorted(perf)}")
        check(launches["K1"] == config.round, f"{name} K1 launches {launches['K1']}, want {config.round}")
        others = [kid for kid, n in launches.items() if n and kid != "K1"]
        check(not others, f"{name}: kernels off this path launched: {others}")
        records[name] = {"wall_s": wall, "peak_gib": peak, "records": perf}
    config = shipped_config("fed_aas/yelp.yaml", os.path.join(workdir, "fed_aas_yelp"))
    try:
        train(config)
    except KeyError as error:
        check("unknown dataset 'Yelp'" in str(error), f"fed_aas/yelp.yaml raised {error!r}")
        print(f"conf/fed_aas/yelp.yaml raises the JAX package's KeyError: {str(error)[:60]}...")
    else:
        check(False, "fed_aas/yelp.yaml trained: 'Yelp' is not a registered dataset")
    return total, records


def profile_gnn_round(workdir: str, records: dict) -> None:
    """Where a ``fed_gnn/cs.yaml`` round's time goes (50 slots, 10 lockstep
    steps with the exchange and the fan-in cap, K1), under
    ``torch.profiler``, in a fresh session."""
    from distributed_learning_simulator_tpu_torch.training import build_session

    session = build_session(shipped_config(GNN_FILES[0], os.path.join(workdir, "gnn_profile"), round=1))
    g = session.engine.layout.flatten(session.engine.init_params(session.config.seed)).cuda()
    session.run_round(g, 1)  # warm: the caching allocator's first round
    alone = records[GNN_FILES[0]]["records"][GNN_ROUNDS]["round_seconds"]
    _profiled(lambda: session.run_round(g, 1), " (fed_gnn Coauthor_CS: 50 slots x 10 lockstep steps, K1)",
              f"round {GNN_ROUNDS} of 4h took {alone:.3f} s with its eval and npz", "one training round",
              host_ops=10)


# ------------------------------- the threaded Shapley values and graph FL
#: phase 4k: the shipped files under ``executor: sequential`` at full
#: width, as shipped but for 1 round of ``THREADED_EPOCHS`` local epoch
THREADED_SV_FILES = ("gtg_sv/mnist.yaml", "hierarchical_sv/mnist.yaml", "multiround_sv/cifar10.yaml")
THREADED_GNN_FILES = ("fed_gnn/cs.yaml", "fed_gcn/cs.yaml", "fed_aas/cora.yaml")


@contextlib.contextmanager
def captured_sv_stacks():
    """Each round's stack of uploads (a clone) and dataset sizes as the
    threaded Shapley server holds them at its aggregate."""
    from distributed_learning_simulator_tpu_torch.method.shapley_value import shapley_value_algorithm as sva

    stacks = []
    aggregate = sva.ShapleyValueAlgorithm.aggregate_worker_data

    def recorded(self):
        stacks.append((self.stack.clone(), self.stack_sizes.copy()))
        return aggregate(self)

    sva.ShapleyValueAlgorithm.aggregate_worker_data = recorded
    try:
        yield stacks
    finally:
        sva.ShapleyValueAlgorithm.aggregate_worker_data = aggregate


@contextlib.contextmanager
def graph_dropout_off():
    """TwoGCN's and ThreeGCN's dropout at 0 (a card's generator draws
    other bits than the CPU's)."""
    from distributed_learning_simulator_tpu_torch.models import graph

    saved = {name: getattr(graph, name) for name in ("TwoGCN", "ThreeGCN")}
    for name, cls in saved.items():
        def init(self, *args, _base=cls, **kwargs):
            _base.__init__(self, *args, **kwargs)
            self.dropout_rate = 0.0

        setattr(graph, name, type(name, (cls,), {"__init__": init}))
    try:
        yield
    finally:
        for name, cls in saved.items():
            setattr(graph, name, cls)


def check_threaded_shapley_task_against_cpu(workdir: str) -> None:
    """``conf/gtg_sv/mnist.yaml`` (LeNet5, f32, GTG) under ``executor:
    sequential`` cut to 3 clients x 64 samples and a test set of 64 at the
    CPU tests' batch 16 and learning rate 0.05 (so that the first round
    moves the accuracy and GTG does not truncate), 1 round, from the port's
    init, by ``build_task`` + ``run_task`` on the CPU and on the card (the
    launch counters set to 0 just before the card's run and read just
    after):

    * every upload (the server's stack) within ``ROW_TOL`` of its row's
      largest value;
    * in lockstep, every subset the CPU evaluated evaluated again on the
      card on the CPU's stack: equal ``correct`` counts and test losses
      within 1e-5 (relative);
    * where the card run's subsets all match the CPU's counts, the same
      subsets were visited and the SV dicts are equal;
    * K1 exactly once a subset and once for the aggregate; no other kernel."""
    import torch

    from distributed_learning_simulator_tpu_torch.training import build_task, run_task

    def make(save_dir: str, **algorithm_kwargs):
        fields = {"executor": "sequential", "round": 1, "worker_number": 3, "batch_size": 16, "learning_rate": 0.05,
                  "dataset_kwargs.train_size": 192, "dataset_kwargs.val_size": 32, "dataset_kwargs.test_size": 64}
        fields.update({f"algorithm_kwargs.{k}": v for k, v in algorithm_kwargs.items()})
        return shipped_config(THREADED_SV_FILES[0], save_dir, **fields)

    init = _port_init(workdir, "tgtg", make)
    runs = {}
    for device in ("cpu", "cuda"):
        ctx = build_task(make(os.path.join(workdir, f"tgtg_{device}"), global_model_path=init), device=device)
        with captured_sv_stacks() as stacks:
            _reset_launches()
            result = run_task(ctx)
            launches = _read_launches()
        runs[device] = (ctx.server.algorithm, stacks[0], result, launches)
    (cpu, (cpu_stack, sizes), cpu_result, _), (card, (card_stack, _), card_result, launches) = runs["cpu"], runs["cuda"]
    row_rel = max(float((card_stack[c].cpu() - cpu_stack[c]).abs().max() / cpu_stack[c].abs().max())
                  for c in range(cpu_stack.shape[0]))
    want, got = cpu.subsets.results[1], card.subsets.results[1]
    matched = sum(k in got and got[k][1:] == want[k][1:] for k in want)
    same = matched == len(want) == len(got)
    subsets = sorted(want)
    card.subsets.metric_many(cpu_stack.cuda(), sizes, 0)(subsets)  # key 0: no round 0 evaluates subsets
    again = card.subsets.results[0]
    lockstep = sum(again[k][1:] == want[k][1:] for k in subsets)
    loss_rel = max(abs(again[k][0] - want[k][0]) / abs(want[k][0]) for k in subsets)
    print(
        f"small task (LeNet5 threaded GTG, 3 clients x 64 samples, 1 round) card vs CPU: uploads rel {row_rel:.3g} (ROW_TOL"
        f" {ROW_TOL}); in lockstep (the CPU's stack) {lockstep} of {len(subsets)} subsets with equal correct"
        f" counts, test loss rel {loss_rel:.3g}; by run_task(): {len(got)} vs {len(want)} subsets evaluated,"
        f" {matched} with equal counts; sv {card_result['sv'][1]} vs {cpu_result['sv'][1]}; launches {launches}"
    )
    check(launches["K1"] == card.subsets.round_subsets[1] + 1,
          f"threaded GTG task: K1 {launches['K1']}, want {card.subsets.round_subsets[1] + 1}")
    check(not [kid for kid, n in launches.items() if n and kid != "K1"], f"threaded GTG task launches {launches}")
    check(row_rel <= ROW_TOL, f"threaded GTG task: uploads {row_rel} apart")
    check(lockstep == len(subsets) and loss_rel <= 1e-5, "threaded GTG task: subset metrics disagree")
    check(not same or (card_result["sv"] == cpu_result["sv"] and card_result["sv_S"] == cpu_result["sv_S"]),
          "threaded GTG task: equal subset counts but other Shapley values")
    del runs, cpu, card
    torch.cuda.empty_cache()


def _graph_worker_stats(save_dir: str) -> dict:
    """Every worker's ``graph_worker_stat.json`` of a run, by worker."""
    stats = {}
    for name in sorted(os.listdir(save_dir)):
        path = os.path.join(save_dir, name, "graph_worker_stat.json")
        if name.startswith("worker_") and os.path.isfile(path):
            with open(path, encoding="utf8") as f:
                stats[name] = json.load(f)
    return stats


def check_threaded_gnn_task_against_cpu(workdir: str) -> None:
    """``conf/fed_gnn/cs.yaml`` under ``executor: sequential`` cut to 4
    workers and a 512-node graph, 2 rounds, ``share_feature`` with
    ``batch_number`` 2 and ``num_neighbor`` 4 (the data loader's numpy
    draws, the same on both), the models' dropout 0, from the port's init,
    by ``train()`` on the card and on the CPU: every round's test loss and
    ``aggregated_model/round_N.npz`` within ``GNN_TOL`` (relative), the
    wire MB equal, every ``graph_worker_stat.json`` equal field for field,
    and no kernel launched on the card."""
    import numpy as np

    from distributed_learning_simulator_tpu_torch.training import train

    def make(save_dir: str, **algorithm_kwargs):
        fields = {"executor": "sequential", "round": 2, "worker_number": 4, "dataset_kwargs.num_nodes_": 512,
                  "algorithm_kwargs.batch_number": 2, "algorithm_kwargs.num_neighbor": 4}
        fields.update({f"algorithm_kwargs.{k}": v for k, v in algorithm_kwargs.items()})
        return shipped_config(THREADED_GNN_FILES[0], save_dir, **fields)

    results = {}
    with graph_dropout_off():
        init = _port_init(workdir, "tgnn", make)
        for device in ("cuda", "cpu"):
            config = make(os.path.join(workdir, f"tgnn_{device}"), global_model_path=init)
            _reset_launches()
            perf = train(config, device=device)["performance"]
            launches = _read_launches()
            results[device] = (perf, {r: _round_params(config.save_dir, r) for r in perf},
                               _graph_worker_stats(config.save_dir), launches)
    (gpu_perf, gpu_params, gpu_stats, launches), (cpu_perf, cpu_params, cpu_stats, _) = results["cuda"], results["cpu"]
    check(sorted(gpu_perf) == sorted(cpu_perf) == [1, 2], f"threaded fed_gnn task records {sorted(gpu_perf)}")
    params = max(
        float(np.abs(gpu_params[r][k] - want).max() / np.abs(want).max())
        for r in cpu_params for k, want in cpu_params[r].items()
    )
    loss = max(abs(gpu_perf[r]["test_loss"] - cpu_perf[r]["test_loss"]) / abs(cpu_perf[r]["test_loss"])
               for r in cpu_perf)
    wire = [((gpu_perf[r]["received_mb"], gpu_perf[r]["sent_mb"]), (cpu_perf[r]["received_mb"], cpu_perf[r]["sent_mb"]))
            for r in cpu_perf]
    print(
        f"small task (threaded fed_gnn Coauthor_CS, 4 workers, 512 nodes, 2 batches, fan-in 4) card vs CPU: test"
        f" loss {[round(gpu_perf[r]['test_loss'], 6) for r in (1, 2)]} vs"
        f" {[round(cpu_perf[r]['test_loss'], 6) for r in (1, 2)]} (rel {loss:.3g}), parameters {params:.3g} apart"
        f" (relative, every round), wire MB {wire}; worker stats equal {gpu_stats == cpu_stats}"
        f" ({sum(s['exchange_count'] for s in gpu_stats.values())} exchanges); launches {launches}"
    )
    check(all(a == b for a, b in wire), f"threaded fed_gnn task wire MB {wire}")
    check(len(gpu_stats) == 4 and gpu_stats == cpu_stats, f"threaded fed_gnn task stats {gpu_stats} vs {cpu_stats}")
    check(all(s["exchange_count"] == 2 * 2 for s in gpu_stats.values()), f"threaded fed_gnn exchanges {gpu_stats}")
    check(params <= GNN_TOL and loss <= GNN_TOL, "threaded fed_gnn task: card and CPU disagree")
    check(not any(launches.values()), f"threaded fed_gnn task launched {launches}")


def run_threaded_sv_gnn_files(workdir: str, card: str) -> tuple[dict[str, int], dict]:
    """``build_task`` + ``run_task`` on each of ``THREADED_SV_FILES`` and
    ``THREADED_GNN_FILES`` at full width, as shipped but for 1 round of
    ``THREADED_EPOCHS`` local epoch (and ``SHAPLEY_TEST_SPLITS``), the
    launch counters set to 0 just before each run and read just after: the
    round's seconds and, for the Shapley files, its subsets and their seconds (K1 exactly ``subsets +
    1``, the SV dict over every worker, ``shapley_values.json`` written),
    for the graph files the exchanges and the MB each worker communicated
    (``graph_worker_stat.json``; fed_gnn and fed_gcn ``batch_number``
    exchanges a worker, fed_aas none; K1 none).  No other kernel.  Returns
    the launches of all runs and each file's numbers."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.training import build_task, run_task

    total, records = {}, {}
    for name in THREADED_SV_FILES + THREADED_GNN_FILES:
        config = shipped_config(name, os.path.join(workdir, name.replace("/", "_")[:-5]), executor="sequential",
                                round=1, epoch=THREADED_EPOCHS, **shapley_test_split(name))
        t0 = time.monotonic()
        ctx = build_task(config)
        setup = time.monotonic() - t0
        _reset_launches()
        t0 = time.monotonic()
        out = run_task(ctx)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = _read_launches()
        for kid, n in launches.items():
            total[kid] = total.get(kid, 0) + n
        row = out["performance"][1]
        print(f"main path {name} threaded ({config.distributed_algorithm}, {config.model_name},"
              f" {config.worker_number} workers): setup {setup:.2f} s, run {wall:.2f} s ({card}); launches {launches}")
        check(np.isfinite(row["test_loss"]) and 0.0 <= row["test_accuracy"] <= 1.0, f"{name} record {row}")
        check(os.path.isfile(os.path.join(config.save_dir, "server", "round_record.json")), f"{name}: no record")
        numbers = {"setup_s": setup, "run_s": wall, "round_s": row["round_seconds"]}
        if name in THREADED_SV_FILES:
            sv = out["sv"][1]
            print(f"  round 1: {row['round_seconds']:.3f} s, {row['subsets']} subsets evaluated in"
                  f" {row['subset_seconds']:.3f} s; test loss {row['test_loss']:.4f} accuracy"
                  f" {row['test_accuracy']:.4f}; round 0 accuracy {out['performance'][0]['test_accuracy']:.4f};"
                  f" sv {({w: round(v, 5) for w, v in sv.items()})}")
            check(sorted(out["performance"]) == [0, 1], f"{name} records {sorted(out['performance'])}")
            check(sorted(sv) == list(range(config.worker_number)), f"{name} sv {sv}")
            check(launches["K1"] == row["subsets"] + 1, f"{name} K1 launches {launches['K1']}, want {row['subsets'] + 1}")
            check(os.path.isfile(os.path.join(config.save_dir, "shapley_values.json")), f"{name}: no shapley_values.json")
            numbers.update(subsets=row["subsets"], subset_s=row["subset_seconds"])
        else:
            stats = _graph_worker_stats(config.save_dir)
            exchanges = sum(s["exchange_count"] for s in stats.values())
            mb = sum(s["communicated_bytes"] for s in stats.values()) / 1e6
            want = 0 if config.distributed_algorithm == "fed_aas" else int(config.algorithm_kwargs["batch_number"])
            print(f"  round 1: {row['round_seconds']:.3f} s; {exchanges} exchanges ({want} a worker),"
                  f" {mb:.3f} MB communicated by the workers; received {row['received_mb']:.3f} MB, sent"
                  f" {row['sent_mb']:.3f} MB; test loss {row['test_loss']:.4f} accuracy {row['test_accuracy']:.4f}")
            check(sorted(out["performance"]) == [1], f"{name} records {sorted(out['performance'])}")
            check(len(stats) == config.worker_number and all(s["exchange_count"] == want for s in stats.values()),
                  f"{name} exchanges {stats}")
            check(launches["K1"] == 0, f"{name} K1 launches {launches['K1']}, want 0")
            numbers.update(exchanges=exchanges, communicated_mb=mb)
        others = [kid for kid, n in launches.items() if n and kid != "K1"]
        check(not others, f"{name}: kernels off this path launched: {others}")
        records[name] = numbers
        del ctx, out
        torch.cuda.empty_cache()
    return total, records


# ------------------------------------------------- BERT and the round machinery
BERT_FILE = "large_scale/fed_avg/bert_agnews.yaml"
BERT_ROUNDS = 2
#: ``client_chunk: auto`` misses the calibration (no entry has the port's
#: key) and runs the session's default chunk
BERT_CHUNK = 8
BUFFERED_FILE = "fed_avg/mnist_buffered.yaml"
#: the rounds its main path runs (20 as shipped; cut for the script's time)
BUFFERED_ROUNDS = 10
#: the phase-3 BERT task's model: d_model 128, 2 heads (Dh 64), 2 layers,
#: MLP 256 (registered by :func:`bert_task_config` under this name)
BERT_TASK_MODEL = "bert_d128_task"
BERT_TASK_WIDTHS = dict(d_model=128, num_layers=2, num_heads=2, mlp_dim=256)


def bert_task_config(save_dir: str, **algorithm_kwargs):
    """A small f32 BERT FedAvg task: AGNews at S = 32 (a 1000-token
    vocabulary), :data:`BERT_TASK_WIDTHS`, ``dropout_rate`` 0 (so training
    runs K4 and K5), 2 clients x 32 samples, batch 16, 2 rounds."""
    from distributed_learning_simulator_tpu_torch.config import DistributedTrainingConfig
    from distributed_learning_simulator_tpu_torch.models.bert import _make_bert
    from distributed_learning_simulator_tpu_torch.models.registry import global_model_factory, register_model

    if BERT_TASK_MODEL not in global_model_factory:
        @register_model(BERT_TASK_MODEL)
        def _task_model(dataset_collection, device, max_len: int = 0, dropout_rate: float = 0.1, **kwargs):
            return _make_bert(dataset_collection, device, name=BERT_TASK_MODEL, max_len=max_len,
                              dropout_rate=dropout_rate, **BERT_TASK_WIDTHS)

    return DistributedTrainingConfig(
        dataset_name="AGNews",
        model_name=BERT_TASK_MODEL,
        distributed_algorithm="fed_avg",
        worker_number=2,
        batch_size=16,
        round=2,
        epoch=1,
        learning_rate=0.05,
        dataset_kwargs={"max_len": 32, "vocab_size": 1000, "train_size": 64, "val_size": 16, "test_size": 32},
        model_kwargs={"dropout_rate": 0.0},
        algorithm_kwargs=algorithm_kwargs,
        save_dir=save_dir,
        log_file=os.path.join(save_dir, "train.log"),
    )


def buffered_task_config(save_dir: str, **algorithm_kwargs):
    """``conf/fed_avg/mnist_buffered.yaml`` (LeNet5, 10 workers, 8 selected,
    ``buffer_size`` 6, stragglers at rate 0.2) cut to 4 rounds and 16
    samples a worker, with one corrupt client (the first worker selected
    in round 2) and ``update_guard`` on."""
    from distributed_learning_simulator_tpu_torch.utils.selection import select_workers

    corrupt = min(select_workers(0, 2, 10, 8))
    overrides = {"round": 4, "dataset_kwargs.train_size": 160, "dataset_kwargs.val_size": 16,
                 "dataset_kwargs.test_size": 32, "fault_tolerance.corrupt_schedule": f"{{2: [{corrupt}]}}",
                 "fault_tolerance.update_guard": True}
    overrides.update({f"algorithm_kwargs.{k}": v for k, v in algorithm_kwargs.items()})
    return shipped_config(BUFFERED_FILE, save_dir, **overrides)


def expected_k1_a_round(session) -> int:
    """K1 launches a FedAvg round makes: one a chunk, times the buckets of
    the buffered replay (``depth + 1``; 1 when it is synchronous)."""
    buckets = session._buffered_depth + 1 if session._buffered_active else 1
    return session.n_slots // session.chunk_size() * buckets


@contextlib.contextmanager
def k1_by_round(counts: list):
    """Appends the K1 launches of every ``SpmdFedAvgSession.run_round`` call
    made inside the block to ``counts`` (the counter read around the call)."""
    from distributed_learning_simulator_tpu_torch.ops import weighted_accum as wa
    from distributed_learning_simulator_tpu_torch.parallel.spmd import SpmdFedAvgSession

    run_round = SpmdFedAvgSession.run_round

    def counted(self, *args, **kwargs):
        before = wa.launches
        out = run_round(self, *args, **kwargs)
        counts.append(wa.launches - before)
        return out

    SpmdFedAvgSession.run_round = counted
    try:
        yield counts
    finally:
        SpmdFedAvgSession.run_round = run_round


@contextlib.contextmanager
def profiled_round(which: int, label: str):
    """Runs the ``which``-th ``SpmdFedAvgSession.run_round`` call made inside
    the block under ``torch.profiler`` (:func:`_profiled`), beside the
    unprofiled time of the call before it; appends the busy share to the
    list it yields."""
    from distributed_learning_simulator_tpu_torch.parallel.spmd import SpmdFedAvgSession

    run_round, calls, busy = SpmdFedAvgSession.run_round, [], []

    def maybe_profiled(self, *args, **kwargs):
        calls.append(time.monotonic())
        if len(calls) != which:
            out = run_round(self, *args, **kwargs)
            calls[-1] = time.monotonic() - calls[-1]
            return out
        out = []
        alone = f"the training of round {which - 1} took {calls[-2]:.3f} s unprofiled"
        busy.append(_profiled(lambda: out.append(run_round(self, *args, **kwargs)), label, alone,
                              f"round {which}'s training", host_ops=10))
        return out[0]

    SpmdFedAvgSession.run_round = maybe_profiled
    try:
        yield busy
    finally:
        SpmdFedAvgSession.run_round = run_round


def _by_round(config, device: str):
    """``build_session(config).run()`` on ``device`` with every round's new
    master kept (``run_round``'s result, on the host); returns the records,
    those parameters, the K1 launches of each round and the session."""
    from distributed_learning_simulator_tpu_torch.training import build_session

    session = build_session(config, device=device)
    params = []
    with k1_by_round([]) as k1:
        run_round = session.run_round  # the counted method

        def keep(*args, **kwargs):
            out = run_round(*args, **kwargs)
            params.append(out.detach().cpu().clone())
            return out

        session.run_round = keep
        perf = session.run()["performance"]
    return perf, params, k1, session


def check_rounds_against_cpu(workdir: str, label: str, make_config, columns=()) -> dict[str, int]:
    """A small f32 task from one init (the port's own, seed 0, through the
    bridge), on the card and on the CPU, round by round: every round's
    parameters (max |difference|) and test loss (relative) within the ViT
    task's 1e-3, the record ``columns`` equal, and on the card K1's
    launches exact every round.  Returns the card run's launches."""
    import numpy as np

    from distributed_learning_simulator_tpu_torch.models import convert
    from distributed_learning_simulator_tpu_torch.training import build_session

    init = os.path.join(workdir, f"{label}_init.npz")
    session = build_session(make_config(os.path.join(workdir, f"{label}_init")), device="cpu")
    np.savez(init, **convert.to_jax(session.engine.init_params(0)))
    runs = {}
    for device in ("cuda", "cpu"):
        if device == "cuda":
            _reset_launches()
        runs[device] = _by_round(make_config(os.path.join(workdir, f"{label}_{device}"), global_model_path=init), device)
        if device == "cuda":
            launches = _read_launches()
    (gpu_perf, gpu_params, k1, card), (cpu_perf, cpu_params, _, _) = runs["cuda"], runs["cpu"]
    check(sorted(gpu_perf) == sorted(cpu_perf) == list(range(1, len(cpu_params) + 1)), f"{label} records")
    params = [float((g - c).abs().max()) for g, c in zip(gpu_params, cpu_params)]
    loss = [abs(gpu_perf[r]["test_loss"] - cpu_perf[r]["test_loss"]) / abs(cpu_perf[r]["test_loss"]) for r in cpu_perf]
    print(
        f"small task ({label}) card vs CPU, round by round: test loss"
        f" {[round(gpu_perf[r]['test_loss'], 6) for r in gpu_perf]} vs {[round(cpu_perf[r]['test_loss'], 6) for r in cpu_perf]}"
        f" (rel {max(loss):.2g}), max |param diff| {[f'{p:.3g}' for p in params]}; launches {launches}"
    )
    for r in cpu_perf:
        for key in columns:
            check(gpu_perf[r][key] == cpu_perf[r][key], f"{label} round {r} {key}: {gpu_perf[r][key]} vs {cpu_perf[r][key]}")
        if columns:
            print(f"  round {r}: " + ", ".join(f"{key} {cpu_perf[r][key]}" for key in columns))
    check(k1 == [expected_k1_a_round(card)] * len(cpu_perf), f"{label} K1 by round {k1}")
    check(max(loss) <= 1e-3 and max(params) <= 1e-3, f"small task ({label}): card and CPU disagree")
    return launches


RECOVERY_FILE = "fed_avg/mnist.yaml"
#: the rounds of each ``--checkpoint-cost`` run
COST_ROUNDS = 5
#: the kill of each recovery task and of bert_agnews.yaml: after this round
RECOVERY_KILL, OBD_RECOVERY_KILL, BERT_KILL = 2, 2, 1


@contextlib.contextmanager
def phase_dir(workdir: str):
    """A directory for one phase's output, removed when the phase ends:
    every round of the SPMD sessions writes a checkpoint (404 MB a round
    for ``bert_agnews.yaml``)."""
    import shutil

    path = tempfile.mkdtemp(dir=workdir)
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


def _record_rows(save_dir: str) -> list[str]:
    with open(os.path.join(save_dir, "server", "round_record.json"), encoding="utf8") as f:
        return list(json.load(f))


def recovery_task_config(save_dir: str, **algorithm_kwargs):
    """``conf/fed_avg/mnist.yaml`` (LeNet5, 10 workers, 2 local epochs) cut
    to 4 rounds and 16 samples a worker."""
    overrides = {"round": 4, "dataset_kwargs.train_size": 160, "dataset_kwargs.val_size": 16,
                 "dataset_kwargs.test_size": 64}
    overrides.update({f"algorithm_kwargs.{k}": v for k, v in algorithm_kwargs.items()})
    return shipped_config(RECOVERY_FILE, save_dir, **overrides)


def obd_recovery_config(save_dir: str, **algorithm_kwargs):
    """``conf/fed_obd/cifar10.yaml`` (DenseNet-40, NNADQ) cut to 2 clients x
    16 samples, 1 round and 2 tuning epochs."""
    overrides = {"round": 1, "epoch": 1, "worker_number": 2, "batch_size": 16,
                 "algorithm_kwargs.second_phase_epoch": 2, "dataset_kwargs.train_size": 32,
                 "dataset_kwargs.val_size": 16, "dataset_kwargs.test_size": 32}
    overrides.update({f"algorithm_kwargs.{k}": v for k, v in algorithm_kwargs.items()})
    return shipped_config(SPMD_OBD_RUNS[0][0], save_dir, **overrides)


def _supervised(config, kill: int):
    """``train_with_recovery`` on the card with a kill after round ``kill``
    and no backoff; the launch counters set to 0 just before and read just
    after.  Returns the result and the launches."""
    from distributed_learning_simulator_tpu_torch.training import train_with_recovery

    config.fault_tolerance = {"kill_after_rounds": [kill], "restart_backoff_seconds": 0.0}
    _reset_launches()
    result = train_with_recovery(config)
    return result, _read_launches()


def check_recovery_against_cpu(workdir: str) -> None:
    """Two recovery tasks, each from one init: killed once on the card and
    recovered by ``train_with_recovery`` (attempt 1 resumes from attempt 0's
    checkpoint), against the uninterrupted run on the CPU.

    * FedAvg (:func:`recovery_task_config`), killed after round
      ``RECOVERY_KILL``: every round's parameters (each attempt's
      ``round_N.npz``) within 1e-3 and test loss within 1e-3 (relative) of
      the CPU's, the last attempt's record holding every round once, K1
      exact over both attempts;
    * FedOBD (:func:`obd_recovery_config`), killed after the first tuning
      epoch (aggregate ``OBD_RECOVERY_KILL``), so the resume lands in phase
      2 and restores ``opt_state.npz`` on the card: the same phases, every
      record's test loss within the FedOBD task's whole-run 1e-2 (level
      flips), the optimizer states restored onto the card bit-equal, slot
      by slot, to the states the killed attempt held when it saved them
      (traces and step counts), K1 exact."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.models import convert
    from distributed_learning_simulator_tpu_torch.parallel.spmd_obd import SpmdFedOBDSession
    from distributed_learning_simulator_tpu_torch.training import build_session, train

    for label, make_config, kill in (("LeNet5 fed_avg", recovery_task_config, RECOVERY_KILL),
                                     ("DenseNet-40 fed_obd", obd_recovery_config, OBD_RECOVERY_KILL)):
        name = label.replace(" ", "_")
        init, cpu_dir = os.path.join(workdir, f"{name}_init.npz"), os.path.join(workdir, f"{name}_cpu")
        session = build_session(make_config(os.path.join(workdir, f"{name}_init")), device="cpu")
        np.savez(init, **convert.to_jax(session.engine.init_params(0)))
        want = train(make_config(cpu_dir, global_model_path=init), device="cpu")["performance"]
        restored, held, load, save = [], {}, SpmdFedOBDSession._load_opt_state, SpmdFedOBDSession._save_opt_state

        def save_kept(self, stat_key):
            # the states the killed attempt holds when it saves them (zeros: a fresh state)
            held[stat_key] = [(None, 0) if st is None else (st.trace.detach().cpu().clone(), st.count)
                              for st in self._opt_states]
            save(self, stat_key)

        def load_checked(self, resume_dir, expect_key):
            load(self, resume_dir, expect_key)
            restored.append(sorted({st.trace.device.type for st in self._opt_states if st is not None}))
            check(expect_key in held, f"{label}: no optimizer states were saved with aggregate {expect_key}")
            for slot, (st, (trace, count)) in enumerate(zip(self._opt_states, held[expect_key])):
                same = st is not None and st.count == count and torch.equal(
                    st.trace.cpu(), torch.zeros_like(st.trace.cpu()) if trace is None else trace)
                check(same, f"{label}: slot {slot}'s optimizer state is not the one saved with aggregate {expect_key}")

        SpmdFedOBDSession._load_opt_state, SpmdFedOBDSession._save_opt_state = load_checked, save_kept
        try:
            card_config = make_config(os.path.join(workdir, f"{name}_cuda"), global_model_path=init)
            result, launches = _supervised(card_config, kill)
        finally:
            SpmdFedOBDSession._load_opt_state, SpmdFedOBDSession._save_opt_state = load, save
        got, recovery = result["performance"], result["recovery"]
        first, last = recovery["attempt_dirs"]
        rounds = sorted(want)
        check(recovery["restarts"] == 1 and last == recovery["save_dir"], f"{label} recovery {recovery}")
        check(sorted(got) == rounds and _record_rows(last) == [str(r) for r in rounds], f"{label} records {sorted(got)}")
        check(_record_rows(first) == [str(r) for r in range(1, kill + 1)], f"{label} killed attempt's records")
        loss = [abs(got[r]["test_loss"] - want[r]["test_loss"]) / abs(want[r]["test_loss"]) for r in rounds]
        params = []
        if make_config is recovery_task_config:
            for r in rounds:
                card, cpu = _round_params(first if r <= kill else last, r), _round_params(cpu_dir, r)
                params.append(max(float(np.abs(card[k] - cpu[k]).max()) for k in cpu))
            check(max(loss) <= 1e-3 and max(params) <= 1e-3, f"{label}: recovered card run and CPU run disagree")
        else:
            check([got[r]["phase"] for r in rounds] == [want[r]["phase"] for r in rounds], f"{label} phases")
            check(restored == [["cuda"]], f"{label}: the optimizer states restored {restored}")
            check(max(loss) <= 1e-2, f"{label}: recovered card run and CPU run disagree")
        k1_want = expected_obd_k1(len(rounds), session.n_slots, session.chunk_size())
        check(launches["K1"] == k1_want, f"{label} K1 {launches['K1']}, want {k1_want}")
        print(f"recovery task ({label}, killed after round {kill}, resumed by train_with_recovery) card vs the"
              f" uninterrupted CPU run, round by round: test loss {[round(got[r]['test_loss'], 6) for r in rounds]}"
              f" vs {[round(want[r]['test_loss'], 6) for r in rounds]} (rel {max(loss):.2g}), max |param diff|"
              f" {[f'{p:.3g}' for p in params]}; optimizer states restored on {restored}; launches {launches}")


@contextlib.contextmanager
def bert_recovery_probe(kill: int):
    """Around a ``train_with_recovery`` call: each attempt's setup time
    (``train()`` entered to its first round), the host copy of round
    ``kill``'s new master, each resumed session's starting master (on the
    host) and every session (for its writer's timings)."""
    from distributed_learning_simulator_tpu_torch import training
    from distributed_learning_simulator_tpu_torch.parallel.spmd import SpmdFedAvgSession

    probe = {"setup_s": [], "entered": [], "master": None, "starts": [], "sessions": []}
    train, run_round, start = training.train, SpmdFedAvgSession.run_round, SpmdFedAvgSession._start

    def timed_train(*args, **kwargs):
        probe["entered"].append(time.monotonic())
        return train(*args, **kwargs)

    def kept_round(self, global_vec, weights, round_number=1, delays=None):
        if len(probe["setup_s"]) < len(probe["entered"]):
            probe["setup_s"].append(time.monotonic() - probe["entered"][-1])
        out = run_round(self, global_vec, weights, round_number, delays)
        if round_number == kill:
            probe["master"] = out.detach().cpu().clone()
        return out

    def kept_start(self):
        vec, start_round = start(self)
        probe["sessions"].append(self)
        if start_round > 1:
            probe["starts"].append((start_round, vec.detach().cpu().clone()))
        return vec, start_round

    training.train, SpmdFedAvgSession.run_round, SpmdFedAvgSession._start = timed_train, kept_round, kept_start
    try:
        yield probe
    finally:
        training.train, SpmdFedAvgSession.run_round, SpmdFedAvgSession._start = train, run_round, start


def run_bert_agnews(workdir: str, card: str) -> tuple[dict[str, int], dict]:
    """``train_with_recovery`` on ``large_scale/fed_avg/bert_agnews.yaml`` as
    shipped but for ``BERT_ROUNDS`` (1000 workers, 100 selected,
    ``bert_base``, ``use_amp``, ``client_chunk: auto``) and a kill after
    round ``BERT_KILL``: attempt 0 trains round 1, writes ``round_1.npz``
    (the f32 master) and is killed; attempt 1 resumes and trains round 2.
    The launch counters are set to 0 just before and read just after:

    * ``round_1.npz`` reloads bit-equal to the host copy of round 1's new
      master, and attempt 1 starts from that file bit for bit;
    * the last attempt's record holds rounds 1 and 2 once, and
      ``best_global_model.npz`` exists;
    * ``auto`` misses the calibration and runs :data:`BERT_CHUNK`; K1
      exactly ``worker_number / chunk`` a round over both attempts; every K4
      launch on the wgmma forward, one a layer per test batch per
      evaluation pass (the test metrics and, with
      ``use_slow_performance_metrics``, the confusion matrix); no K5
      (training runs dropout 0.1: the dense path);
    * printed: each round's time, test loss and accuracy, the peak memory,
      each attempt's setup time, and for each checkpoint the seconds the
      round loop was blocked queueing it and the seconds the writer took.

    Round 2's training runs under ``torch.profiler`` (:func:`profiled_round`;
    its record's time includes the profiler's cost).  Telemetry is on
    (no window of its own): both attempts append to the first attempt's
    trace, which :func:`check_trace` holds (contiguous offsets across the
    kill, a ``resume`` event, the last record's rows cross-linked) and
    :func:`report_trace` prints; with :data:`BERT_PRICED` the round program
    is priced in round 1 (attempt 1 finds it priced in the trace)."""
    import math

    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.data import create_dataset_collection
    from distributed_learning_simulator_tpu_torch.ml_type import MachineLearningPhase
    from distributed_learning_simulator_tpu_torch.models import convert
    from distributed_learning_simulator_tpu_torch.ops import short_attention as sa

    config = shipped_config(BERT_FILE, os.path.join(workdir, "bert_agnews"), round=BERT_ROUNDS,
                            **{"telemetry.enabled": True, "telemetry.capture_cost": BERT_PRICED})
    check(config.algorithm_kwargs.get("client_chunk") == "auto", f"{BERT_FILE}: client_chunk {config.algorithm_kwargs}")
    test = create_dataset_collection(config).get_dataset(MachineLearningPhase.Test)
    passes = 2 if config.use_slow_performance_metrics else 1
    k4 = BERT_ROUNDS * passes * math.ceil(len(test.targets) / config.batch_size) * 12
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    label = f" (bert_agnews: 100 clients x 1 step, {config.worker_number // BERT_CHUNK} K1)"
    # the probe outermost: an attempt's setup ends where its first round begins, before any profiler starts
    with (k1_by_round([]) as k1, profiled_round(BERT_ROUNDS, label) as busy,
          bert_recovery_probe(BERT_KILL) as probe):
        result, launches = _supervised(config, BERT_KILL)
    wall = time.monotonic() - t0
    routes = dict(sa.route_launches)
    perf, recovery = result["performance"], result["recovery"]
    first, last = recovery["attempt_dirs"]
    check(len(busy) == 1, f"{BERT_FILE}: round {BERT_ROUNDS} was not profiled")
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    layout = probe["sessions"][0].engine.layout
    saved = layout.flatten(convert.from_jax(_round_params(first, BERT_KILL)))
    (start_round, start_master), = probe["starts"]
    timings = [(os.path.basename(t.path), t.queue_seconds, t.write_seconds)
               for session in probe["sessions"] for t in session._ckpt.timings]
    print(
        f"main path {BERT_FILE} (bert_base, {config.worker_number} workers,"
        f" {config.algorithm_kwargs['random_client_number']} selected, batch {config.batch_size}, use_amp),"
        f" killed after round {BERT_KILL} and resumed by train_with_recovery: {BERT_ROUNDS} rounds in {wall:.2f} s"
        f" (both attempts' setup and a profiled round included); setup {[f'{t:.2f}' for t in probe['setup_s']]} s an"
        f" attempt; peak memory {peak:.2f} GiB over the {held / 2**30:.2f} GiB held before it; launches {launches};"
        f" K4/K5 by kernel {routes}; K1 by round {k1}"
    )
    print("  checkpoints (file, s the round loop was blocked queueing it, s the writer took): "
          + "; ".join(f"{name} {queue:.4f} {write:.3f}" for name, queue, write in timings))
    for r, row in sorted(perf.items()):
        print(f"  round {r}: {row['round_seconds']:.3f} s; test loss {row['test_loss']:.4f} accuracy"
              f" {row['test_accuracy']:.4f} over {row['test_count']:.0f}")
        check(np.isfinite(row["test_loss"]) and 0.0 <= row["test_accuracy"] <= 1.0, f"{BERT_FILE} record {row}")
    with open(config.log_file, encoding="utf8") as f:
        check("client_chunk: auto found NO calibration entry" in f.read(), f"{BERT_FILE}: auto did not miss")
    check(recovery["restarts"] == 1 and last == recovery["save_dir"], f"{BERT_FILE} recovery {recovery}")
    check(torch.equal(saved, probe["master"]), f"{BERT_FILE}: round_{BERT_KILL}.npz is not round {BERT_KILL}'s master")
    check(start_round == BERT_KILL + 1 and torch.equal(start_master, saved),
          f"{BERT_FILE}: attempt 1 did not start from round_{BERT_KILL}.npz")
    check(sorted(perf) == list(range(1, BERT_ROUNDS + 1)), f"{BERT_FILE} records {sorted(perf)}")
    check(_record_rows(last) == [str(r) for r in range(1, BERT_ROUNDS + 1)], f"{BERT_FILE} last attempt's record")
    check(any(os.path.isfile(os.path.join(d, "server", "best_global_model.npz")) for d in (first, last)),
          f"{BERT_FILE}: no best_global_model.npz")
    check(k1 == [config.worker_number // BERT_CHUNK] * BERT_ROUNDS, f"{BERT_FILE} K1 by round {k1}")
    check(launches["K4"] == k4 and launches["K5"] == 0, f"{BERT_FILE} K4/K5 {launches}, want K4 {k4}, K5 0")
    check_short_routes(routes, launches["K4"], 0, BERT_FILE)
    others = [kid for kid, n in launches.items() if n and kid not in ("K1", "K4")]
    check(not others, f"{BERT_FILE}: kernels off this path launched: {others}")
    records = check_trace(os.path.join(first, "server", "trace.jsonl"), os.path.join(last, "server"), BERT_FILE,
                          metas=2)
    check([r["round"] for r in records if r["kind"] == "resume"] == [BERT_KILL + 1], f"{BERT_FILE}: resume events")
    check(sum(r["kind"] == "program_cost" for r in records) == int(BERT_PRICED), f"{BERT_FILE}: program_cost events")
    report_trace(records, BERT_FILE, card)
    return launches, {"wall_s": wall, "peak_gib": peak, "records": perf, "setup_s": probe["setup_s"],
                      "checkpoints": timings}


def measure_checkpoint_cost(workdir: str) -> dict:
    """``bert_agnews.yaml`` as shipped but for ``COST_ROUNDS`` rounds, with
    ``checkpoint_every`` 1, 100, 100 and 1 (the final round always writes
    its checkpoint): each run's round times and its checkpoints' queue and
    write seconds.  Rounds 2 to ``COST_ROUNDS - 1`` train while the round
    before's checkpoint is written under ``checkpoint_every`` 1, with none
    in flight under 100."""
    from distributed_learning_simulator_tpu_torch.parallel.spmd import SpmdFedAvgSession
    from distributed_learning_simulator_tpu_torch.training import train

    runs, start, sessions = [], SpmdFedAvgSession._start, []

    def kept_start(self):
        sessions.append(self)
        return start(self)

    SpmdFedAvgSession._start = kept_start
    try:
        for every in (1, 100, 100, 1):
            with phase_dir(workdir) as save_dir:
                config = shipped_config(BERT_FILE, save_dir, round=COST_ROUNDS, checkpoint_every=every)
                perf = train(config)["performance"]
            timings = [(os.path.basename(t.path), t.queue_seconds, t.write_seconds) for t in sessions[-1]._ckpt.timings]
            runs.append({"checkpoint_every": every, "round_seconds": [perf[r]["round_seconds"] for r in sorted(perf)],
                         "checkpoints": timings})
            print(f"checkpoint_every {every}: round seconds {runs[-1]['round_seconds']}; checkpoints (file, queue s,"
                  f" write s) {timings}")
    finally:
        SpmdFedAvgSession._start = start
    return {"file": BERT_FILE, "runs": runs}


def run_buffered_file(workdir: str) -> tuple[dict[str, int], dict]:
    """``train()`` on ``fed_avg/mnist_buffered.yaml`` as shipped but for
    ``BUFFERED_ROUNDS`` of its 20 rounds (LeNet5, buffered with
    stragglers), the launch counters set to 0 just
    before and read just after: each record's flush columns printed, K1
    exactly ``n_chunks x (depth + 1)`` every round.  Returns the launches
    and the replay for 4j: its records and its ``round_1.npz``."""
    import numpy as np

    from distributed_learning_simulator_tpu_torch.training import build_session, train

    config = shipped_config(BUFFERED_FILE, os.path.join(workdir, "mnist_buffered"), round=BUFFERED_ROUNDS)
    want = expected_k1_a_round(build_session(config))  # the schedule's depth and the chunk
    _reset_launches()
    t0 = time.monotonic()
    with k1_by_round([]) as k1:
        perf = train(config)["performance"]
    wall = time.monotonic() - t0
    launches = _read_launches()
    print(f"main path {BUFFERED_FILE}: {config.round} rounds in {wall:.2f} s (setup included); launches {launches};"
          f" K1 {want} a round")
    for r, row in sorted(perf.items()):
        print(f"  round {r}: flush_cohort {row['flush_cohort']} stale_updates {row['stale_updates']} buffer_depth"
              f" {row['buffer_depth']}; {row['round_seconds']:.3f} s; test loss {row['test_loss']:.4f}")
        check(np.isfinite(row["test_loss"]), f"{BUFFERED_FILE} record {row}")
    check(sorted(perf) == list(range(1, config.round + 1)), f"{BUFFERED_FILE} records {sorted(perf)}")
    check(want > 2 and k1 == [want] * config.round, f"{BUFFERED_FILE} K1 by round {k1}, want {want}")
    check(any(row["stale_updates"] for row in perf.values()), f"{BUFFERED_FILE}: no stale update merged")
    others = [kid for kid, n in launches.items() if n and kid != "K1"]
    check(not others, f"{BUFFERED_FILE}: kernels off this path launched: {others}")
    return launches, {"records": perf, "round_1": _round_params(config.save_dir, 1)}


# ------------------------------------------------ fault tolerance (slice 21)
#: the phase-3 threaded FedAvg fault task's plan: seed 3 drops and corrupts
#: clients every round and leaves 2, 1 and 2 of the 4 standing; the
#: stragglers sleep 0 s
THREADED_FAULTS = {"seed": 3, "dropout_rate": 0.25, "corrupt_rate": 0.25, "straggler_rate": 0.25,
                   "straggler_delay_seconds": 0.0, "update_guard": True}
#: the record columns a fault task's card and CPU runs must carry equal
FAULT_COLUMNS = ("rejected_updates", "dropped_clients")
#: a threaded FedAvg record's test loss, card against CPU (relative)
THREADED_LOSS_TOL = 1e-5


def threaded_fault_task(save_dir: str, **algorithm_kwargs):
    """A small threaded LeNet5/MNIST FedAvg task (4 workers x 64 samples,
    3 rounds) under :data:`THREADED_FAULTS`, ``min_client_quorum`` 1."""
    from distributed_learning_simulator_tpu_torch.config import DistributedTrainingConfig

    return DistributedTrainingConfig(
        dataset_name="MNIST",
        model_name="LeNet5",
        distributed_algorithm="fed_avg",
        executor="sequential",
        worker_number=4,
        batch_size=16,
        round=3,
        epoch=1,
        learning_rate=0.05,
        dataset_kwargs={"train_size": 256, "val_size": 16, "test_size": 64},
        fault_tolerance=dict(THREADED_FAULTS),
        algorithm_kwargs={"min_client_quorum": 1, **algorithm_kwargs},
        save_dir=save_dir,
        log_file=os.path.join(save_dir, "train.log"),
    )


def check_threaded_faults_against_cpu(workdir: str) -> None:
    """The threaded FedAvg fault task (:func:`threaded_fault_task`) on the
    card and on the CPU from one init: every record's ``rejected_updates``
    and ``dropped_clients`` equal, its test loss within
    ``THREADED_LOSS_TOL``, the final parameters within the phase's 1e-3,
    and no kernel launched (the synchronous server streams uploads into its
    accumulator).  A planted fault: ``min_client_quorum`` 2 above round 2's
    one survivor must raise ``QuorumLostError`` on the card."""
    import numpy as np

    from distributed_learning_simulator_tpu_torch.training import train
    from distributed_learning_simulator_tpu_torch.util.faults import QuorumLostError

    init = _port_init(workdir, "tfaults", threaded_fault_task)
    runs = {}
    for device in ("cuda", "cpu"):
        config = threaded_fault_task(os.path.join(workdir, f"tfaults_{device}"), global_model_path=init)
        if device == "cuda":
            _reset_launches()
        perf = train(config, device=device)["performance"]
        if device == "cuda":
            launches = _read_launches()
        runs[device] = (perf, _round_params(config.save_dir, config.round))
    (gpu, gpu_params), (cpu, cpu_params) = runs["cuda"], runs["cpu"]
    worst, beyond = _params_apart(gpu_params, cpu_params)
    loss = max(abs(gpu[r]["test_loss"] - cpu[r]["test_loss"]) / abs(cpu[r]["test_loss"]) for r in cpu)
    print(
        f"small task (threaded LeNet5 FedAvg, dropout, corruption, guard) card vs CPU: test loss"
        f" {[round(gpu[r]['test_loss'], 6) for r in sorted(gpu)]} vs {[round(cpu[r]['test_loss'], 6) for r in sorted(cpu)]}"
        f" (rel {loss:.2g}); final parameters max |diff| {worst:.3g}, {beyond} elements beyond 1e-5; "
        + "; ".join(f"round {r}: " + ", ".join(f"{k} {cpu[r][k]}" for k in FAULT_COLUMNS) for r in sorted(cpu))
        + f"; launches {launches}"
    )
    check(sorted(gpu) == sorted(cpu) == [1, 2, 3], f"threaded fault task records {sorted(gpu)}")
    for r in cpu:
        for key in FAULT_COLUMNS:
            check(gpu[r][key] == cpu[r][key], f"threaded fault task round {r} {key}: {gpu[r][key]} vs {cpu[r][key]}")
    check(sum(cpu[r]["rejected_updates"] for r in cpu) > 0 and sum(cpu[r]["dropped_clients"] for r in cpu) > 0,
          f"threaded fault task: no fault took effect {cpu}")
    check(loss <= THREADED_LOSS_TOL and worst <= 1e-3, "threaded fault task: card and CPU disagree")
    check(not any(launches.values()), f"threaded fault task: kernels launched {launches}")
    raised = None
    try:
        train(threaded_fault_task(os.path.join(workdir, "tfaults_quorum"), global_model_path=init,
                                  min_client_quorum=2), device="cuda")
    except QuorumLostError as exc:
        raised = str(exc)
    print(f"  planted: min_client_quorum 2 on the card raised {raised!r}")
    check(raised is not None and raised.startswith("round 2:"), "threaded fault task: the lost quorum did not raise")
    check(np.isfinite(gpu[3]["test_loss"]), "threaded fault task: the last round is not finite")


def check_spmd_fault_tasks_against_cpu(workdir: str) -> None:
    """Phase 3's small FedOBD and sign_SGD tasks again, under the fault
    plan, card against CPU by ``train()`` from one init:

    * FedOBD (:func:`obd_task_config`): a corrupt client in round 1 and a
      dropped one in the tuning epoch, ``update_guard`` on: the phases and
      ``rejected_updates`` equal, every record's test loss within the
      task's 1e-2, and K1 exactly as without faults (a dropped or rejected
      client still trains and fills its row: the fault weighs it 0);
    * sign_SGD (``conf/sign_sgd/cifar10.yaml`` cut to 3 clients, 1 epoch of
      batch 8): one client dropped and one corrupt, the vote guard on:
      ``rejected_updates`` equal (one a step), the test loss within 1e-2,
      and K1 once a step."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.models import convert
    from distributed_learning_simulator_tpu_torch.training import build_session, train

    faults = {"fault_tolerance.corrupt_schedule": "{1: [1]}", "fault_tolerance.dropout_schedule": "{2: [0]}",
              "fault_tolerance.update_guard": True}
    init = os.path.join(workdir, "obd_faults_init.npz")
    session = build_session(obd_task_config(os.path.join(workdir, "obd_faults_init")), device="cpu")
    np.savez(init, **convert.to_jax(session.engine.init_params(0)))
    chunk = session.chunk_size()
    runs = {}
    for device in ("cuda", "cpu"):
        config = obd_task_config(os.path.join(workdir, f"obd_faults_{device}"), faults, global_model_path=init)
        if device == "cuda":
            _reset_launches()
        runs[device] = train(config, device=device)["performance"]
        if device == "cuda":
            launches = _read_launches()
    gpu, cpu = runs["cuda"], runs["cpu"]
    rel = max(abs(gpu[k]["test_loss"] - row["test_loss"]) / abs(row["test_loss"]) for k, row in cpu.items())
    k1 = expected_obd_k1(len(cpu), session.n_slots, chunk)
    print(f"small task (DenseNet-40 fed_obd, corrupt then dropped client, guard) card vs CPU: test loss"
          f" {[round(gpu[k]['test_loss'], 6) for k in sorted(gpu)]} vs {[round(cpu[k]['test_loss'], 6) for k in sorted(cpu)]}"
          f" (rel {rel:.2g}); rejected_updates {[gpu[k]['rejected_updates'] for k in sorted(gpu)]} vs"
          f" {[cpu[k]['rejected_updates'] for k in sorted(cpu)]}; launches {launches} (K1 {k1} without faults)")
    check([r["phase"] for _, r in sorted(gpu.items())] == [r["phase"] for _, r in sorted(cpu.items())]
          == ["block_dropout_rounds", "epoch_tune"], f"OBD fault task phases {gpu}")
    check([gpu[k]["rejected_updates"] for k in sorted(gpu)] == [cpu[k]["rejected_updates"] for k in sorted(cpu)]
          == [1.0, 0.0], "OBD fault task: rejected_updates disagree")
    check(rel <= 1e-2, "OBD fault task: card and CPU losses disagree")
    check(launches["K1"] == k1, f"OBD fault task: K1 {launches['K1']}, want {k1}")

    make = _cut_task(SIGN_SGD_FILES[0], 3, 32, epoch=1, batch_size=8, **{
        "fault_tolerance.dropout_schedule": "{1: [0]}", "fault_tolerance.corrupt_schedule": "{1: [2]}",
        "fault_tolerance.update_guard": True})
    runs = {}
    for device in ("cuda", "cpu"):
        if device == "cuda":
            _reset_launches()
        session = build_session(make(os.path.join(workdir, f"sign_faults_{device}")), device=device)
        runs[device] = session.run()["performance"][1]
        if device == "cuda":
            launches = _read_launches()
            steps = session.config.epoch * session.n_batches
    gpu, cpu = runs["cuda"], runs["cpu"]
    rel = abs(gpu["test_loss"] - cpu["test_loss"]) / abs(cpu["test_loss"])
    print(f"small task (DenseNet-40 sign_SGD, 3 clients: one dropped, one corrupt, guard) card vs CPU: test loss"
          f" {gpu['test_loss']:.6f} vs {cpu['test_loss']:.6f} (rel {rel:.2g}); rejected_updates"
          f" {gpu['rejected_updates']} vs {cpu['rejected_updates']} over {steps} steps; launches {launches}")
    check(gpu["rejected_updates"] == cpu["rejected_updates"] == float(steps), "sign_SGD fault task: rejections")
    check(rel <= 1e-2, "sign_SGD fault task: card and CPU disagree")
    check(launches["K1"] == steps, f"sign_SGD fault task: K1 {launches['K1']}, want one a step ({steps})")
    check(not torch.backends.cudnn.allow_tf32, "sign_SGD fault task: f32 convolutions ran in TF32")


#: 4j's threaded buffered run: ``fed_avg/mnist_buffered.yaml`` as shipped
#: but for these rounds, killed after ``BUFFERED_KILL`` and recovered
THREADED_BUFFERED_ROUNDS, BUFFERED_KILL = 4, 2
#: the threaded run's round 1 against 4i's SPMD replay of the same file,
#: on the card (max |difference|): one cohort, summed in other orders
BUFFERED_REPLAY_TOL = 1e-5
#: each threaded flush's K1 mean against the plain f32 weighted sum of the
#: same uploads on the card (max |difference| over the sum's largest
#: |element|): at most 6 rows summed in another order, a few f32 roundings
#: (about 3.6e-7 at worst); a wrong weight or a lost row is off by far more
FLUSH_TOL = 1e-6


def cuda_tensors() -> set[int]:
    """The storages of the CUDA tensors Python can reach, once the
    collector has run (their data pointers)."""
    import gc

    import torch

    gc.collect()
    found = set()
    for obj in gc.get_objects():
        try:
            if torch.is_tensor(obj) and obj.is_cuda:
                found.add(obj.untyped_storage().data_ptr())
        except Exception:  # noqa: BLE001 -- an object that cannot say
            continue
    return found


def flush_against_plain(flush_average, uploads, weights) -> tuple[dict, float]:
    """``flush_average(uploads, weights)`` (the threaded server's K1 flush)
    and its max |difference| from the plain f32 weighted sum
    ``(w[:, None] * stack).sum(0)`` of the same uploads and normalised
    weights on their device, over the sum's largest |element|."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.ops.pytree import ParamVecLayout

    layout = ParamVecLayout.of(uploads[0].parameter)
    stack = torch.stack([layout.flatten(u.parameter) for u in uploads])
    w = torch.tensor(np.asarray([x / sum(weights) for x in weights], np.float32), device=stack.device)
    plain = (w[:, None] * stack).sum(0)
    got = layout.flatten(flush_average(uploads, weights))
    return layout.split(got), float((got - plain).abs().max() / plain.abs().max())


def run_threaded_buffered_recovery(workdir: str, card: str, replay: dict) -> dict[str, int]:
    """``fed_avg/mnist_buffered.yaml`` under ``executor: sequential`` at full
    width (LeNet5, 10 workers, 8 selected, ``buffer_size`` 6, its straggler
    plan, the stragglers' real sleeps), as shipped but for
    ``THREADED_BUFFERED_ROUNDS`` rounds, under ``train_with_recovery`` with
    ``kill_after_rounds`` [``BUFFERED_KILL``], the launch counters set to 0
    just before and read just after:

    * rounds 1-2's flush columns equal to 4i's SPMD replay of the file
      (``replay``: its rows and its ``round_1.npz``), and round 1's
      parameters within ``BUFFERED_REPLAY_TOL`` of the replay's (round 2's
      cohort differs: the threaded server selects one round behind the
      session, ``util/buffered.py::threaded_uploaders``, the JAX rule);
    * the resumed attempt starts from ``round_2.npz`` bit for bit;
    * the rows after the kill follow the drain rule: the schedule's cohorts
      less every origin before the resumed round (the JAX package's
      ``tests/test_async_aggregation.py``);
    * K1 exactly once a flush that merged an upload, over both attempts,
      and each flush's K1 mean within ``FLUSH_TOL`` (relative to its
      largest element) of the plain f32 sum ``(w[:, None] * stack).sum(0)``
      of the same uploads and normalised weights on the card;
    * the killed attempt's threads all ended before the resume, and once
      the run ends and the collector runs no CUDA tensor that Python can
      reach is left over from it (:func:`cuda_tensors`); the card's
      allocated memory printed before the run, after the killed attempt
      (its error still holds the attempt's objects) and at the end (what
      stays allocated is PyTorch's per-thread cuBLAS workspaces, which no
      Python object holds and which depend on the threads that ran)."""
    import threading

    import numpy as np

    import torch

    from distributed_learning_simulator_tpu_torch import training
    from distributed_learning_simulator_tpu_torch.models import convert
    from distributed_learning_simulator_tpu_torch.server.aggregation_server import AggregationServer
    from distributed_learning_simulator_tpu_torch.util.buffered import (
        BufferedSettings,
        compute_arrival_schedule,
        threaded_uploaders,
    )
    from distributed_learning_simulator_tpu_torch.util.faults import FaultPlan

    config = shipped_config(BUFFERED_FILE, os.path.join(workdir, "threaded_buffered"), executor="sequential",
                            round=THREADED_BUFFERED_ROUNDS, **{
                                "fault_tolerance.kill_after_rounds": f"[{BUFFERED_KILL}]",
                                "fault_tolerance.restart_backoff_seconds": 0})
    held = cuda_tensors()
    starts, memory, alive, flushes = [], {"before": torch.cuda.memory_allocated()}, [], []
    get_init, flush_average, train = AggregationServer._get_init_model, AggregationServer._flush_average, training.train

    def noted_init(server):
        params = get_init(server)
        starts.append({k: v.detach().cpu().clone() for k, v in params.items()})
        return params

    def noted_flush(uploads, weights):
        params, err = flush_against_plain(flush_average, uploads, weights)
        flushes.append((len(uploads), err))
        return params

    def noted_train(*args, **kwargs):
        try:
            return train(*args, **kwargs)
        except Exception:
            torch.cuda.synchronize()
            memory["after the killed attempt"] = torch.cuda.memory_allocated()
            alive.extend(t.name for t in threading.enumerate() if t.name.startswith(("server", "worker")))
            raise

    AggregationServer._get_init_model = noted_init
    AggregationServer._flush_average = staticmethod(noted_flush)
    training.train = noted_train
    _reset_launches()
    t0 = time.monotonic()
    try:
        result = training.train_with_recovery(config)
    finally:
        AggregationServer._get_init_model = get_init
        AggregationServer._flush_average = staticmethod(flush_average)
        training.train = train
    wall = time.monotonic() - t0
    launches = _read_launches()
    left = cuda_tensors() - held
    torch.cuda.synchronize()
    memory["at the end"] = torch.cuda.memory_allocated()
    perf = result["performance"]
    print(f"main path {BUFFERED_FILE} threaded ({config.worker_number} workers, {THREADED_BUFFERED_ROUNDS} rounds, killed"
          f" after round {BUFFERED_KILL}, {result['recovery']['restarts']} restart): {wall:.2f} s ({card}); launches"
          f" {launches}; flushes merged {[n for n, _ in flushes]}, K1 against the plain f32 sum"
          f" {[f'{e:.3g}' for _, e in flushes]} (relative, FLUSH_TOL {FLUSH_TOL}); card memory allocated "
          + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in memory.items())
          + f"; CUDA tensors of the run left after it: {len(left)}")
    for r, row in sorted(perf.items()):
        print(f"  round {r}: flush_cohort {row['flush_cohort']} stale_updates {row['stale_updates']} buffer_depth"
              f" {row['buffer_depth']}; test loss {row['test_loss']:.4f} (replay: "
              + (", ".join(f"{replay['records'][r][k]}" for k in ("flush_cohort", "stale_updates", "buffer_depth"))
                 if r in replay["records"] else "-") + ")")
        check(np.isfinite(row["test_loss"]), f"threaded {BUFFERED_FILE} record {row}")
    columns = ("flush_cohort", "stale_updates", "buffer_depth")
    check(result["recovery"]["restarts"] == 1 and sorted(perf) == list(range(1, THREADED_BUFFERED_ROUNDS + 1)),
          f"threaded {BUFFERED_FILE}: recovery {result['recovery']}, records {sorted(perf)}")
    for r in range(1, BUFFERED_KILL + 1):
        for key in columns:
            check(perf[r][key] == replay["records"][r][key],
                  f"threaded {BUFFERED_FILE} round {r} {key}: {perf[r][key]} vs the replay's {replay['records'][r][key]}")
    first = _round_params(result["recovery"]["attempt_dirs"][0], 1)
    worst, _ = _params_apart(first, replay["round_1"])
    print(f"  round 1 against the SPMD replay's: max |diff| {worst:.3g}")
    check(worst <= BUFFERED_REPLAY_TOL, f"threaded {BUFFERED_FILE}: round 1 {worst} from the replay's")
    killed = convert.from_jax(_round_params(result["recovery"]["attempt_dirs"][0], BUFFERED_KILL))
    check(len(starts) == 2 and all(torch.equal(starts[1][k], v) for k, v in killed.items()),
          f"threaded {BUFFERED_FILE}: the resumed attempt does not start from round_{BUFFERED_KILL}.npz")
    schedule = compute_arrival_schedule(BufferedSettings.from_config(config), FaultPlan.from_config(config),
                                        config.worker_number, config.round, threaded_uploaders(config))
    floor = BUFFERED_KILL + 1
    for r in range(floor, config.round + 1):
        want = (len(schedule.live_cohort(r, floor)), schedule.stale_count(r, floor),
                schedule.buffer_depth_after(r, floor))
        check(tuple(perf[r][k] for k in columns) == want, f"threaded {BUFFERED_FILE} round {r}: not drained {want}")
    merged = sum(1 for row in perf.values() if row["flush_cohort"] > 0)
    check(launches["K1"] == len(flushes) == merged, f"threaded {BUFFERED_FILE}: K1 {launches['K1']}, flushes"
          f" {flushes}, {merged} non-empty")
    check(all(e <= FLUSH_TOL for _, e in flushes), f"threaded {BUFFERED_FILE}: K1 flushes off the plain sum {flushes}")
    check(not [kid for kid, n in launches.items() if n and kid != "K1"], f"threaded {BUFFERED_FILE}: {launches}")
    check(not alive, f"threaded {BUFFERED_FILE}: the killed attempt's threads still run: {alive}")
    check(not left, f"threaded {BUFFERED_FILE}: {len(left)} CUDA tensors of the run still reachable")
    return launches


# ------------------------------------------------------------------ telemetry
#: phase 4's telemetry: the config's profiler window on round 2
VIT_TELEMETRY = {"telemetry": {"enabled": True, "profile_rounds": [2, 2]}}
#: whether 4i prices its round program (``capture_cost``) at its first
#: dispatch: only while ``FlopCounterMode`` costs a bert_agnews.yaml round
#: under 10 s.  It costs 24.7 s on an H100 (``--flop-cost``; PERF.md section 6), so
#: phase 4 alone prices its program
BERT_PRICED = False
#: the rounds of ``--flop-cost``: priced 1, 3 and 5, plain 2 and 4
FLOP_ROUNDS = 5


def trace_records(path: str) -> list[dict]:
    """Every line of the trace at ``path``, each of which must parse, with
    its offset ``i`` equal to its line index."""
    with open(path, encoding="utf8") as f:
        lines = f.read().splitlines()
    records = []
    for n, line in enumerate(lines):
        try:
            records.append(json.loads(line))
        except ValueError:
            check(False, f"{path}: line {n} does not parse: {line[:80]!r}")
    check([r["i"] for r in records] == list(range(len(lines))), f"{path}: offsets are not the line indices")
    return records


def check_trace(path: str, record_dir: str, label: str, metas: int = 1, hbm: bool = True,
                window: tuple[int, int] | None = None) -> list[dict]:
    """The trace checks of a telemetry run on the card: every line parses
    and the offsets are contiguous (across ``metas`` sessions); each row of
    ``record_dir``'s ``round_record.json`` cross-links its round span; with
    ``hbm``, watermarks present with 0 < peak <= the card's memory; a
    ``compile`` event for each kernel library the process loaded; with
    ``window``, one profiler file and its start and stop events."""
    import torch

    from distributed_learning_simulator_tpu_torch.ops import build

    records = trace_records(path)
    check(sum(r["ev"] == "meta" for r in records) == metas, f"{label}: meta records, want {metas}")
    with open(os.path.join(record_dir, "round_record.json"), encoding="utf8") as f:
        rows = json.load(f)
    for key, row in rows.items():
        span = records[row["trace_offset"]]
        check((span["ev"], span["kind"], span["round"]) == ("span", "round", int(key)),
              f"{label}: row {key}'s trace_offset {row['trace_offset']} is {span}")
    if hbm:
        total = torch.cuda.get_device_properties(0).total_memory
        marks = [r["peak_bytes_in_use"] for r in records if r["kind"] == "hbm"]
        check(marks and all(0 < peak <= total for peak in marks), f"{label}: hbm peaks {marks} (card {total})")
    loaded = {load["library"] for load in build.loads}
    compiled = {r["program"] for r in records if r["kind"] == "compile"}
    check(loaded and compiled == loaded, f"{label}: compile events {sorted(compiled)}, libraries {sorted(loaded)}")
    if window is not None:
        events = [r for r in records if r["kind"] == "profile"]
        check([(r["action"], r["round"]) for r in events] == [("start", window[0]), ("stop", window[1])],
              f"{label}: profile events {events}")
        files = os.listdir(os.path.join(os.path.dirname(path), "profile_rounds"))
        check(len(files) == 1 and events[1]["file"].endswith(files[0]), f"{label}: profiler files {files}")
        print(f"  {label} profiler window {window}: {files[0]}, {os.path.getsize(events[1]['file']) / 2**20:.1f} MiB")
    return records


def report_trace(records: list[dict], label: str, card: str) -> dict:
    """Prints ``tools/tracedump``'s summary of a trace and, for each priced
    program, its flops and ``roofline`` over the median round span (bytes:
    the priced call's arguments and result, each once), beside the card;
    the round spans, the dispatch spans, the host's share of the rounds
    outside ``dispatch_call`` and the hbm peak.  Returns those numbers."""
    import statistics

    from distributed_learning_simulator_tpu_torch.util.costwatch import chip_hbm_bandwidth, chip_peak_flops, roofline
    from tools.tracedump import format_text, summarize

    print(f"  {label} trace (tools/tracedump):")
    print("\n".join("    " + line for line in format_text(summarize(records)).splitlines()))
    rounds = [r["dur"] for r in records if (r["ev"], r["kind"]) == ("span", "round")]
    calls = [(r["program"], r["dur"]) for r in records if (r["ev"], r["kind"]) == ("span", "dispatch_call")]
    median = statistics.median(rounds)
    outside = 1.0 - sum(d for _, d in calls) / sum(rounds)
    peak = max((r["peak_bytes_in_use"] for r in records if r["kind"] == "hbm"), default=0)
    out = {"round_s": rounds, "dispatch_call_s": calls, "host_share_outside_dispatch_call": outside,
           "hbm_peak_bytes": peak, "programs": {}}
    print(f"    round spans {[f'{d:.3f}' for d in rounds]} s (median {median:.3f}); dispatch_call spans"
          f" {[(p, round(d, 3)) for p, d in calls]}; host share of the rounds outside dispatch_call {outside:.4f};"
          f" hbm peak {peak / 2**30:.2f} GiB")
    for cost in (r for r in records if r["kind"] == "program_cost"):
        line = roofline(cost["flops"], cost["argument_bytes"] + cost["output_bytes"], seconds=median,
                        peak_flops=chip_peak_flops(), hbm_bandwidth=chip_hbm_bandwidth())
        out["programs"][cost["program"]] = {"flops": cost["flops"], **line}
        print(f"    program_cost {cost['program']}: {cost['flops']:.6g} flops (FlopCounterMode; the ctypes kernels"
              f" uncounted), arguments {cost['argument_bytes'] / 2**30:.3f} GiB, result"
              f" {cost['output_bytes'] / 2**30:.3f} GiB; roofline over the median round: achieved MFU"
              f" {line.get('achieved_mfu', 0.0):.6f}, roofline MFU {line['roofline_mfu']:.4f}, bound by"
              f" {line['bound_by']} ({card})")
    return out


def run_vit_main_path(workdir: str, card: str) -> dict[str, int]:
    """``train()`` on the dense-shape configuration with telemetry on and
    its profiler window on round 2, the launch counters set to 0 just
    before and read just after; the records, the launches and the trace
    checked.  Returns the launches."""
    import numpy as np
    import torch

    from distributed_learning_simulator_tpu_torch.ops import short_attention as sa
    from distributed_learning_simulator_tpu_torch.ops import weighted_accum as wa
    from distributed_learning_simulator_tpu_torch.training import train

    config = dense_config(os.path.join(workdir, "main"), **VIT_TELEMETRY)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.monotonic()
    perf = train(config)["performance"]
    wall = time.monotonic() - t0
    launches = {"K1": wa.launches, "K4": sa.fwd_launches, "K5": sa.bwd_launches}
    short_routes = dict(sa.route_launches)
    last = perf[ROUNDS]
    print(
        f"main path: {ROUNDS} rounds in {wall:.2f} s (setup, round 1's pricing and round 2's profiler included);"
        f" round {ROUNDS} {last['round_seconds']:.3f} s = {1 / last['round_seconds']:.3f} rounds/s;"
        f" test loss {last['test_loss']:.4f} accuracy {last['test_accuracy']:.4f};"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches};"
        f" K4/K5 by kernel {short_routes}"
    )
    for r, row in perf.items():
        check(np.isfinite(row["test_loss"]), f"round {r} test loss {row['test_loss']}")
        check(0.0 <= row["test_accuracy"] <= 1.0, f"round {r} accuracy {row['test_accuracy']}")
        check(row["test_count"] == 256.0, f"round {r} evaluated {row['test_count']} samples")
    check(launches["K1"] == ROUNDS * WORKERS // CHUNK, f"K1 launches {launches['K1']}")
    check(launches["K4"] > 0 and launches["K5"] > 0, f"attention launches {launches}")
    check_short_routes(short_routes, launches["K4"], launches["K5"], "ViT-small")
    server = os.path.join(config.save_dir, "server")
    window = tuple(VIT_TELEMETRY["telemetry"]["profile_rounds"])
    records = check_trace(os.path.join(server, "trace.jsonl"), server, "ViT-small", window=window)
    report_trace(records, "ViT-small", card)
    return launches


def measure_flop_cost(workdir: str, card: str) -> dict:
    """``bert_agnews.yaml`` as shipped but for ``FLOP_ROUNDS`` rounds with
    telemetry on, its round program priced under ``FlopCounterMode`` in
    rounds 1, 3 and 5 and not in 2 and 4: the pricing's cost is the mean
    ``dispatch_call`` span of rounds 3 and 5 less that of rounds 2 and 4
    (round 1 also warms up)."""
    from distributed_learning_simulator_tpu_torch.training import train
    from distributed_learning_simulator_tpu_torch.util.telemetry import TraceRecorder

    dispatch, calls = TraceRecorder.dispatch, []

    def alternating(self, program, fn, args, cost_args=None):
        if len(calls) % 2 == 0:
            self._priced.discard(program)  # price this call again
        calls.append(program)
        return dispatch(self, program, fn, args, cost_args=cost_args)

    TraceRecorder.dispatch = alternating
    try:
        with phase_dir(workdir) as save_dir:
            config = shipped_config(BERT_FILE, save_dir, round=FLOP_ROUNDS, **{"telemetry.enabled": True})
            train(config)
            records = trace_records(os.path.join(save_dir, "server", "trace.jsonl"))
    finally:
        TraceRecorder.dispatch = dispatch
    spans = [r["dur"] for r in records if (r["ev"], r["kind"]) == ("span", "dispatch_call")]
    flops = [r["flops"] for r in records if r["kind"] == "program_cost"]
    check(len(spans) == FLOP_ROUNDS and len(flops) == 3 and len(set(flops)) == 1, f"flop cost: {spans} {flops}")
    from distributed_learning_simulator_tpu_torch.util.costwatch import chip_peak_flops

    cost = (spans[2] + spans[4]) / 2 - (spans[1] + spans[3]) / 2
    plain = (spans[1] + spans[3]) / 2
    mfu = flops[0] / plain / chip_peak_flops()
    print(f"FlopCounterMode on {BERT_FILE}'s round program: dispatch_call spans {[f'{d:.3f}' for d in spans]} s"
          f" (priced: rounds 1, 3, 5); pricing costs {cost:.3f} s a round; {flops[0]:.6g} flops, achieved MFU"
          f" {mfu:.5f} over the plain rounds' calls ({card})")
    return {"file": BERT_FILE, "dispatch_call_s": spans, "priced_rounds": [1, 3, 5], "cost_s": cost,
            "flops": flops[0], "achieved_mfu_plain": mfu}


def print_phase_times(marks: list) -> None:
    print("phase wall times: " + "; ".join(
        f"{label} {t - before:.1f} s" for (_, before), (label, t) in zip(marks, marks[1:])
    ))


def main(argv: list[str]) -> int:
    kernels_only = argv == ["--kernels"]
    checkpoint_cost = argv == ["--checkpoint-cost"]
    flop_cost = argv == ["--flop-cost"]
    telemetry_only = argv == ["--telemetry"]
    if argv and not (kernels_only or checkpoint_cost or flop_cost or telemetry_only):
        print("usage: chip_smoke.py [--kernels | --checkpoint-cost | --flop-cost | --telemetry]", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        print(f"{PACKAGE}/ is not beside chip_smoke.py", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: no card to run on", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    import shutil

    from distributed_learning_simulator_tpu_torch.ops import build

    started = time.monotonic()
    marks = [("start", started)]

    def mark(label: str) -> None:  # the script's wall time by phase
        marks.append((label, time.monotonic()))

    # phase 2's f32 checks compare f32 arithmetic: PyTorch's default for
    # matmuls; every train() call then sets the port's precision itself
    # (utils/device.py: TF32 off for f32 matmuls and convolutions)
    check(not torch.backends.cuda.matmul.allow_tf32, "f32 matmuls default to TF32 in this PyTorch")
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    # 1. build (each library's ptxas report is kept beside it)
    sources = ["weighted_accum", "short_attention", "fused_attention", "qsgd"]
    t0 = time.monotonic()
    build.build(sources)
    print(f"build: {time.monotonic() - t0:.1f} s")
    for name in sources:
        regs = [line.split(":", 1)[1].strip() for line in build.report(name).splitlines() if "registers" in line]
        print(f"  {name}.cu: {'; '.join(regs)}")
    for library in WGMMA_KERNELS:
        check_wgmma_build(library)
    mark("1 build")
    # every phase's output lands in a directory of its own, removed after it
    os.makedirs(os.path.join(ROOT, "session"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "session"))
    try:
        if checkpoint_cost:  # bert_agnews.yaml's round time with and without a checkpoint every round
            cost = measure_checkpoint_cost(workdir)
            print(card)
            print(json.dumps({"checkpoint_cost": cost, "card": card}))
            return 0
        if flop_cost:  # FlopCounterMode's cost on a bert_agnews.yaml round
            cost = measure_flop_cost(workdir, card)
            print(card)
            print(json.dumps({"flop_cost": cost, "card": card}))
            return 0
        if telemetry_only:  # phases 4, 4c and 4i with their trace checks, and --flop-cost
            for label, run in (("4 ViT", run_vit_main_path), ("4c threaded fed_obd_sq", run_obd_main_path),
                               ("4i bert_agnews", run_bert_agnews)):
                with phase_dir(workdir) as d:
                    run(d, card)
                mark(label)
            cost = measure_flop_cost(workdir, card)
            mark("flop cost")
            print_phase_times(marks)
            print(card)
            print(json.dumps({"flop_cost": cost, "card": card}))
            return 0
        return _phases(kernels_only, workdir, card, started, marks, mark)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _phases(kernels_only: bool, workdir: str, card: str, started: float, marks: list, mark) -> int:
    """Phases 2-5 of :func:`main` (the module docstring), ``workdir`` the
    parent of every phase's output directory."""
    import torch

    # 2. kernels against their plain versions (the yardsticks: --kernels)
    yardsticks = kernels_only
    gen = torch.Generator(device="cuda").manual_seed(0)
    d, d_cnn, d_gnn = param_count(), param_count("densenet40"), param_count("TwoGCN", "Coauthor_CS")
    d_bert = param_count("bert_base", "AGNews", max_len=128)  # bert_agnews.yaml's
    mark("2 model sizes")
    k1 = check_weighted_accum(d, d_cnn, d_gnn, d_bert, gen, yardsticks)
    mark("2 K1")
    k4, k5 = check_short_attention(gen, yardsticks)
    mark("2 K4/K5")
    fused = check_fused_attention(gen, yardsticks)
    check_tf32x3_refuses_a_misaligned_base(gen)
    check_planted_faults(gen)
    check_tf32_planted_fault(gen)
    mark("2 K6-K11")
    k2, k3 = check_qsgd(gen, yardsticks)
    mark("2 K2/K3")
    if kernels_only:  # phases 1-2 with the yardsticks: the quickest check of a kernel change
        print_phase_times(marks)
        print(json.dumps({"K1": k1, "K2": k2, "K3": k3, "K4": k4, "K5": k5,
                          **{kid: fused[kid] for kid in sorted(fused)}}))
        return 0

    # 3. small tasks on the card against the CPU
    with phase_dir(workdir) as d:
        check_small_task_against_cpu(d, "ViT-small", vit_small_task)
    mark("3 ViT-small")
    with phase_dir(workdir) as d:
        check_small_task_against_cpu(d, "DenseNet-40", densenet_small_task)
    mark("3 DenseNet-40")
    with phase_dir(workdir) as d:
        stream_launches = check_long_context_f32_against_cpu(d)
    mark("3 long context f32")
    with phase_dir(workdir) as d:
        check_obd_task_against_cpu(d)
    mark("3 fed_obd")
    with phase_dir(workdir) as d:
        check_small_task_against_cpu(d, "DenseNet-40 fed_dropout_avg", sparse_small_task("fed_dropout_avg/cifar10.yaml"))
        check_small_task_against_cpu(d, "DenseNet-40 single_model_afd", sparse_small_task("smafd/cifar10.yaml"))
    mark("3 fed_dropout_avg, smafd")
    with phase_dir(workdir) as d:
        check_sign_sgd_task_against_cpu(d)
    mark("3 sign_SGD")
    with phase_dir(workdir) as d:
        check_shapley_task_against_cpu(d)
    mark("3 GTG")
    with phase_dir(workdir) as d:
        check_gnn_task_against_cpu(d)
    mark("3 fed_gnn task")
    with phase_dir(workdir) as d:
        bert_task = check_rounds_against_cpu(d, "BERT d_model 128 f32", bert_task_config)
        check(bert_task["K4"] > 0 and bert_task["K5"] > 0, f"BERT task: K4/K5 {bert_task}")
        check_rounds_against_cpu(d, "LeNet5 buffered, guard", buffered_task_config,
                                 ("flush_cohort", "stale_updates", "buffer_depth", "rejected_updates", "received_mb"))
    mark("3 BERT, buffered tasks")
    with phase_dir(workdir) as d:
        check_recovery_against_cpu(d)
    mark("3 recovery tasks")
    with phase_dir(workdir) as d:
        check_threaded_tasks_against_cpu(d)
        check_keyed_obd_sq_launches(d)
    mark("3 threaded tasks")
    with phase_dir(workdir) as d:
        check_threaded_shapley_task_against_cpu(d)
        check_threaded_gnn_task_against_cpu(d)
    mark("3 threaded GTG, fed_gnn")
    with phase_dir(workdir) as d:
        check_threaded_faults_against_cpu(d)
    mark("3 threaded fault task")
    with phase_dir(workdir) as d:
        check_spmd_fault_tasks_against_cpu(d)
    mark("3 SPMD fault tasks (fed_obd, sign_SGD)")

    # 4. the main path, with telemetry on (its trace checked)
    with phase_dir(workdir) as d:
        launches = run_vit_main_path(d, card)
    mark("4 ViT")

    # 4b. the long-context main path (K6-K8, K1) and its profile
    with phase_dir(workdir) as d:
        lc_launches, _ = run_long_context_main_path(d)
        # the full-width f32 round: K9-K11's main path (the small task's
        # launches, checked above, are a card-vs-CPU check)
        f32_launches = run_long_context_f32_round(d)
    launches.update({kid: lc_launches[kid] for kid in ("K6", "K7", "K8")})
    launches["K1"] += lc_launches["K1"]
    launches.update({kid: f32_launches[kid] for kid in ("K9", "K10", "K11")})
    launches["K1"] += f32_launches["K1"]
    print(f"small f32 task launches (card vs CPU): {stream_launches}")
    mark("4b long context")

    # 4c. the threaded fed_obd_sq main path (K2, K3, K4, K5), with telemetry on
    with phase_dir(workdir) as d:
        obd_launches, _ = run_obd_main_path(d, card)
    launches.update({kid: obd_launches[kid] for kid in ("K2", "K3")})
    launches["K4"] += obd_launches["K4"]
    launches["K5"] += obd_launches["K5"]
    mark("4c threaded fed_obd_sq")

    # 4d. the shipped conf/fed_avg files (K1)
    with phase_dir(workdir) as d:
        cnn_launches = run_shipped_configs(d)
    launches["K1"] += cnn_launches["K1"]
    mark("4d conf/fed_avg")

    # 4e. the shipped fed_obd, fed_obd_sq and fed_paq files on the SPMD
    # session (K1; K4 and K5 on the ViT file)
    with phase_dir(workdir) as d:
        spmd_obd_launches, spmd_obd_records = run_obd_spmd_files(d)
    for kid in ("K1", "K4", "K5"):
        launches[kid] += spmd_obd_launches[kid]
    mark("4e SPMD FedOBD, FedOBD-SQ, FedPAQ")

    # 4f. the large-scale FedOBD files (round_horizon 5, remat_policy);
    # horizon parity and remat on the card; the FedDropoutAvg and SMAFD
    # files (K1 each)
    with phase_dir(workdir) as d:
        large_launches, large_records = run_large_scale_obd(d)
        mark("4f large-scale FedOBD")
        check_horizon_parity(d, large_records)
        check_remat(d)
    mark("4f horizon parity, remat")
    with phase_dir(workdir) as d:
        sparse_launches, _ = run_sparse_files(d)
    launches["K1"] += large_launches["K1"] + sparse_launches["K1"]
    mark("4f FedDropoutAvg, SMAFD")

    # 4g. the shipped sign-SGD and Shapley-value files (K1: a vote a step,
    # a subset's average and a round's aggregate)
    with phase_dir(workdir) as d:
        sign_launches, _ = run_sign_sgd_files(d)
    mark("4g sign_SGD")
    with phase_dir(workdir) as d:
        shapley_launches, _ = run_shapley_files(d)
    launches["K1"] += sign_launches["K1"] + shapley_launches["K1"]
    mark("4g Shapley")

    # 4h. the shipped graph files (K1: a round's aggregate) and a profiled
    # fed_gnn round
    with phase_dir(workdir) as d:
        gnn_launches, gnn_records = run_gnn_files(d)
        launches["K1"] += gnn_launches["K1"]
        mark("4h graph FL")
        profile_gnn_round(d, gnn_records)
    mark("4h profile")

    # 4i. bert_agnews.yaml killed after round 1 and recovered (K1, K4 on
    # wgmma; round 2 profiled; telemetry on across both attempts); the
    # buffered mnist_buffered.yaml (K1 once a chunk and bucket)
    with phase_dir(workdir) as d:
        bert_launches, _ = run_bert_agnews(d, card)
    launches["K1"] += bert_launches["K1"]
    launches["K4"] += bert_launches["K4"]
    mark("4i bert_agnews (killed, recovered, round 2 profiled)")
    with phase_dir(workdir) as d:
        buffered_launches, replay = run_buffered_file(d)
    launches["K1"] += buffered_launches["K1"]
    mark("4i mnist_buffered")

    # 4j. the shipped imdb files of the threaded executor's methods (no
    # kernel of the port on these paths)
    with phase_dir(workdir) as d:
        run_threaded_files(d, card)
    mark("4j threaded imdb files")
    with phase_dir(workdir) as d:
        launches["K1"] += run_threaded_buffered_recovery(d, card, replay)["K1"]
    mark("4j threaded mnist_buffered (killed, recovered)")

    # 4k. the shipped Shapley and graph files on the threaded executor (K1:
    # a subset's average and a round's aggregate; none on the graph files)
    with phase_dir(workdir) as d:
        threaded_launches, _ = run_threaded_sv_gnn_files(d, card)
        launches["K1"] += threaded_launches["K1"]
    mark("4k threaded Shapley, graph files")

    # 5. the record
    src = f"{PACKAGE}/csrc"
    rows = [
        ("weighted_accum", "K1", f"{src}/weighted_accum.cu",
         "distributed_learning_simulator_tpu/ops/pallas_kernels.py:198", k1),
        ("qsgd_encode", "K2", f"{src}/qsgd.cu",
         "distributed_learning_simulator_tpu/ops/pallas_kernels.py:108", k2),
        ("qsgd_decode", "K3", f"{src}/qsgd.cu",
         "distributed_learning_simulator_tpu/ops/pallas_kernels.py:167", k3),
        ("short_attention_fwd", "K4", f"{src}/short_attention.cu",
         "distributed_learning_simulator_tpu/ops/short_attention.py:134", k4),
        ("short_attention_bwd", "K5", f"{src}/short_attention.cu",
         "distributed_learning_simulator_tpu/ops/short_attention.py:159", k5),
    ]
    fa_src, fa_jax = f"{src}/fused_attention.cu", "distributed_learning_simulator_tpu/ops/fused_attention.py"
    for name, kid, line in (
        ("fused_attention_fwd (fused tier)", "K6", 168),
        ("fused_attention_dq (fused tier)", "K7", 271),
        ("fused_attention_dkv (fused tier)", "K8", 281),
        ("fused_attention_fwd (stream tier)", "K9", 425),
        ("fused_attention_dq (stream tier)", "K10", 470),
        ("fused_attention_dkv (stream tier)", "K11", 490),
    ):
        rows.append((name, kid, fa_src, f"{fa_jax}:{line}", fused[kid]))
    kernels = [
        {"name": name, "id": kid, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[kid], "status": "ok", **numbers}
        for name, kid, source, replaces, numbers in rows
    ]
    print_phase_times(marks)
    print(f"chip_smoke wall time: {time.monotonic() - started:.1f} s")
    print(json.dumps({"kernels": kernels, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
