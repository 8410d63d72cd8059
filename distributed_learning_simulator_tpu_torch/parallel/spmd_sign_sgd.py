"""sign-SGD on one device (the port's ``SpmdSignSGDSession``; JAX
``parallel/spmd.py::SpmdSignSGDSession``).

The JAX session compiles a whole round of steps into one program: at each
step every client slot takes its gradient on its own batch at the shared
parameters, the slots vote with the signs, and every client applies the
same momentum update.  Here the slots are a loop on one GPU, and a round
resets the step counter and the velocity, so the cosine schedule over
``epoch * n_batches`` steps restarts every round.  At step index ``i`` of
each epoch:

1. each participating slot computes its gradient on its batch ``i``
   (:meth:`~..engine.engine.ComputeEngine.loss_and_grad`: the model call,
   no optimizer) and writes ``sign(grad)`` into its row of a
   ``[n_slots, D]`` bf16 stack (-1, 0 and +1 are exact in bf16);
2. kernel K1 sums the rows once with the 0/1 vote weights
   (``dataset_sizes > 0``, times the round's selection under
   ``random_client_number``);
3. ``direction = sign(total)``, ``v = momentum * v + direction``,
   ``p = p - lr(step) * v`` in f32, with no weight decay, as in JAX.

The step advances at every batch index, also where a client's batch
counts 0: that client's row is 0 (no vote), as its zero gradient's sign
is in the JAX program; the engine's ``train_step`` would skip the batch
without advancing anything, so the session does not go through it.  The
record row has the JAX keys (test metrics, and ``train_loss_per_epoch`` /
``train_accuracy_per_epoch`` summed over the slots, masked by the vote
weights only under selection or injection) plus ``round_seconds``;
``server/best_global_model.npz`` is rewritten whenever the test accuracy
improves.  The initial parameters are ``engine.init_params(seed)``, as in
JAX (which reads no ``global_model_path``).  ``round_horizon`` H > 1 runs
its rounds one by one, a record each (the H = 1 run, bit for bit).  As in
JAX, the session writes no round checkpoints and takes no ``resume_dir``: a
scheduled kill (``kill_after_rounds``) fires right after its round's record
lands, and ``train_with_recovery`` restarts the run from round 1.
``watchdog_seconds`` guards each round and its evaluation.

The fault plan folds into the 0/1 vote weights as in the JAX session (a
dropped client 0, a corrupt one NaN, the quorum checked before the
round), and with it the training metrics are weighted by the votes.  The
update guard masks a slot out of one step's vote where its gradient or
its weight is not finite and counts it; the row's ``rejected_updates``
sums the round's steps.  (The vote has no round delta, so there is no norm
check.)

Telemetry follows the JAX session's recorder and loop: a ``dispatch_call``
span around each round under the JAX program's name (``run[dense]``, or
``run[gather]`` under ``random_client_number``; ``horizon[h=N]`` at
H > 1), the ``run`` and ``eval`` dispatch events, an ``eval`` span,
``host_sync``, ``hbm`` and the ``round`` span, and a ``horizon`` span a
chunk at H > 1 (whose rounds still make the H = 1 dispatches and syncs);
the trace is flushed every round (the session has no checkpoint writer
whose exit would flush it) and closed at the end.
"""

import os
import time

import numpy as np
import torch

from ..models.convert import to_jax
from ..models.dropout import dropout_generator
from ..ops.pytree import flat_stack_weighted_sum
from ..util.faults import apply_fault_plan
from ..utils.logging import get_logger
from ..utils.selection import select_workers
from .spmd import SpmdFedAvgSession


class SpmdSignSGDSession(SpmdFedAvgSession):
    """Majority-vote sign-SGD: one K1 vote over the slots' gradient signs
    at every optimizer step."""

    supported_algorithm_kwargs = frozenset({"random_client_number", "round_horizon", "min_client_quorum"})
    _uses_val_policy = False

    @classmethod
    def _horizon_unsupported_reason(cls) -> str | None:
        return None  # the JAX session fuses rounds too

    @classmethod
    def _class_update_guard_reason(cls) -> str | None:
        return None  # the JAX session guards its votes

    def __init__(self, config, *args, **kwargs) -> None:
        mode = str(config.algorithm_kwargs.get("aggregation_mode") or "synchronous").lower()
        if mode == "buffered":  # the JAX session's refusal
            raise ValueError(
                "algorithm_kwargs.aggregation_mode=buffered is unsupported here: buffered aggregation"
                " (aggregation_mode: buffered) applies to round-level uploads; sign_SGD exchanges sign"
                " votes on every optimizer step and has no round upload to buffer — drop the knob for"
                " this session"
            )
        super().__init__(config, *args, **kwargs)
        self.n_batches = len(self._counts[0])
        k = config.algorithm_kwargs.get("random_client_number")
        self._selection_active = k is not None and int(k) < config.worker_number
        # the training metrics are weighted by the votes where the cohort
        # varies round to round (selection or injection), as in JAX
        injecting = self._fault_plan is not None and self._fault_plan.injection_active
        self._mask_metrics = self._selection_active or injecting

    def round_weights(self, round_number: int) -> np.ndarray:
        """``[n_slots]`` 0/1 vote weights: the workers with data, under
        ``random_client_number`` only the round's selected ones."""
        weights = (self._dataset_sizes > 0).astype(np.float32)
        if self._selection_active:
            selected = select_workers(
                self.config.seed,
                round_number,
                self.config.worker_number,
                self.config.algorithm_kwargs.get("random_client_number"),
            )
            mask = np.zeros(self.n_slots, np.float32)
            mask[sorted(selected)] = 1.0
            weights = weights * mask
        return apply_fault_plan(
            self._fault_plan, self._min_quorum, round_number, None, weights, self.config.worker_number
        )

    def new_votes(self, size: int) -> torch.Tensor:
        """The ``[n_slots, size]`` bf16 vote stack, zeroed, its rows on
        128-byte boundaries."""
        row_stride = -(-size // 64) * 64
        return torch.zeros(self.n_slots, row_stride, dtype=torch.bfloat16, device=self.device)[:, :size]

    def vote(self, params, votes, w, weights, i, generators, summed=None) -> torch.Tensor:
        """Step index ``i``'s direction ``sign(sum_c w_c * sign(grad_c))`` at
        ``params``: each participating slot's gradient sign in its row of
        ``votes``, then one K1 launch.  Adds the slots' training metrics to
        ``summed`` (``[loss_sum, correct, count]``) when given.  Under the
        update guard a slot whose gradient or weight is not finite votes
        with weight 0 at this step and adds 1 to the round's rejections
        (on the device)."""
        guard = self._update_guard
        if guard:
            w = w.clone()  # this step's vote weights
        for slot in range(self.n_slots):
            if weights[slot] == 0:
                continue  # its row stays 0 and its vote weighs 0
            grad = None
            if self._counts[slot][i] <= 0:
                votes[slot].zero_()  # a zero gradient: no vote
            else:
                batch = {k: v[slot, i] for k, v in self._data.items()}
                metrics, grad = self.engine.loss_and_grad(params, batch, generators[slot])
            if guard:
                ok = torch.isfinite(w[slot])
                if grad is not None:
                    ok = ok & torch.isfinite(grad).all()
                self._rejected += torch.where(ok, 0.0, 1.0)  # a participating slot: its weight is not 0
                w[slot] = torch.where(ok, w[slot], 0.0)
            if grad is None:
                continue
            votes[slot].copy_(grad.sign_())
            if summed is not None:
                row = torch.stack([metrics["loss"] * metrics["count"], metrics["correct"], metrics["count"]])
                summed += row * w[slot] if self._mask_metrics else row
        return torch.sign(flat_stack_weighted_sum(votes, w))

    def update(self, params: torch.Tensor, velocity: torch.Tensor, direction: torch.Tensor, lr) -> None:
        """``v = momentum * v + direction``, ``p = p - lr * v``, in f32, in place."""
        velocity.mul_(self.engine.hyper_parameter.momentum).add_(direction)
        params.sub_(velocity * float(lr))

    def run_round(self, params: torch.Tensor, weights: np.ndarray, round_number: int = 1) -> list:
        """One round of ``epoch * n_batches`` voted steps on the f32
        ``params`` in place, from a zero velocity and the schedule's start;
        returns each epoch's summed ``[loss_sum, correct, count]`` (on the
        device)."""
        schedule = self.engine.hyper_parameter.make_schedule(self.config.epoch * self.n_batches)
        velocity = torch.zeros_like(params)
        votes = self.new_votes(params.numel())
        w = torch.from_numpy(weights).to(self.device)
        if self._update_guard:
            self._rejected = torch.zeros((), device=self.device)
        generators = {
            slot: dropout_generator(self.config.seed, round_number, slot, self.device)
            for slot in range(self.n_slots)
            if weights[slot] != 0
        }
        epochs, step = [], 0
        for _ in range(self.config.epoch):
            summed = torch.zeros(3, device=self.device)
            for i in range(self.n_batches):
                direction = self.vote(params, votes, w, weights, i, generators, summed)
                self.update(params, velocity, direction, schedule(step))
                step += 1
            epochs.append(summed)
        return epochs

    def run(self) -> dict:
        config = self.config
        save_dir = os.path.join(config.save_dir, "server")
        os.makedirs(save_dir, exist_ok=True)
        params = self.engine.layout.flatten(
            {k: v.to(self.device, torch.float32) for k, v in self.engine.init_params(config.seed).items()}
        )
        best_acc = -1.0
        trace = self._trace
        horizon = self.round_horizon
        for round_number in range(1, config.round + 1):
            start = time.monotonic()
            # the JAX session's horizon chunk: [first, boundary]
            first = round_number - (round_number - 1) % horizon
            boundary = min(first + horizon - 1, config.round)
            if horizon > 1:
                program = f"horizon[h={boundary - first + 1}]"
            else:
                program = "run[gather]" if self._jax_gathers() else "run[dense]"
            if round_number == first:
                chunk_start = start
                trace.maybe_profile_start(first, boundary)
            weights = self.round_weights(round_number)
            epochs = self._watchdog.call(
                lambda w=weights, r=round_number: trace.dispatch(
                    program, self.run_round, (params, w, r), cost_args=(params, w, self._data)
                ),
                phase="round",
                round_number=round_number,
            )
            trace.event("dispatch", program="run", round=round_number)
            with trace.span("eval", round=round_number):
                metric = self._watchdog.call(lambda: self._evaluate(params), phase="eval", round_number=round_number)
            trace.event("dispatch", program="eval", round=round_number)
            trace.event("host_sync", round=round_number)
            trace.hbm_watermark(round_number)
            trace.count("rounds")
            sums = torch.stack(epochs).cpu().numpy()  # [epoch, 3] f32
            count = np.maximum(sums[:, 2], np.float32(1.0))
            extra = {
                "train_loss_per_epoch": (sums[:, 0] / count).tolist(),
                "train_accuracy_per_epoch": (sums[:, 1] / count).tolist(),
                "round_seconds": time.monotonic() - start,
            }
            rejected = 0
            if self._update_guard:
                # the vote guard's rejections over the round's steps
                rejected = extra["rejected_updates"] = float(self._rejected)
            self._trace_fault_event(round_number, rejected)
            self._note_round(round_number, metric, save_dir, extra)
            if round_number == boundary and horizon > 1:
                trace.span_record(
                    "horizon", time.monotonic() - chunk_start, first_round=first, last_round=boundary,
                    rounds=boundary - first + 1,
                )
            trace.flush()
            if round_number == boundary:
                trace.maybe_profile_stop(boundary)
            if metric["accuracy"] > best_acc:
                best_acc = metric["accuracy"]
                np.savez(
                    os.path.join(save_dir, "best_global_model.npz"),
                    **to_jax(self.engine.layout.split(params)),
                )
            if self._fault_plan is not None:
                self._flush_record()  # the killed run's rows land first
                self._fault_plan.maybe_kill(round_number)
        trace.close()
        get_logger().info(
            "sign_SGD: %d rounds of %d steps (torch)", config.round, config.epoch * self.n_batches
        )
        return {"performance": self._stat}
