"""GTG-Shapley: Guided Truncation Gradient Shapley for FL participant
contribution (Liu et al., the paper behind the reference's
``gtg_shapley_train.sh`` workload).

Monte-Carlo permutation sampling with:

* **between-round truncation** — if this round's full-coalition metric moved
  less than ``round_trunc_threshold`` from last round, all SVs are 0;
* **within-permutation truncation** — once the running coalition's metric is
  within ``eps`` of the full-coalition metric, remaining marginals are 0;
* **guided sampling** — permutations are seeded round-robin so each player
  leads equally often;
* **convergence check** — stop when the rolling change of the SV estimate
  drops under ``convergence_threshold``.
"""

import itertools

import numpy as np

from ..utils.logging import get_logger
from .base import ShapleyValueEngine


class GTGShapleyValue(ShapleyValueEngine):
    def __init__(
        self,
        players,
        last_round_metric: float = 0.0,
        eps: float = 0.001,
        round_trunc_threshold: float = 0.001,
        convergence_threshold: float = 0.05,
        max_percentage_of_permutations: float = 1.0,
        seed: int = 0,
    ) -> None:
        super().__init__(players, last_round_metric)
        self.eps = eps
        self.round_trunc_threshold = round_trunc_threshold
        self.convergence_threshold = convergence_threshold
        self.max_percentage_of_permutations = max_percentage_of_permutations
        self._rng = np.random.default_rng(seed)

    #: runaway safety valve, NOT a sampling budget — the real stops are
    #: ``convergence_threshold`` and ``max_percentage_of_permutations``
    PERMUTATION_CEILING = 10_000

    def _max_permutations(self) -> int:
        n = len(self.players)
        total = 1
        for i in range(2, n + 1):
            total *= i
            if total > self.PERMUTATION_CEILING:
                break
        total = min(total, self.PERMUTATION_CEILING)
        return max(n, int(total * self.max_percentage_of_permutations))

    def compute(self, round_number: int) -> None:
        players = self.players
        n = len(players)
        full_metric = self._metric(players)
        if abs(full_metric - self.last_round_metric) <= self.round_trunc_threshold:
            get_logger().info(
                "round %s truncated (Δmetric %.5f)",
                round_number,
                full_metric - self.last_round_metric,
            )
            self._finish_round(round_number, {p: 0.0 for p in players})
            return

        contributions = {p: 0.0 for p in players}
        count = 0
        prev_estimate = None
        max_perms = self._max_permutations()
        for k in range(max_perms):
            perm = list(players)
            self._rng.shuffle(perm)
            # guided: rotate so player k%n leads
            lead = players[k % n]
            perm.remove(lead)
            perm.insert(0, lead)

            if getattr(self, "batch_metric_fn", None) is not None:
                # one program evaluates the whole permutation's prefixes;
                # the truncation rule below replays the sequential decisions
                # from the cached values, so the SVs are identical — and so
                # is ``choose_best_subset``: only prefixes the sequential
                # walk actually visits enter ``_considered``, never the
                # extra prefetched ones.  Only when a batch evaluator
                # exists — the sequential fallback would defeat
                # truncation's point
                self._metric_many(
                    {frozenset(perm[: i + 1]) for i in range(len(perm))}
                )
            v_prev = self.last_round_metric
            coalition: list = []
            truncated = False
            for player in perm:
                coalition.append(player)
                if truncated or abs(full_metric - v_prev) <= self.eps:
                    truncated = True
                    marginal = 0.0
                else:
                    v_cur = self._metric(coalition)
                    marginal = v_cur - v_prev
                    v_prev = v_cur
                contributions[player] += marginal
            count += 1

            estimate = np.array([contributions[p] / count for p in players])
            if prev_estimate is not None and count >= n:
                change = float(
                    np.abs(estimate - prev_estimate).sum()
                    / max(float(np.abs(estimate).sum()), 1e-12)
                )
                if change < self.convergence_threshold:
                    break
            prev_estimate = estimate

        sv = {p: contributions[p] / max(count, 1) for p in players}
        self._finish_round(round_number, sv)
