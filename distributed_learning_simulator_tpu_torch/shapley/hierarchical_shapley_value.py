"""Hierarchical (two-level / Owen-style) Shapley value.

The reference ships only a config for this method
(``conf/hierarchical_sv/mnist.yaml``: ``part_number``, ``vp_size``; its
engine was removed from the snapshot — SURVEY.md §2.9).  Recreated from the
config surface as a two-level scheme with a-priori unions:

1. players are partitioned into ``part_number`` groups (round-robin; group
   size bounded by ``vp_size`` when given) — each group is one *virtual
   player*;
2. Shapley values are computed over the groups (metric of a set of groups =
   metric of the union of their members) — exactly up to
   ``exact_group_limit`` groups, by Monte-Carlo permutation sampling above;
3. within each group, member influence is measured *conditionally* — all
   other groups fully present — and the group's top-level value is split
   proportionally to each member's influence magnitude (stable even when
   signed intra-group marginals nearly cancel).

Metric-evaluation count drops from ``2^N`` to roughly
``2^G + G·2^(N/G)`` — the whole point of the hierarchy.
"""

import math
from collections.abc import Iterable

import numpy as np

from .base import ShapleyValueEngine, exact_shapley, monte_carlo_shapley


class HierarchicalShapleyValue(ShapleyValueEngine):
    def __init__(
        self,
        players: Iterable,
        last_round_metric: float = 0.0,
        part_number: int | None = None,
        vp_size: int | None = None,
        exact_group_limit: int = 10,
        mc_permutations: int = 0,
        seed: int = 0,
        **kwargs,
    ) -> None:
        super().__init__(players, last_round_metric)
        n = len(self.players)
        if part_number is None:
            if not vp_size:
                raise ValueError(
                    "Hierarchical_shapley_value needs algorithm_kwargs "
                    "part_number or vp_size (a positive group size)"
                )
            part_number = math.ceil(n / vp_size)
        if part_number <= 0:
            raise ValueError(f"part_number must be positive, got {part_number}")
        self.part_number = min(part_number, n)
        self.exact_group_limit = exact_group_limit
        self.mc_permutations = mc_permutations
        self._rng = np.random.default_rng(seed)
        self.groups: list[list] = [[] for _ in range(self.part_number)]
        for i, player in enumerate(self.players):
            self.groups[i % self.part_number].append(player)
        if vp_size is not None and any(len(g) > vp_size for g in self.groups):
            raise ValueError(
                f"{n} players in {self.part_number} groups exceeds "
                f"vp_size={vp_size}; raise part_number"
            )
        if max(len(g) for g in self.groups) > 12:
            raise ValueError(
                "intra-group exact SV over "
                f"{max(len(g) for g in self.groups)} members would blow up; "
                "use smaller groups (vp_size <= 12)"
            )

    def compute(self, round_number: int) -> None:
        group_ids = list(range(self.part_number))
        if getattr(self, "batch_metric_fn", None) is not None:
            # pre-evaluate every coalition the exact passes below will ask
            # for — one batched aggregate+infer program instead of
            # 2^part_number + Σ_g 2^|g| sequential ones
            import itertools

            wanted: list[set] = []
            if self.part_number <= self.exact_group_limit:
                for r in range(1, self.part_number + 1):
                    for combo in itertools.combinations(group_ids, r):
                        members: set = set()
                        for g in combo:
                            members.update(self.groups[g])
                        wanted.append(members)
            for g in group_ids:
                rest = {
                    p
                    for other in group_ids
                    if other != g
                    for p in self.groups[other]
                }
                for r in range(len(self.groups[g]) + 1):
                    for combo in itertools.combinations(self.groups[g], r):
                        subset = rest | set(combo)
                        if subset:
                            wanted.append(subset)
            self._metric_many(wanted)

        def group_metric(group_subset) -> float:
            members: set = set()
            for g in group_subset:
                members.update(self.groups[g])
            return self._metric(members)

        if self.part_number <= self.exact_group_limit:
            group_sv = exact_shapley(group_ids, group_metric)
        else:
            n_perms = self.mc_permutations or max(2 * self.part_number, 30)
            group_sv = monte_carlo_shapley(
                group_ids, group_metric, n_perms, self._rng
            )

        sv: dict = {}
        for g in group_ids:
            members = self.groups[g]
            rest: set = set()
            for other in group_ids:
                if other != g:
                    rest.update(self.groups[other])

            def member_metric(member_subset) -> float:
                return self._metric(rest | set(member_subset))

            intra = exact_shapley(members, member_metric)
            # split the group's value by influence magnitude: |intra| shares
            # are in [0, 1] and sum to 1, so a group whose signed marginals
            # nearly cancel cannot amplify member values
            denom = sum(abs(v) for v in intra.values())
            if denom < 1e-9:
                share = {m: 1.0 / len(members) for m in members}
            else:
                share = {m: abs(intra[m]) / denom for m in members}
            for m in members:
                sv[m] = group_sv[g] * share[m]

        # evaluate the full coalition so best-subset/last-round metrics exist
        self._metric(self.players)
        self._finish_round(round_number, sv)
