"""Multi-round Shapley value (Song et al. style): per-round SV by exact
enumeration for small player counts, Monte-Carlo permutations otherwise
(reference surface: ``cyy_torch_algorithm.shapely_value.multiround_shapley_value``)."""

import numpy as np

from .base import ShapleyValueEngine, exact_shapley


class MultiRoundShapleyValue(ShapleyValueEngine):
    def __init__(
        self,
        players,
        last_round_metric: float = 0.0,
        exact_player_limit: int = 8,
        mc_permutations: int = 0,
        seed: int = 0,
    ) -> None:
        super().__init__(players, last_round_metric)
        self.exact_player_limit = exact_player_limit
        self.mc_permutations = mc_permutations
        self._rng = np.random.default_rng(seed)

    def compute(self, round_number: int) -> None:
        players = self.players
        n = len(players)
        if n <= self.exact_player_limit:
            sv = self._exact(players)
        else:
            sv = self._monte_carlo(players)
        # evaluate the full coalition so best-subset/last-round metrics exist
        self._metric(players)
        self._finish_round(round_number, sv)

    def _exact(self, players: list) -> dict:
        # all 2^n - 1 coalition metrics are known upfront — evaluate them as
        # one batched program instead of 2^n sequential aggregate+infer runs
        import itertools

        self._metric_many(
            set(subset)
            for r in range(1, len(players) + 1)
            for subset in itertools.combinations(players, r)
        )
        return exact_shapley(players, self._metric)

    def _monte_carlo(self, players: list) -> dict:
        n_perms = self.mc_permutations or max(2 * len(players), 30)
        # plain (non-truncated) permutation sampling touches every prefix of
        # every sampled permutation — also batchable upfront
        perms = [list(self._rng.permutation(players)) for _ in range(n_perms)]
        self._metric_many(
            {frozenset(perm[: i + 1]) for perm in perms for i in range(len(perm))}
        )
        contributions = {p: 0.0 for p in players}
        for perm in perms:
            prefix: set = set()
            prev = self._metric(prefix) if prefix else self.last_round_metric
            for player in perm:
                prefix = prefix | {player}
                current = self._metric(prefix)
                contributions[player] += current - prev
                prev = current
        return {p: v / n_perms for p, v in contributions.items()}
