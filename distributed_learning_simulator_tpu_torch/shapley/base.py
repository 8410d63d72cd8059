"""Shapley-value engine base (the port's ``shapley/base.py``, a copy of the
JAX package's: the engines are pure host logic, so the two packages'
engines give equal values for one metric function).

Equivalents of the reference's external SV engines
(``cyy_torch_algorithm.shapely_value``; surface per SURVEY.md §2.13: ctor
``(players, last_round_metric)``, ``set_metric_function(cb)``,
``compute(round_number)``, ``.shapley_values``, ``.shapley_values_S``).  The
metric callback re-aggregates a player subset and runs central inference —
the session evaluates a batch of subsets per call; the engine itself is
pure host logic with per-round subset-metric caching.
"""

from collections.abc import Callable, Iterable


def exact_shapley(players: list, metric: Callable[[set], float]) -> dict:
    """Textbook exact SV (≤ ~12 players) with a cached metric callable."""
    import itertools
    import math

    n = len(players)
    sv = {p: 0.0 for p in players}
    for player in players:
        others = [p for p in players if p != player]
        for r in range(n):
            coeff = math.factorial(r) * math.factorial(n - r - 1) / math.factorial(n)
            for subset in itertools.combinations(others, r):
                marginal = metric(set(subset) | {player}) - metric(set(subset))
                sv[player] += coeff * marginal
    return sv


def monte_carlo_shapley(
    players: list, metric: Callable[[set], float], n_permutations: int, rng
) -> dict:
    """Permutation-sampling SV estimate for player counts where exact
    enumeration blows up."""
    contributions = {p: 0.0 for p in players}
    for _ in range(n_permutations):
        perm = list(players)
        rng.shuffle(perm)
        prefix: set = set()
        prev = metric(prefix)
        for player in perm:
            prefix = prefix | {player}
            current = metric(prefix)
            contributions[player] += current - prev
            prev = current
    return {p: v / n_permutations for p, v in contributions.items()}


class ShapleyValueEngine:
    def __init__(self, players: Iterable, last_round_metric: float = 0.0) -> None:
        self.players: list = sorted(players)
        self.last_round_metric = float(last_round_metric)
        self.metric_fn: Callable[[Iterable], float] | None = None
        # round -> {player: sv}
        self.shapley_values: dict[int, dict] = {}
        # round -> {player: sv} restricted to the best-metric subset
        self.shapley_values_S: dict[int, dict] = {}
        self._cache: dict[frozenset, float] = {}
        # subsets the SEQUENTIAL evaluation order actually visits — the
        # batched prefetch fills ``_cache`` with prefixes a truncated walk
        # never evaluates, and the best-subset pick must not see those
        # (``choose_best_subset`` must behave identically on both paths)
        self._considered: set[frozenset] = set()

    def set_metric_function(self, fn: Callable[[Iterable], float]) -> None:
        self.metric_fn = fn

    def set_batch_metric_function(self, fn: Callable[[list], list]) -> None:
        """Optional fast path: evaluate MANY subsets in one call (the
        session aggregates and evaluates them in one pass — SURVEY.md §7
        hard-part 4 'batch subset evals')."""
        self.batch_metric_fn = fn

    def _metric_many(self, subsets: Iterable[Iterable]) -> None:
        """Populate the cache for all ``subsets`` at once when a batch
        metric is available; falls back to sequential calls."""
        missing = sorted(
            {frozenset(s) for s in subsets if s} - set(self._cache),
            key=sorted,
        )
        if not missing:
            return
        batch_fn = getattr(self, "batch_metric_fn", None)
        if batch_fn is None:
            for subset in missing:
                self._metric(subset)
            return
        values = batch_fn([tuple(sorted(s)) for s in missing])
        for subset, value in zip(missing, values):
            self._cache[subset] = float(value)

    def _metric(self, subset: Iterable) -> float:
        key = frozenset(subset)
        if not key:
            return self.last_round_metric
        self._considered.add(key)
        if key not in self._cache:
            assert self.metric_fn is not None
            self._cache[key] = float(self.metric_fn(tuple(sorted(key))))
        return self._cache[key]

    def _best_subset(self) -> frozenset:
        candidates = self._considered or set(self._cache)
        if not candidates:
            return frozenset()
        # deterministic tie-break (value, then lexicographic members) so the
        # pick cannot depend on cache-insertion order
        return max(
            candidates,
            key=lambda k: (self._cache[k], tuple(sorted(k, reverse=True))),
        )

    def compute(self, round_number: int) -> None:
        raise NotImplementedError

    def _finish_round(self, round_number: int, sv: dict) -> None:
        self.shapley_values[round_number] = dict(sv)
        best = self._best_subset()
        self.shapley_values_S[round_number] = {
            player: sv.get(player, 0.0) for player in sorted(best)
        }
        full_metric = self._cache.get(frozenset(self.players))
        if full_metric is not None:
            self.last_round_metric = full_metric
        self._cache.clear()
        self._considered.clear()
