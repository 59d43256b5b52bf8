"""Search strategies for online exploration of the tuning space.

The paper's two-phase explorer (§3.3) is ONE strategy among several: the
Kernel Tuning Toolkit (arXiv:1910.08498) and "Tuning the Tuner"
(arXiv:2505.03979) both treat the searcher as an interchangeable component
behind a single propose/report API. This module provides that API:

  * :class:`SearchStrategy` — the protocol every searcher implements:
    ``next_point() -> Point | None`` (pull-based proposal; ``None`` when
    exhausted), ``peek(n)`` (upcoming proposals WITHOUT consuming them —
    the coordinator prefetch-compiles them while a measurement runs),
    ``report(point, score_s) -> bool`` (feed a measurement back; True
    when it is the new best) and the ``finished`` property. The base
    class centralizes seen-point deduplication (a strategy never
    re-proposes a point), best tracking, history, warm-start seed points,
    the peek buffer and the ``run_to_completion`` driver.
  * a **string-keyed registry** — strategies self-register under a name:

        @register_strategy("my_search")
        class MySearch(SearchStrategy):
            def _propose(self) -> Point | None: ...
            def _observe(self, point, score_s, improved) -> None: ...

    ``make_strategy("my_search", space, ...)`` then builds one, and every
    consumer (``OnlineAutotuner(strategy="my_search")``,
    ``static_autotune``, the ``TuningCoordinator``, the serve/train loops
    and their CLI ``--strategy`` flags) accepts the name with no further
    plumbing. Implement ``_propose`` (return a candidate or ``None``;
    duplicates are filtered by the base class, so proposing an
    already-seen point is safe and simply asks ``_propose`` again) and
    optionally ``_observe`` (react to a measurement, e.g. recenter a
    neighborhood).

Built-in strategies:

  * ``two_phase`` (:class:`TwoPhaseExplorer`, the default) — the paper's
    order: phase 1 explores structural parameters least→most switched,
    leftover-free variants first; phase 2 freezes the phase-1 winner and
    explores the remaining codegen options combinatorially.
  * ``random`` (:class:`RandomSearch`) — a deterministic shuffle of the
    valid points (seeded), the classic baseline that "Tuning the Tuner"
    shows is surprisingly hard to beat on small spaces.
  * ``greedy`` (:class:`GreedyNeighborhood`) — hill-climbing: vary one
    parameter at a time around the incumbent best, recenter on
    improvement, and restart from an unseen point at local optima (so
    small spaces are still covered exhaustively).
  * ``cost_model`` (:class:`CostModelSearch`) — model-based: rank the
    unexplored points by the compilette's analytical cost-model
    predictions, continuously recalibrated against observed scores
    (per-parameter-value residuals), so the cheapest-looking candidates
    are measured first and systematic model bias self-corrects.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import itertools
import json
import math
import random as _random
from typing import Any, Callable, Iterator, Sequence

from repro_torch.core.tuning_space import Point, TuningSpace


def point_stripe(point: Point, replica_count: int) -> int:
    """Deterministic stripe owner of a point in an N-replica fleet.

    Hash-stripes the point space: sha256 of the point's canonical JSON
    modulo ``replica_count``. Stable across processes and runs (unlike
    Python's randomized ``hash()``), independent of the space object, so
    every replica computes the same owner for the same point — the
    stripes are disjoint and jointly exhaustive by construction.
    """
    n = int(replica_count)
    if n < 1:
        raise ValueError(f"replica_count must be >= 1, got {replica_count}")
    canon = json.dumps(dict(point), sort_keys=True,
                       separators=(",", ":"), default=str)
    digest = hashlib.sha256(canon.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") % n


def _leftover_rank(space: TuningSpace, point: Point) -> float:
    """0 = leftover-free; larger = more leftover (explored later)."""
    res = space.no_leftover(point)
    if isinstance(res, bool):
        return 0.0 if res else 1.0
    # numeric "amount of leftover" → gradual softening order
    return float(res)


@dataclasses.dataclass
class ExplorerState:
    phase: int = 1
    n_proposed: int = 0
    n_reported: int = 0
    finished: bool = False


class SearchStrategy:
    """Base class for pull-based search strategies.

    The auto-tuner asks for ``next_point()`` only when the regeneration
    policy grants budget, and feeds results back through
    ``report(point, score_s)``. Subclasses implement ``_propose`` (and
    optionally ``_observe``); deduplication, best tracking and warm-start
    seeds are handled here.
    """

    name: str = "base"

    def __init__(
        self,
        space: TuningSpace,
        base_point: Point | None = None,
        seed_points: "Sequence[Point]" = (),
    ) -> None:
        self.space = space
        # Initial state of unexplored parameters: pre-profiled defaults.
        # A supplied base point is merged OVER the defaults and restricted
        # to known parameters, so a stale persisted point (from an older
        # space definition) degrades gracefully instead of producing
        # candidates with missing/unknown keys.
        base = space.default_point()
        for k, v in dict(base_point or {}).items():
            if k in base:
                base[k] = v
        if not space.is_valid(base):
            # The pre-profiled default (or a merged stale point) can be a
            # hole for small problem shapes — e.g. every block_k option
            # exceeding K. Fall back to the first valid point so the
            # reference variant is always generatable; a genuinely empty
            # space keeps the invalid base (exploration proposes nothing
            # and callers can detect it up front).
            fallback = next(iter(space.iter_valid()), None)
            if fallback is not None:
                base = fallback
        self.base_point: Point = base
        self.state = ExplorerState()
        self.best_point: Point | None = None
        self.best_score: float = float("inf")
        self.history: list[tuple[Point, float]] = []
        self._seen: set[tuple] = set()
        # quarantined points: rejected by the variant gate (wrong output),
        # rolled back by the canary, or failed to generate — never proposed
        # again and never reported as best (see ``quarantine``).
        self._quarantined: set[tuple] = set()
        # peek(n) buffer: upcoming proposals drawn ahead of consumption;
        # next_point() serves from here first, so peeked order == proposed
        # order (absent intervening reports that reshape the search).
        self._peeked: list[Point] = []
        # Warm-start: seed points (e.g. a persisted best from a previous
        # run) are proposed before any enumeration, so a warm process
        # re-validates its known-best variant with a single regeneration.
        self._seeds: list[Point] = [
            dict(p) for p in seed_points
            if space.contains(p) and space.is_valid(p)
        ]
        # Fleet partitioning (see ``partition``): None = whole space.
        self._replica: tuple[int, int] | None = None
        # Points exempt from the stripe filter: warm-start seeds (the
        # fleet best must stay re-validatable everywhere) and injected
        # peer candidates.
        self._stripe_exempt: set[tuple] = set()
        # Peer bests already injected (idempotence across syncs).
        self._injected: set[tuple] = set()

    # ---------------------------------------------------- subclass hooks
    def _propose(self) -> Point | None:
        """Next candidate (may repeat a seen point) or None when done."""
        raise NotImplementedError

    def _observe(self, point: Point, score_s: float, improved: bool) -> None:
        """React to a reported measurement (e.g. recenter a neighborhood)."""

    # ------------------------------------------------------------------ api
    def _owns(self, point: Point) -> bool:
        """Does this replica's stripe (or exemption list) cover ``point``?"""
        if self._replica is None:
            return True
        if self.space.key(point) in self._stripe_exempt:
            return True
        replica_id, replica_count = self._replica
        return point_stripe(point, replica_count) == replica_id

    def partition(self, replica_id: int, replica_count: int) -> None:
        """Restrict proposals to this replica's hash stripe of the space.

        The fleet idiom: N replicas sharing a registry backend each call
        ``partition(i, N)`` so exploration is paid once per fleet — every
        point is owned (proposed, compiled, measured) by exactly one
        replica, per :func:`point_stripe`. Foreign points are marked seen
        as they stream past, so ``peek`` never leaks them and restart
        scans terminate. Warm-start seeds and :meth:`inject_candidate`
        points are exempt: a fleet best must stay locally re-validatable
        (through the gate) on every replica.
        """
        replica_id, replica_count = int(replica_id), int(replica_count)
        if replica_count < 1 or not 0 <= replica_id < replica_count:
            raise ValueError(
                f"invalid partition ({replica_id}, {replica_count})")
        if replica_count == 1:
            self._replica = None
            return
        self._replica = (replica_id, replica_count)
        for p in self._seeds:
            self._stripe_exempt.add(self.space.key(p))
        # already-buffered foreign points must not be served
        if self._peeked:
            self._peeked = [p for p in self._peeked if self._owns(p)]

    def mark_seen(self, point: Point) -> bool:
        """Record a peer replica's evaluation: never propose this point.

        Purges it from the peek buffer even when already drawn into the
        seen-set (a buffered prefetch IS seen), so a pending prefetch
        cannot re-compile work a peer already paid for. An *injected*
        candidate is exempt: the fleet best is published alongside its
        own evaluation, and the peer's measurement must not cancel this
        replica's re-validation of it (a repeat sync would otherwise
        purge the pending candidate while :meth:`inject_candidate`'s
        dedup refuses to re-queue it — losing the adoption entirely).
        Returns True if the call changed anything (newly marked or
        purged).
        """
        key = self.space.key(point)
        if key in self._injected:
            return False
        purged = False
        if self._peeked:
            kept = [p for p in self._peeked if self.space.key(p) != key]
            purged = len(kept) != len(self._peeked)
            self._peeked = kept
        if key in self._seen:
            return purged
        self._seen.add(key)
        return True

    def inject_candidate(self, point: Point) -> bool:
        """Queue an externally supplied candidate (a peer's published best).

        The point jumps the proposal queue and bypasses the seen-set
        (peer evaluations mark it seen, yet it must stay proposable
        here) — but it still flows through the normal generate/evaluate/
        gate/canary path, entering as CANDIDATE, never blind INCUMBENT.
        Idempotent per point; quarantined, locally measured or already
        queued points are refused. Returns True when queued.
        """
        if not (self.space.contains(point) and self.space.is_valid(point)):
            return False
        key = self.space.key(point)
        if key in self._quarantined or key in self._injected:
            return False
        if any(self.space.key(p) == key for p, _ in self.history):
            return False   # already measured locally
        if any(self.space.key(p) == key for p in self._peeked):
            return False   # already pending proposal
        self._injected.add(key)
        self._stripe_exempt.add(key)
        self._seen.add(key)
        self._peeked.insert(0, dict(point))
        self.state.finished = False   # an exhausted search has new work
        return True

    def _draw(self) -> Point | None:
        """Pull one deduplicated, valid, stripe-owned candidate."""
        while True:
            point = self._propose()
            if point is None:
                return None
            key = self.space.key(point)
            if key in self._seen:
                continue
            if not self._owns(point):
                # another replica's point: swallow it (counting it seen
                # keeps restart scans terminating) and ask again
                self._seen.add(key)
                continue
            self._seen.add(key)
            return point

    def next_point(self) -> Point | None:
        """Next variant to generate+evaluate, or None when done.

        Never yields the same point twice (``_propose`` duplicates are
        swallowed here) and never yields a hole. Points surfaced by a
        prior :meth:`peek` are served first, in peeked order.
        """
        if self.state.finished:
            return None
        if self._peeked:
            point = self._peeked.pop(0)
        else:
            point = self._draw()
            if point is None:
                self.state.finished = True
                return None
        self.state.n_proposed += 1
        return dict(point)

    def peek(self, n: int = 1) -> list[Point]:
        """Upcoming proposals WITHOUT consuming them (speculative prefetch).

        Returns up to ``n`` points that subsequent :meth:`next_point`
        calls will yield (in order, provided no intervening ``report``
        reshapes the search — a recentering strategy may then serve the
        already-peeked points before its new neighborhood). Peeking past
        the end of the space returns fewer points but does NOT mark the
        strategy finished: buffered points are still pending proposal.
        The coordinator uses this to compile the next 1–2 candidates in
        the background while the current measurement runs.
        """
        if self.state.finished:
            return []
        while len(self._peeked) < n:
            point = self._draw()
            if point is None:
                break
            self._peeked.append(point)
        return [dict(p) for p in self._peeked[:n]]

    def report(self, point: Point, score_s: float) -> bool:
        """Feed a measurement back; returns True if it is the new best."""
        self.state.n_reported += 1
        self.history.append((dict(point), score_s))
        improved = score_s < self.best_score
        if improved:
            self.best_score = score_s
            self.best_point = dict(point)
        self._observe(point, score_s, improved)
        return improved

    def quarantine(self, point: Point) -> None:
        """Mark ``point`` untrusted: never re-propose, never call it best.

        Idempotent. The point joins the seen set (so ``_propose``
        duplicates are swallowed and restart scans skip it), is purged
        from the peek buffer, and — if it currently holds the best slot —
        the best is recomputed from the reported history excluding every
        quarantined point, so a registry flush after a rollback persists
        the best *trusted* point.
        """
        key = self.space.key(point)
        self._quarantined.add(key)
        self._seen.add(key)
        if self._peeked:
            self._peeked = [
                p for p in self._peeked if self.space.key(p) != key]
        if (self.best_point is not None
                and self.space.key(self.best_point) == key):
            self.best_point, self.best_score = None, float("inf")
            for p, s in self.history:
                if self.space.key(p) in self._quarantined:
                    continue
                if s < self.best_score:
                    self.best_score, self.best_point = s, dict(p)

    def is_quarantined(self, point: Point) -> bool:
        return self.space.key(point) in self._quarantined

    @property
    def n_quarantined(self) -> int:
        return len(self._quarantined)

    @property
    def finished(self) -> bool:
        return self.state.finished

    def run_to_completion(
        self, evaluate, max_points: int | None = None
    ) -> tuple[Point | None, float]:
        """Exhaust the exploration with ``evaluate(point) -> seconds``.

        Used by the static tuner and the simulated-platform studies; the
        online auto-tuner instead paces itself with the regeneration policy.
        """
        n = 0
        while max_points is None or n < max_points:
            point = self.next_point()
            if point is None:
                break
            self.report(point, evaluate(point))
            n += 1
        return self.best_point, self.best_score


# --------------------------------------------------------------- registry
STRATEGIES: dict[str, type[SearchStrategy]] = {}


def register_strategy(name: str) -> Callable[[type], type]:
    """Class decorator: register a :class:`SearchStrategy` under ``name``."""

    def deco(cls: type) -> type:
        cls.name = name
        STRATEGIES[name] = cls
        return cls

    return deco


def available_strategies() -> tuple[str, ...]:
    return tuple(sorted(STRATEGIES))


def strategy_accepts(strategy: str, param: str) -> bool:
    """Does the named strategy's constructor take keyword ``param``?

    Lets callers wire optional capabilities (e.g. a compilette cost
    model as ``cost_fn``) only into strategies that can exploit them,
    without every strategy having to swallow ``**kwargs``.
    """
    cls = STRATEGIES.get(strategy)
    if cls is None:
        return False
    return param in inspect.signature(cls.__init__).parameters


def make_strategy(
    strategy: "str | SearchStrategy",
    space: TuningSpace,
    *,
    base_point: Point | None = None,
    seed_points: Sequence[Point] = (),
    **kwargs: Any,
) -> SearchStrategy:
    """Resolve a strategy name (or pass through an instance)."""
    if not isinstance(strategy, str):
        return strategy
    try:
        cls = STRATEGIES[strategy]
    except KeyError:
        raise ValueError(
            f"unknown search strategy {strategy!r}; "
            f"available: {', '.join(available_strategies())}"
        ) from None
    return cls(space, base_point=base_point, seed_points=seed_points, **kwargs)


# -------------------------------------------------------------- two-phase
@register_strategy("two_phase")
class TwoPhaseExplorer(SearchStrategy):
    """The paper's two-phase exploration (§3.3), the default strategy.

    Phase 1 explores the parameters that change the *structure* of the
    code (unrolling factors, vector length, vectorization), in order from
    the least switched to the most switched parameter; variants with no
    leftover code first, then gradually softening. Phase 2 freezes the
    best phase-1 parameters and explores the combinatorial choices of the
    remaining codegen options.
    """

    def __init__(
        self,
        space: TuningSpace,
        base_point: Point | None = None,
        seed_points: "Sequence[Point]" = (),
    ) -> None:
        super().__init__(space, base_point=base_point, seed_points=seed_points)
        self._phase1_iter = self._make_phase1_iter()
        self._phase2_iter: Iterator[Point] | None = None
        self._peek_holds_phase = False

    def peek(self, n: int = 1) -> list[Point]:
        """Peek, but never across an undetermined phase boundary.

        Phase 2 enumerates around the phase-1 *best*; while phase-1
        measurements are outstanding that best is not yet decided, and a
        peeked phase-2 candidate would be pinned to a stale incumbent
        (the coordinator's prefetch peeks routinely, so this is a live
        production path, not a test artifact). Returning fewer points is
        always legal for peek; the boundary is crossed on the next peek
        or proposal after the last phase-1 report lands.
        """
        self._peek_holds_phase = True
        try:
            return super().peek(n)
        finally:
            self._peek_holds_phase = False

    def _make_phase1_iter(self) -> Iterator[Point]:
        # Enumerate in least→most switched order, then stable-sort by
        # leftover rank: leftover-free first, gradually softening.
        candidates = [
            p for p in self.space.iter_phase1(self.base_point)
            if self.space.is_valid(p)
        ]
        candidates.sort(key=lambda p: _leftover_rank(self.space, p))
        return itertools.chain(iter(self._seeds), iter(candidates))

    def _make_phase2_iter(self) -> Iterator[Point]:
        assert self.best_point is not None
        candidates = [
            p for p in self.space.iter_phase2(self.best_point)
            if self.space.is_valid(p)
        ]
        return iter(candidates)

    def _propose(self) -> Point | None:
        while True:
            it = (self._phase1_iter if self.state.phase == 1
                  else self._phase2_iter)
            assert it is not None
            try:
                return next(it)
            except StopIteration:
                if self.state.phase == 1:
                    outstanding = (self.state.n_proposed + len(self._peeked)
                                   > self.state.n_reported)
                    if self._peek_holds_phase and outstanding:
                        # peek stops at the boundary (see peek docstring)
                        return None
                    if self.best_point is None:
                        # nothing valid at all
                        return None
                    self.state.phase = 2
                    self._phase2_iter = self._make_phase2_iter()
                    continue
                return None


# ----------------------------------------------------------------- random
@register_strategy("random")
class RandomSearch(SearchStrategy):
    """Uniform random order over the valid points (deterministic seed).

    Seed points are proposed first (warm start), then the remaining valid
    points in a seeded shuffle. On small spaces this is exhaustive; on
    large spaces it is the classic unbiased baseline.
    """

    def __init__(
        self,
        space: TuningSpace,
        base_point: Point | None = None,
        seed_points: "Sequence[Point]" = (),
        *,
        rng_seed: int = 0,
    ) -> None:
        super().__init__(space, base_point=base_point, seed_points=seed_points)
        candidates = list(space.iter_valid())
        _random.Random(rng_seed).shuffle(candidates)
        self._iter: Iterator[Point] = itertools.chain(
            iter(self._seeds), iter(candidates))

    def _propose(self) -> Point | None:
        return next(self._iter, None)


# ----------------------------------------------------------------- greedy
@register_strategy("greedy")
class GreedyNeighborhood(SearchStrategy):
    """Hill-climb over one parameter at a time.

    Starting from the base point (or a warm-start seed), propose every
    single-parameter variation of the incumbent best; whenever a
    measurement improves the best, the neighborhood recenters there. At a
    local optimum (no unseen neighbor left) the search restarts from the
    first unseen valid point, so a small space is still covered
    exhaustively and the strategy converges to the global optimum on it.
    """

    def __init__(
        self,
        space: TuningSpace,
        base_point: Point | None = None,
        seed_points: "Sequence[Point]" = (),
    ) -> None:
        super().__init__(space, base_point=base_point, seed_points=seed_points)
        self._queue: list[Point] = list(self._seeds)
        if space.is_valid(self.base_point):
            self._queue.append(dict(self.base_point))
        self._frontier_key: tuple | None = None   # neighborhood already queued

    def _neighbors(self, point: Point) -> Iterator[Point]:
        for p in self.space.params:
            for v in p.values:
                if v == point[p.name]:
                    continue
                q = dict(point)
                q[p.name] = v
                if self.space.is_valid(q):
                    yield q

    def _observe(self, point: Point, score_s: float, improved: bool) -> None:
        if improved:
            # recenter: pending neighbors of the old incumbent are stale
            # (any still-unseen ones are recovered by the restart scan)
            self._queue.clear()

    def _propose(self) -> Point | None:
        while True:
            if self._queue:
                return self._queue.pop(0)
            if self.best_point is not None:
                key = self.space.key(self.best_point)
                if key != self._frontier_key:
                    self._frontier_key = key
                    self._queue.extend(
                        q for q in self._neighbors(self.best_point)
                        if self.space.key(q) not in self._seen
                    )
                    if self._queue:
                        continue
            # local optimum (or nothing measured yet): restart from the
            # first unseen valid point, if any
            for q in self.space.iter_valid():
                if self.space.key(q) not in self._seen:
                    return q
            return None


# ------------------------------------------------------------- cost model
@register_strategy("cost_model")
class CostModelSearch(SearchStrategy):
    """Model-based search: measure the cheapest-*predicted* points first.

    Every valid point is priced once by ``cost_fn`` (the compilette's
    analytical cost model — ``OnlineAutotuner`` wires it automatically
    when the compilette carries one); proposals then pop the pending
    point with the lowest *calibrated* prediction. Calibration is a
    per-parameter-value residual table: each finite observation records
    ``ln(observed / predicted)`` against every ``(param, value)`` the
    point contains, and pending predictions are scaled by the mean
    residual of their own values — so a model that systematically
    mis-prices, say, ``unroll=8`` sinks those candidates without
    touching the rest of the ranking. Without a ``cost_fn`` the
    strategy degrades to deterministic enumeration order. Either way
    the whole space is eventually proposed (exhaustive on small
    spaces), seeds first, fully deterministic.
    """

    def __init__(
        self,
        space: TuningSpace,
        base_point: Point | None = None,
        seed_points: "Sequence[Point]" = (),
        *,
        cost_fn: Callable[[Point], float] | None = None,
    ) -> None:
        super().__init__(space, base_point=base_point, seed_points=seed_points)
        self._cost_fn = cost_fn
        self._seed_queue: list[Point] = [dict(p) for p in self._seeds]
        seed_keys = {space.key(p) for p in self._seeds}
        # pending: every valid point not yet proposed, keyed for O(1)
        # removal; _rank breaks prediction ties by enumeration order so
        # the proposal sequence is a pure function of the observations
        self._pending: dict[tuple, Point] = {}
        self._rank: dict[tuple, int] = {}
        self._predicted: dict[tuple, float] = {}
        for i, p in enumerate(space.iter_valid()):
            key = space.key(p)
            if key in self._pending or key in seed_keys:
                continue
            self._pending[key] = dict(p)
            self._rank[key] = i
            self._predicted[key] = self._predict(p)
        # calibration: per (param, canonical value) running mean of
        # ln(observed / predicted) over finite observations
        self._resid_sum: dict[tuple[str, str], float] = {}
        self._resid_n: dict[tuple[str, str], int] = {}

    def _predict(self, point: Point) -> float:
        if self._cost_fn is None:
            return 0.0   # no model: constant prediction = enumeration order
        try:
            pred = float(self._cost_fn(dict(point)))
        except Exception:
            return float("inf")
        return pred if math.isfinite(pred) and pred > 0.0 else float("inf")

    def _value_keys(self, point: Point) -> list[tuple[str, str]]:
        return [(str(k), json.dumps(v, sort_keys=True, default=str))
                for k, v in sorted(dict(point).items())]

    def _calibrated(self, key: tuple, point: Point) -> float:
        pred = self._predicted.get(key, float("inf"))
        if not math.isfinite(pred):
            return pred
        factors = [self._resid_sum[vk] / self._resid_n[vk]
                   for vk in self._value_keys(point)
                   if self._resid_n.get(vk)]
        if not factors:
            return pred
        return pred * math.exp(sum(factors) / len(factors))

    def _observe(self, point: Point, score_s: float, improved: bool) -> None:
        if self._cost_fn is None:
            return
        if not (isinstance(score_s, (int, float)) and math.isfinite(score_s)
                and score_s > 0.0):
            return
        pred = self._predict(point)
        if not math.isfinite(pred):
            return
        residual = math.log(float(score_s) / pred)
        for vk in self._value_keys(point):
            self._resid_sum[vk] = self._resid_sum.get(vk, 0.0) + residual
            self._resid_n[vk] = self._resid_n.get(vk, 0) + 1

    def _propose(self) -> Point | None:
        if self._seed_queue:
            return self._seed_queue.pop(0)
        if not self._pending:
            return None
        key = min(
            self._pending,
            key=lambda k: (self._calibrated(k, self._pending[k]),
                           self._rank[k]))
        return self._pending.pop(key)
