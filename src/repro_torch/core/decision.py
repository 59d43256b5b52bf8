"""Regeneration decision (paper §3.3, extended for serving).

Two factors decide whether the auto-tuning thread may generate+evaluate a
new variant when it wakes up:

  * **overhead budget** — total tuning time (generation + evaluation) must
    stay below ``max_overhead_frac`` of the application time elapsed so
    far. This bounds the cost when tuning never finds anything better
    (paper: 0.2–4.2 % observed).
  * **investment factor** — a fraction ``invest_frac`` of the *time gained*
    by previously found variants may be re-invested into further
    exploration (paper: e.g. invest 10 % of gained time).

Gain estimation (paper §3.3): the only instrumentation is a counter of
kernel invocations; gained time = calls_since_swap × (t_reference − t_active)
accumulated over active-kernel lifetimes. Reference and variants are timed
once each, so gains are estimates, acceptable per the paper.

Serving extensions (the paper tunes a busy batch process; a server idles):

  * ``budget_from="busy"`` budgets from **busy time** — kernel-call time
    actually observed (calls × per-call score, same instrumentation-light
    estimate as gains) — instead of lifetime wall-clock, so a long-idle
    server accrues no budget it could burst onto one request.
  * ``charge_init=True`` charges the register()-time reference measurement
    (``init_spent_s``) against the budget: on a request path that init
    work is tuning overhead like any other.
  * an optional :class:`LatencyHeadroomGate` skips regeneration when the
    per-call latency headroom under an SLO is too thin to absorb one more
    generate+evaluate cycle.
"""

from __future__ import annotations

import dataclasses
import math


class LatencyHistogram:
    """Fixed-bucket log-latency histogram for tail (p99) estimation.

    The per-call cost EWMA answers "what does a typical call cost?"; an SLO is a
    statement about the *tail*, so the headroom gate needs a quantile
    estimate. Buckets are geometric (``buckets_per_decade`` per 10x), so
    the memory footprint is fixed (~one small int array) regardless of
    sample count, and a quantile is exact up to one bucket's relative
    width (~15% at the default 16 buckets/decade) — plenty for a gate
    whose threshold is a fraction of the SLO.
    """

    def __init__(
        self,
        lo_s: float = 1e-7,
        hi_s: float = 1e3,
        buckets_per_decade: int = 16,
    ) -> None:
        if not (0 < lo_s < hi_s):
            raise ValueError(f"need 0 < lo_s < hi_s, got {lo_s}, {hi_s}")
        self.lo_s = float(lo_s)
        self.buckets_per_decade = int(buckets_per_decade)
        decades = math.log10(hi_s / lo_s)
        # + 2: one underflow bucket (index 0) and one overflow bucket
        self._n = int(math.ceil(decades * self.buckets_per_decade)) + 2
        self._counts = [0] * self._n
        self.count = 0

    def _index(self, s: float) -> int:
        if s <= self.lo_s:
            return 0
        i = 1 + int(math.log10(s / self.lo_s) * self.buckets_per_decade)
        return min(i, self._n - 1)

    def _bucket_value(self, i: int) -> float:
        """Geometric midpoint of bucket ``i`` (its representative value)."""
        if i <= 0:
            return self.lo_s
        r = 10.0 ** (1.0 / self.buckets_per_decade)
        return self.lo_s * r ** (i - 0.5)

    def observe(self, s: float) -> None:
        if s < 0:
            return
        self._counts[self._index(s)] += 1
        self.count += 1

    def quantile(self, q: float) -> float:
        """Latency at quantile ``q`` (0 < q <= 1); 0.0 with no samples."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                return self._bucket_value(i)
        return self._bucket_value(self._n - 1)


@dataclasses.dataclass
class TuningAccounts:
    """Mutable accounting state shared with the auto-tuner."""

    app_start_s: float = 0.0            # perf_counter at app start
    tuning_spent_s: float = 0.0         # total generation+evaluation time
    gen_spent_s: float = 0.0            # generation (compile) component of
                                        # tuning_spent_s — charged in full
                                        # even when compilation overlapped
                                        # the hot path (async pipeline)
    gen_stall_s: float = 0.0            # generation time the hot path
                                        # actually WAITED for (synchronous
                                        # compiles); 0 for cache hits and
                                        # async-overlapped generations
    eval_spent_s: float = 0.0           # measurement component
    gen_requests: int = 0               # async generations requested
    init_spent_s: float = 0.0           # reference baseline measurement
                                        # (budgeted only when the policy
                                        # sets charge_init)
    gained_s: float = 0.0               # estimated saved time so far
    busy_s: float = 0.0                 # estimated kernel-call time observed
                                        # (calls x per-call score)
    observed_call_s: float = 0.0        # per-call latency fed to the
                                        # headroom gate: an EWMA of real
                                        # call latencies when the tuner is
                                        # coordinator-managed (ManagedTuner
                                        # times every call), else the
                                        # active kernel's measured score
    observed_tail_s: float = 0.0        # tail (histogram-quantile) per-call
                                        # latency at the headroom gate's
                                        # slo_quantile; 0 until samples
                                        # exist. Read instead of the EWMA
                                        # by quantile-configured gates.
    kernel_calls: int = 0               # invocation counter (instrumentation)
    regenerations: int = 0              # variants generated+evaluated
    swaps: int = 0                      # active-function replacements
    # --- trusted swaps (gate + canary state machine) -------------------
    gate_spent_s: float = 0.0           # oracle-check component of
                                        # tuning_spent_s (one variant
                                        # execution + comparison per check)
    gate_checks: int = 0                # oracle checks performed
    gate_failures: int = 0              # variants the oracle rejected
    canary_calls: int = 0               # production calls served by a
                                        # canary (not yet promoted) variant
    canary_promotions: int = 0          # canaries promoted to incumbent
    rollbacks: int = 0                  # canaries rolled back (tail
                                        # regression or raised exception)
    quarantined: int = 0                # points quarantined (gate failure,
                                        # rollback, or generation failure)


@dataclasses.dataclass(frozen=True)
class LatencyHeadroomGate:
    """SLO-aware regeneration gate for latency-critical paths.

    ``slo_s`` is the per-call latency objective of the tuned kernel (e.g.
    the per-token decode budget). Regeneration is allowed only when the
    active kernel leaves at least ``min_headroom_frac`` of the SLO as
    headroom AND the next generate+evaluate cycle is estimated to fit in
    that headroom — so tuning never lands on a request that is already
    close to its SLO.

    ``slo_quantile`` makes the gate tail-aware: instead of the per-call
    EWMA it reads the :class:`LatencyHistogram` quantile recorded in
    ``accounts.observed_tail_s`` (e.g. ``slo_quantile=0.99`` gates on
    p99), so a kernel whose *mean* is comfortable but whose tail already
    grazes the SLO is frozen — and an isolated mean-inflating outlier in
    an otherwise-tight tail is not double counted.
    """

    slo_s: float
    min_headroom_frac: float = 0.25
    slo_quantile: float | None = None   # e.g. 0.99: gate on tail latency

    def allows(
        self, observed_call_s: float, next_cost_estimate_s: float
    ) -> bool:
        if self.slo_s <= 0.0:
            return True
        headroom_s = self.slo_s - observed_call_s
        if headroom_s < self.min_headroom_frac * self.slo_s:
            return False
        return next_cost_estimate_s <= headroom_s


@dataclasses.dataclass(frozen=True)
class RegenerationPolicy:
    """Paper's two-factor budget: overhead limit + investment of gains."""

    max_overhead_frac: float = 0.01     # e.g. 1 % of app runtime
    invest_frac: float = 0.10           # e.g. reinvest 10 % of gained time
    budget_from: str = "wall"           # "wall" (paper) | "busy" (serving)
    charge_init: bool = False           # budget the reference measurement
    headroom: LatencyHeadroomGate | None = None

    def __post_init__(self) -> None:
        if self.budget_from not in ("wall", "busy"):
            raise ValueError(
                f"budget_from must be 'wall' or 'busy', "
                f"got {self.budget_from!r}")

    def budget_s(self, accounts: TuningAccounts, now_s: float) -> float:
        """Time the tuner is currently allowed to have spent in total."""
        if self.budget_from == "busy":
            elapsed = max(accounts.busy_s, 0.0)
        else:
            elapsed = max(now_s - accounts.app_start_s, 0.0)
        base = self.max_overhead_frac * elapsed
        investment = self.invest_frac * max(accounts.gained_s, 0.0)
        return base + investment

    def spent_s(self, accounts: TuningAccounts) -> float:
        """Tuning time charged against the budget."""
        spent = accounts.tuning_spent_s
        if self.charge_init:
            spent += accounts.init_spent_s
        return spent

    def headroom_allows(
        self, accounts: TuningAccounts, next_cost_estimate_s: float = 0.0
    ) -> bool:
        """SLO gate against the per-call latency recorded in ``accounts``.

        Headroom is a property of ONE kernel's latency, so multi-kernel
        schedulers must gate on the candidate kernel's accounts (not an
        aggregate: the max over kernels would let a slow prefill veto
        tuning of a fast decode forever). A quantile-configured gate
        reads the tail estimate (``observed_tail_s``) and falls back to
        the EWMA until the histogram has samples.
        """
        if self.headroom is None:
            return True
        observed = accounts.observed_call_s
        if (self.headroom.slo_quantile is not None
                and accounts.observed_tail_s > 0.0):
            observed = accounts.observed_tail_s
        return self.headroom.allows(observed, next_cost_estimate_s)

    def budget_allows(
        self,
        accounts: TuningAccounts,
        now_s: float,
        next_cost_estimate_s: float = 0.0,
    ) -> bool:
        return (
            self.spent_s(accounts) + next_cost_estimate_s
            <= self.budget_s(accounts, now_s)
        )

    def should_regenerate(
        self,
        accounts: TuningAccounts,
        now_s: float,
        next_cost_estimate_s: float = 0.0,
    ) -> bool:
        """True when generating+evaluating one more variant fits the budget."""
        return (
            self.headroom_allows(accounts, next_cost_estimate_s)
            and self.budget_allows(accounts, now_s, next_cost_estimate_s)
        )
