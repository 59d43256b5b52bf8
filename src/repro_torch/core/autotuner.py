"""Online auto-tuner (paper Fig. 2 + §3.3–3.4).

At program start a *reference function* is evaluated and becomes the active
function. The tuning thread periodically wakes up; if the regeneration
policy grants budget, it asks the search strategy (the paper's two-phase
explorer by default; any name in the :mod:`repro_torch.core.explorer` registry —
``strategy="random"``, ``"greedy"``, ... — or a pre-built instance) for the
next variant, generates it with the compilette (run-time machine-code
generation), evaluates it, and **swaps the active function pointer** when
the new score is better.

Three scheduling modes:

  * cooperative (default): a wake-up is attempted every ``wake_every``
    kernel invocations, inline. Deterministic; used by tests and by the
    training loop's tuning phase.
  * threaded: a daemon thread wakes every ``wake_period_s`` seconds, like
    the paper's separate auto-tuning thread. The kernel-call path only
    reads a function pointer under no lock (pointer swap is atomic in
    CPython); the tuning thread serializes itself with a lock.
  * managed (``wake_every=None``): the autotuner never self-wakes; an
    external scheduler — the process-wide ``TuningCoordinator`` — calls
    ``wake()`` when it grants this kernel a regeneration slot.

Time is read through an injectable ``clock`` callable (default
``time.perf_counter``). Passing a ``VirtualClock`` makes the entire
control loop — budgets, overhead fractions, gain estimates — a
deterministic function of simulated costs (used by tests/benchmarks).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Sequence

from repro_torch.core.compile_farm import CompileFarm
from repro_torch.core.compilette import (
    Compilette,
    GeneratedKernel,
    GenerationTicket,
)
from repro_torch.core.decision import (
    LatencyHistogram,
    RegenerationPolicy,
    TuningAccounts,
)
from repro_torch.core.evaluator import Measurement
from repro_torch.core.explorer import SearchStrategy, make_strategy, strategy_accepts
from repro_torch.core.gate import GATE_MODES, VariantGate
from repro_torch.core.tuning_space import Point
from repro_torch.runtime import spans

# An external arbiter for regeneration budget (the coordinator's shared
# budget): gate(accounts, now_s, next_cost_estimate_s) -> allowed.
BudgetGate = Callable[[TuningAccounts, float, float], bool]


def _model_cost_fn(
    compilette: Compilette, specialization: dict[str, Any]
) -> Callable[[Any], float] | None:
    """Per-point predicted execution cost from the compilette's model.

    Wired into model-based strategies (``strategy="cost_model"``). The
    model is probed once on the space's default point: a model that
    cannot price this backend at all (e.g. it needs a device profile
    and none is attached) raises there and opts the strategy back into
    its model-free order instead of ranking everything ``inf``.
    """
    model = getattr(compilette, "cost_model", None)
    if model is None:
        return None
    virtual = getattr(compilette, "virtual", None)
    profile = (virtual[1] if isinstance(virtual, tuple) and len(virtual) == 2
               else None)
    spec = dict(specialization or {})
    try:
        model(dict(compilette.space.default_point()), dict(spec), profile)
    except Exception:
        return None

    def cost_fn(point: Any) -> float:
        try:
            return float(model(dict(point), dict(spec), profile))
        except Exception:
            return float("inf")

    return cost_fn


@dataclasses.dataclass
class KernelLife:
    """Bookkeeping for one active-kernel tenure (gain estimation)."""

    point: Point | None           # None = the reference function
    score_s: float
    calls: int = 0


# A canary call whose MEAN observed latency exceeds the incumbent's
# per-call score by this factor is a tail regression: roll back. The
# threshold compares the canary against the *incumbent it wants to
# replace* (a variant that measured fast but serves slow must not survive
# just because it beats its own lie), and uses the running mean so one
# noisy real-hardware call does not condemn a good point outright.
CANARY_REGRESSION_FACTOR = 1.5


@dataclasses.dataclass
class _CanaryState:
    """A gated variant serving a fraction of calls before promotion."""

    fn: Callable[..., Any]
    life: KernelLife              # shares the _lives gain accounting
    served: int = 0
    total_call_s: float = 0.0
    max_call_s: float = 0.0


class OnlineAutotuner:
    def __init__(
        self,
        compilette: Compilette,
        evaluator: Any,
        *,
        policy: RegenerationPolicy | None = None,
        specialization: dict[str, Any] | None = None,
        reference_fn: Callable[..., Any] | None = None,
        reference_score_s: float | None = None,
        base_point: Point | None = None,
        seed_points: Sequence[Point] = (),
        wake_every: int | None = 16,
        strategy: "str | SearchStrategy" = "two_phase",
        explorer: SearchStrategy | None = None,
        clock: Callable[[], float] | None = None,
        budget_gate: BudgetGate | None = None,
        generator: CompileFarm | None = None,
        gate: VariantGate | None = None,
        gate_mode: str = "off",
        canary_fraction: float = 0.25,
        canary_calls: int = 8,
        quarantine_cb: Callable[[Point, str], None] | None = None,
    ) -> None:
        if gate_mode not in GATE_MODES:
            raise ValueError(
                f"gate_mode must be one of {GATE_MODES}, got {gate_mode!r}")
        self.compilette = compilette
        self.evaluator = evaluator
        self.policy = policy or RegenerationPolicy()
        self.specialization = dict(specialization or {})
        self._clock = clock or time.perf_counter
        self._budget_gate = budget_gate
        # --- trusted swaps: oracle gate + canary state machine ------------
        # "off" promotes on measurement alone (pre-gate behavior); "check"
        # runs the oracle gate before the swap; "canary" additionally
        # stages promotion: the variant serves ~canary_fraction of calls,
        # its observed latency compared against the incumbent, with
        # automatic rollback + quarantine on regression or exception.
        self._gate = gate
        self._gate_mode = gate_mode
        self._canary: _CanaryState | None = None
        fraction = min(max(float(canary_fraction), 1e-6), 1.0)
        self._canary_period = max(1, round(1.0 / fraction))
        self._canary_calls = max(1, int(canary_calls))
        self._quarantine_cb = quarantine_cb
        # point whose variant served the most recent __call__ (None = the
        # reference function) — lets harnesses attribute every production
        # call to the exact variant that produced its output
        self.last_served_point: Point | None = None
        # Double-buffered generation: when an AsyncGenerator is injected
        # (by the coordinator), wake() REQUESTS the next variant and keeps
        # the current active_fn serving until the compile is ready.
        self._generator = generator
        self._pending: GenerationTicket | None = None
        # Scheduling priority the coordinator computed when it granted
        # this tuner the slot; passed through to the compile farm so the
        # farm's queue preserves the scheduler's gain ordering.
        self.submit_priority: float = 0.0
        # EWMA of real per-call latency (fed by ManagedTuner.__call__ via
        # observe_latency); None until the first observation. The
        # histogram beside it estimates the tail: when the policy's
        # headroom gate declares an slo_quantile, the gate reads
        # quantile(slo_quantile) instead of the EWMA.
        self._latency_ewma: float | None = None
        self._latency_hist = LatencyHistogram()
        # `explorer` (a pre-built instance) wins over `strategy` (a registry
        # name or instance); both default to the paper's two-phase order.
        # Model-based strategies additionally receive the compilette's
        # cost model (as a per-point `cost_fn`) when one is attached.
        strategy_kwargs: dict[str, Any] = {}
        if (explorer is None and isinstance(strategy, str)
                and strategy_accepts(strategy, "cost_fn")):
            cost_fn = _model_cost_fn(compilette, self.specialization)
            if cost_fn is not None:
                strategy_kwargs["cost_fn"] = cost_fn
        self.explorer = explorer or make_strategy(
            strategy, compilette.space,
            base_point=base_point, seed_points=seed_points,
            **strategy_kwargs,
        )
        self.accounts = TuningAccounts(app_start_s=self._clock())
        self._lock = threading.Lock()
        self._wake_every = None if wake_every is None else max(int(wake_every), 1)
        self._cost_ema: float | None = None   # EMA of gen+eval cost
        self._lives: list[KernelLife] = []
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

        # --- reference function: initial active function (paper §3) -------
        # The reference baseline is measured through normal, instrumented
        # application work (paper §3.3) — it is accounted separately and
        # does not consume the regeneration budget.
        t0 = self._clock()
        if reference_fn is None:
            ref = self.compilette.generate(
                self.explorer.base_point, **self.specialization
            )
            reference_fn = ref.fn
            self.accounts.init_spent_s += ref.generation_time_s
        if reference_score_s is None:
            m = self.evaluator.evaluate(reference_fn)
            reference_score_s = m.score_s
            # Charge the *marginal* instrumentation cost: the measurement
            # runs themselves. m.eval_time_s additionally bundles one-time
            # reference compilation, which is normal app work the first
            # real call would have paid anyway (paper §3.3) — charging it
            # would suppress serving-path tuning (charge_init policies)
            # for far longer than the instrumentation actually cost.
            self.accounts.init_spent_s += min(
                m.eval_time_s, m.score_s * m.n_runs)
        self.reference_score_s = reference_score_s
        # kept for external demotion (fleet quarantine of the incumbent)
        self._reference_fn: Callable[..., Any] = reference_fn
        self._active: Callable[..., Any] = reference_fn
        self._active_life = KernelLife(point=None, score_s=reference_score_s)
        self._lives.append(self._active_life)
        self._init_time_s = self._clock() - t0

    # -------------------------------------------------------------- calling
    @property
    def active_fn(self) -> Callable[..., Any]:
        return self._active

    @property
    def best_point(self) -> Point | None:
        return self.explorer.best_point

    def __call__(self, *args: Any) -> Any:
        if (self._canary is not None
                and self.accounts.kernel_calls % self._canary_period == 0):
            out = self._serve_canary(args)
        else:
            out = self._active(*args)
            self._active_life.calls += 1
            self.last_served_point = self._active_life.point
        self.accounts.kernel_calls += 1
        if (
            self._thread is None
            and self._wake_every is not None
            and self.accounts.kernel_calls % self._wake_every == 0
        ):
            self.wake()
        return out

    # ------------------------------------------------------------- canary
    def _serve_canary(self, args: tuple) -> Any:
        """Serve one production call through the canary variant.

        An exception rolls back to the incumbent (which then serves the
        call — the caller never sees the canary's failure); a mean
        observed latency beyond ``CANARY_REGRESSION_FACTOR`` x the
        incumbent's per-call score is a tail regression and also rolls
        back. After ``canary_calls`` clean served calls the canary is
        promoted to incumbent.
        """
        canary = self._canary
        t0 = self._clock()
        try:
            out = canary.fn(*args)
        except Exception as e:
            self._rollback(canary, f"canary raised: {e!r}")
            out = self._active(*args)
            self._active_life.calls += 1
            self.last_served_point = self._active_life.point
            return out
        call_s = self._clock() - t0
        canary.served += 1
        canary.life.calls += 1
        canary.total_call_s += call_s
        canary.max_call_s = max(canary.max_call_s, call_s)
        self.accounts.canary_calls += 1
        self.last_served_point = canary.life.point
        mean_s = canary.total_call_s / canary.served
        limit_s = CANARY_REGRESSION_FACTOR * max(
            self._active_life.score_s, 1e-12)
        if mean_s > limit_s:
            # keep gain/busy estimates honest: the tenure served at the
            # observed latency, not at the score the variant measured
            canary.life.score_s = mean_s
            self._rollback(
                canary,
                f"tail regression: mean {mean_s:.3e}s vs incumbent "
                f"{self._active_life.score_s:.3e}s")
        elif canary.served >= self._canary_calls:
            self._promote(canary)
        return out

    def _rollback(self, canary: _CanaryState, reason: str) -> None:
        self._canary = None
        self.accounts.rollbacks += 1
        self._quarantine(canary.life.point, reason)

    def _promote(self, canary: _CanaryState) -> None:
        self._active = canary.fn
        self._active_life = canary.life
        self._canary = None
        self.accounts.swaps += 1
        self.accounts.canary_promotions += 1

    def _quarantine(self, point: Point, reason: str) -> None:
        """Never trust this point again: strategy + (via cb) registry."""
        self.accounts.quarantined += 1
        self.explorer.quarantine(point)
        if self._quarantine_cb is not None:
            self._quarantine_cb(dict(point), reason)

    def adopt_quarantine(self, point: Point, reason: str = "") -> bool:
        """Adopt a condemnation published elsewhere (a peer replica).

        Unlike :meth:`_quarantine` this is an *external* verdict: the
        point is quarantined in the explorer, a matching in-flight canary
        is aborted silently (no rollback is charged — the canary did
        nothing wrong locally), and a matching ACTIVE incumbent is
        demoted back to the reference function (a peer's oracle or canary
        proved it wrong under traffic this replica has not seen yet).
        The registry write-through is skipped: the caller merged the
        quarantine from the registry in the first place. Returns True if
        any local state changed.
        """
        key = self.explorer.space.key(point)
        with self._lock:
            changed = False
            if not self.explorer.is_quarantined(point):
                self.explorer.quarantine(point)
                changed = True
            canary = self._canary
            if (canary is not None and canary.life.point is not None
                    and self.explorer.space.key(canary.life.point) == key):
                self._canary = None
                changed = True
            if (self._active_life.point is not None
                    and self.explorer.space.key(self._active_life.point)
                    == key):
                self._active = self._reference_fn
                self._active_life = self._lives[0]
                changed = True
            return changed

    # ------------------------------------------------------------ gains
    def _update_gains(self) -> None:
        """Refresh the derived accounting: gains and busy time.

        Both use the paper's instrumentation-light estimate — the only
        per-call record is a counter, so busy time is calls x measured
        per-call score accumulated over active-kernel tenures (exact under
        the VirtualClock, an estimate on real hardware).
        """
        gained = 0.0
        busy = 0.0
        for life in self._lives:
            gained += life.calls * (self.reference_score_s - life.score_s)
            busy += life.calls * life.score_s
        self.accounts.gained_s = gained
        self.accounts.busy_s = busy
        # Headroom gating prefers the EWMA of real observed call latencies
        # (one outlier call can no longer freeze/unfreeze tuning); the
        # measured score is the fallback for unmanaged tuners.
        self.accounts.observed_call_s = (
            self._latency_ewma if self._latency_ewma is not None
            else self._active_life.score_s)

    def observe_latency(self, call_s: float, alpha: float = 0.2) -> None:
        """Feed one real per-call latency into the EWMA + tail estimates."""
        if call_s < 0:
            return
        if self._latency_ewma is None:
            self._latency_ewma = float(call_s)
        else:
            self._latency_ewma += alpha * (float(call_s) - self._latency_ewma)
        # write through: the headroom gate must see fresh telemetry even
        # between _update_gains passes
        self.accounts.observed_call_s = self._latency_ewma
        self._latency_hist.observe(call_s)
        q = getattr(self.policy.headroom, "slo_quantile", None)
        if q is not None:
            self.accounts.observed_tail_s = self._latency_hist.quantile(q)

    # ------------------------------------------------------------ wake-up
    @property
    def generation_in_flight(self) -> bool:
        """A requested variant is still compiling in the background."""
        return self._pending is not None and not self._pending.done

    def _candidate_cost_estimate(self) -> float:
        """Cost-model prediction of the next regeneration's full charge.

        The budget gate otherwise estimates with the ACTIVE kernel's
        cost EWMA, which understates candidates slower than the
        incumbent — each admission can overshoot the shared budget by
        the difference, and the overshoots accumulate. When the
        compilette carries a cost model and a virtual profile, the
        upcoming candidate's generation + evaluation cost is knowable
        in advance; real backends (no model) keep the EWMA estimate.
        """
        comp = self.compilette
        virtual = getattr(comp, "virtual", None)
        if virtual is None or getattr(comp, "cost_model", None) is None:
            return 0.0
        peeked = self.explorer.peek(1)
        if not peeked:
            return 0.0
        point = peeked[0]
        try:
            gen = comp._simulated_cost(point, self.specialization) or 0.0
            est = gen + comp.simulate(
                point, virtual[1], **self.specialization)
        except Exception:
            return 0.0
        # a hole candidate priced at inf must still be admitted so the
        # normal cycle can report it and move on — never gate on it
        return est if math.isfinite(est) else 0.0

    def wake(self) -> bool:
        """One wake-up of the tuning thread. Returns True if it swapped.

        Without an :class:`AsyncGenerator` this is the paper's synchronous
        cycle: generate, evaluate, maybe swap — the compile stalls the
        wake. With one (coordinator-injected), a wake instead *requests*
        the next variant and returns immediately; the active function
        keeps serving until a later wake finds the compiled candidate
        ready and only then pays the (much cheaper) evaluation. The full
        generation time is charged to the budget either way — only the
        *stall* disappears.
        """
        with self._lock:
            # -- harvest: a previously requested variant may be ready ----
            if self._pending is not None:
                ticket = self._generator.poll(self._pending)
                if ticket is None:
                    return False   # still compiling; hot path unstalled
                self._pending = None
                if ticket.error is not None:
                    # late-found hole: charge the wasted compile,
                    # quarantine the point (a failing compile is as
                    # untrusted as a failing oracle), move on
                    self.accounts.tuning_spent_s += ticket.gen_charge_s
                    self.accounts.gen_spent_s += ticket.gen_charge_s
                    self.explorer.report(ticket.point, float("inf"))
                    self._quarantine(
                        ticket.point, f"generation failed: {ticket.error!r}")
                    return False
                if self.explorer.is_quarantined(ticket.point):
                    # condemned while the compile was in flight (e.g. a
                    # peer replica's verdict arrived via fleet sync): pay
                    # for the wasted compile, never evaluate or serve it
                    self.accounts.tuning_spent_s += ticket.gen_charge_s
                    self.accounts.gen_spent_s += ticket.gen_charge_s
                    return False
                return self._measure_and_swap(
                    ticket.point, ticket.kern,
                    gen_charge_s=ticket.gen_charge_s, stalled=ticket.stalled)
            if self.explorer.finished:
                return False
            self._update_gains()
            now = self._clock()
            estimate = self._cost_ema if self._cost_ema is not None else 0.0
            estimate = max(estimate, self._candidate_cost_estimate())
            gate = self._budget_gate or self.policy.should_regenerate
            if not gate(self.accounts, now, estimate):
                return False
            point = self.explorer.next_point()
            if point is None:
                return False
            # -- request: pipelined generation (double buffering) --------
            if self._generator is not None:
                ticket = self._generator.submit(
                    self.compilette, point, self.specialization,
                    priority=self.submit_priority)
                self.accounts.gen_requests += 1
                if not ticket.done:
                    self._pending = ticket
                    return False
                if ticket.error is not None:
                    self.explorer.report(point, float("inf"))
                    self._quarantine(
                        point, f"generation failed: {ticket.error!r}")
                    return False
                # cache hit: ready now at zero cost — evaluate in place
                # (ticket.stalled covers the rare eviction race where the
                # "hit" actually recompiled inline on this thread)
                return self._measure_and_swap(
                    point, ticket.kern,
                    gen_charge_s=ticket.gen_charge_s, stalled=ticket.stalled)
            # -- synchronous generate+evaluate (paper's original cycle) --
            t0 = self._clock()
            try:
                kern: GeneratedKernel = self.compilette.generate(
                    point, **self.specialization
                )
            except Exception as e:
                # Generation failures are holes discovered late: record the
                # spent time, quarantine the point and move on (the paper's
                # "could not generate code" entries). The whole interval is
                # generation (the evaluation never started), and it stalled
                # this wake.
                spent = self._clock() - t0
                self.accounts.tuning_spent_s += spent
                self.accounts.gen_spent_s += spent
                self.accounts.gen_stall_s += spent
                self.explorer.report(point, float("inf"))
                self._quarantine(point, f"generation failed: {e!r}")
                return False
            compiled = kern.meta.get("source", "compiled") == "compiled"
            if (compiled and kern.meta.get("simulated")
                    and hasattr(self._clock, "advance")):
                # a simulated compile cost stalls the virtual clock exactly
                # like a real synchronous compile stalls the wall clock
                self._clock.advance(kern.generation_time_s)
            return self._measure_and_swap(
                point, kern, gen_charge_s=kern.generation_time_s,
                stalled=compiled, wall_t0=t0)

    def _measure_and_swap(
        self,
        point: Point,
        kern: GeneratedKernel,
        *,
        gen_charge_s: float,
        stalled: bool,
        wall_t0: float | None = None,
    ) -> bool:
        """Evaluate a generated variant, charge the accounts, maybe swap.

        ``wall_t0`` set means the generation ran synchronously inside this
        wake (the clock interval covers it); otherwise generation time was
        overlapped (or cached) and ``gen_charge_s`` is added explicitly so
        the budget still pays for it.
        """
        def _charge(spent: float, eval_s: float) -> None:
            self.accounts.tuning_spent_s += spent
            self.accounts.gen_spent_s += gen_charge_s
            self.accounts.eval_spent_s += eval_s
            if stalled:
                self.accounts.gen_stall_s += gen_charge_s

        # the span holds the interval eval_s times
        with spans.span("tune.evaluate", kernel=self.compilette.name):
            t_eval = self._clock()
            try:
                measurement: Measurement = self.evaluator.evaluate(kern.fn)
                raised = None
            except Exception as e:
                raised = e
            eval_s = self._clock() - t_eval
        if raised is not None:
            start = wall_t0 if wall_t0 is not None else t_eval
            spent = self._clock() - start
            if wall_t0 is None:
                spent += gen_charge_s
            _charge(spent, eval_s)
            self.explorer.report(point, float("inf"))
            self._quarantine(point, f"evaluation raised: {raised!r}")
            return False
        if wall_t0 is not None:
            spent = self._clock() - wall_t0
        else:
            spent = gen_charge_s + eval_s
        _charge(spent, eval_s)
        self.accounts.regenerations += 1
        self._cost_ema = (
            spent
            if self._cost_ema is None
            else 0.5 * self._cost_ema + 0.5 * spent
        )
        # --- variant gate: oracle check before the point may serve -------
        if self._gate_mode != "off" and self._gate is not None:
            t_gate = self._clock()
            ok, reason = self._gate.check(point, kern.fn)
            gate_s = self._clock() - t_gate
            self.accounts.tuning_spent_s += gate_s
            self.accounts.gate_spent_s += gate_s
            self.accounts.gate_checks += 1
            if not ok:
                self.accounts.gate_failures += 1
                self._quarantine(point, reason)
                self.explorer.report(point, float("inf"))
                return False
        is_best = self.explorer.report(point, measurement.score_s)
        if is_best and measurement.score_s < self._active_life.score_s:
            life = KernelLife(point=dict(point), score_s=measurement.score_s)
            self._lives.append(life)
            if self._gate_mode == "canary":
                # staged promotion: CANDIDATE -> CANARY. The incumbent
                # keeps serving most calls; a newer, better candidate
                # simply supersedes an unfinished canary (no quarantine —
                # it did nothing wrong, it just lost).
                self._canary = _CanaryState(fn=kern.fn, life=life)
                return False
            self._active = kern.fn
            self._active_life = life
            self.accounts.swaps += 1
            return True
        return False

    def abandon_pending(self, charge_cb=None) -> None:
        """Drop an unharvested generation request (tuner is retiring).

        The compile cost must still reach the budget: a completed ticket
        is billed here (so the caller can fold these accounts into its
        tombstone), an in-flight one is handed back to the generator
        with ``charge_cb`` to bill at completion.
        """
        with self._lock:
            ticket = self._pending
            self._pending = None
            if ticket is None or self._generator is None:
                return
            charge = self._generator.disown(ticket, charge_cb)
            if charge > 0.0:
                self.accounts.gen_spent_s += charge
                self.accounts.tuning_spent_s += charge

    def exhaust(self, max_wakes: int = 100000) -> None:
        """Drive wake-ups ignoring call pacing until budget or space ends.

        Synchronous tuners only: with an async generator, driving the
        pipeline is the coordinator's job (``pump`` completes and harvests
        in-flight generations).
        """
        for _ in range(max_wakes):
            if self.explorer.finished:
                break
            before = self.explorer.state.n_reported
            self.wake()
            if self.explorer.state.n_reported == before:
                break  # budget exhausted for now

    # ------------------------------------------------------------ threaded
    def start_thread(self, wake_period_s: float = 0.001) -> None:
        if self._thread is not None:
            return

        def _loop() -> None:
            while not self._stop.is_set():
                self.wake()
                if self.explorer.finished:
                    break
                self._stop.wait(wake_period_s)

        self._thread = threading.Thread(target=_loop, daemon=True)
        self._thread.start()

    def stop_thread(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    # ------------------------------------------------------------- reports
    def stats(self) -> dict[str, Any]:
        self._update_gains()
        elapsed = self._clock() - self.accounts.app_start_s
        return {
            "strategy": self.explorer.name,
            "kernel_calls": self.accounts.kernel_calls,
            "regenerations": self.accounts.regenerations,
            "swaps": self.accounts.swaps,
            "tuning_spent_s": self.accounts.tuning_spent_s,
            "gen_spent_s": self.accounts.gen_spent_s,
            "gen_stall_s": self.accounts.gen_stall_s,
            "eval_spent_s": self.accounts.eval_spent_s,
            "generation_in_flight": self.generation_in_flight,
            "gate_mode": self._gate_mode,
            "gate_spent_s": self.accounts.gate_spent_s,
            "gate_checks": self.accounts.gate_checks,
            "gate_failures": self.accounts.gate_failures,
            "canary_calls": self.accounts.canary_calls,
            "canary_promotions": self.accounts.canary_promotions,
            "canary_in_flight": self._canary is not None,
            "rollbacks": self.accounts.rollbacks,
            "quarantined": self.accounts.quarantined,
            "gained_s": self.accounts.gained_s,
            "overhead_frac": (
                self.accounts.tuning_spent_s / elapsed if elapsed > 0 else 0.0
            ),
            "reference_score_s": self.reference_score_s,
            "active_score_s": self._active_life.score_s,
            "active_point": self._active_life.point,
            "best_point": self.explorer.best_point,
            "best_score_s": self.explorer.best_score,
            "exploration_finished": self.explorer.finished,
            "n_explored": self.explorer.state.n_reported,
        }
