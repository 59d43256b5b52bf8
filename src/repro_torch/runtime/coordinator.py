"""Process-wide tuning coordinator: one budget, many kernels, warm starts.

Mirrors ``repro/runtime/coordinator.py``, unchanged: the coordinator is
pure control logic (the device is reached through the compilettes and
evaluators it manages).

The paper tunes ONE kernel per process with its own regeneration budget.
A production process (training loop, serving binary) runs MANY tunable
step-programs — prefill, decode, the train step, individual hand
kernels — and restarts or scales out constantly. The coordinator extends
the paper's economics across both dimensions:

  * **one budget for the whole process** — a single
    :class:`RegenerationPolicy` is applied to the *sum* of tuning time
    spent and time gained across every managed autotuner, so adding more
    tunable kernels never multiplies the tuning overhead cap;
  * **fairness by estimated gain** — each scheduling slot goes to the
    kernel with the highest estimated return per regeneration
    (unmeasured kernels first, then ``potential_gain x call_rate /
    regenerations``), so a hot kernel with headroom gets tuned before a
    cold one that is already optimal;
  * **warm starts from the registry** — every autotuner is seeded from
    the :class:`TunedRegistry` under (kernel, specialization, device
    fingerprint); a restarted or elastically re-scaled job re-validates
    its persisted best variant with a single regeneration instead of
    re-exploring the space (cf. the Kernel Tuning Toolkit's persistent
    dynamic-autotuning service, arXiv:1910.08498);
  * **one tuning thread per process** — instead of one thread per
    kernel, a single coordinator thread (or cooperative ``maybe_pump``
    calls on the hot path) drives every managed autotuner;
  * **double-buffered variant generation** — with ``async_generation``
    on, a background :class:`~repro_torch.core.CompileFarm` of
    ``compile_workers`` workers compiles candidates while the current
    active functions keep serving (the paper's "new version in a code
    buffer", scaled to M buffers), scheduled by the same gain priority
    ``pump`` uses and capped per kernel so one wide space cannot starve
    the rest; every generation goes through a process-wide
    :class:`~repro_torch.core.GenerationCache` (a point revisited after
    bucketing, eviction or warm start never recompiles), and the
    scheduler prefetch-compiles the next ``prefetch`` proposals of each
    kernel it serves (``SearchStrategy.peek``). Generation time is
    charged to the shared budget in full either way — only the hot-path
    *stall* (``gen_stall_s``) disappears;
  * **a managed lifecycle** — a :class:`~repro_torch.runtime.lifecycle.TunerLifecycle`
    buckets shape-like specializations (so varied prompt lengths share
    tuners), marks exhausted tuners ``CONVERGED`` (releasing their pinned
    evaluator closures) and ``RETIRED``\\ s idle ones, unregistering them
    while folding their accounting into a tombstone so the shared budget
    stays honest.

Time is read through an injectable ``clock`` (default
``time.perf_counter``); with a :class:`~repro_torch.core.VirtualClock` the
whole scheduler is deterministic, which is how the tier-1 tests drive it.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable

from repro_torch.core.autotuner import OnlineAutotuner
from repro_torch.core.compile_farm import CompileFarm
from repro_torch.core.compilette import (
    Compilette,
    GenerationCache,
    GenerationTicket,
)
from repro_torch.core.decision import RegenerationPolicy, TuningAccounts
from repro_torch.core.explorer import SearchStrategy
from repro_torch.core.gate import GATE_MODES, VariantGate
from repro_torch.core.persistence import TunedRegistry, device_fingerprint
from repro_torch.core.transfer import (
    calibrated_traits,
    device_traits,
    transfer_seeds,
)
from repro_torch.runtime import spans
from repro_torch.runtime.lifecycle import (
    TunerLifecycle,
    TunerState,
    release_evaluator_closure,
)

__all__ = [
    "ManagedTuner",
    "TuningCoordinator",
    "device_fingerprint",   # re-export: pre-refactor import site
]


def _canon_spec(spec: dict[str, Any]) -> str:
    return json.dumps(spec, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass(eq=False)   # identity semantics: hashable handle
class ManagedTuner:
    """One kernel/step-program under coordinator management."""

    name: str
    specialization: dict[str, Any]
    tuner: OnlineAutotuner
    warm_started: bool
    clock: Callable[[], float] = time.perf_counter
    state: TunerState = TunerState.ACTIVE
    last_used_s: float = 0.0
    calls_at_last_wake: int = 0
    # persistence key device: the coordinator's device fingerprint plus
    # the compilette's own identity suffix (e.g. the kernel source hash),
    # so editing a kernel invalidates exactly that kernel's warm starts
    registry_device: str = ""
    # set by the KernelTuningPlane: this tuner is an individual kernel
    # compilette (vs a whole step-program); consumers (CLI reports) can
    # split stats() entries without hard-coding step-program names
    plane_managed: bool = False
    # fleet sync cursor: how much of the explorer history has already
    # been published to the registry's evaluation ledger
    evals_flushed: int = 0
    # transfer plane: the trait vector persisted with this tuner's bests
    # (None when the device cannot describe itself), and the space keys
    # of foreign bests injected as transfer seeds at registration
    device_traits: dict[str, float] | None = None
    transfer_seed_keys: tuple = ()

    def __call__(self, *args: Any) -> Any:
        t0 = self.last_used_s = self.clock()
        out = self.tuner(*args)
        # Real per-call latency telemetry: the EWMA this feeds is what the
        # LatencyHeadroomGate reads, so one outlier call (GC pause, first
        # compile) cannot freeze or unfreeze tuning by itself.
        self.tuner.observe_latency(self.clock() - t0)
        return out

    @property
    def active_fn(self) -> Callable[..., Any]:
        return self.tuner.active_fn

    def stats(self) -> dict[str, Any]:
        out = self.tuner.stats()
        out["warm_started"] = self.warm_started
        out["state"] = self.state.value
        out["plane_managed"] = self.plane_managed
        out["transfer_seeds"] = len(self.transfer_seed_keys)
        return out


class TuningCoordinator:
    """Owns every :class:`OnlineAutotuner` of a process.

    ``register`` is idempotent per (name, specialization): serving code
    can re-register on every request and always gets the same managed
    autotuner back, which is what makes tuning pay off *across* requests.
    """

    def __init__(
        self,
        *,
        policy: RegenerationPolicy | None = None,
        registry: TunedRegistry | None = None,
        registry_path: str | None = None,
        device: str | None = None,
        clock: Callable[[], float] | None = None,
        pump_every: int = 8,
        lifecycle: TunerLifecycle | None = None,
        strategy: str = "two_phase",
        async_generation: "bool | str" = False,
        generation_cache: GenerationCache | None = None,
        prefetch: int = 1,
        compile_workers: "int | str" = 1,
        gate_mode: str = "off",
        canary_fraction: float = 0.25,
        canary_calls: int = 8,
        gate_rtol: float | None = None,
        gate_atol: float | None = None,
        replica_id: int = 0,
        replica_count: int = 1,
        registry_backend: Any | None = None,
        sync_every_s: float | None = 1.0,
        transfer: bool = False,
        transfer_top_k: int = 3,
        min_similarity: float = 0.75,
    ) -> None:
        if gate_mode not in GATE_MODES:
            raise ValueError(
                f"gate_mode must be one of {GATE_MODES}, got {gate_mode!r}")
        self.policy = policy or RegenerationPolicy()
        # Trusted swaps: with gate_mode != "off" every registered tuner
        # gets a VariantGate over its compilette's declared oracle (with
        # these session-level tolerance overrides) and a quarantine
        # callback writing condemned points through to the registry, so a
        # bad point is never re-trusted across restarts.
        self.gate_mode = gate_mode
        self.canary_fraction = float(canary_fraction)
        self.canary_calls = int(canary_calls)
        self.gate_rtol = gate_rtol
        self.gate_atol = gate_atol
        self.clock = clock or time.perf_counter
        if registry is not None:
            self.registry = registry
        elif registry_path is not None:
            self.registry = TunedRegistry.load(registry_path)
        else:
            self.registry = TunedRegistry()
        self.registry_path = registry_path
        self.device = device or device_fingerprint()
        self.app_start_s = self.clock()
        self.pump_every = max(int(pump_every), 1)
        # Default lifecycle: no bucketing, no eviction (training jobs have
        # a handful of fixed-shape step-programs); serving passes an
        # active TunerLifecycle. Convergence handling is always on.
        self.lifecycle = lifecycle or TunerLifecycle(
            seq_buckets=False, idle_evict_s=None)
        # Names only: the coordinator builds ONE strategy instance per
        # registered tuner (over that tuner's space, seeded from the
        # registry). A shared pre-built instance would leak one kernel's
        # points/seen-set into another and silently drop warm starts.
        if not isinstance(strategy, str):
            raise TypeError(
                "TuningCoordinator strategy must be a registry name "
                f"(one of the repro_torch.core.explorer strategies), got "
                f"{type(strategy).__name__}; pass pre-built instances via "
                "OnlineAutotuner(explorer=...) outside the coordinator")
        self.strategy = strategy
        # Compiled-variant cache: one per coordinator (= per process under
        # the one-coordinator-per-process regime), shared across every
        # managed tuner and SURVIVING tuner retirement, so re-registered
        # buckets and warm starts never recompile. Inject a shared
        # instance to span multiple coordinators. The default is a
        # BOUNDED LRU: compiled executables pin device memory, and an
        # unbounded cache would undo the lifecycle's memory bounding.
        # ("is not None", not truthiness: an EMPTY injected cache is falsy
        # through __len__ but must still be adopted, or two coordinators
        # meant to share one cache would silently get private ones)
        self.generation_cache = (
            generation_cache if generation_cache is not None
            else GenerationCache(max_entries=256))
        # Double-buffered generation: one background compile farm for the
        # whole process, with ``compile_workers`` workers draining the
        # gain-priority queue. True picks the mode from the clock — a
        # virtual (advanceable) clock gets the deterministic "manual"
        # pipeline (one batch of up to ``workers`` jobs completes at the
        # next pump, no sleeps), a real clock gets worker threads. Pass
        # "thread"/"manual"/"process" to force one. The per-kernel cap —
        # a kernel's own request plus its prefetch quota — keeps one
        # kernel's wide space from flooding the farm.
        self.prefetch = max(int(prefetch), 0)
        if async_generation:
            mode = (async_generation if isinstance(async_generation, str)
                    else ("manual" if hasattr(self.clock, "advance")
                          else "thread"))
            self.generator: CompileFarm | None = CompileFarm(
                mode=mode, workers=compile_workers,
                per_kernel_cap=self.prefetch + 1)
        else:
            self.generator = None
        # Fleet fabric: N replicas share one RegistryBackend. Exploration
        # is hash-striped across them (every registered strategy gets
        # partition(replica_id, replica_count)), sync_fleet() publishes
        # local bests/evaluations/quarantines and adopts the fleet's —
        # peer bests enter as CANDIDATE through the normal gate/canary
        # path, peer quarantine is adopted unconditionally, peer
        # evaluations count as seen so no point is compiled twice per
        # fleet. sync_every_s=None syncs on every pump.
        self.replica_id = int(replica_id)
        self.replica_count = max(int(replica_count), 1)
        if not 0 <= self.replica_id < self.replica_count:
            raise ValueError(
                f"replica_id must be in [0, {self.replica_count}), "
                f"got {replica_id}")
        self.registry_backend = registry_backend
        self.sync_every_s = sync_every_s
        self.fleet_syncs = 0
        # Transfer plane: on a fingerprint miss, seed the search with the
        # top-k foreign bests whose device traits are within the
        # similarity floor. Seeds enter via inject_candidate — CANDIDATE
        # through gate/canary, never a blind incumbent.
        self.transfer = bool(transfer)
        self.transfer_top_k = int(transfer_top_k)
        if self.transfer_top_k < 1:
            raise ValueError(
                f"transfer_top_k must be >= 1, got {transfer_top_k}")
        self.min_similarity = float(min_similarity)
        if not 0.0 < self.min_similarity <= 1.0:
            raise ValueError(
                f"min_similarity must be in (0, 1], got {min_similarity}")
        self.transfer_hits = 0
        self._last_sync_s: float | None = None
        self._managed: list[ManagedTuner] = []
        self._by_key: dict[tuple[str, str], ManagedTuner] = {}
        # Accounting tombstone for retired tuners: the shared budget must
        # keep counting what they spent/gained after they unregister.
        self._retired_accounts = TuningAccounts()
        self._n_retired = 0
        # Busy time observed OUTSIDE managed tuners (observe_busy): a
        # kernel-granular serve process runs its step-programs unmanaged,
        # yet that is exactly the useful work a busy-time budget should
        # accrue from — without it, per-kernel tuning would be starved
        # forever (managed kernels are evaluated, never "called").
        self._external_busy_s = 0.0
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._app_calls = 0
        if self.registry_backend is not None:
            # adopt the fleet's published state up front so the very
            # first register() warm-starts from peer bests and never
            # proposes a peer-condemned or peer-evaluated point
            self.sync_fleet()
            self._last_sync_s = self.clock()

    # ------------------------------------------------------------ register
    def register(
        self,
        name: str,
        compilette: Compilette,
        evaluator: Any,
        *,
        specialization: dict[str, Any] | None = None,
        reference_fn: Callable[..., Any] | None = None,
        reference_score_s: float | None = None,
        strategy: str | None = None,
    ) -> ManagedTuner:
        if strategy is not None and not isinstance(strategy, str):
            raise TypeError(
                "register() strategy must be a registry name; a pre-built "
                "instance cannot be re-seeded from the warm-start registry")
        # Shape-like specialization keys are bucketed BEFORE keying, so
        # e.g. seq 120 and seq 150 resolve to one shared 128-bucket tuner.
        spec = self.lifecycle.bucket_specialization(dict(specialization or {}))
        key = (name, _canon_spec(spec))
        with self._lock:
            existing = self._by_key.get(key)
            if existing is not None:
                existing.last_used_s = self.clock()
                return existing
            # Persistence fingerprint: the process device key plus any
            # compilette-declared identity (KernelCompilette appends
            # "src-<hash>" of its ops.py). Editing a kernel's source
            # changes the exact key, so its stale bests miss and exactly
            # that kernel retunes; the legacy fallback chain only ever
            # reaches pre-fingerprint 1–2 part keys, never another hash.
            extra = getattr(compilette, "fingerprint_extra", None)
            reg_device = f"{self.device}:{extra}" if extra else self.device
            # exact fingerprint (incl. compiler version), then legacy keys
            warm_point = self.registry.get_warm(name, spec, reg_device)
            if warm_point is not None and not compilette.space.contains(
                    warm_point):
                # stale entry from an older space definition (renamed or
                # added parameters): a cache miss, never a crash
                warm_point = None
            # persisted quarantine: condemned points (wrong output, tail
            # regression, raising variant) must neither warm-start nor be
            # re-proposed after restart — seed the explorer's quarantine
            # set below and drop a condemned warm point outright
            bad_points = [
                p for p in self.registry.quarantined_points(
                    name, spec, reg_device)
                if compilette.space.contains(p)
            ]
            if warm_point is not None and any(
                    compilette.space.key(warm_point)
                    == compilette.space.key(p) for p in bad_points):
                warm_point = None
            # every generation (sync or async) goes through the shared
            # compiled-variant cache, keyed under this process's device
            compilette.attach_cache(self.generation_cache, self.device)
            gate = (VariantGate(compilette, rtol=self.gate_rtol,
                                atol=self.gate_atol)
                    if self.gate_mode != "off" else None)

            def _quarantine_cb(point: dict[str, Any], reason: str,
                               _name: str = name,
                               _spec: dict[str, Any] = spec,
                               _dev: str = reg_device) -> None:
                self.registry.quarantine(_name, _spec, _dev, point, reason)

            tuner = OnlineAutotuner(
                compilette,
                evaluator,
                policy=self.policy,
                specialization=spec,
                reference_fn=reference_fn,
                reference_score_s=reference_score_s,
                base_point=warm_point,
                seed_points=[warm_point] if warm_point else (),
                wake_every=None,           # managed: coordinator schedules
                strategy=strategy if strategy is not None else self.strategy,
                clock=self.clock,
                budget_gate=self._shared_budget_gate,
                generator=self.generator,
                gate=gate,
                gate_mode=self.gate_mode,
                canary_fraction=self.canary_fraction,
                canary_calls=self.canary_calls,
                quarantine_cb=_quarantine_cb,
            )
            for p in bad_points:
                tuner.explorer.quarantine(p)
            if self.replica_count > 1:
                # fleet: this replica only explores its hash stripe of
                # the space (the warm-start seed stays exempt — the
                # fleet best must re-validate locally through the gate)
                tuner.explorer.partition(self.replica_id, self.replica_count)
            if self.registry_backend is not None:
                # evaluations any replica already published count as
                # seen: never compiled twice per fleet, across restarts
                # too. The warm seed is excluded — marking it seen would
                # swallow its re-validation proposal.
                warm_key = (compilette.space.key(warm_point)
                            if warm_point is not None else None)
                for p in self.registry.evaluated_points(
                        name, spec, reg_device):
                    if not compilette.space.contains(p):
                        continue
                    if (warm_key is not None
                            and compilette.space.key(p) == warm_key):
                        continue
                    tuner.explorer.mark_seen(p)
            # Device traits: what this device IS, persisted with every
            # best so dissimilar-fingerprint peers can rank it. Virtual
            # backends derive them from the exact profile; real ones from
            # the platform fingerprint refined by a cost-model probe
            # against the measured reference time.
            traits = device_traits(compilette, device=self.device)
            traits = calibrated_traits(
                traits, compilette, spec, tuner.reference_score_s,
                device=self.device)
            # Transfer seeds: on a fingerprint miss, the nearest-
            # fingerprint lookup proposes the top-k foreign bests. They
            # jump the proposal queue stripe-exempt (like warm seeds) but
            # flow through generate/evaluate/gate/canary as CANDIDATEs —
            # a foreign best is never trusted blind, and one condemned
            # anywhere in the fleet was already dropped by the lookup or
            # is refused by the explorer's quarantine here.
            seed_keys: list = []
            if self.transfer and warm_point is None and traits is not None:
                for seed in transfer_seeds(
                        self.registry, name, spec, reg_device, traits,
                        top_k=self.transfer_top_k,
                        min_similarity=self.min_similarity):
                    if tuner.explorer.inject_candidate(seed.point):
                        seed_keys.append(
                            compilette.space.key(seed.point))
                        self.transfer_hits += 1
            managed = ManagedTuner(
                name=name,
                specialization=spec,
                tuner=tuner,
                warm_started=warm_point is not None,
                clock=self.clock,
                last_used_s=self.clock(),
                registry_device=reg_device,
                device_traits=traits.to_dict() if traits else None,
                transfer_seed_keys=tuple(seed_keys),
            )
            self._managed.append(managed)
            self._by_key[key] = managed
            return managed

    # ------------------------------------------------------- shared budget
    # TuningAccounts fields summed across tuners by the shared budget
    # (observed_call_s is deliberately NOT additive: it is a per-kernel
    # latency — see _shared_budget_gate — and only max'd for reporting).
    _ADDITIVE_FIELDS = (
        "tuning_spent_s", "gen_spent_s", "gen_stall_s", "eval_spent_s",
        "gained_s", "busy_s", "kernel_calls", "regenerations",
        "gen_requests", "swaps", "init_spent_s",
        "gate_spent_s", "gate_checks", "gate_failures",
        "canary_calls", "canary_promotions", "rollbacks", "quarantined",
    )

    @classmethod
    def _accumulate(cls, dst: TuningAccounts, src: TuningAccounts) -> None:
        for f in cls._ADDITIVE_FIELDS:
            setattr(dst, f, getattr(dst, f) + getattr(src, f))
        dst.observed_call_s = max(dst.observed_call_s, src.observed_call_s)
        dst.observed_tail_s = max(dst.observed_tail_s, src.observed_tail_s)

    def observe_busy(self, seconds: float) -> None:
        """Credit useful work done outside any managed tuner.

        Serving loops call this with the step-program time when the step
        itself is NOT coordinator-managed (``kernel_tuning="kernel"``):
        a ``budget_from="busy"`` policy then accrues budget from real
        traffic exactly as it would had the step been a managed tuner.
        Callers must not double-report work a ManagedTuner already
        counts (its calls accrue ``busy_s`` via calls × score).
        """
        if seconds > 0:
            self._external_busy_s += float(seconds)

    def _aggregate_accounts(self) -> TuningAccounts:
        agg = TuningAccounts(app_start_s=self.app_start_s)
        self._accumulate(agg, self._retired_accounts)
        for m in self._managed:
            m.tuner._update_gains()
            self._accumulate(agg, m.tuner.accounts)
        agg.busy_s += self._external_busy_s
        return agg

    def _shared_budget_gate(
        self, caller: TuningAccounts, now_s: float, estimate_s: float
    ) -> bool:
        """Budget gate on the PROCESS totals; headroom gate on the CALLER.

        Every managed autotuner defers here, so the overhead cap bounds
        the sum of all tuning time while gains found by one kernel can
        fund exploration of another. The latency-headroom gate is the
        exception: SLO headroom is a per-kernel property, so it reads the
        calling tuner's own observed per-call time — a slow prefill must
        not veto tuning of a fast decode step (nor vice versa).
        """
        if not self.policy.headroom_allows(caller, estimate_s):
            return False
        return self.policy.budget_allows(
            self._aggregate_accounts(), now_s, estimate_s
        )

    # ----------------------------------------------------------- schedule
    def _priority(self, m: ManagedTuner) -> float:
        """Estimated return of granting this kernel the next slot."""
        t = m.tuner
        if m.state is not TunerState.ACTIVE or t.explorer.finished:
            return float("-inf")
        if t.accounts.regenerations == 0:
            # Nothing measured yet: exploration has unbounded information
            # value; bootstrap in registration order.
            return float("inf")
        calls_since = t.accounts.kernel_calls - m.calls_at_last_wake
        potential = max(
            t.reference_score_s - max(t.explorer.best_score, 0.0), 0.0
        )
        # gain-rate estimate, damped by how much we already invested here
        return (potential * (1.0 + calls_since)) / (
            1.0 + t.accounts.regenerations
        )

    def _candidates(self) -> list[tuple[float, ManagedTuner]]:
        """Wakeable tuners with their priorities, best first
        (registration order ties).

        ``sorted`` is stable, so equal priorities (e.g. several +inf
        bootstrap kernels) keep registration order.
        """
        prioritized = [(self._priority(m), m) for m in self._managed]
        eligible = [(p, i, m) for i, (p, m) in enumerate(prioritized)
                    if p > float("-inf")]
        eligible.sort(key=lambda t: (-t[0], t[1]))
        return [(p, m) for p, _, m in eligible]

    def pump(self) -> bool:
        """One scheduling slot: hand the farm a prioritized batch.

        Returns True when some wake swapped in a faster variant. Up to
        ``generator.workers`` kernels get a productive wake per pump
        (one without a farm) — the farm has that many compile slots, so
        a single pump can keep every worker fed; each woken kernel's
        request is submitted at its scheduling priority and its next
        proposals are prefetched. A kernel frozen by its own
        latency-headroom gate — or merely waiting for its background
        compile — passes the slot to the next candidate (an over-SLO
        prefill must not starve a fast decode step forever); a
        shared-budget denial instead ends the whole pump, so accruing
        budget stays earmarked for the most valuable kernels rather
        than leaking to cheaper, lower-value ones. The one exception:
        when the budget still has headroom at the kernel's own cost
        EWMA, the denial was its next *candidate's* predicted cost
        (cost-model compilettes gate on it) — an individually
        unaffordable variant passes the slot instead of freezing every
        other kernel behind it.

        With async generation a productive wake is either a *request*
        (next variant submitted to the farm) or a *harvest* (compiled
        candidate evaluated, maybe swapped); one batch of queued jobs —
        up to ``workers`` of them, highest priority first — completes at
        the top of the pump, so in the deterministic "manual" mode a
        variant requested at pump *k* is harvestable at pump *k+1* —
        never sooner (max-overlap semantics: the batch's wall time hides
        inside the serving interval, its full cost is billed).
        """
        batch = 1
        if self.generator is not None:
            self.generator.run_pending()
            batch = self.generator.workers
        self._maybe_sync()
        self.sweep()
        with self._lock:
            candidates = self._candidates()
        progressed = 0
        any_swapped = False
        for prio, m in candidates:
            t = m.tuner
            # progress = a measurement reported (sync cycle, async
            # harvest, or a failed generation logged as a hole) or an
            # async generation requested
            before = t.explorer.state.n_reported + t.accounts.gen_requests
            t.submit_priority = prio
            any_swapped |= t.wake()
            if t.explorer.state.n_reported + t.accounts.gen_requests != before:
                m.calls_at_last_wake = t.accounts.kernel_calls
                self._flush_best(m)
                self._prefetch(m, prio)
                progressed += 1
                if progressed >= batch:
                    break
                continue
            if t.generation_in_flight:
                # waiting on the compile farm: the slot moves on, the
                # hot path keeps running the current active_fn un-stalled
                continue
            # the slot did nothing here: leave this kernel's hotness
            # signal intact — resetting it would starve exactly the
            # kernel we judged most valuable
            est = t._cost_ema or 0.0
            if not self.policy.headroom_allows(t.accounts, est):
                continue       # per-kernel headroom freeze: next
            candidate = t._candidate_cost_estimate()
            if candidate > est and self._shared_budget_gate(
                    t.accounts, self.clock(), est):
                # budget has headroom at this kernel's own cost EWMA: the
                # denial was its next CANDIDATE's predicted cost — a
                # per-kernel condition, so pass the slot rather than
                # freezing the whole fleet behind one expensive variant
                continue
            break              # shared-budget denial: the pump ends
        return any_swapped

    # ----------------------------------------------------------- prefetch
    def _prefetch(self, m: ManagedTuner, priority: float = 0.0) -> None:
        """Speculatively compile the next 1–2 proposals of ``m``.

        ``SearchStrategy.peek`` exposes the upcoming candidates without
        consuming them; submitting them (speculative) fills the
        generation cache while the current measurement — or plain
        serving — runs, so the tuner's own later request is a hit. The
        compile time is charged to the requesting tuner at completion
        whether or not the variant is ever proposed: prefetch spends real
        compute and the shared budget must see it. Submissions carry the
        kernel's scheduling priority (speculation sorts after requests at
        equal priority in the farm's queue) and stop at the farm's
        per-kernel in-flight cap — rejected prefetches simply retry on a
        later slot.
        """
        if self.generator is None or self.prefetch <= 0:
            return
        t = m.tuner
        if t.explorer.finished or m.state is not TunerState.ACTIVE:
            return
        now = self.clock()
        est = t._cost_ema or 0.0
        for point in t.explorer.peek(self.prefetch):
            # consecutive productive wakes peek the same still-unproposed
            # points: skip ones already resident instead of materializing
            # throwaway hit wrappers (which would also inflate hit stats)
            if (t.compilette.cache is not None
                    and t.compilette.cache_key(point, t.specialization)
                    in t.compilette.cache):
                continue
            if not self._shared_budget_gate(t.accounts, now, est):
                return
            ticket = self.generator.submit(
                t.compilette, point, t.specialization,
                speculative=True, charge_cb=self._speculative_charge(m),
                priority=priority)
            if ticket is None:
                return   # per-kernel cap: this kernel's share is full

    def _speculative_charge(self, m: ManagedTuner):
        """Charge callback billing a prefetch compile to its requester.

        In "thread" mode this runs on the compile worker, so the += on
        the shared accounts must be serialized against the tuning
        thread's own charges (``tuner._lock``) — a lost update here would
        leak budget past ``max_overhead_frac``.
        """

        def charge(ticket: GenerationTicket, seconds: float) -> None:
            # state check and write happen under the coordinator lock —
            # sweep() folds accounts into the tombstone under the same
            # lock, so the charge can never land on an already-folded,
            # discarded accounts object and vanish from the aggregate.
            # Lock order (coordinator -> tuner) matches sweep's
            # abandon_pending path; wake never takes the coordinator
            # lock, so there is no cycle.
            with self._lock:
                if m.state is TunerState.RETIRED:
                    self._retired_accounts.gen_spent_s += seconds
                    self._retired_accounts.tuning_spent_s += seconds
                else:
                    with m.tuner._lock:
                        m.tuner.accounts.gen_spent_s += seconds
                        m.tuner.accounts.tuning_spent_s += seconds

        return charge

    # ----------------------------------------------------------- lifecycle
    def _flush_best(self, m: ManagedTuner) -> None:
        best = m.tuner.explorer.best_point
        if best is not None:
            self.registry.put(
                m.name, m.specialization,
                m.registry_device or self.device,
                best, m.tuner.explorer.best_score,
                strategy=m.tuner.explorer.name,
                traits=m.device_traits,
            )

    def _fold_into_tombstone(self, m: ManagedTuner) -> None:
        m.tuner._update_gains()
        self._accumulate(self._retired_accounts, m.tuner.accounts)

    # ---------------------------------------------------------------- fleet
    def _flush_evals(self, m: ManagedTuner) -> None:
        """Publish new local measurements to the registry's fleet ledger."""
        history = m.tuner.explorer.history
        for point, score_s in history[m.evals_flushed:]:
            if score_s == float("inf"):
                continue   # holes/failures travel via the quarantine table
            self.registry.record_evaluation(
                m.name, m.specialization,
                m.registry_device or self.device, point, score_s)
        m.evals_flushed = len(history)

    def _adopt_fleet_state(self, m: ManagedTuner) -> None:
        """Fold the merged registry back into one live tuner.

        Quarantine first (a peer's verdict beats everything: abort a
        matching canary, demote a matching incumbent), then peer
        evaluations (mark seen — never re-compiled here), then the fleet
        best — injected as a CANDIDATE so it still passes this replica's
        gate/canary before ever serving traffic.
        """
        t = m.tuner
        space = t.compilette.space
        dev = m.registry_device or self.device
        for p in self.registry.quarantined_points(m.name, m.specialization,
                                                  dev):
            if space.contains(p):
                t.adopt_quarantine(p, "fleet quarantine")
        for p in self.registry.evaluated_points(m.name, m.specialization,
                                                dev):
            if space.contains(p):
                t.explorer.mark_seen(p)
        entry = self.registry.best_entry(m.name, m.specialization, dev)
        if entry is not None:
            point, score_s = entry
            if (score_s < t.explorer.best_score
                    and t.explorer.inject_candidate(point)
                    and m.state is TunerState.CONVERGED):
                # new fleet work for an exhausted tuner: wake it back up
                m.state = TunerState.ACTIVE

    def sync_fleet(self) -> bool:
        """One fleet round-trip: publish local state, adopt the merge.

        Local bests and measurement history go into the registry, the
        backend merges that snapshot with every peer's (commutative
        lower-score-wins / quarantine-union join), and the merged state
        is folded back into the registry and every live tuner. Returns
        True when a sync ran.
        """
        if self.registry_backend is None:
            return False
        with self._lock:
            for m in self._managed:
                self._flush_best(m)
                self._flush_evals(m)
        merged = self.registry_backend.sync(self.registry.snapshot())
        self.registry.merge_snapshot(merged)
        self.fleet_syncs += 1
        with self._lock:
            for m in self._managed:
                self._adopt_fleet_state(m)
        return True

    def _maybe_sync(self) -> bool:
        """Sync at the configured cadence (None = every pump)."""
        if self.registry_backend is None:
            return False
        now = self.clock()
        if (self.sync_every_s is not None
                and self._last_sync_s is not None
                and now - self._last_sync_s < self.sync_every_s):
            return False
        self._last_sync_s = now
        return self.sync_fleet()

    def sweep(self) -> list[ManagedTuner]:
        """One lifecycle pass: converge exhausted tuners, evict idle ones.

        Returns the tuners retired by this pass. Called from every
        ``pump`` and at request end (``serve_loop.generate``); cheap —
        O(n_managed) attribute checks.
        """
        now = self.clock()
        retired: list[ManagedTuner] = []
        with self._lock:
            for m in list(self._managed):
                if (m.state is TunerState.ACTIVE
                        and m.tuner.explorer.finished):
                    m.state = TunerState.CONVERGED
                    self._flush_best(m)
                if m.state is TunerState.CONVERGED:
                    # idempotent: serve code may have re-pinned the
                    # evaluator closure on re-register; drop it again
                    release_evaluator_closure(m.tuner)
                if self.lifecycle.should_evict(m.last_used_s, now):
                    m.state = TunerState.RETIRED
                    self._flush_best(m)
                    release_evaluator_closure(m.tuner)
                    # an unharvested compile must still be billed: done
                    # tickets charge the accounts now (folded below),
                    # in-flight ones bill the tombstone at completion
                    m.tuner.abandon_pending(self._speculative_charge(m))
                    self._fold_into_tombstone(m)
                    self._managed.remove(m)
                    self._by_key.pop(
                        (m.name, _canon_spec(m.specialization)), None)
                    self._n_retired += 1
                    retired.append(m)
        return retired

    def maybe_pump(self) -> bool:
        """Cooperative pacing: call once per application step/iteration."""
        self._app_calls += 1
        if self._thread is not None:
            return False
        if self._app_calls % self.pump_every:
            return False
        with spans.span("tune.pump"):
            return self.pump()

    @property
    def finished(self) -> bool:
        """Every CURRENTLY managed tuner has exhausted its space.

        Not a terminal state: serve traffic can register new tuners (or
        re-register evicted ones) at any time, which is why the
        coordinator thread keeps pumping regardless.
        """
        return all(m.tuner.explorer.finished for m in self._managed)

    # ------------------------------------------------------------ threaded
    def start_thread(self, wake_period_s: float = 0.002) -> None:
        """Single per-process tuning thread (replaces one thread/kernel)."""
        if self._thread is not None:
            return

        def _loop() -> None:
            # Runs until stop_thread(): unlike a single autotuner's space,
            # the coordinator's tuner set grows back — serve traffic
            # re-registers after eviction, so "all finished" (or empty
            # after a lull) is not a terminal state. Idle pumps are cheap
            # (one lifecycle sweep + a no-op pick).
            while not self._stop.is_set():
                self.pump()
                self._stop.wait(wake_period_s)

        self._thread = threading.Thread(
            target=_loop, daemon=True, name="tuning-coordinator"
        )
        self._thread.start()

    def stop_thread(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self._stop = threading.Event()

    # --------------------------------------------------------- persistence
    def save_registry(self, path: str | None = None) -> None:
        path = path or self.registry_path
        if path is None:
            return
        # flush current bests before writing (retired tuners were flushed
        # at retirement)
        for m in self._managed:
            self._flush_best(m)
        self.registry.save(path)

    def close(self) -> None:
        self.stop_thread()
        if self.generator is not None:
            self.generator.shutdown()
        # final fleet publish: bests/quarantines found since the last
        # cadenced sync must not die with this replica
        self.sync_fleet()
        self.save_registry()

    # ------------------------------------------------------------- reports
    def stats(self) -> dict[str, Any]:
        agg = self._aggregate_accounts()
        elapsed = self.clock() - self.app_start_s
        return {
            "device": self.device,
            "n_kernels": len(self._managed),
            "regenerations": agg.regenerations,
            "swaps": agg.swaps,
            "tuning_spent_s": agg.tuning_spent_s,
            # component split: tuning_spent_s ≈ gen + eval; the paper's
            # per-component overhead-fraction claim is checkable here,
            # and gen_stall_s isolates what the hot path actually waited
            # for (0 when every compile was overlapped or cache-hit)
            "gen_spent_s": agg.gen_spent_s,
            "gen_stall_s": agg.gen_stall_s,
            "eval_spent_s": agg.eval_spent_s,
            "gen_requests": agg.gen_requests,
            "init_spent_s": agg.init_spent_s,
            "busy_s": agg.busy_s,
            "gained_s": agg.gained_s,
            "overhead_frac": (
                agg.tuning_spent_s / elapsed if elapsed > 0 else 0.0
            ),
            # trusted-swaps rollup: per-kernel entries + retired_accounts
            # below reconcile exactly with these aggregates
            "gate_mode": self.gate_mode,
            "gate_spent_s": agg.gate_spent_s,
            "gate_checks": agg.gate_checks,
            "gate_failures": agg.gate_failures,
            "canary_calls": agg.canary_calls,
            "canary_promotions": agg.canary_promotions,
            "rollbacks": agg.rollbacks,
            "quarantined": agg.quarantined,
            "budget_s": self.policy.budget_s(agg, self.clock()),
            "budget_spent_s": self.policy.spent_s(agg),
            "lifecycle": {
                "active": sum(1 for m in self._managed
                              if m.state is TunerState.ACTIVE),
                "converged": sum(1 for m in self._managed
                                 if m.state is TunerState.CONVERGED),
                "retired": self._n_retired,
            },
            # tombstone breakdown: per-kernel entries below only cover
            # CURRENTLY managed tuners, so per-kernel sums + these retired
            # totals reconcile exactly with the aggregate fields above
            "retired_accounts": {
                f: getattr(self._retired_accounts, f)
                for f in ("tuning_spent_s", "gen_spent_s", "gen_stall_s",
                          "eval_spent_s", "gained_s", "regenerations",
                          "swaps", "gate_spent_s", "gate_checks",
                          "gate_failures", "canary_calls",
                          "canary_promotions", "rollbacks", "quarantined")
            },
            "generation_cache": self.generation_cache.stats(),
            "generation": (self.generator.stats()
                           if self.generator is not None
                           else {"mode": "sync"}),
            "fleet": {
                "replica_id": self.replica_id,
                "replica_count": self.replica_count,
                "backend": (type(self.registry_backend).__name__
                            if self.registry_backend is not None else None),
                "syncs": self.fleet_syncs,
            },
            **self._transfer_stats(),
            "kernels": self._kernel_stats(),
        }

    @staticmethod
    def _regens_to_best(tuner: OnlineAutotuner) -> int | None:
        """1-based history index where the final best score first landed."""
        ex = tuner.explorer
        if ex.best_point is None:
            return None
        for i, (_, score) in enumerate(ex.history, 1):
            if score <= ex.best_score:
                return i
        return None

    def _transfer_stats(self) -> dict[str, Any]:
        """Transfer-plane counters: hits, adoptions, time-to-best.

        ``transfer_hits`` counts seeds injected; ``transfer_adopted``
        counts live tuners whose CURRENT best is one of their own
        transfer seeds (it survived gate/canary and won); and
        ``seeded_regens_to_best`` is the mean regenerations a
        transfer-seeded tuner needed to reach its best — the fig-5-at-
        fleet-scale claim is that this stays ~1 while cold search pays
        the whole enumeration.
        """
        adopted = 0
        regens: list[int] = []
        for m in self._managed:
            if not m.transfer_seed_keys:
                continue
            space = m.tuner.compilette.space
            best = m.tuner.explorer.best_point
            if best is not None and space.key(best) in m.transfer_seed_keys:
                adopted += 1
            r = self._regens_to_best(m.tuner)
            if r is not None:
                regens.append(r)
        return {
            "transfer_enabled": self.transfer,
            "transfer_hits": self.transfer_hits,
            "transfer_adopted": adopted,
            "seeded_regens_to_best": (
                sum(regens) / len(regens) if regens else None),
        }

    def _kernel_stats(self) -> dict[str, dict[str, Any]]:
        out: dict[str, dict[str, Any]] = {}
        for m in self._managed:
            key = m.name
            if key in out:   # same kernel, different specialization
                key = f"{m.name}@{_canon_spec(m.specialization)}"
            out[key] = m.stats()
        return out
