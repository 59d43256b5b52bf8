"""Deterministic traffic-replay harness: the fleet-scale fig7 analogue.

Mirrors ``repro/bench/replay.py`` line for line: the harness is pure
arithmetic on a virtual clock (no tensor is made, no kernel runs), so
the same seeds give the reference's reports exactly.

The paper's workload study (fig7) varies one kernel's workload on one
platform; a serving fleet varies *everything at once* — arrival bursts,
prompt/cache-length mixes, traffic ramps, phase changes, and several
architectures sharing one process. This module synthesizes those
workloads as **seeded, scripted traces** and re-serves them through a
:class:`repro_torch.api.TuningSession` on the :class:`~repro_torch.core.VirtualClock`
with the virtual cost-model kernel backend, so every run is exact clock
arithmetic: two replays with the same seed produce byte-identical
metrics on any host, with zero sleeps.

The moving parts:

  * **arrival processes** — :func:`poisson_arrivals` (steady),
    :func:`bursty_arrivals` (on/off modulated), :func:`ramp_arrivals`
    (linear rate ramp via thinning), :func:`phase_arrivals`
    (piecewise-constant rate phases);
  * **length mixes** — :func:`fixed_mix`, :func:`choice_mix`,
    :func:`longtail_mix` (clipped lognormal, the long-tail prompt/cache
    distribution), :func:`phase_mix` (mid-trace workload change);
  * **traces** — :func:`make_trace` scripts one tenant's requests from a
    :class:`Scenario`; :func:`merge_traces` interleaves several tenants
    into one multi-tenant trace;
  * **the engine** — :func:`replay` advances the session's virtual clock
    to each arrival, serves the request through the tenant's registered
    kernel handles (each call advances the clock by the active variant's
    cost-model score and feeds ``observe_latency`` through the managed
    handle), credits scripted non-kernel work via ``observe_busy``, and
    paces tuning with ``maybe_pump`` — then reports per-tenant
    p50/p99/speedup and session-level overhead/time-to-best/cache-hit
    metrics.

Request latency includes queueing: a burst (or a tuning evaluation)
pushes the clock past later arrivals, so the overhead envelope is
directly visible in the tail quantiles.
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.evaluator import VirtualClockEvaluator
from repro_torch.core.profiles import TPU_V5E, DeviceProfile
from repro_torch.runtime.lifecycle import TunerState, pow2_bucket

__all__ = [
    "Request",
    "Scenario",
    "Trace",
    "bursty_arrivals",
    "choice_mix",
    "fault_injection_hook",
    "fault_scenarios",
    "fixed_mix",
    "fleet_scenarios",
    "longtail_mix",
    "make_trace",
    "merge_traces",
    "phase_arrivals",
    "phase_mix",
    "poisson_arrivals",
    "ramp_arrivals",
    "reference_request_cost_s",
    "replay",
    "replay_scenario",
    "replay_session",
    "replay_tuning_defaults",
]

#: default simulated compile cost per generated variant (seconds) — the
#: same constant the kernel-plane tier-1 tests use
GEN_COST_S = 0.002

#: device label for replay sessions: a fixed fingerprint keeps registry
#: keys (and the emitted JSON) byte-identical across hosts
REPLAY_DEVICE = "fleet:v"


# ========================================================= arrival processes
# Uniform signature: (rng, rate_hz, duration_s, **kwargs) -> sorted times.
def poisson_arrivals(rng: random.Random, rate_hz: float,
                     duration_s: float) -> list[float]:
    """Homogeneous Poisson arrivals: exponential inter-arrival gaps."""
    out: list[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate_hz)
        if t >= duration_s:
            return out
        out.append(t)


def bursty_arrivals(rng: random.Random, rate_hz: float, duration_s: float,
                    *, burst_factor: float = 6.0,
                    burst_frac: float = 0.25,
                    cycle_frac: float = 0.125) -> list[float]:
    """On/off modulated Poisson: lulls punctuated by dense bursts.

    The trace alternates lull/burst windows (``cycle_frac`` of the trace
    each full cycle, ``burst_frac`` of a cycle bursting); rates are
    scaled so the *average* rate stays ``rate_hz`` — burst windows run
    ``burst_factor`` times hotter than lulls.
    """
    cycle = max(duration_s * cycle_frac, 1e-9)
    burst_len = cycle * burst_frac
    lull_len = cycle - burst_len
    # solve lull_rate from the average-rate constraint
    lull_rate = rate_hz * cycle / (lull_len + burst_factor * burst_len)
    burst_rate = burst_factor * lull_rate
    out: list[float] = []
    t0 = 0.0
    bursting = False
    while t0 < duration_s:
        win = burst_len if bursting else lull_len
        rate = burst_rate if bursting else lull_rate
        end = min(t0 + win, duration_s)
        t = t0
        while True:
            t += rng.expovariate(rate)
            if t >= end:
                break
            out.append(t)
        t0 += win
        bursting = not bursting
    return out


def ramp_arrivals(rng: random.Random, rate_hz: float, duration_s: float,
                  *, start_frac: float = 0.25,
                  end_frac: float = 1.75) -> list[float]:
    """Linearly ramping rate (thinning a peak-rate Poisson stream).

    The instantaneous rate ramps ``start_frac*rate_hz`` →
    ``end_frac*rate_hz`` across the trace (mean ``~rate_hz`` for the
    default symmetric fracs).
    """
    peak = rate_hz * max(start_frac, end_frac)
    out: list[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= duration_s:
            return out
        frac = start_frac + (end_frac - start_frac) * (t / duration_s)
        if rng.random() < frac * rate_hz / peak:
            out.append(t)


def phase_arrivals(rng: random.Random, rate_hz: float, duration_s: float,
                   *, phases: Sequence[float] = (1.5, 0.25, 1.25)
                   ) -> list[float]:
    """Piecewise-constant rate phases (abrupt traffic regime changes).

    ``phases`` are per-phase rate multipliers over equal-length windows.
    """
    out: list[float] = []
    phase_len = duration_s / len(phases)
    for i, mult in enumerate(phases):
        t = i * phase_len
        end = min((i + 1) * phase_len, duration_s)
        rate = max(mult * rate_hz, 1e-12)
        while True:
            t += rng.expovariate(rate)
            if t >= end:
                break
            out.append(t)
    return out


# ================================================================ length mixes
# A mix draws one integer length from (rng, phase) where phase ∈ [0, 1)
# is the request's position in the trace — so mixes can themselves shift
# mid-trace (phase_mix).
Mix = Callable[[random.Random, float], int]


def fixed_mix(value: int) -> Mix:
    """Every request gets the same length."""
    return lambda rng, phase: int(value)


def choice_mix(options: Sequence[int],
               weights: Sequence[float] | None = None) -> Mix:
    """Weighted categorical mix (e.g. a bimodal short/long split)."""
    opts = [int(o) for o in options]
    w = list(weights) if weights is not None else None

    def draw(rng: random.Random, phase: float) -> int:
        return rng.choices(opts, weights=w, k=1)[0]

    return draw


def longtail_mix(lo: int, hi: int, *, sigma: float = 1.0) -> Mix:
    """Clipped lognormal around ``lo``: most requests short, a heavy
    tail out to ``hi`` — the long-tail prompt/cache-length shape."""
    mu = math.log(max(lo, 1))

    def draw(rng: random.Random, phase: float) -> int:
        v = int(round(rng.lognormvariate(mu, sigma)))
        return max(lo, min(hi, v))

    return draw


def phase_mix(before: Mix, after: Mix, *, switch_at: float = 0.5) -> Mix:
    """Workload change mid-trace: ``before`` then ``after`` the switch."""
    def draw(rng: random.Random, phase: float) -> int:
        return before(rng, phase) if phase < switch_at else after(rng, phase)

    return draw


# ============================================================ scenario / trace
@dataclasses.dataclass(frozen=True)
class Request:
    """One scripted request of a trace (all times in virtual seconds)."""

    t_arrival_s: float
    tenant: str            # model-config name (the REGISTRY key)
    prompt_len: int        # prefill extent (tokens)
    decode_steps: int      # decode calls against the KV-cache kernel
    host_cost_s: float = 0.0   # scripted non-kernel work (observe_busy)


@dataclasses.dataclass(frozen=True)
class Trace:
    """A deterministic, seeded request script (sorted by arrival)."""

    name: str
    seed: int
    duration_s: float
    tenants: tuple[str, ...]
    requests: tuple[Request, ...]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A traffic shape, independent of any concrete model config.

    ``utilization`` is the target offered load (mean request service
    time x arrival rate); drivers turn it into a per-config rate via
    :func:`reference_request_cost_s`, so a 35B and a tiny encoder see
    the *same relative pressure*. ``target_requests`` sizes the trace
    (expected arrivals), which keeps virtual durations config-adaptive.
    """

    name: str
    arrival: Callable[..., list[float]]
    prompt_mix: Mix
    decode_mix: Mix
    utilization: float = 0.4
    target_requests: int = 320
    host_cost_frac: float = 0.0   # scripted host work per request, as a
    #                               fraction of the reference request cost
    arrival_kwargs: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)
    # Failure injection (seeded, per tuning point — see
    # :func:`fault_injection_hook`): ``compile_fail_rate`` makes drawn
    # points raise at generation time, ``wrong_output_rate`` makes them
    # fail the variant gate's scripted oracle, ``tail_regression_rate``
    # makes them measure fast but serve ``tail_factor`` x slower (the
    # canary's rollback trigger). Empty = clean scenario.
    faults: Mapping[str, Any] = dataclasses.field(default_factory=dict)


def make_trace(scenario: Scenario, tenant: str, rate_hz: float,
               seed: int, *, host_cost_s: float = 0.0) -> Trace:
    """Script one tenant's requests for ``scenario`` at ``rate_hz``.

    Seeding is by *string* (sha512-based), so the trace is identical
    across processes and machines — never ``hash()``-randomized.
    """
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be positive, got {rate_hz}")
    rng = random.Random(f"{seed}:{scenario.name}:{tenant}")
    duration_s = scenario.target_requests / rate_hz
    times = scenario.arrival(rng, rate_hz, duration_s,
                             **dict(scenario.arrival_kwargs))
    requests = []
    for t in times:
        phase = t / duration_s
        requests.append(Request(
            t_arrival_s=t,
            tenant=tenant,
            prompt_len=max(1, int(scenario.prompt_mix(rng, phase))),
            decode_steps=max(0, int(scenario.decode_mix(rng, phase))),
            host_cost_s=float(host_cost_s),
        ))
    return Trace(name=f"{scenario.name}:{tenant}", seed=seed,
                 duration_s=duration_s, tenants=(tenant,),
                 requests=tuple(requests))


def merge_traces(name: str, traces: Sequence[Trace]) -> Trace:
    """Interleave per-tenant traces into one multi-tenant trace."""
    if not traces:
        raise ValueError("merge_traces needs at least one trace")
    requests = sorted(
        (r for tr in traces for r in tr.requests),
        key=lambda r: (r.t_arrival_s, r.tenant))
    tenants = tuple(t for tr in traces for t in tr.tenants)
    return Trace(name=name, seed=traces[0].seed,
                 duration_s=max(tr.duration_s for tr in traces),
                 tenants=tenants, requests=tuple(requests))


def fleet_scenarios(target_requests: int = 320) -> list[Scenario]:
    """The standing scenario set: one per traffic shape the paper's
    fig7 claim must survive (steady, bursty, ramp, phase change)."""
    longtail = longtail_mix(128, 2048, sigma=0.8)
    return [
        Scenario(name="steady_poisson", arrival=poisson_arrivals,
                 prompt_mix=fixed_mix(512), decode_mix=fixed_mix(4),
                 utilization=0.4, target_requests=target_requests),
        Scenario(name="bursty_longtail", arrival=bursty_arrivals,
                 prompt_mix=longtail, decode_mix=choice_mix(
                     (2, 4, 16), weights=(0.6, 0.3, 0.1)),
                 utilization=0.35, target_requests=target_requests),
        Scenario(name="ramp_up", arrival=ramp_arrivals,
                 prompt_mix=longtail, decode_mix=fixed_mix(4),
                 utilization=0.35, target_requests=target_requests,
                 host_cost_frac=0.05),
        Scenario(name="phase_change", arrival=phase_arrivals,
                 prompt_mix=phase_mix(fixed_mix(256), fixed_mix(1024)),
                 decode_mix=phase_mix(fixed_mix(8), fixed_mix(2)),
                 utilization=0.4, target_requests=target_requests),
    ]


# ============================================================ fault injection
def _canon_point(point: Mapping[str, Any]) -> str:
    return json.dumps(dict(point), sort_keys=True, separators=(",", ":"))


def _fault_draw(seed: int, kind: str, kernel: str,
                point: Mapping[str, Any]) -> float:
    """Deterministic uniform draw per (seed, fault kind, kernel, point).

    String-seeded like the traces, so the same points fault on every
    host and the replay report stays byte-identical per seed.
    """
    key = f"fault:{seed}:{kind}:{kernel}:{_canon_point(point)}"
    return random.Random(key).random()


def _safe_base_point(space: Any) -> Mapping[str, Any]:
    """The point the auto-tuner's reference variant is generated from.

    Mirrors ``SearchStrategy.__init__``: the space default, falling back
    to the first valid point when the default is a hole. Faults must
    never hit it — a process that cannot build its reference variant
    has no incumbent to roll back to.
    """
    base = space.default_point()
    if not space.is_valid(base):
        fallback = next(iter(space.iter_valid()), None)
        if fallback is not None:
            base = fallback
    return base


def _point_faulted(seed: int, kind: str, comp: Any,
                   point: Mapping[str, Any], rate: float) -> bool:
    if rate <= 0.0:
        return False
    if _canon_point(point) == _canon_point(_safe_base_point(comp.space)):
        return False
    return _fault_draw(seed, kind, comp.name, point) < rate


def fault_injection_hook(faults: Mapping[str, Any], seed: int,
                         clock: Any) -> Callable[[Any], None]:
    """Compilette hook installing seeded faults (for ``compilette_hook``).

    Three deterministic failure modes, drawn independently per (kernel,
    tuning point) and never hitting the reference base point:

    * ``compile_fail_rate`` — generation raises (the compile-farm /
      harvest failure path: billed, quarantined, hole reported);
    * ``wrong_output_rate`` — the variant gate's scripted oracle
      (``comp.gate_script``) rejects the point (the virtual analogue of
      a miscompiled variant producing wrong numerics);
    * ``tail_regression_rate`` — the generated virtual kernel *lies*:
      it measures at ``tail_lie`` x its honest cost (so the explorer
      adopts it) but every production call advances the clock by
      ``tail_factor`` x the honest cost — exactly the
      fast-in-microbenchmark, slow-in-production variant the canary
      state machine exists to roll back.
    """
    compile_fail = float(faults.get("compile_fail_rate", 0.0))
    wrong_output = float(faults.get("wrong_output_rate", 0.0))
    tail_rate = float(faults.get("tail_regression_rate", 0.0))
    tail_factor = float(faults.get("tail_factor", 4.0))
    tail_lie = float(faults.get("tail_lie", 0.25))

    def hook(comp: Any) -> None:
        if wrong_output > 0.0:
            comp.gate_script = lambda point, _c=comp: not _point_faulted(
                seed, "wrong", _c, point, wrong_output)
        if compile_fail <= 0.0 and tail_rate <= 0.0:
            return
        inner = comp._generate

        def generate(point: Mapping[str, Any], **sp: Any):
            if _point_faulted(seed, "compile", comp, point, compile_fail):
                raise RuntimeError(
                    f"injected compile failure: {comp.name} {dict(point)}")
            fn = inner(dict(point), **sp)
            if not _point_faulted(seed, "tail", comp, point, tail_rate):
                return fn
            honest = getattr(fn, "score_s", None)
            if honest is None:
                return fn        # real backend: nothing to lie about
            extra = honest * max(tail_factor - 1.0, 0.0)

            def lying(*args: Any) -> Any:
                clock.advance(extra)      # serves slow...
                return fn(*args)

            lying.score_s = honest * tail_lie   # ...measures fast
            lying.tag = getattr(fn, "tag", None)
            return lying

        comp._generate = generate

    return hook


def fault_scenarios(target_requests: int = 320) -> list[Scenario]:
    """Failure-injection scenario set for the trusted-swaps gates.

    One scenario per injected failure mode; drivers run these with
    ``gate_mode="canary"`` and assert zero wrong-output calls served,
    at least one gate rejection / rollback, and bounded canary exposure
    (see ``benchmarks/scenario_fleet.py``).
    """
    longtail = longtail_mix(128, 2048, sigma=0.8)
    return [
        # compile-failure holes under burst pressure: billed + quarantined
        # while the serving hot path stays alive
        Scenario(name="faulty_compiles_burst", arrival=bursty_arrivals,
                 prompt_mix=longtail, decode_mix=choice_mix(
                     (2, 4, 16), weights=(0.6, 0.3, 0.1)),
                 utilization=0.35, target_requests=target_requests,
                 faults={"compile_fail_rate": 0.25}),
        # wrong-output variants mid-trace: the gate must reject every one
        # before it serves a single production call
        Scenario(name="wrong_output_variant", arrival=poisson_arrivals,
                 prompt_mix=fixed_mix(512), decode_mix=fixed_mix(4),
                 utilization=0.4, target_requests=target_requests,
                 faults={"wrong_output_rate": 0.3}),
        # measures-fast-serves-slow variants: the canary detects the tail
        # regression and rolls back to the incumbent automatically
        Scenario(name="tail_regression", arrival=poisson_arrivals,
                 prompt_mix=fixed_mix(512), decode_mix=fixed_mix(4),
                 utilization=0.4, target_requests=target_requests,
                 faults={"tail_regression_rate": 0.25, "tail_factor": 4.0,
                         "tail_lie": 0.25}),
    ]


# =========================================================== reference probe
def reference_request_cost_s(
        cfg: Any, scenario: Scenario, *,
        profile: DeviceProfile = TPU_V5E, batch: int = 1) -> float:
    """Cost-model estimate of one reference request (seconds).

    Deterministic probe at the scenario's median shapes: drivers divide
    ``scenario.utilization`` by this to get a per-config arrival rate,
    normalizing offered load across wildly different architectures.
    """
    from repro_torch.kernels.catalog import get_catalog
    from repro_torch.models.model import model_kernel_specs

    rng = random.Random(f"probe:{scenario.name}:{cfg.name}")
    prompts = sorted(scenario.prompt_mix(rng, 0.5) for _ in range(33))
    decodes = sorted(scenario.decode_mix(rng, 0.5) for _ in range(33))
    prompt, decode = prompts[16], decodes[16]
    seq_b = pow2_bucket(max(prompt, 1))
    max_b = pow2_bucket(prompt + decode) if decode else None
    catalog = get_catalog()
    total = 0.0
    for name, spec in model_kernel_specs(
            cfg, batch=batch, seq=seq_b, max_len=max_b):
        comp = catalog.compilette(name, spec)
        if comp.cost_model is None:
            continue
        point = next(iter(comp.space.iter_valid()), None)
        if point is None:
            continue
        mult = decode if name == "decode_attention" else 1
        total += comp.simulate(point, profile) * mult
    if total <= 0.0:
        raise ValueError(
            f"config {cfg.name!r} has no tunable kernel with a cost "
            f"model at scenario {scenario.name!r} shapes")
    return total


# ================================================================= the engine
def _quantile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank quantile on a pre-sorted list (exact arithmetic)."""
    if not sorted_vals:
        return 0.0
    i = max(0, min(len(sorted_vals) - 1,
                   math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[i]


def _snap_unit(ratio: float, tol: float = 1e-9) -> float:
    """Snap a ratio within ``tol`` of 1.0 to exactly 1.0."""
    return 1.0 if abs(ratio - 1.0) < tol else ratio


def replay(session: Any, trace: Trace,
           configs: Mapping[str, Any] | None = None,
           *, batch: int = 1) -> dict[str, Any]:
    """Re-serve a scripted trace through ``session``, deterministically.

    The session must run on an advanceable clock (``VirtualClock``):
    idle gaps, kernel calls, scripted host work and tuning evaluations
    all move the same simulated timeline, so latency quantiles, the
    overhead fraction and time-to-best come out as exact arithmetic.

    ``configs`` maps tenant name → ``ModelConfig``; by default the names
    resolve through ``repro_torch.configs.get_config``. Kernel handles are
    registered lazily per (tenant, seq-bucket, cache-bucket) cell via
    ``session.attach_kernels`` — the cold-start registration (including
    its reference measurement) lands in that request's latency, exactly
    like first-traffic in a serving process.
    """
    clock = session.coordinator.clock
    if not hasattr(clock, "advance"):
        raise TypeError(
            "replay() needs a session on an advanceable VirtualClock "
            "(TuningSession(..., clock=VirtualClock())); refusing to "
            "fake wall time")
    if configs is None:
        from repro_torch.configs import get_config
        configs = {t: get_config(t) for t in trace.tenants}

    lifecycle = session.coordinator.lifecycle
    t0 = clock()
    # (tenant, seq_bucket, cache_bucket) -> (prefill handles, decode handles)
    cells: dict[tuple, tuple[list, list]] = {}

    def handles_for(req: Request) -> tuple[list, list]:
        from repro_torch.models.model import model_kernel_specs

        cfg = configs[req.tenant]
        seq_b = lifecycle.bucket_length(max(int(req.prompt_len), 1))
        cache = req.prompt_len + req.decode_steps
        max_b = (lifecycle.bucket_length(max(int(cache), 1))
                 if req.decode_steps else None)
        cell = (req.tenant, seq_b, max_b)
        got = cells.get(cell)
        if got is not None and all(
                h.state is not TunerState.RETIRED
                for part in got for _, h in part):
            return got
        plane = session.attach_kernels(
            cfg, batch=batch, seq=seq_b, max_len=max_b)
        prefill: list = []
        decode: list = []
        for name, spec in model_kernel_specs(
                cfg, batch=batch, seq=seq_b, max_len=max_b):
            h = plane.register_spec(name, spec, require=False)
            if h is None:
                continue   # untunable at this spec: served untuned
            (decode if name == "decode_attention" else prefill).append(
                (name, h))
        cells[cell] = (prefill, decode)
        return cells[cell]

    latencies: dict[str, list[float]] = {t: [] for t in trace.tenants}
    ref_s: dict[str, float] = {t: 0.0 for t in trace.tenants}
    busy_s: dict[str, float] = {t: 0.0 for t in trace.tenants}
    host_total_s = 0.0
    last_swap_s: float | None = None
    # fault-injection bookkeeping (installed by replay_scenario): counts
    # production calls served by a variant the scenario scripted to be
    # wrong-output — the trusted-swaps gate requires this stays ZERO
    fault_seed, faults = getattr(session, "_replay_faults", (0, {}))
    wrong_rate = float(faults.get("wrong_output_rate", 0.0))
    served_wrong_calls = 0

    def timed_call(handle: Any, tenant: str) -> None:
        nonlocal served_wrong_calls
        c0 = clock()
        handle(0)
        busy_s[tenant] += clock() - c0
        ref_s[tenant] += handle.tuner.reference_score_s
        if wrong_rate > 0.0:
            served = handle.tuner.last_served_point
            if served is not None and _point_faulted(
                    fault_seed, "wrong", handle.tuner.compilette,
                    served, wrong_rate):
                served_wrong_calls += 1

    for req in trace.requests:
        arrival = t0 + req.t_arrival_s
        now = clock()
        if arrival > now:
            clock.advance(arrival - now)        # idle until the arrival
        prefill, decode = handles_for(req)      # cold cells register here
        for _, h in prefill:
            timed_call(h, req.tenant)
        for _ in range(req.decode_steps):
            for _, h in decode:
                timed_call(h, req.tenant)
        if req.host_cost_s > 0.0:
            clock.advance(req.host_cost_s)      # scripted non-kernel work
            session.observe_busy(req.host_cost_s)
            host_total_s += req.host_cost_s
        latencies[req.tenant].append(clock() - arrival)
        if session.maybe_pump():                # True: this slot swapped
            last_swap_s = clock() - t0

    stats = session.stats()
    cache = stats["generation_cache"]
    tuning_spent = stats["tuning_spent_s"]
    init_spent = stats["init_spent_s"]
    busy_total = stats["busy_s"]
    ref_total = sum(ref_s.values()) + host_total_s
    all_in_denominator = busy_total + tuning_spent + init_spent
    per_tenant: dict[str, dict[str, Any]] = {}
    for tenant in trace.tenants:
        lat = sorted(latencies[tenant])
        per_tenant[tenant] = {
            "n_requests": len(lat),
            "p50_s": _quantile(lat, 0.50),
            "p99_s": _quantile(lat, 0.99),
            "mean_s": sum(lat) / len(lat) if lat else 0.0,
            "ref_s": ref_s[tenant],
            "busy_s": busy_s[tenant],
            # active variants only ever swap to strictly faster ones, so
            # this is >= 1.0 by construction — the CI gate checks it
            # (snapped: never-swapped handles accumulate ref_s and
            # busy_s in different orders, drifting ~1 ulp below 1.0)
            "speedup_vs_ref": _snap_unit(
                ref_s[tenant] / busy_s[tenant]
                if busy_s[tenant] > 0 else 1.0),
            "n_handles": len({
                id(h)
                for (t, _, _), parts in cells.items() if t == tenant
                for part in parts for _, h in part}),
        }
    return {
        "trace": {
            "name": trace.name,
            "seed": trace.seed,
            "n_requests": len(trace.requests),
            "duration_s": trace.duration_s,
            "tenants": list(trace.tenants),
        },
        "per_tenant": per_tenant,
        "tuning": {
            "tuning_spent_s": tuning_spent,
            "gen_spent_s": stats["gen_spent_s"],
            "gen_stall_s": stats["gen_stall_s"],
            "eval_spent_s": stats["eval_spent_s"],
            "init_spent_s": init_spent,
            "busy_s": busy_total,
            "gained_s": stats["gained_s"],
            "swaps": stats["swaps"],
            "regenerations": stats["regenerations"],
            # tuning work as a share of total productive runtime — the
            # paper's 0.2–4.2 % envelope, fleet-checked (the reference
            # measurement is reported separately as init_spent_s: the
            # reference variant must be built to serve at all)
            "overhead_pct": (
                100.0 * tuning_spent / (busy_total + tuning_spent)
                if busy_total + tuning_spent > 0 else 0.0),
            "cache_hit_rate": cache["hit_rate"],
            "cache_hits": cache["hits"],
            "cache_misses": cache["misses"],
            "time_to_best_s": last_swap_s,
            # every overhead charged, init included: < 1.0 means this
            # trace was too short for tuning to pay for itself (fig7's
            # crossover), > 1.0 means net win all-in
            "speedup_all_in": (ref_total / all_in_denominator
                               if all_in_denominator > 0 else 1.0),
            # trusted swaps: oracle-gate + canary counters (all zero in
            # gate_mode="off") and the fault-injection correctness gate
            "gate_mode": stats["gate_mode"],
            "gate_spent_s": stats["gate_spent_s"],
            "gate_checks": stats["gate_checks"],
            "gate_failures": stats["gate_failures"],
            "canary_calls": stats["canary_calls"],
            "canary_promotions": stats["canary_promotions"],
            "rollbacks": stats["rollbacks"],
            "quarantined": stats["quarantined"],
            "served_wrong_calls": served_wrong_calls,
        },
    }


# ========================================================== session builders
def replay_tuning_defaults() -> "Any":
    """Serving-grade session config for replay runs: strict busy-time
    budget (4 % cap keeps the reported overhead under the 5 % gate with
    margin), pow2 bucketing, no idle eviction (traces are short), tight
    pump cadence, async generation."""
    from repro_torch.api import TuningConfig

    return TuningConfig(
        max_overhead=0.04, invest=0.0, budget_from="busy",
        charge_init=False, seq_buckets=True, idle_evict_s=None,
        pump_every=2, async_generation=True, prefetch=1,
        kernel_tuning="kernel", cache_entries=4096)


def replay_session(clock: Any, *, config: Any | None = None,
                   profile: DeviceProfile = TPU_V5E,
                   gen_cost_s: float = GEN_COST_S,
                   device: str = REPLAY_DEVICE,
                   registry: Any | None = None,
                   registry_backend: Any | None = None,
                   compilette_hook: Callable[[Any], None] | None = None,
                   ) -> "Any":
    """A ``TuningSession`` on the virtual cost-model kernel backend."""
    from repro_torch.api import TuningSession

    return TuningSession(
        config if config is not None else replay_tuning_defaults(),
        clock=clock, device=device, registry=registry,
        registry_backend=registry_backend,
        virtual=(clock, profile), gen_cost_s=gen_cost_s,
        evaluator_factory=lambda comp: VirtualClockEvaluator(clock),
        compilette_hook=compilette_hook)


def replay_scenario(scenario: Scenario, configs: Mapping[str, Any],
                    *, seed: int = 0, batch: int = 1,
                    profile: DeviceProfile = TPU_V5E,
                    gen_cost_s: float | None = None,
                    config: Any | None = None) -> dict[str, Any]:
    """One scenario end to end: fresh clock + session, per-config rates
    from the reference probe, multi-tenant merge when ``configs`` has
    several entries, replay, close. Returns the :func:`replay` report.

    ``gen_cost_s=None`` scales the simulated compile cost to half the
    *cheapest* tenant's reference request (capped at :data:`GEN_COST_S`):
    the paper's compilettes generate machine code in time proportional
    to kernel size, so a tiny encoder must not pay a 35B model's
    compile bill — and the overhead envelope stays comparable across
    the fleet.
    """
    from repro_torch.core.evaluator import VirtualClock

    n_tenants = len(configs)
    if n_tenants == 0:
        raise ValueError("replay_scenario needs at least one config")
    ref_costs = {
        name: reference_request_cost_s(
            configs[name], scenario, profile=profile, batch=batch)
        for name in sorted(configs)}
    if gen_cost_s is None:
        gen_cost_s = min(GEN_COST_S,
                         max(1e-6, 0.5 * min(ref_costs.values())))
    traces = []
    for name, ref_cost in ref_costs.items():
        rate_hz = scenario.utilization / n_tenants / ref_cost
        traces.append(make_trace(
            scenario, name, rate_hz, seed,
            host_cost_s=scenario.host_cost_frac * ref_cost))
    trace = (traces[0] if n_tenants == 1
             else merge_traces(scenario.name, traces))
    clock = VirtualClock()
    hook = (fault_injection_hook(scenario.faults, seed, clock)
            if scenario.faults else None)
    session = replay_session(clock, config=config, profile=profile,
                             gen_cost_s=gen_cost_s, compilette_hook=hook)
    # replay() reads this back to count wrong-output calls served (the
    # same deterministic draws the hook's scripted gate uses)
    session._replay_faults = (seed, dict(scenario.faults))
    try:
        return session.replay(trace, dict(configs), batch=batch)
    finally:
        session.close()
