"""Fleet fabric: N tuning replicas sharing one registry backend.

The port's copy of ``benchmarks/fleet_fabric.py``: the same virtual-clock run
(no tensor is made and no card is used) through ``repro_torch``, whose
JSON (``bench_artifacts/torch_fleet_fabric.json``) equals the reference's.

The same four-kernel serving scenario as ``compile_farm.py`` replayed
through N in {1, 2, 4} virtual-clock replicas wired to a single
``FleetBus`` backend and one shared compiled-variant cache (the
in-process analogue of a shared artifact store). Each replica owns a
hash stripe of every kernel's tuning space (``partition(i, N)``), peers'
published evaluations count as seen, and a peer's published best enters
each replica as a CANDIDATE through the normal gate/canary path — never
as a blind incumbent. Exploration is therefore paid once per fleet while
every replica converges to the fleet-wide best variant.

CI smoke assertions (all deterministic on the VirtualClock):

  * fleet-wide time-to-best (virtual time until EVERY replica serves the
    global best of every kernel) at N=4 beats N=1 by >= 2x;
  * the fleet compiles each variant once: shared-cache misses at N=2 and
    N=4 equal the N=1 count exactly;
  * per-replica tuning overhead stays <= 5% of runtime at every N;
  * two same-seed runs are byte-identical at every N (per-replica stats
    compare equal as JSON);
  * fault fleet: a wrong-output variant condemned by the replica that
    owns it serves ZERO production calls on every replica, is quarantined
    fleet-wide after one sync, and stays condemned for a fresh replica
    restarting from the merged on-disk registry (SharedFileBackend).

    PYTHONPATH=src python benchmarks/torch_fleet_fabric.py [--quick] [--seed N]
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, "src")
sys.path.insert(0, os.path.dirname(__file__))

from torch_common import save, table  # noqa: E402

from repro_torch.core import (  # noqa: E402
    Compilette,
    FleetBus,
    GenerationCache,
    Param,
    RegenerationPolicy,
    SharedFileBackend,
    TPU_V5E,
    TunedRegistry,
    VirtualClock,
    VirtualClockEvaluator,
    point_stripe,
    product_space,
    virtual_kernel,
)
from repro_torch.runtime.coordinator import TuningCoordinator
from repro_torch.runtime.kernel_plane import KernelTuningPlane

DEVICE = "bench:virtual"
GEN_COST_S = 0.001          # declared compile cost per variant
STEP_BUSY_S = 0.010         # serving step each replica's budget accrues from
SYNC_EVERY_S = 0.25         # fleet sync cadence (virtual seconds)
FLEET_SWEEP = (1, 2, 4)
MAX_OVERHEAD_PCT = 5.0
MIN_SPEEDUP = 2.0

SPECS = {
    "matmul": {"M": 256, "N": 256, "K": 256, "dtype": "float32"},
    "attention": {"B": 2, "Tq": 128, "Tkv": 128, "H": 4, "Hk": 2,
                  "Dh": 32, "causal": True, "dtype": "float32"},
    "rmsnorm": {"N": 512, "d": 256, "dtype": "float32"},
    "euclid": {"N": 128, "M": 64, "D": 32, "dtype": "float32"},
}


def run_fleet(n_replicas, *, iters=60000, backend=None, gen_cache=None):
    """One fleet lifetime: N replicas, lockstep traffic, shared backend.

    Every replica sees the FULL serving traffic (the fleet replicates a
    service, it does not shard requests) and runs the identical tuning
    config; only ``replica_id`` differs. The search strategy is
    ``random`` — exhaustive on these spaces, so the stripes are jointly
    exhaustive and the N=1 final best IS the global best.
    """
    backend = backend if backend is not None else FleetBus()
    gen_cache = gen_cache if gen_cache is not None else GenerationCache(
        max_entries=4096)
    replicas = []
    for rid in range(n_replicas):
        clock = VirtualClock()
        coord = TuningCoordinator(
            policy=RegenerationPolicy(
                max_overhead_frac=0.04, invest_frac=0.0, budget_from="busy"),
            registry=TunedRegistry(), device=DEVICE, clock=clock,
            strategy="random", async_generation=True,
            generation_cache=gen_cache, prefetch=1, compile_workers=1,
            replica_id=rid, replica_count=n_replicas,
            registry_backend=backend, sync_every_s=SYNC_EVERY_S)
        plane = KernelTuningPlane(
            coord, virtual=(clock, TPU_V5E), gen_cost_s=GEN_COST_S,
            evaluator_factory=lambda c, _clock=clock: VirtualClockEvaluator(
                _clock))
        handles = {n: plane.register_spec(n, s) for n, s in SPECS.items()}
        replicas.append({
            "clock": clock, "coord": coord, "handles": handles,
            # per-kernel timeline of best-SCORE improvements:
            # (virtual_s, score). Scores, not points: the cost model has
            # tied optima (e.g. lookahead-invariant kernels), and each
            # stripe legitimately keeps its own tie-winner — the fleet
            # converges on the best score, not one canonical point.
            "best_log": {n: [] for n in SPECS},
        })

    def record_bests(rep):
        for n, h in rep["handles"].items():
            score = h.tuner.explorer.best_score
            log = rep["best_log"][n]
            if score != float("inf") and (not log or score < log[-1][1]):
                log.append((rep["clock"](), score))

    def settled():
        # exploration drained everywhere AND every replica agrees on the
        # best score of every kernel (a strictly better peer best keeps
        # getting injected — and injection flips finished back to False —
        # so agreement + finished means propagation is complete)
        for rep in replicas:
            if not all(h.tuner.explorer.finished
                       for h in rep["handles"].values()):
                return False
        for n in SPECS:
            scores = [rep["handles"][n].tuner.explorer.best_score
                      for rep in replicas]
            if any(s != scores[0] for s in scores):
                return False
        return True

    done_at = None
    for i in range(iters):
        for rep in replicas:
            for h in rep["handles"].values():
                h(i)
            rep["clock"].advance(STEP_BUSY_S)
            rep["coord"].observe_busy(STEP_BUSY_S)
            rep["coord"].pump()
            record_bests(rep)
        if settled():
            done_at = i
            break
    for rep in replicas:
        rep["coord"].sync_fleet()

    return {
        "n_replicas": n_replicas,
        "done_at_iter": done_at,
        "cache": gen_cache.stats(),
        "replicas": [{
            "stats": rep["coord"].stats(),
            "best": {n: h.tuner.explorer.best_point
                     for n, h in rep["handles"].items()},
            "best_score": {n: h.tuner.explorer.best_score
                           for n, h in rep["handles"].items()},
            "best_log": rep["best_log"],
        } for rep in replicas],
    }


def fleet_time_to_best(run, targets):
    """Virtual time until EVERY replica serves the global best score.

    Per replica: the latest first-time-at-target over its kernels; fleet:
    the max over replicas (the fleet serves the best only once its
    slowest member does). Returns None if any replica never got there.
    """
    per_replica = []
    for rep in run["replicas"]:
        at = []
        for name, target in targets.items():
            hit = next((t for t, s in rep["best_log"][name]
                        if s <= target), None)
            if hit is None:
                return None
            at.append(hit)
        per_replica.append(max(at))
    return max(per_replica)


def replica_digest(run):
    """The determinism fingerprint: everything observable, JSON-stable."""
    return json.dumps(
        [{"stats": rep["stats"], "best": rep["best"],
          "best_log": rep["best_log"]} for rep in run["replicas"]],
        sort_keys=True, default=str)


# ------------------------------------------------------------- fault fleet
def _fault_compilette(clock, name, bad):
    """4-point space; ``bad`` is the fastest-measuring point but fails
    the output oracle — the dangerous case the gate must catch."""
    sp = product_space([Param("unroll", (1, 2, 4, 8), phase=1,
                              switch_rank=0)])

    def gen(point, **spec):
        return virtual_kernel(clock, 0.010 / point["unroll"], tag=dict(point))

    comp = Compilette(name, sp, gen)
    comp.gate_script = lambda point: dict(point) != bad
    return comp


def run_fault_fleet(registry_dir):
    """Two replicas + a restart on a SharedFileBackend, wrong-output fault.

    The replica that owns the bad point discovers the oracle failure and
    condemns it; after one sync the peer must never propose, canary or
    serve it; a THIRD replica restarting from the merged on-disk registry
    must come up with the point already condemned.
    """
    path = os.path.join(registry_dir, "fleet_tuned.json")
    bad = {"unroll": 8}
    owner = point_stripe(bad, 2)

    replicas = []
    for rid in range(2):
        clock = VirtualClock()
        backend = SharedFileBackend(path)   # own instance, shared file
        coord = TuningCoordinator(
            policy=RegenerationPolicy(max_overhead_frac=1.0, invest_frac=1.0),
            registry=TunedRegistry(), device=DEVICE, clock=clock,
            gate_mode="canary", canary_fraction=0.5, canary_calls=4,
            replica_id=rid, replica_count=2,
            registry_backend=backend, sync_every_s=None)
        m = coord.register(
            "k", _fault_compilette(clock, "k", bad),
            VirtualClockEvaluator(clock),
            reference_fn=virtual_kernel(clock, 0.010))
        replicas.append({"clock": clock, "coord": coord, "m": m})

    for i in range(400):
        for rep in replicas:
            rep["m"](i)
            rep["clock"].advance(STEP_BUSY_S)
            rep["coord"].observe_busy(STEP_BUSY_S)
            rep["coord"].pump()
    for rep in replicas:
        rep["coord"].sync_fleet()
        rep["coord"].close()

    # restart: a fresh replica seeded from the merged on-disk registry
    clock3 = VirtualClock()
    reg3 = TunedRegistry()
    coord3 = TuningCoordinator(
        policy=RegenerationPolicy(max_overhead_frac=1.0, invest_frac=1.0),
        registry=reg3, device=DEVICE, clock=clock3, gate_mode="canary",
        replica_id=0, replica_count=2,
        registry_backend=SharedFileBackend(path), sync_every_s=None)
    m3 = coord3.register(
        "k", _fault_compilette(clock3, "k", bad),
        VirtualClockEvaluator(clock3),
        reference_fn=virtual_kernel(clock3, 0.010))

    rows, violations = [], []
    for rid, rep in enumerate(replicas):
        t = rep["m"].tuner
        wrong_calls = sum(life.calls for life in t._lives
                          if dict(life.point or {}) == bad)
        s = t.stats()
        rows.append({
            "replica": rid,
            "owns_bad": rid == owner,
            "active": s["active_point"],
            "wrong_calls": wrong_calls,
            "gate_failures": s["gate_failures"],
            "quarantined_local": t.explorer.is_quarantined(bad),
        })
        if wrong_calls != 0:
            violations.append(
                f"fault replica {rid}: {wrong_calls} production calls "
                "served by the wrong-output variant (must be 0)")
        if not t.explorer.is_quarantined(bad):
            violations.append(
                f"fault replica {rid}: bad point not quarantined "
                "after sync")
        if s["active_point"] == bad:
            violations.append(f"fault replica {rid}: serving the bad point")
        if rid != owner and any(dict(p) == bad
                                for p, _ in t.explorer.history):
            violations.append(
                f"fault replica {rid}: evaluated a point its peer "
                "condemned (compiled twice per fleet)")
    # exactly one replica (the stripe owner) paid the gate failure
    if sum(r["gate_failures"] for r in rows) != 1:
        violations.append(
            f"fault fleet: expected exactly 1 gate failure fleet-wide, "
            f"got {[r['gate_failures'] for r in rows]}")
    if not m3.tuner.explorer.is_quarantined(bad):
        violations.append(
            "fault restart: merged registry did not carry the fleet "
            "quarantine across restart")
    return {"rows": rows, "restart_quarantined":
            m3.tuner.explorer.is_quarantined(bad),
            "violations": violations}


# ------------------------------------------------------------------- main
def run(quick=False, seed=0, write=True):
    iters = 20000 if quick else 60000
    rows, runs, violations = [], {}, []

    for n in FLEET_SWEEP:
        r = run_fleet(n, iters=iters)
        runs[n] = r
        if r["done_at_iter"] is None:
            violations.append(f"N={n}: fleet never settled in {iters} iters")
            continue
        # determinism: an identical second fleet must be byte-identical
        r2 = run_fleet(n, iters=iters)
        if replica_digest(r) != replica_digest(r2):
            violations.append(f"N={n}: two same-seed runs differ")
        for rid, rep in enumerate(r["replicas"]):
            pct = 100.0 * rep["stats"]["overhead_frac"]
            if pct > MAX_OVERHEAD_PCT:
                violations.append(
                    f"N={n} replica {rid}: tuning overhead {pct:.2f}% "
                    f"> {MAX_OVERHEAD_PCT}%")

    targets = runs[1]["replicas"][0]["best_score"] if 1 in runs else {}
    for n in FLEET_SWEEP:
        r = runs[n]
        for rid, rep in enumerate(r["replicas"]):
            if rep["best_score"] != targets:
                violations.append(
                    f"N={n} replica {rid}: final best scores diverge from "
                    f"the global best: {rep['best_score']} != {targets}")
        ttb = fleet_time_to_best(r, targets)
        if ttb is None:
            violations.append(f"N={n}: some replica never reached the "
                              "global best")
        r["time_to_best"] = ttb
        rows.append({
            "replicas": n,
            "time_to_best_s": ttb,
            "fleet_compiles": r["cache"]["misses"],
            "cache_hits": r["cache"]["hits"],
            "syncs": sum(rep["stats"]["fleet"]["syncs"]
                         for rep in r["replicas"]),
            "max_overhead_pct": max(
                100.0 * rep["stats"]["overhead_frac"]
                for rep in r["replicas"]),
        })

    # the fleet compiles each variant exactly once: every fleet size pays
    # the same number of shared-cache misses as a lone replica
    base_compiles = runs[1]["cache"]["misses"]
    for n in FLEET_SWEEP[1:]:
        if runs[n]["cache"]["misses"] != base_compiles:
            violations.append(
                f"N={n}: fleet compiled {runs[n]['cache']['misses']} "
                f"variants, lone replica compiled {base_compiles} "
                "(must be equal)")

    speedup = None
    if runs[1].get("time_to_best") and runs[4].get("time_to_best"):
        speedup = runs[1]["time_to_best"] / runs[4]["time_to_best"]
        if speedup < MIN_SPEEDUP:
            violations.append(
                f"N=4 fleet time-to-best speedup {speedup:.2f}x "
                f"< {MIN_SPEEDUP}x vs N=1")

    with tempfile.TemporaryDirectory() as d:
        fault = run_fault_fleet(d)
    violations.extend(fault["violations"])

    payload = {
        "seed": seed,
        "quick": quick,
        "gates": {"min_speedup": MIN_SPEEDUP,
                  "max_overhead_pct": MAX_OVERHEAD_PCT,
                  "compile_once_per_fleet": True},
        "rows": rows,
        "speedup_n4": speedup,
        "fault": fault,
        "violations": violations,
    }

    print(table(rows, ["replicas", "time_to_best_s", "fleet_compiles",
                       "cache_hits", "syncs", "max_overhead_pct"],
                title="fleet fabric sweep (virtual seconds)"))
    print()
    print(table(fault["rows"],
                ["replica", "owns_bad", "active", "wrong_calls",
                 "gate_failures", "quarantined_local"],
                title="fault fleet — wrong-output variant, 2 replicas"))
    if violations:
        print("\nGATE VIOLATIONS:")
        for v in violations:
            print(f"  {v}")
    else:
        print(f"\nfleet time-to-best: {runs[1]['time_to_best']:.3f}s (N=1)"
              f" -> {runs[4]['time_to_best']:.3f}s (N=4), "
              f"{speedup:.2f}x faster; {base_compiles} compiles at every "
              f"N (once per fleet); overhead <= {MAX_OVERHEAD_PCT}% per "
              "replica; fault fleet served zero wrong calls and the "
              "quarantine survived restart")
    if write:
        save("fleet_fabric", payload)
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="shorter settle cap (CI); same fleet grid")
    ap.add_argument("--seed", type=int, default=0,
                    help="recorded in the artifact; the virtual fabric "
                         "itself is deterministic by construction")
    args = ap.parse_args(argv)
    payload = run(quick=args.quick, seed=args.seed)
    return 1 if payload["violations"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
