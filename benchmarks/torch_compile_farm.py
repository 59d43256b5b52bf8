"""Compile farm: cold-start time-to-best vs worker count, M in {1, 2, 4}.

The port's copy of ``benchmarks/compile_farm.py``: the same virtual-clock run
(no tensor is made and no card is used) through ``repro_torch``, whose
JSON (``bench_artifacts/torch_compile_farm.json``) equals the reference's.

Deterministic on the VirtualClock: four catalog kernels (matmul,
attention, rmsnorm, euclid) tune in *virtual* mode under one shared
budget while a serving loop accrues busy time. The coordinator's farm
runs in ``"manual"`` mode with max-overlap semantics — one pump
completes one batch of up to M compiles whose wall time hides inside
the serving interval, so M workers let M kernels make progress per
pump instead of one.

CI smoke assertions:

  * time-to-best (virtual time until EVERY kernel finished exploring)
    shrinks monotonically with M, and M=4 beats M=1 by >= 2x;
  * ``gen_stall_s == 0`` at every M: no compile ever blocked serving;
  * two same-seed cold runs are byte-identical at every M (stats and
    farm counters compare equal as JSON);
  * per-kernel gen/stall/eval accounting sums into the aggregate
    exactly (|diff| < 1e-9);
  * a warm replay (same registry + generation cache) is a 100%
    cache hit: every kernel back on its best variant after one
    re-validating regeneration, zero compile charge, zero stall.

    PYTHONPATH=src python benchmarks/torch_compile_farm.py
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, "src")
sys.path.insert(0, os.path.dirname(__file__))

from torch_common import save, table

from repro_torch.core import (
    GenerationCache,
    RegenerationPolicy,
    TPU_V5E,
    VirtualClock,
    VirtualClockEvaluator,
)
from repro_torch.runtime.coordinator import TuningCoordinator
from repro_torch.runtime.kernel_plane import KernelTuningPlane

DEVICE = "bench:virtual"
GEN_COST_S = 0.001          # declared compile cost per variant
STEP_BUSY_S = 0.010         # the serving step the compiles overlap with
WORKER_SWEEP = (1, 2, 4)

SPECS = {
    "matmul": {"M": 256, "N": 256, "K": 256, "dtype": "float32"},
    "attention": {"B": 2, "Tq": 128, "Tkv": 128, "H": 4, "Hk": 2,
                  "Dh": 32, "causal": True, "dtype": "float32"},
    "rmsnorm": {"N": 512, "d": 256, "dtype": "float32"},
    "euclid": {"N": 128, "M": 64, "D": 32, "dtype": "float32"},
}


def run_process(workers, *, clock, gen_cache, registry_path,
                targets=None, iters=30000):
    """One process lifetime over the 4-kernel serve traffic.

    ``targets`` (kernel -> point) makes this a WARM run: per-kernel
    regens/compile-bill are recorded the moment the kernel is running
    that target variant again.
    """
    t_start = clock()
    coord = TuningCoordinator(
        policy=RegenerationPolicy(max_overhead_frac=0.5, invest_frac=0.5),
        registry_path=registry_path, device=DEVICE, clock=clock,
        async_generation=True, generation_cache=gen_cache,
        prefetch=2, compile_workers=workers)
    plane = KernelTuningPlane(
        coord, virtual=(clock, TPU_V5E), gen_cost_s=GEN_COST_S,
        evaluator_factory=lambda c: VirtualClockEvaluator(clock))
    handles = {n: plane.register_spec(n, s) for n, s in SPECS.items()}

    finished_at = {}
    at_target = {n: None for n in handles}
    for i in range(iters):
        for n, h in handles.items():
            h(i)
            if (targets is not None and at_target[n] is None
                    and h.tuner.accounts.regenerations >= 1
                    and h.tuner.explorer.best_point == targets[n]):
                at_target[n] = {
                    "regens": h.tuner.accounts.regenerations,
                    "gen_s": h.tuner.accounts.gen_spent_s,
                    "stall_s": h.tuner.accounts.gen_stall_s,
                }
        # the serving step: busy time the budget accrues from, and the
        # interval the farm's compile batches overlap with
        clock.advance(STEP_BUSY_S)
        coord.observe_busy(STEP_BUSY_S)
        coord.pump()
        for n, h in handles.items():
            if n not in finished_at and h.tuner.explorer.finished:
                finished_at[n] = clock() - t_start
        if len(finished_at) == len(handles):
            break
    coord.save_registry()
    return {
        "stats": coord.stats(),
        "farm": coord.generator.stats(),
        "best": {n: h.tuner.explorer.best_point
                 for n, h in handles.items()},
        "warm": {n: h.warm_started for n, h in handles.items()},
        "finished_at": finished_at,
        "time_to_best": max(finished_at.values()) if finished_at else None,
        "at_target": at_target,
    }


def cold_run(workers):
    clock = VirtualClock()
    with tempfile.TemporaryDirectory() as d:
        return run_process(
            workers, clock=clock, gen_cache=GenerationCache(),
            registry_path=os.path.join(d, "tuned.json"))


def main() -> None:
    rows, results = [], {}
    for workers in WORKER_SWEEP:
        r = cold_run(workers)
        results[workers] = r
        assert r["time_to_best"] is not None, (
            f"M={workers}: kernels never finished exploring")

        # determinism: an identical second run must be byte-identical
        r2 = cold_run(workers)
        for field in ("stats", "farm"):
            a = json.dumps(r[field], sort_keys=True, default=str)
            b = json.dumps(r2[field], sort_keys=True, default=str)
            assert a == b, f"M={workers}: non-deterministic {field}"

        # warm replay on the cold run's registry + compiled-variant cache
        clock = VirtualClock()
        gen_cache = GenerationCache()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "tuned.json")
            cold = run_process(workers, clock=clock, gen_cache=gen_cache,
                               registry_path=path)
            warm = run_process(workers, clock=clock, gen_cache=gen_cache,
                               registry_path=path, targets=cold["best"])

        s, f = r["stats"], r["farm"]
        rows.append({
            "workers": workers,
            "time_to_best_s": r["time_to_best"],
            "gen_ms": 1e3 * s["gen_spent_s"],
            "stall_ms": 1e3 * s["gen_stall_s"],
            "regens": s["regenerations"],
            "speculative": f["speculative_submitted"],
            "rejected_spec": f["rejected_speculative"],
            "warm_gen_ms": 1e3 * warm["stats"]["gen_spent_s"],
        })

        # ---- CI smoke assertions (deterministic: VirtualClock) ----------
        assert s["gen_stall_s"] == 0.0, workers
        assert f["mode"] == "manual" and f["workers"] == workers
        for field in ("gen_spent_s", "gen_stall_s", "eval_spent_s"):
            rollup = (sum(k[field] for k in s["kernels"].values())
                      + s["retired_accounts"][field])
            assert abs(rollup - s[field]) < 1e-9, (workers, field)
        # warm replay: every kernel re-validates its persisted best with
        # ONE regeneration and compiles NOTHING (pure cache hits)
        for name in SPECS:
            assert warm["warm"][name], (workers, name)
            at = warm["at_target"][name]
            assert at is not None and at["regens"] == 1, (workers, name, at)
            assert at["gen_s"] == 0.0 and at["stall_s"] == 0.0, (
                workers, name, at)
        assert warm["stats"]["gen_stall_s"] == 0.0

    print(table(rows, ["workers", "time_to_best_s", "gen_ms", "stall_ms",
                       "regens", "speculative", "rejected_spec",
                       "warm_gen_ms"],
                title="compile farm cold-start sweep (virtual seconds)"))
    save("compile_farm", rows)

    # scaling: monotone in M, and the 4-worker farm at least halves the
    # single-worker cold start
    ttb = {w: results[w]["time_to_best"] for w in WORKER_SWEEP}
    assert ttb[4] <= ttb[2] <= ttb[1], ttb
    speedup = ttb[1] / ttb[4]
    assert speedup >= 2.0, f"M=4 speedup {speedup:.2f}x < 2x: {ttb}"
    print(f"\ncold-start time-to-best: {ttb[1]:.3f}s (M=1) -> "
          f"{ttb[4]:.3f}s (M=4), {speedup:.2f}x faster; stall 0 at every M; "
          "warm replay 100% cache hit")


if __name__ == "__main__":
    main()
