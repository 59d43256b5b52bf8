"""Cold-start vs warm-start time-to-best under the TuningCoordinator.

The port's copy of ``benchmarks/coordinator_warmstart.py``: the same virtual-clock run
(no tensor is made and no card is used) through ``repro_torch``, whose
JSON (``bench_artifacts/torch_coordinator_warmstart.json``) equals the reference's.

Two measurements per scenario, both fully deterministic on the
VirtualClock (simulated seconds, so numbers are reproducible anywhere):

  * regenerations-to-best — how many generate+evaluate cycles before the
    process is *running* its best-known variant;
  * time-to-best — simulated wall time from process start to that swap,
    including all kernel calls and tuning overhead.

The cold process explores the space from scratch; the warm process loads
the registry the cold one persisted and re-validates the stored best with
a single regeneration. A multi-kernel scenario shows the same effect when
one shared budget serves several kernels at once. ``--strategy`` runs the
same scenarios under any registered search strategy (the warm-start
economics are strategy-independent: the registry seed is always proposed
first).

Generation runs through the double-buffered pipeline: each compile has a
declared simulated cost (``gen_cost_s``), candidates are built by the
async executor while the kernels keep serving, and both processes share
one process-wide ``GenerationCache``. The run reports ``gen_spent_s``
(compile cost charged to the budget), ``gen_stall_s`` (compile time the
hot path actually waited for) and the per-run cache hit rate — and
ASSERTS, as a CI smoke, that the warm-start replay is a 100% cache hit
with zero hot-path stall. ``--sync`` disables the pipeline to show the
stall the paper's original synchronous cycle would pay.

    PYTHONPATH=src python benchmarks/torch_coordinator_warmstart.py \
        [--strategy greedy] [--sync]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, "src")
sys.path.insert(0, os.path.dirname(__file__))

from torch_common import save, table

from repro_torch.core import (
    Compilette, GenerationCache, Param, RegenerationPolicy, VirtualClock,
    VirtualClockEvaluator, product_space, virtual_kernel,
)
from repro_torch.runtime.coordinator import TuningCoordinator

DEVICE = "bench:virtual"
GEN_COST_S = 0.002   # simulated compile cost per variant


def make_kernel_suite(clock, n_kernels: int):
    """n kernels with distinct cost landscapes over an 8x2 point space."""
    suite = []
    for k in range(n_kernels):
        base = 0.004 * (k + 1)

        def cost_fn(p, base=base):
            return base / p["unroll"] + (0 if p["sched"] else base / 8)

        sp = product_space([
            Param("unroll", (1, 2, 4, 8), phase=1, switch_rank=0),
            Param("sched", (0, 1), phase=2),
        ])

        def gen(point, _cost_fn=cost_fn, **spec):
            return virtual_kernel(clock, _cost_fn(point))

        suite.append((f"kernel{k}",
                      Compilette(f"kernel{k}", sp, gen,
                                 gen_cost_s=GEN_COST_S),
                      base, {"unroll": 8, "sched": 1}))
    return suite


def run_process(registry_path, n_kernels: int, calls: int = 6000,
                strategy: str = "two_phase", gen_cache=None,
                async_generation=True, clock=None):
    """Simulate one process lifetime; return per-kernel time-to-best.

    ``clock`` is the HOST timeline: cold and warm runs of one scenario
    share it (together with the generation cache), because the cached
    virtual kernels close over the clock they were compiled with —
    per-run times are therefore reported relative to process start.
    """
    clock = clock if clock is not None else VirtualClock()
    t_start = clock()
    ev = VirtualClockEvaluator(clock)
    coord = TuningCoordinator(
        policy=RegenerationPolicy(max_overhead_frac=0.05, invest_frac=0.5),
        registry_path=registry_path, device=DEVICE, clock=clock,
        strategy=strategy, async_generation=async_generation,
        generation_cache=gen_cache, prefetch=1)
    cache = coord.generation_cache
    hits0, misses0 = cache.hits, cache.misses
    managed = []
    for name, comp, base, best in make_kernel_suite(clock, n_kernels):
        m = coord.register(name, comp, ev,
                           reference_fn=virtual_kernel(clock, base))
        managed.append((m, best))

    to_best = {m.name: None for m, _ in managed}
    regens_at_best = {m.name: None for m, _ in managed}
    # per-kernel replay bill: this kernel's compile charge/stall at the
    # moment it is RUNNING its best-known variant again
    replay_gen = {m.name: None for m, _ in managed}
    replay_stall = {m.name: None for m, _ in managed}
    for i in range(calls):
        for m, best in managed:
            m(i)
            if to_best[m.name] is None and m.tuner._active_life.point == best:
                to_best[m.name] = clock() - t_start
                regens_at_best[m.name] = m.tuner.accounts.regenerations
                replay_gen[m.name] = m.tuner.accounts.gen_spent_s
                replay_stall[m.name] = m.tuner.accounts.gen_stall_s
        coord.maybe_pump()
    coord.save_registry()
    stats = coord.stats()
    hits, misses = cache.hits - hits0, cache.misses - misses0
    return {
        "time_to_best_s": to_best,
        "regens_to_best": regens_at_best,
        "total_regens": stats["regenerations"],
        "overhead_frac": stats["overhead_frac"],
        "gen_spent_s": stats["gen_spent_s"],
        "gen_stall_s": stats["gen_stall_s"],
        "cache_hit_rate": hits / (hits + misses) if hits + misses else 0.0,
        # the replay-to-best phase: what each kernel paid in compilation
        # before it was RUNNING its persisted best again
        "replay_gen_s": replay_gen,
        "replay_stall_s": replay_stall,
        "warm": [m.warm_started for m, _ in managed],
        "wall_s": clock() - t_start,
    }


def main() -> None:
    from repro_torch.core import available_strategies

    ap = argparse.ArgumentParser()
    ap.add_argument("--strategy", default="two_phase",
                    choices=available_strategies())
    ap.add_argument("--sync", action="store_true",
                    help="synchronous generation (paper's original cycle): "
                         "compiles stall the hot path")
    args = ap.parse_args()
    async_generation = not args.sync

    rows = []
    results = {}
    for n_kernels in (1, 4):
        # one PROCESS-WIDE compiled-variant cache shared by the cold and
        # warm "processes" (the deployment analogue: a host-level
        # persistent compilation cache surviving a binary restart) — and
        # therefore one HOST clock, since cached virtual kernels advance
        # the clock they were compiled with
        gen_cache = GenerationCache()
        host_clock = VirtualClock()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "tuned.json")
            cold = run_process(path, n_kernels, strategy=args.strategy,
                               gen_cache=gen_cache, clock=host_clock,
                               async_generation=async_generation)
            warm = run_process(path, n_kernels, strategy=args.strategy,
                               gen_cache=gen_cache, clock=host_clock,
                               async_generation=async_generation)
        results[n_kernels] = (cold, warm)
        for phase, r in (("cold", cold), ("warm", warm)):
            ttb = [v for v in r["time_to_best_s"].values() if v is not None]
            rtb = [v for v in r["regens_to_best"].values() if v is not None]
            rows.append({
                "kernels": n_kernels,
                "start": phase,
                "reached_best": f"{len(ttb)}/{n_kernels}",
                "regens_to_best(max)": max(rtb) if rtb else None,
                "time_to_best_s(max)": max(ttb) if ttb else None,
                "total_regens": r["total_regens"],
                "overhead_%": 100 * r["overhead_frac"],
                "gen_stall_ms": 1e3 * r["gen_stall_s"],
                "cache_hit_%": 100 * r["cache_hit_rate"],
            })
    print(table(rows, ["kernels", "start", "reached_best",
                       "regens_to_best(max)", "time_to_best_s(max)",
                       "total_regens", "overhead_%", "gen_stall_ms",
                       "cache_hit_%"],
                title="coordinator cold vs warm start (virtual seconds)"))
    save("coordinator_warmstart", rows)

    cold1 = next(r for r in rows if r["kernels"] == 1 and r["start"] == "cold")
    warm1 = next(r for r in rows if r["kernels"] == 1 and r["start"] == "warm")
    speedup = cold1["time_to_best_s(max)"] / warm1["time_to_best_s(max)"]
    print(f"\nwarm start reaches best {speedup:.1f}x sooner "
          f"({warm1['regens_to_best(max)']} vs "
          f"{cold1['regens_to_best(max)']} regenerations)")

    # ---- CI smoke assertions (deterministic: VirtualClock) --------------
    for n_kernels, (cold, warm) in results.items():
        # the warm-start replay — everything a kernel generates up to
        # RUNNING its persisted best again — re-proposes only points the
        # cold process already compiled: a 100% generation-cache hit
        # rate, i.e. zero compile charge and zero hot-path stall, and a
        # single re-validating regeneration per kernel
        assert all(v == 1 for v in warm["regens_to_best"].values()), warm
        assert all(v == 0.0 for v in warm["replay_gen_s"].values()), warm
        assert all(v == 0.0 for v in warm["replay_stall_s"].values()), warm
        if async_generation:
            # double buffering: NO compile ever stalls the hot path
            assert cold["gen_stall_s"] == 0.0, (n_kernels, cold)
            assert warm["gen_stall_s"] == 0.0, (n_kernels, warm)
            print(f"[{n_kernels} kernel(s)] warm replay: 100% cache hit, "
                  f"0 stall; cold: {cold['gen_spent_s']*1e3:.0f} ms compile "
                  f"fully overlapped")
        else:
            assert cold["gen_stall_s"] > 0.0, (n_kernels, cold)
            print(f"[{n_kernels} kernel(s)] sync mode: hot path stalled "
                  f"{cold['gen_stall_s']*1e3:.0f} ms for compilation; "
                  f"warm replay still stall-free (cache)")


if __name__ == "__main__":
    main()
