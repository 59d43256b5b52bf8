"""Paper Fig. 5 + Fig. 6 — the 11 simulated cores study.

The port's copy of ``benchmarks/fig5_simulated_cores.py``: the same virtual-clock run
(no tensor is made and no card is used) through ``repro_torch``, whose
JSON (``bench_artifacts/torch_fig5_simulated_cores.json``) equals the reference's.
The euclid space is built for the CPU (``device="cpu"``), so its
capacity is the reference's TPU one whether or not a card is present.

For every simulated device profile, runs the online exploration of the
euclid kernel through the ``repro_torch.tune`` session front door (a
``TuningSession`` per core on a ``VirtualClock``, the same coordinator/
budget/registry machinery production uses) and reports speedup +
energy-efficiency improvement over the SISD and SIMD references, then
the IO-vs-OOO ("lean-vs-fat") comparison on equivalent pairs:

  * ref-on-fat vs ref-on-lean  (hardware gap under static code)
  * tuned-on-lean vs ref-on-fat (can online tuning replace OOO hardware?)
"""

from __future__ import annotations

from repro_torch.api import TuningConfig, TuningSession
from repro_torch.core import VirtualClock, VirtualClockEvaluator, virtual_compilette
from repro_torch.core.profiles import ALL_PROFILES, EQUIVALENT_PAIRS
from repro_torch.kernels.euclid.ops import (
    euclid_flops, make_euclid_compilette)
from benchmarks.torch_common import save, table

N, M, D = 4096, 128, 64
MAX_STEPS = 5000   # drive-loop backstop; exploration finishes far earlier


def ref_points():
    sisd = dict(block_n=64, block_m=32, block_d=16, unroll=1, vectorize=0,
                order="nm", scratch=1, lookahead=0)
    simd = dict(block_n=64, block_m=32, block_d=16, unroll=1, vectorize=1,
                order="nm", scratch=1, lookahead=0)
    return sisd, simd


def energy(prof, point, t, comp):
    vect = bool(point["vectorize"])
    fl = euclid_flops(N, M, D, vect)
    by = (N * D + M * D + N * M) * 4.0
    return prof.energy_j(t, fl, by)


def tuned_best(comp, prof, ref_score_s):
    """Online-tune euclid on ``prof`` via the session path; (point, s)."""
    clock = VirtualClock()
    session = TuningSession(
        TuningConfig(max_overhead=1.0, invest=1.0, pump_every=1),
        clock=clock, device=f"fig5:{prof.name}")
    # vmem-overflow points simulate at inf: clamp to a finite (still
    # astronomically bad) cost so the virtual clock stays arithmetic —
    # the explorer must be able to MEASURE an invalid point and move on
    vcomp = virtual_compilette(clock, "euclid", comp.space,
                               lambda p: min(comp.simulate(p, prof), 1.0))
    # virtual marker: candidate-cost estimates and device traits derive
    # from the exact profile being simulated
    vcomp.virtual = (clock, prof)
    vcomp.cost_model = comp.cost_model
    m = session.register("euclid", vcomp, VirtualClockEvaluator(clock),
                         reference_score_s=ref_score_s)
    for i in range(MAX_STEPS):
        if m.tuner.explorer.finished:
            break
        m(i)
        clock.advance(0.001)
        session.observe_busy(0.001)
        session.pump()
    assert m.tuner.explorer.finished, (
        f"{prof.name}: exploration did not finish in {MAX_STEPS} steps")
    bp = dict(m.tuner.explorer.best_point)
    bt = float(m.tuner.explorer.best_score)
    session.close()
    return bp, bt


def run() -> dict:
    comp = make_euclid_compilette(N, M, D, device="cpu")
    sisd, simd = ref_points()
    rows = []
    best = {}
    for prof in ALL_PROFILES:
        t_sisd = comp.simulate(sisd, prof)
        t_simd = comp.simulate(simd, prof)
        bp, bt = tuned_best(comp, prof, t_simd)
        best[prof.name] = (bp, bt)
        e_simd = energy(prof, simd, t_simd, comp)
        e_best = energy(prof, bp, bt, comp)
        rows.append({
            "core": prof.name,
            "speedup_vs_SISD": t_sisd / bt,
            "speedup_vs_SIMD": t_simd / bt,
            "energy_gain_vs_SIMD": e_simd / e_best,
            "best_unroll": bp["unroll"],
            "best_vect": bp["vectorize"],
            "best_block_d": bp["block_d"],
        })
    print(table(rows, ["core", "speedup_vs_SISD", "speedup_vs_SIMD",
                       "energy_gain_vs_SIMD", "best_unroll", "best_vect",
                       "best_block_d"],
                "Fig.5 — online auto-tuning on 11 simulated cores"))

    # ---- Fig. 6: lean (IO) vs fat (OOO) equivalent pairs ---------------
    pair_rows = []
    for lean, fat in EQUIVALENT_PAIRS:
        _, simd_pt = ref_points()
        t_ref_fat = comp.simulate(simd_pt, fat)
        t_ref_lean = comp.simulate(simd_pt, lean)
        bp_lean, t_best_lean = best[lean.name]
        e_ref_fat = energy(fat, simd_pt, t_ref_fat, comp)
        e_best_lean = energy(lean, bp_lean, t_best_lean, comp)
        pair_rows.append({
            "pair": f"{lean.name}/{fat.name}",
            "static_gap_ref": t_ref_lean / t_ref_fat,           # >1: lean slower
            "tuned_lean_gap": t_best_lean / t_ref_fat,
            "tuned_lean_speedup_vs_fat_ref": t_ref_fat / t_best_lean,
            "energy_gain_tuned_lean_vs_fat_ref": e_ref_fat / e_best_lean,
            "area_overhead_fat": fat.area_mm2 / lean.area_mm2 - 1,
        })
    import statistics
    geo = lambda xs: statistics.geometric_mean(xs)
    summary = {
        "static_gap_geo": geo([r["static_gap_ref"] for r in pair_rows]),
        "tuned_gap_geo": geo([r["tuned_lean_gap"] for r in pair_rows]),
        "tuned_lean_speedup_vs_fat_ref_geo": geo(
            [r["tuned_lean_speedup_vs_fat_ref"] for r in pair_rows]),
        "energy_gain_geo": geo(
            [r["energy_gain_tuned_lean_vs_fat_ref"] for r in pair_rows]),
    }
    print(table(pair_rows, list(pair_rows[0].keys()),
                "Fig.6 — lean(IO) vs fat(OOO) equivalent pairs"))
    print("summary:", {k: round(v, 3) for k, v in summary.items()})
    out = {"cores": rows, "pairs": pair_rows, "summary": summary,
           "best_points": {k: v[0] for k, v in best.items()}}
    save("fig5_simulated_cores", out)
    return out


if __name__ == "__main__":
    run()
