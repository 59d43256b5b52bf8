"""Paper Fig. 1 — motivational static exploration.

The port's copy of ``benchmarks/fig1_motivational.py``: the same
simulated run (no tensor is made and no card is used) through
``repro_torch``, whose JSON (``bench_artifacts/torch_fig1_motivational.json``)
equals the reference's. The euclid space is built for the CPU
(``device="cpu"``), so its capacity is the reference's TPU one whether
or not a card is present.

Statically explores the euclid tuning space on two simulated cores
(Cortex-A8/A9 analogues: TI-L2 lean and TI-F2 fat) for the three
specialized dimensions. Reports best speedup vs the hand-vectorized
reference variant and the cross-core performance portability penalty
(paper: best-for-A8 run on A9 is 55 % slower, best-for-A9 on A8 21 %)."""

from __future__ import annotations

from repro_torch.core import TwoPhaseExplorer
from repro_torch.core.profiles import TI_F2, TI_L2
from repro_torch.kernels.euclid.ops import make_euclid_compilette
from benchmarks.torch_common import save, table

CORES = {"lean(TI-L2)": TI_L2, "fat(TI-F2)": TI_F2}
N_POINTS, M_CENTERS = 4096, 128


def reference_point():
    """The 'hand-vectorized reference': default vectorized variant."""
    return dict(block_n=64, block_m=32, block_d=16, unroll=1, vectorize=1,
                order="nm", scratch=1, lookahead=0)


def run(dims=(32, 64, 128)) -> dict:
    rows = []
    best_points = {}
    for dim in dims:
        comp = make_euclid_compilette(N_POINTS, M_CENTERS, dim, device="cpu")
        for cname, prof in CORES.items():
            ref_t = comp.simulate(reference_point(), prof)
            ex = TwoPhaseExplorer(comp.space)
            best, best_t = ex.run_to_completion(
                lambda p: comp.simulate(p, prof))
            n_valid = comp.space.n_valid_variants()
            best_points[(dim, cname)] = (best, best_t)
            rows.append({
                "dim": dim, "core": cname,
                "explorable": n_valid,
                "explored": ex.state.n_reported,
                "best_speedup_vs_ref": ref_t / best_t,
                "best_point": str({k: best[k] for k in
                                   ("block_n", "block_d", "unroll",
                                    "vectorize")}),
            })
    # cross-core portability penalty at the largest dim
    dim = dims[-1]
    comp = make_euclid_compilette(N_POINTS, M_CENTERS, dim, device="cpu")
    (bl, tl) = best_points[(dim, "lean(TI-L2)")]
    (bf, tf) = best_points[(dim, "fat(TI-F2)")]
    cross = {
        "best_lean_on_fat_penalty":
            comp.simulate(bl, TI_F2) / tf - 1.0,
        "best_fat_on_lean_penalty":
            comp.simulate(bf, TI_L2) / tl - 1.0,
    }
    out = {"rows": rows, "cross_core": cross}
    print(table(rows, ["dim", "core", "explorable", "explored",
                       "best_speedup_vs_ref", "best_point"],
                "Fig.1 — static exploration (simulated cores)"))
    print(f"cross-core penalty: best-lean-on-fat +{cross['best_lean_on_fat_penalty']:.0%}, "
          f"best-fat-on-lean +{cross['best_fat_on_lean_penalty']:.0%}")
    save("fig1_motivational", out)
    return out


if __name__ == "__main__":
    run()
