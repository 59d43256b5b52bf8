"""Paper Table 5 / Fig. 8 — best-parameter ↔ pipeline-feature correlation.

The port's copy of ``benchmarks/table5_param_correlation.py``: the same
simulated run (no tensor is made and no card is used) through
``repro_torch``, whose JSON
(``bench_artifacts/torch_table5_param_correlation.json``) equals the
reference's. Both spaces are built for the CPU (``device="cpu"``), so
their capacity is the reference's TPU one whether or not a card is
present.

Runs the full exploration on all 11 simulated cores for euclid and matmul
compilettes, tabulates the winning parameters, and computes simple
correlations with the pipeline features (paper §5.4):

  * unroll (hotUF)  ↔ dynamic scheduling (lean cores want more unrolling)
  * block sizes     ↔ issue width / VMEM
  * lookahead (pld) ↔ lean cores (fat cores hide DMA latency in hardware)
"""

from __future__ import annotations

import statistics

from repro_torch.core import TwoPhaseExplorer
from repro_torch.core.profiles import ALL_PROFILES
from repro_torch.kernels.euclid.ops import make_euclid_compilette
from repro_torch.kernels.matmul.ops import make_matmul_compilette
from benchmarks.torch_common import save, table


def _pearson(xs, ys):
    if len(set(xs)) < 2 or len(set(ys)) < 2:
        return 0.0
    mx, my = statistics.mean(xs), statistics.mean(ys)
    num = sum((a - mx) * (b - my) for a, b in zip(xs, ys))
    den = (sum((a - mx) ** 2 for a in xs) *
           sum((b - my) ** 2 for b in ys)) ** 0.5
    return num / den if den else 0.0


def run() -> dict:
    comps = {
        "euclid": make_euclid_compilette(4096, 128, 64, device="cpu"),
        "matmul": make_matmul_compilette(2048, 2048, 2048, device="cpu"),
    }
    rows = []
    for prof in ALL_PROFILES:
        row = {"core": prof.name, "lean": int(not prof.overlap),
               "issue": prof.issue, "vpus": prof.vpus}
        for kname, comp in comps.items():
            ex = TwoPhaseExplorer(comp.space)
            bp, _ = ex.run_to_completion(lambda p: comp.simulate(p, prof))
            row[f"{kname}_unroll"] = bp["unroll"]
            row[f"{kname}_lookahead"] = bp["lookahead"]
            if kname == "matmul":
                row["matmul_bk"] = bp["block_k"]
                row["matmul_bm"] = bp["block_m"]
            else:
                row["euclid_bd"] = bp["block_d"]
                row["euclid_vect"] = bp["vectorize"]
        rows.append(row)

    corr = {
        "unroll_vs_lean(euclid)": _pearson(
            [r["lean"] for r in rows], [r["euclid_unroll"] for r in rows]),
        "unroll_vs_lean(matmul)": _pearson(
            [r["lean"] for r in rows], [r["matmul_unroll"] for r in rows]),
        "lookahead_vs_lean(matmul)": _pearson(
            [r["lean"] for r in rows], [r["matmul_lookahead"] for r in rows]),
        "block_d_vs_issue(euclid)": _pearson(
            [r["issue"] for r in rows], [r["euclid_bd"] for r in rows]),
        "block_k_vs_issue(matmul)": _pearson(
            [r["issue"] for r in rows], [r["matmul_bk"] for r in rows]),
    }
    print(table(rows, list(rows[0].keys()),
                "Table 5 — best auto-tuned parameters per simulated core"))
    print("correlations:", {k: round(v, 2) for k, v in corr.items()})
    out = {"rows": rows, "correlations": corr}
    save("table5_param_correlation", out)
    return out


if __name__ == "__main__":
    run()
