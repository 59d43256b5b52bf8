"""Roofline table of the port's dry run.

The port's copy of ``benchmarks/roofline.py``: aggregates the records
that ``python -m repro_torch.launch.dryrun`` writes under
``dryrun_artifacts/torch/`` into the per-(arch x shape x mesh) table:
three terms in seconds with an H100's constants
(``repro_torch.distributed.roofline``), the dominant bottleneck,
MODEL_FLOPS over the traced FLOPs, the roofline fraction, the per-device
peak memory and the seconds each trace took. The terms come from graphs
traced on the host, not from runs on a card.

    PYTHONPATH=src:. python benchmarks/torch_roofline.py [single|multi]
"""

from __future__ import annotations

import glob
import json
import os

from benchmarks.torch_common import save, table

ART = os.path.join(os.path.dirname(__file__), "..", "dryrun_artifacts", "torch")


def load(mesh: str = "single", tag: str = "") -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(ART, f"*_{mesh}{tag}.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") == "skipped":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "status": "skipped"})
            continue
        if rec.get("status") != "ok":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "status": "FAILED"})
            continue
        r = rec["roofline"]
        rows.append({
            "arch": rec["arch"], "shape": rec["shape"], "status": "ok",
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "bound": r["bound"],
            "useful": r["useful_ratio"], "roofline_frac": r["roofline_frac"],
            "mem_gb": rec["memory"]["peak_per_device_gb"],
            "trace_s": rec["trace_s"],
        })
    return rows


def run(mesh: str = "single") -> dict:
    rows = load(mesh)
    ok = [r for r in rows if r["status"] == "ok"]
    if not ok:
        print("no dry-run artifacts found — run repro_torch.launch.dryrun first")
        return {"rows": rows}
    cols = ["arch", "shape", "compute_s", "memory_s", "collective_s",
            "bound", "useful", "roofline_frac", "mem_gb", "trace_s"]
    print(table(ok, cols, f"Roofline — {mesh}-mesh dry run "
                          "(per-device terms, H100 constants)"))
    skipped = [r for r in rows if r["status"] == "skipped"]
    if skipped:
        print(f"skipped cells: {[(r['arch'], r['shape']) for r in skipped]}")
    failed = [r for r in rows if r["status"] == "FAILED"]
    if failed:
        print(f"FAILED cells: {[(r['arch'], r['shape']) for r in failed]}")
    worst = min(ok, key=lambda r: r["roofline_frac"])
    coll = max(ok, key=lambda r: r["collective_s"] / max(
        max(r["compute_s"], r["memory_s"]), 1e-12))
    print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']} "
          f"({worst['roofline_frac']:.3f})")
    print(f"most collective-bound:   {coll['arch']}/{coll['shape']}")
    save(f"roofline_{mesh}", rows)
    return {"rows": rows, "worst": worst, "most_collective": coll}


if __name__ == "__main__":
    import sys
    run(sys.argv[1] if len(sys.argv) > 1 else "single")
