"""The dry run's cells cut in depth, held against their torch 2.13 trace.

A sharded cell's per-device program must not depend on which PyTorch is
installed: the models pin every product's placements
(``repro_torch.distributed.sharding.pinned``), so DTensor's own
sharding strategies, which differ from one version to the next, decide
nothing. This module traces the cells that showed the difference (the
card host's torch 2.11 failed or replicated them where 2.13 did not)
and those of the layouts that no such cell runs (``CELLS``),
each at full width on a fake group, cut to one layer (every kind of
layer the family has: its layers are stacked, so one of each), and
compares the walker's counts with those the same cells read on torch
2.13, kept in ``dist_cells.json`` beside this file:

  * product FLOPs and collective link bytes within ``COUNT_REL`` (1 %),
  * HBM bytes and the walker's peak within ``MEMORY_REL`` (10 %).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dist_cells --jobs 3
    PYTHONPATH=src python -m repro_torch.launch.dist_cells --write   # on 2.13

Each cell runs in a process of its own (a process holds one fake
group); exit 1 if a cell fails or disagrees. ``--report`` writes the
counts and the comparisons to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

STORE = os.path.join(os.path.dirname(__file__), "dist_cells.json")

#: (arch, shape, mesh): the cells torch 2.11 failed or replicated,
#: deepseek-7b's train cell on the multi-pod mesh, the MoE train cell
#: (the most pinned sites; too large at full depth for a host trace
#: beside other work), the two long decode cells, whose one batch row
#: does not split (``sharding.pinned`` contracts over the FSDP dim
#: there), and three prefill cells (a forward with no backward that
#: returns its cache, and the chunked attention over 32k): deepseek-7b,
#: qwen2.5-32b (40 heads over 16: uneven) and whisper-tiny
CELLS = (
    ("deepseek-7b", "train_4k", "single"),
    ("deepseek-7b", "decode_32k", "single"),
    ("hymba-1.5b", "train_4k", "single"),
    ("hymba-1.5b", "decode_32k", "single"),
    ("whisper-tiny", "train_4k", "single"),
    ("command-r-35b", "train_4k", "single"),
    ("qwen2.5-32b", "train_4k", "single"),
    ("deepseek-coder-33b", "train_4k", "single"),
    ("qwen2-vl-7b", "train_4k", "single"),
    ("llama4-scout-17b-a16e", "train_4k", "single"),
    ("deepseek-7b", "train_4k", "multi"),
    ("qwen3-moe-30b-a3b", "train_4k", "single"),
    ("hymba-1.5b", "long_500k", "single"),
    ("rwkv6-1.6b", "long_500k", "single"),
    ("deepseek-7b", "prefill_32k", "single"),
    ("qwen2.5-32b", "prefill_32k", "single"),
    ("whisper-tiny", "prefill_32k", "single"),
)
LAYERS = 1
#: the attention chunks of a prefill cell: the dry run's for prefill_32k
#: (``--attn-q-chunk 4096 --attn-k-chunk 8192``: the FLOPs of the
#: default chunks in 64 blocks a layer, not 2048)
PREFILL_CHUNKS = {"attn_q_chunk": 4096, "attn_k_chunk": 8192}
COUNT_REL = 0.01
MEMORY_REL = 0.10
#: the counts held, and the limit of each
LIMITS = {"flops": COUNT_REL, "link_bytes": COUNT_REL,
          "hbm_bytes": MEMORY_REL, "peak_bytes": MEMORY_REL}


def name(cell) -> str:
    return "_".join(cell)


def overrides(arch: str, shape: str) -> dict:
    """The depth cut: one layer (whisper: one encoder and one decoder
    layer); a prefill cell's attention chunks (PREFILL_CHUNKS)."""
    cut = {"n_layers": LAYERS}
    if arch == "whisper-tiny":
        cut["enc_layers"] = LAYERS
    if shape.startswith("prefill"):
        cut.update(PREFILL_CHUNKS)
    return cut


def counts(record: dict) -> dict:
    """The held counts of a ``dryrun.run_cell`` record."""
    return {
        "flops": record["cost"]["flops"],
        "link_bytes": record["collectives"]["link_bytes"],
        "hbm_bytes": record["cost"]["bytes accessed"],
        "peak_bytes": record["memory"]["peak_bytes"],
    }


def trace_one(arch: str, shape: str, mesh: str) -> dict:
    """One cell, traced in this process: its counts and trace seconds."""
    import torch

    from repro_torch.launch.dryrun import run_cell

    rec = run_cell(arch, shape, mesh, overrides=overrides(arch, shape))
    if rec["status"] != "ok":
        raise RuntimeError(f"{name((arch, shape, mesh))}: {rec['status']}")
    return {**counts(rec), "trace_s": rec["trace_s"], "torch": torch.__version__}


def trace(cells, jobs: int) -> dict:
    """Each cell in a process of its own, ``jobs`` at a time: name ->
    counts, or ``{"error": ...}``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", ".."), CUDA_VISIBLE_DEVICES="")

    def one(cell):
        code = ("import json, sys; from repro_torch.launch.dist_cells import trace_one; "
                "print('CELL ' + json.dumps(trace_one(*sys.argv[1:])))")
        res = subprocess.run([sys.executable, "-c", code, *cell], env=env,
                             capture_output=True, text=True)
        if res.returncode or "CELL " not in res.stdout:
            return name(cell), {"error": res.stderr[-3000:]}
        return name(cell), json.loads(res.stdout.split("CELL ", 1)[1])

    with ThreadPoolExecutor(max(1, jobs)) as pool:
        return dict(pool.map(one, cells))


def compare(got: dict, want: dict) -> dict:
    """Per held count: (got, 2.13's, relative difference, limit)."""
    out = {}
    for key, limit in LIMITS.items():
        rel = abs(got[key] - want[key]) / max(abs(want[key]), 1.0)
        out[key] = {"got": got[key], "want": want[key], "rel": rel, "limit": limit}
    return out


def check(traced: dict, store: dict) -> tuple[dict, list]:
    """Each traced cell against the stored counts: (comparisons, faults)."""
    report, faults = {}, []
    for cell, got in traced.items():
        if "error" in got:
            faults.append(f"{cell} failed: {got['error'][-600:]}")
            continue
        cmp = compare(got, store[cell])
        report[cell] = cmp
        faults += [f"{cell} {k}: {c['got']:.6g} against {c['want']:.6g} on torch "
                   f"{store[cell]['torch']} ({c['rel']:.3%} > {c['limit']:.0%})"
                   for k, c in cmp.items() if c["rel"] > c["limit"]]
    return report, faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--write", action="store_true",
                    help="store this PyTorch's counts as the yardstick")
    ap.add_argument("--report", default=None,
                    help="write the counts and comparisons to this JSON file")
    args = ap.parse_args(argv)
    traced = trace(CELLS, args.jobs)
    if args.write:
        bad = {c: r for c, r in traced.items() if "error" in r}
        if bad:
            print(json.dumps(bad, indent=1))
            return 1
        store = json.load(open(STORE)) if os.path.exists(STORE) else {}
        store.update(traced)
        with open(STORE, "w") as f:
            json.dump(dict(sorted(store.items())), f, indent=1)
        print(f"wrote {len(traced)} cells to {STORE}")
        return 0
    report, faults = check(traced, json.load(open(STORE)))
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"traced": traced, "compared": report, "faults": faults}, f, indent=1)
    for cell, cmp in report.items():
        print(cell, " ".join(f"{k} {c['got']:.6g} ({c['rel']:.3%})" for k, c in cmp.items()))
    for f in faults:
        print("FAULT", f)
    return 1 if faults else 0


if __name__ == "__main__":
    raise SystemExit(main())
