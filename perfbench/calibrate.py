"""Readings for the limits of the comparison that decides ``correct``.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed, in one process: the cell's set-up, one whole cycle of its
traffic under a fresh tuning session (its own batch sizes, lengths and
load), then the comparison on the sample a run takes, and beside it the
control: the same reference with every product's operands in float8
e4m3, the step below the bfloat16 the configuration states. It prints
each seed's program readings (the widest and the mean gap of a served
token, and more) and the control's (the same of the tokens the float8
reference puts first), and with ``--out`` writes them as JSON.
``--witnesses fp8,bf16`` adds the reference in bfloat16 products, which
shows what the configuration's own precision does to the same numbers.
Benchmark runs never run the control; ``perfbench/tests/test_bench_control.py``
keeps it as a test.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(cell_name: str, seeds: list[int], device="cuda:0", *, log=print,
             witnesses=("fp8",)) -> list[dict]:
    import torch

    from pbench import correct, runner, spec

    cell = spec.cell(cell_name, ROOT)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = runner.setup(cell, seed, device, root=ROOT)
        t1 = time.perf_counter()
        window = runner.measure(ctx, 0.0)           # the first cycle only
        runner.close_session(ctx)
        t2 = time.perf_counter()
        r = correct.compare(ctx, window.batches, witnesses=witnesses)
        r.update(seed=seed, setup_s=t1 - t0, window_s=window.seconds,
                 compare_s=time.perf_counter() - t2,
                 batches=[{"length": b.length, "ttft_s": b.ttft_s, "tpot_s": b.tpot_s,
                           "prefill_s": b.prefill_s, "decode_s": b.decode_s}
                          for b in window.batches])
        if torch.device(device).type == "cuda":
            r["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        log(json.dumps(r))
        out.append(r)
        del ctx, window
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out", default=None)
    ap.add_argument("--witnesses", default="fp8", help="comma-separated: fp8 (the control), bf16")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    res = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                   witnesses=tuple(args.witnesses.split(",")))
    summary = {"workload": args.workload, "runs": res}
    for name in ("max_logit_gap", "mean_logit_gap"):
        prog = max(r[name] for r in res)
        ctl = min(r["fp8_" + name] for r in res)
        summary[name] = {"program_max": prog, "control_min": ctl,
                         "ratio": ctl / prog if prog > 0 else None}
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
