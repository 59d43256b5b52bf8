"""The benchmark of the PyTorch and CUDA port ``repro_torch`` on one H100.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Loads the cell named in ``BENCHMARK.json``,
sets it up (kernel builds, weights drawn on the card from the seed,
warm-up), serves its traffic for ``--seconds`` under a fresh tuning
session, and (``--trace 1``) profiles one more cycle of it; then compares
a sample of the served tokens with the plain reference, and prints the
result as one JSON object on the last line of standard output, the
numbers compared beside their limits as the last lines of standard
error. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer ones.

Exit codes: 0 a result printed (``correct`` says whether it held); 2 no
program beside the benchmark; 3 no card, or fewer than the cell asks
for; 4 a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: no program at {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    # every cache of the program at a fixed path inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton-cache"))

    import torch

    from pbench import spec
    from pbench.cellrun import forbidden_modules, log, run_cell

    cell = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START,
                      root=ROOT)
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    log(f"result correct={result['correct']}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
