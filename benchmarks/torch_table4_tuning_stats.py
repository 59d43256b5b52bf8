"""Paper Table 4 — online auto-tuning statistics, on the card.

    PYTHONPATH=src python benchmarks/torch_table4_tuning_stats.py [--quick] [--device cpu]

The port's counterpart of ``benchmarks/table4_tuning_stats.py``:
explorable versions against the one-run exploration limit, kernels
evaluated, the tuning overhead as a share of the application's run and
the swaps, for euclid (D 32 / 64 / 128 at N 1024, M 64) and lintra (H
160 / 292 / 332 at W 200, 3 bands), 800 calls each under
``RegenerationPolicy(0.05, 0.15)`` with ``wake_every=2``.

On the card (the default) every variant is a hand kernel (euclid's CUDA
C++ instantiations, lintra's Triton binaries) and the spaces are the
Hopper ones, sized against the card's shared memory: each row says so in
``space``. With ``--device cpu`` the variants are the plain PyTorch
versions and the spaces are the reference's (TPU capacity), so
``explorable`` and ``one_run_limit`` equal the reference's, row for row.
The artifact is ``bench_artifacts/torch_table4_tuning_stats.json``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    Evaluator, OnlineAutotuner, RegenerationPolicy, TwoPhaseExplorer)
from repro_torch.interop import resolve_device  # noqa: E402
from repro_torch.kernels.euclid import ops as euclid  # noqa: E402
from repro_torch.kernels.lintra import ops as lintra  # noqa: E402
from torch_common import save, table  # noqa: E402

N_POINTS, M_CENTERS = 1024, 64
LINTRA_W, LINTRA_BANDS = 200, 3
CALLS = 800


def one_run_limit(space) -> int:
    ex = TwoPhaseExplorer(space)
    n = 0
    while True:
        pt = ex.next_point()
        if pt is None:
            break
        ex.report(pt, 1.0)
        n += 1
    return n


def cases(quick: bool = False) -> list[tuple[str, int]]:
    out = [("euclid", d) for d in ((32,) if quick else (32, 64, 128))]
    out += [("lintra", s) for s in ((160,) if quick else (160, 292, 332))]
    return out


def case_compilette(bench: str, size: int, dev: torch.device):
    """The case's compilette, its arguments and its specialization."""
    gen = torch.Generator().manual_seed(0)
    if bench == "euclid":
        comp = euclid.make_euclid_compilette(N_POINTS, M_CENTERS, size, device=dev)
        args = (torch.randn(N_POINTS, size, generator=gen).to(dev),
                torch.randn(M_CENTERS, size, generator=gen).to(dev))
        return comp, args, {"dim": size}
    H, W, bands = size, LINTRA_W, LINTRA_BANDS
    comp = lintra.make_lintra_compilette(H, W, bands, device=dev)
    args = (torch.randn(H, W, bands, generator=gen).to(dev),
            torch.ones(bands, device=dev), torch.zeros(bands, device=dev))
    return comp, args, {"bands": bands, "width": W}


def run(quick: bool = False, device=None, calls: int = CALLS,
        write: bool = True) -> dict:
    dev = resolve_device(device)
    rows = []
    for bench, size in cases(quick):
        comp, args, spec = case_compilette(bench, size, dev)
        ev = Evaluator(mode="training", groups=1, group_size=3,
                       make_args=lambda a=args: a)
        at = OnlineAutotuner(comp, ev, policy=RegenerationPolicy(0.05, 0.15),
                             specialization=spec, wake_every=2)
        t0 = time.perf_counter()
        for _ in range(calls):
            out = at(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        del out
        s = at.stats()
        rows.append({
            "bench": bench, "size": size,
            "space": "hopper" if dev.type == "cuda" else "tpu",
            "explorable": comp.space.n_valid_variants(),
            "one_run_limit": one_run_limit(comp.space),
            "kernel_calls": calls,
            "explored": s["n_explored"],
            "overhead_%": 100 * s["tuning_spent_s"] / wall,
            "overhead_ms": 1000 * s["tuning_spent_s"],
            "swaps": s["swaps"],
            "wall_s": wall,
            "final_point": s["active_point"],
        })
    print(table(rows, [k for k in rows[0] if k != "final_point"],
                f"Table 4 — online tuning statistics ({dev})"))
    payload = {"device": str(dev), "rows": rows}
    if dev.type == "cuda":
        payload["device_name"] = torch.cuda.get_device_name(dev)
    if write:
        save("table4_tuning_stats", payload)
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="one case of each kernel")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    run(quick=args.quick, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
