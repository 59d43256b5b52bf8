"""Chip smoke test of the PyTorch/CUDA port: the paper's Table 3 on the card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the euclid CUDA library from the repository's sources (sm_90a),
drives the port's main path once — ``repro_torch.bench.table3`` at the
PARSEC sizes, the online auto-tuner generating, evaluating and swapping
hand-kernel variants of euclid (CUDA C++) and lintra (Triton) — with the
kernels' launch counts reset just before and read just after, then holds
each kernel against its plain PyTorch version and times it beside its
bound, its plain version and one PyTorch library call. It prints one
``kernels`` JSON line and, last, ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result. Full results go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM data-sheet peaks (dense): fp32 outside the tensor
#: cores, and device-memory bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

EUCLID_SRC = "src/repro_torch/kernels/euclid/csrc/euclid.cuh"
EUCLID_TPU = "src/repro/kernels/euclid/euclid.py:115"
LINTRA_SRC = "src/repro_torch/kernels/lintra/lintra.py"
LINTRA_TPU = "src/repro/kernels/lintra/lintra.py:67"

#: limits of the kernels against their plain versions. euclid's is far
#: tighter than its KernelDef.tolerance (rtol 1e-3): a sound fp32 kernel
#: stays well inside it, and a TF32 product (about three digits) must not
#: pass it, which check_euclid verifies on the card. lintra's is its
#: KernelDef.tolerance.
EUCLID_TOL = {"rtol": 2e-5, "atol": 1e-5}
LINTRA_TOL = {"rtol": 1e-5, "atol": 1e-7}


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    raise SystemExit(code)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, *args, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn(*args)`` over ``reps`` launches."""
    import torch

    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def serving(row: dict, default: dict) -> dict:
    """The point that served at the end of a Table 3 row's O-AT run (the
    default point when the reference kept serving)."""
    point = row["final_point"]
    return dict(default) if point == "reference" else point


def ptxas_summary(log: Path) -> dict:
    """Registers and spills per instantiation, from nvcc's -Xptxas -v."""
    text = log.read_text() if log.exists() else ""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "spilling_kernels": sum(1 for s in spills if s > 0),
            "max_spill_store_bytes": max(spills, default=0)}


def tol_used(got, want, tol: dict) -> float:
    """The largest ``|got - want| / (atol + rtol * |want|)``: at most 1
    where ``torch.allclose`` passes."""
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())


def check_euclid(lib, dev, gen) -> dict:
    """Every instantiation against the plain version at ragged shapes,
    plus a few points at simlarge, then a control: a TF32 product at
    simlarge must fail the same limit."""
    import torch

    from repro_torch.kernels.euclid.euclid import PHASE1, euclid_cuda, euclid_plain
    from repro_torch.kernels.euclid.ops import DEFAULT_POINT, make_space, reference_simd

    cap = lib_capacity_kb(dev)
    cases = []
    for d in (70, 130):
        space = make_space(1000, 1000, d, vmem_kb=cap)
        for i, tup in enumerate(lib.points):
            for scratch in (i % 2, 1 - i % 2):
                point = dict(zip(PHASE1, tup), order=("nm", "mn")[i // 2 % 2],
                             scratch=scratch, lookahead=i % 3)
                if space.is_valid(point):
                    cases.append(((1000, 1000, d), point))
                    break
    covered = {tuple(p[k] for k in PHASE1) for _, p in cases}
    if covered != set(lib.points):
        fail(f"{len(set(lib.points) - covered)} instantiations left unchecked")
    big = make_space(16384, 1024, 128, vmem_kb=cap)
    picks = [p for i, p in enumerate(big.iter_valid()) if i % 271 == 0]
    cases += [((16384, 1024, 128), p) for p in picks]
    worst, used, inputs = 0.0, 0.0, {}
    for (n, m, d), point in cases:
        if (n, m, d) not in inputs:
            inputs[(n, m, d)] = (
                torch.randn(n, d, generator=gen, device=dev),
                torch.randn(m, d, generator=gen, device=dev))
        x, c = inputs[(n, m, d)]
        got = euclid_cuda(x, c, point, lib=lib)
        want = euclid_plain(x, c, point)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        used = max(used, tol_used(got, want, EUCLID_TOL))
        if not torch.allclose(got, want, **EUCLID_TOL):
            fail(f"euclid {point} at {(n, m, d)}: max|err| {err:.3e} beyond "
                 f"{EUCLID_TOL}")
    print(f"euclid: {len(cases)} checks over {len(covered)} instantiations, "
          f"max|err| {worst:.3e} within rtol={EUCLID_TOL['rtol']} "
          f"atol={EUCLID_TOL['atol']} ({used:.3f} of the limit)")

    # control: the same limit must refuse a TF32 product
    x, c = inputs[(16384, 1024, 128)]
    want = euclid_plain(x, c, DEFAULT_POINT)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = reference_simd(128)(x, c)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_err = float((tf32 - want).abs().max())
    tf32_used = tol_used(tf32, want, EUCLID_TOL)
    if torch.allclose(tf32, want, **EUCLID_TOL):
        fail(f"a TF32 product (max|err| {tf32_err:.3e}) passes the euclid "
             f"limit {EUCLID_TOL}: the check cannot see a loss of precision")
    print(f"euclid control: a TF32 product at simlarge, max|err| "
          f"{tf32_err:.3e} ({tf32_used:.1f} of the limit), is refused")
    return {"max_abs_err": worst, "checks": len(cases), "tol_used": used,
            "tf32_max_abs_err": tf32_err, "tf32_tol_used": tf32_used}


def lib_capacity_kb(dev) -> int:
    from repro_torch.core.profiles import device_smem_kb

    return device_smem_kb(dev)


def check_lintra(dev, gen) -> tuple[float, int, list, list]:
    """About 20 points on a ragged image and at bigben against the plain
    version, each new binary compiled from a cold Triton cache. Returns
    (max abs error, checks, seconds of each new compile, seconds of each
    new binary's first launch up to a sync)."""
    import torch

    from repro_torch.kernels.lintra.lintra import (
        LintraKernel, cold_triton_cache, compile_key, lintra_plain, lintra_triton)
    from repro_torch.kernels.lintra.ops import make_space

    cap = lib_capacity_kb(dev)
    worst, n_checks, compile_s, first_launch_s, seen = 0.0, 0, [], [], set()
    # its own binaries and a cold on-disk cache: each first compile is timed
    with cold_triton_cache():
        kernel = LintraKernel()
        for (h, w), stride in (((1000, 333), 9), ((2662, 5500), 17)):
            x = torch.randn(h, w * 3, generator=gen, device=dev)
            a = torch.tensor([1.5, 0.5, 2.0], device=dev)
            b = torch.tensor([0.1, -0.2, 0.3], device=dev)
            points = list(make_space(h, w, 3, vmem_kb=cap).iter_valid())[::stride][:10]
            for point in points:
                key = compile_key(point, 3, w * 3)
                t0 = time.perf_counter()
                kernel.compile(point, 3, w * 3, x.dtype, dev)
                t1 = time.perf_counter()
                got = lintra_triton(x, a, b, point, kernel=kernel)
                torch.cuda.synchronize()
                if key not in seen:
                    seen.add(key)
                    compile_s.append(t1 - t0)
                    first_launch_s.append(time.perf_counter() - t1)
                want = lintra_plain(x, a, b)
                err = float((got - want).abs().max())
                worst = max(worst, err)
                n_checks += 1
                if not torch.allclose(got, want, **LINTRA_TOL):
                    fail(f"lintra {point} at {(h, w)}: max|err| {err:.3e} "
                         f"beyond {LINTRA_TOL}")
    print(f"lintra: {n_checks} checks, max|err| {worst:.3e} within "
          f"rtol={LINTRA_TOL['rtol']} atol={LINTRA_TOL['atol']}; per new "
          f"binary, Triton compile s {[round(t, 3) for t in compile_s]}, "
          f"first launch s {[round(t, 3) for t in first_launch_s]}")
    return worst, n_checks, compile_s, first_launch_s


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke test runs on the card")
    # Triton's on-disk cache stays inside the checkout's build directory
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "repro_torch" / "triton-cache" / "default"))
    try:
        from repro_torch.bench import table3
        from repro_torch.kernels.euclid import ops as euclid_ops
        from repro_torch.kernels.euclid.euclid import euclid_cuda, euclid_plain
        from repro_torch.kernels.lintra.lintra import lintra_plain, lintra_triton
        from repro_torch.kernels.lintra.ops import DEFAULT_POINT as LINTRA_DEFAULT
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(f"card: {card}")
    # the plain versions' and the yardstick's products stay in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report: dict = {"card": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda}

    # -- 1. build the euclid library (set-up) -------------------------------
    lib = euclid_ops.build_kernels(dev)
    ptxas = ptxas_summary(lib.built.path.with_suffix(".ptxas.log"))
    report["euclid_build"] = {"seconds": lib.build_s, "built": lib.built.built,
                              "instantiations": len(lib.points), **ptxas}
    print(f"euclid build: {lib.build_s:.1f} s for {len(lib.points)} "
          f"instantiations (sm_90a); ptxas: {ptxas}")

    # -- 2. the main path: Table 3 at the PARSEC sizes ------------------------
    euclid_cuda.launches = 0
    lintra_triton.launches = 0
    t0 = time.perf_counter()
    rows = table3.run(device=dev)["rows"]
    main_s = time.perf_counter() - t0
    launches = {"euclid": euclid_cuda.launches, "lintra": lintra_triton.launches}
    print(f"main path: {main_s:.1f} s, kernel launches {launches}")
    for r in rows:
        print(f"  {r['bench']}/{r['input']}: calls={r['calls']} "
              f"Ref={r['Ref_s']:.4f}s Spec-Ref={r['SpecRef_s']:.4f}s "
              f"O-AT={r['OAT_s']:.4f}s BS-AT={r['BSAT_s']:.4f}s "
              f"speedup={r['OAT_speedup']:.3f} "
              f"overhead={100 * r['overhead_frac']:.2f}% "
              f"explored={r['explored']} launches={r['oat_launches']} "
              f"serving={r['final_point']}")
    report["table3"] = [table3.public(r) for r in rows]
    report["main_path_launches"] = launches
    bad = [f"{r['bench']}/{r['input']}" for r in rows if not r["ok"]]
    if bad:
        fail(f"tuned output disagrees with Spec-Ref: {bad}")
    faulted = [f"{r['bench']}/{r['input']}" for r in rows
               if r["_stats"]["quarantined"]]
    if faulted:
        fail(f"variants failed to build, launch or evaluate: {faulted}")
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched the {name} kernel")

    # -- 3. each kernel against its plain version -----------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    e_check = check_euclid(lib, dev, gen)
    l_err, l_checks, l_compile_s, l_first_s = check_lintra(dev, gen)
    report["triton_compile_s"] = l_compile_s
    report["triton_first_launch_s"] = l_first_s

    # -- 4. times at the main path's shapes -----------------------------------
    by = {(r["bench"], r["input"]): r for r in rows}
    er = by[("euclid", "simlarge")]
    N, M, D = er["N"], er["M"], er["D"]
    x = torch.randn(N, D, generator=gen, device=dev)
    c = torch.randn(M, D, generator=gen, device=dev)
    e_oat = serving(er, euclid_ops.DEFAULT_POINT)
    simd = euclid_ops.reference_simd(D)
    e = {"default_ms": time_ms(euclid_cuda, x, c, euclid_ops.DEFAULT_POINT),
         "oat_ms": time_ms(euclid_cuda, x, c, e_oat),
         "bsat_ms": time_ms(euclid_cuda, x, c, er["bsat_point"]),
         "plain_ms": time_ms(euclid_plain, x, c, euclid_ops.DEFAULT_POINT),
         "library_ms": time_ms(simd, x, c)}
    e_flops = 2.0 * N * M * D
    e_bytes = 4.0 * (N * D + M * D + N * M)
    e_bound = max(e_flops / PEAK_FP32_FLOPS, e_bytes / PEAK_BYTES_S) * 1e3

    lr = by[("lintra", "bigben")]
    H, W, B = lr["H"], lr["W"], lr["bands"]
    img = torch.randn(H, W, B, generator=gen, device=dev)
    xf = img.reshape(H, W * B)
    a = torch.tensor([1.5, 0.5, 2.0], device=dev)
    b = torch.tensor([0.1, -0.2, 0.3], device=dev)
    l_oat = serving(lr, LINTRA_DEFAULT)
    lt = {"default_ms": time_ms(lintra_triton, xf, a, b, LINTRA_DEFAULT),
          "oat_ms": time_ms(lintra_triton, xf, a, b, l_oat),
          "bsat_ms": time_ms(lintra_triton, xf, a, b, lr["bsat_point"]),
          "plain_ms": time_ms(lintra_plain, xf, a, b),
          "library_ms": time_ms(torch.addcmul, b, img, a)}
    l_bytes = 2.0 * H * W * B * 4 + 2.0 * B * 4
    l_flops = 2.0 * H * W * B
    l_bound = max(l_flops / PEAK_FP32_FLOPS, l_bytes / PEAK_BYTES_S) * 1e3
    l2_bytes = torch.cuda.get_device_properties(dev).L2_cache_size

    kernels = [
        {"name": "euclid", "route": "cuda", "source": EUCLID_SRC,
         "replaces": EUCLID_TPU, "launches": launches["euclid"],
         "max_abs_err": e_check["max_abs_err"], "ms": e["oat_ms"],
         "plain_ms": e["plain_ms"],
         "bound_ms": e_bound,
         "bound_by": "operations" if e_flops / PEAK_FP32_FLOPS > e_bytes / PEAK_BYTES_S else "bytes",
         "library_ms": e["library_ms"], "default_ms": e["default_ms"],
         "bsat_ms": e["bsat_ms"], "point": e_oat, "bsat_point": er["bsat_point"],
         "shape": [N, M, D], "checks": e_check["checks"],
         "tolerance": EUCLID_TOL, "tol_used": e_check["tol_used"],
         "tf32_control_max_abs_err": e_check["tf32_max_abs_err"],
         "tf32_control_tol_used": e_check["tf32_tol_used"]},
        {"name": "lintra", "route": "triton", "source": LINTRA_SRC,
         "replaces": LINTRA_TPU, "launches": launches["lintra"],
         "max_abs_err": l_err, "ms": lt["oat_ms"], "plain_ms": lt["plain_ms"],
         "bound_ms": l_bound,
         "bound_by": "operations" if l_flops / PEAK_FP32_FLOPS > l_bytes / PEAK_BYTES_S else "bytes",
         "library_ms": lt["library_ms"], "default_ms": lt["default_ms"],
         "bsat_ms": lt["bsat_ms"], "point": l_oat, "bsat_point": lr["bsat_point"],
         "shape": [H, W, B], "checks": l_checks,
         "bytes_per_s": l_bytes / (lt["oat_ms"] * 1e-3),
         "working_set_fits_l2": l_bytes <= l2_bytes},
    ]
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(card)
    print(json.dumps({"kernels": kernels}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
