"""Chip smoke test of the PyTorch/CUDA port on the card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

It builds every CUDA library from the repository's sources (sm_90a; the
four families in parallel), then drives the port's two paths, each with
the kernels' launch counts set to 0 just before and read just after:

1. the paper's Table 3 — ``repro_torch.bench.table3`` at the PARSEC
   sizes, the online auto-tuner generating, evaluating and swapping
   hand-kernel variants of euclid (CUDA C++) and lintra (Triton);
2. LM serving with kernel-granular tuning — the code of ``python -m
   repro_torch.launch.serve --arch deepseek-7b --autotune --kernel-tuning
   kernel --batch 4 --prompt-len 512 --tokens 32 --requests 2`` at
   deepseek-7b's full width and depth (random weights from a seed),
   running the matmul, rmsnorm and flash-attention CUDA C++ kernels.

Then it holds each kernel against its plain PyTorch version (every
instantiation at every ring depth at ragged shapes, a few points at the
main path's shapes, with limits a TF32 product fails, and a TF32 control
that shows it), compares the served model's prefill logits with the
plain versions on the CPU at full width and 2 layers, and times each
kernel beside its bound, its plain version and one PyTorch library call
(euclid at each Table 3 input; rmsnorm at prefill's and decode's
shapes). It prints one ``kernels`` JSON line and, last, ``{"ok": true,
"device": {...}}``.
A profiler trace of one prefill and a few decode steps at full width
says where the serving time goes (device busy share, kernels by device
time).

Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result. Full results go to
``chiprun_out/chip_smoke.json``. ``--only build,check`` (any of
``build``, ``table3``, ``serve``, ``profile``, ``check``, ``logits``,
``time``) runs a subset and prints no verdict: a quick look at a new
kernel (``--only build,check,time`` times the kernels at DEFAULT_POINT
where Table 3 has not run).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM data-sheet peaks (dense): fp32 outside the tensor
#: cores, TF32 on the tensor cores, and device-memory bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_S = 3.35e12

EUCLID_SRC = "src/repro_torch/kernels/euclid/csrc/euclid.cuh"
EUCLID_TPU = "src/repro/kernels/euclid/euclid.py:115"
LINTRA_SRC = "src/repro_torch/kernels/lintra/lintra.py"
LINTRA_TPU = "src/repro/kernels/lintra/lintra.py:67"
MATMUL_SRC = "src/repro_torch/kernels/matmul/csrc/matmul.cuh"
MATMUL_TPU = "src/repro/kernels/matmul/matmul.py:114"
RMSNORM_SRC = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cuh"
RMSNORM_TPU = "src/repro/kernels/rmsnorm/rmsnorm.py:40"
ATTENTION_SRC = "src/repro_torch/kernels/attention/csrc/attention.cuh"
ATTENTION_TPU = "src/repro/kernels/attention/attention.py:112"

#: the serving path, as its CLI would be called
SERVE_ARGS = ["--arch", "deepseek-7b", "--autotune", "--kernel-tuning", "kernel",
              "--batch", "4", "--prompt-len", "512", "--tokens", "32",
              "--requests", "2"]
PHASES = ("build", "table3", "serve", "profile", "check", "logits", "time")

#: limits of the kernels against their plain versions. euclid's is far
#: tighter than its KernelDef.tolerance (rtol 1e-3): a sound fp32 kernel
#: stays well inside it, and a TF32 product (about three digits) must not
#: pass it, which check_euclid verifies on the card. lintra's is its
#: KernelDef.tolerance.
EUCLID_TOL = {"rtol": 2e-5, "atol": 1e-5}
LINTRA_TOL = {"rtol": 1e-5, "atol": 1e-7}
#: the LM kernels against their plain versions, all fp32 (bf16 for the
#: second rmsnorm type). matmul: an fp32 sum of K <= 4096 unit-variance
#: products differs between two summation orders by about 1e-4 in
#: absolute terms, a TF32 product by about 3e-2. attention: outputs are
#: averages of unit-variance values, fp32 differences about 1e-7, a TF32
#: score or value product about 1e-4. rmsnorm: one row's fp32 statistics
#: (no product to run in TF32); bf16 outputs may differ by one rounding.
MATMUL_TOL = {"rtol": 2e-5, "atol": 1e-3}
ATTENTION_TOL = {"rtol": 1e-5, "atol": 1e-5}
RMSNORM_TOL = {"rtol": 1e-5, "atol": 1e-5}
RMSNORM_BF16_TOL = {"rtol": 1e-2, "atol": 1e-2}


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


def device_ms(fn, *args, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn(*args)`` with the host out of the
    way: ``reps`` calls captured in one CUDA graph, replayed three times
    between two events. For calls shorter than their host cost (a Python
    wrapper takes tens of microseconds), where ``time_ms`` times the
    host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


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
    frames = [int(f) for f in re.findall(r"(\d+) bytes stack frame", text)]
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "spilling_kernels": sum(1 for s in spills if s > 0),
            "max_spill_store_bytes": max(spills, default=0),
            "max_stack_frame_bytes": max(frames, default=0)}


def tol_used(got, want, tol: dict) -> float:
    """The largest ``|got - want| / (atol + rtol * |want|)``: at most 1
    where ``torch.allclose`` passes."""
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())


def check_euclid(lib, dev, gen) -> dict:
    """Every instantiation at every ring depth against the plain version
    at ragged shapes (N, M no multiple of any block; D = 70 or 130, rows
    of 280 or 520 bytes, the 4-byte copies), plus a few points at
    simlarge, then a control: a TF32 product at simlarge must fail the
    same limit."""
    import torch

    from repro_torch.kernels.euclid.euclid import PHASE1, euclid_cuda, euclid_plain
    from repro_torch.kernels.euclid.ops import (
        DEFAULT_POINT, kernel_points, make_space, reference_simd)

    cap = lib_capacity_kb(dev)
    points = kernel_points(cap)
    spaces = {d: make_space(1000, 1000, d, vmem_kb=cap, hopper=True) for d in (70, 130)}
    cases = []
    for i, tup in enumerate(points):
        for la in (0, 1, 2):
            k = 3 * i + la
            point = dict(zip(PHASE1, tup), order=("nm", "mn")[k % 2],
                         scratch=(k // 2) % 2, lookahead=la)
            d = next((d for d in (70, 130)[::1 - 2 * (k % 2)]
                      if spaces[d].is_valid(point)), None)
            if d is not None:
                cases.append(((1000, 1000, d), point))
    covered = {(tuple(p[k] for k in PHASE1), p["lookahead"]) for _, p in cases}
    if covered != {(t, la) for t in points for la in (0, 1, 2)} \
            or len(points) != len(lib.symbols):
        fail(f"{3 * len(points) - len(covered)} (instantiation, ring depth) pairs "
             f"left unchecked")
    big = make_space(16384, 1024, 128, vmem_kb=cap, hopper=True)
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
    print(f"euclid: {len(cases)} checks over {len(points)} instantiations x 3 ring "
          f"depths, max|err| {worst:.3e} within rtol={EUCLID_TOL['rtol']} "
          f"atol={EUCLID_TOL['atol']} ({used:.3f} of the limit)")

    # control: the same limit must refuse a TF32 product
    x, c = inputs[(16384, 1024, 128)]
    want = euclid_plain(x, c, DEFAULT_POINT)
    tf32_err, tf32_used = tf32_reading(lambda: reference_simd(128)(x, c), want,
                                       EUCLID_TOL)
    if tf32_used <= 1.0:
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


def bound(flops: float, nbytes: float, *, tf32x3: bool = False) -> tuple[float, str]:
    """The least ms the card could take, and what bounds it: the fp32
    operations on the CUDA cores, or (``tf32x3``) the same operations as
    three TF32 products on the tensor cores, against the bytes."""
    rate = PEAK_TF32_FLOPS / 3 if tf32x3 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / rate, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def build_all(dev) -> tuple[dict, dict]:
    """Every CUDA family, built at once (one nvcc per unit, all started
    together). Returns the libraries and their build report."""
    from repro_torch.kernels.attention import attention
    from repro_torch.kernels.euclid import ops as euclid_ops
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.rmsnorm import rmsnorm

    builders = {"euclid": euclid_ops.build_kernels, "matmul": matmul.build_kernels,
                "rmsnorm": rmsnorm.build_kernels, "attention": attention.build_kernels}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {n: pool.submit(b, dev) for n, b in builders.items()}
        libs = {n: f.result() for n, f in futures.items()}
    wall = time.perf_counter() - t0
    report = {"wall_s": wall}
    logs = ROOT / "chiprun_out" / "ptxas"
    logs.mkdir(parents=True, exist_ok=True)
    for name, lib in libs.items():
        n = len(lib.symbols)
        log = lib.built.path.with_suffix(".ptxas.log")
        if log.exists():
            (logs / f"{name}.log").write_text(log.read_text())
        report[name] = {"seconds": lib.build_s, "built": lib.built.built,
                        "instantiations": n,
                        **ptxas_summary(lib.built.path.with_suffix(".ptxas.log"))}
        print(f"{name} build: {lib.build_s:.1f} s for {n} instantiations "
              f"(sm_90a); ptxas: {report[name]}")
    report["euclid"]["load_s"] = libs["euclid"].load_s
    print(f"builds: {wall:.1f} s wall, in parallel; euclid's kernels loaded into "
          f"the context in {report['euclid']['load_s']:.3f} s (inside that wall)")
    return libs, report


def reset_lm_counts() -> None:
    from repro_torch.kernels.attention.attention import flash_attention_cuda
    from repro_torch.kernels.matmul.matmul import matmul_cuda
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda

    for fn in (matmul_cuda, rmsnorm_cuda, flash_attention_cuda):
        fn.launches = 0
    rmsnorm_cuda.launches_by_rows = {}


def lm_counts() -> dict:
    from repro_torch.kernels.attention.attention import flash_attention_cuda
    from repro_torch.kernels.matmul.matmul import matmul_cuda
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda

    return {"matmul": matmul_cuda.launches, "rmsnorm": rmsnorm_cuda.launches,
            "flash_attention": flash_attention_cuda.launches}


def run_serve() -> dict:
    """The serving path at full width, through the CLI's own code."""
    from repro_torch.launch import serve as serve_cli

    args, tcfg = serve_cli.parse_args(SERVE_ARGS)
    rows = []

    def on_request(req, out):
        a = out["autotune"]
        per = {n: {"regenerations": k["regenerations"], "swaps": k["swaps"],
                   "explored": k["n_explored"], "best_point": k["best_point"]}
               for n, k in sorted(a["kernels"].items())}
        row = {"request": req, "prefill_s": out["prefill_s"],
               "decode_s": out["decode_s"],
               "decode_tok_s": out["decode_tokens_per_s"],
               "regenerations": a["regenerations"], "swaps": a["swaps"],
               "overhead_pct": 100 * a["overhead_frac"],
               "tuning_spent_s": a["tuning_spent_s"], "busy_s": a["busy_s"],
               "init_spent_s": a["init_spent_s"], "quarantined": a["quarantined"],
               "tune_init_s": out["tune_init_s"], "kernels": per}
        rows.append(row)
        print(f"  req {req}: prefill {row['prefill_s']:.3f} s, decode "
              f"{row['decode_tok_s']:.1f} tok/s, regenerations "
              f"{row['regenerations']}, swaps {row['swaps']}, overhead "
              f"{row['overhead_pct']:.2f}%, explored "
              f"{ {n: k['explored'] for n, k in per.items()} }")

    reset_lm_counts()
    t0 = time.perf_counter()
    serve_cli.serve(args, tcfg, on_request=on_request)
    seconds = time.perf_counter() - t0
    launches = lm_counts()
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda
    rms_by_rows = dict(sorted(rmsnorm_cuda.launches_by_rows.items()))
    print(f"serve path: {seconds:.1f} s, kernel launches {launches}; rmsnorm "
          f"launches by rows {rms_by_rows} (prefill 2048, decode 4; other row "
          f"counts are the tuner's evaluations)")
    registered = set(rows[-1]["kernels"])
    print(f"  plane handles: {sorted(registered)}; decode_attention registered: "
          f"{'decode_attention' in registered} (its validator refuses every "
          f"k_chunk at B=4, Hk=32, Dh=128, as the reference's does)")
    missing = {"rmsnorm", "matmul", "attention"} - registered
    if missing:
        fail(f"attach_kernels left {sorted(missing)} without a handle")
    for name, n in launches.items():
        if n == 0:
            fail(f"the serving path never launched the {name} kernel")
    faulted = [r["request"] for r in rows if r["quarantined"]]
    if faulted:
        fail(f"variants were quarantined in requests {faulted}")
    return {"seconds": seconds, "launches": launches, "requests": rows,
            "handles": sorted(registered), "rmsnorm_launches_by_rows": rms_by_rows}


def profile_serve(dev, decode_steps: int = 8) -> dict:
    """Where a full-width request's time goes: one prefill and
    ``decode_steps`` decode steps of deepseek-7b (B = 4, T = 512, the
    step programs without a tuning session), each timed on the host
    around a device sync, then run again under ``torch.profiler``: the
    device busy share is the traced kernels' summed time over the
    untraced host interval (one stream, so kernels do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_tree

    cfg = get_config("deepseek-7b")
    model = build_model(cfg)
    params = init_tree(model.param_defs(),
                       torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab, (4, 512),
                           generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    max_len = 512 + decode_steps + 1

    def prefill():
        return model.prefill(params, {"tokens": tokens})

    def decode(state):
        tok, cache = state
        for i in range(decode_steps):
            logits, cache = model.decode_step(params, cache, tok, 512 + i)
            tok = logits[:, -1].argmax(-1)[:, None]
        return tok

    def decode_state():
        logits, (k, v) = prefill()
        cache = model.init_cache(4, max_len, device=dev)
        cache[0][:, :, :512] = k
        cache[1][:, :, :512] = v
        return logits[:, -1].argmax(-1)[:, None], cache

    decode(decode_state())                      # warm: allocator, cuBLAS
    out = {}
    for phase, fn in (("prefill", prefill), ("decode", decode)):
        # the host time without the profiler, which slows every launch
        arg = (decode_state(),) if phase == "decode" else ()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*arg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the device time with it: kernels and copies, not the host ops
        arg = (decode_state(),) if phase == "decode" else ()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*arg)
            torch.cuda.synchronize()
        dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}
        busy_s = sum(dev_us.values()) * 1e-6
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        out[phase] = {"wall_s": wall, "device_busy_s": busy_s,
                      "device_busy_share": busy_s / wall,
                      "rmsnorm_ms": sum(v for k, v in dev_us.items() if "rmsnorm" in k) * 1e-3,
                      "top_kernels_ms": {k: v * 1e-3 for k, v in top}}
    out["decode"]["step_s"] = out["decode"]["wall_s"] / decode_steps
    for phase, o in out.items():
        print(f"profile {phase}: {o['wall_s']:.4f} s on the host clock, device "
              f"busy {o['device_busy_s']:.4f} s ({100 * o['device_busy_share']:.1f}%), "
              f"rmsnorm {o['rmsnorm_ms']:.3f} ms; "
              f"top kernels (ms): "
              + ", ".join(f"{k[:40]} {v:.1f}" for k, v in list(o["top_kernels_ms"].items())[:5]))
    del params
    return out


def tf32_reading(fn, want, tol) -> tuple[float, float]:
    """max|err| and limit share of ``fn()`` run with TF32 products on."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fn()
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return float((got - want).abs().max()), tol_used(got, want, tol)


def check_cases(name, cases, tol) -> dict:
    """Run (label, kernel(), plain()) cases; fail beyond ``tol``."""
    import torch

    worst, used = 0.0, 0.0
    for label, kernel, plain in cases:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        used = max(used, tol_used(got.float(), want.float(), tol))
        if not torch.allclose(got.float(), want.float(), **tol):
            fail(f"{name} {label}: max|err| {err:.3e} beyond {tol}")
    print(f"{name}: {len(cases)} checks, max|err| {worst:.3e} within "
          f"rtol={tol['rtol']} atol={tol['atol']} ({used:.3f} of the limit)")
    return {"checks": len(cases), "max_abs_err": worst, "tol_used": used}


def check_matmul(lib, dev, gen) -> dict:
    """Every instantiation at a ragged shape (M, N, K no multiple of any
    block), a few points at the serving shape, and a TF32 control."""
    import torch

    from repro_torch.kernels.matmul.matmul import (
        PHASE1, instantiations, matmul_cuda, matmul_plain)
    from repro_torch.kernels.matmul.ops import make_space

    cases, inputs = [], {}

    def args(shape):
        if shape not in inputs:
            M, N, K = shape
            inputs[shape] = (torch.randn(M, K, generator=gen, device=dev),
                             torch.randn(K, N, generator=gen, device=dev))
        return inputs[shape]

    ragged = (333, 450, 700)
    for i, sym in enumerate(sorted(instantiations())):
        dims = [int(v) for v in re.findall(r"\d+", sym)]
        point = dict(zip(PHASE1, dims), order=("mn", "nm")[i % 2],
                     scratch=(i // 2) % 2, lookahead=i % 3)
        a, b = args(ragged)
        cases.append((f"{point} at {ragged}",
                      lambda a=a, b=b, p=point: matmul_cuda(a, b, p, lib=lib),
                      lambda a=a, b=b, p=point: matmul_plain(a, b, p)))
    serving = (2048, 11008, 4096)
    space = make_space(*serving, vmem_kb=lib_capacity_kb(dev), hopper=True)
    for point in list(space.iter_valid())[::271]:
        a, b = args(serving)
        cases.append((f"{point} at {serving}",
                      lambda a=a, b=b, p=point: matmul_cuda(a, b, p, lib=lib),
                      lambda a=a, b=b, p=point: matmul_plain(a, b, p)))
    out = check_cases("matmul", cases, MATMUL_TOL)
    a, b = args(serving)
    want = torch.matmul(a, b)
    out["tf32_max_abs_err"], out["tf32_tol_used"] = tf32_reading(
        lambda: torch.matmul(a, b), want, MATMUL_TOL)
    if out["tf32_tol_used"] <= 1.0:
        fail(f"a TF32 product passes the matmul limit {MATMUL_TOL}")
    print(f"matmul control: a TF32 product at the serving shape, max|err| "
          f"{out['tf32_max_abs_err']:.3e} ({out['tf32_tol_used']:.1f} of the "
          f"limit), is refused")
    return out


def check_attention(lib, dev, gen) -> dict:
    """Every instantiation at a ragged shape (Tkv no multiple of any
    block, G = 4), offset and non-causal calls, a few points at the
    serving shape, and a TF32 control."""
    import torch

    from repro_torch.kernels.attention.attention import (
        BLOCK_KV, BLOCK_Q, flash_attention_cuda, flash_attention_plain)

    cases, inputs = [], {}

    def args(B, Tq, Tkv, H, Hk):
        key = (B, Tq, Tkv, H, Hk)
        if key not in inputs:
            inputs[key] = (torch.randn(B, Tq, H, 128, generator=gen, device=dev),
                           torch.randn(B, Tkv, Hk, 128, generator=gen, device=dev),
                           torch.randn(B, Tkv, Hk, 128, generator=gen, device=dev))
        return inputs[key]

    def case(label, shape, point, **kw):
        q, k, v = args(*shape)
        cases.append((f"{point} {kw} at {shape} {label}",
                      lambda: flash_attention_cuda(q, k, v, point, lib=lib, **kw),
                      lambda: flash_attention_plain(q, k, v, point, **kw)))

    for i, (bq, bkv) in enumerate((bq, bkv) for bq in BLOCK_Q for bkv in BLOCK_KV):
        point = {"block_q": bq, "block_kv": bkv, "lookahead": i % 3}
        case("ragged", (2, 700, 700, 8, 2), point)
        case("offset", (1, 300, 1000, 8, 2), dict(point, lookahead=(i + 1) % 3),
             q_offset=700)
    case("non-causal", (2, 200, 333, 8, 2), {"block_q": 128, "block_kv": 256},
         causal=False)
    serving = (4, 512, 512, 32, 32)
    for point in ({"block_q": 512, "block_kv": 512}, {"block_q": 128, "block_kv": 128},
                  {"block_q": 256, "block_kv": 512}):
        case("serving", serving, point)
    out = check_cases("attention", cases, ATTENTION_TOL)
    q, k, v = args(*serving)
    point = {"block_q": 512, "block_kv": 512}
    want = flash_attention_plain(q, k, v, point)
    out["tf32_max_abs_err"], out["tf32_tol_used"] = tf32_reading(
        lambda: flash_attention_plain(q, k, v, point), want, ATTENTION_TOL)
    if out["tf32_tol_used"] <= 1.0:
        fail(f"TF32 products pass the attention limit {ATTENTION_TOL}")
    print(f"attention control: the plain version with TF32 products at the "
          f"serving shape, max|err| {out['tf32_max_abs_err']:.3e} "
          f"({out['tf32_tol_used']:.1f} of the limit), is refused")
    return out


def check_rmsnorm(lib, dev, gen) -> dict:
    """Every instantiation at every ring depth and type at ragged shapes
    (N not a multiple of block_rows, d not a multiple of 4: the element
    copies) and at the serving shapes, prefill's (2048, 4096) and
    decode's (4, 4096)."""
    import torch

    from repro_torch.kernels.rmsnorm.rmsnorm import (
        BLOCK_ROWS, rmsnorm_cuda, rmsnorm_plain)

    out = {}
    for dtype, tol in ((torch.float32, RMSNORM_TOL), (torch.bfloat16, RMSNORM_BF16_TOL)):
        cases = []
        for N, d in ((1000, 4096), (3, 1001), (2048, 4096), (4, 4096)):
            x = torch.randn(N, d, generator=gen, device=dev).to(dtype)
            w = torch.randn(d, generator=gen, device=dev).to(dtype)
            for rows in BLOCK_ROWS:
                for la in (0, 1, 2):
                    point = {"block_rows": rows, "lookahead": la}
                    cases.append((f"{point} at {(N, d)} {dtype}",
                                  lambda x=x, w=w, p=point: rmsnorm_cuda(x, w, p, lib=lib),
                                  lambda x=x, w=w, p=point: rmsnorm_plain(x, w, p)))
        out[str(dtype).removeprefix("torch.")] = check_cases(
            f"rmsnorm {dtype}", cases, tol)
    return {"checks": sum(v["checks"] for v in out.values()),
            "max_abs_err": out["float32"]["max_abs_err"],
            "tol_used": out["float32"]["tol_used"], "by_type": out}


def to_device(tree: dict, dev) -> dict:
    return {k: to_device(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def check_logits(dev) -> dict:
    """Request 0's prefill at full width and 2 layers: the hand kernels
    on the card against the plain versions on the CPU, same params."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_tree

    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=2)
    model = build_model(cfg)
    t0 = time.perf_counter()
    cpu_params = init_tree(model.param_defs(), torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (4, 512),
                           generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    gpu_params = to_device(cpu_params, dev)
    reset_lm_counts()
    got, _ = model.prefill(gpu_params, {"tokens": tokens})
    torch.cuda.synchronize()
    launched = lm_counts()
    want, _ = model.prefill(cpu_params, {"tokens": tokens.cpu()})
    got = got.cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    agree = float((got[:, -1].argmax(-1) == want[:, -1].argmax(-1)).float().mean())
    print(f"logits at full width, 2 layers: hand kernels on the card against "
          f"plain versions on the CPU, max|err| {err:.3e} (max|logit| "
          f"{scale:.3e}), greedy tokens agree {agree:.2f}; kernel launches "
          f"{launched}; {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": err, "max_abs_logit": scale, "greedy_agree": agree,
            "launches": launched}


def time_lm(libs, dev, gen, serve_report) -> dict:
    """Each LM kernel at the serving shapes beside its bound, its plain
    version and one library call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention.attention import (
        flash_attention_cuda, flash_attention_plain)
    from repro_torch.kernels.matmul.matmul import matmul_cuda, matmul_plain
    from repro_torch.kernels.matmul.ops import DEFAULT_POINT as MM_DEFAULT
    from repro_torch.kernels.rmsnorm.ops import DEFAULT_POINT as RN_DEFAULT
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda, rmsnorm_plain

    tuned = {}
    if serve_report:
        tuned = {n: k["best_point"]
                 for n, k in serve_report["requests"][-1]["kernels"].items()}
    out = {}
    M, N, K = 2048, 11008, 4096
    a = torch.randn(M, K, generator=gen, device=dev)
    b = torch.randn(K, N, generator=gen, device=dev)
    mm_best = tuned.get("matmul") or MM_DEFAULT
    lib = libs["matmul"]
    out["matmul"] = {
        "ms": time_ms(matmul_cuda, a, b, mm_best, reps=5, warmup=1),
        "default_ms": time_ms(matmul_cuda, a, b, MM_DEFAULT, reps=5, warmup=1),
        "plain_ms": time_ms(matmul_plain, a, b, mm_best, reps=5, warmup=1),
        "library_ms": time_ms(torch.matmul, a, b, reps=5, warmup=1),
        "point": mm_best, "shape": [M, N, K]}
    mm_work = (2.0 * M * N * K, 4.0 * (M * K + K * N + M * N))
    out["matmul"]["bound_ms"], out["matmul"]["bound_by"] = bound(*mm_work)
    out["matmul"]["bound_3xtf32_ms"] = bound(*mm_work, tf32x3=True)[0]
    del a, b

    B, T, H, Dh = 4, 512, 32, 128
    q = torch.randn(B, T, H, Dh, generator=gen, device=dev)
    k = torch.randn(B, T, H, Dh, generator=gen, device=dev)
    v = torch.randn(B, T, H, Dh, generator=gen, device=dev)
    step_point = {"block_q": 512, "block_kv": 512}
    at_best = tuned.get("attention") or step_point
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # the step programs adopt the plane's best blocks once it has one;
    # before that they use the config's chunks, clamped: (512, 512)
    out["attention"] = {
        "ms": time_ms(flash_attention_cuda, q, k, v, at_best),
        "untuned_ms": time_ms(flash_attention_cuda, q, k, v, step_point),
        "plain_ms": time_ms(flash_attention_plain, q, k, v, at_best),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "point": at_best, "untuned_point": step_point, "shape": [B, T, H, Dh]}
    at_work = (4.0 * B * H * T * T * Dh * 0.5, 4.0 * 4 * B * T * H * Dh)
    out["attention"]["bound_ms"], out["attention"]["bound_by"] = bound(*at_work)
    out["attention"]["bound_3xtf32_ms"] = bound(*at_work, tf32x3=True)[0]

    x = torch.randn(M, K, generator=gen, device=dev)
    w = torch.randn(K, generator=gen, device=dev)
    rn_best = tuned.get("rmsnorm") or RN_DEFAULT
    # device times from graph replays: an eager call's host cost is longer
    # than the kernel at both shapes
    out["rmsnorm"] = {
        "ms": device_ms(rmsnorm_cuda, x, w, RN_DEFAULT),
        "tuned_ms": device_ms(rmsnorm_cuda, x, w, rn_best),
        "block_rows_8_ms": device_ms(rmsnorm_cuda, x, w, dict(RN_DEFAULT, block_rows=8)),
        "plain_ms": device_ms(rmsnorm_plain, x, w, RN_DEFAULT),
        "library_ms": device_ms(lambda: F.rms_norm(x, (K,), w, eps=1e-6)),
        "eager_ms": time_ms(rmsnorm_cuda, x, w, RN_DEFAULT),
        "point": RN_DEFAULT, "tuned_point": rn_best, "shape": [M, K]}
    out["rmsnorm"]["bound_ms"], out["rmsnorm"]["bound_by"] = bound(
        4.0 * M * K, 4.0 * (2 * M * K + K))
    # decode's shape: the step programs launch at RMSNORM_POINT (DEFAULT_POINT)
    xd = x[:4].clone()
    decode = {
        "ms": device_ms(rmsnorm_cuda, xd, w, RN_DEFAULT),
        "plain_ms": device_ms(rmsnorm_plain, xd, w, RN_DEFAULT),
        "library_ms": device_ms(lambda: F.rms_norm(xd, (K,), w, eps=1e-6)),
        "eager_ms": time_ms(rmsnorm_cuda, xd, w, RN_DEFAULT),
        "library_eager_ms": time_ms(lambda: F.rms_norm(xd, (K,), w, eps=1e-6)),
        "point": RN_DEFAULT, "shape": [4, K]}
    decode["bound_ms"], decode["bound_by"] = bound(4.0 * 4 * K, 4.0 * (2 * 4 * K + K))
    out["rmsnorm"].update({f"decode_{k}": v for k, v in decode.items()})
    for name, t in out.items():
        bounds = f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, fp32 CUDA cores; "
        bounds += f"{t['bound_ms'] / t['ms']:.3f} of it reached"
        if "bound_3xtf32_ms" in t:
            bounds += (f"; 3xTF32 tensor-core bound {t['bound_3xtf32_ms']:.4f} ms, "
                       f"{t['bound_3xtf32_ms'] / t['ms']:.3f} of it reached")
        print(f"{name} at {t['shape']}: {t['ms']:.4f} ms ({bounds}); plain "
              f"{t['plain_ms']:.4f} ms; library {t['library_ms']:.4f} ms; "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items()
                          if k.endswith("_ms") and k not in
                          ("bound_ms", "bound_3xtf32_ms", "plain_ms", "library_ms")))
    return out


def time_euclid(rows, dev, gen) -> dict:
    """euclid at each Table 3 input (M = 1024 centres), at DEFAULT_POINT and
    at the point that served at the end of the O-AT run, beside the plain
    version, cuBLAS's Spec-Ref (one fp32 product) and both bounds, and
    the best point of a sweep of the card's space at simlarge. Without
    Table 3's rows (``--only`` without ``table3``) the O-AT point is
    DEFAULT_POINT."""
    import torch

    from repro_torch.bench.table3 import EUCLID_SIZES, M_CENTERS
    from repro_torch.kernels.euclid import ops as euclid_ops
    from repro_torch.kernels.euclid.euclid import euclid_cuda, euclid_plain

    by = {r["input"]: r for r in rows or () if r["bench"] == "euclid"}
    out = {}
    for name, (N, D) in EUCLID_SIZES.items():
        M = M_CENTERS
        x = torch.randn(N, D, generator=gen, device=dev)
        c = torch.randn(M, D, generator=gen, device=dev)
        default = euclid_ops.DEFAULT_POINT
        row = by.get(name)
        oat = serving(row, default) if row else dict(default)
        # device times from graph replays: at simsmall an eager call's
        # host cost is longer than the kernel
        t = {"default_ms": device_ms(euclid_cuda, x, c, default),
             "oat_ms": device_ms(euclid_cuda, x, c, oat),
             "plain_ms": device_ms(euclid_plain, x, c, default),
             "library_ms": device_ms(euclid_ops.reference_simd(D), x, c),
             "eager_ms": time_ms(euclid_cuda, x, c, oat),
             "point": oat, "shape": [N, M, D]}
        if row:
            t["bsat_ms"] = device_ms(euclid_cuda, x, c, row["bsat_point"])
            t["bsat_point"] = row["bsat_point"]
        work = (2.0 * N * M * D, 4.0 * (N * D + M * D + N * M))
        t["bound_ms"], t["bound_by"] = bound(*work)
        t["bound_3xtf32_ms"] = bound(*work, tf32x3=True)[0]
        if name == "simlarge":
            # every instantiation and ring depth at order "nm", scratch 1
            # (each launch is longer than its host cost here)
            sweep = []
            for p in euclid_ops.make_space(N, M, D, vmem_kb=lib_capacity_kb(dev),
                                           hopper=True).iter_valid():
                if p["order"] == "nm" and p["scratch"] == 1:
                    sweep.append((time_ms(euclid_cuda, x, c, p, reps=5, warmup=1), p))
            sweep.sort(key=lambda r: r[0])
            t["sweep_points"] = len(sweep)
            t["sweep_best_ms"], t["sweep_best_point"] = sweep[0]
            t["sweep_median_ms"] = sweep[len(sweep) // 2][0]
            print(f"euclid simlarge sweep of {len(sweep)} points: best "
                  f"{sweep[0][0]:.4f} ms at {sweep[0][1]}, median "
                  f"{t['sweep_median_ms']:.4f} ms; next: "
                  + "; ".join(f"{ms:.4f} {p}" for ms, p in sweep[1:5]))
        out[name] = t
        print(f"euclid {name} {t['shape']}: O-AT point {t['oat_ms']:.4f} ms, "
              f"DEFAULT_POINT {t['default_ms']:.4f} ms, cuBLAS Spec-Ref "
              f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4f} ms fp32 CUDA cores ({t['bound_by']}), "
              f"{t['bound_3xtf32_ms']:.4f} ms 3xTF32 tensor cores "
              f"({t['bound_3xtf32_ms'] / t['oat_ms']:.3f} of it reached); O-AT point "
              f"{oat}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated phases of {PHASES}; a subset "
                         "prints no verdict")
    only = set(ap.parse_args(argv).only.split(","))
    if only - set(PHASES):
        fail(f"unknown phases {sorted(only - set(PHASES))}")
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
        from repro_torch.kernels.euclid.euclid import euclid_cuda
        from repro_torch.kernels.lintra.lintra import lintra_plain, lintra_triton
        from repro_torch.kernels.lintra.ops import DEFAULT_POINT as LINTRA_DEFAULT
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(f"card: {card}")
    # the plain versions' and the yardsticks' products stay in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report: dict = {"card": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda, "phases": sorted(only)}

    def save() -> None:
        report["seconds"] = time.perf_counter() - t_start
        (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))

    # -- 1. build every CUDA library (set-up) -------------------------------
    libs, report["builds"] = build_all(dev)
    lib = libs["euclid"]
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 2. the first path: Table 3 at the PARSEC sizes ---------------------
    rows = None
    if "table3" in only:
        euclid_cuda.launches = 0
        lintra_triton.launches = 0
        t0 = time.perf_counter()
        rows = table3.run(device=dev)["rows"]
        main_s = time.perf_counter() - t0
        launches = {"euclid": euclid_cuda.launches, "lintra": lintra_triton.launches}
        print(f"Table 3 path: {main_s:.1f} s, kernel launches {launches}")
        for r in rows:
            print(f"  {r['bench']}/{r['input']}: calls={r['calls']} "
                  f"Ref={r['Ref_s']:.4f}s Spec-Ref={r['SpecRef_s']:.4f}s "
                  f"O-AT={r['OAT_s']:.4f}s BS-AT={r['BSAT_s']:.4f}s "
                  f"speedup={r['OAT_speedup']:.3f} "
                  f"overhead={100 * r['overhead_frac']:.2f}% "
                  f"explored={r['explored']} launches={r['oat_launches']} "
                  f"serving={r['final_point']}")
        report["table3"] = [table3.public(r) for r in rows]
        report["table3_seconds"] = main_s
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
                fail(f"the Table 3 path never launched the {name} kernel")
        save()

    # -- 3. the second path: LM serving with kernel tuning ------------------
    serve_report = None
    if "serve" in only:
        serve_report = report["serve"] = run_serve()
        torch.cuda.empty_cache()
        save()

    if "profile" in only:
        report["profile"] = profile_serve(dev)
        torch.cuda.empty_cache()
        save()

    # -- 4. each kernel against its plain version ---------------------------
    if "check" in only:
        report["checks"] = {
            "euclid": check_euclid(lib, dev, gen),
            "matmul": check_matmul(libs["matmul"], dev, gen),
            "attention": check_attention(libs["attention"], dev, gen),
            "rmsnorm": check_rmsnorm(libs["rmsnorm"], dev, gen),
        }
        l_err, l_checks, l_compile_s, l_first_s = check_lintra(dev, gen)
        report["checks"]["lintra"] = {"max_abs_err": l_err, "checks": l_checks}
        report["triton_compile_s"] = l_compile_s
        report["triton_first_launch_s"] = l_first_s
        torch.cuda.empty_cache()
        save()
    if "logits" in only:
        report["logits"] = check_logits(dev)
        torch.cuda.empty_cache()
        save()

    # -- 5. times at the main paths' shapes ---------------------------------
    if "time" in only:
        report["euclid_times"] = time_euclid(rows, dev, gen)
        report["times"] = time_lm(libs, dev, gen, serve_report)
        save()

    if only != set(PHASES):
        save()
        print(f"phases {sorted(only)} done; no verdict for a subset")
        return 0

    by = {(r["bench"], r["input"]): r for r in rows}
    er = by[("euclid", "simlarge")]
    e = report["euclid_times"]["simlarge"]
    N, M, D = e["shape"]

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
    l_bound, l_by = bound(2.0 * H * W * B, l_bytes)
    l2_bytes = torch.cuda.get_device_properties(dev).L2_cache_size
    del img, xf
    lm = report["times"]

    checks = report["checks"]
    launches = report["main_path_launches"]
    e_check = checks["euclid"]
    kernels = [
        {"name": "euclid", "route": "cuda", "source": EUCLID_SRC,
         "replaces": EUCLID_TPU, "launches": launches["euclid"],
         "max_abs_err": e_check["max_abs_err"], "ms": e["oat_ms"],
         "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
         "library_ms": e["library_ms"], "default_ms": e["default_ms"],
         "bsat_ms": e["bsat_ms"], "bound_3xtf32_ms": e["bound_3xtf32_ms"],
         "point": e["point"], "bsat_point": er["bsat_point"],
         "shape": [N, M, D], "checks": e_check["checks"],
         "tolerance": EUCLID_TOL, "tol_used": e_check["tol_used"],
         "tf32_control_max_abs_err": e_check["tf32_max_abs_err"],
         "tf32_control_tol_used": e_check["tf32_tol_used"],
         "by_input": report["euclid_times"]},
        {"name": "lintra", "route": "triton", "source": LINTRA_SRC,
         "replaces": LINTRA_TPU, "launches": launches["lintra"],
         "max_abs_err": checks["lintra"]["max_abs_err"], "ms": lt["oat_ms"],
         "plain_ms": lt["plain_ms"], "bound_ms": l_bound, "bound_by": l_by,
         "library_ms": lt["library_ms"], "default_ms": lt["default_ms"],
         "bsat_ms": lt["bsat_ms"], "point": l_oat, "bsat_point": lr["bsat_point"],
         "shape": [H, W, B], "checks": checks["lintra"]["checks"],
         "bytes_per_s": l_bytes / (lt["oat_ms"] * 1e-3),
         "working_set_fits_l2": l_bytes <= l2_bytes},
    ]
    serve_launches = serve_report["launches"]
    for name, key, src, tpu, tol in (
            ("matmul", "matmul", MATMUL_SRC, MATMUL_TPU, MATMUL_TOL),
            ("rmsnorm", "rmsnorm", RMSNORM_SRC, RMSNORM_TPU, RMSNORM_TOL),
            ("flash_attention", "attention", ATTENTION_SRC, ATTENTION_TPU,
             ATTENTION_TOL)):
        t, chk = lm[key], checks[key]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": serve_launches[name],
                 "max_abs_err": chk["max_abs_err"], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "point": t["point"], "shape": t["shape"], "checks": chk["checks"],
                 "tolerance": tol, "tol_used": chk["tol_used"]}
        entry.update({k: v for k, v in t.items() if k.endswith("_ms")
                      and k not in entry})
        if name == "rmsnorm":
            entry["decode_shape"] = t["decode_shape"]
            entry["launches_by_rows"] = serve_report["rmsnorm_launches_by_rows"]
        if "tf32_max_abs_err" in chk:
            entry["tf32_control_max_abs_err"] = chk["tf32_max_abs_err"]
            entry["tf32_control_tol_used"] = chk["tf32_tol_used"]
        kernels.append(entry)
    report["kernels"] = kernels
    save()
    print(card)
    print(json.dumps({"kernels": kernels}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
