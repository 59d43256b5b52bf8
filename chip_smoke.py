"""Chip smoke test of the PyTorch/CUDA port on the card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

It builds every CUDA library from the repository's sources (sm_90a; the
four families in parallel), then drives the port's paths, each with
the kernels' launch counts set to 0 just before and read just after:

1. the paper's Table 3 — ``repro_torch.bench.table3`` at the PARSEC
   sizes, the online auto-tuner generating, evaluating and swapping
   hand-kernel variants of euclid (CUDA C++) and lintra (Triton);
2. LM serving with kernel-granular tuning — the code of ``python -m
   repro_torch.launch.serve --arch deepseek-7b --autotune --kernel-tuning
   kernel --batch 4 --prompt-len 512 --tokens 32 --requests 2`` at
   deepseek-7b's full width and depth (random weights from a seed),
   running the matmul, rmsnorm and flash-attention CUDA C++ kernels,
   with ``--registry``; then (phase ``warm``) a second process of the
   same command with ``--requests 1`` must warm-start every kernel handle
   from that registry. The serve phase also times each handle's starting
   points (its explorer's base point, its ``DEFAULT_POINT`` and its
   served point) and lists every evaluation's score;
3. LM training — ``repro_torch.runtime.train_loop.train`` on deepseek-7b
   at full width, cut to 2 of its 30 layers (the fp32 AdamW state of all
   30 does not fit the card), B = 4, T = 512, with ``--autotune
   --kernel-tuning both``: 12 steps with a checkpoint at step 12, then a
   second run to step 14 that must resume there with a warm-started
   registry. The step's forward launches the rmsnorm and flash-attention
   kernels through their autograd Functions (again in each block's
   recompute); the handles' evaluations launch all three;
4. the rest of the front door (phase ``front``) — quickstart's real run
   (``examples/torch_quickstart.py``, euclid), paper Table 4
   (``benchmarks/torch_table4_tuning_stats.py``, euclid and lintra), the
   compile farm's ``process`` backend compiling lintra's Triton binaries
   in spawned children, and the reduced serve example
   (``examples/torch_serve_lm.py``: heads of 16, so the flash kernel's
   Dh 16 instantiations);
5. the MoE, VLM and encoder-decoder families (phase ``families``), each
   at full width under the serve CLI's session (``make_session``,
   ``--autotune --kernel-tuning kernel``), the whole model through its
   ``serve``, the ones cut in depth through ``serve_loop.generate``, each
   model's weights freed before the next (FAMILY_RUNS): qwen3-moe-30b-a3b (128
   experts top-8, heads of 64 over 4 kv heads) cut to 16 of its 48
   layers, B 4, prompt 512, 32 tokens, 2 requests; llama4-scout-17b-a16e
   (a shared expert, GQA group 5) cut to 2 of 48, 8 tokens; qwen2-vl-7b
   (M-RoPE, group 7) cut to 4 of 28, with its 1024 patch embeddings and
   512 tokens (prefill T 1536), 16 tokens; whisper-tiny whole (the
   encoder's and cross-attention's non-causal calls over 1500 frames),
   prompt 32, 32 tokens, 2 requests. No attention call of these models
   may run the plain version. Then a profiled qwen3-moe prefill and 4
   decode steps, and qwen3-moe's logits at full width, 2 layers, against
   the CPU, the routing compared first;
6. the hybrid and RWKV families (phase ``recurrent``), whole (every
   layer) and at full width under the same session, each model's weights
   freed before the next (RECURRENT_RUNS): hymba-1.5b (parallel
   windowed attention and SSM heads) and rwkv6-1.6b (no attention), each
   at B 4, prompt 512, 32 tokens, 2 requests, then B 1, prompt 4096, 16
   tokens (hymba past its window of 2048). Every full-sequence attention
   call of hymba must run the plain version with its window, as the
   reference's does; rwkv6 makes none; neither launches the flash kernel
   from its layers, both the rmsnorm kernel. Then a profiled request of
   each, with its SSM scan or WKV chunks in profiler ranges beside their
   bounds; both models' logits at 2 layers against the CPU over a
   prefill and 8 decode steps; and the gap between decoding token T and
   prefilling T + 1 tokens at chunks of 128 and 16, T 512 and 600
   (ROADMAP Queue 3, R4), reported and not held;
7. the distributed and launch layer (phase ``dist``). The machine has one
   card, so no collective crosses a wire here: collectives run only on
   gloo CPU ranks in the tests and on a fake process group in the dry
   run. On a one-rank NCCL group and a 1 x 1 ``(data, model)`` mesh on
   the card, deepseek-7b's train cell from ``launch.shapes.build_cell``
   (full width, 2 of 30 layers, B 4, T 512, fp32: the train phase's cut)
   takes 3 steps from seed 0 with DTensor parameters, and its prefill
   cell runs whole (30 layers, B 4, T 512, fp32). The losses, the
   updated parameters and the logits must equal the unsharded port's on
   the same batches within 1e-6 relative (a 1 x 1 mesh reorders no
   sum), the rmsnorm and flash kernels must launch inside the sharded
   steps (on the local shards) and the plain attention must never run.
   Beside each cell's measured step and peak memory stand the graph
   walker's FLOPs, bytes and peak for the same cell traced on a fake
   1 x 1 group on the host, and the fp32 roofline terms. The host also
   runs, on its own PyTorch (printed first), started at the beginning of
   the run so that they overlap the other phases: deepseek-7b's
   production train and decode cells at full depth on a fake group of
   256 (DIST_DRYRUN), which must read a useful ratio of at least 0.75
   and a peak of at most 8.5 GiB; the cells that torch 2.11's DTensor
   once failed or replicated, the MoE train cell, the two long decode
   cells and three prefill cells (deepseek-7b, qwen2.5-32b, whisper-tiny
   at the dry run's prefill chunks 4096 x 8192), cut to one layer, on
   the 16 x 16 mesh and (deepseek-7b's train cell) the 2 x 16 x 16 one
   (``repro_torch.launch.dist_cells``), whose product FLOPs and link
   bytes must be within 1 % of those torch 2.13 traced
   (``dist_cells.json``) and their HBM bytes and peak within 10 %; and
   the families' sharded gradients against the unsharded ones on 4 gloo
   ranks (``tests/test_torch_distributed_families.py``'s worker and
   cases, within 1e-4 relative L2), and the decode step's logits and
   caches likewise at batch 1, which does not split over the data axis,
   and 4 (``tests/test_torch_dist_decode.py``, within 1e-5). The
   report's ``dist`` entry holds the torch version, each cut cell's
   counts beside 2.13's, and each check's worst case;
8. serving in bf16 (phase ``bf16``): deepseek-7b (all 30 layers) and
   qwen3-moe-30b-a3b (all 48 layers, 60.2 GB of bf16 weights) at full
   width under the serve CLI's session (``--autotune --kernel-tuning
   kernel``) with params and compute in bf16 (``BF16_RUNS``), through
   ``serve_loop.generate``. Every plane handle must be registered at
   dtype bfloat16, the bf16 instantiations of the matmul, attention and
   rmsnorm kernels must launch and no fp32 one may, and no variant may
   be quarantined. Then deepseek-7b's prefill logits at full width, 2
   layers: the bf16 run with the hand kernels (a) against the bf16 run
   through the plain versions (b) and the fp32 run of the same params
   (c); the kernels may add no more error than bf16 itself, so the
   relative L2 distance of (a) from (b) may not pass that of (b) from
   (c). Every bf16 matmul and attention launch of the phase must take
   the wgmma path (the kernels on Hopper's wgmma, TMA and mbarriers);
   the launches by path are printed.

The build phase also reads the SASS of the matmul and attention
libraries (``cuobjdump --dump-sass``): each bf16 wgmma kernel, one for
each ``_bf16`` symbol, must hold HGMMA and UTMALDG instructions; their
registers, spill bytes and the warpgroup waits ptxas inserted are
printed.

Then it holds each kernel against its plain PyTorch version (every
instantiation at every ring depth at ragged shapes — for attention at
each head dim, 16, 64 and 128 — a few points at the
main path's shapes, with limits a TF32 product fails, and a TF32 control
that shows it; the bf16 instantiations of matmul and attention likewise,
on bf16 inputs, on both bf16 paths (the wgmma kernels at shapes TMA can
describe, PR 21's mma.sync kernels at ones it cannot: K or N no
multiple of 8, k and v one element past 16 bytes), within MATMUL_TOL
and ATTENTION_BF16_TOL, with a control that attention with p rounded
to fp8 fails), compares the
served model's prefill logits with the
plain versions on the CPU at full width and 2 layers (and the training
loss's gradient of every parameter the same way), holds the gradients of
the rmsnorm and attention Functions against autograd through their
plain versions, and times each kernel beside its bound, its plain
version and one PyTorch library call (euclid at each Table 3 input;
rmsnorm at prefill's and decode's shapes, at d 4096 and at hymba's 1600;
the bf16 matmul and attention at the bf16 phase's handle shapes beside
PR 21's mma.sync kernels at the same points, against the bf16 tensor
cores' 989 TFLOP/s; rmsnorm on bf16 at the bf16 phase's rows, d 4096
and 2048). It prints the total and the build seconds, one ``kernels``
JSON line and, last, ``{"ok": true, "device": {...}}``.
A profiler trace of one prefill and a few decode steps at full width
says where the serving time goes (device busy share, kernels by device
time), and one of 3 training steps where the training time goes, the
forward, the backward and the update apart.

Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result. Full results go to
``chiprun_out/chip_smoke.json``. ``--only build,check`` (any of
``build``, ``table3``, ``serve``, ``warm`` (after ``serve``), ``profile``,
``front``, ``families``, ``recurrent``, ``bf16``, ``check``, ``logits``, ``train``,
``dist``, ``time``) runs a subset and
prints no verdict: a quick look at a new
kernel (``--only build,check,time`` times the kernels at DEFAULT_POINT
where Table 3 has not run).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
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
#: cores, TF32 and bf16 on the tensor cores, and device-memory bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
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

#: the serving path's registry: written when the serve phase's session
#: closes, read by the warm phase's second process, removed after it
SERVE_REGISTRY = ROOT / "build" / "serve_registry.json"
#: the serving path, as its CLI would be called
SERVE_ARGS = ["--arch", "deepseek-7b", "--autotune", "--kernel-tuning", "kernel",
              "--batch", "4", "--prompt-len", "512", "--tokens", "32",
              "--requests", "2", "--registry", str(SERVE_REGISTRY)]
#: the reduced serve example, as its command line would be called
SERVE_EXAMPLE_ARGS = ["--arch", "deepseek-7b", "--autotune", "--kernel-tuning", "kernel",
                      "--requests", "2"]
PHASES = ("build", "table3", "serve", "warm", "profile", "front", "families", "recurrent",
          "bf16", "check", "logits", "train", "dist", "time")
#: the families phase: each model at full width, its depth cut to what
#: the card holds (None: all of it), served under the serve CLI's
#: session with --kernel-tuning kernel (see run_family):
#: (arch, layers, batch, prompt, new tokens, requests)
FAMILY_RUNS = (
    ("qwen3-moe-30b-a3b", 16, 4, 512, 32, 2),
    ("llama4-scout-17b-a16e", 2, 4, 512, 8, 1),
    ("qwen2-vl-7b", 4, 4, 512, 16, 1),
    ("whisper-tiny", None, 4, 32, 32, 2),
)
#: the recurrent phase: hymba-1.5b and rwkv6-1.6b whole (every layer) at
#: full width, served under the serve CLI's session with --kernel-tuning
#: kernel (see run_family): (arch, batch, prompt, new tokens, requests).
#: The prompt of 4096 runs hymba past its window of 2048 (the prefill
#: mask, the cache's tail slice, and the decode write clamped to the
#: cache's last slot from the first step: ROADMAP Queue 3, R3) and shows
#: whether rwkv6's decode rate holds with its O(1) state
RECURRENT_RUNS = (
    ("hymba-1.5b", 4, 512, 32, 2),
    ("hymba-1.5b", 1, 4096, 16, 1),
    ("rwkv6-1.6b", 4, 512, 32, 2),
    ("rwkv6-1.6b", 1, 4096, 16, 1),
)
#: the bf16 phase: each model whole at full width with params and compute
#: in bf16, served under the serve CLI's session with --kernel-tuning
#: kernel (see run_family): (arch, batch, prompt, new tokens, requests),
#: the serve path's traffic
BF16_RUNS = (
    ("deepseek-7b", 4, 512, 32, 2),
    ("qwen3-moe-30b-a3b", 4, 512, 32, 2),
)
#: the bf16 phase's model-level check: deepseek-7b at full width, this
#: many layers, B 4, T 512
BF16_LOGIT_LAYERS = 2
#: the recurrent phase's card-against-CPU comparison: 2 layers at full
#: width, B 4, T 512, then this many decode steps fed the card's tokens
RECURRENT_DECODE_STEPS = 8
#: the chunk lengths and prompts at which R4's prefill/decode gap is
#: read. Token T of prefill(T + 1) sits at T mod chunk in its chunk: at
#: 512 it opens a chunk of 128, where no clamp binds, so the two agree;
#: at 600 it sits 88 deep, where the reference's clamps bind
R4_CHUNKS = (128, 16)
R4_PROMPTS = (512, 600)
#: the batch and prompt of every profiled request (profile_serve)
PROFILE_BATCH, PROFILE_SEQ = 4, 512
#: the decode steps of the families phase's profiled qwen3-moe request
MOE_PROFILE_DECODE_STEPS = 4
#: the flash kernel's calls on the families path, (B, Tq, Tkv, H, Hk, Dh):
#: qwen3-moe's prefill (GQA group 8), llama4-scout's (group 5),
#: qwen2-vl's (group 7, 1024 patches and 512 tokens), whisper-tiny's
#: decoder prefill, encoder self-attention and cross-attention prefill
FAMILY_ATTENTION_SHAPES = (
    ("qwen3-moe prefill", (4, 512, 512, 32, 4, 64), True),
    ("llama4-scout prefill", (4, 512, 512, 40, 8, 128), True),
    ("qwen2-vl prefill", (4, 1536, 1536, 28, 4, 128), True),
    ("whisper decoder prefill", (4, 32, 32, 6, 6, 64), True),
    ("whisper encoder", (4, 1500, 1500, 6, 6, 64), False),
    ("whisper cross-attention", (4, 32, 1500, 6, 6, 64), False),
)
#: the rmsnorm kernel's rows and widths on the families path: prefill's
#: 2048 rows and decode's 4 at qwen3-moe's, llama4-scout's and qwen2-vl's
#: d_model, and qwen2-vl's prefill of 6144 rows
FAMILY_RMSNORM_SHAPES = ((2048, 2048), (4, 2048), (2048, 5120), (4, 5120),
                         (2048, 3584), (4, 3584), (6144, 3584))
#: the rmsnorm kernel's rows and widths on the recurrent path: hymba's d
#: 1600 at prefill's 2048 rows, decode's 4 and the long prompt's 4096
#: (and its decode's 1); rwkv6's d 2048 at 4096 rows and 1
RECURRENT_RMSNORM_SHAPES = ((2048, 1600), (4, 1600), (4096, 1600), (1, 1600),
                            (4096, 2048), (1, 2048))
#: the training path: deepseek-7b at full width cut to 2 layers, B 4, T 512
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 2, 4, 512
TRAIN_STEPS, TRAIN_RESUME_STEPS = 12, 14
#: the dist phase: sharded steps of the train cell, runs of the prefill
#: cell, and the limit of each against the unsharded port (relative to
#: the largest value of each tensor compared)
DIST_STEPS = 3
DIST_REL = 1e-6
#: production cells the dist phase traces on the host at full depth, on
#: a fake group of 256 (the single 16 x 16 mesh), each in its own
#: process, and what each must read (deepseek-7b's train cell read a
#: useful ratio of 0.79 and its decode cell a peak of 7.75 GiB on torch
#: 2.13; torch 2.11's DTensor, before the products were pinned, 0.050
#: and 968 GiB); beside them ``repro_torch.launch.dist_cells`` traces the
#: cells cut to one layer (DIST_CUT_JOBS at a time) and holds their
#: counts to 2.13's
DIST_DRYRUN = (("deepseek-7b", "train_4k"), ("deepseek-7b", "decode_32k"))
DIST_MIN_USEFUL = {"train_4k": 0.75}
DIST_MAX_PEAK_GB = {"decode_32k": 8.5}
DIST_CUT_JOBS = 2
#: the families' sharded gradients against the unsharded ones on 4 gloo
#: ranks of the host's CPU: tests/test_torch_distributed_families.py's
#: worker and cases, and its limits
DIST_GRAD_CHECK = ROOT / "tests" / "test_torch_distributed_families.py"
DIST_GRAD_REL = 1e-4
#: the sharded decode step's logits and caches against the unsharded
#: ones, batch 1 (contracted over the FSDP dim) and 4, on 4 gloo ranks:
#: tests/test_torch_dist_decode.py's worker and cases, and its limit
DIST_DECODE_CHECK = ROOT / "tests" / "test_torch_dist_decode.py"
DIST_DECODE_REL = 1e-5
DIST_LOSS_RTOL = 1e-5
#: the dist phase's cells traced on a fake 1 x 1 group on the host: the
#: walker's terms for the steps the card runs (fp32 roofline)
DIST_TRACE = """
import dataclasses, json, time
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.hlo_analysis import analyze_graph, memory_analysis
from repro_torch.distributed.roofline import HBM_BW, PEAK_FLOPS_FP32, roofline_from
from repro_torch.launch.dryrun import init_fake_group, trace
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import build_cell
init_fake_group(1)
mesh = make_mesh((1, 1), ("data", "model"), "cpu")
out = {}
for kind, layers, batch, seq in %s:
    cfg = get_config("deepseek-7b")
    cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)
    t0 = time.perf_counter()
    cell = build_cell(cfg, ShapeSpec("dist", kind, seq, batch), mesh)
    gm, donated = trace(cell)
    t = analyze_graph(gm)
    roof = roofline_from({}, t, n_chips=1, model_flops=cell.model_flops,
                         peak=PEAK_FLOPS_FP32, hbm=HBM_BW)
    out[kind] = {"trace_s": time.perf_counter() - t0, "nodes": len(gm.graph.nodes),
                 "flops": t.flops, "bytes": t.bytes, "coll_bytes": t.coll_bytes,
                 "memory": memory_analysis(gm, donated),
                 # an eager step donates nothing: its caller holds the state
                 "memory_eager": memory_analysis(gm), "roofline": roof.row()}
print("DIST_TRACE " + json.dumps(out))
"""

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
#: the bf16 input class, kernel against plain version on the same bf16
#: inputs. matmul: a product of two bf16 values is exact in fp32 and both
#: sides accumulate and write fp32, so only the summation order differs:
#: MATMUL_TOL holds it too. attention: bf16 out, from fp32 sums of p rounded to bf16
#: against another running max (32-key slices against the plain version's
#: blocks): 1e-2 relative and absolute, one bf16 ulp (2^-7 at 1) of
#: headroom inside the reference's own bf16 limit, 2e-2. Its control
#: (check_attention): p rounded to fp8 (e4m3) must be refused, and an
#: unblocked softmax with p rounded to bf16 admitted
ATTENTION_BF16_TOL = {"rtol": 1e-2, "atol": 1e-2}
#: prefill logits of a full-width, 2-layer model, card (hand kernels,
#: cuBLAS fp32) against CPU (plain versions), same params and tokens:
#: fp32 on both sides, sums in other orders (deepseek-7b read 3.6e-5 on
#: logits of magnitude about 5). For qwen3-moe the CPU takes the card's
#: expert choices (its own are compared first, see check_moe_logits), so
#: the limit is the dense one. The recurrent phase holds each carried
#: state tensor to it times the tensor's largest value.
LOGIT_ATOL = 1e-3
#: the card and the CPU may route a token to different experts only at a
#: near-tie: the router's inputs agree to fp32 rounding (about 1e-6
#: relative), which moves a probability by far less than this
ROUTE_TIE = 1e-4
#: the whole model's gradients, card (hand kernels, cuBLAS fp32) against
#: CPU (plain versions), relative L2 error per parameter leaf: fp32 on
#: both sides, sums in other orders (about 1e-6); a TF32 product keeps
#: about three digits and would read about 1e-3
GRAD_REL_L2 = 1e-4


def handle_specs(kernel: str, runs, dtype=None) -> list:
    """(label, spec) of ``kernel`` at each (arch, batch, prompt) of a
    phase's ``runs`` (RECURRENT_RUNS, or BF16_RUNS with ``dtype``
    bfloat16): the shapes at which that phase's plane handle of the
    kernel evaluates its points (model_kernel_specs, as the serve loop
    attaches them)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import model_kernel_specs

    out = []
    for arch, batch, prompt, _, _ in runs:
        cfg = get_config(arch)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=dtype, param_dtype=dtype)
        for name, spec in model_kernel_specs(cfg, batch=batch, seq=prompt):
            if name == kernel:
                out.append((f"{arch} B {batch} T {prompt}", spec))
    return out


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
    simlarge and every point at the front path's shapes, then a control:
    a TF32 product at simlarge must fail the same limit."""
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
    # the front path's shapes: quickstart's points (DEFAULT_POINT at each
    # block_d) and every point of the card's space at quickstart's
    # (2048, 64, 64) and Table 4's (1024, 64, D)
    cases += [((2048, 64, 64), dict(DEFAULT_POINT, block_d=bd)) for bd in (16, 32, 64)]
    for shape in ((2048, 64, 64), (1024, 64, 32), (1024, 64, 64), (1024, 64, 128)):
        cases += [(shape, p) for p in make_space(*shape, vmem_kb=cap, hopper=True).iter_valid()]
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
    version, each new binary compiled from a cold Triton cache (the
    binaries whose compiles are timed), then every point at Table 4's
    shapes in another cold cache. Returns
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
    # the front path's shapes: every point of the space at Table 4's
    # H 160 / 292 / 332 (W 200, 3 bands), which the process-backend check
    # (332 x 200 x 3) only samples; one binary per compile key, shared
    # across the three heights
    t4_worst, t4_checks = 0.0, 0
    with cold_triton_cache():
        kernel = LintraKernel()
        for h in (160, 292, 332):
            x = torch.randn(h, 200 * 3, generator=gen, device=dev)
            a = torch.tensor([1.5, 0.5, 2.0], device=dev)
            b = torch.tensor([0.1, -0.2, 0.3], device=dev)
            want = lintra_plain(x, a, b)
            for point in make_space(h, 200, 3, vmem_kb=cap).iter_valid():
                got = lintra_triton(x, a, b, point, kernel=kernel)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                t4_worst = max(t4_worst, err)
                t4_checks += 1
                if not torch.allclose(got, want, **LINTRA_TOL):
                    fail(f"lintra {point} at {(h, 200)}: max|err| {err:.3e} "
                         f"beyond {LINTRA_TOL}")
    print(f"lintra at Table 4's shapes: {t4_checks} checks, max|err| {t4_worst:.3e} "
          f"within rtol={LINTRA_TOL['rtol']} atol={LINTRA_TOL['atol']}")
    return max(worst, t4_worst), n_checks + t4_checks, compile_s, first_launch_s


def bound(flops: float, nbytes: float, *, tf32x3: bool = False,
          bf16: bool = False) -> tuple[float, str]:
    """The least ms the card could take, and what bounds it: the fp32
    operations on the CUDA cores, (``tf32x3``) the same operations as
    three TF32 products on the tensor cores, or (``bf16``) bf16 products
    on the tensor cores, against the bytes."""
    rate = (PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS / 3 if tf32x3
            else PEAK_FP32_FLOPS)
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
    report["wgmma_sass"] = check_wgmma_sass(libs)
    return libs, report


#: the bf16 wgmma kernels' device functions, by family (their mangled
#: names hold these), one per ``_bf16`` symbol
WGMMA_KERNELS = {"matmul": "matmul_wgmma", "attention": "flash_wgmma"}


def check_wgmma_sass(libs) -> dict:
    """Read the SASS of the matmul and attention libraries
    (``cuobjdump --dump-sass``): every wgmma kernel must hold HGMMA
    (wgmma) and UTMALDG (TMA tile load) instructions, and there must be
    one for each ``_bf16`` symbol. Also the ptxas report of those
    kernels alone (registers, spills, and warpgroup waits ptxas
    inserted, message C7517)."""
    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        tool = "cuobjdump"
    t0 = time.perf_counter()
    texts, jobs = {}, []
    for name, kernel in WGMMA_KERNELS.items():
        log = libs[name].built.path.with_suffix(".ptxas.log")
        texts[name] = log.read_text() if log.exists() else ""
        # the wgmma kernels' mangled names, from ptxas's report, dumped a
        # few at a time by parallel cuobjdump processes (the whole library
        # takes minutes on one core)
        names = sorted(set(re.findall(rf"Compiling entry function '(\w*{kernel}\w*)'",
                                      texts[name])))
        jobs += [(name, names[i:i + 8]) for i in range(0, len(names), 8)]

    def dump(job):
        name, names = job
        res = subprocess.run([tool, "--dump-sass", "--function", ",".join(names),
                              str(libs[name].built.path)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            fail(f"cuobjdump failed on the {name} library: {res.stderr[-2000:]}")
        return name, res.stdout

    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        dumps = list(pool.map(dump, jobs))
    out = {}
    for name, kernel in WGMMA_KERNELS.items():
        funcs = {}
        for family, sass in dumps:
            if family != name:
                continue
            for block in sass.split("Function : ")[1:]:
                fname = block.split("\n", 1)[0].strip()
                if kernel in fname:
                    funcs[fname] = (block.count("HGMMA"), block.count("UTMALDG"))
        want = sum(1 for sym in libs[name].symbols if sym.endswith("_bf16"))
        lacking = [f for f, (h, u) in funcs.items() if not (h and u)]
        if len(funcs) != want or lacking:
            fail(f"{name}: {len(funcs)} wgmma kernels in the SASS for {want} _bf16 symbols; "
                 f"without HGMMA or UTMALDG: {lacking[:5]}")
        text = texts[name]
        mine = [part for part in text.split("Compiling entry function")[1:]
                if kernel in part.split("\n", 1)[0]]
        regs = [int(r) for p in mine for r in re.findall(r"Used (\d+) registers", p)]
        spills = [int(x) for p in mine for x in re.findall(r"(\d+) bytes spill stores", p)]
        injected = len(re.findall(rf"C7517\).*?{kernel}", text))
        out[name] = {"kernels": len(funcs), "min_hgmma": min(h for h, _ in funcs.values()),
                     "min_utmaldg": min(u for _, u in funcs.values()),
                     "max_registers": max(regs, default=0),
                     "max_spill_store_bytes": max(spills, default=0),
                     "spilling_kernels": sum(1 for x in spills if x > 0),
                     "injected_waits": injected}
        print(f"{name} wgmma SASS: {out[name]['kernels']} kernels, each with HGMMA "
              f"(at least {out[name]['min_hgmma']}) and UTMALDG (at least "
              f"{out[name]['min_utmaldg']}); ptxas: {out[name]['max_registers']} registers "
              f"at most, {out[name]['max_spill_store_bytes']} spill-store bytes at most "
              f"({out[name]['spilling_kernels']} kernels spill), {injected} kernels with a "
              f"warpgroup wait ptxas inserted (C7517)")
    out["seconds"] = time.perf_counter() - t0
    return out


def reset_lm_counts() -> None:
    from repro_torch.kernels.attention.attention import flash_attention_cuda
    from repro_torch.kernels.matmul.matmul import matmul_cuda
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda

    for fn in (matmul_cuda, rmsnorm_cuda, flash_attention_cuda):
        fn.launches = 0
        fn.launches_by_dtype = {}
    for fn in (matmul_cuda, flash_attention_cuda):
        fn.launches_by_path = {}
    rmsnorm_cuda.launches_by_rows = {}


def lm_counts() -> dict:
    from repro_torch.kernels.attention.attention import flash_attention_cuda
    from repro_torch.kernels.matmul.matmul import matmul_cuda
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda

    return {"matmul": matmul_cuda.launches, "rmsnorm": rmsnorm_cuda.launches,
            "flash_attention": flash_attention_cuda.launches}


def attention_by_head_dim() -> dict:
    """The flash kernel's launches by head dim, over both input types."""
    from repro_torch.kernels.attention.attention import flash_attention_cuda

    out: dict = {}
    for by_dh in flash_attention_cuda.launches_by_dtype.values():
        for dh, n in by_dh.items():
            out[dh] = out.get(dh, 0) + n
    return dict(sorted(out.items()))


def lm_counts_by_dtype() -> dict:
    """The launches of lm_counts split by input type (attention's also by
    head dim)."""
    from repro_torch.kernels.attention.attention import flash_attention_cuda
    from repro_torch.kernels.matmul.matmul import matmul_cuda
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda

    return {"matmul": dict(matmul_cuda.launches_by_dtype),
            "rmsnorm": dict(rmsnorm_cuda.launches_by_dtype),
            "flash_attention": {t: dict(sorted(by.items())) for t, by in
                                flash_attention_cuda.launches_by_dtype.items()}}


def lm_counts_by_path() -> dict:
    """The matmul and attention launches of lm_counts split by path
    (``tf32x3``, ``wgmma``, ``mma``)."""
    from repro_torch.kernels.attention.attention import flash_attention_cuda
    from repro_torch.kernels.matmul.matmul import matmul_cuda

    return {"matmul": dict(matmul_cuda.launches_by_path),
            "flash_attention": dict(flash_attention_cuda.launches_by_path)}


def run_serve(dev) -> dict:
    """The serving path at full width, through the CLI's own code, under a
    session held here, so that its handles can be read before it closes
    (R1: each handle's starting points and evaluations). Closing the
    session writes the registry the warm phase starts from."""
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

    SERVE_REGISTRY.unlink(missing_ok=True)
    session = serve_cli.make_session(args, tcfg)
    try:
        reset_lm_counts()
        t0 = time.perf_counter()
        serve_cli.serve(args, tcfg, session, on_request=on_request)
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
        plane = sorted(h.name for h in session.plane.handles())
        r1 = starting_points(session)
    finally:
        session.close()
    if not SERVE_REGISTRY.exists():
        fail(f"the serving session wrote no registry at {SERVE_REGISTRY}")
    print(f"  registry {SERVE_REGISTRY.name}: bests of "
          f"{sorted(json.loads(k)['k'] for k in json.loads(SERVE_REGISTRY.read_text()) if not k.startswith('__'))}")
    return {"seconds": seconds, "launches": launches, "requests": rows,
            "handles": sorted(registered), "plane_handles": plane,
            "rmsnorm_launches_by_rows": rms_by_rows, "starting_points": r1}


def starting_points(session) -> dict:
    """R1: where each plane handle's tuner started and what it served, on
    the card at serving's shapes. Times the explorer's base point (the
    space's first values, ``space.default_point()``, unless a warm point
    overrode it), the kernel's declared ``DEFAULT_POINT`` and the served
    point, each generated through the handle's own compilette on its
    example arguments; and lists every evaluation's score of the run."""
    from repro_torch.kernels.catalog import get_catalog

    out = {}
    for h in session.plane.handles():
        comp, ex = h.tuner.compilette, h.tuner.explorer
        points = {"base": ex.base_point, "space_default": comp.space.default_point(),
                  "DEFAULT_POINT": get_catalog().get(h.name).default_point,
                  # a tuner that never swapped serves its reference: the base
                  "served": h.tuner.stats()["active_point"] or ex.base_point}
        args = comp.example_call_args()
        ms = {}
        for label, pt in points.items():
            if pt is None or not comp.space.is_valid(pt):
                ms[label] = None
                continue
            fn = comp.generate(dict(pt), **h.specialization).fn
            # rmsnorm is shorter than an eager call's host cost: graph replays
            ms[label] = (device_ms(fn, *args) if h.name == "rmsnorm"
                         else time_ms(fn, *args, reps=5 if h.name == "matmul" else 20))
        evals = [{"point": p, "score_ms": 1e3 * sc} for p, sc in ex.history]
        out[h.name] = {"points": points, "ms": ms, "evaluations": evals,
                       "reference_score_ms": 1e3 * h.tuner.reference_score_s,
                       "spec": {k: v for k, v in h.specialization.items()}}
        print(f"R1 {h.name}: " + ", ".join(
            f"{k} {v:.4f} ms" if v is not None else f"{k} invalid"
            for k, v in ms.items())
              + f"; base {points['base']}, DEFAULT_POINT {points['DEFAULT_POINT']}, "
              f"served {points['served']}; evaluations (ms): "
              + ", ".join(f"{e['score_ms']:.4f}" for e in evals))
    return out


def run_warm(serve_report) -> dict:
    """The serve CLI's warm start at full width: a second process, ``python
    -m repro_torch.launch.serve`` with the serve phase's arguments and
    ``--requests 1``, starts from the registry the first one wrote. Every
    plane-managed handle of the first process must warm-start there, and
    its first regeneration (if it has one) must re-validate the persisted
    best, as the reference's kernel-plane benchmark asserts."""
    args = list(SERVE_ARGS)
    args[args.index("--requests") + 1] = "1"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                             capture_output=True, text=True, timeout=900, env=env,
                             cwd=str(ROOT))
    finally:
        seconds = time.perf_counter() - t0
    log = ROOT / "chiprun_out" / "warm_serve.log"
    log.write_text(res.stdout + "\n== stderr\n" + res.stderr)
    if res.returncode != 0:
        fail(f"the second serve process exited {res.returncode}: {res.stderr[-2000:]}")
    SERVE_REGISTRY.unlink(missing_ok=True)
    req = re.search(r"req 0: ([\d.]+) tok/s, prefill (\d+) ms", res.stdout)
    kernels = re.search(r"kernels: (.*)", res.stdout)
    if req is None or kernels is None:
        fail(f"the second serve process printed no request line: {res.stdout[-2000:]}")
    handles = {}
    for m in re.finditer(r"(\w+):(\w+)×(\d+)(\(warm\))?", kernels.group(1)):
        handles[m.group(1)] = {"regenerations": int(m.group(3)), "warm": bool(m.group(4))}
    cold = [n for n in serve_report["plane_handles"] if not handles.get(n, {}).get("warm")]
    if cold:
        fail(f"the second serve process did not warm-start {cold}: {kernels.group(1)}")
    # a handle that regenerated at all must have evaluated its persisted best
    # first; only one that never regenerated serves it as the reference
    for m in re.finditer(r"warm (\w+): started from (\{.*?\}); (?:re-validated at "
                         r"regeneration (\d+)|served as the reference, (\d+) "
                         r"regenerations)", res.stdout):
        handles.setdefault(m.group(1), {})["start"] = m.group(2)
        handles[m.group(1)]["revalidated_at"] = (
            int(m.group(3)) if m.group(3) else None if m.group(4) == "0" else "never")
    late = {n: h.get("revalidated_at", "no line") for n, h in handles.items()
            if h.get("revalidated_at", "no line") not in (None, 1)}
    if late:
        fail(f"warm-started handles did not re-validate their best first: {late}")
    out = {"seconds": seconds, "decode_tok_s": float(req.group(1)),
           "prefill_ms": int(req.group(2)), "handles": handles}
    print(f"warm start: a second process in {seconds:.1f} s (set-up included), "
          f"first prefill {out['prefill_ms']} ms, decode {out['decode_tok_s']} tok/s; "
          f"handles {handles}")
    return out


def _load(path: Path):
    """A script of the checkout (an example, a benchmark) as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_chip_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_process_backend(dev, n_points: int = 6) -> dict:
    """The compile farm's ``process`` backend on lintra: ``n_points``
    points with distinct Triton binaries, each compiled by a spawned
    child into a cold Triton cache, then loaded by the parent's own
    generate from that cache; each variant is held against the plain
    version."""
    import torch

    from repro_torch.core import CompileFarm
    from repro_torch.kernels.catalog import get_catalog
    from repro_torch.kernels.lintra.lintra import cold_triton_cache, compile_key, lintra_plain

    H, W, B = 332, 200, 3
    spec = {"H": H, "W": W, "bands": B, "dtype": "float32", "device": str(dev)}
    comp = get_catalog().compilette("lintra", spec)
    points, keys = [], set()
    for p in comp.space.iter_valid():
        key = compile_key(p, B, W * B)
        if key not in keys:
            keys.add(key)
            points.append(p)
        if len(points) == n_points:
            break
    farm = CompileFarm("process", workers=2)
    t0 = time.perf_counter()
    try:
        with cold_triton_cache():
            tickets = [farm.submit(comp, p, {}) for p in points]
            deadline = time.perf_counter() + 600
            while not all(t.done for t in tickets):
                if time.perf_counter() > deadline:
                    fail("the process backend's lintra compiles did not finish in 600 s")
                time.sleep(0.05)
    finally:
        farm.shutdown()
    wall = time.perf_counter() - t0
    stats = farm.stats()
    errors = [str(t.error) for t in tickets if t.error is not None]
    if errors:
        fail(f"process-backend lintra compiles failed: {errors}")
    if (stats["process_offloaded"], stats["process_fallbacks"]) != (len(points), 0):
        fail(f"the process backend offloaded {stats['process_offloaded']} of "
             f"{len(points)} lintra compiles ({stats['process_fallbacks']} fell back)")
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(H, W, B, generator=gen, device=dev)
    a = torch.tensor([1.5, 0.5, 2.0], device=dev)
    b = torch.tensor([0.1, -0.2, 0.3], device=dev)
    want = lintra_plain(x.reshape(H, W * B), a, b).reshape(H, W, B)
    rows = []
    for t in tickets:
        got = t.kern.fn(x, a, b)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, **LINTRA_TOL):
            fail(f"process-compiled lintra {t.point} disagrees with its plain version")
        child = t.kern.meta["process_compile_s"]
        rows.append({"point": t.point, "child_compile_s": child,
                     "parent_load_s": t.kern.generation_time_s - child,
                     "child_pid": t.kern.meta["process_pid"]})
    pids = {r["child_pid"] for r in rows}
    if os.getpid() in pids:
        fail("a process-backend compile ran in the parent")
    print(f"process backend: {len(rows)} lintra compiles offloaded to {len(pids)} "
          f"spawned children in {wall:.2f} s (spawn included), 0 fallbacks; child "
          f"compile s {[round(r['child_compile_s'], 3) for r in rows]}, parent load s "
          f"{[round(r['parent_load_s'], 4) for r in rows]}")
    return {"stats": stats, "wall_s": wall, "compiles": rows}


def run_front(dev) -> dict:
    """The rest of the front door on the card: quickstart's real run
    (``examples/torch_quickstart.py``), paper Table 4
    (``benchmarks/torch_table4_tuning_stats.py``), the compile farm's
    process backend on lintra, and the reduced serve example
    (``examples/torch_serve_lm.py``: heads of 16, the flash kernel's Dh 16
    instantiations). Launch counts are set to 0 just before and read just
    after."""
    from repro_torch.kernels.euclid.euclid import euclid_cuda
    from repro_torch.kernels.lintra.lintra import lintra_triton

    reset_lm_counts()
    euclid_cuda.launches = 0
    lintra_triton.launches = 0
    t0 = time.perf_counter()
    quick = _load(ROOT / "examples" / "torch_quickstart.py").main(str(dev))
    t4 = _load(ROOT / "benchmarks" / "torch_table4_tuning_stats.py").run(device=dev)
    process = check_process_backend(dev)
    outs = _load(ROOT / "examples" / "torch_serve_lm.py").main(
        [*SERVE_EXAMPLE_ARGS, "--device", str(dev)])
    seconds = time.perf_counter() - t0
    launches = {"euclid": euclid_cuda.launches, "lintra": lintra_triton.launches,
                **lm_counts()}
    by_dh = attention_by_head_dim()
    print(f"front path: {seconds:.1f} s, kernel launches {launches}; flash attention "
          f"by head dim {by_dh}")
    if len(t4["rows"]) != 6:
        fail(f"Table 4 produced {len(t4['rows'])} rows, not 6")
    for name in ("euclid", "lintra", "rmsnorm", "flash_attention"):
        if launches[name] == 0:
            fail(f"the front path never launched the {name} kernel")
    if by_dh.get(16, 0) == 0:
        fail("the reduced serve example never launched the flash kernel at Dh 16")
    serve_example = [{"prefill_s": o["prefill_s"], "decode_tok_s": o["decode_tokens_per_s"],
                      "autotune": {k: o["autotune"][k] for k in
                                   ("regenerations", "swaps", "overhead_frac")}}
                     for o in outs]
    return {"seconds": seconds, "launches": launches,
            "attention_launches_by_head_dim": by_dh,
            "quickstart": {k: quick[k] for k in ("calls", "wall_s", "best_point",
                                                 "max_abs_err")}
            | {"explored": quick["stats"]["n_explored"],
               "swaps": quick["stats"]["swaps"],
               "tuning_spent_s": quick["stats"]["tuning_spent_s"]},
            "table4": t4, "process_backend": process, "serve_example": serve_example}


def run_family(dev, arch: str, layers, batch: int, prompt: int, tokens: int,
               requests: int, dtype=None) -> dict:
    """One model of the families phase at full width (``layers`` of its
    layers, or all) under the serve CLI's session (``make_session``, with
    ``--autotune --kernel-tuning kernel``), with params and compute in
    ``dtype`` where it is given (the bf16 phase). A whole model in its
    config's dtype goes through the CLI's ``serve``; a model cut in depth,
    or in another dtype, through ``serve_loop.generate`` with the prompts
    ``serve`` draws and params drawn once from the serve seed, and for the VLM
    ``cfg.vision_patches`` patch embeddings, so that the cache and
    positions the loop sizes by them hold no gap (``serve`` passes 16, as
    the reference does: ROADMAP Queue 3, R2). Launch counts, the peak
    memory and the layers' attention calls, plain and flash, are read
    around the requests. The attention rule: a model's attention
    without a window never runs the plain version (and launches the
    flash kernel at its head dim); every full-sequence attention call of
    a windowed model (hymba) is the plain version and carries its
    window, as in the reference, and launches no flash kernel; a model
    without attention (rwkv6) makes no attention call of either kind.
    The handles' own evaluations may launch the flash kernel whatever
    the model. With ``dtype``, every handle must be registered at that
    dtype, and the matmul, attention and rmsnorm kernels must launch
    only instantiations of that type."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_tree
    from repro_torch.runtime.serve_loop import ServeConfig, generate

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype, param_dtype=dtype)
    args, tcfg = serve_cli.parse_args(
        ["--arch", arch, "--autotune", "--kernel-tuning", "kernel", "--batch", str(batch),
         "--prompt-len", str(prompt), "--tokens", str(tokens), "--requests", str(requests)])
    rows = []

    def on_request(req, out):
        a = out["autotune"]
        per = {n: {"regenerations": k["regenerations"], "explored": k["n_explored"],
                   "best_point": k["best_point"]}
               for n, k in sorted(a["kernels"].items())}
        rows.append({"request": req, "prefill_s": out["prefill_s"],
                     "decode_s": out["decode_s"],
                     "decode_tok_s": out["decode_tokens_per_s"],
                     "regenerations": a["regenerations"], "swaps": a["swaps"],
                     "overhead_pct": 100 * a["overhead_frac"],
                     "quarantined": a["quarantined"], "kernels": per})
        print(f"  {arch} " + serve_cli.format_request(req, out, args))

    plain_calls, layer_flash = [], []
    real_plain, real_flash = L.flash_attention_torch, L.flash_attention_cuda

    def counted_plain(q, k, v, **kw):
        plain_calls.append((tuple(q.shape), tuple(k.shape), kw.get("window")))
        return real_plain(q, k, v, **kw)

    def counted_flash(q, k, v, *a, **kw):
        layer_flash.append((tuple(q.shape), tuple(k.shape)))
        return real_flash(q, k, v, *a, **kw)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    session = serve_cli.make_session(args, tcfg)
    L.flash_attention_torch, L.flash_attention_cuda = counted_plain, counted_flash
    try:
        reset_lm_counts()
        t0 = time.perf_counter()
        if layers is None and dtype is None:
            serve_cli.serve(args, tcfg, session, on_request=on_request)
        else:
            serve_cfg = ServeConfig(max_new_tokens=tokens, tuning=tcfg)
            params = init_tree(build_model(cfg).param_defs(),
                               torch.Generator(device=dev).manual_seed(serve_cfg.seed),
                               dtype=cfg.param_dtype, device=dev)
            for req in range(requests):
                b = {"params": params, "tokens": torch.randint(
                    0, cfg.vocab, (batch, prompt),
                    generator=torch.Generator(device=dev).manual_seed(req), device=dev)}
                if cfg.family == "vlm":
                    b["vision"] = torch.randn(
                        batch, cfg.vision_patches, cfg.d_model,
                        generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev) * 0.05
                on_request(req, generate(cfg, b, serve_cfg, session=session))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = lm_counts()
        by_dtype = lm_counts_by_dtype()
        by_path = lm_counts_by_path()
        by_dh = attention_by_head_dim()
        rms_by_rows = dict(sorted(rmsnorm_cuda.launches_by_rows.items()))
        specs = {h.name: dict(h.specialization) for h in session.plane.handles()}
    finally:
        L.flash_attention_torch, L.flash_attention_cuda = real_plain, real_flash
        session.close()
        params = None
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    windows = sorted({w for _, _, w in plain_calls}, key=str)
    print(f"  {arch} at full width, {cfg.n_layers} of {full.n_layers} layers, B {batch}, "
          f"prompt {prompt}: {seconds:.1f} s, launches {launches}, flash attention by head "
          f"dim {by_dh} ({len(layer_flash)} from the layers), rmsnorm by rows "
          f"{rms_by_rows}; plain attention calls {len(plain_calls)} (windows {windows}); "
          f"peak {peak_gb:.2f} GB")
    if cfg.family == "rwkv":
        if plain_calls or layer_flash:
            fail(f"{arch} has no attention, yet its layers made {len(plain_calls)} plain "
                 f"and {len(layer_flash)} flash attention calls")
    elif cfg.window is not None:
        if not plain_calls or windows != [cfg.window]:
            fail(f"{arch}: every attention call must carry the window {cfg.window}; "
                 f"plain calls {len(plain_calls)}, windows {windows}")
        if layer_flash:
            fail(f"{arch}: the windowed attention launched the flash kernel: {layer_flash[:4]}")
    else:
        if plain_calls:
            fail(f"{arch}: attention ran the plain version on the card: {plain_calls[:4]}")
        if by_dh.get(cfg.d_head, 0) == 0:
            fail(f"{arch} never launched the flash kernel at its head dim {cfg.d_head}")
    faulted = [r["request"] for r in rows if r["quarantined"]]
    if faulted:
        fail(f"{arch}: variants were quarantined in requests {faulted}")
    if dtype is not None:
        name = str(dtype).removeprefix("torch.")
        print(f"  {arch} in {name}: launches by type {by_dtype}; handles "
              + "; ".join(f"{n} {spec}" for n, spec in sorted(specs.items())))
        wrong = {n: spec.get("dtype") for n, spec in specs.items() if spec.get("dtype") != name}
        if wrong or not specs:
            fail(f"{arch}: handles not registered at {name}: {wrong or 'none registered'}")
        for kernel in ("matmul", "rmsnorm", "flash_attention"):
            types = by_dtype[kernel]
            if not types.get(name):
                fail(f"{arch}: the {name} {kernel} kernel was never launched ({types})")
            if set(types) - {name}:
                fail(f"{arch}: {kernel} launched instantiations of {sorted(set(types) - {name})} "
                     f"for {name} specs")
    return {"arch": arch, "n_layers": cfg.n_layers, "of_layers": full.n_layers,
            "dtype": str(cfg.compute_dtype).removeprefix("torch."),
            "handle_specs": specs, "launches_by_dtype": by_dtype,
            "launches_by_path": by_path,
            "batch": batch, "prompt": prompt, "tokens": tokens,
            "prefill_tokens": prompt + (cfg.vision_patches if cfg.family == "vlm" else 0),
            "params": cfg.n_params(), "seconds": seconds, "requests": rows,
            "launches": launches, "attention_launches_by_head_dim": by_dh,
            "rmsnorm_launches_by_rows": rms_by_rows, "plain_attention_calls": len(plain_calls),
            "plain_attention_windows": windows, "layer_flash_launches": len(layer_flash),
            "max_memory_allocated_gb": peak_gb}


def run_families(dev) -> dict:
    """The MoE, VLM and encoder-decoder families on the card (FAMILY_RUNS),
    each model's weights freed before the next; then one profiled
    qwen3-moe prefill and MOE_PROFILE_DECODE_STEPS decode steps; then the
    qwen3-moe logits against the CPU (check_moe_logits)."""
    import torch

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    out = {"runs": {}}
    for arch, layers, batch, prompt, tokens, requests in FAMILY_RUNS:
        out["runs"][arch] = run_family(dev, arch, layers, batch, prompt, tokens, requests)
    launches = {n: sum(r["launches"][n] for r in out["runs"].values())
                for n in ("matmul", "rmsnorm", "flash_attention")}
    by_dh: dict = {}
    for r in out["runs"].values():
        for dh, n in r["attention_launches_by_head_dim"].items():
            by_dh[dh] = by_dh.get(dh, 0) + n
    out["launches"], out["attention_launches_by_head_dim"] = launches, dict(sorted(by_dh.items()))
    for name, n in launches.items():
        if n == 0:
            fail(f"the families path never launched the {name} kernel")
    moe = get_config("qwen3-moe-30b-a3b")
    cut = dataclasses.replace(moe, n_layers=FAMILY_RUNS[0][1])
    out["profile_moe"] = profile_serve(dev, cut, decode_steps=MOE_PROFILE_DECODE_STEPS)
    # the expert weights every dispatch slice reads, at HBM's rate
    expert_bytes = cut.n_layers * cut.top_k * 3 * cut.n_experts * cut.d_model * cut.d_ff * 4
    out["profile_moe"]["expert_bytes_per_step"] = expert_bytes
    out["profile_moe"]["expert_bytes_bound_ms"] = 1e3 * expert_bytes / PEAK_BYTES_S
    print(f"  qwen3-moe: every step reads the experts {cut.top_k} times, "
          f"{expert_bytes / 1e9:.1f} GB: {out['profile_moe']['expert_bytes_bound_ms']:.1f} ms "
          f"at {PEAK_BYTES_S / 1e12:.2f} TB/s, prefill or decode step alike")
    gc.collect()
    torch.cuda.empty_cache()
    out["moe_logits"] = check_moe_logits(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"families path: {out['seconds']:.1f} s, kernel launches {launches}; flash "
          f"attention by head dim {out['attention_launches_by_head_dim']}")
    return out


def run_bf16(dev) -> dict:
    """The bf16 phase: each model of BF16_RUNS whole, at full width, with
    params and compute in bf16 (run_family), each model's weights freed
    before the next; then the model-level check (check_bf16_logits)."""
    import torch

    t0 = time.perf_counter()
    out = {"runs": {}}
    for arch, batch, prompt, tokens, requests in BF16_RUNS:
        out["runs"][arch] = run_family(dev, arch, None, batch, prompt, tokens, requests,
                                       dtype=torch.bfloat16)
        gc.collect()
        torch.cuda.empty_cache()
    def total(counts):  # a count, or attention's counts by head dim
        return sum(counts.values()) if isinstance(counts, dict) else counts

    out["launches_bf16"] = {
        n: sum(total(r["launches_by_dtype"][n].get("bfloat16", 0))
               for r in out["runs"].values())
        for n in ("matmul", "rmsnorm", "flash_attention")}
    # at the served shapes every bf16 product and attention call is one
    # TMA can describe: all of them must take the wgmma kernels
    out["launches_by_path"] = {
        n: {p: sum(r["launches_by_path"][n].get(p, 0) for r in out["runs"].values())
            for p in ("wgmma", "mma", "tf32x3")}
        for n in ("matmul", "flash_attention")}
    for n, by in out["launches_by_path"].items():
        print(f"  bf16 phase {n} launches by path: {by}")
        if by["mma"] or by["tf32x3"] or not by["wgmma"]:
            fail(f"bf16 phase: {n} launches by path {by}; every launch at the served "
                 f"shapes must take the wgmma path")
    out["logits"] = check_bf16_logits(dev)
    out["seconds"] = time.perf_counter() - t0
    for arch, r in out["runs"].items():
        for row in r["requests"]:
            print(f"  bf16 {arch} request {row['request']}: prefill {row['prefill_s']:.4f} s, "
                  f"decode {row['decode_tok_s']:.2f} tok/s, overhead "
                  f"{row['overhead_pct']:.2f} %")
        print(f"  bf16 {arch}: peak {r['max_memory_allocated_gb']:.2f} GB "
              f"(torch.cuda.max_memory_allocated)")
    print(f"bf16 phase: {out['seconds']:.1f} s, bf16 kernel launches {out['launches_bf16']}")
    return out


def check_bf16_logits(dev) -> dict:
    """deepseek-7b at full width, BF16_LOGIT_LAYERS layers, B 4, T 512:
    params drawn in fp32 and cast to bf16, prefill logits of (a) the bf16
    model through the hand kernels, (b) the bf16 model through the plain
    versions (the layers' kernel calls replaced by them, on the card),
    (c) the fp32 model through the plain versions. Fails if the relative
    L2 distance of (a) from (b) passes that of (b) from (c): the kernels
    may add no more error than bf16 itself."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention.attention import flash_attention_plain
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_plain
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model
    from repro_torch.models.params import cast_params, init_tree

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(get_config("deepseek-7b"), n_layers=BF16_LOGIT_LAYERS)
    cfg16 = dataclasses.replace(cfg32, compute_dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    p32 = init_tree(build_model(cfg32).param_defs(),
                    torch.Generator(device=dev).manual_seed(0), device=dev)
    p16 = cast_params(p32, torch.bfloat16)
    batch = {"tokens": torch.randint(0, cfg32.vocab, (4, 512),
                                     generator=torch.Generator(device=dev).manual_seed(0),
                                     device=dev)}

    def prefill(cfg, params):
        reset_lm_counts()
        with torch.no_grad():
            logits, _ = build_model(cfg).prefill(params, dict(batch))
        torch.cuda.synchronize()
        return logits.float(), lm_counts_by_dtype()

    a, launched = prefill(cfg16, p16)
    real = L.flash_attention_cuda, L.rmsnorm_cuda
    L.flash_attention_cuda = lambda q, k, v, point, causal=True: flash_attention_plain(
        q, k, v, point, causal=causal)
    L.rmsnorm_cuda = lambda x, w, point, eps=1e-6: rmsnorm_plain(x, w, point, eps=eps)
    try:
        b, plain_b = prefill(cfg16, p16)
        c, plain_c = prefill(cfg32, p32)
    finally:
        L.flash_attention_cuda, L.rmsnorm_cuda = real

    def rel(x, y):
        return float(torch.linalg.vector_norm(x - y) / torch.linalg.vector_norm(y))

    out = {"a_b": rel(a, b), "b_c": rel(b, c), "a_c": rel(a, c),
           "launches": launched, "seconds": time.perf_counter() - t0}
    print(f"bf16 logits, deepseek-7b at full width, {BF16_LOGIT_LAYERS} layers, B 4, T 512: "
          f"relative L2 hand kernels (a) from plain (b) {out['a_b']:.4e}; plain bf16 (b) "
          f"from plain fp32 (c) {out['b_c']:.4e}; (a) from (c) {out['a_c']:.4e}; launches "
          f"of (a) {launched}; {out['seconds']:.1f} s")
    if any(plain_b.values()) or any(plain_c.values()):
        fail(f"the plain runs launched kernels: {plain_b}, {plain_c}")
    for kernel in ("rmsnorm", "flash_attention"):       # the layers' products are cuBLAS's
        if not launched[kernel].get("bfloat16"):
            fail(f"the bf16 prefill never launched the bf16 {kernel} kernel: {launched}")
    if not out["a_b"] <= out["b_c"]:
        fail(f"bf16 logits: the hand kernels add more error ({out['a_b']:.4e}) than bf16 "
             f"itself ({out['b_c']:.4e})")
    return out


def labelled(targets):
    """Wrap each function ``getattr(module, name)`` of ``targets`` in a
    ``torch.profiler.record_function`` range of that name, for
    profile_serve's ``labels``; returns the function that undoes it."""
    import torch

    saved = [(m, n, getattr(m, n)) for m, n in targets]

    def wrap(fn, name):
        def run(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return run

    for m, n, fn in saved:
        setattr(m, n, wrap(fn, n))
    return lambda: [setattr(m, n, fn) for m, n, fn in saved]


def scan_work(cfg, B: int, T: int) -> dict:
    """The least bytes and the operations of the prefill's recurrent core
    over all layers, from its shapes: hymba's chunked SSM scan reads a
    and b and writes every state (B, T, d, ssm_state), a multiply and an
    add each; rwkv6's chunked WKV reads r, k, v and log w, writes y and
    reads and writes the (H, C, C) state, and does the reference's four
    products a chunk (q k^T and its mask times v over the chunk, q S and
    the state update), whatever the chunk holds."""
    if cfg.family == "hybrid":
        n = B * T * cfg.d_model * cfg.ssm_state
        return {"name": "ssm_scan_chunked", "bytes": cfg.n_layers * 3 * n * 4,
                "flops": cfg.n_layers * 2 * n}
    C = cfg.rwkv_head_size
    H = cfg.d_model // C
    Lc = min(cfg.scan_chunk, T)
    chunks = -(-T // Lc)
    flops = chunks * (4 * B * H * Lc * Lc * C + 4 * B * Lc * H * C * C)
    nbytes = (5 * B * T * H * C + 2 * B * H * C * C) * 4
    return {"name": "wkv_chunked", "bytes": cfg.n_layers * nbytes,
            "flops": cfg.n_layers * flops}


def check_recurrent_logits(dev, arch: str) -> dict:
    """``arch`` at full width, 2 layers: request 0's prefill (B 4, T 512)
    and RECURRENT_DECODE_STEPS decode steps with the hand kernels on the
    card against the plain versions on the CPU, same params. The CPU
    takes the card's tokens, so one differing argmax does not cascade,
    and every decode step compares what the carried state (hymba's conv
    buffer and SSM state, rwkv6's S, xa and xc) gives; the state itself
    is compared after the last step. Fails where logits differ by more
    than LOGIT_ATOL, or a state tensor by more than LOGIT_ATOL times its
    largest value on the CPU (a fault in the state that has not reached
    the logits within the steps)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_tree
    from repro_torch.runtime.serve_loop import widen_cache

    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    model = build_model(cfg)
    t0 = time.perf_counter()
    B, T = 4, 512
    max_len = T + RECURRENT_DECODE_STEPS
    gpu_params = init_tree(model.param_defs(),
                           torch.Generator(device=dev).manual_seed(0), device=dev)
    cpu_params = to_device(gpu_params, "cpu")
    tokens = torch.randint(0, cfg.vocab, (B, T),
                           generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    reset_lm_counts()
    got, gcache = model.prefill(gpu_params, {"tokens": tokens})
    torch.cuda.synchronize()
    launched = lm_counts()
    want, ccache = model.prefill(cpu_params, {"tokens": tokens.cpu()})
    errs, agree = [], []

    def compare(got, want):
        got = got.cpu()
        errs.append(float((got - want).abs().max()))
        agree.append(float((got[:, -1].argmax(-1) == want[:, -1].argmax(-1)).float().mean()))
        return float(want.abs().max())

    scale = compare(got, want)
    gcache, ccache = (widen_cache(model, c, B, max_len) for c in (gcache, ccache))
    tok = got[:, -1].argmax(-1)[:, None]
    for i in range(RECURRENT_DECODE_STEPS):
        got, gcache = model.decode_step(gpu_params, gcache, tok, T + i)
        want, ccache = model.decode_step(cpu_params, ccache, tok.cpu(), T + i)
        scale = max(scale, compare(got, want))
        tok = got[:, -1].argmax(-1)[:, None]
    state_err = [float((g.cpu() - c).abs().max()) for g, c in zip(gcache, ccache)]
    state_max = [float(c.abs().max()) for c in ccache]
    state_limit = [LOGIT_ATOL * m for m in state_max]
    out = {"arch": arch, "n_layers": 2, "batch": B, "seq": T,
           "decode_steps": RECURRENT_DECODE_STEPS, "prefill_max_abs_err": errs[0],
           "decode_max_abs_err": max(errs[1:]), "max_abs_err": max(errs),
           "max_abs_logit": scale, "greedy_agree_prefill": agree[0],
           "greedy_agree_decode": sum(agree[1:]) / len(agree[1:]),
           "state_max_abs_err": state_err, "state_max_abs": state_max,
           "state_limit": state_limit, "launches": launched, "limit": LOGIT_ATOL,
           "seconds": time.perf_counter() - t0}
    print(f"{arch} logits at full width, 2 layers: prefill max|err| {errs[0]:.3e}, "
          f"{RECURRENT_DECODE_STEPS} decode steps fed the card's tokens max|err| "
          f"{max(errs[1:]):.3e} (max|logit| {scale:.3e}, limit {LOGIT_ATOL}); greedy "
          f"tokens agree {agree[0]:.2f} at prefill, {out['greedy_agree_decode']:.2f} over the "
          f"decode steps; state after them max|err| per tensor "
          f"{[f'{e:.2e}' for e in state_err]} (limits {[f'{e:.2e}' for e in state_limit]}); "
          f"kernel launches {launched}; {out['seconds']:.1f} s")
    if not max(errs) <= LOGIT_ATOL:
        fail(f"{arch} logits: max|err| {max(errs):.3e} beyond {LOGIT_ATOL}")
    if not all(e <= lim for e, lim in zip(state_err, state_limit)):
        fail(f"{arch} state: max|err| per tensor {state_err} beyond {state_limit}")
    del gpu_params
    return out


def read_r4(dev, arch: str) -> dict:
    """R4 (ROADMAP Queue 3), reported and not held: ``arch`` at full width,
    2 layers, B 4: prefill(T) then decode token T, against prefill(T +
    1)'s last logits, at each chunk length of R4_CHUNKS and each T of
    R4_PROMPTS."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_tree
    from repro_torch.runtime.serve_loop import widen_cache

    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    params = init_tree(build_model(cfg).param_defs(),
                       torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab, (4, max(R4_PROMPTS) + 1),
                           generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    out = {}
    for chunk in R4_CHUNKS:
        model = build_model(dataclasses.replace(cfg, scan_chunk=chunk))
        for T in R4_PROMPTS:
            _, cache = model.prefill(params, {"tokens": tokens[:, :T]})
            decoded, _ = model.decode_step(params, widen_cache(model, cache, 4, T + 1),
                                           tokens[:, T:T + 1], T)
            full, _ = model.prefill(params, {"tokens": tokens[:, :T + 1]})
            out[f"chunk {chunk}, T {T}"] = {
                "chunk": chunk, "T": T,
                "max_abs_gap": float((decoded[:, -1] - full[:, -1]).abs().max()),
                "max_abs_logit": float(full.abs().max()),
                "greedy_agree": float((decoded[:, -1].argmax(-1)
                                       == full[:, -1].argmax(-1)).float().mean())}
    print(f"R4 {arch} (full width, 2 layers, B 4): decode(prefill(T), token T) against "
          f"prefill(T + 1): " + "; ".join(
              f"{k}: max|gap| {r['max_abs_gap']:.3e} (max|logit| "
              f"{r['max_abs_logit']:.3e}), greedy agree {r['greedy_agree']:.2f}"
              for k, r in out.items()))
    del params
    return out


def run_recurrent(dev) -> dict:
    """The hybrid and RWKV families on the card (RECURRENT_RUNS), whole and
    at full width, each model's weights freed before the next; each must
    launch the rmsnorm kernel. Then one profiled request per model (B
    PROFILE_BATCH, T PROFILE_SEQ, 4 decode steps) with its recurrent core
    in profiler ranges, beside the byte and operation bounds of its steps
    and of that core; the logits of both at 2 layers against the CPU
    (check_recurrent_logits); and R4's prefill/decode gap (read_r4)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import hymba, rwkv6, ssm
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model
    from repro_torch.models.params import count_params

    t0 = time.perf_counter()
    out = {"runs": []}
    for arch, batch, prompt, tokens, requests in RECURRENT_RUNS:
        run = run_family(dev, arch, None, batch, prompt, tokens, requests)
        if run["launches"]["rmsnorm"] == 0:
            fail(f"{arch} never launched the rmsnorm kernel")
        out["runs"].append(run)
    out["launches"] = {n: sum(r["launches"][n] for r in out["runs"])
                       for n in ("matmul", "rmsnorm", "flash_attention")}
    by_rows: dict = {}
    for r in out["runs"]:
        for rows, n in r["rmsnorm_launches_by_rows"].items():
            by_rows[rows] = by_rows.get(rows, 0) + n
    out["rmsnorm_launches_by_rows"] = dict(sorted(by_rows.items()))
    targets = {"hymba-1.5b": [(hymba, "ssm_branch"), (ssm, "ssm_scan_chunked"),
                              (L, "flash_attention_torch")],
               "rwkv6-1.6b": [(rwkv6, "time_mix"), (rwkv6, "wkv_chunked"),
                              (rwkv6, "channel_mix")]}
    out["profiles"] = {}
    for arch, fns in targets.items():
        cfg = get_config(arch)
        undo = labelled(fns)
        try:
            prof = profile_serve(dev, cfg, decode_steps=4, labels=tuple(n for _, n in fns))
        finally:
            undo()
        defs = build_model(cfg).param_defs()
        n_params = count_params(defs)
        # prefill's products: every weight but the embedding table once per
        # token, the unembedding for the last position only
        n_embed = 2 * cfg.vocab * cfg.d_model
        prefill_flops = 2.0 * (n_params - n_embed) * PROFILE_BATCH * PROFILE_SEQ
        prof["decode_bound_ms"], prof["decode_bound_by"] = bound(
            2.0 * (n_params - cfg.vocab * cfg.d_model) * PROFILE_BATCH, 4.0 * n_params)
        prof["prefill_bound_ms"], prof["prefill_bound_by"] = bound(prefill_flops, 4.0 * n_params)
        core = scan_work(cfg, PROFILE_BATCH, PROFILE_SEQ)
        core["bound_ms"], core["bound_by"] = bound(core["flops"], core["bytes"])
        core["prefill_device_ms"] = prof["prefill"]["ranges_ms"].get(core["name"])
        prof["recurrent_core"] = core
        out["profiles"][arch] = prof
        print(f"  {arch}: prefill bound {prof['prefill_bound_ms']:.1f} ms "
              f"({prof['prefill_bound_by']}), decode step bound "
              f"{prof['decode_bound_ms']:.3f} ms ({prof['decode_bound_by']}); its "
              f"{core['name']} in prefill: {core['prefill_device_ms']} ms on the device "
              f"against a bound of {core['bound_ms']:.3f} ms ({core['bound_by']}: "
              f"{core['bytes'] / 1e9:.2f} GB, {core['flops'] / 1e9:.1f} GFLOP)")
        gc.collect()
        torch.cuda.empty_cache()
    out["logits"] = {arch: check_recurrent_logits(dev, arch) for arch in targets}
    gc.collect()
    torch.cuda.empty_cache()
    out["r4"] = {arch: read_r4(dev, arch) for arch in targets}
    out["seconds"] = time.perf_counter() - t0
    print(f"recurrent path: {out['seconds']:.1f} s, kernel launches {out['launches']}; "
          f"rmsnorm by rows {out['rmsnorm_launches_by_rows']}")
    return out


def route_margin(probs, own, card):
    """Per token (G, S): at the first of the k slots where the CPU's
    expert choices ``own`` and the card's ``card`` differ, the CPU's
    probability of its own expert less its probability of the card's
    (0 where all k agree). Earlier slots agree, so that is how far the
    CPU's router is from the card's pick: a near-tie reads near 0 and a
    wrong expert at a wide margin does not, whatever other near-ties the
    token's top k hold."""
    import torch

    first = (own != card).to(torch.int8).argmax(dim=-1, keepdim=True)     # (G, S, 1)
    mine = torch.gather(probs, -1, torch.gather(own, -1, first))
    theirs = torch.gather(probs, -1, torch.gather(card, -1, first))
    return (mine - theirs).squeeze(-1)


def check_moe_logits(dev) -> dict:
    """qwen3-moe at full width, 2 layers: request 0's prefill with the
    hand kernels on the card against the plain versions on the CPU, same
    params and tokens. Routing first: the CPU computes its own router
    from its own hidden state and records its expert choices against the
    card's, then takes the card's, so the two sides' later arithmetic
    stays comparable. Reports the share of (token, slot) choices that
    agree per layer and, at each token where they differ, the margin of
    the first slot that differs (route_margin); fails where they differ
    at a margin of ROUTE_TIE or more,
    and where the logits differ by more than LOGIT_ATOL."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_tree

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=2)
    model = build_model(cfg)
    t0 = time.perf_counter()
    # drawn on the card (7.4 GB: a CPU generator takes seconds), then copied
    gpu_params = init_tree(model.param_defs(),
                           torch.Generator(device=dev).manual_seed(0), device=dev)
    cpu_params = to_device(gpu_params, "cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 512),
                           generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    real_route = moe.route
    card_choices, layers = [], []

    def record(xg, router, k):
        probs, gate_w, gate_idx = real_route(xg, router, k)
        card_choices.append(gate_idx)
        return probs, gate_w, gate_idx

    def pinned(xg, router, k):
        probs, _, own = real_route(xg, router, k)
        card = card_choices[len(layers)].cpu()
        same = own == card
        top = probs.sort(dim=-1, descending=True).values[..., :k + 1]
        gap = (top[..., :-1] - top[..., 1:]).min(dim=-1).values     # (G, S)
        differs = ~same.all(dim=-1)
        margin = route_margin(probs, own, card)[differs]
        layers.append({"agree": float(same.float().mean()),
                       "tokens_differing": int(differs.sum()),
                       "min_margin_where_differing": (float(margin.min())
                                                      if bool(differs.any()) else None),
                       "max_margin_where_differing": (float(margin.max())
                                                      if bool(differs.any()) else None),
                       "min_margin": float(gap.min())})
        gate_w = torch.gather(probs, -1, card)
        gate_w = gate_w / torch.clamp(gate_w.sum(dim=-1, keepdim=True), min=1e-9)
        return probs, gate_w, card

    try:
        moe.route = record
        reset_lm_counts()
        got, _ = model.prefill(gpu_params, {"tokens": tokens})
        torch.cuda.synchronize()
        launched = lm_counts()
        moe.route = pinned
        want, _ = model.prefill(cpu_params, {"tokens": tokens.cpu()})
    finally:
        moe.route = real_route
    got = got.cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    agree_tok = float((got[:, -1].argmax(-1) == want[:, -1].argmax(-1)).float().mean())
    slots = sum(c.numel() for c in card_choices)
    agree = sum(l["agree"] * c.numel() for l, c in zip(layers, card_choices)) / slots
    out = {"max_abs_err": err, "max_abs_logit": scale, "greedy_agree": agree_tok,
           "route_agree": agree, "route_slots": slots, "route_by_layer": layers,
           "launches": launched, "limit": LOGIT_ATOL, "route_tie": ROUTE_TIE,
           "seconds": time.perf_counter() - t0}
    print(f"qwen3-moe logits at full width, 2 layers: routing agrees at {agree:.6f} of "
          f"{slots} (token, slot) choices; per layer {layers}; logits with the card's "
          f"choices max|err| {err:.3e} (max|logit| {scale:.3e}, limit {LOGIT_ATOL}), greedy "
          f"tokens agree {agree_tok:.2f}; kernel launches {launched}; "
          f"{out['seconds']:.1f} s")
    wide = [l["max_margin_where_differing"] for l in layers
            if l["max_margin_where_differing"] is not None
            and l["max_margin_where_differing"] >= ROUTE_TIE]
    if wide:
        fail(f"qwen3-moe: the card and the CPU route differently at margins {wide}, not "
             f"near-ties (under {ROUTE_TIE})")
    if not err <= LOGIT_ATOL:
        fail(f"qwen3-moe logits: max|err| {err:.3e} beyond {LOGIT_ATOL}")
    del gpu_params
    return out


def profile_serve(dev, cfg=None, decode_steps: int = 8, labels=()) -> dict:
    """Where a full-width request's time goes: one prefill and
    ``decode_steps`` decode steps of ``cfg`` (deepseek-7b by default; B
    PROFILE_BATCH, T PROFILE_SEQ; the step programs without a tuning session), each timed on
    the host around a device sync, then run again under
    ``torch.profiler``: the device busy share is the traced kernels'
    summed time over the untraced host interval (one stream, so kernels
    do not overlap). Beside the kernels by device time and their count,
    the ATen products (``aten::bmm``, ``aten::mm``) by input shape, which
    tell an MoE's dispatch and combine einsums from its expert products,
    and the device time inside each ``record_function`` range named in
    ``labels`` (the caller opens them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_tree
    from repro_torch.runtime.serve_loop import widen_cache

    cfg = cfg or get_config("deepseek-7b")
    model = build_model(cfg)
    params = init_tree(model.param_defs(),
                       torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab, (PROFILE_BATCH, PROFILE_SEQ),
                           generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    max_len = PROFILE_SEQ + decode_steps + 1

    def prefill():
        return model.prefill(params, {"tokens": tokens})

    def decode(state):
        tok, cache = state
        for i in range(decode_steps):
            logits, cache = model.decode_step(params, cache, tok, PROFILE_SEQ + i)
            tok = logits[:, -1].argmax(-1)[:, None]
        return tok

    def decode_state():
        logits, cache = prefill()
        return (logits[:, -1].argmax(-1)[:, None],
                widen_cache(model, cache, PROFILE_BATCH, max_len))

    decode(decode_state())                      # warm: allocator, cuBLAS
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": PROFILE_BATCH,
           "seq": PROFILE_SEQ, "decode_steps": decode_steps}
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            fn(*arg)
            torch.cuda.synchronize()
        events = prof.key_averages()
        # a record_function range may also appear on the device's timeline
        # (a user annotation spanning its kernels): not a kernel of its own
        dev_us = {e.key: e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA and e.key not in labels}
        n_kernels = sum(e.count for e in events
                        if e.device_type == DeviceType.CUDA and e.key not in labels)
        ranges_ms = {e.key: e.device_time_total * 1e-3 for e in events
                     if e.key in labels and e.device_type == DeviceType.CPU}
        products = {f"{e.key} {e.input_shapes}": e.device_time_total
                    for e in prof.key_averages(group_by_input_shape=True)
                    if e.key in ("aten::bmm", "aten::mm") and e.device_time_total > 0}
        busy_s = sum(dev_us.values()) * 1e-6
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        top_products = sorted(products.items(), key=lambda kv: -kv[1])[:8]
        out[phase] = {"wall_s": wall, "device_busy_s": busy_s,
                      "device_busy_share": busy_s / wall,
                      "rmsnorm_ms": sum(v for k, v in dev_us.items() if "rmsnorm" in k) * 1e-3,
                      "flash_ms": sum(v for k, v in dev_us.items()
                                      if "flash_kernel" in k) * 1e-3,
                      "top_kernels_ms": {k: v * 1e-3 for k, v in top},
                      "top_products_ms": {k: v * 1e-3 for k, v in top_products},
                      "kernel_launches": n_kernels, "ranges_ms": ranges_ms}
    out["decode"]["step_s"] = out["decode"]["wall_s"] / decode_steps
    for phase in ("prefill", "decode"):
        o = out[phase]
        print(f"profile {cfg.name} ({cfg.n_layers} layers) {phase}: {o['wall_s']:.4f} s "
              f"on the host clock, device busy {o['device_busy_s']:.4f} s "
              f"({100 * o['device_busy_share']:.1f}%), rmsnorm {o['rmsnorm_ms']:.3f} ms, "
              f"flash attention {o['flash_ms']:.3f} ms, {o['kernel_launches']} kernels; "
              f"ranges (ms) { {k: round(v, 3) for k, v in o['ranges_ms'].items()} }; top "
              "kernels (ms): "
              + ", ".join(f"{k[:40]} {v:.1f}" for k, v in list(o["top_kernels_ms"].items())[:5]))
        print("  products by input shape (ms): " + "; ".join(
            f"{k} {v:.1f}" for k, v in list(o["top_products_ms"].items())[:6]))
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
    """Every fp32 instantiation at a ragged shape (M, N, K no multiple of
    any block), a few points at the serving shape and at each shape of
    the recurrent path's handle (handle_specs), and a TF32
    control; then every bf16 instantiation at every ring depth at the
    ragged shape and a few points at each shape of the bf16 phase's
    handle, on the same inputs rounded to bf16 (MATMUL_TOL)."""
    import torch

    from repro_torch.kernels.matmul.matmul import (
        PHASE1, instantiations, matmul_cuda, matmul_plain, path)
    from repro_torch.kernels.matmul.ops import DEFAULT_POINT, make_space

    cases, inputs = [], {}

    def args(shape):
        if shape not in inputs:
            M, N, K = shape
            inputs[shape] = (torch.randn(M, K, generator=gen, device=dev),
                             torch.randn(K, N, generator=gen, device=dev))
        return inputs[shape]

    ragged = (333, 450, 700)
    fp32, bf16 = [], []
    for sym in sorted(instantiations()):
        if "_bf16" not in sym:
            fp32.append(sym)
        elif sym.endswith("_bf16"):
            bf16.append(sym)
    for i, sym in enumerate(fp32):
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
    # the recurrent path's handle shapes, (B T, d_ff, d): the base point
    # and a stride through the Hopper space at each
    for label, spec in handle_specs("matmul", RECURRENT_RUNS):
        shape = (spec["M"], spec["N"], spec["K"])
        space = make_space(*shape, vmem_kb=lib_capacity_kb(dev), hopper=True)
        for point in [DEFAULT_POINT, *list(space.iter_valid())[::541]]:
            a, b = args(shape)
            cases.append((f"{point} at {shape} {label}",
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

    cases, as_bf16, paths = [], {}, {}

    def bf16_case(label, shape, point, want="wgmma"):
        if shape not in as_bf16:
            as_bf16[shape] = tuple(t.to(torch.bfloat16) for t in args(shape))
        a, b = as_bf16[shape]
        if path(a, b) != want:
            fail(f"matmul bf16 at {shape} would take the {path(a, b)} path, not {want}")
        paths[want] = paths.get(want, 0) + 1
        cases.append((f"{point} at {shape} {label} ({want})",
                      lambda: matmul_cuda(a, b, point, lib=lib),
                      lambda: matmul_plain(a, b, point)))

    # every instantiation at every ring depth on both paths: the wgmma
    # kernel at a ragged shape TMA can describe (K and N multiples of 8,
    # no multiple of any tile), the mma kernel at one it cannot
    ragged_tma = (333, 456, 712)
    for i, sym in enumerate(bf16):
        dims = [int(v) for v in re.findall(r"\d+", sym.removesuffix("_bf16"))]
        for la in (0, 1, 2):
            point = dict(zip(PHASE1, dims), order=("mn", "nm")[i % 2],
                         scratch=(i // 2) % 2, lookahead=la)
            bf16_case("bf16 ragged", ragged_tma, point)
            bf16_case("bf16 ragged", ragged, point, want="mma")
    for label, spec in handle_specs("matmul", BF16_RUNS, torch.bfloat16):
        shape = (spec["M"], spec["N"], spec["K"])
        space = make_space(*shape, dtype_bytes=2, vmem_kb=lib_capacity_kb(dev), hopper=True)
        for point in [DEFAULT_POINT, *list(space.iter_valid())[::271]]:
            bf16_case(f"bf16 {label}", shape, point)
    before = dict(matmul_cuda.launches_by_path)
    out["bf16"] = check_cases("matmul bf16", cases, MATMUL_TOL)
    launched = {p: matmul_cuda.launches_by_path.get(p, 0) - before.get(p, 0) for p in paths}
    if launched != paths:
        fail(f"matmul bf16 checks launched {launched} by path, expected {paths}")
    out["bf16"]["checks_by_path"] = paths
    print(f"matmul bf16 checks by path: {paths}")
    return out


def check_attention(lib, dev, gen) -> dict:
    """Every instantiation (each head dim, block_q and block_kv) at every
    ring depth: a ragged shape (Tkv no multiple of any block, G = 4), an
    offset call and a small GQA call with a ragged tail; non-causal calls;
    every block at every ring depth at the reduced serve example's
    prefill (Dh 16); a few points at the serving shape (Dh 128), at
    qwen3-moe's width (Dh 64) and at the timed Dh 16 shape; the families
    path's shapes (FAMILY_ATTENTION_SHAPES) at two points and every ring
    depth; the recurrent path's handle shapes (handle_specs) at
    every point of the Hopper space; and TF32 controls at Dh 128 and
    64. Then the bf16 instantiations on the same inputs rounded to bf16
    (ATTENTION_BF16_TOL): every one at every ring depth at the ragged
    shape, the offset, small and non-causal calls as above, and the bf16
    phase's handle shapes at every point of the bf16 Hopper space; and a
    bf16 control at Dh 128 and 64 (unblocked_attention: p in fp8 must be
    refused, p in bf16 admitted)."""
    import torch

    from repro_torch.kernels.attention.attention import (
        BLOCK_KV, BLOCK_Q, HEAD_DIMS, flash_attention_cuda, flash_attention_plain, path)
    from repro_torch.kernels.attention.ops import make_space

    cases, inputs, per_dh = [], {}, {}

    def args(B, Tq, Tkv, H, Hk, Dh):
        key = (B, Tq, Tkv, H, Hk, Dh)
        if key not in inputs:
            inputs[key] = (torch.randn(B, Tq, H, Dh, generator=gen, device=dev),
                           torch.randn(B, Tkv, Hk, Dh, generator=gen, device=dev),
                           torch.randn(B, Tkv, Hk, Dh, generator=gen, device=dev))
        return inputs[key]

    def case(label, shape, point, **kw):
        q, k, v = args(*shape)
        per_dh[shape[-1]] = per_dh.get(shape[-1], 0) + 1
        cases.append((f"{point} {kw} at {shape} {label}",
                      lambda: flash_attention_cuda(q, k, v, point, lib=lib, **kw),
                      lambda: flash_attention_plain(q, k, v, point, **kw)))

    blocks = [(bq, bkv) for bq in BLOCK_Q for bkv in BLOCK_KV]
    for dh in HEAD_DIMS:
        for i, (bq, bkv) in enumerate(blocks):
            point = {"block_q": bq, "block_kv": bkv}
            case("ragged", (2, 700, 700, 8, 2, dh), dict(point, lookahead=i % 3))
            case("offset", (1, 300, 1000, 8, 2, dh), dict(point, lookahead=(i + 1) % 3),
                 q_offset=700)
            case("small", (3, 150, 77, 4, 1, dh), dict(point, lookahead=(i + 2) % 3))
        case("non-causal", (2, 200, 333, 8, 2, dh), {"block_q": 128, "block_kv": 256},
             causal=False)
    # the front path's prefill: the reduced serve example's (B 4, T 32,
    # H 4, Hk 2, Dh 16), every block (each one a point the tuner may
    # serve there) at every ring depth
    for bq, bkv in blocks:
        for la in (0, 1, 2):
            case("front", (4, 32, 32, 4, 2, 16),
                 {"block_q": bq, "block_kv": bkv, "lookahead": la})
    serving = (4, 512, 512, 32, 32, 128)
    moe = (4, 512, 512, 32, 4, 64)
    reduced = (4, 512, 512, 32, 32, 16)
    for shape in (serving, moe, reduced):
        for point in ({"block_q": 512, "block_kv": 512}, {"block_q": 128, "block_kv": 128},
                      {"block_q": 256, "block_kv": 512}):
            case("main-path width", shape, point)
    # the families path's shapes: the step programs' chunks (512, 1024)
    # clamped to the sequence, and the tuner's base blocks (128, 128), at
    # every ring depth
    for label, shape, causal in FAMILY_ATTENTION_SHAPES:
        for bq, bkv in ((512, 1024), (128, 128)):
            for la in (0, 1, 2):
                case(label, shape, {"block_q": min(bq, shape[1]),
                                    "block_kv": min(bkv, shape[2]), "lookahead": la},
                     causal=causal)
    # the recurrent path's handle shapes (hymba: GQA group 5 over 25
    # heads; rwkv6's 32 heads, which its layers never call): every block
    # the Hopper space holds at every ring depth, each a point the handle
    # may evaluate
    for label, spec in handle_specs("attention", RECURRENT_RUNS):
        shape = tuple(spec[k] for k in ("B", "Tq", "Tkv", "H", "Hk", "Dh"))
        space = make_space(spec["Tq"], spec["Tkv"], spec["Dh"],
                           vmem_kb=lib_capacity_kb(dev), hopper=True)
        points = {(p["block_q"], p["block_kv"], p["lookahead"]) for p in space.iter_valid()}
        for bq, bkv, la in sorted(points):
            case(label, shape, {"block_q": bq, "block_kv": bkv, "lookahead": la})
    out = check_cases("attention", cases, ATTENTION_TOL)
    out["checks_by_head_dim"] = per_dh
    point = {"block_q": 512, "block_kv": 512}
    for shape in (serving, moe):
        q, k, v = args(*shape)
        want = flash_attention_plain(q, k, v, point)
        err, used = tf32_reading(lambda: flash_attention_plain(q, k, v, point), want,
                                 ATTENTION_TOL)
        sfx = "" if shape is serving else f"_dh{shape[-1]}"
        out[f"tf32_max_abs_err{sfx}"], out[f"tf32_tol_used{sfx}"] = err, used
        if used <= 1.0:
            fail(f"TF32 products pass the attention limit {ATTENTION_TOL} at {shape}")
        print(f"attention control: the plain version with TF32 products at "
              f"{shape}, max|err| {err:.3e} ({used:.1f} of the limit), is refused")

    cases, per_dh, as_bf16, paths = [], {}, {}, {}

    def shifted(t):
        """t's values one element past a 16-byte boundary: TMA cannot
        describe the tensor, so the mma kernel serves it"""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return buf[1:].view(t.shape).copy_(t)

    def bf16_case(label, shape, point, want="wgmma", **kw):
        key = (shape, want)
        if key not in as_bf16:
            q, k, v = (t.to(torch.bfloat16) for t in args(*shape))
            as_bf16[key] = (q, k, v) if want == "wgmma" else (q, shifted(k), shifted(v))
        q, k, v = as_bf16[key]
        if path(q, k, v) != want:
            fail(f"attention bf16 at {shape} would take the {path(q, k, v)} path, not {want}")
        paths[want] = paths.get(want, 0) + 1
        per_dh[shape[-1]] = per_dh.get(shape[-1], 0) + 1
        cases.append((f"{point} {kw} at {shape} bf16 {label} ({want})",
                      lambda: flash_attention_cuda(q, k, v, point, lib=lib, **kw),
                      lambda: flash_attention_plain(q, k, v, point, **kw)))

    # every instantiation at every ring depth, on both paths
    for dh in HEAD_DIMS:
        for i, (bq, bkv) in enumerate(blocks):
            point = {"block_q": bq, "block_kv": bkv}
            for want in ("wgmma", "mma"):
                for la in (0, 1, 2):
                    bf16_case("ragged", (2, 700, 700, 8, 2, dh), dict(point, lookahead=la),
                              want)
                bf16_case("offset", (1, 300, 1000, 8, 2, dh),
                          dict(point, lookahead=(i + 1) % 3), want, q_offset=700)
                bf16_case("small", (3, 150, 77, 4, 1, dh),
                          dict(point, lookahead=(i + 2) % 3), want)
        for want in ("wgmma", "mma"):
            bf16_case("non-causal", (2, 200, 333, 8, 2, dh),
                      {"block_q": 128, "block_kv": 256}, want, causal=False)
    for label, spec in handle_specs("attention", BF16_RUNS, torch.bfloat16):
        shape = tuple(spec[k] for k in ("B", "Tq", "Tkv", "H", "Hk", "Dh"))
        space = make_space(spec["Tq"], spec["Tkv"], spec["Dh"], dtype_bytes=2,
                           vmem_kb=lib_capacity_kb(dev), hopper=True)
        points = {(p["block_q"], p["block_kv"], p["lookahead"]) for p in space.iter_valid()}
        for bq, bkv, la in sorted(points):
            bf16_case(label, shape, {"block_q": bq, "block_kv": bkv, "lookahead": la})
    before = dict(flash_attention_cuda.launches_by_path)
    out["bf16"] = check_cases("attention bf16", cases, ATTENTION_BF16_TOL)
    launched = {p: flash_attention_cuda.launches_by_path.get(p, 0) - before.get(p, 0)
                for p in paths}
    if launched != paths:
        fail(f"attention bf16 checks launched {launched} by path, expected {paths}")
    out["bf16"]["checks_by_head_dim"] = per_dh
    out["bf16"]["checks_by_path"] = paths
    print(f"attention bf16 checks by path: {paths}")
    for shape in (serving, moe):
        q, k, v = as_bf16[(shape, "wgmma")] if (shape, "wgmma") in as_bf16 else (
            t.to(torch.bfloat16) for t in args(*shape))
        # the plain version in 128-key blocks, so the unblocked route differs
        want = flash_attention_plain(q, k, v, {"block_q": 128, "block_kv": 128}).float()
        sfx = f"_dh{shape[-1]}"
        for name, p_dtype, refused in (("fp8_control", torch.float8_e4m3fn, True),
                                       ("unblocked", torch.bfloat16, False)):
            got = unblocked_attention(q, k, v, p_dtype).float()
            used = tol_used(got, want, ATTENTION_BF16_TOL)
            out["bf16"][f"{name}_tol_used{sfx}"] = used
            if (used <= 1.0) == refused:
                fail(f"attention bf16 control: {name} at {shape} uses {used:.3f} of the "
                     f"limit {ATTENTION_BF16_TOL}, so the limit "
                     f"{'admits a wrong' if refused else 'refuses a right'} result")
        print(f"attention bf16 control at {shape}: the softmax unblocked with p rounded to "
              f"fp8 (e4m3) uses {out['bf16'][f'fp8_control_tol_used{sfx}']:.2f} of the limit "
              f"and is refused; with p rounded to bf16, "
              f"{out['bf16'][f'unblocked_tol_used{sfx}']:.3f}, admitted")
    return out


def unblocked_attention(q, k, v, p_dtype):
    """Causal attention in one block, scores and sums in fp32, p rounded to
    ``p_dtype`` before p·v: bf16 gives a right bf16 result by another route
    than the plain version's blocks; fp8 a wrong one, for the control."""
    import torch

    B, T, H, Dh = q.shape
    Hk = k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float().reshape(B, T, Hk, H // Hk, Dh),
                     k.float()) * Dh ** -0.5
    pos = torch.arange(T, device=q.device)
    s = s.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(p_dtype).float(), v.float())
    o = o / p.sum(dim=-1)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dh).to(q.dtype)


def check_rmsnorm(lib, dev, gen) -> dict:
    """Every instantiation at every ring depth and type at ragged shapes
    (N not a multiple of block_rows, d not a multiple of 4: the element
    copies), at the serving shapes, prefill's (2048, 4096) and decode's
    (4, 4096), at the reduced serve example's, (128, 64) and (4, 64), and
    at the families and recurrent paths' (FAMILY_RMSNORM_SHAPES,
    RECURRENT_RMSNORM_SHAPES)."""
    import torch

    from repro_torch.kernels.rmsnorm.rmsnorm import (
        BLOCK_ROWS, rmsnorm_cuda, rmsnorm_plain)

    out = {}
    for dtype, tol in ((torch.float32, RMSNORM_TOL), (torch.bfloat16, RMSNORM_BF16_TOL)):
        cases = []
        for N, d in ((1000, 4096), (3, 1001), (2048, 4096), (4, 4096), (128, 64), (4, 64),
                     *FAMILY_RMSNORM_SHAPES, *RECURRENT_RMSNORM_SHAPES):
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
    if not err <= LOGIT_ATOL:
        fail(f"deepseek-7b logits: max|err| {err:.3e} beyond {LOGIT_ATOL}")
    return {"max_abs_err": err, "max_abs_logit": scale, "greedy_agree": agree,
            "launches": launched, "limit": LOGIT_ATOL}


def check_rmsnorm_grad(dev, gen) -> dict:
    """``RMSNormFunction`` (the kernel's forward, a plain backward)
    against autograd through ``rmsnorm_plain``: dx and dw at prefill's
    and decode's shapes and a ragged one, fp32 at RMSNORM_TOL, bf16 at
    RMSNORM_BF16_TOL."""
    import torch

    from repro_torch.kernels.rmsnorm.rmsnorm import (
        DEFAULT_POINT, RMSNormFunction, rmsnorm_plain)

    out = {}
    for dtype, tol in ((torch.float32, RMSNORM_TOL), (torch.bfloat16, RMSNORM_BF16_TOL)):
        cases = []
        for N, d in ((2048, 4096), (4, 4096), (1000, 1000)):
            x = torch.randn(N, d, generator=gen, device=dev).to(dtype)
            w = torch.randn(d, generator=gen, device=dev).to(dtype)
            g = torch.randn(N, d, generator=gen, device=dev).to(dtype)

            def grads(fn, x=x, w=w, g=g):
                xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
                return torch.autograd.grad(fn(xr, wr), (xr, wr), g)

            got = grads(lambda x, w: RMSNormFunction.apply(x, w, 1e-6))
            want = grads(lambda x, w: rmsnorm_plain(x, w, DEFAULT_POINT))
            for name, i in (("dx", 0), ("dw", 1)):
                cases.append((f"{name} at {(N, d)} {dtype}",
                              lambda a=got[i]: a, lambda b=want[i]: b))
        out[str(dtype).removeprefix("torch.")] = check_cases(
            f"rmsnorm gradient {dtype}", cases, tol)
    return {"checks": sum(v["checks"] for v in out.values()),
            "max_abs_err": out["float32"]["max_abs_err"],
            "tol_used": out["float32"]["tol_used"], "by_type": out}


def check_attention_grad_wiring(dev, gen) -> dict:
    """A wiring check, not a check of the kernel: ``FlashAttentionFunction``
    against autograd through ``flash_attention_plain`` at the same point,
    dq, dk, dv at ATTENTION_TOL, at the training shape, a ragged T and
    GQA, with blocks below the smallest instantiation among them. The
    Function's backward is that same plain recompute, so the two agree
    exactly unless the gradients come back in the wrong order or GQA's
    head groups are summed wrongly; the kernel's own evidence in
    training is its forward checks and ``check_model_grads``."""
    import torch

    from repro_torch.kernels.attention.attention import (
        FlashAttentionFunction, flash_attention_plain)

    cases = []
    for (B, T, H, Hk), point in (
            ((4, 512, 32, 32), {"block_q": 512, "block_kv": 512}),
            ((4, 512, 32, 32), {"block_q": 64, "block_kv": 64}),
            ((2, 200, 8, 2), {"block_q": 128, "block_kv": 64}),
            ((2, 512, 32, 8), {"block_q": 256, "block_kv": 128})):
        q = torch.randn(B, T, H, 128, generator=gen, device=dev)
        k = torch.randn(B, T, Hk, 128, generator=gen, device=dev)
        v = torch.randn(B, T, Hk, 128, generator=gen, device=dev)
        g = torch.randn(B, T, H, 128, generator=gen, device=dev)

        def grads(fn, q=q, k=k, v=v, g=g):
            qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
            return torch.autograd.grad(fn(qr, kr, vr), (qr, kr, vr), g)

        got = grads(lambda q, k, v, p=point: FlashAttentionFunction.apply(q, k, v, p))
        want = grads(lambda q, k, v, p=point: flash_attention_plain(q, k, v, p))
        for i, name in enumerate(("dq", "dk", "dv")):
            cases.append((f"{name} {point} at {(B, T, H, Hk)}",
                          lambda a=got[i]: a, lambda b=want[i]: b))
    return check_cases("attention gradient wiring", cases, ATTENTION_TOL)


def check_model_grads(dev) -> dict:
    """The training loss and the gradient of every parameter at full
    width, 2 layers, B 1, T 128: the hand kernels on the card against the
    plain versions on the CPU, same params and tokens. Fails beyond
    GRAD_REL_L2, and where a leaf's gradient is missing or zero on the
    card but not on the CPU.

    Then one AdamW update (the train loop's optimizer settings, step 1)
    from those params, per leaf against GRAD_REL_L2: the card's update of
    its own gradients against the CPU's update of the same gradients (the
    optimizer alone, relative L2 of the change it makes), and the card's
    new params against the CPU's from the CPU's gradients (the whole
    step). The whole step's change itself is reported but not held to a
    limit: the first AdamW step moves an element by about lr * sign(g),
    so an element whose gradient lies within the two sides' rounding of
    zero may move the other way."""
    import torch

    from repro_torch.checkpoint.checkpointer import _flatten
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_tree
    from repro_torch.optim.adamw import AdamW, OptimizerConfig
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=TRAIN_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    cpu_params = init_tree(model.param_defs(), torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (1, 129), generator=gen)
    names = list(_flatten(cpu_params))            # in tree_leaves' order

    def loss_and_grads(params, device):
        batch = {"tokens": tokens[:, :-1].to(device), "labels": tokens[:, 1:].to(device)}
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss = model.loss(params, batch)
        return loss.item(), list(torch.autograd.grad(loss, leaves, allow_unused=True))

    card_params = to_device(cpu_params, dev)
    reset_lm_counts()
    got_loss, card_grads = loss_and_grads(card_params, dev)
    launched = lm_counts()
    got = [None if g is None else g.float().cpu() for g in card_grads]
    want_loss, want = loss_and_grads(cpu_params, "cpu")
    rel, faults = {}, []
    for name, g, w in zip(names, got, want):
        # every leaf of the dense model has a nonzero gradient on the CPU
        if g is None or not bool(g.any()):
            faults.append(name)
            continue
        rel[name] = float((g - w).norm() / w.norm())
    if faults:
        fail(f"training gradients missing or zero on the card, not on the CPU: {faults}")
    worst = max(rel, key=rel.get)
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    print(f"training gradients at full width, {TRAIN_LAYERS} layers, B 1, T 128: hand "
          f"kernels on the card against plain versions on the CPU, loss {got_loss:.6f} "
          f"vs {want_loss:.6f}; {len(rel)} leaves, worst relative L2 error "
          f"{rel[worst]:.3e} ({worst}) against {GRAD_REL_L2}; kernel launches "
          f"{launched}; {time.perf_counter() - t0:.1f} s")
    if rel[worst] > GRAD_REL_L2 or loss_rel > GRAD_REL_L2:
        fail(f"training gradients beyond {GRAD_REL_L2}: {rel}; loss {loss_rel:.3e}")
    if launched["rmsnorm"] == 0 or launched["flash_attention"] == 0:
        fail(f"the training loss did not launch the rmsnorm and attention kernels: "
             f"{launched}")

    t0 = time.perf_counter()
    opt = AdamW(OptimizerConfig(warmup_steps=10, total_steps=TRAIN_STEPS))
    old = [p.detach() for p in tree_leaves(cpu_params)]

    def updated(params, grads):
        """The params after one update from a fresh state, on the CPU."""
        with torch.no_grad():
            params = tree_unflatten(params, [p.detach() for p in tree_leaves(params)])
            new, _, _ = opt.update(tree_unflatten(params, grads), opt.init(params), params)
        return [p.cpu() for p in tree_leaves(new)]

    def rel_l2(a, b, base=None):
        """Per leaf ||a - b|| / ||b||, of the changes from ``base`` if given
        (fp32 differences of nearby values are exact)."""
        out = {}
        for i, n in enumerate(names):
            x, y = (a[i], b[i]) if base is None else (a[i] - base[i], b[i] - base[i])
            out[n] = float((x - y).norm() / y.norm())
        return out

    card_new = updated(card_params, card_grads)
    del card_params, card_grads
    torch.cuda.empty_cache()
    cpu_new = updated(cpu_params, got)          # the CPU's update of the card's gradients
    opt_rel = rel_l2(card_new, cpu_new, old)
    del cpu_new
    step_new = updated(cpu_params, want)        # the whole step on the CPU
    param_rel = rel_l2(card_new, step_new)
    step_update_rel = rel_l2(card_new, step_new, old)
    del card_new, step_new
    opt_worst = max(opt_rel, key=opt_rel.get)
    param_worst = max(param_rel, key=param_rel.get)
    print(f"one AdamW update: the card's against the CPU's on the card's gradients, "
          f"worst relative L2 of the change {opt_rel[opt_worst]:.3e} ({opt_worst}); "
          f"the whole step's new params, worst relative L2 {param_rel[param_worst]:.3e} "
          f"({param_worst}), both against {GRAD_REL_L2}; the whole step's change, "
          f"worst {max(step_update_rel.values()):.3e} (no limit); "
          f"{time.perf_counter() - t0:.1f} s")
    if opt_rel[opt_worst] > GRAD_REL_L2 or param_rel[param_worst] > GRAD_REL_L2:
        fail(f"the AdamW update on the card departs from the CPU's beyond "
             f"{GRAD_REL_L2}: optimizer {opt_rel}; whole step {param_rel}")
    return {"loss": got_loss, "cpu_loss": want_loss, "loss_rel_err": loss_rel,
            "rel_l2": rel, "worst_leaf": worst, "limit": GRAD_REL_L2,
            "launches": launched, "update_rel_l2": opt_rel,
            "step_param_rel_l2": param_rel, "step_update_rel_l2": step_update_rel}


def run_train(dev) -> dict:
    """The training path: ``train()`` at full width, cut to 2 layers,
    with online tuning of the step and its kernels, then a resumed run.
    The checkpoints go to a temporary directory inside the checkout's
    build directory, removed at the end."""
    import shutil
    import tempfile

    import torch

    from repro_torch.api import train_tuning_defaults
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.runtime.train_loop import TrainLoopConfig, train

    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=TRAIN_LAYERS)
    shape = ShapeSpec("chip_smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
    tuning = dataclasses.replace(train_tuning_defaults(), enabled=True,
                                 kernel_tuning="both")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train.", dir=build)
    out = {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                      "of_layers": get_config("deepseek-7b").n_layers,
                      "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                      "d_head": cfg.d_head, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                      "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": cfg.remat,
                      "params": cfg.n_params(), "dtype": str(cfg.param_dtype)},
           "disk_free_gb": shutil.disk_usage(build).free / 1e9}
    try:
        runs = []
        for steps in (TRAIN_STEPS, TRAIN_RESUME_STEPS):
            loop = TrainLoopConfig(steps=steps, ckpt_every=TRAIN_STEPS, ckpt_dir=ckpt_dir,
                                   tuning=dataclasses.replace(tuning))
            # what an earlier run left for the cycle collector (its tuning
            # session's closures hold the state they measured on)
            left = {"before_gc_gb": torch.cuda.memory_allocated(dev) / 1e9}
            gc.collect()
            torch.cuda.empty_cache()
            left["after_gc_gb"] = torch.cuda.memory_allocated(dev) / 1e9
            torch.cuda.reset_peak_memory_stats(dev)
            reset_lm_counts()
            t0 = time.perf_counter()
            res = train(cfg, shape, loop, device=dev)
            res["seconds"] = time.perf_counter() - t0
            res["launches"] = lm_counts()
            res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            res["allocated_at_start"] = left
            runs.append(res)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    first, resumed = runs
    for name, res in (("first", first), ("resumed", resumed)):
        steps_s = res["step_s"]
        a = res["autotune"]
        res["median_step_s"] = sorted(steps_s)[len(steps_s) // 2]
        res["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / res["median_step_s"]
        kernels = {n: {"regenerations": k["regenerations"], "explored": k["n_explored"],
                       "best_point": k["best_point"], "warm_started": k["warm_started"]}
                   for n, k in sorted(res["coordinator"]["kernels"].items())}
        res["kernels"] = kernels
        print(f"train {name}: steps {res['start_step']} -> {res['steps']} in "
              f"{res['seconds']:.1f} s; median step {res['median_step_s']:.4f} s "
              f"({res['tokens_per_s']:.0f} tokens/s); loss {res['first_loss']:.4f} -> "
              f"{res['final_loss']:.4f}; step program: {a['n_explored']} explored, "
              f"serving {a['active_point']}, warm-started {a['warm_started']}; "
              f"overhead {100 * res['coordinator']['overhead_frac']:.2f}%; "
              f"launches {res['launches']}; peak memory "
              f"{res['max_memory_allocated_gb']:.2f} GB (allocated at the start "
              f"{res['allocated_at_start']}); checkpoint save s "
              f"{[round(t, 2) for t in res['ckpt_save_s']]}, restore s "
              f"{res['ckpt_restore_s']}")
        print(f"  handles: {kernels}")
    if first["steps"] != TRAIN_STEPS or first["start_step"] != 0:
        fail(f"the first training run ran {first['start_step']} -> {first['steps']}")
    if resumed["start_step"] != TRAIN_STEPS or resumed["steps"] != TRAIN_RESUME_STEPS:
        fail(f"the resumed run ran {resumed['start_step']} -> {resumed['steps']}, "
             f"not {TRAIN_STEPS} -> {TRAIN_RESUME_STEPS}")
    if not resumed["autotune"]["warm_started"]:
        fail("the resumed run's step program did not warm-start from tuned.json")
    losses = first["losses"] + resumed["losses"]
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        fail(f"non-finite training losses {losses}")
    for name, n in first["launches"].items():
        if n == 0:
            fail(f"the training path never launched the {name} kernel")
    for res in runs:
        if res["coordinator"]["quarantined"]:
            fail(f"variants were quarantined in training: {res['coordinator']}")
    for res in runs:
        res.pop("coordinator")
    out["runs"] = runs
    return out


def profile_train(dev, point: dict, steps: int = 3) -> dict:
    """Where a training step's time goes: ``steps`` steps of the train
    loop's step program (``train_loop._make_step``) at the training
    path's shapes and the attention chunks ``point`` that the tuned run
    served, after one untraced warm-up step, under ``torch.profiler``
    (no tuning session). The step marks its forward, its backward (with
    each block's recompute) and its update, and under the profiler each
    mark ends in a device sync, so a kernel belongs to the mark whose
    host interval holds its start; busy share = the traced kernels' time
    over the traced steps' host interval."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import batches_for, device_put_batch
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_tree
    from repro_torch.optim.adamw import AdamW, OptimizerConfig
    from repro_torch.runtime.train_loop import _make_step

    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=TRAIN_LAYERS,
                              **(point or {}))
    model = build_model(cfg)
    params = init_tree(model.param_defs(), torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    opt = AdamW(OptimizerConfig(warmup_steps=10, total_steps=100))
    state = opt.init(params)
    stream = batches_for(cfg, ShapeSpec("profile", "train", TRAIN_SEQ, TRAIN_BATCH))
    batches = [device_put_batch(next(stream), dev) for _ in range(steps + 1)]
    train_step = _make_step(model, opt, None, cfg)

    def step(params, state, batch):
        loss, params, state, _, _ = train_step(params, state, None, batch)
        loss.item()
        return params, state

    params, state = step(params, state, batches[0])          # warm: allocator, cuBLAS
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[1:]:
            params, state = step(params, state, batch)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    events = prof.events()
    marks = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.name in ("forward", "backward", "update")
             and e.device_type == DeviceType.CPU]
    phases = {n: {"device_ms": 0.0, "host_ms": 0.0, "kernels_ms": {}}
              for n in ("forward", "backward", "update", "unmarked")}
    for name, start, end in marks:
        phases[name]["host_ms"] += (end - start) * 1e-3
    busy_us = 0.0
    for e in events:
        # the marks' device-side spans share their names: not kernels
        if e.device_type != DeviceType.CUDA or e.name in phases:
            continue
        us = e.time_range.elapsed_us()
        busy_us += us
        phase = next((n for n, a, b in marks if a <= e.time_range.start <= b), "unmarked")
        ph = phases[phase]
        ph["device_ms"] += us * 1e-3
        ph["kernels_ms"][e.name] = ph["kernels_ms"].get(e.name, 0.0) + us * 1e-3
    out = {"steps": steps, "point": point, "wall_s": wall, "step_s": wall / steps,
           "device_busy_s": busy_us * 1e-6, "device_busy_share": busy_us * 1e-6 / wall,
           "phases": phases}
    for key, tag in (("rmsnorm_ms", "rmsnorm"), ("flash_ms", "flash_kernel")):
        out[key] = {n: sum(v for k, v in ph["kernels_ms"].items() if tag in k)
                    for n, ph in phases.items()}
    for ph in phases.values():
        ph["kernels_ms"] = dict(sorted(ph["kernels_ms"].items(), key=lambda kv: -kv[1])[:8])
    print(f"profile train at {point}: {steps} steps in {wall:.3f} s on the host clock, device busy "
          f"{out['device_busy_s']:.3f} s ({100 * out['device_busy_share']:.1f}%); "
          f"rmsnorm ms {out['rmsnorm_ms']}, flash attention ms {out['flash_ms']}")
    for name, ph in phases.items():
        print(f"  {name}: device {ph['device_ms']:.1f} ms, host {ph['host_ms']:.1f} ms; "
              + ", ".join(f"{k[:48]} {v:.1f}" for k, v in list(ph["kernels_ms"].items())[:5]))
    del params, state
    return out


def start_dist_traces() -> list:
    """Start the dist phase's host work, each a process on the CPU (no
    card): the production cells of DIST_DRYRUN through ``python -m
    repro_torch.launch.dryrun``, the cut cells through ``python -m
    repro_torch.launch.dist_cells``, the families' gradient check on 4
    gloo ranks, and the phase's own cells on a fake 1 x 1 group.
    :func:`run_dist` collects them."""
    import atexit
    import importlib.util
    import socket

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out_dir = ROOT / "build" / "dryrun_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)

    def start(tag, path, args):
        # each in a process group of its own (with its children), at the
        # lowest priority; :func:`hold_dist_traces` stops and resumes them.
        # A report left by an earlier run must not stand for this one's.
        if path is not None:
            path.unlink(missing_ok=True)
        return (tag, path, subprocess.Popen(
            [sys.executable, *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True,
            preexec_fn=lambda: os.nice(19)))

    cells = [("train", TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ),
             ("prefill", None, TRAIN_BATCH, TRAIN_SEQ)]
    procs = [start("cells", None, ["-c", DIST_TRACE % repr(cells)])]
    for arch, shape in DIST_DRYRUN:
        procs.append(start((arch, shape), out_dir / f"{arch}_{shape}_single.json",
                           ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                            shape, "--mesh", "single", "--out", str(out_dir)]))
    procs.append(start("cut", out_dir / "dist_cells.json",
                       ["-m", "repro_torch.launch.dist_cells", "--jobs", str(DIST_CUT_JOBS),
                        "--report", str(out_dir / "dist_cells.json")]))
    def load(tag, path):
        spec = importlib.util.spec_from_file_location(tag, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    grads, decode = load("families_check", DIST_GRAD_CHECK), load("decode_check",
                                                                  DIST_DECODE_CHECK)
    with socket.socket() as a, socket.socket() as b:
        a.bind(("localhost", 0))
        b.bind(("localhost", 0))
        ports = a.getsockname()[1], b.getsockname()[1]
    for (tag, check, extra), port in zip(
            (("grads", grads, []), ("decode", decode, [str(decode.T)])), ports):
        script = out_dir / f"dist_{tag}.py"
        script.write_text(check.WORKER)
        procs.append(start((tag, len(check.CASES)), out_dir / f"dist_{tag}.json",
                           [str(script), json.dumps(check.CASES), *extra, str(port),
                            str(out_dir / f"dist_{tag}.json")]))
    # a run that fails before collecting them leaves none behind
    atexit.register(stop_dist_traces, procs)
    return procs


def stop_dist_traces(procs) -> None:
    """Kill what is left of :func:`start_dist_traces`' process groups."""
    import signal

    for _, _, proc in procs:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def hold_dist_traces(procs, hold: bool) -> None:
    """Stop (``hold``) or resume :func:`start_dist_traces`' processes and
    their children: the card's host-timed phases must read as they do
    alone (a host-bound decode step slows beside eight trace processes)."""
    import signal

    for _, _, proc in procs or ():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGSTOP if hold else signal.SIGCONT)


def finish_dist_traces(procs) -> tuple[dict, list, dict, dict, dict]:
    """Wait for :func:`start_dist_traces`' processes; fail on any fault:
    (the 1 x 1 cells, the production records, the cut cells' report, the
    gradient check, the decode check)."""
    cells, dryrun, cut, checks = None, [], None, {}
    for tag, path, proc in procs:
        out, err = proc.communicate(timeout=1000)
        if tag == "cut":
            # exit 1: faults, which the report lists; anything else failed
            if proc.returncode not in (0, 1) or not path.exists():
                fail(f"dist: the cut cells exited {proc.returncode}: {err[-2000:]}")
            cut = json.loads(path.read_text())
            from repro_torch.launch import dist_cells
            if sorted(cut["traced"]) != sorted(map(dist_cells.name, dist_cells.CELLS)):
                fail(f"dist: the cut cells' report names {sorted(cut['traced'])}")
            continue
        if proc.returncode != 0:
            fail(f"dist: the host trace {tag} failed: {err[-2000:]}")
        if tag == "cells":
            cells = json.loads(out.split("DIST_TRACE ", 1)[1])
        elif tag[0] in ("grads", "decode"):
            checks[tag[0]] = json.loads(path.read_text())
            if len(checks[tag[0]]) != tag[1]:
                fail(f"dist: the {tag[0]} check ran {sorted(checks[tag[0]])} of {tag[1]} "
                     "cases")
        else:
            rec = json.loads(path.read_text())
            if rec["status"] != "ok":
                fail(f"dist: the dry run of {tag} is {rec['status']}")
            dryrun.append(rec)
    return cells, dryrun, cut, checks["grads"], checks["decode"]


def _on_mesh(tree, layout, mesh):
    """``tree``'s tensors as DTensors on a one-rank ``mesh`` laid out as
    ``layout`` (a tree of placements): there the local shard is the whole
    tensor, so no copy is made."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _on_mesh(v, layout[k], mesh) for k, v in tree.items()}
    return DTensor.from_local(tree, mesh, layout, run_check=False)


def _rel_diff(got, want, l2: bool = False) -> float:
    """max |got - want| over max |want|, or with ``l2`` ||got - want|| over
    ||want|| (DTensors read by their local shard: the whole tensor on one
    rank)."""
    got = got.to_local() if hasattr(got, "to_local") else got
    diff, want = got.float() - want.float(), want.float()
    if l2:
        return float(diff.norm() / want.norm().clamp_min(1e-30))
    return float(diff.abs().max() / want.abs().max().clamp_min(1e-30))


def run_dist(dev, procs, train_report) -> dict:
    """The sharded train and prefill cells on a one-rank NCCL group (see
    the module docstring, 7.), then the host traces' terms."""
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import batches_for, device_put_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import build_cell
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_tree
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import _make_step
    from repro_torch.tree import tree_leaves

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    plain_calls = []
    real_plain = L.flash_attention_torch

    def counted_plain(q, k, v, **kw):
        plain_calls.append(tuple(q.shape))
        return real_plain(q, k, v, **kw)

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0

    out: dict = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        # -- the train cell: 3 steps unsharded, then 3 sharded ------------
        cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=TRAIN_LAYERS)
        shape = ShapeSpec("dist", "train", TRAIN_SEQ, TRAIN_BATCH)
        model, opt = build_model(cfg), AdamW()
        params = init_tree(model.param_defs(), torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        stream = batches_for(cfg, shape)
        batches = [device_put_batch(next(stream), dev) for _ in range(DIST_STEPS)]
        step = _make_step(model, opt, None, cfg)
        p, o = params, opt.init(params)
        plain_losses, plain_s = [], []
        for b in batches:
            (loss, p, o, _, _), s = timed(lambda: step(p, o, None, b))
            plain_losses.append(float(loss))
            plain_s.append(s)
        want = p
        del o, p
        cell = build_cell(cfg, shape, mesh)
        dp = _on_mesh(params, cell.in_shardings[0], mesh)
        do = _on_mesh(opt.init(params), cell.in_shardings[1], mesh)
        dbs = [_on_mesh(b, cell.in_shardings[2], mesh) for b in batches]
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated(dev)
        step_args = sum(t.numel() * t.element_size()
                        for t in tree_leaves(params) + tree_leaves(do) + tree_leaves(batches[0]))
        torch.cuda.reset_peak_memory_stats(dev)
        reset_lm_counts()
        L.flash_attention_torch = counted_plain
        losses, step_s = [], []
        try:
            for b in dbs:
                (loss, dp, do), s = timed(lambda: cell.fn(dp, do, b))
                losses.append(float(loss.to_local()))
                step_s.append(s)
        finally:
            L.flash_attention_torch = real_plain
        launches = lm_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
        # per leaf, in L2: autograd may add a gradient's contributions in
        # another order around DTensor's own nodes, and a first AdamW step
        # moves a parameter whose gradient is near 0 by up to lr whatever
        # its sign, so a few elements may differ by about lr
        param_rel = max(_rel_diff(a, b, l2=True)
                        for a, b in zip(tree_leaves(dp), tree_leaves(want)))
        out["train"] = {
            "config": {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": TRAIN_BATCH,
                       "seq": TRAIN_SEQ, "dtype": str(cfg.param_dtype), "steps": DIST_STEPS,
                       "microbatches": cell.microbatches},
            "losses": losses, "plain_losses": plain_losses, "loss_rel": loss_rel,
            "param_rel": param_rel, "step_s": step_s, "plain_step_s": plain_s,
            "median_step_s": statistics.median(step_s),
            "plain_median_step_s": statistics.median(plain_s),
            "launches": launches, "plain_attention_calls": len(plain_calls),
            "max_memory_allocated_gb": peak / 1e9,
            # the step's own peak: less what stayed resident beside its
            # arguments (the unsharded run's params, the other batches)
            "step_peak_gb": (peak - resident + step_args) / 1e9}
        if train_report is not None:
            out["train"]["train_phase_median_step_s"] = \
                train_report["runs"][0]["median_step_s"]
        del dp, do, dbs, want, params, batches
        gc.collect()
        torch.cuda.empty_cache()
        if loss_rel > DIST_REL or param_rel > DIST_REL:
            fail(f"dist: the sharded train steps differ from the unsharded ones: "
                 f"losses {losses} vs {plain_losses}, params rel {param_rel:.3g}")
        if launches["rmsnorm"] == 0 or launches["flash_attention"] == 0 or plain_calls:
            fail(f"dist: the sharded train steps launched {launches}, "
                 f"plain attention {len(plain_calls)} times")

        # -- the prefill cell, whole: 3 runs unsharded, then 3 sharded ----
        plain_calls.clear()
        cfg = get_config("deepseek-7b")
        shape = ShapeSpec("dist", "prefill", TRAIN_SEQ, TRAIN_BATCH)
        model = build_model(cfg)
        params = init_tree(model.param_defs(), torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        batch = device_put_batch(next(batches_for(cfg, shape)), dev)
        plain_s = []
        with torch.no_grad():
            for _ in range(DIST_STEPS):
                (want, _), s = timed(lambda: model.prefill(params, batch))
                plain_s.append(s)
        cell = build_cell(cfg, shape, mesh)
        dp = _on_mesh(params, cell.in_shardings[0], mesh)
        db = _on_mesh(batch, cell.in_shardings[1], mesh)
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated(dev)
        step_args = sum(t.numel() * t.element_size()
                        for t in tree_leaves(params) + tree_leaves(batch))
        torch.cuda.reset_peak_memory_stats(dev)
        reset_lm_counts()
        L.flash_attention_torch = counted_plain
        run_s = []
        try:
            for _ in range(DIST_STEPS):
                (logits, _), s = timed(lambda: cell.fn(dp, db))
                run_s.append(s)
        finally:
            L.flash_attention_torch = real_plain
        launches = lm_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        logit_rel = _rel_diff(logits, want)
        out["prefill"] = {
            "config": {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": TRAIN_BATCH,
                       "seq": TRAIN_SEQ, "dtype": str(cfg.param_dtype)},
            "logit_rel": logit_rel, "step_s": run_s, "plain_step_s": plain_s,
            "median_step_s": statistics.median(run_s),
            "plain_median_step_s": statistics.median(plain_s),
            "launches": launches, "plain_attention_calls": len(plain_calls),
            "max_memory_allocated_gb": peak / 1e9,
            "step_peak_gb": (peak - resident + step_args) / 1e9}
        del dp, db, params, logits, want
        gc.collect()
        torch.cuda.empty_cache()
        if logit_rel > DIST_REL:
            fail(f"dist: the sharded prefill's logits differ by {logit_rel:.3g} relative")
        if launches["rmsnorm"] == 0 or launches["flash_attention"] == 0 or plain_calls:
            fail(f"dist: the sharded prefill launched {launches}, "
                 f"plain attention {len(plain_calls)} times")
    finally:
        dist.destroy_process_group()

    # -- the host traces: the walker's terms beside the measured steps ----
    cells, dryrun, cut, grads, decode = finish_dist_traces(procs)
    for kind in ("train", "prefill"):
        o, c = out[kind], cells[kind]
        r = c["roofline"]
        dominant = max(r["compute_s"], r["memory_s"], r["collective_s"])
        o["walker"] = c
        o["dominant_s"] = dominant
        o["measured_share"] = dominant / o["median_step_s"]
        print(f"dist {kind}: {o['config']['n_layers']} layers, sharded median step "
              f"{o['median_step_s']:.4f} s, unsharded {o['plain_median_step_s']:.4f} s"
              + (f", train phase {o['train_phase_median_step_s']:.4f} s"
                 if "train_phase_median_step_s" in o else "")
              + f"; {'losses' if kind == 'train' else 'logits'} rel "
              f"{o.get('loss_rel', o.get('logit_rel')):.3g}"
              + (f", params rel {o['param_rel']:.3g}" if kind == "train" else "")
              + f"; launches {o['launches']}, plain attention {o['plain_attention_calls']}; "
              f"peak {o['max_memory_allocated_gb']:.2f} GB allocated, the step's own "
              f"{o['step_peak_gb']:.2f} GB, walker {c['memory_eager']['peak_bytes'] / 1e9:.2f} "
              f"GB ({c['memory']['peak_bytes'] / 1e9:.2f} GB with the state donated); "
              f"walker {c['flops']:.4g} FLOPs, {c['bytes']:.4g} bytes (traced in "
              f"{c['trace_s']:.1f} s, {c['nodes']} nodes); fp32 roofline compute "
              f"{r['compute_s']:.4f} s, memory {r['memory_s']:.4f} s, bound {r['bound']}; "
              f"measured share of the dominant term {o['measured_share']:.3f}")
    out.update(check_dist_host(dryrun, cut, grads, decode))
    return out


def check_dist_host(dryrun, cut, grads, decode) -> dict:
    """The dist phase's host traces on this host's PyTorch: the production
    cells against DIST_MIN_USEFUL and DIST_MAX_PEAK_GB, the cut cells
    against torch 2.13's counts, the families' gradients and the decode
    step's logits and caches against the unsharded ones; fail on any
    fault."""
    import torch

    out: dict = {}
    out["dryrun"] = [{"arch": r["arch"], "shape": r["shape"], "trace_s": r["trace_s"],
                      "graph_nodes": r["graph_nodes"], "memory": r["memory"],
                      "roofline": r["roofline"]} for r in dryrun]
    out["torch"] = torch.__version__
    faults = []
    for r in out["dryrun"]:
        f = r["roofline"]
        print(f"dist dry run {r['arch']} {r['shape']} (256 GPUs, H100 constants, torch "
              f"{torch.__version__}): traced in "
              f"{r['trace_s']:.1f} s ({r['graph_nodes']} nodes); compute {f['compute_s']:.4g} s, "
              f"memory {f['memory_s']:.4g} s, collective {f['collective_s']:.4g} s, "
              f"bound {f['bound']}, useful {f['useful_ratio']:.3f}, roofline fraction "
              f"{f['roofline_frac']:.3f}; peak {r['memory']['peak_per_device_gb']} GB")
        low = DIST_MIN_USEFUL.get(r["shape"])
        if low is not None and f["useful_ratio"] < low:
            faults.append(f"{r['arch']} {r['shape']} useful {f['useful_ratio']:.3f} < {low}")
        high = DIST_MAX_PEAK_GB.get(r["shape"])
        if high is not None and r["memory"]["peak_per_device_gb"] > high:
            faults.append(f"{r['arch']} {r['shape']} peak "
                          f"{r['memory']['peak_per_device_gb']} GB > {high}")
    # -- the cut cells against torch 2.13's counts -------------------------
    out["cut_cells"] = cut
    for name, cmp in cut["compared"].items():
        got = cut["traced"][name]
        print(f"dist cut cell {name} (1 layer, torch {got['torch']}, traced in "
              f"{got['trace_s']:.1f} s): " + "; ".join(
                  f"{k} {c['got']:.6g} against {c['want']:.6g} ({c['rel']:.3%}, limit "
                  f"{c['limit']:.0%})" for k, c in cmp.items()))
    faults += [f"cut cell {f}" for f in cut["faults"]]
    # -- the families' sharded gradients -----------------------------------
    worst = {case: max(r["rel"].items(), key=lambda kv: kv[1]) for case, r in grads.items()}
    out["grad_check"] = {"cases": grads, "worst": worst, "limit": DIST_GRAD_REL}
    case, (leaf, rel) = max(worst.items(), key=lambda kv: kv[1][1])
    print(f"dist gradients, sharded (2 x 2 gloo ranks, torch {torch.__version__}) against "
          f"unsharded over {len(grads)} cases: worst relative L2 {rel:.3g} ({case}, {leaf}), "
          f"limit {DIST_GRAD_REL}; losses within "
          f"{max(abs(r['loss'] - r['want']) / abs(r['want']) for r in grads.values()):.3g}")
    for case, r in grads.items():
        if worst[case][1] > DIST_GRAD_REL:
            faults.append(f"gradient {case} {worst[case][0]}: {worst[case][1]:.3g}")
        if abs(r["loss"] - r["want"]) > DIST_LOSS_RTOL * abs(r["want"]):
            faults.append(f"loss {case}: {r['loss']} against {r['want']}")
    # -- the sharded decode step ------------------------------------------
    out["decode_check"] = {"cases": decode, "limit": DIST_DECODE_REL}
    case = max(decode, key=lambda c: max(decode[c]))
    print(f"dist decode step, sharded (2 x 2 gloo ranks, torch {torch.__version__}) against "
          f"unsharded over {len(decode)} cases (batch 1: contracted over the FSDP dim): "
          f"worst relative L2 {max(decode[case]):.3g} ({case}), limit {DIST_DECODE_REL}")
    faults += [f"decode {c}: {max(r):.3g}" for c, r in decode.items()
               if max(r) > DIST_DECODE_REL]
    if faults:
        fail("dist: " + "; ".join(faults))
    return out


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
    del q, k, v, qt, kt, vt
    # the smaller head dims at the same B, T and H: Dh 64 with qwen3-moe's
    # 4 kv heads, Dh 16 (the reduced configs' head dim) with 32. Device
    # times from graph replays (a Dh 16 call is shorter than an eager
    # wrapper's host cost), the eager readings beside them
    by_dh = {}
    for dh, hk in ((64, 4), (16, 32)):
        q = torch.randn(B, T, H, dh, generator=gen, device=dev)
        k = torch.randn(B, T, hk, dh, generator=gen, device=dev)
        v = torch.randn(B, T, hk, dh, generator=gen, device=dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        row = {"ms": device_ms(flash_attention_cuda, q, k, v, step_point),
               "ms_128x128": device_ms(flash_attention_cuda, q, k, v,
                                       {"block_q": 128, "block_kv": 128}),
               "plain_ms": device_ms(flash_attention_plain, q, k, v, step_point),
               "library_ms": device_ms(sdpa),
               "eager_ms": time_ms(flash_attention_cuda, q, k, v, step_point),
               "library_eager_ms": time_ms(sdpa),
               "point": step_point, "shape": [B, T, H, hk, dh]}
        work = (4.0 * B * H * T * T * dh * 0.5, 4.0 * (2 * B * T * H + 2 * B * T * hk) * dh)
        row["bound_ms"], row["bound_by"] = bound(*work)
        row["bound_3xtf32_ms"] = bound(*work, tf32x3=True)[0]
        by_dh[dh] = row
        print(f"attention at Dh {dh}, {row['shape']} (B, T, H, Hk, Dh): "
              f"{row['ms']:.4f} ms at {step_point}, {row['ms_128x128']:.4f} at "
              f"(128, 128); bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"3xTF32 bound {row['bound_3xtf32_ms']:.4f}; plain "
              f"{row['plain_ms']:.4f} ms; SDPA {row['library_ms']:.4f} ms (graph "
              f"replays); eager: kernel {row['eager_ms']:.4f} ms, SDPA "
              f"{row['library_eager_ms']:.4f} ms")
        del q, k, v, qt, kt, vt
    out["attention"]["by_head_dim"] = by_dh
    # the families path's new shapes: GQA groups 5 and 7 at Dh 128 and
    # whisper's non-causal calls over 1500 frames, at the step programs'
    # chunks (512, 1024) clamped to the sequence
    fam = {}
    for label, (b, tq, tkv, h, hk, dh), causal in FAMILY_ATTENTION_SHAPES:
        if label.startswith(("qwen3-moe", "whisper decoder")):
            continue                      # timed above (Dh 64, Hk 4) / a 32-token call
        q = torch.randn(b, tq, h, dh, generator=gen, device=dev)
        k = torch.randn(b, tkv, hk, dh, generator=gen, device=dev)
        v = torch.randn(b, tkv, hk, dh, generator=gen, device=dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        point = {"block_q": min(512, tq), "block_kv": min(1024, tkv)}

        def sdpa(qt=qt, kt=kt, vt=vt, causal=causal):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)

        row = {"ms": device_ms(lambda: flash_attention_cuda(q, k, v, point, causal=causal)),
               "plain_ms": device_ms(lambda: flash_attention_plain(q, k, v, point,
                                                                   causal=causal)),
               "library_ms": device_ms(sdpa), "point": point, "causal": causal,
               "shape": [b, tq, tkv, h, hk, dh]}
        work = (4.0 * b * h * tq * tkv * dh * (0.5 if causal else 1.0),
                4.0 * (2 * b * tq * h + 2 * b * tkv * hk) * dh)
        row["bound_ms"], row["bound_by"] = bound(*work)
        row["bound_3xtf32_ms"] = bound(*work, tf32x3=True)[0]
        fam[label] = row
        print(f"attention, {label} {row['shape']} (B, Tq, Tkv, H, Hk, Dh), causal {causal}: "
              f"{row['ms']:.4f} ms at {point}; bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), 3xTF32 bound {row['bound_3xtf32_ms']:.4f}; plain "
              f"{row['plain_ms']:.4f} ms; SDPA {row['library_ms']:.4f} ms (graph replays)")
        del q, k, v, qt, kt, vt
    out["attention"]["families"] = fam

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
    # the recurrent path's width, hymba's d 1600, at prefill's and decode's
    # rows. Each call of a replay takes the next input of a pool that holds
    # more than three times the L2 (where one input is larger than a
    # thousandth of it), so prefill's 13 MB input comes from HBM, as the
    # byte bound assumes, and not from the L2 a repeated input stays in
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    rec = {}
    for rows in (2048, 4):
        nbytes = 4 * rows * 1600
        n_pool = -(-3 * l2 // nbytes) if nbytes * 1000 > l2 else 1
        pool = [(torch.randn(rows, 1600, generator=gen, device=dev),
                 torch.randn(1600, generator=gen, device=dev)) for _ in range(n_pool)]

        def rotated(fn):
            turn = itertools.count()
            return lambda: fn(*pool[next(turn) % n_pool])

        row = {"ms": device_ms(rotated(lambda x, w: rmsnorm_cuda(x, w, RN_DEFAULT))),
               "plain_ms": device_ms(rotated(lambda x, w: rmsnorm_plain(x, w, RN_DEFAULT))),
               "library_ms": device_ms(rotated(
                   lambda x, w: F.rms_norm(x, (1600,), w, eps=1e-6))),
               "point": RN_DEFAULT, "shape": [rows, 1600], "input_pool": n_pool,
               "l2_bytes": l2}
        row["bound_ms"], row["bound_by"] = bound(4.0 * rows * 1600,
                                                 4.0 * (2 * rows * 1600 + 1600))
        rec[f"{rows}x1600"] = row
        print(f"rmsnorm at {row['shape']}: {row['ms']:.4f} ms (bound {row['bound_ms']:.5f} ms, "
              f"{row['bound_by']}); plain {row['plain_ms']:.4f} ms; library "
              f"{row['library_ms']:.4f} ms (graph replays over a pool of {n_pool} inputs; "
              f"L2 {l2 / 2**20:.0f} MiB)")
        del pool
    out["rmsnorm"]["recurrent_shapes"] = rec
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


def time_bf16(dev, gen, bf16_report) -> dict:
    """The bf16 matmul and attention at each of the bf16 phase's handle
    shapes (handle_specs over BF16_RUNS), at the point that
    model's handle served last (DEFAULT_POINT, or the step programs'
    (512, 512) blocks, without the bf16 phase), beside PR 21's mma.sync
    kernels at the same points (``mma_ms``: the ``_bf16_mma`` symbols,
    launched through the library as the wrapper would), the plain
    version, one library call and the bound at the bf16 tensor cores'
    rate; and rmsnorm on bf16 at the bf16 phase's rows and widths. The
    library calls: ``torch.mm`` with an fp32 output (``out_dtype``), as
    the kernel writes; ``scaled_dot_product_attention`` on the same bf16
    q, k and v (``enable_gqa``); ``F.rms_norm`` on the same bf16 input.
    Device times from CUDA-graph replays."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention import attention as attn_mod
    from repro_torch.kernels.attention.attention import (
        flash_attention_cuda, flash_attention_plain)
    from repro_torch.kernels.matmul import matmul as mm_mod
    from repro_torch.kernels.matmul.matmul import matmul_cuda, matmul_plain
    from repro_torch.kernels.matmul.ops import DEFAULT_POINT as MM_DEFAULT
    from repro_torch.kernels.rmsnorm.ops import DEFAULT_POINT as RN_DEFAULT
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda, rmsnorm_plain

    bf16 = torch.bfloat16
    mm_lib, at_lib = mm_mod.build_kernels(dev), attn_mod.build_kernels(dev)
    served = {}
    for arch, r in ((bf16_report or {}).get("runs") or {}).items():
        served[arch] = {n: k["best_point"] for n, k in r["requests"][-1]["kernels"].items()}

    def mm_mma(a, b, point):
        """PR 21's kernel at ``point``: the mma path's symbol"""
        M, K = a.shape
        N = b.shape[1]
        c = torch.empty((M, N), dtype=torch.float32, device=dev)
        mm_lib.launch(mm_mod.symbol(point, bf16, "mma"), a.data_ptr(), b.data_ptr(),
                      c.data_ptr(), M, N, K, mm_mod._ORDERS[point.get("order", "mn")],
                      int(bool(point.get("scratch", 1))), int(point.get("lookahead", 1)),
                      torch.cuda.current_stream(dev).cuda_stream)
        return c

    def at_mma(q, k, v, point):
        B, Tq, H, Dh = q.shape
        _, Tkv, Hk, _ = k.shape
        o = torch.empty_like(q)
        at_lib.launch(attn_mod.symbol(point, Tq, Tkv, Dh, bf16, "mma"), q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Tq, Tkv, H, Hk, 1, 0,
                      Dh ** -0.5, int(point.get("lookahead", 1)),
                      torch.cuda.current_stream(dev).cuda_stream)
        return o

    out = {"matmul": {}, "attention": {}, "rmsnorm": {}}
    for label, spec in handle_specs("matmul", BF16_RUNS, torch.bfloat16):
        M, N, K = spec["M"], spec["N"], spec["K"]
        a = torch.randn(M, K, generator=gen, device=dev).to(bf16)
        b = torch.randn(K, N, generator=gen, device=dev).to(bf16)
        point = served.get(label.split()[0], {}).get("matmul") or MM_DEFAULT
        lib_name = "torch.mm(out_dtype=float32)"
        row = {"ms": device_ms(lambda: matmul_cuda(a, b, point), reps=5),
               "default_ms": device_ms(lambda: matmul_cuda(a, b, MM_DEFAULT), reps=5),
               "mma_ms": device_ms(lambda: mm_mma(a, b, point), reps=5),
               "mma_default_ms": device_ms(lambda: mm_mma(a, b, MM_DEFAULT), reps=5),
               "plain_ms": device_ms(lambda: matmul_plain(a, b, point), reps=5),
               "library_ms": device_ms(lambda: torch.mm(a, b, out_dtype=torch.float32),
                                       reps=5), "library": lib_name,
               "path": mm_mod.path(a, b), "point": point, "shape": [M, N, K]}
        row["bound_ms"], row["bound_by"] = bound(2.0 * M * N * K,
                                                 2.0 * (M * K + K * N) + 4.0 * M * N, bf16=True)
        out["matmul"][label] = row
        print(f"matmul bf16, {label} {row['shape']} (M, N, K): {row['ms']:.4f} ms at {point}, "
              f"{row['default_ms']:.4f} at DEFAULT_POINT ({row['path']}); PR 21's mma.sync "
              f"kernel {row['mma_ms']:.4f}, {row['mma_default_ms']:.4f}; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}, bf16 tensor cores); plain "
              f"{row['plain_ms']:.4f} ms; {lib_name} {row['library_ms']:.4f} ms")
        del a, b
    for label, spec in handle_specs("attention", BF16_RUNS, torch.bfloat16):
        B, T, H, Hk, Dh = spec["B"], spec["Tq"], spec["H"], spec["Hk"], spec["Dh"]
        q = torch.randn(B, T, H, Dh, generator=gen, device=dev).to(bf16)
        k = torch.randn(B, T, Hk, Dh, generator=gen, device=dev).to(bf16)
        v = torch.randn(B, T, Hk, Dh, generator=gen, device=dev).to(bf16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        step_point = {"block_q": min(512, T), "block_kv": min(512, T)}
        point = served.get(label.split()[0], {}).get("attention") or step_point
        row = {"ms": device_ms(lambda: flash_attention_cuda(q, k, v, point)),
               "untuned_ms": device_ms(lambda: flash_attention_cuda(q, k, v, step_point)),
               "mma_ms": device_ms(lambda: at_mma(q, k, v, point)),
               "mma_untuned_ms": device_ms(lambda: at_mma(q, k, v, step_point)),
               "plain_ms": device_ms(lambda: flash_attention_plain(q, k, v, point)),
               "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True)),
               "library": "scaled_dot_product_attention (bf16)",
               "path": attn_mod.path(q, k, v), "point": point, "untuned_point": step_point,
               "shape": [B, T, H, Hk, Dh]}
        row["bound_ms"], row["bound_by"] = bound(
            4.0 * B * H * T * T * Dh * 0.5, 2.0 * (2 * B * T * H + 2 * B * T * Hk) * Dh,
            bf16=True)
        out["attention"][label] = row
        print(f"attention bf16, {label} {row['shape']} (B, T, H, Hk, Dh): {row['ms']:.4f} ms "
              f"at {point}, {row['untuned_ms']:.4f} at {step_point} ({row['path']}); PR 21's "
              f"mma.sync kernel {row['mma_ms']:.4f}, {row['mma_untuned_ms']:.4f}; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}, bf16 tensor cores); plain "
              f"{row['plain_ms']:.4f} ms; SDPA {row['library_ms']:.4f} ms (graph replays)")
        del q, k, v, qt, kt, vt
    # rmsnorm on bf16 at the bf16 phase's widths (deepseek-7b's d 4096,
    # qwen3-moe's 2048), prefill's B T rows and decode's B, at the step
    # programs' DEFAULT_POINT. A prefill row's replays rotate over a pool
    # of inputs larger than the L2, so its input comes from HBM, as the
    # byte bound assumes (as for the fp32 rows at d 1600)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    widths = {}
    for arch, batch, prompt, _, _ in BF16_RUNS:
        from repro_torch.configs import get_config
        widths.setdefault(get_config(arch).d_model, (arch, batch, prompt))
    for d, (arch, batch, prompt) in widths.items():
        for rows in (batch * prompt, batch):
            nbytes = 2 * rows * d
            n_pool = -(-3 * l2 // nbytes) if nbytes * 1000 > l2 else 1
            pool = [(torch.randn(rows, d, generator=gen, device=dev).to(bf16),
                     torch.randn(d, generator=gen, device=dev).to(bf16))
                    for _ in range(n_pool)]

            def rotated(fn, pool=pool, n_pool=n_pool):
                turn = itertools.count()
                return lambda: fn(*pool[next(turn) % n_pool])

            row = {"ms": device_ms(rotated(lambda x, w: rmsnorm_cuda(x, w, RN_DEFAULT))),
                   "plain_ms": device_ms(rotated(
                       lambda x, w: rmsnorm_plain(x, w, RN_DEFAULT))),
                   "library_ms": device_ms(rotated(
                       lambda x, w, d=d: F.rms_norm(x, (d,), w, eps=1e-6))),
                   "library": "F.rms_norm (bf16)", "point": RN_DEFAULT,
                   "shape": [rows, d], "arch": arch, "input_pool": n_pool, "l2_bytes": l2}
            row["bound_ms"], row["bound_by"] = bound(4.0 * rows * d, 2.0 * (2 * rows * d + d))
            out["rmsnorm"][f"{rows}x{d}"] = row
            print(f"rmsnorm bf16, {arch} {row['shape']}: {row['ms']:.5f} ms (bound "
                  f"{row['bound_ms']:.5f} ms, {row['bound_by']}); plain {row['plain_ms']:.4f} "
                  f"ms; F.rms_norm {row['library_ms']:.5f} ms (graph replays over a pool of "
                  f"{n_pool} inputs)")
            del pool
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
    # the dist phase's host traces run beside everything else
    dist_procs = start_dist_traces() if "dist" in only else None
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
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

    # the host-timed paths (Table 3's wall clock, host-bound decode) run
    # with the dist phase's host traces held
    hold_dist_traces(dist_procs, True)

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
        serve_report = report["serve"] = run_serve(dev)
        torch.cuda.empty_cache()
        save()
    if "warm" in only:
        if serve_report is None:
            fail("the warm phase starts from the serve phase's registry: add 'serve'")
        report["warm"] = run_warm(serve_report)
        save()

    if "profile" in only:
        report["profile"] = profile_serve(dev)
        torch.cuda.empty_cache()
        save()

    # -- 3b. the rest of the front door: quickstart, Table 4, the process
    #        backend, the reduced serve example ------------------------------
    front_report = None
    if "front" in only:
        front_report = report["front"] = run_front(dev)
        torch.cuda.empty_cache()
        save()

    # -- 3c. the MoE, VLM and encoder-decoder families at full width -------
    families_report = None
    if "families" in only:
        families_report = report["families"] = run_families(dev)
        torch.cuda.empty_cache()
        save()

    # -- 3d. the hybrid and RWKV families, whole, at full width -----------
    recurrent_report = None
    if "recurrent" in only:
        recurrent_report = report["recurrent"] = run_recurrent(dev)
        torch.cuda.empty_cache()
        save()

    # -- 3e. serving in bf16: deepseek-7b and qwen3-moe whole --------------
    bf16_report = None
    if "bf16" in only:
        bf16_report = report["bf16"] = run_bf16(dev)
        torch.cuda.empty_cache()
        save()

    hold_dist_traces(dist_procs, False)

    # -- 4. each kernel against its plain version ---------------------------
    if "check" in only:
        report["checks"] = {
            "euclid": check_euclid(lib, dev, gen),
            "matmul": check_matmul(libs["matmul"], dev, gen),
            "attention": check_attention(libs["attention"], dev, gen),
            "rmsnorm": check_rmsnorm(libs["rmsnorm"], dev, gen),
            "rmsnorm_grad": check_rmsnorm_grad(dev, gen),
            "attention_grad_wiring": check_attention_grad_wiring(dev, gen),
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

    # -- 5. the third path: LM training, and where its step's time goes ----
    train_report = None
    if "train" in only:
        report["model_grads"] = check_model_grads(dev)
        torch.cuda.empty_cache()
        save()
        train_report = report["train"] = run_train(dev)
        torch.cuda.empty_cache()
        save()
        report["train_profile"] = profile_train(
            dev, train_report["runs"][-1]["autotune"]["active_point"])
        torch.cuda.empty_cache()
        save()

    # -- 5b. the distributed and launch layer on a 1 x 1 mesh ---------------
    dist_report = None
    if "dist" in only:
        dist_report = report["dist"] = run_dist(dev, dist_procs, train_report)
        torch.cuda.empty_cache()
        save()

    # -- 6. times at the main paths' shapes ---------------------------------
    if "time" in only:
        report["euclid_times"] = time_euclid(rows, dev, gen)
        report["times"] = time_lm(libs, dev, gen, serve_report)
        report["times_bf16"] = time_bf16(dev, gen, bf16_report)
        save()

    if only != set(PHASES):
        save()
        print(f"chip_smoke: {report['seconds']:.1f} s in all, the builds "
              f"{report['builds']['wall_s']:.1f} s of it")
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
         "by_input": report["euclid_times"],
         "front_launches": report["front"]["launches"]["euclid"]},
        {"name": "lintra", "route": "triton", "source": LINTRA_SRC,
         "replaces": LINTRA_TPU, "launches": launches["lintra"],
         "max_abs_err": checks["lintra"]["max_abs_err"], "ms": lt["oat_ms"],
         "plain_ms": lt["plain_ms"], "bound_ms": l_bound, "bound_by": l_by,
         "library_ms": lt["library_ms"], "default_ms": lt["default_ms"],
         "bsat_ms": lt["bsat_ms"], "point": l_oat, "bsat_point": lr["bsat_point"],
         "shape": [H, W, B], "checks": checks["lintra"]["checks"],
         "bytes_per_s": l_bytes / (lt["oat_ms"] * 1e-3),
         "working_set_fits_l2": l_bytes <= l2_bytes,
         "front_launches": report["front"]["launches"]["lintra"]},
    ]
    serve_launches = serve_report["launches"]
    train_launches = train_report["runs"][0]["launches"]
    for name, key, src, tpu, tol in (
            ("matmul", "matmul", MATMUL_SRC, MATMUL_TPU, MATMUL_TOL),
            ("rmsnorm", "rmsnorm", RMSNORM_SRC, RMSNORM_TPU, RMSNORM_TOL),
            ("flash_attention", "attention", ATTENTION_SRC, ATTENTION_TPU,
             ATTENTION_TOL)):
        t, chk = lm[key], checks[key]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": serve_launches[name],
                 "train_launches": train_launches[name],
                 "max_abs_err": chk["max_abs_err"], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "point": t["point"], "shape": t["shape"], "checks": chk["checks"],
                 "tolerance": tol, "tol_used": chk["tol_used"]}
        entry.update({k: v for k, v in t.items() if k.endswith("_ms")
                      and k not in entry})
        if name == "rmsnorm":
            entry["decode_shape"] = t["decode_shape"]
            entry["recurrent_shapes"] = t["recurrent_shapes"]
            entry["launches_by_rows"] = serve_report["rmsnorm_launches_by_rows"]
        if name == "flash_attention":
            entry["by_head_dim"] = t["by_head_dim"]
            entry["families_shapes"] = t["families"]
            entry["checks_by_head_dim"] = chk["checks_by_head_dim"]
            entry["front_launches_by_head_dim"] = front_report["attention_launches_by_head_dim"]
            entry["families_launches_by_head_dim"] = \
                families_report["attention_launches_by_head_dim"]
            entry["tf32_control_dh64_tol_used"] = chk["tf32_tol_used_dh64"]
        else:
            entry["families_launches"] = families_report["launches"][name]
        entry["recurrent_launches"] = recurrent_report["launches"][name]
        entry["dist_launches"] = {kind: dist_report[kind]["launches"][name]
                                  for kind in ("train", "prefill")}
        entry["front_launches"] = front_report["launches"][name]
        if "tf32_max_abs_err" in chk:
            entry["tf32_control_max_abs_err"] = chk["tf32_max_abs_err"]
            entry["tf32_control_tol_used"] = chk["tf32_tol_used"]
        if f"{key}_grad" in checks:
            grad = checks[f"{key}_grad"]
            entry["grad_max_abs_err"] = grad["max_abs_err"]
            entry["grad_checks"] = grad["checks"]
        entry["bf16_launches"] = bf16_report["launches_bf16"][name]
        kernels.append(entry)
    # the bf16 input class: launches from the bf16 phase's run, times at
    # deepseek-7b's handle shape, every shape in by_shape
    for name, key, src, tpu, tol in (
            ("matmul_bf16", "matmul", MATMUL_SRC, MATMUL_TPU, MATMUL_TOL),
            ("flash_attention_bf16", "attention", ATTENTION_SRC, ATTENTION_TPU,
             ATTENTION_BF16_TOL)):
        rows_bf16, chk = report["times_bf16"][key], checks[key]["bf16"]
        t = next(iter(rows_bf16.values()))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": bf16_report["launches_bf16"][name.removesuffix("_bf16")],
            "max_abs_err": chk["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t["library"], "point": t["point"],
            "shape": t["shape"], "checks": chk["checks"], "tolerance": tol,
            "tol_used": chk["tol_used"], "by_shape": rows_bf16,
            "controls_tol_used": {k: v for k, v in chk.items()
                                  if k.startswith(("fp8_control", "unblocked"))},
            "launches_by_arch": {a: r["launches_by_dtype"] for a, r in
                                 bf16_report["runs"].items()},
            # the wgmma kernel's time beside PR 21's mma.sync kernel at the
            # same point, the launches by path and the checks on each path
            "path": t["path"], "mma_ms": t["mma_ms"],
            "launches_by_path": bf16_report["launches_by_path"][
                name.removesuffix("_bf16")],
            "checks_by_path": chk["checks_by_path"],
            "sass": report["builds"]["wgmma_sass"][key]})
    # rmsnorm's bf16 instantiations (not redesigned): the bf16 phase's
    # launches, times at deepseek-7b's prefill rows
    rows_rn = report["times_bf16"]["rmsnorm"]
    t, chk = next(iter(rows_rn.values())), checks["rmsnorm"]["by_type"]["bfloat16"]
    kernels.append({
        "name": "rmsnorm_bf16", "route": "cuda", "source": RMSNORM_SRC,
        "replaces": RMSNORM_TPU, "launches": bf16_report["launches_bf16"]["rmsnorm"],
        "max_abs_err": chk["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "library": t["library"], "point": t["point"],
        "shape": t["shape"], "checks": chk["checks"], "tolerance": RMSNORM_BF16_TOL,
        "tol_used": chk["tol_used"], "by_shape": rows_rn})
    report["kernels"] = kernels
    save()
    print(f"chip_smoke: {report['seconds']:.1f} s in all, the builds "
          f"{report['builds']['wall_s']:.1f} s of it")
    print(card)
    print(json.dumps({"kernels": kernels}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
