"""Tiled fp32 matmul kernel for Hopper with an auto-tunable variant space.

Mirrors ``repro/kernels/matmul/matmul.py``: ``matmul_cuda`` takes the
place of ``matmul_pallas``, with the same tuning point:

  block_m   — rows per block                    (coldUF: grid coarsening)
  block_n   — columns per block                 (vectLen)
  block_k   — reduction chunk per loop step
  unroll    — independent sub-accumulators within block_k (hotUF)
  order     — "mn" | "nm" block-id-to-tile mapping (IS)
  scratch   — 1: accumulate in registers, store once
              0: read-modify-write the output tile after every chunk
  lookahead — inert (the chunk loop does not prefetch)

The kernel is CUDA C++ (``csrc/matmul.cuh``; its header comment is the
design note). ``block_m``, ``block_n``, ``block_k`` and ``unroll`` are
template parameters, one instantiation per combination (108), all built
once into one shared library; ``order``, ``scratch`` and ``lookahead``
are run-time arguments. Generating a variant resolves its symbol.

``matmul_plain`` is the same function in plain PyTorch, chunk for chunk
and partial for partial. The wrapper uses it only for tensors on the
CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from pathlib import Path
from typing import Any

import torch

from repro_torch.interop import resolve_device
from repro_torch.kernels._build import KernelLibrary, load_family

Point = dict[str, Any]

CSRC = Path(__file__).with_name("csrc")

#: the template parameters of one instantiation, in symbol order
PHASE1 = ("block_m", "block_n", "block_k", "unroll")
#: the options each template parameter is instantiated for
OPTIONS = {"block_m": (64, 128, 256, 512), "block_n": (128, 256, 512),
           "block_k": (128, 256, 512), "unroll": (1, 2, 4)}

#: shared memory of one block (csrc/matmul.cuh ``kSmemBytes``): one 64x32
#: slice of A and one 32x64 slice of B, rows padded by 4 floats
SMEM_BYTES = 4 * 2 * 32 * (64 + 4)

_ORDERS = {"mn": 0, "nm": 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def symbol(point: Point) -> str:
    """Exported C name of the instantiation that serves ``point``."""
    bm, bn, bk, u = (int(point[k]) for k in PHASE1)
    return f"matmul_bm{bm}_bn{bn}_bk{bk}_u{u}"


def instantiations() -> dict[str, str]:
    """Symbol -> instantiation line of every valid phase-1 combination."""
    out = {}
    for combo in itertools.product(*(OPTIONS[k] for k in PHASE1)):
        point = dict(zip(PHASE1, combo))
        if point["block_k"] % point["unroll"] == 0:
            out[symbol(point)] = f"MATMUL_INSTANTIATE({', '.join(map(str, combo))})"
    return out


def build_kernels(device: "torch.device | str | None" = None) -> KernelLibrary:
    """Build (once) and load every instantiation. Set-up: the first call
    runs nvcc (its seconds are in ``.build_s``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the matmul kernel builds for a CUDA device, not {dev}")
    return _library()


@functools.cache
def _library() -> KernelLibrary:
    # memoised: the wrapper asks for it on every launch given no library,
    # and listing the 108 instantiations costs more host time than the
    # lookup should
    return load_family("matmul", CSRC, "matmul.cuh", instantiations(), _ARGTYPES)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, point: Point, *,
                lib: KernelLibrary | None = None) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) fp32.

    On CUDA tensors: checks the arguments, launches the instantiation for
    ``point`` on the current stream, checks the launch status and counts
    the launch in ``matmul_cuda.launches``. On CPU tensors: the plain
    version.
    """
    if not a.is_cuda:
        return matmul_plain(a, b, point)
    if b.device != a.device:
        raise ValueError(f"a on {a.device} but b on {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"matmul_cuda takes float32, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"expected a (M, K) and b (K, N), got {tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_cuda takes contiguous tensors")
    M, K = a.shape
    N = b.shape[1]
    if min(M, N, K) < 1 or max(M * K, K * N, M * N) >= 2**62 or max(M, N, K) >= 2**31:
        raise ValueError(f"unsupported shape M={M} N={N} K={K}")
    if lib is None:
        lib = build_kernels(a.device)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    lib.launch(symbol(point), a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
               _ORDERS[point.get("order", "mn")], int(bool(point.get("scratch", 1))),
               stream)
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0


def matmul_plain(a: torch.Tensor, b: torch.Tensor, point: Point) -> torch.Tensor:
    """The kernel's function in plain PyTorch (any device).

    Chunk for chunk what ``_mm_kernel`` and the CUDA kernel compute:
    ``ceil(K / block_k)`` chunks (the last masked), each split into
    ``unroll`` sub-chunks whose partial products are summed in order into
    the chunk total, which is added to the accumulator.
    """
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    M, K = a.shape
    N = b.shape[1]
    bk = int(point["block_k"])
    unroll = int(point.get("unroll", 1))
    sub = bk // unroll
    acc = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    for kc in range(math.ceil(K / bk)):
        total = None
        for u in range(unroll):
            lo = kc * bk + u * sub
            hi = min(lo + sub, K)
            part = (a[:, lo:hi] @ b[lo:hi, :] if lo < K
                    else torch.zeros_like(acc))
            total = part if total is None else total + part
        acc = acc + total
    return acc


__all__ = ["OPTIONS", "PHASE1", "SMEM_BYTES", "build_kernels", "instantiations",
           "matmul_cuda", "matmul_plain", "symbol"]
