"""Squared euclidean distance kernel for Hopper (Streamcluster case study).

``dist[n, m] = sum_d (X[n, d] - C[m, d])**2`` — the paper's CPU-bound
kernel. Mirrors ``repro/kernels/euclid/euclid.py``: ``euclid_cuda`` takes
the place of ``euclid_pallas``, with the same tuning point:

  block_n   — points per block              (coldUF analogue)
  block_m   — centers per block
  block_d   — d-chunk staged per loop step  (vectLen)
  unroll    — independent partial accumulators inside block_d (hotUF)
  vectorize — 1: ||x||^2 + ||c||^2 - 2 x.c, x.c in 3xTF32 on the
                 tensor cores                             (VE=SIMD)
              0: diff-square-sum on the CUDA cores        (VE=SISD)
  order, scratch — phase-2 codegen options (IS/SM)
  lookahead — slices of x and c in flight ahead of the one computed (a
              ring of lookahead + 1 shared-memory stages; pld)

The kernel is CUDA C++ (``csrc/euclid.cuh``; its header comment is the
design note: what it replaces, what bounds it, what the design does
about that). The phase-1 knobs are template parameters, one
instantiation per point of the tuning space (and one kernel per ring
depth under it), all built once into one shared library; ``order``,
``scratch`` and ``lookahead`` are run-time arguments. Generating a
variant is resolving its instantiation's symbol: microseconds, like
deGoal's code generation.

``euclid_plain`` is the same function in plain PyTorch, chunk for chunk
and partial for partial. The wrapper uses it only for tensors on the
CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Any, Sequence

import torch

from repro_torch.core.profiles import device_sm_count
from repro_torch.kernels._build import KernelLibrary, load_family

Point = dict[str, Any]

CSRC = Path(__file__).with_name("csrc")

#: the template parameters of one instantiation, in symbol order
PHASE1 = ("block_n", "block_m", "block_d", "unroll", "vectorize")

_ORDERS = {"nm": 0, "mn": 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def smem_bytes(point: Point) -> int:
    """Shared memory of one block at ``point`` (``euclid::stage_bytes``):
    ``lookahead + 1`` ring stages, each a slice of the pass tile's x rows
    (``min(block_n, 128)``) and c rows (``min(block_m, 64)``),
    ``min(block_d, 64)`` deep, rows padded by 4 floats."""
    rows = min(int(point["block_n"]), 128) + min(int(point["block_m"]), 64)
    stage = 4 * rows * (min(int(point["block_d"]), 64) + 4)
    return (int(point.get("lookahead", 1)) + 1) * stage


def symbol(point: Point) -> str:
    """Exported C name of the instantiation that serves ``point``."""
    bn, bm, bd, u, v = (int(point[k]) for k in PHASE1)
    return f"euclid_bn{bn}_bm{bm}_bd{bd}_u{u}_v{v}"


def instantiations(points: Sequence[tuple[int, ...]]) -> dict[str, str]:
    """Symbol -> instantiation line of each phase-1 tuple (in
    :data:`PHASE1` order)."""
    return {symbol(dict(zip(PHASE1, p))): f"EUCLID_INSTANTIATE({', '.join(map(str, p))})"
            for p in points}


@functools.lru_cache(maxsize=None)
def load_library(points: tuple[tuple[int, ...], ...], *,
                 n_units: int = 16) -> KernelLibrary:
    """Build (once per process and source hash) and load the instantiations
    of ``points`` (phase-1 tuples in :data:`PHASE1` order; each holds three
    kernels, one per ring depth, so 16 units spread up to 648). Memoised: the
    wrapper calls it on every launch that is given no library, and
    listing the instantiations again would cost more host time than the
    kernel takes on the card."""
    return load_family("euclid", CSRC, "euclid.cuh", instantiations(points),
                       _ARGTYPES, n_units=n_units)


def euclid_cuda(x: torch.Tensor, c: torch.Tensor, point: Point, *,
                lib: KernelLibrary | None = None) -> torch.Tensor:
    """(N, D) points x (M, D) centers -> (N, M) fp32 squared distances.

    On CUDA tensors: checks the arguments, launches the instantiation for
    ``point`` on the current stream, checks the launch status and counts
    the launch in ``euclid_cuda.launches``. On CPU tensors: the plain
    version. ``lib`` defaults to the library built for the card's tuning
    space (:func:`repro_torch.kernels.euclid.ops.build_kernels`).
    """
    if not x.is_cuda:
        return euclid_plain(x, c, point)
    if c.device != x.device:
        raise ValueError(f"x on {x.device} but c on {c.device}")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"euclid_cuda takes float32, got {x.dtype}, {c.dtype}")
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(
            f"expected x (N, D) and c (M, D), got {tuple(x.shape)}, {tuple(c.shape)}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("euclid_cuda takes contiguous tensors")
    N, D = x.shape
    M = c.shape[0]
    if min(N, M, D) < 1 or max(N, M, D) >= 2**31:
        raise ValueError(f"unsupported shape N={N} M={M} D={D}")
    lookahead = int(point.get("lookahead", 1))
    if lookahead not in (0, 1, 2):
        raise ValueError(f"lookahead {lookahead}: the kernel takes 0, 1 or 2")
    if lib is None:
        from repro_torch.kernels.euclid.ops import build_kernels
        lib = build_kernels(x.device)
    order = _ORDERS[point.get("order", "nm")]
    scratch = int(bool(point.get("scratch", 1)))
    out = torch.empty((N, M), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib.launch(symbol(point), x.data_ptr(), c.data_ptr(), out.data_ptr(), N, M, D,
               order, scratch, lookahead, device_sm_count(x.device.index), stream)
    euclid_cuda.launches += 1
    return out


euclid_cuda.launches = 0


def euclid_plain(x: torch.Tensor, c: torch.Tensor, point: Point) -> torch.Tensor:
    """The kernel's function in plain PyTorch (any device).

    Chunk for chunk what ``_euclid_kernel`` and the CUDA kernel compute:
    ``ceil(D / bd)`` chunks (the last zero-padded), each split into
    ``unroll`` sub-chunks whose partials are summed into the chunk total.
    """
    x = x.to(torch.float32)
    c = c.to(torch.float32)
    N, D = x.shape
    M = c.shape[0]
    bd = min(int(point["block_d"]), D)
    unroll = int(point.get("unroll", 1))
    vectorize = bool(point.get("vectorize", 1))
    n_d = math.ceil(D / bd)
    pad = n_d * bd - D
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        c = torch.nn.functional.pad(c, (0, pad))
    sub = bd // unroll
    out = torch.zeros((N, M), dtype=torch.float32, device=x.device)
    for kd in range(n_d):
        total = None
        for u in range(unroll):
            lo = kd * bd + u * sub
            xs, cs = x[:, lo:lo + sub], c[:, lo:lo + sub]
            if vectorize:
                xx = torch.sum(xs * xs, dim=-1, keepdim=True)
                cc = torch.sum(cs * cs, dim=-1, keepdim=True).T
                part = xx + cc - 2.0 * (xs @ cs.T)
            else:
                diff = xs[:, None, :] - cs[None, :, :]
                part = torch.sum(diff * diff, dim=-1)
            total = part if total is None else total + part
        out += total
    return out
