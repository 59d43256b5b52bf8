"""Fused RMSNorm kernel for Hopper (row-tiled, fp32 statistics).

Mirrors ``repro/kernels/rmsnorm/rmsnorm.py``: ``rmsnorm_cuda`` takes the
place of ``rmsnorm_pallas``, with the same tuning point (``block_rows``
— rows per block, the coldUF analogue; ``lookahead`` — inert).

The kernel is CUDA C++ (``csrc/rmsnorm.cuh``; its header comment is the
design note: what it replaces, what bounds it, what the design does about
that). ``block_rows`` is a template parameter, one instantiation per
option and input type, all built once into one shared library; generating
a variant resolves its symbol.

``rmsnorm_plain`` is the same function in plain PyTorch. The wrapper uses
it only for tensors on the CPU; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Any

import torch

from repro_torch.interop import resolve_device
from repro_torch.kernels._build import KernelLibrary, load_family
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

Point = dict[str, Any]

CSRC = Path(__file__).with_name("csrc")

#: the ``block_rows`` options, one instantiation each (and per type)
BLOCK_ROWS = (8, 32, 128, 512)

#: input type -> (symbol tag, C type)
_TYPES = {torch.float32: ("f32", "float"),
          torch.bfloat16: ("bf16", "__nv_bfloat16")}

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def symbol(point: Point, dtype: torch.dtype) -> str:
    """Exported C name of the instantiation that serves ``point``."""
    return f"rmsnorm_r{int(point['block_rows'])}_{_TYPES[dtype][0]}"


def instantiations() -> dict[str, str]:
    """Symbol -> instantiation line of every point and type."""
    return {symbol({"block_rows": r}, dt): f"RMSNORM_INSTANTIATE({r}, {tag}, {ctype})"
            for r in BLOCK_ROWS for dt, (tag, ctype) in _TYPES.items()}


def build_kernels(device: "torch.device | str | None" = None) -> KernelLibrary:
    """Build (once) and load every instantiation. Set-up: the first call
    runs nvcc (its seconds are in ``.build_s``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the rmsnorm kernel builds for a CUDA device, not {dev}")
    return _library()


@functools.cache
def _library() -> KernelLibrary:
    # memoised: every norm of a step launches through the wrapper, which
    # asks for the library each time
    return load_family("rmsnorm", CSRC, "rmsnorm.cuh", instantiations(), _ARGTYPES)


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, point: Point, *,
                 eps: float = 1e-6, lib: KernelLibrary | None = None) -> torch.Tensor:
    """(N, d) rows, (d,) weight -> (N, d) normalized rows, in x's type.

    On CUDA tensors: checks the arguments, launches the instantiation for
    ``point`` on the current stream, checks the launch status and counts
    the launch in ``rmsnorm_cuda.launches``. On CPU tensors: the plain
    version.
    """
    if not x.is_cuda:
        return rmsnorm_plain(x, w, point, eps=eps)
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.dtype not in _TYPES or w.dtype != x.dtype:
        raise TypeError(
            f"rmsnorm_cuda takes float32 or bfloat16 x and a weight of the "
            f"same type, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(
            f"expected x (N, d) and w (d,), got {tuple(x.shape)}, {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_cuda takes contiguous tensors")
    N, d = x.shape
    if min(N, d) < 1 or N * d >= 2**62 or d >= 2**31 or N >= 2**31:
        raise ValueError(f"unsupported shape N={N} d={d}")
    if lib is None:
        lib = build_kernels(x.device)
    out = torch.empty_like(x)
    vec4 = int(x.dtype == torch.float32 and d % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in (x, w, out)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib.launch(symbol(point, x.dtype), x.data_ptr(), w.data_ptr(),
               out.data_ptr(), N, d, float(eps), vec4, stream)
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, point: Point, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch (any device).

    Rows are independent, so ``block_rows`` does not change the result:
    every row is the oracle's (fp32 statistics, x's output type).
    """
    del point
    return rmsnorm_ref(x, w, eps)


__all__ = ["BLOCK_ROWS", "build_kernels", "instantiations", "rmsnorm_cuda",
           "rmsnorm_plain", "symbol"]
