"""Fused RMSNorm kernel for Hopper (fp32 statistics, one read per element).

Mirrors ``repro/kernels/rmsnorm/rmsnorm.py``: ``rmsnorm_cuda`` takes the
place of ``rmsnorm_pallas``, with the same tuning point:

  block_rows — the most rows one block holds (the coldUF analogue); the
               grid is never smaller than the blocks the card holds
               resident (or N)
  lookahead  — rows in flight ahead of the one reduced (a ring of
               ``lookahead + 1`` shared-memory row buffers)

The kernel is CUDA C++ (``csrc/rmsnorm.cuh``; its header comment is the
design note: what it replaces, what bounds it, what the design does about
that). Each ring depth and input type is a kernel of its own; the
exported launcher of each ``block_rows`` option picks one, all built
once into one shared library; generating a variant resolves its symbol.

``rmsnorm_plain`` is the same function in plain PyTorch. The wrapper uses
it only for tensors on the CPU; on a CUDA tensor it launches the kernel
or raises.

``RMSNormFunction`` makes the kernel differentiable: its forward is
``rmsnorm_cuda`` at ``DEFAULT_POINT``, its backward the rmsnorm gradient
in plain PyTorch. The reference differentiates its jnp body, and the
Pallas kernel has no backward, so no hand backward kernel is owed.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Any

import torch

from repro_torch.core.profiles import device_sm_count
from repro_torch.interop import resolve_device
from repro_torch.kernels._build import KernelLibrary, load_family
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

Point = dict[str, Any]

CSRC = Path(__file__).with_name("csrc")

#: the ``block_rows`` options, one instantiation each (and per type)
BLOCK_ROWS = (8, 32, 128, 512)

#: the point the model's layers launch at (the reference's jnp body has
#: no knob); the catalog's default point too
DEFAULT_POINT: Point = {"block_rows": 128, "lookahead": 1}

#: input type -> (symbol tag, C type)
_TYPES = {torch.float32: ("f32", "float"),
          torch.bfloat16: ("bf16", "__nv_bfloat16")}

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def smem_bytes(point: Point, d: int, dtype_bytes: int = 4) -> int:
    """Shared memory of one block at ``point`` (``rmsnorm::smem_bytes``):
    ``lookahead + 1`` ring buffers and the weight, each a row of ``d``
    elements rounded up to 16 bytes, and 8 floats for the reduction."""
    row = -(-d * dtype_bytes // 16) * 16
    return (int(point.get("lookahead", 1)) + 2) * row + 8 * 4


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
    the launch in ``rmsnorm_cuda.launches`` (and, by its number of rows,
    in ``rmsnorm_cuda.launches_by_rows``; by its type in
    ``rmsnorm_cuda.launches_by_dtype``). On CPU tensors: the plain
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
    lookahead = int(point.get("lookahead", 1))
    if lookahead not in (0, 1, 2):
        raise ValueError(f"lookahead {lookahead}: the kernel takes 0, 1 or 2")
    if lib is None:
        lib = build_kernels(x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib.launch(symbol(point, x.dtype), x.data_ptr(), w.data_ptr(),
               out.data_ptr(), N, d, float(eps), lookahead,
               device_sm_count(x.device.index), stream)
    rmsnorm_cuda.launches += 1
    by_rows = rmsnorm_cuda.launches_by_rows
    by_rows[N] = by_rows.get(N, 0) + 1
    by_type = rmsnorm_cuda.launches_by_dtype
    name = str(x.dtype).removeprefix("torch.")
    by_type[name] = by_type.get(name, 0) + 1
    return out


rmsnorm_cuda.launches = 0
rmsnorm_cuda.launches_by_rows = {}
#: by input type ("float32", "bfloat16")
rmsnorm_cuda.launches_by_dtype = {}


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, point: Point, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch (any device).

    Rows are independent, so ``block_rows`` does not change the result:
    every row is the oracle's (fp32 statistics, x's output type).
    """
    del point
    return rmsnorm_ref(x, w, eps)


class RMSNormFunction(torch.autograd.Function):
    """``rmsnorm_cuda`` at ``DEFAULT_POINT`` under autograd: (N, d) rows,
    (d,) weight, ``eps``.

    Forward: the hand kernel on a CUDA tensor (the plain version on the
    CPU), and the rows' fp32 ``rstd`` for the backward. Backward, in
    plain PyTorch with fp32 statistics, with ``x̂ = x·rstd`` and
    ``g' = g·w``: ``dx = rstd·(g' − x̂·mean(g'·x̂))`` and
    ``dw = Σ_rows g·x̂``. Saves only ``x``, ``w`` and ``rstd``.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
        y = rmsnorm_cuda(x, w, DEFAULT_POINT, eps=eps)
        x32 = x.to(torch.float32)
        rstd = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w, rstd = ctx.saved_tensors
        xhat = x.to(torch.float32) * rstd
        g32 = g.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            gw = g32 * w.to(torch.float32)
            dx = (rstd * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
                  ).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.sum(g32 * xhat, dim=0).to(w.dtype)
        return dx, dw, None


__all__ = ["BLOCK_ROWS", "DEFAULT_POINT", "RMSNormFunction", "build_kernels",
           "instantiations", "rmsnorm_cuda", "rmsnorm_plain", "smem_bytes", "symbol"]
