"""VIPS ``im_lintra_vec`` kernel for Hopper, in Triton (memory-bound study).

``y[h, w, band] = a[band] * x[h, w, band] + b[band]`` on the folded
layout ``(H, W*bands)``, a free reshape of ``(H, W, bands)``.

Replaces the Pallas TPU kernel ``lintra_pallas`` (``_lintra_kernel``,
``src/repro/kernels/lintra/lintra.py``), which takes ``ab = (tile(a),
tile(b))`` of shape ``(2, W*bands)``. This kernel computes the same
function without materialising ``ab``: ``BANDS`` is a compile-time
constant (the paper's specialised run-time constant) and each column
reads ``a[col % BANDS]`` and ``b[col % BANDS]``.

What bounds it on an H100: one read and one write of every element and
two operations per element, so device-memory bandwidth (3.35 TB/s). The
design is one fused pass of masked block loads and stores over
``block_h x block_w`` tiles (``block_w`` columns of contiguous memory per
row), ``unroll`` row strips per program, ``order`` mapping program ids to
tiles (``hw``: row-major, ``wh``: column-major). ``num_warps`` follows
the strip size. No shared-memory reuse and no tensor cores are needed,
which is why Triton's masked loads serve as well as CUDA C++ here. The
space's validator counts ``2*block_h*block_w + 2*block_w`` words against
the card's shared memory per block; the kernel stages nothing there, so
every point the validator admits launches.

Every point is its own binary: the point's keys are ``tl.constexpr``, so
generating a variant compiles it at run time, the nearest GPU match for
deGoal's run-time code generation. ``vectorize``, ``scratch`` and
``lookahead`` are inert, as they are in the Pallas kernel; they are kept
out of the compile key, so points that differ only in them share one
binary.

``lintra_plain`` is the same function in plain PyTorch. The wrapper
uses it only for tensors on the CPU; on a CUDA tensor it launches the
kernel or raises. This module imports without ``triton``: the compiler
is imported at the first compile.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
from pathlib import Path
from typing import Any, Iterator

import torch

from repro_torch.kernels._build import BUILD_DIR
from repro_torch.kernels.lintra.ref import lintra_ref_folded

Point = dict[str, Any]

#: ``triton.language``, bound by :func:`_triton` at the first compile so
#: that this module imports on machines without Triton
tl = None

_INT_ARGS = ("H", "WB", "n_h", "n_w")


def _lintra_kernel(x_ptr, a_ptr, b_ptr, y_ptr, H, WB, n_h, n_w,
                   BANDS: "tl.constexpr", BLOCK_H: "tl.constexpr",
                   BLOCK_W: "tl.constexpr", UNROLL: "tl.constexpr",
                   ORDER_HW: "tl.constexpr"):
    pid = tl.program_id(0)
    if ORDER_HW:
        ih = pid // n_w
        iw = pid % n_w
    else:
        iw = pid // n_h
        ih = pid % n_h
    cols = iw * BLOCK_W + tl.arange(0, BLOCK_W)
    cmask = cols < WB
    band = cols % BANDS
    a = tl.load(a_ptr + band, mask=cmask, other=0.0)
    b = tl.load(b_ptr + band, mask=cmask, other=0.0)
    # hotUF: UNROLL independent row strips per program
    for u in tl.static_range(UNROLL):
        rows = ih * BLOCK_H + u * (BLOCK_H // UNROLL) + tl.arange(0, BLOCK_H // UNROLL)
        mask = (rows[:, None] < H) & cmask[None, :]
        offs = rows[:, None] * WB + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0)
        tl.store(y_ptr + offs, x * a[None, :] + b[None, :], mask=mask)


def _triton():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton


@contextlib.contextmanager
def cold_triton_cache() -> Iterator[Path]:
    """Point Triton's on-disk cache at a new, empty directory under
    ``build/repro_torch/triton-cache/`` while the block runs, so every
    binary compiled inside it pays its whole compile. On exit the previous
    ``TRITON_CACHE_DIR`` is restored and the directory deleted (binaries
    already loaded stay usable)."""
    parent = BUILD_DIR / "triton-cache"
    parent.mkdir(parents=True, exist_ok=True)
    before = os.environ.get("TRITON_CACHE_DIR")
    with tempfile.TemporaryDirectory(dir=parent) as tmp:
        os.environ["TRITON_CACHE_DIR"] = tmp
        try:
            yield Path(tmp)
        finally:
            if before is None:
                os.environ.pop("TRITON_CACHE_DIR", None)
            else:
                os.environ["TRITON_CACHE_DIR"] = before


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def compile_key(point: Point, bands: int, WB: int) -> tuple:
    """The constants one binary is compiled for: BANDS, the tile, the
    strips, the order and the warps. Inert knobs are not part of it."""
    bh = int(point["block_h"])
    bw = min(int(point["block_w"]), _next_pow2(WB))
    unroll = int(point.get("unroll", 1))
    if bh % unroll:
        raise ValueError(f"block_h={bh} does not split into {unroll} strips")
    order_hw = point.get("order", "hw") == "hw"
    # ~16 elements a thread, 1..8 warps
    warps = max(1, min(8, (bh // unroll) * bw // 512))
    return (int(bands), bh, bw, unroll, order_hw, warps)


class LintraKernel:
    """One Triton JIT function and the binaries compiled for it.

    Each instance compiles its points afresh (Triton's in-memory cache
    lives on the JIT function), so a tuner that owns one pays the
    compile of every point it generates.
    """

    def __init__(self) -> None:
        triton = _triton()
        self.jit = triton.jit(do_not_specialize=list(_INT_ARGS))(_lintra_kernel)
        self._compiled: set[tuple] = set()
        self._lock = threading.Lock()

    def compile(self, point: Point, bands: int, WB: int,
                dtype: torch.dtype, device: torch.device) -> tuple:
        """Compile ``point``'s binary now (a no-op when it exists)."""
        key = compile_key(point, bands, WB)
        with self._lock:
            if key in self._compiled:
                return key
            bands_, bh, bw, unroll, order_hw, warps = key
            dummy = torch.empty((1, bw), dtype=dtype, device=device)
            ab = torch.empty((bands_,), dtype=dtype, device=device)
            self.jit.warmup(dummy, ab, ab, dummy, 1, bw, 1, 1,
                            BANDS=bands_, BLOCK_H=bh, BLOCK_W=bw,
                            UNROLL=unroll, ORDER_HW=order_hw,
                            num_warps=warps, grid=(1,))
            self._compiled.add(key)
        return key


_DEFAULT: LintraKernel | None = None
_DEFAULT_LOCK = threading.Lock()


def default_kernel() -> LintraKernel:
    """The process-wide :class:`LintraKernel` for direct wrapper calls."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = LintraKernel()
        return _DEFAULT


def lintra_triton(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  point: Point, *,
                  kernel: LintraKernel | None = None) -> torch.Tensor:
    """x (H, W*bands) folded, a/b (bands,) -> y (H, W*bands), x's dtype.

    On CUDA tensors: checks the arguments, launches the point's binary
    (compiling it first if ``kernel`` has not) on the current stream and
    counts the launch in ``lintra_triton.launches``. On CPU tensors: the
    plain version.
    """
    if not x.is_cuda:
        return lintra_plain(x, a, b)
    if a.device != x.device or b.device != x.device:
        raise ValueError(f"x on {x.device} but a on {a.device}, b on {b.device}")
    if x.dim() != 2 or a.dim() != 1 or a.shape != b.shape:
        raise ValueError(
            f"expected x (H, W*bands), a and b (bands,), got {tuple(x.shape)}, "
            f"{tuple(a.shape)}, {tuple(b.shape)}")
    if x.dtype != torch.float32 or a.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"lintra_triton takes float32, got {x.dtype}, {a.dtype}, {b.dtype}")
    if not (x.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("lintra_triton takes contiguous tensors")
    H, WB = x.shape
    bands = a.shape[0]
    if WB % bands:
        raise ValueError(f"row length {WB} is not a multiple of {bands} bands")
    if H * WB >= 2**31:
        raise ValueError(f"{H}x{WB} elements overflow the kernel's int32 offsets")
    kernel = kernel or default_kernel()
    bands_, bh, bw, unroll, order_hw, warps = kernel.compile(
        point, bands, WB, x.dtype, x.device)
    y = torch.empty_like(x)
    n_h, n_w = -(-H // bh), -(-WB // bw)
    with torch.cuda.device(x.device):
        kernel.jit[(n_h * n_w,)](
            x, a, b, y, H, WB, n_h, n_w,
            BANDS=bands_, BLOCK_H=bh, BLOCK_W=bw, UNROLL=unroll,
            ORDER_HW=order_hw, num_warps=warps)
    lintra_triton.launches += 1
    return y


lintra_triton.launches = 0


def lintra_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (any device): the folded
    oracle ``lintra_ref_folded`` with ``ab = (tile(a), tile(b))``. Tiles,
    strips and order do not change an elementwise result."""
    W = x.shape[1] // a.shape[0]
    return lintra_ref_folded(x, torch.stack([a.repeat(W), b.repeat(W)]))
