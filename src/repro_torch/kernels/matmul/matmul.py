"""Tiled matmul kernel for Hopper with an auto-tunable variant space.

Mirrors ``repro/kernels/matmul/matmul.py``: ``matmul_cuda`` takes the
place of ``matmul_pallas``, with the same tuning point:

  block_m   — rows per block                    (coldUF: grid coarsening)
  block_n   — columns per block                 (vectLen)
  block_k   — reduction chunk per loop step
  unroll    — independent sub-accumulators within block_k (hotUF)
  order     — "mn" | "nm" block-id-to-tile mapping (IS)
  scratch   — 1: accumulate in registers, store once
              0: read-modify-write the output tile after every chunk
  lookahead — slices of A and B (64 or 32 deep) in flight ahead of the one
              computed (a ring of lookahead + 1 shared-memory stages)

The kernels are CUDA C++ (``csrc/matmul.cuh``; its header comment is the
design note), fp32 accumulators and an fp32 output either way, as
``matmul_pallas`` writes ``out_dtype=jnp.float32``. Three paths, chosen
by :func:`path` from the operands before the launch (never after a
failure):

  ``tf32x3`` — fp32 operands: 3xTF32 products on ``mma.sync`` (fp32
               accuracy), operands staged by ``cp.async``;
  ``wgmma``  — bf16 operands that TMA can describe (K and N multiples of
               8, both operands 16-byte aligned): a producer warp's TMA
               loads into a ring of mbarrier stages, two consumer
               warpgroups on ``wgmma`` m64nNk16, a persistent grid;
  ``mma``    — other bf16 operands: bf16 products on ``mma.sync``,
               staged by ``cp.async`` or element by element.

On the ``wgmma`` path ``block_m`` and ``block_n`` set the block's tile
(64 or 128 rows, 128 or 256 columns) and the least band of tiles the
persistent walk covers before it moves on (``order`` picks bands of
rows or of columns; the kernel widens a band until the tiles resident
at once span about as many bytes of A as of B); ``block_k`` is the
chunk ``scratch`` 0 read-modify-writes the output after; ``lookahead``
+ 2 is the ring's depth (a stage stays held while the products reading
it finish). ``unroll`` is inert there (every product runs in one wgmma
accumulation chain), and so is ``block_k`` at ``scratch`` 1.
``block_m``, ``block_n``, ``block_k``, ``unroll`` and the operand type
are template parameters, one instantiation per combination (108 a type
and path), all built once into one shared library; ``order``,
``scratch`` and ``lookahead`` are run-time arguments. Generating a
variant resolves its symbol. ``matmul_cuda.launches_by_path`` counts the
launches of each path.

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

#: padded row length of the staged B slices (csrc/matmul.cuh ``kLdB``)
_LD_B = 128 + 8

#: operand type -> symbol suffix (fp32's symbols carry none)
_TYPES = {torch.float32: "", torch.bfloat16: "_bf16"}
#: bf16 path -> symbol suffix after ``_bf16``
_BF16_PATHS = {"wgmma": "", "mma": "_mma"}


def pass_m(point: Point) -> int:
    """Rows of the pass tile the block holds in registers
    (``matmul::pass_m``): 128 or ``block_m`` at ``unroll`` 1, else 64."""
    bm, unroll = int(point["block_m"]), int(point.get("unroll", 1))
    return min(bm, 128) if unroll == 1 else 64


def slice_depth(point: Point) -> int:
    """k depth of a staged slice (``matmul::slice_depth``): 64, or 32
    where a sub-chunk (``block_k / unroll``) is 32 deep."""
    return 64 if (int(point["block_k"]) // int(point.get("unroll", 1))) % 64 == 0 else 32


def smem_bytes(point: Point, dtype_bytes: int = 4, path: str | None = None) -> int:
    """Shared memory of one block at ``point`` for operands of
    ``dtype_bytes`` (4: fp32, 2: bf16), on ``path`` (bf16 defaults to
    ``wgmma``, the one the main path takes).

    ``wgmma`` (``matmul::wg::smem_bytes``): ``lookahead + 2`` stages of a
    (tile rows x 64) A slice and a (64 x tile columns) B slice (a stage
    stays held while its products finish), 64 bytes of barriers and 1024
    bytes to align the ring. ``tf32x3`` and ``mma``
    (``matmul::stage_bytes``): ``lookahead + 1`` stages, each a (pass rows
    x depth) slice of A and a depth x 128 slice of B, A rows padded by 16
    bytes, B rows by 8 elements."""
    stages = int(point.get("lookahead", 1)) + 1
    if dtype_bytes == 2 and (path or "wgmma") == "wgmma":
        tm = 64 if int(point["block_m"]) < 128 else 128
        tn = 128 if int(point["block_n"]) < 256 else 256
        return 1024 + 64 + (stages + 1) * 2 * (tm + tn) * 64
    depth = slice_depth(point)
    ld_a = depth + 16 // dtype_bytes
    stage = dtype_bytes * (pass_m(point) * ld_a + depth * _LD_B)
    return stages * stage


#: the largest footprint of any instantiation (fp32, 128-row passes,
#: 64-deep slices, three stages: 204 kB; bf16's largest is 193 kB, the
#: wgmma kernel's 128 x 256 tile at four stages)
SMEM_BYTES = max(smem_bytes({"block_m": 128, "block_k": 256, "unroll": 1, "lookahead": 2}),
                 smem_bytes({"block_m": 128, "block_n": 256, "lookahead": 2}, 2))

_ORDERS = {"mn": 0, "nm": 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def bf16_path(N: int, K: int, a_ptr: int, b_ptr: int) -> str:
    """The bf16 path for (M, K) @ (K, N) operands at these addresses:
    ``wgmma`` where TMA can describe both (row strides of K and N values
    a multiple of 16 bytes, bases 16-byte aligned), else ``mma``."""
    aligned = a_ptr % 16 == 0 and b_ptr % 16 == 0
    return "wgmma" if K % 8 == 0 and N % 8 == 0 and aligned else "mma"


def path(a: torch.Tensor, b: torch.Tensor) -> str:
    """The path ``matmul_cuda`` launches for these operands: ``tf32x3``
    for fp32, :func:`bf16_path` for bf16."""
    if a.dtype == torch.float32:
        return "tf32x3"
    return bf16_path(b.shape[1], a.shape[1], a.data_ptr(), b.data_ptr())


def symbol(point: Point, dtype: torch.dtype = torch.float32,
           path: str = "wgmma") -> str:
    """Exported C name of the instantiation that serves ``point`` for
    operands of ``dtype`` (a type without instantiations raises
    ``KeyError``); for bf16, on ``path`` (``wgmma`` or ``mma``)."""
    if dtype not in _TYPES:
        raise KeyError(f"no matmul instantiation for {dtype}: instantiated "
                       f"operand types are {tuple(_TYPES)}")
    bm, bn, bk, u = (int(point[k]) for k in PHASE1)
    sfx = _TYPES[dtype] + (_BF16_PATHS[path] if dtype == torch.bfloat16 else "")
    return f"matmul_bm{bm}_bn{bn}_bk{bk}_u{u}{sfx}"


def instantiations() -> dict[str, str]:
    """Symbol -> instantiation line of every valid phase-1 combination,
    for each operand type and bf16 path."""
    out = {}
    for combo in itertools.product(*(OPTIONS[k] for k in PHASE1)):
        point = dict(zip(PHASE1, combo))
        if point["block_k"] % point["unroll"] == 0:
            args = ", ".join(map(str, combo))
            out[symbol(point)] = f"MATMUL_INSTANTIATE({args})"
            out[symbol(point, torch.bfloat16)] = f"MATMUL_INSTANTIATE_BF16({args})"
            out[symbol(point, torch.bfloat16, "mma")] = \
                f"MATMUL_INSTANTIATE_BF16_MMA({args})"
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
    # and listing the 324 instantiations costs more host time than the
    # lookup should
    return load_family("matmul", CSRC, "matmul.cuh", instantiations(), _ARGTYPES,
                       n_units=24)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, point: Point, *,
                lib: KernelLibrary | None = None) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) fp32, for fp32 or bf16 operands (both of
    one type).

    On CUDA tensors: checks the arguments, launches the instantiation for
    ``point``, the operands' type and their :func:`path` on the current
    stream, checks the launch status and counts the launch in
    ``matmul_cuda.launches`` (and in ``.launches_by_dtype`` by operand
    type, ``.launches_by_path`` by path). On CPU tensors: the plain
    version.
    """
    if not a.is_cuda:
        return matmul_plain(a, b, point)
    if b.device != a.device:
        raise ValueError(f"a on {a.device} but b on {b.device}")
    if a.dtype not in _TYPES or b.dtype != a.dtype:
        raise TypeError(f"matmul_cuda takes float32 or bfloat16 operands of one "
                        f"type, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"expected a (M, K) and b (K, N), got {tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_cuda takes contiguous tensors")
    M, K = a.shape
    N = b.shape[1]
    if min(M, N, K) < 1 or max(M * K, K * N, M * N) >= 2**62 or max(M, N, K) >= 2**31:
        raise ValueError(f"unsupported shape M={M} N={N} K={K}")
    lookahead = int(point.get("lookahead", 1))
    if lookahead not in (0, 1, 2):
        raise ValueError(f"lookahead {lookahead}: the kernel takes 0, 1 or 2")
    if lib is None:
        lib = build_kernels(a.device)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    route = path(a, b)
    lib.launch(symbol(point, a.dtype, route), a.data_ptr(), b.data_ptr(), out.data_ptr(),
               M, N, K, _ORDERS[point.get("order", "mn")],
               int(bool(point.get("scratch", 1))), lookahead, stream)
    matmul_cuda.launches += 1
    by_type = matmul_cuda.launches_by_dtype
    name = str(a.dtype).removeprefix("torch.")
    by_type[name] = by_type.get(name, 0) + 1
    by_path = matmul_cuda.launches_by_path
    by_path[route] = by_path.get(route, 0) + 1
    return out


matmul_cuda.launches = 0
#: the launches above, split by operand type ("float32", "bfloat16")
matmul_cuda.launches_by_dtype = {}
#: and by path ("tf32x3", "wgmma", "mma")
matmul_cuda.launches_by_path = {}


def matmul_plain(a: torch.Tensor, b: torch.Tensor, point: Point) -> torch.Tensor:
    """The kernel's function in plain PyTorch (any device), fp32 out.

    bf16 operands are upcast to fp32 first: their products are exact in
    fp32, which is what the kernel's bf16 products and the reference's
    ``preferred_element_type=jnp.float32`` compute.
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


__all__ = ["OPTIONS", "PHASE1", "SMEM_BYTES", "bf16_path", "build_kernels",
           "instantiations", "matmul_cuda", "matmul_plain", "path", "smem_bytes",
           "symbol"]
