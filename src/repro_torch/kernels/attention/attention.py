"""Flash-attention kernel for Hopper (blockwise online softmax), GQA-aware.

Mirrors ``repro/kernels/attention/attention.py``:
``flash_attention_cuda`` takes the place of ``flash_attention_pallas``,
with the same tuning point:

  block_q   — query rows per block (coldUF analogue)
  block_kv  — key/value rows per kv-loop step (vectLen analogue)
  sched     — inert (a parallel/arbitrary hint on the TPU's kv axis)
  lookahead — 32-key slices of K and V in flight ahead of the one
              computed (a ring of lookahead + 1 shared-memory stages)

Layout: q (B, Tq, H, Dh), k/v (B, Tkv, Hk, Dh) with H = G·Hk, read in
place (no transposed copies); the kv head of q head h is h // G.

The kernels are CUDA C++ (``csrc/attention.cuh``; its header comment is
the design note). Three paths, chosen by :func:`path` from the tensors
before the launch (never after a failure):

  ``tf32x3`` — fp32 inputs: 3xTF32 products on ``mma.sync`` (fp32
               accuracy), K and V staged by ``cp.async``, a per-warp
               causal skip;
  ``wgmma``  — bf16 inputs that TMA can describe (q, k and v 16-byte
               aligned): FA3's shape, a producer warp's TMA loads of the
               q tile and of 64- or 128-key K and V tiles into a ring of
               mbarrier stages, two consumer warpgroups of 64 q rows on
               ``wgmma`` (S = Q K^T from shared memory, P from registers
               for P V), a persistent grid that takes the heaviest causal
               q tiles first;
  ``mma``    — other bf16 inputs: bf16 products on ``mma.sync``.

At bf16, P is rounded to bf16 before P·V and the output is written in
bf16, as the reference's kernel does. The input type, head dim,
``block_q`` and ``block_kv`` are template parameters, one instantiation
per combination (Dh 16, 64 and 128, the head dims of the reduced
configs, of the 64-wide families and of deepseek-7b: 45 a type and
path), all built once into one shared library; the launcher picks by
q's type and last dim and raises at a type or Dh it has no
instantiation for. A block clamped to the sequence, as
``flash_attention_pallas`` clamps ``min(block, T)``, is served by the
smallest instantiated block that covers the sequence: one tile either
way. A block below the smallest instantiation (``block_q`` 64 or 32 of
the training and prefill step-programs' chunks, ``block_kv`` 32) is
served by that smallest one: the same hand kernel and the same function,
not a plain fallback. On the ``tf32x3`` and ``mma`` paths ``block_q``
only sets how many 128-row iterations a block walks, and ``block_kv``
changes no slice the kernel computes; on the ``wgmma`` path ``block_q``
is the persistent walk's item (its 128-row units run back to back) and
``block_kv`` 64 takes 64-key tiles, any larger one 128-key tiles.
``flash_attention_cuda.launches_by_path`` counts the launches of each
path.

``flash_attention_plain`` is the same function in plain PyTorch (the
chunked online softmax of ``ops.flash_attention_torch`` with the point's
blocks). The wrapper uses it only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.

``FlashAttentionFunction`` makes the kernel differentiable: its forward
is ``flash_attention_cuda``, its backward recomputes through the plain
chunked version with the same blocks and differentiates that, as the
reference's gradient goes through ``flash_attention_jnp``
(double-checkpointed, so its backward recomputes score blocks). The
Pallas kernel has no backward, so no hand backward kernel is owed.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Any

import torch

from repro_torch.interop import resolve_device
from repro_torch.kernels._build import KernelLibrary, load_family

Point = dict[str, Any]

CSRC = Path(__file__).with_name("csrc")

#: the options each template parameter is instantiated for
BLOCK_Q = (128, 256, 512)
BLOCK_KV = (64, 128, 256, 512, 1024)
#: the head dims the library is instantiated for
HEAD_DIMS = (16, 64, 128)
#: input type -> symbol suffix (fp32's symbols carry none)
_TYPES = {torch.float32: "", torch.bfloat16: "_bf16"}
#: bf16 path -> symbol suffix after ``_bf16``
_BF16_PATHS = {"wgmma": "", "mma": "_mma"}


def stage_bytes(Dh: int, dtype_bytes: int = 4) -> int:
    """Shared memory of one ring stage of the ``tf32x3`` and ``mma``
    kernels (csrc/attention.cuh ``stage_bytes<DH>``): 32 keys of K and
    of V as copied; bf16 rows are padded to Dh + 8 values
    (``stage_bytes_bf16<DH>``)."""
    if dtype_bytes == 2:
        return 2 * 2 * 32 * (Dh + 8)
    return 4 * 2 * 32 * Dh


def split_bytes(Dh: int) -> int:
    """The split slice (``split_bytes<DH>``): 32 keys of K and V as
    (big, small) TF32 pairs, rows padded to Dh + 4 pairs."""
    return 8 * 2 * 32 * (Dh + 4)


def kv_tile(point: Point) -> int:
    """Keys of the ``wgmma`` kernel's K and V tiles
    (``attention::wg::kv_tile``): 64 at ``block_kv`` 64, else 128."""
    return 64 if int(point["block_kv"]) < 128 else 128


def smem_bytes(point: Point, Dh: int, dtype_bytes: int = 4,
               path: str | None = None) -> int:
    """Shared memory of one block at ``point``, head dim ``Dh`` and inputs
    of ``dtype_bytes``, on ``path`` (bf16 defaults to ``wgmma``, the one
    the main path takes). ``wgmma`` (``attention::wg::smem_bytes``): the
    128-row q tile, ``lookahead + 1`` stages of a K and a V tile, 128
    bytes of barriers and 1024 to align them. ``tf32x3`` and ``mma``:
    ``lookahead + 1`` 32-key stages, and for fp32 the split slice."""
    la = int(point.get("lookahead", 1))
    if dtype_bytes == 2 and (path or "wgmma") == "wgmma":
        return 1024 + 128 + 2 * 128 * Dh + (la + 1) * 2 * 2 * kv_tile(point) * Dh
    stages = (la + 1) * stage_bytes(Dh, dtype_bytes)
    return stages if dtype_bytes == 2 else stages + split_bytes(Dh)


#: the largest footprint (bf16's wgmma kernel at Dh 128: the q tile and
#: three stages of 128-key tiles, 225 kB; fp32's largest is 162 kB)
SMEM_BYTES = smem_bytes({"block_kv": 128, "lookahead": 2}, max(HEAD_DIMS), 2)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _block(value: int, extent: int, options: tuple[int, ...]) -> int:
    """The instantiated block serving ``value`` (already clamped to the
    ``extent``, or not): an option itself, the smallest option for a
    block below it, or — for a block clamped to the whole extent — the
    smallest option that covers it."""
    value = max(int(value), options[0])
    if value in options:
        return value
    if value >= extent:
        covering = [o for o in options if o >= extent]
        if covering:
            return covering[0]
    raise KeyError(
        f"no attention instantiation for block {value} at extent {extent}: "
        f"instantiated blocks are {options}")


def bf16_path(*ptrs: int) -> str:
    """The bf16 path for q, k and v at these addresses: ``wgmma`` where
    TMA can describe them (bases 16-byte aligned; their rows, ``H * Dh``
    and ``Hk * Dh`` values at an instantiated Dh, are multiples of 16
    bytes), else ``mma``."""
    return "wgmma" if all(p % 16 == 0 for p in ptrs) else "mma"


def path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The path ``flash_attention_cuda`` launches for these tensors:
    ``tf32x3`` for fp32, :func:`bf16_path` for bf16."""
    if q.dtype == torch.float32:
        return "tf32x3"
    return bf16_path(q.data_ptr(), k.data_ptr(), v.data_ptr())


def symbol(point: Point, Tq: int, Tkv: int, Dh: int,
           dtype: torch.dtype = torch.float32, path: str = "wgmma") -> str:
    """Exported C name of the instantiation serving ``point`` at these
    sequence lengths, head dim and input type (for bf16, on ``path``:
    ``wgmma`` or ``mma``)."""
    if Dh not in HEAD_DIMS:
        raise KeyError(
            f"no attention instantiation for head dim {Dh}: instantiated head "
            f"dims are {HEAD_DIMS}")
    if dtype not in _TYPES:
        raise KeyError(f"no attention instantiation for {dtype}: instantiated "
                       f"input types are {tuple(_TYPES)}")
    bq = _block(point["block_q"], Tq, BLOCK_Q)
    bkv = _block(point["block_kv"], Tkv, BLOCK_KV)
    sfx = _TYPES[dtype] + (_BF16_PATHS[path] if dtype == torch.bfloat16 else "")
    return f"attention_dh{Dh}_bq{bq}_bkv{bkv}{sfx}"


def instantiations() -> dict[str, str]:
    """Symbol -> instantiation line of every (type and path, Dh, block_q,
    block_kv)."""
    lines = {"": "ATTENTION_INSTANTIATE", "_bf16": "ATTENTION_INSTANTIATE_BF16",
             "_bf16_mma": "ATTENTION_INSTANTIATE_BF16_MMA"}
    return {f"attention_dh{dh}_bq{bq}_bkv{bkv}{sfx}": f"{macro}({dh}, {bq}, {bkv})"
            for sfx, macro in lines.items()
            for dh in HEAD_DIMS for bq in BLOCK_Q for bkv in BLOCK_KV}


def build_kernels(device: "torch.device | str | None" = None) -> KernelLibrary:
    """Build (once) and load every instantiation. Set-up: the first call
    runs nvcc (its seconds are in ``.build_s``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the attention kernel builds for a CUDA device, not {dev}")
    return _library()


@functools.cache
def _library() -> KernelLibrary:
    # memoised: the wrapper asks for it on every launch given no library
    return load_family("attention", CSRC, "attention.cuh", instantiations(),
                       _ARGTYPES, n_units=16)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, point: Point, *,
    causal: bool = True, scale: float | None = None, q_offset: int = 0,
    lib: KernelLibrary | None = None,
) -> torch.Tensor:
    """Blockwise causal attention: q (B, Tq, H, Dh), k/v (B, Tkv, Hk, Dh)
    -> (B, Tq, H, Dh) in q's type (fp32 or bf16, all three of one type).

    On CUDA tensors: checks the arguments, launches the instantiation for
    ``point``, q's type, head dim and :func:`path` on the current stream,
    checks the launch status and counts the launch in
    ``flash_attention_cuda.launches`` (by type and head dim in
    ``.launches_by_dtype``, by path in ``.launches_by_path``). On CPU
    tensors: the plain version.
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, point, causal=causal, scale=scale,
                                     q_offset=q_offset)
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device} but k on {k.device}, v on {v.device}")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention_cuda takes float32 or bfloat16 q, k and v of one "
            f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (B, Tq, H, Dh), k and v (B, Tkv, Hk, Dh), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, H, Dh = q.shape
    _, Tkv, Hk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != Dh or Dh not in HEAD_DIMS or H % Hk:
        raise ValueError(
            f"unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}: the "
            f"kernel takes Dh in {HEAD_DIMS} and H a multiple of Hk")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention_cuda takes contiguous tensors")
    if min(B, Tq, Tkv) < 1 or max(q.numel(), k.numel()) >= 2**62 \
            or B * H * Tq >= 2**31 or q_offset < 0:
        raise ValueError(
            f"unsupported call B={B} Tq={Tq} Tkv={Tkv} H={H} q_offset={q_offset}")
    lookahead = int(point.get("lookahead", 1))
    if lookahead not in (0, 1, 2):
        raise ValueError(f"lookahead {lookahead}: the kernel takes 0, 1 or 2")
    if lib is None:
        lib = build_kernels(q.device)
    scale = float(scale if scale is not None else Dh ** -0.5)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    route = path(q, k, v)
    lib.launch(symbol(point, Tq, Tkv, Dh, q.dtype, route), q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), B, Tq, Tkv, H, Hk, int(bool(causal)),
               int(q_offset), scale, lookahead, stream)
    flash_attention_cuda.launches += 1
    by_type = flash_attention_cuda.launches_by_dtype.setdefault(
        str(q.dtype).removeprefix("torch."), {})
    by_type[Dh] = by_type.get(Dh, 0) + 1
    by_path = flash_attention_cuda.launches_by_path
    by_path[route] = by_path.get(route, 0) + 1
    return out


flash_attention_cuda.launches = 0
#: the launches above, split by input type ("float32", "bfloat16"), then head dim
flash_attention_cuda.launches_by_dtype = {}
#: and by path ("tf32x3", "wgmma", "mma")
flash_attention_cuda.launches_by_path = {}


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, point: Point, *,
    causal: bool = True, scale: float | None = None, q_offset: int = 0,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (any device): the chunked
    online softmax with the point's ``block_q`` / ``block_kv``, block for
    block what ``_fa_kernel`` computes."""
    from repro_torch.kernels.attention.ops import flash_attention_torch

    return flash_attention_torch(
        q, k, v, causal=causal, scale=scale, q_offset=q_offset,
        q_chunk=int(point["block_q"]), k_chunk=int(point["block_kv"]))


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention_cuda`` at ``point`` under autograd, causal unless
    told otherwise (the layers' call: no offset, the default scale).

    Forward: the hand kernel on CUDA tensors (the plain version on the
    CPU). Backward: recomputes the attention through
    ``flash_attention_plain`` with the point's blocks under
    ``torch.enable_grad()``, then ``torch.autograd.grad``; saves only q,
    k and v.
    """

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, point: Point,
                causal: bool = True):
        ctx.save_for_backward(q, k, v)
        ctx.point = dict(point)
        ctx.causal = causal
        return flash_attention_cuda(q, k, v, point, causal=causal)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = flash_attention_plain(*inputs, ctx.point, causal=ctx.causal)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None)


__all__ = ["BLOCK_KV", "BLOCK_Q", "FlashAttentionFunction", "HEAD_DIMS", "SMEM_BYTES",
           "bf16_path", "build_kernels", "flash_attention_cuda", "flash_attention_plain",
           "instantiations", "kv_tile", "path", "smem_bytes", "split_bytes",
           "stage_bytes", "symbol"]
