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

The kernel is CUDA C++ (``csrc/attention.cuh``; its header comment is
the design note): 3xTF32 products on the tensor cores (``mma.sync``,
fp32 accuracy), K and V staged by ``cp.async``, a per-warp causal skip.
``block_q`` and ``block_kv`` are template parameters
at Dh = 128, one instantiation per combination (12), all built once
into one shared library. A block clamped to the sequence, as
``flash_attention_pallas`` clamps ``min(block, T)``, is served by the
smallest instantiated block that covers the sequence: one tile either
way.

``flash_attention_plain`` is the same function in plain PyTorch (the
chunked online softmax of ``ops.flash_attention_torch`` with the point's
blocks). The wrapper uses it only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.
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
BLOCK_KV = (128, 256, 512, 1024)
#: the head dim the kernel is written for
HEAD_DIM = 128

#: shared memory of one ring stage (csrc/attention.cuh ``kStageBytes``):
#: 32 keys of K and of V as copied
STAGE_BYTES = 4 * 2 * 32 * 128
#: the split slice (``kSplitBytes``): 32 keys of K and V as (big, small)
#: TF32 pairs, rows padded to 132 pairs
SPLIT_BYTES = 8 * 2 * 32 * 132


def smem_bytes(point: Point) -> int:
    """Shared memory of one block at ``point``: ``lookahead + 1`` stages
    and the split slice."""
    return (int(point.get("lookahead", 1)) + 1) * STAGE_BYTES + SPLIT_BYTES


#: the largest footprint (three stages and the split slice, 162 kB)
SMEM_BYTES = smem_bytes({"lookahead": 2})

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _block(value: int, extent: int, options: tuple[int, ...]) -> int:
    """The instantiated block serving ``value`` (already clamped to the
    ``extent``, or not): an option itself, or — for a block clamped to
    the whole extent — the smallest option that covers it."""
    value = int(value)
    if value in options:
        return value
    if value >= extent:
        covering = [o for o in options if o >= extent]
        if covering:
            return covering[0]
    raise KeyError(
        f"no attention instantiation for block {value} at extent {extent}: "
        f"instantiated blocks are {options}")


def symbol(point: Point, Tq: int, Tkv: int) -> str:
    """Exported C name of the instantiation serving ``point`` at these
    sequence lengths."""
    bq = _block(point["block_q"], Tq, BLOCK_Q)
    bkv = _block(point["block_kv"], Tkv, BLOCK_KV)
    return f"attention_bq{bq}_bkv{bkv}"


def instantiations() -> dict[str, str]:
    """Symbol -> instantiation line of every (block_q, block_kv)."""
    return {f"attention_bq{bq}_bkv{bkv}": f"ATTENTION_INSTANTIATE({bq}, {bkv})"
            for bq in BLOCK_Q for bkv in BLOCK_KV}


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
                       _ARGTYPES, n_units=4)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, point: Point, *,
    causal: bool = True, scale: float | None = None, q_offset: int = 0,
    lib: KernelLibrary | None = None,
) -> torch.Tensor:
    """Blockwise causal attention: q (B, Tq, H, Dh), k/v (B, Tkv, Hk, Dh)
    -> (B, Tq, H, Dh) in q's type.

    On CUDA tensors: checks the arguments, launches the instantiation for
    ``point`` on the current stream, checks the launch status and counts
    the launch in ``flash_attention_cuda.launches``. On CPU tensors: the
    plain version.
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, point, causal=causal, scale=scale,
                                     q_offset=q_offset)
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device} but k on {k.device}, v on {v.device}")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError(
            f"flash_attention_cuda takes float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (B, Tq, H, Dh), k and v (B, Tkv, Hk, Dh), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, H, Dh = q.shape
    _, Tkv, Hk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != Dh or Dh != HEAD_DIM or H % Hk:
        raise ValueError(
            f"unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}: the "
            f"kernel takes Dh = {HEAD_DIM} and H a multiple of Hk")
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
    lib.launch(symbol(point, Tq, Tkv), q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), B, Tq, Tkv, H, Hk, int(bool(causal)), int(q_offset),
               scale, lookahead, stream)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


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


__all__ = ["BLOCK_KV", "BLOCK_Q", "HEAD_DIM", "SMEM_BYTES", "SPLIT_BYTES", "STAGE_BYTES",
           "build_kernels",
           "flash_attention_cuda", "flash_attention_plain", "instantiations",
           "smem_bytes", "symbol"]
