"""Attention ops: chunked PyTorch flash attention, decode, compilette.

Mirrors ``repro/kernels/attention/ops.py``. ``flash_attention_torch`` is
the chunked online-softmax attention (the port of ``flash_attention_jnp``)
the models use wherever the hand kernel does not apply: on the CPU, and
for windowed, non-causal or offset queries, since the Pallas path has no
window either. ``decode_attention`` is the port of the reference's
flash-decoding scan. Both are plain PyTorch: the reference writes them
as jnp scans, not Pallas kernels.

The tuning space, cost model and catalog entry are the reference's. The
catalog's variants are the hand kernel (``attention.py``, CUDA C++) on a
CUDA device and its plain version on the CPU.

**Capacity rule.** At the reference's capacity (``vmem_kb`` of the TPU
profile) the validator is the TPU kernel's VMEM footprint: its q, k, v
and score blocks and the accumulators. On a CUDA device
(``hopper=True``) it checks what the Hopper kernel holds in shared
memory (:func:`~repro_torch.kernels.attention.attention.smem_bytes`): in
fp32 its ring of ``lookahead + 1`` stages of 32 keys of K and V and the
split slice, whatever the blocks (98–162 kB at Dh 128, 50–82 kB at 64,
14–22 kB at 16); in bf16 the wgmma kernel's 128-row q tile and its
ring of ``lookahead + 1`` stages of 64- or 128-key K and V tiles
(65–225 kB at Dh 128, 33–113 at 64, 9–29 at 16), at the head dims the
library is instantiated for (16, 64, 128); any other Dh has no valid
point.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.profiles import TPU_V5E, DeviceProfile
from repro_torch.core.tuning_space import Param, Point, TuningSpace
from repro_torch.interop import resolve_device
from repro_torch.kernels.attention.attention import (
    HEAD_DIMS, build_kernels, flash_attention_cuda, flash_attention_plain,
    smem_bytes, symbol)
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.catalog import (
    KernelDef, example_fill, spec_capacity_kb, spec_on_cuda, torch_dtype)

NEG_INF = -1e30

DEFAULT_POINT: Point = {
    "block_q": 256, "block_kv": 512, "sched": "arbitrary", "lookahead": 1,
}


# ---------------------------------------------------- chunked torch flash
def flash_attention_torch(
    q: torch.Tensor,      # (B, Tq, H, Dh)
    k: torch.Tensor,      # (B, Tkv, Hk, Dh)
    v: torch.Tensor,      # (B, Tkv, Hk, Dh)
    *,
    causal: bool = True,
    scale: float | None = None,
    q_offset: int = 0,
    window: int | None = None,
    q_chunk: int = 256,
    k_chunk: int = 512,
    scores_f32: bool = True,
    recompute: bool = False,
) -> torch.Tensor:
    """Online-softmax attention over ``q_chunk`` x ``k_chunk`` blocks.

    Python loops take the place of the reference's two ``lax.scan``\\ s;
    the masks (ragged kv tail, causal with ``q_offset``, sliding window)
    and the fp32 running max, sum and accumulator are the reference's.
    With ``recompute`` and grad mode on, each query chunk and each block
    in it is checkpointed, as the reference checkpoints both scan bodies:
    the backward recomputes the score blocks instead of keeping them.
    """
    B, Tq, H, Dh = q.shape
    _, Tk, Hk, _ = k.shape
    G = H // Hk
    scale = float(scale if scale is not None else Dh ** -0.5)
    qc = min(q_chunk, Tq)
    kc = min(k_chunk, Tk)
    n_q = math.ceil(Tq / qc)
    n_k = math.ceil(Tk / kc)
    Tq_p, Tk_p = n_q * qc, n_k * kc
    orig_dtype = q.dtype
    dev = q.device

    if Tq_p != Tq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, Tq_p - Tq))
    if Tk_p != Tk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, Tk_p - Tk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Tk_p - Tk))
    score_dtype = torch.float32 if scores_f32 else q.dtype
    # (n_q, B, Hk, G, qc, Dh) and (n_k, B, Hk, kc, Dh)
    qb = q.reshape(B, n_q, qc, Hk, G, Dh).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(B, n_k, kc, Hk, Dh).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, n_k, kc, Hk, Dh).permute(1, 0, 3, 2, 4)
    q_ids = torch.arange(qc, device=dev)
    k_ids = torch.arange(kc, device=dev)

    def kv_step(qcur, m, l, acc, kblk, vblk, q_pos, ik):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qcur,
                         kblk.to(score_dtype)).to(torch.float32) * scale
        k_pos = ik * kc + k_ids[None, :]
        mask = k_pos < Tk
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        # p rounded to v's type, the product in fp32 (the reference's
        # preferred_element_type): bf16 x bf16 is exact in fp32
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(vblk.dtype).float(), vblk.float())
        return m_new, l, acc

    def q_step(qcur, iq):
        m = torch.full((B, Hk, G, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hk, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hk, G, qc, Dh), dtype=torch.float32, device=dev)
        q_pos = q_offset + iq * qc + q_ids[:, None]
        for ik in range(n_k):
            m, l, acc = step(kv_step, qcur, m, l, acc, kb[ik], vb[ik], q_pos, ik)
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(orig_dtype)

    if recompute and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        def step(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False)
    else:
        def step(fn, *args):
            return fn(*args)

    outs = [step(q_step, qb[iq].to(score_dtype), iq) for iq in range(n_q)]
    # (n_q, B, Hk, G, qc, Dh) -> (B, Tq, H, Dh)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Tq_p, H, Dh)
    return out[:, :Tq].to(orig_dtype)


# ------------------------------------------------------------ decode path
def decode_attention(
    q: torch.Tensor,      # (B, 1, H, Dh) — one new token
    k: torch.Tensor,      # (B, S, Hk, Dh) KV cache
    v: torch.Tensor,
    *,
    length: "torch.Tensor | int | None" = None,
    scale: float | None = None,
    k_chunk: int = 4096,
    reduce_scores=None,
) -> torch.Tensor:
    """Flash-decoding: online-softmax loop over KV chunks.

    Chunking bounds the live working set to one chunk. A ragged cache
    (S not a multiple of the chunk) falls back to one chunk, as the
    reference does. ``reduce_scores`` completes each chunk's scores
    where the head dim is split across ranks (a sharded run's sum over
    the ranks that hold the other parts).
    """
    B, Tq, H, Dh = q.shape
    _, S, Hk, _ = k.shape
    G = H // Hk
    scale = float(scale if scale is not None else Dh ** -0.5)
    qg = q.reshape(B, Tq, Hk, G, Dh)
    kc = min(k_chunk, S)
    n = math.ceil(S / kc)
    if n * kc != S:       # ragged tail: fall back to a single chunk
        kc, n = S, 1
    # a Python length stays on the host: turning it into a device tensor
    # would be a blocking copy in every layer of every decode step
    len_b = (length.to(q.device).reshape(-1, 1)
             if isinstance(length, torch.Tensor) else length)
    k_ids = torch.arange(kc, device=q.device)

    m = torch.full((B, Hk, G, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hk, G, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hk, G, Tq, Dh), dtype=torch.float32, device=q.device)
    for ik in range(n):
        kblk = k[:, ik * kc:(ik + 1) * kc]
        vblk = v[:, ik * kc:(ik + 1) * kc]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                         kblk.to(torch.float32)) * scale
        if reduce_scores is not None:
            s = reduce_scores(s)
        if len_b is not None:
            valid = (ik * kc + k_ids)[None, :] < len_b
            s = torch.where(valid[:, None, None, None, :], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vblk.dtype).float(), vblk.float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    # (B, Hk, G, Tq, Dh) -> (B, Tq, H, Dh)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, Dh)
    return o.to(q.dtype)


# ------------------------------------------------------------ tuning space
def make_space(
    Tq: int, Tkv: int, Dh: int,
    *,
    vmem_kb: int = TPU_V5E.vmem_kb,
    hopper: bool = False,
    dtype_bytes: int = 4,
) -> TuningSpace:
    """The reference's space. ``dtype_bytes`` (the inputs' element size)
    counts only in the Hopper rule: the reference's validator counts
    4-byte words whatever the type."""
    params = (
        Param("block_q", (128, 256, 512), phase=1, switch_rank=0),
        Param("block_kv", (128, 256, 512, 1024), phase=1, switch_rank=1),
        Param("sched", ("arbitrary", "parallel"), phase=2),
        Param("lookahead", (0, 1, 2), phase=2),
    )

    def validator(p: Point) -> bool:
        if hopper:
            return Dh in HEAD_DIMS and smem_bytes(p, Dh, dtype_bytes) <= vmem_kb * 1024
        bq, bkv = min(p["block_q"], Tq), min(p["block_kv"], Tkv)
        words = bq * Dh * 2 + 2 * bkv * Dh + bq * bkv + 2 * bq
        return words * 4 <= vmem_kb * 1024

    def no_leftover(p: Point) -> float:
        waste = 1.0
        for dim, blk in ((Tq, min(p["block_q"], Tq)), (Tkv, min(p["block_kv"], Tkv))):
            n = math.ceil(dim / blk)
            waste *= (n * blk) / dim
        return waste - 1.0

    return TuningSpace(params=params, validator=validator, no_leftover=no_leftover)


def attention_cost_model(
    point: Point, spec: dict[str, Any], profile: DeviceProfile
) -> float:
    B, Tq, Tkv, H, Dh = spec["B"], spec["Tq"], spec["Tkv"], spec["H"], spec["Dh"]
    causal = spec.get("causal", True)
    bq, bkv = min(point["block_q"], Tq), min(point["block_kv"], Tkv)
    words = bq * Dh * 2 + 2 * bkv * Dh + bq * bkv + 2 * bq
    if words * 4 > profile.vmem_kb * 1024:
        return float("inf")
    frac = 0.5 if causal else 1.0
    flops = 4.0 * B * H * Tq * Tkv * Dh * frac
    eff = bkv / (bkv + 128.0)
    compute_s = flops / (profile.peak_flops * eff)
    n_q = math.ceil(Tq / bq)
    bytes_total = (B * H * Tq * Dh + B * H * Tkv * Dh * n_q * 2) * 2.0
    mem_s = bytes_total / (profile.hbm_gbps * 1e9)
    steps = B * H * n_q * math.ceil(Tkv / bkv)
    overhead_s = steps * profile.grid_step_overhead_ns * 1e-9 * (
        0.8 if point["sched"] == "arbitrary" else 1.0)
    t = profile.exec_time_s(compute_s, mem_s, overhead_s)
    if not profile.overlap and point["lookahead"] > 0:
        t -= min(compute_s, mem_s) * min(0.35 * point["lookahead"], 0.7)
    return t


def _variant(point: Point, device: torch.device, causal: bool, Tq: int, Tkv: int,
             Dh: int, dtype: torch.dtype):
    """The variant serving ``point`` for inputs of ``dtype``: the hand
    kernel on CUDA (its instantiation resolved now, so a missing one
    raises here), the plain version on the CPU."""
    pt = dict(point)
    lib = None
    if device.type == "cuda":
        lib = build_kernels(device)
        lib.resolve(symbol(pt, Tq, Tkv, Dh, dtype))

    def fn(q, k, v):
        return flash_attention_cuda(q, k, v, pt, causal=causal, lib=lib)

    return fn


# ---------------------------------------------------------- kernel catalog
def _catalog_generate(point: Point, spec: dict[str, Any]):
    return _variant(point, resolve_device(spec.get("device")),
                    bool(spec.get("causal", True)), spec["Tq"], spec["Tkv"],
                    spec["Dh"], _dtype(spec))


def _dtype(spec: dict[str, Any]) -> torch.dtype:
    return torch_dtype(spec.get("dtype", "float32"))


def _extract_spec(q, k, v, **overrides: Any) -> dict[str, Any]:
    B, Tq, H, Dh = q.shape
    _, Tkv, Hk, _ = k.shape
    return {"B": int(B), "Tq": int(Tq), "Tkv": int(Tkv), "H": int(H),
            "Hk": int(Hk), "Dh": int(Dh), "causal": True,
            "dtype": str(q.dtype).removeprefix("torch."),
            "device": str(q.device), **overrides}


def _shapes(spec: dict[str, Any]):
    dt = spec.get("dtype", "float32")
    q = (spec["B"], spec["Tq"], spec["H"], spec["Dh"])
    kv = (spec["B"], spec["Tkv"], spec["Hk"], spec["Dh"])
    return ((q, dt), (kv, dt), (kv, dt))


def _example_args(spec: dict[str, Any]) -> tuple:
    return tuple(example_fill(s, d, scale=0.1, device=spec.get("device"))
                 for s, d in _shapes(spec))


def _catalog_oracle(q, k, v):
    # the catalog registers causal attention only (_extract_spec pins
    # causal=True), so the oracle mirrors that fixed setting
    return attention_ref(q, k, v, causal=True)


KERNEL = KernelDef(
    name="attention",
    make_space=lambda spec: make_space(
        spec["Tq"], spec["Tkv"], spec["Dh"], vmem_kb=spec_capacity_kb(spec),
        hopper=spec_on_cuda(spec),
        dtype_bytes=_dtype(spec).itemsize),
    generate=_catalog_generate,
    cost_model=attention_cost_model,
    extract_spec=_extract_spec,
    example_args=_example_args,
    default_point=DEFAULT_POINT,
    oracle=_catalog_oracle,
    # flash blocks re-scale every partial softmax sum vs the oracle's
    # single full-row softmax
    tolerance={"rtol": 2e-3, "atol": 1e-5},
)


__all__ = [
    "DEFAULT_POINT",
    "KERNEL",
    "flash_attention_torch",
    "flash_attention_cuda",
    "flash_attention_plain",
    "decode_attention",
    "attention_ref",
    "make_space",
    "attention_cost_model",
]
