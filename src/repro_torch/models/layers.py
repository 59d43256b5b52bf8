"""Shared model layers: norms, RoPE/M-RoPE, GQA attention, MLPs, embeddings.

Mirrors ``repro/models/layers.py``: pure functions over param dicts
(declared via ParamDef), interleaved-pair RoPE, Qwen2-VL's M-RoPE, the
sinusoidal positions and cross-attention of the encoder-decoder family.
The reference's ``shard`` annotations stand at its own sites
(:func:`repro_torch.distributed.sharding.shard`): inside a rules scope
they redistribute DTensor activations, anywhere else each is one global
check and the identity. Its u16 bit views around bf16 caches (an
XLA:CPU workaround) drop out: the decode cache is updated in place, slot
by slot, instead of rebuilt.

**Sharded runs.** Under DTensor every product runs on local shards with
its placements stated in the rules' logical axes
(:func:`~repro_torch.distributed.sharding.pinned`): the projections, the
MLP, the logits, the token lookup, ``layer_norm`` and the decode cache's
slot write. DTensor's own strategies, which differ from one PyTorch
version to the next (2.11 gathered whole batches and caches where 2.13
did not), choose nothing there: a weight's FSDP dim is gathered and its
``heads`` / ``ffn`` / ``vocab`` dim stays split, as GSPMD lays the
reference out, the activations keep their batch rows, and a dim that
does not divide its mesh axis is split unevenly. Where the batch does
not split over its mesh axes (a decode of one sequence) the products
contract over the FSDP dim instead, so a region holds no nonlinearity
after a product whose contraction that dim splits. What is left to
DTensor is elementwise and views over whole dims. The hand kernels see
only local shards (``data_ptr()`` of a DTensor is not its shard).
``rms_norm`` runs on each rank's rows (``act_embed`` is replicated, so
each row is whole there) and attention on each rank's batch rows and
heads: where the rules shard the query heads over ``model`` and
replicate the KV heads (the train and prefill rules when the KV heads do
not divide the axis), each rank takes the KV heads its own query heads
read, so the local GQA map stays right on every rank.

**What runs where.** In the reference, the step-programs are jitted: the
layers see tracers there, never route through a kernel-plane handle, and
adopt the plane's best points at trace time. Here the model marks its
step-programs (:func:`~repro_torch.runtime.kernel_plane.step_program`)
and :func:`_plane_routes` answers ``None`` inside one, so a step never
calls a ``ManagedTuner`` (and the serve loop credits its busy time once,
as the reference does). Outside a step-program, with a plane active, an
eager call routes through the plane as in the reference. Otherwise:

  * on a CUDA tensor, ``rms_norm`` launches the rmsnorm hand kernel at
    its ``DEFAULT_POINT`` (the reference's jnp body has no knob), and
    attention without a window or an offset, causal (self-attention) or
    not (an encoder's self-attention, cross-attention over more than one
    query), launches the flash hand kernel with the plane's chunks (the
    config's for cross-attention, as in the reference), clamped to the
    sequence as ``flash_attention_pallas`` clamps its blocks. When grad
    mode is on and an input needs a gradient (training), the two go
    through ``RMSNormFunction`` and ``FlashAttentionFunction``, the same
    kernels under autograd; otherwise (serving, the plane's evaluations)
    the wrappers are called directly;
  * windowed or offset attention, decode attention (one query over the
    cache, self or cross), ``layer_norm``, and everything on the CPU, run
    the plain PyTorch versions (on the card, the flash kernel takes heads
    of 16, 64 and 128, and q and k of 192 over v of 128, and raises at
    any other head dims); so does latent attention's absorbed decode;
  * the projections, the MLP and the MoE experts are ``torch.matmul`` /
    ``torch.einsum`` in full fp32 (the reference leaves these einsums to
    XLA, outside any Pallas kernel), with TF32 off, PyTorch's default.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, YarnScaling
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import shard
from repro_torch.kernels.attention.attention import (
    FlashAttentionFunction, flash_attention_cuda)
from repro_torch.kernels.attention.ops import decode_attention, flash_attention_torch
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm.rmsnorm import (
    DEFAULT_POINT as RMSNORM_POINT, RMSNormFunction, rmsnorm_cuda)
from repro_torch.models.params import ParamDef
from repro_torch.runtime import spans
from repro_torch.runtime.kernel_plane import active_plane, in_step_program


# ------------------------------------------------------------ kernel plane
def _plane_routes():
    """The active kernel-tuning plane, when an eager call may route.

    Inside a step-program the coordinator-managed handle must not run
    (the reference's step-programs are traced, and the serve loop credits
    their time itself); those calls adopt the plane's best-known points
    (see :func:`plane_attn_chunks`) and keep the plain kernel body.
    """
    if in_step_program():
        return None
    return active_plane()


def plane_attn_chunks(cfg: ModelConfig) -> tuple[int, int]:
    """Attention chunk sizes: the plane's tuned blocks, else cfg defaults.

    A step-program run while a plane is active inherits the attention
    kernel's independently tuned ``block_q``/``block_kv`` instead of the
    config's chunk sizes (warm-started registries make this bite from the
    very first step of a restarted process).
    """
    plane = active_plane()
    if plane is not None and plane.adopt_points:
        best = plane.best_point("attention")
        if best is not None:
            return (int(best.get("block_q", cfg.attn_q_chunk)),
                    int(best.get("block_kv", cfg.attn_k_chunk)))
    return cfg.attn_q_chunk, cfg.attn_k_chunk


def plane_decode_chunk(cfg: ModelConfig) -> int:
    """Flash-decoding KV chunk: the plane's tuned ``k_chunk``, else cfg's.

    Suppressed, like the attention chunks, when a program-level tuner
    owns the knob ("both" mode).
    """
    plane = active_plane()
    if plane is not None and plane.adopt_points:
        best = plane.best_point("decode_attention")
        if best is not None:
            return int(best.get("k_chunk", cfg.decode_k_chunk))
    return cfg.decode_k_chunk


#: the families whose blocks the reference always checkpoints in full
_FULL_REMAT_FAMILIES = ("hybrid", "encdec")


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ----------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if shlib.is_dtensor(x):
        # each rank's whole rows through the kernel (or its plain version)
        x, scale = shlib.settle(x), shlib.replicated(scale)
        return shlib.on_local(lambda xl, wl: rms_norm(xl, wl, eps), x, scale,
                              out_like=x,
                              grad_placements=(None, shlib.partial_over(x)))
    plane = _plane_routes()
    shape = x.shape
    if plane is not None and eps == 1e-6 and x.dim() >= 2:
        # coordinator-managed handle: the kernel tuned as an independent
        # unit (block_rows its own space, own strategy)
        y = plane.call("rmsnorm", x.reshape(-1, shape[-1]), scale)
        if y is not None:
            return y.reshape(shape)
    if x.is_cuda:
        rows = x.reshape(-1, shape[-1]).contiguous()
        w = scale.to(x.dtype).contiguous()
        if _needs_grad(x, scale):
            return RMSNormFunction.apply(rows, w, eps).reshape(shape)
        return rmsnorm_cuda(rows, w, RMSNORM_POINT, eps=eps).reshape(shape)
    return rmsnorm_ref(x, scale, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if shlib.is_dtensor(x):
        # each rank's whole rows
        axes = ("batch",) + ("seq",) * (x.dim() - 2) + (None,)
        return shlib.pinned(lambda xl, wl: layer_norm(xl, wl, eps), x, scale,
                            axes=(axes, None), out_axes=axes,
                            out_shape=tuple(x.shape), out_dtype=x.dtype)
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def norm(x: torch.Tensor, scale: torch.Tensor, kind: str) -> torch.Tensor:
    return rms_norm(x, scale) if kind == "rmsnorm" else layer_norm(x, scale)


# ------------------------------------------------------------------ rope
def rope_freqs(d_head: int, theta: float, device=None,
               scaling: "YarnScaling | None" = None) -> torch.Tensor:
    """The rotation frequencies of ``d_head / 2`` pairs. Under YaRN
    (``scaling``, DeepSeek-V2's ``yarn_find_correction_range`` and
    ``yarn_linear_ramp_mask``): pairs below the correction range keep
    their frequency, pairs above it are divided by ``factor``, and a
    linear ramp blends the two between."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=device) / half)
    if scaling is None:
        return freqs

    def correction_dim(rotations: float) -> float:
        return (d_head * math.log(scaling.original_max_position_embeddings
                                  / (rotations * 2 * math.pi))) / (2 * math.log(theta))

    lo = max(math.floor(correction_dim(scaling.beta_fast)), 0)
    hi = min(math.ceil(correction_dim(scaling.beta_slow)), d_head - 1)
    ramp = ((torch.arange(half, dtype=torch.float32, device=device) - lo)
            / (hi - lo if hi != lo else 0.001)).clamp(0, 1)
    return freqs / scaling.factor * ramp + freqs * (1 - ramp)


def yarn_mscale(factor: float, mscale: float) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling: "YarnScaling | None" = None) -> torch.Tensor:
    """x: (B, T, H, Dh); positions: (B, T) int. Interleaved pairs; under
    YaRN (``scaling``) its frequencies, and cos and sin times its
    ``mscale`` over its ``mscale_all_dim`` (1 where the two are equal)."""
    B, T, H, Dh = x.shape
    freqs = rope_freqs(Dh, theta, x.device, scaling)           # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs       # (B, T, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]                        # (B, T, 1, Dh/2)
    sin = torch.sin(ang)[:, :, None, :]
    if scaling is not None:
        m = (yarn_mscale(scaling.factor, scaling.mscale)
             / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
    xp = x.to(torch.float32).reshape(B, T, H, Dh // 2, 2)
    x1, x2 = xp[..., 0], xp[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(B, T, H, Dh).to(x.dtype)


def apply_mrope(
    x: torch.Tensor, positions: torch.Tensor, theta: float,
    sections: tuple[int, ...],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. positions: (3, B, T) for (t, h, w).

    The Dh/2 frequency pairs are split into len(sections) groups; group i
    rotates by positions[i].
    """
    B, T, H, Dh = x.shape
    half = Dh // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to Dh/2 = {half}")
    freqs = rope_freqs(Dh, theta, x.device)                    # (half,)
    # Select which positional stream drives each frequency pair.
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device), output_size=half)  # (half,)
    pos = positions.to(torch.float32)[sec_id]                  # (half, B, T)
    ang = pos.permute(1, 2, 0) * freqs                         # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xp = x.to(torch.float32).reshape(B, T, H, half, 2)
    x1, x2 = xp[..., 0], xp[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(B, T, H, Dh).to(x.dtype)


def sinusoidal_embedding(T: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------------------------------------- attention
def attention_defs(cfg: ModelConfig, cross: bool = False) -> dict:
    d, H, Hk, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    defs = {
        "wq": ParamDef((d, H, Dh), ("embed", "heads", None),
                       scale=1.0 / math.sqrt(d)),
        "wk": ParamDef((d, Hk, Dh), ("embed", "kv", None),
                       scale=1.0 / math.sqrt(d)),
        "wv": ParamDef((d, Hk, Dh), ("embed", "kv", None),
                       scale=1.0 / math.sqrt(d)),
        "wo": ParamDef((H, Dh, d), ("heads", None, "embed"),
                       scale=1.0 / math.sqrt(H * Dh)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, Dh), ("heads", None), init="zeros")
        defs["bk"] = ParamDef((Hk, Dh), ("kv", None), init="zeros")
        defs["bv"] = ParamDef((Hk, Dh), ("kv", None), init="zeros")
    return defs


def _proj(x: torch.Tensor, w: torch.Tensor, axis: str = "heads") -> torch.Tensor:
    """x (B, T, d) @ w (d, *heads) -> (B, T, *heads), one matmul. Under
    DTensor, on local shards: each rank's batch rows against the weight's
    ``axis`` columns (:func:`_proj_flat` where the heads do not split
    evenly)."""
    if shlib.is_dtensor(x):
        if not shlib.splits_evenly(w.shape[1], axis, x.device_mesh):
            return _proj_flat(x, w, axis)
        return shlib.pinned(
            lambda xl, wl: _proj(xl, wl), x, w,
            axes=(("batch", "seq", "embed"), None),
            out_axes=("batch", "seq", axis, None),
            out_shape=(*x.shape[:-1], *w.shape[1:]), out_dtype=x.dtype)
    out = torch.matmul(x, w.to(x.dtype).reshape(w.shape[0], -1))
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def _proj_flat(x: torch.Tensor, w: torch.Tensor, axis: str) -> torch.Tensor:
    """:func:`_proj` for heads that do not split evenly over their mesh
    axis (40 query heads over 16, or KV heads the rules keep whole): each
    rank computes an even share of the flat heads x head-dim columns over
    the ``heads`` mesh axis; the result is gathered and each rank keeps
    its ``axis`` heads (all of them where ``axis`` is kept whole)."""
    flat = (*x.shape[:-1], math.prod(w.shape[1:]))
    shape = (*x.shape[:-1], *w.shape[1:])
    out_axes = ("batch", "seq", axis, None)
    n, lo = shlib.pinned_range(flat, ("batch", "seq", "heads"), x.device_mesh, 2)
    h, h0 = shlib.pinned_range(shape, out_axes, x.device_mesh, 2)
    cols = shlib.pinned(
        lambda xl, wl: torch.matmul(xl, wl.to(xl.dtype).reshape(wl.shape[0], -1)[:, lo:lo + n]),
        x, w, axes=(("batch", "seq", "embed"), ("embed", None, None)),
        out_axes=("batch", "seq", "heads"), out_shape=flat, out_dtype=x.dtype)
    return shlib.pinned(
        lambda cl: cl.reshape(*cl.shape[:-1], *w.shape[1:])[:, :, h0:h0 + h], cols,
        axes=(("batch", "seq", None),), out_axes=out_axes, out_shape=shape,
        out_dtype=x.dtype)


def qkv_proj(x: torch.Tensor, p: dict, cfg: ModelConfig):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"], "kv")
    v = _proj(x, p["wv"], "kv")
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv", None)
    v = shard(v, "batch", "seq", "kv", None)
    return q, k, v


def attn_out(o: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    B, T, H, Dh = o.shape
    if shlib.is_dtensor(o):
        if shlib.splits_evenly(H, "heads", o.device_mesh):
            # each rank's batch rows and heads against the same heads'
            # rows of wo: a pending sum over the heads' mesh axis
            out = shlib.pinned(
                lambda ol, wl: attn_out(ol, {"wo": wl}, cfg), o, p["wo"],
                axes=(("batch", "seq", "heads", None), None),
                out_axes=("batch", "seq", "embed"), out_shape=(B, T, p["wo"].shape[-1]),
                out_dtype=o.dtype)
        else:
            out = _attn_out_flat(o, p["wo"])
        return shard(out, "batch", "seq", "embed")
    w = p["wo"].to(o.dtype)
    out = torch.matmul(o.reshape(B, T, H * Dh), w.reshape(H * Dh, w.shape[-1]))
    return shard(out, "batch", "seq", "embed")


def _attn_out_flat(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """:func:`attn_out` for heads that do not split evenly over their mesh
    axis: the heads gathered, each rank takes an even share of the flat
    heads x head-dim rows (over the ``heads`` mesh axis) and of ``wo``'s:
    a pending sum over that axis."""
    B, T, H, Dh = o.shape
    flat = (B, T, H * Dh)
    n, lo = shlib.pinned_range(flat, ("batch", "seq", "heads"), o.device_mesh, 2)
    cols = shlib.pinned(
        lambda ol: ol.reshape(*ol.shape[:2], -1)[..., lo:lo + n], o,
        axes=(("batch", "seq", None, None),), out_axes=("batch", "seq", "heads"),
        out_shape=flat, out_dtype=o.dtype)
    return shlib.pinned(
        lambda cl, wl: torch.matmul(cl, wl.to(cl.dtype).reshape(H * Dh, -1)[lo:lo + n]),
        cols, wo, axes=(("batch", "seq", "heads"), (None, None, "embed")),
        out_axes=("batch", "seq", "embed"), out_shape=(B, T, wo.shape[-1]),
        out_dtype=o.dtype)


def _rotate(q, k, positions, cfg: ModelConfig):
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif positions is not None:
        pos2d = positions if positions.dim() == 2 else positions[None]
        q = apply_rope(q, pos2d, cfg.rope_theta)
        k = apply_rope(k, pos2d, cfg.rope_theta)
    return q, k


def _attend(q, k, v, cfg: ModelConfig, *, causal: bool, q_offset: int = 0,
            chunks: tuple[int, int] | None = None, scale: float | None = None):
    """The step-programs' attention (see the module docstring): the
    plane's chunks unless ``chunks`` are given; ``scale`` the scores'
    (``Dh ** -0.5`` by default)."""
    qc, kc = chunks if chunks is not None else plane_attn_chunks(cfg)
    if shlib.is_dtensor(q):
        return _attend_local(q, k, v, cfg, causal=causal, q_offset=q_offset,
                             chunks=(qc, kc), scale=scale)
    if q.is_cuda and q_offset == 0 and cfg.window is None:
        point = {"block_q": min(qc, q.shape[1]), "block_kv": min(kc, k.shape[1])}
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _needs_grad(q, k, v):
            return FlashAttentionFunction.apply(q, k, v, point, causal, scale)
        return flash_attention_cuda(q, k, v, point, causal=causal, scale=scale)
    return flash_attention_torch(
        q, k, v, causal=causal, scale=scale, q_offset=q_offset, window=cfg.window,
        q_chunk=qc, k_chunk=kc, scores_f32=cfg.attn_scores_f32,
        # inside a block checkpointed in full the attention checkpoints its
        # own chunks too, as the reference's does; under remat "dots" the
        # port recomputes every product of the block instead
        # (``repro_torch/models/transformer.py``)
        recompute=cfg.remat == "full" or cfg.family in _FULL_REMAT_FAMILIES)


def _kv_pick(q, k):
    """Which of its local KV heads each local query head reads.

    Local query head ``i`` is global head ``off + i`` and reads KV head
    ``(off + i) // G``. ``None`` where the local call's own GQA map
    (``i // (h / hk)``) already gives that; a slice where the rank's query
    heads cover whole groups (query heads sharded, KV heads replicated);
    else one KV head per query head, by index.
    """
    G = q.shape[2] // k.shape[2]
    h, off = shlib.local_range(q, 2)
    hk, koff = shlib.local_range(k, 2)
    need = [(off + i) // G - koff for i in range(h)]
    if hk and h % hk == 0 and need == [i // (h // hk) for i in range(h)]:
        return None
    if h % G == 0 and off % G == 0:
        return slice(need[0], need[-1] + 1)
    return need


def _take_heads(kl, vl, pick):
    if isinstance(pick, slice):
        return kl[:, :, pick], vl[:, :, pick]
    if pick is not None:
        idx = torch.tensor(pick, device=kl.device)
        return kl.index_select(2, idx), vl.index_select(2, idx)
    return kl, vl


def _attend_local(q, k, v, cfg: ModelConfig, *, causal: bool, q_offset: int,
                  chunks: tuple[int, int], scale: float | None = None):
    """:func:`_attend` on each rank's batch rows and heads, the rank's KV
    heads picked by :func:`_kv_pick` (so the local GQA map stays right on
    every rank where the query heads are sharded and the KV heads are
    not)."""
    from torch.distributed.tensor import Partial, Shard

    q, k, v = shlib.settle(q), shlib.settle(k), shlib.settle(v)
    pick = _kv_pick(q, k)
    # K/V replicated where the queries are split: each rank's gradient
    # is its query heads' share of the sum
    kv_grad = tuple(
        Partial() if isinstance(pq, Shard) and not isinstance(pk, Shard) else pk
        for pq, pk in zip(q.placements, k.placements))

    def local(ql, kl, vl):
        kl, vl = _take_heads(kl, vl, pick)
        return _attend(ql, kl, vl, cfg, causal=causal, q_offset=q_offset,
                       chunks=chunks, scale=scale)

    return shlib.on_local(local, q, k, v, out_like=q,
                          grad_placements=(None, kv_grad, kv_grad))


def _decode_local(q, k, v, *, length, k_chunk: int):
    """``decode_attention`` on each rank's shards of one query and a
    (B, S, Hk, Dh) cache. The query is laid out as the cache on its batch
    and head-dim mesh dims; where the cache's head dim is split
    (``kv_dh``), each chunk's scores are summed over those ranks before
    the softmax (the reference's psum of the score contraction); the
    output is laid out as the query came in."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    q, k, v = shlib.settle(q), shlib.settle(k), shlib.settle(v)
    mesh = k.device_mesh
    q_pl = q.placements
    target, dh_dims = [], []
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if pk.is_shard(3):
            dh_dims.append(i)
            target.append(Shard(3))
        elif pk.is_shard(0) or pk.is_shard(2):
            target.append(pk)
        else:
            target.append(pq if pq.is_shard(2) else Replicate())
    q = q.redistribute(mesh, tuple(target))
    pick = _kv_pick(q, k)
    scale = q.shape[-1] ** -0.5

    def reduce(s):
        for i in dh_dims:
            s = funcol.all_reduce(s, "sum", (mesh, i))
        return s

    def local(ql, kl, vl):
        kl, vl = _take_heads(kl, vl, pick)
        return decode_attention(ql, kl, vl, length=length, scale=scale,
                                k_chunk=k_chunk,
                                reduce_scores=reduce if dh_dims else None)

    o = shlib.on_local(local, q, k, v, out_like=q)
    return o.redistribute(mesh, q_pl)


def self_attention(
    x: torch.Tensor,
    p: dict,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full-sequence attention (train / prefill / encoder)."""
    if cfg.kv_lora_rank:
        return _mla_expanded(x, p, cfg, positions)[0]
    q, k, v = qkv_proj(x, p, cfg)
    q, k = _rotate(q, k, positions, cfg)
    plane = _plane_routes()
    o = None
    if (plane is not None and causal and q_offset == 0
            and cfg.window is None):
        # eager call with an active plane: the flash kernel runs as an
        # independently tuned coordinator-managed unit
        o = plane.call("attention", q.contiguous(), k.contiguous(), v.contiguous())
    if o is None:
        o = _attend(q, k, v, cfg, causal=causal, q_offset=q_offset)
    return attn_out(o, p, cfg)


def self_attention_with_cache(
    x: torch.Tensor,
    p: dict,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Prefill: returns output and the (k, v) cache to keep (under latent
    attention the normed latent and the rotated shared rope key:
    :func:`_mla_expanded`)."""
    if cfg.kv_lora_rank:
        return _mla_expanded(x, p, cfg, positions)
    q, k, v = qkv_proj(x, p, cfg)
    q, k = _rotate(q, k, positions, cfg)
    o = _attend(q, k, v, cfg, causal=True)
    return attn_out(o, p, cfg), (k, v)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """``cache[:, slot] = new[:, 0]``, in place. Under DTensor each rank
    writes its own shard, the new entry laid out as the cache is: an
    in-place write through DTensor's own rules may gather the cache."""
    if shlib.is_dtensor(cache):
        new = new.redistribute(cache.device_mesh, cache.placements)
        cache, new = cache.to_local(), new.to_local()
    cache[:, slot] = new[:, 0].to(cache.dtype)


def decode_self_attention(
    x: torch.Tensor,                 # (B, 1, d)
    p: dict,
    cfg: ModelConfig,
    cache_k: torch.Tensor,           # (B, S, Hk, Dh), updated in place
    cache_v: torch.Tensor,
    pos: int,                        # cache write slot
    rope_pos: int | None = None,     # rotary position (defaults to pos;
                                     # differs for VLM, where vision
                                     # patches share a grid position)
):
    """One-token decode against a KV cache.

    The new token's k and v are written into the cache in place (the
    reference returns an updated copy that XLA aliases with its input).
    Under latent attention the cache is the latent one and the step the
    absorbed one (:func:`_mla_decode`).
    """
    if cfg.kv_lora_rank:
        return _mla_decode(x, p, cfg, cache_k, cache_v, pos, rope_pos)
    q, k, v = qkv_proj(x, p, cfg)
    B = x.shape[0]
    positions = torch.full((B, 1), rope_pos if rope_pos is not None else pos,
                           dtype=torch.int32, device=x.device)
    if cfg.mrope_sections is not None:
        pos3 = positions[None].expand(3, B, 1)
        q = apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    S = cache_k.shape[1]
    if cfg.window is not None and cfg.window < S:
        slot = pos % cfg.window
        S_eff = cfg.window
    else:
        # the reference writes with dynamic_update_slice, which clamps the
        # start to S - 1: a windowed cache sized at the window (hymba's,
        # W = min(max_len, window)) takes every token past W at slot W - 1
        slot = min(pos, S - 1)
        S_eff = S
    _write_slot(cache_k, k, slot)
    _write_slot(cache_v, v, slot)
    cache_k = shard(cache_k, "batch", "kv_seq", "kv", "kv_dh")
    cache_v = shard(cache_v, "batch", "kv_seq", "kv", "kv_dh")
    length = min(pos + 1, S_eff)
    plane = _plane_routes()
    o = None
    if shlib.is_dtensor(q):
        o = _decode_local(q, cache_k, cache_v, length=length,
                          k_chunk=plane_decode_chunk(cfg))
    elif plane is not None:
        # eager call with an active plane: flash-decoding runs as an
        # independently tuned unit, keyed per cache-length bucket
        o = plane.call("decode_attention", q, cache_k, cache_v, length)
    if o is None:
        o = decode_attention(q, cache_k, cache_v, length=length,
                             k_chunk=plane_decode_chunk(cfg))
    return attn_out(o, p, cfg), (cache_k, cache_v)


# ------------------------------------------------------ latent attention
def mla_defs(cfg: ModelConfig) -> dict:
    """DeepSeek-V2's latent attention without a query latent (``q_lora_rank``
    null): ``wq`` to every head's [nope | rope] query, ``wkv_a`` to the
    latent and the one rope key all heads share, the latent's RMSNorm,
    ``wkv_b`` from the latent to every head's [nope key | value], ``wo``."""
    d, H, R = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": ParamDef((d, H, nope + rope), ("embed", "heads", None),
                       scale=1.0 / math.sqrt(d)),
        "wkv_a": ParamDef((d, R + rope), ("embed", None), scale=1.0 / math.sqrt(d)),
        "kv_norm": ParamDef((R,), (None,), init="ones"),
        "wkv_b": ParamDef((R, H, nope + dv), (None, "heads", None),
                          scale=1.0 / math.sqrt(R)),
        "wo": ParamDef((H, dv, d), ("heads", None, "embed"),
                       scale=1.0 / math.sqrt(H * dv)),
    }


def mla_scale(cfg: ModelConfig) -> float:
    """The scores' scale: ``(nope + rope) ** -0.5``, under YaRN times
    ``yarn_mscale(factor, mscale_all_dim)`` squared."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.rope_scaling is not None:
        m = yarn_mscale(cfg.rope_scaling.factor, cfg.rope_scaling.mscale_all_dim)
        scale *= m * m
    return scale


def _mla_project(x, p, cfg: ModelConfig, positions):
    """One ``mla.project`` span: the queries (B, T, H, nope + rope), their
    rope part rotated, the normed latent (B, T, 1, R) and the rotated rope
    key (B, T, 1, rope)."""
    nope, R = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    with spans.layer("mla.project"):
        q = _proj(x, p["wq"])
        ckv = torch.matmul(x, p["wkv_a"].to(x.dtype))
        c = rms_norm(ckv[..., :R], p["kv_norm"])[:, :, None]
        k_pe = apply_rope(ckv[:, :, None, R:], positions, cfg.rope_theta, cfg.rope_scaling)
        q_pe = apply_rope(q[..., nope:], positions, cfg.rope_theta, cfg.rope_scaling)
        q = torch.cat([q[..., :nope], q_pe], dim=-1)
    return q, c, k_pe


def _mla_expanded(x, p, cfg: ModelConfig, positions):
    """Latent attention over a whole sequence, expanded: the latent
    through ``wkv_b`` (``mla.expand``) to every head's nope key and value,
    the keys [nope | the shared rope key], causal flash attention at q and
    k head dim nope + rope and v head dim ``v_head_dim`` (``mla.attend``).
    Returns the output and the cache to keep: the normed latent and the
    rotated rope key."""
    pos2d = positions if positions.dim() == 2 else positions[None]
    q, c, k_pe = _mla_project(x, p, cfg, pos2d)
    B, T, H, _ = q.shape
    nope = cfg.qk_nope_head_dim
    with spans.layer("mla.expand"):
        kv = _proj(c[:, :, 0], p["wkv_b"])                      # (B, T, H, nope + dv)
        k = torch.cat([kv[..., :nope], k_pe.expand(B, T, H, -1)], dim=-1)
        v = kv[..., nope:]
    with spans.layer("mla.attend", keys=T, path="flash"):
        o = _attend(q, k, v, cfg, causal=True, scale=mla_scale(cfg))
    return attn_out(o, p, cfg), (c, k_pe)


def _mla_decode(x, p, cfg: ModelConfig, cache_c, cache_pe, pos: int,
                rope_pos: int | None = None):
    """One token of latent attention, absorbed, over the latent cache alone
    (``cache_c`` (B, S, 1, R), ``cache_pe`` (B, S, 1, rope), the new slot
    written in place): each head's nope query through its ``wkv_b`` key
    columns into the latent (``mla.absorb``), scores against the latents
    and the rope keys, the softmax in fp32, the weighted sum of the
    latents (``mla.attend``), then each head's value columns
    (``mla.unabsorb``). Products in the compute type, which accumulate in
    fp32; no key or value of 16 heads is ever built."""
    B = x.shape[0]
    positions = torch.full((B, 1), rope_pos if rope_pos is not None else pos,
                           dtype=torch.int32, device=x.device)
    q, c, k_pe = _mla_project(x, p, cfg, positions)
    S = cache_c.shape[1]
    slot = min(pos, S - 1)
    _write_slot(cache_c, c, slot)
    _write_slot(cache_pe, k_pe, slot)
    length = min(pos + 1, S)
    nope = cfg.qk_nope_head_dim
    w_kv = p["wkv_b"].to(x.dtype)                               # (R, H, nope + dv)
    with spans.layer("mla.absorb"):
        q_lat = torch.einsum("bhn,rhn->bhr", q[:, 0, :, :nope], w_kv[..., :nope])
    with spans.layer("mla.attend", keys=length, path="latent"):
        lat = cache_c[:, :length, 0]                            # (B, length, R)
        s = (torch.bmm(q_lat, lat.transpose(1, 2)).float()
             + torch.bmm(q[:, 0, :, nope:], cache_pe[:, :length, 0].transpose(1, 2)).float())
        w = torch.softmax(s * mla_scale(cfg), dim=-1)
        o_lat = torch.bmm(w.to(lat.dtype), lat)                 # (B, H, R)
    with spans.layer("mla.unabsorb"):
        o = torch.einsum("bhr,rhv->bhv", o_lat, w_kv[..., nope:])
    return attn_out(o[:, None], p, cfg), (cache_c, cache_pe)


def cross_attention_defs(cfg: ModelConfig) -> dict:
    return attention_defs(cfg)


def cross_attention(
    x: torch.Tensor, p: dict, cfg: ModelConfig,
    enc_k: torch.Tensor, enc_v: torch.Tensor,
) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V: one query
    through flash-decoding, more through non-causal flash attention at
    the config's chunks."""
    q = _proj(x, p["wq"])
    if x.shape[1] == 1 and shlib.is_dtensor(q):
        o = _decode_local(q, enc_k, enc_v, length=None,
                          k_chunk=plane_decode_chunk(cfg))
    elif x.shape[1] == 1:
        o = decode_attention(q, enc_k, enc_v, k_chunk=plane_decode_chunk(cfg))
    else:
        o = _attend(q, enc_k, enc_v, cfg, causal=False,
                    chunks=(cfg.attn_q_chunk, cfg.attn_k_chunk))
    return attn_out(o, p, cfg)


def encoder_kv(p: dict, cfg: ModelConfig, enc_out: torch.Tensor):
    return _proj(enc_out, p["wk"], "kv"), _proj(enc_out, p["wv"], "kv")


# ------------------------------------------------------------------- mlp
def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(ff)
    if cfg.act == "swiglu":
        return {
            "w_gate": ParamDef((d, ff), ("embed", "ffn"), scale=s_in),
            "w_up": ParamDef((d, ff), ("embed", "ffn"), scale=s_in),
            "w_down": ParamDef((ff, d), ("ffn", "embed"), scale=s_out),
        }
    return {
        "w_up": ParamDef((d, ff), ("embed", "ffn"), scale=s_in),
        "w_down": ParamDef((ff, d), ("ffn", "embed"), scale=s_out),
    }


def mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    up = ("w_gate", "w_up") if cfg.act == "swiglu" else ("w_up",)
    if shlib.is_dtensor(x):
        # each rank's batch rows through its ffn columns (two regions: the
        # up products may be pending sums over the FSDP dim), the down
        # product a pending sum over the ffn's mesh axis
        rows, cols = ("batch", "seq", "embed"), ("batch", "seq", "ffn")
        hid = (*x.shape[:-1], p["w_up"].shape[-1])
        gu = shlib.pinned(
            lambda xl, *ws: tuple(torch.matmul(xl, w.to(xl.dtype)) for w in ws),
            x, *(p[n] for n in up), axes=(rows, *(None for _ in up)),
            out_axes=(cols,) * len(up), out_shape=(hid,) * len(up),
            out_dtype=(x.dtype,) * len(up))
        out = shlib.pinned(lambda wd, *gl: _mlp_down(gl, wd, cfg), p["w_down"], *gu,
                           axes=(None, *(cols for _ in up)), out_axes=rows,
                           out_shape=tuple(x.shape), out_dtype=x.dtype)
        return shard(out, "batch", "seq", "embed")
    gu = tuple(torch.matmul(x, p[n].to(x.dtype)) for n in up)
    return shard(_mlp_down(gu, p["w_down"], cfg), "batch", "seq", "embed")


def _mlp_down(gu, w_down, cfg: ModelConfig):
    """The MLP's activation of its up products ``gu`` and its down
    product."""
    if cfg.act == "swiglu":
        h = torch.nn.functional.silu(gu[0]) * gu[1]
    else:
        h = (torch.nn.functional.gelu(gu[0], approximate="tanh") if cfg.act == "gelu"
             else torch.square(torch.relu(gu[0])))
    h = shard(h, "batch", "seq", "ffn")
    return torch.matmul(h, w_down.to(h.dtype))


# ------------------------------------------------------------- embeddings
def embedding_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
        "unembed": ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                            scale=1.0 / math.sqrt(cfg.d_model)),
    }


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. Under DTensor, on local shards: each rank looks
    its batch rows' tokens up in its rows of the table (its ``embed``
    gathered), a token outside them reading zeros, so that the result is
    a pending sum over the mesh axes that split the vocabulary."""
    if not shlib.is_dtensor(table):
        return table[tokens]
    axes = (("vocab", "embed"), ("batch", "seq"))
    v, lo = shlib.pinned_range(table.shape, axes[0], table.device_mesh, 0)

    def rows(tl, ix):
        if v == table.shape[0]:
            return tl[ix]
        local = ix.long() - lo
        inside = ((local >= 0) & (local < v)).unsqueeze(-1)
        return torch.where(inside, tl[local.clamp(0, v - 1)], 0)

    return shlib.pinned(rows, table, tokens, axes=axes,
                        out_axes=("batch", "seq", "embed"),
                        out_shape=(*tokens.shape, table.shape[1]), out_dtype=table.dtype)


def embed_tokens(tokens: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    return shard(lookup(p["embed"].to(cfg.compute_dtype), tokens), "batch", "seq", "embed")


def logits_out(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if shlib.is_dtensor(x):
        # each rank's batch rows against its vocabulary columns, then the
        # cap on the settled product
        vocab = ("batch", "seq", "vocab")
        shape = (*x.shape[:-1], p["unembed"].shape[-1])
        logits = shlib.pinned(
            lambda xl, wl: torch.matmul(xl, wl.to(xl.dtype)), x, p["unembed"],
            axes=(("batch", "seq", "embed"), ("embed", "vocab")),
            out_axes=vocab, out_shape=shape, out_dtype=x.dtype)
        if not cfg.logit_softcap:
            return logits
        return shlib.pinned(lambda ll: _softcap(ll, cfg), logits, axes=(vocab,),
                            out_axes=vocab, out_shape=shape, out_dtype=x.dtype)
    logits = torch.matmul(x, p["unembed"].to(x.dtype))
    return _softcap(shard(logits, "batch", "seq", "vocab"), cfg)


def _softcap(logits, cfg: ModelConfig):
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token negative log-likelihood over one rank's slice [lo, lo +
    v) of the vocabulary: the max, the sum of exponentials and the gold
    logit are reduced over ``groups`` (the mesh dims that split the
    vocabulary), and the gradient is each rank's slice of softmax minus
    one-hot, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, groups):
        import torch.distributed._functional_collectives as funcol

        ctx.dtype = logits.dtype
        x = logits.to(torch.float32)
        v = x.shape[-1]
        m = x.amax(dim=-1)
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
        e = torch.exp(x - m.unsqueeze(-1))
        total = e.sum(dim=-1)
        for g in groups:
            total = funcol.all_reduce(total, "sum", g)
        local = labels.long() - lo
        inside = ((local >= 0) & (local < v)).to(torch.float32)
        idx = local.clamp(0, v - 1).unsqueeze(-1)
        gold = torch.gather(x, -1, idx).squeeze(-1) * inside
        for g in groups:
            gold = funcol.all_reduce(gold, "sum", g)
        ctx.save_for_backward(e, total, idx, inside)
        return torch.log(total) + m - gold

    @staticmethod
    def backward(ctx, grad):
        e, total, idx, inside = ctx.saved_tensors
        p = e / total.unsqueeze(-1)
        p = p.scatter_add(-1, idx, -inside.unsqueeze(-1))
        return (p * grad.unsqueeze(-1)).to(ctx.dtype), None, None, None


def _vocab_parallel_nll(logits, labels, split: list[int]):
    """The per-token NLL of ``logits`` whose vocabulary the mesh dims
    ``split`` shard, on local shards (:class:`_VocabParallelNLL`): the
    logits are never gathered whole."""
    from torch.distributed.tensor import Replicate

    mesh = logits.device_mesh
    logits = shlib.settle(logits)
    tok_pl = tuple(Replicate() if i in split else p
                   for i, p in enumerate(logits.placements))
    labels = shlib.settle(labels).redistribute(mesh, tok_pl)
    _, lo = shlib.local_range(logits, 2)
    groups = [(mesh, i) for i in split]
    out = shlib.template(logits, logits.shape[:2], torch.float32, tok_pl)
    return shlib.on_local(
        lambda x, y: _VocabParallelNLL.apply(x, y, lo, groups), logits, labels,
        out_like=out)


def cross_entropy(
    logits: torch.Tensor,      # (B, T, V)
    labels: torch.Tensor,      # (B, T) int
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    split = [i for i, p in enumerate(logits.placements)
             if p.is_shard(2) and logits.device_mesh.size(i) > 1] \
        if shlib.is_dtensor(logits) else []
    if split:
        nll = _vocab_parallel_nll(logits, labels, split)
    else:
        logits = logits.to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        # gathered and subtracted at (B, T, 1): a DTensor gather over
        # sharded vocab holds a masked partial sum, settled at that shape
        gold = torch.gather(logits, -1, labels.long().unsqueeze(-1))
        nll = (lse.unsqueeze(-1) - gold).squeeze(-1)
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
