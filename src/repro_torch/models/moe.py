"""Mixture-of-Experts FFN: GShard-style grouped capacity dispatch.

Mirrors ``repro/models/moe.py``. Tokens are reshaped into groups of
``moe_group_size`` (the ragged tail zero-padded). Each of the top-k
routing choices keeps the reference's top-1 slice semantics: slice j
places a token in its expert's queue by a cumsum over the group, at
capacity C per expert and slice, and a choice past C is dropped (it
passes through with zero contribution, as in GShard/Switch). The port
stacks the k slices along the capacity axis (slot ``j * C + pos`` of
an expert's k * C), so one dispatch tensor carries them all and the
expert products run once over the stack: a pass reads each expert's
weights once, where the reference's loop of k dispatches reads them k
times. Only the order of the combine's summation differs. The stack
runs in chunks of ``max(1, G // top_k)`` groups, so a chunk's
intermediates are no larger than one of the reference's slices when
G >= top_k; a decode step (one group) is one pass. A load-balancing
auxiliary loss is returned.

The reference's ``shard`` annotations stand at its own sites. Under
DTensor (a sharded run) the routing and the dispatch have no DTensor
sharding strategy (sort, one-hot, cumsum), so both run on local shards
between those annotations: the routing on each rank's groups (the
groups follow the batch; each rank of the model axis routes the same
groups), the dispatch, expert products and combine on each rank's
groups and its own experts (``expert`` -> ``model``; the weights'
FSDP dim is gathered first), whose combined output is a partial sum over
the model axis that the closing ``shard`` reduces. The load-balancing
loss takes each rank's sums over its groups, reduced over the batch
axes. The router (in fp32) and the expert products are plain PyTorch
products (``@``, ``bmm``): the reference computes them outside any
Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import shard
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef
from repro_torch.runtime import spans


def moe_defs(cfg: ModelConfig) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(ff)
    defs = {
        "router": ParamDef((d, E), ("embed", None), scale=s_in),
        "w_gate": ParamDef((E, d, ff), ("expert", "embed", None), scale=s_in),
        "w_up": ParamDef((E, d, ff), ("expert", "embed", None), scale=s_in),
        "w_down": ParamDef((E, ff, d), ("expert", None, "embed"), scale=s_out),
    }
    if cfg.n_shared_experts:
        defs["shared"] = L.mlp_defs(cfg, d_ff=cfg.d_ff * cfg.n_shared_experts)
    return defs


def capacity(cfg: ModelConfig, group_len: int | None = None) -> int:
    S = group_len if group_len is not None else cfg.moe_group_size
    return max(4, math.ceil(S / cfg.n_experts * cfg.capacity_factor))


def route(xg: torch.Tensor, router: torch.Tensor, k: int, renormalise: bool = True):
    """fp32 router over groups xg (G, S, d): softmax probabilities
    (G, S, E), the top-k gates (renormalised to sum to one unless
    ``renormalise`` is False: DeepSeek-V2's ``norm_topk_prob``) and their
    expert indices (G, S, k). Equal probabilities (the zero-padded tail's
    are uniform) go to the lower expert index first, as ``jax.lax.top_k``
    orders them: a stable descending sort, where ``torch.topk`` promises
    no order among ties."""
    logits = xg.to(torch.float32) @ router.to(torch.float32)           # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_idx = gate_w[..., :k], gate_idx[..., :k]
    if renormalise:
        gate_w = gate_w / torch.clamp(gate_w.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_w, gate_idx


def _aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor, E: int, k: int):
    """Switch/GShard load-balancing aux loss over all tokens: E times the
    mean probability of each expert dotted with its share of the choices."""
    n = gate_idx.shape[0] * gate_idx.shape[1]
    return torch.dot(probs.mean(dim=(0, 1)), _expert_counts(gate_idx, E)) * (E / (n * k))


def _expert_counts(gate_idx: torch.Tensor, E: int) -> torch.Tensor:
    """The top-k choices each expert got, (E,) in fp32."""
    return F.one_hot(gate_idx, E).sum(dim=(0, 1, 2), dtype=torch.float32)


def _slots(gate_w, gate_idx, C: int, E: int, dtype):
    """The dispatch and combine tensors (G, S, E * k * C) of all k routing
    choices at once. Choice j of a token takes slot ``j * C + pos`` of its
    expert's k * C, ``pos`` its place in that expert's queue of slice j (a
    cumsum over the group, per slice, as the reference's top-1 slices have
    it); a choice at ``pos >= C`` is dropped (a zero there). The combine
    holds the choice's gate in the same slot."""
    G, S, k = gate_idx.shape
    onehot = F.one_hot(gate_idx, E)                                     # (G, S, k, E)
    # the choice's place in its expert's queue of its slice, from 1
    n = torch.cumsum(onehot, dim=1).gather(-1, gate_idx[..., None])[..., 0]
    keep = (n <= C).to(dtype)                                           # (G, S, k)
    # one slot a choice; a dropped one's (clamped) slot gets the zero
    slot = (gate_idx * (k * C) + n.clamp(max=C)
            + torch.arange(-1, k * C - 1, C, device=gate_idx.device))
    dispatch = torch.zeros(G, S, E * k * C, dtype=dtype, device=gate_idx.device)
    combine = torch.zeros_like(dispatch).scatter_(-1, slot, keep * gate_w.to(dtype))
    return dispatch.scatter_(-1, slot, keep), combine


def _experts(xg, gate_w, gate_idx, w_gate, w_up, w_down, cfg: ModelConfig,
             C: int, experts: "tuple[int, int] | None" = None):
    """All k routing choices through the experts ``experts`` (a [lo, hi)
    range of the E; all when None), stacked, in chunks of
    ``max(1, G // k)`` groups: the combined output over those experts.
    The products are ``bmm``: the dispatch over each group's tokens, the
    experts over each expert's k * C slots of every group in the chunk,
    the combine over each group's slots."""
    G, S, d = xg.shape
    k = cfg.top_k
    lo, hi = experts or (0, cfg.n_experts)
    E, kC = hi - lo, k * C
    step = max(1, G // k)
    outs = []
    for g0 in range(0, G, step):
        chunk = slice(g0, g0 + step)
        xc = xg[chunk]
        g = xc.shape[0]
        with spans.layer("moe.dispatch", slices=k, groups=g):
            dispatch, combine = _slots(gate_w[chunk], gate_idx[chunk], C,
                                       cfg.n_experts, xg.dtype)
            dispatch, combine = dispatch[..., lo * kC:hi * kC], combine[..., lo * kC:hi * kC]
            xe = torch.bmm(dispatch.transpose(1, 2), xc).view(g, E, kC, d)
            xe = shard(xe, "groups", "expert", None, None)
            xe = xe.transpose(0, 1).reshape(E, g * kC, d)       # a view at one group
        with spans.layer("moe.experts"):
            h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
            ye = torch.bmm(h, w_down).view(E, g, kC, d).transpose(0, 1)
            ye = shard(ye, "groups", "expert", None, None)      # (G, E, kC, d)
        with spans.layer("moe.combine"):
            outs.append(torch.bmm(combine, ye.reshape(g, E * kC, d)))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _moe_sharded(xg, p: dict, cfg: ModelConfig, C: int):
    """Routing, then dispatch/experts/combine, each on local shards (see
    the module docstring): (output, a partial sum over the model axis;
    aux loss)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    E, k = cfg.n_experts, cfg.top_k
    mesh = xg.device_mesh
    names = tuple(mesh.mesh_dim_names)
    xg = shlib.settle(xg)
    router = shlib.replicated(p["router"])
    like_k = shlib.template(xg, (xg.shape[0], xg.shape[1], k), torch.float32)
    # the aux loss's sums over this rank's groups: pending sums over its
    # batch axes, reduced here
    like_sum = shlib.template(xg, (E,), torch.float32, shlib.partial_over(xg))

    def routing(xl, rl):
        probs, gate_w, gate_idx = route(xl, rl, k, cfg.norm_topk_prob)
        return probs.sum(dim=(0, 1)), gate_w, gate_idx, _expert_counts(gate_idx, E)

    with spans.layer("moe.route"):
        p_sum, gate_w, gate_idx, c_sum = shlib.on_local(
            routing, xg, router,
            out_like=(like_sum, like_k, shlib.template(xg, like_k.shape, torch.int64),
                      like_sum),
            grad_placements=(None, shlib.partial_over(xg)))
        n_tok = xg.shape[0] * xg.shape[1]
        aux = E * torch.sum((shlib.settle(p_sum) / n_tok) * (shlib.settle(c_sum) / n_tok / k))

    m = names.index("model")
    # experts over the model axis, whole on the others (the FSDP gather)
    w_pl = tuple(Shard(0) if i == m else Replicate() for i in range(len(names)))
    ws = [p[n].to(xg.dtype).redistribute(mesh, w_pl)
          for n in ("w_gate", "w_up", "w_down")]
    n_local, lo = shlib.local_range(ws[0], 0)
    over_model = tuple(Partial() if i == m else pl
                       for i, pl in enumerate(xg.placements))
    out_like = shlib.template(xg, tuple(xg.shape), xg.dtype, over_model)
    w_grad = tuple(Partial() if i != m and xg.placements[i].is_shard() else pl
                   for i, pl in enumerate(w_pl))

    def experts(xl, gw, gi, wg, wu, wd):
        return _experts(xl, gw, gi, wg, wu, wd, cfg, C, (lo, lo + n_local))

    out = shlib.on_local(experts, xg, gate_w, gate_idx, *ws, out_like=out_like,
                         grad_placements=(over_model, over_model, None,
                                          w_grad, w_grad, w_grad))
    return out, aux


def _shards(x, dim: int) -> int:
    n = 1
    for i, pl in enumerate(x.placements):
        if pl.is_shard(dim):
            n *= x.device_mesh.size(i)
    return n


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out, aux_loss): one ``moe`` span of the layer tier
    (:mod:`repro_torch.runtime.spans`), with ``moe.route`` and, per chunk
    of groups, ``moe.dispatch`` (attributes ``slices``, ``groups``),
    ``moe.experts`` and ``moe.combine`` inside."""
    with spans.layer("moe"):
        return _moe_ffn(x, p, cfg)


def _moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * T
    S = min(cfg.moe_group_size, N)
    G = -(-N // S)
    Np = G * S
    C = capacity(cfg, S)

    x_flat = x.reshape(N, d)
    if Np != N:   # ragged tail: pad tokens (they waste a little capacity)
        x_flat = torch.cat([x_flat, x.new_zeros(Np - N, d)], dim=0)
    xg = x_flat.reshape(G, S, d)
    xg = shard(xg, "groups", None, "embed")

    if shlib.is_dtensor(xg):
        out, aux = _moe_sharded(xg, p, cfg, C)
        if G % _shards(out, 0):
            # groups that do not divide their ranks (one decode group):
            # whole on every rank before the reshapes
            out = shlib.replicated(out)
    else:
        with spans.layer("moe.route"):
            probs, gate_w, gate_idx = route(xg, p["router"], k, cfg.norm_topk_prob)
            aux = _aux_loss(probs, gate_idx, E, k)
        w_gate, w_up, w_down = (p[n].to(xg.dtype) for n in ("w_gate", "w_up", "w_down"))
        out = _experts(xg, gate_w, gate_idx, w_gate, w_up, w_down, cfg, C)

    out = out.reshape(Np, d)[:N].reshape(B, T, d)
    if cfg.n_shared_experts:
        out = out + L.mlp(x, p["shared"], cfg)
    return shard(out, "batch", "seq", "embed"), aux
