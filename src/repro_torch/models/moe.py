"""Mixture-of-Experts FFN: GShard-style grouped capacity dispatch.

Mirrors ``repro/models/moe.py``. Tokens are reshaped into groups of
``moe_group_size`` (the ragged tail zero-padded); each of the top-k
routing choices is dispatched as an independent top-1 slice, with a
one-hot dispatch tensor (G, S, E, C) at capacity C. Dropped tokens
(capacity overflow) pass through with zero contribution, as in
GShard/Switch. A load-balancing auxiliary loss is returned.

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
axes. The router and the expert products are ``torch.einsum`` in full
fp32: the reference computes them outside any Pallas kernel. Each of the ``top_k``
slices runs the expert products over all ``E`` experts at capacity
``C``, so a step reads every expert's weights ``top_k`` times, prefill
or decode alike; the port keeps that dispatch, as the reference has it.
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


def route(xg: torch.Tensor, router: torch.Tensor, k: int):
    """fp32 router over groups xg (G, S, d): softmax probabilities
    (G, S, E), the renormalised top-k gates and their expert indices
    (G, S, k). Equal probabilities (the zero-padded tail's are uniform)
    go to the lower expert index first, as ``jax.lax.top_k`` orders
    them: a stable descending sort, where ``torch.topk`` promises no
    order among ties."""
    logits = torch.einsum("gsd,de->gse", xg.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_idx = gate_w[..., :k], gate_idx[..., :k]
    gate_w = gate_w / torch.clamp(gate_w.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_w, gate_idx


def _aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor, E: int, k: int):
    """Switch/GShard load-balancing aux loss over all tokens."""
    me = probs.mean(dim=(0, 1))                                          # (E,)
    ce = _expert_counts(gate_idx, E).mean(dim=(0, 1)) / k
    return E * torch.sum(me * ce)


def _expert_counts(gate_idx: torch.Tensor, E: int) -> torch.Tensor:
    return F.one_hot(gate_idx, E).to(torch.float32).sum(dim=2)          # (G, S, E)


def _experts(xg, gate_w, gate_idx, w_gate, w_up, w_down, cfg: ModelConfig,
             C: int, experts: "tuple[int, int] | None" = None):
    """The k top-1 dispatches through the experts ``experts`` (a
    [lo, hi) range of the E; all when None): the combined output over
    those experts."""
    E, k = cfg.n_experts, cfg.top_k
    out = torch.zeros_like(xg)
    for j in range(k):                    # k independent top-1 dispatches
        with spans.layer("moe.dispatch"):
            onehot_e = F.one_hot(gate_idx[..., j], E).to(torch.float32)    # (G, S, E)
            pos = (torch.cumsum(onehot_e, dim=1) * onehot_e).sum(dim=-1) - 1.0  # (G, S)
            keep = (pos < C).to(torch.float32)
            # a dropped token's slot (pos >= C) is masked by keep; the
            # reference's one_hot gives it a zero row, torch's refuses it
            pos_oh = F.one_hot(pos.to(torch.int64).clamp(max=C - 1), C).to(torch.float32)
            dispatch = (onehot_e[..., None] * pos_oh[..., None, :]
                        * keep[..., None, None]).to(xg.dtype)               # (G,S,E,C)
            if experts is not None:
                dispatch = dispatch[:, :, experts[0]:experts[1]]
            xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)               # (G,E,C,d)
            xe = shard(xe, "groups", "expert", None, None)
        with spans.layer("moe.experts"):
            g = torch.einsum("gecd,edf->gecf", xe, w_gate)
            u = torch.einsum("gecd,edf->gecf", xe, w_up)
            h = F.silu(g) * u
            ye = torch.einsum("gecf,efd->gecd", h, w_down)
            ye = shard(ye, "groups", "expert", None, None)
        with spans.layer("moe.combine"):
            combine = dispatch * gate_w[..., j].to(xg.dtype)[..., None, None]
            out = out + torch.einsum("gsec,gecd->gsd", combine, ye)
    return out


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
        probs, gate_w, gate_idx = route(xl, rl, k)
        return (probs.sum(dim=(0, 1)), gate_w, gate_idx,
                _expert_counts(gate_idx, E).sum(dim=(0, 1)))

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
    (:mod:`repro_torch.runtime.spans`), with ``moe.route`` and, per top-k
    slice, ``moe.dispatch``, ``moe.experts`` and ``moe.combine`` inside."""
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
            probs, gate_w, gate_idx = route(xg, p["router"], k)
            aux = _aux_loss(probs, gate_idx, E, k)
        w_gate, w_up, w_down = (p[n].to(xg.dtype) for n in ("w_gate", "w_up", "w_down"))
        out = _experts(xg, gate_w, gate_idx, w_gate, w_up, w_down, cfg, C)

    out = out.reshape(Np, d)[:N].reshape(B, T, d)
    if cfg.n_shared_experts:
        out = out + L.mlp(x, p["shared"], cfg)
    return shard(out, "batch", "seq", "embed"), aux
