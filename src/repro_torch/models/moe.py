"""Mixture-of-Experts FFN: GShard-style grouped capacity dispatch.

Mirrors ``repro/models/moe.py``. Tokens are reshaped into groups of
``moe_group_size`` (the ragged tail zero-padded); each of the top-k
routing choices is dispatched as an independent top-1 slice, with a
one-hot dispatch tensor (G, S, E, C) at capacity C. Dropped tokens
(capacity overflow) pass through with zero contribution, as in
GShard/Switch. A load-balancing auxiliary loss is returned.

The reference's ``shard`` annotations drop out (there is no mesh). The
router and the expert products are ``torch.einsum`` in full fp32: the
reference computes them outside any Pallas kernel. Each of the ``top_k``
slices runs the expert products over all ``E`` experts at capacity
``C``, so a step reads every expert's weights ``top_k`` times, prefill
or decode alike; the port keeps that dispatch, as the reference has it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef


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


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out, aux_loss)."""
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

    probs, gate_w, gate_idx = route(xg, p["router"], k)

    # Switch/GShard load-balancing aux loss over all tokens.
    me = probs.mean(dim=(0, 1))                                          # (E,)
    ce = F.one_hot(gate_idx, E).to(torch.float32).sum(dim=2).mean(dim=(0, 1)) / k
    aux = E * torch.sum(me * ce)

    w_gate, w_up, w_down = (p[n].to(xg.dtype) for n in ("w_gate", "w_up", "w_down"))
    out = torch.zeros_like(xg)
    for j in range(k):                    # k independent top-1 dispatches
        onehot_e = F.one_hot(gate_idx[..., j], E).to(torch.float32)    # (G, S, E)
        pos = (torch.cumsum(onehot_e, dim=1) * onehot_e).sum(dim=-1) - 1.0  # (G, S)
        keep = (pos < C).to(torch.float32)
        # a dropped token's slot (pos >= C) is masked by keep; the
        # reference's one_hot gives it a zero row, torch's refuses it
        pos_oh = F.one_hot(pos.to(torch.int64).clamp(max=C - 1), C).to(torch.float32)
        dispatch = (onehot_e[..., None] * pos_oh[..., None, :]
                    * keep[..., None, None]).to(xg.dtype)               # (G,S,E,C)
        xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)               # (G,E,C,d)
        g = torch.einsum("gecd,edf->gecf", xe, w_gate)
        u = torch.einsum("gecd,edf->gecf", xe, w_up)
        h = F.silu(g) * u
        ye = torch.einsum("gecf,efd->gecd", h, w_down)
        combine = dispatch * gate_w[..., j].to(xg.dtype)[..., None, None]
        out = out + torch.einsum("gsec,gecd->gsd", combine, ye)

    out = out.reshape(Np, d)[:N].reshape(B, T, d)
    if cfg.n_shared_experts:
        out = out + L.mlp(x, p["shared"], cfg)
    return out, aux
