"""Plain PyTorch oracle for attention (naive full softmax, GQA-aware).

Mirrors ``repro/kernels/attention/ref.py``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,      # (B, Tq, H, Dh)
    k: torch.Tensor,      # (B, Tkv, Hk, Dh)
    v: torch.Tensor,      # (B, Tkv, Hk, Dv)
    *,
    causal: bool = True,
    scale: float | None = None,
    q_offset: int = 0,
    window: int | None = None,
) -> torch.Tensor:
    B, Tq, H, Dh = q.shape
    _, Tkv, Hk, _ = k.shape
    G = H // Hk
    scale = float(scale if scale is not None else Dh ** -0.5)

    qg = q.reshape(B, Tq, Hk, G, Dh).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    q_pos = q_offset + torch.arange(Tq, device=q.device)[:, None]
    k_pos = torch.arange(Tkv, device=q.device)[None, :]
    mask = torch.ones((Tq, Tkv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return o.reshape(B, Tq, H, v.shape[3]).to(q.dtype)
