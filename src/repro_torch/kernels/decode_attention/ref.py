"""Plain PyTorch oracle for decode attention (naive full softmax over the
cache).

Mirrors ``repro/kernels/decode_attention/ref.py``: one new query token
attending over a (possibly partially filled) KV cache with GQA head
grouping, without chunking or online softmax — the ground truth the
flash-decoding variants are gated against.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,      # (B, 1, H, Dh) — one new token
    k: torch.Tensor,      # (B, S, Hk, Dh) KV cache
    v: torch.Tensor,
    length: "torch.Tensor | int | None" = None,
    scale: float | None = None,
) -> torch.Tensor:
    B, Tq, H, Dh = q.shape
    _, S, Hk, _ = k.shape
    G = H // Hk
    scale = float(scale if scale is not None else Dh ** -0.5)

    qg = q.reshape(B, Tq, Hk, G, Dh).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * scale
    if length is not None:
        len_b = torch.as_tensor(length, device=q.device).reshape(-1, 1)
        valid = torch.arange(S, device=q.device)[None, :] < len_b   # (1 or B, S)
        s = torch.where(valid[:, None, None, None, :], s,
                        torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(B, Tq, H, Dh).to(q.dtype)
