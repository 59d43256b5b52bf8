"""Qwen2-VL-style backbone: decoder LM with M-RoPE over (t, h, w).

Mirrors ``repro/models/vlm.py``. The vision frontend is a STUB: the batch
carries precomputed patch embeddings (B, P, d_model), which are
prepended to the text embeddings. Vision positions use a (t=0, h, w)
grid; text positions continue the temporal stream after the grid.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import shard
from repro_torch.models import layers as L
from repro_torch.models.params import cast_params
from repro_torch.models.transformer import TransformerLM
from repro_torch.runtime.kernel_plane import step_program


def mrope_positions(P: int, T_text: int, B: int, device=None) -> torch.Tensor:
    """(3, B, P+T_text) positions: vision grid then text stream."""
    side = max(int(math.sqrt(P)), 1)
    idx = torch.arange(P, dtype=torch.int32, device=device)
    vis_t = torch.zeros(P, dtype=torch.int32, device=device)
    vis_h = idx // side
    vis_w = idx % side
    t0 = side  # text stream starts after the grid's spatial extent
    txt = t0 + torch.arange(T_text, dtype=torch.int32, device=device)
    pos = torch.stack([
        torch.cat([vis_t, txt]),
        torch.cat([vis_h, txt]),
        torch.cat([vis_w, txt]),
    ])                                                   # (3, P+T)
    return pos[:, None].expand(3, B, P + T_text)


class VLM(TransformerLM):
    """Reuses the dense transformer stack with multimodal input assembly."""

    def _assemble(self, params, batch):
        cfg = self.cfg
        tokens = batch["tokens"]                        # (B, T_text)
        vision = batch["vision"]                        # (B, P, d)
        B, T_text = tokens.shape
        P = vision.shape[1]
        tok_x = L.embed_tokens(tokens, params["tok"], cfg)
        x = torch.cat([vision.to(tok_x.dtype), tok_x], dim=1)
        x = shard(x, "batch", "seq", "embed")
        positions = batch.get("positions")
        if positions is None:
            positions = mrope_positions(P, T_text, B, tokens.device)
        return x, positions, P

    def loss(self, params, batch):
        cfg = self.cfg
        with step_program():
            params = cast_params(params, cfg.compute_dtype)
            x, positions, P = self._assemble(params, batch)
            h, aux = self.forward_train(params, x, positions)
            logits = L.logits_out(h[:, P:], params["tok"], cfg)
            loss = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
            return loss + 0.01 * aux

    def prefill(self, params, batch):
        cfg = self.cfg
        with step_program():
            params = cast_params(params, cfg.compute_dtype)
            x, positions, P = self._assemble(params, batch)
            h, cache = self.forward_prefill(params, x, positions)
            return L.logits_out(h[:, -1:], params["tok"], cfg), cache

    def decode_step(self, params, cache, tokens, pos, rope_pos=None):
        # The cache slot is `pos`; the M-RoPE temporal position of text
        # token i is `side + i` (the grid occupies one temporal step and
        # `side` spatial steps). pos counts vision patches + text tokens.
        if rope_pos is None:
            P = self.cfg.vision_patches
            side = max(int(math.sqrt(max(P, 1))), 1)
            rope_pos = pos - P + side
        return super().decode_step(params, cache, tokens, pos, rope_pos=rope_pos)
