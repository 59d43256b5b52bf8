"""Whisper-style encoder–decoder (audio backbone; conv frontend stubbed).

Mirrors ``repro/models/whisper.py``. The modality frontend is a STUB:
the batch carries precomputed frame embeddings (B, F, d). The encoder is
a bidirectional transformer over frames (sinusoidal positions); the
decoder is causal with cross-attention (learned positions), tied
unembedding. The decode cache is four tensors with a leading L axis:
self-attention k and v (updated in place at slot ``pos``) and the
encoder's k and v for cross-attention.

As the reference checkpoints every encoder and decoder block (its
training's gradient recomputes them), ``loss`` wraps each in
``torch.utils.checkpoint`` when grad mode is on (see
``repro_torch/models/transformer.py``); ``prefill`` and ``decode_step``
record no gradient and wrap nothing.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import shard
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, cast_params
from repro_torch.models.transformer import checkpointed, layer_params, stack_defs
from repro_torch.runtime.kernel_plane import step_program


def whisper_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    enc_layer = {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "attn": L.attention_defs(cfg),
        "ln2": ParamDef((d,), (None,), init="ones"),
        "ffn": L.mlp_defs(cfg),
    }
    dec_layer = {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "attn": L.attention_defs(cfg),
        "ln_c": ParamDef((d,), (None,), init="ones"),
        "xattn": L.attention_defs(cfg),
        "ln2": ParamDef((d,), (None,), init="ones"),
        "ffn": L.mlp_defs(cfg),
    }
    return {
        "tok": {"embed": ParamDef((cfg.vocab, d), ("vocab", "embed"), scale=0.02)},
        "dec_pos": ParamDef((cfg.max_decode_len, d), (None, "embed"), scale=0.01),
        "enc_layers": stack_defs(enc_layer, cfg.enc_layers),
        "enc_ln_f": ParamDef((d,), (None,), init="ones"),
        "dec_layers": stack_defs(dec_layer, cfg.n_layers),
        "dec_ln_f": ParamDef((d,), (None,), init="ones"),
    }


class WhisperLM(nn.Module):
    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        self.cfg = cfg

    def param_defs(self) -> dict:
        return whisper_defs(self.cfg)

    # ------------------------------------------------------------ encoder
    def encode(self, params, audio_embeds: torch.Tensor, *,
               remat: bool = False) -> torch.Tensor:
        """The encoder's output; ``remat``: checkpoint each block (training)."""
        cfg = self.cfg
        B, F, d = audio_embeds.shape
        x = audio_embeds.to(cfg.compute_dtype)
        x = x + L.sinusoidal_embedding(F, d, x.device).to(x.dtype)[None]
        x = shard(x, "batch", "seq", "embed")

        def body(h, lp):
            hn = L.norm(h, lp["ln1"], cfg.norm)
            h = h + L.self_attention(hn, lp["attn"], cfg, positions=None, causal=False)
            h = h + L.mlp(L.norm(h, lp["ln2"], cfg.norm), lp["ffn"], cfg)
            return shard(h, "batch", "seq", "embed")

        if remat and torch.is_grad_enabled():
            body = checkpointed(body)
        for i in range(cfg.enc_layers):
            x = body(x, layer_params(params["enc_layers"], i))
        return L.norm(x, params["enc_ln_f"], cfg.norm)

    # ------------------------------------------------------------ decoder
    def _embed_dec(self, params, tokens, pos0=0):
        cfg = self.cfg
        T = tokens.shape[1]
        x = L.lookup(params["tok"]["embed"].to(cfg.compute_dtype), tokens)
        table = params["dec_pos"]
        # the reference's dynamic_slice clamps the start so the slice fits
        start = min(max(int(pos0), 0), table.shape[0] - T)

        def add(xl, tl):
            return xl + tl.to(xl.dtype)[start:start + T][None]

        if shlib.is_dtensor(x):
            # each rank's batch rows plus the whole table's rows
            rows = ("batch", "seq", "embed")
            x = shlib.pinned(add, x, table, axes=(rows, None), out_axes=rows,
                             out_shape=tuple(x.shape),
                             out_dtype=x.dtype)
        else:
            x = add(x, table)
        return shard(x, "batch", "seq", "embed")

    def _logits(self, params, h):
        table = params["tok"]["embed"]
        if shlib.is_dtensor(h):
            # each rank's batch rows against its rows of the tied table
            return shlib.pinned(
                lambda hl, tl: self._logits({"tok": {"embed": tl}}, hl), h, table,
                axes=(("batch", "seq", "embed"), ("vocab", "embed")),
                out_axes=("batch", "seq", "vocab"),
                out_shape=(*h.shape[:-1], table.shape[0]), out_dtype=h.dtype)
        logits = torch.matmul(h, table.to(h.dtype).T)
        return shard(logits, "batch", "seq", "vocab")

    def _decode_stack(self, params, x, enc_out, mode, cache=None, pos=None):
        cfg = self.cfg
        layers = params["dec_layers"]

        if mode == "decode":
            ks, vs, xks, xvs = cache
            for i in range(cfg.n_layers):
                lp = layer_params(layers, i)
                hn = L.norm(x, lp["ln1"], cfg.norm)
                attn, _ = L.decode_self_attention(hn, lp["attn"], cfg, ks[i], vs[i], int(pos))
                x = x + attn
                hc = L.norm(x, lp["ln_c"], cfg.norm)
                x = x + L.cross_attention(hc, lp["xattn"], cfg, xks[i], xvs[i])
                x = x + L.mlp(L.norm(x, lp["ln2"], cfg.norm), lp["ffn"], cfg)
            return L.norm(x, params["dec_ln_f"], cfg.norm), (ks, vs, xks, xvs)

        def body(h, lp):
            hn = L.norm(h, lp["ln1"], cfg.norm)
            if mode == "prefill":
                attn, (ck, cv) = L.self_attention_with_cache(
                    hn, lp["attn"], cfg, positions=None)
            else:
                attn = L.self_attention(hn, lp["attn"], cfg, positions=None, causal=True)
            h = h + attn
            hc = L.norm(h, lp["ln_c"], cfg.norm)
            xk, xv = L.encoder_kv(lp["xattn"], cfg, enc_out)
            h = h + L.cross_attention(hc, lp["xattn"], cfg, xk, xv)
            h = h + L.mlp(L.norm(h, lp["ln2"], cfg.norm), lp["ffn"], cfg)
            h = shard(h, "batch", "seq", "embed")
            if mode == "train":
                return h
            return h, (ck, cv, xk, xv)

        if mode == "train":
            if torch.is_grad_enabled():
                body = checkpointed(body)
            for i in range(cfg.n_layers):
                x = body(x, layer_params(layers, i))
            return L.norm(x, params["dec_ln_f"], cfg.norm), None
        caches = []
        for i in range(cfg.n_layers):
            x, c = body(x, layer_params(layers, i))
            caches.append(c)
        stacked = tuple(torch.stack(parts) for parts in zip(*caches))
        return L.norm(x, params["dec_ln_f"], cfg.norm), stacked

    # -------------------------------------------------------------- steps
    def loss(self, params, batch):
        with step_program():
            params = cast_params(params, self.cfg.compute_dtype)
            enc_out = self.encode(params, batch["audio_embeds"], remat=True)
            x = self._embed_dec(params, batch["tokens"])
            h, _ = self._decode_stack(params, x, enc_out, "train")
            logits = self._logits(params, h)
            return L.cross_entropy(logits, batch["labels"], batch.get("mask"))

    def prefill(self, params, batch):
        """Logits of the last position, and the four stacked caches."""
        with step_program():
            params = cast_params(params, self.cfg.compute_dtype)
            enc_out = self.encode(params, batch["audio_embeds"])
            x = self._embed_dec(params, batch["tokens"])
            h, caches = self._decode_stack(params, x, enc_out, "prefill")
            return self._logits(params, h[:, -1:]), caches

    def decode_step(self, params, cache, tokens, pos):
        with step_program():
            params = cast_params(params, self.cfg.compute_dtype)
            x = self._embed_dec(params, tokens, pos0=pos)
            h, cache = self._decode_stack(params, x, None, "decode", cache=cache, pos=pos)
            return self._logits(params, h), cache

    def init_cache_shape(self, batch: int, max_len: int) -> tuple[tuple[int, ...], ...]:
        """The shape of each cache tensor: (k, v, cross k, cross v)."""
        cfg = self.cfg
        kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        xkv = (cfg.n_layers, batch, cfg.enc_frames, cfg.n_kv_heads, cfg.d_head)
        return (kv, kv, xkv, xkv)

    def init_cache(self, batch: int, max_len: int, *,
                   device: "torch.device | str" = "cpu"):
        return tuple(torch.zeros(shape, dtype=self.cfg.compute_dtype, device=device)
                     for shape in self.init_cache_shape(batch, max_len))
