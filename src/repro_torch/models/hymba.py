"""Hymba: hybrid layers with *parallel* attention + Mamba heads.

Mirrors ``repro/models/hymba.py``. Each layer normalizes once, feeds the
same input to a GQA attention branch (sliding-window) and a
selective-SSM branch in parallel, combines them with learned per-channel
output gains, then applies a standard FFN block. The SSM state makes
decode O(1) in sequence length: the decode cache is four tensors with a
leading L axis, a bounded (window) KV cache, the conv buffer and the
fp32 SSM state.

The attention is windowed, so it runs the plain PyTorch version on the
card as on the CPU (the reference's layer takes its jnp path whenever
``cfg.window`` is set); the norms launch the rmsnorm hand kernel.

As the reference checkpoints each layer of its training scan, ``loss``
wraps each layer in ``torch.utils.checkpoint`` when grad mode is on (see
``repro_torch/models/transformer.py``); ``prefill`` and ``decode_step``
record no gradient and wrap nothing. ``decode_step`` writes the new k
and v into the KV cache in place (at the slot ``decode_self_attention``
picks, clamped as the reference's ``dynamic_update_slice`` clamps it)
and returns the conv buffers and SSM states as new tensors, so replaying
a step from the same cache gives the same result.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, cast_params
from repro_torch.models.ssm import ssm_branch, ssm_defs
from repro_torch.models.transformer import checkpointed, layer_params, stack_defs
from repro_torch.runtime.kernel_plane import step_program


def hymba_layer_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "ln2": ParamDef((d,), (None,), init="ones"),
        "attn": L.attention_defs(cfg),
        "ssm": ssm_defs(cfg),
        "beta_attn": ParamDef((d,), (None,), init="ones", scale=0.5),
        "beta_ssm": ParamDef((d,), (None,), init="ones", scale=0.5),
        "ffn": L.mlp_defs(cfg),
    }


def hymba_defs(cfg: ModelConfig) -> dict:
    return {
        "tok": L.embedding_defs(cfg),
        "layers": stack_defs(hymba_layer_defs(cfg), cfg.n_layers),
        "ln_f": ParamDef((cfg.d_model,), (None,), init="ones"),
    }


class HymbaLM(nn.Module):
    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        self.cfg = cfg

    def param_defs(self) -> dict:
        return hymba_defs(self.cfg)

    # ------------------------------------------------------------ forward
    def _layer(self, h, lp, *, positions, mode, cache=None, pos=None):
        cfg = self.cfg
        hn = L.norm(h, lp["ln1"], cfg.norm)
        if mode == "decode":
            ck, cv, conv_buf, hs = cache
            attn, (ck, cv) = L.decode_self_attention(
                hn, lp["attn"], cfg, ck, cv, pos)
            s, (conv_buf, hs) = ssm_branch(
                hn, lp["ssm"], cfg, state=(conv_buf, hs))
            new_cache = (ck, cv, conv_buf, hs)
        elif mode == "prefill":
            attn, (k, v) = L.self_attention_with_cache(
                hn, lp["attn"], cfg, positions=positions)
            s, (conv_buf, hs) = ssm_branch(hn, lp["ssm"], cfg)
            new_cache = (k, v, conv_buf, hs)
        else:
            attn = L.self_attention(hn, lp["attn"], cfg, positions=positions)
            s, _ = ssm_branch(hn, lp["ssm"], cfg)
            new_cache = None
        mix = attn * lp["beta_attn"].to(h.dtype) + s * lp["beta_ssm"].to(h.dtype)
        h = h + 0.5 * mix
        h = h + L.mlp(L.norm(h, lp["ln2"], cfg.norm), lp["ffn"], cfg)
        return shard(h, "batch", "seq", "embed"), new_cache

    def _embed(self, params, tokens):
        B, T = tokens.shape
        x = L.embed_tokens(tokens, params["tok"], self.cfg)
        return x, torch.arange(T, device=tokens.device)[None].expand(B, T)

    def loss(self, params, batch):
        cfg = self.cfg
        with step_program():
            params = cast_params(params, cfg.compute_dtype)
            h, positions = self._embed(params, batch["tokens"])

            def body(h, lp):
                return self._layer(h, lp, positions=positions, mode="train")[0]

            if torch.is_grad_enabled():
                body = checkpointed(body)
            for i in range(cfg.n_layers):
                h = body(h, layer_params(params["layers"], i))
            h = L.norm(h, params["ln_f"], cfg.norm)
            logits = L.logits_out(h, params["tok"], cfg)
            return L.cross_entropy(logits, batch["labels"], batch.get("mask"))

    def prefill(self, params, batch):
        """Logits of the last position, and the four stacked caches (the
        KV caches cut to their tail ``W`` slots when the prompt is longer
        than the decode window)."""
        cfg = self.cfg
        with step_program():
            params = cast_params(params, cfg.compute_dtype)
            tokens = batch["tokens"]
            h, positions = self._embed(params, tokens)
            caches = []
            for i in range(cfg.n_layers):
                h, c = self._layer(h, layer_params(params["layers"], i),
                                   positions=positions, mode="prefill")
                caches.append(c)
            h = L.norm(h, params["ln_f"], cfg.norm)
            logits = L.logits_out(h[:, -1:], params["tok"], cfg)
            W = self._cache_window(tokens.shape[1])
            # the prefill cache may exceed the decode window: keep the tail
            # (a copy, since decode writes into it and a view would keep
            # the whole prefill cache alive)
            k, v, conv_buf, hs = (torch.stack(parts) for parts in zip(*caches))
            if k.shape[2] > W:
                k, v = k[:, :, -W:].contiguous(), v[:, :, -W:].contiguous()
            return logits, (k, v, conv_buf, hs)

    def decode_step(self, params, cache, tokens, pos):
        """One-token decode; the KV caches are updated in place, the conv
        buffers and SSM states come back as new stacked tensors."""
        cfg = self.cfg
        with step_program():
            params = cast_params(params, cfg.compute_dtype)
            ks, vs, convs, hss = cache
            h = L.embed_tokens(tokens, params["tok"], cfg)
            new_convs, new_hss = [], []
            for i in range(cfg.n_layers):
                h, (_, _, conv_buf, hs) = self._layer(
                    h, layer_params(params["layers"], i), positions=None,
                    mode="decode", cache=(ks[i], vs[i], convs[i], hss[i]), pos=int(pos))
                new_convs.append(conv_buf)
                new_hss.append(hs)
            h = L.norm(h, params["ln_f"], cfg.norm)
            logits = L.logits_out(h, params["tok"], cfg)
            return logits, (ks, vs, torch.stack(new_convs), torch.stack(new_hss))

    # ------------------------------------------------------------- caches
    def _cache_window(self, max_len: int) -> int:
        cfg = self.cfg
        return min(max_len, cfg.window) if cfg.window else max_len

    def init_cache_shape(self, batch: int, max_len: int) -> tuple[tuple[int, ...], ...]:
        """The shape of each cache tensor: (k, v, conv buffer, SSM state)."""
        cfg = self.cfg
        W = self._cache_window(max_len)
        kv = (cfg.n_layers, batch, W, cfg.n_kv_heads, cfg.d_head)
        return (kv, kv, (cfg.n_layers, batch, cfg.ssm_conv - 1, cfg.d_model),
                (cfg.n_layers, batch, cfg.d_model, cfg.ssm_state))

    def init_cache(self, batch: int, max_len: int, *,
                   device: "torch.device | str" = "cpu"):
        """Zeros; the SSM state in fp32, the rest in the compute dtype."""
        dtypes = (self.cfg.compute_dtype,) * 3 + (torch.float32,)
        return tuple(torch.zeros(shape, dtype=dt, device=device)
                     for shape, dt in zip(self.init_cache_shape(batch, max_len), dtypes))
