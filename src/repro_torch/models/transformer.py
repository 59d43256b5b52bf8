"""Decoder-only transformer (dense / MoE / VLM backbones).

Mirrors ``repro/models/transformer.py``. The model is an ``nn.Module``
whose layers sit in an ``nn.ModuleList``; the modules hold no weights of
their own: every step reads the reference's param tree (stacked layers,
leading L axis), so one tree — made here by ``init_tree`` or carried over
from JAX — drives both packages. A Python loop over the layers takes the
place of the reference's ``lax.scan``. A block returns its MoE
load-balancing loss beside its output (0 for a dense FFN), and ``loss``
adds 0.01 times their sum, as the reference does.

``loss``, ``prefill`` and ``decode_step`` are step-programs: they run
inside :func:`~repro_torch.runtime.kernel_plane.step_program`, so no
layer call inside them routes through a kernel-plane handle (see
``repro_torch/models/layers.py``).

**Remat.** ``cfg.remat`` picks what ``loss`` keeps for the backward,
block by block, as the reference's ``_remat`` does around its scan
body: ``"none"`` keeps every activation; ``"full"`` and ``"dots"`` both
wrap each block in ``torch.utils.checkpoint(..., use_reentrant=False)``,
which keeps the block's inputs and recomputes the rest in the backward.
PyTorch has no counterpart of JAX's ``dots_with_no_batch_dims_saveable``
that sees the hand kernels (selective checkpointing decides per aten op,
and the kernels are launched outside aten), so ``"dots"`` recomputes the
products too: the same gradients, one more forward per block. Under
``"full"`` the plain attention also checkpoints its own chunks, as the
reference's attention does (its backward recomputes the score blocks
once more); under ``"dots"`` it keeps them, the products' extra
recompute standing in for that one. The
recompute runs under the kernel plane and the step-program mark that
were active in the forward, whichever thread autograd runs it on, so it
launches what the forward launched and never routes through a handle.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_defs, moe_ffn
from repro_torch.models.params import ParamDef, cast_params
from repro_torch.runtime.kernel_plane import active_plane, step_program, use_kernel_plane


def stack_defs(defs: dict, n: int) -> dict:
    """Prepend a stacked 'layers' axis to every ParamDef in the tree."""
    out = {}
    for name, node in defs.items():
        if isinstance(node, ParamDef):
            out[name] = ParamDef(
                (n,) + node.shape, ("layers",) + node.axes, node.init, node.scale
            )
        else:
            out[name] = stack_defs(node, n)
    return out


def layer_defs(cfg: ModelConfig) -> dict:
    defs = {
        "ln1": ParamDef((cfg.d_model,), (None,), init="ones"),
        "attn": L.mla_defs(cfg) if cfg.kv_lora_rank else L.attention_defs(cfg),
    }
    if not cfg.parallel_block:
        defs["ln2"] = ParamDef((cfg.d_model,), (None,), init="ones")
    if not cfg.first_k_dense:
        defs["ffn"] = moe_defs(cfg) if cfg.family == "moe" else L.mlp_defs(cfg)
    return defs


def transformer_defs(cfg: ModelConfig) -> dict:
    """The tree: ``tok``, ``layers`` (stacked), ``ln_f``. Where the first
    ``first_k_dense`` layers have a dense FFN and the rest experts, the
    FFNs are two stacks of their own beside ``layers``: ``dense_ffn``
    (the leading layers', ``dense_d_ff`` wide) and ``moe_ffn``."""
    defs = {
        "tok": L.embedding_defs(cfg),
        "layers": stack_defs(layer_defs(cfg), cfg.n_layers),
        "ln_f": ParamDef((cfg.d_model,), (None,), init="ones"),
    }
    k = cfg.first_k_dense
    if k:
        defs["dense_ffn"] = stack_defs(L.mlp_defs(cfg, d_ff=cfg.dense_d_ff), k)
        defs["moe_ffn"] = stack_defs(moe_defs(cfg), cfg.n_layers - k)
    return defs


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s params: views into the stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def block_params(params: dict, cfg: ModelConfig, i: int) -> dict:
    """Block ``i``'s params: its layer of ``layers``, and where the FFNs
    have stacks of their own, its FFN from the one it belongs to."""
    lp = layer_params(params["layers"], i)
    k = cfg.first_k_dense
    if k:
        lp["ffn"] = (layer_params(params["dense_ffn"], i) if i < k
                     else layer_params(params["moe_ffn"], i - k))
    return lp


def checkpointed(fn):
    """``fn`` under ``torch.utils.checkpoint`` (see the module docstring):
    its recompute runs under the kernel plane and step-program mark of
    the forward, whichever thread autograd runs it on."""
    plane = active_plane()

    def run(*args):
        with use_kernel_plane(plane), step_program():
            return fn(*args)

    return lambda *args: checkpoint(run, *args, use_reentrant=False)


def ffn_apply(x: torch.Tensor, lp: dict, cfg: ModelConfig):
    """The block's FFN and its load-balancing loss (0.0 for a dense FFN:
    no device allocation in a decode step): the experts where the layer
    has a router, else the dense MLP at the width of its weights."""
    if "router" in lp["ffn"]:
        return moe_ffn(x, lp["ffn"], cfg)
    return L.mlp(x, lp["ffn"], cfg), 0.0


class TransformerBlock(nn.Module):
    """One pre-norm block: attention, then the FFN (or both in parallel)."""

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        self.cfg = cfg

    def _ffn(self, h: torch.Tensor, lp: dict, attn: torch.Tensor,
             hn: torch.Tensor) -> tuple[torch.Tensor, "torch.Tensor | float"]:
        cfg = self.cfg
        if cfg.parallel_block:
            f, aux = ffn_apply(hn, lp, cfg)
            return h + attn + f, aux
        h = h + attn
        f, aux = ffn_apply(L.norm(h, lp["ln2"], cfg.norm), lp, cfg)
        return h + f, aux

    def forward(self, h: torch.Tensor, lp: dict, positions: torch.Tensor):
        """(output, load-balancing loss)."""
        hn = L.norm(h, lp["ln1"], self.cfg.norm)
        attn = L.self_attention(hn, lp["attn"], self.cfg, positions=positions)
        h, aux = self._ffn(h, lp, attn, hn)
        return shard(h, "batch", "seq", "embed"), aux

    def prefill(self, h: torch.Tensor, lp: dict, positions: torch.Tensor):
        hn = L.norm(h, lp["ln1"], self.cfg.norm)
        attn, kv = L.self_attention_with_cache(
            hn, lp["attn"], self.cfg, positions=positions)
        return shard(self._ffn(h, lp, attn, hn)[0], "batch", "seq", "embed"), kv

    def decode(self, h: torch.Tensor, lp: dict, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: int, rope_pos: int | None = None):
        hn = L.norm(h, lp["ln1"], self.cfg.norm)
        attn, _ = L.decode_self_attention(
            hn, lp["attn"], self.cfg, cache_k, cache_v, pos, rope_pos=rope_pos)
        return self._ffn(h, lp, attn, hn)[0]


class TransformerLM(nn.Module):
    """Dense/MoE decoder LM with the standard step functions."""

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(
                f"family {cfg.family!r}: TransformerLM runs the dense, moe and "
                "vlm backbones")
        self.cfg = cfg
        self.layers = nn.ModuleList(TransformerBlock(cfg) for _ in range(cfg.n_layers))

    # --- params ---
    def param_defs(self) -> dict:
        return transformer_defs(self.cfg)

    def _positions(self, batch: dict, B: int, T: int, device) -> torch.Tensor:
        pos = batch.get("positions")
        if pos is None:
            pos = torch.arange(T, device=device)[None].expand(B, T)
        return pos

    def _remat_block(self, block: TransformerBlock, positions: torch.Tensor):
        """``block`` under ``cfg.remat`` (see the module docstring)."""
        if self.cfg.remat == "none" or not torch.is_grad_enabled():
            return lambda h, lp: block(h, lp, positions)
        return checkpointed(lambda h, lp: block(h, lp, positions))

    # --- forward passes over embedded input (the reference's
    # forward_train and forward_prefill); callers mark the step-program
    def forward_train(self, params: dict, x: torch.Tensor, positions: torch.Tensor):
        """x: (B, T, d) embedded input -> (final hidden, aux loss)."""
        aux = x.new_zeros((), dtype=torch.float32)
        for i, block in enumerate(self.layers):
            x, a = self._remat_block(block, positions)(x, block_params(params, self.cfg, i))
            aux = aux + a
        return L.norm(x, params["ln_f"], self.cfg.norm), aux

    def forward_prefill(self, params: dict, x: torch.Tensor, positions: torch.Tensor):
        """Causal forward that also returns the stacked (L, B, T, Hk, Dh)
        KV caches (under latent attention the (L, B, T, 1, kv_lora_rank)
        latents and the (L, B, T, 1, qk_rope_head_dim) rope keys)."""
        ks, vs = [], []
        for i, block in enumerate(self.layers):
            x, (k, v) = block.prefill(x, block_params(params, self.cfg, i), positions)
            ks.append(k)
            vs.append(v)
        return L.norm(x, params["ln_f"], self.cfg.norm), (torch.stack(ks), torch.stack(vs))

    # --- steps ---
    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        with step_program():
            params = cast_params(params, cfg.compute_dtype)
            tokens = batch["tokens"]                      # (B, T)
            B, T = tokens.shape
            x = L.embed_tokens(tokens, params["tok"], cfg)
            positions = self._positions(batch, B, T, tokens.device)
            h, aux = self.forward_train(params, x, positions)
            logits = L.logits_out(h, params["tok"], cfg)
            loss = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
            return loss + 0.01 * aux

    def prefill(self, params: dict, batch: dict):
        """Logits of the last position, and the stacked (L, B, T, Hk, Dh)
        KV caches."""
        cfg = self.cfg
        with step_program():
            params = cast_params(params, cfg.compute_dtype)
            tokens = batch["tokens"]
            B, T = tokens.shape
            x = L.embed_tokens(tokens, params["tok"], cfg)
            positions = self._positions(batch, B, T, tokens.device)
            h, cache = self.forward_prefill(params, x, positions)
            return L.logits_out(h[:, -1:], params["tok"], cfg), cache

    def decode_step(self, params: dict, cache: tuple, tokens: torch.Tensor,
                    pos: int, rope_pos: int | None = None):
        """One-token decode. tokens: (B, 1); cache: (k, v) with a leading
        L axis, updated in place at slot ``pos``; ``rope_pos`` is the
        rotary position (``pos`` by default)."""
        cfg = self.cfg
        with step_program():
            params = cast_params(params, cfg.compute_dtype)
            ks, vs = cache
            h = L.embed_tokens(tokens, params["tok"], cfg)    # (B, 1, d)
            for i, block in enumerate(self.layers):
                h = block.decode(h, block_params(params, cfg, i), ks[i], vs[i],
                                 int(pos), None if rope_pos is None else int(rope_pos))
            h = L.norm(h, params["ln_f"], cfg.norm)
            return L.logits_out(h, params["tok"], cfg), (ks, vs)

    def init_cache_shape(self, batch: int, max_len: int) -> tuple[tuple[int, ...], ...]:
        """The shape of each cache tensor: (k, v); under latent attention
        (the normed latent, the rotated rope key), ``kv_lora_rank +
        qk_rope_head_dim`` values a token a layer."""
        cfg = self.cfg
        S = min(max_len, cfg.window) if cfg.window else max_len
        if cfg.kv_lora_rank:
            return ((cfg.n_layers, batch, S, 1, cfg.kv_lora_rank),
                    (cfg.n_layers, batch, S, 1, cfg.qk_rope_head_dim))
        return ((cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.d_head),) * 2

    def init_cache(self, batch: int, max_len: int, *,
                   device: "torch.device | str" = "cpu"):
        return tuple(torch.zeros(shape, dtype=self.cfg.compute_dtype, device=device)
                     for shape in self.init_cache_shape(batch, max_len))
