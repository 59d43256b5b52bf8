"""RWKV-6 "Finch" (attention-free, data-dependent per-channel decay).

Mirrors ``repro/models/rwkv6.py``. Recurrence (per head, head size C):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T S_{t-1} + (r_t · (u ⊙ k_t)) v_t^T
with w_t = exp(-exp(ŵ_t)) produced by a data-dependent LoRA, plus
token-shift ddlerp mixing and a squared-ReLU channel-mix FFN.

Prefill and training use the reference's chunk-parallel form: within a
chunk the decays are folded into q̃ = r ⊙ exp(cl_{t-1}) and k̃ = k ⊙
exp(−cl_t), clamped in log space to ±30 exactly as the reference clamps
them, and a Python loop over the chunks carries the state. Decode runs
the same function at T = 1. The clamps keep the reference's behaviour
where they bind: within a chunk of 128 at decays of about e^-1 a token,
the in-chunk decay between far-apart tokens saturates, so prefill and
token-by-token decode disagree there (ROADMAP Queue 3, R4); the port
reproduces the reference, not the exact recurrence.

The norms launch the rmsnorm hand kernel on the card; the per-head group
norm and every product are plain PyTorch. ``loss`` checkpoints each
layer when grad mode is on; the decode state (S, xa, xc) comes back as
new stacked tensors.

The reference's ``shard`` annotations stand at its own sites. Under
DTensor (a sharded run) the time mix runs on local shards
(:func:`_time_mix_sharded`): DTensor cannot propagate its reshapes (the
LoRA's 5 x 32 split of a sharded product), and the WKV recurrence is
per head, so each rank of the model axis takes its own heads (the
r/k/v/g columns, ``u``, ``ln_x`` and the rows of ``wo``) with the
token-shift LoRAs whole and the decay LoRA's columns of its heads; the output is a partial sum over the model
axis that the closing ``shard`` reduces. Where the heads do not divide
the model axis, every rank takes all of them (the time mix replicated
over that axis). The channel mix goes through DTensor's propagation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import shard
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, cast_params
from repro_torch.models.transformer import checkpointed, layer_params, stack_defs
from repro_torch.runtime.kernel_plane import step_program

LORA_MIX = 32
LORA_DECAY = 64
CLAMP = 30.0


def rwkv_layer_defs(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    C = cfg.rwkv_head_size
    H = d // C
    s = 1.0 / math.sqrt(d)
    return {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "ln2": ParamDef((d,), (None,), init="ones"),
        "tm": {  # time-mix block
            "mu_x": ParamDef((d,), (None,), init="zeros"),
            "mu": ParamDef((5, d), (None, None), init="zeros"),
            "lora_a": ParamDef((d, 5 * LORA_MIX), ("embed", None), scale=s),
            "lora_b": ParamDef((5, LORA_MIX, d), (None, None, "embed"),
                               scale=0.01),
            "wr": ParamDef((d, d), ("embed", "heads"), scale=s),
            "wk": ParamDef((d, d), ("embed", "heads"), scale=s),
            "wv": ParamDef((d, d), ("embed", "heads"), scale=s),
            "wg": ParamDef((d, d), ("embed", "heads"), scale=s),
            "wo": ParamDef((d, d), ("heads", "embed"), scale=s),
            "w_base": ParamDef((d,), (None,), init="zeros"),
            "w_lora_a": ParamDef((d, LORA_DECAY), ("embed", None), scale=s),
            "w_lora_b": ParamDef((LORA_DECAY, d), (None, "embed"), scale=0.01),
            "u": ParamDef((H, C), ("heads", None), init="zeros"),
            "ln_x": ParamDef((d,), (None,), init="ones"),
        },
        "cm": {  # channel-mix block
            "mu_k": ParamDef((d,), (None,), init="zeros"),
            "mu_r": ParamDef((d,), (None,), init="zeros"),
            "wk": ParamDef((d, ff), ("embed", "ffn"), scale=s),
            "wv": ParamDef((ff, d), ("ffn", "embed"), scale=1.0 / math.sqrt(ff)),
            "wr": ParamDef((d, d), ("embed", "heads"), scale=s),
        },
    }


def rwkv_defs(cfg: ModelConfig) -> dict:
    return {
        "tok": L.embedding_defs(cfg),
        "ln_in": ParamDef((cfg.d_model,), (None,), init="ones"),
        "layers": stack_defs(rwkv_layer_defs(cfg), cfg.n_layers),
        "ln_f": ParamDef((cfg.d_model,), (None,), init="ones"),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """shift(x)[t] = x[t-1]; position 0 takes `prev` (decode) or zeros."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :]
    first = prev[:, None, :] if prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(x, xx, p):
    """RWKV-6 data-dependent token-shift mixing → 5 mixed inputs."""
    s = torch.tanh(torch.matmul(x + xx * p["mu_x"].to(x.dtype), p["lora_a"].to(x.dtype)))
    s = s.reshape(*s.shape[:-1], 5, LORA_MIX)
    dyn = torch.einsum("btnk,nkd->btnd", s, p["lora_b"].to(x.dtype))
    mix = p["mu"].to(x.dtype)[None, None] + dyn           # (B,T,5,d)
    return tuple(x + xx * mix[:, :, i] for i in range(5))


def wkv_chunked(r, k, v, logw, u, S0, chunk: int):
    """Chunk-parallel WKV. r/k/v/logw: (B, T, H, C); u: (H, C);
    S0: (B, H, C, C). Returns (y (B,T,H,C), S_final)."""
    B, T, H, C = r.shape
    Lc = min(chunk, T)
    n = -(-T // Lc)
    Tp = n * Lc
    if Tp != T:
        # identity padding: logw=0 (decay 1), r/k/v=0 → state frozen past T
        def pad(t):
            return torch.cat([t, t.new_zeros((B, Tp - T, H, C))], dim=1)
        r, k, v, logw = pad(r), pad(k), pad(v), pad(logw)
    mask = torch.tril(torch.ones((Lc, Lc), dtype=torch.float32, device=r.device),
                      diagonal=-1)                        # strict lower
    S = S0
    ys = []
    for c in range(n):
        sl = slice(c * Lc, (c + 1) * Lc)
        rc, kc, vc, lw = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]   # (B, Lc, H, C)
        cl = torch.cumsum(lw, dim=1)                      # inclusive
        cl_prev = cl - lw                                 # exclusive
        qt = rc * torch.exp(torch.clamp(cl_prev, min=-CLAMP))
        kt = kc * torch.exp(torch.clamp(-cl, max=CLAMP))
        att = torch.einsum("blhc,bmhc->bhlm", qt, kt) * mask[None, None]
        y = torch.einsum("bhlm,bmhc->blhc", att, vc)
        bonus = torch.einsum("blhc,hc,blhc->blh", rc, u, kc)
        y = y + bonus[..., None] * vc
        y = y + torch.einsum("blhc,bhcd->blhd", qt, S)
        cl_end = cl[:, -1:]                               # (B,1,H,C)
        k2 = kc * torch.exp(torch.clamp(cl_end - cl, min=-CLAMP))
        S = torch.exp(torch.clamp(cl_end[:, 0], min=-CLAMP))[..., None] * S \
            + torch.einsum("blhc,blhd->bhcd", k2, vc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :T], S


def time_mix(x, p, cfg: ModelConfig, *, S0=None, x_prev=None):
    """Returns (out, S_final, last_x). x: (B, T, d)."""
    if shlib.is_dtensor(x):
        return _time_mix_sharded(x, p, cfg, S0=S0, x_prev=x_prev)
    return _time_mix(x, p, cfg, S0=S0, x_prev=x_prev)


def _time_mix_sharded(x, p, cfg: ModelConfig, *, S0=None, x_prev=None):
    """:func:`_time_mix` on each rank's batch rows and heads (see the
    module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    m = names.index("model")
    C = cfg.rwkv_head_size
    H = x.shape[-1] // C
    tp = H % mesh.size(m) == 0          # heads over the model axis
    x = shlib.settle(x)
    batch_pl = tuple(Replicate() if i == m else pl for i, pl in enumerate(x.placements))
    x = x.redistribute(mesh, batch_pl)

    def laid(t, dim):
        """``t`` whole except ``dim`` over the model axis (when ``tp``)."""
        pl = tuple(Shard(dim) if (i == m and tp and dim is not None) else Replicate()
                   for i in range(len(names)))
        return t.redistribute(mesh, pl)

    heads = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "wo": 0, "u": 0, "ln_x": 0,
             "w_base": 0, "w_lora_b": 1}
    names_p = sorted(p)
    ws = [laid(p[n], heads.get(n)) for n in names_p]
    # a weight's gradient: a sum over this rank's rows, and over the
    # model axis for what each rank reads whole while it serves its heads
    def grad_of(n):
        def one(i, pl):
            if i == m:
                return Partial() if tp and n not in heads else pl
            return Partial() if x.placements[i].is_shard() else pl
        return tuple(one(i, pl) for i, pl in enumerate(laid(p[n], heads.get(n)).placements))
    over_model = tuple(Partial() if i == m and tp else pl
                       for i, pl in enumerate(batch_pl))
    state_pl = tuple(Shard(1) if i == m and tp else pl for i, pl in enumerate(batch_pl))
    extra = []
    if S0 is not None:
        extra.append(shlib.settle(S0).redistribute(mesh, state_pl))
    if x_prev is not None:
        extra.append(shlib.settle(x_prev).redistribute(mesh, batch_pl))
    B, T, d = x.shape

    def local(xl, *rest):
        pl_ = dict(zip(names_p, rest[:len(names_p)]))
        more = list(rest[len(names_p):])
        s0 = more.pop(0) if S0 is not None else None
        xp = more.pop(0) if x_prev is not None else None
        out, S, _ = _time_mix(xl, pl_, cfg, S0=s0, x_prev=xp,
                              heads=pl_["u"].shape[0])
        return out, S

    out_like = shlib.template(x, x.shape, x.dtype, over_model)
    s_like = shlib.template(x, (B, H, C, C), torch.float32, state_pl)
    out, S = shlib.on_local(
        local, x, *ws, *extra, out_like=(out_like, s_like),
        grad_placements=(over_model, *(grad_of(n) for n in names_p),
                         *(None for _ in extra)))
    return shard(out, "batch", "seq", "embed"), S, x[:, -1]


def _time_mix(x, p, cfg: ModelConfig, *, S0=None, x_prev=None, heads=None):
    """The time mix over ``heads`` heads (all of ``x``'s when None; a
    rank's own in a sharded run, with the r/k/v/g and decay columns,
    ``u``, ``ln_x`` and the rows of ``wo`` for those heads)."""
    B, T, d = x.shape
    C = cfg.rwkv_head_size
    H = d // C if heads is None else heads
    xx = _token_shift(x, x_prev) - x
    xw, xk, xv, xr, xg = _ddlerp(x, xx, p)

    r = torch.matmul(xr, p["wr"].to(x.dtype))
    k = torch.matmul(xk, p["wk"].to(x.dtype))
    v = torch.matmul(xv, p["wv"].to(x.dtype))
    g = torch.matmul(xg, p["wg"].to(x.dtype))
    w_raw = p["w_base"].to(torch.float32) + torch.matmul(
        torch.matmul(xw.to(torch.float32), p["w_lora_a"].to(torch.float32)),
        p["w_lora_b"].to(torch.float32))
    logw = -torch.exp(torch.clamp(w_raw, -8.0, 4.0))      # log decay < 0

    rs = r.reshape(B, T, H, C).to(torch.float32)
    ks = k.reshape(B, T, H, C).to(torch.float32)
    vs = v.reshape(B, T, H, C).to(torch.float32)
    ws = logw.reshape(B, T, H, C)
    if S0 is None:
        S0 = torch.zeros((B, H, C, C), dtype=torch.float32, device=x.device)
    y, S = wkv_chunked(rs, ks, vs, ws, p["u"].to(torch.float32), S0, cfg.scan_chunk)
    y = y.reshape(B, T, H * C).to(x.dtype)
    # per-head group norm (scale-only), then output gating
    yh32 = y.reshape(B, T, H, C).to(torch.float32)
    mu = torch.mean(yh32, dim=-1, keepdim=True)
    var = torch.var(yh32, dim=-1, keepdim=True, unbiased=False)
    yh = ((yh32 - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    y = yh.reshape(B, T, H * C) * p["ln_x"].to(x.dtype)
    y = y * F.silu(g)
    out = torch.matmul(y, p["wo"].to(x.dtype))
    return shard(out, "batch", "seq", "embed"), S, x[:, -1]


def channel_mix(x, p, cfg: ModelConfig, *, x_prev=None):
    if shlib.is_dtensor(x):
        return _channel_mix_sharded(x, p, cfg, x_prev=x_prev)
    xx = _token_shift(x, x_prev) - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(torch.matmul(xk, p["wk"].to(x.dtype))))
    k = shard(k, "batch", "seq", "ffn")
    kv = torch.matmul(k, p["wv"].to(x.dtype))
    r = torch.sigmoid(torch.matmul(xr, p["wr"].to(x.dtype)))
    return shard(r * kv, "batch", "seq", "embed"), x[:, -1]


def _channel_mix_sharded(x, p, cfg: ModelConfig, *, x_prev=None):
    """:func:`channel_mix` in regions on local shards: the key product
    over the rank's ``ffn`` columns, the value product (a pending sum,
    reduced), the receptance product over its ``heads`` columns, their
    gated product on those columns, gathered by the closing ``shard``.
    Each product is a region of its own: where the batch does not split,
    a product is a pending sum over the FSDP dim (``pinned``)."""
    row, chan = ("batch", "seq", "embed"), ("batch", "seq", "heads")
    prev = ("batch", "embed")

    def mixed(xl, pl, mu, w):
        return torch.matmul(xl + (_token_shift(xl, pl) - xl) * mu.to(xl.dtype),
                            w.to(xl.dtype))

    k = shlib.pinned(mixed, x, x_prev, p["mu_k"], p["wk"],
                     axes=(row, prev, ("embed",), None), out_axes=("batch", "seq", "ffn"),
                     out_shape=(*x.shape[:-1], p["wk"].shape[1]), out_dtype=x.dtype)
    kv = shlib.settle(shlib.pinned(
        lambda kl, wv: torch.matmul(torch.square(torch.relu(kl)), wv.to(kl.dtype)),
        k, p["wv"], axes=(("batch", "seq", "ffn"), None),
        out_axes=row, out_shape=tuple(x.shape), out_dtype=x.dtype))
    r = shlib.pinned(mixed, x, x_prev, p["mu_r"], p["wr"],
                     axes=(row, prev, ("embed",), None),
                     out_axes=chan, out_shape=tuple(x.shape), out_dtype=x.dtype)
    rkv = shlib.pinned(lambda rl, kvl: torch.sigmoid(rl) * kvl, r, kv, axes=(chan, chan),
                       out_axes=chan, out_shape=tuple(x.shape), out_dtype=x.dtype)
    return shard(rkv, "batch", "seq", "embed"), x[:, -1]


class RWKV6LM(nn.Module):
    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        if cfg.d_model % cfg.rwkv_head_size != 0:
            raise ValueError(
                f"d_model {cfg.d_model} is not a multiple of the head size "
                f"{cfg.rwkv_head_size}")
        self.cfg = cfg

    def param_defs(self) -> dict:
        return rwkv_defs(self.cfg)

    def _block(self, h, lp, S0=None, xa=None, xc=None):
        cfg = self.cfg
        a, S, last_a = time_mix(L.norm(h, lp["ln1"], cfg.norm), lp["tm"], cfg,
                                S0=S0, x_prev=xa)
        h = h + a
        c, last_c = channel_mix(L.norm(h, lp["ln2"], cfg.norm), lp["cm"], cfg, x_prev=xc)
        return shard(h + c, "batch", "seq", "embed"), S, last_a, last_c

    def _forward(self, params, x, state=None, *, remat: bool = False):
        """state: (S, xa, xc) stacked over layers, or None (train and
        prefill). ``remat``: checkpoint each layer (training)."""
        cfg = self.cfg
        block = self._block
        if remat and torch.is_grad_enabled():
            block = checkpointed(block)
        outs = []
        for i in range(cfg.n_layers):
            lp = layer_params(params["layers"], i)
            layer_state = () if state is None else tuple(s[i] for s in state)
            x, *new = block(x, lp, *layer_state)
            outs.append(new)
        new_state = tuple(torch.stack(parts) for parts in zip(*outs))
        return L.norm(x, params["ln_f"], cfg.norm), new_state

    def _embed(self, params, tokens):
        x = L.embed_tokens(tokens, params["tok"], self.cfg)
        return L.norm(x, params["ln_in"], self.cfg.norm)

    def loss(self, params, batch):
        cfg = self.cfg
        with step_program():
            params = cast_params(params, cfg.compute_dtype)
            h, _ = self._forward(params, self._embed(params, batch["tokens"]), remat=True)
            logits = L.logits_out(h, params["tok"], cfg)
            return L.cross_entropy(logits, batch["labels"], batch.get("mask"))

    def prefill(self, params, batch):
        """Logits of the last position, and the stacked (S, xa, xc) state."""
        cfg = self.cfg
        with step_program():
            params = cast_params(params, cfg.compute_dtype)
            h, state = self._forward(params, self._embed(params, batch["tokens"]))
            return L.logits_out(h[:, -1:], params["tok"], cfg), state

    def decode_step(self, params, state, tokens, pos):
        """One-token decode; ``pos`` is unused (the state carries the
        history), as in the reference."""
        cfg = self.cfg
        with step_program():
            params = cast_params(params, cfg.compute_dtype)
            h, state = self._forward(params, self._embed(params, tokens), state=state)
            return L.logits_out(h, params["tok"], cfg), state

    def init_cache_shape(self, batch: int, max_len: int) -> tuple[tuple[int, ...], ...]:
        """The shape of each state tensor: (S, xa, xc)."""
        cfg = self.cfg
        C = cfg.rwkv_head_size
        H = cfg.d_model // C
        return ((cfg.n_layers, batch, H, C, C), (cfg.n_layers, batch, cfg.d_model),
                (cfg.n_layers, batch, cfg.d_model))

    def init_cache(self, batch: int, max_len: int, *,
                   device: "torch.device | str" = "cpu"):
        """Zeros; S in fp32, the shifted inputs in the compute dtype."""
        dtypes = (torch.float32, self.cfg.compute_dtype, self.cfg.compute_dtype)
        return tuple(torch.zeros(shape, dtype=dt, device=device)
                     for shape, dt in zip(self.init_cache_shape(batch, max_len), dtypes))
