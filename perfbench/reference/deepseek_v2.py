"""The kind of block ``deepseek_v2``: DeepSeek-V2's decoder, with latent
attention (MLA) in every layer, the first ``first_k_dense_replace``
layers a dense SwiGLU and the rest routed SwiGLU experts (softmax
scores, greedy top-k, ``norm_topk_prob``) beside shared ones, under
GShard capacity dispatch as the port runs experts.

This module is the one place of the benchmark that knows the kind: its
sizes as the published ``config.json`` names them (:func:`shapes`), its
weights' layout (:func:`param_layout`), the port's ``ModelConfig``
fields that run it (:func:`program_fields`), the yardstick's counts of
its work (and of its flash calls, :func:`flash_call`), its tiny CPU
stand-in (:func:`small_config`), and its plain reference
(:func:`served_logits`). It imports nothing of the program.

The reference is the expanded forward as published (the Hugging Face
``modeling_deepseek.py`` of DeepSeek-V2, without a query latent): the
queries, the latent ``c_kv`` and the shared rope key from the hidden
state, the latent's RMSNorm, every head's nope key and value from the
latent, YaRN RoPE on the rope parts (de-interleaved, then rotated by
halves, as published), causal softmax attention at YaRN's scale in
blocks of queries, in float32 with TF32 off. It follows the
configuration's departures: the experts' capacity per group of tokens
(counted as the serving loop made its calls: :func:`served_logits` of
the ``transformer`` kind says how), and the router in float32.
``products`` as the ``transformer`` kind takes it (``"fp8"``, the
control; ``"bf16"``, a witness).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from pbench.spec import load_file_module
from pbench.weights import layer
from pbench.yardstick import BF16_BYTES

base = load_file_module(Path(__file__).with_name("transformer.py"), "reference")
call_groups = base.call_groups
capacity = base.capacity


# ------------------------------------------------------------------ sizes
@dataclasses.dataclass(frozen=True)
class Yarn:
    """``rope_scaling`` of type ``yarn``, under the names the port's
    ``YarnScaling`` reads."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float


@dataclasses.dataclass(frozen=True)
class Shapes:
    n_layers: int
    d: int
    heads: int
    vocab: int
    kv_lora_rank: int
    qk_nope: int
    qk_rope: int
    v_head: int
    first_k_dense: int
    dense_ff: int         # the leading dense layers' SwiGLU width
    d_ff: int             # one routed expert's width (and one shared expert's)
    experts: int
    top_k: int
    shared: int           # shared experts, run by every token, ungated
    norm_topk_prob: bool
    capacity_factor: float
    group_size: int
    rope_theta: float
    yarn: Yarn
    eps: float = 1e-6

    @property
    def qk_head(self) -> int:
        return self.qk_nope + self.qk_rope

    @property
    def shared_ff(self) -> int:
        return self.shared * self.d_ff

    @property
    def moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense


def shapes(conf: dict) -> Shapes:
    """The sizes of a configuration file (DeepSeek-V2's ``config.json``
    keys, with the run's settings under ``runs_as``)."""
    run = conf["runs_as"]
    want = {"hidden_act": "silu", "q_lora_rank": None, "scoring_func": "softmax",
            "topk_method": "greedy", "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
            "routed_scaling_factor": 1, "tie_word_embeddings": False, "attention_bias": False}
    for key, value in want.items():
        if conf.get(key, value) != value:
            raise ValueError(f"{key} {conf[key]!r}: only {value!r} is run")
    rs = conf["rope_scaling"]
    if rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling {rs!r}: only yarn is run")
    return Shapes(
        n_layers=int(conf["num_hidden_layers"]), d=int(conf["hidden_size"]),
        heads=int(conf["num_attention_heads"]), vocab=int(conf["vocab_size"]),
        kv_lora_rank=int(conf["kv_lora_rank"]), qk_nope=int(conf["qk_nope_head_dim"]),
        qk_rope=int(conf["qk_rope_head_dim"]), v_head=int(conf["v_head_dim"]),
        first_k_dense=int(conf["first_k_dense_replace"]),
        dense_ff=int(conf["intermediate_size"]), d_ff=int(conf["moe_intermediate_size"]),
        experts=int(conf["n_routed_experts"]), top_k=int(conf["num_experts_per_tok"]),
        shared=int(conf["n_shared_experts"]), norm_topk_prob=bool(conf["norm_topk_prob"]),
        capacity_factor=float(run["capacity_factor"]), group_size=int(run["moe_group_size"]),
        rope_theta=float(conf["rope_theta"]),
        yarn=Yarn(factor=float(rs["factor"]),
                  original_max_position_embeddings=int(rs["original_max_position_embeddings"]),
                  beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
                  mscale=float(rs["mscale"]), mscale_all_dim=float(rs["mscale_all_dim"])),
        eps=float(conf["rms_norm_eps"]),
    )


def small_config(conf: dict, *, dtype: str | None = None, group: int = 16) -> dict:
    """A tiny stand-in of ``conf`` for the CPU tests: one dense layer and
    two expert layers at tiny widths, the published YaRN and routing
    (``dtype`` the served type, ``group`` the experts' group length: 16,
    so that the tests' few dozen prompt tokens overflow some expert's
    capacity)."""
    c = copy.deepcopy(conf)
    c.update(num_hidden_layers=3, hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             vocab_size=256, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, first_k_dense_replace=1, intermediate_size=96,
             moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2)
    c["runs_as"] = dict(c["runs_as"], moe_group_size=group)
    if dtype:
        c["runs_as"] = dict(c["runs_as"], dtype=dtype)
    return c


# ---------------------------------------------------------------- weights
def param_layout(s: Shapes) -> list[tuple[tuple[str, ...], tuple[int, ...], float]]:
    """(path, shape, scale) of every leaf, in the port's tree: ``tok``,
    ``layers`` (norms and latent attention, every layer), ``ln_f``, then
    the leading dense layers' FFN (``dense_ffn``) and the expert layers'
    (``moe_ffn``), each stacked on a leading axis of its own layers;
    scale 0 marks a norm scale (ones)."""
    L, d, H, R = s.n_layers, s.d, s.heads, s.kv_lora_rank
    k, Lm, E, ff, sff = s.first_k_dense, s.moe_layers, s.experts, s.d_ff, s.shared_ff
    inv = lambda n: 1.0 / math.sqrt(n)
    return [
        (("tok", "embed"), (s.vocab, d), 0.02),
        (("tok", "unembed"), (d, s.vocab), inv(d)),
        (("layers", "ln1"), (L, d), 0.0),
        (("layers", "ln2"), (L, d), 0.0),
        (("layers", "attn", "wq"), (L, d, H, s.qk_head), inv(d)),
        (("layers", "attn", "wkv_a"), (L, d, R + s.qk_rope), inv(d)),
        (("layers", "attn", "kv_norm"), (L, R), 0.0),
        (("layers", "attn", "wkv_b"), (L, R, H, s.qk_nope + s.v_head), inv(R)),
        (("layers", "attn", "wo"), (L, H, s.v_head, d), inv(H * s.v_head)),
        (("ln_f",), (d,), 0.0),
        (("dense_ffn", "w_gate"), (k, d, s.dense_ff), inv(d)),
        (("dense_ffn", "w_up"), (k, d, s.dense_ff), inv(d)),
        (("dense_ffn", "w_down"), (k, s.dense_ff, d), inv(s.dense_ff)),
        (("moe_ffn", "router"), (Lm, d, E), inv(d)),
        (("moe_ffn", "w_gate"), (Lm, E, d, ff), inv(d)),
        (("moe_ffn", "w_up"), (Lm, E, d, ff), inv(d)),
        (("moe_ffn", "w_down"), (Lm, E, ff, d), inv(ff)),
        (("moe_ffn", "shared", "w_gate"), (Lm, d, sff), inv(d)),
        (("moe_ffn", "shared", "w_up"), (Lm, d, sff), inv(d)),
        (("moe_ffn", "shared", "w_down"), (Lm, sff, d), inv(sff)),
    ]


# ---------------------------------------------------------------- program
def program_fields(s: Shapes, conf: dict) -> dict:
    """Every field of the port's ``ModelConfig`` (its ``MLAConfig``) that
    the run sets."""
    if s.eps != 1e-6:
        raise ValueError(f"rms_norm_eps {s.eps}: the port's rmsnorm runs at 1e-6")
    dtype = getattr(torch, conf["runs_as"]["dtype"])
    return dict(
        family="moe", n_layers=s.n_layers, d_model=s.d, n_heads=s.heads, n_kv_heads=s.heads,
        d_head=s.qk_head, d_ff=s.d_ff, vocab=s.vocab, rope_theta=s.rope_theta, act="swiglu",
        qkv_bias=False, param_dtype=dtype, compute_dtype=dtype, n_experts=s.experts,
        top_k=s.top_k, n_shared_experts=s.shared, capacity_factor=s.capacity_factor,
        moe_group_size=s.group_size, kv_lora_rank=s.kv_lora_rank, qk_nope_head_dim=s.qk_nope,
        qk_rope_head_dim=s.qk_rope, v_head_dim=s.v_head, first_k_dense=s.first_k_dense,
        dense_d_ff=s.dense_ff, norm_topk_prob=s.norm_topk_prob, rope_scaling=s.yarn)


# ------------------------------------------------- the yardstick's counts
def _attention_products(s: Shapes) -> int:
    """A token's multiply-adds in one layer's attention products: the
    queries, the latent and rope key, ``wkv_b`` (in decode the same count
    as the absorbed W_uk and W_uv: R x H x (nope + v)), the output."""
    d, H, R = s.d, s.heads, s.kv_lora_rank
    return (d * H * s.qk_head + d * (R + s.qk_rope) + R * H * (s.qk_nope + s.v_head)
            + H * s.v_head * d)


def _expert_layer(s: Shapes) -> int:
    """A token's multiply-adds in one expert layer: the router, its top-k
    experts and the shared experts."""
    return s.d * s.experts + 3 * s.d * (s.top_k * s.d_ff + s.shared_ff)


def linear_flops_per_token(s: Shapes) -> float:
    """The products of one token through every layer: attention's, the
    dense FFN of the leading layers, the router, top-k and shared experts
    of the rest, without the output head."""
    return 2.0 * (s.n_layers * _attention_products(s)
                  + s.first_k_dense * 3 * s.d * s.dense_ff + s.moe_layers * _expert_layer(s))


def head_flops(s: Shapes) -> float:
    """The output head at one position."""
    return 2.0 * s.d * s.vocab


def causal_attention_flops(s: Shapes, t: int) -> float:
    """Scores over nope + rope and values over ``v_head_dim`` of a causal
    prefill of ``t`` tokens, expanded, every layer and head."""
    return 2.0 * s.n_layers * s.heads * (s.qk_head + s.v_head) * t * (t + 1) / 2


def decode_attention_flops(s: Shapes, keys: int) -> float:
    """One query over ``keys`` cached tokens, absorbed, every layer and
    head: scores over the latent and the rope key (R + rope), values over
    the latent (R)."""
    return 2.0 * s.n_layers * s.heads * (2 * s.kv_lora_rank + s.qk_rope) * keys


def moe_call(s: Shapes, tokens: int, experts_used: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one expert layer over ``tokens`` tokens: the
    router, each token's top-k experts and the shared experts; the
    router, each expert the routing chose and the shared experts read
    once, the input read and the output written once."""
    flops = 2.0 * tokens * _expert_layer(s)
    nbytes = BF16_BYTES * (s.d * s.experts + (experts_used * s.d_ff + s.shared_ff) * 3 * s.d
                           + 2 * tokens * s.d)
    return flops, nbytes


def flash_call(s: Shapes, call: tuple) -> tuple[float, float]:
    """(FLOPs, bytes) of one flash call of the expanded prefill, as the
    trace records it, ``(B, Tq, Tkv, H, Hk, Dh, causal)`` with ``Dh`` q's
    and k's head dim: scores over ``Dh`` and values over ``v_head_dim``
    of the keys each query needs; q, k and v read once and the output
    written once, in bf16."""
    b, tq, tkv, h, hk, dh, causal = call
    dv = s.v_head
    pairs = tq * (tkv - tq) + tq * (tq + 1) / 2 if causal else tq * tkv
    flops = 2.0 * b * h * (dh + dv) * pairs
    nbytes = BF16_BYTES * b * (tq * h + tkv * hk) * (dh + dv)
    return flops, nbytes


# -------------------------------------------------------------- reference
def _yarn_inv_freq(s: Shapes, device) -> torch.Tensor:
    """``DeepseekV2YarnRotaryEmbedding``'s ``inv_freq``."""
    dim, y, b = s.qk_rope, s.yarn, s.rope_theta
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    freq_extra = 1.0 / (b ** (ar / dim))
    freq_inter = 1.0 / (y.factor * b ** (ar / dim))

    def corr(rot):
        return (dim * math.log(y.original_max_position_embeddings / (rot * 2 * math.pi))
                / (2 * math.log(b)))

    low = max(math.floor(corr(y.beta_fast)), 0)
    high = min(math.ceil(corr(y.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def _mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def softmax_scale(s: Shapes) -> float:
    """``q_head_dim ** -0.5`` times ``yarn_get_mscale(factor,
    mscale_all_dim)`` squared."""
    m = _mscale(s.yarn.factor, s.yarn.mscale_all_dim)
    return s.qk_head ** -0.5 * m * m


def _rope(x: torch.Tensor, s: Shapes) -> torch.Tensor:
    """x (B, L, H, rope) at positions 0..L-1, as published: the pairs
    de-interleaved, then rotated by halves, cos and sin times YaRN's
    ``mscale / mscale_all_dim``."""
    B, L, H, D = x.shape
    inv = _yarn_inv_freq(s, x.device)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * inv
    emb = torch.cat([ang, ang], dim=-1)
    m = _mscale(s.yarn.factor, s.yarn.mscale) / _mscale(s.yarn.factor, s.yarn.mscale_all_dim)
    cos, sin = (torch.cos(emb) * m)[None, :, None], (torch.sin(emb) * m)[None, :, None]
    x = x.reshape(B, L, H, D // 2, 2).transpose(-1, -2).reshape(B, L, H, D)
    rot = torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
    return x * cos + rot * sin


def _attention(q, k, v, scale: float, products: str, chunk_elems: int = 1 << 28):
    """Causal softmax attention, every head its own keys: q, k (B, L, H,
    Dk), v (B, L, H, Dv) -> (B, L, H, Dv). Queries in chunks, each over
    the keys up to its last."""
    B, L, H, _ = q.shape
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))   # (B, H, L, .)
    out = q.new_empty(B, H, L, v.shape[-1])
    step = max(1, chunk_elems // (B * H * L))
    pos = torch.arange(L, device=q.device)
    for a in range(0, L, step):
        b = min(L, a + step)
        sc = base._mm(q[:, :, a:b], k[:, :, :b].transpose(-1, -2), products) * scale
        sc.masked_fill_(pos[None, :b] > pos[a:b, None], float("-inf"))
        out[:, :, a:b] = base._mm(torch.softmax(sc, dim=-1), v[:, :, :b], products)
        del sc
    return out.transpose(1, 2)


def _moe(h: torch.Tensor, p: dict, s: Shapes, calls, products: str) -> torch.Tensor:
    """h (N, d) flattened by rows -> the routed experts' output: softmax
    scores in float32, greedy top-k (renormalised where
    ``norm_topk_prob``), each choice kept only within its expert's
    capacity in its group (the ``transformer`` kind's count), each kept
    choice's expert output times its gate."""
    N = h.shape[0]
    probs = torch.softmax(h @ p["router"].float(), dim=-1)
    w, idx = probs.topk(s.top_k, dim=-1)
    if s.norm_topk_prob:
        w = w / w.sum(-1, keepdim=True)
    keep = torch.zeros_like(w, dtype=torch.bool)
    for groups in calls:
        C = capacity(s, groups[0].numel())
        for g in groups:
            g = g.to(h.device)
            onehot = F.one_hot(idx[g], s.experts)             # (S, k, E)
            place = (onehot.cumsum(0) * onehot).sum(-1) - 1   # (S, k)
            keep[g] = place < C
    weight = torch.zeros(N, s.experts, device=h.device)
    weight.scatter_add_(1, idx, w * keep)
    out = torch.zeros_like(h)
    for e in torch.nonzero(weight.sum(0)).flatten().tolist():
        rows = torch.nonzero(weight[:, e]).flatten()
        x = h[rows]
        g = base._mm(x, p["w_gate"][e].float(), products)
        u = base._mm(x, p["w_up"][e].float(), products)
        y = base._mm(F.silu(g) * u, p["w_down"][e].float(), products)
        out.index_add_(0, rows, y * weight[rows, e, None])
    return out


@torch.no_grad()
def served_logits(params: dict, conf: dict, prompts: torch.Tensor, served: torch.Tensor,
                  products: str = "fp32") -> torch.Tensor:
    """Logits (B, n, V), float32, of the positions that chose each of the
    ``served`` (B, n) tokens after the ``prompts`` (B, T)."""
    s = shapes(conf)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _served_logits(params, s, prompts, served, products)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _served_logits(params, s: Shapes, prompts, served, products):
    B, T = prompts.shape
    n = served.shape[1]
    seq = torch.cat([prompts, served[:, :n - 1]], dim=1)         # (B, L)
    L = seq.shape[1]
    H, R, nope = s.heads, s.kv_lora_rank, s.qk_nope
    calls = call_groups(B, T, L, s.group_size)
    mm = lambda a, w: base._mm(a, w.float().reshape(a.shape[-1], -1), products)
    x = params["tok"]["embed"][seq].float()                      # (B, L, d)
    for i in range(s.n_layers):
        lp = layer(params["layers"], i)
        a = lp["attn"]
        h = base._rms(x, lp["ln1"], s.eps).reshape(B * L, s.d)
        q = mm(h, a["wq"]).view(B, L, H, s.qk_head)
        ckv = mm(h, a["wkv_a"])
        c = base._rms(ckv[:, :R], a["kv_norm"], s.eps)
        k_pe = _rope(ckv[:, R:].reshape(B, L, 1, s.qk_rope), s)
        kv = mm(c, a["wkv_b"]).view(B, L, H, nope + s.v_head)
        del h, ckv, c
        q = torch.cat([q[..., :nope], _rope(q[..., nope:], s)], dim=-1)
        k = torch.cat([kv[..., :nope], k_pe.expand(B, L, H, s.qk_rope)], dim=-1)
        o = _attention(q, k, kv[..., nope:], softmax_scale(s), products)
        del q, k, kv, k_pe
        x = x + mm(o.reshape(B * L, -1), a["wo"]).view(B, L, s.d)
        del o
        h = base._rms(x, lp["ln2"], s.eps).reshape(B * L, s.d)
        if i < s.first_k_dense:
            f = base._mlp(h, layer(params["dense_ffn"], i), products)
        else:
            p = layer(params["moe_ffn"], i - s.first_k_dense)
            f = _moe(h, p, s, calls, products) + base._mlp(h, p["shared"], products)
        x = x + f.view(B, L, s.d)
        del h, f
    h = base._rms(x[:, T - 1:], params["ln_f"], s.eps)           # (B, n, d)
    return base._mm(h, params["tok"]["unembed"].float(), products)
