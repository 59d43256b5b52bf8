"""The kind of block ``transformer``: a decoder of pre-norm blocks, each
multi-head attention (grouped KV heads, RoPE) and a dense SwiGLU or a
mixture of SwiGLU experts under GShard capacity dispatch (the
``runs_as`` family ``dense`` or ``moe``).

This module is the one place of the benchmark that knows the kind: its
sizes as the published ``config.json`` names them (:func:`shapes`), its
weights' layout (:func:`param_layout`), the port's ``ModelConfig``
fields that run it (:func:`program_fields`), the yardstick's counts of
its work, its tiny CPU stand-in (:func:`small_config`), and its plain
reference (:func:`served_logits`). It imports nothing of the program.

The reference follows the configuration file as it is run (its
published sizes, and the departures it states: interleaved-pair RoPE,
no q/k norm, the experts' capacity per group), in float32 with TF32
off, layer by layer, over the benchmark's own weights and tokens.

:func:`served_logits` runs each served sequence, its prompt and then
its served tokens but the last, as the serving loop ran it: one prefill
of the whole batch, then one decode step a position. That matters only
for the experts' capacity, which is counted per group of tokens of one
call: the prompt tokens of the batch in row order, in groups of
``moe_group_size``; a decode step's one token per sequence, in batch
order. Its logits at the positions that chose the served tokens are
returned.

``products="fp8"`` is the control: every matrix product's operands
rounded to float8 e4m3 with a scale per row of the left operand and per
column of the right one (the router stays float32). ``products="bf16"``
rounds them to bfloat16 instead: the configuration's own precision, a
witness of what bfloat16 products alone do to the served tokens.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
import torch.nn.functional as F

from pbench.weights import layer
from pbench.yardstick import BF16_BYTES


# ------------------------------------------------------------------ sizes
@dataclasses.dataclass(frozen=True)
class Shapes:
    family: str          # dense | moe
    n_layers: int
    d: int
    heads: int
    kv_heads: int
    d_head: int
    d_ff: int            # the dense MLP's width, or one expert's
    vocab: int
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    group_size: int = 0
    rope_theta: float = 1e4
    eps: float = 1e-6

    @property
    def q_width(self) -> int:
        return self.heads * self.d_head

    @property
    def kv_width(self) -> int:
        return self.kv_heads * self.d_head


def shapes(conf: dict) -> Shapes:
    """The sizes of a configuration file (Hugging Face ``config.json``
    keys, with the run's settings under ``runs_as``)."""
    run = conf["runs_as"]
    if conf.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {conf['hidden_act']!r}: only SwiGLU (silu) is run")
    if conf.get("tie_word_embeddings"):
        raise ValueError("tied embeddings are not run")
    heads = int(conf["num_attention_heads"])
    d = int(conf["hidden_size"])
    moe = run["family"] == "moe"
    return Shapes(
        family=run["family"],
        n_layers=int(conf["num_hidden_layers"]),
        d=d, heads=heads,
        kv_heads=int(conf.get("num_key_value_heads") or heads),
        d_head=int(conf.get("head_dim") or d // heads),
        d_ff=int(conf["moe_intermediate_size"] if moe else conf["intermediate_size"]),
        vocab=int(conf["vocab_size"]),
        experts=int(conf["num_experts"]) if moe else 0,
        top_k=int(conf["num_experts_per_tok"]) if moe else 0,
        capacity_factor=float(run["capacity_factor"]) if moe else 0.0,
        group_size=int(run["moe_group_size"]) if moe else 0,
        rope_theta=float(conf["rope_theta"]),
        eps=float(conf["rms_norm_eps"]),
    )


def small_config(conf: dict, *, dtype: str | None = None, group: int = 16) -> dict:
    """A tiny stand-in of ``conf`` for the CPU tests: the same family and
    settings, tiny widths (``dtype`` the served type, ``group`` the
    experts' group length: 16, so that the tests' few dozen prompt tokens
    overflow some expert's capacity)."""
    c = copy.deepcopy(conf)
    c.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, vocab_size=256)
    if c["runs_as"]["family"] == "moe":
        c.update(num_key_value_heads=2, head_dim=16, moe_intermediate_size=32,
                 num_experts=8, num_experts_per_tok=2)
        c["runs_as"] = dict(c["runs_as"], moe_group_size=group)
    else:
        c.update(num_key_value_heads=4, intermediate_size=128)
    if dtype:
        c["runs_as"] = dict(c["runs_as"], dtype=dtype)
    return c


# ---------------------------------------------------------------- weights
def param_layout(s: Shapes) -> list[tuple[tuple[str, ...], tuple[int, ...], float]]:
    """(path, shape, scale) of every leaf, in the port's tree:
    ``tok.{embed,unembed}``, ``layers.*`` stacked on a leading layer axis,
    ``ln_f``; scale 0 marks a norm scale (ones)."""
    L, d, ff = s.n_layers, s.d, s.d_ff
    inv = lambda n: 1.0 / math.sqrt(n)
    leaves = [
        (("tok", "embed"), (s.vocab, d), 0.02),
        (("tok", "unembed"), (d, s.vocab), inv(d)),
        (("layers", "ln1"), (L, d), 0.0),
        (("layers", "ln2"), (L, d), 0.0),
        (("layers", "attn", "wq"), (L, d, s.heads, s.d_head), inv(d)),
        (("layers", "attn", "wk"), (L, d, s.kv_heads, s.d_head), inv(d)),
        (("layers", "attn", "wv"), (L, d, s.kv_heads, s.d_head), inv(d)),
        (("layers", "attn", "wo"), (L, s.heads, s.d_head, d), inv(s.q_width)),
        (("ln_f",), (d,), 0.0),
    ]
    if s.family == "moe":
        E = s.experts
        leaves += [
            (("layers", "ffn", "router"), (L, d, E), inv(d)),
            (("layers", "ffn", "w_gate"), (L, E, d, ff), inv(d)),
            (("layers", "ffn", "w_up"), (L, E, d, ff), inv(d)),
            (("layers", "ffn", "w_down"), (L, E, ff, d), inv(ff)),
        ]
    else:
        leaves += [
            (("layers", "ffn", "w_gate"), (L, d, ff), inv(d)),
            (("layers", "ffn", "w_up"), (L, d, ff), inv(d)),
            (("layers", "ffn", "w_down"), (L, ff, d), inv(ff)),
        ]
    return leaves


# ---------------------------------------------------------------- program
def program_fields(s: Shapes, conf: dict) -> dict:
    """Every field of the port's ``ModelConfig`` that the run sets."""
    if s.eps != 1e-6:
        raise ValueError(f"rms_norm_eps {s.eps}: the port's rmsnorm runs at 1e-6")
    dtype = getattr(torch, conf["runs_as"]["dtype"])
    fields = dict(
        family=s.family, n_layers=s.n_layers, d_model=s.d, n_heads=s.heads,
        n_kv_heads=s.kv_heads, d_head=s.d_head, d_ff=s.d_ff, vocab=s.vocab,
        rope_theta=s.rope_theta, act="swiglu", qkv_bias=False,
        param_dtype=dtype, compute_dtype=dtype)
    if s.family == "moe":
        fields.update(n_experts=s.experts, top_k=s.top_k, n_shared_experts=0,
                      capacity_factor=s.capacity_factor, moe_group_size=s.group_size)
    return fields


# ------------------------------------------------- the yardstick's counts
def linear_flops_per_token(s: Shapes) -> float:
    """The products of one token through every layer: the attention
    projections and the FFN at its active experts (the router's top-k
    only, and its router), without the output head."""
    attn = s.d * (2 * s.q_width + 2 * s.kv_width)
    if s.family == "moe":
        ffn = s.top_k * 3 * s.d * s.d_ff + s.d * s.experts
    else:
        ffn = 3 * s.d * s.d_ff
    return 2.0 * s.n_layers * (attn + ffn)


def head_flops(s: Shapes) -> float:
    """The output head at one position."""
    return 2.0 * s.d * s.vocab


def causal_attention_flops(s: Shapes, t: int) -> float:
    """Scores and values of a causal prefill of ``t`` tokens, every layer:
    query ``i`` reads keys ``0..i``."""
    return 4.0 * s.n_layers * s.heads * s.d_head * t * (t + 1) / 2


def decode_attention_flops(s: Shapes, keys: int) -> float:
    """Scores and values of one query over ``keys`` cached keys, every layer."""
    return 4.0 * s.n_layers * s.heads * s.d_head * keys


def moe_call(s: Shapes, tokens: int, experts_used: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one MoE layer over ``tokens`` tokens: the router,
    and each token's top-k experts' three products; the router and each
    expert the routing chose read once, the input read and the output
    written once."""
    flops = 2.0 * tokens * (s.d * s.experts + s.top_k * 3 * s.d * s.d_ff)
    nbytes = BF16_BYTES * (s.d * s.experts + experts_used * 3 * s.d * s.d_ff
                           + 2 * tokens * s.d)
    return flops, nbytes


# -------------------------------------------------------------- reference
FP8_MAX = 448.0


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, products: str) -> torch.Tensor:
    if products == "fp8":
        a, b = _q8(a, -1), _q8(b, -2)
    elif products == "bf16":
        a, b = a.bfloat16().float(), b.bfloat16().float()
    return a @ b


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, L, H, Dh) at positions 0..L-1; interleaved pairs."""
    L, Dh = x.shape[1], x.shape[3]
    half = Dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = x1 * cos - x2 * sin
    out[..., 1::2] = x1 * sin + x2 * cos
    return out


def _attention(q, k, v, products: str, chunk_elems: int = 1 << 28) -> torch.Tensor:
    """Causal softmax attention; q (B, L, H, Dh), k, v (B, L, Hk, Dh);
    query head h reads key head h // (H / Hk). Queries in chunks."""
    B, L, H, Dh = q.shape
    G = H // k.shape[2]
    q = q.transpose(1, 2)                                   # (B, H, L, Dh)
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    out = torch.empty_like(q)
    step = max(1, chunk_elems // (B * H * L))
    pos = torch.arange(L, device=q.device)
    for a in range(0, L, step):
        b = min(L, a + step)
        s = _mm(q[:, :, a:b], k[:, :, :b].transpose(-1, -2), products) / math.sqrt(Dh)
        s = s.masked_fill(pos[None, :b] > pos[a:b, None], float("-inf"))
        out[:, :, a:b] = _mm(torch.softmax(s, dim=-1), v[:, :, :b], products)
    return out.transpose(1, 2)


def call_groups(B: int, T: int, L: int, group_size: int) -> list[list[torch.Tensor]]:
    """The token groups of each call the serving loop made, as indices
    into the (B, L) sequence flattened by rows: the prefill's B x T
    prompt tokens in row order, then each decode position's B tokens."""
    calls = []
    prompt = (torch.arange(B)[:, None] * L + torch.arange(T)[None]).flatten()
    calls.append(prompt)
    for t in range(T, L):
        calls.append(torch.arange(B) * L + t)
    out = []
    for idx in calls:
        S = min(group_size, idx.numel())
        out.append([idx[i:i + S] for i in range(0, idx.numel(), S)])
    return out


def capacity(s: Shapes, group: int) -> int:
    return max(4, math.ceil(group / s.experts * s.capacity_factor))


def _moe(h: torch.Tensor, p: dict, s: Shapes, calls, products: str) -> torch.Tensor:
    """h (N, d) flattened by rows -> the experts' combined output."""
    N = h.shape[0]
    probs = torch.softmax(h @ p["router"].float(), dim=-1)
    w, idx = probs.topk(s.top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    keep = torch.zeros_like(w, dtype=torch.bool)
    for groups in calls:
        C = capacity(s, groups[0].numel())
        for g in groups:
            g = g.to(h.device)
            onehot = F.one_hot(idx[g], s.experts)             # (S, k, E)
            # per choice j: the token's place among the group's tokens
            # whose j-th choice is the same expert, in order
            place = (onehot.cumsum(0) * onehot).sum(-1) - 1   # (S, k)
            keep[g] = place < C
    weight = torch.zeros(N, s.experts, device=h.device)
    weight.scatter_add_(1, idx, w * keep)
    out = torch.zeros_like(h)
    for e in torch.nonzero(weight.sum(0)).flatten().tolist():
        rows = torch.nonzero(weight[:, e]).flatten()
        x = h[rows]
        g = _mm(x, p["w_gate"][e].float(), products)
        u = _mm(x, p["w_up"][e].float(), products)
        y = _mm(F.silu(g) * u, p["w_down"][e].float(), products)
        out.index_add_(0, rows, y * weight[rows, e, None])
    return out


def _mlp(h: torch.Tensor, p: dict, products: str, rows: int = 1 << 14) -> torch.Tensor:
    out = torch.empty_like(h)
    wg, wu, wd = (p[n].float() for n in ("w_gate", "w_up", "w_down"))
    for a in range(0, h.shape[0], rows):
        x = h[a:a + rows]
        out[a:a + rows] = _mm(F.silu(_mm(x, wg, products)) * _mm(x, wu, products), wd, products)
    return out


def ffn(h: torch.Tensor, p: dict, s: Shapes, calls, products: str) -> torch.Tensor:
    """The block's FFN over ``h`` (N, d), flattened by rows: the experts
    (``calls`` the token groups of :func:`call_groups`) or the dense MLP."""
    return _moe(h, p, s, calls, products) if calls else _mlp(h, p, products)


@torch.no_grad()
def served_logits(params: dict, conf: dict, prompts: torch.Tensor, served: torch.Tensor,
                  products: str = "fp32", *, ffn=ffn) -> torch.Tensor:
    """Logits (B, n, V), float32, of the positions that chose each of the
    ``served`` (B, n) tokens after the ``prompts`` (B, T). ``ffn`` is the
    block's FFN (a kind that adds to it, as a shared expert does, passes
    its own)."""
    s = shapes(conf)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _served_logits(params, s, prompts, served, products, ffn)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _served_logits(params, s: Shapes, prompts, served, products, ffn):
    B, T = prompts.shape
    n = served.shape[1]
    seq = torch.cat([prompts, served[:, :n - 1]], dim=1)         # (B, L)
    L = seq.shape[1]
    calls = call_groups(B, T, L, s.group_size) if s.family == "moe" else None
    x = params["tok"]["embed"][seq].float()                      # (B, L, d)
    for i in range(s.n_layers):
        lp = layer(params["layers"], i)
        a = lp["attn"]
        h = _rms(x, lp["ln1"], s.eps).reshape(B * L, s.d)
        q = _mm(h, a["wq"].float().reshape(s.d, -1), products).view(B, L, s.heads, s.d_head)
        k = _mm(h, a["wk"].float().reshape(s.d, -1), products).view(B, L, s.kv_heads, s.d_head)
        v = _mm(h, a["wv"].float().reshape(s.d, -1), products).view(B, L, s.kv_heads, s.d_head)
        o = _attention(_rope(q, s.rope_theta), _rope(k, s.rope_theta), v, products)
        x = x + _mm(o.reshape(B * L, -1), a["wo"].float().reshape(-1, s.d),
                    products).view(B, L, s.d)
        del h, q, k, v, o
        h = _rms(x, lp["ln2"], s.eps).reshape(B * L, s.d)
        f = ffn(h, lp["ffn"], s, calls, products)
        x = x + f.view(B, L, s.d)
        del h, f
    h = _rms(x[:, T - 1:], params["ln_f"], s.eps)                # (B, n, d)
    return _mm(h, params["tok"]["unembed"].float(), products)
