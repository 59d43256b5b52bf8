"""The yardstick: the H100's published peaks, and the operations and
bytes the served work needs, counted from the configuration's shapes.

Peaks: NVIDIA H100 Tensor Core GPU data sheet, SXM part at 700 W, dense
rates (no sparsity). Operations are multiply-adds counted twice.
"""

from __future__ import annotations

from pbench.shapes import Shapes

PEAK_BF16_FLOPS = 989e12     # dense bf16 tensor-core FLOP/s
PEAK_HBM_BYTES_S = 3.35e12   # HBM3 bytes/s
BF16_BYTES = 2


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


def prefill_flops(s: Shapes, batch: int, t: int) -> float:
    """A batch's prefill: every prompt token through the layers, the head
    at the last position."""
    return batch * (t * linear_flops_per_token(s) + causal_attention_flops(s, t)
                    + head_flops(s))


def decode_flops(s: Shapes, batch: int, t: int, new_tokens: int) -> float:
    """A batch's decode steps after its prefill: ``new_tokens - 1`` steps,
    step ``i`` writing position ``t + i`` and reading ``t + i + 1`` keys."""
    per = sum(linear_flops_per_token(s) + head_flops(s)
              + decode_attention_flops(s, t + i + 1) for i in range(new_tokens - 1))
    return batch * per


def request_flops(s: Shapes, batch: int, t: int, new_tokens: int) -> float:
    return prefill_flops(s, batch, t) + decode_flops(s, batch, t, new_tokens)


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def flash_call(b: int, tq: int, tkv: int, h: int, hk: int, dh: int,
               causal: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of one flash-attention call in bf16: the score and
    value products over the keys each query needs; q, k, v read once and
    the output written once."""
    if causal:
        # query i (of the last tq of tkv positions) reads tkv - tq + i + 1 keys
        pairs = tq * (tkv - tq) + tq * (tq + 1) / 2
    else:
        pairs = tq * tkv
    flops = 4.0 * b * h * dh * pairs
    nbytes = BF16_BYTES * (2 * b * tq * h * dh + 2 * b * tkv * hk * dh)
    return flops, nbytes


def moe_call(s: Shapes, tokens: int, experts_used: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one MoE layer over ``tokens`` tokens: the router,
    and each token's top-k experts' three products; the router and each
    expert the routing chose read once, the input read and the output
    written once."""
    flops = 2.0 * tokens * (s.d * s.experts + s.top_k * 3 * s.d * s.d_ff)
    nbytes = BF16_BYTES * (s.d * s.experts + experts_used * 3 * s.d * s.d_ff
                           + 2 * tokens * s.d)
    return flops, nbytes
