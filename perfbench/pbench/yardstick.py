"""The yardstick: the H100's published peaks, and the operations and
bytes the served work needs, counted from the configuration's shapes.

The counts that depend on the kind of block (a token through the
layers, the head, attention in prefill and in decode, one MoE call) are
the kind module's (:func:`pbench.spec.kind_of`); a request's, a flash
call's and the roofline are worked out here from them.

Peaks: NVIDIA H100 Tensor Core GPU data sheet, SXM part at 700 W, dense
rates (no sparsity). Operations are multiply-adds counted twice.
"""

from __future__ import annotations

from typing import Any

from pbench.spec import kind_of

Shapes = Any    # a kind's sizes: what its ``shapes(conf)`` returns

PEAK_BF16_FLOPS = 989e12     # dense bf16 tensor-core FLOP/s
PEAK_HBM_BYTES_S = 3.35e12   # HBM3 bytes/s
BF16_BYTES = 2


def linear_flops_per_token(s: Shapes) -> float:
    """The products of one token through every layer at its active
    parameters, without the output head."""
    return kind_of(s).linear_flops_per_token(s)


def head_flops(s: Shapes) -> float:
    """The output head at one position."""
    return kind_of(s).head_flops(s)


def causal_attention_flops(s: Shapes, t: int) -> float:
    """Scores and values of a causal prefill of ``t`` tokens, every layer."""
    return kind_of(s).causal_attention_flops(s, t)


def decode_attention_flops(s: Shapes, keys: int) -> float:
    """Scores and values of one query over ``keys`` cached keys, every layer."""
    return kind_of(s).decode_attention_flops(s, keys)


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
    """(FLOPs, bytes) of one MoE layer over ``tokens`` tokens, whose
    routing chose ``experts_used`` experts."""
    return kind_of(s).moe_call(s, tokens, experts_used)
