"""The yardstick's counts against numbers worked by hand."""

import pytest

from pbench import spec
from pbench import yardstick as Y
from pbench.weights import n_params


def cfg(name):
    conf = spec.cell(name).config
    return spec.reference(conf).shapes(conf)


DS = "deepseek-7b.prefill-long"
MOE = "qwen3-moe-30b-a3b.decode-batch"


def test_deepseek_token_and_head():
    s = cfg(DS)
    # 30 x 2 x (4096 x (2 x 4096 + 2 x 4096) + 3 x 4096 x 11008)
    assert Y.linear_flops_per_token(s) == 12_142_510_080
    assert Y.head_flops(s) == 2 * 4096 * 102400
    # 4 x 30 layers x 32 heads x 128 x (1 + 2 + 3 + 4) key reads
    assert Y.causal_attention_flops(s, 4) == 4_915_200
    assert Y.decode_attention_flops(s, 5) == 4 * 30 * 4096 * 5


def test_request_is_prefill_and_its_steps():
    s = cfg(DS)
    pre = 8 * (3 * 12_142_510_080 + 4 * 30 * 4096 * 6 + 838_860_800)
    assert Y.prefill_flops(s, 8, 3) == pre
    steps = 8 * sum(12_142_510_080 + 838_860_800 + 4 * 30 * 4096 * k for k in (4, 5))
    assert Y.decode_flops(s, 8, 3, 3) == steps
    assert Y.request_flops(s, 8, 3, 3) == pre + steps


def test_moe_counts_the_active_experts_and_the_router():
    s = cfg(MOE)
    attn = 2048 * (2 * 32 * 128 + 2 * 4 * 128)
    ffn = 8 * 3 * 2048 * 768 + 2048 * 128
    assert Y.linear_flops_per_token(s) == 2 * 48 * (attn + ffn)
    flops, nbytes = Y.moe_call(s, 64, 100)
    assert flops == 2 * 64 * (262_144 + 37_748_736)
    assert nbytes == 2 * (262_144 + 100 * 4_718_592 + 2 * 64 * 2048)


def test_published_parameter_counts():
    # Qwen3-30B-A3B: 30.5 B total at head_dim 128; deepseek-llm-7b: 6.9 B
    assert n_params(cfg(MOE)) == pytest.approx(30.53e9, rel=2e-3)
    assert n_params(cfg(DS)) == pytest.approx(6.91e9, rel=2e-3)


def test_flash_call_counts_the_causal_triangle():
    # 4 queries over 4 keys, causal: 1 + 2 + 3 + 4 = 10 pairs
    assert Y.flash_call(1, 4, 4, 2, 1, 8, True) == (4 * 2 * 8 * 10, 2 * (2 * 4 * 2 * 8 + 2 * 4 * 8))
    # the last 2 of 6 positions, causal: 5 + 6 keys
    assert Y.flash_call(1, 2, 6, 1, 1, 4, True)[0] == 4 * 4 * 11
    assert Y.flash_call(1, 2, 6, 1, 1, 4, False)[0] == 4 * 4 * 12


def test_roofline_takes_the_larger_bound():
    assert Y.roofline_s(Y.PEAK_BF16_FLOPS, 0) == 1.0
    assert Y.roofline_s(0, Y.PEAK_HBM_BYTES_S) == 1.0
    assert Y.roofline_s(Y.PEAK_BF16_FLOPS, 2 * Y.PEAK_HBM_BYTES_S) == 2.0
