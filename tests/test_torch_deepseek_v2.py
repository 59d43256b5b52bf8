"""DeepSeek-V2-Lite on the port (``configs/deepseek_v2_lite.py``): latent
attention, expanded in prefill and absorbed in decode over a latent
cache, YaRN RoPE, a leading dense layer, routed experts without
renormalisation beside shared experts.

Held on the CPU, at the kind's tiny stand-in (``small_config``) and in
float32, against the benchmark's plain reference of the kind,
``perfbench/reference/deepseek_v2.py`` (the published forward, expanded;
it imports nothing of the port), loaded by path, on the weights the
benchmark draws from a seed. The published widths are checked by count
and shape only.
"""

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.kernels.attention.ops import KERNEL as ATTENTION
from repro_torch.models import layers as L
from repro_torch.models import moe, transformer
from repro_torch.models.model import build_model, model_kernel_specs
from repro_torch.models.params import count_params, init_tree
from repro_torch.runtime.serve_loop import widen_cache

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from pbench import spec, weights  # noqa: E402
from pbench.model import program_config  # noqa: E402

CELL = "deepseek-v2-lite.long-context"
#: fp32 on both sides: the port's absorbed decode and the reference's
#: expanded attention sum the same products in other orders (the latent
#: through W_uk before or after the score), and the online softmax of the
#: port's plain flash rescales its blocks where the reference takes one
#: softmax; both move logits of order 1 by a few 1e-6
TOL = {"rtol": 1e-4, "atol": 1e-4}


@pytest.fixture(scope="module")
def kind():
    return spec.load_file_module(BENCH / "reference" / "deepseek_v2.py", "reference")


@pytest.fixture(scope="module")
def small(kind):
    conf = kind.small_config(spec.cell(CELL).config, dtype="float32")
    s = kind.shapes(conf)
    params = weights.make_params(s, 7, "cpu", dtype=torch.float32)
    return conf, s, params


def program_logits(cfg, params, prompts, served):
    """The port's logits of each served token's position: one prefill,
    then a decode step a served token but the last, through the cache."""
    model = build_model(cfg)
    B, T = prompts.shape
    n = served.shape[1]
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompts})
        cache = widen_cache(model, cache, B, T + n)
        out = [logits[:, -1]]
        for i in range(n - 1):
            logits, cache = model.decode_step(params, cache, served[:, i:i + 1], T + i)
            out.append(logits[:, -1])
    return torch.stack(out, dim=1)


def tokens(s, B, T, n, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randint(0, s.vocab, (B, T), generator=gen),
            torch.randint(0, s.vocab, (B, n), generator=gen))


# ------------------------------------------------- against the reference
def test_prefill_logits_and_its_latent_cache_match_the_reference(kind, small, monkeypatch):
    """The prefill's last logits, and each layer's cached normed latent and
    rotated rope key against the reference's (its rope key in the
    published order: the port turns interleaved pairs, the reference
    de-interleaves first, so pair i of the port is element i and
    rope / 2 + i of the reference)."""
    conf, s, params = small
    cfg = program_config(conf)
    prompts, served = tokens(s, 3, 20, 1)
    seen = {"c": [], "k_pe": []}
    rms, rope = kind.base._rms, kind._rope

    def rms_seen(x, w, eps):
        out = rms(x, w, eps)
        if x.shape[-1] == s.kv_lora_rank:
            seen["c"].append(out)
        return out

    def rope_seen(x, shapes):
        out = rope(x, shapes)
        if x.shape[2] == 1:
            seen["k_pe"].append(out)
        return out

    monkeypatch.setattr(kind.base, "_rms", rms_seen)
    monkeypatch.setattr(kind, "_rope", rope_seen)
    want = kind.served_logits(params, conf, prompts, served)
    with torch.no_grad():
        got, (c, k_pe) = build_model(cfg).prefill(params, {"tokens": prompts})
    torch.testing.assert_close(got[:, -1], want[:, 0], **TOL)
    B, T = prompts.shape
    assert c.shape == (s.n_layers, B, T, 1, s.kv_lora_rank)
    assert k_pe.shape == (s.n_layers, B, T, 1, s.qk_rope)
    half = s.qk_rope // 2
    for i in range(s.n_layers):
        torch.testing.assert_close(c[i, :, :, 0], seen["c"][i].view(B, T, -1), **TOL)
        ref = seen["k_pe"][i][:, :, 0]
        torch.testing.assert_close(k_pe[i, :, :, 0, 0::2], ref[..., :half], **TOL)
        torch.testing.assert_close(k_pe[i, :, :, 0, 1::2], ref[..., half:], **TOL)


@pytest.mark.parametrize("B,T", [(3, 20), (2, 33)])
def test_prefill_and_eight_absorbed_decode_steps_match_the_reference(kind, small, B, T):
    """Prefill, then 8 decode steps over the latent cache alone, against
    the reference's full forward over the same tokens (the experts'
    capacity counted per call as the serving loop made its calls)."""
    conf, s, params = small
    prompts, served = tokens(s, B, T, 9, seed=T)
    got = program_logits(program_config(conf), params, prompts, served)
    want = kind.served_logits(params, conf, prompts, served)
    assert got.shape == want.shape == (B, 9, s.vocab)
    torch.testing.assert_close(got, want, **TOL)


def test_a_decode_step_builds_no_key_or_value_of_every_head(small):
    """The absorbed step reads the latent cache alone: no tensor with the
    cache's length and a head axis of 16 heads is made in a step (the
    expanded keys would be (B, S, H, nope + rope))."""
    conf, s, params = small
    cfg = program_config(conf)
    model = build_model(cfg)
    prompts, served = tokens(s, 2, 24, 2)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": prompts})
        cache = widen_cache(model, cache, 2, 26)
    shapes = []
    from torch.utils._python_dispatch import TorchDispatchMode

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    shapes.append(tuple(t.shape))
            return out

    with torch.no_grad(), Shapes():
        model.decode_step(params, cache, served[:, :1], 24)
    assert shapes
    expanded = [sh for sh in shapes if len(sh) >= 3 and 25 in sh and s.heads in sh[2:]]
    assert not expanded, expanded


# ------------------------------------------------------------------ YaRN
def test_yarn_frequencies_and_scale_are_the_published_formula_worked_by_hand():
    """DeepSeek-V2-Lite's rope (64 dims, theta 1e4, factor 40 over 4096,
    beta_fast 32, beta_slow 1): the correction range is [10, 23]
    (64 ln(4096 / (32 * 2 pi)) / (2 ln 1e4) = 10.47, floored; 64 ln(4096 /
    (2 pi)) / (2 ln 1e4) = 22.51, ceiled); below it a pair keeps 1e4 **
    (-i / 32), above it that over 40, between a ramp (i - 10) / 13. The
    scale: 192 ** -0.5 * (0.1 * 0.707 * ln 40 + 1) ** 2 = 0.114721."""
    cfg = get_config("deepseek-v2-lite")
    got = L.rope_freqs(64, 1e4, scaling=cfg.rope_scaling)
    base = [1e4 ** (-i / 32) for i in range(32)]
    want = [b if i <= 10 else b / 40 if i >= 23 else
            b / 40 * (i - 10) / 13 + b * (1 - (i - 10) / 13) for i, b in enumerate(base)]
    torch.testing.assert_close(got, torch.tensor(want), rtol=1e-6, atol=0)
    assert got[16].item() == pytest.approx(0.01 * (6 / 13 / 40 + 7 / 13), rel=1e-6)
    assert L.mla_scale(cfg) == pytest.approx(0.114721, abs=1e-6)
    assert L.yarn_mscale(40, 0.707) == pytest.approx(1.260804, abs=1e-6)
    # mscale over mscale_all_dim is 1: cos and sin are not scaled
    x = torch.randn(1, 3, 1, 64, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(3)[None]
    norms = L.apply_rope(x, pos, 1e4, cfg.rope_scaling).norm(dim=-1)
    torch.testing.assert_close(norms, x.norm(dim=-1))


def test_yarn_rope_is_the_published_rotation_in_interleaved_order(kind, small):
    """The port's interleaved-pair rotation equals the published
    de-interleave-then-rotate-half one up to the order of the outputs."""
    conf, s, _ = small
    x = torch.randn(2, 9, 3, s.qk_rope, generator=torch.Generator().manual_seed(1))
    got = L.apply_rope(x, torch.arange(9)[None].expand(2, 9), s.rope_theta,
                       program_config(conf).rope_scaling)
    want = kind._rope(x, s)
    half = s.qk_rope // 2
    torch.testing.assert_close(got[..., 0::2], want[..., :half], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[..., 1::2], want[..., half:], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------- the blocks' FFNs
def test_layer_zero_is_dense_and_the_rest_are_experts(small, monkeypatch):
    """Layer 0 runs the dense SwiGLU of ``dense_d_ff``; every later layer
    reaches ``transformer.moe_ffn`` through ``ffn_apply``, with a router."""
    conf, s, params = small
    cfg = program_config(conf)
    assert "ffn" not in params["layers"]
    assert params["dense_ffn"]["w_gate"].shape == (1, s.d, s.dense_ff)
    assert params["moe_ffn"]["router"].shape == (s.n_layers - 1, s.d, s.experts)
    calls, widths = [], []
    moe_ffn, mlp = transformer.moe_ffn, L.mlp

    def seen_moe(x, p, c):
        calls.append(p["router"].shape)
        return moe_ffn(x, p, c)

    def seen_mlp(x, p, c):
        widths.append(p["w_gate"].shape[-1])
        return mlp(x, p, c)

    monkeypatch.setattr(transformer, "moe_ffn", seen_moe)
    monkeypatch.setattr(L, "mlp", seen_mlp)
    prompts, _ = tokens(s, 2, 8, 1)
    with torch.no_grad():
        build_model(cfg).prefill(params, {"tokens": prompts})
    assert calls == [(s.d, s.experts)] * (s.n_layers - 1)
    # layer 0's dense FFN, then each expert layer's shared experts
    assert widths == [s.dense_ff] + [s.shared_ff] * (s.n_layers - 1)


def test_routing_renormalises_the_top_k_only_where_the_config_says():
    """DeepSeek-V2's gates are the top-k softmax probabilities themselves;
    qwen3-moe's (``norm_topk_prob`` true) are renormalised to sum to one."""
    xg = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(2))
    router = torch.randn(16, 8, generator=torch.Generator().manual_seed(3))
    probs, raw, idx = moe.route(xg, router, 3, renormalise=False)
    torch.testing.assert_close(raw, probs.gather(-1, idx))
    assert (raw.sum(-1) < 1).all()
    _, norm, idx2 = moe.route(xg, router, 3)
    assert torch.equal(idx, idx2)
    torch.testing.assert_close(norm, raw / raw.sum(-1, keepdim=True))
    assert get_config("deepseek-v2-lite").norm_topk_prob is False
    assert get_config("qwen3-moe-30b-a3b").norm_topk_prob is True


@pytest.mark.parametrize("arch", ["deepseek-v2-lite", "qwen3-moe-30b-a3b"])
def test_the_expert_layer_weighs_each_expert_by_its_gate(arch):
    """At a capacity no token overflows, ``moe_ffn`` is the shared
    experts plus each token's top-k experts times its gate (the raw
    probability for DeepSeek-V2, renormalised for qwen3-moe)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), capacity_factor=100.0)
    p = init_tree(moe.moe_defs(cfg), torch.Generator().manual_seed(4))
    x = torch.randn(2, 6, cfg.d_model, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got, _ = moe.moe_ffn(x, p, cfg)
        flat = x.reshape(-1, cfg.d_model)
        probs = torch.softmax(flat @ p["router"], dim=-1)
        w, idx = probs.topk(cfg.top_k, dim=-1)
        if cfg.norm_topk_prob:
            w = w / w.sum(-1, keepdim=True)
        want = torch.zeros_like(flat)
        for t in range(flat.shape[0]):
            for j in range(cfg.top_k):
                e = idx[t, j]
                h = torch.nn.functional.silu(flat[t] @ p["w_gate"][e]) * (flat[t] @ p["w_up"][e])
                want[t] += w[t, j] * (h @ p["w_down"][e])
        if cfg.n_shared_experts:
            want += L.mlp(flat, p["shared"], cfg)
    torch.testing.assert_close(got.reshape(-1, cfg.d_model), want, rtol=1e-5, atol=1e-5)


def test_the_shared_experts_are_one_swiglu_added_for_every_token():
    """Two shared experts of 1408 are one SwiGLU of 2816 at the published
    widths; with every routed expert's weights zero the layer's output is
    that SwiGLU's alone."""
    full = get_config("deepseek-v2-lite")
    assert moe.moe_defs(full)["shared"]["w_gate"].shape == (2048, 2 * 1408)
    cfg = full.reduced()
    p = init_tree(moe.moe_defs(cfg), torch.Generator().manual_seed(6))
    for name in ("w_gate", "w_up", "w_down"):
        p[name] = torch.zeros_like(p[name])
    x = torch.randn(3, 4, cfg.d_model, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        got, _ = moe.moe_ffn(x, p, cfg)
    torch.testing.assert_close(got, L.mlp(x, p["shared"], cfg))


# -------------------------------------------------- the published widths
def test_the_latent_cache_holds_576_values_a_token_a_layer():
    cfg = get_config("deepseek-v2-lite")
    model = build_model(cfg)
    c, pe = model.init_cache_shape(4, 32784)
    assert c == (27, 4, 32784, 1, 512) and pe == (27, 4, 32784, 1, 64)
    assert c[-1] + pe[-1] == 576
    # 31.1 kB a token across the layers in bf16, against 276 kB expanded
    assert 27 * 576 * 2 == 31_104
    assert 27 * 16 * (192 + 128) * 2 == 276_480
    # every other config keeps its (k, v) cache
    dense = build_model(get_config("deepseek-7b")).init_cache_shape(4, 100)
    assert dense == ((30, 4, 100, 32, 128),) * 2


def test_kernel_specs_register_the_expanded_flash_and_no_decode_attention():
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), compute_dtype=torch.bfloat16)
    specs = dict(model_kernel_specs(cfg, batch=4, seq=16384, max_len=16400))
    assert "decode_attention" not in specs
    assert specs["attention"] == {"B": 4, "Tq": 16384, "Tkv": 16384, "H": 16, "Hk": 16,
                                  "Dh": 192, "Dv": 128, "causal": True, "dtype": "bfloat16"}
    # its Hopper space: the (192, 128) instantiation, at most two stages
    # of 128-key tiles (80 kB each beside the 48 kB q tile)
    space = ATTENTION.make_space(dict(specs["attention"], device="cuda", vmem_kb=227))
    points = list(space.iter_valid())
    assert points and {p["lookahead"] for p in points} == {0, 1}
    # a config without latent attention registers what it did
    dense = dict(model_kernel_specs(get_config("deepseek-7b"), batch=4, seq=512, max_len=544))
    assert "Dv" not in dense["attention"] and dense["decode_attention"]["Dh"] == 128


def test_the_catalog_runs_and_checks_the_split_head_dims_on_the_cpu():
    """A spec with ``Dv``: its example arguments have v of that width, a
    variant (the plain version on the CPU) agrees with the oracle."""
    q = torch.zeros(1, 40, 2, 24)
    k, v = torch.zeros(1, 40, 2, 24), torch.zeros(1, 40, 2, 16)
    sp = ATTENTION.extract_spec(q, k, v)
    assert sp["Dv"] == 16 and "Dv" not in ATTENTION.extract_spec(q, k, k)
    args = ATTENTION.example_args(sp)
    assert [tuple(a.shape) for a in args] == [(1, 40, 2, 24), (1, 40, 2, 24), (1, 40, 2, 16)]
    fn = ATTENTION.generate({"block_q": 128, "block_kv": 128, "sched": "arbitrary",
                             "lookahead": 1}, sp)
    torch.testing.assert_close(fn(*args), ATTENTION.oracle(*args), **ATTENTION.tolerance)


def test_the_published_widths_count_15_71_billion_parameters(kind):
    cfg = get_config("deepseek-v2-lite")
    n = count_params(build_model(cfg).param_defs())
    assert n == cfg.n_params()
    assert n == pytest.approx(15.71e9, rel=1e-3)
    # the benchmark's weights are the same tree
    s = kind.shapes(spec.cell(CELL).config)
    assert weights.n_params(s) == n
    # about 2.24 B active a token without the embedding and the head
    active = cfg.n_active_params() - 2 * cfg.vocab * cfg.d_model
    assert active == pytest.approx(2.24e9, rel=5e-3)


def test_the_config_is_the_ports_own_and_every_other_config_is_unchanged():
    """``deepseek-v2-lite`` resolves beside the reference's registry, not
    in it; the reference's configs carry none of its fields."""
    assert "deepseek-v2-lite" not in REGISTRY
    assert get_config("deepseek-v2-lite").kv_lora_rank == 512
    for name, cfg in REGISTRY.items():
        fields = {f.name for f in dataclasses.fields(cfg)}
        assert "kv_lora_rank" not in fields, name
        assert (cfg.kv_lora_rank, cfg.first_k_dense, cfg.rope_scaling) == (0, 0, None)
        assert cfg.norm_topk_prob is True
    assert math.isclose(get_config("deepseek-v2-lite").rope_scaling.factor, 40.0)
