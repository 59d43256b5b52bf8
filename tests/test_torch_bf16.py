"""The bf16 input class of the matmul and flash-attention kernels, and the
LM slice served in bf16, held against the JAX package at bf16.

Inputs are made once with numpy from a seed and cast to bf16 on both
sides (``jnp.asarray(x, jnp.bfloat16)`` and ``torch.from_numpy(x).to(
torch.bfloat16)`` both round to nearest even); the Pallas kernels run in
interpret mode, as ``tests/test_kernels.py`` runs them at bf16. On the
CPU the wrappers take their plain versions; the CUDA kernels' bf16
instantiations are held against those on the card by ``chip_smoke.py``
and under the emulator by ``tests/test_torch_bf16_emulation.py``.

Limits, each with its reason:

* matmul rtol = atol = 1e-4: the product of two bf16 values is exact in
  fp32 and both sides accumulate and return fp32, so only the summation
  order differs (far inside the reference's own bf16 limit, 2e-2);
* flash attention rtol = atol = 2e-2, the reference's bf16 limit
  (``tests/test_kernels.py``): p is rounded to bf16 before p·v on both
  sides, and the bf16 output may differ by an ulp where the fp32 sums
  differ in their last bits;
* prefill logits of reduced deepseek-7b: max |diff| 5e-2 and a relative
  L2 distance of 2e-2 (read: 3.1e-2 and 1.0e-2, at logits up to 3.3).
  bf16 keeps 8 bits, and the two frameworks round in different places
  (XLA rounds once per fused chain of elementwise ops, PyTorch after
  every op): 5e-2 is about three bf16 ulps of the largest logits (2^-6
  each between 2 and 4). Both runs are about as far from the fp32
  logits (1.28e-2 and 1.22e-2 relative L2), which the MoE rule below
  holds for both models;
* the MoE's bf16 router may break a near-tie the other way, so its rule
  is relative to fp32: the port's bf16 logits at most twice the JAX bf16
  run's relative L2 distance from the JAX fp32 logits, plus 1e-3;
* the virtual-clock stats exactly.
"""

import dataclasses
import importlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.attention import ops as jattn
from repro.kernels.attention.attention import flash_attention_pallas
from repro.kernels.matmul import ops as jmatmul
from repro.kernels.matmul.matmul import matmul_pallas
from repro.models.model import build_model as jax_build
from repro.models.params import init_tree as jax_init
from repro.runtime.serve_loop import ServeConfig as JServeConfig
from repro.runtime.serve_loop import generate as jax_generate

from repro_torch.api import serve_tuning_defaults
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels.attention import attention as tattn_kernel
from repro_torch.kernels.attention import ops as tattn
from repro_torch.kernels.catalog import get_catalog
from repro_torch.kernels.matmul import matmul as tmatmul_kernel
from repro_torch.kernels.matmul import ops as tmatmul
from repro_torch.models import params as tparams
from repro_torch.models.model import build_model
from repro_torch.runtime.serve_loop import ServeConfig, generate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
MATMUL_TOL = {"rtol": 1e-4, "atol": 1e-4}
ATTENTION_TOL = {"rtol": 2e-2, "atol": 2e-2}
#: reduced deepseek-7b's bf16 prefill logits, port against JAX
LOGIT_MAX_ABS, LOGIT_REL_L2 = 5e-2, 2e-2


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def both(x):
    """One numpy array as a JAX and a torch bf16 array."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF16)


def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ------------------------------------------------------------------ kernels
#: the three points of the reference's own matmul test (tests/test_kernels.py)
MATMUL_POINTS = [
    dict(block_m=64, block_n=128, block_k=128, unroll=1, order="mn", scratch=1, lookahead=0),
    dict(block_m=128, block_n=128, block_k=128, unroll=2, order="nm", scratch=0, lookahead=1),
    dict(block_m=64, block_n=128, block_k=256, unroll=4, order="mn", scratch=1, lookahead=2),
]


@pytest.mark.parametrize("M,N,K", [(100, 200, 300), (70, 130, 260)])
@pytest.mark.parametrize("which", range(3))
def test_matmul_plain_matches_pallas_at_bf16(M, N, K, which):
    """Ragged M, N and K (no multiple of any block): fp32 out from bf16
    operands on both sides."""
    point = MATMUL_POINTS[which]
    ja, ta = both(normal((M, K), 1))
    jb, tb = both(normal((K, N), 2))
    want = np.asarray(matmul_pallas(ja, jb, point, out_dtype=jnp.float32, interpret=True))
    got = tmatmul_kernel.matmul_cuda(ta, tb, point)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **MATMUL_TOL)


ATTENTION_CASES = [
    # (B, Tq, Tkv, H, Hk, Dh, causal, q_offset)
    (1, 64, 64, 4, 4, 16, True, 0),       # causal prefill
    (2, 40, 70, 4, 4, 16, False, 0),      # non-causal over a ragged kv
    (1, 64, 64, 8, 2, 64, True, 0),       # GQA, G = 4
    (1, 30, 100, 4, 2, 16, True, 70),     # q_offset, ragged kv
    (2, 48, 90, 4, 1, 64, False, 0),      # GQA over one kv head, ragged kv
]


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=str)
def test_flash_plain_matches_pallas_at_bf16(case):
    B, Tq, Tkv, H, Hk, Dh, causal, q_offset = case
    point = {"block_q": 32, "block_kv": 32}
    jq, tq = both(normal((B, Tq, H, Dh), 3))
    jk, tk = both(normal((B, Tkv, Hk, Dh), 4))
    jv, tv = both(normal((B, Tkv, Hk, Dh), 5))
    want = flash_attention_pallas(jq, jk, jv, point, causal=causal, q_offset=q_offset,
                                  interpret=True)
    got = tattn_kernel.flash_attention_cuda(tq, tk, tv, point, causal=causal,
                                            q_offset=q_offset)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    np.testing.assert_allclose(f32(got), f32(want), **ATTENTION_TOL)


def test_flash_plain_rounds_p_to_v_type_before_pv():
    """At bf16 the plain version's p·v takes p rounded to v's type, as the
    reference's ``p.astype(v.dtype)`` does, and sums the product in fp32,
    as the reference's ``preferred_element_type=jnp.float32`` does: one
    32-key block (a single online-softmax step) equals that formula
    written out, and not the same formula with p unrounded."""
    q = torch.from_numpy(normal((1, 4, 1, 16), 6)).to(BF16)
    k = torch.from_numpy(normal((1, 32, 1, 16), 7)).to(BF16)
    v = torch.from_numpy(normal((1, 32, 1, 16), 8)).to(BF16)
    got = tattn.flash_attention_torch(q, k, v, causal=False, q_chunk=32, k_chunk=32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 16 ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1)[..., None].permute(0, 2, 1, 3)

    def out(pp):
        return (torch.einsum("bhqk,bkhd->bqhd", pp.float(), v.float()) / l).to(BF16)

    assert torch.equal(got, out(p.to(BF16)))
    assert not torch.equal(got, out(p))


@pytest.mark.parametrize("shape", [(1, 256, 4, 4, 128), (2, 256, 8, 2, 64)], ids=str)
def test_chip_smoke_bf16_attention_control(shape):
    """``chip_smoke.py``'s control for its bf16 attention limit, on the
    CPU: against the plain version in 128-key blocks, one unblocked
    softmax with p rounded to bf16 (a right result by another route) is
    within ``ATTENTION_BF16_TOL`` and the same with p rounded to fp8
    (e4m3) is not. Read here: 3.5 and 0.16 of the limit."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    B, T, H, Hk, Dh = shape
    q, k, v = (torch.from_numpy(normal(s, seed)).to(BF16) for seed, s in
               enumerate([(B, T, H, Dh), (B, T, Hk, Dh), (B, T, Hk, Dh)], 20))
    want = tattn_kernel.flash_attention_plain(
        q, k, v, {"block_q": 128, "block_kv": 128}).float()
    tol = smoke.ATTENTION_BF16_TOL
    right = smoke.unblocked_attention(q, k, v, BF16).float()
    wrong = smoke.unblocked_attention(q, k, v, torch.float8_e4m3fn).float()
    assert smoke.tol_used(right, want, tol) <= 0.5
    assert smoke.tol_used(wrong, want, tol) > 2.0


def test_wrappers_refuse_other_types_on_the_card():
    """On a CUDA tensor a type without an instantiation raises; the
    symbols of each type are distinct."""
    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    a = torch.zeros(8, 8, dtype=torch.float16).as_subclass(OnCard)
    with pytest.raises(TypeError, match="bfloat16"):
        tmatmul_kernel.matmul_cuda(a, a, MATMUL_POINTS[0])
    mixed = torch.zeros(8, 8, dtype=BF16).as_subclass(OnCard)
    with pytest.raises(TypeError, match="one"):
        tmatmul_kernel.matmul_cuda(mixed, torch.zeros(8, 8).as_subclass(OnCard),
                                   MATMUL_POINTS[0])
    q = torch.zeros(1, 8, 2, 16, dtype=torch.float16).as_subclass(OnCard)
    with pytest.raises(TypeError, match="bfloat16"):
        tattn_kernel.flash_attention_cuda(q, q, q, {"block_q": 128, "block_kv": 128})
    point = {"block_q": 128, "block_kv": 128}
    assert tattn_kernel.symbol(point, 64, 64, 128, BF16) == "attention_dh128_bq128_bkv128_bf16"
    assert tmatmul_kernel.symbol(MATMUL_POINTS[0], BF16) == "matmul_bm64_bn128_bk128_u1_bf16"
    with pytest.raises(KeyError):
        tattn_kernel.symbol(point, 64, 64, 128, torch.float16)
    with pytest.raises(KeyError):
        tmatmul_kernel.symbol(MATMUL_POINTS[0], torch.float16)


# ------------------------------------------------------------------ catalog
BF16_SPECS = {
    "matmul": {"M": 512, "N": 512, "K": 512, "dtype": "bfloat16"},
    "attention": {"B": 4, "Tq": 512, "Tkv": 512, "H": 8, "Hk": 4,
                  "Dh": 64, "causal": True, "dtype": "bfloat16"},
    "rmsnorm": {"N": 2048, "d": 512, "dtype": "bfloat16"},
}


@pytest.mark.parametrize("name,shape", [
    ("matmul", {"M": 200, "N": 300, "K": 600}), ("matmul", {"M": 2048, "N": 768, "K": 2048}),
    ("attention", {"B": 1, "Tq": 150, "Tkv": 150, "H": 4, "Hk": 2, "Dh": 16, "causal": True}),
    ("attention", {"B": 4, "Tq": 512, "Tkv": 512, "H": 32, "Hk": 4, "Dh": 64,
                   "causal": True}),
], ids=str)
def test_bf16_catalog_spaces_and_examples_equal_the_reference(name, shape):
    """At a bf16 spec on the CPU (``hopper=False``, the TPU capacity) the
    port's space is the reference's, its example arguments are bf16 and
    equal to the reference's, and a variant agrees with the oracle."""
    spec = {**shape, "dtype": "bfloat16"}
    jdef = {"matmul": jmatmul, "attention": jattn}[name].KERNEL
    comp = get_catalog().compilette(name, {**spec, "device": "cpu"})
    assert [dict(p) for p in comp.space.iter_valid()] == \
        [dict(p) for p in jdef.make_space(spec).iter_valid()]
    ex, jex = comp.example_call_args(), jdef.example_args(spec)
    for a, b in zip(ex, jex):
        assert a.dtype == BF16
        assert np.array_equal(a.float().numpy(), f32(b))
    if name == "matmul" and shape["M"] > 1000:
        return                      # the served shape: space and inputs only
    pt = next(iter(comp.space.iter_valid()))
    got = comp.generate(pt).fn(*ex)
    np.testing.assert_allclose(f32(got), f32(jdef.oracle(*jex)),
                               **(MATMUL_TOL if name == "matmul" else ATTENTION_TOL))


def test_gate_checks_bf16_variants():
    """The variant gate (``gate_mode`` check or canary) compares a bf16
    output with its oracle (numpy has no bf16: the gate reads fp64) and
    refuses a wrong one, as the reference's gate does at bf16."""
    from repro_torch.core.gate import VariantGate

    spec = {"B": 1, "Tq": 64, "Tkv": 64, "H": 4, "Hk": 2, "Dh": 16, "causal": True,
            "dtype": "bfloat16", "device": "cpu"}
    comp = get_catalog().compilette("attention", spec)
    gate = VariantGate(comp, rtol=2e-2, atol=2e-2)
    pt = next(iter(comp.space.iter_valid()))
    fn = comp.generate(pt).fn
    assert gate.check(pt, fn) == (True, "")
    ok, reason = gate.check(pt, lambda *a: fn(*a) * 1.5)
    assert not ok and "max|err|" in reason


def test_hopper_rule_counts_the_bf16_footprint():
    """On the card the capacity rule counts the bf16 kernels' own shared
    memory (the wgmma kernels', the main path's). matmul: a capacity that
    holds every bf16 ring (193 kB at most) refuses fp32 points. attention:
    the wgmma kernel's q tile and 128-key stages outgrow fp32's rings, so
    a capacity that holds every fp32 ring (162 kB at most) refuses
    exactly the bf16 points with three stages of 128-key tiles."""
    mm16 = tmatmul.make_space(2048, 11008, 4096, dtype_bytes=2, vmem_kb=194, hopper=True)
    mm32 = tmatmul.make_space(2048, 11008, 4096, dtype_bytes=4, vmem_kb=194, hopper=True)
    assert len(list(mm16.iter_valid())) == len(list(mm16.iter_all())) - sum(
        1 for p in mm16.iter_all() if p["block_k"] % p["unroll"]
        or p["block_m"] > 2048 + 8)
    assert len(list(mm32.iter_valid())) < len(list(mm16.iter_valid()))
    at16 = tattn.make_space(512, 512, 128, vmem_kb=163, hopper=True, dtype_bytes=2)
    at32 = tattn.make_space(512, 512, 128, vmem_kb=163, hopper=True)
    assert len(list(at32.iter_valid())) == len(list(at32.iter_all()))
    refused = [p for p in at16.iter_all() if not at16.is_valid(p)]
    assert refused and all(p["lookahead"] == 2 and p["block_kv"] >= 128 for p in refused)
    assert len(refused) == sum(1 for p in at16.iter_all()
                               if p["lookahead"] == 2 and p["block_kv"] >= 128)
    whole = tattn.make_space(512, 512, 128, vmem_kb=226, hopper=True, dtype_bytes=2)
    assert len(list(whole.iter_valid())) == len(list(whole.iter_all()))
    for p in at16.iter_valid():
        assert tattn_kernel.symbol(p, 512, 512, 128, BF16) in tattn_kernel.instantiations()
    # the catalog reads the element size from the spec's dtype
    cat = get_catalog()
    spec = {"B": 4, "Tq": 512, "Tkv": 512, "H": 32, "Hk": 32, "Dh": 128,
            "causal": True, "device": "cuda", "vmem_kb": 163}
    assert len(list(cat.get("attention").make_space({**spec, "dtype": "bfloat16"})
                    .iter_valid())) == len(list(at16.iter_valid()))
    assert len(list(cat.get("attention").make_space({**spec, "dtype": "float32"})
                    .iter_valid())) == len(list(at32.iter_valid()))


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.core"),
            importlib.import_module(f"{pkg}.runtime.coordinator"),
            importlib.import_module(f"{pkg}.runtime.kernel_plane"))


def _plane_stats(pkg):
    core, coordm, planem = _mods(pkg)
    clock = core.VirtualClock()
    coord = coordm.TuningCoordinator(
        policy=core.RegenerationPolicy(1.0, 0.5), device="test:v", clock=clock,
        async_generation=True, prefetch=1)
    plane = planem.KernelTuningPlane(
        coord, virtual=(clock, core.TPU_V5E), gen_cost_s=0.002,
        evaluator_factory=lambda c: core.VirtualClockEvaluator(clock))
    handles = {n: plane.register_spec(n, s) for n, s in BF16_SPECS.items()}
    for i in range(3000):
        for h in handles.values():
            h(i)
        coord.maybe_pump()
        if all(h.tuner.explorer.finished for h in handles.values()):
            break
    stats = json.loads(json.dumps(coord.stats(), sort_keys=True, default=str))
    best = {n: h.tuner.explorer.best_point for n, h in handles.items()}
    coord.close()
    return stats, best


def test_kernel_plane_stats_equal_at_bf16_specs():
    """The kernel plane under a VirtualClock at bf16 specs (the cost
    models read the 2-byte element size): the same best points and
    ``coordinator.stats()`` in both packages."""
    jstats, jbest = _plane_stats("repro")
    tstats, tbest = _plane_stats("repro_torch")
    assert tbest == jbest
    assert tstats == jstats


# ---------------------------------------------------------------- the slice
B, T = 2, 40


def _cfgs(arch):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), compute_dtype=jnp.bfloat16,
                               param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype=BF16,
                               param_dtype=BF16)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["deepseek-7b", "qwen3-moe-30b-a3b"])
def bf16_model(request):
    """(arch, JAX bf16 config, port bf16 config, fp32 JAX params as numpy,
    tokens): one JAX init in fp32, cast to bf16 on each side."""
    arch = request.param
    jcfg, tcfg = _cfgs(arch)
    jparams = jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))
    nparams = jax.tree.map(np.asarray, jparams)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    return arch, jcfg, tcfg, nparams, tokens


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_prefill_logits_match_jax(bf16_model):
    """Params and compute in bf16 on both sides (the cache in bf16 too).
    Both models: the port's distance from the JAX fp32 logits at most
    twice the JAX bf16 run's, plus 1e-3. deepseek-7b also within
    ``LOGIT_MAX_ABS`` and ``LOGIT_REL_L2`` of the JAX bf16 logits."""
    arch, jcfg, tcfg, nparams, tokens = bf16_model
    jb = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), nparams)
    jl, _ = jax.jit(jax_build(jcfg).prefill)(jb, {"tokens": jnp.asarray(tokens)})
    tl, (tk, _) = build_model(tcfg).prefill(
        params_from_jax(nparams, tcfg, "cpu"), {"tokens": torch.from_numpy(tokens)})
    assert tl.dtype == BF16 and tk.dtype == BF16
    got, want = f32(tl), f32(jl)
    j32cfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32, param_dtype=jnp.float32)
    ref, _ = jax.jit(jax_build(j32cfg).prefill)(
        jax.tree.map(jnp.asarray, nparams), {"tokens": jnp.asarray(tokens)})
    ref = np.asarray(ref, np.float32)
    assert _rel_l2(got, ref) <= 2 * _rel_l2(want, ref) + 1e-3
    if arch == "deepseek-7b":
        assert np.abs(got - want).max() <= LOGIT_MAX_ABS
        assert _rel_l2(got, want) <= LOGIT_REL_L2


@pytest.mark.parametrize("kernel_tuning", ["off", "kernel"])
def test_bf16_generate_matches_jax(bf16_model, kernel_tuning):
    """``generate`` in bf16, with the kernel plane off and on (its handles
    registered at dtype bfloat16 and evaluated on bf16 example inputs):
    deepseek-7b gives the JAX package's greedy tokens; the MoE's prompt
    logits keep the relative-L2 rule of the prefill test."""
    arch, jcfg, tcfg, nparams, tokens = bf16_model
    jb = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), nparams)
    tuned = kernel_tuning != "off"
    jout = jax_generate(jcfg, {"tokens": jnp.asarray(tokens), "params": jb},
                        JServeConfig(max_new_tokens=4, autotune=tuned,
                                     kernel_tuning=kernel_tuning))
    tout = generate(tcfg, {"tokens": torch.from_numpy(tokens),
                           "params": params_from_jax(nparams, tcfg, "cpu")},
                    ServeConfig(max_new_tokens=4, tuning=dataclasses.replace(
                        serve_tuning_defaults(), enabled=tuned,
                        kernel_tuning=kernel_tuning)))
    if tuned:
        kernels = tout["autotune"]["kernels"]
        assert set(kernels) == set(jout["autotune"]["kernels"])
        assert {"attention", "matmul", "rmsnorm"} <= set(kernels)
    if arch == "deepseek-7b":
        assert np.array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    else:
        assert tout["tokens"].shape == tuple(np.asarray(jout["tokens"]).shape)
        assert np.array_equal(tout["tokens"][:, 0].numpy(), np.asarray(jout["tokens"])[:, 0])


def test_bf16_handles_register_at_bfloat16():
    """A bf16 model registers every kernel handle at dtype bfloat16, as
    the reference's model does."""
    from repro.models.model import model_kernel_specs as jspecs
    from repro_torch.models.model import model_kernel_specs as tspecs

    jcfg, tcfg = _cfgs("deepseek-7b")
    t = tspecs(tcfg, batch=4, seq=512, max_len=544)
    assert t == jspecs(jcfg, batch=4, seq=512, max_len=544)
    assert {s["dtype"] for _, s in t} == {"bfloat16"}


# ---------------------------------------------------------------- init_tree
def test_init_tree_fp32_draws_are_unchanged():
    """fp32 leaves are one draw each, bit for bit what the port drew
    before bf16 leaves were drawn in slices (the formula written out)."""
    from repro_torch.models.params import _iter_defs

    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    defs = build_model(cfg).param_defs()
    got = tparams.init_tree(defs, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    for path, d in _iter_defs(defs):
        leaf = got
        for key in path:
            leaf = leaf[key]
        if d.init == "normal":
            want = torch.randn(d.shape, generator=gen, dtype=torch.float32).mul_(d.scale)
        else:
            want = (torch.zeros if d.init == "zeros" else torch.ones)(d.shape)
        assert leaf.dtype == torch.float32 and torch.equal(leaf, want), path


def test_init_tree_draws_other_types_in_slices(monkeypatch):
    """A bf16 leaf is preallocated in bf16 and drawn in fp32 slices along
    its leading axis, none larger than ``DRAW_ELEMS`` elements or one
    row: the stacked expert leaves never live whole in fp32. The draws
    are seeded (the same tree again) and scaled by the def's scale."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    defs = build_model(cfg).param_defs()
    draws = []
    real = torch.randn

    def recorded(*shape, **kw):
        out = real(*shape, **kw)
        draws.append(out.numel())
        return out

    monkeypatch.setattr(tparams, "DRAW_ELEMS", 4096)
    monkeypatch.setattr(torch, "randn", recorded)
    tree = tparams.init_tree(defs, torch.Generator().manual_seed(3), dtype=BF16)
    w_gate = tree["layers"]["ffn"]["w_gate"]
    assert w_gate.dtype == BF16 and w_gate.shape == (2, 8, 64, 128)
    row = w_gate[0].numel()                  # 65536 > DRAW_ELEMS: one row a draw
    assert max(draws) <= row < w_gate.numel()
    # the same slices drawn by hand from the same seed
    monkeypatch.setattr(torch, "randn", real)
    again = tparams.init_tree(defs, torch.Generator().manual_seed(3), dtype=BF16)
    assert torch.equal(again["layers"]["ffn"]["w_gate"], w_gate)
    scale = defs["layers"]["ffn"]["w_gate"].scale
    assert 0.9 * scale < float(w_gate.float().std()) < 1.1 * scale
