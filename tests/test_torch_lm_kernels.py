"""The port's attention kernels, and the serving slice's spaces and
catalog entries, held against the JAX package's.

Inputs are made once with numpy from a seed and fed to both packages;
the Pallas kernel runs in interpret mode, as ``tests/test_kernels.py``
runs it. On the CPU the wrappers take their plain PyTorch versions (the
CUDA kernels are held against those on the card by ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.catalog import get_catalog

# Tolerances: attention rtol 1e-4, atol 1e-5 (online softmax over other
# blocks, fp32); the oracles rtol 1e-5, atol 1e-5 (the same formula in
# both frameworks); catalog variants against the JAX oracle, the kernel's
# KernelDef.tolerance.
from repro.kernels.attention import ops as jattn
from repro.kernels.attention.attention import flash_attention_pallas
from repro.kernels.decode_attention import ops as jdecode
from repro.kernels.decode_attention.ref import decode_attention_ref as jdecode_ref
from repro.kernels.matmul import ops as jmatmul
from repro.kernels.rmsnorm import ops as jrmsnorm

from repro_torch.kernels.attention import attention as tattn_kernel
from repro_torch.kernels.attention import ops as tattn
from repro_torch.kernels.decode_attention import ops as tdecode
from repro_torch.kernels.decode_attention.ref import decode_attention_ref as tdecode_ref
from repro_torch.kernels.matmul import matmul as tmatmul_kernel
from repro_torch.kernels.matmul import ops as tmatmul
from repro_torch.kernels.rmsnorm import ops as trmsnorm
from repro_torch.kernels.rmsnorm import rmsnorm as trmsnorm_kernel

ATTN_TOL = {"rtol": 1e-4, "atol": 1e-5}
ORACLE_TOL = {"rtol": 1e-5, "atol": 1e-5}

#: the H100's shared memory per block, in kB (the card's opt-in limit)
H100_SMEM_KB = 227


def normal(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def random_point(space, seed):
    pts = list(space.iter_valid())
    return pts[np.random.default_rng(seed).integers(len(pts))]


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("seed", range(4))
def test_flash_plain_matches_pallas_at_random_points(seed):
    """GQA G = 2, a ragged kv tail (Tkv not a multiple of block_kv) and,
    on odd seeds, a query offset."""
    B, Tq, Tkv, H, Hk, Dh = 1, 150, 150, 4, 2, 16
    q_offset = 0 if seed % 2 == 0 else 20
    space = tattn.make_space(Tq, Tkv, Dh)
    pt = dict(random_point(space, seed), block_q=(64, 128, 32, 64)[seed],
              block_kv=(64, 32, 128, 96)[seed])
    qn = normal((B, Tq, H, Dh), seed)
    kn = normal((B, Tkv, Hk, Dh), seed + 1)
    vn = normal((B, Tkv, Hk, Dh), seed + 2)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), pt,
        causal=seed != 3, q_offset=q_offset, interpret=True))
    got = tattn_kernel.flash_attention_plain(
        *(torch.from_numpy(a) for a in (qn, kn, vn)), pt, causal=seed != 3,
        q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("causal,q_offset,window", [
    (True, 0, None), (False, 0, None), (True, 40, None), (True, 40, 24)])
def test_chunked_attention_matches_jnp_and_oracle(causal, q_offset, window):
    B, Tq, Tkv, H, Hk, Dh = 2, 30, 70, 6, 3, 16
    qn = normal((B, Tq, H, Dh), 5)
    kn, vn = normal((B, Tkv, Hk, Dh), 6), normal((B, Tkv, Hk, Dh), 7)
    kw = dict(causal=causal, q_offset=q_offset, window=window)
    want = np.asarray(jattn.flash_attention_jnp(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), q_chunk=16,
        k_chunk=32, **kw))
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    got = tattn.flash_attention_torch(q, k, v, q_chunk=16, k_chunk=32, **kw)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    np.testing.assert_allclose(
        tattn.attention_ref(q, k, v, **kw).numpy(),
        np.asarray(jattn.attention_ref(qn, kn, vn, **kw)), **ORACLE_TOL)


@pytest.mark.parametrize("S,k_chunk", [(160, 32), (150, 32), (64, 4096)])
def test_decode_attention_matches_jnp_and_oracle(S, k_chunk):
    """S = 150 is a ragged cache: both packages fall back to one chunk."""
    B, H, Hk, Dh = 2, 8, 2, 16
    qn = normal((B, 1, H, Dh), 8)
    kn, vn = normal((B, S, Hk, Dh), 9), normal((B, S, Hk, Dh), 10)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    for length in (1, S // 2, S):
        want = np.asarray(jattn.decode_attention(
            jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), length=length,
            k_chunk=k_chunk))
        got = tattn.decode_attention(q, k, v, length=length, k_chunk=k_chunk)
        np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
        np.testing.assert_allclose(
            tdecode_ref(q, k, v, length).numpy(),
            np.asarray(jdecode_ref(qn, kn, vn, length)), **ORACLE_TOL)


def test_attention_wrapper_on_cpu_and_block_resolution():
    qn = normal((1, 40, 2, 16), 11)
    kn, vn = normal((1, 40, 2, 16), 12), normal((1, 40, 2, 16), 13)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    pt = {"block_q": 16, "block_kv": 32, "sched": "arbitrary", "lookahead": 1}
    before = tattn_kernel.flash_attention_cuda.launches
    assert torch.equal(tattn_kernel.flash_attention_cuda(q, k, v, pt),
                       tattn_kernel.flash_attention_plain(q, k, v, pt))
    assert tattn_kernel.flash_attention_cuda.launches == before
    # a block clamped to the sequence is served by the smallest
    # instantiation covering it; any other block has none
    assert tattn_kernel.symbol({"block_q": 512, "block_kv": 512}, 512, 512, 128) == \
        "attention_dh128_bq512_bkv512"
    assert tattn_kernel.symbol({"block_q": 300, "block_kv": 1024}, 300, 700, 128) == \
        "attention_dh128_bq512_bkv1024"
    with pytest.raises(KeyError):
        tattn_kernel.symbol({"block_q": 200, "block_kv": 128}, 1000, 1000, 128)


# ------------------------------------------------- spaces and capacities
SPACE_CASES = [
    ("matmul", (200, 300, 600)), ("matmul", (64, 96, 40)),
    ("matmul", (2048, 11008, 4096)),
    ("rmsnorm", (2048, 4096)), ("rmsnorm", (4, 64)), ("rmsnorm", (100, 256)),
    ("attention", (512, 512, 128)), ("attention", (150, 150, 16)),
    ("attention", (32, 32, 16)),
    ("decode_attention", (544, 4, 32, 32, 128)), ("decode_attention", (40, 2, 4, 2, 16)),
]
SPACE_MODULES = {"matmul": (tmatmul, jmatmul), "rmsnorm": (trmsnorm, jrmsnorm),
                 "attention": (tattn, jattn), "decode_attention": (tdecode, jdecode)}


@pytest.mark.parametrize("name,shape", SPACE_CASES, ids=lambda c: str(c))
def test_lm_spaces_identical_at_tpu_capacity(name, shape):
    tmod, jmod = SPACE_MODULES[name]
    tspace, jspace = tmod.make_space(*shape), jmod.make_space(*shape)
    assert [dict(p) for p in tspace.iter_valid()] == \
           [dict(p) for p in jspace.iter_valid()]
    assert [dict(p) for p in tspace.iter_all()] == [dict(p) for p in jspace.iter_all()]


def test_lm_kernels_have_valid_points_on_the_card_at_full_width():
    """Under the H100's 227 kB and the Hopper capacity rule, every slice
    kernel has valid points at deepseek-7b's full-width specs, and the
    points the step-programs use are among them: rmsnorm's DEFAULT_POINT
    (prefill and decode) and attention's (512, 1024) chunks clamped to
    (512, 512). The TPU rule at the same capacity refuses every point."""
    cap = H100_SMEM_KB
    mm = tmatmul.make_space(2048, 11008, 4096, vmem_kb=cap, hopper=True)
    assert mm.is_valid(tmatmul.DEFAULT_POINT)
    for N in (2048, 4):
        rn = trmsnorm.make_space(N, 4096, vmem_kb=cap, hopper=True)
        assert rn.is_valid(trmsnorm.DEFAULT_POINT)
        assert not list(trmsnorm.make_space(N, 4096, vmem_kb=cap).iter_valid()) or N == 4
    at = tattn.make_space(512, 512, 128, vmem_kb=cap, hopper=True)
    assert at.is_valid(dict(tattn.DEFAULT_POINT, block_q=512, block_kv=512))
    assert not list(tattn.make_space(512, 512, 128, vmem_kb=cap).iter_valid())
    for space, symbols in ((mm, tmatmul_kernel.instantiations()),
                           (at, tattn_kernel.instantiations())):
        valid = list(space.iter_valid())
        assert valid
        for p in valid:
            sym = (tmatmul_kernel.symbol(p) if space is mm
                   else tattn_kernel.symbol(p, 512, 512, 128))
            assert sym in symbols
    assert tmatmul_kernel.SMEM_BYTES <= cap * 1024
    assert tattn_kernel.SMEM_BYTES <= cap * 1024
    # decode_attention's validator is the reference's: at B = 4, Hk = 32,
    # Dh = 128 it refuses every k_chunk, even at the TPU's capacity
    assert not list(tdecode.make_space(544, 4, 32, 32, 128).iter_valid())


def test_hopper_rule_depends_on_the_spec_device():
    spec = {"M": 2048, "N": 11008, "K": 4096, "dtype": "float32"}
    cat = get_catalog()
    cpu = cat.get("matmul").make_space({**spec, "device": "cpu"})
    assert [dict(p) for p in cpu.iter_valid()] == \
           [dict(p) for p in jmatmul.KERNEL.make_space(spec).iter_valid()]


@pytest.mark.parametrize("name", ["matmul", "rmsnorm", "attention", "decode_attention"])
def test_lm_catalog_entries_match_the_reference(name):
    cat = get_catalog()
    specs = {"matmul": {"M": 200, "N": 300, "K": 600},
             "rmsnorm": {"N": 100, "d": 64},
             "attention": {"B": 1, "Tq": 150, "Tkv": 150, "H": 4, "Hk": 2,
                           "Dh": 16, "causal": True},
             "decode_attention": {"B": 2, "S": 64, "H": 4, "Hk": 2, "Dh": 16}}
    spec = {**specs[name], "dtype": "float32"}
    tdef, jdef = cat.get(name), {
        "matmul": jmatmul, "rmsnorm": jrmsnorm, "attention": jattn,
        "decode_attention": jdecode}[name].KERNEL
    assert tdef.default_point == jdef.default_point
    assert tdef.tolerance == jdef.tolerance
    comp = cat.compilette(name, {**spec, "device": "cpu"})
    assert [dict(p) for p in comp.space.iter_valid()] == \
           [dict(p) for p in jdef.make_space(spec).iter_valid()]
    ex = comp.example_call_args()
    jex = jdef.example_args(spec)
    for a, b in zip(ex, jex):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    pt = next(iter(comp.space.iter_valid()))
    got = comp.generate(pt).fn(*ex)
    np.testing.assert_allclose(got.numpy(), np.asarray(jdef.oracle(*jex)),
                               **jdef.tolerance)
    for prof_name in ("tpu-v5e",):
        from repro_torch.core.profiles import TPU_V5E as TP
        from repro.core.profiles import TPU_V5E as JP
        assert tdef.cost_model(pt, spec, TP) == jdef.cost_model(pt, spec, JP), prof_name


@pytest.mark.parametrize("family", ["matmul", "rmsnorm", "attention"])
def test_lm_kernel_builds_need_a_cuda_device(family):
    mod = {"matmul": tmatmul_kernel, "rmsnorm": trmsnorm_kernel,
           "attention": tattn_kernel}[family]
    with pytest.raises(ValueError):
        mod.build_kernels("cpu")


def test_lm_instantiation_units():
    """One instantiation line per symbol, dealt over the units of one
    library with its error-string unit: matmul and attention once per
    input type and path (fp32 without a suffix, bf16's wgmma kernels with
    ``_bf16``, its mma kernels with ``_bf16_mma``), rmsnorm's macro
    taking the type as an argument; and attention's split head dims
    (q and k 192 over v 128) once more on bf16's wgmma kernels."""
    paths = (("", ""), ("_BF16", "_bf16"), ("_BF16_MMA", "_bf16_mma"))
    for mod, macro, count, types, split in (
            (tmatmul_kernel, "MATMUL_INSTANTIATE", 108, paths, 0),
            (tattn_kernel, "ATTENTION_INSTANTIATE", 45, paths, 15),
            (trmsnorm_kernel, "RMSNORM_INSTANTIATE", 8, (("", ""),), 0)):
        inst = mod.instantiations()
        assert len(inst) == count * len(types) + split == len(set(inst.values()))
        dv = [sym for sym, line in inst.items() if line.startswith(macro + "_BF16_DV(")]
        assert len(dv) == split and all(sym.endswith("_bf16") and "_dv" in sym for sym in dv)
        for sfx, sym_sfx in types:
            mine = [sym for sym, line in inst.items() if line.startswith(macro + sfx + "(")]
            assert len(mine) == count
            if len(types) > 1:
                assert all(sym.endswith(sym_sfx) and not sym.endswith(sym_sfx + "_mma")
                           for sym in mine)


@pytest.mark.parametrize("family", ["matmul", "rmsnorm", "attention", "euclid"])
def test_library_lookup_is_memoised(family, monkeypatch):
    """A wrapper given no library asks for it on every launch: the lookup
    lists the instantiations and loads the family once, not per call."""
    from repro_torch.kernels.euclid import euclid as teuclid_kernel
    from repro_torch.kernels.euclid import ops as teuclid

    mod = {"matmul": tmatmul_kernel, "rmsnorm": trmsnorm_kernel,
           "attention": tattn_kernel, "euclid": teuclid_kernel}[family]
    loads = []
    monkeypatch.setattr(mod, "load_family",
                        lambda name, *a, **k: loads.append(name) or object())
    lookup = (mod.load_library if family == "euclid" else mod._library)
    lookup.cache_clear()
    try:
        args = (teuclid.kernel_points(227),) if family == "euclid" else ()
        first = lookup(*args)
        assert all(lookup(*args) is first for _ in range(3))
        assert loads == [family]
    finally:
        lookup.cache_clear()


@pytest.mark.parametrize("family", ["matmul", "attention", "rmsnorm", "euclid"])
def test_hopper_capacity_rule_counts_the_ring_at_the_points_lookahead(family):
    """The Hopper rule counts ``lookahead + 1`` ring stages: at a capacity
    between the shallowest and the deepest ring, points differ only in
    ``lookahead`` and the deeper ones are refused."""
    from repro_torch.kernels.euclid import euclid as teuclid_kernel
    from repro_torch.kernels.euclid import ops as teuclid

    if family == "matmul":
        footprint, most = tmatmul_kernel.smem_bytes, tmatmul_kernel.SMEM_BYTES
        space_at = lambda kb: tmatmul.make_space(  # noqa: E731
            2048, 11008, 4096, vmem_kb=kb, hopper=True)
        point = dict(tmatmul.DEFAULT_POINT)
    elif family == "attention":
        # deepseek-7b's heads, Dh 128
        footprint = lambda p: tattn_kernel.smem_bytes(p, 128)  # noqa: E731
        most = tattn_kernel.SMEM_BYTES
        space_at = lambda kb: tattn.make_space(  # noqa: E731
            512, 512, 128, vmem_kb=kb, hopper=True)
        point = dict(tattn.DEFAULT_POINT)
    elif family == "rmsnorm":
        # deepseek-7b's rows, fp32: a 16 kB row buffer a stage
        footprint = lambda p: trmsnorm_kernel.smem_bytes(p, 4096)  # noqa: E731
        most = trmsnorm_kernel.smem_bytes({"lookahead": 2}, 4096)
        space_at = lambda kb: trmsnorm.make_space(  # noqa: E731
            2048, 4096, vmem_kb=kb, hopper=True)
        point = dict(trmsnorm.DEFAULT_POINT)
    else:
        footprint = teuclid_kernel.smem_bytes
        most = footprint({"block_n": 256, "block_m": 128, "block_d": 128,
                          "lookahead": 2})
        space_at = lambda kb: teuclid.make_space(  # noqa: E731
            16384, 1024, 128, vmem_kb=kb, hopper=True)
        point = dict(teuclid.DEFAULT_POINT)
    sizes = [footprint(dict(point, lookahead=la)) for la in (0, 1, 2)]
    assert sizes[0] < sizes[1] < sizes[2] <= most <= H100_SMEM_KB * 1024
    cap_kb = sizes[1] // 1024 + 1          # room for two stages, not three
    space = space_at(cap_kb)
    assert [space.is_valid(dict(point, lookahead=la)) for la in (0, 1, 2)] == \
        [True, True, False]
    assert all(space.is_valid(dict(point, lookahead=la)) for la in (0, 1, 2)
               for space in [space_at(H100_SMEM_KB)])
