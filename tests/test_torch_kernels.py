"""The port's euclid and lintra kernels held against the JAX package's.

Inputs are made once with numpy from a seed and fed to both packages.
The Pallas kernels run in interpret mode, as ``tests/test_kernels.py``
runs them. On the CPU the port's kernel wrappers take their plain
PyTorch versions (the CUDA and Triton kernels themselves are held
against those plain versions on the card by ``chip_smoke.py``).

Tolerances: euclid rtol 1e-3, atol 1e-3 (chunked fp32 accumulation and
the ||x||^2+||c||^2-2x.c cancellation, as ``tests/test_kernels.py``
states it); lintra rtol 1e-5, atol 1e-5 (one multiply-add per element).
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.euclid import ops as jeuclid
from repro.kernels.euclid.euclid import euclid_pallas
from repro.kernels.lintra import ops as jlintra
from repro.kernels.lintra.lintra import lintra_pallas

from repro_torch.interop import fold_lintra, to_torch
from repro_torch.kernels._build import instantiation_units
from repro_torch.kernels.catalog import get_catalog
from repro_torch.kernels.euclid import euclid as teuclid_kernel
from repro_torch.kernels.euclid import ops as teuclid
from repro_torch.kernels.lintra import lintra as tlintra_kernel
from repro_torch.kernels.lintra import ops as tlintra

EUCLID_TOL = {"rtol": 1e-3, "atol": 1e-3}
LINTRA_TOL = {"rtol": 1e-5, "atol": 1e-5}

EUCLID_POINTS = [
    dict(block_n=64, block_m=32, block_d=32, unroll=1, vectorize=1,
         order="nm", scratch=1, lookahead=0),
    dict(block_n=128, block_m=32, block_d=16, unroll=2, vectorize=0,
         order="mn", scratch=0, lookahead=1),
    dict(block_n=64, block_m=64, block_d=64, unroll=4, vectorize=1,
         order="mn", scratch=0, lookahead=2),
]
LINTRA_POINTS = [
    dict(block_h=8, block_w=128, unroll=1, vectorize=1, order="hw",
         scratch=1, lookahead=0),
    dict(block_h=32, block_w=256, unroll=2, vectorize=0, order="wh",
         scratch=0, lookahead=2),
    dict(block_h=64, block_w=1024, unroll=4, vectorize=1, order="hw",
         scratch=0, lookahead=1),
]


def euclid_inputs(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.standard_normal((m, d), dtype=np.float32))


def lintra_inputs(h, w, bands, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((h, w, bands), dtype=np.float32),
            np.arange(1.0, bands + 1, dtype=np.float32),
            np.linspace(-1, 1, bands, dtype=np.float32))


# ------------------------------------------------------------------ euclid
@pytest.mark.parametrize("reference", ["pallas", "jnp_variant"])
@pytest.mark.parametrize("n,m,d,pi", [
    (n, m, d, pi) for n, m, d in [(128, 32, 32), (250, 90, 70), (64, 64, 128)]
    for pi, pt in enumerate(EUCLID_POINTS) if pt["block_d"] <= d])
def test_euclid_plain_and_variant_match_pallas_and_jnp(n, m, d, pi, reference):
    """The port's one eager euclid (``euclid_plain``, which the wrapper's
    and the compilette's CPU branches both call) against the Pallas
    kernel in interpret mode and against the reference's jnp variant."""
    pt = EUCLID_POINTS[pi]
    xn, cn = euclid_inputs(n, m, d)
    x, c = to_torch((xn, cn), "cpu")
    if reference == "pallas":
        want = np.asarray(euclid_pallas(jnp.asarray(xn), jnp.asarray(cn), pt,
                                        interpret=True))
    else:
        want = np.asarray(jeuclid.generate_jnp_variant(pt, dim=d)(xn, cn))
    plain = teuclid_kernel.euclid_plain(x, c, pt).numpy()
    variant = teuclid._variant(pt, torch.device("cpu"))(x, c).numpy()
    np.testing.assert_array_equal(variant, plain)
    np.testing.assert_allclose(plain, want, **EUCLID_TOL)


@pytest.mark.parametrize("seed", range(6))
def test_euclid_random_valid_points_match_pallas(seed):
    n, m, d = 250, 90, 70
    space = teuclid.make_space(n, m, d)
    pts = list(space.iter_valid())
    pt = pts[np.random.default_rng(seed).integers(len(pts))]
    xn, cn = euclid_inputs(n, m, d, seed)
    x, c = to_torch((xn, cn), "cpu")
    pallas = np.asarray(euclid_pallas(jnp.asarray(xn), jnp.asarray(cn), pt,
                                      interpret=True))
    np.testing.assert_allclose(teuclid_kernel.euclid_plain(x, c, pt).numpy(),
                               pallas, **EUCLID_TOL)


def test_euclid_oracles_and_references_agree():
    xn, cn = euclid_inputs(128, 48, 96, seed=3)
    x, c = to_torch((xn, cn), "cpu")
    want = np.asarray(jeuclid.euclid_ref(xn, cn))
    np.testing.assert_allclose(teuclid.euclid_ref(x, c).numpy(), want,
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(teuclid.reference_sisd(96)(x, c).numpy(),
                               np.asarray(jeuclid.reference_sisd(96)(xn, cn)),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(teuclid.reference_simd(96)(x, c).numpy(),
                               np.asarray(jeuclid.reference_simd(96)(xn, cn)),
                               **EUCLID_TOL)


def test_euclid_wrapper_on_cpu_takes_the_plain_version():
    xn, cn = euclid_inputs(100, 40, 24)
    x, c = to_torch((xn, cn), "cpu")
    pt = dict(EUCLID_POINTS[0], block_d=16)
    before = teuclid_kernel.euclid_cuda.launches
    out = teuclid_kernel.euclid_cuda(x, c, pt)
    assert torch.equal(out, teuclid_kernel.euclid_plain(x, c, pt))
    assert teuclid_kernel.euclid_cuda.launches == before


def test_euclid_compilette_on_cpu_serves_the_torch_variant():
    xn, cn = euclid_inputs(256, 64, 32, seed=5)
    x, c = to_torch((xn, cn), "cpu")
    comp = teuclid.make_euclid_compilette(256, 64, 32, device="cpu")
    jcomp = jeuclid.make_euclid_compilette(256, 64, 32)
    assert [dict(p) for p in comp.space.iter_valid()] == \
           [dict(p) for p in jcomp.space.iter_valid()]
    pt = EUCLID_POINTS[1]
    np.testing.assert_allclose(
        comp.generate(pt, dim=32).fn(x, c).numpy(),
        np.asarray(jcomp.generate(pt, dim=32).fn(xn, cn)), **EUCLID_TOL)


def test_euclid_instantiations_cover_the_card_space():
    # an H100 block may opt in to 227 kB of shared memory
    points = teuclid.kernel_points(227)
    assert 0 < len(points) <= 3 * 3 * 4 * 3 * 2
    for shape in [(16384, 1024, 128), (4096, 1024, 32), (1000, 1000, 70)]:
        for hopper in (False, True):
            space = teuclid.make_space(*shape, vmem_kb=227, hopper=hopper)
            for p in space.iter_valid():
                assert tuple(p[k] for k in teuclid_kernel.PHASE1) in points
    lines = list(teuclid_kernel.instantiations(points).values())
    units = instantiation_units("euclid", "euclid.cuh", lines, 8)
    text = "".join(units.values())
    assert "euclid_errors.cu" in units and len(units) == 9
    assert text.count("EUCLID_INSTANTIATE(") == len(points)
    for p in points:
        assert f"EUCLID_INSTANTIATE({', '.join(map(str, p))})" in text


def test_euclid_smem_fits_what_the_validator_counts():
    """The kernel's shared memory (csrc/euclid.cuh, ``stage_bytes`` times
    the ring's ``lookahead + 1`` stages; the emulation tests hold the
    Python count to the kernel's own) is what the space's Hopper rule
    counts: every built point fits the card at every ring depth, and at a
    capacity one kB short of a point's footprint the rule refuses it."""
    shape = (16384, 1024, 128)
    for tup in teuclid.kernel_points(227):
        base = dict(zip(teuclid_kernel.PHASE1, tup), order="nm", scratch=1)
        for la in (0, 1, 2):
            point = dict(base, lookahead=la)
            need = teuclid_kernel.smem_bytes(point)
            assert 7 * 1024 < need <= 153 * 1024
            fits = -(-need // 1024)
            assert teuclid.make_space(*shape, vmem_kb=fits, hopper=True).is_valid(point)
            assert not teuclid.make_space(*shape, vmem_kb=fits - 1,
                                          hopper=True).is_valid(point)


def test_euclid_catalog_spec_and_space():
    cat = get_catalog()
    from repro.kernels.catalog import get_catalog as jax_catalog
    assert cat.names() == jax_catalog().names()
    xn, cn = euclid_inputs(250, 90, 70)
    x, c = to_torch((xn, cn), "cpu")
    spec = cat.spec_of("euclid", x, c)
    assert spec == {"N": 250, "M": 90, "D": 70, "dtype": "float32",
                    "device": "cpu"}
    comp = cat.compilette("euclid", spec)
    jspace = jeuclid.KERNEL.make_space({"N": 250, "M": 90, "D": 70})
    assert [dict(p) for p in comp.space.iter_valid()] == \
           [dict(p) for p in jspace.iter_valid()]
    ex = comp.example_call_args()
    jex = jeuclid.KERNEL.example_args({"N": 250, "M": 90, "D": 70})
    for a, b in zip(ex, jex):
        assert np.array_equal(a.numpy(), np.asarray(b))
    kern = comp.generate(EUCLID_POINTS[0])
    np.testing.assert_allclose(kern.fn(x, c).numpy(),
                               np.asarray(jeuclid.euclid_ref(xn, cn)), **EUCLID_TOL)


def test_euclid_build_needs_a_cuda_device():
    with pytest.raises(ValueError):
        teuclid.build_kernels("cpu")


# ------------------------------------------------------------------ lintra
@pytest.mark.parametrize("h,w,bands,pi", [
    (h, w, bands, pi) for h, w, bands in [(64, 100, 3), (120, 200, 3), (33, 50, 4)]
    for pi, pt in enumerate(LINTRA_POINTS) if pt["block_h"] <= h])
def test_lintra_plain_matches_pallas_and_oracle(h, w, bands, pi):
    pt = LINTRA_POINTS[pi]
    img_n, a_n, b_n = lintra_inputs(h, w, bands)
    img, a, b = to_torch((img_n, a_n, b_n), "cpu")
    fold, ab = fold_lintra(img, a, b)
    pallas = np.asarray(lintra_pallas(jnp.asarray(fold.numpy()),
                                      jnp.asarray(ab.numpy()), pt,
                                      interpret=True)).reshape(h, w, bands)
    want = np.asarray(jlintra.lintra_ref(img_n, a_n, b_n))
    plain = tlintra_kernel.lintra_plain(fold, a, b).reshape(h, w, bands).numpy()
    np.testing.assert_allclose(plain, pallas, **LINTRA_TOL)
    np.testing.assert_allclose(plain, want, **LINTRA_TOL)
    np.testing.assert_allclose(tlintra.lintra_ref(img, a, b).numpy(), want,
                               **LINTRA_TOL)
    np.testing.assert_allclose(
        tlintra.generate_torch_variant(pt, bands=bands, width=w)(img, a, b).numpy(),
        np.asarray(jlintra.generate_jnp_variant(pt, bands=bands, width=w)(img_n, a_n, b_n)),
        **LINTRA_TOL)


def test_fold_lintra_matches_the_reference_layout():
    img_n, a_n, b_n = lintra_inputs(5, 7, 3)
    fold, ab = fold_lintra(*to_torch((img_n, a_n, b_n), "cpu"))
    assert np.array_equal(fold.numpy(), img_n.reshape(5, 21))
    want = np.stack([np.tile(a_n, 7), np.tile(b_n, 7)])
    assert np.array_equal(ab.numpy(), want)
    np.testing.assert_allclose(
        tlintra.lintra_ref_folded(fold, ab).numpy(),
        np.asarray(jlintra.lintra_ref_folded(img_n.reshape(5, 21), want)),
        **LINTRA_TOL)


def test_lintra_wrapper_on_cpu_takes_the_plain_version():
    img_n, a_n, b_n = lintra_inputs(40, 30, 3)
    img, a, b = to_torch((img_n, a_n, b_n), "cpu")
    fold = img.reshape(40, 90)
    before = tlintra_kernel.lintra_triton.launches
    out = tlintra_kernel.lintra_triton(fold, a, b, LINTRA_POINTS[0])
    assert torch.equal(out, tlintra_kernel.lintra_plain(fold, a, b))
    assert tlintra_kernel.lintra_triton.launches == before


def test_lintra_compile_key_leaves_inert_knobs_out():
    space = tlintra.make_space(2662, 5500, 3, vmem_kb=227)
    points = list(space.iter_valid())
    keys = {tlintra_kernel.compile_key(p, 3, 16500) for p in points}
    inert = {("vectorize",), ("scratch",), ("lookahead",)}
    assert len(keys) < len(points)
    for p in points[:50]:
        for (knob,) in inert:
            q = dict(p, **{knob: space.param(knob).values[-1]})
            assert tlintra_kernel.compile_key(q, 3, 16500) == \
                tlintra_kernel.compile_key(p, 3, 16500)
    # a block wider than the row is cut to the row's power of two
    assert tlintra_kernel.compile_key(LINTRA_POINTS[2], 3, 150)[2] == 256


def test_lintra_catalog_spec_and_variant():
    img_n, a_n, b_n = lintra_inputs(48, 40, 3)
    img, a, b = to_torch((img_n, a_n, b_n), "cpu")
    cat = get_catalog()
    spec = cat.spec_of("lintra", img, a, b)
    comp = cat.compilette("lintra", spec)
    jspace = jlintra.KERNEL.make_space({"H": 48, "W": 40, "bands": 3})
    assert [dict(p) for p in comp.space.iter_valid()] == \
           [dict(p) for p in jspace.iter_valid()]
    kern = comp.generate(LINTRA_POINTS[1])
    np.testing.assert_allclose(kern.fn(img, a, b).numpy(),
                               np.asarray(jlintra.lintra_ref(img_n, a_n, b_n)),
                               **LINTRA_TOL)


# ------------------------------------------------------------------- rules
def test_lintra_module_imports_triton_only_inside_functions():
    src = Path(tlintra_kernel.__file__).read_text()
    for node in ast.parse(src).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names]
            mod = getattr(node, "module", None) or ""
            assert "triton" not in mod and not any("triton" in n for n in names)


# ============================================== LM kernels (serving slice)
# Tolerances: matmul rtol 1e-4, atol 1e-4 (chunked fp32 accumulation over
# K <= 600 against another chunking); rmsnorm rtol 1e-5, atol 1e-5 (fp32
# statistics of one row); the oracles rtol 1e-5, atol 1e-5 (the same
# formula in both frameworks). The attention kernels, spaces and catalog
# entries of the serving slice are in test_torch_lm_kernels.py.
from repro.kernels.matmul import ops as jmatmul
from repro.kernels.matmul.matmul import matmul_pallas
from repro.kernels.rmsnorm import ops as jrmsnorm
from repro.kernels.rmsnorm.rmsnorm import rmsnorm_pallas

from repro_torch.kernels.matmul import matmul as tmatmul_kernel
from repro_torch.kernels.matmul import ops as tmatmul
from repro_torch.kernels.rmsnorm import ops as trmsnorm
from repro_torch.kernels.rmsnorm import rmsnorm as trmsnorm_kernel

MATMUL_TOL = {"rtol": 1e-4, "atol": 1e-4}
RMSNORM_TOL = {"rtol": 1e-5, "atol": 1e-5}
ORACLE_TOL = {"rtol": 1e-5, "atol": 1e-5}


def normal(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def random_point(space, seed):
    pts = list(space.iter_valid())
    return pts[np.random.default_rng(seed).integers(len(pts))]


# ------------------------------------------------------------------ matmul
@pytest.mark.parametrize("seed", range(6))
def test_matmul_plain_matches_pallas_at_random_points(seed):
    """Ragged M, N and K (none a multiple of its block), both orders and
    both scratch modes over the seeds."""
    M, N, K = 200, 300, 600
    space = tmatmul.make_space(M, N, K)
    pt = dict(random_point(space, seed),
              order=("mn", "nm")[seed % 2], scratch=(seed // 2) % 2)
    an, bn = normal((M, K), seed), normal((K, N), seed + 100)
    want = np.asarray(matmul_pallas(jnp.asarray(an), jnp.asarray(bn), pt,
                                    interpret=True))
    got = tmatmul_kernel.matmul_plain(torch.from_numpy(an), torch.from_numpy(bn), pt)
    np.testing.assert_allclose(got.numpy(), want, **MATMUL_TOL)


def test_matmul_oracle_and_wrapper_on_cpu():
    an, bn = normal((70, 90), 1), normal((90, 50), 2)
    a, b = torch.from_numpy(an), torch.from_numpy(bn)
    np.testing.assert_allclose(tmatmul.matmul_ref(a, b).numpy(),
                               np.asarray(jmatmul.matmul_ref(an, bn)), **ORACLE_TOL)
    pt = dict(tmatmul.DEFAULT_POINT, block_k=32, unroll=2)
    before = tmatmul_kernel.matmul_cuda.launches
    assert torch.equal(tmatmul_kernel.matmul_cuda(a, b, pt),
                       tmatmul_kernel.matmul_plain(a, b, pt))
    assert tmatmul_kernel.matmul_cuda.launches == before


# ----------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("n,d,rows", [(64, 128, 8), (100, 256, 32), (4, 64, 128),
                                      (300, 96, 512)])
def test_rmsnorm_plain_matches_pallas(n, d, rows):
    xn, wn = normal((n, d), n), normal((d,), d)
    pt = {"block_rows": rows, "lookahead": 1}
    want = np.asarray(rmsnorm_pallas(jnp.asarray(xn), jnp.asarray(wn), pt,
                                     interpret=True))
    got = trmsnorm_kernel.rmsnorm_plain(torch.from_numpy(xn), torch.from_numpy(wn), pt)
    np.testing.assert_allclose(got.numpy(), want, **RMSNORM_TOL)


def test_rmsnorm_oracle_and_wrapper_on_cpu():
    xn, wn = normal((33, 48), 3), normal((48,), 4)
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    np.testing.assert_allclose(trmsnorm.rmsnorm_ref(x, w).numpy(),
                               np.asarray(jrmsnorm.rmsnorm_ref(xn, wn)), **ORACLE_TOL)
    before = trmsnorm_kernel.rmsnorm_cuda.launches
    out = trmsnorm_kernel.rmsnorm_cuda(x, w, trmsnorm.DEFAULT_POINT)
    assert out.dtype == x.dtype and torch.equal(out, trmsnorm.rmsnorm_ref(x, w))
    assert trmsnorm_kernel.rmsnorm_cuda.launches == before
