"""The bf16 wgmma kernels of matmul and flash attention, run on the CPU
under ``tests/cuda_emulator.h``.

``matmul::wg::matmul_wgmma`` and ``attention::wg::flash_wgmma`` are
Hopper's own machinery: a producer thread's TMA loads into a ring of
mbarrier stages, two consumer warpgroups on ``wgmma`` reading their
operands through shared-memory descriptors, a persistent grid. The
emulator runs each of those primitives on the host (a TMA box copied
with zero fill and the card's swizzle, its bytes completed on its
barrier; a wait that sees only completed phases; a wgmma queued until
its group is waited for, then run by the warpgroup's 128 threads
together through an exchange, A and B read through their descriptors),
so these tests check the kernels' tiles, descriptors, barrier parities,
ring depths and persistent walks against their plain PyTorch versions
at small shapes. The emulated card has 3 SMs (``set_sms`` changes it):
every block walks several tiles.

Covered: matmul at ragged M, N and K edges (K and N multiples of 8, as
the path requires), both orders, ``scratch`` 0 and 1, every
``lookahead``, 64- and 128-row tiles; attention causal and non-causal,
with ``q_offset``, GQA, a ragged kv tail and a ragged q tile, at Dh 16,
64 and 128 and both kv tiles, and at q and k head dim 192 over v head
dim 128 (latent attention's expanded prefill), causal and ragged, at
every ring depth that fits; the path-choosing functions; and that the
wgmma launchers refuse what TMA cannot describe.

Limits: matmul rtol 1e-5, atol 1e-4 (products of bf16 values are exact
in fp32; the sums run in another order); attention rtol 1e-2, atol 1e-2
(P rounded to bf16 against a 64- or 128-key tile's running max, the
plain version against its block's; bf16 outputs), as in
``test_torch_bf16_emulation.py``.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import attention as tattn
from repro_torch.kernels.matmul import matmul as tmatmul

from test_torch_cuda_emulation import _emulated_source

BF16 = torch.bfloat16
MATMUL_TOL = {"rtol": 1e-5, "atol": 1e-4}
ATTENTION_TOL = {"rtol": 1e-2, "atol": 1e-2}

MATMUL_POINTS = [
    dict(block_m=128, block_n=256, block_k=128, unroll=1),   # 128 x 256 tiles
    dict(block_m=64, block_n=128, block_k=128, unroll=2),    # 64-row tiles, n split
    dict(block_m=512, block_n=512, block_k=256, unroll=4),   # bands of 4 x 2 tiles
]
ATTENTION_POINTS = [
    {"block_q": 128, "block_kv": 128},   # 128-key tiles
    {"block_q": 256, "block_kv": 64},    # 64-key tiles, two 128-row units an item
]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """family -> ctypes library of the wgmma instantiations used here,
    both built with the host compiler in parallel; each exports
    ``set_sms(n)``, the emulated card's SM count."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    out = tmp_path_factory.mktemp("wgmma_emulation")
    (out / "cuda_emulator.h").write_text(
        Path(__file__).with_name("cuda_emulator.h").read_text())
    mm, at = tmatmul.instantiations(), tattn.instantiations()
    wanted = {
        "matmul": [mm[tmatmul.symbol(p, BF16)] for p in MATMUL_POINTS],
        "attention": sorted({at[tattn.symbol(p, 1024, 1024, dh, BF16)]
                             for p in ATTENTION_POINTS for dh in tattn.HEAD_DIMS}
                            | {at[tattn.symbol(p, 1024, 1024, dh, BF16, Dv=dv)]
                               for p in ATTENTION_POINTS
                               for dh, dv in tattn.SPLIT_HEAD_DIMS}),
    }
    procs = {}
    for family, lines in wanted.items():
        (out / f"{family}.h").write_text(_emulated_source(family))
        unit = out / f"{family}.cpp"
        unit.write_text(f'#include "{family}.h"\n' + "\n".join(lines) + "\n"
                        'extern "C" void set_sms(int n) { emu_sm_count = n; }\n')
        procs[family] = subprocess.Popen(
            [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
             str(unit), "-o", str(out / f"lib{family}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for family, proc in procs.items():
        log, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            if "barrier" in log and "No such file" in log:
                pytest.skip(f"the host compiler lacks C++20 <barrier>: {log[:200]}")
            raise AssertionError(f"emulated wgmma {family} failed to build:\n{log}")
        libs[family] = ctypes.CDLL(str(out / f"lib{family}.so"))
    return libs


def _bf16(shape, seed, shift=0):
    """A bf16 tensor of ``shape`` from a numpy draw, ``shift`` elements
    past the start of its storage (shift 1: not 16-byte aligned)."""
    x = np.random.default_rng(seed).standard_normal(int(np.prod(shape)) + shift)
    t = torch.from_numpy(x.astype(np.float32)).to(BF16)
    return t[shift:].view(*shape)


def _launch(lib, symbol, argtypes, *args, sms=3):
    lib.set_sms(sms)
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn(*args)


def _matmul(lib, a, b, point, sms=3):
    (M, K), N = a.shape, b.shape[1]
    c = torch.full((M, N), float("nan"), dtype=torch.float32)
    rc = _launch(lib, tmatmul.symbol(point, BF16), tmatmul._ARGTYPES,
                 a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                 tmatmul._ORDERS[point["order"]], point["scratch"], point["lookahead"],
                 None, sms=sms)
    return rc, c


@pytest.mark.parametrize("lookahead", [0, 1, 2])
@pytest.mark.parametrize("pi,order,scratch", [
    (0, "mn", 1), (0, "nm", 0), (1, "nm", 1), (1, "mn", 0), (2, "mn", 0), (2, "nm", 1)])
def test_emulated_wgmma_matmul(emulated, pi, order, scratch, lookahead):
    """Ragged M (150), N (264: no multiple of the 128- or 256-column tile)
    and K (200: TMA's zero fill past K's last 64-deep slice), bf16 A and
    B, fp32 C, against ``matmul_plain`` (which upcasts)."""
    point = dict(MATMUL_POINTS[pi], order=order, scratch=scratch, lookahead=lookahead)
    M, N, K = 150, 264, 200
    a, b = _bf16((M, K), seed=pi), _bf16((K, N), seed=10 + lookahead)
    assert tmatmul.bf16_path(N, K, a.data_ptr(), b.data_ptr()) == "wgmma"
    rc, c = _matmul(emulated["matmul"], a, b, point)
    assert rc == 0
    torch.testing.assert_close(c, tmatmul.matmul_plain(a, b, point), **MATMUL_TOL)


@pytest.mark.parametrize("sms", [1, 7])
def test_emulated_wgmma_matmul_persistent_walk(emulated, sms):
    """One block walking every tile, and more blocks than bands: the same
    result, chunk by chunk (``scratch`` 0 over a K of three chunks)."""
    point = dict(MATMUL_POINTS[2], order="nm", scratch=0, lookahead=1)
    a, b = _bf16((300, 8 * 37), seed=5), _bf16((8 * 37, 520), seed=6)
    rc, c = _matmul(emulated["matmul"], a, b, point, sms=sms)
    assert rc == 0
    torch.testing.assert_close(c, tmatmul.matmul_plain(a, b, point), **MATMUL_TOL)


@pytest.mark.parametrize("N,K,shift", [(136, 77, 0), (45, 96, 0), (136, 96, 1)])
def test_emulated_wgmma_matmul_refuses_what_tma_cannot_describe(emulated, N, K, shift):
    """K or N no multiple of 8, or an operand past a 16-byte boundary:
    the tensor map is refused, the launcher returns an error and writes
    nothing, and the path chooser sends such operands to ``mma``."""
    point = dict(MATMUL_POINTS[0], order="mn", scratch=1, lookahead=1)
    a, b = _bf16((40, K), seed=1, shift=shift), _bf16((K, N), seed=2, shift=shift)
    rc, c = _matmul(emulated["matmul"], a, b, point)
    assert rc != 0
    assert torch.isnan(c).all()
    assert tmatmul.bf16_path(N, K, a.data_ptr(), b.data_ptr()) == "mma"


def _attention(lib, q, k, v, point, *, causal=1, q_offset=0, lookahead=1, sms=3, scale=None):
    B, Tq, H, Dh = q.shape
    _, Tkv, Hk, _ = k.shape
    Dv = v.shape[3]
    out = torch.full((B, Tq, H, Dv), float("nan"), dtype=q.dtype)
    rc = _launch(lib, tattn.symbol(point, Tq, Tkv, Dh, BF16, Dv=Dv), tattn._ARGTYPES,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq, Tkv, H,
                 Hk, causal, q_offset, Dh ** -0.5 if scale is None else scale, lookahead, None,
                 sms=sms)
    return rc, out


@pytest.mark.parametrize("Dh", [16, 64, 128])
@pytest.mark.parametrize("case", [
    # B, Tq, Tkv, H, Hk, causal, q_offset, point, lookahead
    (1, 40, 100, 4, 2, 1, 60, 0, 0),    # offset queries, GQA G = 2, a ragged kv tail
    (2, 150, 150, 2, 1, 1, 0, 1, 2),    # a ragged q tile over two units, G = 2
    (1, 70, 45, 3, 3, 0, 0, 0, 1),      # non-causal over a ragged kv
    (1, 130, 300, 2, 1, 0, 0, 1, 0),    # one stage over several kv tiles, non-causal
    (1, 200, 200, 2, 2, 1, 0, 0, 0),    # one stage, causal: several tiles a unit
])
def test_emulated_wgmma_attention(emulated, Dh, case):
    B, Tq, Tkv, H, Hk, causal, q_offset, pi, lookahead = case
    point = ATTENTION_POINTS[pi]
    q = _bf16((B, Tq, H, Dh), seed=20 + Dh)
    k, v = _bf16((B, Tkv, Hk, Dh), seed=21), _bf16((B, Tkv, Hk, Dh), seed=22)
    assert tattn.bf16_path(q.data_ptr(), k.data_ptr(), v.data_ptr()) == "wgmma"
    rc, got = _attention(emulated["attention"], q, k, v, point, causal=causal,
                         q_offset=q_offset, lookahead=lookahead)
    assert rc == 0
    want = tattn.flash_attention_plain(q, k, v, point, causal=bool(causal),
                                       q_offset=q_offset)
    assert got.dtype == BF16
    torch.testing.assert_close(got.float(), want.float(), **ATTENTION_TOL)


@pytest.mark.parametrize("case", [
    # B, Tq, Tkv, H, causal, q_offset, point, lookahead
    (1, 150, 150, 2, 1, 0, 0, 1),       # causal, a ragged q tile over two units, 128-key tiles
    (2, 70, 70, 1, 1, 0, 1, 2),         # causal, 64-key tiles, three stages
    (1, 40, 100, 2, 1, 60, 1, 0),       # offset queries over a ragged kv tail, one stage
    (1, 100, 45, 2, 0, 0, 0, 0),        # non-causal over a ragged kv
])
def test_emulated_wgmma_attention_split_head_dims(emulated, case):
    """Latent attention's expanded prefill: q and k of head dim 192, v and
    the output of 128, every head its own keys, at YaRN's scale; a V tile
    of two boxes beside a K tile of three."""
    B, Tq, Tkv, H, causal, q_offset, pi, lookahead = case
    (Dh, Dv), = tattn.SPLIT_HEAD_DIMS
    point = ATTENTION_POINTS[pi]
    assert tattn.smem_bytes(dict(point, lookahead=lookahead), Dh, 2, Dv=Dv) <= 232448
    q = _bf16((B, Tq, H, Dh), seed=50)
    k, v = _bf16((B, Tkv, H, Dh), seed=51), _bf16((B, Tkv, H, Dv), seed=52)
    rc, got = _attention(emulated["attention"], q, k, v, point, causal=causal,
                         q_offset=q_offset, lookahead=lookahead, scale=0.1147)
    assert rc == 0
    want = tattn.flash_attention_plain(q, k, v, point, causal=bool(causal),
                                       q_offset=q_offset, scale=0.1147)
    assert got.shape == want.shape == (B, Tq, H, Dv)
    torch.testing.assert_close(got.float(), want.float(), **ATTENTION_TOL)


def test_emulated_wgmma_attention_heaviest_first_walk(emulated):
    """Causal q tiles of unequal work walked by one block, then by five:
    the same output."""
    point = ATTENTION_POINTS[0]
    q = _bf16((1, 300, 2, 16), seed=30)
    k, v = _bf16((1, 300, 1, 16), seed=31), _bf16((1, 300, 1, 16), seed=32)
    want = tattn.flash_attention_plain(q, k, v, point)
    for sms in (1, 5):
        rc, got = _attention(emulated["attention"], q, k, v, point, sms=sms)
        assert rc == 0
        torch.testing.assert_close(got.float(), want.float(), **ATTENTION_TOL)


def test_emulated_wgmma_attention_refuses_an_unaligned_tensor(emulated):
    q = _bf16((1, 40, 2, 64), seed=40)
    k, v = _bf16((1, 40, 2, 64), seed=41, shift=1), _bf16((1, 40, 2, 64), seed=42)
    rc, got = _attention(emulated["attention"], q, k, v, ATTENTION_POINTS[0])
    assert rc != 0 and torch.isnan(got.float()).all()
    assert tattn.bf16_path(q.data_ptr(), k.data_ptr(), v.data_ptr()) == "mma"


@pytest.mark.parametrize("M,N,K,shift,want", [
    (2048, 11008, 4096, 0, "wgmma"),   # deepseek-7b's up-projection
    (2048, 768, 2048, 0, "wgmma"),     # qwen3-moe's expert width
    (333, 450, 700, 0, "mma"),         # N and K no multiple of 8
    (64, 128, 96, 1, "mma"),           # an operand one element past 16 bytes
])
def test_matmul_path_choice(M, N, K, shift, want):
    """``path`` picks before any launch, from the shapes and addresses
    alone; fp32 operands take 3xTF32."""
    a, b = _bf16((M, K), seed=1, shift=shift), _bf16((K, N), seed=2)
    assert tmatmul.path(a, b) == want
    assert tmatmul.bf16_path(N, K, a.data_ptr(), b.data_ptr()) == want
    assert tmatmul.path(a.float(), b.float()) == "tf32x3"
    sym = tmatmul.symbol(dict(MATMUL_POINTS[0]), BF16, want)
    assert sym in tmatmul.instantiations()
    assert sym.endswith("_bf16" if want == "wgmma" else "_bf16_mma")


@pytest.mark.parametrize("shift,want", [(0, "wgmma"), (1, "mma")])
def test_attention_path_choice(shift, want):
    q = _bf16((1, 8, 4, 16), seed=1)
    k, v = _bf16((1, 8, 2, 16), seed=2, shift=shift), _bf16((1, 8, 2, 16), seed=3)
    assert tattn.path(q, k, v) == want
    assert tattn.path(q.float(), k.float(), v.float()) == "tf32x3"
    sym = tattn.symbol(ATTENTION_POINTS[0], 8, 8, 16, BF16, want)
    assert sym in tattn.instantiations()
