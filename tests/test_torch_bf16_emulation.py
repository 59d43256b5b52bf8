"""The bf16 input class of the matmul and flash-attention kernels on their
``mma`` path (the ``mma.sync`` kernels that serve operands TMA cannot
describe), run on the CPU under ``tests/cuda_emulator.h``; the ``wgmma``
path has ``test_torch_wgmma_emulation.py``.

The ``mma`` paths of ``csrc/matmul.cuh`` (bf16 A and B, fp32 C) and
``csrc/attention.cuh`` (``flash_kernel_bf16``: bf16 q, k, v and out) are
compiled with the host's C++ compiler against the emulator, whose
``mma_bf16_m16n8k16`` gathers the warp's fragments in PTX's m16n8k16
layout and whose ``pack_bf16x2`` rounds to nearest even, and are held
against the plain PyTorch versions on the same bf16 inputs: at ragged
edges, at two or three ring depths, on the 16-byte copies and on the
element copies (K, N or the kv rows not a multiple of 8 values, or an
operand one element past a 16-byte boundary).

Limits: matmul rtol 1e-5, atol 1e-4 (products of two bf16 values are
exact in fp32; the sums run in another order); attention rtol 1e-2,
atol 1e-2 (the kernel rounds P to bf16 against its 32-key slice's
running max, the plain version against its block's, and both round the
output to bf16: a few bf16 ulps at most, inside ``chip_smoke.py``'s
limit for the same comparison on the card).

A file of its own, at the smallest shapes that cover these cases: two
emulator files running side by side slow each other.
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
    dict(block_m=64, block_n=128, block_k=128, unroll=1, order="mn", scratch=1),
    dict(block_m=128, block_n=128, block_k=256, unroll=2, order="nm", scratch=0),
]
ATTENTION_POINT = {"block_q": 128, "block_kv": 128}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """family -> ctypes library of the bf16 instantiations used here,
    both built with the host compiler in parallel."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    out = tmp_path_factory.mktemp("bf16_emulation")
    (out / "cuda_emulator.h").write_text(
        Path(__file__).with_name("cuda_emulator.h").read_text())
    # each family's mma instantiations, and (for the footprint test) the
    # wgmma ones of the same points
    wanted = {
        "matmul": [tmatmul.instantiations()[tmatmul.symbol(p, BF16, path)]
                   for p in MATMUL_POINTS for path in ("mma", "wgmma")],
        "attention": [tattn.instantiations()[tattn.symbol(ATTENTION_POINT, 64, 64, 16, BF16,
                                                          path)]
                      for path in ("mma", "wgmma")],
    }
    procs = {}
    for family, lines in wanted.items():
        (out / f"{family}.h").write_text(_emulated_source(family))
        unit = out / f"{family}.cpp"
        unit.write_text(f'#include "{family}.h"\n' + "\n".join(lines) + "\n")
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
            raise AssertionError(f"emulated bf16 {family} failed to build:\n{log}")
        libs[family] = ctypes.CDLL(str(out / f"lib{family}.so"))
    return libs


def _bf16(shape, seed, shift=0):
    """A bf16 tensor of ``shape`` from a numpy draw, ``shift`` elements
    past the start of its storage (shift 1: not 16-byte aligned)."""
    x = np.random.default_rng(seed).standard_normal(int(np.prod(shape)) + shift)
    t = torch.from_numpy(x.astype(np.float32)).to(BF16)
    return t[shift:].view(*shape)


def _call(lib, symbol, argtypes, *args):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    assert fn(*args) == 0


@pytest.mark.parametrize("M,N,K,shift", [
    (70, 136, 96, 0),    # the 16-byte copies; a ragged M and N edge
    (33, 45, 77, 0),     # K and N no multiple of 8: the element copies
    (40, 136, 96, 1),    # operands past a 16-byte boundary: the element copies
])
@pytest.mark.parametrize("which", [0, 1])
def test_emulated_bf16_matmul(emulated, M, N, K, shift, which):
    """bf16 A and B, fp32 C, against ``matmul_plain`` (which upcasts),
    at lookahead 0 and 2: two points, one with ``unroll`` 2 and the
    read-modify-write output (``scratch`` 0)."""
    point = dict(MATMUL_POINTS[which], lookahead=2 * which)
    a, b = _bf16((M, K), seed=1 + which, shift=shift), _bf16((K, N), seed=3, shift=shift)
    c = torch.full((M, N), float("nan"), dtype=torch.float32)
    _call(emulated["matmul"], tmatmul.symbol(point, BF16, "mma"), tmatmul._ARGTYPES,
          a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
          tmatmul._ORDERS[point["order"]], point["scratch"], point["lookahead"], None)
    torch.testing.assert_close(c, tmatmul.matmul_plain(a, b, point), **MATMUL_TOL)


def _attention(lib, q, k, v, point, *, causal=1, q_offset=0, lookahead=1):
    B, Tq, H, Dh = q.shape
    _, Tkv, Hk, _ = k.shape
    out = torch.full_like(q, float("nan"))
    _call(lib, tattn.symbol(point, Tq, Tkv, Dh, BF16, "mma"), tattn._ARGTYPES,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq, Tkv, H, Hk,
          causal, q_offset, Dh ** -0.5, lookahead, None)
    return out


@pytest.mark.parametrize("lookahead", [0, 1, 2])
def test_emulated_bf16_attention_offset_gqa_ragged(emulated, lookahead):
    """Dh 16, causal with q_offset (the rows at the end of a longer kv
    sequence), GQA G = 2, a kv length no multiple of 32, at every ring
    depth: bf16 out, against ``flash_attention_plain`` at bf16."""
    B, Tq, Tkv, H, Hk, Dh, q_offset = 1, 40, 70, 2, 1, 16, 30
    q = _bf16((B, Tq, H, Dh), seed=10)
    k, v = _bf16((B, Tkv, Hk, Dh), seed=11), _bf16((B, Tkv, Hk, Dh), seed=12)
    got = _attention(emulated["attention"], q, k, v, ATTENTION_POINT,
                     q_offset=q_offset, lookahead=lookahead)
    want = tattn.flash_attention_plain(q, k, v, ATTENTION_POINT, q_offset=q_offset)
    assert got.dtype == BF16
    torch.testing.assert_close(got.float(), want.float(), **ATTENTION_TOL)


@pytest.mark.parametrize("causal,shift", [(1, 1), (0, 0)])
def test_emulated_bf16_attention_unaligned_and_non_causal(emulated, causal, shift):
    """Two batch rows, a ragged q tile and kv tail; k and v one element
    past a 16-byte boundary take the element copies; non-causal over
    the whole kv."""
    B, Tq, Tkv, H, Hk, Dh = 2, 20, 45, 2, 1, 16
    q = _bf16((B, Tq, H, Dh), seed=20)
    k = _bf16((B, Tkv, Hk, Dh), seed=21, shift=shift)
    v = _bf16((B, Tkv, Hk, Dh), seed=22, shift=shift)
    assert (k.data_ptr() % 16 == 0) == (shift == 0)
    got = _attention(emulated["attention"], q, k, v, ATTENTION_POINT, causal=causal)
    want = tattn.flash_attention_plain(q, k, v, ATTENTION_POINT, causal=bool(causal))
    torch.testing.assert_close(got.float(), want.float(), **ATTENTION_TOL)


def test_emulated_bf16_footprints_match_the_python_count(emulated):
    """The capacity rule's counts are the bf16 kernels' own footprints,
    each kernel's exported ``_smem`` at every ring depth: the wgmma
    kernels' (``smem_bytes`` at bf16, the main path's) and the mma
    kernels' (``path="mma"``)."""
    def smem(lib, sym):
        fn = getattr(lib, sym + "_smem")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
        return fn

    wgmma = smem(emulated["attention"], tattn.symbol(ATTENTION_POINT, 64, 64, 16, BF16))
    mma = smem(emulated["attention"], tattn.symbol(ATTENTION_POINT, 64, 64, 16, BF16, "mma"))
    for la in (0, 1, 2):
        point = dict(ATTENTION_POINT, lookahead=la)
        assert wgmma(la) == tattn.smem_bytes(point, 16, dtype_bytes=2)
        # a 1024-byte alignment pad, 128 bytes of barriers, the 128-row q
        # tile and la + 1 stages of 128-key K and V tiles
        assert wgmma(la) == 1024 + 128 + 2 * 128 * 16 + (la + 1) * 2 * 2 * 128 * 16
        assert mma(la) == tattn.smem_bytes(point, 16, dtype_bytes=2, path="mma")
        assert mma(la) == (la + 1) * 2 * 2 * 32 * (16 + 8)
    for p in MATMUL_POINTS:
        wgmma = smem(emulated["matmul"], tmatmul.symbol(p, BF16))
        tm, tn = (64 if p["block_m"] < 128 else 128), (128 if p["block_n"] < 256 else 256)
        for la in (0, 1, 2):
            point = dict(p, lookahead=la)
            assert wgmma(la) == tmatmul.smem_bytes(point, 2)
            assert wgmma(la) == 1024 + 64 + (la + 2) * 2 * (tm + tn) * 64
    # the mma kernel's 64-row passes, 64-deep slices: A 64 x 72 and B 64 x
    # 136 bf16 values
    assert tmatmul.smem_bytes(dict(MATMUL_POINTS[0], lookahead=0), 2, path="mma") == \
        2 * (64 * 72 + 64 * 136)
