"""The port's CUDA C++ kernels, run on the CPU under an emulator.

There is no nvcc and no card here, so the kernels' sources
(``kernels/*/csrc/*.cuh``) are compiled with the host's C++ compiler
against ``tests/cuda_emulator.h`` (one thread per CUDA thread, real
barriers for ``__syncthreads`` and warp shuffles) and launched through
ctypes on CPU tensors, at ragged shapes, against the kernels' plain
PyTorch versions. This checks the kernels' indexing, masking and
synchronization in tier-1; what nvcc accepts and how fast the card runs
them only ``chip_smoke.py`` shows.

Every kernel calls the Hopper primitives of ``kernels/_csrc/sm90.cuh``;
the emulator supplies host versions of them (the TF32 split, the
m16n8k8 product over the warp's fragments in PTX's layout, cp.async
copies that land when their group is waited for). The cases cover every
ring depth (``lookahead`` 0, 1 and 2), row strides that are not a
multiple of 4 floats (the 4-byte copies), misaligned operands, causal
attention with ``q_offset``, euclid's 4-deep sub-chunks and rmsnorm at
decode's few rows.

Tolerances: euclid rtol 2e-5, atol 1e-4 (the plain version's chunked
sums, another order; 3xTF32 products for vectorize=1, as for matmul);
matmul rtol 1e-5, atol 1e-4 (sums of K <= 300
products in another order; the 3xTF32 products drop small*small, about
2^-22 of each product); attention rtol 1e-5, atol 1e-5 (online softmax
over 32-key slices against the plain version's blocks, 3xTF32 products
as for matmul); rmsnorm rtol 1e-5, atol 1e-5 (fp32), 1e-2 for bfloat16
outputs (one rounding).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.attention import attention as tattn
from repro_torch.kernels.euclid import euclid as teuclid
from repro_torch.kernels.matmul import matmul as tmatmul
from repro_torch.kernels.rmsnorm import rmsnorm as trmsnorm

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"

MATMUL_POINTS = [
    dict(block_m=64, block_n=128, block_k=128, unroll=1, order="mn", scratch=1),
    dict(block_m=128, block_n=128, block_k=256, unroll=2, order="nm", scratch=0),
    dict(block_m=64, block_n=256, block_k=128, unroll=4, order="nm", scratch=1),
    dict(block_m=128, block_n=128, block_k=512, unroll=4, order="mn", scratch=0),
]
ATTENTION_POINTS = [dict(block_q=128, block_kv=128), dict(block_q=256, block_kv=128),
                    dict(block_q=128, block_kv=256)]
EUCLID_POINTS = [
    dict(block_n=64, block_m=32, block_d=32, unroll=1, vectorize=1, order="nm", scratch=1),
    dict(block_n=128, block_m=64, block_d=16, unroll=2, vectorize=0, order="mn", scratch=0),
    dict(block_n=64, block_m=64, block_d=64, unroll=4, vectorize=1, order="mn", scratch=0),
    dict(block_n=64, block_m=32, block_d=16, unroll=4, vectorize=1, order="nm", scratch=1),
    dict(block_n=64, block_m=128, block_d=64, unroll=1, vectorize=1, order="mn", scratch=1),
]


def _emulated_source(family: str) -> str:
    """The family's header, with the launch syntax and dynamic shared
    memory rewritten for the emulator."""
    src = (KERNELS / family / "csrc" / f"{family}.cuh").read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emulator.h"')
    # the emulator supplies the host versions of the shared Hopper primitives
    src = src.replace('#include "sm90.cuh"', "")
    src = src.replace("#include <cuda_bf16.h>", "")
    src = src.replace("extern __shared__ __align__(16) float smem[];",
                      "float* smem = (float*)emu_dyn_smem;")
    return re.sub(
        r"(\w+(?:<[\w, ]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
        lambda m: ("emu_launch(" + ", ".join(p.strip() for p in m.group(2).split(",")[:3])
                   + ", [&] { " + m.group(1) + "(" + m.group(3) + "); });"),
        src, flags=re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """family -> ctypes library of a few instantiations, built with the
    host compiler in parallel."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emulation")
    (out / "cuda_emulator.h").write_text((Path(__file__).with_name("cuda_emulator.h")).read_text())
    wanted = {
        "matmul": [tmatmul.instantiations()[tmatmul.symbol(p)] for p in MATMUL_POINTS],
        "attention": [tattn.instantiations()[tattn.symbol(p, 1024, 1024)]
                      for p in ATTENTION_POINTS],
        "rmsnorm": list(trmsnorm.instantiations().values()),
        "euclid": list(teuclid.instantiations(
            [tuple(p[k] for k in teuclid.PHASE1) for p in EUCLID_POINTS]).values()),
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
            raise AssertionError(f"emulated {family} failed to build:\n{log}")
        libs[family] = ctypes.CDLL(str(out / f"lib{family}.so"))
    return libs


def launch(lib, symbol, argtypes, *args):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    assert fn(*args) == 0


def randn(*shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("pi", range(len(MATMUL_POINTS)))
def test_emulated_matmul_matches_its_plain_version(emulated, pi):
    """Ragged M, N and K: no multiple of any block."""
    point = MATMUL_POINTS[pi]
    M, N, K = 70, 150, 300
    a, b = randn(M, K, seed=pi), randn(K, N, seed=pi + 10)
    out = torch.full((M, N), float("nan"))
    launch(emulated["matmul"], tmatmul.symbol(point), tmatmul._ARGTYPES,
           a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
           tmatmul._ORDERS[point["order"]], point["scratch"], point.get("lookahead", 1),
           None)
    torch.testing.assert_close(out, tmatmul.matmul_plain(a, b, point),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("lookahead", [0, 1, 2])
@pytest.mark.parametrize("M,N,K", [(70, 150, 300), (33, 131, 203)])
def test_emulated_matmul_ring_depths_and_row_strides(emulated, M, N, K, lookahead):
    """Every ring depth; B rows of 150 or 131 floats and A rows of 203
    (not multiples of 4: the 4-byte copies), both scratch modes."""
    point = dict(MATMUL_POINTS[(lookahead + K) % len(MATMUL_POINTS)], lookahead=lookahead)
    a, b = randn(M, K, seed=lookahead), randn(K, N, seed=lookahead + 10)
    out = torch.full((M, N), float("nan"))
    launch(emulated["matmul"], tmatmul.symbol(point), tmatmul._ARGTYPES,
           a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
           tmatmul._ORDERS[point["order"]], point["scratch"], lookahead, None)
    torch.testing.assert_close(out, tmatmul.matmul_plain(a, b, point),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B,Tq,Tkv,H,Hk,causal,q_offset,pi", [
    (1, 70, 70, 4, 2, 1, 0, 0),       # one ragged tile, GQA G = 2
    (1, 150, 200, 2, 1, 1, 50, 0),    # offset queries, a ragged kv tail
    (1, 100, 90, 2, 2, 0, 0, 2),      # non-causal
    (1, 300, 300, 2, 1, 1, 0, 1),     # several q tiles: the causal skip
])
def test_emulated_flash_attention_matches_its_plain_version(
        emulated, B, Tq, Tkv, H, Hk, causal, q_offset, pi):
    point = ATTENTION_POINTS[pi]
    q = randn(B, Tq, H, 128, seed=1)
    k, v = randn(B, Tkv, Hk, 128, seed=2), randn(B, Tkv, Hk, 128, seed=3)
    out = torch.full_like(q, float("nan"))
    launch(emulated["attention"], tattn.symbol(point, Tq, Tkv), tattn._ARGTYPES,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           B, Tq, Tkv, H, Hk, causal, q_offset, 128 ** -0.5, 1, None)
    want = tattn.flash_attention_plain(q, k, v, point, causal=bool(causal),
                                       q_offset=q_offset)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,d", [(100, 64), (3, 33), (4, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_rmsnorm_matches_its_plain_version(emulated, N, d, dtype):
    """Every instantiation; N below and not a multiple of block_rows; d
    not a multiple of 4 (the scalar path)."""
    x, w = randn(N, d, seed=N).to(dtype), randn(d, seed=d).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for rows in trmsnorm.BLOCK_ROWS:
        point = {"block_rows": rows}
        out = torch.full_like(x, float("nan"))
        # a 4-SM card: blocks of several rows at N = 100
        launch(emulated["rmsnorm"], trmsnorm.symbol(point, dtype), trmsnorm._ARGTYPES,
               x.data_ptr(), w.data_ptr(), out.data_ptr(), N, d, 1e-6, 1, 4, None)
        torch.testing.assert_close(out.float(), trmsnorm.rmsnorm_plain(x, w, point).float(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("pi", range(len(EUCLID_POINTS)))
def test_emulated_euclid_matches_its_plain_version(emulated, pi):
    """Ragged N, M and D: no multiple of any block; both scratch modes,
    both orders, both formulations."""
    point = EUCLID_POINTS[pi]
    N, M, D = 150, 70, 70
    x, c = randn(N, D, seed=pi), randn(M, D, seed=pi + 10)
    out = torch.full((N, M), float("nan"))
    launch(emulated["euclid"], teuclid.symbol(point), teuclid._ARGTYPES,
           x.data_ptr(), c.data_ptr(), out.data_ptr(), N, M, D,
           teuclid._ORDERS[point["order"]], point["scratch"], 1, 132, None)
    torch.testing.assert_close(out, teuclid.euclid_plain(x, c, point),
                               rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("lookahead", [0, 1, 2])
@pytest.mark.parametrize("D", [64, 70])
def test_emulated_euclid_ring_depths_and_row_strides(emulated, D, lookahead):
    """Every ring depth; D = 64 (16-byte copies) and D = 70 (rows of 280
    bytes: the 4-byte copies); the two vectorize formulations and a
    block_d 16, unroll 4 point, whose 4-deep sub-chunks run the k8 product
    with a zero upper half. A 2-SM card: each block walks several tiles,
    the ring running on across them."""
    N, M = 90, 40
    x, c = randn(N, D, seed=D + lookahead), randn(M, D, seed=D + lookahead + 10)
    for point in (EUCLID_POINTS[(lookahead + D) % 3], EUCLID_POINTS[3]):
        point = dict(point, lookahead=lookahead)
        out = torch.full((N, M), float("nan"))
        launch(emulated["euclid"], teuclid.symbol(point), teuclid._ARGTYPES,
               x.data_ptr(), c.data_ptr(), out.data_ptr(), N, M, D,
               teuclid._ORDERS[point["order"]], point["scratch"], lookahead, 2, None)
        torch.testing.assert_close(out, teuclid.euclid_plain(x, c, point),
                                   rtol=2e-5, atol=1e-4)


def test_emulated_euclid_misaligned_operands(emulated):
    """x and c one float past a 16-byte boundary take the 4-byte copies
    even where D is a multiple of 4."""
    N, M, D = 70, 50, 32
    point = dict(EUCLID_POINTS[0], lookahead=2)
    x = randn(N * D + 1, seed=7)[1:].view(N, D)
    c = randn(M * D + 1, seed=8)[1:].view(M, D)
    assert x.data_ptr() % 16 != 0 and c.data_ptr() % 16 != 0
    out = torch.full((N, M), float("nan"))
    launch(emulated["euclid"], teuclid.symbol(point), teuclid._ARGTYPES,
           x.data_ptr(), c.data_ptr(), out.data_ptr(), N, M, D,
           teuclid._ORDERS[point["order"]], point["scratch"], 2, 3, None)
    torch.testing.assert_close(out, teuclid.euclid_plain(x, c, point),
                               rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("lookahead", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_rmsnorm_decode_shapes_and_ring_depths(emulated, dtype, lookahead):
    """Decode-like shapes, one row or four (a block a row), a ragged d (the
    element copies) and several rows a block (N = 37 on a 4-SM card: the
    ring wraps), at every ring depth."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for N, d in ((1, 256), (4, 256), (4, 33), (37, 40)):
        x = randn(N, d, seed=N + d).to(dtype)
        w = randn(d, seed=d + 1).to(dtype)
        for rows in (8, 512):
            point = {"block_rows": rows, "lookahead": lookahead}
            out = torch.full_like(x, float("nan"))
            launch(emulated["rmsnorm"], trmsnorm.symbol(point, dtype), trmsnorm._ARGTYPES,
                   x.data_ptr(), w.data_ptr(), out.data_ptr(), N, d, 1e-6, lookahead, 4,
                   None)
            torch.testing.assert_close(
                out.float(), trmsnorm.rmsnorm_plain(x, w, point).float(),
                rtol=tol, atol=tol)


def test_emulated_truncating_split_is_the_bit_model(emulated, tmp_path):
    """The host version of ``sm90::tf32_split_trunc`` (which euclid's
    fragments go through) against the bit model of
    ``tests/test_torch_tf32.py``: big clears x's low 13 mantissa bits,
    small clears those of x - big."""
    (tmp_path / "cuda_emulator.h").write_text(
        Path(__file__).with_name("cuda_emulator.h").read_text())
    unit = tmp_path / "split.cpp"
    unit.write_text('#include "cuda_emulator.h"\n'
                    'extern "C" void split(const float* x, uint32_t* big, uint32_t* small, '
                    'int n) {\n  for (int i = 0; i < n; ++i) '
                    'sm90::tf32_split_trunc(x[i], big[i], small[i]);\n}\n')
    cxx = shutil.which("g++") or shutil.which("c++")
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
                    str(unit), "-o", str(tmp_path / "libsplit.so")], check=True)
    lib = ctypes.CDLL(str(tmp_path / "libsplit.so"))
    x = randn(4096, seed=3)
    big = torch.empty(4096, dtype=torch.int32)
    small = torch.empty(4096, dtype=torch.int32)
    lib.split.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.split(x.data_ptr(), big.data_ptr(), small.data_ptr(), 4096)
    want_big = x.view(torch.int32) & -8192
    want_small = (x - want_big.view(torch.float32)).view(torch.int32) & -8192
    assert torch.equal(big, want_big) and torch.equal(small, want_small)


def test_emulated_shared_memory_footprints_match_the_python_counts(emulated):
    """The footprints the capacity rules count (``smem_bytes`` in Python)
    are the kernels' own, read from their exported ``_smem`` functions."""
    for point in EUCLID_POINTS:
        fn = getattr(emulated["euclid"], teuclid.symbol(point) + "_smem")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
        for la in (0, 1, 2):
            assert fn(la) == teuclid.smem_bytes(dict(point, lookahead=la))
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        fn = getattr(emulated["rmsnorm"], trmsnorm.symbol({"block_rows": 8}, dtype) + "_smem")
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
        for d in (1, 33, 1001, 4096):
            for la in (0, 1, 2):
                assert fn(d, la) == trmsnorm.smem_bytes({"lookahead": la}, d, size)


@pytest.mark.parametrize("lookahead,aligned", [(0, True), (1, True), (2, True), (1, False)])
def test_emulated_flash_attention_ring_depths(emulated, lookahead, aligned):
    """Causal with q_offset (the query rows sit at the end of a longer kv
    sequence, GQA G = 2) at every ring depth; k and v one float past a
    16-byte boundary take the 4-byte copies."""
    B, Tq, Tkv, H, Hk, q_offset = 1, 150, 280, 4, 2, 130
    point = ATTENTION_POINTS[lookahead]
    q = randn(B, Tq, H, 128, seed=4)
    n = B * Tkv * Hk * 128
    shift = 0 if aligned else 1
    k = randn(n + shift, seed=5)[shift:].view(B, Tkv, Hk, 128)
    v = randn(n + shift, seed=6)[shift:].view(B, Tkv, Hk, 128)
    assert (k.data_ptr() % 16 == 0) == aligned
    out = torch.full_like(q, float("nan"))
    launch(emulated["attention"], tattn.symbol(point, Tq, Tkv), tattn._ARGTYPES,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           B, Tq, Tkv, H, Hk, 1, q_offset, 128 ** -0.5, lookahead, None)
    want = tattn.flash_attention_plain(q, k, v, point, q_offset=q_offset)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
