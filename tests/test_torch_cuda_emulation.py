"""The port's CUDA C++ kernels, run on the CPU under an emulator.

There is no nvcc and no card here, so the kernels' sources
(``kernels/*/csrc/*.cuh``) are compiled with the host's C++ compiler
against ``tests/cuda_emulator.h`` (one thread per CUDA thread, real
barriers for ``__syncthreads`` and warp shuffles) and launched through
ctypes on CPU tensors, at ragged shapes, against the kernels' plain
PyTorch versions. This checks the kernels' indexing, masking and
synchronization in tier-1; what nvcc accepts and how fast the card runs
them only ``chip_smoke.py`` shows.

Tolerances: euclid rtol 2e-5, atol 1e-4 (the plain version's chunked
sums, another order); matmul rtol 1e-5, atol 1e-4 (fp32 sums of K <= 300 products
in another order); attention rtol 1e-5, atol 1e-5 (online softmax over
64-key slices against the plain version's blocks); rmsnorm rtol 1e-5,
atol 1e-5 (fp32), 1e-2 for bfloat16 outputs (one rounding).
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
]


def _emulated_source(family: str) -> str:
    """The family's header, with the launch syntax and dynamic shared
    memory rewritten for the emulator."""
    src = (KERNELS / family / "csrc" / f"{family}.cuh").read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emulator.h"')
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
           tmatmul._ORDERS[point["order"]], point["scratch"], None)
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
           B, Tq, Tkv, H, Hk, causal, q_offset, 128 ** -0.5, None)
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
        vec4 = int(dtype == torch.float32 and d % 4 == 0)
        launch(emulated["rmsnorm"], trmsnorm.symbol(point, dtype), trmsnorm._ARGTYPES,
               x.data_ptr(), w.data_ptr(), out.data_ptr(), N, d, 1e-6, vec4, None)
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
           teuclid._ORDERS[point["order"]], point["scratch"], None)
    torch.testing.assert_close(out, teuclid.euclid_plain(x, c, point),
                               rtol=2e-5, atol=1e-4)
