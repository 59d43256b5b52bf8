"""The flash-attention kernel at head dims 16, 64 and 128.

The kernel's head dim is a template parameter (``csrc/attention.cuh``),
instantiated at Dh 16 (every ``.reduced()`` config), 64 (the 64-wide
families) and 128 (deepseek-7b). Here the source runs on the CPU under
``tests/cuda_emulator.h`` at Dh 16 and 64, at every ring depth, with
GQA, ``q_offset`` and a ragged kv tail, and at Dh 128 with GQA groups of
5 and 7, against ``flash_attention_plain``
(rtol 1e-5, atol 1e-5, as at Dh 128 in ``test_torch_cuda_emulation.py``:
online softmax over 32-key slices against the plain version's blocks,
3xTF32 products). The shared-memory counts of the capacity rule are held
against the kernel's exported footprints, and a head dim without an
instantiation is refused by the space, by ``symbol`` and by the layers'
path to the kernel.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.attention import attention as tattn
from repro_torch.kernels.attention import ops as tattn_ops
from repro_torch.models import layers

from test_torch_cuda_emulation import _emulated_source

#: the Hopper card's shared memory a block may use, in kB
H100_SMEM_KB = 227
POINTS = [dict(block_q=128, block_kv=128), dict(block_q=256, block_kv=256)]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The attention header under the emulator, instantiated at Dh 16 and
    64 for ``POINTS`` and at Dh 128 for one point (its footprint)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernel")
    out = tmp_path_factory.mktemp("attention_dh")
    (out / "cuda_emulator.h").write_text(
        Path(__file__).with_name("cuda_emulator.h").read_text())
    (out / "attention.h").write_text(_emulated_source("attention"))
    inst = tattn.instantiations()
    lines = [inst[tattn.symbol(p, 1024, 1024, dh)] for dh in (16, 64) for p in POINTS]
    lines.append(inst[tattn.symbol(POINTS[0], 1024, 1024, 128)])
    unit = out / "attention.cpp"
    unit.write_text('#include "attention.h"\n' + "\n".join(lines) + "\n")
    res = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w", str(unit),
         "-o", str(out / "libattention.so")],
        capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        if "barrier" in res.stdout + res.stderr and "No such file" in res.stdout + res.stderr:
            pytest.skip("the host compiler lacks C++20 <barrier>")
        raise AssertionError(f"emulated attention failed to build:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(out / "libattention.so"))


def _randn(*shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _run(lib, q, k, v, point, *, causal=1, q_offset=0, lookahead=1):
    B, Tq, H, Dh = q.shape
    _, Tkv, Hk, _ = k.shape
    out = torch.full_like(q, float("nan"))
    fn = getattr(lib, tattn.symbol(point, Tq, Tkv, Dh))
    fn.argtypes, fn.restype = tattn._ARGTYPES, ctypes.c_int
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq, Tkv,
              H, Hk, causal, q_offset, Dh ** -0.5, lookahead, None) == 0
    return out


@pytest.mark.parametrize("Dh", [16, 64])
@pytest.mark.parametrize("lookahead", [0, 1, 2])
def test_emulated_attention_at_small_head_dims(emulated, Dh, lookahead):
    """Causal with q_offset (the rows sit at the end of a longer kv
    sequence), GQA G = 2, a kv length no multiple of 32: every ring
    depth at both new head dims."""
    B, Tq, Tkv, H, Hk, q_offset = 1, 40, 150, 2, 1, 110
    point = POINTS[lookahead % 2]
    q = _randn(B, Tq, H, Dh, seed=10 + Dh)
    k, v = _randn(B, Tkv, Hk, Dh, seed=11), _randn(B, Tkv, Hk, Dh, seed=12)
    got = _run(emulated, q, k, v, point, q_offset=q_offset, lookahead=lookahead)
    want = tattn.flash_attention_plain(q, k, v, point, q_offset=q_offset)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Dh,causal,aligned", [(16, 1, False), (64, 0, True),
                                               (16, 0, True), (64, 1, False)])
def test_emulated_attention_ragged_and_unaligned(emulated, Dh, causal, aligned):
    """Two batch rows, G = 2, a ragged q tile and kv tail; k and v one
    float past a 16-byte boundary take the 4-byte copies."""
    B, Tq, Tkv, H, Hk = 2, 40, 45, 2, 1
    q = _randn(B, Tq, H, Dh, seed=20)
    n = B * Tkv * Hk * Dh
    shift = 0 if aligned else 1
    k = _randn(n + shift, seed=21)[shift:].view(B, Tkv, Hk, Dh)
    v = _randn(n + shift, seed=22)[shift:].view(B, Tkv, Hk, Dh)
    assert (k.data_ptr() % 16 == 0) == aligned
    got = _run(emulated, q, k, v, POINTS[0], causal=causal)
    want = tattn.flash_attention_plain(q, k, v, POINTS[0], causal=bool(causal))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,Hk", [(10, 2), (7, 1)])
def test_emulated_attention_at_gqa_groups_5_and_7(emulated, H, Hk):
    """GQA groups of 5 (llama4-scout: 40 heads over 8) and 7 (qwen2-vl:
    28 over 4) at Dh 128, their head dim: q head h reads kv head h // G
    for a G that is no power of two. Causal, Tq = Tkv = 9, as a prefill."""
    B, T, Dh = 1, 9, 128
    q = _randn(B, T, H, Dh, seed=30 + H)
    k, v = _randn(B, T, Hk, Dh, seed=31), _randn(B, T, Hk, Dh, seed=32)
    got = _run(emulated, q, k, v, POINTS[0])
    want = tattn.flash_attention_plain(q, k, v, POINTS[0])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_emulated_attention_non_causal_over_a_ragged_kv(emulated):
    """Non-causal at Dh 64 (whisper's encoder and cross-attention), a
    few queries over 150 keys: no multiple of the 128-key block or of a
    32-key slice."""
    B, Tq, Tkv, H, Hk, Dh = 1, 8, 150, 2, 2, 64
    q = _randn(B, Tq, H, Dh, seed=40)
    k, v = _randn(B, Tkv, Hk, Dh, seed=41), _randn(B, Tkv, Hk, Dh, seed=42)
    got = _run(emulated, q, k, v, POINTS[0], causal=0, lookahead=2)
    want = tattn.flash_attention_plain(q, k, v, POINTS[0], causal=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Dh", tattn.HEAD_DIMS)
def test_emulated_footprint_matches_the_python_count(emulated, Dh):
    """``smem_bytes`` (the capacity rule's count) is the kernel's own
    footprint, read from its exported ``_smem`` function, at each Dh."""
    fn = getattr(emulated, tattn.symbol(POINTS[0], 1024, 1024, Dh) + "_smem")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    for la in (0, 1, 2):
        assert fn(la) == tattn.smem_bytes({"lookahead": la}, Dh)
        assert fn(la) == (la + 1) * tattn.stage_bytes(Dh) + tattn.split_bytes(Dh)
    assert tattn.smem_bytes({"lookahead": 2}, Dh) <= tattn.SMEM_BYTES


@pytest.mark.parametrize("Dh", tattn.HEAD_DIMS)
def test_hopper_capacity_rule_per_head_dim(Dh):
    """At the card's capacity every point of the space is valid at an
    instantiated Dh; at a capacity between two and three ring stages
    only lookahead 2 is refused; every point resolves to an instantiation."""
    space = tattn_ops.make_space(512, 512, Dh, vmem_kb=H100_SMEM_KB, hopper=True)
    valid = list(space.iter_valid())
    assert len(valid) == len(list(space.iter_all()))
    for p in valid:
        assert tattn.symbol(p, 512, 512, Dh) in tattn.instantiations()
    sizes = [tattn.smem_bytes({"lookahead": la}, Dh) for la in (0, 1, 2)]
    cap_kb = sizes[1] // 1024 + 1
    tight = tattn_ops.make_space(512, 512, Dh, vmem_kb=cap_kb, hopper=True)
    point = dict(tattn_ops.DEFAULT_POINT)
    assert [tight.is_valid(dict(point, lookahead=la)) for la in (0, 1, 2)] == \
        [True, True, False]


@pytest.mark.parametrize("Dh", [8, 12, 32, 96, 256])
def test_uninstantiated_head_dims_have_no_point(Dh):
    """A head dim the library has no instantiation for (and any Dh that
    is not a multiple of 8) has no valid Hopper point and no symbol."""
    space = tattn_ops.make_space(512, 512, Dh, vmem_kb=H100_SMEM_KB, hopper=True)
    assert not list(space.iter_valid())
    with pytest.raises(KeyError):
        tattn.symbol({"block_q": 128, "block_kv": 128}, 512, 512, Dh)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so the wrapper's
    argument checks, which come before any launch, can run here."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("Dh", [32, 12])
def test_attend_raises_at_an_uninstantiated_head_dim(Dh):
    """On a CUDA tensor the layers' causal self-attention goes to the
    kernel, which refuses a head dim it has no instantiation for: no
    fallback to the plain version."""
    cfg = get_config("deepseek-7b").reduced()
    q = _randn(1, 40, 4, Dh, seed=1).as_subclass(_OnCard)
    k = _randn(1, 40, 2, Dh, seed=2).as_subclass(_OnCard)
    v = _randn(1, 40, 2, Dh, seed=3).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="Dh in"):
        layers._attend(q, k, v, cfg, causal=True, q_offset=0)
    with pytest.raises(ValueError, match="Dh in"):
        tattn.flash_attention_cuda(q, k, v, {"block_q": 128, "block_kv": 128})


def test_reduced_configs_run_at_an_instantiated_head_dim():
    """Every ``.reduced()`` config has Dh 16, which the kernel takes."""
    assert get_config("deepseek-7b").reduced().d_head == 16
    assert get_config("deepseek-7b").d_head in tattn.HEAD_DIMS
