"""The arithmetic of the 3xTF32 products, modelled in PyTorch on the CPU.

The matmul and flash-attention kernels (``kernels/*/csrc/*.cuh``) run
their fp32 products on the tensor cores as three TF32 products
(``sm90::mma_3xtf32``): each operand ``x`` is split into ``big =
tf32(x)`` and ``small = tf32(x - big)``, and ``small*big + big*small +
big*big`` is accumulated in fp32, 8 deep per ``mma.sync`` step. These
tests model that with bit masks on ``float32.view(int32)`` and hold it
against a float64 product under the limits ``chip_smoke.py`` holds the
kernels to on the card (``MATMUL_TOL``, ``ATTENTION_TOL``, read from its
source): 3xTF32 passes them, one TF32 product does not. The accumulator
is rounded either to nearest or toward zero after every step, since the
tensor core's own rounding of its fp32 sums is not documented; the
matmul partials are as deep as the kernel's sub-chunks (128 to 512).
The card then confirms the reasoning in ``chip_smoke.py``'s checks.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def chip_limit(name: str) -> dict:
    """A limit as ``chip_smoke.py`` states it."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, keeping
    10 explicit mantissa bits (the low 13 bits become 0)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -8192).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32(x)
    return big, tf32(x - big)


def toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = x.to(torch.float32)
    up = f.double().abs() > x.abs()
    bits = f.view(torch.int32)
    return torch.where(up, bits - 1, bits).view(torch.float32)


def mma_accumulate(acc, x, y, *, terms: int, rounding: str):
    """``acc + x @ y`` in 8-deep tensor-core steps: the TF32 products are
    exact, the fp32 accumulator is rounded after each of the ``terms``
    products of a step (3: small*big, big*small, big*big; 1: big*big)."""
    xb, xs = tf32_split(x)
    yb, ys = tf32_split(y)
    pairs = [(xs, yb), (xb, ys), (xb, yb)] if terms == 3 else [(xb, yb)]
    for k0 in range(0, x.shape[1], 8):
        for p, q in pairs:
            s = acc.double() + p[:, k0:k0 + 8].double() @ q[k0:k0 + 8].double()
            acc = s.float() if rounding == "nearest" else toward_zero(s)
    return acc


def limit_share(got, want, tol) -> float:
    """The largest ``|got - want| / (atol + rtol * |want|)``."""
    return float(((got.double() - want).abs()
                  / (tol["atol"] + tol["rtol"] * want.abs())).max())


def normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def test_tf32_split_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # a tf32 ulp at 1.0
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    big, small = tf32_split(normal((4096,), 0))
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    x = normal((4096,), 0)
    # big carries 11 significant bits, big + small about 22
    assert float(((big - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float(((big.double() + small.double() - x.double()).abs()
                  / x.double().abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("rounding", ["nearest", "toward_zero"])
@pytest.mark.parametrize("depth", [128, 512])
def test_3xtf32_matmul_passes_the_chip_limit_and_1xtf32_does_not(depth, rounding):
    """K = 4096, unit-variance inputs, partials ``depth`` deep (the
    kernel's sub-chunks) summed in fp32, against a float64 product."""
    tol = chip_limit("MATMUL_TOL")
    a, b = normal((32, 4096), 1), normal((4096, 32), 2)
    want = a.double() @ b.double()

    def product(terms):
        out = torch.zeros(32, 32, dtype=torch.float32)
        for k0 in range(0, 4096, depth):
            part = mma_accumulate(torch.zeros(32, 32), a[:, k0:k0 + depth],
                                  b[k0:k0 + depth], terms=terms, rounding=rounding)
            out = out + part
        return out

    assert limit_share(product(3), want, tol) < 0.5
    assert limit_share(product(1), want, tol) > 10


@pytest.mark.parametrize("rounding", ["nearest", "toward_zero"])
def test_3xtf32_attention_rows_pass_the_chip_limit_and_1xtf32_does_not(rounding):
    """One warp's 16 query rows at the end of a 1000-key causal sequence
    (q_offset 984), Dh = 128, the online softmax over 32-key slices as
    the kernel runs it, against float64 attention."""
    tol = chip_limit("ATTENTION_TOL")
    T, rows, q_offset, dh = 1000, 16, 984, 128
    q, k, v = normal((rows, dh), 3), normal((T, dh), 4), normal((T, dh), 5)
    scale = dh ** -0.5
    qpos = q_offset + torch.arange(rows)

    s = (q.double() @ k.double().T) * scale
    s = torch.where(qpos[:, None] >= torch.arange(T)[None], s,
                    torch.tensor(-1e300, dtype=torch.float64))
    want = torch.softmax(s, dim=1) @ v.double()

    def kernel_model(terms):
        m = torch.full((rows,), -1e30)
        l, o = torch.zeros(rows), torch.zeros(rows, dh)
        for s0 in range(0, T, 32):
            ks, vs = k[s0:s0 + 32], v[s0:s0 + 32]
            sc = mma_accumulate(torch.zeros(rows, len(ks)), q, ks.T.contiguous(),
                                terms=terms, rounding=rounding) * scale
            sc = torch.where(qpos[:, None] >= s0 + torch.arange(len(ks))[None], sc,
                             torch.tensor(-1e30))
            m_new = torch.maximum(m, sc.amax(dim=1))
            p, alpha = torch.exp(sc - m_new[:, None]), torch.exp(m - m_new)
            l, m = l * alpha + p.sum(dim=1), m_new
            o = mma_accumulate(o * alpha[:, None], p, vs, terms=terms,
                               rounding=rounding)
        return o / l[:, None]

    assert limit_share(kernel_model(3), want, tol) < 0.5
    assert limit_share(kernel_model(1), want, tol) > 2


def test_one_4096_deep_truncating_chain_would_fail_the_matmul_limit():
    """Why the kernel sums its tensor-core products in k-chunk partials
    (at most 512 deep) before adding them in fp32: if the tensor core
    truncates its fp32 sums, one accumulator over all of K = 4096 would
    fail the chip limit even in 3xTF32."""
    tol = chip_limit("MATMUL_TOL")
    a, b = normal((32, 4096), 1), normal((4096, 32), 2)
    got = mma_accumulate(torch.zeros(32, 32), a, b, terms=3, rounding="toward_zero")
    assert limit_share(got, a.double() @ b.double(), tol) > 1
