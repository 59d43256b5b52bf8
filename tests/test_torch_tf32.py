"""The arithmetic of the 3xTF32 products, modelled in PyTorch on the CPU.

The matmul, flash-attention and euclid kernels (``kernels/*/csrc/*.cuh``)
run their fp32 products on the tensor cores as three TF32 products
(``sm90::mma_3xtf32``): each operand ``x`` is split into ``big =
tf32(x)`` and ``small = tf32(x - big)`` (rounded to nearest in matmul and
attention, ``sm90::tf32_split``; truncated in euclid,
``sm90::tf32_split_trunc``), and ``small*big + big*small + big*big`` is
accumulated in fp32, 8 deep per ``mma.sync`` step. These tests model
that with bit masks on ``float32.view(int32)`` and hold it against a
float64 product under the limits ``chip_smoke.py`` holds the kernels to
on the card (``MATMUL_TOL``, ``ATTENTION_TOL``, ``EUCLID_TOL``, read from
its source): 3xTF32 passes them, one TF32 product does not. The accumulator
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


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The low 13 mantissa bits cleared (``sm90::tf32_split_trunc``)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def tf32_split(x: torch.Tensor, split: str = "round") -> tuple[torch.Tensor, torch.Tensor]:
    cut = tf32 if split == "round" else tf32_trunc
    big = cut(x)
    return big, cut(x - big)


def toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = x.to(torch.float32)
    up = f.double().abs() > x.abs()
    bits = f.view(torch.int32)
    return torch.where(up, bits - 1, bits).view(torch.float32)


def mma_accumulate(acc, x, y, *, terms: int, rounding: str, split: str = "round"):
    """``acc + x @ y`` in 8-deep tensor-core steps: the TF32 products are
    exact, the fp32 accumulator is rounded after each of the ``terms``
    products of a step (3: small*big, big*small, big*big; 1: big*big);
    the operands split as ``split`` says ("round" or "trunc")."""
    xb, xs = tf32_split(x, split)
    yb, ys = tf32_split(y, split)
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


def euclid_cases():
    """(D, sub-chunk depth, block_d): Table 3's dimensions, every sub-chunk
    depth from 4 to D, each at a block_d that splits into 1, 2 or 4 of
    them (block_d 16 at unroll 4 for the 4-deep ones)."""
    return [(d, sub, min(4 * sub, 128, d)) for d in (32, 64, 128)
            for sub in (4, 8, 16, 32, 64, 128) if sub <= d]


@pytest.mark.parametrize("rounding", ["nearest", "toward_zero"])
@pytest.mark.parametrize("D,sub,block_d", euclid_cases())
def test_3xtf32_euclid_passes_the_chip_limit_and_1xtf32_does_not(D, sub, block_d, rounding):
    """Table 3's standard-normal points and centres, the kernel's
    arithmetic for ``vectorize=1``: per sub-chunk, fp32 squared norms and
    the dot product on the tensor cores with truncated splits (a 4-deep
    sub-chunk is the k8 product with a zero upper half, so the same
    sums), combined as
    (||x||^2 + ||c||^2) - 2 x.c in fp32 and summed in order into the
    chunk total, which is added to the accumulator; against float64
    distances, under ``EUCLID_TOL``."""
    tol = chip_limit("EUCLID_TOL")
    x, c = normal((64, D), 6), normal((48, D), 7)
    want = ((x.double()[:, None, :] - c.double()[None, :, :]) ** 2).sum(-1)

    def kernel_model(terms):
        acc = torch.zeros(64, 48)
        for k0 in range(0, D, block_d):
            total = torch.zeros(64, 48)
            for s0 in range(k0, k0 + block_d, sub):
                xs, cs = x[:, s0:s0 + sub], c[:, s0:s0 + sub]
                dot = mma_accumulate(torch.zeros(64, 48), xs, cs.T.contiguous(),
                                     terms=terms, rounding=rounding, split="trunc")
                xx = (xs * xs).sum(-1, keepdim=True)
                cc = (cs * cs).sum(-1, keepdim=True).T
                total = total + ((xx + cc) - 2.0 * dot)
            acc = acc + total
        return acc

    assert limit_share(kernel_model(3), want, tol) < 0.5
    assert limit_share(kernel_model(1), want, tol) > 2


def test_truncated_split_keeps_about_21_bits():
    """``sm90::tf32_split_trunc``: big and small are TF32 values (low 13
    bits zero), big is x truncated toward zero, and big + small carries x
    to about 2^-20, against 2^-21 for the rounding split."""
    x = normal((4096,), 0)
    big, small = tf32_split(x, "trunc")
    bits = lambda t: t.view(torch.int32) & 8191  # noqa: E731
    assert not bits(big).any() and not bits(small).any()
    assert bool((big.abs() <= x.abs()).all()) and bool((big * x >= 0).all())
    assert float(((big - x).abs() / x.abs()).max()) <= 2.0 ** -10
    err = (big.double() + small.double() - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -20
