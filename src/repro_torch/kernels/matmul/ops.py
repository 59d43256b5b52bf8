"""Matmul kernel: compilette factory, analytical cost model, catalog entry.

Mirrors ``repro/kernels/matmul/ops.py``: the same tuning space, cost
model and catalog entry. Variants are the hand kernel (``matmul.py``,
CUDA C++) on a CUDA device and its plain version on the CPU.

**Capacity rule.** At the reference's capacity (``vmem_kb`` of the TPU
profile) the validator is the TPU kernel's VMEM footprint: the A, B and
output blocks (and the scratch accumulator). On a CUDA device
(``hopper=True``) it checks what the Hopper kernel holds in shared
memory: its ring of ``lookahead + 1`` stages, in fp32 each a slice of
A (the pass tile's rows x 64 or 32) and a 64 or 32 x 128 slice of B
(26–204 kB, whatever the tile, since the tile is walked in passes and
slices), in bf16 the wgmma kernel's 64-deep slices of its 64- or
128-row, 128- or 256-column tile (49–193 kB;
:func:`~repro_torch.kernels.matmul.matmul.smem_bytes`); and
``block_k`` must be one of the instantiated chunk depths.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.compilette import Compilette
from repro_torch.core.profiles import TPU_V5E, DeviceProfile, device_smem_kb
from repro_torch.core.tuning_space import Param, Point, TuningSpace
from repro_torch.interop import resolve_device
from repro_torch.kernels.catalog import (
    KernelDef, example_fill, spec_capacity_kb, spec_on_cuda, torch_dtype)
from repro_torch.kernels.matmul.matmul import (
    OPTIONS, build_kernels, matmul_cuda, matmul_plain, smem_bytes, symbol)
from repro_torch.kernels.matmul.ref import matmul_ref

DEFAULT_POINT: Point = {
    "block_m": 128, "block_n": 128, "block_k": 256,
    "unroll": 1, "order": "mn", "scratch": 1, "lookahead": 1,
}


def make_space(
    M: int, N: int, K: int,
    *,
    dtype_bytes: int = 4,
    vmem_kb: int = TPU_V5E.vmem_kb,
    hopper: bool = False,
) -> TuningSpace:
    # block_k options past K are all holes (validator: block_k > K), so a
    # small-K problem would otherwise have an EMPTY space; keep the pow2
    # options that fit and fall back to the exact extent when none do.
    bk_options = tuple(v for v in (128, 256, 512) if v <= K) or (int(K),)
    params = (
        # phase 1 — structural (analogues: coldUF, vectLen, chunking, hotUF)
        Param("block_m", (64, 128, 256, 512), phase=1, switch_rank=0),
        Param("block_n", (128, 256, 512), phase=1, switch_rank=1),
        Param("block_k", bk_options, phase=1, switch_rank=2),
        Param("unroll", (1, 2, 4), phase=1, switch_rank=3),
        # phase 2 — codegen options (IS, SM, pldStride analogues)
        Param("order", ("mn", "nm"), phase=2),
        Param("scratch", (1, 0), phase=2),
        Param("lookahead", (0, 1, 2), phase=2),
    )

    def validator(p: Point) -> bool:
        if p["block_k"] % p["unroll"] != 0:
            return False
        if p["block_m"] > M + 8 or p["block_n"] > N + 128 or p["block_k"] > K:
            return False  # degenerate over-tiling
        if hopper:
            return (p["block_k"] in OPTIONS["block_k"]
                    and smem_bytes(p, dtype_bytes) <= vmem_kb * 1024)
        # VMEM footprint hole (the register-pressure analogue)
        words = (
            p["block_m"] * p["block_k"]
            + p["block_k"] * p["block_n"]
            + p["block_m"] * p["block_n"] * (2 if p["scratch"] else 1)
        )
        return words * dtype_bytes <= vmem_kb * 1024

    def no_leftover(p: Point) -> float:
        # fraction of padded (wasted) grid cells; 0 = leftover-free
        waste = 1.0
        for dim, blk in ((M, p["block_m"]), (N, p["block_n"]), (K, p["block_k"])):
            n = math.ceil(dim / blk)
            waste *= (n * blk) / dim
        return waste - 1.0

    return TuningSpace(params=params, validator=validator, no_leftover=no_leftover)


# --------------------------------------------------------------------- cost
def matmul_cost_model(
    point: Point, spec: dict[str, Any], profile: DeviceProfile
) -> float:
    """Analytical execution-time estimate of a matmul variant (seconds)."""
    M, N, K = spec["M"], spec["N"], spec["K"]
    b = spec.get("dtype_bytes", 4)
    bm, bn, bk = point["block_m"], point["block_n"], point["block_k"]
    unroll, order = point["unroll"], point["order"]
    scratch, lookahead = point["scratch"], point["lookahead"]

    words = bm * bk + bk * bn + bm * bn * (2 if scratch else 1)
    if words * b > profile.vmem_kb * 1024:
        return float("inf")  # late-discovered hole on this device

    n_m, n_n, n_k = math.ceil(M / bm), math.ceil(N / bn), math.ceil(K / bk)
    flops = 2.0 * (n_m * bm) * (n_n * bn) * (n_k * bk)  # padded work counts

    # MXU pipeline efficiency: unrolling supplies independent chains (hotUF);
    # fat (OOO-analogue) cores extract them in hardware.
    if profile.overlap:
        eff_u = max(0.88, unroll / (unroll + 0.35))
    else:
        eff_u = unroll / (unroll + 1.2)
    eff_k = bk / (bk + 64.0)  # per-step MXU drain
    compute_s = flops / (profile.peak_flops * eff_u * eff_k)

    bytes_a = M * K * n_n * b
    bytes_b = K * N * n_m * b
    bytes_c = M * N * (2 * n_k - 1 if not scratch else 1) * b
    mem_s = (bytes_a + bytes_b + bytes_c) / (profile.hbm_gbps * 1e9)

    steps = n_m * n_n * n_k
    # order (IS analogue): the right traversal keeps the streamed operand
    # contiguous; wrong choice pays extra per-step latency.
    good_order = (order == "nm") == (M >= N)
    step_ns = profile.grid_step_overhead_ns * (0.8 if good_order else 1.0)
    overhead_s = steps * step_ns * 1e-9

    t = profile.exec_time_s(compute_s, mem_s, overhead_s)
    if not profile.overlap and lookahead > 0:
        # pldStride analogue: deeper DMA lookahead recovers part of the
        # serialization on lean cores.
        t -= min(compute_s, mem_s) * min(0.35 * lookahead, 0.7)
    return t


# --------------------------------------------------------------- compilette
def _variant(point: Point, device: torch.device, dtype: torch.dtype):
    """The variant serving ``point`` for operands of ``dtype``: the hand
    kernel on CUDA (its instantiation resolved now, so a missing one
    raises here), the plain version on the CPU."""
    pt = dict(point)
    lib = None
    if device.type == "cuda":
        lib = build_kernels(device)
        lib.resolve(symbol(pt, dtype))

    def fn(a, b):
        return matmul_cuda(a, b, pt, lib=lib)

    return fn


def make_matmul_compilette(
    M: int, N: int, K: int,
    *,
    dtype: torch.dtype = torch.float32,
    device: "torch.device | str | None" = None,
    vmem_kb: int | None = None,
) -> Compilette:
    """Compilette over the matmul space at ``M x N x K``.

    The reference's factory, with ``device`` for its ``interpret``: on a
    CUDA ``device`` (the default) the space is sized by the Hopper rule
    against the card's shared memory per block and every variant is the
    hand kernel; on the CPU it keeps the reference's rule and
    ``TPU_V5E.vmem_kb`` (the simulated-core studies' space) and serves
    the plain version. Its cost model is :func:`matmul_cost_model`.
    """
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    if vmem_kb is None:
        vmem_kb = device_smem_kb(dev) if on_cuda else TPU_V5E.vmem_kb
    itemsize = torch.empty((), dtype=dtype).element_size()
    space = make_space(M, N, K, dtype_bytes=itemsize, vmem_kb=vmem_kb, hopper=on_cuda)

    def generate(point: Point, **spec: Any):
        return _variant(point, dev, dtype)

    def cost_model(point: Point, spec: dict[str, Any], profile: DeviceProfile) -> float:
        full = {"M": M, "N": N, "K": K, "dtype_bytes": itemsize}
        full.update(spec)
        return matmul_cost_model(point, full, profile)

    return Compilette("matmul", space, generate, cost_model=cost_model)


# ---------------------------------------------------------- kernel catalog
def _itemsize(spec: dict[str, Any]) -> int:
    return torch.empty((), dtype=torch_dtype(spec.get("dtype", "float32"))).element_size()


def _catalog_space(spec: dict[str, Any]) -> TuningSpace:
    return make_space(
        spec["M"], spec["N"], spec["K"], dtype_bytes=_itemsize(spec),
        vmem_kb=spec_capacity_kb(spec), hopper=spec_on_cuda(spec))


def _catalog_generate(point: Point, spec: dict[str, Any]):
    return _variant(point, resolve_device(spec.get("device")),
                    torch_dtype(spec.get("dtype", "float32")))


def _catalog_cost(point: Point, spec: dict[str, Any], profile) -> float:
    full = {"dtype_bytes": _itemsize(spec)}
    full.update(spec)
    return matmul_cost_model(point, full, profile)


def _extract_spec(a, b, **overrides: Any) -> dict[str, Any]:
    M, K = a.shape
    _, N = b.shape
    return {"M": int(M), "N": int(N), "K": int(K),
            "dtype": str(a.dtype).removeprefix("torch."),
            "device": str(a.device), **overrides}


def _shapes(spec: dict[str, Any]):
    dt = spec.get("dtype", "float32")
    return ((spec["M"], spec["K"]), dt), ((spec["K"], spec["N"]), dt)


def _example_args(spec: dict[str, Any]) -> tuple:
    return tuple(example_fill(s, d, device=spec.get("device"))
                 for s, d in _shapes(spec))


KERNEL = KernelDef(
    name="matmul",
    make_space=_catalog_space,
    generate=_catalog_generate,
    cost_model=_catalog_cost,
    extract_spec=_extract_spec,
    example_args=_example_args,
    default_point=DEFAULT_POINT,
    oracle=matmul_ref,
    # tiled f32 accumulation vs one fused dot: order-of-summation only
    tolerance={"rtol": 1e-3, "atol": 1e-5},
)


__all__ = [
    "DEFAULT_POINT",
    "KERNEL",
    "make_matmul_compilette",
    "make_space",
    "matmul_cost_model",
    "matmul_cuda",
    "matmul_plain",
    "matmul_ref",
]
