"""Euclidean-distance kernel: compilettes, wrappers, cost model.

Mirrors ``repro/kernels/euclid/ops.py``. One tuning space, two variant
backends chosen by device:

  * CUDA — the hand-written Hopper kernel (``euclid.py``, CUDA C++): one
    template instantiation per phase-1 point, resolved at generation.
  * CPU  — ``euclid_plain``, the kernel's function in plain PyTorch
    (chunk for chunk and partial for partial what the CUDA kernel and
    ``euclid_pallas`` compute); the wrappers' CPU branch calls it too.

The analytical cost model drives the 11 simulated device profiles,
unchanged.

**Capacity rule.** At the reference's capacity (``vmem_kb`` of the TPU
profile) the validator is the TPU kernel's VMEM footprint: the x, c and
output blocks (the scratch accumulator, and for ``vectorize=0`` the diff
cube). On a CUDA device (``hopper=True``) it checks what the Hopper
kernel holds in shared memory: its ring of ``lookahead + 1`` stages, each
a slice of the pass tile's x and c rows (:func:`~repro_torch.kernels.
euclid.euclid.smem_bytes`, 7.5–153 kB), whatever the tile, since the tile
is walked in passes and slices.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch

from repro_torch.core.compilette import Compilette
from repro_torch.core.profiles import TPU_V5E, DeviceProfile, device_smem_kb
from repro_torch.core.tuning_space import Param, Point, TuningSpace
from repro_torch.interop import resolve_device
from repro_torch.kernels.catalog import (
    KernelDef, example_fill, spec_capacity_kb, spec_on_cuda)
from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels.euclid.euclid import (
    PHASE1, euclid_cuda, euclid_plain, load_library, smem_bytes, symbol)
from repro_torch.kernels.euclid.ref import euclid_ref

DEFAULT_POINT: Point = {
    "block_n": 128, "block_m": 64, "block_d": 32, "unroll": 1,
    "vectorize": 1, "order": "nm", "scratch": 1, "lookahead": 1,
}


def make_space(
    N: int, M: int, D: int,
    *,
    vmem_kb: int = TPU_V5E.vmem_kb,
    hopper: bool = False,
) -> TuningSpace:
    params = (
        Param("block_n", (64, 128, 256), phase=1, switch_rank=0),   # coldUF
        Param("block_m", (32, 64, 128), phase=1, switch_rank=1),
        Param("block_d", (16, 32, 64, 128), phase=1, switch_rank=2),  # vectLen
        Param("unroll", (1, 2, 4), phase=1, switch_rank=3),          # hotUF
        Param("vectorize", (1, 0), phase=1, switch_rank=4),          # VE
        Param("order", ("nm", "mn"), phase=2),                       # IS
        Param("scratch", (1, 0), phase=2),                           # SM
        Param("lookahead", (0, 1, 2), phase=2),                      # pld
    )

    def validator(p: Point) -> bool:
        bd = min(p["block_d"], D)
        if bd % p["unroll"] != 0:
            return False
        if p["block_d"] > D:
            return False           # over-tiling the specialized dimension
        if p["block_n"] > N or p["block_m"] > M:
            return False
        if hopper:
            return smem_bytes(p) <= vmem_kb * 1024
        words = p["block_n"] * bd + p["block_m"] * bd + p["block_n"] * p["block_m"]
        if p["scratch"]:
            words += p["block_n"] * p["block_m"]
        if not p["vectorize"]:
            # VPU path materializes the (bn, bm, sub) diff cube in VMEM —
            # the register-pressure hole of the paper's SISD variants.
            words += p["block_n"] * p["block_m"] * (bd // p["unroll"])
        return words * 4 <= vmem_kb * 1024

    def no_leftover(p: Point) -> float:
        waste = 1.0
        for dim, blk in ((N, p["block_n"]), (M, p["block_m"]), (D, min(p["block_d"], D))):
            n = math.ceil(dim / blk)
            waste *= (n * blk) / dim
        return waste - 1.0

    return TuningSpace(params=params, validator=validator, no_leftover=no_leftover)


# ------------------------------------------------------------ hand kernels
@functools.lru_cache(maxsize=None)
def kernel_points(vmem_kb: int) -> tuple[tuple[int, ...], ...]:
    """Phase-1 tuples the card's space (the Hopper rule at capacity
    ``vmem_kb``) admits for any shape: one CUDA instantiation each (at
    most 3*3*4*3*2 = 216). Cached per capacity: the wrapper resolves its
    library on every call."""
    # at a shape larger than every block, only the capacity makes holes
    space = make_space(1 << 20, 1 << 20, 1 << 20, vmem_kb=vmem_kb, hopper=True)
    return tuple(sorted({tuple(p[k] for k in PHASE1) for p in space.iter_valid()}))


def build_kernels(device: "torch.device | str | None" = None) -> KernelLibrary:
    """Build (once) and load the instantiations of the card's tuning space.

    The capacity is the shared memory one block may use on ``device``.
    This is set-up: the first call runs nvcc (its seconds are in
    ``.build_s``) and loads every kernel into the device's context (its
    seconds in ``.load_s``): CUDA would otherwise load each kernel at its
    first launch, which online tuning would pay for every variant it
    explores. Later calls return the loaded library. (A second card in
    the same process loads its kernels lazily, as CUDA does by default.)
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the euclid kernel builds for a CUDA device, not {dev}")
    lib = load_library(kernel_points(device_smem_kb(dev)))
    if lib.load_s is None:
        with torch.cuda.device(dev):
            lib.load_all("_load")
    return lib


# --------------------------------------------------------------------- cost
def euclid_cost_model(
    point: Point, spec: dict[str, Any], profile: DeviceProfile
) -> float:
    N, M, D = spec["N"], spec["M"], spec["D"]
    bn, bm = point["block_n"], point["block_m"]
    bd = min(point["block_d"], D)
    unroll, vect = point["unroll"], bool(point["vectorize"])
    scratch, lookahead = point["scratch"], point["lookahead"]

    words = bn * bd + bm * bd + bn * bm + (bn * bm if scratch else 0)
    if not vect:
        words += bn * bm * (bd // unroll)
    if words * 4 > profile.vmem_kb * 1024:
        return float("inf")

    n_n, n_m, n_d = math.ceil(N / bn), math.ceil(M / bm), math.ceil(D / bd)
    if vect:
        flops = 2.0 * N * M * D + 2.0 * (N + M) * D
        if profile.overlap:
            eff_u = max(0.88, unroll / (unroll + 0.35))
        else:
            eff_u = unroll / (unroll + 1.2)
        eff_k = bd / (bd + 64.0)
        compute_s = flops / (profile.peak_flops * eff_u * eff_k)
    else:
        flops = 3.0 * N * M * D
        # VPU path: lean single-VPU cores stall badly without unrolling
        # (the paper's non-pipelined VFP story on the Cortex-A8).
        if profile.overlap:
            eff_u = max(0.80, unroll / (unroll + 0.5))
        else:
            eff_u = unroll / (unroll + 2.0)
        compute_s = flops / (profile.vpu_gflops * 1e9 * eff_u)

    bytes_total = (N * D * n_m + M * D * n_n + N * M) * 4.0
    mem_s = bytes_total / (profile.hbm_gbps * 1e9)

    steps = n_n * n_m * n_d
    good_order = (point["order"] == "nm") == (N >= M)
    overhead_s = steps * profile.grid_step_overhead_ns * (0.8 if good_order else 1.0) * 1e-9

    t = profile.exec_time_s(compute_s, mem_s, overhead_s)
    if not profile.overlap and lookahead > 0:
        t -= min(compute_s, mem_s) * min(0.35 * lookahead, 0.7)
    return t


def euclid_flops(N: int, M: int, D: int, vectorize: bool = True) -> float:
    return (2.0 if vectorize else 3.0) * N * M * D


# --------------------------------------------------------------- compilette
def _variant(point: Point, device: torch.device):
    """The variant serving ``point``: the hand kernel on CUDA (its
    instantiation resolved now, so a missing one raises here), the plain
    version on the CPU (``euclid_cuda`` takes it for CPU tensors)."""
    pt = dict(point)
    lib = None
    if device.type == "cuda":
        lib = build_kernels(device)
        lib.resolve(symbol(pt))

    def fn(x, c):
        return euclid_cuda(x, c, pt, lib=lib)

    return fn


def make_euclid_compilette(
    N: int, M: int, D: int,
    *,
    device: "torch.device | str | None" = None,
    vmem_kb: int | None = None,
) -> Compilette:
    """Compilette over the euclid space at ``N x M x D``.

    On a CUDA ``device`` (the default) the space is sized by the Hopper
    rule against the card's shared memory per block and every variant is
    the hand kernel; on the CPU it keeps the reference's rule and
    ``TPU_V5E.vmem_kb`` and serves the plain version.
    """
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    if vmem_kb is None:
        vmem_kb = device_smem_kb(dev) if on_cuda else TPU_V5E.vmem_kb
    space = make_space(N, M, D, vmem_kb=vmem_kb, hopper=on_cuda)

    def generate(point: Point, **spec: Any):
        return _variant(point, dev)

    def cost_model(point: Point, spec: dict[str, Any], profile: DeviceProfile) -> float:
        full = {"N": N, "M": M, "D": D}
        full.update(spec)
        return euclid_cost_model(point, full, profile)

    return Compilette("euclid", space, generate, cost_model=cost_model)


# ------------------------------------------------------------- references
def reference_sisd(dim: int):
    """The 'compiler default' scalar reference (paper's PARSEC C code)."""
    def fn(x, c):
        return euclid_ref(x, c)
    return fn


def reference_simd(dim: int):
    """Hand-vectorized reference (paper's PARVEC NEON code analogue).

    Its product is one fp32 matrix multiply (cuBLAS on the card): callers
    keep ``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default.
    """
    def fn(x, c):
        x = x.to(torch.float32)
        c = c.to(torch.float32)
        xx = torch.sum(x * x, dim=-1, keepdim=True)
        cc = torch.sum(c * c, dim=-1, keepdim=True).T
        return xx + cc - 2.0 * (x @ c.T)
    return fn


# ---------------------------------------------------------- kernel catalog
def _catalog_generate(point: Point, spec: dict[str, Any]):
    return _variant(point, resolve_device(spec.get("device")))


def _extract_spec(x, c, **overrides: Any) -> dict[str, Any]:
    N, D = x.shape
    M, _ = c.shape
    return {"N": int(N), "M": int(M), "D": int(D),
            "dtype": str(x.dtype).removeprefix("torch."),
            "device": str(x.device), **overrides}


def _shapes(spec: dict[str, Any]):
    dt = spec.get("dtype", "float32")
    return (((spec["N"], spec["D"]), dt), ((spec["M"], spec["D"]), dt))


def _example_args(spec: dict[str, Any]) -> tuple:
    # non-constant fill: with identical rows every distance is exactly 0
    # and the variant gate's oracle comparison can't see corruption
    return tuple(example_fill(s, d, device=spec.get("device"))
                 for s, d in _shapes(spec))


KERNEL = KernelDef(
    name="euclid",
    make_space=lambda spec: make_space(
        spec["N"], spec["M"], spec["D"], vmem_kb=spec_capacity_kb(spec),
        hopper=spec_on_cuda(spec)),
    generate=_catalog_generate,
    cost_model=euclid_cost_model,
    extract_spec=_extract_spec,
    example_args=_example_args,
    default_point=DEFAULT_POINT,
    oracle=euclid_ref,
    # chunked/unrolled f32 accumulation vs the naive single-axis sum
    tolerance={"rtol": 1e-3, "atol": 1e-5},
)


__all__ = [
    "DEFAULT_POINT",
    "KERNEL",
    "build_kernels",
    "kernel_points",
    "make_space",
    "make_euclid_compilette",
    "euclid_cost_model",
    "euclid_flops",
    "euclid_ref",
    "euclid_cuda",
    "euclid_plain",
    "reference_sisd",
    "reference_simd",
]
