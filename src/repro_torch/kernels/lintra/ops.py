"""Lintra kernel: compilettes, wrappers, cost model (memory-bound study).

Mirrors ``repro/kernels/lintra/ops.py``. Specialized run-time constants
(paper §4.3): the number of bands and the image width. On a CUDA device
every variant is the hand-written Triton kernel (``lintra.py``),
compiled for the point when it is generated; on the CPU,
``generate_torch_variant`` is the eager mirror of the reference's
``generate_jnp_variant``. The cost model serves the simulated profiles,
unchanged.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.compilette import Compilette
from repro_torch.core.profiles import TPU_V5E, DeviceProfile, device_smem_kb
from repro_torch.core.tuning_space import Param, Point, TuningSpace
from repro_torch.interop import resolve_device
from repro_torch.kernels.catalog import KernelDef, example_fill, spec_capacity_kb
from repro_torch.kernels.lintra.lintra import (
    LintraKernel, default_kernel, lintra_plain, lintra_triton)
from repro_torch.kernels.lintra.ref import lintra_ref, lintra_ref_folded

DEFAULT_POINT: Point = {
    "block_h": 64, "block_w": 256, "unroll": 1,
    "vectorize": 1, "order": "hw", "scratch": 1, "lookahead": 1,
}


def make_space(
    H: int, W: int, bands: int,
    *,
    vmem_kb: int = TPU_V5E.vmem_kb,
) -> TuningSpace:
    WB = W * bands
    params = (
        Param("block_h", (8, 32, 64, 128), phase=1, switch_rank=0),     # coldUF
        Param("block_w", (128, 256, 512, 1024), phase=1, switch_rank=1),  # vectLen
        Param("unroll", (1, 2, 4), phase=1, switch_rank=2),             # hotUF
        Param("vectorize", (1, 0), phase=1, switch_rank=3),             # VE
        Param("order", ("hw", "wh"), phase=2),                          # IS
        Param("scratch", (1, 0), phase=2),                              # SM
        Param("lookahead", (0, 1, 2), phase=2),                         # pld
    )

    def validator(p: Point) -> bool:
        if p["block_h"] % p["unroll"] != 0:
            return False
        if p["block_h"] > H or min(p["block_w"], WB) > WB:
            return False
        words = 2 * p["block_h"] * min(p["block_w"], WB) + 2 * min(p["block_w"], WB)
        return words * 4 <= vmem_kb * 1024

    def no_leftover(p: Point) -> float:
        waste = 1.0
        for dim, blk in ((H, p["block_h"]), (WB, min(p["block_w"], WB))):
            n = math.ceil(dim / blk)
            waste *= (n * blk) / dim
        return waste - 1.0

    return TuningSpace(params=params, validator=validator, no_leftover=no_leftover)


# ----------------------------------------------------------- torch variants
def generate_torch_variant(point: Point, *, bands: int, width: int):
    """Specialized eager variant: bands and width are closed-over consts.

    The eager mirror of the reference's ``generate_jnp_variant``. The
    paper's key observation for this kernel: the reference C code
    *reloads the run-time-constant a/b vectors every loop iteration*, while
    the compilette inlines them — most of the observed speedup.
    """
    unroll = point["unroll"]
    vect = bool(point["vectorize"])
    n_strips = unroll

    def fn(x, a, b):
        # x: (H, W, bands) fp32
        H = x.shape[0]
        if vect:
            xs = x.reshape(H, width * bands)
            af = a.repeat(width)
            bf = b.repeat(width)
            # hotUF: independent row strips
            strip = max(H // n_strips, 1)
            outs = []
            for u in range(n_strips):
                lo = u * strip
                hi = H if u == n_strips - 1 else (u + 1) * strip
                outs.append(xs[lo:hi] * af[None, :] + bf[None, :])
            y = torch.cat(outs, dim=0) if n_strips > 1 else outs[0]
            return y.reshape(H, width, bands)
        # SISD path: per-band loop (the paper's scalar code shape)
        cols = [x[:, :, k] * a[k] + b[k] for k in range(bands)]
        return torch.stack(cols, dim=-1)

    return fn


# --------------------------------------------------------------------- cost
def lintra_cost_model(
    point: Point, spec: dict[str, Any], profile: DeviceProfile
) -> float:
    H, W, bands = spec["H"], spec["W"], spec["bands"]
    WB = W * bands
    bh, bw = point["block_h"], min(point["block_w"], WB)
    unroll, vect = point["unroll"], bool(point["vectorize"])
    lookahead = point["lookahead"]

    words = 2 * bh * bw + 2 * bw
    if words * 4 > profile.vmem_kb * 1024:
        return float("inf")

    flops = 2.0 * H * WB
    if vect:
        eff_u = max(0.85, unroll / (unroll + 0.3)) if profile.overlap else unroll / (unroll + 1.0)
        compute_s = flops / (profile.vpu_gflops * 1e9 * eff_u)
    else:
        # scalar per-band path: an order of magnitude off the vector pipe
        compute_s = flops / (profile.vpu_gflops * 1e9 * 0.12)

    bytes_total = 2.0 * H * WB * 4.0   # read once + write once: streaming
    mem_s = bytes_total / (profile.hbm_gbps * 1e9)

    steps = math.ceil(H / bh) * math.ceil(WB / bw)
    good_order = (point["order"] == "hw") == (H >= WB / 128)
    overhead_s = steps * profile.grid_step_overhead_ns * (0.8 if good_order else 1.0) * 1e-9

    t = profile.exec_time_s(compute_s, mem_s, overhead_s)
    if not profile.overlap and lookahead > 0:
        t -= min(compute_s, mem_s) * min(0.35 * lookahead, 0.7)
    return t


# --------------------------------------------------------------- compilette
def _variant(point: Point, bands: int, width: int, device: torch.device,
             kernel: LintraKernel | None = None):
    """The variant serving ``point``: on CUDA the Triton binary, compiled
    now (a compile error raises here); on the CPU the eager mirror."""
    if device.type == "cuda":
        kernel = kernel or default_kernel()
        kernel.compile(point, bands, width * bands, torch.float32, device)
        pt = dict(point)

        def fn(x, a, b):
            H = x.shape[0]
            y = lintra_triton(x.reshape(H, width * bands), a, b, pt,
                              kernel=kernel)
            return y.reshape(H, width, bands)

        return fn
    return generate_torch_variant(point, bands=bands, width=width)


def make_lintra_compilette(
    H: int, W: int, bands: int,
    *,
    device: "torch.device | str | None" = None,
    vmem_kb: int | None = None,
) -> Compilette:
    """Compilette over the lintra space at ``H x W x bands``.

    On a CUDA ``device`` (the default) the capacity is the card's shared
    memory per block and every variant is the Triton kernel, compiled by a
    :class:`LintraKernel` of this compilette's own, so its generation cost
    is paid here; on the CPU the space keeps ``TPU_V5E.vmem_kb`` and the
    variants are eager mirrors.
    """
    dev = resolve_device(device)
    if vmem_kb is None:
        vmem_kb = device_smem_kb(dev) if dev.type == "cuda" else TPU_V5E.vmem_kb
    space = make_space(H, W, bands, vmem_kb=vmem_kb)
    kernel = LintraKernel() if dev.type == "cuda" else None

    def generate(point: Point, **spec: Any):
        return _variant(point, spec.get("bands", bands), spec.get("width", W),
                        dev, kernel)

    def cost_model(point: Point, spec: dict[str, Any], profile: DeviceProfile) -> float:
        full = {"H": H, "W": W, "bands": bands}
        full.update(spec)
        return lintra_cost_model(point, full, profile)

    return Compilette("lintra", space, generate, cost_model=cost_model)


def reference_sisd(bands: int, width: int):
    """Reference that RELOADS a/b per row (the paper's C-code behaviour)."""
    def fn(x, a, b):
        rows = []
        for k in range(bands):
            # reload (re-broadcast) constants per band, scalar-ish path
            rows.append(x[:, :, k] * a[k] + b[k])
        return torch.stack(rows, dim=-1)
    return fn


def reference_simd(bands: int, width: int):
    """Hand-vectorized reference (single fused broadcast op)."""
    def fn(x, a, b):
        return lintra_ref(x, a, b)
    return fn


# ---------------------------------------------------------- kernel catalog
def _catalog_generate(point: Point, spec: dict[str, Any]):
    return _variant(point, spec["bands"], spec["W"],
                    resolve_device(spec.get("device")))


def _extract_spec(x, a, b, **overrides: Any) -> dict[str, Any]:
    H, W, bands = x.shape
    return {"H": int(H), "W": int(W), "bands": int(bands),
            "dtype": str(x.dtype).removeprefix("torch."),
            "device": str(x.device), **overrides}


def _shapes(spec: dict[str, Any]):
    dt = spec.get("dtype", "float32")
    return (((spec["H"], spec["W"], spec["bands"]), dt),
            ((spec["bands"],), dt), ((spec["bands"],), dt))


def _example_args(spec: dict[str, Any]) -> tuple:
    return tuple(example_fill(s, d, device=spec.get("device"))
                 for s, d in _shapes(spec))


KERNEL = KernelDef(
    name="lintra",
    make_space=lambda spec: make_space(
        spec["H"], spec["W"], spec["bands"], vmem_kb=spec_capacity_kb(spec)),
    generate=_catalog_generate,
    cost_model=lintra_cost_model,
    extract_spec=_extract_spec,
    example_args=_example_args,
    default_point=DEFAULT_POINT,
    oracle=lintra_ref,
    # a single fused multiply-add per element: no accumulation at all
    tolerance={"rtol": 1e-5, "atol": 1e-7},
    # each CUDA variant is a Triton binary compiled when it is generated
    process_compile=True,
)


__all__ = [
    "DEFAULT_POINT",
    "KERNEL",
    "make_space",
    "make_lintra_compilette",
    "generate_torch_variant",
    "lintra_cost_model",
    "lintra_ref",
    "lintra_ref_folded",
    "lintra_plain",
    "lintra_triton",
    "reference_sisd",
    "reference_simd",
]
