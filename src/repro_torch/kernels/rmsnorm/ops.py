"""RMSNorm kernel: wrapper + compilette + cost model (memory-bound op).

Mirrors ``repro/kernels/rmsnorm/ops.py``: the same tuning space, cost
model and catalog entry. Variants are the hand kernel
(``rmsnorm.py``, CUDA C++) on a CUDA device and its plain version on the
CPU.

**Capacity rule.** At the reference's capacity (``vmem_kb`` of the TPU
profile) the validator is the TPU kernel's: the whole ``(rows, d)``
block in and out of VMEM, ``2 * rows * d * 4`` bytes. On a CUDA device
(``hopper=True``) it checks what the Hopper kernel holds in shared
memory: a ring of ``lookahead + 1`` row buffers and the weight, each
``d`` elements (:func:`~repro_torch.kernels.rmsnorm.rmsnorm.smem_bytes`;
48 kB at deepseek-7b's d = 4096 in fp32 and ``lookahead`` 1, where the
TPU rule would refuse every point against the H100's 227 kB), whatever
``block_rows``, since a block reduces one staged row at a time.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.profiles import TPU_V5E, DeviceProfile
from repro_torch.core.tuning_space import Param, Point, TuningSpace
from repro_torch.interop import resolve_device
from repro_torch.kernels.catalog import (
    KernelDef, example_fill, spec_capacity_kb, spec_on_cuda, torch_dtype)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm.rmsnorm import (
    build_kernels, rmsnorm_cuda, rmsnorm_plain, smem_bytes, symbol)

DEFAULT_POINT: Point = {"block_rows": 128, "lookahead": 1}


def make_space(N: int, d: int, *, vmem_kb: int = TPU_V5E.vmem_kb,
               hopper: bool = False) -> TuningSpace:
    params = (
        Param("block_rows", (8, 32, 128, 512), phase=1, switch_rank=0),
        Param("lookahead", (0, 1, 2), phase=2),
    )

    def validator(p: Point) -> bool:
        if hopper:
            # fp32 rows: a bound for bfloat16 rows too, which take half
            return smem_bytes(p, d) <= vmem_kb * 1024
        rows = min(p["block_rows"], N)
        return 2 * rows * d * 4 <= vmem_kb * 1024

    def no_leftover(p: Point) -> float:
        rows = min(p["block_rows"], N)
        n = math.ceil(N / rows)
        return (n * rows) / N - 1.0

    return TuningSpace(params=params, validator=validator,
                       no_leftover=no_leftover)


def rmsnorm_cost_model(point: Point, spec: dict[str, Any],
                       profile: DeviceProfile) -> float:
    N, d = spec["N"], spec["d"]
    rows = min(point["block_rows"], N)
    if 2 * rows * d * 4 > profile.vmem_kb * 1024:
        return float("inf")
    flops = 4.0 * N * d
    compute_s = flops / (profile.vpu_gflops * 1e9)
    mem_s = 2.0 * N * d * 4.0 / (profile.hbm_gbps * 1e9)
    steps = math.ceil(N / rows)
    overhead_s = steps * profile.grid_step_overhead_ns * 1e-9
    t = profile.exec_time_s(compute_s, mem_s, overhead_s)
    if not profile.overlap and point["lookahead"] > 0:
        t -= min(compute_s, mem_s) * min(0.35 * point["lookahead"], 0.7)
    return t


def _variant(point: Point, device: torch.device, dtype: torch.dtype):
    """The variant serving ``point``: the hand kernel on CUDA (its
    instantiation resolved now), the plain version on the CPU."""
    pt = dict(point)
    lib = None
    if device.type == "cuda":
        lib = build_kernels(device)
        lib.resolve(symbol(pt, dtype))

    def fn(x, w):
        return rmsnorm_cuda(x, w, pt, lib=lib)

    return fn


# ---------------------------------------------------------- kernel catalog
def _catalog_generate(point: Point, spec: dict[str, Any]):
    return _variant(point, resolve_device(spec.get("device")),
                    torch_dtype(spec.get("dtype", "float32")))


def _extract_spec(x, w, **overrides: Any) -> dict[str, Any]:
    N, d = x.shape
    return {"N": int(N), "d": int(d),
            "dtype": str(x.dtype).removeprefix("torch."),
            "device": str(x.device), **overrides}


def _example_args(spec: dict[str, Any]) -> tuple:
    dt = spec.get("dtype", "float32")
    dev = spec.get("device")
    return (example_fill((spec["N"], spec["d"]), dt, device=dev),
            example_fill((spec["d"],), dt, device=dev))


KERNEL = KernelDef(
    name="rmsnorm",
    make_space=lambda spec: make_space(
        spec["N"], spec["d"], vmem_kb=spec_capacity_kb(spec),
        hopper=spec_on_cuda(spec)),
    generate=_catalog_generate,
    cost_model=rmsnorm_cost_model,
    extract_spec=_extract_spec,
    example_args=_example_args,
    default_point=DEFAULT_POINT,
    oracle=rmsnorm_ref,
    tolerance={"rtol": 1e-3, "atol": 1e-5},
)


__all__ = ["DEFAULT_POINT", "KERNEL", "make_space",
           "rmsnorm_cost_model", "rmsnorm_cuda",
           "rmsnorm_plain", "rmsnorm_ref"]
