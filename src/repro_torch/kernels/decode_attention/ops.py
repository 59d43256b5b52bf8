"""Decode-attention (flash-decoding) catalog kernel.

Mirrors ``repro/kernels/decode_attention/ops.py``: the same space (its
validator too, which at deepseek-7b's B = 4, Hk = 32, Dh = 128 refuses
every ``k_chunk`` even at the TPU's capacity), cost model and catalog
entry. Variants are the plain PyTorch
:func:`repro_torch.kernels.attention.ops.decode_attention` per
``k_chunk`` on any device: the reference's is a jnp scan, not a Pallas
kernel, so no hand kernel is owed (a split-KV kernel is later work).

The serving decode path reads the WHOLE KV cache for every generated
token, scanning it in ``k_chunk``-sized blocks (online softmax,
above). Beside the *program*-level tuning of that chunk (the
``serve_decode`` step-program compilette), this ``KernelDef`` makes the
kernel itself a plane-managed unit, so the KV-chunk tunes **per cache-length bucket** —
the run-time constant that actually decides the best chunk — with its
own search strategy, registry warm-start key and generation-cache lines.

The spec keys on the allocated cache extent ``S`` (registration sites
pre-bucket it, e.g. serve's pow2 ``max_len`` bucket); the per-token
filled length stays a runtime argument, so one compiled variant serves
every step of a request.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.profiles import TPU_V5E, DeviceProfile
from repro_torch.core.tuning_space import (
    Param,
    Point,
    TuningSpace,
    clamped_options,
)
from repro_torch.kernels.attention.ops import decode_attention
from repro_torch.kernels.catalog import KernelDef, example_fill, spec_capacity_kb
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

DEFAULT_POINT: Point = {"k_chunk": 512}

K_CHUNK_OPTIONS = (128, 256, 512, 1024, 4096)


def make_space(
    S: int, B: int, H: int, Hk: int, Dh: int,
    *,
    vmem_kb: int = TPU_V5E.vmem_kb,
) -> TuningSpace:
    params = (
        Param("k_chunk", clamped_options(K_CHUNK_OPTIONS, S), phase=1),
    )

    def _words(kc: int) -> int:
        # live working set of one scan step: a K and a V chunk across
        # batch and KV heads, the score block, and the running acc
        return 2 * B * kc * Hk * Dh + B * H * kc + B * H * Dh

    def validator(p: Point) -> bool:
        return _words(min(p["k_chunk"], S)) * 4 <= vmem_kb * 1024

    def no_leftover(p: Point) -> float:
        kc = min(p["k_chunk"], S)
        n = math.ceil(S / kc)
        return (n * kc) / S - 1.0

    return TuningSpace(params=params, validator=validator,
                       no_leftover=no_leftover)


def decode_attention_cost_model(
    point: Point, spec: dict[str, Any], profile: DeviceProfile
) -> float:
    B, S, H, Hk, Dh = (spec["B"], spec["S"], spec["H"], spec["Hk"],
                       spec["Dh"])
    kc = min(point["k_chunk"], S)
    words = 2 * B * kc * Hk * Dh + B * H * kc + B * H * Dh
    if words * 4 > profile.vmem_kb * 1024:
        return float("inf")
    flops = 4.0 * B * H * S * Dh              # qk scores + pv accumulate
    eff = kc / (kc + 256.0)                   # short chunks waste issue slots
    compute_s = flops / (profile.peak_flops * eff)
    # memory-bound by construction: the whole KV cache streams once per
    # decoded token (2 bytes/elem), q/o traffic is negligible beside it
    bytes_total = (2.0 * B * S * Hk * Dh + 2.0 * B * H * Dh) * 2.0
    mem_s = bytes_total / (profile.hbm_gbps * 1e9)
    steps = math.ceil(S / kc)
    overhead_s = steps * profile.grid_step_overhead_ns * 1e-9
    return profile.exec_time_s(compute_s, mem_s, overhead_s)


# ---------------------------------------------------------- kernel catalog
def _catalog_generate(point: Point, spec: dict[str, Any]):
    kc = int(point["k_chunk"])

    def fn(q, k, v, length):
        return decode_attention(q, k, v, length=length, k_chunk=kc)

    return fn


def _extract_spec(q, k, v, length=None, **overrides: Any) -> dict[str, Any]:
    del length  # runtime argument, not a spec constant
    B, _, H, Dh = q.shape
    _, S, Hk, _ = k.shape
    return {"B": int(B), "S": int(S), "H": int(H), "Hk": int(Hk),
            "Dh": int(Dh), "dtype": str(q.dtype).removeprefix("torch."),
            "device": str(q.device), **overrides}


def _shapes(spec: dict[str, Any]):
    dt = spec.get("dtype", "float32")
    q = (spec["B"], 1, spec["H"], spec["Dh"])
    kv = (spec["B"], spec["S"], spec["Hk"], spec["Dh"])
    return ((q, dt), (kv, dt), (kv, dt))


def _example_args(spec: dict[str, Any]) -> tuple:
    dev = spec.get("device")
    arrays = tuple(example_fill(s, d, scale=0.1, device=dev)
                   for s, d in _shapes(spec))
    return arrays + (torch.tensor(spec["S"], dtype=torch.int32,
                                  device=arrays[0].device),)


KERNEL = KernelDef(
    name="decode_attention",
    make_space=lambda spec: make_space(
        spec["S"], spec["B"], spec["H"], spec["Hk"], spec["Dh"],
        vmem_kb=spec_capacity_kb(spec)),
    generate=_catalog_generate,
    cost_model=decode_attention_cost_model,
    extract_spec=_extract_spec,
    example_args=_example_args,
    default_point=DEFAULT_POINT,
    oracle=decode_attention_ref,
    # online-softmax accumulation vs the naive full softmax: f32 math,
    # but the rescaling path reorders every sum
    tolerance={"rtol": 2e-3, "atol": 1e-5},
)


__all__ = [
    "DEFAULT_POINT",
    "KERNEL",
    "K_CHUNK_OPTIONS",
    "make_space",
    "decode_attention_cost_model",
]
