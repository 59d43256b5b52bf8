"""Transfer plane: cross-device warm starts ranked by trait similarity.

Mirrors ``repro/core/transfer.py``, unchanged: a ``cuda:`` fingerprint
picks the GPU nominal profile.

The registry warm-starts only on an *exact* device fingerprint, so a
heterogeneous fleet re-explores from cold on every new hardware profile —
exactly the cost the paper's Fig. 5/6 study shows online tuning should
amortize. This module closes that gap:

  * :class:`DeviceTraits` — a quantitative vector describing the device a
    registry entry was tuned on: peak fused-math throughput, memory
    bandwidth, on-chip scratch (VMEM), issue width and whether compute/DMA
    overlap. Derived from a :class:`~repro_torch.core.profiles.DeviceProfile`
    for virtual backends, and from the platform fingerprint plus a
    cost-model probe for real ones. The coordinator attaches it to every
    ``TunedRegistry.put`` at save time.
  * :func:`similarity` — normalized distance over the trait axes mapped
    to ``(0, 1]``: throughput-like axes compare on log-ratio (a 2x faster
    device is as far from 1x as 4x is from 2x), the overlap axis is
    categorical (lean vs fat cores want different code shapes).
  * :func:`transfer_seeds` — on a fingerprint miss, the nearest-
    fingerprint lookup: rank every foreign device's best for the same
    (kernel, specialization) by trait similarity, apply a
    ``min_similarity`` floor, return the top-k. The caller feeds these
    into the search strategy as *transfer seeds* via
    ``SearchStrategy.inject_candidate`` — stripe-exempt like warm seeds,
    but flowing through the normal generate/evaluate/gate/canary path as
    CANDIDATEs. A transfer seed is never a blind incumbent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

from repro_torch.core.persistence import TunedRegistry, _canon
from repro_torch.core.profiles import TPU_V5E, DeviceProfile

#: The axes of a trait vector, in canonical order. ``flops``,
#: ``bandwidth_gbps``, ``vmem_kb`` and ``issue`` are compared on
#: log-ratio; ``overlap`` is categorical (0.0 = lean/in-order,
#: 1.0 = fat/out-of-order).
TRAIT_AXES: tuple[str, ...] = (
    "flops", "bandwidth_gbps", "vmem_kb", "issue", "overlap")

# Distance charged for disagreeing on the categorical overlap axis: a
# lean and a fat core differ architecturally about as much as a 4x
# throughput gap (the paper's IO-vs-OOO split moves the optimum more
# than a clock bump does).
_OVERLAP_DISTANCE = math.log(4.0)


@dataclasses.dataclass(frozen=True)
class DeviceTraits:
    """Quantitative identity of the device a tuned point was found on."""

    flops: float           # peak fused-math throughput, FLOP/s
    bandwidth_gbps: float  # main-memory bandwidth, GB/s
    vmem_kb: float         # on-chip scratch, kB
    issue: float           # issue width
    overlap: float         # 1.0 = compute/DMA overlap, 0.0 = serialized

    def to_dict(self) -> dict[str, float]:
        return {axis: float(getattr(self, axis)) for axis in TRAIT_AXES}

    @classmethod
    def from_dict(cls, d: Any) -> "DeviceTraits | None":
        """Tolerant parse of a persisted trait dict; None unless every
        axis is present, numeric and finite (a registry written by a
        newer layout must degrade to no-transfer, not crash)."""
        if not isinstance(d, Mapping):
            return None
        values: dict[str, float] = {}
        for axis in TRAIT_AXES:
            v = d.get(axis)
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                return None
            values[axis] = float(v)
        return cls(**values)

    @classmethod
    def from_profile(cls, profile: DeviceProfile) -> "DeviceTraits":
        return cls(
            flops=float(profile.peak_flops),
            bandwidth_gbps=float(profile.hbm_gbps),
            vmem_kb=float(profile.vmem_kb),
            issue=float(profile.issue),
            overlap=1.0 if profile.overlap else 0.0,
        )


def similarity(a: DeviceTraits, b: DeviceTraits) -> float:
    """Trait similarity in ``(0, 1]``; 1.0 = identical trait vectors.

    Mean per-axis distance mapped through ``exp(-d)``: throughput-like
    axes contribute ``|ln(a/b)|`` (scale-free), the overlap axis a fixed
    architectural penalty. Symmetric, and monotone in every axis gap.
    """
    d = 0.0
    for axis in ("flops", "bandwidth_gbps", "vmem_kb", "issue"):
        x = max(float(getattr(a, axis)), 1e-12)
        y = max(float(getattr(b, axis)), 1e-12)
        d += abs(math.log(x / y))
    d += _OVERLAP_DISTANCE * abs(a.overlap - b.overlap)
    return math.exp(-d / len(TRAIT_AXES))


# Nominal (profile, traits) per platform fingerprint prefix. Real
# backends have no DeviceProfile; the platform string picks a nominal
# profile and :func:`calibrated_traits` refines its throughput axes
# with a cost-model probe against the observed reference time.
_CPU_NOMINAL = dataclasses.replace(
    TPU_V5E, name="cpu-host", vpus=1, mxu_tflops=0.5,
    hbm_gbps=64.0, vmem_kb=1024, grid_step_overhead_ns=40.0)
_GPU_NOMINAL = dataclasses.replace(
    TPU_V5E, name="gpu-generic", mxu_tflops=90.0, hbm_gbps=900.0,
    vmem_kb=20 * 1024)
_PLATFORM_NOMINALS: tuple[tuple[str, DeviceProfile], ...] = (
    ("tpu", TPU_V5E),
    ("gpu", _GPU_NOMINAL),
    ("cuda", _GPU_NOMINAL),
    ("rocm", _GPU_NOMINAL),
    ("cpu", _CPU_NOMINAL),
)


def traits_from_fingerprint(device: str | None) -> DeviceTraits | None:
    """Best-effort traits for a real device fingerprint.

    The fingerprint's platform prefix (``platform:device_kind:...``)
    selects a nominal profile; unknown platforms yield None (the
    transfer plane then simply stays cold — never a wrong seed ranked
    by made-up numbers).
    """
    if not device:
        return None
    platform = str(device).split(":", 1)[0].strip().lower()
    for prefix, profile in _PLATFORM_NOMINALS:
        if platform.startswith(prefix):
            return DeviceTraits.from_profile(profile)
    return None


def device_traits(
    compilette: Any = None,
    device: str | None = None,
    profile: DeviceProfile | None = None,
) -> DeviceTraits | None:
    """Traits of the device ``compilette`` is being tuned on.

    Precedence: an explicit ``profile``, then the compilette's virtual
    marker (``compilette.virtual == (clock, profile)`` on simulated
    backends), then the platform fingerprint table. None when nothing
    is known — callers must treat that as transfer-disabled.
    """
    if profile is not None:
        return DeviceTraits.from_profile(profile)
    virtual = getattr(compilette, "virtual", None)
    if (isinstance(virtual, tuple) and len(virtual) == 2
            and virtual[1] is not None):
        return DeviceTraits.from_profile(virtual[1])
    return traits_from_fingerprint(device)


def calibrated_traits(
    traits: DeviceTraits | None,
    compilette: Any,
    specialization: Mapping[str, Any] | None,
    observed_score_s: float | None,
    device: str | None = None,
) -> DeviceTraits | None:
    """Refine fingerprint-table traits with one cost-model probe.

    Two real devices sharing a platform string (e.g. two ``cpu`` hosts
    of very different silicon) must not rank as identical. When the
    compilette carries a cost model, the ratio of its predicted
    reference time under the nominal platform profile to the *observed*
    reference time estimates how much faster/slower this device is than
    nominal; the throughput axes are scaled by it (clamped to 8x either
    way — a probe is a probe, not a benchmark). Virtual backends pass
    through unchanged: their traits already come from the exact profile.
    """
    if traits is None:
        return None
    virtual = getattr(compilette, "virtual", None)
    if isinstance(virtual, tuple) and len(virtual) == 2:
        return traits
    model = getattr(compilette, "cost_model", None)
    if (model is None or observed_score_s is None
            or not isinstance(observed_score_s, (int, float))
            or not math.isfinite(observed_score_s)
            or observed_score_s <= 0.0):
        return traits
    platform = str(device or "").split(":", 1)[0].strip().lower()
    profile = next(
        (nominal for prefix, nominal in _PLATFORM_NOMINALS
         if platform.startswith(prefix)), None)
    if profile is None:
        return traits
    try:
        predicted = float(model(
            dict(compilette.space.default_point()),
            dict(specialization or {}), profile))
    except Exception:
        return traits
    if not math.isfinite(predicted) or predicted <= 0.0:
        return traits
    ratio = min(max(predicted / float(observed_score_s), 1.0 / 8.0), 8.0)
    return dataclasses.replace(
        traits,
        flops=traits.flops * ratio,
        bandwidth_gbps=traits.bandwidth_gbps * ratio,
    )


@dataclasses.dataclass(frozen=True)
class TransferSeed:
    """One foreign best proposed as a transfer seed (a CANDIDATE)."""

    point: dict[str, Any]
    score_s: float         # the score on the FOREIGN device, not here
    device: str            # foreign registry device key
    similarity: float


def transfer_seeds(
    registry: TunedRegistry,
    kernel: str,
    specialization: dict[str, Any],
    device: str,
    traits: DeviceTraits | None,
    *,
    top_k: int = 3,
    min_similarity: float = 0.75,
) -> list[TransferSeed]:
    """Nearest-fingerprint lookup: top-k foreign bests by trait similarity.

    Scans every registry entry for the same (kernel, specialization)
    under a *different* device fingerprint, ranks the ones carrying
    traits by :func:`similarity` against the local traits, drops rows
    below ``min_similarity``, dedups by point (keeping the most similar
    donor) and returns at most ``top_k`` seeds — most similar first,
    deterministic under ties. Points condemned under ANY device key
    never surface (a seed that failed one device's oracle is blocked
    fleet-wide, not just where it failed), and the caller's explorer
    re-checks its local quarantine on injection.
    """
    if traits is None or top_k <= 0:
        return []
    banned = {_canon(p) for p in registry.fleet_quarantined_points(
        kernel, specialization)}
    ranked: list[TransferSeed] = []
    for dev, entry in registry.cross_device_entries(
            kernel, specialization, exclude_device=device):
        foreign = DeviceTraits.from_dict(entry.get("traits"))
        if foreign is None:
            continue
        sim = similarity(traits, foreign)
        if sim < min_similarity:
            continue
        point = entry.get("point")
        if not isinstance(point, dict) or _canon(point) in banned:
            continue
        ranked.append(TransferSeed(
            point=dict(point), score_s=float(entry["score_s"]),
            device=str(dev), similarity=sim))
    ranked.sort(key=lambda s: (-s.similarity, s.score_s,
                               _canon(s.point), s.device))
    seen: set[str] = set()
    out: list[TransferSeed] = []
    for seed in ranked:
        pk = _canon(seed.point)
        if pk in seen:
            continue
        seen.add(pk)
        out.append(seed)
        if len(out) >= top_k:
            break
    return out
