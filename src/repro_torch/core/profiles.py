"""Simulated device profiles — the paper's gem5/McPAT study, TPU-ified.

The paper simulates 11 ARM cores: {single,dual,triple}-issue × {IO,OOO} ×
{1..3} VPUs (Table 1/2). The TPU-native analogue varies:

  * ``issue``        — number of scalar/vector issue slots (1–3); scales
                       VPU throughput and per-grid-step control overhead.
  * ``overlap``      — ``False`` = *lean* core (in-order analogue): DMA and
                       compute serialize; ``True`` = *fat* core (OOO
                       analogue): DMA/compute overlap (latency hiding à la
                       dynamic scheduling). Fat cores pay area + energy.
  * ``vpus``         — number of vector (VPU) pipes (1–3); SIMD throughput.
  * ``vmem_kb``      — VMEM size: the register-file/cache analogue that
                       creates holes in the tuning space (block footprints
                       that do not fit are invalid points).

Energy follows a McPAT-flavoured model: E = P_static·t + e_flop·FLOPs +
e_byte·DRAM bytes, with fat cores paying a dynamic-scheduling multiplier on
compute energy and extra static power via area.

These profiles drive the *analytical cost models* of the kernel
compilettes; they are the "simulated platform" of the reproduction. All
numbers are self-consistent fictions in TPU-ish units, not vendor data.

On a CUDA card the capacity term of the tuning spaces (the role
``TPU_V5E.vmem_kb`` plays) is the shared memory one block may use, read
from the device by :func:`device_smem_kb`.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    issue: int              # 1..3 issue width (analogue of SI/DI/TI)
    overlap: bool           # False=lean/in-order, True=fat/out-of-order
    vpus: int               # number of vector pipes
    clock_ghz: float
    vmem_kb: int            # VMEM budget for kernel working sets
    hbm_gbps: float         # HBM bandwidth GB/s
    mxu_tflops: float       # matrix-unit peak (vectorized path), TFLOP/s
    grid_step_overhead_ns: float  # per grid-step control/DMA-issue cost
    area_mm2: float
    static_w: float
    e_flop_pj: float        # dynamic energy per FLOP
    e_byte_pj: float        # dynamic energy per DRAM byte

    @property
    def vpu_gflops(self) -> float:
        """Scalar/vector (non-MXU) path peak, GFLOP/s."""
        # 8 sublanes x 128 lanes x 2 flops per VPU at clock; scaled down to
        # keep the SISD:SIMD ratio paper-like.
        return self.vpus * self.issue * 64.0 * self.clock_ghz

    @property
    def peak_flops(self) -> float:
        return self.mxu_tflops * 1e12

    def exec_time_s(self, compute_s: float, memory_s: float, overhead_s: float) -> float:
        """Lean cores serialize compute and DMA; fat cores overlap them."""
        if self.overlap:
            return max(compute_s, memory_s) + 0.25 * min(compute_s, memory_s) + overhead_s
        return compute_s + memory_s + overhead_s

    def energy_j(self, time_s: float, flops: float, dram_bytes: float) -> float:
        sched_mult = 1.55 if self.overlap else 1.0
        dyn = flops * self.e_flop_pj * 1e-12 * sched_mult
        dyn += dram_bytes * self.e_byte_pj * 1e-12
        return self.static_w * time_s + dyn


def _mk(name: str, issue: int, overlap: bool, vpus: int) -> DeviceProfile:
    clock = {1: 0.7, 2: 0.85, 3: 0.94}[issue]
    vmem = {1: 256, 2: 512, 3: 1024}[issue]
    hbm = {1: 102.0, 2: 205.0, 3: 410.0}[issue]
    mxu = vpus * issue * 1.9 * clock          # TFLOP/s for the MXU path
    # Lean cores expose raw per-step latency; fat cores hide most of it.
    step_ns = (38.0 if not overlap else 14.0) / issue
    core_area = 0.45 * issue * (1.0 + 0.27 * (vpus - 1))
    if overlap:
        core_area *= 1.16  # OOO window/renaming area overhead (paper Fig.6d)
    area = core_area + {1: 1.52, 2: 3.19, 3: 5.88}[issue]
    static = 0.08 * area
    return DeviceProfile(
        name=name,
        issue=issue,
        overlap=overlap,
        vpus=vpus,
        clock_ghz=clock,
        vmem_kb=vmem,
        hbm_gbps=hbm,
        mxu_tflops=mxu,
        grid_step_overhead_ns=step_ns,
        area_mm2=area,
        static_w=static,
        e_flop_pj=0.65,
        e_byte_pj=4.4,
    )


# 11 profiles mirroring the paper's Table 2 (L=lean/in-order, F=fat/OOO).
SI_L1 = _mk("SI-L1", 1, False, 1)
DI_L1 = _mk("DI-L1", 2, False, 1)
DI_L2 = _mk("DI-L2", 2, False, 2)
TI_L1 = _mk("TI-L1", 3, False, 1)
TI_L2 = _mk("TI-L2", 3, False, 2)
TI_L3 = _mk("TI-L3", 3, False, 3)
DI_F1 = _mk("DI-F1", 2, True, 1)
DI_F2 = _mk("DI-F2", 2, True, 2)
TI_F1 = _mk("TI-F1", 3, True, 1)
TI_F2 = _mk("TI-F2", 3, True, 2)
TI_F3 = _mk("TI-F3", 3, True, 3)

ALL_PROFILES: tuple[DeviceProfile, ...] = (
    SI_L1, DI_L1, DI_L2, DI_F1, DI_F2, TI_L1, TI_L2, TI_L3, TI_F1, TI_F2, TI_F3
)

#: lean↔fat pairs with identical configs but scheduling (paper Fig. 6).
EQUIVALENT_PAIRS: tuple[tuple[DeviceProfile, DeviceProfile], ...] = (
    (DI_L1, DI_F1), (DI_L2, DI_F2), (TI_L1, TI_F1), (TI_L2, TI_F2), (TI_L3, TI_F3),
)

#: The "real TPU" target used for roofline terms (v5e-flavoured constants).
TPU_V5E = DeviceProfile(
    name="tpu-v5e",
    issue=3,
    overlap=True,
    vpus=4,
    clock_ghz=0.94,
    vmem_kb=128 * 1024 // 8,   # ~16 MiB usable VMEM expressed in kB
    hbm_gbps=819.0,
    mxu_tflops=197.0,
    grid_step_overhead_ns=6.0,
    area_mm2=0.0,
    static_w=0.0,
    e_flop_pj=0.45,
    e_byte_pj=3.2,
)


def by_name(name: str) -> DeviceProfile:
    for p in ALL_PROFILES + (TPU_V5E,):
        if p.name == name:
            return p
    raise KeyError(name)


def scaled_profile(
    base: DeviceProfile,
    name: str,
    *,
    flops: float = 1.0,
    bandwidth: float = 1.0,
    vmem: float = 1.0,
) -> DeviceProfile:
    """A synthetic neighbour of ``base`` with scaled roofline terms.

    Scales peak math throughput (via ``mxu_tflops``), HBM bandwidth and
    VMEM capacity independently while keeping the microarchitectural
    shape (issue width, overlap, VPU count, clock) fixed — the knob set
    a device *generation* moves, as opposed to a device *family*.
    Transfer-plane grids use this to build unseen-but-similar devices
    around :data:`ALL_PROFILES`.
    """
    if flops <= 0 or bandwidth <= 0 or vmem <= 0:
        raise ValueError(
            f"scale factors must be > 0, got flops={flops}, "
            f"bandwidth={bandwidth}, vmem={vmem}")
    return dataclasses.replace(
        base,
        name=name,
        mxu_tflops=base.mxu_tflops * flops,
        hbm_gbps=base.hbm_gbps * bandwidth,
        vmem_kb=max(1, int(round(base.vmem_kb * vmem))),
    )


def device_smem_kb(device: "torch.device | str | int | None" = None) -> int:
    """Shared memory one block may opt in to on a CUDA ``device``, in kB.

    Read from the device (``shared_memory_per_block_optin``), never typed
    in: it is the capacity the Hopper kernels' tuning spaces are sized
    against (227 kB on an H100).
    """
    props = torch.cuda.get_device_properties(device)
    return int(props.shared_memory_per_block_optin) // 1024
