"""Roofline terms of a traced step, with the H100's constants.

Mirrors ``repro/distributed/roofline.py``. Three terms per (arch x shape
x mesh), all in seconds:

  compute    = FLOPs per device / peak FLOP rate
  memory     = HBM bytes per device / HBM bandwidth
  collective = ring-model link bytes per device / link bandwidth

FLOPs, bytes and link bytes come from the per-device graph walker
(:mod:`repro_torch.distributed.hlo_analysis`); ``collective_stats``
reads its collective nodes.

The constants are an NVIDIA H100 80GB HBM3 SXM's at 700 W, from NVIDIA's
H100 Tensor Core GPU datasheet. The link term reads every collective as
NVLink traffic; a ``model`` axis of 16 spans two nodes of 8, where the
network gives a GPU far less (InfiniBand NDR, about 50 GB/s each), so on
such a mesh the collective term is a lower bound.
"""

from __future__ import annotations

import dataclasses
from typing import Any

PEAK_FLOPS = 989.4e12     # dense bf16 tensor-core FLOP/s (datasheet, SXM)
PEAK_FLOPS_FP32 = 67e12   # fp32 FLOP/s, non-tensor (datasheet, SXM)
HBM_BW = 3.35e12          # HBM3 bytes/s (datasheet, SXM)
LINK_BW = 450e9           # NVLink 4 bytes/s per direction per GPU (900 GB/s total)


@dataclasses.dataclass
class CollectiveStats:
    per_op_bytes: dict[str, float]
    link_bytes: float          # ring-model bytes crossing one device's links
    n_ops: dict[str, int]


def collective_stats(gm) -> CollectiveStats:
    """The ring-model traffic of ``gm``'s collective nodes, by kind."""
    from repro_torch.distributed.hlo_analysis import collective_nodes, link_bytes

    per_op: dict[str, float] = {}
    n_ops: dict[str, int] = {}
    total = 0.0
    for kind, out_bytes, g in collective_nodes(gm):
        traffic = link_bytes(kind, out_bytes, g)
        per_op[kind] = per_op.get(kind, 0.0) + traffic
        n_ops[kind] = n_ops.get(kind, 0) + 1
        total += traffic
    return CollectiveStats(per_op_bytes=per_op, link_bytes=total, n_ops=n_ops)


@dataclasses.dataclass
class Roofline:
    flops: float               # per device
    bytes_hbm: float           # per device
    bytes_link: float          # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    model_flops: float         # analytic useful flops (global)
    n_chips: int
    useful_ratio: float        # MODEL_FLOPS / (graph FLOPs x devices)
    roofline_frac: float       # ideal compute time / dominant term

    def row(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def roofline_from(
    cost: dict[str, float],
    totals=None,
    *,
    n_chips: int,
    model_flops: float,
    peak: float = PEAK_FLOPS,
    hbm: float = HBM_BW,
    link: float = LINK_BW,
) -> Roofline:
    """The three terms from the walker's ``Totals`` (or a traced graph,
    walked here); ``cost`` (``cost_analysis``'s dict) stands in where the
    totals have no FLOPs or bytes."""
    from repro_torch.distributed.hlo_analysis import Totals, analyze_graph

    if totals is None:
        totals = Totals()
    elif not isinstance(totals, Totals):
        totals = analyze_graph(totals)
    flops = totals.flops or float(cost.get("flops", 0.0))
    bytes_hbm = totals.bytes or float(cost.get("bytes accessed", 0.0))
    compute_s = flops / peak
    memory_s = bytes_hbm / hbm
    collective_s = totals.coll_bytes / link
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bound = max(terms, key=terms.get)
    total_flops = flops * n_chips
    useful = model_flops / total_flops if total_flops else 0.0
    ideal_s = model_flops / (n_chips * peak)
    dominant = max(terms.values())
    return Roofline(
        flops=flops,
        bytes_hbm=bytes_hbm,
        bytes_link=totals.coll_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bound=bound,
        model_flops=model_flops,
        n_chips=n_chips,
        useful_ratio=useful,
        roofline_frac=ideal_s / dominant if dominant > 0 else 0.0,
    )
