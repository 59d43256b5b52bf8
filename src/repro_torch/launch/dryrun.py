"""Multi-node dry run: trace every (arch x shape x mesh) cell per device.

Mirrors ``repro/launch/dryrun.py``. Where the reference forces 512 host
devices and compiles each cell's SPMD module, this initialises a fake
process group of the mesh's size (``torch.testing``'s ``FakeStore``:
every collective returns at once, nothing crosses a wire) and traces the
cell's step with ``make_fx(..., tracing_mode="fake")`` over fake local
shards, in bf16 compute with remat ``dots``, as the reference's run
does. The step takes the plain PyTorch path on the CPU: it launches no
kernel and names no device. The per-device graph gives the roofline
terms (``repro_torch.distributed.hlo_analysis``, ``roofline``, with the
H100's constants) and the peak memory by a liveness walk.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Records go to ``dryrun_artifacts/torch/`` (the reference's go to
``dryrun_artifacts/``), one JSON per cell with the overrides it was
traced with; exit 1 on any FAILED cell. ``--shape`` also takes a comma
list; ``--jobs N`` traces N cells at a time, each in a process of its
own (one fake group a process: ``--mesh both`` needs it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ALL_SHAPES, REGISTRY
from repro_torch.distributed.hlo_analysis import (
    analyze_graph, cost_analysis, memory_analysis)
from repro_torch.distributed.roofline import (
    HBM_BW, LINK_BW, PEAK_FLOPS, roofline_from)
from repro_torch.launch.shapes import Cell, build_cell, local_args, skip_reason, spmd_fn

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "../../../dryrun_artifacts/torch")

DEVICE_NOTE = ("traced on a fake process group on the host: no device ran; "
               "terms use H100 80GB HBM3 SXM constants")


def init_fake_group(world_size: int) -> None:
    """A fake default group of ``world_size`` ranks, this process rank 0
    (once per process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a group of {dist.get_world_size()} is already initialised; "
                f"this cell needs {world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def trace(cell: Cell):
    """(per-device FX graph of the cell's step, donated placeholder
    indices): ``make_fx`` over fake local shards."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.tree import tree_leaves

    fake_mode = FakeTensorMode(allow_non_fake_inputs=False)
    args = local_args(cell, fake_mode)
    donated, i = set(), 0
    for n, a in enumerate(args):
        count = sum(isinstance(x, torch.Tensor) for x in tree_leaves(a))
        if n in cell.donate_argnums:
            donated.update(range(i, i + count))
        i += count
    gm = make_fx(spmd_fn(cell), tracing_mode="fake")(*args)
    # nodes no result depends on (some DTensor versions trace the global
    # tensors of their shape propagation) are no part of the program; the
    # walkers read the graph, so the module's code is not regenerated
    gm.graph.eliminate_dead_code()
    return gm, donated


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str | None = None,
             overrides: dict | None = None) -> dict:
    from repro_torch.launch.mesh import make_production_mesh

    cfg = REGISTRY[arch]
    base = {"compute_dtype": torch.bfloat16, "remat": "dots"}
    base.update(overrides or {})
    cfg = dataclasses.replace(cfg, **base)
    shape = next(s for s in ALL_SHAPES if s.name == shape_name)
    multi_pod = mesh_kind == "multi"
    n_chips = 512 if multi_pod else 256
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "n_chips": n_chips, "status": None, "device": DEVICE_NOTE,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
    }
    reason = skip_reason(cfg, shape)
    if reason:
        record["status"] = "skipped"
        record["skip_reason"] = reason
        return record

    init_fake_group(n_chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    t0 = time.time()
    cell = build_cell(cfg, shape, mesh)
    gm, donated = trace(cell)
    t_trace = time.time() - t0
    t1 = time.time()
    mem = memory_analysis(gm, donated)
    totals = analyze_graph(gm)
    cost = cost_analysis(gm)
    roof = roofline_from(cost, totals, n_chips=n_chips, model_flops=cell.model_flops)
    t_walk = time.time() - t1
    record.update({
        "status": "ok",
        "trace_s": round(t_trace, 2),
        "walk_s": round(t_walk, 2),
        "graph_nodes": len(gm.graph.nodes),
        "microbatches": cell.microbatches,
        "memory": {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "peak_per_device_gb": round(mem["peak_bytes"] / 2**30, 3),
            "peak_bytes": mem["peak_bytes"],
        },
        "cost": cost,
        "collectives": {
            "link_bytes": totals.coll_bytes,
            "per_op": totals.coll_per_op,
        },
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW},
        "roofline": roof.row(),
    })
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--micro", type=int, default=None,
                    help="override gradient-accumulation factor")
    ap.add_argument("--moe-group", type=int, default=None)
    ap.add_argument("--remat", default=None, choices=("none", "dots", "full"))
    ap.add_argument("--attn-q-chunk", type=int, default=None)
    ap.add_argument("--attn-k-chunk", type=int, default=None)
    ap.add_argument("--scan-chunk", type=int, default=None)
    ap.add_argument("--scores-bf16", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    args = ap.parse_args(argv)
    overrides = {}
    if args.micro is not None:
        overrides["microbatches"] = args.micro
    if args.moe_group is not None:
        overrides["moe_group_size"] = args.moe_group
    if args.remat is not None:
        overrides["remat"] = args.remat
    if args.attn_q_chunk is not None:
        overrides["attn_q_chunk"] = args.attn_q_chunk
    if args.attn_k_chunk is not None:
        overrides["attn_k_chunk"] = args.attn_k_chunk
    if args.scan_chunk is not None:
        overrides["scan_chunk"] = args.scan_chunk
    if args.scores_bf16:
        overrides["attn_scores_f32"] = False

    os.makedirs(args.out, exist_ok=True)
    archs = sorted(REGISTRY) if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in ALL_SHAPES] if (args.all or not args.shape) \
        else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.jobs > 1 or len(meshes) > 1:
        raise SystemExit(_run_jobs(archs, shapes, meshes, args, argv))

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                name = f"{arch}_{shape}_{mesh_kind}{args.tag}"
                path = os.path.join(args.out, name + ".json")
                try:
                    rec = run_cell(arch, shape, mesh_kind, args.out,
                                   overrides=overrides)
                except Exception as e:  # a failure here is a bug in the system
                    failures += 1
                    rec = {
                        "arch": arch, "shape": shape, "mesh": mesh_kind,
                        "status": "FAILED", "error": repr(e),
                        "traceback": traceback.format_exc()[-4000:],
                    }
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[{rec['status']:>7s}] {name} "
                      + (f"trace={rec.get('trace_s')}s "
                         f"mem={rec.get('memory', {}).get('peak_per_device_gb')}GB "
                         f"bound={rec.get('roofline', {}).get('bound')}"
                         if rec["status"] == "ok" else
                         rec.get("skip_reason", rec.get("error", ""))[:120]),
                      flush=True)
    raise SystemExit(1 if failures else 0)


def _run_jobs(archs, shapes, meshes, args, argv) -> int:
    """Each cell in a ``python -m repro_torch.launch.dryrun`` process of
    its own, ``args.jobs`` at a time; 1 if any failed."""
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    argv = list(sys.argv[1:] if argv is None else argv)
    keep, skip = [], {"--arch", "--shape", "--mesh", "--jobs"}
    it = iter(argv)
    for a in it:
        if a in skip:
            next(it, None)
        elif a.split("=")[0] in skip or a == "--all":
            continue
        else:
            keep.append(a)

    def one(cell) -> int:
        arch, shape, mesh = cell
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", mesh, *keep],
            capture_output=True, text=True)
        print(res.stdout.strip().splitlines()[-1] if res.stdout.strip()
              else f"[ FAILED] {arch}_{shape}_{mesh}: {res.stderr[-300:]}", flush=True)
        return res.returncode

    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        codes = list(pool.map(one, cells))
    return 1 if any(codes) else 0


if __name__ == "__main__":
    main()
