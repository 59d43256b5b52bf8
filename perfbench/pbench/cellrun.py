"""One run of one cell: set-up, window, traced stretch, comparison,
metrics, and the result line's object."""

from __future__ import annotations

import gc
import sys
import time

import torch

from pbench import correct, runner, spec, trace
from pbench.spec import Cell

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden (``repro_torch``
    is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def requests_failed(window) -> int:
    """Requests of the window that came back without all their tokens."""
    failed = 0
    for b in window.batches:
        ok_shape = tuple(b.tokens.shape) == (b.batch, b.new_tokens)
        failed += b.batch if not ok_shape else 0
    return failed


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             *, conf: dict | None = None, mix_spec: dict | None = None,
             limits: dict | None = None, root=spec.ROOT) -> dict:
    """The result object of one run (the contract's last line)."""
    device = torch.device(device)
    ctx = runner.setup(cell, seed, device, conf=conf, mix_spec=mix_spec, root=root)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (builds {ctx.build_s})")
    window = runner.measure(ctx, seconds)
    log(f"window {window.seconds:.3f} s, {len(window.batches)} batches, "
        f"counters {window.counters1}")
    stretch = None
    if traced:
        t0 = time.perf_counter()
        stretch = trace.traced_stretch(ctx, len(window.batches))
        log(f"traced stretch and its reduction {time.perf_counter() - t0:.1f} s: "
            f"{stretch['device_ops']} device ops, {stretch['launches_mapped']} launches mapped, "
            f"{stretch['launches_in_window']} in the window range, "
            f"reduction {stretch['reduce_s']:.1f} s, device s by range {stretch['range_device_s']}, "
            f"busy {stretch['busy_s']:.4f} of {stretch['window_s']:.4f} s")
    runner.close_session(ctx)
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    readings = correct.compare(ctx, window.batches)
    log(f"comparison {time.perf_counter() - t0:.1f} s over {readings['requests']} requests, "
        f"{readings['tokens']} served tokens: {readings}")
    ok, checks = correct.verdict(readings, cell.limits if limits is None else limits)

    rec = {"setup_s": setup_s, "window": window, "trace": stretch, "shapes": ctx.shapes,
           "mix": ctx.mix}
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.metric_reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": sum(b.batch for b in window.batches),
              "failed": requests_failed(window), "metrics": metrics, "device": dev}
    if stretch is not None:
        dev["busy_s"] = stretch["busy_s"]
        dev["window_s"] = stretch["window_s"]
        result["breakdown"] = stretch["breakdown"]
    result["checks"] = checks
    return result
