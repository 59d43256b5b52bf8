"""The traced stretch: whole batches under ``torch.profiler`` (the
device's activity: kernels, copies and the runtime calls that launched
them), with the benchmark's own host ranges around the calls into each
layer, reduced to device time by range (a device op belongs to the
ranges open when its launch was made), the device's busy time (the
union of device-op intervals), idle gaps by what the host was doing, and
the calls' shapes that the roofline readers price.

Ranges (all named ``perfbench.<name>``, stamped on the profiler's clock,
Unix nanoseconds; the program is not edited, its functions are wrapped
for the stretch only): ``window`` (the stretch),
``generate``, ``prefill`` and ``decode_step`` (the steps of the model
class the program builds for the cell),
``maybe_pump`` (the session's tuning slot), ``attention`` (the layers'
attention entry, prefill and decode), ``flash`` (the flash-attention
kernel's wrapper) and ``moe_ffn`` (the expert layer).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Any, Iterable

import torch

PREFIX = "perfbench."
WINDOW = PREFIX + "window"
OUTSIDE = "outside every range"


@dataclasses.dataclass(frozen=True)
class Ev:
    """One profiler event, reduced to what the readers need."""
    name: str
    on_device: bool
    start_ns: int
    end_ns: int
    corr: int = 0        # a device op and the host call that launched it share it


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Ranges:
    """Host ranges of one name, for containment lookups."""

    def __init__(self, spans: Iterable[tuple[int, int]]) -> None:
        self.spans = sorted(spans)
        self.starts = [a for a, _b in self.spans]

    def find(self, t: int) -> "tuple[int, int] | None":
        """The span holding ``t`` (ranges of one name do not overlap)."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i][0] <= t <= self.spans[i][1]:
            return self.spans[i]
        return None

    def contains(self, t: int) -> bool:
        return self.find(t) is not None


def reduce_events(events: list[Ev], top: int = 10) -> dict:
    """Busy and idle time of the device inside the ``window`` range, device
    seconds by range, and the breakdown's two top lists."""
    host = [e for e in events if not e.on_device and e.name.startswith(PREFIX)]
    win = [e for e in host if e.name == WINDOW]
    if not win:
        raise ValueError(f"no {WINDOW} range in the trace")
    w0, w1 = win[0].start_ns, win[0].end_ns
    ops = [e for e in events if e.on_device and e.end_ns > w0 and e.start_ns < w1]
    busy = _union([(max(e.start_ns, w0), min(e.end_ns, w1)) for e in ops])
    busy_ns = sum(b - a for a, b in busy)

    # each device op's launch: the host runtime call with its correlation id
    launches = {e.corr: e.start_ns for e in events
                if not e.on_device and e.corr and e.name.startswith("cu")}
    by_name: dict[str, list[tuple[int, int]]] = {}
    for e in host:
        by_name.setdefault(e.name, []).append((e.start_ns, e.end_ns))
    ranges = {n: _Ranges(spans) for n, spans in by_name.items()}
    mapped = sum(1 for e in ops if e.corr in launches)
    # the host ranges and the launches share a clock: count the launches
    # of the window's device ops that fall inside the window range
    in_window = sum(1 for e in ops if w0 <= launches.get(e.corr, w0 - 1) <= w1)

    range_ns: dict[str, int] = {n.removeprefix(PREFIX): 0 for n in by_name}
    for e in ops:
        dur = min(e.end_ns, w1) - max(e.start_ns, w0)
        at = launches.get(e.corr)
        if at is None:
            continue
        for n, r in ranges.items():
            if r.contains(at):
                range_ns[n.removeprefix(PREFIX)] += dur

    # idle gaps inside the window, labelled by the innermost host range
    # open at the gap's midpoint
    gaps: dict[str, int] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    inner = [(n.removeprefix(PREFIX), r) for n, r in ranges.items() if n != WINDOW]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        label, width = OUTSIDE, None
        for n, r in inner:
            span = r.find(mid)
            if span is not None and (width is None or span[1] - span[0] < width):
                label, width = n, span[1] - span[0]
        gaps[label] = gaps.get(label, 0) + (b - a)

    per_op: dict[str, int] = {}
    for e in ops:
        per_op[e.name] = per_op.get(e.name, 0) + (min(e.end_ns, w1) - max(e.start_ns, w0))
    top_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "device_ops": len(ops),
        "launches_mapped": mapped,
        "launches_in_window": in_window,
        "range_device_s": {n: v * 1e-9 for n, v in range_ns.items()},
        "breakdown": {
            "device_ops": [[n[:160], v * 1e-9] for n, v in top_ops],
            "idle_gaps": [[n, v * 1e-9] for n, v in top_gaps],
        },
    }


def kineto_events(prof) -> list[Ev]:
    """The profiler's raw events (no function-event tree: a batch can
    launch a few hundred thousand kernels)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        out.append(Ev(name=e.name(), on_device=e.device_type() == DeviceType.CUDA,
                      start_ns=start, end_ns=start + int(e.duration_ns()),
                      corr=int(e.correlation_id())))
    return out


# ------------------------------------------------------------ the stretch
class Recorder:
    """The stretch's host ranges, on the host clock the profiler stamps its
    events with (Unix nanoseconds), and the calls' shapes; recording stops
    with the profiler."""

    def __init__(self, s, stop_after_steps: "int | None") -> None:
        self.s = s
        self.stop_after_steps = stop_after_steps
        self.events: list[Ev] = []
        self.flash: list = []          # (B, Tq, Tkv, H, Hk, Dh, causal)
        self.moe: list = []            # (tokens, experts used: a tensor until the end)
        self.steps = 0
        self.on = False
        self.stop = None               # set by traced_stretch

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.events.append(Ev(PREFIX + name, False, t0, time.time_ns()))

    def ranged(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


@contextlib.contextmanager
def layer_ranges(rec: Recorder, model_cls: type) -> Any:
    """The ranges and probes of the stretch, installed on the program's
    functions (and on ``model_cls``'s steps) for the block only."""
    from repro_torch.api import TuningSession
    from repro_torch.models import layers, transformer
    from pbench.runner import patched

    s = rec.s

    def flash(fn):
        def wrapped(q, k, v, point, *args, causal=True, **kwargs):
            if rec.on:
                rec.flash.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                                  k.shape[2], q.shape[3], bool(causal)))
            with rec.span("flash"):
                return fn(q, k, v, point, *args, causal=causal, **kwargs)
        return wrapped

    def moe(fn):
        def wrapped(x, p, cfg):
            if rec.on:
                # the experts this call's routing chooses, by the benchmark's
                # own routing of the same input (outside the moe_ffn range)
                with torch.no_grad():
                    logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
                    chosen = logits.topk(s.top_k, dim=-1).indices.flatten()
                    used = torch.bincount(chosen, minlength=s.experts).gt(0).sum()
                rec.moe.append((x.shape[0] * x.shape[1], used))
            with rec.span("moe_ffn"):
                return fn(x, p, cfg)
        return wrapped

    def decode_step(fn):
        def wrapped(*args, **kwargs):
            with rec.span("decode_step"):
                out = fn(*args, **kwargs)
            if rec.on:
                rec.steps += 1
                if rec.stop_after_steps is not None and rec.steps >= rec.stop_after_steps:
                    rec.stop()
            return out
        return wrapped

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(model_cls, "prefill", lambda fn: rec.ranged("prefill", fn)))
        stack.enter_context(patched(model_cls, "decode_step", decode_step))
        stack.enter_context(patched(TuningSession, "maybe_pump",
                                    lambda fn: rec.ranged("maybe_pump", fn)))
        for name in ("self_attention_with_cache", "decode_self_attention"):
            stack.enter_context(patched(layers, name, lambda fn: rec.ranged("attention", fn)))
        stack.enter_context(patched(layers, "flash_attention_cuda", flash))
        stack.enter_context(patched(transformer, "moe_ffn", moe))
        yield


def traced_stretch(ctx, first_index: int) -> dict:
    """One whole cycle of the mix's batches (or, where the mix sets
    ``trace_decode_steps``, its first batch's prefill and that many decode
    steps) under the profiler, after the window and under its session;
    returns the reduced trace and the calls' shapes. The profiler traces
    the device's activity only (its kernels and the runtime calls that
    launched them), so the host pays as little as the trace allows; the
    host ranges are the benchmark's own, on the same clock."""
    from torch.profiler import ProfilerActivity, profile

    from pbench.runner import first_token_probe, serve_batch, sync

    rec = Recorder(ctx.shapes, ctx.mix.trace_decode_steps)
    prof = profile(activities=[ProfilerActivity.CUDA if ctx.device.type == "cuda"
                               else ProfilerActivity.CPU])
    t_start = []

    def stop():
        if rec.on:
            sync(ctx.device)
            rec.events.append(Ev(WINDOW, False, t_start[0], time.time_ns()))
            rec.on = False
            prof.stop()

    rec.stop = stop
    with layer_ranges(rec, ctx.model_cls), first_token_probe(ctx):
        sync(ctx.device)
        prof.start()
        rec.on = True
        t_start.append(time.time_ns())
        for j in range(ctx.mix.cycle):
            with rec.span("generate"):
                serve_batch(ctx, first_index + j)
        stop()
    t0 = time.perf_counter()
    out = reduce_events(kineto_events(prof) + rec.events)
    out["reduce_s"] = time.perf_counter() - t0
    out["flash_calls"] = rec.flash
    out["moe_calls"] = [(n, int(u)) for n, u in rec.moe]
    return out
