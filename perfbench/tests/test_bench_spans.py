"""The metrics that read the program's spans (``repro_torch.runtime.spans``):
on the CPU, a traced run of each cell at a small size gives each of them
where the cell lists it, and a reader finds nothing (``None``) where the
request counts disagree with the run's or the program has no spans; on
the card, the runtime's launch calls of one request of each cell fall
inside the program's spans."""

import contextlib
import dataclasses
import gc
import json
import sys
import time

import pytest
import torch

from pbench import runner, spec, trace
from small import small_config, small_mix

#: every cell of BENCHMARK.json
CELLS = tuple(w["name"] for w in spec.load_benchmark()["workloads"])
NEW = ("decode_step_p90_ms", "decode_issue_ms", "tune_inline_pct", "moe_dispatch_ms")


def traced_rec(name: str) -> dict:
    """A small run's record as ``run_cell`` gives it to the readers: set-up,
    the window, the traced stretch."""
    cell = spec.cell(name)
    lengths = (8, 12) if len(cell.mix["prompt_lengths"]) > 1 else (20,)
    mix = small_mix(cell.mix, lengths=lengths, batch=3, new_tokens=6)
    torch.manual_seed(0)
    ctx = runner.setup(cell, 2**31 + 11, "cpu", conf=small_config(cell.config), mix_spec=mix)
    window = runner.measure(ctx, 0.5)
    stretch = trace.traced_stretch(ctx, len(window.batches))
    runner.close_session(ctx)
    return {"setup_s": 1.0, "window": window, "trace": stretch, "shapes": ctx.shapes,
            "mix": ctx.mix}


@pytest.fixture(scope="module", params=CELLS)
def run(request):
    """The cell and its small run's record, read against a span ring of
    its own: a benchmark run is one process, and the requests of runs
    made before it in the same process (other tests') would make the
    window's count disagree."""
    import collections

    from repro_torch.runtime import spans

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spans, "_ring", collections.deque(maxlen=spans.RING))
        yield spec.cell(request.param), traced_rec(request.param)


def test_each_new_metric_reads_a_number_in_its_cells(run):
    cell, rec = run
    listed = {m["name"] for m in cell.per_layer}
    want = {"decode_issue_ms", "tune_inline_pct"}
    if getattr(rec["shapes"], "experts", 0):
        want |= {"decode_step_p90_ms", "moe_dispatch_ms"}
    assert listed & set(NEW) == want
    for name in want:
        value = spec.metric_reader(name)(rec)
        assert value is not None and value >= 0, name
    # the steps' issue time lies within the steps' time
    steps_ms = 1e3 * sum(b.decode_s for b in rec["window"].batches)
    assert spec.metric_reader("decode_issue_ms")(rec) <= steps_ms
    assert spec.metric_reader("tune_inline_pct")(rec) <= 100.0


def test_a_reader_finds_nothing_where_the_counts_disagree(run):
    cell, rec = run
    w = rec["window"]
    for batches in (w.batches + w.batches[-1:], w.batches[1:]):
        other = dict(rec, window=dataclasses.replace(w, batches=batches))
        for name in NEW:
            assert spec.metric_reader(name)(other) is None, name
    longer = dataclasses.replace(rec["mix"], prompt_lengths=rec["mix"].prompt_lengths * 2)
    for name in NEW:
        assert spec.metric_reader(name)(dict(rec, mix=longer)) is None, name


def test_a_reader_finds_nothing_in_a_program_without_spans(run, monkeypatch):
    import repro_torch.runtime

    cell, rec = run
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    monkeypatch.delattr(repro_torch.runtime, "spans")
    for name in NEW:
        assert spec.metric_reader(name)(rec) is None, name


@contextlib.contextmanager
def moe_brackets(out: list):
    """Each ``moe_ffn`` call's interval on the profiler's clock, from
    outside the program."""
    from repro_torch.models import transformer

    original = transformer.moe_ffn

    def bracketed(x, p, cfg):
        t0 = time.time_ns()
        try:
            return original(x, p, cfg)
        finally:
            out.append((t0, time.time_ns()))

    with runner.patched(transformer, "moe_ffn", lambda fn: bracketed):
        yield


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_launches_fall_inside_the_programs_spans(card, name):
    """One request of the cell, at its size, under a CUDA profiler after
    a first request that registers the tuner's handles: at least 99 % of
    the runtime's launch calls lie inside its ``serve.generate`` span, and
    every launch made while ``moe_ffn`` runs lies inside a ``moe`` span."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import spans

    cell = spec.cell(name)
    ctx = runner.setup(cell, 2**31 + 23, card)
    has_experts = bool(getattr(ctx.shapes, "experts", 0))
    runner.open_session(ctx)
    runner.serve_batch(ctx, 0)
    runner.sync(card)
    start = max((r.id for r in spans.records()), default=0)
    brackets: list = []
    with moe_brackets(brackets), profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner.serve_batch(ctx, 1)
        runner.sync(card)
    runner.close_session(ctx)
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    events = trace.kineto_events(prof)
    device = {e.corr for e in events if e.on_device and e.corr}
    calls = [e for e in events if not e.on_device and e.name.startswith("cu")]
    launches = [e.start_ns for e in calls if e.corr in device]
    launched = {e.corr for e in calls}
    mine = [r for r in spans.records() if r.id > start]
    (gen,) = [r for r in mine if r.name == "serve.generate"]
    inside = sum(gen.start_ns <= t <= gen.end_ns for t in launches)
    moe = trace._Ranges((r.start_ns, r.end_ns) for r in mine if r.name == "moe")
    ffn = trace._Ranges(brackets)
    in_ffn = [t for t in launches if ffn.contains(t)]
    in_moe = sum(moe.contains(t) for t in in_ffn)
    # device events no launch call made (a profiler range drawn on the device)
    annotated = sorted({e.name for e in events if e.on_device and e.corr not in launched})
    print(json.dumps({"cell": name, "launches": len(launches), "in_generate": inside,
                      "moe_ffn_calls": len(brackets), "launches_in_moe_ffn": len(in_ffn),
                      "of_them_in_a_moe_span": in_moe, "spans": len(mine),
                      "device_events_without_launch": annotated[:8]}))
    assert launches and inside >= 0.99 * len(launches)
    assert in_moe == len(in_ffn)
    if has_experts:
        assert in_ffn
