"""The port's spans (``repro_torch.runtime.spans``) on the CPU: nesting,
parents and request numbers, the ring's bound, a layer tier that costs
no clock read when off, the spans on the profiler's clock, ``generate``'s
times as sums of its spans, the evaluations' spans against the tuner's
``eval_spent_s``, and the MoE layer's spans per decode step."""

import collections
import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import TuningSession, serve_tuning_defaults
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.models.params import init_tree
from repro_torch.runtime import spans
from repro_torch.runtime.serve_loop import ServeConfig, generate


def new_records(before: int) -> list:
    """The records closed after the one with id ``before``."""
    return [r for r in spans.records() if r.id > before]


def last_id() -> int:
    recs = spans.records()
    return max((r.id for r in recs), default=0)


def tuned(max_new_tokens: int, **tuning) -> ServeConfig:
    return ServeConfig(max_new_tokens=max_new_tokens, tuning=dataclasses.replace(
        serve_tuning_defaults(), enabled=True, kernel_tuning="kernel", **tuning))


def test_spans_nest_with_parents_and_request_numbers():
    start = last_id()
    other = []
    with spans.request(batch=2) as req:
        with spans.span("outer", k=1) as outer:
            with spans.span("inner"):
                pass
            t = threading.Thread(target=lambda: other.append(spans.span("apart").__enter__()))
            t.start()
            t.join(timeout=10)
        with spans.recording(), spans.layer("moe"):
            pass
    with spans.span("after"):
        pass
    with spans.request() as req2:
        pass
    other[0].__exit__(None, None, None)
    recs = {r.name: r for r in new_records(start)}
    gen = [r for r in new_records(start) if r.name == "serve.generate"]
    assert [g.id for g in gen] == [req.id, req2.id]
    assert req2.request == req.request + 1
    assert recs["inner"].parent == outer.id and recs["outer"].parent == req.id
    assert recs["moe"].parent == req.id
    assert {recs[n].request for n in ("inner", "outer", "moe")} == {req.request}
    assert recs["after"].request == 0 and recs["after"].parent == 0
    # a span on another thread belongs to no request and has no parent there
    assert recs["apart"].request == 0 and recs["apart"].parent == 0
    assert recs["apart"].thread != recs["inner"].thread
    assert recs["outer"].attrs == {"k": 1} and gen[0].attrs == {"batch": 2}
    for r in new_records(start):
        assert r.start_ns <= r.end_ns and not r.profiled
    assert recs["inner"].start_ns >= recs["outer"].start_ns
    assert recs["inner"].end_ns <= recs["outer"].end_ns
    assert req.kid_seconds("outer") == pytest.approx(recs["outer"].seconds)


def test_the_ring_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(spans, "RING", 8)
    monkeypatch.setattr(spans, "_ring", collections.deque(maxlen=8))
    monkeypatch.setattr(spans, "_dropped", 0)
    for i in range(20):
        with spans.span(f"s{i}"):
            pass
    assert [r.name for r in spans.records()] == [f"s{i}" for i in range(12, 20)]
    assert spans.dropped() == 12
    monkeypatch.undo()
    assert spans.RING == 1 << 16 and spans._ring.maxlen == spans.RING


class CountingClock:
    def __init__(self):
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return 0


@pytest.fixture(scope="module")
def moe():
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    model = build_model(cfg)
    params = init_tree(model.param_defs(), torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(1))
    return cfg, model, params, tokens


def test_an_off_layer_tier_reads_no_clock_and_records_nothing(moe, monkeypatch):
    cfg, model, params, tokens = moe
    clock = CountingClock()
    monkeypatch.setattr(spans, "_clock", clock)
    before = len(spans.records()), spans.dropped()
    # the shared null context, attributes or none
    assert spans.layer("moe") is spans.layer("moe.dispatch", slices=2, groups=1)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens})
    assert clock.calls == 0
    assert (len(spans.records()), spans.dropped()) == before
    with spans.recording(), spans.layer("moe"):
        pass
    assert clock.calls == 2


def test_layer_spans_lie_on_the_profilers_clock(moe):
    """Under the profiler with CPU activity, every ``aten::`` op the model
    runs inside a ``moe.dispatch`` range lies within that span's start and
    end: the profiler stamps its host events on ``time.time_ns()``."""
    cfg, model, params, tokens = moe
    start = last_id()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model.prefill(params, {"tokens": tokens})
    dispatch = [r for r in new_records(start) if r.name == "moe.dispatch"]
    # one group of 24 tokens: one stacked dispatch a layer
    assert len(dispatch) == cfg.n_layers and all(r.profiled for r in dispatch)
    base = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted((e for e in prof.events() if e.name == "moe.dispatch"),
                    key=lambda e: e.time_range.start)
    assert len(ranges) == len(dispatch)

    def atens(e):
        for c in e.cpu_children:
            if c.name.startswith("aten::"):
                yield c
            yield from atens(c)

    checked = 0
    for rng, rec in zip(ranges, sorted(dispatch, key=lambda r: r.start_ns)):
        for op in atens(rng):
            a = base + round(op.time_range.start * 1e3)
            b = base + round(op.time_range.end * 1e3)
            assert rec.start_ns <= a <= b <= rec.end_ns, (op.name, rec)
            checked += 1
    assert checked >= len(dispatch) * 5


def test_a_reduced_moe_decode_step_records_one_stacked_dispatch_a_layer_under_recording(moe):
    """A decode step is one group: each layer records one ``moe.dispatch``,
    ``moe.experts`` and ``moe.combine``, the dispatch carrying all top-k
    slices of that one group."""
    cfg, model, params, tokens = moe
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens})
        from repro_torch.runtime.serve_loop import widen_cache
        cache = widen_cache(model, cache, tokens.shape[0], tokens.shape[1] + 2)
        tok = logits[:, -1].argmax(-1)[:, None]
        start = last_id()
        with spans.recording():
            model.decode_step(params, cache, tok, tokens.shape[1])
    recs = new_records(start)
    counts = collections.Counter(r.name for r in recs)
    n = cfg.n_layers
    assert cfg.n_layers >= 2 and cfg.top_k >= 2
    assert counts == {"moe": n, "moe.route": n,
                      "moe.dispatch": n, "moe.experts": n, "moe.combine": n}
    for r in recs:
        want = {"slices": cfg.top_k, "groups": 1} if r.name == "moe.dispatch" else None
        assert r.attrs == want, r


@pytest.fixture(scope="module")
def dense():
    cfg = get_config("deepseek-7b").reduced()
    params = init_tree(build_model(cfg).param_defs(), torch.Generator().manual_seed(0))
    return cfg, params


def test_generate_times_are_sums_of_the_requests_spans(dense):
    cfg, params = dense
    session = TuningSession(tuned(6).tuning, device="test:cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(2))
    for _ in range(2):
        start = last_id()
        out = generate(cfg, {"tokens": tokens.clone(), "params": params}, tuned(6),
                       session=session)
        recs = new_records(start)
        (gen,) = [r for r in recs if r.name == "serve.generate"]
        mine = [r for r in recs if r.request == gen.request]
        assert all(r.thread == gen.thread for r in mine)
        kids = [r for r in mine if r.parent == gen.id]

        def total(name, rs):
            return sum(r.end_ns - r.start_ns for r in rs if r.name == name) * 1e-9

        (prefill,) = [r for r in kids if r.name == "serve.prefill"]
        assert out["prefill_s"] == pytest.approx(prefill.seconds, rel=1e-9)
        assert len([r for r in kids if r.name == "serve.decode_step"]) == 5
        assert out["decode_s"] == pytest.approx(
            total("serve.decode_step", kids) + total("serve.sync", kids), rel=1e-9)
        assert total("tune.register", kids) > 0
        assert out["tune_init_s"] == pytest.approx(total("tune.register", kids), rel=1e-9)
        # the prefill's syncs lie inside it; one closes the decode steps
        assert [r.parent for r in mine if r.name == "serve.sync"].count(gen.id) == 1
    session.close()


def test_evaluation_spans_match_the_tuners_eval_spent_s(dense):
    cfg, params = dense
    serve = tuned(17, max_overhead=0.5)
    session = TuningSession(serve.tuning, device="test:cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(3))
    e0 = session.stats()["eval_spent_s"]
    start = last_id()
    for _ in range(2):
        generate(cfg, {"tokens": tokens.clone(), "params": params}, serve, session=session)
    spent = session.stats()["eval_spent_s"] - e0
    evals = [r for r in new_records(start) if r.name == "tune.evaluate"]
    session.close()
    assert len(evals) >= 2 and spent > 0
    assert all(r.attrs["kernel"] in ("matmul", "attention", "rmsnorm", "decode_attention")
               for r in evals)
    assert sum(r.seconds for r in evals) == pytest.approx(spent, rel=0.01)
    # every evaluation ran in a tuning slot of a decode step
    by_id = {r.id: r for r in new_records(start)}
    assert all(by_id[r.parent].name == "tune.pump" for r in evals)


def test_decode_tokens_per_s_counts_the_decoded_tokens_only(dense):
    cfg, params = dense
    tokens = torch.randint(0, cfg.vocab, (3, 8), generator=torch.Generator().manual_seed(4))
    out = generate(cfg, {"tokens": tokens, "params": params}, ServeConfig(max_new_tokens=5))
    assert out["tokens"].shape == (3, 5)
    # the prefill gives the first token; the decode steps the other 4
    assert out["decode_tokens_per_s"] * out["decode_s"] == pytest.approx(3 * 4)


@pytest.fixture(scope="module")
def mla():
    cfg = get_config("deepseek-v2-lite").reduced()
    params = init_tree(build_model(cfg).param_defs(), torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(5))
    return cfg, params, tokens


def test_latent_attention_spans_nest_in_the_serve_loops_steps(mla):
    """Under ``recording()``, a request's prefill records per layer
    ``mla.project``, ``mla.expand`` and ``mla.attend`` (path ``flash``,
    the prompt's keys) inside ``serve.prefill``; each decode step per
    layer ``mla.project``, ``mla.absorb``, ``mla.attend`` (path
    ``latent``, the keys so far) and ``mla.unabsorb`` inside
    ``serve.decode_step``."""
    cfg, params, tokens = mla
    start = last_id()
    with spans.recording():
        generate(cfg, {"tokens": tokens.clone(), "params": params}, ServeConfig(max_new_tokens=3))
    recs = new_records(start)
    by_id = {r.id: r for r in recs}
    n = cfg.n_layers
    prefill = [r for r in recs if r.name == "serve.prefill"]
    steps = [r for r in recs if r.name == "serve.decode_step"]
    assert len(prefill) == 1 and len(steps) == 2

    def step_of(r):
        p = by_id.get(r.parent)
        while p is not None and p.name not in ("serve.prefill", "serve.decode_step"):
            p = by_id.get(p.parent)
        return p

    mla_recs = [r for r in recs if r.name.startswith("mla.")]
    assert all(step_of(r) is not None for r in mla_recs)
    counts = collections.Counter((step_of(r).id, r.name) for r in mla_recs)
    assert {name: counts[(prefill[0].id, name)] for name in
            ("mla.project", "mla.expand", "mla.attend", "mla.absorb", "mla.unabsorb")} == \
        {"mla.project": n, "mla.expand": n, "mla.attend": n, "mla.absorb": 0, "mla.unabsorb": 0}
    for i, step in enumerate(steps):
        assert {name: counts[(step.id, name)] for name in
                ("mla.project", "mla.expand", "mla.attend", "mla.absorb", "mla.unabsorb")} == \
            {"mla.project": n, "mla.expand": 0, "mla.attend": n, "mla.absorb": n,
             "mla.unabsorb": n}
        attends = [r for r in mla_recs if r.name == "mla.attend" and step_of(r) is step]
        assert all(r.attrs == {"keys": tokens.shape[1] + i + 1, "path": "latent"}
                   for r in attends)
    assert all(r.attrs == {"keys": tokens.shape[1], "path": "flash"} for r in mla_recs
               if r.name == "mla.attend" and step_of(r) is prefill[0])


def test_latent_attention_spans_are_off_outside_a_profiler(mla, monkeypatch):
    cfg, params, tokens = mla
    clock = CountingClock()
    monkeypatch.setattr(spans, "_clock", clock)
    model = build_model(cfg)
    before = len(spans.records()), spans.dropped()
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens})
        from repro_torch.runtime.serve_loop import widen_cache
        cache = widen_cache(model, cache, tokens.shape[0], tokens.shape[1] + 1)
        model.decode_step(params, cache, logits[:, -1].argmax(-1)[:, None], tokens.shape[1])
    assert clock.calls == 0
    assert (len(spans.records()), spans.dropped()) == before
