"""Set-up, the measured window, and the traced stretch of one cell.

The window is a closed loop, as in offline batch serving: each iteration
is one ``repro_torch.runtime.serve_loop.generate`` call, one batch of the
mix's prompts under one ``TuningSession``, opened fresh when the window
starts (no registry), so all online tuning falls inside the window. The
window holds whole cycles of the mix's prompt lengths: a cycle starts
only if the previous cycle's time says it will end within the window.

Set-up builds (or loads) the kernel families the session can launch
(the kind's ``families``, or :data:`FAMILIES`), draws the weights on the
device, and warms each shape the mix serves (prefill, the cache at its
decode length, two decode steps) without a session.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable

import torch

from pbench import spec, traffic, weights
from pbench.model import program_config
from pbench.spec import Cell

#: the kernel families set-up builds where the kind names none
FAMILIES = ("matmul", "attention", "rmsnorm")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class BatchRecord:
    index: int
    batch: int
    length: int
    new_tokens: int
    t_start: float          # host clock: generate called
    t_first: float          # host clock: the prefill's logits on the device, synced
    t_end: float            # host clock: generate returned, every token synced
    prefill_s: float        # generate's own spans
    decode_s: float
    tokens: torch.Tensor    # (batch, new_tokens) served

    @property
    def ttft_s(self) -> float:
        return self.t_first - self.t_start

    @property
    def tpot_s(self) -> float:
        return (self.t_end - self.t_first) / max(self.new_tokens - 1, 1)


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    batches: list[BatchRecord]
    counters0: dict
    counters1: dict

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Ctx:
    cell: Cell
    conf: dict               # the configuration as it is run
    seed: int
    device: torch.device
    kind: Any                # the configuration's kind module (perfbench/reference/)
    shapes: Any
    mix: traffic.Mix
    cfg: Any                 # the program's ModelConfig
    model_cls: type          # the class the program builds for cfg
    params: dict
    prompts: traffic.Prompts
    serve_cfg: Any
    tuning: Any
    session: Any = None
    build_s: dict = dataclasses.field(default_factory=dict)
    first_token: list = dataclasses.field(default_factory=lambda: [None])


# ------------------------------------------------------------------ set-up
def build_families(device, families=FAMILIES) -> dict:
    """Build (once per checkout) and load the hand-kernel families the
    serving session can launch (``repro_torch.kernels.<name>.<name>``),
    in parallel: seconds each."""
    mods = {n: importlib.import_module(f"repro_torch.kernels.{n}.{n}") for n in families}
    with ThreadPoolExecutor(len(mods)) as pool:
        libs = {n: pool.submit(m.build_kernels, device) for n, m in mods.items()}
        return {n: f.result().build_s for n, f in libs.items()}


def setup(cell: Cell, seed: int, device, *, conf: dict | None = None,
          mix_spec: dict | None = None, root: Path = spec.ROOT) -> Ctx:
    """Everything before the window. ``conf`` and ``mix_spec`` stand in for
    the cell's files (tests run the harness on small shapes); ``root`` is
    the checkout whose ``perfbench/reference/`` holds the kind."""
    from repro_torch.api import serve_tuning_defaults
    from repro_torch.models.model import build_model
    from repro_torch.runtime.serve_loop import ServeConfig

    device = torch.device(device)
    conf = conf or cell.config
    mix_spec = mix_spec or cell.mix
    kind = spec.reference(conf, root)
    s = kind.shapes(conf)
    mix = traffic.Mix.from_spec(mix_spec)
    built = (build_families(device, getattr(kind, "families", FAMILIES))
             if device.type == "cuda" else {})
    cfg = program_config(conf, root)
    model = build_model(cfg)
    params = weights.make_params(s, traffic.derive(seed, traffic.WEIGHTS), device,
                                 dtype=cfg.param_dtype)
    tuning = dataclasses.replace(serve_tuning_defaults(), **mix_spec["tuning"])
    ctx = Ctx(cell=cell, conf=conf, seed=seed, device=device, kind=kind, shapes=s, mix=mix,
              cfg=cfg, model_cls=type(model), params=params,
              prompts=traffic.Prompts(mix, s.vocab, seed, device),
              serve_cfg=ServeConfig(max_new_tokens=mix.new_tokens, tuning=tuning),
              tuning=tuning, build_s=built)
    warm(ctx, model)
    return ctx


def warm(ctx: Ctx, model) -> None:
    """Each (batch, length, cache length) the mix serves: prefill, the
    cache widened to its decode length, two decode steps; no session."""
    from repro_torch.runtime.serve_loop import widen_cache

    gen = torch.Generator(device=ctx.device).manual_seed(0)
    for b, t, max_len in ctx.mix.shapes():
        tokens = torch.randint(0, ctx.shapes.vocab, (b, t), generator=gen, device=ctx.device)
        logits, cache = model.prefill(ctx.params, {"tokens": tokens})
        cache = widen_cache(model, cache, b, max_len)
        tok = logits[:, -1].argmax(-1)[:, None]
        for i in range(min(2, ctx.mix.new_tokens - 1)):
            logits, cache = model.decode_step(ctx.params, cache, tok, t + i)
            tok = logits[:, -1].argmax(-1)[:, None]
        sync(ctx.device)
        del logits, cache, tok
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ window
@contextlib.contextmanager
def patched(owner: Any, name: str, make: Callable[[Callable], Callable]):
    """``owner.name`` replaced by ``make(original)`` inside the block (an
    attribute ``owner`` inherits is shadowed there, and unshadowed after)."""
    own = name in vars(owner)
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        if own:
            setattr(owner, name, original)
        else:
            delattr(owner, name)


@contextlib.contextmanager
def first_token_probe(ctx: Ctx):
    """Record the host time at which each prefill's logits are on the
    device (a sync the serve loop makes right after the prefill anyway),
    on the class the program builds for the cell."""
    def make(prefill):
        def probed(*args, **kwargs):
            out = prefill(*args, **kwargs)
            sync(ctx.device)
            ctx.first_token[0] = time.perf_counter()
            return out
        return probed

    with patched(ctx.model_cls, "prefill", make):
        yield


def open_session(ctx: Ctx) -> None:
    from repro_torch.api import TuningSession
    from repro_torch.core.persistence import device_fingerprint

    ctx.session = TuningSession(ctx.tuning, device=device_fingerprint(ctx.device))


def close_session(ctx: Ctx) -> None:
    if ctx.session is not None:
        ctx.session.close()
        ctx.session = None


def counters(session) -> dict:
    st = session.stats()
    return {k: float(st[k]) for k in ("tuning_spent_s", "regenerations", "swaps")}


def serve_batch(ctx: Ctx, i: int) -> BatchRecord:
    """Batch ``i`` of the mix through ``generate`` under the session."""
    from repro_torch.runtime.serve_loop import generate

    tokens = ctx.prompts[i]
    ctx.first_token[0] = None
    t_start = time.perf_counter()
    out = generate(ctx.cfg, {"tokens": tokens, "params": ctx.params}, ctx.serve_cfg,
                   session=ctx.session)
    t_end = time.perf_counter()
    return BatchRecord(
        index=i, batch=tokens.shape[0], length=tokens.shape[1],
        new_tokens=ctx.mix.new_tokens, t_start=t_start,
        t_first=ctx.first_token[0] if ctx.first_token[0] is not None else t_end,
        t_end=t_end, prefill_s=float(out["prefill_s"]), decode_s=float(out["decode_s"]),
        tokens=out["tokens"])


def whole_cycles(serve: Callable[[int], Any], cycle: int, seconds: float, t0: float,
                 clock: Callable[[], float] = time.perf_counter) -> tuple[list, float]:
    """Serve whole cycles of ``cycle`` batches from ``t0``: the first always,
    each next one only if the previous cycle's time says it will end
    within ``seconds`` of ``t0``. Returns the records and the last end."""
    records: list = []
    last = None
    while True:
        if last is not None and clock() - t0 + last > seconds:
            break
        u0 = clock()
        for _ in range(cycle):
            records.append(serve(len(records)))
        last = clock() - u0
    return records, clock()


def measure(ctx: Ctx, seconds: float) -> Window:
    """The measured window: a fresh session, then whole cycles."""
    with first_token_probe(ctx):
        t0 = time.perf_counter()
        open_session(ctx)
        c0 = counters(ctx.session)
        records, _ = whole_cycles(lambda i: serve_batch(ctx, i), ctx.mix.cycle,
                                  seconds, t0)
        c1 = counters(ctx.session)
    return Window(t0=t0, t1=records[-1].t_end, batches=records, counters0=c0, counters1=c1)
