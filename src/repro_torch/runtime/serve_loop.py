"""Serving runtime: batched prefill + greedy decode with KV cache.

Mirrors ``repro/runtime/serve_loop.py``: the same ``ServeConfig``,
``generate`` and program-level compilettes, whose points now yield eager
PyTorch step functions. Where the reference blocks on the device before
crediting busy time, this loop synchronizes the device through the
evaluator's :func:`~repro_torch.core.evaluator.block_until_ready` (which
swallows nothing): without it the credited interval would be the time to
enqueue the step, not to run it. Prompts and params live on the device
of ``batch["tokens"]``.

Online auto-tuning (paper technique, serving workload) is configured by
the embedded :class:`~repro_torch.api.TuningConfig` (``ServeConfig.tuning``)
and owned by a :class:`~repro_torch.api.TuningSession` — the one front door to
the coordinator machinery. The serving regime it runs under:

  * the regeneration budget accrues from **busy time** (kernel-call time
    actually observed), not lifetime wall-clock, so a long-idle server
    cannot burst accrued budget onto one request; the register()-time
    reference measurement is charged to the same budget;
  * sequence lengths are **bucketed to powers of two** (nearest in log
    space), so varied prompt shapes share tuners instead of accumulating
    one tuner (plus pinned evaluation closures) per exact shape;
  * exhausted tuners converge (closures released) and idle tuners are
    evicted by the session lifecycle;
  * the search strategy is pluggable (``TuningConfig.strategy``: any
    name registered in :mod:`repro_torch.core.explorer`);
  * **candidate compilation is off the request path**: variants are
    built by the session's background pipeline while the live
    step-programs keep serving — the paper's double-buffered code
    generation, serving-grade;
  * **hierarchical registration** (``kernel_tuning``): beside the whole
    step-programs, ``session.attach_kernels`` registers the model's
    constituent kernels (matmul, attention, rmsnorm, and the decode
    path's flash-decoding ``decode_attention`` keyed per cache-length
    bucket) as independent compilettes — each with its own tuning space,
    search strategy, registry warm-start key and generation-cache lines,
    all drawing slots from the same shared budget. ``"program"`` tunes
    the step-programs, ``"kernel"`` only the kernels (step-programs
    adopt the kernels' best block sizes), ``"both"`` runs the two levels
    together (program points own the step-level knobs).

Pass a long-lived session (one per serving process) so tuning state,
budget and warm-started best points persist across requests; within a
single ``generate`` call tuning already begins between decode steps.
The reference's deprecated shims (``make_serve_coordinator``, the bare
``coordinator=`` argument, the flat ``ServeConfig`` tuning fields) are
not ported: the port has no older call sites.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.api import (
    KERNEL_TUNING_MODES,
    TuningConfig,
    TuningSession,
    serve_tuning_defaults,
)
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    Compilette,
    Evaluator,
    Param,
    clamped_options,
    product_space,
)
from repro_torch.core.evaluator import block_until_ready
from repro_torch.models.model import build_model
from repro_torch.models.params import init_tree
from repro_torch.runtime import spans

__all__ = [
    "KERNEL_TUNING_MODES",
    "ServeConfig",
    "generate",
    "serve_tuning_defaults",   # re-export: the regime base lives in api
    "widen_cache",
]

class ServeConfig:
    """Serving knobs; tuning knobs live in the embedded ``tuning`` config."""

    def __init__(
        self,
        max_new_tokens: int = 32,
        greedy: bool = True,
        temperature: float = 1.0,
        seed: int = 0,
        tuning: TuningConfig | None = None,
    ) -> None:
        self.max_new_tokens = max_new_tokens
        self.greedy = greedy
        self.temperature = temperature
        self.seed = seed
        self.tuning = tuning if tuning is not None else \
            serve_tuning_defaults()

    def __repr__(self) -> str:  # cache_token-stable (identity-free)
        return (f"ServeConfig(max_new_tokens={self.max_new_tokens}, "
                f"greedy={self.greedy}, temperature={self.temperature}, "
                f"seed={self.seed}, tuning={self.tuning})")


def widen_cache(model, cache, batch: int, max_len: int) -> tuple:
    """A prefill's cache at its decode shape: each tensor of ``cache`` into
    the zeros of ``model.init_cache_shape(batch, max_len)``, where the
    family's cache is positional (KV caches); a tensor already at its
    shape (a recurrent state, hymba's windowed cache cut to its tail) is
    kept as it is."""
    widened = []
    for got, want in zip(cache, model.init_cache_shape(batch, max_len)):
        if tuple(got.shape) == tuple(want):
            widened.append(got)
        else:
            full = torch.zeros(want, dtype=got.dtype, device=got.device)
            full[tuple(slice(0, g) for g in got.shape)] = got
            widened.append(full)
    return tuple(widened)


def _sync(x) -> None:
    """``block_until_ready(x)`` as one ``serve.sync`` span."""
    with spans.span("serve.sync"):
        block_until_ready(x)


def _prefill_compilette(model_cfg: ModelConfig, seq: int) -> Compilette:
    """Points are prefill step-programs: attention chunking variants.

    ``seq`` is the (bucketed) sequence extent bounding the chunk options.
    """
    space = product_space([
        Param("attn_q_chunk", clamped_options((32, 64, 128, 256), seq),
              phase=1, switch_rank=0),
        Param("attn_k_chunk", clamped_options((32, 64, 128, 256), seq),
              phase=1, switch_rank=1),
    ])

    def gen(point, **spec):
        cfg2 = dataclasses.replace(
            model_cfg,
            attn_q_chunk=point["attn_q_chunk"],
            attn_k_chunk=point["attn_k_chunk"],
        )
        return build_model(cfg2).prefill

    # cache_token: compilettes named "serve_prefill" exist per model
    # config; without the token the process-wide GenerationCache could
    # hand one model's compiled step-program to another with the same
    # shape specialization
    return Compilette("serve_prefill", space, gen,
                      cache_token=repr(model_cfg))


def _decode_compilette(model_cfg: ModelConfig, max_len: int) -> Compilette:
    """Points are decode step-programs: flash-decoding KV-chunk variants."""
    space = product_space([
        Param("decode_k_chunk",
              clamped_options((128, 256, 512, 1024, 4096), max_len),
              phase=1),
    ])

    def gen(point, **spec):
        cfg2 = dataclasses.replace(
            model_cfg, decode_k_chunk=point["decode_k_chunk"])
        return build_model(cfg2).decode_step

    return Compilette("serve_decode", space, gen,
                      cache_token=repr(model_cfg))


def generate(
    model_cfg: ModelConfig,
    batch: dict[str, Any],
    serve: ServeConfig | None = None,
    session: TuningSession | None = None,
) -> dict[str, Any]:
    """Prefill the prompt batch, then decode ``max_new_tokens`` greedily.

    Tuning state lives in ``session`` (one per serving process); without
    one, an ephemeral session is built from ``serve.tuning`` and closed
    when the request finishes. Everything runs on the device of
    ``batch["tokens"]``; without ``batch["params"]``, params are drawn
    there from ``serve.seed``.

    The call is one ``serve.generate`` span with a request number of its
    own (:mod:`repro_torch.runtime.spans`); ``prefill_s``, ``decode_s``
    and ``tune_init_s`` are sums of its spans.
    """
    B, T = batch["tokens"].shape
    serve = serve or ServeConfig()
    with spans.request(batch=B, length=T,
                       new_tokens=serve.max_new_tokens) as req:
        return _generate(model_cfg, batch, serve, session, req)


def _generate(model_cfg, batch, serve, session, req) -> dict[str, Any]:
    tcfg = serve.tuning
    if tcfg.kernel_tuning not in KERNEL_TUNING_MODES:
        raise ValueError(
            f"kernel_tuning must be one of {KERNEL_TUNING_MODES}, "
            f"got {tcfg.kernel_tuning!r}")
    tune_program = tcfg.tune_program
    tune_kernels = tcfg.tune_kernels
    tuning = tune_program or tune_kernels
    own_session = False
    if tuning and session is None:
        session = TuningSession(tcfg)
        own_session = True
    model = build_model(model_cfg)
    device = batch["tokens"].device
    params = batch.pop("params", None)
    if params is None:
        params = init_tree(
            model.param_defs(),
            torch.Generator(device=device).manual_seed(serve.seed),
            dtype=model_cfg.param_dtype, device=device)

    B, T = batch["tokens"].shape
    max_len = T + serve.max_new_tokens
    if model_cfg.family == "vlm":
        max_len += model_cfg.vision_patches

    prefill = model.prefill
    decode = model.decode_step

    # ---- online tuning: step-programs + constituent kernels -------------
    decode_state: dict[str, Any] = {}
    if tune_kernels:
        # Hierarchical registration, kernel level: the model's
        # constituent kernels become independent session-managed
        # compilettes (own space/strategy/registry key), drawing
        # regeneration slots from the same shared budget as the
        # step-programs. Untunable shapes (every point a hole at a
        # reduced size) are skipped, not fatal.
        session.attach_kernels(model_cfg, batch=B, seq=T, max_len=max_len,
                               device=device)
    if tune_program:
        # The compilette's chunk options are bounded by the BUCKETED
        # extent, matching the bucketed specialization key the
        # session registers under — so seq 120 and 150 build the
        # identical 128-bucket space and share one tuner.
        seq_b = session.coordinator.lifecycle.bucket_length(T)
        prefill_ev = Evaluator(
            mode="real", real_runs=1, warmup=1,
            make_args=lambda: (params, batch))
        prefill = session.register(
            "serve_prefill", _prefill_compilette(model_cfg, seq_b),
            prefill_ev,
            specialization={"seq": T, "batch": B},
            reference_fn=prefill,
        )
        # register() is idempotent across requests: point the (possibly
        # pre-existing) evaluator at THIS request's inputs so measurements
        # stay representative of live traffic.
        prefill.tuner.evaluator.make_args = prefill_ev.make_args

    # The session scope stays active for the whole request: step-programs
    # run in here adopt tuned kernel block sizes, and any eager kernel
    # call outside a step-program routes through its managed handle.
    scope_ctx = session.scope() if session is not None \
        else contextlib.nullcontext()
    try:
        with scope_ctx:
            return _generate_inner(
                model_cfg, model, params, batch, serve, session,
                prefill, decode, B, T, max_len, tuning, tune_program,
                decode_state, req)
    finally:
        if own_session:
            session.close()


def _generate_inner(
    model_cfg, model, params, batch, serve, session,
    prefill, decode, B, T, max_len, tuning, tune_program,
    decode_state, req,
) -> dict[str, Any]:
    # Busy-time credit for unmanaged step-programs: with kernel-only
    # tuning the prefill/decode calls are real traffic a busy-time
    # budget must accrue from, but no ManagedTuner counts them (a
    # managed step reports its own calls — never double-credit).
    credit_busy = tuning and not tune_program

    with spans.span("serve.prefill") as sp_prefill:
        logits, cache = prefill(params, batch)
        if credit_busy:
            _sync(logits)
            session.observe_busy(sp_prefill.elapsed())
        cache = widen_cache(model, cache, B, max_len)
        _sync(cache[0])

    tokens = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out_tokens = [tokens]
    pos0 = T if model_cfg.family != "vlm" else T + model_cfg.vision_patches

    if tune_program:
        # The decode evaluator replays the *current* decoding state; its
        # outputs are discarded, so measurement is side-effect-free.
        decode_state.update(cache=cache, tokens=tokens, pos=pos0)
        max_len_b = session.coordinator.lifecycle.bucket_length(max_len)
        decode_ev = Evaluator(
            mode="real", real_runs=1, warmup=1,
            make_args=lambda: (params, decode_state["cache"],
                               decode_state["tokens"], decode_state["pos"]))
        decode = session.register(
            "serve_decode", _decode_compilette(model_cfg, max_len_b),
            decode_ev,
            specialization={"max_len": max_len, "batch": B},
            reference_fn=decode,
        )
        decode.tuner.evaluator.make_args = decode_ev.make_args

    for i in range(serve.max_new_tokens - 1):
        with spans.span("serve.decode_step") as step:
            logits, cache = decode(params, cache, tokens, pos0 + i)
            tokens = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out_tokens.append(tokens)
            if tuning:
                if credit_busy:
                    # sync before crediting: CUDA launches are asynchronous,
                    # so without it the credited interval would be the
                    # enqueue time (µs) while the device executes inside
                    # the final sync — and a busy-time budget would starve
                    # exactly the kernel tuning this credit exists to fund
                    _sync(tokens)
                    session.observe_busy(step.elapsed())
                if tune_program:
                    decode_state.update(
                        cache=cache, tokens=tokens, pos=pos0 + i + 1)
                session.maybe_pump()
    _sync(tokens)
    # the decode steps and the sync that closes them
    t_decode = req.kid_seconds("serve.decode_step") + req.kid_seconds("serve.sync")

    generated = torch.cat(out_tokens, dim=1)
    n_decoded = generated.shape[1] - 1     # the prefill gave the first
    out = {
        "tokens": generated,
        "prefill_s": sp_prefill.seconds,
        "decode_s": t_decode,
        "decode_tokens_per_s": (B * n_decoded / t_decode
                                if t_decode > 0 else 0.0),
    }
    if tuning:
        session.save()
        # Lifecycle pass at request end: converged tuners release the
        # evaluator closures pinning this request's params/batch/cache,
        # and tuners idle past the eviction horizon are unregistered.
        session.sweep()
        out["tune_init_s"] = req.kid_seconds("tune.register")
        out["kernel_tuning"] = serve.tuning.kernel_tuning
        out["autotune"] = session.stats()
    return out
