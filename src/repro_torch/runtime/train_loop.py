"""Training runtime: fault-tolerant loop with integrated online auto-tuning.

Mirrors ``repro/runtime/train_loop.py`` path for path. During early
steps the online auto-tuner explores *step-program variants* (attention
chunk sizes, which on the card select the flash kernel's instantiation)
under the regeneration-budget policy, swapping the active step when a
variant measures faster; in kernel modes the model's constituent kernels
(matmul, rmsnorm, attention) tune as independent handles under the same
budget. All overheads are part of the wall time the loop reports.

Tuning is configured by the embedded :class:`~repro_torch.api.TuningConfig`
(``TrainLoopConfig.tuning``) and owned by a
:class:`~repro_torch.api.TuningSession`; the best points are persisted
next to the checkpoints (``tuned.json``), so a restarted job warm-starts
instead of re-exploring.

Fault tolerance, as in the reference: a checkpoint every ``ckpt_every``
steps (atomic, retained set, the reference's format), auto-resume from
the latest one (the data stream is a pure function of the step index),
an optional injected failure, and a straggler count (steps slower than
``straggler_factor`` x the running median).

What differs from the reference:

  * The step is eager PyTorch, not a jitted program: ``torch.autograd``
    takes the place of ``jax.value_and_grad``, and on the card the
    forward launches the rmsnorm and flash-attention hand kernels
    through their autograd Functions (their backward is plain PyTorch,
    as the reference's gradient is jnp).
  * Params are drawn by the port's ``init_tree`` from a
    ``torch.Generator`` seeded with ``loop.seed``: ``jax.random`` gives
    other numbers from the same seed, so the two packages start from
    different weights unless one tree is carried over
    (``repro_torch.interop.params_from_jax``).
  * A step's time is the host clock from the step's launch to
    ``loss.item()``, which waits for the device.
  * ``train`` runs on ``device`` (the card unless the caller asks for
    the CPU), and its result adds ``step_s`` (each step's seconds),
    ``ckpt_save_s`` and ``ckpt_restore_s`` to the reference's keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Any

import torch

from repro_torch.api import (
    KERNEL_TUNING_MODES,
    TuningConfig,
    TuningSession,
    train_tuning_defaults,
)
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import Compilette, Evaluator, Param, clamped_options, product_space
from repro_torch.core.persistence import device_fingerprint
from repro_torch.data.pipeline import batches_for, device_put_batch
from repro_torch.distributed.compression import ErrorFeedback
from repro_torch.interop import resolve_device
from repro_torch.models.model import build_model
from repro_torch.models.params import init_tree
from repro_torch.optim.adamw import AdamW, OptimizerConfig
from repro_torch.runtime.spans import mark
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["FaultInjected", "TrainLoopConfig", "train", "train_tuning_defaults"]

class TrainLoopConfig:
    """Loop knobs; tuning knobs live in the embedded ``tuning`` config.

    The reference also accepts its flat legacy tuning fields
    (``autotune``, ``tune_strategy``, ...) as aliases into ``tuning``;
    the port takes ``tuning=`` only, as ``ServeConfig`` does.
    """

    def __init__(
        self,
        steps: int = 50,
        ckpt_every: int = 20,
        ckpt_dir: str = "/tmp/repro_ckpt",
        keep: int = 3,
        seed: int = 0,
        compress_grads: bool = False,
        straggler_factor: float = 3.0,
        fail_at_step: int | None = None,
        log_every: int = 10,
        tuning: TuningConfig | None = None,
    ) -> None:
        self.steps = steps
        self.ckpt_every = ckpt_every
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.seed = seed
        self.compress_grads = compress_grads
        self.straggler_factor = straggler_factor
        self.fail_at_step = fail_at_step
        self.log_every = log_every
        self.tuning = tuning if tuning is not None else \
            train_tuning_defaults()


class FaultInjected(RuntimeError):
    pass


def _make_step(model, optimizer, ef: ErrorFeedback | None, cfg: ModelConfig):
    """One training step: loss and gradients by autograd, optional
    compression, then the functional AdamW update. Leaves its arguments
    as they were (the program tuner re-runs it on the live state). The
    phases are marked ``forward``, ``backward`` and ``update`` for a
    profiler."""
    def step(params, opt_state, ef_state, batch):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        dev = live[0].device
        with torch.enable_grad():
            with mark("forward", dev):
                loss = model.loss(tree_unflatten(params, live), batch)
            with mark("backward", dev):
                grads = tree_unflatten(params, list(torch.autograd.grad(loss, live)))
        with torch.no_grad(), mark("update", dev):
            if ef is not None:
                grads, ef_state = ef.apply(grads, ef_state)
            params, opt_state, gnorm = optimizer.update(grads, opt_state, params)
        return loss.detach(), params, opt_state, ef_state, gnorm
    return step


def _attention_step_compilette(model_cfg: ModelConfig, model, optimizer,
                               ef, sample_batch, seq: int) -> Compilette:
    """Compilette whose points are attention-chunk program variants.

    Chunk options are bounded by the training sequence length up front
    (same dedup as the serve compilettes): chunks past ``seq`` all
    give the same program, so enumerating them would waste the shared
    regeneration budget. On the card each point's clamped chunks select
    an instantiation of the flash kernel.
    """
    space = product_space([
        Param("attn_q_chunk", clamped_options((64, 128, 256), seq),
              phase=1, switch_rank=0),
        Param("attn_k_chunk", clamped_options((64, 128, 256, 512), seq),
              phase=1, switch_rank=1),
    ])

    def generate(point, **spec):
        cfg2 = dataclasses.replace(
            model_cfg,
            attn_q_chunk=point["attn_q_chunk"],
            attn_k_chunk=point["attn_k_chunk"],
        )
        return _make_step(build_model(cfg2), optimizer, ef, cfg2)

    return Compilette("train_step_attn", space, generate,
                      cache_token=repr(model_cfg))


def train(
    model_cfg: ModelConfig,
    shape: ShapeSpec,
    loop: TrainLoopConfig | None = None,
    opt_cfg: OptimizerConfig | None = None,
    *,
    device: "torch.device | str | None" = None,
) -> dict[str, Any]:
    loop = loop or TrainLoopConfig()
    tcfg = loop.tuning
    if tcfg.kernel_tuning not in KERNEL_TUNING_MODES:
        raise ValueError(
            f"kernel_tuning must be off|program|kernel|both, "
            f"got {tcfg.kernel_tuning!r}")
    dev = resolve_device(device)
    model = build_model(model_cfg)
    optimizer = AdamW(opt_cfg or OptimizerConfig(warmup_steps=10,
                                                 total_steps=loop.steps))
    ef = ErrorFeedback() if loop.compress_grads else None
    ckpt = Checkpointer(loop.ckpt_dir, keep=loop.keep)
    registry_path = f"{loop.ckpt_dir}/tuned.json"

    # ---- init or resume -------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(loop.seed)
    params = init_tree(model.param_defs(), gen, dtype=model_cfg.param_dtype,
                       device=dev)
    opt_state = optimizer.init(params)
    ef_state = ef.init(params) if ef else None
    start_step = 0
    restore_s = None
    latest = ckpt.latest_step()
    if latest is not None:
        t0 = time.perf_counter()
        # keep no name on the initial or the restored state: each is a full
        # copy on the device, and the loop rebinds params every step
        skeleton = {"params": params, "opt": opt_state}
        del params, opt_state
        state, manifest = ckpt.restore(skeleton, latest, device=dev)
        del skeleton
        params, opt_state = state.pop("params"), state.pop("opt")
        start_step = manifest["step"]
        restore_s = time.perf_counter() - t0

    # ---- step program (with optional online auto-tuning) ---------------
    stream = batches_for(model_cfg, shape, seed=loop.seed + 1,
                         start_step=start_step)
    first_batch = device_put_batch(next(stream), dev)
    raw_step = _make_step(model, optimizer, ef, model_cfg)

    session = None
    tuner = None
    evaluator = None
    tune_program = tcfg.tune_program
    tune_kernels = tcfg.tune_kernels
    if tune_program or tune_kernels:
        # One session per training process: a single regeneration budget
        # shared by every tunable step-program AND every constituent
        # kernel, warm-started from the checkpoint-adjacent registry so
        # a restarted job skips re-exploration.
        if tcfg.registry_path is None:
            tcfg = dataclasses.replace(tcfg, registry_path=registry_path)
        session = TuningSession(tcfg, device=device_fingerprint(dev))
    if tune_kernels:
        # Hierarchical registration, kernel level: each hand kernel of
        # the step tunes as an independent compilette under the shared
        # budget (untunable reduced shapes are skipped).
        B_k, T_k = first_batch["tokens"].shape
        session.attach_kernels(model_cfg, batch=B_k, seq=T_k, device=dev)
    if tune_program:
        comp = _attention_step_compilette(
            model_cfg, model, optimizer, ef, first_batch, shape.seq_len)
        spec = {"seq": shape.seq_len}
        evaluator = Evaluator(
            mode="real", real_runs=2, warmup=1,
            make_args=lambda: (params, opt_state, ef_state, first_batch))
        tuner = session.register(
            "train_step_attn", comp, evaluator,
            specialization=spec, reference_fn=raw_step,
        )

    # ---- loop ------------------------------------------------------------
    losses: list[float] = []
    durations: list[float] = []
    save_s: list[float] = []
    stragglers = 0
    t_start = time.perf_counter()
    step = start_step
    batch = first_batch
    scope_ctx = session.scope() if session is not None \
        else contextlib.nullcontext()
    try:
        with scope_ctx:
            while step < loop.steps:
                if loop.fail_at_step is not None and step == loop.fail_at_step:
                    raise FaultInjected(f"injected failure at step {step}")
                t0 = time.perf_counter()
                fn = tuner if tuner is not None else raw_step
                loss, params, opt_state, ef_state, gnorm = fn(
                    params, opt_state, ef_state, batch)
                loss = loss.item()
                if session is not None:
                    session.maybe_pump()
                dt = time.perf_counter() - t0
                durations.append(dt)
                if len(durations) >= 5:
                    med = statistics.median(durations)
                    if dt > loop.straggler_factor * med:
                        stragglers += 1
                losses.append(loss)
                step += 1
                if step % loop.ckpt_every == 0 or step == loop.steps:
                    t_save = time.perf_counter()
                    ckpt.save(step, {"params": params, "opt": opt_state},
                              extra={"loss": loss})
                    save_s.append(time.perf_counter() - t_save)
                    if session is not None:
                        session.save()
                batch = device_put_batch(next(stream), dev)
    finally:
        if evaluator is not None:
            # the session's tuners and coordinator refer to one another:
            # without this the closure would keep the last params and
            # optimizer state (15 GB at the chip smoke test's size) on
            # the device until the cycle collector next runs
            evaluator.make_args = None

    wall = time.perf_counter() - t_start
    out = {
        "steps": step,
        "start_step": start_step,
        "final_loss": losses[-1] if losses else None,
        "first_loss": losses[0] if losses else None,
        "wall_s": wall,
        "stragglers_flagged": stragglers,
        "losses": losses,
        "step_s": durations,
        "ckpt_save_s": save_s,
        "ckpt_restore_s": restore_s,
    }
    if tuner is not None:
        out["autotune"] = tuner.stats()
    if session is not None:
        session.close()
        out["coordinator"] = session.stats()
    return out
