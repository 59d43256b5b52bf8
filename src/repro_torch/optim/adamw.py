"""AdamW with global-norm clipping and a warmup + cosine schedule.

Mirrors ``repro/optim/adamw.py``: the same ``OptimizerConfig`` fields
and defaults, the same schedule (linear warmup, then cosine down to
``min_lr_frac`` of ``lr``), a global-norm clip in fp32, bias
correction, decoupled weight decay, fp32 ``m`` and ``v`` and an int32
``step``. The state mirrors the parameter tree.

``update`` is functional, as the reference's is: it returns new tensors
and changes none of its arguments. The train loop's program tuner
re-runs the step on the live state to measure a variant
(``Evaluator(make_args=lambda: (params, opt_state, ...))``); an update
in place would advance training during measurement. The scalars
(``step``, the learning rate, the norm) stay on the params' device, so
an update never waits for the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in fp32."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac
                    + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


class AdamW:
    def __init__(self, cfg: OptimizerConfig | None = None) -> None:
        self.cfg = cfg or OptimizerConfig()

    def init(self, params: Any) -> dict:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return {
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def init_abstract(self, params: Any) -> dict:
        """The state's shapes as meta tensors (fp32 ``m`` and ``v``, an
        int32 ``step``): no storage."""
        like = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
        return {
            "m": tree_map(like, params),
            "v": tree_map(like, params),
            "step": torch.empty((), dtype=torch.int32, device="meta"),
        }

    def update(self, grads: Any, state: dict, params: Any):
        """(new params, new state, global grad norm); nothing in place."""
        cfg = self.cfg
        step = state["step"] + 1
        # global-norm clip in fp32
        sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                 for g in tree_leaves(grads))
        gnorm = torch.sqrt(torch.as_tensor(sq, dtype=torch.float32,
                                           device=step.device))
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = schedule(cfg, step)
        step_f = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=step.device), step_f)
        bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=step.device), step_f)

        def upd(p, g, m, v):
            g = g.to(torch.float32) * scale
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
            mh = m / bc1
            vh = v / bc2
            p32 = p.to(torch.float32)
            delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
            return (p32 - lr * delta).to(p.dtype), m, v

        outs = [upd(*leaves) for leaves in zip(
            tree_leaves(params), tree_leaves(grads),
            tree_leaves(state["m"]), tree_leaves(state["v"]))]
        new_params, new_m, new_v = (
            tree_unflatten(params, [o[i] for o in outs]) for i in range(3))
        return new_params, {"m": new_m, "v": new_v, "step": step}, gnorm
