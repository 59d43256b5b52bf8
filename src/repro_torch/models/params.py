"""Declarative parameter definitions.

Mirrors ``repro/models/params.py``. Each model family declares its
parameters once as a nested dict of ``ParamDef`` (shape + logical axes +
initializer); ``init_tree`` materializes them, on an explicit device from
an explicit ``torch.Generator``. The tree has the reference's layout (the
stacked layers keep their leading L axis), so a JAX-initialised tree
carries over as it is (``repro_torch.interop.params_from_jax``). From
the same defs, ``spec_tree`` gives the tree of partition specs (logical
axes resolved to mesh axes by ``repro_torch.distributed.sharding``) and
``abstract_tree`` a tree of meta tensors that allocates nothing (the
dry run's stand-ins for ``jax.ShapeDtypeStruct``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]      # logical axis per dim
    init: str = "normal"              # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _iter_defs(tree: dict, path=()):
    for name in sorted(tree):
        node = tree[name]
        if isinstance(node, ParamDef):
            yield path + (name,), node
        else:
            yield from _iter_defs(node, path + (name,))


def _set(tree: dict, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def init_tree(defs: dict, generator: torch.Generator, *,
              dtype: torch.dtype = torch.float32,
              device: "torch.device | str" = "cpu") -> dict:
    """Materialize ``defs`` on ``device``: normal draws (fp32, times the
    def's scale) from ``generator``, which must live on that device.

    ``jax.random`` and torch's generators give different numbers from one
    seed; tests that compare the two packages carry the JAX tree over
    instead (``repro_torch.interop.params_from_jax``).
    """
    out: dict = {}
    for path, d in _iter_defs(defs):
        if d.init == "zeros":
            arr = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            arr = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            arr = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                              device=device).mul_(d.scale).to(dtype)
        _set(out, path, arr)
    return out


def spec_tree(defs: dict, resolve: Callable[[str | None], Any]) -> dict:
    """resolve(logical_axis) -> mesh axis name(s) or None."""
    from repro_torch.distributed.sharding import PartitionSpec as P

    out: dict = {}
    for path, d in _iter_defs(defs):
        _set(out, path, P(*(resolve(a) for a in d.axes)))
    return out


def abstract_tree(defs: dict, dtype: torch.dtype = torch.float32) -> dict:
    """Meta tensors of each def's shape and ``dtype``: no storage."""
    out: dict = {}
    for path, d in _iter_defs(defs):
        _set(out, path, torch.empty(d.shape, dtype=dtype, device="meta"))
    return out


def cast_params(params: Any, dtype: torch.dtype) -> Any:
    """Cast float parameters to the compute dtype once, before the layers
    run (a no-op, returning the same tensors, when they already have it)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.is_floating_point() \
            and params.dtype != dtype:
        return params.to(dtype)
    return params


def count_params(defs: dict) -> int:
    total = 0
    for _, d in _iter_defs(defs):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total
