"""Weights drawn on the device from the run's seed, in the served type.

One buffer holds every parameter; one ``normal_`` call fills it from a
``torch.Generator`` on the device, then each leaf is scaled in place and
the norm scales set to one. The leaves, their shapes and scales, and the
tree they make (the one the port reads) are the kind's
``param_layout(s)``, found from the sizes ``s`` themselves. Both the
program and the plain reference read these tensors.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from pbench.spec import kind_of


def param_layout(s: Any) -> list[tuple[tuple[str, ...], tuple[int, ...], float]]:
    """(path, shape, scale) of every leaf; scale 0 marks a norm scale (ones)."""
    return kind_of(s).param_layout(s)


def n_params(s: Any) -> int:
    return sum(math.prod(shape) for _p, shape, _s in param_layout(s))


def make_params(s: Any, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The parameter tree of ``s`` drawn from ``seed`` on ``device``."""
    layout = param_layout(s)
    buf = torch.empty(sum(math.prod(shape) for _p, shape, _s in layout),
                      dtype=dtype, device=device)
    buf.normal_(generator=torch.Generator(device=device).manual_seed(seed))
    tree: dict = {}
    at = 0
    for path, shape, scale in layout:
        n = math.prod(shape)
        leaf = buf[at:at + n].view(shape)
        at += n
        if scale:
            leaf.mul_(scale)
        else:
            leaf.fill_(1.0)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s leaves: views into the stacked tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}
