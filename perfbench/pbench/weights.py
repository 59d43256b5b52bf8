"""Weights drawn on the device from the run's seed, in the served type.

One buffer holds every parameter; one ``normal_`` call fills it from a
``torch.Generator`` on the device, then each leaf is scaled in place and
the norm scales set to one. The tree is laid out as the port reads it:
``tok.{embed,unembed}``, ``layers.*`` stacked on a leading layer axis,
``ln_f``. Both the program and the plain reference read these tensors.
"""

from __future__ import annotations

import math

import torch

from pbench.shapes import Shapes


def param_layout(s: Shapes) -> list[tuple[tuple[str, ...], tuple[int, ...], float]]:
    """(path, shape, scale) of every leaf; scale 0 marks a norm scale (ones)."""
    L, d, ff = s.n_layers, s.d, s.d_ff
    inv = lambda n: 1.0 / math.sqrt(n)
    leaves = [
        (("tok", "embed"), (s.vocab, d), 0.02),
        (("tok", "unembed"), (d, s.vocab), inv(d)),
        (("layers", "ln1"), (L, d), 0.0),
        (("layers", "ln2"), (L, d), 0.0),
        (("layers", "attn", "wq"), (L, d, s.heads, s.d_head), inv(d)),
        (("layers", "attn", "wk"), (L, d, s.kv_heads, s.d_head), inv(d)),
        (("layers", "attn", "wv"), (L, d, s.kv_heads, s.d_head), inv(d)),
        (("layers", "attn", "wo"), (L, s.heads, s.d_head, d), inv(s.q_width)),
        (("ln_f",), (d,), 0.0),
    ]
    if s.family == "moe":
        E = s.experts
        leaves += [
            (("layers", "ffn", "router"), (L, d, E), inv(d)),
            (("layers", "ffn", "w_gate"), (L, E, d, ff), inv(d)),
            (("layers", "ffn", "w_up"), (L, E, d, ff), inv(d)),
            (("layers", "ffn", "w_down"), (L, E, ff, d), inv(ff)),
        ]
    else:
        leaves += [
            (("layers", "ffn", "w_gate"), (L, d, ff), inv(d)),
            (("layers", "ffn", "w_up"), (L, d, ff), inv(d)),
            (("layers", "ffn", "w_down"), (L, ff, d), inv(ff)),
        ]
    return leaves


def n_params(s: Shapes) -> int:
    return sum(math.prod(shape) for _p, shape, _s in param_layout(s))


def make_params(s: Shapes, seed: int, device, dtype=torch.bfloat16) -> dict:
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
