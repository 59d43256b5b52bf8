"""Gradient compression: int8 quantization with error feedback (EF-SGD).

Mirrors ``repro/distributed/compression.py``: the numerics (quantize,
dequantize, error feedback) the train loop applies with
``compress_grads``. On a cluster the quantized tensors are what crosses
the data-parallel axis; as in the reference, the train loop applies the
numerics and no collective of its own.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads: Any) -> Any:
    return tree_map(quantize_int8, grads)


class ErrorFeedback:
    """Residual accumulator: e ← g + e − deq(quant(g + e))."""

    def init(self, params: Any) -> Any:
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def apply(self, grads: Any, errors: Any) -> tuple[Any, Any]:
        def one(g, e):
            corrected = g.to(torch.float32) + e
            q, scale = quantize_int8(corrected)
            deq = dequantize_int8(q, scale)
            return deq, corrected - deq

        out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(errors))]
        return (tree_unflatten(grads, [o[0] for o in out]),
                tree_unflatten(errors, [o[1] for o in out]))
