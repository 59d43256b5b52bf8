"""Plain PyTorch oracle for the euclidean-distance kernel.

Mirrors ``repro/kernels/euclid/ref.py``.
"""

from __future__ import annotations

import torch


def euclid_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """dist[n, m] = sum_d (x[n,d] - c[m,d])^2, computed naively in fp32."""
    x = x.to(torch.float32)
    c = c.to(torch.float32)
    diff = x[:, None, :] - c[None, :, :]
    return torch.sum(diff * diff, dim=-1)
