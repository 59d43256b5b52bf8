"""Plain PyTorch oracle for the fused RMSNorm kernel.

Mirrors ``repro/kernels/rmsnorm/ref.py``.
"""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)
