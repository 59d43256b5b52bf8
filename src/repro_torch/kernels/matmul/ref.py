"""Plain PyTorch oracle for the tiled matmul kernel.

Mirrors ``repro/kernels/matmul/ref.py``: one fp32 product. On the card
that is cuBLAS in full fp32 as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False, PyTorch's
default.
"""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(out_dtype)
