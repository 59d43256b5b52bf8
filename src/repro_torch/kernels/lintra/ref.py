"""Plain PyTorch oracle for the VIPS linear-transform kernel.

Mirrors ``repro/kernels/lintra/ref.py``.
"""

from __future__ import annotations

import torch


def lintra_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[h, w, band] = a[band] * x[h, w, band] + b[band].

    ``x`` is (H, W, bands); ``a``/``b`` are (bands,).
    """
    return x * a[None, None, :] + b[None, None, :]


def lintra_ref_folded(x: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """Folded layout oracle: x (H, W*bands), ab (2, W*bands)."""
    return x * ab[0][None, :] + ab[1][None, :]
