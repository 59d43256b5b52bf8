"""Carrying state between the JAX reference and the port.

What crosses between ``repro`` and ``repro_torch`` is the kernels'
arguments (numpy arrays, made once from a seed), the tuning points
(plain dicts keyed through ``repro_torch.core.persistence._canon``, the
same JSON form the JAX registry writes) and, for the language models,
the param tree (:func:`params_from_jax`: ``jax.random`` cannot be
reproduced with torch's generators, so the tests initialise once in JAX
and carry the tree over). The helpers here place those arrays on a
device and lay the VIPS image out as the reference's folded kernel
expects it.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch


def resolve_device(device: "torch.device | str | None" = None) -> torch.device:
    """The device an entry point runs on: the card unless told otherwise.

    ``None`` means CUDA, and raises when there is no CUDA device: the port
    never carries on on the CPU unless the caller passes ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the card; pass "
                "device='cpu' to run the plain PyTorch versions instead")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def to_torch(arrays: Any, device: "torch.device | str | None" = None) -> Any:
    """numpy array(s) -> tensor(s) on ``device`` (CUDA by default).

    Takes one array, a sequence (returned as a tuple) or a mapping
    (returned as a dict). Values are copied; dtypes are kept.
    """
    dev = resolve_device(device)
    if isinstance(arrays, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(arrays)).to(dev)
    if isinstance(arrays, Mapping):
        return {k: to_torch(v, dev) for k, v in arrays.items()}
    if isinstance(arrays, Sequence):
        return tuple(to_torch(v, dev) for v in arrays)
    raise TypeError(f"expected numpy arrays, got {type(arrays).__name__}")


def fold_lintra(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W, bands) image + per-band a, b -> the folded kernel layout.

    Returns ``(x (H, W*bands), ab (2, W*bands))`` with row 0 of ``ab`` the
    tiled factors and row 1 the tiled offsets: the arguments
    ``repro.kernels.lintra.lintra.lintra_pallas`` takes.
    """
    H, W, bands = x.shape
    if a.shape != (bands,) or b.shape != (bands,):
        raise ValueError(
            f"a and b must have shape ({bands},), got {tuple(a.shape)} "
            f"and {tuple(b.shape)}")
    return x.reshape(H, W * bands), torch.stack([a.repeat(W), b.repeat(W)])


def params_from_jax(tree: Mapping[str, Any], cfg: Any,
                    device: "torch.device | str | None" = None) -> dict:
    """The JAX param tree (numpy arrays, stacked layers with their leading
    L axis) -> the port's param tree on ``device`` (CUDA by default).

    Every leaf is checked against the port's declaration of ``cfg``'s
    model (same paths, same shapes) and cast to ``cfg.param_dtype``.
    """
    from repro_torch.models.model import build_model
    from repro_torch.models.params import _iter_defs

    dev = resolve_device(device)
    out: dict = {}
    seen = set()
    for path, d in _iter_defs(build_model(cfg).param_defs()):
        node: Any = tree
        for key in path:
            if not isinstance(node, Mapping) or key not in node:
                raise KeyError(f"the JAX tree has no param {'/'.join(path)}")
            node = node[key]
        arr = np.asarray(node)
        if arr.shape != d.shape:
            raise ValueError(
                f"param {'/'.join(path)}: JAX shape {arr.shape}, port declares "
                f"{d.shape}")
        target = out
        for key in path[:-1]:
            target = target.setdefault(key, {})
        target[path[-1]] = torch.tensor(
            np.asarray(arr, dtype=np.float32)).to(dev, cfg.param_dtype)
        seen.add(path)

    def leaves(node, path=()):
        for k, v in node.items():
            if isinstance(v, Mapping):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,)

    extra = sorted("/".join(p) for p in leaves(tree) if p not in seen)
    if extra:
        raise ValueError(f"the JAX tree has params the port does not declare: {extra}")
    return out
