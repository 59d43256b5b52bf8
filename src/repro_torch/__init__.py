"""repro_torch — the online auto-tuner on PyTorch and CUDA (Hopper).

The port of :mod:`repro` (JAX on a TPU), path for path: every module here
names its reference under ``src/repro/``. The subpackages
(``repro_torch.core``, ``repro_torch.kernels``, ``repro_torch.runtime``,
``repro_torch.models``, ``repro_torch.bench``) are importable directly;
the names below resolve lazily, so ``import repro_torch`` loads nothing
but this file. ``repro_torch.tune`` / ``repro_torch.tuned`` are the
session front door, as ``repro.tune`` / ``repro.tuned`` are in the
reference.
"""

import importlib

_EXPORTS = {
    "OnlineAutotuner": "repro_torch.core",
    "Evaluator": "repro_torch.core",
    "RegenerationPolicy": "repro_torch.core",
    "VirtualClock": "repro_torch.core",
    "static_autotune": "repro_torch.core",
    "get_catalog": "repro_torch.kernels",
    "TuningConfig": "repro_torch.api",
    "TuningSession": "repro_torch.api",
    "tune": "repro_torch.api",
    "tuned": "repro_torch.api",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
