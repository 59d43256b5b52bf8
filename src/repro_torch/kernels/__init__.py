# Compute hot-spot kernels (paper's tuned units) + the kernel catalog.
# Each <name>/ops.py exposes a declarative KERNEL (KernelDef); the
# catalog discovers them and builds coordinator-ready KernelCompilettes.
# Names resolve lazily, so importing a kernel module does not import the
# catalog's discovery (which imports every ops.py).

import importlib

_EXPORTS = (
    "KernelCatalog",
    "KernelCompilette",
    "KernelDef",
    "discover_kernels",
    "get_catalog",
)

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module("repro_torch.kernels.catalog"), name)
    raise AttributeError(
        f"module 'repro_torch.kernels' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
