"""Production mesh builders over ``torch.distributed``'s ``DeviceMesh``.

Mirrors ``repro/launch/mesh.py``. Defined as FUNCTIONS, so importing
this module touches no process group: each builder calls
``init_device_mesh``, which needs a default group of the mesh's size
(``torchrun``, or the dry run's fake group).
"""

from __future__ import annotations

from repro_torch.distributed import sharding as shlib


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A named mesh over every rank of the default group (the reference's
    ``_mk``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def set_mesh(mesh):
    """Ambient-mesh context: ``with set_mesh(mesh): ...``."""
    return shlib.use_mesh(mesh)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 (256 GPUs) or 2x16x16 (512 GPUs) mesh: the reference's cells,
    read as 32 or 64 HGX nodes of 8 H100s. A ``model`` axis of 16 spans
    two NVLink domains of 8, so its collectives cross the nodes'
    network."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh_for(n_devices: int, model_axis: int = 2, device_type: str = "cuda"):
    """Small meshes for tests and examples (e.g. 8 = 4x2)."""
    data = n_devices // model_axis
    return make_mesh((data, model_axis), ("data", "model"), device_type)
