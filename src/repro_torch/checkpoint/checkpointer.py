"""Fault-tolerant checkpointing, in the reference's on-disk format.

Mirrors ``repro/checkpoint/checkpointer.py``:

  * **Format**: one ``arrays.npz`` keyed by leaf path (``params/tok/embed``,
    ``opt/step``, ...) plus a JSON ``manifest.json``, the unsharded
    logical arrays. A checkpoint written by either package restores in
    the other.
  * **Atomicity**: write to ``<dir>/tmp.<uuid>``, fsync the manifest,
    then ``os.replace`` into ``step_<N>`` and update the ``LATEST``
    pointer atomically: a preempted writer never corrupts the latest
    checkpoint.
  * **Retention**: keep the newest ``keep`` checkpoints.

Tensors are copied to the host to be written; ``restore`` places the
leaves on ``device``.

**Sharded state** (the reference's elastic restore): a DTensor leaf is
saved whole, so a checkpoint does not depend on the mesh that wrote it.
Gathering a DTensor is a collective: in a group, every rank calls
``save`` (rank 0 alone writes, then all wait for it). ``restore(...,
shardings=)`` takes a tree of ``(mesh, placements)`` and lays each leaf
out on its (possibly different) mesh; every rank reads the file.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, path=()) -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], path + (str(k),)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, path + (str(i),)))
    else:
        out["/".join(path)] = tree
    return out


def _unflatten_into(skeleton: Any, flat: dict[str, Any], path=()) -> Any:
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(v, flat, path + (str(k),))
                for k, v in skeleton.items()}
    if isinstance(skeleton, tuple):
        return tuple(_unflatten_into(v, flat, path + (str(i),))
                     for i, v in enumerate(skeleton))
    if isinstance(skeleton, list):
        return [_unflatten_into(v, flat, path + (str(i),))
                for i, v in enumerate(skeleton)]
    return flat["/".join(path)]


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()       # a collective: every rank calls it
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _is_dtensor(x: Any) -> bool:
    if not torch.distributed.is_available() or not torch.distributed.is_initialized():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _writer() -> bool:
    """Whether this process writes: rank 0 of a group, or the only one."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _barrier() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- saving
    def save(self, step: int, state: Any, extra: dict | None = None) -> str:
        flat = _flatten(state)
        arrays = {k: _to_numpy(v) for k, v in flat.items()}
        final = os.path.join(self.dir, f"step_{step:010d}")
        if not _writer():
            _barrier()
            return final
        tmp = os.path.join(self.dir, f"tmp.{uuid.uuid4().hex}")
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                       # atomic publish
        self._update_latest(step)
        self._gc()
        _barrier()
        return final

    def _update_latest(self, step: int) -> None:
        tmp = os.path.join(self.dir, f".latest.{uuid.uuid4().hex}")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(self.dir, "LATEST"))

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------ loading
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            steps = self.all_steps()
            return steps[-1] if steps else None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, skeleton: Any, step: int | None = None, *,
                device: "torch.device | str | None" = None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Restore into ``skeleton``'s structure: a tensor per leaf, on
        ``device`` (each skeleton tensor's own device when None); with
        ``shardings`` (a tree of ``(mesh, placements)`` shaped like
        ``skeleton``), each leaf laid out as a DTensor on its mesh."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            flat = {k: data[k] for k in data.files}

        placed = {
            path: torch.from_numpy(flat[path]).to(
                device if device is not None else getattr(like, "device", "cpu"))
            for path, like in _flatten(skeleton).items()}
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor

            layouts = _flatten_layouts(shardings)
            # every rank read the whole array: no rank sends its data
            placed = {path: distribute_tensor(
                t.to(layouts[path][0].device_type), *layouts[path], src_data_rank=None)
                for path, t in placed.items()}
        return _unflatten_into(skeleton, placed), manifest


def _flatten_layouts(tree: Any, path=()) -> dict[str, tuple]:
    """``_flatten`` of a tree whose leaves are ``(mesh, placements)``."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_layouts(tree[k], path + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)) and not (
            len(tree) == 2 and hasattr(tree[0], "mesh_dim_names")):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten_layouts(v, path + (str(i),)))
        return out
    return {"/".join(path): tuple(tree)}
