"""Logical-axis sharding rules (DP/FSDP/TP/EP + decode-SP) on DTensor.

Mirrors ``repro/distributed/sharding.py``. Models annotate params and
activations with *logical* axes ("embed", "heads", "batch", ...). Rules
map logical axes to mesh axes:

  batch   -> (pod, data)     data parallelism across pods and the data axis
  embed   -> (pod, data)     FSDP (ZeRO-3) weight sharding on the embed dim
  heads / kv / ffn / expert / vocab -> model   tensor/expert parallelism
  kv_seq  -> model            decode-time KV sequence parallelism (SP) used
                             when kv head sharding is unavailable
  layers / seq / state -> None (replicated / unsharded)

``default_rules``, ``resolve``, ``resolver`` and ``use_rules`` are the
reference's, as they are. :class:`PartitionSpec` stands in for JAX's: a
tuple with one entry per tensor dim, each a mesh-axis name, a tuple of
names or ``None``. :func:`placements` turns a spec into DTensor
placements on a named ``DeviceMesh``; :func:`shard` is the counterpart of
``with_sharding_constraint``: inside a rules scope it redistributes a
DTensor to the resolved placements, and anywhere else it returns its
argument after one global check. :func:`pinned` runs a region (a
product, a norm, a lookup) on local shards with every placement stated
in the same logical axes, so that DTensor's own sharding strategies,
which differ from one PyTorch version to the next, decide nothing there.

A dim that does not divide its mesh axes (40 heads over 16) is sharded
unevenly by DTensor, where GSPMD pads it: the port's roofline shows no
padding waste.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch

_ACTIVE_RULES: dict[str, Any] | None = None
_ACTIVE_MESH = None


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names (one
    dim over several mesh axes, major first) or ``None``. A tuple of one
    name is that name, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def default_rules(multi_pod: bool = False, **overrides: Any) -> dict[str, Any]:
    fsdp = ("pod", "data") if multi_pod else ("data",)
    rules: dict[str, Any] = {
        "batch": fsdp,
        "embed": fsdp,
        "heads": "model",
        "kv": "model",
        "ffn": "model",
        "expert": "model",
        "vocab": "model",
        "kv_seq": None,
        "kv_dh": None,     # decode-cache head_dim sharding (awkward kv counts)
        "seq": None,
        "layers": None,
        "state": None,
        "groups": fsdp,     # MoE dispatch groups follow the batch
        # Activations: the residual (embed) dim stays unsharded — "embed"
        # means FSDP only for *weights*; shard() translates it.
        "act_embed": None,
    }
    rules.update(overrides)
    return rules


def resolve(axis: str | None):
    if axis is None:
        return None
    if _ACTIVE_RULES is None:
        return None
    return _ACTIVE_RULES.get(axis)


def resolver():
    """Capture the current rules into a resolve callable (for spec_tree)."""
    rules = dict(_ACTIVE_RULES or {})

    def _resolve(axis: str | None):
        if axis is None:
            return None
        return rules.get(axis)

    return _resolve


@contextlib.contextmanager
def use_rules(rules: dict[str, Any] | None):
    global _ACTIVE_RULES
    prev = _ACTIVE_RULES
    _ACTIVE_RULES = rules
    try:
        yield
    finally:
        _ACTIVE_RULES = prev


@contextlib.contextmanager
def use_mesh(mesh):
    """The ambient mesh :func:`shard` reads (``launch.mesh.set_mesh``)."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim that tensor dim ``dim`` names, ``Replicate()`` elsewhere. A
    tuple entry shards one tensor dim over several mesh dims, the first
    named the major one, as GSPMD lays it out."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(ax)] = Shard(dim)
    return tuple(out)


def spec_of(axes: tuple) -> PartitionSpec:
    """The spec of logical ``axes`` under the active rules, with the
    activation-side ``embed`` -> ``act_embed`` translation."""
    axes = tuple("act_embed" if a == "embed" else a for a in axes)
    return P(*(resolve(a) for a in axes))


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Logical sharding constraint; the identity outside a rules scope
    and on a plain tensor.

    Activation-side translation: "embed" (a *weight* FSDP axis) resolves to
    the activation rule "act_embed" (unsharded by default) so batch/embed
    never collide on one tensor.
    """
    if _ACTIVE_RULES is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = _ACTIVE_MESH if _ACTIVE_MESH is not None else x.device_mesh
    spec = spec_of(axes)
    if "batch" in axes and not splits_evenly(x.shape[axes.index("batch")], "batch", mesh):
        # a batch that does not split over its mesh axes stays whole, as
        # :func:`pinned` keeps it (an uneven split of it would leave the
        # ops between regions to DTensor's version-dependent rules)
        spec = P(*(None if a == "batch" else e for a, e in zip(axes, spec)))
    target = placements(spec, mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (one global check when none can be)."""
    if _ACTIVE_RULES is None and _ACTIVE_MESH is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def settle(x):
    """``x`` with any pending (partial) reduction carried out."""
    from torch.distributed.tensor import Partial, Replicate

    if any(isinstance(p, Partial) for p in x.placements):
        return x.redistribute(x.device_mesh, tuple(
            Replicate() if isinstance(p, Partial) else p for p in x.placements))
    return x


def replicated(x):
    """``x`` whole on every rank."""
    from torch.distributed.tensor import Replicate

    target = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == target else \
        x.redistribute(x.device_mesh, target)


def local_shape_offset(shape, placements_, mesh) -> tuple[list, list]:
    """This rank's local shape and global offset of a tensor of global
    ``shape`` laid out as ``placements_`` on ``mesh``: DTensor's split
    (``torch.chunk``'s sizes, mesh dims major first), in plain Python
    (tensor arithmetic would be traced)."""
    size, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements_):
        if p.is_shard():
            d = p.dim
            k = mesh.size(i)
            chunk = -(-size[d] // k)
            start = min(coord[i] * chunk, size[d])
            off[d], size[d] = off[d] + start, max(0, min(chunk, size[d] - start))
    return size, off


def local_range(x, dim: int) -> tuple[int, int]:
    """(size, global offset) of this rank's part of DTensor ``x``'s dim
    ``dim``."""
    size, off = local_shape_offset(x.shape, x.placements, x.device_mesh)
    return size[dim], off[dim]


def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def template(x, shape, dtype, placements_=None):
    """A stand-in for :func:`on_local`'s results: ``x``'s mesh and
    placements (or ``placements_``) at global ``shape``, no storage."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        torch.empty(0, dtype=dtype, device="meta"), x.device_mesh,
        placements_ if placements_ is not None else x.placements,
        run_check=False, shape=torch.Size(shape), stride=contiguous_stride(shape))


def partial_over(x) -> tuple:
    """The placements of a gradient that each rank computes from its own
    shard of ``x`` for a weight replicated wherever ``x`` is not sharded:
    a pending sum over the mesh dims that shard ``x``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in x.placements)


def global_stride(local: torch.Tensor, shape) -> tuple[int, ...]:
    """The stride of a tensor of global ``shape`` laid out in memory as
    ``local`` is (its dims in the same order)."""
    order = sorted(range(local.dim()), key=lambda d: (local.stride(d), -d))
    stride = [0] * local.dim()
    acc = 1
    for d in order:
        stride[d] = acc
        acc *= shape[d]
    return tuple(stride)


def on_local(fn, *args, out_like, grad_placements=None):
    """``fn`` over the local shards of its DTensor arguments (the
    counterpart of a ``shard_map`` region, as ``local_map``): each result
    is wrapped as a DTensor with the mesh, placements, shape and stride
    of ``out_like`` (one template, or one per result of a tuple). The
    arguments must hold no pending reduction (:func:`settle`).

    ``grad_placements`` gives, per argument, the placements of the
    gradient ``fn`` produces for its local shard (``None``: the
    argument's own); a replicated weight whose gradient each rank sums
    over its own rows takes :func:`partial_over` of those rows.
    """
    from torch.distributed.tensor import DTensor

    grad_placements = grad_placements or (None,) * len(args)
    local = [a.to_local(grad_placements=g if g is not None else a.placements)
             if isinstance(a, DTensor) else a
             for a, g in zip(args, grad_placements)]
    out = fn(*local)

    def wrap(t, like):
        return DTensor.from_local(t, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=global_stride(t, like.shape))

    if isinstance(out, tuple):
        likes = out_like if isinstance(out_like, tuple) else (out_like,) * len(out)
        return tuple(wrap(t, like) for t, like in zip(out, likes))
    return wrap(out, out_like)


def _logical_placements(axes, mesh, contract: bool = False) -> tuple:
    """The placements of a tensor whose dims carry the logical ``axes``
    under the active rules (``embed`` read as an activation's
    ``act_embed``; with ``contract``, as the weights' FSDP dim, and
    ``batch`` whole). A dim that does not divide its mesh axes (40 heads
    over 16) is split unevenly, where GSPMD would pad it."""
    sub = {"embed": "embed", "batch": None} if contract else {"embed": "act_embed"}
    return placements(P(*(resolve(sub.get(a, a)) for a in axes)), mesh)


def pinned_range(shape, axes, mesh, dim: int) -> tuple[int, int]:
    """(size, global offset) of this rank's part of dim ``dim`` of a
    tensor of ``shape`` that :func:`pinned` lays out by the logical
    ``axes`` (``dim`` neither ``batch`` nor ``embed``)."""
    size, off = local_shape_offset(shape, _logical_placements(axes, mesh), mesh)
    return size[dim], off[dim]


def splits_evenly(n: int, axis, mesh) -> bool:
    """Whether a dim of ``n`` carrying the logical ``axis`` is split over
    its mesh axes into parts of one size."""
    entry = resolve(axis)
    if entry is None:
        return False
    names = tuple(mesh.mesh_dim_names)
    k = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        k *= mesh.size(names.index(a))
    return n % k == 0


def _fsdp_dims(mesh) -> set:
    """The mesh dims that split the weights' FSDP (``embed``) dim."""
    entry = resolve("embed") or ()
    names = tuple(mesh.mesh_dim_names)
    return {names.index(a) for a in (entry if isinstance(entry, tuple) else (entry,))}


def pinned(fn, *args, axes, out_axes, out_shape, out_dtype=None):
    """``fn`` over local shards with every placement stated in the
    rules' logical axes, so that no product, view or gradient of the
    region is left to DTensor's own sharding strategies (which differ
    from one PyTorch version to the next).

    Each DTensor argument ``i`` is first laid out by ``axes[i]``: one
    logical axis or ``None`` per dim, where an activation's residual dim
    is written ``embed``; or ``None`` for a weight taken as its spec laid
    it out. The batch rows stay split and the weights' FSDP dim is
    gathered, as GSPMD lays the reference out, unless the batch does not
    split evenly over its mesh axes (the one row of a long decode over 16
    data ranks): then the batch is whole on every rank and the region
    contracts over the FSDP dim instead, weights keeping their shard and
    activations splitting their ``embed`` dim alike, so that every rank
    takes its share of each product. ``fn`` gets the local shards and
    returns the rank's part of a result of global ``out_shape`` laid out
    by ``out_axes`` (or a tuple of results: then ``out_axes``,
    ``out_shape`` and ``out_dtype`` are tuples). A mesh dim that splits
    some argument but no dim of a result is a contraction: that result
    holds a pending sum over it, so ``fn`` must be linear in what such a
    mesh dim splits. An argument's gradient keeps its own shards and, on
    a mesh dim where it is whole while an argument or a result is split,
    is that pending sum (each rank's share). Other arguments pass as
    they are.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate

    like = next(a for a in args if isinstance(a, DTensor))
    mesh = like.device_mesh
    contract = any(isinstance(a, DTensor) and ax is not None and "batch" in ax
                   and not splits_evenly(a.shape[ax.index("batch")], "batch", mesh)
                   for a, ax in zip(args, axes))
    fsdp = _fsdp_dims(mesh)
    many = not isinstance(out_shape[0], int)
    outs = list(zip(out_axes, out_shape, out_dtype)) if many else \
        [(out_axes, out_shape, out_dtype)]
    laid, split = [], set()
    for a, ax in zip(args, axes):
        if not isinstance(a, DTensor):
            laid.append((a, None))
            continue
        if ax is not None:
            pl = _logical_placements(ax, mesh, contract)
        elif contract:
            pl = tuple(a.placements)
        else:
            pl = tuple(Replicate() if i in fsdp else p for i, p in enumerate(a.placements))
        split.update(i for i, p in enumerate(pl) if p.is_shard())
        laid.append((a if tuple(a.placements) == pl else a.redistribute(mesh, pl), pl))
    likes, made = [], set(split)
    for ax, shape, dtype in outs:
        pl = _logical_placements(ax, mesh, contract)
        made.update(i for i, p in enumerate(pl) if p.is_shard())
        pl = tuple(Partial() if i in split and not p.is_shard() else p
                   for i, p in enumerate(pl))
        likes.append(template(like, shape, dtype or like.dtype, pl))
    grads = tuple(None if pl is None else tuple(
        Partial() if i in made and not p.is_shard() else p for i, p in enumerate(pl))
        for _, pl in laid)
    return on_local(fn, *(a for a, _ in laid),
                    out_like=tuple(likes) if many else likes[0], grad_placements=grads)
