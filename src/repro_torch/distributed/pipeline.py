"""GPipe-style pipeline parallelism over ``torch.distributed``.

Mirrors ``repro/distributed/pipeline.py``, tick for tick: layer stages
lie along a ``pipe`` mesh axis; microbatches stream through the stages,
a ring send and receive (``batch_isend_irecv`` over the axis's group,
where the reference uses ``ppermute``) moving each stage's activation to
the next. The schedule is the classic GPipe fill-drain: with S stages
and M microbatches, S + M - 1 ticks; stage 0 injects microbatch t at
tick t, the last stage emits microbatch t - (S - 1), and at the end the
last stage's outputs reach every rank by a masked sum over the axis
(the reference's ``psum`` of a one-hot mask). Every stage applies its
layer at every tick, as the reference's does.

Point-to-point calls, not ``torch.distributed.pipelining``, so that the
ticks compare one to one with the reference's.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def pipeline_apply(
    stage_params,          # tree, leaves with leading axis S (stages)
    x: torch.Tensor,       # (M, mb, ...) microbatched input, the same on every rank
    layer_fn: Callable,    # layer_fn(stage_params_slice, h) -> h
    mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run x through S pipeline stages laid over mesh axis ``axis``;
    every rank returns the (M, mb, ...) outputs."""
    from torch.distributed.tensor import DTensor

    dim = tuple(mesh.mesh_dim_names).index(axis)
    S = mesh.size(dim)
    M = x.shape[0]
    group = mesh.get_group(dim)
    idx = mesh.get_local_rank(dim)
    # this rank's stage: its shard of a DTensor laid out over the axis,
    # else its row of the stacked leaves
    params_me = tree_map(
        lambda a: a.to_local()[0] if isinstance(a, DTensor) else a[idx],
        stage_params)
    send_to = dist.get_global_rank(group, (idx + 1) % S)
    recv_from = dist.get_global_rank(group, (idx - 1) % S)

    h = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    outs = torch.zeros_like(x)
    for t in range(M + S - 1):
        # stage 0 injects microbatch t (while filling)
        if idx == 0 and t < M:
            h = x[t]
        h = layer_fn(params_me, h)
        # the last stage emits microbatch t - (S - 1)
        emit_t = t - (S - 1)
        if idx == S - 1 and emit_t >= 0:
            outs[emit_t] = h.to(outs.dtype)
        # ring: stage i's activation moves to stage i + 1
        received = torch.empty_like(h)
        ops = [dist.P2POp(dist.isend, h.contiguous(), send_to, group),
               dist.P2POp(dist.irecv, received, recv_from, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        h = received
    # the last stage's outputs to every rank: a masked sum over the axis
    outs = outs * float(idx == S - 1)
    dist.all_reduce(outs, group=group)
    return outs
