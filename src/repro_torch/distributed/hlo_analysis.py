"""Per-device cost analysis of a traced step: the roofline's inputs.

Mirrors ``repro/distributed/hlo_analysis.py`` (the file keeps its name so
the counterpart is easy to find), but walks the per-device ATen FX graph
that ``make_fx(step, tracing_mode="fake")`` gives of a DTensor program
whose arguments are the local shards, not HLO text. DTensor lowers
every global op to the rank's local ops plus ``_c10d_functional``
collectives, so that graph is the counterpart of the compiled SPMD
module. (A dispatch mode entered around DTensor code, such as
``FlopCounterMode``, sees the global ops instead: its counts are not per
device.) It rolls up:

  * FLOPs: ``torch.utils.flop_counter``'s formulas on the nodes' fake
    shapes (products, convolutions, attention);
  * HBM bytes: operand plus result bytes of the materialising ops, the
    reference's fusion model: products, copies and materialising
    transposes (``clone``), ``cat``, pad, scatter and ``index_put``,
    reductions, sort and top-k, collectives; gathers and slices touch
    their result twice. Elementwise ops, casts and views are fused into
    their neighbours and cost nothing;
  * collective link bytes by the reference's ring model: all-reduce
    2N(g-1)/g, reduce-scatter N(g-1), the others N(g-1)/g, with N the
    result's bytes and g the size of the node's group.

The reference multiplies ``while`` bodies by their trip counts; Python
loops (layers, microbatches, attention chunks) leave every iteration in
the graph, so nothing is multiplied here. Shapes come from each node's
``meta["val"]``; a tensor the tracer made a constant (``get_attr``) is
read from the module. :func:`memory_analysis` walks the same graph for
the per-device peak: arguments, the live intermediates at each node and
the outputs, less the donated arguments once they are dead.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any

import torch

_PRODUCTS = {
    "mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
    "convolution_backward", "_scaled_mm",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_flash_attention_backward",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_efficient_attention_backward",
    "_flash_attention_forward", "_flash_attention_backward",
    "_efficient_attention_forward", "_efficient_attention_backward",
}
_MATERIALIZING = _PRODUCTS | {
    "clone", "copy", "copy_", "cat", "constant_pad_nd", "pad",
    "reflection_pad1d", "replication_pad1d",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "index_put", "index_put_", "_index_put_impl_", "index_add", "index_add_",
    "index_copy", "index_copy_", "slice_scatter", "select_scatter",
    "embedding_dense_backward",
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp", "var",
    "var_mean", "std", "norm", "linalg_vector_norm", "prod", "argmax",
    "argmin", "cumsum", "cumprod", "any", "all",
    "_log_softmax", "_softmax", "_log_softmax_backward_data",
    "_softmax_backward_data",
    "sort", "topk",
}
# gathers and slices touch the slice, not their operand
_GATHERS = {"gather", "index", "index_select", "embedding", "take"}

#: ops that alias their first argument's storage
_VIEWS = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t", "expand",
    "select", "slice", "unsqueeze", "squeeze", "alias", "as_strided",
    "detach", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "view_as", "unflatten", "flatten", "diagonal", "lift_fresh",
    "_reshape_alias", "movedim", "unfold", "real", "view_as_real",
}


def _op_name(node) -> str:
    target = node.target
    packet = getattr(target, "_overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def _namespace(node) -> str:
    return getattr(node.target, "namespace", "")


def _is_collective(node) -> bool:
    return _namespace(node).startswith("_c10d_functional") and \
        not _op_name(node).startswith("wait_tensor")


def _val(gm, node) -> Any:
    if not isinstance(node, torch.fx.Node):
        return node
    if node.op == "get_attr":
        return getattr(gm, node.target, None)
    return node.meta.get("val")


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    if isinstance(v, (list, tuple)):
        return sum(_nbytes(x) for x in v)
    return 0


def _arg_vals(gm, node) -> tuple[list, dict]:
    def conv(a):
        if isinstance(a, torch.fx.Node):
            return _val(gm, a)
        if isinstance(a, (list, tuple)):
            return type(a)(conv(x) for x in a)
        return a
    return [conv(a) for a in node.args], {k: conv(v) for k, v in node.kwargs.items()}


def _operand_bytes(gm, node) -> int:
    seen: set = set()
    total = 0
    for a in node.all_input_nodes:
        if a in seen:
            continue
        seen.add(a)
        total += _nbytes(_val(gm, a))
    return total


def group_size(node) -> int:
    """The size of a collective node's group: its ``group_size`` argument
    where it has one, else the named process group's size."""
    name = _op_name(node)
    if name.startswith(("all_gather_into_tensor", "reduce_scatter_tensor")):
        return int(node.args[1] if name.startswith("all_gather") else node.args[2])
    group = node.args[-1]
    try:
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(group).size()
    except Exception:
        return torch.distributed.get_world_size() \
            if torch.distributed.is_initialized() else 1


def collective_kind(node) -> str:
    """The reference's name for a collective node's kind."""
    name = _op_name(node)
    if name.startswith("all_reduce"):
        return "all-reduce"
    if name.startswith("all_gather"):
        return "all-gather"
    if name.startswith("reduce_scatter"):
        return "reduce-scatter"
    if name.startswith("all_to_all"):
        return "all-to-all"
    return "collective-permute"


def link_bytes(kind: str, out_bytes: float, g: int) -> float:
    """Ring-model bytes crossing one device's links."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    return out_bytes * (g - 1) / g


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_per_op: dict = dataclasses.field(default_factory=dict)

    def add(self, other: "Totals", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_bytes += other.coll_bytes * mult
        for k, v in other.coll_per_op.items():
            self.coll_per_op[k] = self.coll_per_op.get(k, 0.0) + v * mult


def node_flops(gm, node) -> float:
    """``torch.utils.flop_counter``'s count for one node (0 for ops it
    has no formula for)."""
    from torch.utils.flop_counter import flop_registry

    packet = getattr(node.target, "_overloadpacket", None)
    if packet is None or packet not in flop_registry:
        return 0.0
    args, kwargs = _arg_vals(gm, node)
    return float(flop_registry[packet](*args, **kwargs, out_val=_val(gm, node)))


def analyze_graph(gm) -> Totals:
    t = Totals()
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = _op_name(node)
        t.flops += node_flops(gm, node)
        if _is_collective(node):
            out_b = _nbytes(_val(gm, node))
            kind = collective_kind(node)
            traffic = link_bytes(kind, out_b, group_size(node))
            t.coll_bytes += traffic
            t.coll_per_op[kind] = t.coll_per_op.get(kind, 0.0) + traffic
            t.bytes += _operand_bytes(gm, node) + out_b
        elif name in _GATHERS:
            t.bytes += 2.0 * _nbytes(_val(gm, node))
        elif name in _MATERIALIZING:
            t.bytes += _operand_bytes(gm, node) + _nbytes(_val(gm, node))
    return t


def cost_analysis(gm) -> dict:
    """The counterpart of ``compiled_cost_analysis``: ``flops`` and
    ``bytes accessed`` of the per-device graph."""
    t = analyze_graph(gm)
    return {"flops": t.flops, "bytes accessed": t.bytes}


def collective_nodes(gm) -> list:
    """(kind, result bytes, group size) of every collective node."""
    return [(collective_kind(n), _nbytes(_val(gm, n)), group_size(n))
            for n in gm.graph.nodes
            if n.op == "call_function" and _is_collective(n)]


def memory_analysis(gm, donated: "set[int] | None" = None) -> dict:
    """Per-device bytes by a liveness walk over ``gm``.

    ``donated`` holds indices of placeholders (in graph order) whose
    storage the step may reuse once they are dead, as the reference's
    ``donate_argnums``. Views share their base's storage; a storage is
    freed after its last reader, unless it is an argument that is not
    donated or an output.
    """
    donated = donated or set()
    nodes = list(gm.graph.nodes)
    root: dict = {}
    size: dict = {}
    last: dict = {}
    args_b = 0
    alias_b = 0
    placeholders = [n for n in nodes if n.op == "placeholder"]
    for i, n in enumerate(placeholders):
        b = _nbytes(_val(gm, n))
        args_b += b
        if i in donated:
            alias_b += b
    output = next(n for n in nodes if n.op == "output")
    out_roots: set = set()
    for idx, n in enumerate(nodes):
        if n.op == "call_function" and n.args \
                and isinstance(n.args[0], torch.fx.Node) \
                and (_op_name(n) in _VIEWS or n.target is operator.getitem):
            # a view, or one result of a multi-result op: the storage is
            # its base's (a multi-result op's size counts every result)
            root[n] = root.get(n.args[0], n.args[0])
        else:
            root[n] = n
            if n.op in ("call_function", "get_attr"):
                size[n] = _nbytes(_val(gm, n))
        # a value no node reads dies where it is made
        last[root[n]] = max(last.get(root[n], idx), idx)
        for a in n.all_input_nodes:
            last[root[a]] = idx
    for a in output.all_input_nodes:
        out_roots.add(root[a])
    pinned = {n for i, n in enumerate(placeholders) if i not in donated}
    frees: dict[int, list] = {}
    for r, idx in last.items():
        if r in out_roots or r in pinned:
            continue
        frees.setdefault(idx, []).append(r)
    live = args_b
    peak = live
    temp_peak = 0
    temp = 0
    for idx, n in enumerate(nodes):
        if root.get(n) is n and n in size:
            live += size[n]
            temp += size[n]
        peak = max(peak, live)
        temp_peak = max(temp_peak, temp)
        for r in frees.get(idx, ()):
            b = size.get(r, _nbytes(_val(gm, r)) if r.op == "placeholder" else 0)
            live -= b
            if r.op != "placeholder":
                temp -= b
    out_b = sum(size.get(r, 0) for r in out_roots)
    return {
        "argument_bytes": args_b,
        "output_bytes": out_b,
        "temp_bytes": temp_peak,
        "alias_bytes": alias_b,
        "peak_bytes": peak,
    }
