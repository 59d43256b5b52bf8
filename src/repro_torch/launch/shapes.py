"""Cell construction: (arch x shape x mesh) -> step + abstract args.

Mirrors ``repro/launch/shapes.py``. ``input_specs`` returns meta-tensor
stand-ins for every model input (no storage); ``build_cell`` bundles the
step function, its abstract arguments and their placements on the mesh.
The step takes DTensors laid out as ``in_shardings`` and runs under the
cell's sharding rules with plain tensors read as replicated
(``implicit_replication``); a train step sums the microbatches'
gradients in a Python loop. :func:`distribute` lays real tensors out
for the step; ``repro_torch.launch.dryrun`` traces it on fake shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.models.model import build_model
from repro_torch.models.params import abstract_tree, spec_tree
from repro_torch.optim.adamw import AdamW, OptimizerConfig
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

KV_AXES = ("layers", "batch", "kv_seq", "kv", "kv_dh")


def cache_axes(cfg: ModelConfig) -> tuple[tuple, ...]:
    if cfg.family in ("dense", "moe", "vlm"):
        return (KV_AXES, KV_AXES)
    if cfg.family == "rwkv":
        return (
            ("layers", "batch", "heads", None, None),
            ("layers", "batch", None),
            ("layers", "batch", None),
        )
    if cfg.family == "hybrid":
        return (
            KV_AXES, KV_AXES,
            ("layers", "batch", None, "heads"),
            ("layers", "batch", "heads", None),
        )
    if cfg.family == "encdec":
        return (KV_AXES, KV_AXES, KV_AXES, KV_AXES)
    raise ValueError(cfg.family)


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> str | None:
    """Cells that are skipped by design."""
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return ("full-attention arch: 500k dense-KV decode unsupported "
                "without an algorithmic change (see DESIGN.md §6)")
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# --------------------------------------------------------------- input specs
def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, torch.Tensor]:
    """Abstract model inputs for one cell (the data batch only)."""
    B, T = shape.global_batch, shape.seq_len
    tok = lambda b, t: _meta((b, t), torch.int32)
    emb = cfg.compute_dtype
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            return {
                "audio_embeds": _meta((B, cfg.enc_frames, cfg.d_model), emb),
                "tokens": tok(B, T),
                "labels": tok(B, T),
            }
        if cfg.family == "vlm":
            Pv = cfg.vision_patches
            return {
                "vision": _meta((B, Pv, cfg.d_model), emb),
                "tokens": tok(B, T - Pv),
                "labels": tok(B, T - Pv),
            }
        return {"tokens": tok(B, T), "labels": tok(B, T)}
    # decode: one new token against a cache of length T
    return {"tokens": tok(B, 1)}


def batch_axes(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, tuple]:
    ax: dict[str, tuple] = {}
    for name in input_specs(cfg, shape):
        if name in ("audio_embeds", "vision"):
            ax[name] = ("batch", None, None)
        else:
            ax[name] = ("batch", None)
    return ax


# ------------------------------------------------------------- MODEL_FLOPS
def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Analytic useful FLOPs for the cell (global, fwd+bwd for train).

    6·N·D (dense) / 6·N_active·D (MoE) plus the attention term
    12·L·T·d_attn per token (causal halves it), which matters at 32k+.
    """
    n_active = cfg.n_active_params()
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * T
        base = 6.0 * n_active * tokens
        attn = 0.0
        if cfg.family not in ("rwkv",):
            d_attn = cfg.n_heads * cfg.d_head
            layers = cfg.n_layers
            eff_ctx = min(cfg.window, T) if cfg.window else T
            attn = 12.0 * layers * d_attn * eff_ctx * 0.5 * tokens
        return base + attn
    if shape.kind == "prefill":
        tokens = B * T
        base = 2.0 * n_active * tokens
        attn = 0.0
        if cfg.family not in ("rwkv",):
            d_attn = cfg.n_heads * cfg.d_head
            eff_ctx = min(cfg.window, T) if cfg.window else T
            attn = 4.0 * cfg.n_layers * d_attn * eff_ctx * 0.5 * tokens
        return base + attn
    # decode: one token per sequence
    tokens = B
    base = 2.0 * n_active * tokens
    attn = 0.0
    if cfg.family not in ("rwkv",):
        eff_ctx = min(cfg.window, T) if cfg.window else T
        attn = 2.0 * cfg.n_layers * cfg.n_heads * cfg.d_head * eff_ctx * 2.0 * tokens
    if cfg.family in ("rwkv", "hybrid"):
        # state update ~ H·C² (rwkv) or di·state (ssm) per layer per token
        attn += 4.0 * cfg.n_layers * cfg.d_model * max(
            cfg.rwkv_head_size, cfg.ssm_state) * tokens
    return base + attn


# ------------------------------------------------------------------- cells
@dataclasses.dataclass
class Cell:
    cfg: ModelConfig
    shape: ShapeSpec
    fn: Callable
    args: tuple                # meta tensors (global shapes); ints pass as they are
    in_shardings: tuple        # placements per tensor leaf of ``args``
    out_shardings: Any         # placements per tensor leaf of the result
    donate_argnums: tuple[int, ...]
    model_flops: float
    mesh: Any = None
    rules: dict | None = None
    microbatches: int = 1


def _axis_size(mesh, name: str) -> int:
    if isinstance(mesh.shape, dict):
        return mesh.shape[name]
    return mesh.size(tuple(mesh.mesh_dim_names).index(name))


def _fit_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Drop mesh axes that do not divide the dim (top-level args must
    divide exactly, as in the reference)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, entries):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for a in axes:
            size *= _axis_size(mesh, a)
        out.append(ax if dim % size == 0 else None)
    return P(*out)


def sanitize(abs_tree, spec_pytree, mesh):
    return tree_map(lambda a, s: _fit_spec(s, tuple(a.shape), mesh),
                    abs_tree, spec_pytree)


def auto_microbatches(cfg: ModelConfig, shape: ShapeSpec, data_shards: int,
                      budget_bytes: float = 20e9) -> int:
    """Gradient-accumulation factor so the per-layer carries fit HBM.

    The layer loop saves one residual-stream carry per layer per
    microbatch: L x tokens_per_device x d_model x 2B must fit the budget
    (20e9 bytes by default: a quarter of an H100's 80 GB).
    """
    if cfg.microbatches:
        return cfg.microbatches
    tokens_per_dev = shape.global_batch * shape.seq_len / max(data_shards, 1)
    carry = cfg.n_layers * tokens_per_dev * cfg.d_model * 2.0
    micro = max(1, int(math.ceil(carry / budget_bytes)))
    # round up to a divisor of the per-device batch
    while shape.global_batch % micro or (shape.global_batch // micro) % 1:
        micro += 1
    return min(micro, shape.global_batch)


def _microbatch(x, micro: int, i: int):
    """Microbatch ``i`` of ``micro``: each rank's ``i``-th slice of its own
    batch rows, as the reference's reshape to (micro, B / micro, ...)
    splits each device's rows (a DTensor split along a sharded dim would
    gather it first)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.chunk(micro, 0)[i]
    part = x.to_local().chunk(micro, 0)[i]
    shape = (x.shape[0] // micro,) + tuple(x.shape[1:])
    return DTensor.from_local(part, x.device_mesh, x.placements, run_check=False,
                              shape=shape, stride=shlib.contiguous_stride(shape))


def _placements_tree(mesh, spec_pytree):
    if isinstance(spec_pytree, dict):
        return {k: _placements_tree(mesh, v) for k, v in spec_pytree.items()}
    return shlib.placements(spec_pytree, mesh)


def _settled_to(x, pl):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and tuple(x.placements) != tuple(pl):
        return x.redistribute(x.device_mesh, pl)
    return x


def _in_scope(rules: dict):
    """The step's scope: the cell's rules, plain tensors read as
    replicated."""
    import contextlib

    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    stack.enter_context(shlib.use_rules(rules))
    stack.enter_context(implicit_replication())
    return stack


def build_cell(
    cfg: ModelConfig,
    shape: ShapeSpec,
    mesh,
    *,
    rules: dict | None = None,
    optimizer: AdamW | None = None,
) -> Cell:
    multi_pod = "pod" in mesh.mesh_dim_names
    tp = _axis_size(mesh, "model")
    kv_div = cfg.n_kv_heads % tp == 0
    if rules is None:
        if shape.kind == "decode":
            # Decode: KV heads on the model axis when divisible, else the
            # cache head_dim: the score contraction becomes a reduction
            # over the model axis.
            rules = shlib.default_rules(
                multi_pod=multi_pod,
                kv="model" if kv_div else None,
                kv_dh=None if kv_div else "model",
                kv_seq=None)
        elif shape.kind == "prefill":
            # Prefill caches are produced once: shard KV heads when
            # divisible, else the sequence axis.
            rules = shlib.default_rules(
                multi_pod=multi_pod,
                kv="model" if kv_div else None,
                kv_seq=None if kv_div else "model")
        else:
            # Train: replicate the small KV activations when the KV heads
            # do not divide the model axis.
            rules = shlib.default_rules(
                multi_pod=multi_pod, kv="model" if kv_div else None)
    model = build_model(cfg)
    optimizer = optimizer or AdamW(OptimizerConfig())

    with shlib.use_rules(rules):
        resolve = shlib.resolver()
    defs = model.param_defs()
    params_abs = abstract_tree(defs, cfg.param_dtype)
    params_pl = _placements_tree(mesh, sanitize(params_abs, spec_tree(defs, resolve), mesh))

    batch_abs = input_specs(cfg, shape)
    batch_pl = {
        k: shlib.placements(_fit_spec(P(*(resolve(a) for a in ax)),
                                      tuple(batch_abs[k].shape), mesh), mesh)
        for k, ax in batch_axes(cfg, shape).items()
    }

    mf = model_flops(cfg, shape)

    if shape.kind == "train":
        opt_abs = optimizer.init_abstract(params_abs)
        replicated = shlib.placements(P(), mesh)
        opt_pl = {"m": params_pl, "v": params_pl, "step": replicated}
        data_shards = 1
        for ax in (rules.get("batch") or ()):
            data_shards *= _axis_size(mesh, ax)
        micro = auto_microbatches(cfg, shape, data_shards)

        def train_step(params, opt_state, batch):
            with _in_scope(rules):
                leaves = tree_leaves(params)
                live = [p.detach().requires_grad_(True) for p in leaves]
                tree = tree_unflatten(params, live)
                loss_sum, grads = None, None
                mbs = [tree_map(lambda x, i=i: _microbatch(x, micro, i), batch)
                       for i in range(micro)] if micro > 1 else [batch]
                for b in mbs:
                    with torch.enable_grad():
                        l = model.loss(tree, b)
                        g = torch.autograd.grad(l, live)
                    l = l.detach()
                    loss_sum = l if loss_sum is None else loss_sum + l
                    grads = list(g) if grads is None else \
                        [a + c for a, c in zip(grads, g)]
                if micro > 1:
                    loss_sum = loss_sum / micro
                    grads = [g / micro for g in grads]
                grads = [_settled_to(g, p.placements) for g, p in zip(grads, leaves)]
                with torch.no_grad():
                    params, opt_state, _ = optimizer.update(
                        tree_unflatten(params, grads), opt_state, params)
            return loss_sum, params, opt_state

        return Cell(
            cfg=cfg, shape=shape, fn=train_step,
            args=(params_abs, opt_abs, batch_abs),
            in_shardings=(params_pl, opt_pl, batch_pl),
            out_shardings=(replicated, params_pl, opt_pl),
            donate_argnums=(0, 1),
            model_flops=mf, mesh=mesh, rules=rules, microbatches=micro,
        )

    cache_abs = tuple(model.init_cache(shape.global_batch, shape.seq_len,
                                       device="meta"))
    cache_pl = tuple(
        shlib.placements(_fit_spec(P(*(resolve(a) for a in ax)),
                                   tuple(c.shape), mesh), mesh)
        for ax, c in zip(cache_axes(cfg), cache_abs))
    logits_pl = shlib.placements(_fit_spec(
        P(resolve("batch"), None, resolve("vocab")),
        (shape.global_batch, 1, cfg.vocab), mesh), mesh)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with _in_scope(rules), torch.no_grad():
                logits, cache = model.prefill(params, batch)
                return (_settled_to(logits, logits_pl),
                        tuple(_settled_to(c, pl) for c, pl in zip(cache, cache_pl)))

        return Cell(
            cfg=cfg, shape=shape, fn=prefill_step,
            args=(params_abs, batch_abs),
            in_shardings=(params_pl, batch_pl),
            out_shardings=(logits_pl, cache_pl),
            donate_argnums=(),
            model_flops=mf, mesh=mesh, rules=rules,
        )

    # decode: the new token at the last slot of a full cache
    def decode_step(params, cache, tokens, pos):
        with _in_scope(rules), torch.no_grad():
            logits, cache = model.decode_step(params, cache, tokens, pos)
            return (_settled_to(logits, logits_pl),
                    tuple(_settled_to(c, pl) for c, pl in zip(cache, cache_pl)))

    return Cell(
        cfg=cfg, shape=shape, fn=decode_step,
        args=(params_abs, cache_abs, batch_abs["tokens"], shape.seq_len - 1),
        in_shardings=(params_pl, cache_pl, batch_pl["tokens"], None),
        out_shardings=(logits_pl, cache_pl),
        donate_argnums=(1,),
        model_flops=mf, mesh=mesh, rules=rules,
    )


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and all(hasattr(p, "is_shard") for p in x)


def _zip_args(args, shardings, fn, *others):
    """``fn(leaf, placements, *other_leaves)`` over each tensor leaf of
    ``args`` and the matching leaves of ``others`` (trees of its
    structure); ints and other plain values pass through."""
    def go(a, s, *o):
        if isinstance(a, torch.Tensor):
            return fn(a, s, *o)
        if isinstance(a, dict):
            return {k: go(v, s[k], *(x[k] for x in o)) for k, v in a.items()}
        if isinstance(a, (tuple, list)):
            ss = [s] * len(a) if _is_placements(s) else s
            return type(a)(go(v, si, *(x[i] for x in o))
                           for i, (v, si) in enumerate(zip(a, ss)))
        return a
    return tuple(go(a, s, *o) for a, s, *o in zip(args, shardings, *others))


def distribute(cell: Cell, args: tuple) -> tuple:
    """Real full-size tensors (every rank holding the same values) laid
    out as the cell's ``in_shardings``."""
    from torch.distributed.tensor import distribute_tensor

    return _zip_args(args, cell.in_shardings,
                     lambda t, pl: distribute_tensor(t, cell.mesh, pl))


def spmd_fn(cell: Cell) -> Callable:
    """The cell's step over this rank's local shards: it wraps each as a
    DTensor of the argument's global shape, runs the step and returns
    the local shards of the results (the program ``make_fx`` traces)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import set_mesh

    def wrap(like, pl, local):
        return DTensor.from_local(local, cell.mesh, pl, run_check=False,
                                  shape=like.shape,
                                  stride=shlib.contiguous_stride(like.shape))

    def run(*local_args):
        with set_mesh(cell.mesh):
            out = cell.fn(*_zip_args(cell.args, cell.in_shardings, wrap, local_args))
        return tree_map(lambda o: o.to_local() if isinstance(o, DTensor) else o, out)

    return run


def local_args(cell: Cell, fake_mode) -> tuple:
    """Fake tensors of this rank's shards of the cell's arguments."""
    def mk(a, pl):
        size, _ = shlib.local_shape_offset(tuple(a.shape), pl, cell.mesh)
        with fake_mode:
            return torch.empty(size, dtype=a.dtype)
    return _zip_args(cell.args, cell.in_shardings, mk)
