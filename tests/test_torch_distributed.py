"""The port's sharding rules, specs and cell shapes against the JAX package's.

Everything here runs in the test's own process and touches no process
group: the rules, specs and shape arithmetic are plain Python, and a
mesh is stood in for by an object with the names and sizes they read.
The sharded runs themselves are in ``test_torch_distributed_gloo.py``
and ``test_torch_dryrun.py``, in subprocesses.
"""

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ALL_SHAPES as J_SHAPES
from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import TRAIN_4K as J_TRAIN_4K
from repro.distributed import sharding as jsh
from repro.launch import shapes as jshapes
from repro.models.model import build_model as jax_build
from repro.models.params import spec_tree as jax_spec_tree

from repro_torch.configs import ALL_SHAPES, REGISTRY, TRAIN_4K
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.launch import shapes
from repro_torch.models.model import build_model
from repro_torch.models.params import abstract_tree, count_params, spec_tree
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_leaves

ARCHS = sorted(REGISTRY)


class FakeMesh:
    """What ``_fit_spec`` and ``placements`` read of a mesh."""
    shape = {"data": 16, "model": 16, "pod": 2}
    mesh_dim_names = ("pod", "data", "model")


def _flat_specs(tree, path=()):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_specs(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = tuple(v)
    return out


# ------------------------------------------------------------ sharding unit
def test_fit_spec_drops_nondividing_axes():
    s = shapes._fit_spec(P("data", "model"), (32, 40), FakeMesh())
    assert s == P("data", None)
    s = shapes._fit_spec(P(("pod", "data"), None), (64, 10), FakeMesh())
    assert s == P(("pod", "data"), None)
    s = shapes._fit_spec(P(("pod", "data"), None), (16, 10), FakeMesh())
    assert s == P(None, None)


def test_shard_is_the_identity_outside_a_mesh():
    x = torch.ones((2, 3, 4))
    assert sh.shard(x, "batch", "seq", "embed") is x
    with sh.use_rules(sh.default_rules()):
        # a rules scope but a plain tensor: no mesh, nothing to do
        assert sh.shard(x, "batch", "seq", "embed") is x
        assert sh.spec_of(("batch", "seq", "embed")) == P("data", None, None)


def test_default_rules_multi_pod():
    r = sh.default_rules(multi_pod=True)
    assert r["batch"] == ("pod", "data")
    assert r["embed"] == ("pod", "data")
    assert r["heads"] == "model"
    assert sh.default_rules(multi_pod=True) == jsh.default_rules(multi_pod=True)
    assert sh.default_rules(kv=None) == jsh.default_rules(kv=None)


def test_placements_shard_one_dim_over_several_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard

    assert sh.placements(P(("pod", "data"), None), FakeMesh()) == \
        (Shard(0), Shard(0), Replicate())
    assert sh.placements(P(None, "model", "data"), FakeMesh()) == \
        (Replicate(), Shard(2), Shard(1))
    assert sh.placements(P(), FakeMesh()) == (Replicate(),) * 3


# ------------------------------------------------------- parity: spec trees
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_matches_reference(arch, multi):
    with jsh.use_rules(jsh.default_rules(multi_pod=multi)):
        jres = jsh.resolver()
    with sh.use_rules(sh.default_rules(multi_pod=multi)):
        res = sh.resolver()
    ref = jax_spec_tree(jax_build(J_REGISTRY[arch]).param_defs(), jres)
    got = spec_tree(build_model(REGISTRY[arch]).param_defs(), res)
    ref_flat = {k: tuple(v) for k, v in _flat_specs(
        ref if not isinstance(ref, JP) else {}).items()}
    assert _flat_specs(got) == ref_flat


# ---------------------------------------------------- parity: cell shapes
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_shapes_match_reference(arch):
    cfg, jcfg = REGISTRY[arch], J_REGISTRY[arch]
    model, jmodel = build_model(cfg), jax_build(jcfg)
    assert shapes.cache_axes(cfg) == jshapes.cache_axes(jcfg)
    for shape, jshape in zip(ALL_SHAPES, J_SHAPES):
        assert shape.name == jshape.name
        assert shapes.model_flops(cfg, shape) == jshapes.model_flops(jcfg, jshape)
        assert shapes.skip_reason(cfg, shape) == jshapes.skip_reason(jcfg, jshape)
        got = {k: tuple(v.shape) for k, v in shapes.input_specs(cfg, shape).items()}
        ref = {k: tuple(v.shape) for k, v in jshapes.input_specs(jcfg, jshape).items()}
        assert got == ref
        assert shapes.batch_axes(cfg, shape) == jshapes.batch_axes(jcfg, jshape)
        if shape.kind == "train":
            # the data shards of the two production meshes (the rounding
            # loop seeks a divisor of the batch: a factor past it would
            # never end, in either package)
            for shards in (16, 32):
                assert shapes.auto_microbatches(cfg, shape, shards, budget_bytes=4e9) == \
                    jshapes.auto_microbatches(jcfg, jshape, shards, budget_bytes=4e9)
        if shape.kind != "train":
            caches = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
            jcaches = jmodel.init_cache_shape(jshape.global_batch, jshape.seq_len)
            assert [tuple(c.shape) for c in caches] == [tuple(c.shape) for c in jcaches]


def test_auto_microbatches_budget_is_a_quarter_of_the_card():
    for arch in ARCHS:
        cfg, jcfg = REGISTRY[arch], J_REGISTRY[arch]
        assert shapes.auto_microbatches(cfg, TRAIN_4K, 16) == \
            jshapes.auto_microbatches(jcfg, J_TRAIN_4K, 16, budget_bytes=20e9)


# ------------------------------------------------------- abstract trees
def test_abstract_tree_and_optimizer_state_allocate_nothing():
    cfg = REGISTRY["deepseek-7b"]
    defs = build_model(cfg).param_defs()
    params = abstract_tree(defs, cfg.param_dtype)
    leaves = tree_leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == count_params(defs)
    state = AdamW().init_abstract(params)
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in tree_leaves(state["m"]) + tree_leaves(state["v"]))
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    ref = jax_build(J_REGISTRY["deepseek-7b"])
    from repro.models.params import abstract_tree as jax_abstract
    jleaves = [l for l in __import__("jax").tree.leaves(
        jax_abstract(ref.param_defs(), jnp.float32))]
    assert [tuple(t.shape) for t in leaves] == [tuple(t.shape) for t in jleaves]


def test_mesh_builders_touch_no_process_group_on_import():
    import importlib

    import repro_torch.launch.mesh as mesh_mod

    importlib.reload(mesh_mod)
    assert not torch.distributed.is_initialized()


def test_importing_the_distributed_layer_leaves_jax_out():
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = ("import sys, repro_torch.launch.dryrun, repro_torch.launch.shapes,"
            " repro_torch.launch.mesh, repro_torch.distributed.pipeline,"
            " repro_torch.distributed.roofline, repro_torch.distributed.hlo_analysis;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'));"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr
