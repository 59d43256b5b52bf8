"""The dry run's per-device programs, held where PyTorch versions differ.

The models pin every product's placements (``sharding.pinned``), so a
sharded cell traces the same per-device program on any PyTorch. Three
checks, each trace in a process of its own (a process holds one fake
group):

* the cells cut to one layer that torch 2.11 failed or replicated
  (``repro_torch.launch.dist_cells``), at full width on a fake group of
  256, must read exactly the product FLOPs and link bytes stored in
  ``dist_cells.json`` (torch 2.13), and its HBM bytes and peak within
  1 %; the store must name every cell, as traced on 2.13;
* a multi-pod cell (reduced deepseek-7b, pod 2 x data 2 x model 2 on a
  fake group of 8) must read the reference's product FLOPs (its
  ``analyze_hlo`` on 8 host devices under ``default_rules(multi_pod=True)``)
  within 5 %;
* in deepseek-7b's reduced train cell on a 4 x 2 mesh no product may take
  more activation rows than the rank's batch shard: the strategy that
  gathers the batch (torch 2.11's DTensor chose it) shows there on any
  version.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch import dist_cells  # noqa: E402

#: the cut cells traced here: deepseek-7b's two, one of each of the
#: three faults torch 2.11 showed (a split of a sharded dim: qwen2.5-32b;
#: a pending sum asked of a shard: hymba-1.5b, whisper-tiny; a plain
#: pending sum into a masked one: command-r-35b), and a decode whose
#: batch row does not split (hymba-1.5b long_500k)
TIER1 = [("deepseek-7b", "train_4k", "single"), ("deepseek-7b", "decode_32k", "single"),
         ("hymba-1.5b", "decode_32k", "single"), ("whisper-tiny", "train_4k", "single"),
         ("command-r-35b", "train_4k", "single"), ("qwen2.5-32b", "train_4k", "single"),
         ("hymba-1.5b", "long_500k", "single")]


@pytest.fixture(scope="module")
def cut():
    return dist_cells.trace(TIER1, jobs=2)


def test_the_store_names_every_cut_cell_as_traced_on_2_13():
    store = json.load(open(dist_cells.STORE))
    assert sorted(store) == sorted(dist_cells.name(c) for c in dist_cells.CELLS)
    for cell, rec in store.items():
        assert rec["torch"].startswith("2.13"), (cell, rec["torch"])
        assert rec["flops"] > 0 and rec["link_bytes"] > 0 and rec["peak_bytes"] > 0


@pytest.mark.parametrize("cell", TIER1, ids=dist_cells.name)
def test_cut_cell_reads_the_stored_counts(cut, cell):
    got = cut[dist_cells.name(cell)]
    assert "error" not in got, got.get("error")
    want = json.load(open(dist_cells.STORE))[dist_cells.name(cell)]
    assert got["flops"] == want["flops"]
    assert got["link_bytes"] == want["link_bytes"]
    assert got["hbm_bytes"] == pytest.approx(want["hbm_bytes"], rel=0.01)
    assert got["peak_bytes"] == pytest.approx(want["peak_bytes"], rel=0.01)


MULTI_PORT = textwrap.dedent("""
    import dataclasses, json
    import torch
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.hlo_analysis import analyze_graph
    from repro_torch.launch.dryrun import init_fake_group, trace
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import build_cell
    init_fake_group(8)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    cfg = REGISTRY["deepseek-7b"].reduced(n_layers=2, vocab=512)
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    cell = build_cell(cfg, ShapeSpec("t", "train", 128, 16), mesh)
    assert cell.rules["batch"] == ("pod", "data"), cell.rules
    gm, _ = trace(cell)
    print("PORT", json.dumps({"flops": analyze_graph(gm).flops}))
""")

MULTI_REFERENCE = textwrap.dedent("""
    import dataclasses, json
    import jax, jax.numpy as jnp
    from repro.configs import REGISTRY
    from repro.configs.base import ShapeSpec
    from repro.distributed.hlo_analysis import analyze_hlo
    from repro.launch.mesh import _mk, set_mesh
    from repro.launch.shapes import build_cell
    mesh = _mk((2, 2, 2), ("pod", "data", "model"))
    cfg = REGISTRY["deepseek-7b"].reduced(n_layers=2, vocab=512)
    cfg = dataclasses.replace(cfg, compute_dtype=jnp.bfloat16)
    cell = build_cell(cfg, ShapeSpec("t", "train", 128, 16), mesh)
    with set_mesh(mesh):
        compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                           out_shardings=cell.out_shardings,
                           donate_argnums=cell.donate_argnums
                           ).lower(*cell.args).compile()
    print("REF", json.dumps({"flops": analyze_hlo(compiled.as_text()).flops}))
""")


def test_multi_pod_cell_matches_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {
        "PORT": subprocess.Popen([sys.executable, "-c", MULTI_PORT], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "REF": subprocess.Popen([sys.executable, "-c", MULTI_REFERENCE], env=ref_env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    got = {}
    for tag, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{tag}: {err[-3000:]}"
        got[tag] = json.loads(out.split(tag, 1)[1])["flops"]
    assert got["PORT"] > 0
    assert got["PORT"] == pytest.approx(got["REF"], rel=0.05), got


ROWS = textwrap.dedent("""
    import dataclasses, json
    import torch
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.hlo_analysis import _op_name, _val
    from repro_torch.launch.dryrun import init_fake_group, trace
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.shapes import build_cell
    init_fake_group(8)
    mesh = make_mesh_for(8, model_axis=2, device_type="cpu")
    cfg = REGISTRY["deepseek-7b"].reduced(n_layers=2, vocab=512)
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    cell = build_cell(cfg, ShapeSpec("t", "train", 128, 16), mesh)
    gm, _ = trace(cell)
    shapes = [(_op_name(n), [list(_val(gm, a).shape) for a in n.all_input_nodes])
              for n in gm.graph.nodes
              if n.op == "call_function" and _op_name(n) in ("mm", "bmm")]
    print("ROWS", json.dumps({"shapes": shapes, "kv_heads": cfg.n_kv_heads}))
""")


def test_no_product_takes_more_rows_than_the_batch_shard():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", ROWS], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.split("ROWS", 1)[1])
    T, b_local = 128, 16 // 4          # the batch over the data axis of 4
    gathered = {b * T for b in range(b_local + 1, 17)}
    assert out["shapes"]
    for op, operands in out["shapes"]:
        if op == "mm":
            # a token dim of more rows than the rank's batch holds
            assert not gathered & {d for s in operands for d in s}, (op, operands)
        else:
            # (batch x kv heads, rows, cols): at most the rank's batch rows
            # times every kv head
            assert all(s[0] <= b_local * out["kv_heads"] for s in operands), (op, operands)
