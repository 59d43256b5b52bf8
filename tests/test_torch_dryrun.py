"""The dry run's per-device traces of the six families against the JAX
package's compiled SPMD modules.

The reference's family cells (``tests/test_distributed.py``: a reduced
config of 2 layers and vocab 512 in bf16, T 128, B 16, on a 4 x 2 mesh)
are traced by the port on a fake process group of 8 and compiled by
the reference on 8 fake host devices, each in its own subprocess, the
two at once. Each trace must complete, and its per-device product FLOPs
must be within 5% of the reference's ``analyze_hlo`` of the same cell
(the port's graph walker counts every product the rank runs; both
recompute each checkpointed block's forward in training).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAMILIES = [
    ("deepseek-7b", "train"),
    ("qwen3-moe-30b-a3b", "train"),
    ("rwkv6-1.6b", "decode"),
    ("hymba-1.5b", "prefill"),
    ("whisper-tiny", "train"),
    ("qwen2-vl-7b", "decode"),
]

PORT = textwrap.dedent("""
    import dataclasses, json, sys, time
    import torch
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.hlo_analysis import analyze_graph, memory_analysis
    from repro_torch.launch.dryrun import init_fake_group, trace
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.shapes import build_cell
    init_fake_group(8)
    mesh = make_mesh_for(8, model_axis=2, device_type="cpu")
    out = {}
    for cell_id in sys.argv[1:]:
        arch, kind = cell_id.split(":")
        cfg = REGISTRY[arch].reduced(n_layers=2, vocab=512)
        cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
        t0 = time.time()
        cell = build_cell(cfg, ShapeSpec("t", kind, 128, 16), mesh)
        gm, donated = trace(cell)
        t = analyze_graph(gm)
        out[cell_id] = {"flops": t.flops, "coll": t.coll_bytes, "s": time.time() - t0,
                        "peak": memory_analysis(gm, donated)["peak_bytes"]}
    print("PORT", json.dumps(out))
""")

REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp
    from repro.configs import REGISTRY
    from repro.configs.base import ShapeSpec
    from repro.distributed.hlo_analysis import analyze_hlo
    from repro.launch.mesh import make_mesh_for, set_mesh
    from repro.launch.shapes import build_cell
    mesh = make_mesh_for(8, model_axis=2)
    out = {}
    for cell_id in sys.argv[1:]:
        arch, kind = cell_id.split(":")
        cfg = REGISTRY[arch].reduced(n_layers=2, vocab=512)
        cfg = dataclasses.replace(cfg, compute_dtype=jnp.bfloat16)
        cell = build_cell(cfg, ShapeSpec("t", kind, 128, 16), mesh)
        with set_mesh(mesh):
            compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                               out_shardings=cell.out_shardings,
                               donate_argnums=cell.donate_argnums
                               ).lower(*cell.args).compile()
        out[cell_id] = {"flops": analyze_hlo(compiled.as_text()).flops}
    print("REF", json.dumps(out))
""")


@pytest.fixture(scope="module")
def traced():
    cells = [f"{a}:{k}" for a, k in FAMILIES]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {
        "PORT": subprocess.Popen([sys.executable, "-c", PORT, *cells], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "REF": subprocess.Popen([sys.executable, "-c", REFERENCE, *cells], env=ref_env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    results = {}
    for tag, proc in procs.items():
        out, err = proc.communicate(timeout=400)
        assert proc.returncode == 0, f"{tag}: {err[-3000:]}"
        results[tag] = json.loads(out.split(tag, 1)[1])
    return results


@pytest.mark.parametrize("arch,kind", FAMILIES)
def test_family_traces_on_a_fake_group_of_8(traced, arch, kind):
    cell = f"{arch}:{kind}"
    port, ref = traced["PORT"][cell], traced["REF"][cell]
    assert port["flops"] > 0 and port["peak"] > 0
    assert port["flops"] == pytest.approx(ref["flops"], rel=0.05), (port, ref)


def test_production_meshes_and_a_spec_over_two_mesh_dims():
    code = textwrap.dedent("""
        import torch
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch.dryrun import init_fake_group
        from repro_torch.launch.mesh import make_production_mesh, set_mesh
        init_fake_group(512)
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert tuple(mesh.shape) == (2, 16, 16), mesh.shape
        assert tuple(mesh.mesh_dim_names) == ("pod", "data", "model")
        pl = sh.placements(sh.P(("pod", "data"), None), mesh)
        assert pl == (Shard(0), Shard(0), Replicate()), pl
        assert sh.local_shape_offset((512, 4096), pl, mesh) == ([16, 4096], [0, 0])
        x = DTensor.from_local(torch.ones(512, 4096), mesh, (Replicate(),) * 3,
                               run_check=False)
        with sh.use_rules(sh.default_rules(multi_pod=True)), set_mesh(mesh):
            y = sh.shard(x, "batch", "embed")   # embed -> act_embed: whole
        assert tuple(y.placements) == pl and tuple(y.to_local().shape) == (16, 4096)
        assert sh.shard(x, "batch", "embed") is x   # no rules: the identity
        print("MESH ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MESH ok" in out.stdout
