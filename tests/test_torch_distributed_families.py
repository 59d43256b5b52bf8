"""Every family's sharded training step against the unsharded one.

The reduced config of each of the six families, and of command-r and of
ragged heads (``CASES``; 2 layers, vocab 512, fp32, B 8, T 32) runs its loss and gradients as a DTensor program on a
2 x 2 (data, model) mesh of 4 gloo ranks, spawned in a subprocess (no
process group is left in the test's process), and the same step runs
unsharded on rank 0 from the same parameters and batch. The local
regions (rmsnorm and attention on local shards, the MoE dispatch, the
RWKV time mix, the vocabulary-parallel cross-entropy) must give the
gradients the unsharded program gives: the loss within rtol 1e-5 and
each parameter's gradient within 1e-4 relative L2 (the same fp32
arithmetic with its sums split across ranks reads up to about 5e-6; a
gradient summed over the wrong ranks is off by a factor of 2).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (case, arch, overrides of the reduced config): the six families,
#: command-r's layernorm and parallel block, and query heads that do not
#: divide the model axis (5 over 2, one KV head: DTensor shards them
#: unevenly, and each rank's gradient of the replicated KV is a share)
CASES = [(a, a, {}) for a in ("deepseek-7b", "qwen3-moe-30b-a3b", "rwkv6-1.6b",
                             "hymba-1.5b", "whisper-tiny", "qwen2-vl-7b",
                             "command-r-35b")] + [
    ("ragged-heads", "qwen2.5-32b", {"n_heads": 5, "n_kv_heads": 1})]

WORKER = textwrap.dedent('''
    import json, os, sys
    import numpy as np, torch, torch.distributed as dist, torch.multiprocessing as mp


    def run(rank, cases, port, out):
        os.environ["MASTER_ADDR"] = "localhost"
        os.environ["MASTER_PORT"] = str(port)
        dist.init_process_group("gloo", rank=rank, world_size=4)
        from repro_torch.checkpoint.checkpointer import _flatten
        from repro_torch.configs import REGISTRY
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.data.pipeline import batches_for
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.shapes import _in_scope, build_cell, distribute
        from repro_torch.models.model import build_model
        from repro_torch.models.params import init_tree
        from repro_torch.optim.adamw import AdamW
        from repro_torch.tree import tree_leaves, tree_unflatten
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        results = {}
        for case, arch, overrides in cases:
            cfg = REGISTRY[arch].reduced(n_layers=2, vocab=512, **overrides)
            shape = ShapeSpec("t", "train", 32, 8)
            model = build_model(cfg)
            params = init_tree(model.param_defs(), torch.Generator().manual_seed(0))
            batch = {k: torch.from_numpy(np.asarray(v))
                     for k, v in next(batches_for(cfg, shape)).items()}
            cell = build_cell(cfg, shape, mesh)
            p, _, b = distribute(cell, (params, AdamW().init(params), batch))
            with _in_scope(cell.rules):
                live = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
                with torch.enable_grad():
                    loss = model.loss(tree_unflatten(p, live), b)
                    grads = torch.autograd.grad(loss, live)
            # every rank gathers: a gather is a collective
            grads = [g.full_tensor() for g in grads]
            loss = float(loss.full_tensor())
            if rank == 0:
                live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
                with torch.enable_grad():
                    want = model.loss(tree_unflatten(params, live), batch)
                    want_grads = torch.autograd.grad(want, live)
                rel = {name: float((g - w).norm() / w.norm().clamp_min(1e-30))
                       for name, g, w in zip(_flatten(params), grads, want_grads)}
                results[case] = {"loss": loss, "want": float(want.detach()), "rel": rel}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(run, args=(json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3]),
                 nprocs=4)
''')


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    script, out = tmp / "worker.py", tmp / "out.json"
    script.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, str(script), json.dumps(CASES), str(port),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=400)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", [c for c, _, _ in CASES])
def test_sharded_step_gives_the_unsharded_gradients(sharded, case):
    r = sharded[case]
    assert r["loss"] == pytest.approx(r["want"], rel=1e-5)
    worst = max(r["rel"].items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-4, worst
