"""The sharded decode step against the unsharded one.

A decode cell's products are pinned (``sharding.pinned``) in one of two
layouts: where the batch splits over the data axis, each rank takes its
batch rows against weights whose FSDP dim is gathered; where it does not
(the one row of ``long_500k``), every rank takes the whole batch and its
share of the FSDP dim, each product a pending sum over that axis. Both
run here as DTensor programs on a 2 x 2 (data, model) mesh of 4 gloo
ranks, spawned in a subprocess, for the dense, hybrid and RWKV families
(reduced, 2 layers, vocab 512, fp32, a cache of 16 filled from a seed):
the logits and every updated cache must match the unsharded decode step
from the same parameters and cache within 1e-5 relative L2 (the same
fp32 arithmetic with its sums split across ranks).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (case, arch, batch): batch 1 does not split over the data axis of 2
CASES = [(f"{a}-b{b}", a, b) for a in ("deepseek-7b", "hymba-1.5b", "rwkv6-1.6b")
         for b in (1, 4)]
T = 16

WORKER = textwrap.dedent('''
    import json, os, sys
    import numpy as np, torch, torch.distributed as dist, torch.multiprocessing as mp


    def run(rank, cases, T, port, out):
        os.environ["MASTER_ADDR"] = "localhost"
        os.environ["MASTER_PORT"] = str(port)
        dist.init_process_group("gloo", rank=rank, world_size=4)
        from repro_torch.configs import REGISTRY
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.shapes import build_cell, distribute
        from repro_torch.models.model import build_model
        from repro_torch.models.params import init_tree
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        results = {}
        for case, arch, B in cases:
            cfg = REGISTRY[arch].reduced(n_layers=2, vocab=512)
            model = build_model(cfg)
            params = init_tree(model.param_defs(), torch.Generator().manual_seed(0))
            rng = np.random.default_rng(1)
            cache = tuple(
                torch.from_numpy(0.5 * rng.standard_normal(c.shape)).to(c.dtype)
                for c in model.init_cache(B, T, device="cpu"))
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).to(torch.int32)
            cell = build_cell(cfg, ShapeSpec("t", "decode", T, B), mesh)
            args = distribute(cell, (params, cache, tokens, T - 1))
            logits, new = cell.fn(*args)
            # every rank gathers: a gather is a collective
            got = [logits.full_tensor()] + [c.full_tensor() for c in new]
            if rank == 0:
                with torch.no_grad():
                    want_logits, want_new = model.decode_step(
                        params, tuple(c.clone() for c in cache), tokens, T - 1)
                want = [want_logits] + list(want_new)
                results[case] = [
                    float((g.float() - w.float()).norm()
                          / w.float().norm().clamp_min(1e-30))
                    for g, w in zip(got, want)]
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(run, args=(json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                            sys.argv[4]), nprocs=4)
''')


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode")
    script, out = tmp / "worker.py", tmp / "out.json"
    script.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, str(script), json.dumps(CASES), str(T), str(port),
                          str(out)], env=env, capture_output=True, text=True, timeout=400)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", [c for c, _, _ in CASES])
def test_sharded_decode_step_gives_the_unsharded_logits_and_cache(sharded, case):
    rel = sharded[case]
    assert len(rel) > 1
    assert max(rel) <= 1e-5, rel
