"""The port's sharded runs on gloo ranks, held against the JAX package's.

Every process group lives in a subprocess (``torch.multiprocessing``
spawns the ranks, which find each other at ``localhost``), as the
reference's tests run their meshes in subprocesses with fake host
devices: no default group is ever left in a test worker. The JAX side
runs on 4 fake host devices (``--xla_force_host_platform_device_count``)
in its own subprocess, at the same time as the port's.

Tolerances, each with its reason:

* The reduced deepseek-7b train cell (2 layers, vocab 512, B 16, T 64,
  fp32) on a 2x2 (data, model) mesh: losses rtol 1e-5 of the unsharded
  port's (the same fp32 arithmetic, its sums split across ranks), and
  rtol 1e-4 of the reference's cell on 4 devices (the port's own
  tolerance for a few fp32 train steps, ``tests/test_torch_train.py``).
* ``pipeline_apply`` on 4 ranks: rtol and atol 2e-5 against the
  sequential product and against the reference's ``pipeline_apply`` on
  the same numpy weights (the reference's own bound).
* The elastic restore: exact values.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent('''
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def train(rank, out, npz):
        from repro_torch.configs import REGISTRY
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.data.pipeline import batches_for
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.shapes import build_cell, distribute
        from repro_torch.optim.adamw import AdamW
        cfg = REGISTRY["deepseek-7b"].reduced(n_layers=2, vocab=512)
        shape = ShapeSpec("t", "train", 64, 16)
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        cell = build_cell(cfg, shape, mesh)
        params = load_params(npz, cfg)
        stream = batches_for(cfg, shape)
        p = o = None
        losses = []
        for i in range(3):
            b = {k: torch.from_numpy(np.asarray(v)) for k, v in next(stream).items()}
            if p is None:
                p, o, b = distribute(cell, (params, AdamW().init(params), b))
            else:
                b = distribute(cell, (params, o, b))[2]
            loss, p, o = cell.fn(p, o, b)
            losses.append(float(loss.full_tensor()))
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"losses": losses}, f)


    def load_params(npz, cfg):
        from repro_torch.interop import params_from_jax
        tree = {}
        for k, v in np.load(npz).items():
            node = tree
            *parents, leaf = k.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
        return params_from_jax(tree, cfg, device="cpu")


    def pipeline(rank, out, npz):
        from repro_torch.distributed.pipeline import pipeline_apply
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((4,), ("pipe",), "cpu")
        data = np.load(npz)
        Ws, x = torch.from_numpy(data["Ws"]), torch.from_numpy(data["x"])
        y = pipeline_apply(Ws, x, lambda W, h: torch.tanh(h @ W), mesh, axis="pipe")
        ys = [torch.empty_like(y) for _ in range(4)]
        dist.all_gather(ys, y)
        assert all(torch.equal(ys[0], t) for t in ys), "ranks disagree"
        if rank == 0:
            np.save(out, y.numpy())


    def restore(rank, out, tmp):
        from torch.distributed.tensor import Shard, distribute_tensor
        from repro_torch.checkpoint.checkpointer import Checkpointer
        from repro_torch.launch.mesh import make_mesh
        w = torch.arange(64.0).reshape(8, 8)
        mesh1 = make_mesh((2, 2), ("data", "model"), "cpu")
        ck = Checkpointer(tmp)
        ck.save(5, {"w": distribute_tensor(w, mesh1, (Shard(0), Shard(1)))})
        mesh2 = make_mesh((4, 1), ("data", "model"), "cpu")
        layout = (mesh2, (Shard(0), Shard(1)))
        restored, manifest = ck.restore({"w": torch.zeros(8, 8)},
                                        shardings={"w": layout})
        r = restored["w"]
        assert manifest["step"] == 5
        assert torch.equal(r.full_tensor(), w)
        assert tuple(r.placements) == (Shard(0), Shard(1))
        assert tuple(r.device_mesh.shape) == (4, 1)
        assert r.to_local().shape == (2, 8)
        if rank == 0:
            with open(out, "w") as f:
                f.write("ok")


    def main(rank, mode, port, out, arg):
        os.environ["MASTER_ADDR"] = "localhost"
        os.environ["MASTER_PORT"] = str(port)
        dist.init_process_group("gloo", rank=rank, world_size=4)
        try:
            {"train": train, "pipeline": pipeline, "restore": restore}[mode](rank, out, arg)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        mode, port, out, arg = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
        mp.spawn(main, args=(mode, port, out, arg), nprocs=4)
''')

JAX_TRAIN = textwrap.dedent('''
    import json, sys
    import numpy as np, jax
    from repro.configs import REGISTRY
    from repro.configs.base import ShapeSpec
    from repro.data.pipeline import batches_for
    from repro.launch.mesh import make_mesh_for, set_mesh
    from repro.launch.shapes import build_cell
    from repro.models.model import build_model
    from repro.models.params import init_tree
    from repro.optim.adamw import AdamW
    cfg = REGISTRY["deepseek-7b"].reduced(n_layers=2, vocab=512)
    shape = ShapeSpec("t", "train", 64, 16)
    mesh = make_mesh_for(4, model_axis=2)
    cell = build_cell(cfg, shape, mesh)
    p0 = init_tree(build_model(cfg).param_defs(), jax.random.PRNGKey(0))
    flat = {}
    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat["/".join(path + (k,))] = np.asarray(v)
    walk(p0)
    np.savez(sys.argv[1], **flat)
    with open(sys.argv[1] + ".ready", "w") as f:
        f.write("1")
    opt = AdamW()
    with set_mesh(mesh):
        params = jax.device_put(p0, cell.in_shardings[0])
        opt_state = jax.device_put(opt.init(params), cell.in_shardings[1])
        step = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings)
        stream = batches_for(cfg, shape)
        losses = []
        for i in range(3):
            batch = {k: jax.device_put(v, cell.in_shardings[2][k])
                     for k, v in next(stream).items()}
            loss, params, opt_state = step(params, opt_state, batch)
            losses.append(float(loss))
    print("LOSSES", json.dumps(losses))
''')

JAX_PIPELINE = textwrap.dedent('''
    import sys
    import numpy as np, jax.numpy as jnp
    from repro.distributed.pipeline import pipeline_apply
    from repro.launch.mesh import _mk
    data = np.load(sys.argv[1])
    mesh = _mk((4,), ("pipe",))
    out = pipeline_apply(jnp.asarray(data["Ws"]), jnp.asarray(data["x"]),
                         lambda W, h: jnp.tanh(h @ W), mesh, axis="pipe")
    np.save(sys.argv[2], np.asarray(out))
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(jax_devices: int | None = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    if jax_devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={jax_devices}"
    return env


def _start(script: str, *args: str, jax_devices: int | None = None):
    return subprocess.Popen([sys.executable, script, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(jax_devices))


def _finish(proc, timeout: int = 300) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


def _worker(tmp_path, mode: str, out: str, arg: str):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    return _start(str(script), mode, str(_free_port()), out, arg)


def test_train_cell_on_a_2x2_gloo_mesh_matches_unsharded_and_reference(tmp_path):
    npz = str(tmp_path / "params.npz")
    ref_script = tmp_path / "jax_train.py"
    ref_script.write_text(JAX_TRAIN)
    ref = _start(str(ref_script), npz, jax_devices=4)
    # the port starts once the reference has written the shared params
    import time
    deadline = time.time() + 240
    while not os.path.exists(npz + ".ready"):
        assert ref.poll() is None or os.path.exists(npz + ".ready"), \
            ref.communicate()[1][-3000:]
        assert time.time() < deadline, "the reference never wrote its params"
        time.sleep(0.2)
    out = str(tmp_path / "losses.json")
    port = _worker(tmp_path, "train", out, npz)

    # the unsharded port step on the same params and batches
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import batches_for
    from repro_torch.interop import params_from_jax
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = REGISTRY["deepseek-7b"].reduced(n_layers=2, vocab=512)
    shape = ShapeSpec("t", "train", 64, 16)
    tree: dict = {}
    for k, v in np.load(npz).items():
        node = tree
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    params = params_from_jax(tree, cfg, device="cpu")
    model, opt = build_model(cfg), AdamW()
    state = opt.init(params)
    stream = batches_for(cfg, shape)
    plain = []
    for _ in range(3):
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in next(stream).items()}
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = model.loss(tree_unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            params, state, _ = opt.update(tree_unflatten(params, list(grads)), state, params)
        plain.append(float(loss.detach()))

    _finish(port)
    ref_out = _finish(ref)
    sharded = json.load(open(out))["losses"]
    reference = json.loads(ref_out.split("LOSSES", 1)[1])
    assert all(np.isfinite(sharded)), sharded
    np.testing.assert_allclose(sharded, plain, rtol=1e-5, atol=0)
    np.testing.assert_allclose(sharded, reference, rtol=1e-4, atol=0)


def test_pipeline_apply_on_4_gloo_ranks_matches_sequential_and_reference(tmp_path):
    S, M, mb, d = 4, 4, 16, 32
    rng = np.random.default_rng(0)
    Ws = (rng.standard_normal((S, d, d)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, mb, d)).astype(np.float32)
    npz = str(tmp_path / "pipe.npz")
    np.savez(npz, Ws=Ws, x=x)
    ref_script = tmp_path / "jax_pipeline.py"
    ref_script.write_text(JAX_PIPELINE)
    ref_out = str(tmp_path / "ref.npy")
    ref = _start(str(ref_script), npz, ref_out, jax_devices=4)
    out = str(tmp_path / "port.npy")
    port = _worker(tmp_path, "pipeline", out, npz)
    _finish(port)
    _finish(ref)
    got = np.load(out)
    seq = torch.from_numpy(x)
    for i in range(S):
        seq = torch.tanh(seq @ torch.from_numpy(Ws[i]))
    np.testing.assert_allclose(got, seq.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.load(ref_out), rtol=2e-5, atol=2e-5)


def test_elastic_restore_from_2x2_onto_4x1(tmp_path):
    out = str(tmp_path / "ok")
    ck_dir = tmp_path / "ck"
    ck_dir.mkdir()
    _finish(_worker(tmp_path, "restore", out, str(ck_dir)))
    assert open(out).read() == "ok"
