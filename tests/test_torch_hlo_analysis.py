"""The per-device graph walker: the roofline's numbers ride on it.

The reference's cases (``tests/test_hlo_analysis.py``), each on graphs
that ``make_fx`` traces on fake tensors; Python loops stand where the
reference has ``lax.scan``, so the graph holds every iteration. Product
FLOPs are also held equal to the reference's ``analyze_hlo`` of the
same functions. The sharded product runs in a subprocess on a fake
process group of 8 (no group is left in the test's process).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils.checkpoint import checkpoint

from repro.distributed.hlo_analysis import analyze_hlo

from repro_torch.distributed.hlo_analysis import (
    analyze_graph, cost_analysis, memory_analysis)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graph(fn, *args):
    return make_fx(fn, tracing_mode="fake")(*args)


def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _loop(x, ws):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


def _nested(x, ws):
    for blk in ws:
        for w in blk:
            x = x @ w
    return x


def test_flat_matmul_flops_exact():
    M, K, N = 128, 256, 64
    t = analyze_graph(_graph(lambda a, b: a @ b, torch.ones(M, K), torch.ones(K, N)))
    assert t.flops == 2 * M * N * K


def test_loop_counts_every_iteration():
    M, K, n = 64, 128, 10
    t = analyze_graph(_graph(_loop, torch.ones(M, K), torch.ones(n, K, K)))
    assert t.flops == pytest.approx(n * 2 * M * K * K)


def test_nested_loops_multiply():
    M, K = 64, 128
    t = analyze_graph(_graph(_nested, torch.ones(M, K), torch.ones(4, 5, K, K)))
    assert t.flops == pytest.approx(20 * 2 * M * K * K)


def test_checkpoint_recompute_counted():
    M, K = 64, 128
    args = (torch.ones(M, K), torch.ones(K, K) * 0.01, torch.ones(K, 1) * 0.01)

    def block(x, w1):
        return torch.tanh(x @ w1)

    def grad_of(remat):
        def f(x, w1, w2):
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                h = checkpoint(block, x, w1, use_reentrant=False) if remat \
                    else block(x, w1)
                loss = torch.sum(h @ w2)
                return torch.autograd.grad(loss, x)[0]
        return analyze_graph(_graph(f, *args))

    plain = analyze_graph(_graph(
        lambda x, w1, w2: torch.sum(torch.tanh(x @ w1) @ w2), *args))
    grad, remat = grad_of(False), grad_of(True)
    assert grad.flops >= 2 * plain.flops - 1
    # the recompute itself: one more forward product of the block
    assert remat.flops == pytest.approx(grad.flops + 2 * M * K * K)


def test_bytes_follow_the_fusion_model_on_matmul():
    M, K, N = 128, 256, 64
    t = analyze_graph(_graph(lambda a, b: a @ b, torch.ones(M, K), torch.ones(K, N)))
    expected = (M * K + K * N + 2 * M * N) * 4
    assert t.bytes == pytest.approx(expected, rel=0.3)
    assert cost_analysis(_graph(lambda a, b: a @ b, torch.ones(M, K),
                                torch.ones(K, N))) == {"flops": t.flops,
                                                       "bytes accessed": t.bytes}


def test_elementwise_chains_are_fused_free():
    """A long elementwise chain should add ~no HBM traffic vs one op."""
    x = torch.ones(256, 256)

    def chain(x):
        for _ in range(10):
            x = torch.tanh(x) * 1.01 + 0.001
        return x

    t1 = analyze_graph(_graph(lambda x: torch.tanh(x), x))
    t10 = analyze_graph(_graph(chain, x))
    assert t10.bytes <= t1.bytes * 6


def test_memory_walk_frees_dead_intermediates():
    M, K, n = 64, 128, 10
    gm = _graph(_loop, torch.ones(M, K), torch.ones(n, K, K))
    mem = memory_analysis(gm)
    args = (M * K + n * K * K) * 4
    assert mem["argument_bytes"] == args
    assert mem["output_bytes"] == M * K * 4
    # one product and its tanh live at a time, not all ten
    assert args < mem["peak_bytes"] <= args + 3 * M * K * 4
    donated = memory_analysis(gm, donated={0, 1})
    assert donated["alias_bytes"] == args
    assert donated["peak_bytes"] <= mem["peak_bytes"]


@pytest.mark.parametrize("case", ["matmul", "loop", "nested"])
def test_product_flops_equal_the_reference(case):
    M, K = 64, 128
    if case == "matmul":
        port = _graph(lambda a, b: a @ b, torch.ones(M, K), torch.ones(K, 32))
        ref = _hlo(lambda a, b: a @ b, jnp.ones((M, K)), jnp.ones((K, 32)))
    elif case == "loop":
        port = _graph(_loop, torch.ones(M, K), torch.ones(10, K, K))
        ref = _hlo(lambda x, ws: jax.lax.scan(
            lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0],
            jnp.ones((M, K)), jnp.ones((10, K, K)))
    else:
        port = _graph(_nested, torch.ones(M, K), torch.ones(4, 5, K, K))

        def f(x, ws):
            def outer(c, blk):
                return jax.lax.scan(lambda c2, w: (c2 @ w, None), c, blk)[0], None
            return jax.lax.scan(outer, x, ws)[0]
        ref = _hlo(f, jnp.ones((M, K)), jnp.ones((4, 5, K, K)))
    assert analyze_graph(port).flops == analyze_hlo(ref).flops


def test_collective_bytes_under_a_sharded_product():
    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.fx.experimental.proxy_tensor import make_fx
        from repro_torch.distributed.hlo_analysis import analyze_graph
        from repro_torch.launch.mesh import make_mesh
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
        mesh = make_mesh((8,), ("model",), "cpu")
        def f(x, w):
            x = DTensor.from_local(x, mesh, (Replicate(),), run_check=False)
            w = DTensor.from_local(w, mesh, (Shard(1),), run_check=False,
                                   shape=(128, 512), stride=(512, 1))
            return torch.sum(x @ w, dim=-1).full_tensor()
        gm = make_fx(f, tracing_mode="fake")(torch.ones(64, 128), torch.ones(128, 64))
        t = analyze_graph(gm)
        # the local product is (64, 128) x (128, 64): an eighth of the global one
        assert t.flops == 2 * 64 * 128 * 64, t.flops
        assert t.coll_bytes > 0 and t.coll_per_op, t
        print("COLL", t.coll_bytes, sorted(t.coll_per_op))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "COLL" in out.stdout
