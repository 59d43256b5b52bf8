"""Roofline terms of the port: the ring model on traced collectives, the
term arithmetic, and the H100's constants.

The reference's cases (``tests/test_roofline.py``) on the port. The
collectives are traced in a subprocess on a fake process group of 8 (a
4 x 2 mesh, so the groups have 2, 4 and 8 ranks).
"""

import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.distributed import roofline as rl
from repro_torch.distributed.hlo_analysis import Totals, link_bytes
from repro_torch.distributed.roofline import roofline_from

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ring_model_on_traced_collectives():
    code = textwrap.dedent("""
        import json
        import torch, torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch.fx.experimental.proxy_tensor import make_fx
        from repro_torch.distributed.roofline import collective_stats
        from repro_torch.launch.mesh import make_mesh
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
        mesh = make_mesh((4, 2), ("data", "model"), "cpu")
        def f(a, b, c):
            a = funcol.all_reduce(a, "sum", (mesh, 1))            # g = 2
            b = funcol.all_gather_tensor(b, 0, (mesh, 0))         # g = 4
            c = funcol.reduce_scatter_tensor(c, "sum", 0, (mesh, 0))
            d = funcol.all_reduce(a * 2, "sum", dist.group.WORLD)  # g = 8
            return a, b, c, d
        gm = make_fx(f, tracing_mode="fake")(
            torch.ones(128, 64), torch.ones(64, 64, dtype=torch.bfloat16),
            torch.ones(64, 64))
        st = collective_stats(gm)
        print("STATS", json.dumps({"per_op": st.per_op_bytes, "n_ops": st.n_ops,
                                   "link": st.link_bytes}))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    st = json.loads(out.stdout.split("STATS", 1)[1])
    assert st["n_ops"] == {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1}
    # all-reduce: 2 * out * (g-1)/g, at g = 2 and g = 8
    ar = 2 * (128 * 64 * 4) * 1 / 2 + 2 * (128 * 64 * 4) * 7 / 8
    assert st["per_op"]["all-reduce"] == pytest.approx(ar)
    # all-gather: out * (g-1)/g, g = 4, bf16, out = (256, 64)
    assert st["per_op"]["all-gather"] == pytest.approx((256 * 64 * 2) * 3 / 4)
    # reduce-scatter: out * (g-1), g = 4, out = (16, 64)
    assert st["per_op"]["reduce-scatter"] == pytest.approx((16 * 64 * 4) * 3)
    assert st["link"] == pytest.approx(sum(st["per_op"].values()))


def test_link_bytes_formulas():
    assert link_bytes("all-reduce", 100.0, 4) == pytest.approx(150.0)
    assert link_bytes("reduce-scatter", 100.0, 4) == pytest.approx(300.0)
    assert link_bytes("all-gather", 100.0, 4) == pytest.approx(75.0)
    assert link_bytes("all-to-all", 100.0, 1) == 0.0


def test_roofline_terms_and_bound():
    peak, hbm = 989.4e12, 3.35e12
    cost = {"flops": peak, "bytes accessed": hbm * 2}  # 1 s vs 2 s
    roof = roofline_from(cost, Totals(), n_chips=256,
                         model_flops=peak * 256 * 0.5, peak=peak, hbm=hbm)
    assert roof.compute_s == pytest.approx(1.0)
    assert roof.memory_s == pytest.approx(2.0)
    assert roof.bound == "memory"
    assert roof.useful_ratio == pytest.approx(0.5)
    assert roof.roofline_frac == pytest.approx(0.25)  # 0.5 s ideal / 2 s


def test_roofline_reads_the_walkers_totals_first():
    t = Totals(flops=67e12 * 3, bytes=3.35e12, coll_bytes=450e9 * 4)
    roof = roofline_from({"flops": 1.0, "bytes accessed": 1.0}, t, n_chips=1,
                         model_flops=67e12 * 3, peak=67e12)
    assert roof.compute_s == pytest.approx(3.0)
    assert roof.memory_s == pytest.approx(1.0)
    assert roof.collective_s == pytest.approx(4.0)
    assert roof.bound == "collective"
    assert roof.bytes_link == t.coll_bytes


def test_constants_are_the_h100s():
    assert rl.PEAK_FLOPS == 989.4e12
    assert rl.PEAK_FLOPS_FP32 == 67e12
    assert rl.HBM_BW == 3.35e12
    assert rl.LINK_BW == 450e9


def test_model_flops_formulas():
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import DECODE_32K, TRAIN_4K
    from repro_torch.launch.shapes import model_flops

    cfg = REGISTRY["deepseek-7b"]
    mf = model_flops(cfg, TRAIN_4K)
    base = 6.0 * cfg.n_params() * TRAIN_4K.global_batch * TRAIN_4K.seq_len
    assert base < mf < base * 1.5  # the attention term adds on top
    moe = REGISTRY["qwen3-moe-30b-a3b"]
    assert moe.n_active_params() < 0.2 * moe.n_params()
    assert model_flops(cfg, DECODE_32K) < mf / 1000


def test_skip_matrix():
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import LONG_500K, TRAIN_4K
    from repro_torch.launch.shapes import skip_reason

    skipped = [a for a in REGISTRY if skip_reason(REGISTRY[a], LONG_500K) is not None]
    assert sorted(skipped) == sorted([
        "llama4-scout-17b-a16e", "qwen3-moe-30b-a3b", "command-r-35b",
        "deepseek-coder-33b", "qwen2.5-32b", "deepseek-7b", "qwen2-vl-7b",
        "whisper-tiny"])
    assert all(skip_reason(REGISTRY[a], TRAIN_4K) is None for a in REGISTRY)
