"""The port's tuning engine held against the JAX package's, on the CPU.

Virtual-clock runs are pure arithmetic, so the port must reproduce the
reference exactly: the same ``VirtualClock`` script through both
packages' ``OnlineAutotuner`` gives equal ``stats()``, every registered
strategy proposes the same sequence, and ``static_autotune`` finds the
same best. Spaces, canonical keys and the ``example_fill`` ramp agree
bit for bit.
"""

import json

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.persistence import _canon as jax_canon
from repro.kernels.catalog import example_fill as jax_example_fill
from repro.kernels.euclid import ops as jeuclid
from repro.kernels.lintra import ops as jlintra

import repro_torch.core as tcore
from repro_torch.core import evaluator as tevaluator
from repro_torch.core.gate import VariantGate
from repro_torch.core.persistence import _canon as torch_canon
from repro_torch.kernels.catalog import example_fill as torch_example_fill
from repro_torch.kernels.euclid import ops as teuclid
from repro_torch.kernels.lintra import ops as tlintra

SPEC = {"N": 1024, "M": 256, "D": 64}


def _points(space):
    return [dict(p) for p in space.iter_valid()]


# ------------------------------------------------------------------ spaces
@pytest.mark.parametrize("shape", [(1024, 64, 32), (250, 90, 70),
                                   (16384, 1024, 128), (64, 32, 16)])
def test_euclid_spaces_identical_at_tpu_capacity(shape):
    j = jeuclid.make_space(*shape, vmem_kb=jcore.TPU_V5E.vmem_kb)
    t = teuclid.make_space(*shape, vmem_kb=tcore.TPU_V5E.vmem_kb)
    assert _points(j) == _points(t)
    assert [j.no_leftover(p) for p in _points(j)] == \
           [t.no_leftover(p) for p in _points(t)]


@pytest.mark.parametrize("shape", [(160, 200, 3), (292, 292, 3),
                                   (2662, 5500, 3), (33, 50, 4)])
def test_lintra_spaces_identical_at_tpu_capacity(shape):
    j = jlintra.make_space(*shape, vmem_kb=jcore.TPU_V5E.vmem_kb)
    t = tlintra.make_space(*shape, vmem_kb=tcore.TPU_V5E.vmem_kb)
    assert _points(j) == _points(t)


def test_profiles_identical():
    from repro.core.profiles import ALL_PROFILES as jall
    from repro_torch.core.profiles import ALL_PROFILES as tall

    assert [vars(p) for p in jall] == [vars(p) for p in tall]
    assert vars(jcore.TPU_V5E) == vars(tcore.TPU_V5E)


@pytest.mark.parametrize("shape", [(7, 5), (300,), (2662, 5500, 3),
                                   ((1 << 24) + 4099,)])
def test_example_fill_bit_identical(shape):
    # past 2**24 elements the float32 ramp index rounds: still identical
    want = np.asarray(jax_example_fill(shape, "float32"))
    got = torch_example_fill(shape, "float32", device="cpu").numpy()
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_example_fill_scale_identical():
    want = np.asarray(jax_example_fill((50, 3), "float32", scale=0.25))
    got = torch_example_fill((50, 3), "float32", scale=0.25, device="cpu")
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("obj", [
    {"block_n": 64, "order": "nm", "scratch": 1},
    {"N": 16384, "M": 1024, "D": 128, "dtype": "float32"},
    [1, 2.5, "x", None, {"b": 1, "a": 2}],
])
def test_canon_agrees(obj):
    assert torch_canon(obj) == jax_canon(obj)


def test_jax_tuned_point_is_a_port_point():
    """A point tuned by the JAX package, read back as JSON, is valid in the
    port's space at the same spec, under the same canonical key."""
    jspace = jeuclid.make_space(SPEC["N"], SPEC["M"], SPEC["D"])
    cost = lambda p: jeuclid.euclid_cost_model(p, SPEC, jcore.TPU_V5E)  # noqa: E731
    best, _, _ = jcore.static_autotune(
        jeuclid.make_euclid_compilette(SPEC["N"], SPEC["M"], SPEC["D"]),
        None, score_fn=cost)
    stored = json.loads(json.dumps({"point": best}))["point"]
    tspace = teuclid.make_space(SPEC["N"], SPEC["M"], SPEC["D"])
    assert tspace.contains(stored) and tspace.is_valid(stored)
    assert torch_canon(stored) == jax_canon(best)


# ---------------------------------------------------------- control loop
def _run_virtual(core, ops, strategy, gate_mode="off", calls=400):
    clock = core.VirtualClock()
    space = ops.make_space(SPEC["N"], SPEC["M"], SPEC["D"])
    comp = core.virtual_compilette(
        clock, "euclid", space,
        lambda p: ops.euclid_cost_model(p, SPEC, core.TPU_V5E),
        gen_cost_s=2e-4)
    comp.gate_script = lambda p: p["unroll"] != 4   # scripted oracle
    comp.virtual = (clock, core.TPU_V5E)
    ev = core.VirtualClockEvaluator(clock, runs=3, fixed_eval_cost_s=1e-5)
    gate = core.VariantGate(comp) if gate_mode != "off" else None
    at = core.OnlineAutotuner(
        comp, ev, policy=core.RegenerationPolicy(0.05, 0.15),
        wake_every=2, strategy=strategy, clock=clock, gate=gate,
        gate_mode=gate_mode)
    served = []
    for i in range(calls):
        at(None)
        if i % 50 == 0:
            clock.advance(1e-4)            # scripted host work
        served.append(json.dumps(at.last_served_point, sort_keys=True))
    return at.stats(), served


@pytest.mark.parametrize("strategy", jcore.available_strategies())
def test_autotuner_stats_equal_under_virtual_clock(strategy):
    assert tcore.available_strategies() == jcore.available_strategies()
    jstats, jserved = _run_virtual(jcore, jeuclid, strategy)
    tstats, tserved = _run_virtual(tcore, teuclid, strategy)
    assert jstats["n_explored"] >= 1
    assert tstats == jstats
    assert tserved == jserved


@pytest.mark.parametrize("gate_mode", ["check", "canary"])
def test_autotuner_gate_modes_equal_under_virtual_clock(gate_mode):
    jstats, jserved = _run_virtual(jcore, jeuclid, "two_phase", gate_mode)
    tstats, tserved = _run_virtual(tcore, teuclid, "two_phase", gate_mode)
    assert jstats["gate_checks"] >= 1
    assert tstats == jstats
    assert tserved == jserved


@pytest.mark.parametrize("strategy", jcore.available_strategies())
def test_strategy_proposal_sequences_equal(strategy):
    def run(core, ops):
        space = ops.make_space(SPEC["N"], SPEC["M"], SPEC["D"])
        cost = lambda p: ops.euclid_cost_model(p, SPEC, core.TPU_V5E)  # noqa: E731
        kwargs = {"cost_fn": cost} if core.strategy_accepts(strategy, "cost_fn") else {}
        strat = core.make_strategy(strategy, space, **kwargs)
        seq = []
        for _ in range(60):
            peeked = strat.peek(2)
            point = strat.next_point()
            if point is None:
                break
            seq.append((point, peeked))
            strat.report(point, cost(point))
        return seq, strat.best_point, strat.best_score

    assert run(tcore, teuclid) == run(jcore, jeuclid)


def test_static_autotune_equal():
    def run(core, ops):
        comp = ops.make_euclid_compilette(SPEC["N"], SPEC["M"], SPEC["D"],
                                          **({"device": "cpu"} if core is tcore else {}))
        cost = lambda p: ops.euclid_cost_model(p, SPEC, core.TPU_V5E)  # noqa: E731
        return core.static_autotune(comp, None, only_no_leftover=True,
                                    max_points=40, score_fn=cost)

    assert run(tcore, teuclid) == run(jcore, jeuclid)


def test_compile_farm_manual_batches_like_reference():
    """Manual mode: one ``run_pending`` completes one batch, as the
    reference's farm does; both packages take the same three modes and
    refuse any other."""
    def run(core):
        clock = core.VirtualClock()
        space = jeuclid.make_space(256, 64, 32)
        comp = core.virtual_compilette(clock, "euclid", space, lambda p: 1e-3,
                                       gen_cost_s=5e-3)
        farm = core.CompileFarm("manual", workers=2)
        tickets = [farm.submit(comp, p, {}, priority=float(i % 3))
                   for i, p in enumerate(list(space.iter_valid())[:5])]
        batches = []
        while farm.run_pending():
            batches.append([t.done for t in tickets])
        return batches, [t.gen_charge_s for t in tickets]

    assert run(tcore) == run(jcore)
    for core in (tcore, jcore):
        farm = core.CompileFarm("process", workers=2)
        assert farm.stats()["mode"] == "process"
        assert (farm.stats()["process_offloaded"], farm.stats()["process_fallbacks"]) == (0, 0)
        farm.shutdown()
        with pytest.raises(ValueError):
            core.CompileFarm("processes")


# ------------------------------------------------------------ touch points
def test_time_once_on_cpu_uses_host_clock():
    x = torch.ones(8)
    assert tevaluator.time_once(lambda t: t * 2, (x,)) >= 0.0
    tevaluator.block_until_ready(x)          # a CPU tensor is complete: no sync


def test_device_memory_probe_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcore.device_free_memory_bytes() is None
    assert tcore.executable_bytes(lambda: None) is None


def test_gate_compares_tensors_on_the_host():
    class Comp:
        oracle = staticmethod(lambda x: x * 2)
        tolerance = {"rtol": 1e-5, "atol": 1e-7}

        @staticmethod
        def example_call_args():
            return (torch.arange(6, dtype=torch.float32),)

    gate = VariantGate(Comp())
    assert gate.check({}, lambda x: x * 2) == (True, "")
    ok, reason = gate.check({}, lambda x: x * 2 + 1)
    assert not ok and "max|err|" in reason
