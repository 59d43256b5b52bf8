"""Traffic replay and the virtual-clock benchmarks of the port.

The first half ports ``tests/test_replay.py`` (the acceptance suite of
``repro.bench.replay`` and ``benchmarks/scenario_fleet.py``) to
``repro_torch.bench.replay`` and ``benchmarks/torch_scenario_fleet.py``:
seeded arrival processes and mixes, trace synthesis and multi-tenant
merging, the virtual-clock replay engine, and the fleet gates (two
same-seed runs byte-identical; tuning overhead <= 5 %; speedup vs
reference >= 1.0 on every row).

The second half holds the port against the reference: the harness is
pure arithmetic on a virtual clock, so the same scenarios and seeds give
equal traces and equal replay reports, and each of the eight ported
benchmark scripts (``benchmarks/torch_<name>.py``) gives JSON equal to
its reference script's at the reference's ``--quick`` sizes (the scripts
without ``--quick`` at their only size), with every gate of the script
run along. No key is stripped before the comparison: the replay
sessions' device labels are fixed strings (``fleet:v`` and the like),
not fingerprints of the host, so :data:`FINGERPRINT_KEYS` is empty.
"""

import dataclasses
import importlib
import importlib.util
import json
import random
import sys
from pathlib import Path

import pytest

from repro_torch.bench import (
    Request, Trace, bursty_arrivals, choice_mix, fixed_mix,
    fleet_scenarios, longtail_mix, make_trace, merge_traces, phase_arrivals,
    phase_mix, poisson_arrivals, ramp_arrivals, replay_scenario,
)
from repro_torch.configs import REGISTRY

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmarks"
ARRIVALS = [poisson_arrivals, bursty_arrivals, ramp_arrivals, phase_arrivals]
#: keys stripped from both packages' JSON before comparing: none, since
#: no script's output carries a fingerprint of the host or its framework
FINGERPRINT_KEYS: frozenset = frozenset()


def _load_script(name: str):
    """A benchmark script as a module of its own (not under ``__main__``)."""
    for path in (str(ROOT), str(BENCH)):
        if path not in sys.path:
            sys.path.insert(0, path)
    spec = importlib.util.spec_from_file_location(f"_bench_{name}", BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fleet_module():
    return _load_script("torch_scenario_fleet")


def _plain(payload):
    """JSON data with the fingerprint keys removed at every depth."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k not in FINGERPRINT_KEYS}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return strip(json.loads(json.dumps(payload, sort_keys=True, default=str)))


# ------------------------------------------------------------- arrivals
@pytest.mark.parametrize("arrival", ARRIVALS, ids=lambda a: a.__name__)
def test_arrival_processes_are_seeded_and_bounded(arrival):
    a1 = arrival(random.Random("s"), rate_hz=50.0, duration_s=4.0)
    a2 = arrival(random.Random("s"), rate_hz=50.0, duration_s=4.0)
    assert a1 == a2                       # same seed, same arrivals
    assert a1 == sorted(a1)
    assert all(0.0 <= t < 4.0 for t in a1)
    # the processes are average-rate-preserving: ~rate*duration events
    assert 0.4 * 200 <= len(a1) <= 2.0 * 200
    a3 = arrival(random.Random("other"), rate_hz=50.0, duration_s=4.0)
    assert a1 != a3                       # seed actually matters


def test_bursty_arrivals_cluster_into_bursts():
    rng = random.Random(3)
    times = bursty_arrivals(rng, rate_hz=100.0, duration_s=8.0,
                            burst_factor=8.0)
    gaps = sorted(b - a for a, b in zip(times, times[1:]))
    # on/off traffic: tight in-burst gaps plus long inter-burst silences
    assert gaps[len(gaps) // 2] < 1.0 / 100.0
    assert gaps[-1] > 4.0 / 100.0


# ----------------------------------------------------------------- mixes
def test_mixes_are_seeded_and_in_range():
    lt = longtail_mix(64, 4096, sigma=1.0)
    draws = [lt(random.Random(9), i / 100.0) for i in range(100)]
    assert draws == [lt(random.Random(9), i / 100.0) for i in range(100)]
    assert all(64 <= d <= 4096 for d in draws)
    assert fixed_mix(7)(random.Random(0), 0.3) == 7
    ch = choice_mix((1, 2), (1.0, 0.0))
    assert ch(random.Random(0), 0.5) == 1
    pm = phase_mix(fixed_mix(1), fixed_mix(2), switch_at=0.5)
    assert pm(random.Random(0), 0.2) == 1
    assert pm(random.Random(0), 0.8) == 2


# ---------------------------------------------------------------- traces
def test_make_trace_is_deterministic_and_sorted():
    sc = fleet_scenarios(64)[1]           # bursty_longtail
    t1 = make_trace(sc, "tenant-a", 200.0, seed=5)
    t2 = make_trace(sc, "tenant-a", 200.0, seed=5)
    assert t1 == t2
    assert t1 != make_trace(sc, "tenant-a", 200.0, seed=6)
    # a different tenant name reseeds the stream, not just relabels it
    assert ([r.prompt_len for r in t1.requests]
            != [r.prompt_len
                for r in make_trace(sc, "tenant-b", 200.0, seed=5).requests])
    ts = [r.t_arrival_s for r in t1.requests]
    assert ts == sorted(ts)
    assert all(r.tenant == "tenant-a" for r in t1.requests)


def test_merge_traces_interleaves_tenants_in_time_order():
    sc = fleet_scenarios(48)[0]
    ta = make_trace(sc, "a", 150.0, seed=1)
    tb = make_trace(sc, "b", 150.0, seed=1)
    merged = merge_traces("pair", [ta, tb])
    assert merged.tenants == ("a", "b")
    assert len(merged.requests) == len(ta.requests) + len(tb.requests)
    keys = [(r.t_arrival_s, r.tenant) for r in merged.requests]
    assert keys == sorted(keys)


# ----------------------------------------------------------------- engine
def test_replay_requires_a_virtual_clock():
    from repro_torch.api import TuningSession

    trace = Trace("t", 0, 1.0, ("deepseek-7b",),
                  (Request(0.0, "deepseek-7b", 128, 0),))
    session = TuningSession()             # wall clock: no .advance
    try:
        with pytest.raises(TypeError):
            session.replay(trace)
    finally:
        session.close()


def test_single_config_replay_converges_and_reports():
    sc = fleet_scenarios(160)[0]          # steady_poisson
    rep = replay_scenario(sc, {"deepseek-7b": REGISTRY["deepseek-7b"]},
                          seed=0)
    pt = rep["per_tenant"]["deepseek-7b"]
    t = rep["tuning"]
    assert rep["trace"]["tenants"] == ["deepseek-7b"]
    assert pt["n_requests"] > 100
    assert pt["p99_s"] >= pt["p50_s"] > 0.0
    assert pt["n_handles"] >= 3           # rmsnorm + matmul + attention
    assert t["swaps"] > 0                 # tuning actually found wins
    assert pt["speedup_vs_ref"] > 1.0
    assert t["time_to_best_s"] is not None
    assert 0.0 < t["time_to_best_s"] <= rep["trace"]["duration_s"] * 2
    assert 0.0 < t["overhead_pct"] <= 5.0
    assert 0.0 <= t["cache_hit_rate"] <= 1.0
    # identical seed -> byte-identical report
    rep2 = replay_scenario(sc, {"deepseek-7b": REGISTRY["deepseek-7b"]},
                           seed=0)
    assert json.dumps(rep, sort_keys=True, default=str) \
        == json.dumps(rep2, sort_keys=True, default=str)


def test_bursty_traffic_builds_a_queueing_tail():
    sc = fleet_scenarios(160)[1]          # bursty_longtail
    rep = replay_scenario(sc, {"qwen2.5-32b": REGISTRY["qwen2.5-32b"]},
                          seed=0)
    pt = rep["per_tenant"]["qwen2.5-32b"]
    # bursts overrun the server: the p99 sits well above the median
    assert pt["p99_s"] > 2.0 * pt["p50_s"]


def test_multi_tenant_replay_shares_one_session():
    sc = fleet_scenarios(48)[0]
    names = ["deepseek-7b", "whisper-tiny", "rwkv6-1.6b"]
    rep = replay_scenario(sc, {n: REGISTRY[n] for n in names}, seed=0)
    assert sorted(rep["per_tenant"]) == sorted(names)
    for name in names:
        pt = rep["per_tenant"][name]
        assert pt["n_requests"] > 0
        assert pt["speedup_vs_ref"] >= 1.0
    assert rep["tuning"]["overhead_pct"] <= 5.0


def test_session_replay_delegates_to_bench_replay():
    from repro_torch.api import TuningSession
    from repro_torch.bench import replay as bench_replay
    from repro_torch.bench.replay import replay_session
    from repro_torch.core import VirtualClock

    assert TuningSession.replay.__doc__
    sc = fleet_scenarios(32)[0]
    trace = make_trace(sc, "whisper-tiny", 400.0, seed=2)
    clock = VirtualClock()
    session = replay_session(clock)
    try:
        rep = session.replay(trace,
                             {"whisper-tiny": REGISTRY["whisper-tiny"]})
    finally:
        session.close()
    clock2 = VirtualClock()
    session2 = replay_session(clock2)
    try:
        rep2 = bench_replay(session2, trace,
                            {"whisper-tiny": REGISTRY["whisper-tiny"]})
    finally:
        session2.close()
    assert json.dumps(rep, sort_keys=True, default=str) \
        == json.dumps(rep2, sort_keys=True, default=str)


# ------------------------------------------------------------ fleet gates
def test_scenario_fleet_quick_is_deterministic_and_gated():
    """The acceptance: >= 10 configs x >= 4 scenarios (+ multi-tenant),
    two same-seed runs byte-identical, overhead <= 5% and speedup >= 1.0
    on every row."""
    fleet = _fleet_module()
    p1 = fleet.run(quick=True, seed=0, write=False)
    p2 = fleet.run(quick=True, seed=0, write=False)
    assert json.dumps(p1, sort_keys=True, default=str) \
        == json.dumps(p2, sort_keys=True, default=str)

    assert p1["n_configs"] >= 10
    assert p1["n_scenarios"] >= 4
    scenario_names = {r["scenario"] for r in p1["rows"]}
    assert len(scenario_names) >= 5       # 4 traffic shapes + multi_tenant
    assert "multi_tenant" in scenario_names
    assert len(p1["rows"]) >= 10 * 4

    assert p1["violations"] == []
    for r in p1["rows"]:
        assert r["overhead_pct"] <= fleet.MAX_OVERHEAD_PCT, r
        assert r["speedup_vs_ref"] >= fleet.MIN_SPEEDUP, r
    # tuning is live across the fleet, not vacuously gated
    assert sum(1 for r in p1["rows"] if r["swaps"]) >= len(p1["rows"]) // 2


def test_scenario_fleet_check_rows_flags_violations():
    fleet = _fleet_module()
    bad = [{"scenario": "s", "config": "c",
            "overhead_pct": 7.5, "speedup_vs_ref": 0.9}]
    msgs = fleet.check_rows(bad)
    assert len(msgs) == 2
    assert "overhead" in msgs[0] and "speedup" in msgs[1]
    good = [{"scenario": "s", "config": "c",
             "overhead_pct": 0.5, "speedup_vs_ref": 1.2}]
    assert fleet.check_rows(good) == []


# ------------------------------------------------- parity with the reference
def _reference_replay():
    return importlib.import_module("repro.bench.replay")


@pytest.mark.parametrize("seed", [0, 7])
def test_make_trace_equals_the_reference(seed):
    """Every standing and fault scenario, one and two tenants: the same
    requests, field for field, as the reference's harness scripts."""
    jr = _reference_replay()
    tr = importlib.import_module("repro_torch.bench.replay")
    for jsc, tsc in zip(jr.fleet_scenarios(64) + jr.fault_scenarios(64),
                        tr.fleet_scenarios(64) + tr.fault_scenarios(64)):
        assert jsc.name == tsc.name
        jt = [jr.make_trace(jsc, n, 120.0, seed, host_cost_s=1e-4) for n in ("a", "b")]
        tt = [tr.make_trace(tsc, n, 120.0, seed, host_cost_s=1e-4) for n in ("a", "b")]
        assert dataclasses.asdict(jr.merge_traces("ab", jt)) == \
            dataclasses.asdict(tr.merge_traces("ab", tt))
        assert dataclasses.asdict(jt[0]) == dataclasses.asdict(tt[0])


@pytest.mark.parametrize("scenario,names", [
    ("steady_poisson", ("deepseek-7b",)),
    ("phase_change", ("qwen3-moe-30b-a3b", "whisper-tiny")),
    ("wrong_output_variant", ("deepseek-7b",)),
])
def test_replay_scenario_equals_the_reference(scenario, names):
    """``replay_scenario`` (a fresh session, ``session.replay``) reports
    what the reference's reports, fault injection included."""
    jr = _reference_replay()
    tr = importlib.import_module("repro_torch.bench.replay")
    jcfgs = importlib.import_module("repro.configs").REGISTRY

    def pick(mod):
        return next(s for s in mod.fleet_scenarios(64) + mod.fault_scenarios(64)
                    if s.name == scenario)

    want = jr.replay_scenario(pick(jr), {n: jcfgs[n] for n in names}, seed=1)
    got = tr.replay_scenario(pick(tr), {n: REGISTRY[n] for n in names}, seed=1)
    assert _plain(got) == _plain(want)


#: script -> how its reference is driven: ("run", kwargs) calls
#: ``run(**kwargs)``, ("main", argv) calls ``main()`` under that argv; a
#: script that saves its artifact has ``save`` replaced by a recorder
SCRIPTS = {
    "coordinator_warmstart": ("main", []),
    "kernel_plane": ("main", []),
    "compile_farm": ("main", []),
    "scenario_fleet": ("run", {"quick": True, "seed": 0, "write": False}),
    "fig7_varying_workload": ("run", {"quick": True}),
    "fleet_fabric": ("run", {"quick": True, "seed": 0, "write": False}),
    "transfer_grid": ("run", {"quick": True, "seed": 0, "write": False}),
    "fig5_simulated_cores": ("run", {}),
    "fig1_motivational": ("run", {}),
    "table5_param_correlation": ("run", {}),
}


def _drive(name: str, monkeypatch) -> list:
    """Run one script (its asserts and exit gates included); returns the
    payloads it returned or would have saved, as plain JSON data."""
    mod = _load_script(name)
    kind, arg = SCRIPTS[name.removeprefix("torch_")]
    saved: list = []
    monkeypatch.setattr(mod, "save", lambda n, payload: saved.append((n, payload)),
                        raising=False)
    if kind == "main":
        monkeypatch.setattr(sys, "argv", [f"{name}.py", *arg])
        ret = mod.main()
    else:
        ret = mod.run(**arg)
    if isinstance(ret, dict) and "violations" in ret:
        # the exit gate of the script's main(): any violation exits 1
        assert ret["violations"] == [], ret["violations"]
    return _plain([ret if isinstance(ret, dict) else None, [p for _n, p in saved]])


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_benchmark_script_json_equals_the_reference(name, monkeypatch, capsys):
    """The port's script passes its gates and gives the reference's JSON."""
    want = _drive(name, monkeypatch)
    got = _drive(f"torch_{name}", monkeypatch)
    assert got == want
    assert any(got), f"{name} produced no payload"
    out = capsys.readouterr().out
    assert out                              # the script printed its table


@pytest.mark.parametrize("shape", [(2048, 2048, 2048), (512, 1024, 96)])
def test_make_matmul_compilette_is_the_references_on_the_cpu(shape):
    """Built for the CPU, the port's matmul compilette has the reference's
    space (the TPU capacity) and simulates every valid point on every
    profile to the reference's seconds."""
    from repro_torch.core.profiles import ALL_PROFILES
    from repro_torch.kernels.matmul.ops import make_matmul_compilette

    jops = importlib.import_module("repro.kernels.matmul.ops")
    jprofiles = importlib.import_module("repro.core.profiles")
    want = jops.make_matmul_compilette(*shape)
    got = make_matmul_compilette(*shape, device="cpu")
    points = list(got.space.iter_valid())
    assert [dict(p) for p in points] == [dict(p) for p in want.space.iter_valid()]
    assert points
    for prof, jprof in zip(ALL_PROFILES, jprofiles.ALL_PROFILES):
        assert prof.name == jprof.name
        for p in points[::7]:
            assert got.simulate(p, prof) == want.simulate(p, jprof)


def test_simulated_cores_example_prints_fig5s_table(tmp_path):
    """``examples/torch_simulated_cores.py``, run from another directory,
    prints the tables and summary of ``benchmarks/torch_fig5_simulated_cores.py``."""
    import subprocess

    res = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_simulated_cores.py")],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr
    assert "Fig.5" in res.stdout and "summary:" in res.stdout
    for prof in ("SI-L1", "TI-F3"):
        assert prof in res.stdout
