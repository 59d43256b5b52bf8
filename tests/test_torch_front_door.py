"""The rest of the port's front door, held against the reference on the CPU.

* ``examples/torch_quickstart.py``: its ``--virtual``, ``--fleet`` and
  ``--transfer`` modes are virtual-clock arithmetic, so they print what
  the reference's ``examples/quickstart.py`` prints, line for line; its
  real run, with ``--device cpu`` (the euclid kernel's plain version),
  ends within the oracle.
* ``benchmarks/torch_table4_tuning_stats.py``: on the CPU its spaces are
  the reference's (TPU capacity), so ``explorable`` and ``one_run_limit``
  equal the reference's for all six cases; a short run produces its rows.
* The compile farm's ``process`` backend: a module-level payload runs in
  a spawned child (another pid) whose seconds join the generation
  charge; a compilette without a payload (the CUDA C++ families, a spec
  off the card) compiles in-thread, counted as a fallback; a session
  built with ``compile_backend="process"`` runs its farm in that mode.
* ``examples/torch_serve_lm.py`` at a reduced config on the CPU, and a
  second run warm-starting from the registry the first one wrote.
"""

import importlib.util
import json
import os
import sys
import threading
from pathlib import Path

import pytest

from repro_torch.core import CompileFarm
from repro_torch.kernels.catalog import get_catalog
from repro_torch.kernels.lintra.ops import DEFAULT_POINT as LINTRA_DEFAULT

ROOT = Path(__file__).resolve().parents[1]
LINTRA_CPU = {"H": 100, "W": 50, "bands": 3, "dtype": "float32", "device": "cpu"}


def _load(path: Path, name: str):
    """A script of the checkout as a module of its own (not ``__main__``)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wait(ticket, timeout_s: float = 120.0):
    done = threading.Event()
    for _ in range(int(timeout_s / 0.01)):
        if ticket.done:
            break
        done.wait(0.01)
    assert ticket.done, "the compile job did not finish"
    return ticket


# ------------------------------------------------------------- quickstart
@pytest.mark.parametrize("mode", ["main_virtual", "main_fleet", "main_transfer"])
def test_quickstart_virtual_modes_print_the_references_stats(mode, capsys):
    ref = _load(ROOT / "examples" / "quickstart.py", "_ref_quickstart")
    port = _load(ROOT / "examples" / "torch_quickstart.py", "_torch_quickstart")
    getattr(ref, mode)()
    want = capsys.readouterr().out
    getattr(port, mode)()
    got = capsys.readouterr().out
    assert got == want
    assert got.count("\n") >= 2


def test_quickstart_real_run_on_the_cpu_ends_within_the_oracle(capsys):
    port = _load(ROOT / "examples" / "torch_quickstart.py", "_torch_quickstart")
    out = port.main("cpu")
    assert out["calls"] == 200 and out["max_abs_err"] <= 1e-3
    assert out["stats"]["n_explored"] >= 1
    assert out["best_point"]["block_d"] in (16, 32, 64)
    assert "max abs err vs oracle" in capsys.readouterr().out


# ---------------------------------------------------------------- Table 4
def test_table4_space_statistics_equal_the_references():
    """explorable and one_run_limit for all six cases: the port's CPU
    spaces against the reference's, through each script's own helpers."""
    ref = _load(ROOT / "benchmarks" / "table4_tuning_stats.py", "_ref_table4")
    port = _load(ROOT / "benchmarks" / "torch_table4_tuning_stats.py", "_torch_table4")
    cases = port.cases()
    assert cases == [("euclid", 32), ("euclid", 64), ("euclid", 128),
                     ("lintra", 160), ("lintra", 292), ("lintra", 332)]
    for bench, size in cases:
        comp, _args, _spec = port.case_compilette(bench, size, "cpu")
        if bench == "euclid":
            jcomp = ref.euclid.make_euclid_compilette(ref.N_POINTS, ref.M_CENTERS, size)
        else:
            jcomp = ref.lintra.make_lintra_compilette(size, 200, 3)
        assert comp.space.n_valid_variants() == jcomp.space.n_valid_variants()
        assert port.one_run_limit(comp.space) == ref.one_run_limit(jcomp.space), (bench, size)


def test_table4_short_run_on_the_cpu():
    port = _load(ROOT / "benchmarks" / "torch_table4_tuning_stats.py", "_torch_table4")
    payload = port.run(quick=True, device="cpu", calls=40, write=False)
    assert payload["device"] == "cpu"
    assert [(r["bench"], r["size"]) for r in payload["rows"]] == [("euclid", 32),
                                                                 ("lintra", 160)]
    for r in payload["rows"]:
        assert r["space"] == "tpu" and r["kernel_calls"] == 40
        assert r["explored"] >= 1 and r["one_run_limit"] <= r["explorable"]


# -------------------------------------------------------- process backend
def test_process_backend_offloads_a_compile_to_a_spawned_child(tmp_path):
    """``compile_in_process`` named by a module-level payload runs in a
    spawned child; its seconds are added to the generation charge."""
    from repro_torch.core import VirtualClock, virtual_compilette

    comp_cpu = get_catalog().compilette("lintra", LINTRA_CPU)
    clock = VirtualClock()
    comp = virtual_compilette(clock, "lintra", comp_cpu.space, lambda p: 1e-3,
                              gen_cost_s=0.002)
    comp.process_payload = lambda point, spec: (
        "repro_torch.kernels.catalog", "compile_in_process",
        {"kernel": "lintra", "point": dict(point), "spec": LINTRA_CPU,
         "triton_cache_dir": str(tmp_path)})
    farm = CompileFarm("process", workers=1)
    try:
        t = _wait(farm.submit(comp, dict(LINTRA_DEFAULT), {}), timeout_s=300)
    finally:
        farm.shutdown()
    assert t.error is None
    stats = farm.stats()
    assert (stats["process_offloaded"], stats["process_fallbacks"]) == (1, 0)
    assert t.kern.meta["process_pid"] != os.getpid()
    child_s = t.kern.meta["process_compile_s"]
    assert child_s >= 0.0
    assert t.gen_charge_s == pytest.approx(0.002 + child_s)


def test_process_payloads_by_family():
    """lintra on a CUDA spec names ``compile_in_process`` with the Triton
    cache directory; the CUDA C++ families, a spec off the card and the
    virtual backend have no payload (their compiles stay in-thread)."""
    from repro_torch.core import TPU_V5E, VirtualClock

    cat = get_catalog()
    cuda = dict(LINTRA_CPU, device="cuda:0", vmem_kb=227)
    payload = cat.compilette("lintra", cuda).process_payload(LINTRA_DEFAULT, {"W": 50})
    module, attr, kwargs = payload
    assert (module, attr) == ("repro_torch.kernels.catalog", "compile_in_process")
    assert kwargs["kernel"] == "lintra" and kwargs["spec"]["W"] == 50
    assert kwargs["triton_cache_dir"] == os.environ.get("TRITON_CACHE_DIR")
    assert cat.compilette("lintra", LINTRA_CPU).process_payload(LINTRA_DEFAULT, {}) is None
    virtual = cat.compilette("lintra", cuda, virtual=(VirtualClock(), TPU_V5E))
    assert virtual.process_payload(LINTRA_DEFAULT, {}) is None
    att = {"B": 1, "Tq": 64, "Tkv": 64, "H": 2, "Hk": 1, "Dh": 16, "causal": True,
           "dtype": "float32", "device": "cuda:0", "vmem_kb": 227}
    point = next(iter(cat.compilette("attention", att).space.iter_valid()))
    assert cat.compilette("attention", att).process_payload(point, {}) is None


def test_compile_in_process_builds_the_variant_in_this_process(tmp_path, monkeypatch):
    """The child's entry, run here: it resolves the kernel from the
    catalog, generates the point, points Triton's cache where it is told
    and returns the seconds."""
    from repro_torch.kernels.catalog import compile_in_process

    monkeypatch.setenv("TRITON_CACHE_DIR", "elsewhere")
    seconds = compile_in_process("lintra", LINTRA_DEFAULT, LINTRA_CPU,
                                 triton_cache_dir=str(tmp_path))
    assert seconds >= 0.0
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path)


def test_process_backend_counts_an_in_thread_fallback():
    """A catalog compilette with no payload (attention: a CUDA C++
    family) is generated in the farm's thread and counted."""
    att = {"B": 1, "Tq": 32, "Tkv": 32, "H": 2, "Hk": 1, "Dh": 16, "causal": True,
           "dtype": "float32", "device": "cpu"}
    comp = get_catalog().compilette("attention", att)
    farm = CompileFarm("process", workers=1)
    try:
        t = _wait(farm.submit(comp, next(iter(comp.space.iter_valid())), {}))
    finally:
        farm.shutdown()
    assert t.error is None and t.kern is not None
    assert (farm.stats()["process_offloaded"], farm.stats()["process_fallbacks"]) == (0, 1)


def test_session_with_the_process_backend_offloads_through_its_farm(tmp_path):
    from repro_torch.api import TuningConfig, TuningSession
    from repro_torch.core import VirtualClock, virtual_compilette

    session = TuningSession(TuningConfig(compile_backend="process", compile_workers=1),
                            device="test:v")
    try:
        farm = session.coordinator.generator
        assert farm.mode == "process"
        space = get_catalog().compilette("lintra", LINTRA_CPU).space
        comp = virtual_compilette(VirtualClock(), "lintra", space, lambda p: 1e-3)
        comp.process_payload = lambda point, spec: (
            "repro_torch.kernels.catalog", "compile_in_process",
            {"kernel": "lintra", "point": dict(point), "spec": LINTRA_CPU,
             "triton_cache_dir": str(tmp_path)})
        t = _wait(farm.submit(comp, dict(LINTRA_DEFAULT), {}), timeout_s=300)
        assert t.error is None
        gen = session.stats()["generation"]
        assert (gen["mode"], gen["process_offloaded"]) == ("process", 1)
    finally:
        session.close()


# ------------------------------------------------------- the serve example
def test_serve_example_on_the_cpu_warm_starts_from_its_registry(tmp_path, capsys):
    """Two runs of the reduced serve example with one ``--registry``: the
    second starts every handle the first one persisted from its best, and
    a handle that regenerates evaluates that point first.

    Whether a run tunes at all is the host clock's call (the budget is a
    share of busy time, and the reference measurements at registration
    are charged to it), so the first run gets a budget no clock can
    exhaust and generates in-line: it persists a best on any host. The
    second run keeps the example's own budget, under which the number of
    regenerations is again the clock's; what the warm start guarantees
    does not depend on it: a handle that regenerates at all re-validates
    the persisted point at its first regeneration."""
    import ast
    import re

    example = _load(ROOT / "examples" / "torch_serve_lm.py", "_torch_serve_lm")
    reg = tmp_path / "serve.json"
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "16", "--tokens", "4",
            "--autotune", "--kernel-tuning", "kernel", "--registry", str(reg)]
    first = example.main([*argv, "--requests", "4", "--tune-overhead", "1e9",
                          "--sync-generation"])
    assert len(first) == 4 and reg.exists()
    for out in first:
        assert tuple(out["tokens"].shape) == (2, 4)
    persisted = {json.loads(k)["k"]: v["point"] for k, v in json.loads(reg.read_text()).items()
                 if not k.startswith("__")}
    assert persisted, "the first run persisted no best"
    capsys.readouterr()
    second = example.main([*argv, "--requests", "1"])
    out = capsys.readouterr().out
    kernels = second[0]["autotune"]["kernels"]
    warm = {name: (start, at, unrevalidated) for name, start, at, unrevalidated in re.findall(
        r"warm (\w+): started from (\{.*?\}); (?:re-validated at regeneration (\d+)|"
        r"served as the reference, (\d+) regenerations)", out)}
    for name, point in persisted.items():
        assert kernels[name]["warm_started"], name
        assert f"kernel {name}: " in out and name in warm, (name, out)
        start, at, unrevalidated = warm[name]
        assert ast.literal_eval(start) == point, (name, start, point)
        # a handle that regenerated at all evaluated the persisted point first;
        # only one that never regenerated serves it as the reference
        assert at == "1" or unrevalidated == "0", (name, at, unrevalidated)
    assert "warm-started" in out


def test_serve_cli_reports_each_warm_start(tmp_path, capsys):
    """``python -m repro_torch.launch.serve`` restarted on its registry
    marks each warm handle and prints where it started and whether its
    first regeneration re-validated that point (the line ``chip_smoke.py``
    reads at full width)."""
    import re

    from repro_torch.launch import serve

    argv = ["--arch", "deepseek-7b", "--reduced", "--device", "cpu", "--autotune",
            "--kernel-tuning", "kernel", "--batch", "2", "--prompt-len", "16",
            "--tokens", "4", "--registry", str(tmp_path / "reg.json")]
    # the first run persists a best on any host (see the test above)
    serve.main([*argv, "--requests", "5", "--tune-overhead", "1e9", "--sync-generation"])
    assert "warm " not in capsys.readouterr().out
    serve.main([*argv, "--requests", "1", "--tune-overhead", "0.5"])
    out = capsys.readouterr().out
    warm = re.findall(r"warm (\w+): started from \{.*?\}; (re-validated at regeneration "
                      r"(\d+)|served as the reference)", out)
    assert warm, out
    for name, _what, at in warm:
        assert f"{name}:two_phase" in out and f"{name}:two_phase×" in out
        assert at in ("", "1"), (name, at)
    assert "(warm)" in out


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_serve_example_serves_the_recurrent_families(arch, capsys):
    """The reduced rwkv6 and hymba through the example on the CPU; the
    hymba prompt of 40 runs past its reduced window of 32."""
    example = _load(ROOT / "examples" / "torch_serve_lm.py", "_torch_serve_lm")
    outs = example.main(["--device", "cpu", "--arch", arch, "--tokens", "4",
                         "--batch", "2", "--prompt-len", "40"])
    assert len(outs) == 1 and tuple(outs[0]["tokens"].shape) == (2, 4)
    assert capsys.readouterr().out

