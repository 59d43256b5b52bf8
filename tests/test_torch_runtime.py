"""The port's tuning front door held against the JAX package's.

The same VirtualClock scripts run through both packages' sessions,
coordinators and kernel planes (the catalog's virtual backend prices
every variant by the kernel's cost model, so nothing runs on a device):
``coordinator.stats()`` must be equal — pure arithmetic, so exactly, up
to the source hashes in registry device keys, which name each package's
own ``ops.py``. A registry JSON written by either package must load and
merge in the other.
"""

import importlib
import json

import numpy as np
import pytest

from repro.configs import get_config as jax_config

GEN_COST = 0.002

SPECS = {
    "matmul": {"M": 512, "N": 512, "K": 512, "dtype": "float32"},
    "attention": {"B": 4, "Tq": 512, "Tkv": 512, "H": 8, "Hk": 4,
                  "Dh": 64, "causal": True, "dtype": "float32"},
    "rmsnorm": {"N": 2048, "d": 512, "dtype": "float32"},
}


def mods(pkg):
    return (importlib.import_module(f"{pkg}.core"),
            importlib.import_module(f"{pkg}.runtime.coordinator"),
            importlib.import_module(f"{pkg}.runtime.kernel_plane"),
            importlib.import_module(f"{pkg}.api"))


def comparable(stats):
    """stats() as plain data (the compile farm's ``process`` counters
    included: both packages report them)."""
    return json.loads(json.dumps(stats, sort_keys=True, default=str))


def plane_script(pkg, strategies):
    core, coordm, planem, _ = mods(pkg)
    clock = core.VirtualClock()
    coord = coordm.TuningCoordinator(
        policy=core.RegenerationPolicy(1.0, 0.5), device="test:v", clock=clock,
        async_generation=True, prefetch=1)
    plane = planem.KernelTuningPlane(
        coord, virtual=(clock, core.TPU_V5E), gen_cost_s=GEN_COST,
        evaluator_factory=lambda c: core.VirtualClockEvaluator(clock),
        strategies=strategies)
    handles = {n: plane.register_spec(n, s) for n, s in SPECS.items()}
    for i in range(3000):
        for h in handles.values():
            h(i)
        coord.maybe_pump()
        if all(h.tuner.explorer.finished for h in handles.values()):
            break
    stats = coord.stats()
    best = {n: h.tuner.explorer.best_point for n, h in handles.items()}
    coord.close()
    return comparable(stats), best


@pytest.mark.parametrize("strategies", [
    None, {"matmul": "greedy", "attention": "random"},
    {"rmsnorm": "cost_model", "matmul": "two_phase"}], ids=str)
def test_kernel_plane_stats_equal_under_virtual_clock(strategies):
    jstats, jbest = plane_script("repro", strategies)
    tstats, tbest = plane_script("repro_torch", strategies)
    assert tbest == jbest
    assert tstats == jstats


def session_script(pkg, kernel_tuning):
    core, _, _, api = mods(pkg)
    cfgs = importlib.import_module(f"{pkg}.configs")
    clock = core.VirtualClock()
    cfg = api.TuningConfig(max_overhead=1.0, invest=0.5, pump_every=1,
                           kernel_tuning=kernel_tuning)
    session = api.TuningSession(
        cfg, clock=clock, device="test:v", virtual=(clock, core.TPU_V5E),
        gen_cost_s=GEN_COST,
        evaluator_factory=lambda c: core.VirtualClockEvaluator(clock))
    # deepseek-7b at full width: specs only, no weights
    plane = session.attach_kernels(cfgs.get_config("deepseek-7b"), batch=4,
                                   seq=512, max_len=544)
    names = sorted(m.name for m in plane.handles())
    for step in range(400):
        for h in plane.handles():
            h(step)
        clock.advance(0.001)
        session.pump()
    with session.scope():
        layers = importlib.import_module(f"{pkg}.models.layers")
        chunks = layers.plane_attn_chunks(cfgs.get_config("deepseek-7b"))
    stats = comparable(session.stats())
    session.close()
    return names, chunks, stats


@pytest.mark.parametrize("kernel_tuning", ["kernel", "both"])
def test_session_attach_kernels_stats_equal_at_full_width(kernel_tuning):
    """attach_kernels at deepseek-7b's full-width specs: the same handles
    (decode_attention is untunable there and skipped by both), the same
    adopted attention chunks, the same stats."""
    jnames, jchunks, jstats = session_script("repro", kernel_tuning)
    tnames, tchunks, tstats = session_script("repro_torch", kernel_tuning)
    assert tnames == jnames == ["attention", "matmul", "rmsnorm"]
    assert tchunks == jchunks
    assert tstats == jstats


def tuned_script(pkg):
    core, _, _, api = mods(pkg)
    clock = core.VirtualClock()
    session = api.TuningSession(
        api.TuningConfig(max_overhead=1.0, invest=0.5, pump_every=1),
        clock=clock, device="test:v")
    space = core.product_space([core.Param("unroll", (1, 2, 4, 8), phase=1)])
    kw = {"jit": False} if pkg == "repro" else {}

    @session.tune(space=space, gen_cost_s=GEN_COST, name="k",
                  evaluator=core.VirtualClockEvaluator(
                      clock, score_fn=lambda f: 0.010 / f.point["unroll"]), **kw)
    def k(step, *, unroll):
        clock.advance(0.010 / unroll)
        return step

    for step in range(120):
        k(step)
    stats = comparable(session.stats())
    session.close()
    return k.best_point, stats


def test_tuned_function_stats_equal_under_virtual_clock():
    jbest, jstats = tuned_script("repro")
    tbest, tstats = tuned_script("repro_torch")
    assert tbest == jbest == {"unroll": 8}
    assert tstats == jstats


# ------------------------------------------------------------ registries
def _registry(pkg, device, point, score):
    core = importlib.import_module(f"{pkg}.core")
    reg = core.TunedRegistry()
    reg.put("matmul", {"M": 64, "N": 64, "K": 64}, device, point, score)
    reg.quarantine("matmul", {"M": 64, "N": 64, "K": 64}, device,
                   {"block_m": 512}, f"{pkg} verdict")
    return reg


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_registry_json_loads_and_merges_across_packages(tmp_path, writer, reader):
    path = tmp_path / "tuned.json"
    wreg = _registry(writer, f"{writer}:dev:v1", {"block_m": 64}, 1.0)
    wreg.save(str(path))
    rcore = importlib.import_module(f"{reader}.core")
    loaded = rcore.TunedRegistry.load(str(path))
    spec = {"M": 64, "N": 64, "K": 64}
    assert loaded.get("matmul", spec, f"{writer}:dev:v1") == {"block_m": 64}
    own = _registry(reader, f"{reader}:dev:v1", {"block_m": 128}, 2.0)
    a, b = json.loads(path.read_text()), own.snapshot()
    merged = rcore.merge_snapshots(a, b)
    assert merged == rcore.merge_snapshots(b, a)
    wcore = importlib.import_module(f"{writer}.core")
    assert json.dumps(merged, sort_keys=True) == \
        json.dumps(wcore.merge_snapshots(a, b), sort_keys=True)


def test_registry_keeps_the_other_packages_compiler_entries(tmp_path):
    """Compaction drops entries of another version of the package's own
    compiler, never the other package's."""
    from repro.core import TunedRegistry as JReg
    from repro.core.persistence import compiler_version as jax_compiler
    from repro_torch.core import TunedRegistry as TReg
    from repro_torch.core.persistence import compiler_version

    path = tmp_path / "tuned.json"
    jax_dev = f"cpu:cpu:{jax_compiler()}"
    jreg = JReg()
    jreg.put("rmsnorm", {"N": 8, "d": 8}, jax_dev, {"block_rows": 8}, 1.0)
    jreg.save(str(path))
    treg = TReg.load(str(path))
    treg.put("rmsnorm", {"N": 8, "d": 8}, "cuda:H100:torch0.0-cuda0.0",
             {"block_rows": 8}, 1.0)
    treg.put("rmsnorm", {"N": 8, "d": 8}, f"cuda:H100:{compiler_version()}",
             {"block_rows": 32}, 1.0)
    treg.save(str(path))
    again = TReg.load(str(path))
    assert again.get("rmsnorm", {"N": 8, "d": 8}, jax_dev) == {"block_rows": 8}
    assert again.get("rmsnorm", {"N": 8, "d": 8}, f"cuda:H100:{compiler_version()}") \
        == {"block_rows": 32}
    assert again.get("rmsnorm", {"N": 8, "d": 8}, "cuda:H100:torch0.0-cuda0.0") is None


def test_device_fingerprint_names_the_card_and_the_compilers():
    import torch

    from repro_torch.core.persistence import compiler_version, device_fingerprint

    assert compiler_version() == \
        f"torch{torch.__version__}-cuda{torch.version.cuda or 'none'}"
    assert device_fingerprint("cpu") == f"cpu:cpu:{compiler_version()}"
    from repro_torch.core.transfer import traits_from_fingerprint
    assert traits_from_fingerprint("cuda:NVIDIA H100 80GB HBM3:x") is not None


# --------------------------------------------------------------- config
ENV = {"REPRO_TUNE_STRATEGY": "greedy", "REPRO_TUNE_MAX_OVERHEAD": "0.02",
       "REPRO_TUNE_KERNEL_TUNING": "kernel", "REPRO_TUNE_COMPILE_WORKERS": "2",
       "REPRO_TUNE_GATE": "check"}


def test_config_from_env_identical():
    from repro.api import TuningConfig as J
    from repro_torch.api import TuningConfig as T
    import dataclasses
    assert dataclasses.asdict(T.from_env(ENV)) == dataclasses.asdict(J.from_env(ENV))
    assert dataclasses.asdict(T()) == dataclasses.asdict(J())
    for cls in (J, T):
        with pytest.raises(ValueError):
            cls.from_env({"REPRO_TUNE_NOT_A_KNOB": "1"})


def test_process_backend_is_refused_and_auto_never_picks_it():
    """``compile_backend="process"`` builds a session whose farm runs in
    process mode (the raise of the unported backend is gone); ``auto``
    still picks threads on a real clock and manual batches on a virtual
    one, never processes."""
    from repro_torch.api import TuningConfig, TuningSession
    from repro_torch.core import VirtualClock

    session = TuningSession(TuningConfig(compile_backend="process"), device="test:v")
    gen = session.stats()["generation"]
    assert (gen["mode"], gen["process_offloaded"], gen["process_fallbacks"]) == \
        ("process", 0, 0)
    session.close()
    session = TuningSession(TuningConfig(compile_backend="auto"), device="test:v")
    assert session.stats()["generation"]["mode"] == "thread"
    session.close()
    session = TuningSession(TuningConfig(), clock=VirtualClock(), device="test:v")
    assert session.stats()["generation"]["mode"] == "manual"
    session.close()


def test_session_replay_waits_for_its_port():
    """``session.replay`` delegates to the ported harness: a one-tenant
    trace re-served on a virtual clock reports what the reference's
    session reports, and a session on the wall clock is refused."""
    from repro_torch.api import TuningConfig, TuningSession
    from repro_torch.configs import get_config
    from repro_torch.core import VirtualClock

    def run(rp, cfg):
        sc = rp.Scenario(name="tiny", arrival=rp.poisson_arrivals,
                         prompt_mix=rp.fixed_mix(64), decode_mix=rp.fixed_mix(2),
                         utilization=0.4, target_requests=24)
        trace = rp.make_trace(sc, cfg.name, 50.0, seed=3)
        clock = (VirtualClock() if rp is treplay
                 else importlib.import_module("repro.core").VirtualClock())
        session = rp.replay_session(clock)
        try:
            return comparable(session.replay(trace, {cfg.name: cfg}))
        finally:
            session.close()

    jreplay = importlib.import_module("repro.bench.replay")
    treplay = importlib.import_module("repro_torch.bench.replay")
    jcfg = jax_config("deepseek-7b").reduced()
    assert run(treplay, get_config("deepseek-7b").reduced()) == run(jreplay, jcfg)
    session = TuningSession(TuningConfig(), device="test:v")
    with pytest.raises(TypeError, match="VirtualClock"):
        session.replay(trace=None)
    session.close()


@pytest.mark.parametrize("n", [1, 2, 3, 120, 150, 181, 182, 544, 4096, 5000])
def test_lifecycle_buckets_equal(n):
    from repro.runtime.lifecycle import pow2_bucket as jb
    from repro_torch.runtime.lifecycle import pow2_bucket as tb
    assert tb(n) == jb(n)


def test_transfer_similarity_equal():
    from repro.core import ALL_PROFILES as JP, DeviceTraits as JT, similarity as jsim
    from repro_torch.core import ALL_PROFILES as TP, DeviceTraits as TT, similarity as tsim
    for a, b in zip(JP, TP):
        for c, d in zip(JP, TP):
            assert tsim(TT.from_profile(b), TT.from_profile(d)) == \
                jsim(JT.from_profile(a), JT.from_profile(c))


def test_model_kernel_specs_equal():
    from repro.models.model import model_kernel_specs as jspecs
    from repro_torch.configs import get_config
    from repro_torch.models.model import model_kernel_specs as tspecs

    for name in ("deepseek-7b", "qwen3-moe-30b-a3b"):
        for reduced in (False, True):
            jc, tc = jax_config(name), get_config(name)
            if reduced:
                jc, tc = jc.reduced(), tc.reduced()
            kw = dict(batch=4, seq=512, max_len=544)
            assert tspecs(tc, **kw) == jspecs(jc, **kw)


def test_configs_equal_but_for_dtypes():
    import dataclasses

    import torch

    from repro_torch.configs import REGISTRY
    from repro.configs import REGISTRY as JREG
    assert sorted(REGISTRY) == sorted(JREG)
    for name, cfg in REGISTRY.items():
        for red in (False, True):
            t = cfg.reduced() if red else cfg
            j = JREG[name].reduced() if red else JREG[name]
            td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
            for key in ("param_dtype", "compute_dtype"):
                assert td.pop(key) == torch.float32
                assert np.dtype(jd.pop(key)) == np.float32
            assert td == jd
            assert t.n_params() == j.n_params()
