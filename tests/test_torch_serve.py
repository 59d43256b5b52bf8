"""The port's LM serving slice held against the JAX package's, on the CPU.

A reduced deepseek-7b (GQA: 4 heads over 2 kv heads) is initialised
once in JAX and carried over with ``params_from_jax``; prompts are made
with numpy from a seed. Prefill logits agree within rtol 1e-4, atol
1e-4 (fp32 everywhere, other summation orders), and greedy decoding
gives the same tokens. On the CPU every kernel call takes its plain
PyTorch version; the hand kernels are held against those on the card by
``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.models.params import count_params as jax_count
from repro.models.params import init_tree as jax_init
from repro.runtime.serve_loop import ServeConfig as JServeConfig
from repro.runtime.serve_loop import generate as jax_generate

from repro_torch.api import serve_tuning_defaults
from repro_torch.configs import REGISTRY, get_config
from repro_torch.interop import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.models.params import count_params, init_tree
from repro_torch.runtime.serve_loop import ServeConfig, generate

LOGIT_TOL = {"rtol": 1e-4, "atol": 1e-4}
B, T = 2, 40


def tuned_serve_config(kernel_tuning: str) -> ServeConfig:
    """The port's counterpart of the reference's ``ServeConfig(
    max_new_tokens=6, autotune=True, kernel_tuning=...)`` (the port keeps
    no flat tuning aliases on ``ServeConfig``)."""
    return ServeConfig(max_new_tokens=6, tuning=dataclasses.replace(
        serve_tuning_defaults(), enabled=True, kernel_tuning=kernel_tuning))


@pytest.fixture(scope="module")
def reduced():
    jcfg = jax_config("deepseek-7b").reduced()
    tcfg = get_config("deepseek-7b").reduced()
    jparams = jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))
    nparams = jax.tree.map(np.asarray, jparams)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    return jcfg, tcfg, jparams, nparams, tokens


def test_reduced_config_is_gqa(reduced):
    _, tcfg, *_ = reduced
    assert tcfg.n_heads == 4 and tcfg.n_kv_heads == 2


def test_prefill_logits_and_caches_match_jax(reduced):
    jcfg, tcfg, jparams, nparams, tokens = reduced
    jl, (jk, jv) = jax.jit(jax_build(jcfg).prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tl, (tk, tv) = build_model(tcfg).prefill(
        params_from_jax(nparams, tcfg, "cpu"), {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **LOGIT_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **LOGIT_TOL)


def test_greedy_decode_matches_jax_over_8_steps(reduced):
    jcfg, tcfg, jparams, nparams, tokens = reduced
    steps, max_len = 8, T + 8
    jm, tm = jax_build(jcfg), build_model(tcfg)
    tparams = params_from_jax(nparams, tcfg, "cpu")
    jl, jcache = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    jcache = tuple(jnp.pad(c, ((0, 0), (0, 0), (0, max_len - T), (0, 0), (0, 0)))
                   for c in jcache)
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    full = tm.init_cache(B, max_len)
    for f, c in zip(full, tcache):
        f[:, :, :T] = c
    tcache = full
    jdec = jax.jit(jm.decode_step)
    jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
    for i in range(steps):
        assert np.array_equal(tt.numpy(), np.asarray(jt)), i
        jl, jcache = jdec(jparams, jcache, jt, jnp.int32(T + i))
        tl, tcache = tm.decode_step(tparams, tcache, tt, T + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], dim=-1)[:, None]


@pytest.mark.parametrize("kernel_tuning", ["kernel", "program"])
def test_generate_with_tuning_gives_the_jax_tokens(reduced, kernel_tuning):
    jcfg, tcfg, jparams, nparams, tokens = reduced
    jout = jax_generate(jcfg, {"tokens": jnp.asarray(tokens), "params": jparams},
                        JServeConfig(max_new_tokens=6, autotune=True,
                                     kernel_tuning=kernel_tuning))
    tout = generate(tcfg, {"tokens": torch.from_numpy(tokens),
                           "params": params_from_jax(nparams, tcfg, "cpu")},
                    tuned_serve_config(kernel_tuning))
    assert np.array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    assert tout["kernel_tuning"] == kernel_tuning
    assert set(tout["autotune"]["kernels"]) == set(jout["autotune"]["kernels"])


def test_no_step_program_call_reaches_a_managed_tuner(reduced, monkeypatch):
    """Kernel-granular serving: the plane's handles tune from their own
    evaluations; prefill and decode_step never call one (the reference's
    jitted step-programs cannot)."""
    from repro_torch.runtime import coordinator
    from repro_torch.runtime.kernel_plane import in_step_program

    _, tcfg, _, nparams, tokens = reduced
    inside, outside = [], []
    real_call = coordinator.ManagedTuner.__call__

    def spy(self, *args):
        (inside if in_step_program() else outside).append(self.name)
        return real_call(self, *args)

    monkeypatch.setattr(coordinator.ManagedTuner, "__call__", spy)
    out = generate(tcfg, {"tokens": torch.from_numpy(tokens),
                          "params": params_from_jax(nparams, tcfg, "cpu")},
                   tuned_serve_config("kernel"))
    assert inside == []
    assert out["autotune"]["n_kernels"] >= 2


def test_eager_layer_calls_route_through_the_plane_outside_step_programs():
    from repro_torch.api import TuningConfig, TuningSession
    from repro_torch.models import layers
    from repro_torch.runtime.kernel_plane import step_program

    session = TuningSession(TuningConfig(), device="test:cpu")
    session.attach_kernels(get_config("deepseek-7b").reduced(), batch=2, seq=16,
                           device="cpu")
    x = torch.randn(2, 16, 64)
    w = torch.randn(64)
    with session.scope():
        with step_program():
            layers.rms_norm(x, w)
        assert session.plane.handles("rmsnorm")[0].tuner.accounts.kernel_calls == 0
        y = layers.rms_norm(x, w)
    calls = sum(h.tuner.accounts.kernel_calls for h in session.plane.handles("rmsnorm"))
    assert calls == 1
    torch.testing.assert_close(y, layers.rmsnorm_ref(x, w))
    session.close()


def test_init_tree_is_seeded_and_counts_like_the_reference():
    tcfg = get_config("deepseek-7b").reduced()
    defs = build_model(tcfg).param_defs()
    a = init_tree(defs, torch.Generator().manual_seed(3))
    b = init_tree(defs, torch.Generator().manual_seed(3))
    assert torch.equal(a["tok"]["embed"], b["tok"]["embed"])
    assert torch.equal(a["layers"]["ln1"], torch.ones(2, 64))
    from repro.models.params import count_params as jcount
    assert count_params(defs) == jcount(jax_build(jax_config("deepseek-7b").reduced())
                                        .param_defs())


def test_params_from_jax_checks_the_tree(reduced):
    _, tcfg, _, nparams, _ = reduced
    bad = jax.tree.map(lambda a: a, nparams)
    bad["ln_f"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="ln_f"):
        params_from_jax(bad, tcfg, "cpu")
    extra = dict(nparams, bogus=np.ones(1, np.float32))
    with pytest.raises(ValueError, match="bogus"):
        params_from_jax(extra, tcfg, "cpu")


def test_build_model_refuses_an_unknown_family():
    with pytest.raises(ValueError, match="unknown model family 'ssm'"):
        build_model(dataclasses.replace(get_config("deepseek-7b"), family="ssm"))


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_build_model_builds_every_config(arch):
    """Every config of ``repro_torch.configs`` builds, at full width and
    reduced, and declares the reference's parameter count."""
    for cfg in (get_config(arch), get_config(arch).reduced()):
        model = build_model(cfg)
        assert count_params(model.param_defs()) > 0
    assert count_params(build_model(get_config(arch)).param_defs()) == \
        jax_count(jax_build(jax_config(arch)).param_defs())


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
                "--autotune", "--kernel-tuning", "kernel", "--batch", "2",
                "--prompt-len", "16", "--tokens", "4", "--requests", "2"])
    out = capsys.readouterr().out
    assert out.count("req ") == 2 and "kernels:" in out


def test_launch_serve_without_a_device_needs_the_card(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "deepseek-7b", "--reduced", "--tokens", "2"])
