"""The port's hybrid (hymba-1.5b) and RWKV (rwkv6-1.6b) families held
against the JAX package's, on the CPU.

Reduced configs: 2 layers, d_model 64; hymba with 4 heads of 16 over 2
kv heads, a window of 32 and an SSM state of 8; rwkv6 with heads of 16;
``scan_chunk`` 16 for both. Params are initialised once in JAX and
carried over with ``params_from_jax``; inputs are made with numpy from a
seed. Tolerances, all fp32 with sums in other orders:

* logits, caches, states, layer outputs, losses: rtol 1e-4, atol 1e-4
  (as the other families' in ``test_torch_families.py``);
* the scans (``ssm_scan_chunked``, ``wkv_chunked``) and the conv: rtol
  1e-5, atol 1e-5 (the port's doubling scan multiplies in another tree
  than ``jax.lax.associative_scan``, a few roundings apart);
* gradients of every leaf: rtol 1e-4, atol 1e-5 of the leaf's largest
  gradient (as ``test_torch_train.py``) for hymba; for rwkv6, atol 1e-4
  of it. rwkv6's chunked form multiplies factors of up to e^{±16} within
  a chunk of 16, and the reference's fp32 gradients sit up to 5.8e-5 of
  the leaf's largest from the same model run in fp64 (the port's 6.6e-6;
  hymba's both 2.2e-6). So the port is also held to its own fp64 run at
  atol 1e-5 of the leaf's largest gradient, which the reference's fp32
  gradients would not pass.

On the CPU every kernel call takes its plain PyTorch version; the hand
kernels are held against those on the card by ``chip_smoke.py``. Two
behaviours of the reference are kept and pinned here (ROADMAP Queue 3):
R3, hymba's decode past its window writes every token at the cache's
last slot; R4, ``wkv_chunked``'s ±30 clamps bind inside a chunk of 128
at decays of e^-1 a token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import rwkv6 as jrwkv
from repro.models import ssm as jssm
from repro.models.model import build_model as jax_build
from repro.models.model import model_kernel_specs as jax_specs
from repro.models.params import count_params as jax_count
from repro.models.params import init_tree as jax_init
from repro.runtime.serve_loop import ServeConfig as JServeConfig
from repro.runtime.serve_loop import generate as jax_generate

from repro_torch.api import serve_tuning_defaults
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import rwkv6, ssm
from repro_torch.models.model import build_model, model_kernel_specs
from repro_torch.models.params import count_params, init_tree
from repro_torch.runtime.serve_loop import ServeConfig, generate, widen_cache

TOL = {"rtol": 1e-4, "atol": 1e-4}
SCAN_TOL = {"rtol": 1e-5, "atol": 1e-5}
ARCHS = ["hymba-1.5b", "rwkv6-1.6b"]
B, T = 2, 24


def cfgs(arch: str, **overrides):
    return (jax_config(arch).reduced(**overrides), get_config(arch).reduced(**overrides))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def tree_t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def make_inputs(cfg, seed: int = 0, T_: int = T) -> dict:
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B, T_)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def layer0(nparams, key: str) -> dict:
    return jax.tree.map(lambda a: a[0], nparams["layers"])[key]


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    jcfg, tcfg = cfgs(request.param)
    jparams = jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, to_np(jparams), make_inputs(jcfg)


def rng_f32(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------- SSM
@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_jax(with_prev):
    x, w = rng_f32(1, B, 9, 16), rng_f32(2, 4, 16)
    prev = rng_f32(3, B, 3, 16) if with_prev else None
    jout, jprev = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    None if prev is None else jnp.asarray(prev))
    tout, tprev = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                   None if prev is None else torch.from_numpy(prev))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **SCAN_TOL)
    np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev), **SCAN_TOL)


@pytest.mark.parametrize("chunk", [4, 12, 24, 7])
def test_ssm_scan_chunked_matches_jax(chunk):
    """T 24 in chunks of 4, 12, 24 and 7 (ragged: identity padding).
    Decays in (0.37, 1) as hymba's exp(dt A) gives them."""
    a = np.exp(-np.random.default_rng(4).uniform(0.0, 1.0, (B, T, 8, 4))).astype(np.float32)
    b, h0 = rng_f32(5, B, T, 8, 4), rng_f32(6, B, 8, 4)
    jall, jlast = jssm.ssm_scan_chunked(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), chunk)
    tall, tlast = ssm.ssm_scan_chunked(torch.from_numpy(a), torch.from_numpy(b),
                                       torch.from_numpy(h0), chunk)
    np.testing.assert_allclose(tall.numpy(), np.asarray(jall), **SCAN_TOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **SCAN_TOL)


def test_ssm_scan_is_the_sequential_recurrence():
    a = np.exp(-np.random.default_rng(7).uniform(0.0, 2.0, (1, 37, 3, 2))).astype(np.float32)
    b, h = rng_f32(8, 1, 37, 3, 2), rng_f32(9, 1, 3, 2)
    tall, tlast = ssm.ssm_scan_chunked(torch.from_numpy(a), torch.from_numpy(b),
                                       torch.from_numpy(h), 16)
    want = []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(tall.numpy(), np.stack(want, 1), **SCAN_TOL)
    np.testing.assert_allclose(tlast.numpy(), h, **SCAN_TOL)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_ssm_branch_matches_jax(mode):
    """The output and the (conv buffer, h) state: a prefill from zero
    state, or one decode step from a carried state."""
    jcfg, tcfg = cfgs("hymba-1.5b")
    p = layer0(to_np(jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))), "ssm")
    d, st = jcfg.d_model, jcfg.ssm_state
    if mode == "prefill":
        x, state = rng_f32(10, B, T, d), None
    else:
        x = rng_f32(11, B, 1, d)
        state = (rng_f32(12, B, jcfg.ssm_conv - 1, d), rng_f32(13, B, d, st))
    jy, (jconv, jh) = jssm.ssm_branch(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    ty, (tconv, th) = ssm.ssm_branch(
        torch.from_numpy(x), tree_t(p), tcfg,
        state=None if state is None else tuple(map(torch.from_numpy, state)))
    for got, want in ((ty, jy), (tconv, jconv), (th, jh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------- RWKV
@pytest.mark.parametrize("T_,with_prev", [(5, False), (5, True), (1, True)])
def test_token_shift_and_ddlerp_match_jax(T_, with_prev):
    jcfg, tcfg = cfgs("rwkv6-1.6b")
    p = layer0(to_np(jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))), "tm")
    p = dict(p, mu=rng_f32(14, 5, jcfg.d_model, scale=0.3),
             mu_x=rng_f32(15, jcfg.d_model, scale=0.3))
    x = rng_f32(16, B, T_, jcfg.d_model)
    prev = rng_f32(17, B, jcfg.d_model) if with_prev else None
    jshift = jrwkv._token_shift(jnp.asarray(x), None if prev is None else jnp.asarray(prev))
    tshift = rwkv6._token_shift(torch.from_numpy(x),
                                None if prev is None else torch.from_numpy(prev))
    np.testing.assert_array_equal(tshift.numpy(), np.asarray(jshift))
    xx = np.asarray(jshift) - x
    jmix = jrwkv._ddlerp(jnp.asarray(x), jnp.asarray(xx), jax.tree.map(jnp.asarray, p))
    tmix = rwkv6._ddlerp(torch.from_numpy(x), torch.from_numpy(xx), tree_t(p))
    for got, want in zip(tmix, jmix):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _wkv_inputs(seed, T_, H, C, logw=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((1 if logw is not None else B, T_, H, C))
               .astype(np.float32) for _ in range(3))
    if logw is None:
        lw = -np.exp(rng.uniform(-3.0, 0.5, r.shape)).astype(np.float32)
    else:
        lw = np.full(r.shape, logw, np.float32)
    u = (rng.standard_normal((H, C)) * 0.5).astype(np.float32)
    S0 = (rng.standard_normal((r.shape[0], H, C, C)) * 0.1).astype(np.float32)
    return r, k, v, lw, u, S0


def _wkv_both(args, chunk):
    jy, jS = jrwkv.wkv_chunked(*map(jnp.asarray, args), chunk)
    ty, tS = rwkv6.wkv_chunked(*map(torch.from_numpy, args), chunk)
    return (ty.numpy(), tS.numpy()), (np.asarray(jy), np.asarray(jS))


@pytest.mark.parametrize("chunk", [4, 8, 24, 7])
def test_wkv_chunked_matches_jax(chunk):
    (ty, tS), (jy, jS) = _wkv_both(_wkv_inputs(18, T, 2, 8), chunk)
    np.testing.assert_allclose(ty, jy, **SCAN_TOL)
    np.testing.assert_allclose(tS, jS, **SCAN_TOL)


def _wkv_sequential(r, k, v, lw, u, S):
    """The exact recurrence of the module docstring, token by token."""
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], np.exp(lw[:, t])
        kv = kt[..., :, None] * vt[..., None, :]                  # (B, H, C, C)
        ys.append(np.einsum("bhc,bhcd->bhd", rt, S + u[None, ..., None] * kv))
        S = wt[..., None] * S + kv
    return np.stack(ys, 1), S


def test_wkv_chunked_keeps_the_references_clamp_at_chunk_128():
    """R4 (ROADMAP Queue 3): at chunk 128, T 256 and logw = -1 a token,
    the ±30 clamps bind for a query and a key far apart in one chunk, so
    the reference's chunked WKV departs from the exact recurrence (by
    101 against outputs up to 21). The port equals the reference
    there too; at chunk 16 both agree with the recurrence."""
    args = _wkv_inputs(19, 256, 2, 8, logw=-1.0)
    (ty, tS), (jy, jS) = _wkv_both(args, 128)
    np.testing.assert_allclose(ty, jy, **SCAN_TOL)
    np.testing.assert_allclose(tS, jS, **SCAN_TOL)
    exact_y, _ = _wkv_sequential(*args)
    assert np.abs(ty - exact_y).max() > 1.0            # the clamp binds
    (ty16, _), _ = _wkv_both(args, 16)
    np.testing.assert_allclose(ty16, exact_y, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [128, 16])
def test_rwkv6_prefill_and_decode_part_where_the_clamp_binds(chunk):
    """R4 at the model level (reduced rwkv6, whose random init gives log
    decays of about -1 a token): decode(prefill(100), token 100) against
    prefill(101)'s last logits. Token 100 sits 100 deep in a chunk of
    128, where the clamps bind, so the two part by about the logits'
    own size (2.7 against 2.9 here), in JAX as in the port; 4 deep in a
    chunk of 16 they agree. prefill(101) equals the reference's either
    way."""
    jcfg, tcfg = cfgs("rwkv6-1.6b", scan_chunk=chunk)
    jparams = jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))
    tparams = params_from_jax(to_np(jparams), tcfg, "cpu")
    tm = build_model(tcfg)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (B, 101)).astype(np.int32)
    with torch.no_grad():
        _, state = tm.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :100])})
        decoded, _ = tm.decode_step(tparams, state, torch.from_numpy(toks[:, 100:]), 100)
        full, _ = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    jfull, _ = jax.jit(jax_build(jcfg).prefill)(jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), **TOL)
    gap = float((decoded[:, -1] - full[:, -1]).abs().max())
    if chunk == 128:
        assert gap > 0.1 * float(full.abs().max()), gap
    else:
        assert gap < TOL["atol"], gap


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_and_channel_mix_match_jax(with_state):
    jcfg, tcfg = cfgs("rwkv6-1.6b")
    nparams = to_np(jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0)))
    tm, cm = layer0(nparams, "tm"), layer0(nparams, "cm")
    tm = dict(tm, u=rng_f32(20, *tm["u"].shape, scale=0.5),
              w_base=rng_f32(21, jcfg.d_model, scale=0.5))
    cm = dict(cm, mu_k=rng_f32(22, jcfg.d_model, scale=0.3))
    d, C = jcfg.d_model, jcfg.rwkv_head_size
    if with_state:
        x = rng_f32(23, B, 1, d)
        S0, xa, xc = rng_f32(24, B, d // C, C, C, scale=0.1), rng_f32(25, B, d), \
            rng_f32(26, B, d)
    else:
        x, S0, xa, xc = rng_f32(27, B, T, d), None, None, None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    jout, jS, jlast = jrwkv.time_mix(j(x), jax.tree.map(jnp.asarray, tm), jcfg,
                                     S0=j(S0), x_prev=j(xa))
    tout, tS, tlast = rwkv6.time_mix(t(x), tree_t(tm), tcfg, S0=t(S0), x_prev=t(xa))
    for got, want in ((tout, jout), (tS, jS), (tlast, jlast)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jc, jlc = jrwkv.channel_mix(j(x), jax.tree.map(jnp.asarray, cm), jcfg, x_prev=j(xc))
    tc, tlc = rwkv6.channel_mix(t(x), tree_t(cm), tcfg, x_prev=t(xc))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_array_equal(tlc.numpy(), np.asarray(jlc))


# ------------------------------------------------------------ whole models
def test_prefill_logits_and_caches_match_jax(family):
    jcfg, tcfg, jparams, nparams, batch = family
    jl, jcache = jax.jit(jax_build(jcfg).prefill)(jparams, jbatch(batch))
    tl, tcache = build_model(tcfg).prefill(params_from_jax(nparams, tcfg, "cpu"),
                                           tbatch(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert len(tcache) == len(jcache) == (4 if tcfg.family == "hybrid" else 3)
    for t, j in zip(tcache, jcache):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _widen_jax(model, cache, max_len):
    return tuple(jnp.pad(c, [(0, w - g) for g, w in zip(c.shape, want.shape)])
                 for c, want in zip(cache, model.init_cache_shape(B, max_len)))


def _greedy_both(jcfg, tcfg, jparams, nparams, batch, steps, max_len):
    """Prefill ``batch`` in both packages, then ``steps`` greedy decode
    steps; asserts equal tokens and logits within TOL at every step.
    Returns the caches before the first decode step and after the last."""
    jm, tm = jax_build(jcfg), build_model(tcfg)
    tparams = params_from_jax(nparams, tcfg, "cpu")
    T_ = batch["tokens"].shape[1]
    jl, jcache = jax.jit(jm.prefill)(jparams, jbatch(batch))
    jcache = _widen_jax(jm, jcache, max_len)
    tl, tcache = tm.prefill(tparams, tbatch(batch))
    tcache = widen_cache(tm, tcache, B, max_len)
    first = tuple(c.clone() for c in tcache)
    jdec = jax.jit(jm.decode_step)
    jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
    for i in range(steps):
        assert np.array_equal(tt.numpy(), np.asarray(jt)), i
        jl, jcache = jdec(jparams, jcache, jt, jnp.int32(T_ + i))
        tl, tcache = tm.decode_step(tparams, tcache, tt, T_ + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for t, j in zip(tcache, jcache):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
    return first, tcache


def test_greedy_decode_and_caches_match_jax_over_8_steps(family):
    jcfg, tcfg, jparams, nparams, batch = family
    _greedy_both(jcfg, tcfg, jparams, nparams, batch, 8, T + 8)


def test_hymba_past_its_window_matches_jax():
    """R3 (ROADMAP Queue 3): a prompt of 40 over a window of 32 keeps the
    tail 32 slots of the prefill cache; every decode step past the
    window then writes slot 31 (the reference's dynamic_update_slice
    clamps its start), so only slot 31 of the KV cache changes."""
    jcfg, tcfg = cfgs("hymba-1.5b")
    assert tcfg.window == 32
    jparams = jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))
    batch = make_inputs(jcfg, seed=3, T_=40)
    first, last = _greedy_both(jcfg, tcfg, jparams, to_np(jparams), batch, 4, 40 + 4)
    assert first[0].shape[2] == last[0].shape[2] == 32
    for before, after in zip(first[:2], last[:2]):
        changed = (before != after).any(dim=(0, 1, 3, 4))
        assert changed.nonzero().flatten().tolist() == [31]


@pytest.mark.parametrize("arch,T_", [("hymba-1.5b", 12), ("hymba-1.5b", 40),
                                     ("rwkv6-1.6b", 12)])
def test_widen_cache_pads_positional_caches_and_keeps_the_rest(arch, T_):
    """The serve loop's widening: a KV cache shorter than its decode shape
    goes into zeros at its head; a tensor already at its shape (every
    recurrent state, hymba's cache cut to its window) is the same
    tensor."""
    _, tcfg = cfgs(arch)
    model = build_model(tcfg)
    params = init_tree(model.param_defs(), torch.Generator().manual_seed(0))
    tokens = torch.randint(0, tcfg.vocab, (B, T_), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": tokens})
    widened = widen_cache(model, cache, B, T_ + 4)
    for got, c, want in zip(widened, cache, model.init_cache_shape(B, T_ + 4)):
        assert tuple(got.shape) == tuple(want) and got.dtype == c.dtype
        if c.shape == got.shape:
            assert got is c
        else:
            head = tuple(slice(0, n) for n in c.shape)
            assert torch.equal(got[head], c)
            rest = got.clone()
            rest[head] = 0
            assert not rest.any()
    kv_padded = [c.shape != g.shape for c, g in zip(cache, widened)]
    assert kv_padded == ([True, True, False, False] if arch == "hymba-1.5b" and T_ < 32
                         else [False] * len(cache))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


#: the gradients' atol against the reference's, a share of the leaf's
#: largest gradient (see the module docstring)
GRAD_ATOL_SHARE = {"hybrid": 1e-5, "rwkv": 1e-4}


def _loss_and_grads(tcfg, nparams, batch, dtype=torch.float32):
    cfg = dataclasses.replace(tcfg, compute_dtype=dtype, param_dtype=dtype)
    tparams = params_from_jax(nparams, cfg, "cpu")
    paths, leaves = zip(*_leaves(tparams))
    for leaf in leaves:
        leaf.requires_grad_()
    loss = build_model(cfg).loss(tparams, tbatch(batch))
    return float(loss), dict(zip(paths, torch.autograd.grad(loss, leaves)))


def _assert_grads_close(grads, want_of, share):
    for path, g in grads.items():
        want = np.asarray(want_of(path), dtype=np.float64)
        scale = float(np.abs(want).max())
        assert scale > 0, path
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=share * scale,
                                   err_msg="/".join(path))


def test_loss_and_every_gradient_match_jax(family):
    jcfg, tcfg, jparams, nparams, _ = family
    batch = make_inputs(jcfg, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_build(jcfg).loss))(jparams, jbatch(batch))
    tloss, grads = _loss_and_grads(tcfg, nparams, batch)
    np.testing.assert_allclose(tloss, float(jloss), **TOL)
    _assert_grads_close(grads, lambda p: _get(jgrads, p), GRAD_ATOL_SHARE[tcfg.family])


def test_every_gradient_matches_the_same_model_in_fp64(family):
    _, tcfg, _, nparams, batch = family
    _, grads = _loss_and_grads(tcfg, nparams, make_inputs(tcfg, seed=1))
    _, exact = _loss_and_grads(tcfg, nparams, make_inputs(tcfg, seed=1), torch.float64)
    _assert_grads_close(grads, lambda p: exact[p].numpy(), 1e-5)


# ---------------------------------------- ported reference tests (test_models)
def _ref_batch(tcfg, seed=1, T_=32):
    batch = tbatch(make_inputs(tcfg, seed=seed, T_=T_))
    batch["labels"] = batch["tokens"]
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke_loss_and_grads(arch):
    """Port of ``tests/test_models.py::test_arch_smoke_loss_and_grads``."""
    tcfg = get_config(arch).reduced()
    model = build_model(tcfg)
    params = init_tree(model.param_defs(), torch.Generator().manual_seed(0))
    leaves = [v.requires_grad_() for _, v in _leaves(params)]
    loss = model.loss(params, _ref_batch(tcfg))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert loss.shape == () and torch.isfinite(loss)
    assert all(g is None or torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_prefill_decode_consistency(arch):
    """Port of ``tests/test_models.py::test_arch_prefill_decode_consistency``:
    decode(prefill(T), token_T) == prefill(T+1) last logits."""
    tcfg = get_config(arch).reduced()
    model = build_model(tcfg)
    params = init_tree(model.param_defs(), torch.Generator().manual_seed(0))
    T_ = 16
    full_batch = _ref_batch(tcfg, seed=4, T_=T_ + 1)
    prompt = dict(full_batch, tokens=full_batch["tokens"][:, :T_])
    with torch.no_grad():
        logits_p, cache = model.prefill(params, prompt)
        assert torch.isfinite(logits_p).all()
        full = widen_cache(model, cache, B, 64)
        logits_d, _ = model.decode_step(params, full, full_batch["tokens"][:, T_:T_ + 1], T_)
        logits_p2, _ = model.prefill(params, full_batch)
    np.testing.assert_allclose(logits_p2.numpy(), logits_d.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch,chunks", [("rwkv6-1.6b", (4, 8, 24, 7)),
                                         ("hymba-1.5b", (4, 12, 24))])
def test_chunk_invariance(arch, chunks):
    """Port of ``tests/test_models.py::test_rwkv_chunk_invariance`` and
    ``test_hymba_ssm_chunk_invariance``: the loss does not depend on
    ``scan_chunk``."""
    tcfg = get_config(arch).reduced()
    batch = _ref_batch(tcfg, seed=1, T_=24)
    params = init_tree(build_model(tcfg).param_defs(), torch.Generator().manual_seed(0))
    with torch.no_grad():
        losses = [float(build_model(dataclasses.replace(tcfg, scan_chunk=c)).loss(params, batch))
                  for c in chunks]
    for loss in losses[1:]:
        assert abs(loss - losses[0]) < 1e-4, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_are_the_references(arch):
    """Port of ``tests/test_models.py::test_param_counts_match_analytic``
    for the two families: the exact count equals the reference's (full
    width and reduced) and stays within 5 % of the analytic count."""
    for jcfg, tcfg in ((jax_config(arch), get_config(arch)), cfgs(arch)):
        exact = count_params(build_model(tcfg).param_defs())
        assert exact == jax_count(jax_build(jcfg).param_defs())
    full = get_config(arch)
    exact = count_params(build_model(full).param_defs())
    assert abs(exact - full.n_params()) / exact < 0.05


# ------------------------------------------------------- serving and specs
@pytest.mark.parametrize("kernel_tuning", ["kernel", "program"])
def test_generate_with_tuning_gives_the_jax_tokens(family, kernel_tuning):
    jcfg, tcfg, jparams, nparams, batch = family
    batch = {"tokens": batch["tokens"]}
    jout = jax_generate(jcfg, {**jbatch(batch), "params": jparams},
                        JServeConfig(max_new_tokens=4, autotune=True,
                                     kernel_tuning=kernel_tuning))
    tout = generate(tcfg, {**tbatch(batch), "params": params_from_jax(nparams, tcfg, "cpu")},
                    ServeConfig(max_new_tokens=4, tuning=dataclasses.replace(
                        serve_tuning_defaults(), enabled=True,
                        kernel_tuning=kernel_tuning)))
    assert np.array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    assert set(tout["autotune"]["kernels"]) == set(jout["autotune"]["kernels"])


def test_generate_past_hymbas_window_gives_the_jax_tokens():
    """A prompt of 24 and 16 new tokens over a window of 32: the serve
    loop widens the prefill cache to the window and decode crosses it."""
    jcfg, tcfg = cfgs("hymba-1.5b")
    jparams = jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))
    batch = {"tokens": make_inputs(jcfg, seed=5)["tokens"]}
    jout = jax_generate(jcfg, {**jbatch(batch), "params": jparams},
                        JServeConfig(max_new_tokens=16))
    tout = generate(tcfg, {**tbatch(batch),
                           "params": params_from_jax(to_np(jparams), tcfg, "cpu")},
                    ServeConfig(max_new_tokens=16))
    assert np.array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_model_kernel_specs_are_the_references(arch, reduced):
    """Family-agnostic in both packages: rwkv6 registers attention
    handles though it has no attention, as the reference does."""
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for kw in ({"batch": 4, "seq": 512}, {"batch": 4, "seq": 512, "max_len": 4112}):
        assert model_kernel_specs(tcfg, **kw) == jax_specs(jcfg, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--autotune",
                "--kernel-tuning", "kernel", "--batch", "2", "--prompt-len", "16",
                "--tokens", "4", "--requests", "2"])
    out = capsys.readouterr().out
    assert out.count("req ") == 2 and "kernels:" in out


def test_launch_train_builds_rwkv6_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as train_cli

    train_cli.main(["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu", "--steps", "2",
                    "--seq", "32", "--batch", "2", "--ckpt-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = eval(line, {"__builtins__": {}, "inf": float("inf"), "nan": float("nan")})
    assert (out["start_step"], out["steps"]) == (0, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_each_family(arch):
    jcfg, tcfg = cfgs(arch)
    nparams = to_np(jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0)))
    tparams = params_from_jax(nparams, tcfg, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(nparams)[0]
    assert len(flat_j) == len(list(_leaves(tparams)))
    for path, leaf in flat_j:
        np.testing.assert_array_equal(_get(tparams, [k.key for k in path]).numpy(), leaf)
    bad = jax.tree.map(lambda a: a, nparams)
    bad["layers"]["ln1"] = np.ones((3,), np.float32)
    with pytest.raises(ValueError, match="ln1"):
        params_from_jax(bad, tcfg, "cpu")
