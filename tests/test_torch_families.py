"""The port's MoE, VLM and encoder-decoder families held against the JAX
package's, on the CPU.

Reduced configs (2 layers, d_model 64, heads of 16) of qwen3-moe-30b-a3b
(8 experts top-2), llama4-scout-17b-a16e (8 experts top-1 and a shared
expert), qwen2-vl-7b (M-RoPE, qkv bias, 16 vision patches) and
whisper-tiny (2 + 2 layers over 32 frames). Params are initialised once
in JAX and carried over with ``params_from_jax``; tokens and the stub
modality inputs are made with numpy from a seed. Tolerances, all fp32
with sums in other orders:

* logits, caches, MoE outputs and losses: rtol 1e-4, atol 1e-4 (as the
  dense family's in ``test_torch_serve.py``); the load-balancing loss
  rtol 1e-5;
* gradients of every leaf: rtol 1e-4, atol 1e-5 of the leaf's largest
  gradient (as ``test_torch_train.py``);
* layer functions without a reduction (positions, rotations, the
  sinusoidal table): rtol 1e-6, atol 1e-6;
* routing is discrete: the router's expert choices must be equal, and a
  check says whether any top-k margin of the inputs is under 1e-5 (an
  fp32 router summed in another order could swap two experts closer
  than that).

On the CPU every kernel call takes its plain PyTorch version; the hand
kernels are held against those on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as jL
from repro.models.model import build_model as jax_build
from repro.models.model import model_kernel_specs as jax_specs
from repro.models.moe import capacity as jax_capacity
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro.models.params import count_params as jax_count
from repro.models.params import init_tree as jax_init
from repro.models.vlm import mrope_positions as jax_mrope_positions
from repro.runtime.serve_loop import ServeConfig as JServeConfig
from repro.runtime.serve_loop import generate as jax_generate

from repro_torch.api import serve_tuning_defaults
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models.model import build_model, model_kernel_specs
from repro_torch.models.moe import capacity, moe_ffn, route
from repro_torch.models.params import count_params, init_tree
from repro_torch.models.vlm import mrope_positions
from repro_torch.runtime.serve_loop import ServeConfig, generate, widen_cache

TOL = {"rtol": 1e-4, "atol": 1e-4}
AUX_TOL = {"rtol": 1e-5, "atol": 1e-7}
EXACT_TOL = {"rtol": 1e-6, "atol": 1e-6}
MIN_MARGIN = 1e-5
MOE = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"]
FAMILIES = MOE + ["qwen2-vl-7b", "whisper-tiny"]
B, T = 2, 24


def cfgs(arch: str, **overrides):
    return (jax_config(arch).reduced(**overrides), get_config(arch).reduced(**overrides))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def make_inputs(cfg, seed: int = 0, T_: int = T) -> dict:
    """numpy tokens, labels and the family's stub modality input."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, T_)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.family == "encdec":
        batch["audio_embeds"] = (rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)) * 0.05).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision"] = (rng.standard_normal((B, 16, cfg.d_model)) * 0.05).astype(
            np.float32)
    return batch


def jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    jcfg, tcfg = cfgs(request.param)
    jparams = jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, to_np(jparams), make_inputs(jcfg)


def ffn_params(nparams, layer: int = 0) -> dict:
    return jax.tree.map(lambda a: a[layer], nparams["layers"])["ffn"]


# ------------------------------------------------------------------ MoE FFN
def _moe_case(arch, shape, seed, **overrides):
    jcfg, tcfg = cfgs(arch, **overrides)
    nparams = to_np(jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0)))
    p = ffn_params(nparams)
    x = np.random.default_rng(seed).standard_normal((*shape, jcfg.d_model)).astype(np.float32)
    jout, jaux = jax_moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg)
    tout, taux = moe_ffn(torch.from_numpy(x), jax.tree.map(torch.from_numpy, p), tcfg)
    return jcfg, x, p, (np.asarray(jout), float(jaux)), (tout.numpy(), float(taux))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("shape,overrides", [
    ((2, 32), {}),                              # two full groups
    ((3, 13), {}),                              # N 39: a ragged, zero-padded tail
    ((2, 32), {"capacity_factor": 0.01}),       # saturated capacity: drops
], ids=["groups", "ragged", "saturated"])
def test_moe_ffn_matches_jax(arch, shape, overrides):
    _, _, _, (jout, jaux), (tout, taux) = _moe_case(arch, shape, 3, **overrides)
    np.testing.assert_allclose(tout, jout, **TOL)
    np.testing.assert_allclose(taux, jaux, **AUX_TOL)
    assert taux > 0


def test_moe_dropped_tokens_contribute_zero():
    """At capacity 4 per expert of a 32-token group, top-1 (llama4-scout
    has a shared expert; without it the routed output of a dropped token
    is exactly 0): some tokens drop, and their rows are zero."""
    arch = "llama4-scout-17b-a16e"
    jcfg, x, p, (jout, _), (tout, _) = _moe_case(
        arch, (2, 32), 5, capacity_factor=0.01, n_shared_experts=0)
    assert capacity(get_config(arch).reduced(capacity_factor=0.01), 32) == 4
    zero = np.all(tout == 0.0, axis=-1)
    assert zero.any() and not zero.all()
    np.testing.assert_array_equal(zero, np.all(jout == 0.0, axis=-1))
    np.testing.assert_allclose(tout, jout, **TOL)


#: (top_k, tokens): one group of 32; one ragged chunk of 5 groups
#: (top 1); 5 groups in chunks of 2, 2, 1 (top 2); 3 groups, each its own
#: chunk (1 < G < top 8); 17 groups in 9 chunks (top 8). Every token
#: count past 32 leaves a zero-padded tail, but 544 (17 whole groups).
STACKED = [(1, 32), (1, 153), (2, 32), (2, 153), (8, 32), (8, 91), (8, 544)]
HOT = 3          # the expert half of each group picks first


def _forced_routing(k: int, n: int, E: int, d: int, seed: int = 0):
    """Inputs whose router logits (an identity router over the first E
    features) put each token's k choices in a set order, margins 0.5
    apart and 2.5 above the rest: the even tokens of a group choose
    expert ``HOT`` first (16 of 32, past capacity 4), tokens 1, 9, 17, 25
    choose it second (4, within capacity), no other token chooses it, and
    the rest are drawn at random. Returns x (n, d), the router (d, E) and
    the choices (n, k)."""
    rng = np.random.default_rng(seed)
    choices = np.empty((n, k), np.int64)
    for i in range(n):
        s = i % 32
        first = [HOT] if s % 2 == 0 else []
        if k >= 2 and s % 8 == 1:
            first = [int(rng.choice([e for e in range(E) if e != HOT])), HOT]
        rest = [e for e in rng.permutation(E) if e not in first and e != HOT]
        choices[i] = (first + rest)[:k]
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, :E] = rng.uniform(-1.0, 0.0, (n, E))
    for j in range(k):
        x[np.arange(n), choices[:, j]] = 6.0 - 0.5 * j
    router = np.zeros((d, E), np.float32)
    router[np.arange(E), np.arange(E)] = 1.0
    return x, router, choices


def _kept(choices: np.ndarray, C: int, S: int = 32) -> np.ndarray:
    """(n, k): whether each choice keeps its slot, counting each slice's
    queue per expert and group on its own (padding comes last and takes
    no real token's slot)."""
    n, k = choices.shape
    keep = np.zeros((n, k), bool)
    for j in range(k):
        for g0 in range(0, n, S):
            seen = np.zeros(choices.max() + 1, int)
            for i in range(g0, min(g0 + S, n)):
                keep[i, j] = seen[choices[i, j]] < C
                seen[choices[i, j]] += 1
    return keep


@pytest.mark.parametrize("k,n", STACKED, ids=[f"top{k}-{n}" for k, n in STACKED])
def test_the_stacked_dispatch_keeps_each_slices_capacity(k, n):
    """All top-k slices dispatched in one stack keep and drop what the
    reference's k top-1 slices do: capacity C per expert and per slice,
    never pooled. An expert past capacity in slice 0 and within it in
    slice 1 of the same group; the port's zeroed shares are those of a
    per-slice count; both packages' outputs equal that count's sum."""
    from repro_torch.models.moe import _slots

    E = 16
    jcfg, tcfg = cfgs("qwen3-moe-30b-a3b", top_k=k, n_experts=E)
    p = ffn_params(to_np(jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))))
    x, p["router"], choices = _forced_routing(k, n, E, jcfg.d_model)
    C = capacity(tcfg, 32)
    keep = _kept(choices, C)
    first = keep[np.arange(0, n, 2), 0]
    assert C == 4 and not first.all() and first.any()
    if k >= 2:
        assert keep[np.arange(1, n, 8), 1].all()     # the same expert, its other slice
    jout, _ = jax_moe_ffn(jnp.asarray(x[None]), jax.tree.map(jnp.asarray, p), jcfg)
    tout, _ = moe_ffn(torch.from_numpy(x[None]), jax.tree.map(torch.from_numpy, p), tcfg)

    # the port's shares: slice j's slots of the chosen expert hold the gate or 0
    G = -(-n // 32)
    xg = np.concatenate([x, np.zeros((G * 32 - n, x.shape[1]), np.float32)])
    _, gate_w, gate_idx = route(torch.from_numpy(xg).reshape(G, 32, -1),
                                torch.from_numpy(p["router"]), k)
    np.testing.assert_array_equal(gate_idx.reshape(-1, k)[:n].numpy(), choices)
    dispatch, combine = _slots(gate_w, gate_idx, C, E, torch.float32)
    per_slice = lambda t: t.reshape(G * 32, E, k, C).sum(-1)[:n]   # noqa: E731
    rows = np.arange(n)[:, None]
    np.testing.assert_array_equal(per_slice(dispatch).numpy()[rows, choices, np.arange(k)],
                                  keep.astype(np.float32))
    assert float(per_slice(dispatch).sum()) == keep.sum()
    shares = per_slice(combine).numpy()[rows, choices, np.arange(k)]
    np.testing.assert_array_equal(shares, np.where(keep, gate_w.reshape(-1, k)[:n], 0.0))

    # each token's output: the kept choices' gated experts
    logits = x[:, :E].astype(np.float64)
    top = np.take_along_axis(logits, choices, 1)
    gate = np.exp(top - top.max(1, keepdims=True))
    gate /= gate.sum(1, keepdims=True)

    def expert(e, v):
        g, u = v @ p["w_gate"][e], v @ p["w_up"][e]
        return (g / (1 + np.exp(-g)) * u) @ p["w_down"][e]

    y = np.stack([[expert(e, x[i].astype(np.float64)) for e in choices[i]]
                  for i in range(n)])                                    # (n, k, d)
    want = np.einsum("nk,nkd->nd", gate * keep, y)
    every = np.einsum("nk,nkd->nd", gate, y)
    assert np.abs(every - want).max() > 100 * TOL["atol"]   # the drops show
    np.testing.assert_allclose(np.asarray(jout)[0], want, **TOL)
    np.testing.assert_allclose(tout[0].numpy(), want, **TOL)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_a_decode_moe_call_dispatches_as_many_ops_at_any_top_k():
    """One reduced ``moe_ffn`` call at one group (a decode step's 8 tokens)
    runs the same number of aten ops at top 2, 4 and 8: the slices share
    one dispatch, one pass of the experts and one combine, so no launch
    is made per slice."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for k in (2, 4, 8):
        cfg = get_config("qwen3-moe-30b-a3b").reduced(top_k=k, n_experts=16)
        params = init_tree(build_model(cfg).param_defs(), torch.Generator().manual_seed(0))
        lp = {n: v[0] for n, v in params["layers"]["ffn"].items()}
        x = torch.randn(8, 1, cfg.d_model, generator=torch.Generator().manual_seed(1))
        with torch.no_grad(), Count() as c:
            out, aux = moe_ffn(x, lp, cfg)
        assert out.shape == x.shape and torch.isfinite(out).all()
        counts[k] = c.n
    assert counts[2] == counts[4] == counts[8], counts


def test_capacity_is_the_references():
    for arch in MOE + ["deepseek-7b"]:
        for factor in (0.01, 1.25, 8.0):
            jcfg = dataclasses.replace(jax_config(arch), capacity_factor=factor,
                                       n_experts=jax_config(arch).n_experts or 16)
            tcfg = dataclasses.replace(get_config(arch), capacity_factor=factor,
                                       n_experts=get_config(arch).n_experts or 16)
            for group_len in (None, 1, 4, 32, 100, 512):
                assert capacity(tcfg, group_len) == jax_capacity(jcfg, group_len)


def _jax_route(xg, router, k):
    logits = jnp.einsum("gsd,de->gse", xg, router)
    probs = jax.nn.softmax(logits, axis=-1)
    return probs, jax.lax.top_k(probs, k)


@pytest.mark.parametrize("arch", MOE)
def test_router_choices_are_the_references(arch):
    """The expert indices (G, S, k) equal the reference's exactly; the
    gates agree within TOL. No top-k margin of these inputs (the gap
    between neighbouring probabilities down to the (k+1)-th) is under
    MIN_MARGIN, or the test says so instead of trusting the comparison."""
    jcfg, tcfg = cfgs(arch)
    nparams = to_np(jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0)))
    router = ffn_params(nparams)["router"]
    xg = np.random.default_rng(7).standard_normal((4, 32, jcfg.d_model)).astype(np.float32)
    jprobs, (_, jidx) = _jax_route(jnp.asarray(xg), jnp.asarray(router), jcfg.top_k)
    top = -np.sort(-np.asarray(jprobs), axis=-1)[..., :jcfg.top_k + 1]
    margin = float(np.min(top[..., :-1] - top[..., 1:]))
    assert margin >= MIN_MARGIN, (
        f"a top-k margin of {margin:.2e} in the test's inputs is under {MIN_MARGIN}: "
        "a different summation order may legitimately swap two experts there")
    probs, gate_w, gate_idx = route(torch.from_numpy(xg), torch.from_numpy(router),
                                    tcfg.top_k)
    np.testing.assert_array_equal(gate_idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    jw = np.take_along_axis(np.asarray(jprobs), np.asarray(jidx), -1)
    np.testing.assert_allclose(gate_w.numpy(), jw / jw.sum(-1, keepdims=True), **TOL)


# ------------------------------------------------------------ whole models
def test_prefill_logits_and_caches_match_jax(family):
    jcfg, tcfg, jparams, nparams, batch = family
    jl, jcache = jax.jit(jax_build(jcfg).prefill)(jparams, jbatch(batch))
    tl, tcache = build_model(tcfg).prefill(params_from_jax(nparams, tcfg, "cpu"),
                                           tbatch(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert len(tcache) == len(jcache) == (4 if tcfg.family == "encdec" else 2)
    for t, j in zip(tcache, jcache):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _pad_cache(cache, want_shapes):
    return tuple(jnp.pad(c, [(0, w - g) for g, w in zip(c.shape, want)])
                 for c, want in zip(cache, want_shapes))


def test_greedy_decode_matches_jax_over_8_steps(family):
    jcfg, tcfg, jparams, nparams, batch = family
    steps = 8
    P = 16 if tcfg.family == "vlm" else 0
    max_len = P + T + steps
    jm, tm = jax_build(jcfg), build_model(tcfg)
    tparams = params_from_jax(nparams, tcfg, "cpu")
    jl, jcache = jax.jit(jm.prefill)(jparams, jbatch(batch))
    jcache = _pad_cache(jcache, [s.shape for s in jm.init_cache_shape(B, max_len)])
    tl, tcache = tm.prefill(tparams, tbatch(batch))
    tcache = widen_cache(tm, tcache, B, max_len)
    jdec = jax.jit(jm.decode_step)
    jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
    # the VLM's rotary position follows the patches the batch carried
    side = 4
    for i in range(steps):
        assert np.array_equal(tt.numpy(), np.asarray(jt)), i
        pos = P + T + i
        if tcfg.family == "vlm":
            jl, jcache = jdec(jparams, jcache, jt, jnp.int32(pos), jnp.int32(side + T + i))
            tl, tcache = tm.decode_step(tparams, tcache, tt, pos, rope_pos=side + T + i)
        else:
            jl, jcache = jdec(jparams, jcache, jt, jnp.int32(pos))
            tl, tcache = tm.decode_step(tparams, tcache, tt, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], dim=-1)[:, None]


def test_vlm_decode_defaults_rope_pos_to_the_references():
    """Without ``rope_pos`` the VLM rotates decode token ``pos`` at
    ``pos - cfg.vision_patches + side`` (the reference's default, R2)."""
    jcfg, tcfg = cfgs("qwen2-vl-7b")
    jparams = jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))
    tparams = params_from_jax(to_np(jparams), tcfg, "cpu")
    jm, tm = jax_build(jcfg), build_model(tcfg)
    max_len = 40
    jcache = jm.init_cache(B, max_len)
    tcache = tm.init_cache(B, max_len)
    tok = np.array([[3], [5]], np.int32)
    for pos in (20, 21):
        jl, jcache = jax.jit(jm.decode_step)(jparams, jcache, jnp.asarray(tok), jnp.int32(pos))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_loss_and_every_gradient_match_jax_for_qwen3_moe():
    jcfg, tcfg = cfgs("qwen3-moe-30b-a3b")
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jax_init(jm.param_defs(), jax.random.PRNGKey(0))
    batch = make_inputs(jcfg, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jparams, jbatch(batch))
    tparams = params_from_jax(to_np(jparams), tcfg, "cpu")
    leaves, paths = [], []

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                leaves.append(v.requires_grad_())
                paths.append(path + (k,))

    walk(tparams)
    tloss = tm.loss(tparams, tbatch(batch))
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    for path, g in zip(paths, grads):
        want = np.asarray(_get(jgrads, path))
        assert np.abs(want).max() > 0, path
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg="/".join(path))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_moe_loss_adds_a_hundredth_of_the_load_balancing_loss():
    """The loss with the aux term, against the cross entropy of the same
    logits: they differ by 0.01 times the blocks' summed aux losses."""
    jcfg, tcfg = cfgs("qwen3-moe-30b-a3b")
    jparams = jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))
    tparams = params_from_jax(to_np(jparams), tcfg, "cpu")
    tm = build_model(tcfg)
    batch = tbatch(make_inputs(jcfg, seed=2))
    with torch.no_grad():
        loss = tm.loss(tparams, batch)
        x = L.embed_tokens(batch["tokens"], tparams["tok"], tcfg)
        pos = torch.arange(T)[None].expand(B, T)
        h, aux = tm.forward_train(tparams, x, pos)
        ce = L.cross_entropy(L.logits_out(h, tparams["tok"], tcfg), batch["labels"])
    assert float(aux) > 0
    np.testing.assert_allclose(float(loss), float(ce + 0.01 * aux), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-tiny"])
def test_loss_matches_jax(arch):
    jcfg, tcfg = cfgs(arch)
    jparams = jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))
    batch = make_inputs(jcfg, seed=1)
    jloss = jax.jit(jax_build(jcfg).loss)(jparams, jbatch(batch))
    tloss = build_model(tcfg).loss(params_from_jax(to_np(jparams), tcfg, "cpu"),
                                   tbatch(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)


# ---------------------------------------------------------- layer functions
@pytest.mark.parametrize("P,T_text,B_", [(16, 8, 2), (1024, 512, 1), (10, 3, 3), (0, 5, 1)])
def test_mrope_positions_are_the_references(P, T_text, B_):
    want = np.asarray(jax_mrope_positions(P, T_text, B_))
    got = mrope_positions(P, T_text, B_).numpy()
    assert got.shape == want.shape == (3, B_, P + T_text)
    np.testing.assert_array_equal(got, want)


def test_apply_mrope_is_the_references():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 9)).astype(np.int32)
    want = jL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (4, 2, 2))
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (4, 2, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT_TOL)
    with pytest.raises(ValueError, match="sum"):
        L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (4, 2, 1))


@pytest.mark.parametrize("T_,d", [(32, 64), (1500, 384)])
def test_sinusoidal_embedding_is_the_references(T_, d):
    np.testing.assert_allclose(L.sinusoidal_embedding(T_, d).numpy(),
                               np.asarray(jL.sinusoidal_embedding(T_, d)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("Tq", [1, 7])
def test_cross_attention_and_encoder_kv_are_the_references(Tq):
    """One query (flash-decoding) or several (non-causal flash attention)
    over 37 encoder frames, 4 heads over 2 kv heads."""
    jcfg, tcfg = cfgs("whisper-tiny", n_kv_heads=2)
    jparams = jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: np.asarray(a[0]), jparams["dec_layers"])["xattn"]
    rng = np.random.default_rng(Tq)
    enc = rng.standard_normal((B, 37, jcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, Tq, jcfg.d_model)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)
    jk, jv = jL.encoder_kv(jp, jcfg, jnp.asarray(enc))
    tk, tv = L.encoder_kv(tp, tcfg, torch.from_numpy(enc))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    want = jL.cross_attention(jnp.asarray(x), jp, jcfg, jk, jv)
    got = L.cross_attention(torch.from_numpy(x), tp, tcfg, tk, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------- serving and specs
def tuned_serve_config(kernel_tuning: str) -> ServeConfig:
    return ServeConfig(max_new_tokens=4, tuning=dataclasses.replace(
        serve_tuning_defaults(), enabled=True, kernel_tuning=kernel_tuning))


@pytest.mark.parametrize("kernel_tuning", ["kernel", "program"])
def test_generate_with_tuning_gives_the_jax_tokens(family, kernel_tuning):
    jcfg, tcfg, jparams, nparams, batch = family
    batch = {k: v for k, v in batch.items() if k != "labels"}
    jout = jax_generate(jcfg, {**jbatch(batch), "params": jparams},
                        JServeConfig(max_new_tokens=4, autotune=True,
                                     kernel_tuning=kernel_tuning))
    tout = generate(tcfg, {**tbatch(batch), "params": params_from_jax(nparams, tcfg, "cpu")},
                    tuned_serve_config(kernel_tuning))
    assert np.array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    assert set(tout["autotune"]["kernels"]) == set(jout["autotune"]["kernels"])


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("reduced", [True, False])
def test_model_kernel_specs_are_the_references(arch, reduced):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for kw in ({"batch": 4, "seq": 512}, {"batch": 4, "seq": 512, "max_len": 1568}):
        assert model_kernel_specs(tcfg, **kw) == jax_specs(jcfg, **kw)


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_serve_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--autotune",
                "--kernel-tuning", "kernel", "--batch", "2", "--prompt-len", "16",
                "--tokens", "4", "--requests", "2"])
    out = capsys.readouterr().out
    assert out.count("req ") == 2 and "kernels:" in out


def test_serve_passes_the_references_stub_inputs(monkeypatch):
    """``launch/serve.py::serve`` adds (B, enc_frames, d) frames for the
    encoder-decoder and (B, 16, d) patches for the VLM, times 0.05, from
    a generator seeded with 1, the same for every request."""
    from repro_torch.launch import serve

    seen = []

    def fake_generate(cfg, batch, serve_cfg, session=None):
        seen.append({k: v.clone() for k, v in batch.items()})
        return {"tokens": batch["tokens"]}

    monkeypatch.setattr("repro_torch.runtime.serve_loop.generate", fake_generate)
    for arch, key, shape in (("whisper-tiny", "audio_embeds", (2, 32, 64)),
                             ("qwen2-vl-7b", "vision", (2, 16, 64))):
        seen.clear()
        args, tcfg = serve.parse_args(["--arch", arch, "--reduced", "--device", "cpu",
                                       "--batch", "2", "--requests", "2"])
        serve.serve(args, tcfg, None)
        want = torch.randn(*shape, generator=torch.Generator().manual_seed(1)) * 0.05
        for b in seen:
            assert torch.equal(b[key], want), arch
        assert not torch.equal(seen[0]["tokens"], seen[1]["tokens"])


# -------------------------------------------- params, counts, the raise
@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_carries_each_family(arch):
    jcfg, tcfg = cfgs(arch)
    nparams = to_np(jax_init(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0)))
    tparams = params_from_jax(nparams, tcfg, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(nparams)[0]
    assert len(flat_j) == count_leaves(tparams)
    for path, leaf in flat_j:
        keys = [k.key for k in path]
        np.testing.assert_array_equal(_get(tparams, keys).numpy(), leaf)
    bad = jax.tree.map(lambda a: a, nparams)
    bad["tok"]["embed"] = np.ones((3, 3), np.float32)
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(bad, tcfg, "cpu")


def count_leaves(tree) -> int:
    return sum(count_leaves(v) if isinstance(v, dict) else 1 for v in tree.values())


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_counts_are_the_references(arch):
    """The port declares the reference's tree (exact count, at full width
    and reduced) and stays within 5 % of the config's analytic count."""
    for jcfg, tcfg in ((jax_config(arch), get_config(arch)), cfgs(arch)):
        exact = count_params(build_model(tcfg).param_defs())
        assert exact == jax_count(jax_build(jcfg).param_defs())
    full = get_config(arch)
    exact = count_params(build_model(full).param_defs())
    assert abs(exact - full.n_params()) / exact < 0.05


def test_init_tree_builds_each_family_on_the_cpu():
    for arch in FAMILIES:
        tcfg = get_config(arch).reduced()
        params = init_tree(build_model(tcfg).param_defs(), torch.Generator().manual_seed(0))
        assert count_leaves(params) == len(list(jax.tree.leaves(
            jax_init(jax_build(jax_config(arch).reduced()).param_defs(),
                     jax.random.PRNGKey(0)))))


# ---------------------------------------- ported reference tests (test_models)
def _ref_batch(tcfg, seed=1, T_=32):
    batch = tbatch(make_inputs(tcfg, seed=seed, T_=T_))
    batch["labels"] = batch["tokens"]
    return batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_arch_smoke_loss_and_grads(arch):
    """Port of ``tests/test_models.py::test_arch_smoke_loss_and_grads``."""
    tcfg = get_config(arch).reduced()
    model = build_model(tcfg)
    params = init_tree(model.param_defs(), torch.Generator().manual_seed(0))
    leaves = []

    def walk(node):
        for v in node.values():
            walk(v) if isinstance(v, dict) else leaves.append(v.requires_grad_())

    walk(params)
    loss = model.loss(params, _ref_batch(tcfg))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert loss.shape == () and torch.isfinite(loss)
    assert all(g is None or torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("arch", FAMILIES)
def test_arch_prefill_decode_consistency(arch):
    """Port of ``tests/test_models.py::test_arch_prefill_decode_consistency``:
    decode(prefill(T), token_T) == prefill(T+1) last logits (MoE at a
    drop-free capacity factor)."""
    tcfg = get_config(arch).reduced(capacity_factor=8.0)
    model = build_model(tcfg)
    params = init_tree(model.param_defs(), torch.Generator().manual_seed(0))
    T_ = 16
    full_batch = _ref_batch(tcfg, seed=4, T_=T_ + 1)
    prompt = dict(full_batch, tokens=full_batch["tokens"][:, :T_])
    with torch.no_grad():
        logits_p, cache = model.prefill(params, prompt)
        assert torch.isfinite(logits_p).all()
        full = widen_cache(model, cache, B, 64)
        pos0 = T_ if tcfg.family != "vlm" else T_ + 16
        logits_d, _ = model.decode_step(params, full, full_batch["tokens"][:, T_:T_ + 1],
                                        pos0)
        logits_p2, _ = model.prefill(params, full_batch)
    np.testing.assert_allclose(logits_p2.numpy(), logits_d.numpy(), rtol=2e-2, atol=2e-2)


def test_moe_aux_loss_and_capacity():
    """Port of ``tests/test_models.py::test_moe_aux_loss_and_capacity``."""
    tcfg = get_config("qwen3-moe-30b-a3b").reduced()
    params = init_tree(build_model(tcfg).param_defs(), torch.Generator().manual_seed(0))
    x = torch.randn(2, 32, tcfg.d_model, generator=torch.Generator().manual_seed(2))
    lp = {k: v[0] for k, v in params["layers"]["ffn"].items()}
    out, aux = moe_ffn(x, lp, tcfg)
    assert out.shape == x.shape
    assert torch.isfinite(aux) and float(aux) > 0
    assert capacity(tcfg, 32) >= 4


def test_moe_dropped_tokens_pass_through():
    """Port of ``tests/test_models.py::test_moe_dropped_tokens_pass_through``."""
    tcfg = get_config("qwen3-moe-30b-a3b").reduced(capacity_factor=0.01)
    model = build_model(tcfg)
    params = init_tree(model.param_defs(), torch.Generator().manual_seed(0))
    assert torch.isfinite(model.loss(params, _ref_batch(tcfg)))


def test_vlm_mrope_positions():
    """Port of ``tests/test_models.py::test_vlm_mrope_positions``."""
    pos = mrope_positions(16, 8, 2)
    assert pos.shape == (3, 2, 24)
    txt = pos[:, 0, 16:]
    assert bool((txt[:, 1:] > txt[:, :-1]).all())
