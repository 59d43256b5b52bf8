"""The plain reference against the port's own plain path (its CPU
versions of every kernel), at a small size in float32: prefill's
last-position logits and each decode step's through the cache. Only this
test imports both."""

import pytest
import torch

from pbench import spec, weights
from pbench.model import program_config
from small import small_config

#: every cell of BENCHMARK.json
CELLS = tuple(w["name"] for w in spec.load_benchmark()["workloads"])


def program_logits(conf, params, prompts, served):
    from repro_torch.models.model import build_model
    from repro_torch.runtime.serve_loop import widen_cache

    cfg = program_config(conf)
    model = build_model(cfg)
    B, T = prompts.shape
    n = served.shape[1]
    logits, cache = model.prefill(params, {"tokens": prompts})
    cache = widen_cache(model, cache, B, T + n)
    out = [logits[:, -1]]
    for i in range(n - 1):
        logits, cache = model.decode_step(params, cache, served[:, i:i + 1], T + i)
        out.append(logits[:, -1])
    return torch.stack(out, dim=1).float()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("batch,length", [(3, 20), (2, 7)])
def test_reference_matches_the_ports_plain_path(name, batch, length):
    cell = spec.cell(name)
    conf = small_config(cell.config, dtype="float32")
    s = spec.reference(conf).shapes(conf)
    params = weights.make_params(s, 5, "cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, s.vocab, (batch, length), generator=gen)
    served = torch.randint(0, s.vocab, (batch, 5), generator=gen)
    got = program_logits(conf, params, prompts, served)
    want = spec.reference(conf).served_logits(params, conf, prompts, served)
    assert want.shape == got.shape == (batch, 5, s.vocab)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_capacity_drops_tokens_in_the_small_moe():
    """The MoE case above is only a test of capacity if some token of it
    overflows an expert: count the drops the reference makes."""
    cell = spec.cell("qwen3-moe-30b-a3b.decode-batch")
    conf = small_config(cell.config, dtype="float32")
    ref = spec.reference(conf)
    s = ref.shapes(conf)
    calls = ref.call_groups(3, 20, 24, s.group_size)
    assert [len(g) for g in calls] == [4] + [1] * 4       # 60 prompt tokens in 16s
    assert ref.capacity(s, 16) == 4
    # 16 equal tokens all choose the same two experts: each of the two
    # top-1 dispatches keeps the group's first 4 tokens and drops the rest
    h = torch.zeros(16, s.d)
    p = {"router": torch.zeros(s.d, s.experts)}
    p["router"][:, 0] = 1.0
    h[:, 0] = 1.0
    for n in ("w_gate", "w_up"):
        p[n] = torch.ones(s.experts, s.d, s.d_ff)
    p["w_down"] = torch.ones(s.experts, s.d_ff, s.d)
    out = ref._moe(h, p, s, [[torch.arange(16)]], "fp32")
    kept = torch.nonzero(out.abs().sum(-1) > 0).flatten().tolist()
    assert kept == [0, 1, 2, 3]
