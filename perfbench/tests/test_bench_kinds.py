"""A configuration's kind of block (``perfbench/reference/<kind>.py``) is
the harness's one extension point.

(a) The ``transformer`` kind gives both cells what the harness gave them
    before the kind was a module of its own: the same weights' layout
    and bits, the same ``ModelConfig``, the same FLOP and byte counts
    (values recorded by running the harness of commit 15d083c on the CPU).
(b) A kind is added by files alone: in a copy of the checkout, a kind
    with shared experts (``tests/kinds/moe_shared.py``), a configuration,
    a mix, a limit and entries make a cell that runs through set-up,
    window, traced stretch and comparison, correct, with its counts
    holding the shared experts, and a planted fault fails it.
(c) The first-token probe and the trace's step ranges sit on the class
    the program builds for the cell, also where that class overrides
    ``prefill``.
"""

import dataclasses
import hashlib
import json
import shutil
import time

import pytest
import torch

from pbench import runner, spec, trace, weights
from pbench import yardstick as Y
from pbench.cellrun import run_cell
from pbench.model import program_config
from small import small_config, small_mix
from test_bench_faults import run_with_fault

CELL_OF = {"deepseek-7b": "deepseek-7b.prefill-long",
           "qwen3-moe-30b-a3b": "qwen3-moe-30b-a3b.decode-batch"}

#: the parent's param_layout at published sizes: (path, shape, scale)
LAYOUT = {
    'deepseek-7b': [
        ('tok.embed', (102400, 4096), 0.02),
        ('tok.unembed', (4096, 102400), 0.015625),
        ('layers.ln1', (30, 4096), 0.0),
        ('layers.ln2', (30, 4096), 0.0),
        ('layers.attn.wq', (30, 4096, 32, 128), 0.015625),
        ('layers.attn.wk', (30, 4096, 32, 128), 0.015625),
        ('layers.attn.wv', (30, 4096, 32, 128), 0.015625),
        ('layers.attn.wo', (30, 32, 128, 4096), 0.015625),
        ('ln_f', (4096,), 0.0),
        ('layers.ffn.w_gate', (30, 4096, 11008), 0.015625),
        ('layers.ffn.w_up', (30, 4096, 11008), 0.015625),
        ('layers.ffn.w_down', (30, 11008, 4096), 0.009531160645787792),
    ],
    'qwen3-moe-30b-a3b': [
        ('tok.embed', (151936, 2048), 0.02),
        ('tok.unembed', (2048, 151936), 0.022097086912079608),
        ('layers.ln1', (48, 2048), 0.0),
        ('layers.ln2', (48, 2048), 0.0),
        ('layers.attn.wq', (48, 2048, 32, 128), 0.022097086912079608),
        ('layers.attn.wk', (48, 2048, 4, 128), 0.022097086912079608),
        ('layers.attn.wv', (48, 2048, 4, 128), 0.022097086912079608),
        ('layers.attn.wo', (48, 32, 128, 2048), 0.015625),
        ('ln_f', (2048,), 0.0),
        ('layers.ffn.router', (48, 2048, 128), 0.022097086912079608),
        ('layers.ffn.w_gate', (48, 128, 2048, 768), 0.022097086912079608),
        ('layers.ffn.w_up', (48, 128, 2048, 768), 0.022097086912079608),
        ('layers.ffn.w_down', (48, 128, 768, 2048), 0.036084391824351615),
    ],
}
N_PARAMS = {'deepseek-7b': 6910365696, 'qwen3-moe-30b-a3b': 30532110336}
#: the parent's yardstick counts at each mix's (batch, length, new tokens)
COUNTS = {
    'deepseek-7b': {
        'linear_flops_per_token': 12142510080.0,
        'head_flops': 838860800.0,
        'causal_attention_flops(1024)': 257949696000.0,
        'decode_attention_flops(1027)': 504791040.0,
        'prefill_flops(8,1024)': 101541751029760.0,
        'decode_flops(8,1024,4)': 323656089600.0,
        'request_flops(8,1024,4)': 101865407119360.0,
        'causal_attention_flops(2048)': 1031295467520.0,
        'decode_attention_flops(2051)': 1008107520.0,
        'prefill_flops(8,2048)': 207199959777280.0,
        'decode_flops(8,2048,4)': 335735685120.0,
        'request_flops(8,2048,4)': 207535695462400.0,
        'causal_attention_flops(3072)': 2320037314560.0,
        'decode_attention_flops(3075)': 1511424000.0,
        'prefill_flops(8,3072)': 316981337128960.0,
        'decode_flops(8,3072,4)': 347815280640.0,
        'request_flops(8,3072,4)': 317329152409600.0,
        'causal_attention_flops(4092)': 4116125122560.0,
        'decode_attention_flops(4095)': 2012774400.0,
        'prefill_flops(8,4092)': 430432921845760.0,
        'decode_flops(8,4092,4)': 359847690240.0,
        'request_flops(8,4092,4)': 430792769536000.0,
    },
    'qwen3-moe-30b-a3b': {
        'linear_flops_per_token': 5460983808.0,
        'head_flops': 622329856.0,
        'causal_attention_flops(512)': 103280541696.0,
        'decode_attention_flops(543)': 427032576.0,
        'prefill_flops(64,512)': 185595301199872.0,
        'decode_flops(64,512,32)': 12893122723840.0,
        'request_flops(64,512,32)': 198488423923712.0,
        'moe_call(64,100)': (4865392640.0, 944766976),
        'moe_call(32768,128)': (2491081031680.0, 1476919296),
    },
}
#: sha256 of the small stand-in's bf16 weights drawn from seed 1
SMALL_WEIGHTS_SHA256 = {
    'deepseek-7b': '6b70ac429775542e2dadfce68de31d3028ebeafd85831af29da91f9898409aa9',
    'qwen3-moe-30b-a3b': '3709e32a621d56ce886c42b704c64d98b85351e976a6cfadee72c83f90d15bcb',
}
#: the fields the parent's program_config set over get_config(arch)
PROGRAM_FIELDS = {
    'deepseek-7b': dict(family='dense', n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128, d_ff=11008, vocab=102400, rope_theta=10000.0, act='swiglu', qkv_bias=False, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16),
    'qwen3-moe-30b-a3b': dict(family='moe', n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128, d_ff=768, vocab=151936, rope_theta=1000000.0, act='swiglu', qkv_bias=False, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, n_experts=128, top_k=8, n_shared_experts=0, capacity_factor=1.25, moe_group_size=512),
}


def counts(s, mix: dict) -> dict:
    """The yardstick's counts of ``s`` at the mix's sizes, named as recorded."""
    b, n = mix["batch"], mix["new_tokens"]
    out = {"linear_flops_per_token": Y.linear_flops_per_token(s), "head_flops": Y.head_flops(s)}
    for t in mix["prompt_lengths"]:
        out[f"causal_attention_flops({t})"] = Y.causal_attention_flops(s, t)
        out[f"decode_attention_flops({t + n - 1})"] = Y.decode_attention_flops(s, t + n - 1)
        out[f"prefill_flops({b},{t})"] = Y.prefill_flops(s, b, t)
        out[f"decode_flops({b},{t},{n})"] = Y.decode_flops(s, b, t, n)
        out[f"request_flops({b},{t},{n})"] = Y.request_flops(s, b, t, n)
    if getattr(s, "experts", 0):
        tokens = b * mix["prompt_lengths"][0]
        out["moe_call(64,100)"] = Y.moe_call(s, 64, 100)
        out[f"moe_call({tokens},{s.experts})"] = Y.moe_call(s, tokens, s.experts)
    return out


def tree_sha256(tree: dict) -> str:
    h = hashlib.sha256()

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                h.update(".".join(path + (k,)).encode())
                h.update(str(tuple(v.shape)).encode())
                h.update(v.contiguous().view(torch.int16).numpy().tobytes())
    walk(tree, ())
    return h.hexdigest()


# ------------------------------------------------------ (a) the same numbers
@pytest.mark.parametrize("config", sorted(CELL_OF))
def test_the_kind_keeps_the_recorded_weights_config_and_counts(config):
    cell = spec.cell(CELL_OF[config])
    conf = cell.config
    kind = spec.reference(conf)
    s = kind.shapes(conf)
    assert [(".".join(p), sh, sc) for p, sh, sc in weights.param_layout(s)] == LAYOUT[config]
    assert weights.n_params(s) == N_PARAMS[config]
    assert counts(s, cell.mix) == COUNTS[config]
    from repro_torch.configs import get_config

    want = dataclasses.replace(get_config(conf["runs_as"]["arch"]), **PROGRAM_FIELDS[config])
    assert program_config(conf) == want
    small = small_config(conf)
    tree = weights.make_params(kind.shapes(small), 1, "cpu", dtype=torch.bfloat16)
    assert tree_sha256(tree) == SMALL_WEIGHTS_SHA256[config]


# ------------------------------------------------- (b) a kind added by files
SHARED_CELL = "qwen3-moe-shared.decode-shared"


def add_shared_expert_cell(root):
    """A copy of the checkout at ``root`` with a kind of block, a
    configuration, a mix, a limit and their entries added, and no file
    of the copy edited but ``BENCHMARK.json``'s lists."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", root)
    shutil.copytree(spec.BENCH_DIR, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "perfbench"
    shutil.copy(bench / "tests" / "kinds" / "moe_shared.py", bench / "reference")
    conf = json.loads((bench / "configs" / "qwen3-moe-30b-a3b.json").read_text())
    conf.update(reference="moe_shared", n_shared_experts=1)
    (bench / "configs" / "qwen3-moe-shared.json").write_text(json.dumps(conf))
    shutil.copy(bench / "traffic" / "decode-batch.json", bench / "traffic" / "decode-shared.json")
    shutil.copy(bench / "limits" / "qwen3-moe-30b-a3b.decode-batch.json",
                bench / "limits" / f"{SHARED_CELL}.json")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "qwen3-moe-shared", "source": conf["source"],
                         "file": "perfbench/configs/qwen3-moe-shared.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": SHARED_CELL, "config": "qwen3-moe-shared",
                           "traffic": "decode-shared", "chips": 1, "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "qwen3-moe-30b-a3b.decode-batch" in m.get("workloads", []):
            m["workloads"].append(SHARED_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return spec.cell(SHARED_CELL, root)


def test_a_kind_added_by_files_runs_its_cell_and_counts_its_shared_expert(tmp_path,
                                                                          monkeypatch):
    cell = add_shared_expert_cell(tmp_path)
    seen = []                                        # the records the readers get
    reader = spec.metric_reader

    def spy(name, root=spec.ROOT):
        read = reader(name, root)

        def recorded(rec):
            seen.append(rec)
            return read(rec)
        return recorded

    monkeypatch.setattr(spec, "metric_reader", spy)
    conf = small_config(cell.config, tmp_path)
    mix = small_mix(cell.mix, lengths=(20,), batch=4, new_tokens=6)
    torch.manual_seed(0)
    r = run_cell(cell, 2**31 + 29, 0.0, True, "cpu", time.perf_counter(), conf=conf,
                 mix_spec=mix, root=tmp_path)
    assert r["correct"] and set(r["checks"]) == {"mean_logit_gap"}, r["checks"]
    rec = seen[0]
    s = rec["shapes"]
    kind = spec.kind_of(s)
    assert kind is spec.reference(cell.config, tmp_path) and s.shared == 1
    plain = kind.base.shapes(conf)                   # the same sizes without the shared expert
    shared_flops = 2 * s.n_layers * 3 * s.d * s.shared_ff   # a token through the layers

    mfu = reader("mfu", tmp_path)
    w = rec["window"]
    tokens = sum(b.batch * (b.length + b.new_tokens - 1) for b in w.batches)
    assert r["metrics"]["mfu"]["value"] == mfu(rec)
    assert mfu(rec) - mfu(dict(rec, shapes=plain)) == pytest.approx(
        100 * tokens * shared_flops / (w.seconds * Y.PEAK_BF16_FLOPS), rel=1e-9)

    # the CPU's trace holds no device time: price the calls over one second
    t = rec["trace"]
    assert t["moe_calls"]
    t = dict(t, range_device_s=dict(t["range_device_s"], moe_ffn=1.0))
    roofline = reader("moe_roofline", tmp_path)
    want = 0.0
    for n, used in t["moe_calls"]:
        flops, nbytes = kind.base.moe_call(plain, n, used)
        want += Y.roofline_s(flops + 2 * n * 3 * s.d * s.shared_ff,
                             nbytes + Y.BF16_BYTES * 3 * s.d * s.shared_ff)
    assert roofline(dict(rec, trace=t)) == pytest.approx(100 * want, rel=1e-12)
    assert roofline(dict(rec, trace=t)) > roofline(dict(rec, trace=t, shapes=plain))


def test_a_kind_added_by_files_fails_a_planted_fault(tmp_path):
    cell = add_shared_expert_cell(tmp_path)
    assert run_with_fault(cell, "token_altered", tmp_path)["correct"] is False


# ---------------------------------------- (c) the probes on the model's class
def test_a_model_class_with_its_own_prefill_gets_its_first_token_and_ranges(monkeypatch):
    from repro_torch.models import model as model_module
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.runtime import serve_loop

    prefill = TransformerLM.prefill

    class OwnPrefill(TransformerLM):
        def prefill(self, params, batch):
            return prefill(self, params, batch)

    for module in (model_module, serve_loop):
        monkeypatch.setattr(module, "build_model", OwnPrefill)
    cell = spec.cell(CELL_OF["deepseek-7b"])
    torch.manual_seed(0)
    ctx = runner.setup(cell, 2**31 + 31, "cpu", conf=small_config(cell.config),
                       mix_spec=small_mix(cell.mix, lengths=(8, 12), new_tokens=5))
    assert ctx.model_cls is OwnPrefill
    window = runner.measure(ctx, 0.0)
    stretch = trace.traced_stretch(ctx, len(window.batches))
    runner.close_session(ctx)
    assert all(b.t_start < b.t_first < b.t_end for b in window.batches)
    assert {"prefill", "decode_step"} <= set(stretch["range_device_s"])
    # the patches are undone, the inherited decode_step unshadowed
    assert TransformerLM.prefill is prefill and "decode_step" not in vars(OwnPrefill)
