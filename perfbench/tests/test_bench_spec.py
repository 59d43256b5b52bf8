"""The harness finds cells, mixes, limits and metric readers by the
names in BENCHMARK.json: a cell is added by adding files and entries."""

import json
import shutil

from pbench import spec

#: what every kind module provides (``moe_call`` too where its sizes have experts)
KIND = ("shapes", "param_layout", "program_fields", "linear_flops_per_token", "head_flops",
        "causal_attention_flops", "decode_attention_flops", "small_config", "served_logits")


def test_every_cell_resolves_its_files_and_readers():
    """Every cell of BENCHMARK.json resolves its files, its readers and its kind."""
    bench = spec.load_benchmark()
    assert bench["workloads"]
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.chips in (1, 4) and cell.limits
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "gen_tokens_per_s"}
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        kind = spec.reference(cell.config)
        assert all(callable(getattr(kind, f)) for f in KIND), w["name"]
        s = kind.shapes(cell.config)
        assert spec.kind_of(s) is kind and s.vocab > 0
        if getattr(s, "experts", 0):
            assert s.top_k > 0 and callable(kind.moe_call)


def test_a_metric_with_workloads_is_reported_only_there():
    dense, moe = (spec.cell(n) for n in ("deepseek-7b.prefill-long",
                                         "qwen3-moe-30b-a3b.decode-batch"))
    assert "tpot_p95_ms" not in {m["name"] for m in dense.end_to_end}
    assert "tpot_p95_ms" in {m["name"] for m in moe.end_to_end}
    assert "moe_roofline" in {m["name"] for m in moe.per_layer}
    assert "moe_roofline" not in {m["name"] for m in dense.per_layer}


def test_adding_files_and_entries_adds_a_cell(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    mix = json.loads((tmp_path / "perfbench/traffic/prefill-long.json").read_text())
    (tmp_path / "perfbench/traffic/short-chat.json").write_text(
        json.dumps(dict(mix, prompt_lengths=[256], new_tokens=64)))
    (tmp_path / "perfbench/metrics/tokens_served.py").write_text(
        "def read(rec):\n    return 7.0\n")
    bench["workloads"].append({"name": "deepseek-7b.short-chat", "config": "deepseek-7b",
                               "traffic": "short-chat", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "tokens_served", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "serve loop",
                               "moves": "gen_tokens_per_s",
                               "workloads": ["deepseek-7b.short-chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("deepseek-7b.short-chat", tmp_path)
    assert cell.mix["prompt_lengths"] == [256] and cell.config_name == "deepseek-7b"
    assert [m["name"] for m in cell.per_layer][-1] == "tokens_served"
    assert spec.metric_reader("tokens_served", tmp_path)({}) == 7.0
