"""The port's first slice as a whole, on the CPU.

``repro_torch.bench.table3`` runs the paper's online auto-tuning loop
(Table 3) at a tiny size with ``device="cpu"``: its rows carry the JAX
rows' keys, the tuned output matches the JAX oracle on the same numpy
inputs (euclid rtol 1e-3, atol 1e-3; lintra rtol 1e-5, atol 1e-5), and
the tuner explores. The package and ``chip_smoke.py`` import neither JAX
nor the JAX package, and nothing runs on the CPU unless asked to.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.euclid.ref import euclid_ref as jax_euclid_ref
from repro.kernels.lintra.ref import lintra_ref as jax_lintra_ref

from repro_torch.bench import table3

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _jax_row_keys() -> set[str]:
    """The keys of the rows ``benchmarks/table3_exec_times.py`` returns."""
    tree = ast.parse((ROOT / "benchmarks" / "table3_exec_times.py").read_text())
    keys = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name.startswith("bench_"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
                    keys |= {k.value for k in node.value.keys
                             if isinstance(k, ast.Constant)}
    return keys


def test_euclid_row_matches_jax_oracle():
    n, m, d = 256, 64, 32
    row = table3.bench_euclid("tiny", n, d, m_centers=m, calls=24,
                              max_points=4, device="cpu")
    assert _jax_row_keys() <= set(row)
    assert {"bench", "input", "Ref_s", "OAT_s", "_stats"} <= _jax_row_keys()
    assert row["explored"] >= 1 and row["ok"]
    xn, cn = table3.euclid_inputs(n, m, d, seed=0)
    np.testing.assert_allclose(row["_out"].numpy(),
                               np.asarray(jax_euclid_ref(xn, cn)),
                               rtol=1e-3, atol=1e-3)
    assert row["oat_launches"] == 0          # the CPU runs no kernel


def test_lintra_row_matches_jax_oracle():
    h, w = 48, 40
    row = table3.bench_lintra("tiny", (h, w), calls=24, max_points=4,
                              device="cpu")
    assert _jax_row_keys() <= set(row)
    assert row["explored"] >= 1 and row["ok"]
    img, a, b = table3.lintra_inputs(h, w, table3.BANDS, seed=0)
    np.testing.assert_allclose(row["_out"].numpy(),
                               np.asarray(jax_lintra_ref(img, a, b)),
                               rtol=1e-5, atol=1e-5)


def test_every_input_has_a_fixed_call_count():
    assert set(table3.CALLS) == set(table3.EUCLID_SIZES) | set(table3.LINTRA_SIZES)
    assert min(table3.CALLS.values()) >= table3.DEFAULT_CALLS


def _round_to_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits, as tensor cores read it."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_euclid_check_refuses_a_tf32_product():
    """The Table 3 limit passes fp32 formulations and fails a product on
    TF32-rounded inputs, the precision loss it exists to catch."""
    xn, cn = table3.euclid_inputs(512, 256, 128, seed=0)
    x, c = torch.from_numpy(xn), torch.from_numpy(cn)
    want = torch.tensor(np.asarray(jax_euclid_ref(xn, cn)))
    fp32 = (x * x).sum(1, keepdim=True) + (c * c).sum(1) - 2.0 * (x @ c.T)
    tf32 = ((x * x).sum(1, keepdim=True) + (c * c).sum(1)
            - 2.0 * (_round_to_tf32(x) @ _round_to_tf32(c).T))
    assert table3._check(fp32, want, table3.EUCLID_TOL)[1]
    assert not table3._check(tf32, want, table3.EUCLID_TOL)[1]


def test_cold_triton_cache_restores_the_environment(monkeypatch, tmp_path):
    from repro_torch.kernels.lintra import lintra as lintra_mod

    monkeypatch.setattr(lintra_mod, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("TRITON_CACHE_DIR", "before")
    with lintra_mod.cold_triton_cache() as cache:
        assert os.environ["TRITON_CACHE_DIR"] == str(cache)
        assert cache.parent == tmp_path / "triton-cache" and not any(cache.iterdir())
    assert os.environ["TRITON_CACHE_DIR"] == "before" and not cache.exists()
    monkeypatch.delenv("TRITON_CACHE_DIR")
    with lintra_mod.cold_triton_cache():
        pass
    assert "TRITON_CACHE_DIR" not in os.environ


def test_table_and_public_rows():
    row = table3.bench_lintra("tiny", (16, 12), calls=8, max_points=2,
                              device="cpu")
    text = table3.table([row], table3.COLS, "t")
    assert text.splitlines()[0] == "== t ==" and "lintra" in text
    assert "_out" not in table3.public(row) and "_stats" in table3.public(row)


@pytest.mark.parametrize("entry", ["bench_euclid", "bench_lintra", "run"])
def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"bench_euclid": ("tiny", 64, 16), "bench_lintra": ("tiny", (8, 8)),
            "run": ()}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(table3, entry)(*args)


def test_interop_needs_an_explicit_cpu(monkeypatch):
    from repro_torch.interop import resolve_device, to_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        to_torch(np.zeros(3, np.float32))
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert to_torch(np.zeros(3, np.float32), "cpu").device.type == "cpu"


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "examples").glob("torch_*.py"))
                         + sorted((ROOT / "benchmarks").glob("torch_*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    """Nor, for the port's scripts, the reference scripts' helpers
    (``benchmarks/common.py``)."""
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "common"), f"{path} imports {mod}"
        assert mod != "benchmarks.common", f"{path} imports {mod}"


def test_importing_the_bench_leaves_jax_out():
    code = ("import sys, repro_torch.bench.table3, repro_torch.kernels.catalog;"
            "repro_torch.kernels.catalog.get_catalog();"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'));"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr


def test_importing_the_model_families_leaves_jax_out():
    """Building every family (dense, moe, vlm, encdec, rwkv, hybrid), and
    the serve loop and CLI, imports nothing of JAX or the JAX package."""
    code = ("import sys, repro_torch.launch.serve, repro_torch.runtime.serve_loop;"
            "from repro_torch.configs import get_config;"
            "from repro_torch.models.model import build_model;"
            "[build_model(get_config(a).reduced()) for a in ('deepseek-7b',"
            " 'qwen3-moe-30b-a3b', 'llama4-scout-17b-a16e', 'qwen2-vl-7b', 'whisper-tiny',"
            " 'rwkv6-1.6b', 'hymba-1.5b')];"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'));"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory, or without CUDA, it exits non-zero and prints
    no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    hidden = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}   # no card, anywhere
    for script in (lone, ROOT / "chip_smoke.py"):
        res = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, timeout=120, cwd=script.parent,
                             env=hidden)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
