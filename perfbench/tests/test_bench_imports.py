"""No module the harness loads is ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` (whole top-level names: ``repro_torch`` is the port),
and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

from pbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax():
    for path in spec.BENCH_DIR.rglob("*.py"):
        assert not FORBIDDEN & set(imported_names(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        assert "repro_torch" not in set(imported_names(path)), path


RUN = """
import json, sys, time
sys.path[:0] = [{bench!r}, {src!r}, {tests!r}]
from pbench import spec
from pbench.cellrun import run_cell, forbidden_modules
from small import small_config, small_mix
for name in {cells!r}:
    cell = spec.cell(name)
    run_cell(cell, 3, 0.0, True, "cpu", time.perf_counter(), conf=small_config(cell.config),
             mix_spec=small_mix(cell.mix, lengths=(8,)), limits={{}})
print(json.dumps([forbidden_modules(), sorted({{m.split(".")[0] for m in sys.modules}})]))
"""


def test_a_run_loads_no_jax_module():
    code = RUN.format(bench=str(spec.BENCH_DIR), src=str(spec.ROOT / "src"),
                      tests=str(spec.BENCH_DIR / "tests"),
                      cells=[w["name"] for w in spec.load_benchmark()["workloads"]])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    found, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == [] and not FORBIDDEN & set(loaded)
    assert "repro_torch" in loaded
