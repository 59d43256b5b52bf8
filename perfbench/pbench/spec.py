"""Cells, configurations, traffic mixes, limits and metric readers,
found by the names in ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix.
Each lives in a file of its own:

* the configuration: the ``file`` of its ``configs`` entry
  (``perfbench/configs/<config>.json``), which names its kind of block,
  ``perfbench/reference/<reference>.py``: the one module that knows the
  kind (its sizes, weights' layout, the port's config fields, the
  yardstick's counts, the kernel families set-up builds, a tiny CPU
  stand-in and the plain reference);
* the traffic mix: ``perfbench/traffic/<traffic>.json``;
* the limits of the comparison that decides ``correct``:
  ``perfbench/limits/<cell>.json``;
* each metric, end-to-end or per-layer: a reader
  ``perfbench/metrics/<metric>.py`` with ``read(rec) -> float | None``.

So a cell, a mix, a metric or a kind of block is added by adding files
and entries; no file here names one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Callable

#: the checkout's root: ``perfbench/pbench/spec.py`` -> two levels up
ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "perfbench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict            # the configuration as it is run
    mix: dict               # the traffic mix's parameters
    limits: dict            # number compared -> {"limit": ..., ...}
    end_to_end: list[dict]  # BENCHMARK.json entries reported with --trace 0
    per_layer: list[dict]   # ... and with --trace 1


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reported_in(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files read."""
    bench = load_benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {known}")
    w = found[0]
    conf_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    limits_file = root / "perfbench" / "limits" / f"{name}.json"
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=w["config"], traffic_name=w["traffic"],
        config=json.loads((root / conf_entry["file"]).read_text()),
        mix=json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=(json.loads(limits_file.read_text()) if limits_file.exists() else {}),
        end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported_in(m, name)],
    )


def load_file_module(path: Path, prefix: str) -> Any:
    """Import the Python file ``path`` once, under a private module name
    registered in ``sys.modules`` (so that :func:`kind_of` finds a kind's
    module from its sizes, and its dataclasses resolve); the same file
    of two checkouts gets two names."""
    path = Path(path).resolve()
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:12]
    mod_name = f"perfbench_{prefix}_{path.stem}_{tag}".replace("-", "_").replace(".", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable[[dict], "float | None"]:
    """``perfbench/metrics/<name>.py``'s ``read``."""
    return load_file_module(root / "perfbench" / "metrics" / f"{name}.py", "metric").read


def reference(config: dict, root: Path = ROOT) -> Any:
    """The configuration's kind of block: the module
    ``perfbench/reference/<reference>.py``."""
    return load_file_module(
        root / "perfbench" / "reference" / f"{config['reference']}.py", "reference")


def kind_of(shapes: Any) -> Any:
    """The kind module whose ``shapes`` made ``shapes``."""
    return sys.modules[type(shapes).__module__]
