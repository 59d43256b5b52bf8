"""Shared benchmark utilities of the port's scripts (``torch_*.py``).

Mirrors ``benchmarks/common.py``; an artifact is written as
``bench_artifacts/torch_<name>.json``, so a port script never overwrites
the reference script's artifact of the same name.
"""

from __future__ import annotations

import json
import os

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "bench_artifacts")


def artifact_path(name: str) -> str:
    return os.path.join(ARTIFACT_DIR, f"torch_{name}.json")


def save(name: str, payload) -> None:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    with open(artifact_path(name), "w") as f:
        json.dump(payload, f, indent=1, default=str)


def table(rows: list[dict], cols: list[str], title: str = "") -> str:
    if title:
        out = [f"== {title} =="]
    else:
        out = []
    widths = {c: max(len(c), *(len(_fmt(r.get(c))) for r in rows)) for c in cols}
    out.append("  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        out.append("  ".join(_fmt(r.get(c)).ljust(widths[c]) for c in cols))
    return "\n".join(out)


def _fmt(v) -> str:
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1000 or abs(v) < 0.001:
            return f"{v:.3e}"
        return f"{v:.4g}"
    return str(v)
