"""On the card, at each cell's own size: the control (the reference in
float8 products, the step below the configuration's bfloat16) fails the
cell's limit on three seeds, and the program's own readings pass it.
Run with ``python -m pytest -q perfbench/tests -m card`` on an H100
(about 2 minutes a seed and cell)."""

import pytest

import calibrate
from pbench import spec

#: every cell of BENCHMARK.json
CELLS = tuple(w["name"] for w in spec.load_benchmark()["workloads"])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limit_and_the_program_passes(card, name):
    limits = spec.cell(name).limits
    for r in calibrate.readings(name, [4_100_000_001, 4_100_000_002, 4_100_000_003], card,
                                log=lambda line: None):
        assert any(r["fp8_" + n] > lim["limit"] for n, lim in limits.items()), r
        assert all(r[n] <= lim["limit"] for n, lim in limits.items()), r
