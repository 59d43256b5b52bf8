"""Paper Fig. 7 — online auto-tuning speedup vs workload size.

The port's copy of ``benchmarks/fig7_varying_workload.py``: the same virtual-clock run
(no tensor is made and no card is used) through ``repro_torch``, whose
JSON (``bench_artifacts/torch_fig7_varying_workload.json``) equals the reference's.

Reframed on the traffic-replay harness (`repro_torch.bench.replay`): one
steady-Poisson scenario at growing trace lengths, served by the
deepseek-7b config on the virtual cost-model backend. The all-in
speedup (every tuning and init overhead charged) shows the paper's
crossover — short runs don't amortize exploration, longer ones do —
while the kernel-time speedup vs the static reference grows toward the
tuned optimum. Deterministic: seeded traces on the VirtualClock.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, "src")
sys.path.insert(0, os.path.dirname(__file__))

from torch_common import save, table  # noqa: E402

from repro_torch.bench.replay import Scenario, fixed_mix, poisson_arrivals, \
    replay_scenario  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402

CONFIG = "deepseek-7b"


def one(n_requests: int, seed: int = 0) -> dict:
    scenario = Scenario(
        name=f"fig7_steady_{n_requests}",
        arrival=poisson_arrivals,
        prompt_mix=fixed_mix(512),
        decode_mix=fixed_mix(16),
        utilization=0.4,
        target_requests=n_requests,
    )
    rep = replay_scenario(scenario, {CONFIG: REGISTRY[CONFIG]}, seed=seed)
    pt = rep["per_tenant"][CONFIG]
    t = rep["tuning"]
    return {
        "n_requests": pt["n_requests"],
        "duration_s": rep["trace"]["duration_s"],
        "speedup_all_in": t["speedup_all_in"],
        "speedup_vs_ref": pt["speedup_vs_ref"],
        "overhead_pct": t["overhead_pct"],
        "time_to_best_s": t["time_to_best_s"],
        "swaps": t["swaps"],
        "regenerations": t["regenerations"],
    }


def run(quick: bool = False) -> dict:
    # the all-in crossover sits between ~600 and ~1300 requests: short
    # traces lose to exploration + init, the 2560-request trace wins 1.4x
    grid = [40, 320] if quick else [20, 80, 320, 1280, 2560]
    rows = [one(n) for n in grid]
    print(table(rows, list(rows[0].keys()),
                "Fig.7 — speedup vs workload (all overheads included)"))
    save("fig7_varying_workload", rows)
    return {"rows": rows}


if __name__ == "__main__":
    run(quick="--quick" in sys.argv)
