"""Benchmarks of the port: the paper's tables on a CUDA card, and the
deterministic workload layer (traffic replay).

Mirrors ``repro/bench/__init__.py``. ``repro_torch.bench.table3`` is
Table 3 on the card; ``repro_torch.bench.replay`` synthesizes seeded, virtual-clock traffic traces
(Poisson/bursty arrivals, long-tail prompt and cache-length mixes, ramp
and phase-change patterns, multi-tenant interleaving) and re-serves them
through a :class:`repro_torch.api.TuningSession` — the repo's fleet-scale
analogue of the paper's fig7 workload study.
"""

from repro_torch.bench.replay import (
    Request,
    Scenario,
    Trace,
    bursty_arrivals,
    choice_mix,
    fixed_mix,
    fleet_scenarios,
    longtail_mix,
    make_trace,
    merge_traces,
    phase_arrivals,
    phase_mix,
    poisson_arrivals,
    ramp_arrivals,
    reference_request_cost_s,
    replay,
    replay_scenario,
    replay_session,
    replay_tuning_defaults,
)

__all__ = [
    "Request",
    "Scenario",
    "Trace",
    "bursty_arrivals",
    "choice_mix",
    "fixed_mix",
    "fleet_scenarios",
    "longtail_mix",
    "make_trace",
    "merge_traces",
    "phase_arrivals",
    "phase_mix",
    "poisson_arrivals",
    "ramp_arrivals",
    "reference_request_cost_s",
    "replay",
    "replay_scenario",
    "replay_session",
    "replay_tuning_defaults",
]
