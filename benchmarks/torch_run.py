"""Benchmark driver of the port: one harness per paper table/figure.

The port's copy of ``benchmarks/run.py``, in the reference's order:

    PYTHONPATH=src:. python -m benchmarks.torch_run [--quick] [--device cpu]

Table 3 and Table 4 run the online auto-tuner on the card (the plain
PyTorch versions with ``--device cpu``); the simulated-core studies
(Fig. 1, Fig. 5, Table 5) and Fig. 7 run on the virtual clock; the
roofline harness aggregates the port's dry-run artifacts.
"""

from __future__ import annotations

import sys
import time


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    quick = "--quick" in argv
    device = argv[argv.index("--device") + 1] if "--device" in argv else None
    t0 = time.time()
    from benchmarks import (torch_fig1_motivational, torch_fig5_simulated_cores,
                            torch_fig7_varying_workload, torch_roofline,
                            torch_table4_tuning_stats, torch_table5_param_correlation)
    from repro_torch.bench import table3

    print("\n### Fig.1 — motivational static exploration\n")
    torch_fig1_motivational.run()
    print("\n### Table 3 — real-platform execution times\n")
    table3.run(quick=quick, device=device)
    print("\n### Table 4 — tuning statistics\n")
    torch_table4_tuning_stats.run(quick=quick, device=device)
    print("\n### Fig.5/6 — 11 simulated cores\n")
    torch_fig5_simulated_cores.run()
    print("\n### Fig.7 — varying workload\n")
    torch_fig7_varying_workload.run(quick=quick)
    print("\n### Table 5 — parameter/pipeline correlation\n")
    torch_table5_param_correlation.run()
    print("\n### Roofline (from the port's dry-run artifacts)\n")
    torch_roofline.run("single")
    print(f"\nall benchmarks done in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
