"""The paper's IO-vs-OOO study on the 11 simulated device profiles.

    python examples/torch_simulated_cores.py

The port's counterpart of ``examples/simulated_cores.py``: it runs
``benchmarks/torch_fig5_simulated_cores.py``, a simulated run that makes
no tensor and needs no card.

Shows per-profile best tuning points adapting to the hardware (lean cores
want deeper unrolling + DMA lookahead; fat cores rely on hardware
scheduling), and whether online tuning on lean cores can match static
code on fat cores (paper Fig. 6).
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks.torch_fig5_simulated_cores import run

if __name__ == "__main__":
    run()
