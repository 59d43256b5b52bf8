"""The benchmark's own code: cells from ``BENCHMARK.json``, traffic,
weights, the measured window, the trace's reduction, the yardstick's
arithmetic and the comparison that decides ``correct``.

Nothing here imports ``jax`` or the JAX package ``repro``; the PyTorch
port ``repro_torch`` is imported only where the system under test is
driven or wrapped (:mod:`pbench.runner`, :mod:`pbench.model`,
:mod:`pbench.trace`), never by the reference.
"""
