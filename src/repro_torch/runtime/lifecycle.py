"""Serving-grade tuner lifecycle: bucketing, convergence, eviction.

Mirrors ``repro/runtime/lifecycle.py``, unchanged.

``TuningCoordinator.register`` is idempotent per (kernel, specialization),
which is what lets tuning pay off across requests — but real serve traffic
has unbounded shape diversity: one tuner per exact (seq, batch) pair
accumulates tuners (and the request arrays their evaluator closures pin)
without bound. The :class:`TunerLifecycle` bounds both dimensions:

  * **power-of-two sequence bucketing** — shape-like specialization keys
    (``seq``, ``max_len``) are rounded to the nearest power of two *in log
    space* (geometric rounding), so prompts of length 120 and 150 share
    the 128-bucket tuner instead of each spawning their own;
  * **convergence** — a tuner whose search strategy has exhausted its
    space moves to ``CONVERGED``: it keeps serving its tuned active
    function, but its evaluator closure (which pins a request's
    params/batch/cache arrays) is released since nothing will be
    evaluated again;
  * **idle eviction** — a tuner not called for ``idle_evict_s`` simulated
    seconds is ``RETIRED``: its best point is flushed to the registry,
    its evaluator closure is released, and it is unregistered from the
    coordinator (its spent/gained accounting is folded into a tombstone
    so the process-wide budget does not inflate when tuners leave).

A retired specialization that comes back simply re-registers; the registry
warm-start re-validates its persisted best with a single regeneration —
and because the coordinator's :class:`~repro_torch.core.GenerationCache` is
owned by the *coordinator*, not the tuner, retirement releases closures
and accounting but NOT compiled variants: the re-registered bucket's
re-validation (and any re-exploration) is a cache hit, never a recompile.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any


class TunerState(enum.Enum):
    ACTIVE = "active"         # exploring (or waiting for budget)
    CONVERGED = "converged"   # space exhausted; still serving its best fn
    RETIRED = "retired"       # evicted: unregistered, closures released


def pow2_bucket(n: int) -> int:
    """Nearest power of two in log space (geometric rounding).

    120 → 128 and 150 → 128 (the midpoint between 128 and 256 is
    sqrt(128*256) ≈ 181), so nearby prompt shapes share one bucket.
    """
    n = int(n)
    if n <= 1:
        return 1
    lo = 1 << (n.bit_length() - 1)
    hi = lo << 1
    # n <= sqrt(lo*hi)  <=>  n*n <= lo*hi  (exact in integers)
    return lo if n * n <= lo * hi else hi


@dataclasses.dataclass
class TunerLifecycle:
    """Policy knobs for the coordinator's managed-tuner lifecycle.

    ``bucket_keys`` names the shape-like specialization keys to bucket;
    ``idle_evict_s`` is the idle time (coordinator-clock seconds) after
    which a tuner is retired, ``None`` disables eviction.
    """

    seq_buckets: bool = True
    bucket_keys: tuple[str, ...] = ("seq", "max_len")
    idle_evict_s: float | None = 300.0

    def bucket_specialization(self, spec: dict[str, Any]) -> dict[str, Any]:
        """Bucketed copy of ``spec`` (identity when bucketing is off)."""
        if not self.seq_buckets:
            return dict(spec)
        out = dict(spec)
        for key in self.bucket_keys:
            v = out.get(key)
            if isinstance(v, int) and not isinstance(v, bool) and v > 0:
                out[key] = pow2_bucket(v)
        return out

    def bucket_length(self, n: int) -> int:
        """Bucketed problem extent (for building bucket-wide compilettes)."""
        return pow2_bucket(n) if self.seq_buckets else int(n)

    def should_evict(self, last_used_s: float, now_s: float) -> bool:
        return (
            self.idle_evict_s is not None
            and now_s - last_used_s >= self.idle_evict_s
        )


def release_evaluator_closure(tuner: Any) -> None:
    """Drop the evaluator's pinned argument factory, if it has one.

    Serve evaluators close over a request's params/batch/cache so
    between-request pumps can measure variants; once a tuner is converged
    or retired nothing will evaluate again — holding those arrays for the
    coordinator's lifetime would be a leak. Evaluators without a
    ``make_args`` factory (e.g. ``VirtualClockEvaluator``) are untouched.
    """
    ev = getattr(tuner, "evaluator", None)
    if ev is not None and getattr(ev, "make_args", None) is not None:
        ev.make_args = None
