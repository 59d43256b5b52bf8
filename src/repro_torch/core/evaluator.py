"""Kernel evaluation (paper §3.4).

Two evaluation modes:

  * ``real``      — time the variant on real input data (useful work is
                    performed during evaluation, measurements are noisier);
                    score = arithmetic mean of ``runs`` measurements.
  * ``training``  — time the variant on a training input with warmed
                    caches; score = the paper's robust filter: **the worst
                    value among the 3 best values of groups of 5
                    measurements** — filters oscillations from hardware
                    (pipeline/cache/counter fluctuations) and software
                    (interruptions).

Calls on CUDA tensors are timed on the device with CUDA events, so
asynchronous launches cannot fake speedups; ``eval_time_s`` stays host
wall time, because it is overhead the application pays.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import torch


def _cuda_device(values: Sequence[Any]) -> torch.device | None:
    """The device of the first CUDA tensor in ``values`` (None: no CUDA)."""
    for v in values:
        if isinstance(v, torch.Tensor) and v.is_cuda:
            return v.device
        if isinstance(v, (tuple, list)):
            dev = _cuda_device(v)
            if dev is not None:
                return dev
    return None


def block_until_ready(x: Any) -> None:
    """Wait until the device has finished producing ``x``.

    A CUDA result synchronizes its device, and a fault raised by the
    kernel surfaces here: nothing is caught. Plain Python and CPU
    tensors are already complete.
    """
    dev = _cuda_device((x,))
    if dev is not None:
        torch.cuda.synchronize(dev)


def time_once(fn: Callable[..., Any], args: Sequence[Any]) -> float:
    """Seconds one call of ``fn`` takes.

    Calls on CUDA tensors are timed on the device with CUDA events (the
    host clock around an asynchronous launch would time the enqueue);
    everything else is timed on the host clock.
    """
    dev = _cuda_device(args)
    if dev is None:
        t0 = time.perf_counter()
        out = fn(*args)
        block_until_ready(out)
        return time.perf_counter() - t0
    stream = torch.cuda.current_stream(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    fn(*args)
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def filtered_training_time(
    fn: Callable[..., Any],
    args: Sequence[Any],
    *,
    groups: int = 3,
    group_size: int = 5,
    warmup: int = 1,
) -> float:
    """Paper's filter: worst of the ``groups`` best values of groups of
    ``group_size`` measurements."""
    for _ in range(warmup):
        time_once(fn, args)
    best_of_groups = []
    for _ in range(groups):
        samples = [time_once(fn, args) for _ in range(group_size)]
        best_of_groups.append(min(samples))
    return max(best_of_groups)


def mean_real_time(
    fn: Callable[..., Any],
    args: Sequence[Any],
    *,
    runs: int = 5,
    warmup: int = 1,
) -> float:
    for _ in range(warmup):
        time_once(fn, args)
    return sum(time_once(fn, args) for _ in range(runs)) / runs


@dataclasses.dataclass
class Measurement:
    score_s: float          # lower is better (execution time)
    n_runs: int
    mode: str               # "real" | "training" | "simulated"
    eval_time_s: float      # wall time spent evaluating (overhead accounting)


class Evaluator:
    """Scores generated kernels; the auto-tuner compares ``score_s``."""

    def __init__(
        self,
        *,
        mode: str = "training",
        groups: int = 3,
        group_size: int = 5,
        real_runs: int = 5,
        warmup: int = 1,
        make_args: Callable[[], Sequence[Any]] | None = None,
    ) -> None:
        if mode not in ("real", "training"):
            raise ValueError(f"unknown evaluation mode {mode!r}")
        self.mode = mode
        self.groups = groups
        self.group_size = group_size
        self.real_runs = real_runs
        self.warmup = warmup
        self.make_args = make_args

    def n_runs(self) -> int:
        if self.mode == "training":
            return self.groups * self.group_size + self.warmup
        return self.real_runs + self.warmup

    def evaluate(self, fn: Callable[..., Any], args: Sequence[Any] | None = None) -> Measurement:
        if args is None:
            if self.make_args is None:
                raise ValueError("no args supplied and no make_args factory")
            args = self.make_args()
        t0 = time.perf_counter()
        if self.mode == "training":
            score = filtered_training_time(
                fn, args, groups=self.groups, group_size=self.group_size, warmup=self.warmup
            )
        else:
            score = mean_real_time(fn, args, runs=self.real_runs, warmup=self.warmup)
        eval_time = time.perf_counter() - t0
        return Measurement(score_s=score, n_runs=self.n_runs(), mode=self.mode, eval_time_s=eval_time)


class VirtualClock:
    """Injectable simulated time source.

    A ``VirtualClock`` instance is callable (drop-in for
    ``time.perf_counter``) and only moves when something calls
    ``advance``. Injected into ``OnlineAutotuner``/``TuningCoordinator``
    (their ``clock`` parameter) it makes the whole tuning control loop —
    budget decisions, overhead accounting, time-to-best — a deterministic
    function of the simulated costs, so tests and benchmarks never sleep
    and never flake on a loaded host.
    """

    def __init__(self, start_s: float = 0.0) -> None:
        self._now = float(start_s)

    def __call__(self) -> float:
        return self._now

    def advance(self, dt_s: float) -> float:
        if dt_s < 0:
            raise ValueError(f"cannot advance a clock backwards ({dt_s})")
        self._now += float(dt_s)
        return self._now


def virtual_kernel(clock: VirtualClock, cost_s: float, tag: Any = None):
    """A fake kernel whose 'execution' advances ``clock`` by ``cost_s``.

    The cost is attached as ``fn.score_s`` so ``VirtualClockEvaluator``
    can read it back without re-running anything.
    """

    def fn(*args: Any) -> Any:
        clock.advance(cost_s)
        return args[0] if args else None

    fn.score_s = float(cost_s)  # type: ignore[attr-defined]
    fn.tag = tag                # type: ignore[attr-defined]
    return fn


def virtual_compilette(clock: VirtualClock, name: str, space, cost_fn,
                       *, gen_cost_s: float = 0.0):
    """A compilette over virtual kernels with a SIMULATED compile cost.

    ``cost_fn(point) -> seconds`` prices execution; ``gen_cost_s`` prices
    generation. The compile cost is *declared* (``Compilette.gen_cost_s``)
    rather than burned inside the generator, so the party that decides
    stall-vs-overlap charges it correctly: a synchronous ``wake()``
    advances the virtual clock by it (the hot path stalls, exactly like a
    real inline kernel compile), while the async pipeline and cache hits
    charge it to the budget without moving the clock — which is the
    whole point of double-buffered generation, and what the no-sleep
    tests in ``tests/test_generation_pipeline.py`` assert.
    """
    from repro_torch.core.compilette import Compilette

    def gen(point, **spec):
        return virtual_kernel(clock, cost_fn(point), tag=dict(point))

    return Compilette(name, space, gen, gen_cost_s=gen_cost_s)


class VirtualClockEvaluator:
    """Deterministic evaluator driven by simulated time (no wall clock).

    ``evaluate`` reads the variant's cost instead of timing it — either
    via ``score_fn(fn)`` or, by default, from the ``score_s`` attribute
    that ``virtual_kernel`` attaches — then charges a fixed simulated
    measurement cost (``runs`` x score + ``fixed_eval_cost_s``) to the
    injected ``VirtualClock``. Budget/overhead accounting in the
    auto-tuner therefore behaves exactly as with a real evaluator, but
    bit-reproducibly.
    """

    def __init__(
        self,
        clock: VirtualClock,
        *,
        score_fn: Callable[[Callable[..., Any]], float] | None = None,
        runs: int = 1,
        fixed_eval_cost_s: float = 0.0,
    ) -> None:
        self.clock = clock
        self.score_fn = score_fn
        self.runs = max(int(runs), 1)
        self.fixed_eval_cost_s = float(fixed_eval_cost_s)
        self.mode = "virtual"

    def n_runs(self) -> int:
        return self.runs

    def evaluate(
        self, fn: Callable[..., Any], args: Sequence[Any] | None = None
    ) -> Measurement:
        if self.score_fn is not None:
            score = float(self.score_fn(fn))
        else:
            score = float(getattr(fn, "score_s"))
        eval_cost = self.runs * score + self.fixed_eval_cost_s
        self.clock.advance(eval_cost)
        return Measurement(
            score_s=score, n_runs=self.runs, mode="virtual",
            eval_time_s=eval_cost,
        )


class SimulatedEvaluator:
    """Evaluator against an analytical device profile (paper's gem5 analogue).

    ``evaluate`` consults the compilette cost model instead of running code.
    Evaluation wall-time is ~0; the simulated score drives replacement
    decisions exactly like a real measurement.
    """

    def __init__(self, compilette, profile, **specialization: Any) -> None:
        self.compilette = compilette
        self.profile = profile
        self.specialization = specialization
        self.mode = "simulated"

    def evaluate_point(self, point) -> Measurement:
        t0 = time.perf_counter()
        score = self.compilette.simulate(point, self.profile, **self.specialization)
        return Measurement(
            score_s=score, n_runs=1, mode="simulated", eval_time_s=time.perf_counter() - t0
        )
