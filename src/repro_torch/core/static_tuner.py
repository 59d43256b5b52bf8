"""Static (offline) auto-tuning baseline — the paper's BS-AT columns.

Exhaustively explores the tuning space (optionally restricted to
leftover-free variants, as the paper does for Streamcluster to bound
exploration time) and returns the best point. Used to quantify how close
the *online* tuner lands to the statically found optimum (paper: within
~6 % on average).
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.core.compilette import Compilette
from repro_torch.core.evaluator import Evaluator
from repro_torch.core.tuning_space import Point


def static_autotune(
    compilette: Compilette,
    evaluator: Evaluator,
    *,
    specialization: dict[str, Any] | None = None,
    only_no_leftover: bool = False,
    max_points: int | None = None,
    score_fn: Callable[[Point], float] | None = None,
    strategy: str | None = None,
) -> tuple[Point | None, float, list[tuple[Point, float]]]:
    """Returns (best_point, best_score_s, full history).

    With ``strategy`` (a name from the :mod:`repro_torch.core.explorer`
    registry) the exploration order is delegated to that strategy instead
    of the exhaustive scan; ``only_no_leftover`` applies only to the
    exhaustive scan.
    """
    from repro_torch.core.explorer import _leftover_rank, make_strategy

    specialization = dict(specialization or {})

    def measure(point: Point) -> float:
        if score_fn is not None:
            return score_fn(point)
        kern = compilette.generate(point, **specialization)
        return evaluator.evaluate(kern.fn).score_s

    if strategy is not None:
        strat = make_strategy(strategy, compilette.space)
        best_point, best_score = strat.run_to_completion(
            measure, max_points=max_points)
        return best_point, best_score, list(strat.history)

    history: list[tuple[Point, float]] = []
    best_point: Point | None = None
    best_score = float("inf")
    n = 0
    for point in compilette.space.iter_valid():
        # no_leftover may return a bool or a numeric waste fraction
        # (0 = leftover-free)
        if only_no_leftover and _leftover_rank(compilette.space, point) > 0:
            continue
        if max_points is not None and n >= max_points:
            break
        n += 1
        score = measure(point)
        history.append((dict(point), score))
        if score < best_score:
            best_score = score
            best_point = dict(point)
    return best_point, best_score, history
