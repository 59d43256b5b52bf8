"""Tuning-space formalization (paper §3.2).

The tuning space is a discrete space with ``Nc_par`` dimensions, one per
auto-tuned parameter. Each point is a candidate code variant. The space has
*holes*: points where code generation is impossible on the target
micro-architecture (paper Fig. 1 "empty results"); holes are expressed by a
``validator`` predicate supplied by the compilette.

Phases (paper §3.3):
  phase 1 — *structural* parameters (unrolling factors, vector length,
            vectorization): they change the shape of the generated code.
  phase 2 — remaining codegen options (instruction scheduling, stack
            minimization, prefetch stride): explored combinatorially after
            phase-1 winners are frozen.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Iterator, Mapping, Sequence

Point = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Param:
    """One auto-tuned parameter (one dimension of the tuning space).

    ``phase`` assigns it to the two-phase exploration; ``switch_rank``
    orders phase-1 parameters from least-switched (0) to most-switched,
    reproducing the paper's exploration order (hotUF, coldUF, vectLen, VE).
    """

    name: str
    values: tuple[Any, ...]
    phase: int = 1
    switch_rank: int = 0

    def __post_init__(self) -> None:
        if self.phase not in (1, 2):
            raise ValueError(f"phase must be 1 or 2, got {self.phase}")
        if not self.values:
            raise ValueError(f"parameter {self.name!r} has no values")

    @property
    def range_size(self) -> int:
        """RangeSize(Nc_i) in the paper's Eq. (1)."""
        return len(self.values)


@dataclasses.dataclass(frozen=True)
class TuningSpace:
    """Discrete tuning space with validity holes."""

    params: tuple[Param, ...]
    # validator(point) -> True when the variant can be generated on the
    # target (the space's holes are the False region).
    validator: Callable[[Point], bool] = lambda point: True
    # no_leftover(point) -> True when the variant covers the iteration space
    # exactly (paper §3.3 explores leftover-free variants first).
    no_leftover: Callable[[Point], bool] = lambda point: True

    def __post_init__(self) -> None:
        names = [p.name for p in self.params]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate parameter names: {names}")

    # ------------------------------------------------------------------ size
    @property
    def n_code_variants(self) -> int:
        """Eq. (1): N_codeVariants = prod RangeSize(Nc_i). Includes holes."""
        return math.prod(p.range_size for p in self.params)

    def n_valid_variants(self) -> int:
        return sum(1 for _ in self.iter_valid())

    # ------------------------------------------------------------ accessors
    def param(self, name: str) -> Param:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(name)

    @property
    def phase1_params(self) -> tuple[Param, ...]:
        """Phase-1 params ordered least-switched -> most-switched."""
        ps = [p for p in self.params if p.phase == 1]
        return tuple(sorted(ps, key=lambda p: p.switch_rank))

    @property
    def phase2_params(self) -> tuple[Param, ...]:
        return tuple(p for p in self.params if p.phase == 2)

    def default_point(self) -> Point:
        return {p.name: p.values[0] for p in self.params}

    # ------------------------------------------------------------ iteration
    def iter_all(self) -> Iterator[Point]:
        names = [p.name for p in self.params]
        for combo in itertools.product(*(p.values for p in self.params)):
            yield dict(zip(names, combo))

    def iter_valid(self) -> Iterator[Point]:
        for point in self.iter_all():
            if self.validator(point):
                yield point

    def is_valid(self, point: Point) -> bool:
        return self.validator(dict(point))

    def contains(self, point: Mapping[str, Any]) -> bool:
        try:
            return all(point[p.name] in p.values for p in self.params)
        except KeyError:
            return False

    # Phase-1 sub-space iteration: vary phase-1 params, keep phase-2 fixed.
    def iter_phase1(self, base: Point) -> Iterator[Point]:
        """All phase-1 variations of ``base``.

        Order follows the paper: parameters are explored from the least
        switched to the most switched, i.e. the *first* phase-1 parameter
        changes most slowly.
        """
        p1 = self.phase1_params
        for combo in itertools.product(*(p.values for p in p1)):
            point = dict(base)
            point.update(dict(zip((p.name for p in p1), combo)))
            yield point

    def iter_phase2(self, base: Point) -> Iterator[Point]:
        """All phase-2 variations of ``base`` (combinatorial, paper §3.3)."""
        p2 = self.phase2_params
        for combo in itertools.product(*(p.values for p in p2)):
            point = dict(base)
            point.update(dict(zip((p.name for p in p2), combo)))
            yield point

    def key(self, point: Point) -> tuple:
        """Canonical hashable identity of a point."""
        return tuple(point[p.name] for p in self.params)


def product_space(params: Sequence[Param], **kwargs) -> TuningSpace:
    return TuningSpace(params=tuple(params), **kwargs)


def clamped_options(options: Sequence[int], bound: int) -> tuple[int, ...]:
    """Deduplicate integer options past ``bound``.

    Chunk/tile sizes larger than the problem extent all compile to the
    same program, so a space built from raw option lists would contain
    duplicate variants — and re-measuring duplicates wastes the shared
    regeneration budget. Used by the serve/train compilettes to bound
    chunk options by the (bucketed) sequence length.
    """
    return tuple(sorted({min(int(v), int(bound)) for v in options}))
