"""Kernel-granular tuning plane: coordinator-owned kernel handles.

Mirrors ``repro/runtime/kernel_plane.py``. The catalog's kernels here are
the hand kernels for Hopper (CUDA C++, Triton) and, on the CPU, their
plain PyTorch versions. PyTorch has no trace: where the JAX layers see
tracers inside a jitted step-program (and so never route through a
handle), the port's step-programs mark themselves with
:func:`step_program`, and :func:`in_step_program` tells the layers not
to route (see ``repro_torch/models/layers.py``).

The paper's claim is that auto-tuning pays off at the granularity of the
individual short-running kernel; the coordinator's management machinery
(shared budget, fairness, warm starts, async generation, lifecycle)
alone applies it to monolithic step-programs. The
:class:`KernelTuningPlane` closes that gap: it turns every kernel in the
:class:`~repro_torch.kernels.catalog.KernelCatalog` into an independently
managed :class:`~repro_torch.runtime.coordinator.ManagedTuner` —

  * **one handle per (kernel, spec)** — the spec (problem shape, dtype)
    is extracted from live call arguments or registered explicitly from
    model shapes; the coordinator warm-starts and idle-evicts the
    handle exactly like a step-program tuner. Kernel shape dims (M/N/K,
    Tq/Tkv, …) key EXACTLY — a compiled kernel executable only accepts
    its own shapes, so pow2 bucketing cannot alias them the way it
    aliases chunk-clamping step-programs; registration sites bound
    shape diversity by pre-bucketing the extents they derive specs from
    (serve uses ``lifecycle.bucket_length``) and idle eviction retires
    the long tail;
  * **its own strategy** — ``strategies={"matmul": "greedy", ...}`` maps
    kernel names to search-strategy registry names (cf. "Tuning the
    Tuner": the best searcher is kernel-dependent), defaulting to the
    coordinator's strategy;
  * **one shared budget** — kernel handles draw regeneration slots from
    the same :class:`~repro_torch.core.RegenerationPolicy` budget as the
    step-program tuners, so adding per-kernel tuning never multiplies
    the overhead cap;
  * **model integration** — :func:`use_kernel_plane` installs the plane
    in a context variable; ``repro_torch.models.layers`` routes eager kernel
    calls through :meth:`KernelTuningPlane.call` and, inside jitted
    step-program traces, adopts the plane's best-known kernel points
    instead of hard-coded block sizes (:meth:`best_point`).

Pass ``virtual=(VirtualClock, DeviceProfile)`` to price every kernel by
its analytical cost model instead of compiling — the deterministic
backend the tier-1 kernel-plane tests and ``benchmarks/kernel_plane.py``
drive.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
from typing import Any, Callable, Mapping

from repro_torch.core.evaluator import Evaluator
from repro_torch.kernels.catalog import KernelCatalog, KernelCompilette, get_catalog
from repro_torch.runtime import spans
from repro_torch.runtime.coordinator import ManagedTuner, TuningCoordinator
from repro_torch.runtime.lifecycle import TunerState

__all__ = [
    "KernelTuningPlane",
    "active_plane",
    "in_step_program",
    "parse_kernel_strategies",
    "step_program",
    "use_kernel_plane",
]


def _canon(spec: Mapping[str, Any]) -> str:
    return json.dumps(dict(spec), sort_keys=True, separators=(",", ":"))


def parse_kernel_strategies(items: "list[str]") -> dict[str, str] | None:
    """Parse repeated ``KERNEL=STRATEGY`` CLI items, failing fast.

    Both the kernel name (against the discovered catalog) and the
    strategy (against the search-strategy registry) are validated — a
    typo'd kernel would otherwise be silently ignored and the user would
    tune with the default strategy while believing the override is
    active. Shared by ``launch/serve.py`` and ``examples/serve_lm.py``.
    """
    from repro_torch.core.explorer import available_strategies

    out: dict[str, str] = {}
    known = get_catalog().names()
    for item in items:
        name, _, strat = item.partition("=")
        if name not in known:
            raise SystemExit(
                f"--kernel-strategy: unknown kernel {name!r}; "
                f"catalog kernels: {', '.join(known)}")
        if not strat or strat not in available_strategies():
            raise SystemExit(
                f"--kernel-strategy {item!r}: strategy must be one of "
                f"{', '.join(available_strategies())}")
        out[name] = strat
    return out or None


class KernelTuningPlane:
    """Registers catalog kernels as coordinator-managed tuners."""

    def __init__(
        self,
        coordinator: TuningCoordinator,
        *,
        catalog: KernelCatalog | None = None,
        strategies: Mapping[str, str] | None = None,
        virtual: tuple | None = None,
        gen_cost_s: "float | Callable[..., float] | None" = None,
        evaluator_factory: "Callable[[KernelCompilette], Any] | None" = None,
        eval_runs: int = 1,
        adopt_points: bool = True,
        compilette_hook: "Callable[[KernelCompilette], None] | None" = None,
    ) -> None:
        self.coordinator = coordinator
        self.catalog = catalog or get_catalog()
        self.strategies = dict(strategies or {})
        self.virtual = virtual
        self.gen_cost_s = gen_cost_s
        self.evaluator_factory = evaluator_factory
        self.eval_runs = eval_runs
        # Runs on every freshly built kernel compilette, before its first
        # generation: the fault-injection replay harness installs scripted
        # gate verdicts (``comp.gate_script``) and wrapped generators here.
        self.compilette_hook = compilette_hook
        # Trace-time adoption: jitted step-programs read best_point() for
        # their block sizes. Turned OFF when a program-level tuner owns
        # those same parameters (serve/train "both" mode), so the two
        # planes never fight over one knob.
        self.adopt_points = adopt_points
        self._handles: dict[tuple[str, str], ManagedTuner] = {}
        # last concrete call arguments per handle: evaluations then
        # measure live traffic, falling back to synthetic example args.
        # Entries are dropped once a handle converges/retires (nothing
        # will evaluate again — keeping them would pin one full set of
        # kernel inputs per shape cell for the coordinator's lifetime).
        self._live_args: dict[tuple[str, str], tuple] = {}
        # hot-path memo: (kernel, arg shapes/dtypes, overrides) → handle,
        # skipping spec extraction + canonicalization + the coordinator
        # register round-trip on every call after the first
        self._fast: dict[tuple, tuple[tuple[str, str], ManagedTuner]] = {}

    @classmethod
    def shared(cls, coordinator: TuningCoordinator,
               **kwargs: Any) -> "KernelTuningPlane":
        """The one plane of ``coordinator``, created on first use.

        A long-lived serving coordinator spans many requests; building a
        fresh plane per request would discard the handle memo and the
        live-args table every time (re-building compilettes only for the
        coordinator's idempotent register to throw them away, and
        pinning evaluators to a dead plane's live-args). Construction
        kwargs apply on first use; the *mutable* config knobs
        (``adopt_points``, ``strategies``) are re-applied on every call,
        so a request that switches tuning mode (kernel ↔ both) cannot
        leave a stale plane fighting a program tuner over one knob.
        """
        plane = getattr(coordinator, "_kernel_plane", None)
        if plane is None:
            plane = cls(coordinator, **kwargs)
            coordinator._kernel_plane = plane
        else:
            if "adopt_points" in kwargs:
                plane.adopt_points = kwargs["adopt_points"]
            if kwargs.get("strategies"):
                plane.strategies.update(kwargs["strategies"])
            if kwargs.get("compilette_hook") is not None:
                plane.compilette_hook = kwargs["compilette_hook"]
        return plane

    # ------------------------------------------------------------ evaluators
    def _evaluator(self, comp: KernelCompilette,
                   key: tuple[str, str]) -> Any:
        if self.evaluator_factory is not None:
            return self.evaluator_factory(comp)

        def make_args() -> tuple:
            live = self._live_args.get(key)
            return live if live is not None else comp.example_call_args()

        return Evaluator(mode="real", real_runs=self.eval_runs, warmup=1,
                         make_args=make_args)

    # ------------------------------------------------------------- handles
    def register_spec(self, name: str, spec: Mapping[str, Any], *,
                      strategy: str | None = None,
                      require: bool = True) -> ManagedTuner | None:
        """Get-or-register the managed tuner for (kernel, spec).

        Idempotent per spec — serve code can re-register on every
        request. Only ``seq``/``max_len``-style keys are bucketed (the
        lifecycle's bucket_keys); kernel shape dims key exactly, since
        the compiled executable is shape-exact — callers that want
        nearby shapes to share a tuner must pre-bucket the extents they
        build the spec from. A handle evicted by the lifecycle
        re-registers transparently and warm-starts from the registry.

        A spec at which every tuning point is a hole (e.g. a reduced
        model whose K is below the smallest block_k) is untunable:
        ``require=True`` raises, ``require=False`` returns ``None`` (the
        serve/train hierarchical registration skips such kernels).
        """
        self.prune_released()
        bucketed = self.coordinator.lifecycle.bucket_specialization(
            dict(spec))
        key = (name, _canon(bucketed))
        handle = self._handles.get(key)
        if handle is not None and handle.state is not TunerState.RETIRED:
            # refresh idle stamp through the coordinator's idempotent path
            return self.coordinator.register(
                name, handle.tuner.compilette, handle.tuner.evaluator,
                specialization=dict(spec))
        comp = self.catalog.compilette(
            name, bucketed, virtual=self.virtual, gen_cost_s=self.gen_cost_s)
        if self.compilette_hook is not None:
            self.compilette_hook(comp)
        if not comp.has_valid_points():
            if require:
                raise ValueError(
                    f"kernel {name!r} has no valid tuning point at spec "
                    f"{bucketed}")
            return None
        handle = self.coordinator.register(
            name, comp, self._evaluator(comp, key),
            specialization=dict(spec),
            strategy=strategy or self.strategies.get(name))
        handle.plane_managed = True
        self._handles[key] = handle
        return handle

    def handle(self, name: str, *args: Any,
               **spec_overrides: Any) -> ManagedTuner:
        """Managed tuner for a kernel call, spec extracted from ``args``."""
        spec = self.catalog.spec_of(name, *args, **spec_overrides)
        return self.register_spec(name, spec)

    def prune_released(self) -> None:
        """Drop pinned live args of handles that will never evaluate again.

        A CONVERGED/RETIRED tuner never measures — the lifecycle
        releases its evaluator closure for exactly that reason, and the
        plane must not keep pinning the arrays behind its back. Runs on
        every plane use (cheap: a few dict entries), so one kernel's
        continued traffic unpins its converged siblings.
        """
        for key, handle in list(self._handles.items()):
            if (handle.state is not TunerState.ACTIVE
                    or handle.tuner.explorer.finished):
                self._live_args.pop(key, None)

    def _remember_or_release(self, key: tuple[str, str],
                             handle: ManagedTuner, args: tuple) -> None:
        """Keep live args only while the handle can still evaluate."""
        if (handle.state is TunerState.ACTIVE
                and not handle.tuner.explorer.finished):
            self._live_args[key] = args
        else:
            self._live_args.pop(key, None)

    def call(self, name: str, *args: Any, **spec_overrides: Any) -> Any:
        """Run a kernel through its coordinator-managed active function.

        Live arguments are remembered FIRST, so the register-time
        reference measurement (and all later evaluations, until the
        lifecycle releases the closure) runs on real traffic. Returns
        ``None`` when the spec is untunable (every point a hole) — the
        calling layer falls back to its plain implementation. A first
        sight of a shape (its registration and reference measurement) is
        one ``tune.register`` span.
        """
        fast_key = (
            name,
            tuple((tuple(a.shape), str(a.dtype)) for a in args
                  if hasattr(a, "shape")),
            tuple(sorted(spec_overrides.items())),
        )
        memo = self._fast.get(fast_key)
        if memo is not None:
            key, handle = memo
            if handle.state is not TunerState.RETIRED:
                # hot path: no spec extraction, no canonicalization, no
                # coordinator lock (the handle call refreshes last_used)
                self._remember_or_release(key, handle, args)
                return handle(*args)
            self._fast.pop(fast_key, None)
            self._live_args.pop(key, None)
        self.prune_released()
        spec = self.catalog.spec_of(name, *args, **spec_overrides)
        bucketed = self.coordinator.lifecycle.bucket_specialization(spec)
        key = (name, _canon(bucketed))
        self._live_args[key] = args
        with spans.span("tune.register", kernel=name):
            handle = self.register_spec(name, spec, require=False)
        if handle is None:
            self._live_args.pop(key, None)
            return None
        self._fast[fast_key] = (key, handle)
        self._remember_or_release(key, handle, args)
        return handle(*args)

    # -------------------------------------------------------------- lookup
    def handles(self, name: str | None = None) -> list[ManagedTuner]:
        out = [m for (n, _), m in self._handles.items()
               if name is None or n == name]
        return [m for m in out if m.state is not TunerState.RETIRED]

    def best_point(self, name: str,
                   spec: Mapping[str, Any] | None = None) -> dict | None:
        """Best-known tuned point for ``name`` (for trace-time adoption).

        With ``spec``, the exact bucketed handle is consulted; otherwise
        the most-called handle of that kernel (the shape that dominates
        live traffic) answers. ``None`` until something was measured.
        """
        if spec is not None:
            bucketed = self.coordinator.lifecycle.bucket_specialization(
                dict(spec))
            m = self._handles.get((name, _canon(bucketed)))
            candidates = [m] if m is not None else []
        else:
            candidates = sorted(
                self.handles(name),
                key=lambda m: -m.tuner.accounts.kernel_calls)
        for m in candidates:
            best = m.tuner.explorer.best_point
            if best is not None:
                return dict(best)
        return None

    def stats(self) -> dict[str, Any]:
        return {
            "handles": {
                f"{n}@{spec}": m.stats()
                for (n, spec), m in self._handles.items()
            },
        }


# ----------------------------------------------------------- active plane
_ACTIVE: "contextvars.ContextVar[KernelTuningPlane | None]" = (
    contextvars.ContextVar("kernel_tuning_plane", default=None))


def active_plane() -> KernelTuningPlane | None:
    """The plane installed by :func:`use_kernel_plane`, if any."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_kernel_plane(plane: KernelTuningPlane | None):
    """Install ``plane`` for model code (layers) to route kernels through."""
    token = _ACTIVE.set(plane)
    try:
        yield plane
    finally:
        _ACTIVE.reset(token)


# --------------------------------------------------------- step programs
_IN_STEP: "contextvars.ContextVar[bool]" = contextvars.ContextVar(
    "in_step_program", default=False)


def in_step_program() -> bool:
    """True inside a step-program (the model's prefill / decode step).

    The counterpart of the JAX layers' tracer test: a jitted step-program
    never calls a managed handle, it adopts the plane's best points at
    trace time, and the serve loop credits its busy time itself. A layer
    that routed here would double-count that time.
    """
    return _IN_STEP.get()


@contextlib.contextmanager
def step_program():
    """Mark the enclosed model calls as one step-program's body."""
    token = _IN_STEP.set(True)
    try:
        yield
    finally:
        _IN_STEP.reset(token)
