"""One front door: the ``repro_torch.tune`` session API.

Mirrors ``repro/api.py``: the same :class:`TuningConfig` knobs with the
same defaults and the same ``REPRO_TUNE_*`` environment keys (the port
adds none under that prefix: the reference's ``from_env`` would raise on
it), so one test can build both packages' sessions from one config.
What differs: a tuned function's variants are eager PyTorch calls (no
``jit``); :meth:`TuningSession.attach_kernels` takes the device the
kernels run on.

The paper's pitch is that online auto-tuning pays off only when it is
cheap to *adopt* — deployed directly at the level of machine-code
generation, with 0.2–4.2 % overhead and no re-architecting of the
application. Without it the repo has four entry points
(:class:`~repro_torch.core.OnlineAutotuner`, ``static_autotune``,
``TuningCoordinator.register``, ``KernelTuningPlane``) and three CLIs
re-declaring the same strategy/budget/SLO/bucketing knobs. This module
collapses them into one declarative surface (cf. the Kernel Tuning
Toolkit's single dynamic-tuning API, arXiv:1910.08498, and "Tuning the
Tuner"'s one-place searcher configuration):

  * :class:`TuningConfig` — every tuning knob, once, as data; built
    programmatically, :meth:`TuningConfig.from_env` (``REPRO_TUNE_*``),
    or :meth:`TuningConfig.from_flags` / :meth:`TuningConfig.add_flags`
    (so CLIs declare the canonical flag set in one call);
  * :class:`TuningSession` — owns exactly one
    :class:`~repro_torch.runtime.coordinator.TuningCoordinator` (shared
    budget, warm-start registry, generation cache, async pipeline) and
    at most one :class:`~repro_torch.runtime.kernel_plane.KernelTuningPlane`;
  * :meth:`TuningSession.tune` / the :func:`tuned` decorator — wrap any
    callable into a coordinator-managed
    :class:`~repro_torch.runtime.coordinator.ManagedTuner` handle: the
    application just keeps calling its function;
  * :meth:`TuningSession.attach_kernels` — hierarchical registration of
    a model's constituent catalog kernels (subsumes the serve/train
    plane wiring);
  * :meth:`TuningSession.scope` — the one context manager serve/train
    enter: installs the kernel plane for model code, re-entrant, and
    (for sessions that own their lifetime) closes exactly once at the
    outermost exit.

The reference's legacy constructors (``make_serve_coordinator``, the
per-loop coordinator wiring, the flat config aliases) are not ported:
the port has no older call sites.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import threading
from typing import Any, Callable, Mapping

from repro_torch.core.compilette import (
    Compilette,
    GenerationCache,
    device_free_memory_bytes,
)
from repro_torch.core.decision import LatencyHeadroomGate, RegenerationPolicy
from repro_torch.core.evaluator import Evaluator
from repro_torch.core.gate import GATE_MODES
from repro_torch.core.tuning_space import TuningSpace
from repro_torch.runtime import spans
from repro_torch.runtime.coordinator import ManagedTuner, TuningCoordinator
from repro_torch.runtime.kernel_plane import (
    KernelTuningPlane,
    parse_kernel_strategies,
    use_kernel_plane,
)
from repro_torch.runtime.lifecycle import TunerLifecycle, TunerState

__all__ = [
    "COMPILE_BACKENDS",
    "KERNEL_TUNING_MODES",
    "TunedFunction",
    "TuningConfig",
    "TuningSession",
    "default_session",
    "serve_tuning_defaults",
    "set_default_session",
    "train_tuning_defaults",
    "tune",
    "tuned",
]

KERNEL_TUNING_MODES = ("off", "program", "kernel", "both")
# compile-farm backends: "auto" keeps the clock-based pick (virtual clock
# -> deterministic "manual" batches, real clock -> worker threads);
# "process" opts into child-process compiles (Triton's compiler runs in a
# spawned child that fills the on-disk cache the parent then loads).
COMPILE_BACKENDS = ("auto", "thread", "process", "manual")


def _canon(spec: Mapping[str, Any]) -> str:
    return json.dumps(dict(spec), sort_keys=True, separators=(",", ":"))


def _parse_workers(value: Any) -> "int | str":
    """``--compile-workers`` / env value: a pool size M, or \"auto\"."""
    s = str(value).strip()
    if s.lower() == "auto":
        return "auto"
    return int(s)


def _resolve_backend(spec: Any) -> Any:
    """A :class:`~repro_torch.core.persistence.RegistryBackend` from config.

    ``None``/empty stays local-only; ``"shared:<path>"`` (or a bare
    path) builds a :class:`~repro_torch.core.persistence.SharedFileBackend`
    over that file. Non-string values are assumed to already BE backend
    objects (e.g. a ``FleetBus`` handed to :class:`TuningSession`) and
    pass through.
    """
    if spec is None:
        return None
    if not isinstance(spec, str):
        return spec
    s = spec.strip()
    if not s:
        return None
    from repro_torch.core.persistence import SharedFileBackend

    scheme, sep, rest = s.partition(":")
    if sep and scheme == "shared" and rest:
        return SharedFileBackend(rest)
    if sep and scheme in ("local", "file") and rest:
        return SharedFileBackend(rest)
    return SharedFileBackend(s)   # bare path


# ============================================================== TuningConfig
@dataclasses.dataclass
class TuningConfig:
    """Every tuning knob of a session, declaratively.

    One instance configures program-level tuners, the kernel plane, the
    shared budget, the warm-start registry and the async generation
    pipeline — the knobs that previously had to be re-plumbed through
    ``ServeConfig``/``TrainLoopConfig`` and three CLIs.
    """

    enabled: bool = True              # master switch (CLI: --autotune)
    strategy: str = "two_phase"       # default search strategy (registry name)
    strategies: dict[str, str] | None = None   # per-kernel overrides
    max_overhead: float = 0.05        # budget: fraction of app/busy time
    invest: float = 0.10              # budget: reinvested fraction of gains
    budget_from: str = "wall"         # "wall" (paper) | "busy" (serving)
    charge_init: bool = False         # budget the reference measurement
    slo_s: float | None = None        # per-call latency SLO (headroom gate)
    slo_quantile: float | None = None  # e.g. 0.99: gate on p99, not mean
    seq_buckets: bool = True          # pow2-bucket seq/max_len tuner keys
    idle_evict_s: float | None = 300.0  # retire tuners idle this long
    registry_path: str | None = None  # warm-start across restarts
    pump_every: int = 8               # app calls between tuning slots
    async_generation: bool = True     # compile variants off the hot path
    prefetch: int = 1                 # speculative compiles per slot
    compile_workers: "int | str" = 1  # compile-farm pool size (M) or "auto"
    compile_backend: str = "auto"     # auto | thread | process | manual
    kernel_tuning: str = "program"    # off | program | kernel | both
    cache_entries: int | None = 256   # generation-cache entry bound
    cache_bytes: int | None = None    # generation-cache byte bound
    gate_mode: str = "off"            # off | check | canary (trusted swaps)
    canary_fraction: float = 0.25     # fraction of calls a canary serves
    canary_calls: int = 8             # clean canary calls before promotion
    gate_rtol: float | None = None    # oracle tolerance overrides
    gate_atol: float | None = None    # (None = per-kernel catalog values)
    # fleet fabric: N replicas partition exploration and share a registry
    # backend ("shared:<path>" or a bare path -> SharedFileBackend; pass
    # backend OBJECTS — e.g. a FleetBus — to TuningSession directly)
    replica_id: int = 0               # this replica's index in the fleet
    replica_count: int = 1            # fleet size (1 = no partitioning)
    registry_backend: str | None = None   # shared backend spec
    sync_every_s: float | None = 1.0  # fleet sync cadence (None = every pump)
    # transfer plane: on a fingerprint miss, seed the search with the
    # top-k foreign bests ranked by device-trait similarity; seeds flow
    # through the gate/canary path as CANDIDATEs, never blind incumbents
    transfer: bool = False            # cross-device transfer seeding
    transfer_top_k: int = 3           # foreign bests injected per miss
    min_similarity: float = 0.75      # trait-similarity floor in (0, 1]

    def __post_init__(self) -> None:
        if self.kernel_tuning not in KERNEL_TUNING_MODES:
            raise ValueError(
                f"kernel_tuning must be one of {KERNEL_TUNING_MODES}, "
                f"got {self.kernel_tuning!r}")
        if self.budget_from not in ("wall", "busy"):
            raise ValueError(
                f"budget_from must be 'wall' or 'busy', "
                f"got {self.budget_from!r}")
        if self.compile_backend not in COMPILE_BACKENDS:
            raise ValueError(
                f"compile_backend must be one of {COMPILE_BACKENDS}, "
                f"got {self.compile_backend!r}")
        if self.compile_workers != "auto" and (
                not isinstance(self.compile_workers, int)
                or self.compile_workers < 1):
            raise ValueError(
                f"compile_workers must be >= 1 or 'auto', "
                f"got {self.compile_workers!r}")
        if self.replica_count < 1:
            raise ValueError(
                f"replica_count must be >= 1, got {self.replica_count}")
        if not 0 <= self.replica_id < self.replica_count:
            raise ValueError(
                f"replica_id must be in [0, {self.replica_count}), "
                f"got {self.replica_id}")
        if self.sync_every_s is not None and self.sync_every_s < 0:
            raise ValueError(
                f"sync_every_s must be >= 0 or None, got {self.sync_every_s}")
        if self.gate_mode not in GATE_MODES:
            raise ValueError(
                f"gate_mode must be one of {GATE_MODES}, "
                f"got {self.gate_mode!r}")
        if not 0.0 < self.canary_fraction <= 1.0:
            raise ValueError(
                f"canary_fraction must be in (0, 1], "
                f"got {self.canary_fraction}")
        if self.canary_calls < 1:
            raise ValueError(
                f"canary_calls must be >= 1, got {self.canary_calls}")
        if self.transfer_top_k < 1:
            raise ValueError(
                f"transfer_top_k must be >= 1, got {self.transfer_top_k}")
        if not 0.0 < self.min_similarity <= 1.0:
            raise ValueError(
                f"min_similarity must be in (0, 1], "
                f"got {self.min_similarity}")

    # -------------------------------------------------------- derived views
    @property
    def active(self) -> bool:
        """Tuning actually happens (enabled and not mode ``off``)."""
        return self.enabled and self.kernel_tuning != "off"

    @property
    def tune_program(self) -> bool:
        return self.active and self.kernel_tuning in ("program", "both")

    @property
    def tune_kernels(self) -> bool:
        return self.active and self.kernel_tuning in ("kernel", "both")

    def policy(self) -> RegenerationPolicy:
        return RegenerationPolicy(
            max_overhead_frac=self.max_overhead,
            invest_frac=self.invest,
            budget_from=self.budget_from,
            charge_init=self.charge_init,
            headroom=(LatencyHeadroomGate(
                slo_s=self.slo_s, slo_quantile=self.slo_quantile)
                if self.slo_s else None),
        )

    def lifecycle(self) -> TunerLifecycle:
        return TunerLifecycle(seq_buckets=self.seq_buckets,
                              idle_evict_s=self.idle_evict_s)

    # ------------------------------------------------------------------ env
    # field → parser; fields absent here parse as plain strings
    _BOOL_FIELDS = ("enabled", "charge_init", "seq_buckets",
                    "async_generation", "transfer")
    _FLOAT_FIELDS = ("max_overhead", "invest", "canary_fraction",
                     "min_similarity")
    _OPT_FLOAT_FIELDS = ("slo_s", "slo_quantile", "idle_evict_s",
                         "gate_rtol", "gate_atol", "sync_every_s")
    _INT_FIELDS = ("pump_every", "prefetch", "canary_calls",
                   "replica_id", "replica_count", "transfer_top_k")
    _OPT_INT_FIELDS = ("cache_entries", "cache_bytes")
    _OPT_STR_FIELDS = ("registry_path", "registry_backend")
    # environment/CLI spellings that map onto differently named fields
    _FIELD_ALIASES = {"autotune": "enabled",
                      "kernel_strategies": "strategies",
                      "gate": "gate_mode",
                      "sync_every": "sync_every_s",
                      "transfer_k": "transfer_top_k"}

    @classmethod
    def _parse_field(cls, field: str, raw: str) -> Any:
        s = raw.strip()
        none = s == "" or s.lower() == "none"
        if field in cls._BOOL_FIELDS:
            return s.lower() in ("1", "true", "yes", "on")
        if field in cls._FLOAT_FIELDS:
            return float(s)
        if field in cls._OPT_FLOAT_FIELDS:
            return None if none else float(s)
        if field in cls._INT_FIELDS:
            return int(s)
        if field in cls._OPT_INT_FIELDS:
            return None if none else int(s)
        if field in cls._OPT_STR_FIELDS:
            return None if none else s
        if field == "compile_workers":
            return _parse_workers(s)
        if field == "strategies":
            items = [i for i in s.replace(",", " ").split() if i]
            try:
                return parse_kernel_strategies(items)
            except SystemExit as e:
                # the parser's CLI-flavoured SystemExit is wrong for a
                # config/env code path: surface the same message as the
                # contract every other bad env value follows
                raise ValueError(
                    f"bad kernel strategies {raw!r}: {e}") from None
        return s

    @classmethod
    def from_env(
        cls,
        environ: Mapping[str, str] | None = None,
        *,
        base: "TuningConfig | None" = None,
        prefix: str = "REPRO_TUNE_",
    ) -> "TuningConfig":
        """Config from ``REPRO_TUNE_*`` variables (field names uppercased).

        ``REPRO_TUNE_STRATEGY=greedy REPRO_TUNE_MAX_OVERHEAD=0.1`` etc.;
        booleans accept 1/true/yes/on, per-kernel strategies are
        ``REPRO_TUNE_STRATEGIES="matmul=greedy,attention=random"``.
        Unknown ``REPRO_TUNE_*`` keys raise (a typo'd knob must not be
        silently ignored).
        """
        env = os.environ if environ is None else environ
        known = {f.name for f in dataclasses.fields(cls)}
        updates: dict[str, Any] = {}
        for key in sorted(env):
            if not key.startswith(prefix):
                continue
            field = key[len(prefix):].lower()
            field = cls._FIELD_ALIASES.get(field, field)
            if field not in known:
                raise ValueError(
                    f"unknown tuning variable {key!r}: no TuningConfig "
                    f"field {field!r}")
            updates[field] = cls._parse_field(field, env[key])
        return dataclasses.replace(base or cls(), **updates)

    # ---------------------------------------------------------------- flags
    @staticmethod
    def add_flags(parser: Any,
                  base: "TuningConfig | None" = None) -> Any:
        """Declare the canonical tuning flags on an argparse parser.

        CLIs call this once instead of re-declaring the knob set; the
        ``base`` config supplies the defaults (so serve and train CLIs
        can differ only in their base). Returns the parser.
        """
        from repro_torch.core.explorer import available_strategies

        base = base or TuningConfig(enabled=False)
        g = parser.add_argument_group("online auto-tuning (repro_torch.tune)")
        g.add_argument("--autotune", action="store_true",
                       default=base.enabled,
                       help="tune online under the session budget")
        g.add_argument("--strategy", default=base.strategy,
                       choices=available_strategies(),
                       help="search strategy for every tuner")
        g.add_argument("--kernel-tuning", default=base.kernel_tuning,
                       choices=list(KERNEL_TUNING_MODES),
                       help="tuning granularity: whole step-programs, "
                            "individual Pallas kernels, or both levels "
                            "hierarchically under one shared budget")
        g.add_argument("--kernel-strategy", action="append", default=[],
                       metavar="KERNEL=STRATEGY",
                       help="per-kernel search strategy override "
                            "(repeatable), e.g. matmul=greedy")
        g.add_argument("--tune-overhead", type=float,
                       default=base.max_overhead,
                       help="tuning overhead cap (fraction of app time)")
        g.add_argument("--tune-invest", type=float, default=base.invest,
                       help="fraction of gained time reinvested")
        g.add_argument("--registry", default=base.registry_path,
                       help="tuned-point registry path (warm-start)")
        g.add_argument("--slo", type=float, default=base.slo_s,
                       help="per-step latency SLO in seconds "
                            "(headroom-gates tuning)")
        g.add_argument("--slo-quantile", type=float,
                       default=base.slo_quantile,
                       help="gate on this latency quantile (e.g. 0.99 "
                            "for p99) instead of the per-call EWMA; "
                            "needs --slo")
        g.add_argument("--seq-buckets", dest="seq_buckets",
                       action="store_true", default=base.seq_buckets,
                       help="pow2-bucket seq/max_len tuner keys")
        g.add_argument("--no-seq-buckets", dest="seq_buckets",
                       action="store_false",
                       help="one tuner per exact shape")
        g.add_argument("--sync-generation", dest="async_generation",
                       action="store_false",
                       default=base.async_generation,
                       help="compile candidate variants inline on the "
                            "hot path (paper's original synchronous "
                            "cycle) instead of the background pipeline")
        g.add_argument("--prefetch", type=int, default=base.prefetch,
                       help="speculative compiles per tuning slot (0=off)")
        g.add_argument("--compile-workers", type=_parse_workers,
                       default=base.compile_workers,
                       help="compile-farm pool size: background variant "
                            "compiles running concurrently, or 'auto' "
                            "to grow under backlog and shrink when idle")
        g.add_argument("--compile-backend", default=base.compile_backend,
                       choices=list(COMPILE_BACKENDS),
                       help="compile-farm backend: auto picks threads "
                            "(or deterministic manual batches under a "
                            "virtual clock); process isolates compiles "
                            "in child processes")
        g.add_argument("--gate-mode", default=base.gate_mode,
                       choices=list(GATE_MODES),
                       help="trusted swaps: check gates every variant "
                            "against the kernel's oracle before it may "
                            "serve; canary additionally stages promotion "
                            "behind a serving canary with auto-rollback")
        g.add_argument("--canary-fraction", type=float,
                       default=base.canary_fraction,
                       help="fraction of production calls a canary "
                            "variant serves before promotion")
        g.add_argument("--canary-calls", type=int,
                       default=base.canary_calls,
                       help="clean canary calls required for promotion")
        g.add_argument("--gate-rtol", type=float, default=base.gate_rtol,
                       help="override the per-kernel oracle rtol")
        g.add_argument("--gate-atol", type=float, default=base.gate_atol,
                       help="override the per-kernel oracle atol")
        g.add_argument("--replica-id", type=int, default=base.replica_id,
                       help="fleet: this replica's index in [0, "
                            "replica-count)")
        g.add_argument("--replica-count", type=int,
                       default=base.replica_count,
                       help="fleet: replicas partitioning exploration "
                            "over a shared registry backend")
        g.add_argument("--registry-backend", default=base.registry_backend,
                       help="fleet: shared registry backend, "
                            "'shared:<path>' (lock-file protected JSON "
                            "shared by every replica)")
        g.add_argument("--sync-every", type=float, dest="sync_every_s",
                       default=base.sync_every_s,
                       help="fleet: seconds between registry syncs")
        g.add_argument("--transfer", action="store_true",
                       default=base.transfer,
                       help="transfer plane: on a fingerprint miss, seed "
                            "the search with foreign bests from trait-"
                            "similar devices (gated CANDIDATEs)")
        g.add_argument("--transfer-top-k", type=int,
                       dest="transfer_top_k",
                       default=base.transfer_top_k,
                       help="foreign bests injected per fingerprint miss")
        g.add_argument("--min-similarity", type=float,
                       dest="min_similarity",
                       default=base.min_similarity,
                       help="device-trait similarity floor in (0, 1] "
                            "below which foreign bests are not seeded")
        return parser

    @classmethod
    def from_flags(cls, args: Any,
                   base: "TuningConfig | None" = None) -> "TuningConfig":
        """Config from an argparse namespace built by :meth:`add_flags`.

        ``base`` supplies the fields that have no flag (budget source,
        init charging, eviction horizon, cache bounds) — pass the same
        base given to ``add_flags``.
        """
        if (getattr(args, "slo_quantile", None) is not None
                and getattr(args, "slo", None) is None):
            raise SystemExit(
                "--slo-quantile has no effect without --slo (the "
                "headroom gate only exists when an SLO is set)")
        base = base or cls(enabled=False)
        strategies = parse_kernel_strategies(
            list(getattr(args, "kernel_strategy", []) or []))
        if strategies is None:
            # no --kernel-strategy flags: inherit the base overrides,
            # like every other flag inherits its base default
            strategies = base.strategies
        return dataclasses.replace(
            base,
            enabled=args.autotune,
            strategy=args.strategy,
            kernel_tuning=args.kernel_tuning,
            strategies=strategies,
            max_overhead=args.tune_overhead,
            invest=args.tune_invest,
            registry_path=args.registry,
            slo_s=args.slo,
            slo_quantile=args.slo_quantile,
            seq_buckets=args.seq_buckets,
            async_generation=args.async_generation,
            prefetch=args.prefetch,
            compile_workers=args.compile_workers,
            compile_backend=args.compile_backend,
            gate_mode=args.gate_mode,
            canary_fraction=args.canary_fraction,
            canary_calls=args.canary_calls,
            gate_rtol=args.gate_rtol,
            gate_atol=args.gate_atol,
            replica_id=args.replica_id,
            replica_count=args.replica_count,
            registry_backend=args.registry_backend,
            sync_every_s=args.sync_every_s,
            transfer=args.transfer,
            transfer_top_k=args.transfer_top_k,
            min_similarity=args.min_similarity,
        )


# ------------------------------------------------------ per-regime defaults
def serve_tuning_defaults() -> TuningConfig:
    """Serving-grade base config: strict cap as a fraction of BUSY time,
    reference measurements charged, pow2 bucketing + idle eviction.

    Lives here (not in the torch-heavy serve loop) so CLIs can seed their
    flags before importing anything expensive.
    """
    return TuningConfig(
        enabled=False, max_overhead=0.05, invest=0.10,
        budget_from="busy", charge_init=True, seq_buckets=True,
        idle_evict_s=300.0, pump_every=4, async_generation=True,
        prefetch=1, kernel_tuning="program")


def train_tuning_defaults() -> TuningConfig:
    """Training-grade base config: generous overhead for short demo runs,
    wall-clock budget, fixed-shape step-programs (no bucketing, no
    eviction), tight pump cadence."""
    return TuningConfig(
        enabled=False, max_overhead=0.20, invest=0.5,
        budget_from="wall", charge_init=False, seq_buckets=False,
        idle_evict_s=None, pump_every=2, async_generation=True,
        prefetch=1, kernel_tuning="program")


# ============================================================ TunedFunction
class TunedFunction:
    """A callable wrapped into coordinator-managed tuner handles.

    Built by :meth:`TuningSession.tune` / the :func:`tuned` decorator.
    The tuning-space point's keys are passed to ``fn`` as keyword
    arguments **closed over at generation time** (the deGoal ``#(...)``
    inlining analogue), so each point is its own specialized callable. Registration is lazy: the first call
    captures live arguments, so the register-time reference measurement
    (and every later evaluation, until the lifecycle releases the
    closure) runs on real traffic. ``spec_from(*args)`` keys separate
    handles per run-time-constant cell (shape-like keys are pow2-bucketed
    by the session lifecycle), exactly like the kernel plane.
    """

    def __init__(
        self,
        session: "TuningSession",
        fn: Callable[..., Any],
        *,
        space: "TuningSpace | Callable[[dict], TuningSpace]",
        name: str | None = None,
        spec: Mapping[str, Any] | None = None,
        spec_from: Callable[..., Mapping[str, Any]] | None = None,
        evaluator: Any | None = None,
        reference_fn: Callable[..., Any] | None = None,
        reference_score_s: float | None = None,
        strategy: str | None = None,
        gen_cost_s: "float | Callable[..., float] | None" = None,
        cache_token: str | None = None,
    ) -> None:
        functools.update_wrapper(self, fn)
        self._session = session
        self._fn = fn
        self._space = space
        self._name = name or getattr(fn, "__name__", "tuned")
        self._spec = dict(spec or {})
        self._spec_from = spec_from
        self._evaluator = evaluator
        self._reference_fn = reference_fn
        self._reference_score_s = reference_score_s
        self._strategy = strategy
        self._gen_cost_s = gen_cost_s
        self._cache_token = cache_token
        self._handles: dict[str, ManagedTuner] = {}
        self._live_args: dict[str, tuple] = {}

    # ------------------------------------------------------------ generation
    def _generate(self, point: dict, **sp: Any) -> Callable[..., Any]:
        del sp  # run-time constants live in the point closure / fn body
        pt = dict(point)
        call = functools.partial(self._fn, **pt)

        def variant(*args: Any) -> Any:
            return call(*args)

        variant.point = pt   # virtual evaluators read the point back
        return variant

    # --------------------------------------------------------------- handles
    def _remember_or_release(self, key: str, handle: ManagedTuner,
                             args: tuple) -> None:
        """Pin live args only while the handle can still evaluate."""
        if (handle.state is TunerState.ACTIVE
                and not handle.tuner.explorer.finished):
            self._live_args[key] = args
        else:
            self._live_args.pop(key, None)

    def _handle_for(self, args: tuple) -> ManagedTuner:
        coord = self._session.coordinator
        spec = dict(self._spec)
        if self._spec_from is not None:
            spec.update(self._spec_from(*args))
        bucketed = coord.lifecycle.bucket_specialization(dict(spec))
        key = _canon(bucketed)
        handle = self._handles.get(key)
        if handle is not None and handle.state is not TunerState.RETIRED:
            self._remember_or_release(key, handle, args)
            return handle
        space = self._space(dict(spec)) if callable(self._space) \
            else self._space
        comp = Compilette(self._name, space, self._generate,
                          gen_cost_s=self._gen_cost_s,
                          cache_token=self._cache_token)
        evaluator = self._evaluator or Evaluator(
            mode="real", real_runs=1, warmup=1,
            make_args=lambda k=key: self._live_args[k])
        # live args land BEFORE register(): the reference measurement
        # (and the warm-start re-validation) runs on real traffic
        self._live_args[key] = args
        handle = coord.register(
            self._name, comp, evaluator,
            specialization=spec,
            reference_fn=self._reference_fn,
            reference_score_s=self._reference_score_s,
            strategy=self._strategy)
        self._handles[key] = handle
        self._remember_or_release(key, handle, args)
        return handle

    def __call__(self, *args: Any) -> Any:
        handle = self._handle_for(args)
        out = handle(*args)
        # one front door: calling the function IS the application loop,
        # so the session paces its own tuning slots
        self._session.coordinator.maybe_pump()
        return out

    # ----------------------------------------------------------------- views
    @property
    def session(self) -> "TuningSession":
        return self._session

    @property
    def handle(self) -> ManagedTuner | None:
        """The most recently registered handle (the only one, commonly)."""
        return next(reversed(self._handles.values()), None) \
            if self._handles else None

    def handles(self) -> list[ManagedTuner]:
        return list(self._handles.values())

    @property
    def best_point(self) -> dict | None:
        h = self.handle
        return None if h is None else h.tuner.explorer.best_point

    @property
    def active_fn(self) -> Callable[..., Any] | None:
        h = self.handle
        return None if h is None else h.active_fn

    def stats(self) -> dict[str, Any]:
        if len(self._handles) == 1:
            return self.handle.stats()
        return {key: h.stats() for key, h in self._handles.items()}


# ============================================================= TuningSession
class TuningSession:
    """One coordinator + registry + generation cache + kernel plane.

    The single integration surface: serve/train loops, CLIs and user
    code configure a session from one :class:`TuningConfig` and get the
    whole tuning machinery — shared regeneration budget, gain-based
    fairness, warm starts, double-buffered generation, lifecycle
    bucketing/eviction, kernel-granular plane — behind three calls
    (:meth:`tune`, :meth:`attach_kernels`, :meth:`scope`).
    """

    def __init__(
        self,
        config: TuningConfig | None = None,
        *,
        clock: Callable[[], float] | None = None,
        registry: Any | None = None,
        generation_cache: GenerationCache | None = None,
        device: str | None = None,
        virtual: tuple | None = None,
        evaluator_factory: Callable[..., Any] | None = None,
        gen_cost_s: "float | Callable[..., float] | None" = None,
        close_on_scope_exit: bool = False,
        compilette_hook: Callable[[Any], None] | None = None,
        registry_backend: Any | None = None,
    ) -> None:
        self.config = config if config is not None else TuningConfig()
        # kernel-plane construction kwargs (virtual backend for tests and
        # benchmarks), applied on the plane's first use; compilette_hook
        # runs on every freshly built kernel compilette — the
        # fault-injection replay harness uses it to install scripted
        # gate verdicts and wrapped generators
        self._plane_kwargs: dict[str, Any] = dict(
            virtual=virtual, evaluator_factory=evaluator_factory,
            gen_cost_s=gen_cost_s, compilette_hook=compilette_hook)
        self._scope_depth = 0
        self._close_on_scope_exit = bool(close_on_scope_exit)
        self._closed = False
        self._close_mu = threading.Lock()
        cfg = self.config
        # the backend knob refines async generation: "auto" keeps the
        # coordinator's clock-based pick, an explicit backend forces
        # the farm mode (sync generation ignores both)
        async_generation: "bool | str" = (
            cfg.async_generation if cfg.compile_backend == "auto"
            else (cfg.async_generation and cfg.compile_backend))
        self.coordinator = TuningCoordinator(
            policy=cfg.policy(),
            registry=registry,
            registry_path=cfg.registry_path,
            device=device,
            clock=clock,
            pump_every=cfg.pump_every,
            lifecycle=cfg.lifecycle(),
            strategy=cfg.strategy,
            async_generation=async_generation,
            generation_cache=(
                generation_cache if generation_cache is not None
                else GenerationCache(
                    max_entries=cfg.cache_entries,
                    max_bytes=cfg.cache_bytes,
                    # live device-memory pressure shrinks the byte
                    # bound; on CPU/virtual backends the probe has no
                    # signal and the static bound applies unchanged
                    free_memory_fn=device_free_memory_bytes)),
            prefetch=cfg.prefetch,
            compile_workers=cfg.compile_workers,
            gate_mode=cfg.gate_mode,
            canary_fraction=cfg.canary_fraction,
            canary_calls=cfg.canary_calls,
            gate_rtol=cfg.gate_rtol,
            gate_atol=cfg.gate_atol,
            replica_id=cfg.replica_id,
            replica_count=cfg.replica_count,
            # a backend OBJECT passed to the session (FleetBus, a
            # custom RegistryBackend) wins over the config's string
            # spec; both plug into the same coordinator knob
            registry_backend=_resolve_backend(
                registry_backend if registry_backend is not None
                else cfg.registry_backend),
            sync_every_s=cfg.sync_every_s,
            transfer=cfg.transfer,
            transfer_top_k=cfg.transfer_top_k,
            min_similarity=cfg.min_similarity,
        )
        self._plane: KernelTuningPlane | None = None

    # ------------------------------------------------------------- builders
    @classmethod
    def from_env(cls, environ: Mapping[str, str] | None = None,
                 *, base: TuningConfig | None = None,
                 **session_kwargs: Any) -> "TuningSession":
        """Session configured from ``REPRO_TUNE_*`` environment variables."""
        return cls(TuningConfig.from_env(environ, base=base),
                   **session_kwargs)

    @classmethod
    def from_flags(cls, args: Any, *, base: TuningConfig | None = None,
                   **session_kwargs: Any) -> "TuningSession":
        """Session from an argparse namespace (:meth:`TuningConfig.add_flags`)."""
        return cls(TuningConfig.from_flags(args, base=base),
                   **session_kwargs)

    # ------------------------------------------------------------ delegates
    @property
    def registry(self):
        return self.coordinator.registry

    @property
    def generation_cache(self) -> GenerationCache:
        return self.coordinator.generation_cache

    @property
    def plane(self) -> KernelTuningPlane | None:
        return self._plane

    @property
    def closed(self) -> bool:
        return self._closed

    def register(self, name: str, compilette: Compilette, evaluator: Any,
                 **kwargs: Any) -> ManagedTuner:
        """Register a pre-built compilette (program-level tuners)."""
        with spans.span("tune.register", kernel=name):
            return self.coordinator.register(name, compilette, evaluator,
                                             **kwargs)

    def observe_busy(self, seconds: float) -> None:
        self.coordinator.observe_busy(seconds)

    def maybe_pump(self) -> bool:
        return self.coordinator.maybe_pump()

    def pump(self) -> bool:
        return self.coordinator.pump()

    def sweep(self):
        return self.coordinator.sweep()

    def save(self, path: str | None = None) -> None:
        """Flush current bests to the warm-start registry."""
        self.coordinator.save_registry(path)

    def stats(self) -> dict[str, Any]:
        return self.coordinator.stats()

    def start_thread(self, wake_period_s: float = 0.002) -> None:
        self.coordinator.start_thread(wake_period_s)

    # ----------------------------------------------------------------- tune
    def tune(self, fn: Callable[..., Any] | None = None, *,
             space: "TuningSpace | Callable[[dict], TuningSpace]",
             **kwargs: Any) -> "TunedFunction | Callable[..., TunedFunction]":
        """Wrap ``fn`` into a managed tuner handle (decorator-friendly).

        ``session.tune(fn, space=...)`` or::

            @session.tune(space=...)
            def kernel(x, *, chunk): ...

        The point's keys are passed to ``fn`` as keyword constants at
        generation time; see :class:`TunedFunction` for the spec/
        evaluator/reference options.
        """
        def wrap(f: Callable[..., Any]) -> TunedFunction:
            return TunedFunction(self, f, space=space, **kwargs)

        return wrap if fn is None else wrap(fn)

    # --------------------------------------------------------------- replay
    def replay(self, trace: Any,
               configs: Mapping[str, Any] | None = None,
               **kwargs: Any) -> dict[str, Any]:
        """Re-serve a scripted traffic trace, deterministically.

        The session-API entry to the :mod:`repro_torch.bench.replay`
        harness: advances this session's (virtual) clock through the
        trace's arrivals, serves each request via the attached kernel
        handles (feeding per-call ``observe_latency`` through the managed
        tuners and ``observe_busy`` credits for scripted host work), and
        returns the per-tenant latency/speedup and session-level overhead
        report. See :func:`repro_torch.bench.replay.replay`.
        """
        from repro_torch.bench.replay import replay as _replay

        return _replay(self, trace, configs, **kwargs)

    # -------------------------------------------------------------- kernels
    def attach_kernels(self, model_cfg: Any, *, batch: int, seq: int,
                       max_len: int | None = None,
                       strategies: Mapping[str, str] | None = None,
                       device: Any = None,
                       ) -> KernelTuningPlane:
        """Register a model's constituent catalog kernels on the plane.

        Subsumes the serve/train plane wiring: builds (or refreshes)
        the coordinator's one shared plane, pre-buckets the traffic
        extents, and registers every
        :func:`~repro_torch.models.model.model_kernel_specs` kernel —
        including the decode-path ``decode_attention`` keyed per
        cache-length bucket when ``max_len`` is given. Untunable reduced
        shapes are skipped, not fatal. Idempotent per traffic cell.

        ``device`` (a ``torch.device`` or its name) is where the kernels
        run: it joins each spec, so the spaces are sized for that device
        and the example arguments are made there. ``None`` keeps the
        reference's specs as they are (the virtual backend).
        """
        from repro_torch.models.model import model_kernel_specs

        with spans.span("tune.register"):
            cfg = self.config
            plane = KernelTuningPlane.shared(
                self.coordinator,
                strategies=(dict(strategies) if strategies is not None
                            else cfg.strategies),
                # program points own the chunk knobs in "both" mode: the two
                # levels must never fight over one knob
                adopt_points=cfg.kernel_tuning != "both",
                **self._plane_kwargs)
            lifecycle = self.coordinator.lifecycle
            seq_b = lifecycle.bucket_length(int(seq))
            max_b = lifecycle.bucket_length(int(max_len)) if max_len else None
            for name, spec in model_kernel_specs(
                    model_cfg, batch=int(batch), seq=seq_b, max_len=max_b):
                if device is not None:
                    spec = {**spec, "device": str(device)}
                plane.register_spec(name, spec, require=False)
            self._plane = plane
            return plane

    # ----------------------------------------------------------- scope/close
    @contextlib.contextmanager
    def scope(self):
        """The one context serve/train enter around their request/loop.

        Installs the kernel plane for model code (when kernels are
        attached), re-entrantly: nested scopes — a serve request inside
        an outer CLI scope — stack, and a session constructed with
        ``close_on_scope_exit=True`` closes exactly once, at the
        OUTERMOST exit.
        """
        if self._closed:
            raise RuntimeError("TuningSession is closed")
        self._scope_depth += 1
        ctx = (use_kernel_plane(self._plane) if self._plane is not None
               else contextlib.nullcontext())
        try:
            with ctx:
                yield self
        finally:
            self._scope_depth -= 1
            if self._scope_depth == 0 and self._close_on_scope_exit:
                self.close()

    def close(self) -> None:
        """Flush the registry and stop the pipeline — exactly once.

        Idempotent and re-entrancy-safe: however many times nested
        ``scope()`` exits and explicit calls race here, the registry is
        saved and the async generator shut down a single time.
        """
        with self._close_mu:
            if self._closed:
                return
            self._closed = True
        self.coordinator.close()

    def __enter__(self) -> "TuningSession":
        self._scope_ctx = self.scope()
        return self._scope_ctx.__enter__()

    def __exit__(self, *exc: Any) -> None:
        ctx, self._scope_ctx = self._scope_ctx, None
        ctx.__exit__(*exc)


# ========================================================== default session
_DEFAULT_SESSION: TuningSession | None = None
_DEFAULT_MU = threading.Lock()


def default_session() -> TuningSession:
    """The process-default session (``REPRO_TUNE_*``-configured, lazy)."""
    global _DEFAULT_SESSION
    with _DEFAULT_MU:
        if _DEFAULT_SESSION is None or _DEFAULT_SESSION.closed:
            _DEFAULT_SESSION = TuningSession(TuningConfig.from_env())
        return _DEFAULT_SESSION


def set_default_session(
        session: TuningSession | None) -> TuningSession | None:
    """Install (or clear, with ``None``) the process-default session."""
    global _DEFAULT_SESSION
    with _DEFAULT_MU:
        old, _DEFAULT_SESSION = _DEFAULT_SESSION, session
    return old


def tune(fn: Callable[..., Any] | None = None, *,
         session: TuningSession | None = None,
         **kwargs: Any) -> Any:
    """``repro_torch.tune``: wrap a callable via the (default) session."""
    return (session or default_session()).tune(fn, **kwargs)


def tuned(*, session: TuningSession | None = None,
          **kwargs: Any) -> Callable[[Callable[..., Any]], TunedFunction]:
    """``@repro_torch.tuned(space=...)``: decorator form of :func:`tune`."""
    def deco(fn: Callable[..., Any]) -> TunedFunction:
        return tune(fn, session=session, **kwargs)

    return deco
