"""Compilette: the parametrizable function generator (paper §3.1).

In the paper a compilette is a deGoal generator that emits ARM machine code
at run time, specializing run-time constants and honouring the auto-tuned
parameters. Here, a compilette is an object that — given a tuning-space
point and a set of run-time-constant specializations — *instantiates a
concrete compiled executable*:

  * on a CUDA device, a kernel written by hand for Hopper and specialised
    for the point (a template instantiation resolved from a library built
    once, or a Triton binary compiled for the point's constants) — the
    GPU analogue of deGoal's run-time code generation; on the CPU, an
    eager PyTorch program that mirrors the point;
  * on a simulated device profile, a cost-model evaluation of the same
    point (the analogue of the paper's gem5 simulations).

The generator function receives ``(point, **specialization)`` and must
return a callable ``fn(*args)``. Generation cost is measured and reported —
it is part of the paper's claimed overhead budget.

Two pieces take generation cost OFF the application hot path:

  * :class:`GenerationCache` — memoizes :class:`GeneratedKernel`\\ s under
    ``(kernel, point, specialization, device fingerprint[, token])``. A
    point revisited after bucketing, tuner eviction or a warm start is a
    cache hit: the stored executable is returned with zero generation
    time instead of recompiling. The cache is owned by the process-wide
    ``TuningCoordinator`` (one per process), so entries survive tuner
    retirement and re-registration.
  * :class:`~repro_torch.core.compile_farm.CompileFarm` — the background
    compile pool (the coordinator's analogue of the paper's "new version
    in a code buffer" double-buffering): the tuning wake *requests* a
    variant and keeps the current active function serving until the
    compiled candidate is ready. In ``"thread"`` mode worker threads
    compile; in ``"manual"`` mode jobs complete only at explicit
    ``run_pending()`` calls, which is what makes the pipeline
    deterministically testable under a :class:`~repro_torch.core.VirtualClock`
    (no sleeps).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Mapping

import torch

from repro_torch.core.persistence import _canon
from repro_torch.core.tuning_space import Point, TuningSpace


@dataclasses.dataclass
class GeneratedKernel:
    """A concrete variant: the paper's 'new version in a code buffer'.

    ``generation_time_s`` is the cost *charged for this instantiation*: the
    measured (or simulated) compile time on a fresh compile, and ``0.0``
    on a :class:`GenerationCache` hit (``meta["source"] == "cache"``; the
    original compile cost is kept in ``meta["compiled_in_s"]``).
    """

    point: Point
    fn: Callable[..., Any]
    generation_time_s: float
    specialization: dict[str, Any]
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)


# Residency estimate for cache entries whose executable size is unknown
# (lazy jit wrappers, virtual kernels): a byte-bounded cache must charge
# SOMETHING per entry or unknown-size entries would make the bound a
# no-op.
DEFAULT_ENTRY_BYTES = 64 * 1024


def device_free_memory_bytes() -> int | None:
    """Free bytes on the current CUDA device, or ``None`` when unknowable.

    Read from ``torch.cuda.mem_get_info``; without a CUDA device there is
    no live pressure signal and callers get ``None``.
    """
    if not torch.cuda.is_available():
        return None
    free, _total = torch.cuda.mem_get_info()
    return int(free)


def executable_bytes(fn: Callable[..., Any]) -> int | None:
    """Resident bytes of a generated variant: unknown for hand kernels.

    A CUDA instantiation lives in a shared library loaded once, and a
    Triton binary in Triton's own cache, so no variant reports a size;
    byte-bounded caches charge :data:`DEFAULT_ENTRY_BYTES` instead.
    """
    return None


class GenerationCache:
    """Process-wide memo of compiled variants, keyed by full identity.

    The key is ``(kernel name, cache token, canonical point, canonical
    specialization, device fingerprint)`` — the same identity the
    ``TunedRegistry`` persists best points under, so anything the registry
    would warm-start, the cache can serve without recompiling. Entries are
    kept in LRU order; ``max_entries`` bounds residency (compiled
    variants pin memory), ``None`` means unbounded.

    **Cost-weighted eviction.** Entries are not equally expensive to get
    back: one attention step-program costs orders of magnitude more to
    recompile than a trivial rmsnorm variant, yet a pure LRU would let
    ten cheap variants displace it. Every entry records its
    ``generation_time_s``; when the cache overflows, the victim is the
    *cheapest-to-regenerate* entry among the ``evict_window`` least
    recently used (ties break toward the older entry, so equal-cost
    entries degrade to plain LRU). The window keeps the policy local:
    recently used entries are never sacrificed however cheap they are.

    **Byte bound.** ``max_bytes`` additionally bounds the *estimated
    resident bytes* of the cached executables (compiled code pins
    host/device memory in proportion to its size, not its entry count):
    every entry is charged its ``meta["size_bytes"]`` — recorded at
    compile time where the variant reports its size — or
    :data:`DEFAULT_ENTRY_BYTES` when unknown. Overflowing either bound
    evicts through the same cost-weighted window; the newest entry is
    never its own victim, so one entry larger than ``max_bytes`` stays
    resident until displaced (evicting it on arrival would make the
    cache useless for exactly the kernels it exists to keep).

    **Live memory pressure.** ``max_bytes`` is a static estimate; the
    device the executables actually pin is shared with activations and
    weights whose footprint the cache cannot predict. When a
    ``free_memory_fn`` is provided (the session wires
    :func:`device_free_memory_bytes`), every ``put`` re-derives the
    effective byte bound as ``min(max_bytes, memory_headroom_frac x
    free_device_bytes)`` — under pressure the cache shrinks itself
    before the allocator OOMs, and when the probe has no signal (CPU
    backends, virtual clocks) the static ``max_bytes`` bound applies
    unchanged. Evictions forced by the dynamic bound alone are counted
    in ``pressure_evictions``.

    Thread-safe: the coordinator's tuning thread, the async compile
    worker, and the application thread may all hit it concurrently.
    """

    def __init__(self, max_entries: int | None = None,
                 evict_window: int = 8,
                 max_bytes: int | None = None,
                 free_memory_fn: Callable[[], int | None] | None = None,
                 memory_headroom_frac: float = 0.5) -> None:
        self._table: "collections.OrderedDict[tuple, GeneratedKernel]" = (
            collections.OrderedDict())
        self._mu = threading.Lock()
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.free_memory_fn = free_memory_fn
        self.memory_headroom_frac = float(memory_headroom_frac)
        self.evict_window = max(int(evict_window), 1)
        self._bytes = 0
        self._effective_max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.pressure_evictions = 0

    @staticmethod
    def key(
        kernel: str,
        point: Point,
        specialization: Mapping[str, Any],
        device: str,
        token: str | None = None,
    ) -> tuple:
        return (kernel, token, _canon(dict(point)),
                _canon(dict(specialization)), device)

    def get(self, key: tuple) -> GeneratedKernel | None:
        with self._mu:
            kern = self._table.get(key)
            if kern is None:
                self.misses += 1
                return None
            self._table.move_to_end(key)
            self.hits += 1
            return kern

    @staticmethod
    def _regen_cost(kern: GeneratedKernel) -> float:
        """What evicting this entry would cost to recompile later."""
        return float(kern.meta.get("compiled_in_s", kern.generation_time_s))

    @staticmethod
    def _entry_bytes(kern: GeneratedKernel) -> int:
        """Residency charge of one entry against the byte bound."""
        size = kern.meta.get("size_bytes")
        return int(size) if size else DEFAULT_ENTRY_BYTES

    def _byte_bound(self) -> int | None:
        """The byte bound in force for this put: static cap shrunk by
        live device-memory pressure when the probe has a signal."""
        free = None
        if self.free_memory_fn is not None:
            try:
                free = self.free_memory_fn()
            except Exception:
                free = None
        if free is None:
            return self.max_bytes          # no signal: static estimate
        dynamic = int(free * self.memory_headroom_frac)
        if self.max_bytes is None:
            return dynamic
        return min(self.max_bytes, dynamic)

    def _over_bounds(self, byte_bound: int | None) -> bool:
        return (
            (self.max_entries is not None
             and len(self._table) > self.max_entries)
            or (byte_bound is not None and self._bytes > byte_bound)
        )

    def put(self, key: tuple, kern: GeneratedKernel) -> None:
        with self._mu:
            byte_bound = self._effective_max_bytes = self._byte_bound()
            # an eviction within the static bound can only have been
            # forced by the pressure-shrunk dynamic bound
            pressured = (byte_bound is not None
                         and (self.max_bytes is None
                              or byte_bound < self.max_bytes))
            old = self._table.pop(key, None)
            if old is not None:
                self._bytes -= self._entry_bytes(old)
            self._table[key] = kern
            self._bytes += self._entry_bytes(kern)
            while self._over_bounds(byte_bound):
                if len(self._table) == 1:
                    if self.max_entries is not None and self.max_entries < 1:
                        # max_entries=0 (caching disabled): nothing can stay
                        _, lone = self._table.popitem(last=False)
                        self._bytes -= self._entry_bytes(lone)
                        self.evictions += 1
                        continue
                    # one entry larger than max_bytes: the newest entry is
                    # never its own victim, so it stays until displaced
                    break
                # cheapest-to-regenerate among the LRU window; min() keeps
                # the first (= least recently used) entry on cost ties.
                # The window never reaches the newest entry (cap at
                # len-1), so a fresh expensive compile cannot evict itself
                # the moment it lands.
                window = itertools.islice(
                    self._table.items(),
                    min(self.evict_window, len(self._table) - 1))
                if pressured and not self._over_bounds(self.max_bytes):
                    # within every static bound: only the pressure-shrunk
                    # dynamic bound forced this victim out
                    self.pressure_evictions += 1
                victim, evicted = min(
                    window, key=lambda kv: self._regen_cost(kv[1]))
                del self._table[victim]
                self._bytes -= self._entry_bytes(evicted)
                self.evictions += 1

    def __len__(self) -> int:
        with self._mu:
            return len(self._table)

    def __contains__(self, key: tuple) -> bool:
        with self._mu:
            return key in self._table

    def clear(self) -> None:
        with self._mu:
            self._table.clear()
            self._bytes = 0

    def stats(self) -> dict[str, Any]:
        with self._mu:
            total = self.hits + self.misses
            return {
                "entries": len(self._table),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "effective_max_bytes": self._effective_max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "pressure_evictions": self.pressure_evictions,
                "hit_rate": self.hits / total if total else 0.0,
            }


class Compilette:
    """Parametrizable kernel generator.

    Parameters
    ----------
    name:       kernel identity (used for persistence keys).
    space:      the tuning space (with validity holes).
    generate:   ``generate(point, **specialization) -> callable``; the
                callable must accept the kernel's runtime arguments. It
                should *close over* the specialized run-time constants —
                this is the deGoal ``#(...)`` inlining analogue (in JAX,
                trace-time constant folding).
    gen_cost_s: simulated generation cost — a float or
                ``f(point, specialization) -> seconds``. When set, the
                reported ``generation_time_s`` is this simulated cost
                instead of the measured wall time (``meta["simulated"]``
                is True), which is how virtual-clock tests model compile
                cost deterministically.
    cache_token: extra identity mixed into the generation-cache key.
                Compilettes that share a *name* but generate different
                programs (e.g. the serve step-programs of two different
                model configs) must carry distinct tokens, or a cache hit
                would hand one kernel the other's executable.
    """

    def __init__(
        self,
        name: str,
        space: TuningSpace,
        generate: Callable[..., Callable[..., Any]],
        cost_model: Callable[[Point, Mapping[str, Any], Any], float] | None = None,
        *,
        gen_cost_s: float | Callable[..., float] | None = None,
        cache_token: str | None = None,
    ) -> None:
        self.name = name
        self.space = space
        self._generate = generate
        # cost_model(point, specialization, profile) -> simulated seconds.
        self.cost_model = cost_model
        self.gen_cost_s = gen_cost_s
        self.cache_token = cache_token
        # Attached by the coordinator (attach_cache): process-wide memo of
        # compiled variants + the device fingerprint that keys it.
        self.cache: GenerationCache | None = None
        self.cache_device: str = "uncached"
        # Extra identity a compilette contributes to the *persistence*
        # fingerprint (appended to the device key by the coordinator).
        # KernelCompilette sets "src-<hash>" of its ops.py so editing a
        # kernel's source invalidates exactly that kernel's warm starts.
        self.fingerprint_extra: str | None = None

    # ------------------------------------------------------------- caching
    def attach_cache(self, cache: GenerationCache | None,
                     device: str | None = None) -> None:
        """Route this compilette's generations through ``cache``."""
        self.cache = cache
        if device is not None:
            self.cache_device = device

    def cache_key(self, point: Point,
                  specialization: Mapping[str, Any]) -> tuple:
        return GenerationCache.key(
            self.name, point, specialization, self.cache_device,
            self.cache_token)

    def _simulated_cost(self, point: Point,
                        specialization: Mapping[str, Any]) -> float | None:
        if self.gen_cost_s is None:
            return None
        if callable(self.gen_cost_s):
            return float(self.gen_cost_s(dict(point), dict(specialization)))
        return float(self.gen_cost_s)

    def generate(self, point: Point, **specialization: Any) -> GeneratedKernel:
        """Instantiate ``point`` — from the cache when possible.

        A cache hit returns a fresh :class:`GeneratedKernel` wrapper
        (shared ``fn``, private ``meta``) with ``generation_time_s = 0``:
        nothing was compiled, so nothing is charged and nothing stalls.
        ``Compilette._generate`` runs at most once per cache key.
        """
        if not self.space.is_valid(point):
            raise ValueError(
                f"compilette {self.name!r}: point {point} is a hole in the "
                "tuning space (invalid variant)"
            )
        key = None
        if self.cache is not None:
            key = self.cache_key(point, specialization)
            cached = self.cache.get(key)
            if cached is not None:
                return GeneratedKernel(
                    point=dict(point),
                    fn=cached.fn,
                    generation_time_s=0.0,
                    specialization=dict(specialization),
                    meta={"source": "cache",
                          "compiled_in_s": cached.meta.get(
                              "compiled_in_s", cached.generation_time_s)},
                )
        t0 = time.perf_counter()
        fn = self._generate(dict(point), **specialization)
        dt = time.perf_counter() - t0
        sim = self._simulated_cost(point, specialization)
        kern = GeneratedKernel(
            point=dict(point),
            fn=fn,
            generation_time_s=dt if sim is None else sim,
            specialization=dict(specialization),
            meta={"source": "compiled", "simulated": sim is not None,
                  "compiled_in_s": dt if sim is None else sim,
                  # byte-bounded caches charge this residency estimate
                  # (None → DEFAULT_ENTRY_BYTES at the cache)
                  "size_bytes": executable_bytes(fn)},
        )
        if self.cache is not None and key is not None:
            self.cache.put(key, kern)
        return kern

    def simulate(self, point: Point, profile: Any, **specialization: Any) -> float:
        """Simulated execution time of ``point`` on a device ``profile``."""
        if self.cost_model is None:
            raise ValueError(f"compilette {self.name!r} has no cost model")
        return self.cost_model(dict(point), dict(specialization), profile)


# ------------------------------------------------------------- async pipeline
@dataclasses.dataclass(eq=False)
class GenerationTicket:
    """Handle for one in-flight (or completed) generation job."""

    compilette: Compilette
    point: Point
    specialization: dict[str, Any]
    speculative: bool = False
    # scheduling inputs (set at submit): the farm pops highest priority
    # first, non-speculative before speculative at equal priority, then
    # submission order — a total, deterministic order
    priority: float = 0.0
    seq: int = 0
    # set at completion (under the generator lock):
    done: bool = False
    kern: GeneratedKernel | None = None
    error: BaseException | None = None
    gen_charge_s: float = 0.0   # unclaimed budget charge for the harvester
    stalled: bool = False       # the generation ran inline on the caller
                                # (cache-eviction race): a real stall
    # charge_cb(ticket, seconds): bills a speculative compile at completion
    _charge_cb: Callable[["GenerationTicket", float], None] | None = None

    def adopt(self) -> None:
        """A tuner claims a speculative ticket: the harvester (not the
        completion callback) will charge its generation time."""
        self.speculative = False
        self._charge_cb = None
