"""Compile farm: the parallel variant-generation pool (paper §3 scaled out).

A lone ``AsyncGenerator`` hides generation cost off the hot path but keeps a
*single* background executor — with several catalog kernels tuning
concurrently, one slow variant compile serializes every other kernel's
pipeline and cold-start time-to-best scales with the *sum* of compile
costs instead of the max. :class:`CompileFarm` generalizes it into a pool
of M workers draining generation requests **and** speculative ``peek(n)``
prefetches for all registered tuners concurrently:

  * **gain-priority scheduling** — jobs carry a priority (the
    coordinator passes its scheduling estimate: potential speedup x
    remaining call volume, damped by regenerations already invested);
    the farm pops the highest-priority job first, non-speculative
    requests before speculation at equal priority, submission order as
    the final tie-break. The order is total and deterministic.
  * **per-kernel in-flight caps** — a kernel with a wide space could
    flood the queue with prefetch jobs and starve the rest; speculative
    submissions beyond ``per_kernel_cap`` in-flight jobs for the same
    kernel are *rejected* (``submit`` returns ``None``, the prefetcher
    just tries again next slot). A tuner's own non-speculative request
    is always admitted: there is at most one per tuner.
  * **three backends** — ``"thread"`` (default): up to ``workers``
    daemon threads compile concurrently (nvcc and Triton's compiler run
    outside the GIL for most of their work). ``"process"``: same worker
    threads, but a compilette exposing the ``process_payload`` protocol
    has its compile executed in a spawned child process first — for a
    Triton kernel the child fills Triton's on-disk cache, and the
    parent's own compile then loads the binary from it instead of
    compiling; a compilette with no payload (the CUDA C++ families,
    whose variants are symbols of a library built once, and the virtual
    backend) compiles in-thread, counted in ``process_fallbacks``.
    ``"manual"``: no threads at all; jobs complete only at explicit
    ``run_pending()`` calls.

**Deterministic max-overlap semantics (manual mode).** One
``run_pending()`` call completes *up to* ``workers`` jobs, in priority
order — the virtual-time model of M workers each finishing one compile
per pump interval. The virtual clock is never advanced by a batch: like
the single-executor pipeline, compile latency is fully overlapped with
serving (a batch's wall-time is the *max* of its members' costs, hidden
inside the serving interval), while the budget is billed the *sum* of
every job's cost — ``gen_spent_s`` accrues in full, ``gen_stall_s``
stays exactly 0, and the existing VirtualClock test idiom ("requested at
pump k, harvestable at pump k+1") carries over unchanged.

**Atomic idle retirement.** The old single-worker queue had a race: a
job enqueued between the worker's ``queue.Empty`` timeout and its
retirement check could sit unserviced until the next submit spawned a
fresh worker. Farm workers wait on a condition variable under the same
mutex ``submit`` pushes under, so "queue still empty → deregister and
exit" is one critical section — a submit either sees the retiring worker
still registered (and its push is observed by that worker's emptiness
check) or sees it gone and spawns a replacement.

``AsyncGenerator`` remains as the single-worker alias for existing call
sites and tests.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Callable, Mapping

from repro_torch.core.compilette import Compilette, GenerationTicket
from repro_torch.core.tuning_space import Point

__all__ = ["AsyncGenerator", "CompileFarm", "run_process_payload"]

_MODES = ("thread", "manual", "process")


def run_process_payload(payload: tuple) -> tuple[float, int]:
    """Child-process entry: resolve and run one compile payload.

    ``payload`` is ``(module, attr, kwargs)`` — everything picklable —
    naming a module-level callable that performs the compile and returns
    its measured seconds. Returns ``(seconds, child_pid)``.
    """
    import importlib
    import os

    module, attr, kwargs = payload
    fn = getattr(importlib.import_module(module), attr)
    return float(fn(**dict(kwargs))), os.getpid()


class CompileFarm:
    """Pool of M background compile workers shared by a whole coordinator.

    See the module docstring for scheduling, backend and determinism
    semantics. ``submit`` deduplicates by cache key: a job already in
    flight is joined (the same ticket is returned), and a point already
    in the compilette's cache returns an immediately-done ticket.
    Speculative (prefetch) submissions carry a charge callback so their
    compile time is billed to the requesting tuner's accounts even if
    the prefetched variant is never proposed.
    """

    #: consecutive backlogged submits before an "auto" pool grows
    AUTO_GROW_AFTER = 2
    #: consecutive idle observations before an "auto" pool shrinks
    AUTO_SHRINK_AFTER = 8

    def __init__(self, mode: str = "thread", *,
                 workers: "int | str" = 1,
                 per_kernel_cap: int | None = None,
                 worker_idle_timeout_s: float = 30.0,
                 max_workers: int | None = None) -> None:
        if mode not in _MODES:
            raise ValueError(
                f"CompileFarm mode must be one of {_MODES}, got {mode!r}")
        self.mode = mode
        # Adaptive sizing: workers="auto" starts at 1 and grows under
        # sustained queue backlog (more queued+running jobs than workers
        # on AUTO_GROW_AFTER consecutive submits), shrinks back when the
        # farm is observed idle. The signals are pure queue-state
        # counters sampled at submits and manual pump ticks — no clocks,
        # no thread timing — so the manual/virtual backend resizes (and
        # therefore batches) byte-identically across same-seed runs.
        self.auto_sized = workers == "auto"
        if self.auto_sized:
            import os
            self.workers = 1
            self.max_workers = (max(int(max_workers), 1)
                                if max_workers is not None
                                else min(8, os.cpu_count() or 1))
        else:
            self.workers = max(int(workers), 1)
            self.max_workers = self.workers
        self._backlog_pressure = 0
        self._idle_pressure = 0
        self.grown = 0
        self.shrunk = 0
        self.per_kernel_cap = (None if per_kernel_cap is None
                               else max(int(per_kernel_cap), 1))
        self.worker_idle_timeout_s = worker_idle_timeout_s
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        # priority heap of (-priority, speculative, seq, ticket): highest
        # priority first, requests before speculation, then FIFO
        self._heap: list[tuple[float, int, int, GenerationTicket]] = []
        self._seq = 0
        self._inflight: dict[tuple, GenerationTicket] = {}
        # per-kernel-name in-flight counts (queued + running), for the cap
        self._kernel_inflight: dict[str, int] = {}
        # negative memo: keys whose generation raised. Bounded by the
        # number of holes in the managed tuning spaces; without it a
        # prefetched hole would be compiled (and billed) a second time
        # when the tuner itself proposes the point.
        self._failed: dict[tuple, BaseException] = {}
        self._threads: set[threading.Thread] = set()
        self._busy = 0                 # workers currently inside _run
        self._stopping = False
        self._pool = None              # lazy ProcessPoolExecutor
        self._pool_mu = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.speculative_submitted = 0
        self.joined = 0
        self.rejected_speculative = 0
        self.process_offloaded = 0
        self.process_fallbacks = 0
        # escapes caught by _run_safe (raises past _run's own generate
        # catch, e.g. a non-canonicalizable point key or a raising
        # speculative charge callback) — each one used to kill a worker
        self.worker_errors = 0

    # ------------------------------------------------------------ lifecycle
    def _spawn_locked(self) -> None:
        """Keep enough workers alive for the queued work (caller holds
        the farm mutex)."""
        if self.mode == "manual" or self._stopping:
            return
        want = min(self.workers, len(self._heap) + self._busy)
        while len(self._threads) < want:
            t = threading.Thread(
                target=self._worker_loop, daemon=True,
                name=f"compile-farm-{self._seq}-{len(self._threads)}")
            self._threads.add(t)
            t.start()

    def _worker_loop(self) -> None:
        # Workers retire after an idle period (a fresh one is spawned by
        # the next submit), so a forgotten coordinator — e.g. a
        # per-request one that was never close()d — does not pin blocked
        # daemon threads for the life of the process.
        me = threading.current_thread()
        try:
            while True:
                with self._cv:
                    while not self._heap:
                        if self._stopping:
                            return
                        if not self._cv.wait(self.worker_idle_timeout_s):
                            # idle timeout with the queue STILL empty:
                            # retire inside the same critical section
                            # submit pushes under — a concurrent enqueue
                            # either lands before this check (and is
                            # served) or after the deregistration (and
                            # spawns a replacement)
                            if not self._heap:
                                # an idle-retiring worker is the thread
                                # backend's idleness signal
                                self._note_idle_locked()
                                return
                    ticket = heapq.heappop(self._heap)[-1]
                    self._busy += 1
                try:
                    self._run_safe(ticket)
                finally:
                    with self._cv:
                        self._busy -= 1
        finally:
            # Whatever path ends this loop, the thread MUST leave the
            # registry: _spawn_locked sizes the pool by |_threads|, so a
            # dead-but-registered thread would permanently occupy a slot
            # (the dead-worker bug the safe runner exists to prevent).
            with self._cv:
                self._threads.discard(me)

    def shutdown(self) -> None:
        """Drain queued jobs, stop the workers, release the process pool.

        The farm stays usable: a later submit respawns workers (matching
        the old single-executor behaviour).
        """
        with self._cv:
            threads = list(self._threads)
            self._stopping = True
            self._cv.notify_all()
        for t in threads:
            t.join(timeout=5.0)
        with self._cv:
            self._stopping = False
        with self._pool_mu:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # ------------------------------------------------------------- process
    def _process_pool(self):
        with self._pool_mu:
            if self._pool is None:
                import concurrent.futures
                import multiprocessing

                self._pool = concurrent.futures.ProcessPoolExecutor(
                    max_workers=self.workers,
                    mp_context=multiprocessing.get_context("spawn"))
            return self._pool

    def _count(self, offloaded: bool) -> None:
        with self._mu:
            if offloaded:
                self.process_offloaded += 1
            else:
                self.process_fallbacks += 1

    def _offload(self, ticket: GenerationTicket) -> tuple[float, int] | None:
        """Run the ticket's compile payload in a child process.

        Returns ``(child_seconds, child_pid)``, or ``None`` when the
        compilette has no payload or the child failed — the caller then
        compiles in-thread as in "thread" mode (``process_fallbacks``).
        """
        payload_fn = getattr(ticket.compilette, "process_payload", None)
        if payload_fn is None:
            self._count(False)
            return None
        try:
            payload = payload_fn(ticket.point, ticket.specialization)
        except Exception:
            payload = None
        if payload is None:
            self._count(False)
            return None
        try:
            fut = self._process_pool().submit(run_process_payload, payload)
            seconds, pid = fut.result()
        except Exception:
            self._count(False)
            return None
        self._count(True)
        return float(seconds), int(pid)

    # ------------------------------------------------------------- running
    def _run(self, ticket: GenerationTicket) -> None:
        child: tuple[float, int] | None = None
        if self.mode == "process":
            child = self._offload(ticket)
        t0 = time.perf_counter()
        try:
            kern = ticket.compilette.generate(
                ticket.point, **ticket.specialization)
            err = None
        except BaseException as e:  # generation failure = late-found hole
            # drop the traceback: it pins the whole _generate frame
            # (model state, tracing temporaries) for as long as the
            # failure memo lives, and no consumer ever re-raises
            kern, err = None, e.with_traceback(None)
        failed_charge = time.perf_counter() - t0
        if err is not None:
            try:
                # a declared simulated cost keeps failure billing
                # deterministic under virtual clocks (successes already
                # bill the declared cost via generation_time_s)
                sim = ticket.compilette._simulated_cost(
                    ticket.point, ticket.specialization)
                if sim is not None:
                    failed_charge = sim
            except Exception:
                pass
        if child is not None and kern is not None:
            # the child's compile is real compute the budget must see,
            # on top of whatever the parent's own generate measured
            kern.generation_time_s += child[0]
            kern.meta["process_compile_s"] = child[0]
            kern.meta["process_pid"] = child[1]
        elif child is not None:
            failed_charge += child[0]
        try:
            key = ticket.compilette.cache_key(
                ticket.point, ticket.specialization)
        except BaseException as e:
            # a point that cannot be canonicalized cannot be keyed — and
            # must not kill the worker holding the farm lock. Treat it
            # like a generation failure (the variant is unusable either
            # way) and fall back to an identity scan for the inflight
            # entry, which was registered under the same raising key
            # path only if submit managed to compute it.
            key = None
            if err is None:
                kern, err = None, e.with_traceback(None)
        with self._mu:
            ticket.kern = kern
            ticket.error = err
            if err is not None and key is not None:
                self._failed[key] = err
            charge = (kern.generation_time_s if kern is not None
                      else failed_charge)
            if ticket.speculative and ticket._charge_cb is not None:
                # prefetch: the requester is billed NOW (used or not);
                # the harvester must not charge a second time
                cb, ticket.gen_charge_s = ticket._charge_cb, 0.0
            else:
                cb, ticket.gen_charge_s = None, charge
            ticket.done = True
            if key is not None:
                self._inflight.pop(key, None)
            else:
                for k, t in list(self._inflight.items()):
                    if t is ticket:
                        del self._inflight[k]
                        break
            self._kernel_uncount(ticket.compilette.name)
            if err is None:
                self.completed += 1
            else:
                self.failed += 1
        if cb is not None:
            # outside the lock: the callback charges tuner/coordinator
            # accounts and may take their locks — and may raise; the
            # ticket is already complete, so the failure is the
            # callback owner's, not the worker's
            try:
                cb(ticket, charge)
            except BaseException:
                with self._mu:
                    self.worker_errors += 1

    def _run_safe(self, ticket: GenerationTicket) -> None:
        """``_run`` that never raises: the worker-pool survival guarantee.

        ``_run`` already converts a raising ``generate`` into a
        failed-harvest ticket; this belt-and-suspenders wrapper converts
        any *remaining* escape the same way, because an exception
        crossing the worker loop used to kill the thread while it stayed
        registered in ``_threads`` — permanently shrinking the pool
        below M (``_spawn_locked`` sizes by registered threads). Manual
        mode shares the guarantee: an escape here would otherwise crash
        the coordinator's pump thread mid-request.
        """
        try:
            self._run(ticket)
            return
        except BaseException as e:
            err = e.with_traceback(None)
        with self._mu:
            self.worker_errors += 1
            if ticket.done:
                return   # completed before the escape: books are settled
            ticket.kern = None
            ticket.error = err
            ticket.gen_charge_s = 0.0
            ticket.done = True
            self.failed += 1
            self._kernel_uncount(ticket.compilette.name)
            for k, t in list(self._inflight.items()):
                if t is ticket:
                    del self._inflight[k]
                    break

    def _kernel_uncount(self, name: str) -> None:
        n = self._kernel_inflight.get(name, 0) - 1
        if n > 0:
            self._kernel_inflight[name] = n
        else:
            self._kernel_inflight.pop(name, None)

    # ------------------------------------------------------------- sizing
    def _note_backlog_locked(self) -> None:
        """Auto sizing, sampled at submit (caller holds the mutex)."""
        if not self.auto_sized:
            return
        queued = len(self._heap) + self._busy
        if queued > self.workers:
            self._idle_pressure = 0
            self._backlog_pressure += 1
            if (self._backlog_pressure >= self.AUTO_GROW_AFTER
                    and self.workers < self.max_workers):
                self.workers += 1
                self.grown += 1
                self._backlog_pressure = 0
        else:
            self._backlog_pressure = 0

    def _note_idle_locked(self) -> None:
        """Auto sizing, sampled when the farm is observed with no work."""
        if not self.auto_sized:
            return
        if self._heap or self._busy:
            self._idle_pressure = 0
            return
        self._backlog_pressure = 0
        self._idle_pressure += 1
        if self._idle_pressure >= self.AUTO_SHRINK_AFTER and self.workers > 1:
            self.workers -= 1
            self.shrunk += 1
            self._idle_pressure = 0

    def run_pending(self, max_jobs: int | None = None) -> int:
        """Manual mode: complete up to ``max_jobs`` queued jobs inline —
        one *batch* of ``workers`` jobs by default (the max-overlap model
        of M workers each finishing one compile per pump interval). In
        priority order; returns jobs completed. No-op in thread/process
        mode (the workers drain the queue themselves)."""
        if self.mode != "manual":
            return 0
        with self._mu:
            self._note_idle_locked()
        batch = self.workers if max_jobs is None else max_jobs
        n = 0
        while n < batch:
            with self._mu:
                if not self._heap:
                    return n
                ticket = heapq.heappop(self._heap)[-1]
            self._run_safe(ticket)
            n += 1
        return n

    def drain(self) -> int:
        """Manual mode: complete EVERY queued job, however many workers.

        The explicit whole-queue flush for tests and teardown paths;
        scheduled pumping should go through batched ``run_pending``.
        """
        total = 0
        while True:
            n = self.run_pending(max_jobs=len(self._heap) or 1)
            if n == 0:
                return total
            total += n

    # ------------------------------------------------------------- submit
    def submit(
        self,
        compilette: Compilette,
        point: Point,
        specialization: Mapping[str, Any],
        *,
        speculative: bool = False,
        charge_cb: Callable[[GenerationTicket, float], None] | None = None,
        priority: float = 0.0,
    ) -> GenerationTicket | None:
        """Request generation of ``point``; never blocks on the compile.

        Returns a ticket that is already ``done`` when the variant is in
        the cache, the in-flight ticket when the same key was already
        submitted (a non-speculative join adopts a speculative ticket),
        a freshly queued job otherwise — or ``None`` when a *speculative*
        submission was rejected by the per-kernel in-flight cap.
        """
        key = compilette.cache_key(point, specialization)

        def _join_locked(existing: GenerationTicket) -> GenerationTicket:
            self.joined += 1
            if not speculative:
                existing.adopt()
            return existing

        with self._mu:
            existing = self._inflight.get(key)
            if existing is not None:
                return _join_locked(existing)
            failed = self._failed.get(key)
            if failed is not None:
                # known hole: an already-billed failure, never recompiled
                return GenerationTicket(
                    compilette=compilette, point=dict(point),
                    specialization=dict(specialization), done=True,
                    error=failed, gen_charge_s=0.0)
        if compilette.cache is not None and key in compilette.cache:
            # hit: materialize through generate() so cache counters and
            # the zero-cost hit wrapper stay consistent. OUTSIDE the
            # farm lock: in the rare race where an LRU eviction lands
            # between the check and the get, generate() recompiles
            # inline — a bounded stall for this caller only, charged
            # below AND flagged as a stall, never a compile inside the
            # critical section. A failure on that inline path is a hole
            # like any other (a raise here would crash the caller's
            # pump/request thread).
            try:
                kern = compilette.generate(point, **dict(specialization))
            except BaseException as e:
                err = e.with_traceback(None)
                with self._mu:
                    self._failed[key] = err
                    self.failed += 1
                return GenerationTicket(
                    compilette=compilette, point=dict(point),
                    specialization=dict(specialization), done=True,
                    error=err, gen_charge_s=0.0)
            return GenerationTicket(
                compilette=compilette, point=dict(point),
                specialization=dict(specialization), done=True,
                kern=kern, gen_charge_s=kern.generation_time_s,
                stalled=kern.meta.get("source") == "compiled")
        with self._cv:
            existing = self._inflight.get(key)
            if existing is not None:   # raced in while we were unlocked
                return _join_locked(existing)
            name = compilette.name
            if (speculative and self.per_kernel_cap is not None
                    and self._kernel_inflight.get(name, 0)
                    >= self.per_kernel_cap):
                # cap: this kernel already owns its share of the farm;
                # the prefetcher retries on a later slot, while other
                # kernels' jobs keep flowing
                self.rejected_speculative += 1
                return None
            self._seq += 1
            ticket = GenerationTicket(
                compilette=compilette, point=dict(point),
                specialization=dict(specialization),
                speculative=speculative, _charge_cb=charge_cb,
                priority=float(priority), seq=self._seq)
            self._inflight[key] = ticket
            self._kernel_inflight[name] = (
                self._kernel_inflight.get(name, 0) + 1)
            self.submitted += 1
            if speculative:
                self.speculative_submitted += 1
            heapq.heappush(
                self._heap,
                (-ticket.priority, 1 if speculative else 0,
                 ticket.seq, ticket))
            self._note_backlog_locked()
            self._spawn_locked()
            self._cv.notify()
        return ticket

    def poll(self, ticket: GenerationTicket) -> GenerationTicket | None:
        """Non-blocking readiness check: the ticket when done, else None."""
        with self._mu:
            return ticket if ticket.done else None

    def disown(self, ticket: GenerationTicket,
               charge_cb: Callable[[GenerationTicket, float], None] | None
               ) -> float:
        """Release a ticket nobody will harvest (its tuner is retiring).

        Returns the unclaimed charge of an already-completed ticket (the
        caller bills it); a still-in-flight ticket is converted to a
        speculative one so ``charge_cb`` bills it at completion — either
        way the compile cost reaches the budget exactly once.
        """
        with self._mu:
            if ticket.done:
                charge, ticket.gen_charge_s = ticket.gen_charge_s, 0.0
                return charge
            ticket.speculative = True
            ticket._charge_cb = charge_cb
            return 0.0

    @property
    def in_flight(self) -> int:
        with self._mu:
            return len(self._inflight)

    def kernel_in_flight(self, name: str) -> int:
        with self._mu:
            return self._kernel_inflight.get(name, 0)

    def stats(self) -> dict[str, Any]:
        with self._mu:
            return {
                "mode": self.mode,
                "workers": self.workers,
                "auto_sized": self.auto_sized,
                "max_workers": self.max_workers,
                "grown": self.grown,
                "shrunk": self.shrunk,
                "per_kernel_cap": self.per_kernel_cap,
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "speculative_submitted": self.speculative_submitted,
                "joined": self.joined,
                "rejected_speculative": self.rejected_speculative,
                "process_offloaded": self.process_offloaded,
                "process_fallbacks": self.process_fallbacks,
                "worker_errors": self.worker_errors,
                "in_flight": len(self._inflight),
            }


class AsyncGenerator(CompileFarm):
    """Single-worker :class:`CompileFarm`: the pre-farm executor's name.

    Kept for existing call sites and tests; ``AsyncGenerator(mode)`` is
    exactly ``CompileFarm(mode, workers=1)``.
    """

    def __init__(self, mode: str = "thread",
                 worker_idle_timeout_s: float = 30.0) -> None:
        super().__init__(mode, workers=1,
                         worker_idle_timeout_s=worker_idle_timeout_s)
