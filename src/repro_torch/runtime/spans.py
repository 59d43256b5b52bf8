"""The port's one tracing module: spans on the profiler's host clock.

A span is a named interval of host time on one thread, stamped with
``time.time_ns()``: the clock ``torch.profiler`` stamps its host events
with, so a span and the runtime calls of a trace line up. A closed span
becomes a :class:`Span` record in one bounded ring of :data:`RING`
records (the oldest dropped first), read back with :func:`records`.
While a ``torch.profiler`` run is active each span also opens a
``torch.profiler.record_function`` range of its name, so the spans show
in a trace exported with ``export_chrome_trace``.

Two tiers:

* **the request tier** (:func:`span`, :func:`request`) is always on: a
  few spans a request and a decode step, each two clock reads and one
  append;
* **the layer tier** (:func:`layer`) records only while a profiler runs
  or inside :func:`recording`; otherwise a site reads two flags and
  returns a shared null context (no clock read, no append).

The spans, by tier:

* request: ``serve.generate`` (one ``generate`` call, one request
  number); ``serve.prefill`` (the prefill and its cache widened,
  synced); ``serve.decode_step`` (one decode step: the model call, the
  argmax, the sync that closes it under kernel tuning, the tuning slot
  after it); ``serve.sync`` (the wait in one of the serve loop's device
  syncs); ``tune.pump`` (a ``maybe_pump`` call that reached ``pump()``);
  ``tune.register`` (``attach_kernels``, ``session.register``, a kernel
  plane's first sight of a shape, each with its reference measurement);
  ``tune.evaluate`` (one candidate's measurement, attribute ``kernel``:
  the interval the tuner adds to ``eval_spent_s``);
* layer: ``moe`` (one ``moe_ffn`` call); ``moe.route`` (the router, the
  top-k, the load-balancing loss); per chunk of groups (one in a decode
  step) ``moe.dispatch`` (positions, the stacked dispatch tensor of all
  top-k slices, gather; attributes ``slices``, the top-k, and ``groups``,
  the chunk's groups), ``moe.experts`` (gate, up, SiLU, down, once over
  the stack) and ``moe.combine`` (the weighted scatter back to the
  tokens).
  Under latent attention (``repro_torch.models.layers``, one set a
  layer): ``mla.project`` (the queries, the latent and its RMSNorm, the
  rope key, both rotations), in a prefill ``mla.expand`` (the latent
  through ``wkv_b`` to every head's keys and values), in a decode step
  ``mla.absorb`` (the nope queries into the latent) and ``mla.unabsorb``
  (the latent output to every head's values), and ``mla.attend``
  (attributes ``keys``, the keys attended, and ``path``: ``flash`` in a
  prefill, ``latent`` in a decode step).

A span opened on a thread inside :func:`request` carries that request's
number; its parent is the span open on the same thread when it opened.
:func:`mark` is the training step's profiler range (no record).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, NamedTuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["RING", "Span", "dropped", "layer", "mark", "records", "recording",
           "request", "span"]

#: records the ring holds: a benchmark run's window (the request tier,
#: a few hundred records a request) and its traced stretch (the MoE
#: cell's prefill and 8 decode steps under the layer tier: about 11,200)
#: both fit, at about 20 MB when full
RING = 1 << 16

#: the host clock of every span; the profiler's own (tests stub it)
_clock = time.time_ns


class Span(NamedTuple):
    """One closed span."""
    name: str
    start_ns: int          # time.time_ns() at the opening
    end_ns: int            # ... at the close
    thread: int            # threading.get_ident()
    id: int                # unique in the process, in order of opening
    parent: int            # the enclosing span's id on this thread, 0 if none
    request: int           # the request number, 0 outside a request
    profiled: bool         # a torch.profiler run was active at the opening
    attrs: "dict | None"

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


#: the closed spans as plain tuples in :class:`Span`'s order
_ring: "collections.deque[tuple]" = collections.deque(maxlen=RING)
_dropped = 0
_ids = itertools.count(1)
_requests = itertools.count(1)
_recording = 0
_mu = threading.Lock()        # the two counters' updates
_local = threading.local()


def records() -> list[Span]:
    """What the ring holds, in the order the spans closed."""
    return [Span._make(r) for r in list(_ring)]


def dropped() -> int:
    """Records the ring has dropped to stay within :data:`RING`."""
    return _dropped


class _Thread:
    """One thread's open spans (innermost last) and request number."""

    __slots__ = ("stack", "request", "ident")

    def __init__(self) -> None:
        self.stack: list = []
        self.request = 0
        self.ident = threading.get_ident()


def _thread() -> _Thread:
    try:
        return _local.state
    except AttributeError:
        _local.state = t = _Thread()
        return t


class _Open:
    """A span while it is open; ``seconds`` once it has closed. A span made
    by :func:`request` also sums its direct children's time by name."""

    __slots__ = ("name", "attrs", "id", "parent", "request", "profiled", "start_ns",
                 "end_ns", "range", "kids", "_t")

    def __init__(self, name: str, attrs: "dict | None") -> None:
        self.name = name
        self.attrs = attrs
        self.range = None
        self.kids = None
        self.end_ns = 0

    def __enter__(self) -> "_Open":
        t = _thread()
        self._t = t
        self.parent = t.stack[-1] if t.stack else None
        self.request = t.request
        self.id = next(_ids)
        self.profiled = _profiler._is_profiler_enabled
        if self.profiled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        t.stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        self.end_ns = end = _clock()
        stack = self._t.stack
        if stack and stack[-1] is self:
            stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
            self.range = None
        parent = self.parent
        if parent is not None and parent.kids is not None:
            parent.kids[self.name] = parent.kids.get(self.name, 0) + end - self.start_ns
        if len(_ring) == RING:
            with _mu:
                _dropped += 1
        _ring.append((self.name, self.start_ns, end, self._t.ident, self.id,
                      parent.id if parent is not None else 0, self.request,
                      self.profiled, self.attrs))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def elapsed(self) -> float:
        """Seconds since the opening (one more clock read)."""
        return (_clock() - self.start_ns) * 1e-9

    def kid_seconds(self, name: str) -> float:
        """Seconds of the closed direct children named ``name``."""
        return (self.kids or {}).get(name, 0) * 1e-9


def span(name: str, **attrs: Any) -> _Open:
    """A request-tier span (always recorded)."""
    return _Open(name, attrs or None)


_NULL = contextlib.nullcontext()


def layer(name: str, **attrs: Any) -> "_Open | contextlib.nullcontext":
    """A layer-tier span, with ``attrs`` as :func:`span` takes them:
    recorded under a running profiler or inside :func:`recording`, else
    the shared null context."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    return _Open(name, attrs or None)


@contextlib.contextmanager
def request(**attrs: Any):
    """The ``serve.generate`` span of a new request: the process's next
    request number, carried by every span opened on this thread inside
    the block. The span (an :class:`_Open`) sums its direct children's
    seconds by name (:meth:`_Open.kid_seconds`)."""
    t = _thread()
    outer = t.request
    t.request = next(_requests)
    sp = _Open("serve.generate", attrs or None)
    sp.kids = {}
    try:
        with sp:
            yield sp
    finally:
        t.request = outer


@contextlib.contextmanager
def recording():
    """Turn the layer tier on for the block (nestable, any thread)."""
    global _recording
    with _mu:
        _recording += 1
    try:
        yield
    finally:
        with _mu:
            _recording -= 1


@contextlib.contextmanager
def mark(name: str, device: torch.device):
    """A profiler range around one phase of a training step. Under the
    profiler, and only there, it ends in a device sync, so each kernel of
    the phase starts inside the range's host interval; with no profiler
    running it costs one ``record_function``."""
    with torch.profiler.record_function(name):
        yield
        if device.type == "cuda" and _profiler._is_profiler_enabled:
            torch.cuda.synchronize(device)
