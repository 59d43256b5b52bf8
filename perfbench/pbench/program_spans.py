"""The program's own spans (``repro_torch.runtime.spans``), read in the
run's process after the run, for the ``program_span`` metrics that read
them.

The ring holds each request's ``serve.generate`` record. The traced
stretch's requests are the trailing ones opened under the profiler; the
window's are the unprofiled ones just before those, one for each of
``rec["window"].batches``. Where the counts disagree with the run's (the
mix's cycle traced, the window's batches, each one's batch and prompt
length), or the ring has dropped records, or the program has no spans
module, there is nothing to read: :func:`requests` returns ``None``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Requests:
    records: list             # every record the ring holds, as the program made them
    window: list              # the window's serve.generate records, in order
    traced: list              # the traced stretch's
    by_id: dict

    def of(self, gens: list) -> list:
        """The records of the requests ``gens`` (their own spans only)."""
        numbers = {g.request for g in gens}
        return [r for r in self.records if r.request in numbers]

    def children(self, ids: set) -> dict:
        """The direct children of the spans ``ids``, by parent id."""
        out: dict = {i: [] for i in ids}
        for r in self.records:
            if r.parent in out:
                out[r.parent].append(r)
        return out

    def ancestor(self, r, test):
        """The nearest enclosing span ``p`` of ``r`` with ``test(p)``, else None."""
        p = self.by_id.get(r.parent)
        while p is not None:
            if test(p):
                return p
            p = self.by_id.get(p.parent)
        return None


def requests(rec) -> "Requests | None":
    try:
        from repro_torch.runtime import spans
    except ImportError:            # a program that records no spans
        return None
    if not rec.get("trace") or spans.dropped():
        return None
    records = spans.records()
    gens = [r for r in records if r.name == "serve.generate"]
    traced = _trailing(gens, True)
    window = _trailing(gens[:len(gens) - len(traced)], False)
    batches = rec["window"].batches
    if len(traced) != rec["mix"].cycle or len(window) != len(batches):
        return None
    for g, b in zip(window, batches):
        attrs = g.attrs or {}
        if (attrs.get("batch"), attrs.get("length")) != (b.batch, b.length):
            return None
    return Requests(records=records, window=window, traced=traced,
                    by_id={r.id: r for r in records})


def _trailing(gens: list, profiled: bool) -> list:
    """The longest tail of ``gens`` opened with the profiler on (or off)."""
    n = 0
    while n < len(gens) and gens[len(gens) - 1 - n].profiled == profiled:
        n += 1
    return gens[len(gens) - n:]
