"""Persistence of tuned configurations.

Mirrors ``repro/core/persistence.py``. Tuned best-points are keyed by
(kernel name, specialization, device) and stored as JSON, in the same
format the JAX package writes: a registry written by either package
loads, and merges, in the other.

The device key is a *fingerprint* ``platform:device_kind:compiler`` —
here ``cuda:<device name>:torch<v>-cuda<v>`` (``cpu:cpu:...`` without a
card). A tuned point is only transferable between identical devices
under the same PyTorch and CUDA, so entries persisted under another
version simply miss (cold start) instead of warm-starting a stale point.
Registries written by older layouts are still honoured through
:func:`device_fallbacks`.
"""

from __future__ import annotations

import copy
import json
import os
import tempfile
import threading
import time
from typing import Any

from repro_torch.core.tuning_space import Point


def _canon(obj: Any) -> str:
    """Canonical JSON identity used by BOTH the tuned-point registry and
    the generation cache (``repro_torch.core.compilette``), so the two key
    formats can never silently diverge. Deliberately STRICT: a
    non-JSON-serializable specialization value raises here, loudly —
    stringifying it would embed memory addresses in persisted keys and
    silently break warm starts across restarts."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def compiler_version() -> str:
    """PyTorch/CUDA version pair: tuned points do not survive the compiler."""
    import torch

    return f"torch{torch.__version__}-cuda{torch.version.cuda or 'none'}"


def device_fingerprint(device: Any = None) -> str:
    """Stable identity of the accelerator the process is tuning for.

    Tuned points are only transferable between identical devices under
    the same compiler, so the registry key includes platform, device kind
    and the PyTorch/CUDA version. ``device`` (a ``torch.device`` or its
    name) defaults to the current CUDA device, or the CPU without one.
    """
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}:{compiler_version()}"
    return f"{dev.type}:{dev.type}:{compiler_version()}"


def device_fallbacks(device: str) -> tuple[str, ...]:
    """Legacy registry keys to try after an exact-fingerprint miss.

    Older layouts keyed entries by ``platform:device_kind`` (pre
    compiler-version) or by bare ``device_kind`` (pre-coordinator). Both
    remain readable; entries that DO carry a compiler version only match
    exactly, so a compiler upgrade degrades them to a cold start.
    """
    parts = device.split(":")
    out: list[str] = []
    if len(parts) >= 3:
        out.append(":".join(parts[:2]))   # platform:device_kind
    if len(parts) >= 2:
        out.append(parts[1])              # bare device_kind
    return tuple(out)


_META_KEY = "__registry_meta__"


class TunedRegistry:
    """Thread-safe: the coordinator's tuning thread calls ``put`` while
    the application thread may be inside ``save`` (request end,
    checkpoint), so mutation and serialization are serialized on an
    internal lock.

    **Aging.** Without hygiene the JSON accumulates dead entries forever
    (retired shapes, superseded compilers). Every entry carries a
    last-used stamp in *save generations* (a monotonic counter persisted
    with the file — wall time would mis-age registries that are loaded
    rarely but saved often). ``put`` and lookup hits refresh the stamp;
    ``save()`` advances the generation and compacts entries that (a) went
    unused for ``max_idle_saves`` saves or (b) were recorded under a
    *different* compiler version than the running one (they can only ever
    miss). Versionless legacy keys carry no compiler claim and age out
    through (a) alone. ``max_idle_saves=None`` disables idle compaction.

    The horizon is measured in SAVES, so size it to the caller's save
    cadence: the serve loop saves once per request (managed tuners are
    re-stamped by the pre-save flush, but an *evicted* bucket's entry is
    only refreshed if its shape re-registers), while a training job
    saves once per checkpoint. The default of 64 keeps a retired serve
    bucket warm for 64 requests and a checkpoint-style entry for 64
    checkpoints before reclaiming it.
    """

    def __init__(self, *, max_idle_saves: int | None = 64) -> None:
        self._table: dict[str, dict[str, Any]] = {}
        # Quarantine: per registry key, canonical-point -> reason for
        # points the variant gate rejected or the canary rolled back. A
        # quarantined point is never returned by lookups, never accepted
        # by ``put``, and survives save/load — a bad point is never
        # re-trusted after a warm start. Unlike best-point entries it
        # does NOT age out with idle saves (bad stays bad); only a
        # compiler change invalidates it (the variant it condemned no
        # longer exists).
        self._quarantine: dict[str, dict[str, str]] = {}
        # Evaluations: per registry key, canonical-point -> best observed
        # score. This is the fleet's "already paid for" ledger — a peer
        # replica that merges it marks those points seen in its explorer
        # and never re-compiles them. Like quarantine it unions across
        # replicas and only dies with a compiler change.
        self._evaluations: dict[str, dict[str, float]] = {}
        self._mu = threading.Lock()
        self._generation = 0
        self.max_idle_saves = max_idle_saves
        self.compacted_total = 0

    @staticmethod
    def key(kernel: str, specialization: dict[str, Any], device: str) -> str:
        return _canon({"k": kernel, "s": specialization, "d": device})

    def put(
        self,
        kernel: str,
        specialization: dict[str, Any],
        device: str,
        point: Point,
        score_s: float,
        strategy: str | None = None,
        traits: dict[str, float] | None = None,
    ) -> None:
        k = self.key(kernel, specialization, device)
        with self._mu:
            if _canon(dict(point)) in self._quarantine.get(k, {}):
                return   # a condemned point never re-enters the registry
            cur = self._table.get(k)
            if cur is None or score_s < cur["score_s"]:
                entry = {"point": dict(point), "score_s": float(score_s),
                         "gen": self._generation}
                if strategy is not None:
                    # provenance: which search strategy found this best
                    entry["strategy"] = str(strategy)
                if traits is not None:
                    # device-trait vector: the transfer plane ranks this
                    # entry against dissimilar-fingerprint lookups
                    entry["traits"] = dict(traits)
                self._table[k] = entry
            else:
                # a worse score still proves the entry is in use
                cur["gen"] = self._generation
                if traits is not None and "traits" not in cur:
                    # a pre-transfer entry learns its device traits the
                    # first time the device describes itself
                    cur["traits"] = dict(traits)

    def get(
        self, kernel: str, specialization: dict[str, Any], device: str
    ) -> Point | None:
        with self._mu:
            k = self.key(kernel, specialization, device)
            entry = self._table.get(k)
            if entry is None:
                return None
            if _canon(entry["point"]) in self._quarantine.get(k, {}):
                return None   # defensive: quarantine always wins
            entry["gen"] = self._generation   # last-used stamp
            return dict(entry["point"])

    def best_entry(
        self, kernel: str, specialization: dict[str, Any], device: str
    ) -> tuple[Point, float] | None:
        """Exact-key best point WITH its score (fleet adoption needs the
        score to decide whether a peer's best beats the local one)."""
        with self._mu:
            k = self.key(kernel, specialization, device)
            entry = self._table.get(k)
            if entry is None:
                return None
            if _canon(entry["point"]) in self._quarantine.get(k, {}):
                return None
            entry["gen"] = self._generation
            return dict(entry["point"]), float(entry["score_s"])

    def get_warm(
        self, kernel: str, specialization: dict[str, Any], device: str
    ) -> Point | None:
        """Exact-fingerprint lookup, then the legacy-key fallback chain."""
        point = self.get(kernel, specialization, device)
        if point is not None:
            return point
        for legacy in device_fallbacks(device):
            point = self.get(kernel, specialization, legacy)
            if point is not None:
                return point
        return None

    def cross_device_entries(
        self,
        kernel: str,
        specialization: dict[str, Any],
        *,
        exclude_device: str | None = None,
    ) -> list[tuple[str, dict[str, Any]]]:
        """Best entries for this (kernel, spec) under OTHER device keys.

        The transfer plane's raw material after a fingerprint miss: every
        foreign device's best row — with its persisted trait vector, when
        recorded — quarantine-filtered under its OWN key (a point a
        similar device condemned never travels). Rows are deep copies
        sorted by device key, so downstream ranking is deterministic and
        cannot mutate the registry.
        """
        probe = json.loads(self.key(kernel, specialization, ""))
        out: list[tuple[str, dict[str, Any]]] = []
        with self._mu:
            for k, entry in self._table.items():
                try:
                    parsed = json.loads(k)
                except (json.JSONDecodeError, TypeError):
                    continue
                if (not isinstance(parsed, dict)
                        or parsed.get("k") != probe["k"]
                        or parsed.get("s") != probe["s"]):
                    continue
                dev = parsed.get("d")
                if (not isinstance(dev, str) or not dev
                        or dev == exclude_device):
                    continue
                if _canon(entry.get("point", {})) in self._quarantine.get(
                        k, {}):
                    continue
                out.append((dev, copy.deepcopy(entry)))
        out.sort(key=lambda row: row[0])
        return out

    def __len__(self) -> int:
        with self._mu:
            return len(self._table)

    # ---------------------------------------------------------- quarantine
    def quarantine(
        self,
        kernel: str,
        specialization: dict[str, Any],
        device: str,
        point: Point,
        reason: str = "",
    ) -> None:
        """Condemn ``point`` for this (kernel, spec, device) permanently.

        Drops a matching best entry (so warm starts can never seed it)
        and records the point + reason in the persisted quarantine table.
        """
        k = self.key(kernel, specialization, device)
        pk = _canon(dict(point))
        with self._mu:
            self._quarantine.setdefault(k, {})[pk] = str(reason)
            cur = self._table.get(k)
            if cur is not None and _canon(cur.get("point", {})) == pk:
                del self._table[k]

    def is_quarantined(
        self,
        kernel: str,
        specialization: dict[str, Any],
        device: str,
        point: Point,
    ) -> bool:
        k = self.key(kernel, specialization, device)
        with self._mu:
            return _canon(dict(point)) in self._quarantine.get(k, {})

    def quarantined_points(
        self, kernel: str, specialization: dict[str, Any], device: str
    ) -> list[Point]:
        """Condemned points under the exact key AND the legacy fallbacks."""
        out: list[Point] = []
        seen: set[str] = set()
        with self._mu:
            for dev in (device, *device_fallbacks(device)):
                k = self.key(kernel, specialization, dev)
                for pk in self._quarantine.get(k, {}):
                    if pk in seen:
                        continue
                    seen.add(pk)
                    try:
                        out.append(dict(json.loads(pk)))
                    except (json.JSONDecodeError, TypeError):
                        continue
        return out

    def fleet_quarantined_points(
        self, kernel: str, specialization: dict[str, Any]
    ) -> list[Point]:
        """Condemned points for this (kernel, spec) under ANY device key.

        The transfer plane's blocklist: a transfer seed that failed one
        device's oracle must never be re-seeded on any other device —
        the verdict travels with the registry, not with the device that
        paid for it.
        """
        probe = json.loads(self.key(kernel, specialization, ""))
        out: list[Point] = []
        seen: set[str] = set()
        with self._mu:
            for k, points in self._quarantine.items():
                try:
                    parsed = json.loads(k)
                except (json.JSONDecodeError, TypeError):
                    continue
                if (not isinstance(parsed, dict)
                        or parsed.get("k") != probe["k"]
                        or parsed.get("s") != probe["s"]):
                    continue
                for pk in points:
                    if pk in seen:
                        continue
                    seen.add(pk)
                    try:
                        out.append(dict(json.loads(pk)))
                    except (json.JSONDecodeError, TypeError):
                        continue
        return out

    @property
    def n_quarantined(self) -> int:
        with self._mu:
            return sum(len(v) for v in self._quarantine.values())

    # --------------------------------------------------------- evaluations
    def record_evaluation(
        self,
        kernel: str,
        specialization: dict[str, Any],
        device: str,
        point: Point,
        score_s: float,
    ) -> None:
        """Publish one measured (point, score) to the fleet ledger.

        Peers that merge this registry mark the point *seen* so it is
        never compiled twice per fleet. Keeps the best observed score per
        point (min merge is commutative, so sync order cannot change the
        merged state)."""
        k = self.key(kernel, specialization, device)
        pk = _canon(dict(point))
        s = float(score_s)
        with self._mu:
            evals = self._evaluations.setdefault(k, {})
            cur = evals.get(pk)
            if cur is None or s < cur:
                evals[pk] = s

    def evaluated_points(
        self, kernel: str, specialization: dict[str, Any], device: str
    ) -> list[Point]:
        """Points any replica has already measured under the exact key."""
        out: list[Point] = []
        with self._mu:
            k = self.key(kernel, specialization, device)
            for pk in self._evaluations.get(k, {}):
                try:
                    out.append(dict(json.loads(pk)))
                except (json.JSONDecodeError, TypeError):
                    continue
        return out

    @property
    def n_evaluations(self) -> int:
        with self._mu:
            return sum(len(v) for v in self._evaluations.values())

    # ---------------------------------------------------------- compaction
    @staticmethod
    def _entry_compiler(key: str) -> str | None:
        """Compiler version claimed by an entry's device key, if any."""
        try:
            device = json.loads(key).get("d", "")
        except (json.JSONDecodeError, AttributeError):
            return None
        parts = str(device).split(":")
        if len(parts) >= 3 and parts[2].startswith("torch"):
            return parts[2]
        # a versionless legacy key, or one of the JAX package's compilers:
        # no claim this package can test, so the entry is kept
        return None

    def _compact_locked(self) -> int:
        """Drop idle and foreign-compiler entries (caller holds the lock)."""
        current = compiler_version()
        dead = []
        for k, entry in self._table.items():
            claimed = self._entry_compiler(k)
            if claimed is not None and claimed != current:
                dead.append(k)
                continue
            if (self.max_idle_saves is not None
                    and self._generation - entry.get("gen", 0)
                    >= self.max_idle_saves):
                dead.append(k)
        for k in dead:
            del self._table[k]
        self.compacted_total += len(dead)
        # quarantine and evaluation ledgers only die with the compiler
        # that wrote them — the exact variants no longer exist afterwards
        for ledger in (self._quarantine, self._evaluations):
            for k in [k for k in ledger
                      if (c := self._entry_compiler(k)) is not None
                      and c != current]:
                del ledger[k]
        return len(dead)

    # ------------------------------------------------------------------ io
    def snapshot(self) -> dict[str, Any]:
        """Serializable full state — the unit the fleet backends merge."""
        with self._mu:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict[str, Any]:
        meta: dict[str, Any] = {"generation": self._generation}
        if self._quarantine:
            meta["quarantine"] = {
                k: dict(v) for k, v in self._quarantine.items()}
        if self._evaluations:
            meta["evaluations"] = {
                k: dict(v) for k, v in self._evaluations.items()}
        snapshot: dict[str, Any] = {_META_KEY: meta}
        snapshot.update({k: dict(v) for k, v in self._table.items()})
        return snapshot

    def merge_snapshot(self, snapshot: dict[str, Any]) -> None:
        """Fold a (peer-merged) snapshot into the live registry.

        Same join as :func:`merge_snapshots`: quarantine and evaluation
        ledgers union (a point condemned by ANY replica is condemned
        here), bests adopt only on a strictly better score, and a newly
        condemned best is dropped. Idempotent and commutative, so sync
        cadence and replica order cannot change the result.
        """
        if not isinstance(snapshot, dict):
            return
        meta = snapshot.get(_META_KEY)
        meta = meta if isinstance(meta, dict) else {}
        with self._mu:
            quar = meta.get("quarantine")
            if isinstance(quar, dict):
                for k, v in quar.items():
                    if not isinstance(v, dict):
                        continue
                    mine = self._quarantine.setdefault(k, {})
                    for pk, reason in v.items():
                        if pk not in mine or str(reason) < mine[pk]:
                            mine[pk] = str(reason)
            evals = meta.get("evaluations")
            if isinstance(evals, dict):
                for k, v in evals.items():
                    if not isinstance(v, dict):
                        continue
                    mine_e = self._evaluations.setdefault(k, {})
                    for pk, s in v.items():
                        if not isinstance(s, (int, float)):
                            continue
                        if pk not in mine_e or float(s) < mine_e[pk]:
                            mine_e[pk] = float(s)
            for k, entry in snapshot.items():
                if k == _META_KEY or not isinstance(entry, dict):
                    continue
                if (not isinstance(entry.get("point"), dict)
                        or not isinstance(entry.get("score_s"), (int, float))):
                    continue
                if _canon(entry["point"]) in self._quarantine.get(k, {}):
                    continue
                cur = self._table.get(k)
                if cur is None or float(entry["score_s"]) < cur["score_s"]:
                    adopted = dict(entry)
                    adopted["point"] = dict(entry["point"])
                    adopted["score_s"] = float(entry["score_s"])
                    adopted["gen"] = self._generation
                    if isinstance(entry.get("traits"), dict):
                        adopted["traits"] = dict(entry["traits"])
                    else:
                        adopted.pop("traits", None)
                    self._table[k] = adopted
                elif ("traits" not in cur
                        and isinstance(entry.get("traits"), dict)):
                    # trait union: the key names one device, so a peer's
                    # trait vector for it applies to the held best too —
                    # without this a traits-less side would flap the
                    # merged metadata across sync order
                    cur["traits"] = dict(entry["traits"])
            # fleet quarantine always wins over a previously held best
            for k in list(self._table):
                if (_canon(self._table[k].get("point", {}))
                        in self._quarantine.get(k, {})):
                    del self._table[k]

    def save(self, path: str) -> None:
        with self._mu:
            self._generation += 1
            self._compact_locked()
            snapshot = self._snapshot_locked()
        LocalBackend(path).write(snapshot)

    @classmethod
    def load(cls, path: str) -> "TunedRegistry":
        reg = cls()
        table = LocalBackend(path).read()
        if isinstance(table, dict):
            table = dict(table)
            meta = table.pop(_META_KEY, None)
            if isinstance(meta, dict):
                if isinstance(meta.get("generation"), int):
                    reg._generation = meta["generation"]
                quar = meta.get("quarantine")
                if isinstance(quar, dict):
                    reg._quarantine = {
                        k: {pk: str(r) for pk, r in v.items()}
                        for k, v in quar.items()
                        if isinstance(v, dict)
                    }
                evals = meta.get("evaluations")
                if isinstance(evals, dict):
                    reg._evaluations = {
                        k: {pk: float(s) for pk, s in v.items()
                            if isinstance(s, (int, float))}
                        for k, v in evals.items()
                        if isinstance(v, dict)
                    }
            reg._table = {
                k: v for k, v in table.items()
                if isinstance(v, dict)
                and isinstance(v.get("point"), dict)
                and isinstance(v.get("score_s"), (int, float))
            }
            # pre-aging files carry no stamps: treat every entry
            # as freshly used rather than instantly idle
            for v in reg._table.values():
                v.setdefault("gen", reg._generation)
        return reg


# ---------------------------------------------------------------- backends
def merge_snapshots(
    a: dict[str, Any], b: dict[str, Any]
) -> dict[str, Any]:
    """Deterministic commutative join of two registry snapshots.

    The fleet's merge rule, applied identically by every backend:

    * best entries — lower ``score_s`` wins per (kernel, spec,
      fingerprint) key (under monotone per-replica improvement this
      coincides with last-write-wins); exact score ties break on the
      canonical JSON of the entry so the result never depends on
      argument order;
    * per-entry device traits — unioned: the winning entry keeps its
      trait vector, and a winner missing one adopts a candidate's (the
      key names one device, so any candidate's traits describe it);
    * quarantine — unioned: a point condemned by ANY replica is
      condemned fleet-wide, and a condemned best is dropped;
    * evaluations — unioned with min-score: work any replica already
      paid for is never re-paid;
    * generation — max.

    Commutativity + idempotence make the fabric a state-based CRDT: the
    merged registry is byte-identical regardless of sync interleaving.
    """
    out: dict[str, Any] = {}
    meta_a = a.get(_META_KEY) if isinstance(a.get(_META_KEY), dict) else {}
    meta_b = b.get(_META_KEY) if isinstance(b.get(_META_KEY), dict) else {}
    gen = max(int(meta_a.get("generation") or 0),
              int(meta_b.get("generation") or 0))

    quarantine: dict[str, dict[str, str]] = {}
    for meta in (meta_a, meta_b):
        quar = meta.get("quarantine")
        if not isinstance(quar, dict):
            continue
        for k, v in quar.items():
            if not isinstance(v, dict):
                continue
            merged = quarantine.setdefault(k, {})
            for pk, reason in v.items():
                if pk not in merged or str(reason) < merged[pk]:
                    merged[pk] = str(reason)

    evaluations: dict[str, dict[str, float]] = {}
    for meta in (meta_a, meta_b):
        evals = meta.get("evaluations")
        if not isinstance(evals, dict):
            continue
        for k, v in evals.items():
            if not isinstance(v, dict):
                continue
            merged_e = evaluations.setdefault(k, {})
            for pk, s in v.items():
                if not isinstance(s, (int, float)):
                    continue
                if pk not in merged_e or float(s) < merged_e[pk]:
                    merged_e[pk] = float(s)

    def _valid(entry: Any) -> bool:
        return (isinstance(entry, dict)
                and isinstance(entry.get("point"), dict)
                and isinstance(entry.get("score_s"), (int, float)))

    for k in sorted(set(a) | set(b)):
        if k == _META_KEY:
            continue
        ea, eb = a.get(k), b.get(k)
        candidates = [e for e in (ea, eb) if _valid(e)]
        candidates = [e for e in candidates
                      if _canon(e["point"]) not in quarantine.get(k, {})]
        if not candidates:
            continue
        winner = copy.deepcopy(min(
            candidates,
            key=lambda e: (float(e["score_s"]), _canon(e))))
        # trait union: the key names ONE device, so any candidate's trait
        # vector describes the winner's device too. A winner missing its
        # traits adopts the (deterministically chosen) donor's — without
        # this, merging {entry+traits} with {entry} would keep or drop
        # the metadata depending on argument order.
        if not isinstance(winner.get("traits"), dict):
            winner.pop("traits", None)
            donors = [e["traits"] for e in candidates
                      if isinstance(e.get("traits"), dict)]
            if donors:
                winner["traits"] = copy.deepcopy(min(donors, key=_canon))
        out[k] = winner

    meta: dict[str, Any] = {"generation": gen}
    if quarantine:
        meta["quarantine"] = quarantine
    if evaluations:
        meta["evaluations"] = evaluations
    out[_META_KEY] = meta
    return out


class RegistryBackend:
    """Where a :class:`TunedRegistry` synchronizes its state.

    One method matters: ``sync(snapshot)`` publishes this replica's
    snapshot, merges it with whatever the fleet has already published
    (per :func:`merge_snapshots`) and returns the merged state for the
    caller to adopt via :meth:`TunedRegistry.merge_snapshot`. Backends
    must make the merge atomic against concurrent replicas.
    """

    def sync(self, snapshot: dict[str, Any]) -> dict[str, Any]:
        raise NotImplementedError


class LocalBackend(RegistryBackend):
    """Single-writer JSON file — the classic per-process registry.

    ``write`` publishes via write-temp-then-``os.replace`` so a reader
    (or a crash) can never observe a torn file; ``read`` degrades a
    corrupt or missing file to a cold start. ``sync`` is last-writer-
    wins wholesale: there are no peers to merge with.
    """

    def __init__(self, path: str) -> None:
        self.path = str(path)

    def read(self) -> dict[str, Any] | None:
        if not os.path.exists(self.path):
            return None
        # A registry is a cache: a corrupt or partially-written file
        # must degrade to a cold start, never crash the process.
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError, UnicodeDecodeError):
            return None
        return data if isinstance(data, dict) else None

    def write(self, snapshot: dict[str, Any]) -> None:
        parent = os.path.dirname(self.path) or "."
        os.makedirs(parent, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=parent)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(snapshot, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)  # atomic publish
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def sync(self, snapshot: dict[str, Any]) -> dict[str, Any]:
        self.write(snapshot)
        return snapshot


class SharedFileBackend(LocalBackend):
    """One JSON file shared by N replicas, serialized by a lock file.

    ``sync`` takes the lock (``O_CREAT | O_EXCL`` — works on any shared
    filesystem), merges the caller's snapshot with the file contents
    under :func:`merge_snapshots`, publishes atomically via
    temp-then-rename, releases the lock, and returns the merged state.
    A crash between lock and publish leaves the previous file intact; a
    crash that leaks the lock is healed by stale-lock takeover — a lock
    older than ``stale_lock_s`` is broken and re-contested.
    """

    def __init__(
        self,
        path: str,
        *,
        lock_timeout_s: float = 10.0,
        stale_lock_s: float = 30.0,
        poll_s: float = 0.005,
    ) -> None:
        super().__init__(path)
        self.lock_path = self.path + ".lock"
        self.lock_timeout_s = float(lock_timeout_s)
        self.stale_lock_s = float(stale_lock_s)
        self.poll_s = float(poll_s)
        self.syncs = 0
        self.stale_takeovers = 0

    def _acquire_lock(self) -> None:
        parent = os.path.dirname(self.path) or "."
        os.makedirs(parent, exist_ok=True)
        deadline = time.monotonic() + self.lock_timeout_s
        while True:
            try:
                fd = os.open(self.lock_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with os.fdopen(fd, "w") as f:
                    f.write(str(os.getpid()))
                return
            except FileExistsError:
                try:
                    age = time.time() - os.path.getmtime(self.lock_path)
                except OSError:
                    continue  # holder released between open and stat
                if age > self.stale_lock_s:
                    # holder died mid-sync: break the lock and re-contest
                    # (unlink is idempotent if another waiter won the race)
                    try:
                        os.unlink(self.lock_path)
                        self.stale_takeovers += 1
                    except OSError:
                        pass
                    continue
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"registry lock {self.lock_path} held for "
                        f"{age:.1f}s (timeout {self.lock_timeout_s}s)")
                time.sleep(self.poll_s)

    def _release_lock(self) -> None:
        try:
            os.unlink(self.lock_path)
        except OSError:
            pass

    def sync(self, snapshot: dict[str, Any]) -> dict[str, Any]:
        self._acquire_lock()
        try:
            on_disk = self.read() or {}
            merged = merge_snapshots(on_disk, snapshot)
            self.write(merged)
        finally:
            self._release_lock()
        self.syncs += 1
        return merged


class FleetBus(RegistryBackend):
    """In-memory fleet backend for tests and virtual-clock benchmarks.

    Same merge semantics as :class:`SharedFileBackend`, no filesystem:
    N in-process replicas share one bus instance and observe each
    other's bests, evaluations and quarantines at every ``sync``.
    """

    def __init__(self) -> None:
        self._state: dict[str, Any] = {}
        self._mu = threading.Lock()
        self.syncs = 0

    def sync(self, snapshot: dict[str, Any]) -> dict[str, Any]:
        with self._mu:
            self._state = merge_snapshots(self._state, snapshot)
            self.syncs += 1
            return copy.deepcopy(self._state)

    def peek(self) -> dict[str, Any]:
        """Current merged fleet state (read-only copy, no publish)."""
        with self._mu:
            return copy.deepcopy(self._state)
