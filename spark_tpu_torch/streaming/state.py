"""Versioned key-value state store for stateful streaming operators.

The reference's ``HDFSBackedStateStoreProvider.scala`` keeps per-operator,
per-partition versioned maps: every micro-batch commits version N as a
DELTA file (puts + removes), a full SNAPSHOT is written every
``stateSnapshotInterval`` commits, and ``load(N)`` replays the nearest
snapshot plus deltas.  Recovery after any crash loads the version the
commit log names.

Keys and values are plain Python objects pickled per delta: this store
backs arbitrary stateful operators (flatMapGroupsWithState), whose user
function runs on the host; the columnar aggregation and deduplication
state (``core.AggregationState`` / ``core.DedupState``) lives on the
session's device instead.

Layout under <checkpoint>/state/<operator_id>/<partition_id>/:
    1.delta 2.delta 3.snapshot 4.delta ...
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Iterator, Optional, Tuple

from .. import config as C

SNAPSHOT_INTERVAL = C.conf("spark.tpu.streaming.stateSnapshotInterval").doc(
    "Commits between full state snapshots; deltas replay on top "
    "(minDeltasForSnapshot analog)."
).int(10)

STATE_RETAIN = C.conf("spark.tpu.streaming.stateMinVersionsToRetain").doc(
    "Committed versions kept for recovery before maintenance deletes "
    "their files (minVersionsToRetain analog)."
).int(2)


def snapshot_file(directory: str, version: int) -> str:
    """The path of a full state snapshot of ``version`` under
    ``directory``: the one spelling of the ``.snapshot`` block name,
    for the versioned store here and ``core.AggregationState``."""
    return os.path.join(directory, f"{version}.snapshot")


class StateStore:
    """One loaded version of a partition's state, staged for one commit.

    get/put/remove stage changes; ``commit()`` durably writes version+1
    and returns it; ``abort()`` discards.  Mirrors ``StateStore.scala``'s
    one-store-per-task lifecycle."""

    def __init__(self, provider: "StateStoreProvider", version: int,
                 data: Dict[Any, Any]):
        self._provider = provider
        self.version = version
        self._data = data
        self._puts: Dict[Any, Any] = {}
        self._removes: set = set()
        self._done = False

    # -- reads --------------------------------------------------------------
    def get(self, key, default=None):
        if key in self._removes:
            return default
        if key in self._puts:
            return self._puts[key]
        return self._data.get(key, default)

    def contains(self, key) -> bool:
        sentinel = object()
        return self.get(key, sentinel) is not sentinel

    def iterator(self) -> Iterator[Tuple[Any, Any]]:
        for k, v in self._data.items():
            if k not in self._removes and k not in self._puts:
                yield k, v
        for k, v in self._puts.items():
            yield k, v

    def __len__(self) -> int:
        n = sum(1 for k in self._data
                if k not in self._removes and k not in self._puts)
        return n + len(self._puts)

    # -- writes -------------------------------------------------------------
    def put(self, key, value) -> None:
        assert not self._done, "store already committed/aborted"
        self._removes.discard(key)
        self._puts[key] = value

    def remove(self, key) -> None:
        assert not self._done, "store already committed/aborted"
        self._puts.pop(key, None)
        if key in self._data:
            self._removes.add(key)

    # -- lifecycle ----------------------------------------------------------
    def commit(self) -> int:
        assert not self._done, "store already committed/aborted"
        self._done = True
        new = dict(self._data)
        for k in self._removes:
            new.pop(k, None)
        new.update(self._puts)
        return self._provider._commit(
            self.version + 1, new, self._puts, self._removes)

    def abort(self) -> None:
        self._done = True


class StateStoreProvider:
    """Versioned persistence for one (operator, partition) state."""

    def __init__(self, checkpoint_dir: str, operator_id: int = 0,
                 partition_id: int = 0, conf=None,
                 ledger_supplier=None, ledger_owner: Optional[str] = None,
                 on_commit=None):
        conf = conf or C.Conf()
        self.dir = os.path.join(checkpoint_dir, "state", str(operator_id),
                                str(partition_id))
        os.makedirs(self.dir, exist_ok=True)
        self.snapshot_interval = conf.get(SNAPSHOT_INTERVAL)
        self.retain = conf.get(STATE_RETAIN)
        # block-service registrar: called with the committed version
        # after each durable state write so the owning stream renews its
        # checkpoint lease with the block service (blockserver.py) —
        # state files stay 'live' to the orphan reaper while commits flow
        self._on_commit = on_commit
        self._cache: Dict[int, Dict[Any, Any]] = {}   # version → full map
        self._bytes: Dict[int, int] = {}    # version → resident estimate
        # host-ledger tenancy: cached (host-resident) versions are
        # accounted under ledger_owner; over budget, old versions leave
        # the cache — they stay reconstructable from delta/snapshot
        # files, so this is a spill, never a loss
        self._ledger_supplier = ledger_supplier or (lambda: None)
        self._ledger_owner = ledger_owner or f"statestore:{self.dir}"
        self.versions_spilled = 0

    # -- loading ------------------------------------------------------------
    def _files(self) -> Dict[int, str]:
        out = {}
        for name in os.listdir(self.dir):
            stem, _, kind = name.partition(".")
            if kind in ("delta", "snapshot") and stem.isdigit():
                v = int(stem)
                # snapshot wins over a delta of the same version
                if kind == "snapshot" or v not in out:
                    out[v] = name
        return out

    def latest_version(self) -> int:
        files = self._files()
        return max(files) if files else 0

    def get_store(self, version: Optional[int] = None) -> StateStore:
        """Load ``version`` (default latest) and stage the next commit."""
        v = self.latest_version() if version is None else version
        return StateStore(self, v, dict(self._load(v)))

    def _load(self, version: int) -> Dict[Any, Any]:
        if version == 0:
            return {}
        if version in self._cache:
            return self._cache[version]
        files = self._files()
        if version not in files:
            raise ValueError(
                f"state version {version} not found under {self.dir} "
                f"(have {sorted(files)})")
        # walk back to the nearest snapshot, replay deltas forward
        base = version
        while base > 0 and files.get(base, "").endswith(".delta"):
            base -= 1
        state: Dict[Any, Any] = {}
        if base > 0:
            with open(os.path.join(self.dir, files[base]), "rb") as f:
                state = pickle.load(f)
        for v in range(base + 1, version + 1):
            with open(os.path.join(self.dir, files[v]), "rb") as f:
                puts, removes = pickle.load(f)
            for k in removes:
                state.pop(k, None)
            state.update(puts)
        self._cache[version] = state
        self._bytes[version] = len(pickle.dumps(state))
        self._account(version)
        return state

    # -- committing ---------------------------------------------------------
    def _commit(self, version: int, full: Dict[Any, Any],
                puts: Dict[Any, Any], removes: set) -> int:
        if version % self.snapshot_interval == 0:
            name, payload = f"{version}.snapshot", full
        else:
            name, payload = f"{version}.delta", (puts, removes)
        tmp = os.path.join(self.dir, name + ".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, name))
        self._cache[version] = full
        self._bytes[version] = len(pickle.dumps(full))
        self.maintenance(version)
        self._account(version)
        if self._on_commit is not None:
            self._on_commit(version)
        return version

    def _account(self, current: int) -> None:
        """Re-reserve the cache's resident bytes; on rejection spill the
        oldest non-current versions out of the host cache (their files
        stay — ``_load`` reconstructs on demand)."""
        ledger = self._ledger_supplier()
        if ledger is None:
            return
        ledger.release(self._ledger_owner)
        total = sum(self._bytes.get(v, 0) for v in self._cache)
        while total and not ledger.try_reserve(self._ledger_owner, total):
            old = [v for v in sorted(self._cache) if v != current]
            if not old:
                # the current version alone is over budget: keep it
                # resident unaccounted rather than thrash reload it
                return
            v = old[0]
            del self._cache[v]
            total -= self._bytes.pop(v, 0)
            self.versions_spilled += 1

    def maintenance(self, current: int) -> None:
        """Drop cache entries and files older than the retention window,
        keeping every file needed to reconstruct retained versions."""
        floor = current - self.retain
        if floor <= 0:
            return
        files = self._files()
        # the nearest snapshot at-or-before the floor anchors the replay
        anchor = floor
        while anchor > 0 and files.get(anchor, "").endswith(".delta"):
            anchor -= 1
        for v, name in files.items():
            if v < anchor:
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass
        for v in list(self._cache):
            if v < current - self.retain:
                del self._cache[v]
                self._bytes.pop(v, None)
