"""Device memory accounting and the cache of materialized relations.

The device half of ``spark_tpu/memory.py``.  The reference splits a fixed
heap between EXECUTION (a query's working memory) and STORAGE (cached
blocks), with storage evictable down to a protected floor —
``UnifiedMemoryManager.scala:47`` — and tracks cached relations in
``CacheManager.scala`` / ``InMemoryRelation.scala``.  Here the accounted
resource is the card's memory:

- the budget is ``spark.tpu.memory.hbmBudget`` when set, else the card's
  total memory (``torch.cuda.mem_get_info``), else 16 GiB (a CPU session);
- EXECUTION reservations are made by the planner for a query's leaf
  batches and static operator buffers *before* dispatch
  (``planner._plan_reserve_bytes``), so a query that cannot fit fails
  with ``HBMOutOfMemoryError`` naming itself instead of dying inside the
  allocator;
- STORAGE has two tenants.  The stage cache's captured graphs: each
  graph's private memory pool stays allocated between replays and is
  charged under ``stage:<key>``.  Cached relations (``df.cache``,
  ``DeviceCacheManager``): a DEVICE entry's batch is charged under
  ``cache:<key>``.  Under pressure a cached relation demotes DEVICE ->
  HOST_COMPRESSED (columnar RLE / dictionary / byte-codec blocks,
  ``codec.py``) and is promoted back on its next use; a graph is
  dropped.

**One eviction rule for both tenants.**  The memory manager has one
eviction callback; the session sets it to ``evict_lru`` over both
tenants.  Every use of a graph (a stage-cache hit, build or dispatch)
and of a cached relation (``put``, ``get``) takes a tick of one shared
clock (``tick``); eviction takes the holder of the OLDEST tick first,
whichever tenant it belongs to, until the bytes asked for are free.  A
hot relation outlives a cold graph, and a hot graph a cold relation.  A
graph that a query is running is never taken.

**Lock order.**  The cache manager shares the memory manager's lock (an
``RLock``; the callback runs under it), and the stage cache's own lock
is always taken after it: the stage cache releases dropped entries
outside its lock (``stagecompile._release``).

On a ``cuda`` session a HOST entry and a decompressed host copy live in
pinned memory, so a query over an entry that stays on the host reaches a
captured graph by ``non_blocking`` copies, as a file leaf does.  Every
batch served under one entry carries the entry's ``_cache_uid``, through
demotion, decompression and promotion, so plans over it keep their stage
key and plan-cache fingerprint.

**Host memory.**  ``HostMemoryLedger`` is the host twin of the execution
pool for the cross-process shuffle (``parallel/hostshuffle.py``,
``parallel/crossproc.py``): owner-keyed reservations of host bytes —
bucketed map output (read back into a pinned staging buffer on a card,
which the map side's reservation covers), fetched blocks, drained
shards — under ``spark.tpu.memory.hostBudget``.  It has no eviction:
a reserver that cannot fit spills (``try_reserve`` is False) or fails
structured (``reserve`` raises ``HostMemoryError``).
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import codec as codec_mod
from . import config as C
from .columnar import ColumnBatch, ColumnVector

HBM_BUDGET = C.conf("spark.tpu.memory.hbmBudget").doc(
    "Device memory budget in bytes for execution+storage accounting; 0 = "
    "the card's total memory (torch.cuda.mem_get_info; 16 GiB for a CPU "
    "session)."
).int(0)

STORAGE_FRACTION = C.conf("spark.tpu.memory.storageFraction").doc(
    "Fraction of the device memory budget protected for storage (the "
    "stage cache's graph pools and cached relations) before execution "
    "reservations may force eviction (UnifiedMemoryManager's "
    "spark.memory.storageFraction analog)."
).float(0.3)

CACHE_CODEC = C.conf("spark.tpu.cache.codec").doc(
    "Byte codec for HOST_COMPRESSED cache blocks: one of codec.CODECS "
    "(zlib/lzma/bz2 always; lz4/zstd when their wheels are present)."
).string("zlib")


HOST_BUDGET = C.conf("spark.tpu.memory.hostBudget").doc(
    "Host-RAM budget in bytes for the shuffle path's exchange staging "
    "(bucketed map output, fetched blocks, drained shards); 0 = the "
    "machine's physical RAM (psutil, else os.sysconf; 16 GiB when "
    "unknown).  Sides that cannot reserve spill to disk instead of "
    "growing unbounded."
).check(lambda v: v >= 0).int(0)


class HBMOutOfMemoryError(MemoryError):
    """Execution reservation cannot fit even after evicting all unpinned
    storage (SparkOutOfMemoryError analog)."""


class HostMemoryError(MemoryError):
    """Host-RAM staging can proceed NEITHER in memory nor via spill (a
    disk error, or the ledger exhausted by concurrent reservers): the
    query fails bounded with the reserver and exchange named, never with
    partial results."""

    def __init__(self, owner: str, requested: int, budget: int,
                 holders: Optional[Dict[str, int]] = None,
                 exchange: str = "", detail: str = ""):
        self.owner = owner
        self.requested = requested
        self.budget = budget
        self.holders = dict(holders or {})
        self.exchange = exchange
        self.detail = detail
        held = sum(self.holders.values())
        msg = (f"{owner}: cannot stage {requested} B"
               f"{' for exchange ' + exchange if exchange else ''} "
               f"(host budget {budget} B, held {held} B by "
               f"{len(self.holders)} reserver(s))")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class HostMemoryPressure(HostMemoryError):
    """A ledger reservation failed where a DEGRADED mode can still finish
    the query (a distributed join's drained post-exchange shard, which the
    grace path re-buckets to disk and joins piecewise).  The raiser leaves
    the underlying state intact and re-consumable; a caller with no grace
    path treats it as its ``HostMemoryError`` base."""


def batch_nbytes(batch: ColumnBatch) -> int:
    """Bytes a batch holds: data, validity masks, row mask.  A lazy run
    vector charges its run table (values and int64 lengths), a run plane
    its two plane tensors, not the rows they stand for."""
    from .columnar import unexpanded_plane, unmaterialized_runs
    total = 0
    for v in batch.vectors:
        runs = unmaterialized_runs(v)
        plane = unexpanded_plane(v)
        if runs is not None:
            total += (runs.run_values.numel() * runs.run_values.element_size()
                      + runs.run_lengths.numel() * 8)
        elif plane is not None:
            total += plane.plane_capacity * (
                plane.plane_values.element_size() + 8)
        else:
            # an array column is a (capacity, max_len) plane
            total += np.dtype(v.dtype.np_dtype).itemsize * int(
                v.data.numel())
        if v.valid is not None:
            total += batch.capacity
    if batch.row_valid is not None:
        total += batch.capacity
    return total


def _device_budget(conf, device=None) -> int:
    fixed = conf.get(HBM_BUDGET)
    if fixed:
        return fixed
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total)
    return 16 << 30


class MemoryManager:
    """Execution/storage split over one device budget with storage
    eviction."""

    def __init__(self, conf, device=None):
        self._conf = conf
        self._lock = threading.RLock()
        self.budget = _device_budget(conf, device)
        self.storage_floor = int(self.budget * conf.get(STORAGE_FRACTION))
        self._execution: Dict[str, int] = {}
        self._storage: Dict[str, int] = {}
        self._evict_cb: Optional[Callable[[int], int]] = None

    # -- introspection ------------------------------------------------------
    @property
    def execution_used(self) -> int:
        return sum(self._execution.values())

    @property
    def storage_used(self) -> int:
        return sum(self._storage.values())

    @property
    def free(self) -> int:
        return self.budget - self.execution_used - self.storage_used

    def storage_held(self, key: str) -> int:
        with self._lock:
            return self._storage.get(key, 0)

    def set_eviction_callback(self, cb: Callable[[int], int]) -> None:
        """cb(nbytes_needed) -> bytes actually released."""
        self._evict_cb = cb

    # -- execution pool -----------------------------------------------------
    def acquire_execution(self, owner: str, nbytes: int) -> None:
        with self._lock:
            if nbytes > self.free and self._evict_cb is not None:
                # evict storage above the protected floor
                evictable = max(0, self.storage_used - self.storage_floor)
                want = min(nbytes - self.free, evictable)
                if want > 0:
                    self._evict_cb(want)
            if nbytes > self.free:
                raise HBMOutOfMemoryError(
                    f"{owner}: need {nbytes} B, free {self.free} B of "
                    f"{self.budget} B (execution {self.execution_used} B, "
                    f"storage {self.storage_used} B)")
            self._execution[owner] = self._execution.get(owner, 0) + nbytes

    def release_execution(self, owner: str) -> None:
        with self._lock:
            self._execution.pop(owner, None)

    def execution_held(self, owner: str) -> int:
        """Bytes an owner still holds (0 = clean)."""
        with self._lock:
            return self._execution.get(owner, 0)

    # -- storage pool -------------------------------------------------------
    def try_acquire_storage(self, key: str, nbytes: int) -> bool:
        with self._lock:
            if nbytes > self.free and self._evict_cb is not None:
                self._evict_cb(nbytes - self.free)
            if nbytes > self.free:
                return False
            self._storage[key] = self._storage.get(key, 0) + nbytes
            return True

    def release_storage(self, key: str) -> None:
        with self._lock:
            self._storage.pop(key, None)


# ---------------------------------------------------------------------------
# one LRU over the storage tenants
# ---------------------------------------------------------------------------

_TICKS = itertools.count(1)


def tick() -> int:
    """The shared clock of storage use: a later use, a larger tick."""
    return next(_TICKS)


def evict_lru(memory: MemoryManager, nbytes: int, tenants: Sequence) -> int:
    """Release at least ``nbytes`` of ``memory``'s storage, oldest use
    first across ``tenants`` (the eviction callback of a session).  Each
    tenant's ``eviction_candidates(memory)`` gives ``(last tick, evict)``
    pairs, ``evict()`` the bytes it released.  Returns the bytes
    released."""
    candidates = []
    for tenant in tenants:
        candidates.extend(tenant.eviction_candidates(memory))
    candidates.sort(key=lambda c: c[0])
    freed = 0
    for _last, evict in candidates:
        if freed >= nbytes:
            break
        freed += evict()
    return freed


# ---------------------------------------------------------------------------
# storage levels & cached entries
# ---------------------------------------------------------------------------

class StorageLevel:
    DEVICE = "DEVICE"                      # on the card (MEMORY_ONLY)
    HOST = "HOST"                          # host tensors (MEMORY_AND_DISK)
    HOST_COMPRESSED = "HOST_COMPRESSED"    # codec blocks (compressed cache)


LEVELS = (StorageLevel.DEVICE, StorageLevel.HOST,
          StorageLevel.HOST_COMPRESSED)


class _Entry:
    __slots__ = ("key", "level", "requested", "batch", "blocks", "nbytes",
                 "last_used", "uid")

    def __init__(self, key, level, requested, batch, nbytes, uid):
        self.key = key
        self.level = level
        self.requested = requested
        self.batch = batch            # device or host ColumnBatch
        self.blocks = None            # HOST_COMPRESSED payload
        self.nbytes = nbytes
        self.last_used = tick()
        self.uid = uid                # stable plan-key identity (see get)

    @property
    def storage_key(self) -> str:
        return f"cache:{self.key}"


def _compress_batch(batch: ColumnBatch, codec_name: str):
    """The batch as codec blocks, read to the host in one packed copy."""
    host = batch.packed_host()
    cols = []
    for v in host.vectors:
        enc = codec_mod.encode_column(v.data.numpy(), codec_name)
        validity = (None if v.valid is None
                    else np.packbits(v.valid.numpy()))
        cols.append((enc, validity, v.dtype, v.dictionary))
    rv = (None if host.row_valid is None
          else np.packbits(host.row_valid.numpy()))
    return (host.names, cols, rv, host.capacity)


def _decompress_batch(blocks) -> ColumnBatch:
    names, cols, rv, capacity = blocks

    def bits(packed):
        return None if packed is None else torch.from_numpy(
            np.unpackbits(packed)[:capacity].astype(bool))
    vectors = [ColumnVector(torch.from_numpy(codec_mod.decode_column(enc)),
                            dt, bits(validity), dictionary)
               for enc, validity, dt, dictionary in cols]
    return ColumnBatch(names, vectors, bits(rv), capacity)


def _blocks_nbytes(blocks) -> int:
    return sum(c[0].nbytes for c in blocks[1])


class DeviceCacheManager:
    """Plan-keyed cached relations with demotion and LRU eviction
    (``CacheManager.scala`` analog).  A session holds one
    (``session.cacheManager``); its entries are a storage tenant of the
    session's ``MemoryManager`` beside the stage cache's graphs."""

    def __init__(self, memory: MemoryManager, conf, device=None):
        self._memory = memory
        self._conf = conf
        self._device = torch.device(device if device is not None else "cpu")
        self._entries: Dict[str, _Entry] = {}
        # ONE lock with the memory manager: eviction runs under it, and a
        # second lock here would order-invert (put -> try_acquire_storage
        # vs acquire_execution -> evict)
        self._lock = memory._lock

    def _host(self, batch: ColumnBatch) -> ColumnBatch:
        """``batch`` on the host; in pinned memory on a card session."""
        host = batch.to_host()
        if self._device.type == "cuda" and not host.is_pinned():
            host = host.pinned()
        return host

    # -- public -------------------------------------------------------------
    def put(self, key: str, batch: ColumnBatch,
            level: str = StorageLevel.DEVICE) -> None:
        if level not in LEVELS:
            raise ValueError(
                f"unknown storage level {level!r}; expected one of "
                f"StorageLevel.DEVICE/HOST/HOST_COMPRESSED")
        from .sql.logical import _batch_uid
        with self._lock:
            self.remove(key)
            entry = _Entry(key, level, level, None, batch_nbytes(batch),
                           _batch_uid(batch))
            if level == StorageLevel.DEVICE:
                if self._memory.try_acquire_storage(entry.storage_key,
                                                    entry.nbytes):
                    entry.batch = batch.to_device(self._device)
                else:                      # no room: demote on entry
                    entry.level = StorageLevel.HOST
                    entry.batch = self._host(batch)
            elif level == StorageLevel.HOST:
                entry.batch = self._host(batch)
            else:
                entry.blocks = _compress_batch(
                    batch, self._conf.get(CACHE_CODEC))
                entry.nbytes = _blocks_nbytes(entry.blocks)
            self._entries[key] = entry

    def get(self, key: str) -> Optional[ColumnBatch]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            entry.last_used = tick()
            if entry.batch is None:       # decompress ONCE; keep the
                entry.batch = self._host(  # host copy
                    _decompress_batch(entry.blocks))
            batch = entry.batch
            # promote back toward the requested level — both decompressed
            # blocks and entries put on the host because the card was full
            if entry.level != StorageLevel.DEVICE \
                    and entry.requested == StorageLevel.DEVICE \
                    and self._memory.try_acquire_storage(
                        entry.storage_key, batch_nbytes(batch)):
                entry.batch = batch = batch.to_device(self._device)
                entry.blocks = None
                entry.level = StorageLevel.DEVICE
                entry.nbytes = batch_nbytes(batch)
            # every object served under this key carries the SAME uid, so
            # plan keys over a cached batch (cache-on-cache, stage keys,
            # plan-cache fingerprints) stay stable across demote /
            # decompress / promote
            batch._cache_uid = entry.uid
            return batch

    def level(self, key: str) -> Optional[str]:
        with self._lock:
            entry = self._entries.get(key)
            return None if entry is None else entry.level

    def remove(self, key: str) -> bool:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return False
            if entry.level == StorageLevel.DEVICE:
                self._memory.release_storage(entry.storage_key)
            return True

    def clear(self) -> None:
        with self._lock:
            for key in list(self._entries):
                self.remove(key)

    def entries(self) -> List[dict]:
        with self._lock:
            return [{"key": e.key, "level": e.level, "nbytes": e.nbytes,
                     "uid": e.uid} for e in self._entries.values()]

    # -- eviction (a storage tenant of ``evict_lru``) -------------------------
    def eviction_candidates(self, memory: MemoryManager) -> list:
        if memory is not self._memory:
            return []
        with self._lock:
            return [(e.last_used, lambda e=e: self._demote(e))
                    for e in self._entries.values()
                    if e.level == StorageLevel.DEVICE]

    def _demote(self, entry: _Entry) -> int:
        """DEVICE -> HOST_COMPRESSED; returns the device bytes freed."""
        with self._lock:
            if self._entries.get(entry.key) is not entry \
                    or entry.level != StorageLevel.DEVICE:
                return 0
            entry.blocks = _compress_batch(entry.batch,
                                           self._conf.get(CACHE_CODEC))
            entry.batch = None            # get() decompresses and promotes
            entry.level = StorageLevel.HOST_COMPRESSED
            freed = self._memory.storage_held(entry.storage_key)
            self._memory.release_storage(entry.storage_key)
            entry.nbytes = _blocks_nbytes(entry.blocks)
            return freed


# ---------------------------------------------------------------------------
# the host memory ledger (cross-process exchange staging)
# ---------------------------------------------------------------------------

def discover_host_budget() -> int:
    """Physical host RAM in bytes: psutil when it is installed, else
    ``os.sysconf``, else 16 GiB."""
    try:
        import psutil
        return int(psutil.virtual_memory().total)
    except Exception:
        pass
    try:
        return int(os.sysconf("SC_PAGE_SIZE")) * int(os.sysconf("SC_PHYS_PAGES"))
    except (AttributeError, OSError, ValueError):
        return 16 << 30


class HostMemoryLedger:
    """Owner-keyed host-RAM reservations for the shuffle staging path
    (``spark_tpu/memory.py`` ``HostMemoryLedger``).

    Over-budget reservers either spill (``try_reserve`` returns False) or
    fail structured (``reserve`` raises ``HostMemoryError``).  ``peak`` is
    the high-water mark of accounted bytes (the ``peak_host_bytes``
    gauge)."""

    def __init__(self, conf=None, budget: Optional[int] = None):
        #: a budget given here is fixed; else ``budget`` follows the conf
        self._fixed = None if budget is None else int(budget)
        self._conf = conf
        self._discovered: Optional[int] = None
        self._lock = threading.Lock()
        self._held: Dict[str, int] = {}
        self.peak = 0

    @property
    def budget(self) -> int:
        """The given budget, else ``spark.tpu.memory.hostBudget`` as the
        conf holds it now (0 = the host's RAM).  The reference reads the
        conf once, when the ledger is built (ROADMAP §3)."""
        if self._fixed is not None:
            return self._fixed
        fixed = self._conf.get(HOST_BUDGET) if self._conf is not None else 0
        if fixed:
            return int(fixed)
        if self._discovered is None:
            self._discovered = discover_host_budget()
        return self._discovered

    @property
    def used(self) -> int:
        with self._lock:
            return sum(self._held.values())

    @property
    def free(self) -> int:
        return self.budget - self.used

    def held(self, owner: str) -> int:
        with self._lock:
            return self._held.get(owner, 0)

    def owners(self) -> List[str]:
        with self._lock:
            return list(self._held)

    def try_reserve(self, owner: str, nbytes: int) -> bool:
        nbytes = int(nbytes)
        with self._lock:
            used = sum(self._held.values())
            if used + nbytes > self.budget:
                return False
            self._held[owner] = self._held.get(owner, 0) + nbytes
            self.peak = max(self.peak, used + nbytes)
            return True

    def reserve(self, owner: str, nbytes: int, exchange: str = "") -> None:
        if not self.try_reserve(owner, nbytes):
            with self._lock:
                holders = dict(self._held)
            raise HostMemoryError(owner, int(nbytes), self.budget,
                                  holders=holders, exchange=exchange)

    def release(self, owner: str, nbytes: Optional[int] = None) -> None:
        with self._lock:
            if nbytes is None:
                self._held.pop(owner, None)
                return
            left = self._held.get(owner, 0) - int(nbytes)
            if left > 0:
                self._held[owner] = left
            else:
                self._held.pop(owner, None)

    def release_prefix(self, prefix: str) -> int:
        """Drop every reservation whose owner starts with ``prefix`` (the
        query-exit safety net against leaks on error paths); returns the
        bytes freed."""
        freed = 0
        with self._lock:
            for owner in [o for o in self._held if o.startswith(prefix)]:
                freed += self._held.pop(owner)
        return freed
