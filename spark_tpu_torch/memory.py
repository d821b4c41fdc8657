"""Device memory accounting: the device half of ``spark_tpu/memory.py``.

The reference splits a fixed heap between EXECUTION (a query's working
memory) and STORAGE (cached blocks), with storage evictable down to a
protected floor — ``UnifiedMemoryManager.scala:47``.  Here the accounted
resource is the card's memory:

- the budget is ``spark.tpu.memory.hbmBudget`` when set, else the card's
  total memory (``torch.cuda.mem_get_info``), else 16 GiB (a CPU session);
- EXECUTION reservations are made by the planner for a query's leaf
  batches and static operator buffers *before* dispatch
  (``planner._plan_reserve_bytes``), so a query that cannot fit fails
  with ``HBMOutOfMemoryError`` naming itself instead of dying inside the
  allocator;
- STORAGE holds what outlives a query.  In this slice that is the stage
  cache's captured graphs: each graph's private memory pool stays
  allocated between replays and is charged under ``stage:<key>``; the
  eviction callback drops the least recently used graphs.  Cached
  relations (``df.cache``) come with the cache slice.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import config as C
from .columnar import ColumnBatch

HBM_BUDGET = C.conf("spark.tpu.memory.hbmBudget").doc(
    "Device memory budget in bytes for execution+storage accounting; 0 = "
    "the card's total memory (torch.cuda.mem_get_info; 16 GiB for a CPU "
    "session)."
).int(0)

STORAGE_FRACTION = C.conf("spark.tpu.memory.storageFraction").doc(
    "Fraction of the device memory budget protected for storage (the "
    "stage cache's graph pools) before execution reservations may force "
    "eviction (UnifiedMemoryManager's spark.memory.storageFraction "
    "analog)."
).float(0.3)


class HBMOutOfMemoryError(MemoryError):
    """Execution reservation cannot fit even after evicting all unpinned
    storage (SparkOutOfMemoryError analog)."""


def batch_nbytes(batch: ColumnBatch) -> int:
    """Device bytes of a dense batch: data, validity masks, row mask."""
    total = 0
    for v in batch.vectors:
        total += np.dtype(v.dtype.np_dtype).itemsize * batch.capacity
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
