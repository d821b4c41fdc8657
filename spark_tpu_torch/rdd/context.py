"""SparkContext: the core entry point (`core/SparkContext.scala` analog).

The port of ``spark_tpu/rdd/context.py``.  One process = driver +
executors, so the context is a thin service registry: parallelize/textFile
build RDD lineages, broadcast/accumulator mirror the reference APIs
(`broadcast/TorrentBroadcast.scala:57`, `util/AccumulatorV2.scala`), and
``toDF`` hops onto the session's device through ``_session()``: the
session this context was made by (``SparkSession.sparkContext``), else
``SparkSession.builder.getOrCreate()`` under the session's device policy
(the card unless ``spark.torch.device`` says ``cpu``).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Callable, Iterable, List, Optional

from .rdd import RDD

__all__ = ["SparkContext", "Broadcast", "Accumulator", "AccumulatorParam"]


class Broadcast:
    """Read-only value shared with all tasks.  In-process there is exactly
    one copy by construction — the torrent machinery's job (chunked
    BlockManager distribution) only exists across hosts, where the device
    path uses replication/all_gather instead."""

    _next_id = itertools.count()

    def __init__(self, value):
        self._value = value
        self.id = next(self._next_id)
        self._destroyed = False

    @property
    def value(self):
        if self._destroyed:
            raise RuntimeError(f"broadcast {self.id} was destroyed")
        return self._value

    def unpersist(self, blocking: bool = False) -> None:
        pass

    def destroy(self) -> None:
        self._destroyed = True
        self._value = None


class AccumulatorParam:
    def zero(self, value):
        return 0

    def addInPlace(self, a, b):
        return a + b


class Accumulator:
    """Write-only-from-tasks counter (`AccumulatorV2`); thread-safe."""

    _next_id = itertools.count()

    def __init__(self, value, param: Optional[AccumulatorParam] = None):
        self._value = value
        self._param = param or AccumulatorParam()
        self._lock = threading.Lock()
        self.id = next(self._next_id)

    def add(self, term) -> None:
        with self._lock:
            self._value = self._param.addInPlace(self._value, term)

    def __iadd__(self, term):
        self.add(term)
        return self

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        self._value = v

    def __repr__(self):
        return f"Accumulator(id={self.id}, value={self._value})"


class SparkContext:
    """Driver-side root object.  ``master`` accepts `local[*]`-style URLs
    for API parity; the partitions are host lists evaluated in this
    process."""

    _active: Optional["SparkContext"] = None

    def __init__(self, master: str = "local[*]", appName: str = "spark-tpu",
                 conf=None, session=None):
        from .. import config as C
        self.master = master
        self.appName = appName
        self._conf = conf if conf is not None else C.Conf()
        self._rdd_ids = itertools.count()
        self._default_parallelism = self._parse_parallelism(master)
        self.startTime = int(time.time() * 1000)
        self._stopped = False
        self._session_ref = session
        SparkContext._active = self

    @classmethod
    def getOrCreate(cls, master: str = "local[*]",
                    appName: str = "spark-tpu") -> "SparkContext":
        if cls._active is not None and not cls._active._stopped:
            return cls._active
        return cls(master, appName)

    def _parse_parallelism(self, master: str) -> int:
        if master.startswith("local["):
            inner = master[len("local["):-1]
            if inner == "*":
                return os.cpu_count() or 4
            return int(inner)
        return os.cpu_count() or 4

    @property
    def defaultParallelism(self) -> int:
        return self._default_parallelism

    def _next_rdd_id(self) -> int:
        return next(self._rdd_ids)

    def _session(self):
        if self._session_ref is None:
            from ..sql.session import SparkSession
            self._session_ref = SparkSession.builder.getOrCreate()
        return self._session_ref

    # -- RDD constructors --------------------------------------------------
    def parallelize(self, data: Iterable[Any],
                    numSlices: Optional[int] = None) -> RDD:
        items = list(data)
        n = numSlices or min(self._default_parallelism, max(1, len(items)))
        n = max(1, n)
        # contiguous slices, Spark's ParallelCollectionRDD.slice semantics
        slices: List[List[Any]] = []
        for i in range(n):
            start = (i * len(items)) // n
            end = ((i + 1) * len(items)) // n
            slices.append(items[start:end])
        return RDD(self, n, lambda i: slices[i], name="ParallelCollectionRDD")

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              numSlices: Optional[int] = None) -> RDD:
        if end is None:
            start, end = 0, start
        return self.parallelize(range(start, end, step), numSlices)

    def emptyRDD(self) -> RDD:
        return self.parallelize([], 1)

    def textFile(self, path: str,
                 minPartitions: Optional[int] = None) -> RDD:
        from ..io import _resolve_paths
        files = _resolve_paths(path)
        lines: List[str] = []
        for f in files:
            with open(f, "r", encoding="utf-8") as fh:
                lines += [ln.rstrip("\n") for ln in fh]
        return self.parallelize(lines, minPartitions)

    def wholeTextFiles(self, path: str) -> RDD:
        from ..io import _resolve_paths
        files = _resolve_paths(path)
        out = []
        for f in files:
            with open(f, "r", encoding="utf-8") as fh:
                out.append((f, fh.read()))
        return self.parallelize(out, len(out) or 1)

    def union(self, rdds: List[RDD]) -> RDD:
        out = rdds[0]
        for r in rdds[1:]:
            out = out.union(r)
        return out

    # -- shared variables --------------------------------------------------
    def broadcast(self, value) -> Broadcast:
        return Broadcast(value)

    def accumulator(self, value, param: Optional[AccumulatorParam] = None
                    ) -> Accumulator:
        return Accumulator(value, param)

    # -- job control -------------------------------------------------------
    def runJob(self, rdd: RDD, func: Callable, partitions=None) -> List[Any]:
        parts = partitions if partitions is not None \
            else range(rdd.getNumPartitions())
        return [func(iter(rdd._partition(i))) for i in parts]

    def setJobGroup(self, groupId: str, description: str) -> None:
        self._job_group = (groupId, description)

    def setLogLevel(self, level: str) -> None:
        import logging
        logging.getLogger("spark_tpu_torch").setLevel(level.upper())

    def stop(self) -> None:
        self._stopped = True
        if SparkContext._active is self:
            SparkContext._active = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def __repr__(self):
        return f"SparkContext(master={self.master}, appName={self.appName})"
