"""RDD: the resilient-distributed-dataset API (`core/rdd/RDD.scala:76` +
`PairRDDFunctions.scala` analog).

Semantics mirror the reference: lazy transformations building a lineage
graph, actions that execute it, hash-partitioned shuffles for the ByKey
family, and the same operation surface (map:369.., reduceByKey, cogroup,
treeAggregate:1125, ...).

Execution model: partitions are host Python lists evaluated through the
lineage chain (one "task" per partition).  As in ``spark_tpu/rdd/`` the
RDD API is host code, the control-plane/compat layer: columnar DataFrames
are the path on the card, mirroring how PySpark RDDs pay the pickle pipe
while DataFrames stay in Tungsten (`python/pyspark/rdd.py` vs
`sql/dataframe.py`).  Numeric RDDs can hop to the device path via
``toDF``.
"""

from __future__ import annotations

import bisect
import heapq
import itertools
import math
import os
import random
from collections import defaultdict
from functools import reduce as _freduce
from typing import Any, Callable, Iterable, List, Optional, Tuple

__all__ = ["RDD", "Partitioner", "HashPartitioner", "StatCounter"]


def _portable_hash(x) -> int:
    """Deterministic hash for shuffle partitioning (tuples/None like Spark's
    portable_hash; python hash randomization must not leak into layouts)."""
    if x is None:
        return 0
    if isinstance(x, bool):
        return int(x)
    if isinstance(x, int):
        return x
    if isinstance(x, str):
        h = 0
        for ch in x:
            h = (31 * h + ord(ch)) & 0xFFFFFFFF
        return h
    if isinstance(x, float):
        return hash(x)
    if isinstance(x, tuple):
        h = 0x345678
        for item in x:
            h = (h * 31 + _portable_hash(item)) & 0xFFFFFFFF
        return h
    return hash(x)


class Partitioner:
    def __init__(self, num_partitions: int):
        self.numPartitions = num_partitions

    def __call__(self, key) -> int:
        raise NotImplementedError

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.numPartitions == other.numPartitions)


class HashPartitioner(Partitioner):
    """`Partitioner.scala:80` HashPartitioner."""

    def __call__(self, key) -> int:
        return _portable_hash(key) % self.numPartitions


class StatCounter:
    """`util/StatCounter.scala`: running count/mean/variance/min/max."""

    def __init__(self, values: Iterable[float] = ()):
        self.n = 0
        self.mu = 0.0
        self.m2 = 0.0
        self.maxValue = -math.inf
        self.minValue = math.inf
        for v in values:
            self.merge(v)

    def merge(self, v: float) -> "StatCounter":
        self.n += 1
        delta = v - self.mu
        self.mu += delta / self.n
        self.m2 += delta * (v - self.mu)
        self.maxValue = max(self.maxValue, v)
        self.minValue = min(self.minValue, v)
        return self

    def mergeStats(self, o: "StatCounter") -> "StatCounter":
        if o.n == 0:
            return self
        if self.n == 0:
            self.n, self.mu, self.m2 = o.n, o.mu, o.m2
            self.maxValue, self.minValue = o.maxValue, o.minValue
            return self
        delta = o.mu - self.mu
        total = self.n + o.n
        self.mu = (self.mu * self.n + o.mu * o.n) / total
        self.m2 += o.m2 + delta * delta * self.n * o.n / total
        self.n = total
        self.maxValue = max(self.maxValue, o.maxValue)
        self.minValue = min(self.minValue, o.minValue)
        return self

    def count(self):
        return self.n

    def mean(self):
        return self.mu

    def sum(self):
        return self.mu * self.n

    def variance(self):
        return self.m2 / self.n if self.n else math.nan

    def sampleVariance(self):
        return self.m2 / (self.n - 1) if self.n > 1 else math.nan

    def stdev(self):
        return math.sqrt(self.variance())

    def sampleStdev(self):
        return math.sqrt(self.sampleVariance())

    def min(self):  # noqa: A003
        return self.minValue

    def max(self):  # noqa: A003
        return self.maxValue

    def __repr__(self):
        return (f"(count: {self.n}, mean: {self.mu}, stdev: {self.stdev()}, "
                f"max: {self.maxValue}, min: {self.minValue})")


class RDD:
    """Lazy lineage node: ``_compute(split)`` yields one partition's rows."""

    def __init__(self, sc, num_partitions: int,
                 compute: Callable[[int], Iterable[Any]],
                 parents: Tuple["RDD", ...] = (),
                 partitioner: Optional[Partitioner] = None,
                 name: str = "RDD"):
        self._sc = sc
        self._num = num_partitions
        self._compute_fn = compute
        self._parents = parents
        self.partitioner = partitioner
        self._name = name
        self._cache: Optional[List[List[Any]]] = None
        self.id = sc._next_rdd_id()

    # -- plumbing ---------------------------------------------------------
    def getNumPartitions(self) -> int:
        return self._num

    def _partition(self, i: int) -> List[Any]:
        if self._cache is not None:
            return self._cache[i]
        return list(self._compute_fn(i))

    def _materialize(self) -> List[List[Any]]:
        return [self._partition(i) for i in range(self._num)]

    def cache(self) -> "RDD":
        return self.persist()

    def persist(self, storageLevel=None) -> "RDD":
        if self._cache is None:
            self._cache = self._materialize()
        return self

    def unpersist(self) -> "RDD":
        self._cache = None
        return self

    def checkpoint(self) -> None:
        self.persist()

    def setName(self, name: str) -> "RDD":
        self._name = name
        return self

    def name(self):
        return self._name

    def toDebugString(self) -> str:
        lines = []

        def walk(r, depth):
            lines.append("  " * depth + f"({r.getNumPartitions()}) "
                         f"{r._name} [{r.id}]")
            for p in r._parents:
                walk(p, depth + 1)
        walk(self, 0)
        return "\n".join(lines)

    def _derive(self, fn, num=None, partitioner=None, name="RDD") -> "RDD":
        return RDD(self._sc, num if num is not None else self._num, fn,
                   parents=(self,), partitioner=partitioner, name=name)

    # -- transformations (narrow) ----------------------------------------
    def map(self, f) -> "RDD":
        return self._derive(lambda i: (f(x) for x in self._partition(i)),
                            name="MapRDD")

    def flatMap(self, f) -> "RDD":
        return self._derive(
            lambda i: itertools.chain.from_iterable(
                f(x) for x in self._partition(i)), name="FlatMapRDD")

    def filter(self, f) -> "RDD":
        return self._derive(lambda i: (x for x in self._partition(i) if f(x)),
                            partitioner=self.partitioner, name="FilterRDD")

    def mapPartitions(self, f, preservesPartitioning=False) -> "RDD":
        return self._derive(
            lambda i: f(iter(self._partition(i))),
            partitioner=self.partitioner if preservesPartitioning else None,
            name="MapPartitionsRDD")

    def mapPartitionsWithIndex(self, f, preservesPartitioning=False) -> "RDD":
        return self._derive(
            lambda i: f(i, iter(self._partition(i))),
            partitioner=self.partitioner if preservesPartitioning else None,
            name="MapPartitionsRDD")

    def glom(self) -> "RDD":
        return self._derive(lambda i: [self._partition(i)], name="GlomRDD")

    def zipWithIndex(self) -> "RDD":
        sizes = [len(self._partition(i)) for i in range(self._num)]
        starts = [0]
        for s in sizes[:-1]:
            starts.append(starts[-1] + s)

        def fn(i):
            return ((x, starts[i] + j)
                    for j, x in enumerate(self._partition(i)))
        return self._derive(fn, name="ZipWithIndexRDD")

    def zip(self, other: "RDD") -> "RDD":
        if self._num != other._num:
            raise ValueError("can only zip RDDs with the same number of partitions")

        def fn(i):
            a, b = self._partition(i), other._partition(i)
            if len(a) != len(b):
                raise ValueError("can only zip RDDs with equal partition sizes")
            return zip(a, b)
        return RDD(self._sc, self._num, fn, parents=(self, other),
                   name="ZippedRDD")

    def keyBy(self, f) -> "RDD":
        return self.map(lambda x: (f(x), x))

    def sample(self, withReplacement: bool, fraction: float,
               seed: Optional[int] = None) -> "RDD":
        seed = seed if seed is not None else random.randrange(1 << 30)

        def fn(i):
            rng = random.Random(seed + i)
            for x in self._partition(i):
                if withReplacement:
                    for _ in range(_poisson(rng, fraction)):
                        yield x
                elif rng.random() < fraction:
                    yield x
        return self._derive(fn, name="SampledRDD")

    def union(self, other: "RDD") -> "RDD":
        n_self = self._num

        def fn(i):
            if i < n_self:
                return self._partition(i)
            return other._partition(i - n_self)
        return RDD(self._sc, self._num + other._num, fn,
                   parents=(self, other), name="UnionRDD")

    def cartesian(self, other: "RDD") -> "RDD":
        def fn(i):
            a, b = divmod(i, other._num)
            return ((x, y) for x in self._partition(a)
                    for y in other._partition(b))
        return RDD(self._sc, self._num * other._num, fn,
                   parents=(self, other), name="CartesianRDD")

    def distinct(self, numPartitions: Optional[int] = None) -> "RDD":
        return (self.map(lambda x: (x, None))
                .reduceByKey(lambda a, b: a, numPartitions)
                .map(lambda kv: kv[0]))

    def intersection(self, other: "RDD") -> "RDD":
        return (self.map(lambda x: (x, 1)).cogroup(
            other.map(lambda x: (x, 1)))
            .filter(lambda kv: len(kv[1][0]) > 0 and len(kv[1][1]) > 0)
            .map(lambda kv: kv[0]))

    def subtract(self, other: "RDD") -> "RDD":
        return (self.map(lambda x: (x, x))
                .cogroup(other.map(lambda x: (x, 1)))
                .flatMap(lambda kv: kv[1][0] if len(kv[1][1]) == 0 else []))

    def groupBy(self, f, numPartitions: Optional[int] = None) -> "RDD":
        return self.map(lambda x: (f(x), x)).groupByKey(numPartitions)

    def sortBy(self, keyfunc, ascending: bool = True,
               numPartitions: Optional[int] = None) -> "RDD":
        return (self.keyBy(keyfunc)
                .sortByKey(ascending, numPartitions)
                .map(lambda kv: kv[1]))

    def repartition(self, numPartitions: int) -> "RDD":
        return self.coalesce(numPartitions, shuffle=True)

    def coalesce(self, numPartitions: int, shuffle: bool = False) -> "RDD":
        if shuffle:
            counter = itertools.count()

            def spread(i):
                return (((next(counter) + i) % numPartitions, x)
                        for x in self._partition(i))
            keyed = self._derive(spread, name="CoalesceKeyed")
            return keyed._shuffle(numPartitions).mapPartitions(
                lambda it: (v for _, v in it))
        numPartitions = min(numPartitions, self._num)
        groups = [[] for _ in range(numPartitions)]
        for i in range(self._num):
            groups[i % numPartitions].append(i)

        def fn(i):
            return itertools.chain.from_iterable(
                self._partition(j) for j in groups[i])
        return self._derive(fn, num=numPartitions, name="CoalescedRDD")

    def pipe(self, command: str) -> "RDD":
        import subprocess

        def fn(i):
            inp = "\n".join(str(x) for x in self._partition(i))
            out = subprocess.run(command, input=inp, capture_output=True,
                                 shell=True, text=True, check=True)
            return (ln for ln in out.stdout.splitlines())
        return self._derive(fn, name="PipedRDD")

    # -- pair transformations (shuffles) ----------------------------------
    def _shuffle(self, numPartitions: Optional[int] = None,
                 partitioner: Optional[Partitioner] = None) -> "RDD":
        """Hash-exchange (k, v) rows (ShuffledRDD; one file per reducer in
        the reference's BypassMergeSortShuffleWriter sense)."""
        part = partitioner or HashPartitioner(numPartitions or self._num)
        buckets: Optional[List[List[Any]]] = None

        def materialize():
            nonlocal buckets
            if buckets is None:
                buckets = [[] for _ in range(part.numPartitions)]
                for i in range(self._num):
                    for kv in self._partition(i):
                        buckets[part(kv[0])].append(kv)
            return buckets

        def fn(i):
            return materialize()[i]
        return self._derive(fn, num=part.numPartitions, partitioner=part,
                            name="ShuffledRDD")

    def partitionBy(self, numPartitions: int,
                    partitionFunc=None) -> "RDD":
        part = HashPartitioner(numPartitions)
        if partitionFunc is not None:
            class _F(Partitioner):
                def __call__(self, key):
                    return partitionFunc(key) % self.numPartitions
            part = _F(numPartitions)
        return self._shuffle(partitioner=part)

    def combineByKey(self, createCombiner, mergeValue, mergeCombiners,
                     numPartitions: Optional[int] = None) -> "RDD":
        """`PairRDDFunctions.combineByKeyWithClassTag` — map-side combine
        then reduce-side merge."""
        def map_side(i):
            acc = {}
            for k, v in self._partition(i):
                if k in acc:
                    acc[k] = mergeValue(acc[k], v)
                else:
                    acc[k] = createCombiner(v)
            return acc.items()
        combined = self._derive(map_side, name="MapSideCombine")
        shuffled = combined._shuffle(numPartitions)

        def reduce_side(i):
            acc = {}
            for k, c in shuffled._partition(i):
                if k in acc:
                    acc[k] = mergeCombiners(acc[k], c)
                else:
                    acc[k] = c
            return acc.items()
        return shuffled._derive(reduce_side, partitioner=shuffled.partitioner,
                                name="CombineByKeyRDD")

    def reduceByKey(self, func, numPartitions: Optional[int] = None) -> "RDD":
        return self.combineByKey(lambda v: v, func, func, numPartitions)

    def foldByKey(self, zeroValue, func,
                  numPartitions: Optional[int] = None) -> "RDD":
        return self.combineByKey(lambda v: func(zeroValue, v), func, func,
                                 numPartitions)

    def aggregateByKey(self, zeroValue, seqFunc, combFunc,
                       numPartitions: Optional[int] = None) -> "RDD":
        return self.combineByKey(lambda v: seqFunc(zeroValue, v), seqFunc,
                                 combFunc, numPartitions)

    def groupByKey(self, numPartitions: Optional[int] = None) -> "RDD":
        return self.combineByKey(lambda v: [v],
                                 lambda c, v: c + [v],
                                 lambda a, b: a + b, numPartitions)

    def mapValues(self, f) -> "RDD":
        return self._derive(
            lambda i: ((k, f(v)) for k, v in self._partition(i)),
            partitioner=self.partitioner, name="MapValuesRDD")

    def flatMapValues(self, f) -> "RDD":
        return self._derive(
            lambda i: ((k, w) for k, v in self._partition(i) for w in f(v)),
            partitioner=self.partitioner, name="FlatMapValuesRDD")

    def keys(self) -> "RDD":
        return self.map(lambda kv: kv[0])

    def values(self) -> "RDD":
        return self.map(lambda kv: kv[1])

    def cogroup(self, other: "RDD",
                numPartitions: Optional[int] = None) -> "RDD":
        num = numPartitions or max(self._num, other._num)
        part = HashPartitioner(num)
        left = self._shuffle(partitioner=part)
        right = other._shuffle(partitioner=part)

        def fn(i):
            a, b = defaultdict(list), defaultdict(list)
            for k, v in left._partition(i):
                a[k].append(v)
            for k, v in right._partition(i):
                b[k].append(v)
            for k in {**a, **b}:
                yield (k, (a.get(k, []), b.get(k, [])))
        return RDD(self._sc, num, fn, parents=(left, right),
                   partitioner=part, name="CoGroupedRDD")

    def join(self, other: "RDD", numPartitions=None) -> "RDD":
        return self.cogroup(other, numPartitions).flatMap(
            lambda kv: ((kv[0], (a, b)) for a in kv[1][0] for b in kv[1][1]))

    def leftOuterJoin(self, other: "RDD", numPartitions=None) -> "RDD":
        return self.cogroup(other, numPartitions).flatMap(
            lambda kv: ((kv[0], (a, b)) for a in kv[1][0]
                        for b in (kv[1][1] or [None])))

    def rightOuterJoin(self, other: "RDD", numPartitions=None) -> "RDD":
        return self.cogroup(other, numPartitions).flatMap(
            lambda kv: ((kv[0], (a, b)) for a in (kv[1][0] or [None])
                        for b in kv[1][1]))

    def fullOuterJoin(self, other: "RDD", numPartitions=None) -> "RDD":
        return self.cogroup(other, numPartitions).flatMap(
            lambda kv: ((kv[0], (a, b)) for a in (kv[1][0] or [None])
                        for b in (kv[1][1] or [None])))

    def sortByKey(self, ascending: bool = True,
                  numPartitions: Optional[int] = None) -> "RDD":
        """Range-partitioned global sort (`Partitioner.scala:108`
        RangePartitioner: sampled splitters → exchange → local sort)."""
        num = numPartitions or self._num
        all_keys = [kv[0] for i in range(self._num)
                    for kv in self._partition(i)]
        if not all_keys:
            return self
        rng = random.Random(17)
        sample = sorted(rng.sample(all_keys, min(len(all_keys), 20 * num)))
        splitters = [sample[int(len(sample) * (i + 1) / num)]
                     for i in range(num - 1)] if num > 1 else []

        class _Range(Partitioner):
            def __call__(self, key):
                idx = bisect.bisect_left(splitters, key)
                return idx if ascending else self.numPartitions - 1 - idx

        shuffled = self._shuffle(partitioner=_Range(num))
        return shuffled._derive(
            lambda i: iter(sorted(shuffled._partition(i),
                                  key=lambda kv: kv[0],
                                  reverse=not ascending)),
            partitioner=shuffled.partitioner, name="SortedRDD")

    # -- actions ----------------------------------------------------------
    def collect(self) -> List[Any]:
        out: List[Any] = []
        for i in range(self._num):
            out += list(self._partition(i))
        return out

    def collectAsMap(self) -> dict:
        return dict(self.collect())

    def count(self) -> int:
        return sum(len(list(self._partition(i))) for i in range(self._num))

    def countByKey(self) -> dict:
        out: dict = defaultdict(int)
        for k, _ in self.collect():
            out[k] += 1
        return dict(out)

    def countByValue(self) -> dict:
        out: dict = defaultdict(int)
        for x in self.collect():
            out[x] += 1
        return dict(out)

    def first(self):
        for i in range(self._num):
            p = list(self._partition(i))
            if p:
                return p[0]
        raise ValueError("RDD is empty")

    def take(self, n: int) -> List[Any]:
        out: List[Any] = []
        for i in range(self._num):
            if len(out) >= n:
                break
            out += list(self._partition(i))[:n - len(out)]
        return out

    def top(self, n: int, key=None) -> List[Any]:
        return heapq.nlargest(n, self.collect(), key=key)

    def takeOrdered(self, n: int, key=None) -> List[Any]:
        return heapq.nsmallest(n, self.collect(), key=key)

    def isEmpty(self) -> bool:
        return all(not list(self._partition(i)) for i in range(self._num))

    def reduce(self, f):
        parts = [_freduce(f, p) for p in
                 (list(self._partition(i)) for i in range(self._num)) if p]
        if not parts:
            raise ValueError("cannot reduce empty RDD")
        return _freduce(f, parts)

    def fold(self, zeroValue, op):
        parts = [_freduce(op, list(self._partition(i)), zeroValue)
                 for i in range(self._num)]
        return _freduce(op, parts, zeroValue)

    def aggregate(self, zeroValue, seqOp, combOp):
        import copy
        parts = [_freduce(seqOp, list(self._partition(i)),
                          copy.deepcopy(zeroValue))
                 for i in range(self._num)]
        return _freduce(combOp, parts, copy.deepcopy(zeroValue))

    def treeAggregate(self, zeroValue, seqOp, combOp, depth: int = 2):
        """`RDD.treeAggregate:1125` — multi-level partial aggregation (the
        reference's allreduce analog), over host partitions."""
        import copy
        if self._num == 0:
            return zeroValue
        partials = [_freduce(seqOp, list(self._partition(i)),
                             copy.deepcopy(zeroValue))
                    for i in range(self._num)]
        scale = max(int(math.ceil(len(partials) ** (1.0 / depth))), 2)
        while len(partials) > 1:
            groups = [partials[i:i + scale]
                      for i in range(0, len(partials), scale)]
            partials = [_freduce(combOp, g) for g in groups]
        return partials[0]

    def treeReduce(self, f, depth: int = 2):
        vals = self.collect()
        if not vals:
            raise ValueError("cannot reduce empty RDD")
        return _freduce(f, vals)

    def sum(self):  # noqa: A003
        return sum(self.collect())

    def mean(self):
        return self.stats().mean()

    def min(self, key=None):  # noqa: A003
        return min(self.collect(), key=key) if key else min(self.collect())

    def max(self, key=None):  # noqa: A003
        return max(self.collect(), key=key) if key else max(self.collect())

    def stdev(self):
        return self.stats().stdev()

    def variance(self):
        return self.stats().variance()

    def stats(self) -> StatCounter:
        return self.aggregate(StatCounter(),
                              lambda s, v: s.merge(v),
                              lambda a, b: a.mergeStats(b))

    def histogram(self, buckets):
        vals = [v for v in self.collect()]
        if isinstance(buckets, int):
            lo, hi = min(vals), max(vals)
            step = (hi - lo) / buckets
            edges = [lo + i * step for i in range(buckets)] + [hi]
        else:
            edges = list(buckets)
        counts = [0] * (len(edges) - 1)
        for v in vals:
            idx = bisect.bisect_right(edges, v) - 1
            if idx == len(counts):
                idx -= 1
            if 0 <= idx < len(counts):
                counts[idx] += 1
        return edges, counts

    def foreach(self, f) -> None:
        for x in self.collect():
            f(x)

    def foreachPartition(self, f) -> None:
        for i in range(self._num):
            f(iter(self._partition(i)))

    def lookup(self, key) -> List[Any]:
        return [v for k, v in self.collect() if k == key]

    def saveAsTextFile(self, path: str) -> None:
        os.makedirs(path, exist_ok=False)
        for i in range(self._num):
            with open(os.path.join(path, f"part-{i:05d}"), "w",
                      encoding="utf-8") as f:
                for x in self._partition(i):
                    f.write(str(x) + "\n")
        open(os.path.join(path, "_SUCCESS"), "w").close()

    # -- bridge to the accelerated path -----------------------------------
    def toDF(self, names: Optional[List[str]] = None):
        """Hop onto the columnar path on the session's device
        (``SparkSession.createDataFrame``)."""
        session = self._sc._session()
        return session.createDataFrame(self.collect(), names)

    def __repr__(self):
        return f"{self._name}[{self.id}] at partitions={self._num}"


def _poisson(rng: random.Random, lam: float) -> int:
    # Knuth's algorithm (small lambda)
    L = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= L:
            return k
        k += 1
