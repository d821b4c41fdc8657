"""Multi-stage out-of-core execution: streamed stage DAGs with grace joins.

The port of ``spark_tpu/sql/stages.py``.  The single-relation runner
(``multibatch.py``) streams one file chain through one breaker; this
module takes PLANS WITH JOINS over file relations larger than one batch
(``DAGScheduler.scala:114`` stage DAGs, ``SortMergeJoinExec.scala:36``
with ``ExternalAppendOnlyMap``'s spillable state):

- the plan becomes a tree of **batch streams**;
- filters, projects and **broadcast joins** (the other side fits one
  batch: ``BroadcastHashJoinExec``'s role) fuse into the per-batch step
  of the stream they consume — one stage-cache entry keyed ``stream|…``,
  one captured CUDA graph on a card; the broadcast sides are device
  leaves of that entry;
- joins where BOTH sides exceed a batch run as **grace hash joins**: each
  side is partitioned by ``Hash64`` of its join keys into spill buckets
  (same count, same hash: co-partitioned), and each bucket pair runs
  through the ordinary single-batch join (``_eager``: the graph lane on
  one device, the distributed executor under the mesh, where every
  exchange is one K2 launch).  NULL keys share the NULL hash's bucket,
  where the join rejects them and outer null-extension still applies,
  so per-bucket execution is exact for every join type;
- aggregate, sort, distinct and limit breakers consume a stream through
  the cross-batch mergers of ``multibatch.py``.

A skewed bucket re-partitions with a salted hash; a bucket of literally
equal keys falls back to a host sort-merge emit or a chunked
probe/build loop.  The card holds one probe batch and one build batch at
a time; host RAM and disk (pickle spill files, as in the reference) are
the partition store.
"""

from __future__ import annotations

import logging
import math
import os
import pickle
import tempfile
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from .. import config as C
from .. import types as T
from ..columnar import (ColumnBatch, ColumnVector, live_prefix,
                        normalize_valids, pad_capacity, pad_to_capacity,
                        slice_rows, union_all)
from ..expressions import (And, Cast, Col, EvalContext, Expression, Hash64,
                           Literal)
from ..kernels import compact, take_batch
from . import logical as L
from . import physical as P
from .joins import split_equi_condition
from .multibatch import STREAM_STATS, StreamedStep, _prefix_live

_log = logging.getLogger("spark_tpu_torch.stages")

#: recursion depth for salted re-partitioning of skewed grace buckets
_MAX_SALT_DEPTH = 3
_PID = "__stage_pid__"          # chunked-fallback probe row tag


class NotStreamable(Exception):
    """A plan shape the stage runner cannot stream; the caller falls back
    to the eager single-batch path."""


# ---------------------------------------------------------------------------
# small host-batch helpers
# ---------------------------------------------------------------------------

def _emit_pieces(host: ColumnBatch, batch_rows: int, capacity: int
                 ) -> Iterator[ColumnBatch]:
    """A compacted host batch cut into uniform stream pieces."""
    n = int(host.num_rows())
    for start in range(0, n, batch_rows):
        piece = slice_rows(host, start, min(start + batch_rows, n))
        yield normalize_valids(pad_to_capacity(piece, capacity))


def _concat_live(batches: List[ColumnBatch]) -> Optional[ColumnBatch]:
    lives = [live_prefix(compact(b)) for b in batches]
    lives = [b for b in lives if b.capacity > 0]
    if not lives:
        return None
    return lives[0] if len(lives) == 1 else union_all(lives)


def _padded(batch: ColumnBatch) -> ColumnBatch:
    return normalize_valids(
        pad_to_capacity(batch, pad_capacity(max(batch.capacity, 1))))


def _empty_side(schema: T.StructType, dicts: Dict[str, tuple]) -> ColumnBatch:
    """A zero-row batch carrying the stream's FIXED dictionaries, so a
    bucket joined against an empty side keeps the dictionaries of the
    other buckets."""
    cap = 8
    vectors = []
    for f in schema.fields:
        d = tuple(dicts.get(f.name, ())) if f.dataType.is_string else None
        vectors.append(ColumnVector(
            torch.zeros(cap, dtype=f.dataType.torch_dtype), f.dataType,
            torch.zeros(cap, dtype=torch.bool), d))
    return ColumnBatch([f.name for f in schema.fields], vectors,
                       torch.zeros(cap, dtype=torch.bool), cap)


def _eager(session, plan: L.LogicalPlan) -> ColumnBatch:
    """An analyzed and optimized sub-plan run by the ordinary executor
    (the graph lane with its adaptive retry and memory pre-flight; the
    distributed executor under the mesh).  Such a sub-plan holds no
    oversized file relation, so it never comes back here."""
    from .planner import QueryExecution
    qe = QueryExecution(session, plan)
    qe._analyzed = plan
    qe._optimized = plan
    return qe._execute_inner()


def _batch_dicts(batch: ColumnBatch) -> Dict[str, tuple]:
    return {n: v.dictionary for n, v in zip(batch.names, batch.vectors)
            if v.dictionary is not None}


def _hash_buckets(live: ColumnBatch, keys: List[Expression], n_buckets: int,
                  salt: int) -> np.ndarray:
    """Bucket id of each row: ``Hash64`` of the keys (salted), as an
    unsigned 64-bit value modulo the bucket count — the reference's
    buckets, bit for bit.  NULL keys hash to the NULL constant."""
    ctx = EvalContext(live)
    exprs = ([Literal(int(salt), T.int64)] if salt else []) + list(keys)
    h = ctx.broadcast(Hash64(*exprs).eval(ctx)).data
    return (h.numpy().view(np.uint64) % np.uint64(n_buckets)).astype(np.int64)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

class BatchStream:
    """A source of host batches, every batch padded to ``capacity`` with
    FIXED string dictionaries (one step serves all of them)."""

    schema: T.StructType
    capacity: int
    batch_rows: int
    est_rows: int

    def batches(self) -> Iterator[ColumnBatch]:
        raise NotImplementedError

    def items(self):
        """``(host batch, step leaf, slot)`` per batch; the consumer calls
        ``done(leaf, slot)`` once it has queued the leaf's copies."""
        for b in self.batches():
            yield b, b, None

    def done(self, leaf, slot) -> None:
        pass


class _FileStream(BatchStream):
    """Streamed file scan (``FileScanRDD.scala``), re-encoded onto the
    relation's global string dictionaries; a step's leaves come through
    the pinned ring on a card (``multibatch.BatchFeed``)."""

    def __init__(self, session, rel: L.FileRelation, batch_rows: int):
        from ..io import file_row_count, scan_string_dictionaries
        self.session = session
        self.rel = rel
        self.batch_rows = batch_rows
        self.capacity = pad_capacity(batch_rows)
        self.schema = rel.schema()
        self.est_rows = file_row_count(rel) or 0
        self._dicts = scan_string_dictionaries(rel, batch_rows)
        self._feed = None

    def batches(self) -> Iterator[ColumnBatch]:
        from ..io import prefetch_iter, scan_file_batches, scan_prefetch_depth
        from .multibatch import BatchFeed
        prep = BatchFeed(self.session, self.rel, self.batch_rows,
                         self._dicts, ring=False).prep
        yield from prefetch_iter(scan_file_batches(self.rel, self.batch_rows),
                                 prep, scan_prefetch_depth(self.session))

    def items(self):
        from .multibatch import BatchFeed
        self._feed = BatchFeed(self.session, self.rel, self.batch_rows,
                               self._dicts)
        try:
            yield from self._feed
        finally:
            self._feed.close()

    def done(self, leaf, slot) -> None:
        self._feed.done(leaf, slot)


class _SingletonStream(BatchStream):
    """One materialized batch re-sliced as a stream (a breaker result or a
    broadcast-sized side entering a grace join)."""

    def __init__(self, batch: ColumnBatch, batch_rows: int):
        self._batch = compact(batch.to_host())
        self.schema = batch.schema
        self.batch_rows = batch_rows
        self.capacity = pad_capacity(batch_rows)
        self.est_rows = int(self._batch.num_rows())

    def batches(self) -> Iterator[ColumnBatch]:
        yield from _emit_pieces(self._batch, self.batch_rows, self.capacity)


class _MappedStream(BatchStream):
    """A child stream with a fused chain of per-batch device ops.

    ``ops`` are builders ``fn(leaf_node) -> LogicalPlan`` applied
    bottom-up over a ``LocalRelation`` of each incoming batch; the
    composed tree is planned once into one stage-cache entry, broadcast
    build sides entering as extra device leaves.  A join's output
    overflow grows that join's factor (``check_factor_cap`` bounds each
    growth), rebuilds the step and re-runs THIS batch.  Under a mesh the
    step is one SPMD program over the shards (one stage-cache entry,
    ``stream|mesh{n}|…``), the batch split over the shards and the
    broadcast sides replicated."""

    def __init__(self, session, child: BatchStream, ops: List,
                 schema: T.StructType, mesh=None):
        self.session = session
        self.child = child
        self.ops = list(ops)
        self.schema = schema
        self.mesh = mesh
        self.batch_rows = child.batch_rows
        self.capacity = child.capacity
        self.est_rows = child.est_rows
        self._factors: Optional[List] = None

    def with_op(self, builder, schema: T.StructType) -> "_MappedStream":
        return _MappedStream(self.session, self.child,
                             self.ops + [builder], schema, self.mesh)

    def compose(self, leaf: L.LogicalPlan) -> L.LogicalPlan:
        node = leaf
        for b in self.ops:
            node = b(node)
        return node

    def _compile(self, template: ColumnBatch, phys_wrap=None
                 ) -> StreamedStep:
        """The step for batches like ``template``.  Planning runs per
        compile to collect THIS instance's extra leaves (broadcast sides
        are data, never part of the cached entry's key beyond their
        shapes)."""
        from .planner import Planner
        planner = Planner(self.session, join_factor_override=self._factors)
        node = self.compose(L.LocalRelation(template))
        leaves: List[ColumnBatch] = []
        phys = planner._to_physical(node, leaves)
        if phys_wrap is not None:
            phys = phys_wrap(phys)
        planner._assign_op_ids(phys, [1])
        if not leaves or leaves[0] is not template:
            raise NotStreamable("streamed leaf is not the planner's first "
                                "leaf; cannot swap batches per step")
        tag = "local" if self.mesh is None else f"mesh{self.mesh.n_shards}"
        return StreamedStep(self.session, phys, leaves, f"stream|{tag}",
                            _prefix_live(phys), mesh=self.mesh)

    def _run_step(self, step: StreamedStep, b: ColumnBatch, leaf,
                  phys_wrap=None):
        """One batch; on a join overflow grow the positional factors,
        rebuild the step and re-run THIS batch.  Returns (host runs,
        step)."""
        from .planner import check_factor_cap, grow_capacity_factor
        base_f = self.session.conf.get(C.JOIN_OUTPUT_FACTOR)
        for _attempt in range(6):
            runs, flags, caps, kinds = step.run(leaf)
            if not any(f > 0 for f in flags):
                return runs, step
            cur = list(self._factors) if self._factors else []
            n_joins = sum(1 for k in kinds if k == "join")
            while len(cur) < n_joins:
                cur.append(None)
            ji = 0
            for f, c, k in zip(flags, caps, kinds):
                if k != "join":
                    continue
                if f > 0:
                    prev = cur[ji] if cur[ji] is not None else base_f
                    cur[ji] = grow_capacity_factor(prev, f / max(c, 1))
                    # c is THIS join's static output capacity (probe x
                    # prev), so c/prev is its probe base
                    check_factor_cap(cur[ji],
                                     int(max(c, 1) / max(prev, 1e-9)),
                                     self.session, "streamed join")
                ji += 1
            self._factors = cur
            _log.warning("streamed step join overflow; rebuilding with "
                         "factors %s", ["%.2f" % x if x else "-"
                                        for x in cur])
            step = self._compile(b, phys_wrap)
        raise RuntimeError(
            "streamed join output still overflows after 6 adaptive "
            f"retries; raise {C.JOIN_OUTPUT_FACTOR.key} explicitly "
            f"(growth is bounded by {C.JOIN_OUTPUT_MAX_ROWS.key})")

    def run(self, phys_wrap=None):
        """``(runs, batch)`` per child batch through the fused step, with
        the step's memory reserved for the whole stream."""
        mem = self.session._memory
        owner = f"stream:{id(self)}"
        step = reserved = None
        try:
            for b, leaf, slot in self.child.items():
                self.session.raise_if_cancelled()
                try:
                    if step is None:
                        step = self._compile(b, phys_wrap)
                    if step is not reserved:
                        mem.release_execution(owner)
                        mem.acquire_execution(owner, step.reserve)
                        reserved = step
                    runs, step = self._run_step(step, b, leaf, phys_wrap)
                finally:
                    self.child.done(leaf, slot)
                yield runs, b
        finally:
            mem.release_execution(owner)

    def batches(self) -> Iterator[ColumnBatch]:
        for runs, _b in self.run():
            for host in runs:
                yield from _emit_pieces(host, self.batch_rows, self.capacity)


def _as_mapped(session, stream: BatchStream, mesh=None) -> _MappedStream:
    if isinstance(stream, _MappedStream):
        return stream
    return _MappedStream(session, stream, [], stream.schema, mesh)


# ---------------------------------------------------------------------------
# grace hash join stream
# ---------------------------------------------------------------------------

class _BucketStore:
    """Per-bucket row store: host RAM up to a row budget, then per-bucket
    pickle spill files (``Spillable.scala``'s threshold idiom applied to
    the grace partition phase)."""

    def __init__(self, n_buckets: int, budget_rows: int, spill_dir: str):
        os.makedirs(spill_dir, exist_ok=True)
        self._dir = tempfile.mkdtemp(prefix="grace-", dir=spill_dir)
        self.n = n_buckets
        self.budget_rows = budget_rows
        self._mem: List[List[ColumnBatch]] = [[] for _ in range(n_buckets)]
        self._mem_rows = 0
        self._files: List[Optional[str]] = [None] * n_buckets
        self.rows = np.zeros(n_buckets, np.int64)

    def add(self, live: ColumnBatch, bucket_ids: np.ndarray) -> None:
        """Distribute the rows of a LIVE batch (capacity == rows) to their
        buckets (``native.partition_permutation``)."""
        from ..memory import batch_nbytes
        from ..native import partition_permutation
        order, bounds = partition_permutation(bucket_ids, self.n)
        # one gather of the batch into bucket order; each bucket's rows
        # are then a contiguous range, copied out on their own (a view
        # would pickle the whole batch's storage)
        ordered = take_batch(live, torch.from_numpy(order))
        for b in range(self.n):
            lo, hi = int(bounds[b]), int(bounds[b + 1])
            if hi <= lo:
                continue
            piece = ColumnBatch(
                ordered.names,
                [ColumnVector(v.data[lo:hi].clone(), v.dtype,
                              None if v.valid is None
                              else v.valid[lo:hi].clone(), v.dictionary)
                 for v in ordered.vectors],
                None if ordered.row_valid is None
                else ordered.row_valid[lo:hi].clone(), hi - lo)
            self._mem[b].append(piece)
            self.rows[b] += hi - lo
            self._mem_rows += hi - lo
        STREAM_STATS["bucket_rows"] += live.capacity
        STREAM_STATS["bucket_bytes"] += batch_nbytes(live)
        if self._mem_rows > self.budget_rows:
            self._spill()

    def _spill(self) -> None:
        for b in range(self.n):
            if not self._mem[b]:
                continue
            path = self._files[b]
            if path is None:
                path = os.path.join(self._dir, f"bucket-{b:05d}.spill")
                self._files[b] = path
            with open(path, "ab") as f:
                before = f.tell()
                pickle.dump(self._mem[b], f,
                            protocol=pickle.HIGHEST_PROTOCOL)
                STREAM_STATS["bucket_spill_bytes"] += f.tell() - before
            self._mem[b] = []
        _log.info("grace partition spilled %d rows to %s",
                  self._mem_rows, self._dir)
        self._mem_rows = 0

    def __getstate__(self):
        # checkpoints: spill files are APPENDED in place, so a resumed
        # store truncates them back to their pickled sizes (rows spilled
        # after the checkpoint would otherwise count twice)
        d = dict(self.__dict__)
        d["_file_sizes"] = [
            os.path.getsize(p) if p is not None else 0 for p in self._files]
        return d

    def __setstate__(self, state):
        sizes = state.pop("_file_sizes", None)
        self.__dict__.update(state)
        if sizes is None:
            return
        for p, sz in zip(self._files, sizes):
            if p is None:
                continue
            if not os.path.exists(p):       # the checkpoint is unusable
                raise FileNotFoundError(p)
            with open(p, "ab") as f:
                f.truncate(sz)

    def load(self, b: int) -> List[ColumnBatch]:
        out: List[ColumnBatch] = []
        path = self._files[b]
        if path is not None:
            with open(path, "rb") as f:
                while True:
                    try:
                        out.extend(pickle.load(f))
                    except EOFError:
                        break
        out.extend(self._mem[b])
        return out

    def close(self) -> None:
        for path in self._files:
            if path is not None:
                try:
                    os.remove(path)
                except OSError:
                    pass
        try:
            os.rmdir(self._dir)
        except OSError:
            pass
        self._mem = [[] for _ in range(self.n)]


class _UnionStream(BatchStream):
    """UNION ALL of child streams: children drain in order, every batch
    re-encoded onto the union's shared string dictionaries so one
    downstream step serves all of them."""

    def __init__(self, session, children: List[BatchStream],
                 schema: T.StructType):
        self.session = session
        self.children_streams = children
        self.schema = schema
        self.batch_rows = children[0].batch_rows
        self.capacity = max(c.capacity for c in children)
        self.est_rows = sum(c.est_rows for c in children)
        self._dicts: Optional[Dict[str, tuple]] = None
        for c in children[1:]:
            for a, b in zip(schema.fields, c.schema.fields):
                if type(a.dataType) is not type(b.dataType):
                    raise NotStreamable(
                        f"streamed UNION needs identical column types; "
                        f"{a.name}: {a.dataType} vs {b.dataType}")

    def batches(self) -> Iterator[ColumnBatch]:
        from ..io import reencode_strings
        names = self.schema.names
        for child in self.children_streams:
            for b in child.batches():
                b = ColumnBatch(list(names), list(b.vectors), b.row_valid,
                                b.capacity)      # positional rename
                b = reencode_strings(b, self._shared_dicts(b))
                yield normalize_valids(pad_to_capacity(b, self.capacity))

    def _shared_dicts(self, batch: ColumnBatch) -> Dict[str, tuple]:
        if self._dicts is None:
            # the sorted union of every child's fixed dictionaries
            merged: Dict[str, set] = {}
            for c in self.children_streams:
                child_dicts = getattr(c, "_dicts", None)
                if child_dicts is None and hasattr(c, "child"):
                    child_dicts = getattr(c.child, "_dicts", None)
                if child_dicts is None and hasattr(c, "_batch"):
                    child_dicts = _batch_dicts(c._batch)
                for name, f in zip(self.schema.names, c.schema.fields):
                    if f.dataType.is_string:
                        merged.setdefault(name, set())
                        if child_dicts:
                            cname = c.schema.names[
                                self.schema.names.index(name)]
                            merged[name] |= set(child_dicts.get(cname, ()))
            self._dicts = {k: tuple(sorted(v)) for k, v in merged.items()}
            self._seen: set = set()
        # a batch carrying words the pre-pass missed (computed strings)
        # cannot extend the shared dictionaries mid-stream: consumers
        # fixed them at the first batch, and a sorted extension shifts
        # every code.  Fall back to the eager path instead.
        for name, v in zip(batch.names, batch.vectors):
            if v.dictionary is None:
                continue
            key = (name, v.dictionary)
            if key in self._seen:
                continue
            extra = set(v.dictionary) - set(self._dicts.get(name, ()))
            if extra:
                raise NotStreamable(
                    f"streamed UNION column {name!r} produced dictionary "
                    f"words outside the scan-level union "
                    f"({sorted(extra)[:5]}...); the fixed-dictionary "
                    "invariant cannot hold")
            self._seen.add(key)
        return self._dicts


class _GraceJoinStream(BatchStream):
    """Grace hash join of two streams (``SortMergeJoinExec.scala:36``'s
    role at out-of-core scale: partition, then join bucket by bucket
    through the single-batch join)."""

    def __init__(self, session, node: L.Join, left: BatchStream,
                 right: BatchStream):
        self.session = session
        self.node = node
        self.left = left
        self.right = right
        self.schema = node.schema()
        self.batch_rows = left.batch_rows
        self.capacity = pad_capacity(self.batch_rows)
        self.est_rows = left.est_rows + right.est_rows

        lcols = set(left.schema.names)
        rcols = set(right.schema.names)
        if node.using:
            pairs = [(Col(n), Col(n)) for n in node.using]
            res_list: List[Expression] = []
        else:
            pairs, res_list = split_equi_condition(node.on, lcols, rcols)
        self._residual: Optional[Expression] = None
        for conj in res_list:
            self._residual = conj if self._residual is None \
                else And(self._residual, conj)
        if not pairs:
            raise NotStreamable(
                f"{node.how} join of two oversized relations without "
                "equi-join keys cannot be grace-partitioned")
        # hash the SAME value domain on both sides: a mixed int/float
        # pair hashes as float64 (the join's own key normalization)
        self._lkeys: List[Expression] = []
        self._rkeys: List[Expression] = []
        for l, r in pairs:
            try:
                ldt = l.data_type(left.schema)
                rdt = r.data_type(right.schema)
                if ldt.is_numeric and rdt.is_numeric \
                        and ldt.is_fractional != rdt.is_fractional:
                    l, r = Cast(l, T.float64), Cast(r, T.float64)
            except Exception:
                pass
            self._lkeys.append(l)
            self._rkeys.append(r)
        self._ldicts: Dict[str, tuple] = {}
        self._rdicts: Dict[str, tuple] = {}

    # -- partition phase -------------------------------------------------
    def _partition_stream(self, stream: BatchStream, keys: List[Expression],
                          n_buckets: int, dicts_out: Dict[str, tuple]
                          ) -> _BucketStore:
        store = self._make_store(n_buckets)
        for b in stream.batches():
            self.session.raise_if_cancelled()
            live = live_prefix(compact(b))
            if not dicts_out:
                dicts_out.update(_batch_dicts(live))
            if live.capacity == 0:
                continue
            store.add(live, _hash_buckets(live, keys, n_buckets, 0))
        return store

    def _partition_batches(self, batches: List[ColumnBatch],
                           keys: List[Expression], n_buckets: int,
                           salt: int) -> _BucketStore:
        store = self._make_store(n_buckets)
        for b in batches:
            live = live_prefix(compact(b))
            if live.capacity == 0:
                continue
            store.add(live, _hash_buckets(live, keys, n_buckets, salt))
        return store

    def _make_store(self, n_buckets: int) -> _BucketStore:
        from .multibatch import default_spill_dir
        conf = self.session.conf
        return _BucketStore(n_buckets, conf.get(C.SPILL_MEMORY_ROWS) // 2,
                            default_spill_dir(conf))

    # -- join phase ------------------------------------------------------
    def _skip(self, lrows: int, rrows: int) -> bool:
        how = self.node.how
        if how in ("inner", "cross", "left_semi"):
            return lrows == 0 or rrows == 0
        if how in ("left", "left_anti"):
            return lrows == 0
        if how == "right":
            return rrows == 0
        return lrows == 0 and rrows == 0          # full

    def _join_pair(self, lb: Optional[ColumnBatch],
                   rb: Optional[ColumnBatch]) -> ColumnBatch:
        import time

        from ..memory import batch_nbytes
        node = self.node
        lb = _padded(lb) if lb is not None \
            else _empty_side(self.left.schema, self._ldicts)
        rb = _padded(rb) if rb is not None \
            else _empty_side(self.right.schema, self._rdicts)
        if self.session.device.type == "cuda":
            STREAM_STATS["bytes_to_device"] += batch_nbytes(lb) \
                + batch_nbytes(rb)
        plan = L.Join(L.LocalRelation(lb), L.LocalRelation(rb),
                      node.how, node.on, node.using)
        t0 = time.perf_counter()
        try:
            return _eager(self.session, plan)
        finally:
            STREAM_STATS["bucket_join_ms"] += \
                (time.perf_counter() - t0) * 1e3

    def _bucket_join(self, lbs: List[ColumnBatch], rbs: List[ColumnBatch],
                     depth: int) -> Iterator[ColumnBatch]:
        lrows = sum(int(b.num_rows()) for b in lbs)
        rrows = sum(int(b.num_rows()) for b in rbs)
        if self._skip(lrows, rrows):
            return
        cap = self.batch_rows
        if lrows <= cap and rrows <= cap:
            from .planner import JoinFanoutError
            try:
                yield self._join_pair(_concat_live(lbs), _concat_live(rbs))
            except JoinFanoutError:
                # the pair fits but its OUTPUT fans out past
                # spark.sql.join.maxOutputRows (hot keys on both sides):
                # chunk it.  FULL OUTER cannot chunk (both sides keep
                # their unmatched rows).
                if self.node.how == "full":
                    raise
                _log.warning(
                    "grace bucket join output fans out past the eager "
                    "bound (%d x %d rows); chunking the bucket pair",
                    lrows, rrows)
                yield from self._chunked_join(lbs, rbs)
            return
        if depth < _MAX_SALT_DEPTH:
            # a skewed bucket: re-partition BOTH sides with a salted hash
            sub = 16
            lstore = self._partition_batches(lbs, self._lkeys, sub,
                                             salt=depth + 1)
            rstore = self._partition_batches(rbs, self._rkeys, sub,
                                             salt=depth + 1)
            try:
                if (max(int(lstore.rows.max()), 1) < max(lrows, 1)
                        or max(int(rstore.rows.max()), 1) < max(rrows, 1)):
                    for b in range(sub):
                        yield from self._bucket_join(
                            lstore.load(b), rstore.load(b), depth + 1)
                    return
                # no progress: every row shares one key — chunk instead
            finally:
                lstore.close()
                rstore.close()
        yield from self._chunked_join(lbs, rbs)

    # -- chunked fallback (identical-key skew) ---------------------------
    def _chunks(self, batches: List[ColumnBatch]) -> List[ColumnBatch]:
        cat = _concat_live(batches)
        if cat is None:
            return []
        return [live_prefix(p) for p in
                _emit_pieces(cat, self.batch_rows, self.capacity)]

    def _chunked_join(self, lbs, rbs) -> Iterator[ColumnBatch]:
        """A hot bucket: one that salting cannot split (all rows share one
        key) or whose output fans out past the eager bound.  First a host
        sort-merge emit (``_merge_emit``); for the shapes it does not
        cover, a chunked probe/build loop of single-batch joins with the
        probe rows' matches tracked on the host.  The probe is the
        outer-preserved side; FULL OUTER cannot chunk and raises."""
        node = self.node
        how = node.how
        if how == "full":
            raise NotStreamable(
                "grace join: a single join-key value exceeds device batch "
                "capacity on both sides of a FULL OUTER join")
        swap = how == "right"
        probe_bs, build_bs = (rbs, lbs) if swap else (lbs, rbs)
        how2 = "left" if swap else how
        merged = self._merge_emit(probe_bs, build_bs, swap, how2)
        if merged is not None:
            yield from merged
            return
        out_names = list(self.schema.names)

        def tag(batch: ColumnBatch) -> ColumnBatch:
            n = batch.capacity
            return ColumnBatch(
                list(batch.names) + [_PID],
                list(batch.vectors) + [ColumnVector(
                    torch.arange(n, dtype=torch.int64), T.int64, None,
                    None)],
                batch.row_valid, n)

        build_chunks = self._chunks(build_bs)
        for pchunk in self._chunks(probe_bs):
            matched = np.zeros(pchunk.capacity, bool)
            tagged = _padded(tag(pchunk))
            for bchunk in build_chunks:
                inner_how = "left_semi" if how2 in ("left_semi",
                                                    "left_anti") else "inner"
                for res in self._probe_chunk(tagged, bchunk, inner_how):
                    matched[_col_values(res, _PID)] = True
                    if how2 in ("inner", "left"):
                        out = _drop_col(res, _PID)
                        if swap:
                            out = _reorder(out, out_names)
                        if int(out.num_rows()):
                            yield out
            if how2 == "left":
                rest = _mask_rows(pchunk, ~matched)
                if int(rest.num_rows()):
                    other_schema, other_dicts = (
                        (self.left.schema, self._ldicts) if swap
                        else (self.right.schema, self._rdicts))
                    yield _null_extend(rest, self.schema, other_schema,
                                       other_dicts)
            elif how2 == "left_semi":
                yield _mask_rows(pchunk, matched)
            elif how2 == "left_anti":
                yield _mask_rows(pchunk, ~matched)

    # -- sort-merge emit (the first hot-bucket path) ---------------------
    def _merge_emit(self, probe_bs, build_bs, swap: bool, how2: str):
        """Sort-merge join of one hot bucket on the host: both sides sort
        once on the join's exact int64 key encoding
        (``joins._exact_encode_pair``: the device join's match
        semantics), equal-key runs are matched by one merge over the
        distinct keys, and each matched run pair emits its cross product
        in tiles of at most ``batch_rows``.  None when the shape is not
        covered (several keys, an unencodable key, a USING join's
        inner/outer output)."""
        from .joins import _exact_encode_pair
        node = self.node
        if len(self._lkeys) != 1:
            return None
        if node.using and how2 in ("inner", "left"):
            return None

        probe_cat = _concat_live(probe_bs)
        if probe_cat is None:
            return iter(())
        build_cat = _concat_live(build_bs)

        pkey = (self._rkeys if swap else self._lkeys)[0]
        bkey = (self._lkeys if swap else self._rkeys)[0]
        other_schema, other_dicts = (
            (self.left.schema, self._ldicts) if swap
            else (self.right.schema, self._rdicts))

        if build_cat is None:
            def _no_build():
                if how2 == "left":
                    yield _null_extend(probe_cat, self.schema, other_schema,
                                       other_dicts)
                elif how2 == "left_anti":
                    yield probe_cat
            return _no_build()

        enc = _exact_encode_pair(EvalContext(probe_cat),
                                 EvalContext(build_cat), pkey, bkey)
        if enc is None:
            return None
        p_enc, p_val, b_enc, b_val = enc
        residual = self._residual

        def _run():
            pe = p_enc.numpy()
            be = b_enc.numpy()
            p_idx = np.nonzero(p_val.numpy())[0] if p_val is not None \
                else np.arange(len(pe))
            b_idx = np.nonzero(b_val.numpy())[0] if b_val is not None \
                else np.arange(len(be))
            p_sorted = p_idx[np.argsort(pe[p_idx], kind="stable")]
            b_sorted = b_idx[np.argsort(be[b_idx], kind="stable")]
            pk = pe[p_sorted]
            bk = be[b_sorted]
            pu = np.flatnonzero(np.r_[True, pk[1:] != pk[:-1]]) \
                if len(pk) else np.empty(0, np.int64)
            bu = np.flatnonzero(np.r_[True, bk[1:] != bk[:-1]]) \
                if len(bk) else np.empty(0, np.int64)
            pu_end = np.r_[pu[1:], len(pk)].astype(np.int64)
            bu_end = np.r_[bu[1:], len(bk)].astype(np.int64)
            pu_vals = pk[pu] if len(pk) else np.empty(0, np.int64)
            bu_vals = bk[bu] if len(bk) else np.empty(0, np.int64)
            pos = np.searchsorted(bu_vals, pu_vals)
            pos_c = np.clip(pos, 0, max(len(bu_vals) - 1, 0))
            has = (pos < len(bu_vals)) & (bu_vals[pos_c] == pu_vals) \
                if len(bu_vals) else np.zeros(len(pu_vals), bool)

            matched = np.zeros(probe_cat.capacity, bool)
            emit_tiles = how2 in ("inner", "left") or residual is not None
            for j in np.flatnonzero(has):
                p_rows = p_sorted[pu[j]:pu_end[j]]
                b_rows = b_sorted[bu[pos[j]]:bu_end[pos[j]]]
                if residual is None:
                    matched[p_rows] = True
                if not emit_tiles:
                    continue
                bblock = int(min(len(b_rows), self.batch_rows))
                pblock = max(1, self.batch_rows // bblock)
                for bs_ in range(0, len(b_rows), bblock):
                    br = b_rows[bs_:bs_ + bblock]
                    for ps_ in range(0, len(p_rows), pblock):
                        pr = p_rows[ps_:ps_ + pblock]
                        pi = np.repeat(pr, len(br))
                        bi = np.tile(br, len(pr))
                        pout = take_batch(probe_cat, torch.from_numpy(pi))
                        bout = take_batch(build_cat, torch.from_numpy(bi))
                        lo, ro = (bout, pout) if swap else (pout, bout)
                        comb = ColumnBatch(
                            list(lo.names) + list(ro.names),
                            list(lo.vectors) + list(ro.vectors),
                            None, len(pi))
                        if residual is not None:
                            rctx = EvalContext(comb)
                            rv = rctx.broadcast(residual.eval(rctx))
                            keep = rv.data.numpy().astype(bool)
                            if rv.valid is not None:
                                keep = keep & rv.valid.numpy()
                            matched[pi[keep]] = True
                            if how2 not in ("inner", "left"):
                                continue
                            comb = _mask_rows(comb, keep)
                        if how2 in ("inner", "left") \
                                and int(comb.num_rows()):
                            yield comb
            if how2 == "left":
                rest = _mask_rows(probe_cat, ~matched)
                if int(rest.num_rows()):
                    yield _null_extend(rest, self.schema, other_schema,
                                       other_dicts)
            elif how2 == "left_semi":
                yield _mask_rows(probe_cat, matched)
            elif how2 == "left_anti":
                yield _mask_rows(probe_cat, ~matched)

        return _run()

    def _probe_chunk(self, tagged: ColumnBatch, bchunk: ColumnBatch,
                     inner_how: str) -> Iterator[ColumnBatch]:
        """One probe-chunk x build-chunk inner join, splitting the build
        side in halves while the pair's output still fans out past the
        eager bound (inner joins distribute over build-row subsets)."""
        from .planner import JoinFanoutError
        node = self.node
        try:
            plan = L.Join(L.LocalRelation(tagged),
                          L.LocalRelation(_padded(bchunk)),
                          inner_how, node.on, node.using)
            yield _eager(self.session, plan)
            return
        except JoinFanoutError:
            live = live_prefix(compact(bchunk))
            rows = int(live.num_rows())
            if rows <= 1:
                raise
        half = max(rows // 2, 1)
        _log.info("chunk-pair join output fans out; splitting %d build "
                  "rows", rows)
        for part in _emit_pieces(live, half, pad_capacity(half)):
            yield from self._probe_chunk(tagged, live_prefix(part),
                                         inner_how)

    # -- partition, then join bucket by bucket ---------------------------
    def batches(self) -> Iterator[ColumnBatch]:
        n_max = self.session.conf.get(C.GRACE_MAX_BUCKETS)
        est = max(self.left.est_rows, self.right.est_rows, 1)
        n_buckets = min(n_max,
                        max(2, math.ceil(1.25 * est / self.batch_rows)))
        STREAM_STATS["grace_joins"] += 1
        STREAM_STATS["buckets"] += n_buckets
        _log.info("grace join: %d buckets over est %d/%d rows",
                  n_buckets, self.left.est_rows, self.right.est_rows)
        import time
        t0 = time.perf_counter()
        lstore = self._partition_stream(self.left, self._lkeys, n_buckets,
                                        self._ldicts)
        rstore = self._partition_stream(self.right, self._rkeys, n_buckets,
                                        self._rdicts)
        STREAM_STATS["partition_ms"] += (time.perf_counter() - t0) * 1e3
        try:
            for b in range(n_buckets):
                for out in self._bucket_join(lstore.load(b),
                                             rstore.load(b), 0):
                    yield from _emit_pieces(compact(out.to_host()),
                                            self.batch_rows, self.capacity)
        finally:
            lstore.close()
            rstore.close()


def _col_values(batch: ColumnBatch, name: str) -> np.ndarray:
    live = live_prefix(compact(batch.to_host()))
    if live.capacity == 0:
        return np.zeros(0, np.int64)
    return live.column(name).data.numpy().astype(np.int64)


def _drop_col(batch: ColumnBatch, name: str) -> ColumnBatch:
    idx = [i for i, n in enumerate(batch.names) if n != name]
    return ColumnBatch([batch.names[i] for i in idx],
                       [batch.vectors[i] for i in idx],
                       batch.row_valid, batch.capacity)


def _reorder(batch: ColumnBatch, names: List[str]) -> ColumnBatch:
    idx = [batch.names.index(n) for n in names]
    return ColumnBatch([batch.names[i] for i in idx],
                       [batch.vectors[i] for i in idx],
                       batch.row_valid, batch.capacity)


def _mask_rows(batch: ColumnBatch, keep: np.ndarray) -> ColumnBatch:
    rv = batch.row_valid_or_true() & torch.from_numpy(np.asarray(keep, bool))
    return ColumnBatch(list(batch.names), list(batch.vectors), rv,
                       batch.capacity)


def _null_extend(probe: ColumnBatch, out_schema: T.StructType,
                 other_schema: T.StructType, other_dicts: Dict[str, tuple]
                 ) -> ColumnBatch:
    """Probe rows with no match, null-extended on the other side, in the
    output schema's order (LEFT/RIGHT outer unmatched rows)."""
    cap = probe.capacity
    nulls = _empty_side(other_schema, other_dicts)
    vectors: List[ColumnVector] = []
    for f in out_schema.fields:
        n = f.name
        if n in probe.names:
            vectors.append(probe.column(n))
        else:
            proto = nulls.vectors[other_schema.names.index(n)]
            vectors.append(ColumnVector(
                torch.zeros(cap, dtype=proto.data.dtype), proto.dtype,
                torch.zeros(cap, dtype=torch.bool), proto.dictionary))
    return ColumnBatch(list(out_schema.names), vectors, probe.row_valid, cap)


# ---------------------------------------------------------------------------
# breakers over a stream (the shared mergers)
# ---------------------------------------------------------------------------

def _agg_mode(agg: L.Aggregate) -> Optional[str]:
    """'partial' (mergeable fixed-width buffers, first/last value-carry
    included), 'grace' (collect/percentile: bucket spill, then one host
    aggregate per bucket), or None (a raw distinct aggregate: its partial
    would drop the distinctness, so it stays eager)."""
    grace = False
    for f, _n in agg.aggs:
        if getattr(f, "is_distinct", False):
            return None
        if getattr(f, "is_collect", False) \
                or getattr(f, "is_percentile", False):
            grace = True
    return "grace" if grace else "partial"


def _run_breaker(session, stream: BatchStream, breaker: L.LogicalPlan,
                 topk: Optional[int], mesh=None) -> ColumnBatch:
    """Stream → merger → one materialized host result, through the
    cross-batch mergers of ``multibatch.py``."""
    import time

    from .multibatch import (_AggMerger, _ConcatMerger, _DistinctMerger,
                             _GraceAggMerger, _SortMerger, SpilledRuns,
                             default_spill_dir)
    mapped = _as_mapped(session, stream, mesh)
    conf = session.conf

    def make_spill():
        return SpilledRuns(conf.get(C.SPILL_MEMORY_ROWS),
                           default_spill_dir(conf),
                           budget_bytes=conf.get(C.SHUFFLE_SPILL_THRESHOLD),
                           run_codes=conf.get(C.SHUFFLE_WIRE_RUN_CODES),
                           conf=conf)

    spine_schema = stream.schema
    phys_wrap = None
    if isinstance(breaker, L.Aggregate) and _agg_mode(breaker) == "grace":
        merger = _GraceAggMerger(
            session, breaker, spine_schema, conf.get(C.GRACE_AGG_BUCKETS),
            conf.get(C.SPILL_MEMORY_ROWS), default_spill_dir(conf))
    elif isinstance(breaker, L.Aggregate):
        from ..parallel.dist import DPartialAggregate

        def phys_wrap(p):
            return DPartialAggregate(breaker.keys, breaker.aggs, p)
        merger = _AggMerger(breaker.keys, breaker.aggs, spine_schema,
                            conf.get(C.AGG_FOLD_ROWS))
    elif isinstance(breaker, L.Sort):
        orders = [(o.child, o.ascending, o.nulls_first)
                  for o in breaker.orders]

        def phys_wrap(p):
            p = P.PSort(orders, p)
            return P.PLimit(topk, p) if topk is not None else p
        merger = _SortMerger(make_spill(), orders, topk)
    elif isinstance(breaker, L.Distinct):
        phys_wrap = P.PDistinct
        merger = _DistinctMerger(make_spill(), conf.get(C.AGG_FOLD_ROWS))
    elif isinstance(breaker, L.Limit):
        def phys_wrap(p):
            return P.PLimit(breaker.n, p)
        merger = _ConcatMerger(make_spill(), limit=breaker.n)
    else:
        raise NotStreamable(f"unsupported breaker {breaker!r}")
    n_batches = 0
    try:
        gen = mapped.run(phys_wrap)
        try:
            for runs, _b in gen:
                n_batches += 1
                t0 = time.perf_counter()
                if hasattr(merger, "next_batch"):
                    merger.next_batch()
                more = all(merger.add(host) for host in runs)
                STREAM_STATS["merge_ms"] += (time.perf_counter() - t0) * 1e3
                if not more:
                    _log.info("stage breaker early exit")
                    break
        finally:
            gen.close()
        if n_batches == 0:
            # ZERO input batches (a streamed UNION whose branches all
            # filtered empty): the breaker still runs over an empty input
            # — a keyless aggregate gives its one global row
            empty = _empty_side(stream.schema,
                                getattr(stream, "_dicts", None) or {})
            plan: L.LogicalPlan = _rebase(breaker, L.LocalRelation(empty))
            if topk is not None:
                plan = L.Limit(topk, plan)
            return _eager(session, plan)
        t0 = time.perf_counter()
        result = merger.finish()
        STREAM_STATS["merge_ms"] += (time.perf_counter() - t0) * 1e3
        return compact(result.to_host())
    finally:
        spill = getattr(merger, "spill", None)
        if spill is not None:
            spill.close()
        if hasattr(merger, "close_spills"):
            merger.close_spills()


# ---------------------------------------------------------------------------
# plan → stage graph
# ---------------------------------------------------------------------------

class _Builder:
    def __init__(self, session, batch_rows: int, mesh=None):
        self.session = session
        self.batch_rows = batch_rows
        self.mesh = mesh

    def _oversized(self, node: L.LogicalPlan) -> bool:
        from ..io import file_row_count
        if isinstance(node, L.FileRelation):
            try:
                n = file_row_count(node)
            except Exception:
                return False
            return n is not None and n > self.batch_rows
        return any(self._oversized(c) for c in node.children)

    def _det(self, node: L.LogicalPlan) -> None:
        from .optimizer import is_deterministic
        for e in node.expressions():
            if e is not None and not is_deterministic(e):
                raise NotStreamable(
                    f"nondeterministic expression {e!r} cannot replay "
                    "per streamed batch")

    def build(self, node: L.LogicalPlan):
        """A materialized host ColumnBatch or a BatchStream."""
        if not self._oversized(node):
            return _eager(self.session, node)
        if isinstance(node, L.SubqueryAlias):
            return self.build(node.children[0])
        if isinstance(node, L.FileRelation):
            return _FileStream(self.session, node, self.batch_rows)
        if isinstance(node, (L.Project, L.Filter)):
            self._det(node)
            src = self.build(node.children[0])
            if isinstance(src, ColumnBatch):
                return _eager(self.session,
                              _rebase(node, L.LocalRelation(src)))
            mapped = _as_mapped(self.session, src, self.mesh)
            return mapped.with_op(lambda n, op=node: _rebase(op, n),
                                  node.schema())
        if isinstance(node, L.Limit) and isinstance(node.children[0], L.Sort):
            sort = node.children[0]
            self._det(sort)
            return self._breaker(sort.children[0], sort, topk=node.n)
        if isinstance(node, (L.Aggregate, L.Sort, L.Distinct, L.Limit)):
            self._det(node)
            if isinstance(node, L.Aggregate) and _agg_mode(node) is None:
                # a raw distinct aggregate: materialize the stream, then
                # aggregate eagerly
                mat = self._materialize(self.build(node.children[0]))
                return _eager(self.session,
                              _rebase(node, L.LocalRelation(mat)))
            return self._breaker(node.children[0], node, topk=None)
        if isinstance(node, L.Join):
            return self._join(node)
        if isinstance(node, L.Union):
            kids = [self.build(c) for c in node.children]
            streams = [k if isinstance(k, BatchStream)
                       else _SingletonStream(k, self.batch_rows)
                       for k in kids]
            return _UnionStream(self.session, streams, node.schema())
        raise NotStreamable(f"{type(node).__name__} over an oversized "
                            "file relation is not streamable")

    def _materialize(self, src) -> ColumnBatch:
        if isinstance(src, ColumnBatch):
            return src
        runs = [live_prefix(compact(b)) for b in src.batches()]
        runs = [r for r in runs if r.capacity > 0]
        if not runs:
            return ColumnBatch.empty(src.schema)
        return union_all(runs) if len(runs) > 1 else runs[0]

    def _breaker(self, child: L.LogicalPlan, breaker: L.LogicalPlan,
                 topk: Optional[int]) -> ColumnBatch:
        src = self.build(child)
        if isinstance(src, ColumnBatch):
            plan = _rebase(breaker, L.LocalRelation(src))
            if topk is not None:
                plan = L.Limit(topk, plan)
            return _eager(self.session, plan)
        return _run_breaker(self.session, src, breaker, topk, self.mesh)

    def _join(self, node: L.Join):
        self._det(node)
        lsrc = self.build(node.left)
        rsrc = self.build(node.right)
        lmat = isinstance(lsrc, ColumnBatch)
        rmat = isinstance(rsrc, ColumnBatch)
        if lmat and rmat:
            from .planner import JoinFanoutError
            try:
                return _eager(self.session, L.Join(
                    L.LocalRelation(lsrc), L.LocalRelation(rsrc),
                    node.how, node.on, node.using))
            except JoinFanoutError as fanout:
                # a join of two materialized intermediates whose hot-key
                # fanout exceeds the eager bound: grace-partitioning both
                # sides keeps each bucket pair's capacity small
                try:
                    gj = _GraceJoinStream(
                        self.session, node,
                        _SingletonStream(lsrc, self.batch_rows),
                        _SingletonStream(rsrc, self.batch_rows))
                except NotStreamable:
                    raise fanout
                _log.warning(
                    "eager join output exceeds the in-memory bound; "
                    "re-routing the materialized join through the grace "
                    "spill path (%s)", fanout)
                return gj

        def fits(b: ColumnBatch) -> bool:
            return int(b.num_rows()) <= self.batch_rows

        how = node.how
        # broadcast fusion: the materialized side rides the step as a
        # constant build leaf (BroadcastHashJoinExec)
        if rmat and not lmat and fits(rsrc):
            if how in ("inner", "left", "left_semi", "left_anti"):
                mapped = _as_mapped(self.session, lsrc, self.mesh)
                rel = L.LocalRelation(rsrc)
                return mapped.with_op(
                    lambda n, rel=rel: L.Join(n, rel, how, node.on,
                                              node.using),
                    node.schema())
            if how == "cross" and rsrc.capacity * lsrc.capacity <= 1 << 24:
                mapped = _as_mapped(self.session, lsrc, self.mesh)
                rel = L.LocalRelation(rsrc)
                return mapped.with_op(
                    lambda n, rel=rel: L.Join(n, rel, "cross", node.on,
                                              node.using),
                    node.schema())
        if lmat and not rmat and fits(lsrc):
            if how == "right":
                # plan_join swaps a right outer join, visiting the
                # streamed right side first
                mapped = _as_mapped(self.session, rsrc, self.mesh)
                rel = L.LocalRelation(lsrc)
                return mapped.with_op(
                    lambda n, rel=rel: L.Join(rel, n, "right", node.on,
                                              node.using),
                    node.schema())
            if how == "inner":
                # swap so the stream is the probe; restore column order
                mapped = _as_mapped(self.session, rsrc, self.mesh)
                rel = L.LocalRelation(lsrc)
                out_names = list(node.schema().names)
                return mapped.with_op(
                    lambda n, rel=rel: L.Project(
                        [Col(c) for c in out_names],
                        L.Join(n, rel, "inner", node.on, node.using)),
                    node.schema())
        # everything else: grace-partition both sides
        left = lsrc if isinstance(lsrc, BatchStream) \
            else _SingletonStream(lsrc, self.batch_rows)
        right = rsrc if isinstance(rsrc, BatchStream) \
            else _SingletonStream(rsrc, self.batch_rows)
        return _GraceJoinStream(self.session, node, left, right)


def _rebase(op: L.LogicalPlan, child: L.LogicalPlan) -> L.LogicalPlan:
    from .multibatch import _with_child
    out = _with_child(op, child)
    if out is None:
        raise NotStreamable(f"cannot rebase {type(op).__name__}")
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

class StageExecution:
    def __init__(self, session, optimized: L.LogicalPlan, batch_rows: int,
                 mesh=None):
        self.session = session
        self.optimized = optimized
        self.batch_rows = batch_rows
        self.mesh = mesh

    def execute(self) -> ColumnBatch:
        builder = _Builder(self.session, self.batch_rows, self.mesh)
        src = builder.build(self.optimized)
        result = builder._materialize(src)
        return compact(result.to_host())


def plan_stages(session, optimized: L.LogicalPlan, mesh=None
                ) -> Optional[StageExecution]:
    """The stage DAG for a plan over at least one file relation larger
    than a batch, or None.  Linear single-relation chains go to
    ``plan_multibatch`` first; a shape ``_Builder`` cannot stream raises
    ``NotStreamable`` from ``execute()``, and the caller falls back to
    the eager path."""
    if not session.conf.get(C.STAGES_ENABLED) \
            or not session.conf.get(C.MULTIBATCH_ENABLED):
        return None
    batch_rows = session.conf.get(C.SCAN_MAX_BATCH_ROWS)
    if not _Builder(session, batch_rows)._oversized(optimized):
        return None
    return StageExecution(session, optimized, batch_rows, mesh)
