"""Out-of-core multi-batch execution: the host-side stage runner.

The port of ``spark_tpu/sql/multibatch.py``.  A file relation larger than
one scan batch streams through ONE per-batch step — a stage-cache entry
keyed ``mb|…``: one captured CUDA graph on a card, replayed for every
batch — and a host-side merger folds the per-batch results:

- streamed file splits  → ``FileScanRDD.scala`` (one split at a time):
  ``io.scan_file_batches``, decoded ``prefetch_iter``'s depth ahead on a
  background thread, re-encoded onto the relation's global string
  dictionaries, padded to ONE capacity with every validity mask
  explicit (``columnar.normalize_valids``), so that every batch replays
  the same graph variant;
- cross-batch aggregate → the partial/final split of ``AggUtils.scala``:
  the step emits raw mergeable buffers (``DPartialAggregate``), the host
  folds them (``DMergePartial``) and finishes once (``DFinalAggregate``);
- sorted-run spill      → ``ExternalSorter.scala:89``: per-batch sorted
  runs accumulate under a host-RAM budget, overflow goes to disk in the
  wire format (``wire.py``), one final merge (``native.merge_sorted_runs``).

On a ``cuda`` session the batch lands in a ring of pinned host buffers
(``io.PinnedRing``), is copied by ``non_blocking`` copies into the
graph's static input buffers on the replay stream, and the step's result
and flags come back in one packed copy (``stagecompile._read_result``).
The card holds one batch and its partial; host RAM, then disk, hold the
rest.  The folds and the final aggregate run on the host, on host
tensors, through the port's operators (``ExecContext("cpu")``).
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import tempfile
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import config as C
from .. import types as T
from .. import wire
from ..aggregates import First
from ..columnar import (ColumnBatch, ColumnVector, live_prefix,
                        normalize_valids, pad_capacity, pad_to_capacity,
                        union_all)
from ..kernels import compact, distinct as k_distinct
from . import logical as L
from . import physical as P
from .planner import Planner, PlannedQuery, _plan_reserve_bytes
from .window import WindowNode

_log = logging.getLogger("spark_tpu_torch.multibatch")

#: what the streamed runners did in this process (reset freely): scan
#: batches through a step, host ms in the steps (dispatch), in their
#: read-backs (which wait for the step's kernels) and in the mergers, bytes of host leaves copied to the card (step
#: leaves and grace bucket pairs), files and bytes spilled by
#: SpilledRuns, grace joins, buckets, rows and bytes bucketed and spilled
#: by _BucketStore, host ms partitioning and joining grace buckets
STREAM_STATS = {"batches": 0, "step_ms": 0.0, "readback_ms": 0.0,
                "merge_ms": 0.0,
                "bytes_to_device": 0, "spill_files": 0, "spill_bytes": 0,
                "grace_joins": 0, "buckets": 0, "bucket_rows": 0,
                "bucket_bytes": 0, "bucket_spill_bytes": 0,
                "partition_ms": 0.0, "bucket_join_ms": 0.0}


def reset_stream_stats() -> None:
    for k in STREAM_STATS:
        STREAM_STATS[k] = 0.0 if k.endswith("_ms") else 0


# ---------------------------------------------------------------------------
# plan decomposition
# ---------------------------------------------------------------------------

class _Decomposed(NamedTuple):
    rel: L.FileRelation
    spine: List[L.LogicalPlan]        # streamable ops, bottom-up
    breaker: Optional[L.LogicalPlan]  # Aggregate | Sort | Distinct | Limit
    topk: Optional[int]               # Limit fused into a Sort breaker
    above: List[L.LogicalPlan]        # ops above the breaker, top-down
    grace: bool = False               # grace hash aggregation


def _with_child(op: L.LogicalPlan, child: L.LogicalPlan):
    """A one-child logical node rebuilt over a new child."""
    if isinstance(op, L.Project):
        return L.Project(op.exprs, child)
    if isinstance(op, L.Filter):
        return L.Filter(op.condition, child)
    if isinstance(op, L.Aggregate):
        return L.Aggregate(op.keys, op.aggs, child)
    if isinstance(op, L.Sort):
        return L.Sort(op.orders, child, op.is_global)
    if isinstance(op, L.Limit):
        return L.Limit(op.n, child)
    if isinstance(op, L.Distinct):
        return L.Distinct(child)
    if isinstance(op, WindowNode):
        return WindowNode(op.wexprs, child)
    if isinstance(op, L.Sample):
        return L.Sample(op.fraction, op.seed, child)
    return None


def _spine_ok(op: L.LogicalPlan) -> bool:
    # nondeterministic expressions would correlate draws and ids across
    # batches if one step replayed per batch: such plans stay eager
    from .optimizer import is_deterministic
    if isinstance(op, L.Project):
        return all(is_deterministic(e) for e in op.exprs)
    if isinstance(op, L.Filter):
        return is_deterministic(op.condition)
    return False


def _decompose(optimized: L.LogicalPlan) -> Optional[_Decomposed]:
    chain: List[L.LogicalPlan] = []
    node = optimized
    while True:
        if isinstance(node, L.SubqueryAlias):
            node = node.children[0]
            continue
        chain.append(node)
        if not node.children:
            break
        if len(node.children) != 1:
            return None
        node = node.children[0]
    leaf = chain[-1]
    if not isinstance(leaf, L.FileRelation):
        return None
    ops = chain[:-1]                      # root .. just above the leaf
    i = len(ops)
    while i > 0 and _spine_ok(ops[i - 1]):
        i -= 1
    spine = ops[i:][::-1]                 # bottom-up
    rest = ops[:i]                        # root .. breaker
    breaker: Optional[L.LogicalPlan] = None
    topk: Optional[int] = None
    above: List[L.LogicalPlan] = []
    grace = False
    if rest:
        cand = rest[-1]
        if not isinstance(cand, (L.Aggregate, L.Sort, L.Distinct, L.Limit)):
            return None
        breaker = cand
        above = rest[:-1]
        if isinstance(cand, L.Sort) and above \
                and isinstance(above[-1], L.Limit):
            topk = above[-1].n
            above = above[:-1]
        if isinstance(breaker, L.Aggregate):
            # one classification shared with the stage runner
            from .stages import _agg_mode
            mode = _agg_mode(breaker)
            if mode is None:
                return None
            grace = mode == "grace"
        for op in above:
            if _with_child(op, leaf) is None:
                return None
    return _Decomposed(leaf, spine, breaker, topk, above, grace)


def default_spill_dir(conf) -> str:
    """Where mergers spill: the configured directory, or one per process
    under the temporary directory."""
    return conf.get(C.SPILL_DIR) or os.path.join(
        tempfile.gettempdir(), f"spark_tpu_torch_spill_{os.getpid()}")


def host_run(session, node: L.LogicalPlan) -> ColumnBatch:
    """A logical plan over host batches run on the host, through the
    port's operators on the CPU (``ExecContext("cpu")``), compacted.
    Keyed aggregates are not shrunk: nothing here reads the flags."""
    planner = Planner(session, shrink_aggs=False)
    leaves: List[ColumnBatch] = []
    phys = planner._to_physical(node, leaves)
    planner._assign_op_ids(phys, [1])
    out = phys.run(P.ExecContext("cpu", [b.to_host() for b in leaves]))
    return compact(out.to_host())


def _run_host(phys: P.PhysicalPlan, batch: ColumnBatch) -> ColumnBatch:
    return compact(phys.run(P.ExecContext("cpu", [batch])))


# ---------------------------------------------------------------------------
# spill-backed run accumulator
# ---------------------------------------------------------------------------

class SpilledRuns:
    """Run batches held in host RAM up to a row budget (and, when set, a
    byte budget), then on disk in the wire format (``Spillable.scala``'s
    threshold idiom): a torn spill file fails its checksum on read."""

    def __init__(self, budget_rows: int, spill_dir: str,
                 budget_bytes: int = 0, run_codes: bool = False,
                 conf: Optional[C.Conf] = None):
        self.budget_rows = budget_rows
        self.conf = conf               # the wire codec and its threshold
        self.run_codes = run_codes
        self.budget_bytes = budget_bytes
        os.makedirs(spill_dir, exist_ok=True)
        self._dir = tempfile.mkdtemp(prefix="runs-", dir=spill_dir)
        self._mem: List[ColumnBatch] = []
        self._disk: List[str] = []
        self.total_rows = 0
        self._mem_rows = 0
        self._mem_bytes = 0
        self._n_spilled = 0

    def add(self, batch: ColumnBatch) -> None:
        rows = int(batch.num_rows())
        self.total_rows += rows
        self._mem.append(batch)
        self._mem_rows += rows
        if self.budget_bytes > 0:
            self._mem_bytes += wire.raw_nbytes([batch])
        if (self._mem_rows > self.budget_rows
                or 0 < self.budget_bytes < self._mem_bytes):
            self._spill()

    def _spill(self) -> None:
        path = os.path.join(self._dir, f"run-{self._n_spilled:05d}.spill")
        self._n_spilled += 1
        data = wire.encode_batches([b.to_host() for b in self._mem],
                                   run_codes=self.run_codes, conf=self.conf)
        with open(path, "wb") as f:
            f.write(data)
        STREAM_STATS["spill_files"] += 1
        STREAM_STATS["spill_bytes"] += len(data)
        _log.info("spilled %d rows in %d runs to %s",
                  self._mem_rows, len(self._mem), path)
        self._disk.append(path)
        self._mem = []
        self._mem_rows = 0
        self._mem_bytes = 0

    def drain(self) -> List[ColumnBatch]:
        """All runs (disk runs loaded back); clears the accumulator."""
        runs: List[ColumnBatch] = []
        for path in self._disk:
            with open(path, "rb") as f:
                data = f.read()
            runs.extend(wire.decode_batches(data, keep_runs=self.run_codes))
            os.remove(path)
        runs.extend(self._mem)
        self._disk = []
        self._mem = []
        self._mem_rows = 0
        self._mem_bytes = 0
        self.total_rows = 0
        return runs

    def close(self) -> None:
        """Remove every spill file and the run directory."""
        for path in self._disk:
            try:
                os.remove(path)
            except OSError:
                pass
        self._disk = []
        self._mem = []
        try:
            os.rmdir(self._dir)
        except OSError:
            pass


def _pack_keys(cols: List[np.ndarray], n: int) -> np.ndarray:
    """Sort-key columns (int64, compared in order) as one int64 key per
    row when their value ranges fit 63 bits together, else as a
    ``(rows, keys)`` array."""
    if not cols:
        return np.zeros(n, np.int64)
    los = [int(c.min()) for c in cols]
    widths = [max(int(c.max()) - lo, 0).bit_length()
              for c, lo in zip(cols, los)]
    if sum(widths) > 63:
        return np.stack(cols, axis=1)
    key = np.zeros(n, np.int64)
    for c, lo, w in zip(cols, los, widths):
        key = (key << np.int64(w)) | (c - np.int64(lo))
    return key


def _concat(runs: List[ColumnBatch]) -> ColumnBatch:
    return union_all(runs) if len(runs) > 1 else runs[0]


# ---------------------------------------------------------------------------
# cross-batch mergers
# ---------------------------------------------------------------------------

class _ConcatMerger:
    """Map-only spine (or plain Limit): concatenate per-batch outputs."""

    def __init__(self, spill: SpilledRuns, limit: Optional[int] = None):
        self.spill = spill
        self.limit = limit

    def add(self, batch: ColumnBatch) -> bool:
        self.spill.add(batch)
        if self.limit is not None and self.spill.total_rows >= self.limit:
            return False                       # early-exit the scan
        return True

    def finish(self) -> ColumnBatch:
        runs = self.spill.drain()
        if not runs:
            raise RuntimeError("no scan batches produced")
        out = _concat(runs)
        if self.limit is not None:
            return _run_host(P.PLimit(self.limit, P.PScan(0, out.schema)),
                             out)
        return compact(out)


class _SortMerger:
    """Sorted-run accumulation + one final host merge; a fused Limit (the
    ORDER BY … LIMIT k top-k) keeps the accumulation bounded by folding
    whenever it exceeds a few multiples of k."""

    def __init__(self, spill: SpilledRuns, orders, topk: Optional[int]):
        self.spill = spill
        self.orders = orders                  # [(expr, asc, nulls_first)]
        self.topk = topk

    def _sort_limit(self, batch: ColumnBatch) -> ColumnBatch:
        phys: P.PhysicalPlan = P.PSort(self.orders, P.PScan(0, batch.schema))
        if self.topk is not None:
            phys = P.PLimit(self.topk, phys)
        return _run_host(phys, batch)

    def add(self, batch: ColumnBatch) -> bool:
        self.spill.add(batch)
        if self.topk is not None and \
                self.spill.total_rows > max(4 * self.topk, 1 << 16):
            self.spill.add(self._sort_limit(_concat(self.spill.drain())))
        return True

    def _merge(self, runs: List[ColumnBatch]) -> Optional[ColumnBatch]:
        """k-way merge of the sorted runs by ``merge_sorted_runs`` over
        the sort's own key image (``kernels.sort_key_transform``, the
        keys ``PSort`` sorts by), so the merged order is the order one
        sort of their concatenation gives, ties in run order.  The key
        columns pack into one int64 when their value ranges fit 63 bits
        (a stable sort of it merges the runs' natural order), else they
        compare column by column.  The reference merges a single integral
        key this way and sorts the concatenation otherwise; the port
        merges any ORDER BY whose keys evaluate on the host.  None when
        there is nothing to merge."""
        if self.topk is not None or len(runs) < 2:
            return None
        from ..expressions import EvalContext
        from ..kernels import _sortable, sort_key_transform, take_batch
        from ..native import merge_sorted_runs
        runs = [live_prefix(r) for r in runs]
        cat = _concat(runs)
        ectx = EvalContext(cat)
        cols = []
        for e, asc, nf in self.orders:
            v = ectx.broadcast(e.eval(ectx))
            for k in sort_key_transform(v.data, v.valid,
                                        e.data_type(cat.schema), asc, nf):
                col = _sortable(k).to(torch.int64).numpy()
                if len(col) and col.min() != col.max():
                    cols.append(col)
        bounds = np.cumsum([0] + [r.capacity for r in runs])
        keys = _pack_keys(cols, cat.capacity)
        perm = torch.from_numpy(merge_sorted_runs(
            [keys[bounds[i]:bounds[i + 1]] for i in range(len(runs))]))
        out = take_batch(cat, perm)
        return ColumnBatch(out.names, out.vectors, None, out.capacity)

    def finish(self) -> ColumnBatch:
        runs = self.spill.drain()
        if not runs:
            raise RuntimeError("no scan batches produced")
        runs = [compact(r) for r in runs]
        merged = self._merge(runs)
        if merged is not None:
            return merged
        return self._sort_limit(_concat(runs))


class _DistinctMerger:
    """Per-batch distincts re-distincted whenever the accumulation exceeds
    a budget that grows when the true distinct count is larger."""

    def __init__(self, spill: SpilledRuns, fold_rows: int):
        self.spill = spill
        self.fold_rows = fold_rows

    def _fold(self) -> None:
        runs = self.spill.drain()
        if not runs:
            return
        self.spill.add(compact(k_distinct(_concat(runs))))
        got = self.spill.total_rows
        if got > self.fold_rows:
            self.fold_rows = 2 * got          # avoid quadratic refolding

    def add(self, batch: ColumnBatch) -> bool:
        self.spill.add(batch)
        if self.spill.total_rows > self.fold_rows:
            self._fold()
        return True

    def finish(self) -> ColumnBatch:
        self._fold()
        runs = self.spill.drain()
        return runs[0] if runs else ColumnBatch.empty(T.StructType([]))


class _AggMerger:
    """Accumulates ``DPartialAggregate`` outputs (keys + raw buffer
    columns), folds them with per-buffer-kind re-reduction
    (``DMergePartial``: sum-of-sums, min-of-mins) and finishes once
    (``DFinalAggregate``) — the merge contract the mesh lane uses across
    shards, reused across scan batches.  A partial's min/max/first value
    buffer over a string column carries its dictionary itself."""

    def __init__(self, keys, slots, child_schema: T.StructType,
                 fold_rows: int):
        from ..parallel.dist import DPartialAggregate
        self.keys = list(keys)
        self.slots = list(slots)
        self.child_schema = child_schema
        self.partial = DPartialAggregate(
            self.keys, self.slots, P.PScan(0, child_schema))
        self.fold_rows = fold_rows
        self._acc: List[ColumnBatch] = []
        self._rows = 0
        self._first_slots = [i for i, (f, _n) in enumerate(self.slots)
                             if isinstance(f, First)]
        self._batch_ord = -1   # bumped by next_batch() before each batch

    def next_batch(self) -> None:
        """Called once per scan batch (before its runs are added): the
        scan ordinal the first/last ranks are rebased on."""
        self._batch_ord += 1

    def _rebase_ranks(self, pbatch: ColumnBatch) -> ColumnBatch:
        """First/last rank buffers re-encoded from per-batch coordinates
        (``shard << 48 | row``) into scan-global ``(batch, shard, row)``
        lexicographic int64s, so the cross-batch min/max picks the
        scan-order first (or last) contributing row."""
        if not self._first_slots:
            return pbatch
        if self._batch_ord >= (1 << 29):
            raise RuntimeError("first/last rank rebase overflow: > 2^29 "
                               "scan batches")
        live = pbatch.row_valid_or_true().numpy()
        names = list(pbatch.names)
        vectors = list(pbatch.vectors)
        for i in self._first_slots:
            func = self.slots[i][0]
            is_last = getattr(func, "ARGREDUCE", "first") == "last"
            dead = np.int64(-1) if is_last else np.int64(1 << 62)
            j = names.index(self.partial.buffer_names(i, func)[0])
            v = vectors[j]
            rank = v.data.numpy().astype(np.int64)
            mask = live & (rank != dead)
            shard = rank >> np.int64(48)
            row = rank & np.int64((1 << 48) - 1)
            if mask.any():
                if int(row[mask].max()) >= (1 << 24):
                    raise RuntimeError(
                        "first/last rank rebase requires scan batches "
                        "<= 2^24 rows")
                if int(shard[mask].max()) >= 256:
                    raise RuntimeError(
                        "first/last rank rebase supports at most 256 "
                        "shards per batch")
            enc = (np.int64(self._batch_ord) << np.int64(32)) \
                | (shard << np.int64(24)) | row
            vectors[j] = ColumnVector(torch.from_numpy(np.where(mask, enc,
                                                                dead)),
                                      v.dtype, v.valid, v.dictionary)
        return ColumnBatch(names, vectors, pbatch.row_valid, pbatch.capacity)

    def _fold(self) -> None:
        if len(self._acc) <= 1:
            return
        from ..parallel.dist import DMergePartial
        allp = union_all(self._acc)
        folded = _run_host(DMergePartial(self.keys, self.slots, self.partial,
                                         P.PScan(0, allp.schema)), allp)
        self._acc = [folded]
        self._rows = int(folded.num_rows())

    def add(self, pbatch: ColumnBatch) -> bool:
        pbatch = self._rebase_ranks(pbatch)
        self._acc.append(pbatch)
        self._rows += int(pbatch.num_rows())
        if self._rows > self.fold_rows:
            self._fold()
        return True

    def finish(self) -> ColumnBatch:
        from ..parallel.dist import DFinalAggregate
        if not self._acc:
            raise RuntimeError("no scan batches produced")
        self._fold()
        state = self._acc[0]
        return _run_host(DFinalAggregate(self.keys, self.slots, self.partial,
                                         P.PScan(0, state.schema)), state)


class _GraceAggMerger:
    """Grace hash aggregation for aggregates with no fixed-width mergeable
    partial (collect_list/collect_set, percentile, and any mix of them
    with other slots): raw spine rows stream into spill buckets by
    group-key hash (the grace join's ``_BucketStore``), and each bucket
    is aggregated on the host at the end.  Groups never straddle
    buckets, so per-bucket results are exact and disjoint
    (``ObjectHashAggregateExec.scala``'s fallback role)."""

    def __init__(self, session, agg, spine_schema: T.StructType,
                 n_buckets: int, budget_rows: int, spill_dir: str):
        from .stages import _BucketStore
        self.session = session
        self.keys = list(agg.keys)
        self.aggs = list(agg.aggs)
        self.spine_schema = spine_schema
        self.n_buckets = max(1, n_buckets) if self.keys else 1
        self.store = _BucketStore(self.n_buckets, budget_rows, spill_dir)

    def __getstate__(self):
        # the session holds locks: a resumed merger is reattached by the
        # runner that loads it
        d = dict(self.__dict__)
        d["session"] = None
        return d

    def add(self, batch: ColumnBatch) -> bool:
        from .stages import _hash_buckets
        live = live_prefix(compact(batch.to_host()))
        if live.capacity == 0:
            return True
        if self.n_buckets == 1:
            bucket = np.zeros(live.capacity, np.int64)
        else:
            bucket = _hash_buckets(live, self.keys, self.n_buckets, 0)
        self.store.add(live, bucket)
        return True

    def _eager_agg(self, bucket_batch: ColumnBatch) -> ColumnBatch:
        return host_run(self.session, L.Aggregate(
            self.keys, self.aggs, L.LocalRelation(bucket_batch)))

    def finish(self) -> ColumnBatch:
        outs: List[ColumnBatch] = []
        for b in range(self.n_buckets):
            runs = self.store.load(b)
            if not runs:
                continue
            out = self._eager_agg(_concat(runs))
            if int(out.num_rows()):
                outs.append(out)
        self.close_spills()
        if not outs:
            # zero input rows: a global aggregate still gives its row
            return self._eager_agg(ColumnBatch.empty(self.spine_schema))
        return _concat(outs)

    def close_spills(self) -> None:
        self.store.close()


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _prefix_live(phys: P.PhysicalPlan) -> bool:
    """True when ``phys``'s output provably carries all live rows in a
    prefix, so the per-batch step can skip the sort-based ``compact``
    (the aggregation stages scatter groups to slots 0..k-1, PSort pushes
    dead rows past the end, scan batches arrive compacted and padded,
    projects and limits keep a prefix-live child)."""
    from ..parallel.dist import (DFinalAggregate, DMergePartial,
                                 DPartialAggregate)
    if isinstance(phys, (DPartialAggregate, DFinalAggregate,
                         DMergePartial, P.PSort)):
        return True
    if isinstance(phys, (P.PScan, P.PRange)):
        return True
    if isinstance(phys, (P.PProject, P.PLimit)):
        return _prefix_live(phys.children[0])
    return False


def step_maker(phys: P.PhysicalPlan, slots, device, skey: str,
               in_schemas, skip_compact: bool):
    """What makes a streamed step's stage-cache entry: one run of
    ``phys`` over the step's leaves, compacted unless its output is
    prefix-live; its scalars are the row count and the overflow flags."""
    from . import stagecompile as SC

    def make():
        entry_slots = slots          # the entry owns THIS plan's literals

        def step(leaves, params, ctx=None):
            from .. import expressions as E
            E._slot_bindings.map = {
                id(l): p for l, p in zip(entry_slots, params)}
            try:
                if ctx is None:
                    ctx = P.ExecContext(device, list(leaves))
                out = phys.run(ctx)
                c = out if skip_compact else compact(out)
                return c, [c.num_rows()] + list(ctx.flags), \
                    (list(ctx.flag_caps), list(ctx.flag_kinds))
            finally:
                E._slot_bindings.map = None

        return step, SC.Stage(phys, in_schemas, phys.schema(), skey)

    return make


class StreamedStep:
    """One stage-cache entry run per streamed batch.

    The entry is dispatched (a captured graph on a card): a pinned leaf
    goes to the card by ``non_blocking`` copies into the graph's static
    buffers, the slotted literals ride in the entry's parameter scalars,
    and the step's live rows and flags come back in one packed copy.
    ``ship_rows`` — the rows that copy brings — starts at the step's
    capacity and then follows twice the most rows a batch has given, so
    a partial aggregate of a few groups ships a few rows, not the batch's
    capacity.

    Under the mesh the entry's step is one SPMD program over the shards
    (``spmd.run_shards``): the stream leaf split over the shards inside
    the program, the other leaves replicated, each shard's output one
    run.  The program is the entry's graph, like the single-device
    step's, and its one packed copy brings every shard's first
    ``ship_rows`` rows, row count and flags."""

    def __init__(self, session, phys: P.PhysicalPlan, leaves, key_prefix: str,
                 skip_compact: bool, mesh=None):
        from . import stagecompile as SC
        from ..columnar import dense_runs
        self.session = session
        self.mesh = mesh
        self.device = session.device
        # the extra leaves (broadcast build sides) take the run-plane
        # decision on the single-device lane; the mesh lane splits or
        # replicates leaves by rows, which a plane cannot follow
        if mesh is None:
            leaves = [leaves[0]] + SC.plan_leaves(session, leaves[1:])
        else:
            leaves = [dense_runs(b, "cpu") for b in leaves]
        skey, slots = SC.stage_fingerprint(phys)
        self.key = (f"{key_prefix}|{skey}|{SC.leaf_signature(leaves)}"
                    f"|{SC._conf_component(session)}"
                    + (f"|cards{mesh.n_cards}" if mesh is not None
                       and mesh.n_cards > 1 else ""))
        self.cache = SC.stage_cache(session)
        make = step_maker(phys, slots, self.device, self.key,
                          [b.schema for b in leaves], skip_compact)
        if mesh is not None:
            make = mesh_step_maker(make, mesh, self.device)
        self.entry = self.cache.get_or_build(
            self.key, make, n_ops=SC.count_ops(phys), session=session,
            segments=1 if mesh is None else mesh.n_shards)
        self.params = SC.param_values(slots)
        self.capacity = leaves[0].capacity
        if mesh is not None and mesh.n_cards > 1:
            # each card holds its own copy of every replicated leaf
            self.extra = [b.to_device(dev) for b in leaves[1:]
                          for dev in mesh.cards]
        else:
            self.extra = [b.to_device(self.device) for b in leaves[1:]]
        self.ship_rows = self.capacity
        self._most_rows = 0
        self.reserve = _plan_reserve_bytes(
            PlannedQuery(phys, list(leaves)),
            1 if mesh is None else mesh.n_shards)

    def run(self, leaf: ColumnBatch
            ) -> Tuple[List[ColumnBatch], List[int], List[int], List[str]]:
        """(host runs, int flags, flag caps, flag kinds) of one batch."""
        from . import stagecompile as SC
        t0, rb0 = time.perf_counter(), SC.READBACK_MS
        if self.device.type == "cuda" and leaf.device.type == "cpu":
            from ..memory import batch_nbytes
            STREAM_STATS["bytes_to_device"] += batch_nbytes(leaf)
        try:
            return self._run(leaf)
        finally:
            readback = SC.READBACK_MS - rb0
            STREAM_STATS["readback_ms"] += readback
            STREAM_STATS["step_ms"] += \
                (time.perf_counter() - t0) * 1e3 - readback
            STREAM_STATS["batches"] += 1

    def _run(self, leaf: ColumnBatch):
        def finish(host, ints, meta):
            return host, ints, meta

        multi = self.mesh is not None and self.mesh.n_cards > 1
        if multi:
            # each card's rows of the batch go to it
            from ..parallel.executor import place_leaves
            leaves = place_leaves(self.mesh, [leaf]) + self.extra
        else:
            leaves = [leaf] + self.extra
        host, ints, (caps, kinds) = self.cache.dispatch(
            self.entry, leaves, self.params, finish,
            self.device, memory=self.session._memory,
            ship_rows=self.ship_rows, card_memory=self.session.card_memory)
        if multi:
            from .. import cuda_a2a
            cuda_a2a.check_barriers()
        most = ints[0]
        self._most_rows = max(self._most_rows, most)
        self.ship_rows = min(self.capacity,
                             pad_capacity(2 * max(self._most_rows, 1)))
        flags = ints[1:1 + len(caps)]
        if self.mesh is None:
            return ([_head(host, most)] if most else []), flags, caps, kinds
        # one run per shard: shard s's rows are the s-th of the packed
        # copy's equal segments
        runs = []
        if not any(f > 0 for f in flags):
            n = self.mesh.n_shards
            seg = host.capacity // n
            for s, rows in enumerate(ints[1 + len(caps):1 + len(caps) + n]):
                if rows:
                    runs.append(_head(_segment(host, s * seg, seg), rows))
        return runs, flags, caps, kinds


def mesh_step_maker(make, mesh, device):
    """A streamed step's entry builder under the mesh: ``make``'s step run
    once per shard as one SPMD program.  The program's scalars are the
    most live rows of a shard, each overflow flag's worst shard and every
    shard's row count; its result is the shards' outputs one after
    another (``segments`` of the entry).

    On several cards the step's leaves are the stream batch's parts per
    card (``executor.place_leaves``) and each replicated leaf once per
    card; its parameters one list per card; and the scalars and outputs
    meet on shard 0's card through the collectives (pmax, all-gather, K2's
    gather to shard 0)."""
    from ..parallel.executor import (_join_shards, gather_batch,
                                     placed_shards, shard_leaf)
    from ..parallel.spmd import ShardContext, run_shards
    n = mesh.n_shards
    C = mesh.n_cards

    def mesh_make():
        fn, stage = make()

        def step(leaves, params):
            if C == 1:
                shards = shard_leaf(mesh, leaves[0])
                extra = list(leaves[1:])
            else:
                shards = placed_shards(mesh, leaves[:C])[0]
                rest = leaves[C:]

            def shard_fn(shard, comm):
                if C == 1:
                    ls = [shards[shard]] + extra
                    return fn(ls, params, ShardContext(device, ls, shard,
                                                       comm))
                c = mesh.card_of[shard]
                ls = [shards[shard]] + list(rest[c::C])
                out, scal, meta = fn(ls, params[c], ShardContext(
                    mesh.devices[shard], ls, shard, comm))
                rows = scal[0].reshape(()).to(torch.int64)
                most = comm.pmax(shard, rows)
                flags = []
                if len(scal) > 1:
                    flags = list(comm.pmax(shard, torch.stack(
                        [f.reshape(()).to(torch.int64) for f in scal[1:]]
                    )).unbind())
                every = comm.all_gather(shard, [rows])[0]
                joined = gather_batch(comm, shard, out)
                return joined, [most] + flags + list(every.unbind()), meta

            results = run_shards(n, device, shard_fn, mesh)
            if C > 1:
                return results[0]
            outs = [r[0] for r in results]
            rows = [r[1][0] for r in results]
            n_flags = len(results[0][1]) - 1
            flags = [torch.stack([r[1][1 + i].reshape(()).to(torch.int64)
                                  for r in results]).amax()
                     for i in range(n_flags)]
            most = torch.stack([x.reshape(()).to(torch.int64)
                                for x in rows]).amax()
            return _join_shards(outs), [most] + flags + rows, results[0][2]

        if C > 1:
            step.cards = list(mesh.cards)
        return step, stage

    return mesh_make


def _segment(host: ColumnBatch, start: int, rows: int) -> ColumnBatch:
    """Rows ``[start, start + rows)`` of a host batch."""
    sl = slice(start, start + rows)
    vectors = [ColumnVector(v.data[sl], v.dtype,
                            None if v.valid is None else v.valid[sl],
                            v.dictionary) for v in host.vectors]
    rv = None if host.row_valid is None else host.row_valid[sl]
    return ColumnBatch(host.names, vectors, rv, rows)


def _head(host: ColumnBatch, n: int) -> ColumnBatch:
    """The first ``pad_capacity(n)`` rows of a compacted host batch (its
    live prefix with the padding a capacity needs)."""
    cap = min(pad_capacity(max(n, 1)), host.capacity)
    if cap == host.capacity:
        return host
    vectors = [ColumnVector(v.data[:cap], v.dtype,
                            None if v.valid is None else v.valid[:cap],
                            v.dictionary) for v in host.vectors]
    rv = None if host.row_valid is None else host.row_valid[:cap]
    return ColumnBatch(host.names, vectors, rv, cap)


class BatchFeed:
    """The streamed batches of one file relation, ready for a step: each
    re-encoded onto the global dictionaries, padded to ``capacity`` with
    explicit masks and — on a card — copied into a pinned ring slot, all
    on the prefetch thread.  Yields ``(host batch, leaf, slot)``; the
    consumer calls ``done(slot)`` once it has queued the leaf's copies,
    and ``close()`` at the end."""

    def __init__(self, session, rel: L.FileRelation, batch_rows: int,
                 fixed_dicts, skip: int = 0, ring: bool = True):
        from ..io import PinnedRing, scan_prefetch_depth
        self.session = session
        self.rel = rel
        self.batch_rows = batch_rows
        self.capacity = pad_capacity(batch_rows)
        self.fixed_dicts = fixed_dicts
        self.skip = skip
        self.depth = scan_prefetch_depth(session)
        on_card = session.device.type == "cuda"
        self.ring = PinnedRing(self.depth + 1) if on_card and ring else None

    def prep(self, raw: ColumnBatch) -> ColumnBatch:
        from ..io import reencode_strings
        return normalize_valids(pad_to_capacity(
            reencode_strings(raw, self.fixed_dicts), self.capacity))

    def __iter__(self):
        from ..io import prefetch_iter, scan_file_batches
        idx = [0]

        def _prep(raw):
            i = idx[0]
            idx[0] += 1
            b = self.prep(raw)
            if i < self.skip:              # folded into a checkpoint
                return b, None, None
            if self.ring is None:
                return b, b, None
            leaf, slot = self.ring.fill(b)
            return b, leaf, slot

        return prefetch_iter(scan_file_batches(self.rel, self.batch_rows),
                             _prep, self.depth)

    def done(self, leaf: Optional[ColumnBatch], slot) -> None:
        from ..io import SCAN_STATS
        from ..memory import batch_nbytes
        if leaf is not None and self.session.device.type == "cuda":
            SCAN_STATS["bytes_to_device"] += batch_nbytes(leaf)
        if slot is not None:
            self.ring.release(slot)

    def close(self) -> None:
        if self.ring is not None:
            self.ring.close()


class MultiBatchExecution:
    def __init__(self, session, dec: _Decomposed, batch_rows: int):
        self.session = session
        self.dec = dec
        self.batch_rows = batch_rows
        self.capacity = pad_capacity(batch_rows)

    # -- per-batch step ----------------------------------------------------
    def _step_physical(self, template: ColumnBatch
                       ) -> Tuple[P.PhysicalPlan, T.StructType]:
        """Physical spine + breaker-partial for one scan batch — one
        definition for the local and the sharded steps."""
        planner = Planner(self.session)
        node: L.LogicalPlan = L.LocalRelation(template)
        for op in self.dec.spine:
            node = _with_child(op, node)
        leaves: List[ColumnBatch] = []
        phys = planner._to_physical(node, leaves)
        spine_schema = phys.schema()
        breaker = self.dec.breaker
        if isinstance(breaker, L.Aggregate):
            if not self.dec.grace:
                from ..parallel.dist import DPartialAggregate
                phys = DPartialAggregate(breaker.keys, breaker.aggs, phys)
            # grace: the raw spine rows stream; the merger buckets them
        elif isinstance(breaker, L.Sort):
            orders = [(o.child, o.ascending, o.nulls_first)
                      for o in breaker.orders]
            phys = P.PSort(orders, phys)
            if self.dec.topk is not None:
                phys = P.PLimit(self.dec.topk, phys)
        elif isinstance(breaker, L.Distinct):
            phys = P.PDistinct(phys)
        elif isinstance(breaker, L.Limit):
            phys = P.PLimit(breaker.n, phys)
        planner._assign_op_ids(phys, [1])
        return phys, spine_schema

    def _build_step(self, template: ColumnBatch
                    ) -> Tuple[StreamedStep, T.StructType]:
        phys, spine_schema = self._step_physical(template)
        return StreamedStep(self.session, phys, [template], "mb",
                            _prefix_live(phys)), spine_schema

    # -- merger selection ------------------------------------------------
    def _make_merger(self, spine_schema: T.StructType,
                     template: ColumnBatch):
        conf = self.session.conf
        breaker = self.dec.breaker
        spill_dir = default_spill_dir(conf)
        if isinstance(breaker, L.Aggregate):
            if self.dec.grace:
                return _GraceAggMerger(
                    self.session, breaker, spine_schema,
                    conf.get(C.GRACE_AGG_BUCKETS),
                    conf.get(C.SPILL_MEMORY_ROWS), spill_dir)
            return _AggMerger(breaker.keys, breaker.aggs, spine_schema,
                              conf.get(C.AGG_FOLD_ROWS))
        spill = SpilledRuns(
            conf.get(C.SPILL_MEMORY_ROWS), spill_dir,
            budget_bytes=conf.get(C.SHUFFLE_SPILL_THRESHOLD),
            run_codes=conf.get(C.SHUFFLE_WIRE_RUN_CODES), conf=conf)
        if isinstance(breaker, L.Sort):
            orders = [(o.child, o.ascending, o.nulls_first)
                      for o in breaker.orders]
            return _SortMerger(spill, orders, self.dec.topk)
        if isinstance(breaker, L.Distinct):
            return _DistinctMerger(spill, conf.get(C.AGG_FOLD_ROWS))
        if isinstance(breaker, L.Limit):
            return _ConcatMerger(spill, limit=breaker.n)
        return _ConcatMerger(spill)

    # -- checkpoint / resume -------------------------------------------------
    # Every checkpointInterval batches the merger (host state and spill
    # file references) and the batch cursor are pickled atomically; a
    # rerun of the same query over the same files resumes at the cursor.
    # Scan order is deterministic (sorted files, fixed batch_rows).
    def _ckpt_path(self) -> Optional[str]:
        ckpt_dir = self.session.conf.get(C.MULTIBATCH_CKPT)
        if not ckpt_dir:
            return None
        ident = [repr(self.dec.spine), repr(self.dec.breaker),
                 str(self.batch_rows)]
        from ..io import _resolve_paths
        for p in _resolve_paths(self.dec.rel.paths):
            st = os.stat(p)
            ident += [p, str(st.st_mtime_ns), str(st.st_size)]
        key = hashlib.sha1("|".join(ident).encode()).hexdigest()[:16]
        os.makedirs(ckpt_dir, exist_ok=True)
        return os.path.join(ckpt_dir, f"mb-{key}.ckpt")

    def _ckpt_save(self, path: str, n_batches: int, merger) -> None:
        try:
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump({"n": n_batches, "merger": merger}, f,
                            protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        except Exception as e:   # a failed checkpoint must not fail the run
            _log.warning("multi-batch checkpoint to %s failed: %s", path, e)

    def _ckpt_load(self, path: Optional[str]):
        if not path or not os.path.exists(path):
            return 0, None
        try:
            with open(path, "rb") as f:
                payload = pickle.load(f)
            merger = payload["merger"]
            spill = getattr(merger, "spill", None)
            if spill is not None:
                for run in spill._disk:
                    if not os.path.exists(run):   # spill files vanished
                        raise FileNotFoundError(run)
            if hasattr(merger, "session"):
                merger.session = self.session
            _log.info("resuming multi-batch run at batch %d from %s",
                      payload["n"], path)
            return payload["n"], merger
        except Exception as e:           # torn or stale: start over
            _log.warning("ignoring unusable checkpoint %s: %s", path, e)
            return 0, None

    def execute(self) -> ColumnBatch:
        from ..io import scan_string_dictionaries
        rel = self.dec.rel
        fixed_dicts = scan_string_dictionaries(rel, self.batch_rows)
        ckpt = self._ckpt_path()
        interval = self.session.conf.get(C.MULTIBATCH_CKPT_INTERVAL)
        skip, merger = self._ckpt_load(ckpt)
        feed = BatchFeed(self.session, rel, self.batch_rows, fixed_dicts,
                         skip)
        step = None
        n_batches = 0
        completed = False
        mem = self.session._memory
        owner = f"stream:{id(self)}"
        try:
            for b, leaf, slot in feed:
                self.session.raise_if_cancelled()
                try:
                    if step is None:
                        step, spine_schema = self._build_step(b)
                        mem.acquire_execution(owner, step.reserve)
                        if merger is None:
                            merger = self._make_merger(spine_schema, b)
                    n_batches += 1
                    if n_batches <= skip:
                        continue         # already folded into the merger
                    runs, flags, _caps, _kinds = step.run(leaf)
                finally:
                    feed.done(leaf, slot)
                if any(f > 0 for f in flags):
                    raise RuntimeError(
                        f"streamed step overflowed its static capacity "
                        f"(flags {flags})")
                t0 = time.perf_counter()
                if hasattr(merger, "next_batch"):
                    merger.next_batch()
                more = all(merger.add(host) for host in runs)
                STREAM_STATS["merge_ms"] += (time.perf_counter() - t0) * 1e3
                if not more:
                    _log.info("multi-batch scan early exit after %d batches",
                              n_batches)
                    break
                if ckpt and interval > 0 and n_batches % interval == 0:
                    self._ckpt_save(ckpt, n_batches, merger)
            if merger is None:
                raise RuntimeError(f"empty file relation {rel!r}")
            t0 = time.perf_counter()
            result = merger.finish()
            STREAM_STATS["merge_ms"] += (time.perf_counter() - t0) * 1e3
            completed = True
        finally:
            feed.close()
            mem.release_execution(owner)
            # with checkpointing on, the spill files a checkpoint refers
            # to must survive a crash; they go on success or at the next
            # run's resume or restart
            spill = getattr(merger, "spill", None)
            if spill is not None and (not ckpt or completed):
                spill.close()
            if not completed and hasattr(merger, "close_spills") \
                    and not ckpt:
                merger.close_spills()
        if ckpt and os.path.exists(ckpt):
            try:
                os.remove(ckpt)
            except OSError:
                pass
        return self._run_above(result)

    def _run_above(self, result: ColumnBatch) -> ColumnBatch:
        """Ops above the breaker run on the merged result, on the host:
        post-breaker data is usually small, and a large sorted or
        concatenated result must not go back to the card whole."""
        if not self.dec.above:
            return compact(result.to_host())
        node: L.LogicalPlan = L.LocalRelation(result)
        for op in reversed(self.dec.above):
            node = _with_child(op, node)
        return host_run(self.session, node)


class DistributedMultiBatchExecution(MultiBatchExecution):
    """Multi-batch streaming under the mesh lane: every scan batch is
    split over the shards and runs the spine + breaker-partial step per
    shard; each shard's result is one independent run of the host
    merger (``ShuffledRowRDD`` stages that are out-of-core and
    distributed at once).  The step's entry is keyed ``mbdist{n}|…``."""

    def __init__(self, session, dec: _Decomposed, batch_rows: int, mesh):
        super().__init__(session, dec, batch_rows)
        self.mesh = mesh
        self.n = mesh.n_shards

    def _build_step(self, template: ColumnBatch
                    ) -> Tuple[StreamedStep, T.StructType]:
        phys, spine_schema = self._step_physical(template)
        return StreamedStep(self.session, phys, [template],
                            f"mbdist{self.n}", _prefix_live(phys),
                            mesh=self.mesh), spine_schema


def plan_multibatch(session, optimized: L.LogicalPlan, mesh=None
                    ) -> Optional[MultiBatchExecution]:
    """The multi-batch runner for a query, or None: it must be enabled,
    the plan must decompose into scan → spine → breaker → above over ONE
    file relation, and the file must exceed one batch.  With a ``mesh``
    the per-batch step runs sharded over it."""
    if not session.conf.get(C.MULTIBATCH_ENABLED):
        return None
    dec = _decompose(optimized)
    if dec is None:
        return None
    batch_rows = session.conf.get(C.SCAN_MAX_BATCH_ROWS)
    from ..io import file_row_count
    try:
        total = file_row_count(dec.rel)
    except Exception:
        return None
    if total is None or total <= batch_rows:
        return None
    _log.info("multi-batch path: %d rows > %d rows/batch (%s)%s",
              total, batch_rows, dec.rel,
              "" if mesh is None else f" sharded over {mesh}")
    if mesh is not None:
        return DistributedMultiBatchExecution(session, dec, batch_rows, mesh)
    return MultiBatchExecution(session, dec, batch_rows)
