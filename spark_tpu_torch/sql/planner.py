"""Planner + executor: logical plan → physical plan → one run on the device.

The local single-device lane of ``spark_tpu/sql/planner.py`` (the
compressed analog of ``QueryExecution.scala:67-92``).  Where the JAX
package jits the physical plan into one XLA program from its stage
cache, here the plan runs as one CUDA graph captured once and replayed
from the port's stage cache (``stagecompile.py``); the eager lane
(``spark.sql.codegen.wholeStage=false``) and the per-operator baseline
(``spark.tpu.stage.fusion=false``) stay beside it.  Before dispatch the
plan's static bytes are reserved with the session's ``MemoryManager``.
The adaptive join-factor / agg-capacity retry loop and its overflow
accounting are the reference's.  Each flag is a device scalar; all of
them come back to the host in one transfer after the plan has run.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import config as C
from .. import types as T
from ..columnar import ColumnBatch, ColumnVector, dense_runs, pad_capacity
from ..expressions import AnalysisException
from ..kernels import compact
from .logical import (
    Aggregate, CachedRelation, Distinct, EventTimeWatermark, Explode,
    FileRelation, Filter, FlatMapGroupsWithState, Join, LazyCheckpoint,
    Limit, LocalRelation, LogicalPlan, Project,
    RangeRelation, Sample, Sort, SubqueryAlias, Union, plan_cache_key,
)
from . import physical as P

_log = logging.getLogger("spark_tpu_torch.execution")

#: adaptive capacity retry policy
ADAPT_MAX_RETRIES = 4


def grow_capacity_factor(base: float, ratio: float) -> float:
    """Next capacity factor after an overflow of `ratio` (lost/capacity):
    at least 2× so pathological distributions converge in few retries."""
    return base * max(2.0, (1.0 + ratio) * 1.25)


class JoinFanoutError(RuntimeError):
    """An adaptive join-capacity growth asked for an output buffer beyond
    ``spark.sql.join.maxOutputRows``."""


def _fanout_error(where: str, est_rows: float, factor: float,
                  probe_rows: int, cap: int) -> JoinFanoutError:
    return JoinFanoutError(
        f"{where} output needs ~{est_rows:,.0f} rows of static capacity "
        f"(factor {factor:.2f}x over {probe_rows:,} probe rows; > "
        f"{C.JOIN_OUTPUT_MAX_ROWS.key}={cap}): the join fans out too "
        "much for eager in-memory execution.  Route it out-of-core "
        f"(file-backed inputs larger than {C.SCAN_MAX_BATCH_ROWS.key} "
        "stream through the grace-join stage runner), reduce the "
        "hot-key fanout, or raise the cap explicitly")


def check_factor_cap(factor: float, probe_rows: int, session,
                     where: str = "join") -> None:
    """Fanout guard where a join's probe capacity is known directly (the
    streamed step passes each join's OWN static probe base): an output
    buffer beyond ``spark.sql.join.maxOutputRows`` rows raises the typed
    ``JoinFanoutError`` — which the stage DAG's ``_Builder`` catches to
    re-route a join through the grace spill path — instead of exhausting
    memory.
    The bound is absolute rows: a large factor on a small batch is
    fine."""
    cap = session.conf.get(C.JOIN_OUTPUT_MAX_ROWS)
    est = factor * max(probe_rows, 1)
    if est > cap:
        raise _fanout_error(where, est, factor, probe_rows, cap)


def _overflow_ratio(flags: List[int], caps: List[int]) -> float:
    """Worst lost-rows / static-capacity ratio across all overflow flags.

    A missing capacity degrades to cap=1 so a positive flag is NEVER
    silently ignored."""
    ratio = 0.0
    for i, f in enumerate(flags):
        if f > 0:
            c = caps[i] if i < len(caps) else 1
            ratio = max(ratio, f / max(c, 1))
    return ratio


def _slice_to_host(result: ColumnBatch, n: int) -> ColumnBatch:
    """Transfer only the live prefix of a COMPACTED device batch to host:
    collect() of a few rows from a padded million-row batch must not ship
    the padding over PCIe.  Every column, mask and ``row_valid`` comes
    over in ONE packed copy (``ColumnBatch.packed_host``)."""
    return result.packed_host(min(pad_capacity(max(n, 1)), result.capacity))


def _row_nbytes(schema: T.StructType, width: int = 1) -> int:
    """Device bytes per row of one materialized batch of this schema
    (data + validity + row mask); an array column counts ``width``
    elements."""
    return 2 + sum(np.dtype(f.dataType.np_dtype).itemsize
                   * (width if isinstance(f.dataType, T.ArrayType) else 1)
                   + 1 for f in schema.fields)


def _plan_exprs(obj):
    """Every expression a physical node's fields hold, lambda bodies
    included."""
    from ..expressions import Expression
    if isinstance(obj, Expression):
        yield obj
        for c in obj.children:
            yield from _plan_exprs(c)
        for f in getattr(obj, "LAMBDA_BODIES", ()):
            yield from _plan_exprs(getattr(obj, f))
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _plan_exprs(x)


def _array_width_bound(pq: "PlannedQuery") -> int:
    """An upper bound of every array plane's width in the plan: array
    operators keep or narrow their input's width, so the widest source
    bounds them all — a 2-D leaf, a collect's ``max_len``, an array()
    call, an array literal or a split() of a leaf dictionary."""
    from ..aggregates import CollectList
    from ..expressions import Literal, MakeArray, SplitStr
    width = max([1] + [int(v.data.shape[1]) for b in pq.leaves
                       for v in b.vectors if v.data.dim() == 2])
    splits = []

    def walk(node):
        nonlocal width
        for name, val in vars(node).items():
            if name == "children":
                continue
            for e in _plan_exprs(val):
                if isinstance(e, CollectList):
                    width = max(width, e.max_len or 1)
                elif isinstance(e, MakeArray):
                    width = max(width, len(e.children))
                elif isinstance(e, Literal) and isinstance(e.value,
                                                           (list, tuple)):
                    width = max(width, len(e.value))
                elif isinstance(e, SplitStr):
                    splits.append(e)
        for c in node.children:
            walk(c)

    walk(pq.physical)
    for e in splits:
        for b in pq.leaves:
            for v in b.vectors:
                if v.dictionary is not None:
                    width = max(width,
                                e.split_table(v.dictionary)[0].shape[1])
    return width


def _walk_plan_caps(pq: "PlannedQuery"):
    """(root_cap, extra_bytes, join_caps) over the physical plan's STATIC
    output capacities — exact arithmetic, not a heuristic: join output
    capacity is ``pad_capacity(probe × factor)`` by construction
    (joins.py).  ``join_caps`` lists ``(PJoin, probe_rows, out_rows)``
    for every join with an adaptive (factor-sized) output buffer.  Array
    planes count ``_array_width_bound`` elements a row: an explode's
    output holds its child's capacity times that many rows, and a
    collect aggregate scatters into a plane that wide."""
    from .joins import PJoin

    extra = 0
    join_caps: List[tuple] = []
    widths: List[int] = []

    def width() -> int:
        # walked only for a plan that holds arrays (most hold none)
        if not widths:
            widths.append(_array_width_bound(pq))
        return widths[0]

    def row_nbytes(schema: T.StructType) -> int:
        if any(isinstance(f.dataType, T.ArrayType) for f in schema.fields):
            return _row_nbytes(schema, width())
        return _row_nbytes(schema)

    def cap(node: P.PhysicalPlan) -> int:
        nonlocal extra
        if isinstance(node, P.PScan):
            return pq.leaves[node.index].capacity
        if isinstance(node, P.PRange):
            return node.capacity
        ch = [cap(c) for c in node.children]
        if isinstance(node, P.PExplode):
            out = (ch[0] if ch else 1) * width()
            extra += out * row_nbytes(node.schema())
            return out
        if isinstance(node, P.PAggregate):
            for f, _n in node.slots:
                if getattr(f, "is_collect", False):
                    # the scatter plane: a max_len row per input row, and
                    # a spill slot per input row
                    extra += (ch[0] if ch else 1) * (f.max_len + 1) * 8
        if isinstance(node, P.PAggregate) and not node.keys:
            return 1            # global aggregate: capacity-1 output
        if isinstance(node, P.PAggShrink):
            return min(ch[0] if ch else 1, node.out_rows)
        if isinstance(node, PJoin):
            probe = ch[0] if ch else 1
            build = ch[1] if len(ch) > 1 else 1
            if node.how == "cross" or not node.key_pairs:
                # the all-pairs path takes ANY join without equi keys
                out = probe * build
            elif node.how in ("left_semi", "left_anti"):
                return probe                     # probe-shaped, no buffer
            else:
                out = pad_capacity(int(probe * max(node.factor, 0.1)))
                if node.how == "full":
                    out += build
                join_caps.append((node, probe, out))
            extra += out * row_nbytes(node.schema())
            return out
        if isinstance(node, P.PUnion):
            out = sum(ch) if ch else 1
            extra += out * row_nbytes(node.schema())
            return out
        return max(ch) if ch else 1

    root_cap = cap(pq.physical)
    extra += root_cap * row_nbytes(pq.physical.schema())
    return root_cap, extra, join_caps


def check_planned_join_capacities(pq: "PlannedQuery", session,
                                  where: str = "join") -> None:
    """Fail any join whose STATIC output buffer exceeds
    ``spark.sql.join.maxOutputRows``, naming the join that owns it."""
    cap = session.conf.get(C.JOIN_OUTPUT_MAX_ROWS)
    for node, probe, out in _walk_plan_caps(pq)[2]:
        if out > cap:
            raise _fanout_error(where, out, node.factor, probe, cap)


def _plan_reserve_bytes(pq: "PlannedQuery") -> int:
    """Upper-bound device bytes for one execution attempt: the leaf
    working set (input + one fused intermediate), the device copy of
    every host leaf (a file batch or a cached relation held on the host:
    not resident before the query as an in-memory leaf is), plus the
    STATIC output buffers of every capacity-growing operator
    (``_walk_plan_caps``).  A cached relation on the card counts its
    intermediate only: its input is charged as storage already."""
    from ..memory import batch_nbytes
    _root, extra, _joins = _walk_plan_caps(pq)
    kinds = [k for k, _n in pq.leaf_recipes] if pq.leaf_recipes \
        else [None] * len(pq.leaves)
    total = extra
    for b, kind in zip(pq.leaves, kinds):
        if kind == "cached" and b.device.type == "cuda":
            copies = 1
        elif b.source is not None or kind == "cached" and b.is_pinned():
            copies = 3
        else:
            copies = 2
        total += copies * batch_nbytes(b)
    return total


def _reads_files(plan: LogicalPlan) -> bool:
    """Whether any leaf of ``plan`` is a file relation."""
    return isinstance(plan, FileRelation) or any(
        _reads_files(c) for c in plan.children)


def _needs_local_fallback(plan: LogicalPlan) -> bool:
    """Plans the mesh lane cannot shard: ArrayType columns at a leaf or
    feeding an exchange-inducing operator (exchanges are 1-D)."""
    from .. import types as T
    from .window import WindowNode
    found = []

    def has_arrays(node: LogicalPlan) -> bool:
        try:
            return any(isinstance(f.dataType, T.ArrayType)
                       for f in node.schema().fields)
        except AnalysisException:
            return False

    def walk(node: LogicalPlan):
        if not node.children and has_arrays(node):
            found.append("array-leaf")
        exchange_like = isinstance(node, (Aggregate, Distinct, Join, Union,
                                          Sort, WindowNode))
        for c in node.children:
            if exchange_like and has_arrays(c):
                found.append("array-into-exchange")
            walk(c)

    walk(plan)
    return bool(found)


def stage_key(session, pq: "PlannedQuery", leaves=None
              ) -> Tuple[str, list]:
    """(stage-cache key, slotted Literal objects) of one planned query:
    the slot-aware physical fingerprint, the leaves' shape/dtype
    signature (``leaves``, default ``pq.leaves``) and the planning
    conf."""
    from . import stagecompile as SC
    body, slots = SC.stage_fingerprint(pq.physical)
    return compose_stage_key(session, body,
                             pq.leaves if leaves is None else leaves), slots


def compose_stage_key(session, body: str, leaves) -> str:
    """The stage key of a physical fingerprint ``body`` over ``leaves``."""
    from . import stagecompile as SC
    return (f"local|{body}|{SC.leaf_signature(leaves)}"
            f"|{SC._conf_component(session)}")


def stage_maker(pq: "PlannedQuery", slots, device, skey: str):
    """The builder of ``pq``'s stage-cache entry: a step that runs the
    physical plan once with ``slots`` bound to the entry's parameter
    scalars, and its ``Stage`` record."""
    from . import stagecompile as SC

    def make():
        physical = pq.physical
        entry_slots = slots          # entry owns THIS plan's literals

        def run(leaves, params):
            from .. import expressions as E
            E._slot_bindings.map = {
                id(l): p for l, p in zip(entry_slots, params)}
            try:
                ctx = P.ExecContext(device, list(leaves))
                out = compact(physical.run(ctx))
                meta = (list(ctx.flag_caps), list(ctx.flag_kinds),
                        [(oid, lbl) for oid, lbl, _v in ctx.metrics])
                return out, [out.num_rows()] + list(ctx.flags) \
                    + [v for _o, _l, v in ctx.metrics], meta
            finally:
                E._slot_bindings.map = None

        return run, SC.Stage(physical, [b.schema for b in pq.leaves],
                             physical.schema(), skey)

    return make


class PlannedQuery:
    def __init__(self, physical: P.PhysicalPlan, leaves: List[ColumnBatch],
                 leaf_recipes=None):
        self.physical = physical
        self.leaves = leaves
        #: how each leaf batch was obtained, in PScan index order:
        #: ("local", LocalRelation) | ("file", FileRelation) |
        #: ("cached", CachedRelation) | ("opaque", None) — the serving
        #: plan cache re-reads file leaves on a hit (an answer is never
        #: staler than the files) and cached relations (the entry as it
        #: is now), and caches no plan with an opaque leaf (a lazy
        #: checkpoint's files); None where no planner made the leaves
        self.leaf_recipes = leaf_recipes


class Planner:
    """Logical → physical (``SparkPlanner.strategies`` analog)."""

    def __init__(self, session, join_factor_override=None,
                 agg_shrink_override=None, shrink_aggs: bool = True,
                 for_execution: bool = True):
        #: None | float (every join) | list (per join construction index —
        #: chained joins must not COMPOUND one overflowing join's growth)
        self.session = session
        self.join_factor_override = join_factor_override
        #: None | int rows: adaptively grown keyed-agg output capacity
        self.agg_shrink_override = agg_shrink_override
        #: False where a plan runs WITHOUT its flags being read (the
        #: out-of-core runners' host folds): the shrink's overflow flag is
        #: its only escape hatch, so such plans must not shrink
        self.shrink_aggs = shrink_aggs
        #: False for explain: a lazy checkpoint is shown, not written
        self.for_execution = for_execution
        self._join_seq = 0
        self._leaf_recipes: list = []

    def bind_collect(self, aggs):
        """The aggregate slots with each collect bound to the session's
        ``spark.tpu.collect.maxArrayLen``: the arrays' width is a constant
        of the plan, so of its stage key."""
        width = self.session.conf.get(C.COLLECT_MAX_LEN)
        return [(f.with_max_len(width) if getattr(f, "is_collect", False)
                 else f, n) for f, n in aggs]

    def _shrunk(self, agg: P.PhysicalPlan) -> P.PhysicalPlan:
        if not self.shrink_aggs:
            return agg
        rows = self.agg_shrink_override
        if rows is None:
            rows = self.session.conf.get(C.AGG_OUTPUT_ROWS)
        return P.PAggShrink(pad_capacity(int(rows)), agg)

    def next_join_factor(self) -> float:
        """Output capacity factor for the NEXT join constructed; each call
        consumes one position of a list override."""
        i = self._join_seq
        self._join_seq += 1
        o = self.join_factor_override
        if isinstance(o, (list, tuple)):
            if i < len(o) and o[i] is not None:
                return o[i]
            return self.session.conf.get(C.JOIN_OUTPUT_FACTOR)
        if o is not None:
            return o
        return self.session.conf.get(C.JOIN_OUTPUT_FACTOR)

    def plan(self, logical: LogicalPlan) -> PlannedQuery:
        self._join_seq = 0            # positional factors restart per plan
        self._leaf_recipes = []
        leaves: List[ColumnBatch] = []
        phys = self._to_physical(logical, leaves)
        self._assign_op_ids(phys, [1])
        if self.session.conf.get(C.METRICS_ENABLED):
            phys = self._wrap_metrics(phys)
        return PlannedQuery(phys, leaves, self._leaf_recipes)

    def _wrap_metrics(self, node: P.PhysicalPlan) -> P.PhysicalPlan:
        node.children = tuple(self._wrap_metrics(c) for c in node.children)
        return P.PMetric(node)

    def _assign_op_ids(self, node: P.PhysicalPlan, counter: List[int]) -> None:
        node.op_id = counter[0]
        counter[0] += 1
        for c in node.children:
            self._assign_op_ids(c, counter)

    def _scan(self, batch: ColumnBatch, leaves: List[ColumnBatch],
              source=None) -> P.PScan:
        leaves.append(batch)
        kind = "opaque" if source is None else \
            "file" if isinstance(source, FileRelation) else \
            "cached" if isinstance(source, CachedRelation) else "local"
        self._leaf_recipes.append((kind, source))
        return P.PScan(len(leaves) - 1, batch.schema)

    def _to_physical(self, node: LogicalPlan, leaves) -> P.PhysicalPlan:
        if isinstance(node, LocalRelation):
            return self._scan(node.batch, leaves, node)
        if isinstance(node, RangeRelation):
            return P.PRange(node.start, node.end, node.step, node.name,
                            node.num_rows())
        if isinstance(node, FileRelation):
            # one host batch per relation (pinned on a card session),
            # copied to the device per run and never kept there
            from ..io import read_file_relation
            return self._scan(read_file_relation(node, self.session),
                              leaves, node)
        if isinstance(node, SubqueryAlias):
            return self._to_physical(node.child, leaves)
        if isinstance(node, FlatMapGroupsWithState):
            # host-side user function: the child sub-plan runs as its own
            # query, the function runs per group with a fresh batch-mode
            # state, and the result enters THIS plan as a scanned leaf
            # (FlatMapGroupsWithStateExec batch semantics)
            from ..streaming.groupstate import run_flat_map_groups
            child = QueryExecution(self.session, node.child).execute()
            out, _states, _ch, _rm = run_flat_map_groups(
                node.func, node.key_names, child, node.out_schema, {},
                watermark_us=None, timeout_conf=node.timeout_conf)
            return self._scan(out, leaves)
        if isinstance(node, EventTimeWatermark):
            return self._to_physical(node.children[0], leaves)  # batch no-op
        if isinstance(node, Project):
            return P.PProject(node.exprs, self._to_physical(node.child, leaves))
        if isinstance(node, Filter):
            return P.PFilter(node.condition, self._to_physical(node.child, leaves))
        if isinstance(node, Aggregate):
            agg = P.PAggregate(node.keys, self.bind_collect(node.aggs),
                               self._to_physical(node.child, leaves))
            return self._shrunk(agg) if node.keys else agg
        if isinstance(node, Sort):
            orders = [(o.child, o.ascending, o.nulls_first) for o in node.orders]
            return P.PSort(orders, self._to_physical(node.child, leaves))
        if isinstance(node, Limit):
            return P.PLimit(node.n, self._to_physical(node.child, leaves))
        if isinstance(node, Distinct):
            return self._shrunk(
                P.PDistinct(self._to_physical(node.child, leaves)))
        if isinstance(node, Join):
            from .joins import plan_join
            return plan_join(self, node, leaves)
        if isinstance(node, Union):
            return P.PUnion([self._to_physical(c, leaves)
                             for c in node.children], node.schema())
        from .window import WindowNode
        if isinstance(node, WindowNode):
            return P.PWindow(node.wexprs,
                             self._to_physical(node.child, leaves))
        if isinstance(node, Sample):
            return P.PSample(node.fraction, node.seed,
                             self._to_physical(node.child, leaves))
        if isinstance(node, Explode):
            return P.PExplode(node.pre_exprs, node.array_expr, node.out_name,
                              node.with_pos, node.pos_name,
                              self._to_physical(node.child, leaves),
                              insert_at=node.insert_at)
        if isinstance(node, LazyCheckpoint):
            return self._checkpoint(node, leaves)
        raise AnalysisException(f"no physical plan for {node!r}")

    def _checkpoint(self, node: LazyCheckpoint, leaves) -> P.PhysicalPlan:
        """The first execution over a lazy checkpoint writes its child to
        parquet; every execution then scans the files.  Explain writes
        nothing and shows the child's plan."""
        if not node.state["done"]:
            if not self.for_execution:
                return self._to_physical(node.child, leaves)
            from .dataframe import DataFrame
            DataFrame(self.session, node.child).write.parquet(node.path)
            node.state["done"] = True
        from ..io import read_file_relation
        rel = self.session.read.parquet(node.path)._plan
        # opaque to the plan cache: the node's done-state would churn
        # fingerprints, and the materialization must run
        return self._scan(read_file_relation(rel, self.session), leaves)


class QueryExecution:
    """Carries one query through analyze → optimize → plan → execute."""

    def __init__(self, session, logical: LogicalPlan):
        self.session = session
        self.logical = logical
        self._analyzed: Optional[LogicalPlan] = None
        self._optimized: Optional[LogicalPlan] = None
        self._planned: Optional[PlannedQuery] = None
        #: per-operator metrics of the last execution:
        #: {(op_id, operator label): output row count}
        self.metrics: Dict[Tuple[int, str], int] = {}
        #: leave the result on the device (the cross-process lanes bucket
        #: a local result there before their one read-back)
        self.keep_on_device = False

    @property
    def analyzed(self) -> LogicalPlan:
        if self._analyzed is None:
            from .analyzer import Analyzer
            plan = Analyzer(self.session.catalog).analyze(self.logical)
            self._analyzed = self._use_cached_data(plan)
        return self._analyzed

    def _use_cached_data(self, plan: LogicalPlan) -> LogicalPlan:
        """Replace subtrees a ``DataFrame.cache()`` materialized with the
        cached batches (``CacheManager.useCachedData`` on the analyzed
        plan), bottom up.  A plan over a cached file scan then reads no
        file, so the out-of-core routing (``_reads_files``) passes it
        by."""
        cache = self.session._cache
        if not cache.entries():
            return plan
        memo: dict = {}               # one memo across the walk: O(n) keys

        def sub(node: LogicalPlan) -> LogicalPlan:
            if isinstance(node, LocalRelation):
                return node           # never probe: not substitutable
            key = plan_cache_key(node, memo)
            hit = cache.get(key)      # get() bumps the LRU
            return node if hit is None else CachedRelation(hit, key)

        return plan.transform_up(sub)

    @property
    def optimized(self) -> LogicalPlan:
        if self._optimized is None:
            from .optimizer import Optimizer
            self._optimized = Optimizer(self.session.conf).optimize(self.analyzed)
        return self._optimized

    @property
    def planned(self) -> PlannedQuery:
        if self._planned is None:
            self._planned = Planner(self.session).plan(self.optimized)
        return self._planned

    def planned_preview(self) -> PlannedQuery:
        """The plan for explain: lazy checkpoints are NOT written."""
        return Planner(self.session, for_execution=False) \
            .plan(self.optimized)

    # ------------------------------------------------------------------
    MAX_ADAPT = ADAPT_MAX_RETRIES

    def execute(self) -> ColumnBatch:
        """Run the query; returns a COMPACTED host batch.

        Capacity overflow (a join producing more rows than its static
        output buffer, or more groups than the agg output capacity)
        triggers an automatic replan with a factor sized from the MEASURED
        overflow, instead of erroring."""
        self.session._last_qe = self      # metrics/explain introspection
        self.session._query_count += 1
        session = self.session
        if not session._events_wanted():
            return self._execute_inner()
        # the listener bus: one SQLExecutionStart / SQLExecutionEnd pair
        # per execution, the end with the operator metrics or the error
        t0 = time.time()
        session._post_event({"event": "SQLExecutionStart", "time": t0,
                             "plan": repr(self.optimized)[:500]})
        try:
            result = self._execute_inner()
        except BaseException as e:
            session._post_event({
                "event": "SQLExecutionEnd", "time": time.time(),
                "durationMs": (time.time() - t0) * 1000,
                "error": f"{type(e).__name__}: {e}"[:300]})
            raise
        session._post_event({
            "event": "SQLExecutionEnd", "time": time.time(),
            "durationMs": (time.time() - t0) * 1000,
            "metrics": {f"{oid}:{lbl}": v
                        for (oid, lbl), v in self.metrics.items()}})
        return result

    def _staged(self, kind: str, thunk):
        """Route one mesh-lane (``dist``) or out-of-core (``multibatch``,
        ``stages``) execution through the serving plan cache's
        statement-level bookkeeping: a repeat — from ANY server session —
        reports ``cacheHit``.  Without an attached plan cache this is the
        thunk."""
        plan_cache = self.session._plan_cache
        if plan_cache is None:
            return thunk()
        return plan_cache.run_staged(self, kind, thunk)

    def _out_of_core(self, mesh=None) -> Optional[ColumnBatch]:
        """The out-of-core path: a file scan larger than one batch streams
        through the multi-batch runner (a one-child chain) or the stage
        DAG (plans with joins), never as one batch.  With a ``mesh`` the
        per-batch steps split over its shards, and the grace bucket joins
        come back through the mesh lane.  None when no relation exceeds a
        batch, or when the stage DAG cannot stream the plan (the caller's
        eager path runs it); a plan that reads no file skips the file
        stats."""
        if not _reads_files(self.optimized):
            return None
        from .multibatch import plan_multibatch
        mb = plan_multibatch(self.session, self.optimized, mesh=mesh)
        if mb is not None:
            return self._staged("multibatch", mb.execute)
        from .stages import NotStreamable, plan_stages
        st = plan_stages(self.session, self.optimized, mesh=mesh)
        if st is None:
            return None
        try:
            return self._staged("stages", st.execute)
        except NotStreamable as e:
            _log.warning("stage runner fallback to %s eager: %s",
                         "local" if mesh is None else "distributed", e)
            return None

    def _execute_inner(self) -> ColumnBatch:
        # The optimized plan is verified first (analysis.maybe_verify_plan,
        # on under pytest or with spark.tpu.analysis.verifyPlans=on), its
        # physical plan per attempt (_run_planned) and each stage's cut
        # contract where the stage cache builds it.  The mesh lane below
        # stays eager (no graphs).  The cross-process exchange
        # (``crossproc_execute``) runs the host shuffle's lanes, recovering
        # a lost peer in epochs up to spark.tpu.recovery.maxStageRetries;
        # exchanges stay on the host tier or, with
        # spark.tpu.shuffle.ici.enabled, between processes on one card
        # through the device tier.
        session = self.session
        session.raise_if_cancelled()      # checkpoint: before planning
        from ..analysis import maybe_verify_plan
        maybe_verify_plan(session, self.optimized)
        svc = session._crossproc_svc
        if svc is not None:
            # a registered host shuffle makes the exchange a planner
            # decision (ShuffleExchangeExec placement role): every local
            # run inside grounds out with the service cleared
            from ..parallel.crossproc import crossproc_execute
            return self._staged(
                "crossproc",
                lambda: crossproc_execute(session, self.optimized, svc))
        n_shards = session.conf.get(C.MESH_SHARDS)
        if n_shards == 0:
            n_shards = 1          # "all local devices": the engine spans one
        if n_shards > 1 and _needs_local_fallback(self.optimized):
            _log.info("array plan: falling back to single-shard")
            n_shards = 1
        if n_shards > 1:
            # the mesh lane: n shards of one SPMD program on the session's
            # device, every exchange one all-to-all kernel launch
            from ..parallel.executor import DistributedExecution
            from ..parallel.mesh import get_mesh
            mesh = get_mesh(n_shards, session.device)
            out = self._out_of_core(mesh)
            if out is not None:
                return out
            return self._staged(
                "dist", lambda: DistributedExecution(session, mesh).execute(
                    self.optimized))

        out = self._out_of_core()
        if out is not None:
            return out

        # serving plan cache (serving/plancache.py): attached to server
        # sessions, shared across all of them.  A usable entry skips the
        # planner and the stage key; None falls through to the normal
        # adaptive path (uncacheable plan, overflow, a lane that captures
        # nothing)
        plan_cache = session._plan_cache
        t0 = time.perf_counter()
        if plan_cache is not None:
            cached_out = plan_cache.try_execute(self)
            if cached_out is not None:
                return cached_out

        base_key = "local:" + self.planned.physical.key()
        adapted = self.session._adapted_factors.get(base_key) or {}
        factors, shrink = adapted.get("join"), adapted.get("shrink")
        grew = False
        for attempt in range(self.MAX_ADAPT + 1):
            pq = self.planned if factors is None and shrink is None \
                else Planner(self.session, join_factor_override=factors,
                             agg_shrink_override=shrink) \
                .plan(self.optimized)
            if grew:
                # only GROWTH in THIS execution is guarded — factors cached
                # from a previous successful run already proved they fit
                check_planned_join_capacities(pq, self.session)
            result, ratio = self._run_planned(pq)
            if ratio <= 0.0:
                if factors is not None or shrink is not None:
                    self.session._adapted_factors[base_key] = {
                        "join": factors, "shrink": shrink}
                    if plan_cache is not None:
                        plan_cache.adopt(
                            self, pq, (time.perf_counter() - t0) * 1e3)
                return result
            if attempt == self.MAX_ADAPT:
                raise RuntimeError(
                    f"join/agg output still overflows after {attempt} "
                    f"adaptive retries (factors {factors}, agg capacity "
                    f"{shrink}); raise {C.JOIN_OUTPUT_FACTOR.key} / "
                    f"{C.AGG_OUTPUT_ROWS.key} explicitly (join growth is "
                    f"bounded by {C.JOIN_OUTPUT_MAX_ROWS.key})")
            # grow ONLY the joins that overflowed (positional): a chained
            # plan must not compound one hot join's factor into every join
            base_f = self.session.conf.get(C.JOIN_OUTPUT_FACTOR)
            join_ratios = self._last_join_ratios
            cur = list(factors) if isinstance(factors, (list, tuple)) \
                else [None] * len(join_ratios)
            while len(cur) < len(join_ratios):
                cur.append(None)
            for i, r in enumerate(join_ratios):
                if r > 0:
                    prev = cur[i] if cur[i] is not None else base_f
                    cur[i] = grow_capacity_factor(prev, r)
            factors = cur
            # grow the keyed-agg output capacity past the measured group
            # count (ONE bound for all aggs in the plan)
            lost = self._last_shrink
            if any(l > 0 for l, _c in lost):
                # 2x floor: bucket tables can spread live groups across
                # [0, bucket_cap), so growth must make geometric progress
                need = max(max(c + l, 2 * c) for l, c in lost if l > 0)
                shrink = pad_capacity(int(need * 1.25))
                _log.warning("agg output capacity overflowed; growing to "
                             "%d rows", shrink)
            grew = True
            _log.warning(
                "join/agg output overflowed its static capacity by "
                "%.0f%%; replanning with per-join factors %s, agg "
                "capacity %s", ratio * 100,
                ["%.2f" % f if f else "-" for f in factors], shrink)

    def _run_planned(self, pq: PlannedQuery) -> Tuple[ColumnBatch, float]:
        """One execution attempt → (host result, worst overflow ratio).

        Before dispatch the query's device working set is reserved with
        the session's memory manager (UnifiedMemoryManager's
        acquireExecutionMemory): captured graphs held as storage are
        evicted to make room, and a query that cannot fit raises
        ``HBMOutOfMemoryError`` naming itself instead of dying inside the
        allocator.  The reservation counts the TRUE static output buffers
        of capacity-growing operators (join/cross/union buffers) on top
        of the leaf working set.  The physical plan is verified first
        (``analysis.maybe_verify_physical``)."""
        from ..analysis import maybe_verify_physical
        maybe_verify_physical(self.session, pq)
        mem = self.session._memory
        owner = f"query:{id(self)}"
        mem.acquire_execution(owner, _plan_reserve_bytes(pq))
        try:
            return self._run_planned_inner(pq)
        finally:
            mem.release_execution(owner)

    def _run_planned_inner(self, pq: PlannedQuery
                           ) -> Tuple[ColumnBatch, float]:
        session = self.session
        if not session.conf.get(C.CODEGEN_ENABLED):
            return self._run_eager(pq)
        from .udf import plan_has_slow_udf
        if plan_has_slow_udf(self.optimized):
            # the row lane copies its arguments to the host in the middle
            # of the plan: no capture can hold that, so the whole query
            # runs on the eager lane (the reference's stage break)
            _log.info("row-lane Python UDF in the plan: running it on the "
                      "eager lane")
            return self._run_eager(pq)

        from . import stagecompile as SC
        device = session.device
        if not session.conf.get(C.STAGE_FUSION):
            # baseline mode: one eager step per physical operator, flags
            # read back per op so adaptive retry still works, metrics
            # dropped (debug lane)
            c, n_rows, _nd, int_flags, caps, kinds = SC.run_per_op(
                pq.physical, pq.leaves, device)
            self.metrics = {}
            return self._result(c, n_rows), \
                self._note_flags(int_flags, caps, kinds)

        # the whole plan IS one stage: its captured programs live in the
        # PROCESS-LOCAL stage cache, keyed on the structural fingerprint
        # plus the leaf shape/dtype signature and the planning conf, with
        # int/float/bool literals in arithmetic/comparison positions
        # slotted out as the entry's device scalars
        # lazy run columns enter the stage as run planes or dense: the
        # plane markers of leaf_signature re-key the stage (a run count
        # past its bucket captures anew, never replays a stale graph)
        leaves = SC.plan_leaves(session, pq.leaves)
        skey, slots = stage_key(session, pq, leaves)
        return self._dispatch_stage(pq, skey,
                                    stage_maker(pq, slots, device, skey),
                                    SC.count_ops(pq.physical),
                                    SC.param_values(slots), leaves)

    def _dispatch_stage(self, pq: PlannedQuery, skey: str, make, n_ops: int,
                        params, leaves=None) -> Tuple[ColumnBatch, float]:
        """One run of ``pq`` through its stage-cache entry (built by
        ``make`` on a miss) with the slotted literal values ``params``.
        The statement's cancellation is checked before the graph is
        replayed; a replay itself runs to its end once launched."""
        from . import stagecompile as SC
        session = self.session
        device = session.device
        cache = SC.stage_cache(session)
        entry = cache.get_or_build(skey, make, n_ops=n_ops, session=session)
        # a pinned host leaf (a file batch) goes to the card by the
        # entry's own copies into its static buffers; a run vector that
        # did not become a plane enters dense (the key signs it so)
        leaves = [b if device.type == "cuda" and b.device.type == "cpu"
                  and b.is_pinned() else dense_runs(b, device)
                  for b in (pq.leaves if leaves is None else leaves)]

        def finish(out, host, meta):
            caps, kinds, metric_keys = meta
            n_rows, int_flags = host[0], host[1:1 + len(caps)]
            self.metrics = dict(zip(metric_keys, host[1 + len(caps):]))
            return self._result(out, n_rows), \
                self._note_flags(int_flags, caps, kinds)

        session.raise_if_cancelled()      # checkpoint: before the replay
        return cache.dispatch(entry, leaves, params, finish, device,
                              memory=session._memory)

    def _run_eager(self, pq: PlannedQuery) -> Tuple[ColumnBatch, float]:
        """The eager lane: every operator's kernels launched from the
        host, the flags read back once at the end."""
        from .stagecompile import _read_back
        device = self.session.device
        ctx = P.ExecContext(device, [b.to_device(device) for b in pq.leaves])
        # checkpoint: after each operator, before the next one runs
        ctx.checkpoint = self.session.raise_if_cancelled
        out = compact(pq.physical.run(ctx))
        # ONE device → host transfer for the row count, every overflow
        # flag and every metric
        host = _read_back([out.num_rows()] + list(ctx.flags)
                          + [v for _o, _l, v in ctx.metrics])
        n_rows, rest = host[0], host[1:]
        int_flags = rest[:len(ctx.flags)]
        metric_vals = rest[len(ctx.flags):]
        self.metrics = {(oid, lbl): v for (oid, lbl, _v), v
                        in zip(ctx.metrics, metric_vals)}
        return self._result(out, n_rows), \
            self._note_flags(int_flags, ctx.flag_caps, ctx.flag_kinds)

    def _result(self, out: ColumnBatch, n: int) -> ColumnBatch:
        """The live prefix of a compacted result: on the host in one
        packed copy, or with ``keep_on_device`` cloned on the device (a
        stage entry's static outputs belong to its next replay)."""
        if not self.keep_on_device or out.device.type == "cpu":
            return _slice_to_host(out, n)
        rows = min(pad_capacity(max(n, 1)), out.capacity)

        def head(t):
            return None if t is None else t[:rows].clone()
        return ColumnBatch(out.names, [ColumnVector(head(v.data), v.dtype,
                                                    head(v.valid),
                                                    v.dictionary)
                                       for v in out.vectors],
                           head(out.row_valid), rows)

    def _note_flags(self, int_flags: List[int], caps: List[int],
                    kinds: List[str]) -> float:
        """Keep the per-join and per-shrink overflows for the adaptive
        retry; returns the worst overflow ratio."""
        self._last_join_ratios = [
            f / max(c, 1) for f, c, k in zip(int_flags, caps, kinds)
            if k == "join"]
        self._last_shrink = [
            (f, c) for f, c, k in zip(int_flags, caps, kinds)
            if k == "shrink"]
        return _overflow_ratio(int_flags, caps)

    def explain_string(self) -> str:
        s = "== Analyzed Logical Plan ==\n" + self.analyzed.tree_string()
        s += "== Optimized Logical Plan ==\n" + self.optimized.tree_string()
        s += "== Physical Plan ==\n" + \
            self.planned_preview().physical.tree_string()
        return s
