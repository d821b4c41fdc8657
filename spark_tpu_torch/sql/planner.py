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
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import config as C
from .. import types as T
from ..columnar import ColumnBatch, ColumnVector, pad_capacity
from ..expressions import AnalysisException
from ..kernels import compact
from .logical import (
    Aggregate, Distinct, Filter, Join, Limit, LocalRelation, LogicalPlan,
    Project, RangeRelation, Sort, SubqueryAlias, Union,
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
        "much for eager in-memory execution.  Reduce the hot-key fanout "
        "or raise the cap explicitly")


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
    the padding over PCIe."""
    cap = min(pad_capacity(max(n, 1)), result.capacity)
    if cap == result.capacity:
        return result.to_host()
    vectors = [ColumnVector(v.data[:cap].cpu(), v.dtype,
                            None if v.valid is None else v.valid[:cap].cpu(),
                            v.dictionary)
               for v in result.vectors]
    rv = None if result.row_valid is None else result.row_valid[:cap].cpu()
    return ColumnBatch(result.names, vectors, rv, cap)


def _row_nbytes(schema: T.StructType) -> int:
    """Device bytes per row of one materialized batch of this schema
    (data + validity + row mask)."""
    return 2 + sum(np.dtype(f.dataType.np_dtype).itemsize + 1
                   for f in schema.fields)


def _walk_plan_caps(pq: "PlannedQuery"):
    """(root_cap, extra_bytes, join_caps) over the physical plan's STATIC
    output capacities — exact arithmetic, not a heuristic: join output
    capacity is ``pad_capacity(probe × factor)`` by construction
    (joins.py).  ``join_caps`` lists ``(PJoin, probe_rows, out_rows)``
    for every join with an adaptive (factor-sized) output buffer."""
    from .joins import PJoin

    extra = 0
    join_caps: List[tuple] = []

    def cap(node: P.PhysicalPlan) -> int:
        nonlocal extra
        if isinstance(node, P.PScan):
            return pq.leaves[node.index].capacity
        if isinstance(node, P.PRange):
            return node.capacity
        ch = [cap(c) for c in node.children]
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
            extra += out * _row_nbytes(node.schema())
            return out
        if isinstance(node, P.PUnion):
            out = sum(ch) if ch else 1
            extra += out * _row_nbytes(node.schema())
            return out
        return max(ch) if ch else 1

    root_cap = cap(pq.physical)
    extra += root_cap * _row_nbytes(pq.physical.schema())
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
    working set (input + one fused intermediate) plus the STATIC output
    buffers of every capacity-growing operator (``_walk_plan_caps``)."""
    from ..memory import batch_nbytes
    _root, extra, _joins = _walk_plan_caps(pq)
    return 2 * sum(batch_nbytes(b) for b in pq.leaves) + extra


def _needs_local_fallback(plan: LogicalPlan) -> bool:
    """Plans the mesh lane cannot shard: ArrayType columns at a leaf or
    feeding an exchange-inducing operator (exchanges are 1-D)."""
    from .. import types as T
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
                                          Sort))
        for c in node.children:
            if exchange_like and has_arrays(c):
                found.append("array-into-exchange")
            walk(c)

    walk(plan)
    return bool(found)


class PlannedQuery:
    def __init__(self, physical: P.PhysicalPlan, leaves: List[ColumnBatch]):
        self.physical = physical
        self.leaves = leaves


class Planner:
    """Logical → physical (``SparkPlanner.strategies`` analog)."""

    def __init__(self, session, join_factor_override=None,
                 agg_shrink_override=None):
        #: None | float (every join) | list (per join construction index —
        #: chained joins must not COMPOUND one overflowing join's growth)
        self.session = session
        self.join_factor_override = join_factor_override
        #: None | int rows: adaptively grown keyed-agg output capacity
        self.agg_shrink_override = agg_shrink_override
        self._join_seq = 0

    def _shrunk(self, agg: P.PhysicalPlan) -> P.PhysicalPlan:
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
        leaves: List[ColumnBatch] = []
        phys = self._to_physical(logical, leaves)
        self._assign_op_ids(phys, [1])
        if self.session.conf.get(C.METRICS_ENABLED):
            phys = self._wrap_metrics(phys)
        return PlannedQuery(phys, leaves)

    def _wrap_metrics(self, node: P.PhysicalPlan) -> P.PhysicalPlan:
        node.children = tuple(self._wrap_metrics(c) for c in node.children)
        return P.PMetric(node)

    def _assign_op_ids(self, node: P.PhysicalPlan, counter: List[int]) -> None:
        node.op_id = counter[0]
        counter[0] += 1
        for c in node.children:
            self._assign_op_ids(c, counter)

    def _scan(self, batch: ColumnBatch, leaves: List[ColumnBatch]) -> P.PScan:
        leaves.append(batch)
        return P.PScan(len(leaves) - 1, batch.schema)

    def _to_physical(self, node: LogicalPlan, leaves) -> P.PhysicalPlan:
        if isinstance(node, LocalRelation):
            return self._scan(node.batch, leaves)
        if isinstance(node, RangeRelation):
            return P.PRange(node.start, node.end, node.step, node.name,
                            node.num_rows())
        if isinstance(node, SubqueryAlias):
            return self._to_physical(node.child, leaves)
        if isinstance(node, Project):
            return P.PProject(node.exprs, self._to_physical(node.child, leaves))
        if isinstance(node, Filter):
            return P.PFilter(node.condition, self._to_physical(node.child, leaves))
        if isinstance(node, Aggregate):
            agg = P.PAggregate(node.keys, node.aggs,
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
        # file scans, windows, samples, explode, stateful groups: later
        # slices (the analyzer refuses them first)
        raise AnalysisException(f"no physical plan for {node!r}")


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

    @property
    def analyzed(self) -> LogicalPlan:
        if self._analyzed is None:
            from .analyzer import Analyzer
            self._analyzed = Analyzer(self.session.catalog).analyze(self.logical)
        return self._analyzed

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

    # ------------------------------------------------------------------
    MAX_ADAPT = ADAPT_MAX_RETRIES

    def execute(self) -> ColumnBatch:
        """Run the query; returns a COMPACTED host batch.

        Capacity overflow (a join producing more rows than its static
        output buffer, or more groups than the agg output capacity)
        triggers an automatic replan with a factor sized from the MEASURED
        overflow, instead of erroring."""
        self.session._last_qe = self      # metrics/explain introspection
        return self._execute_inner()

    def _execute_inner(self) -> ColumnBatch:
        # Left out here, each with the slice that brings it:
        # * the plan-analysis verifiers (maybe_verify_*) and the serving
        #   plan cache: the serving slice;
        # * run planes at the stage boundary (plan_leaves): with the
        #   run-length vectors;
        # * the cross-process exchange (crossproc_execute): the
        #   cross-process slice;
        # * the multi-batch and stage-DAG out-of-core runners, alone and
        #   under the mesh: the out-of-core slice;
        # * the mesh lane under graphs: the mesh lane below stays eager.
        n_shards = self.session.conf.get(C.MESH_SHARDS)
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
            mesh = get_mesh(n_shards, self.session.device)
            return DistributedExecution(self.session, mesh).execute(
                self.optimized)

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
        of the leaf working set."""
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
        leaves = [b.to_device(device) for b in pq.leaves]
        if not session.conf.get(C.STAGE_FUSION):
            # baseline mode: one eager step per physical operator, flags
            # read back per op so adaptive retry still works, metrics
            # dropped (debug lane)
            c, n_rows, _nd, int_flags, caps, kinds = SC.run_per_op(
                pq.physical, leaves, device)
            self.metrics = {}
            return _slice_to_host(c, n_rows), \
                self._note_flags(int_flags, caps, kinds)

        # the whole plan IS one stage: its captured programs live in the
        # PROCESS-LOCAL stage cache, keyed on the structural fingerprint
        # plus the leaf shape/dtype signature and the planning conf, with
        # int/float/bool literals in arithmetic/comparison positions
        # slotted out as the entry's device scalars
        cache = SC.stage_cache(session)
        skey, slots = SC.stage_fingerprint(pq.physical)
        skey = (f"local|{skey}|{SC.leaf_signature(leaves)}"
                f"|{SC._conf_component(session)}")

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

            return run, SC.Stage(physical, [b.schema for b in leaves],
                                 physical.schema(), skey)

        entry = cache.get_or_build(skey, make,
                                   n_ops=SC.count_ops(pq.physical),
                                   session=session)

        def finish(out, host, meta):
            caps, kinds, metric_keys = meta
            n_rows, int_flags = host[0], host[1:1 + len(caps)]
            self.metrics = dict(zip(metric_keys, host[1 + len(caps):]))
            return _slice_to_host(out, n_rows), \
                self._note_flags(int_flags, caps, kinds)

        return cache.dispatch(entry, leaves, SC.param_values(slots), finish,
                              device, memory=session._memory)

    def _run_eager(self, pq: PlannedQuery) -> Tuple[ColumnBatch, float]:
        """The eager lane: every operator's kernels launched from the
        host, the flags read back once at the end."""
        from .stagecompile import _read_back
        device = self.session.device
        ctx = P.ExecContext(device, [b.to_device(device) for b in pq.leaves])
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
        return _slice_to_host(out, n_rows), \
            self._note_flags(int_flags, ctx.flag_caps, ctx.flag_kinds)

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
        s += "== Physical Plan ==\n" + self.planned.physical.tree_string()
        return s
