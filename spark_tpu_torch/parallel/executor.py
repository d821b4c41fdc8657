"""Distributed planner + SPMD executor.

The port of ``spark_tpu/parallel/executor.py``: the planner emits an
exchange-aware physical plan, and the executor runs it once per shard as
one SPMD program (``spmd.run_shards``, the ``shard_map`` counterpart)
whose collectives are the stage boundaries.  The result is every shard's
compacted output joined in shard order, then compacted — the order that
makes a range-partitioned ORDER BY come out globally sorted.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import torch

from .. import config as C
from ..columnar import ColumnBatch, ColumnVector, pad_capacity
from ..expressions import Col
from ..kernels import compact
from ..sql import physical as P
from ..sql.joins import PJoin, _JoinOutput, plan_join_raw
from ..sql.logical import (Aggregate, Distinct, Filter, Join, Limit,
                           LocalRelation, LogicalPlan, Project,
                           RangeRelation, Sample, Sort, SubqueryAlias)
from ..sql.planner import (ADAPT_MAX_RETRIES, Planner, _slice_to_host,
                           check_planned_join_capacities,
                           grow_capacity_factor)
from . import dist as D
from .mesh import Mesh, mesh_shards
from .spmd import ShardContext, run_shards

_log = logging.getLogger("spark_tpu_torch.execution")


class DistributedPlanner(Planner):
    """Planner emitting exchange-aware physical plans (EnsureRequirements)."""

    def __init__(self, session, n_shards: int,
                 skew_override: Optional[float] = None,
                 join_factor_override: Optional[float] = None,
                 agg_shrink_override: Optional[int] = None):
        super().__init__(session, join_factor_override,
                         agg_shrink_override=agg_shrink_override)
        self.n_shards = n_shards
        self.skew_override = skew_override

    @property
    def skew(self) -> float:
        if self.skew_override is not None:
            return self.skew_override
        return self.session.conf.get(C.EXCHANGE_SKEW_FACTOR)

    @property
    def fine(self) -> int:
        """Fine buckets for adaptive exchanges (0 = static hash % n)."""
        if not self.session.conf.get(C.ADAPTIVE_ENABLED):
            return 0
        return self.n_shards * self.session.conf.get(C.EXCHANGE_FINE_BUCKETS)

    def _to_physical(self, node: LogicalPlan, leaves) -> P.PhysicalPlan:
        n = self.n_shards
        if isinstance(node, RangeRelation):
            return D.DRange(node.start, node.end, node.step, node.name,
                            node.num_rows(), n)
        if isinstance(node, Aggregate):
            child = self._to_physical(node.child, leaves)
            if any(getattr(f, "is_collect", False)
                   or getattr(f, "is_percentile", False)
                   for f, _n in node.aggs):
                # no fixed-width mergeable partial form: gather rows to one
                # shard and aggregate there; a keyless aggregate emits an
                # always-valid row on EVERY shard, so mask it to shard 0
                agg = P.PAggregate(node.keys, node.aggs, D.DGatherOne(child))
                return agg if node.keys else D.DKeepShardZero(agg)
            if not node.keys:
                return D.DGlobalAggregate(node.aggs, child)
            partial_agg = D.DPartialAggregate(node.keys, node.aggs, child)
            key_refs = [Col(k.name) for k in node.keys]
            exchanged = D.DExchangeHash(key_refs, n, self.skew, partial_agg,
                                        fine_buckets=self.fine)
            # per-shard group tables are prefix-live, so the shrink
            # applies per shard; its overflow flag is pmax'd by the executor
            return self._shrunk(D.DFinalAggregate(
                node.keys, node.aggs, partial_agg, exchanged))
        if isinstance(node, Distinct):
            child = self._to_physical(node.child, leaves)
            keys = [Col(nm) for nm in node.child.schema().names]
            partial_agg = D.DPartialAggregate(keys, [], child)
            exchanged = D.DExchangeHash(keys, n, self.skew, partial_agg,
                                        fine_buckets=self.fine)
            return self._shrunk(D.DFinalAggregate(
                keys, [], partial_agg, exchanged))
        if isinstance(node, Sort):
            child = self._to_physical(node.child, leaves)
            orders = [(o.child, o.ascending, o.nulls_first)
                      for o in node.orders]
            ex = D.DExchangeRange(orders, n, self.skew, child)
            return D.DShardSort(orders, ex)
        if isinstance(node, Limit):
            return D.DLimit(node.n, self._to_physical(node.child, leaves))
        if isinstance(node, Join):
            return self._plan_dist_join(node, leaves)
        # windows raise here as on the single-device lane (the window slice
        # brings them, with their exchange)
        return super()._to_physical(node, leaves)

    def _plan_dist_join(self, node: Join, leaves) -> P.PhysicalPlan:
        n = self.n_shards
        threshold = self.session.conf.get(C.AUTO_BROADCAST_JOIN_THRESHOLD)
        # estimate the build size by the logical row estimate (capacity)
        right_rows = _estimate_rows(node.right)
        raw = plan_join_raw(self, node if node.how != "right" else
                            Join(node.right, node.left, "left", node.on,
                                 node.using),
                            leaves)
        inner = raw
        if isinstance(raw, PJoin):
            build_small = right_rows is not None and right_rows <= threshold \
                and node.how in ("inner", "left", "left_semi", "left_anti",
                                 "cross")
            if build_small or raw.how == "cross":
                # broadcast hash join: build side replicated to all shards
                inner = PJoin(raw.children[0], D.DBroadcast(raw.children[1]),
                              raw.how, raw.key_pairs, raw.residual,
                              raw._schema, raw.factor)
            elif self.fine > 0:
                # adaptive shuffled hash join: one balanced assignment for
                # both sides; hot probe buckets spread + build replicate
                # (only where build-side unmatched rows are never emitted)
                allow_spread = raw.how in ("inner", "left", "left_semi",
                                           "left_anti")
                inner = D.DSkewJoin(
                    raw.children[0], raw.children[1], raw.how,
                    raw.key_pairs, raw.residual, raw._schema, raw.factor,
                    n, self.skew, self.fine,
                    self.session.conf.get(C.EXCHANGE_SPREAD_FRAC),
                    allow_spread)
            else:
                # shuffled hash join: co-partition both sides on key hash
                # (pairs normalized so a mixed int/float pair routes both
                # sides identically)
                lkeys, rkeys = D._routing_key_pairs(
                    raw.key_pairs, raw.children[0].schema(),
                    raw.children[1].schema())
                ex_l = D.DExchangeHash(lkeys, n, self.skew, raw.children[0])
                ex_r = D.DExchangeHash(rkeys, n, self.skew, raw.children[1])
                inner = PJoin(ex_l, ex_r, raw.how, raw.key_pairs,
                              raw.residual, raw._schema, raw.factor)
        if node.how in ("left_semi", "left_anti"):
            return inner
        ls, rs = node.left.schema(), node.right.schema()
        if node.how == "right":
            return _JoinOutput(node.schema(), ls.names, rs.names,
                               left_base=len(rs.names), right_base=0,
                               using=node.using or [], how="right",
                               child=inner)
        return _JoinOutput(node.schema(), ls.names, rs.names,
                           left_base=0, right_base=len(ls.names),
                           using=node.using or [], how=node.how, child=inner)


def _estimate_rows(node: LogicalPlan) -> Optional[int]:
    if isinstance(node, LocalRelation):
        return node.batch.capacity
    if isinstance(node, RangeRelation):
        return node.num_rows()
    if isinstance(node, (Project, SubqueryAlias, Filter, Sample)):
        return _estimate_rows(node.children[0])
    if isinstance(node, Limit):
        child = _estimate_rows(node.children[0])
        return min(node.n, child) if child is not None else node.n
    return None


# ---------------------------------------------------------------------------

class DistributedExecution:
    """Runs a planned query as one SPMD program over the mesh."""

    def __init__(self, session, mesh: Mesh):
        self.session = session
        self.mesh = mesh
        self.n = mesh_shards(mesh)

    MAX_ADAPT = ADAPT_MAX_RETRIES

    def execute(self, optimized: LogicalPlan) -> ColumnBatch:
        """Run with adaptive capacity retry: when an exchange bucket or a
        join output overflows its static capacity, replan with factors
        sized from the MEASURED worst-shard overflow and rerun."""
        # same adapted-parameter dict shape as the local executor
        base_key = f"dist{self.n}:adapt:" + optimized.tree_string()
        adapted = self.session._adapted_factors.get(base_key) or {}
        skew, jf = adapted.get("skew"), adapted.get("join")
        shrink = adapted.get("shrink")
        grew = False
        for attempt in range(self.MAX_ADAPT + 1):
            result, ex_ratio, join_ratio, shrink_need = self._run_once(
                optimized, skew, jf, shrink, check_caps=grew)
            if ex_ratio <= 0.0 and join_ratio <= 0.0 and shrink_need <= 0:
                if skew is not None or jf is not None or shrink is not None:
                    self.session._adapted_factors[base_key] = {
                        "skew": skew, "join": jf, "shrink": shrink}
                return result
            base_skew = skew if skew is not None \
                else self.session.conf.get(C.EXCHANGE_SKEW_FACTOR)
            base_jf = jf if jf is not None \
                else self.session.conf.get(C.JOIN_OUTPUT_FACTOR)
            if attempt == self.MAX_ADAPT:
                raise RuntimeError(
                    f"exchange/join/agg still overflows after {attempt} "
                    f"adaptive retries (skew={base_skew}, join "
                    f"factor={base_jf}, agg capacity={shrink}); raise "
                    f"{C.EXCHANGE_SKEW_FACTOR.key} / "
                    f"{C.JOIN_OUTPUT_FACTOR.key} / "
                    f"{C.AGG_OUTPUT_ROWS.key} explicitly")
            if ex_ratio > 0.0:
                skew = grow_capacity_factor(base_skew, ex_ratio)
            if join_ratio > 0.0:
                jf = grow_capacity_factor(base_jf, join_ratio)
                grew = True
            if shrink_need > 0:
                base_s = shrink if shrink is not None \
                    else self.session.conf.get(C.AGG_OUTPUT_ROWS)
                shrink = pad_capacity(
                    max(int(shrink_need * 1.25), 2 * int(base_s)))
            _log.warning(
                "capacity overflow (exchange %.0f%%, join %.0f%%, agg "
                "need %d); replanning with skew=%s join_factor=%s "
                "agg_capacity=%s", ex_ratio * 100, join_ratio * 100,
                shrink_need, skew, jf, shrink)

    def _run_once(self, optimized: LogicalPlan, skew: Optional[float],
                  jf: Optional[float], shrink: Optional[int] = None,
                  check_caps: bool = False
                  ) -> Tuple[Optional[ColumnBatch], float, float, int]:
        planner = DistributedPlanner(self.session, self.n,
                                     skew_override=skew,
                                     join_factor_override=jf,
                                     agg_shrink_override=shrink)
        pq = planner.plan(optimized)
        if check_caps:
            # exact per-join allocation guard after growth in THIS
            # execution; cached factors already proved they fit
            check_planned_join_capacities(pq, self.session,
                                          "distributed join")
        physical = pq.physical
        device = self.mesh.device
        leaves = [shard_leaf(self.mesh, b) for b in pq.leaves]

        def shard_fn(shard, comm):
            ctx = ShardContext(device, [leaf[shard] for leaf in leaves],
                               shard, comm)
            out = compact(physical.run(ctx))
            n_rows = comm.psum(shard, out.num_rows())
            # per-kind worst overflow RATIO (lost rows / capacity), pmax'd
            # over shards — sizes the adaptive retry; the agg shrink needs
            # an absolute capacity (lost + bound), 0 when nothing overflowed
            ex_r = torch.zeros((), dtype=torch.float32, device=device)
            join_r = torch.zeros((), dtype=torch.float32, device=device)
            shr_need = torch.zeros((), dtype=torch.int64, device=device)
            for f, kind, cap in zip(ctx.flags, ctx.flag_kinds,
                                    ctx.flag_caps):
                if kind == "shrink":
                    lost = f.to(torch.int64)
                    shr_need = torch.maximum(
                        shr_need, torch.where(lost > 0, lost + cap, 0))
                    continue
                r = f.to(torch.float32) / float(max(cap, 1))
                if kind == "exchange":
                    ex_r = torch.maximum(ex_r, r)
                else:
                    join_r = torch.maximum(join_r, r)
            return (out, n_rows, comm.pmax(shard, ex_r),
                    comm.pmax(shard, join_r), comm.pmax(shard, shr_need))

        results = run_shards(self.n, device, shard_fn)
        # ONE device → host transfer for the row count and the ratios
        n_rows, ex_ratio, join_ratio, shrink_need = torch.stack(
            [x.reshape(()).to(torch.float64) for x in results[0][1:]]
        ).cpu().tolist()
        if ex_ratio > 0.0 or join_ratio > 0.0 or shrink_need > 0:
            return None, ex_ratio, join_ratio, int(shrink_need)
        joined = compact(_join_shards([r[0] for r in results]))
        return _slice_to_host(joined, int(n_rows)), 0.0, 0.0, 0


def _join_shards(outs: List[ColumnBatch]) -> ColumnBatch:
    """The shards' outputs one after another, in shard order."""
    first = outs[0]
    vectors = []
    for j, v in enumerate(first.vectors):
        parts = [o.vectors[j] for o in outs]
        data = torch.cat([p.data.expand(o.capacity)
                          for p, o in zip(parts, outs)])
        valid = None
        if any(p.valid is not None for p in parts):
            valid = torch.cat([p.valid_or_true().expand(o.capacity)
                               for p, o in zip(parts, outs)])
        vectors.append(ColumnVector(data, v.dtype, valid, v.dictionary))
    rv = torch.cat([o.row_valid_or_true() for o in outs])
    return ColumnBatch(first.names, vectors, rv, sum(o.capacity for o in outs))


def shard_leaf(mesh: Mesh, batch: ColumnBatch) -> List[ColumnBatch]:
    """Pad a batch so rows split evenly over the shards, then cut it into
    one contiguous slice per shard, on the mesh's device."""
    n = mesh.n_shards
    per = pad_capacity(max(-(-batch.capacity // n), 1))
    total = per * n

    def padded(x: torch.Tensor, fill) -> torch.Tensor:
        x = x.to(mesh.device)
        if x.shape[0] < total:
            pad = torch.full((total - x.shape[0],) + tuple(x.shape[1:]),
                             fill, dtype=x.dtype, device=mesh.device)
            x = torch.cat([x, pad])
        return x

    cols = [(padded(v.data, 0),
             None if v.valid is None else padded(v.valid, False), v)
            for v in batch.vectors]
    rv = padded(batch.row_valid_or_true(), False)
    out = []
    for s in range(n):
        sl = slice(s * per, (s + 1) * per)
        vectors = [ColumnVector(d[sl], v.dtype,
                                None if m is None else m[sl], v.dictionary)
                   for d, m, v in cols]
        out.append(ColumnBatch(batch.names, vectors, rv[sl], per))
    return out
