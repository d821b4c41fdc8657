"""Distributed planner + SPMD executor.

The port of ``spark_tpu/parallel/executor.py``: the planner emits an
exchange-aware physical plan, and the executor runs it once per shard as
one SPMD program (``spmd.run_shards``, the ``shard_map`` counterpart)
whose collectives are the stage boundaries.  The result is every shard's
compacted output joined in shard order, then compacted — the order that
makes a range-partitioned ORDER BY come out globally sorted.

With ``spark.sql.codegen.wholeStage`` on (the default) that program is
ONE entry of the process-local stage cache (``sql/stagecompile.py``),
keyed ``dist{n}|{stage fingerprint}|{leaf signature}|{conf}`` — the
counterpart of the reference's ``jax.jit(shard_map(...))`` cached under
``dist{n}:``: on a card one captured CUDA graph holds every shard's
operators, every K2 all-to-all and all-gather, the ``lpt_assign``
launches, the psum/pmax reductions and the flags, and a warm query is
one replay.  Off, the same program runs eagerly.  The entry's leaves are
the query's whole leaf batches (its static buffers); the shards' slices
are cut inside the program (``shard_leaf``).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import torch

import numpy as np

from .. import config as C
from .. import cuda_a2a
from .. import expressions as E
from ..aggregates import First
from ..columnar import ColumnBatch, ColumnVector, pad_capacity
from ..expressions import Col
from ..kernels import compact
from ..sql import physical as P
from ..sql.joins import PJoin, _JoinOutput, plan_join_raw
from ..sql.logical import (Aggregate, Distinct, FileRelation, Filter, Join,
                           Limit, LocalRelation, LogicalPlan, Project,
                           RangeRelation, Sample, Sort, SubqueryAlias)
from ..sql.window import WindowNode
from ..sql.planner import (ADAPT_MAX_RETRIES, Planner, _plan_reserve_bytes,
                           _slice_to_host, check_planned_join_capacities,
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
                   or (not node.keys and isinstance(f, First))
                   for f, _n in node.aggs):
                # no fixed-width mergeable partial form (first/last without
                # keys: the global aggregate reduces buffers, it gathers no
                # row): gather rows to one shard and aggregate there; a
                # keyless aggregate emits an always-valid row on EVERY
                # shard, so mask it to shard 0.  A keyed one keeps the
                # gathered capacity (n times a shard's): shrink it as the
                # local lane does, or every array plane above it is that
                # long
                agg = P.PAggregate(node.keys, self.bind_collect(node.aggs),
                                   D.DGatherOne(child))
                return self._shrunk(agg) if node.keys \
                    else D.DKeepShardZero(agg)
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
        if isinstance(node, WindowNode):
            return self._plan_dist_window(node, leaves)
        return super()._to_physical(node, leaves)

    def _plan_dist_window(self, node: WindowNode, leaves) -> P.PhysicalPlan:
        """A window needs every row of a partition on one shard
        (``WindowExec.requiredChildDistribution``: clustered on partitionBy,
        one partition when it is empty): a hash exchange by the partition
        keys (one K2 launch), or a gather to one shard, then the
        single-device window operator on each shard.  The analyzer makes
        one WindowNode per window spec, so one exchange serves all its
        window expressions."""
        child = self._to_physical(node.child, leaves)
        pb = node.wexprs[0][0].spec.partition_by
        if pb:
            exchanged = D.DExchangeHash(list(pb), self.n_shards, self.skew,
                                        child, fine_buckets=self.fine)
        else:
            exchanged = D.DGatherOne(child)
        return P.PWindow(node.wexprs, exchanged)

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
                build = D.DBroadcast(raw.children[1])
                if node.how != "right" and _single_row(node.right):
                    # a keyless aggregate (a scalar subquery) holds its one
                    # row first of all shards' capacity: keep only that
                    # slot, or every cross join multiplies its probe's
                    # capacity by the shards' summed capacity
                    build = P.PAggShrink(1, build)
                inner = PJoin(raw.children[0], build,
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


def _single_row(node: LogicalPlan) -> bool:
    """At most one row by construction: a keyless aggregate under row-wise
    nodes."""
    while isinstance(node, (Project, SubqueryAlias, Filter)):
        node = node.children[0]
    return isinstance(node, Aggregate) and not node.keys


def _estimate_rows(node: LogicalPlan) -> Optional[int]:
    if isinstance(node, LocalRelation):
        return node.batch.capacity
    if isinstance(node, RangeRelation):
        return node.num_rows()
    if isinstance(node, FileRelation):
        # datasource statistics (SparkStrategies.scala:116): a small
        # parquet dimension takes the broadcast path, not a shuffle —
        # parquet answers from its footers without loading data
        from ..io import file_row_count
        return file_row_count(node)
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

    def live_view(self):
        """The process set this executor would serve after a failure:
        ``cluster.live_view`` over the session's heartbeat verdicts and
        the host shuffle's agreed-lost set (``recovered_pids``).  Only
        observational: a mesh program cannot drop a shard mid-collective;
        the cross-process lanes (``crossproc``) re-plan over this set."""
        from .cluster import live_view as _lv
        svc = getattr(self.session, "_crossproc_svc", None)
        hb = getattr(svc, "heartbeat", None) if svc is not None else None
        dead = hb.dead_hosts() if hb is not None else ()
        gone = sorted(svc.recovered_pids) if svc is not None else ()
        return _lv(self.n, dead, gone)

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
        # the program's device working set — every shard's intermediates,
        # which a captured entry's pool holds for its lifetime — is
        # reserved before dispatch, as on the single-device lane
        owner = f"mesh:{id(self)}"
        held = []
        try:
            for mem, nbytes in self._reserves(pq):
                mem.acquire_execution(owner, nbytes)
                held.append(mem)
            return self._dispatch(optimized, pq)
        finally:
            for mem in held:
                mem.release_execution(owner)

    def _reserves(self, pq):
        """(memory manager, bytes) to reserve: the whole program on the
        session's card, or on several cards each card's shards against
        that card's manager."""
        mesh = self.mesh
        if mesh.n_cards == 1:
            return [(self.session._memory, _plan_reserve_bytes(pq, self.n))]
        return [(self.session.card_memory(dev),
                 _plan_reserve_bytes(pq, self.n, len(mesh.shards_on(c)),
                                     root=c == 0))
                for c, dev in enumerate(mesh.cards)]

    def _dispatch(self, optimized: LogicalPlan, pq
                  ) -> Tuple[Optional[ColumnBatch], float, float, int]:
        """One run of ``pq``'s SPMD program: through its stage-cache entry
        (``dist{n}|…``), or eagerly with ``wholeStage`` off or a row-lane
        UDF in the plan (its host copies are a stage break)."""
        from ..sql import stagecompile as SC
        from ..sql.udf import plan_has_slow_udf
        session = self.session
        mesh = self.mesh
        device = mesh.device
        multi = mesh.n_cards > 1
        # the shards cut leaves by rows, which a run plane cannot follow
        leaves = SC.entry_leaves(pq.leaves, device)
        # on several cards each card's rows go to it first
        run_leaves = place_leaves(mesh, leaves) if multi else leaves

        def finish(out, host, meta):
            if multi:
                cuda_a2a.check_barriers()
            caps, kinds = meta
            ex_ratio, join_ratio, shrink_need = _overflow(host[1:], caps,
                                                          kinds)
            if ex_ratio > 0.0 or join_ratio > 0.0 or shrink_need > 0:
                return None, ex_ratio, join_ratio, shrink_need
            return _slice_to_host(out, host[0]), 0.0, 0.0, 0

        if not session.conf.get(C.CODEGEN_ENABLED) \
                or plan_has_slow_udf(optimized):
            step = query_step(mesh, pq.physical, [], device)
            out, scalars, meta = step(
                run_leaves, [[]] * mesh.n_cards if multi else [])
            return finish(out, SC._read_back(scalars), meta)
        body, slots = SC.stage_fingerprint(pq.physical)
        # shards on several cards are another program (one graph per card)
        skey = (f"dist{self.n}|{body}|{SC.leaf_signature(leaves)}"
                f"|{SC._conf_component(session)}"
                + (f"|cards{mesh.n_cards}" if multi else ""))
        physical = pq.physical

        def make():
            return query_step(self.mesh, physical, slots, device), \
                SC.Stage(physical, [b.schema for b in pq.leaves],
                         physical.schema(), skey)

        cache = SC.stage_cache(session)
        entry = cache.get_or_build(skey, make, n_ops=SC.count_ops(physical),
                                   session=session)
        session.raise_if_cancelled()      # checkpoint: before the replay
        return cache.dispatch(entry, run_leaves, SC.param_values(slots),
                              finish, device, memory=session._memory,
                              card_memory=session.card_memory)


def query_step(mesh: Mesh, physical: P.PhysicalPlan, slots, device):
    """The SPMD program of one mesh query as a stage step:
    ``step(leaves, params) -> (compacted result, [row count, overflow
    flag, ...], (flag caps, flag kinds))``.  Each shard runs the plan on
    its slice of every leaf; the row count is psum'd and each flag pmax'd
    over the shards, so the scalars read back are the program's own.

    On several cards the leaves are ``place_leaves``'s (each card's rows
    on its card), ``params`` holds one list of parameter scalars per card,
    and the shards' outputs meet on shard 0's card through K2
    (``gather_batch``)."""
    n = mesh.n_shards
    multi = mesh.n_cards > 1

    def step(leaves, params):
        shards = placed_shards(mesh, leaves) if multi \
            else [shard_leaf(mesh, b) for b in leaves]

        def shard_fn(shard, comm):
            # the slotted literals' binding is thread-local: each shard
            # thread binds the entry's parameter scalars itself (those on
            # its card)
            mine = params[mesh.card_of[shard]] if multi else params
            E._slot_bindings.map = {id(l): p for l, p in zip(slots, mine)}
            try:
                ctx = ShardContext(mesh.devices[shard],
                                   [s[shard] for s in shards], shard, comm)
                out = compact(physical.run(ctx))
                n_rows = comm.psum(shard, out.num_rows())
                flags = []
                if ctx.flags:
                    flags = list(comm.pmax(shard, torch.stack(
                        [f.reshape(()).to(torch.int64) for f in ctx.flags]
                    )).unbind())
                joined = gather_batch(comm, shard, out) if multi else None
                return out, [n_rows] + flags, (list(ctx.flag_caps),
                                               list(ctx.flag_kinds)), joined
            finally:
                E._slot_bindings.map = None

        results = run_shards(n, device, shard_fn, mesh)
        joined = results[0][3] if multi \
            else _join_shards([r[0] for r in results])
        return compact(joined), results[0][1], results[0][2]

    if multi:
        step.cards = list(mesh.cards)
    return step


def _overflow(flags, caps, kinds) -> Tuple[float, float, int]:
    """(worst exchange overflow ratio, worst join overflow ratio, agg
    capacity needed or 0) of the program's pmax'd flags: a ratio is lost
    rows over capacity in float32; the agg shrink needs lost rows +
    capacity."""
    ex_r = join_r = 0.0
    shr_need = 0
    for f, kind, cap in zip(flags, kinds, caps):
        if kind == "shrink":
            if f > 0:
                shr_need = max(shr_need, f + cap)
            continue
        r = float(np.float32(f) / np.float32(max(cap, 1)))
        if kind == "exchange":
            ex_r = max(ex_r, r)
        else:
            join_r = max(join_r, r)
    return ex_r, join_r, shr_need


def _join_shards(outs: List[ColumnBatch]) -> ColumnBatch:
    """The shards' outputs one after another, in shard order."""
    first = outs[0]
    vectors = []
    for j, v in enumerate(first.vectors):
        parts = [o.vectors[j] for o in outs]
        # an array column is (capacity, max_len): rows join, width stays
        data = torch.cat([p.data.expand(o.capacity, *p.data.shape[1:])
                          for p, o in zip(parts, outs)])
        valid = None
        if any(p.valid is not None for p in parts):
            valid = torch.cat([p.valid_or_true().expand(o.capacity)
                               for p, o in zip(parts, outs)])
        vectors.append(ColumnVector(data, v.dtype, valid, v.dictionary))
    rv = torch.cat([o.row_valid_or_true() for o in outs])
    return ColumnBatch(first.names, vectors, rv, sum(o.capacity for o in outs))


def gather_batch(comm, shard: int, out: ColumnBatch
                 ) -> Optional[ColumnBatch]:
    """The shards' outputs one after another, in shard order, on shard 0's
    card (None on every other shard): ``_join_shards`` for shards on
    several cards, one K2 gather to shard 0.  Every vector's data, its
    validity and the row validity travel, each expanded to the shard's
    capacity (the shards run one plan, so every shard sends the same
    planes)."""
    planes = []
    for v in out.vectors:
        planes.append(v.data.expand(out.capacity, *v.data.shape[1:]))
        planes.append(v.valid_or_true().expand(out.capacity))
    planes.append(out.row_valid_or_true())
    got = comm.gather_root(shard, planes)
    if got is None:
        return None
    n = comm.n
    flat = [g.reshape((n * out.capacity,) + tuple(g.shape[2:])) for g in got]
    vectors = [ColumnVector(flat[2 * j], v.dtype, flat[2 * j + 1],
                            v.dictionary) for j, v in enumerate(out.vectors)]
    return ColumnBatch(out.names, vectors, flat[-1], n * out.capacity)


def _leaf_rows(mesh: Mesh, batch: ColumnBatch) -> int:
    """Rows of each shard's slice of a leaf: the leaf padded so rows split
    evenly over the shards."""
    return pad_capacity(max(-(-batch.capacity // mesh.n_shards), 1))


def _padded_rows(x: torch.Tensor, lo: int, hi: int, fill, device
                 ) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``x`` on ``device``, rows past its end
    ``fill``."""
    part = x[lo:min(hi, x.shape[0])].to(device)
    if part.shape[0] < hi - lo:
        pad = torch.full((hi - lo - part.shape[0],) + tuple(x.shape[1:]),
                         fill, dtype=x.dtype, device=device)
        part = torch.cat([part, pad])
    return part


def shard_leaf(mesh: Mesh, batch: ColumnBatch) -> List[ColumnBatch]:
    """Pad a batch so rows split evenly over the shards, then cut it into
    one contiguous slice per shard, on the mesh's device (every shard on
    one card)."""
    n = mesh.n_shards
    per = _leaf_rows(mesh, batch)
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


def place_leaves(mesh: Mesh, leaves: List[ColumnBatch]) -> List[ColumnBatch]:
    """Shards on several cards: each leaf cut, as ``shard_leaf`` cuts it,
    into one batch per card holding the slices of that card's shards, on
    that card — leaf i's part on card c at ``i * n_cards + c``.  A stage
    entry copies each part into its card's static buffers."""
    out = []
    for b in leaves:
        per = _leaf_rows(mesh, b)
        rv = b.row_valid_or_true()
        for c, dev in enumerate(mesh.cards):
            shards = mesh.shards_on(c)
            lo, hi = shards.start * per, shards.stop * per
            vectors = [ColumnVector(
                _padded_rows(v.data, lo, hi, 0, dev), v.dtype,
                None if v.valid is None
                else _padded_rows(v.valid, lo, hi, False, dev),
                v.dictionary) for v in b.vectors]
            out.append(ColumnBatch(b.names, vectors,
                                   _padded_rows(rv, lo, hi, False, dev),
                                   hi - lo))
    return out


def placed_shards(mesh: Mesh, placed: List[ColumnBatch]
                  ) -> List[List[ColumnBatch]]:
    """Per leaf, each shard's slice of ``place_leaves``'s parts (views on
    the shard's card)."""
    C = mesh.n_cards
    out = []
    for i in range(len(placed) // C):
        slices = []
        for s in range(mesh.n_shards):
            c = mesh.card_of[s]
            part = placed[i * C + c]
            per = part.capacity // len(mesh.shards_on(c))
            lo = (s - mesh.shards_on(c).start) * per
            sl = slice(lo, lo + per)
            slices.append(ColumnBatch(
                part.names,
                [ColumnVector(v.data[sl], v.dtype,
                              None if v.valid is None else v.valid[sl],
                              v.dictionary) for v in part.vectors],
                part.row_valid[sl], per))
        out.append(slices)
    return out
