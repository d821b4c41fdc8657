"""Distributed physical operators (run once per shard, inside
``spmd.run_shards``).

The port of ``spark_tpu/parallel/dist.py``, the EnsureRequirements analog
(``exchange/EnsureRequirements.scala:33``): each operator that needs
co-located data gets an exchange inserted under it, and exchanges are
collectives between the shards of one SPMD program:

* Aggregate  → partial (per-shard buffers) → hash exchange on keys → final
  merge (the ``AggUtils`` partial/final split);
* global Agg → partial → ``psum`` → finish;
* Join       → hash exchange BOTH sides (balanced, with hot-key
  spreading) → per-shard local join, or broadcast of a small build side;
* Sort       → sampled splitters → range exchange → per-shard sort; shard
  order == global order at collect;
* Limit      → per-shard count prefix via all-gather (global-exact).

``ctx`` is the shard's ``spmd.ShardContext``: ``ctx.shard`` stands for
``lax.axis_index`` and ``ctx.comm`` for the ``lax`` collectives, at the
same point in each node as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..aggregates import (AggregateFunction, Avg, Count, CountStar, First,
                          Max, Min, Sum, VarianceBase, identity)
from ..columnar import ColumnBatch, ColumnVector, pad_capacity
from ..expressions import AnalysisException, Cast, Col, EvalContext, \
    Expression, Hash64
from ..kernels import (_global_reduce, _scatter_starts, _segment_starts,
                       _sortable, multi_key_argsort, segment_reduce, sort_batch,
                       sort_key_transform)
from ..sql import physical as P
from ..sql.joins import PJoin
from .collective import (balanced_assignment, broadcast_all,
                         fine_bucket_histogram, hash_exchange, lex_bucket,
                         replicate_selected, round_robin_exchange,
                         sampled_splitters_multi, umod)

_I64_MIN = torch.iinfo(torch.int64).min
_I64_MAX = torch.iinfo(torch.int64).max


# ---------------------------------------------------------------------------
# partitioning properties (the Distribution/Partitioning contract)
# ---------------------------------------------------------------------------

class Partitioning:
    """Output partitioning property; used to elide redundant exchanges."""

    def satisfies_hash(self, key_names: Tuple[str, ...]) -> bool:
        return False


class UnknownPartitioning(Partitioning):
    pass


class HashPartitioning(Partitioning):
    def __init__(self, key_names: Tuple[str, ...]):
        self.key_names = key_names

    def satisfies_hash(self, key_names: Tuple[str, ...]) -> bool:
        return self.key_names == key_names


UNKNOWN = UnknownPartitioning()


def _key_names(keys: Sequence[Expression]) -> Optional[Tuple[str, ...]]:
    names = []
    for k in keys:
        if not isinstance(k, Col):
            return None
        names.append(k.name)
    return tuple(names)


# ---------------------------------------------------------------------------
# distributed nodes
# ---------------------------------------------------------------------------

class DNode(P.PhysicalPlan):
    n_shards: int = 1

    def partitioning(self) -> Partitioning:
        return UNKNOWN


class DRange(P.PRange):
    """Each shard generates its contiguous slice of the range."""

    def __init__(self, start, end, step, name, num_rows, n_shards):
        super().__init__(start, end, step, name, num_rows)
        self.n_shards = n_shards
        self.rows_per_shard = -(-num_rows // n_shards)
        self.capacity = pad_capacity(max(self.rows_per_shard, 1))

    def run(self, ctx):
        base = ctx.shard * self.rows_per_shard
        idx = torch.arange(self.capacity, dtype=torch.int64,
                           device=ctx.device)
        gidx = base + idx
        data = gidx * self.step + self.start
        rv = (idx < self.rows_per_shard) & (gidx < self.num_rows)
        return ColumnBatch([self.name], [ColumnVector(data, T.int64)], rv,
                           self.capacity)

    def partitioning(self):
        return UNKNOWN

    def __repr__(self):
        return f"DRange({self.start},{self.end},{self.step} x{self.n_shards})"


def exchange_cap(child_cap: int, n_shards: int, skew_factor: float) -> int:
    """Per-destination send-bucket capacity of an all-to-all exchange:
    the even split times the skew headroom factor — ONE definition for
    every exchange so capacity sizing can never diverge between them."""
    even = -(-child_cap // n_shards)
    return pad_capacity(max(int(even * skew_factor), 1))


def _routing_key_pairs(key_pairs, probe_schema, build_schema):
    """Normalize join-key pairs for ROUTING hashes: a mixed int/float pair
    hashes BOTH sides as float64 — ``Hash64(int64 7) != Hash64(float64
    7.0)``, so without this every cross-typed match would route to two
    different shards and vanish."""
    lks, rks = [], []
    for l, r in key_pairs:
        try:
            ldt = l.data_type(probe_schema)
            rdt = r.data_type(build_schema)
            if ldt.is_numeric and rdt.is_numeric \
                    and ldt.is_fractional != rdt.is_fractional:
                l, r = Cast(l, T.float64), Cast(r, T.float64)
        except AnalysisException:
            pass
        lks.append(l)
        rks.append(r)
    return lks, rks


def _hash(batch: ColumnBatch, keys: Sequence[Expression]) -> torch.Tensor:
    ectx = EvalContext(batch)
    return ectx.broadcast(Hash64(*keys).eval(ectx)).data


class DExchangeHash(DNode):
    """All-to-all repartition on key hash (ShuffleExchange).

    With ``fine_buckets > 0`` (adaptive, the default): rows hash into
    fine buckets, their psum'd global counts feed a greedy balanced
    bucket→shard assignment (``ExchangeCoordinator.scala:85,118``); same-
    key rows still land on one shard (assignment is per fine bucket)."""

    def __init__(self, keys: Sequence[Expression], n_shards: int,
                 skew_factor: float, child: P.PhysicalPlan,
                 fine_buckets: int = 0):
        self.keys = list(keys)
        self.n_shards = n_shards
        self.skew_factor = skew_factor
        self.fine_buckets = fine_buckets
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def cap_out(self, child_cap: int) -> int:
        return exchange_cap(child_cap, self.n_shards, self.skew_factor)

    def run(self, ctx):
        batch = self.children[0].run(ctx)
        h = _hash(batch, self.keys)
        if self.fine_buckets > 0:
            live = batch.row_valid_or_true()
            fine, counts = fine_bucket_histogram(ctx, h, live,
                                                 self.fine_buckets)
            assign, _loads = ctx.comm.once(ctx.shard, balanced_assignment,
                                           counts, self.n_shards)
            bucket = assign[fine.to(torch.int64)]
        else:
            bucket = umod(h, self.n_shards).to(torch.int32)
        cap_out = self.cap_out(batch.capacity)
        out, overflow = hash_exchange(ctx, batch, bucket, self.n_shards,
                                      cap_out)
        ctx.add_flag(overflow, "exchange", cap_out)  # executor reduces
        return out

    def partitioning(self):
        kn = _key_names(self.keys)
        return HashPartitioning(kn) if kn is not None else UNKNOWN

    def __repr__(self):
        return (f"ExchangeHash [{', '.join(map(repr, self.keys))}] "
                f"x{self.n_shards} f={self.skew_factor} "
                f"fine={self.fine_buckets}")


class DExchangeRange(DNode):
    """Range repartition by sampled splitters (global sort step 1)."""

    def __init__(self, orders: Sequence[Tuple[Expression, bool, bool]],
                 n_shards: int, skew_factor: float, child: P.PhysicalPlan):
        self.orders = list(orders)
        self.n_shards = n_shards
        self.skew_factor = skew_factor
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx):
        batch = self.children[0].run(ctx)
        batch = round_robin_exchange(ctx, batch, self.n_shards)
        ectx = EvalContext(batch)
        schema = batch.schema
        # FULL lexicographic splitters over every sort key: equal-first-key
        # runs split across shards by the later keys
        keys64 = []
        for e, asc, nf in self.orders:
            v = ectx.broadcast(e.eval(ectx))
            _, key = sort_key_transform(v.data, v.valid,
                                        e.data_type(schema), asc, nf)
            if key.dtype.is_floating_point:
                # the local sort's own monotone int64 image of the float
                # (-0.0 == 0.0, NaN last), so routing order IS sort order
                key64 = _sortable(key.to(torch.float64))
            else:
                key64 = key.to(torch.int64)
            if v.valid is not None:
                # nulls route to the extreme bucket on their order side
                key64 = torch.where(v.valid, key64,
                                    _I64_MIN if nf else _I64_MAX)
            keys64.append(key64)
        live = batch.row_valid_or_true()
        splitters = sampled_splitters_multi(ctx, keys64, live, self.n_shards)
        bucket = lex_bucket(keys64, splitters)
        cap_out = exchange_cap(batch.capacity, self.n_shards,
                               self.skew_factor)
        out, overflow = hash_exchange(ctx, batch, bucket, self.n_shards,
                                      cap_out)
        ctx.add_flag(overflow, "exchange", cap_out)  # executor reduces
        return out

    def __repr__(self):
        parts = [f"{e!r} {'ASC' if a else 'DESC'} {'NF' if nf else 'NL'}"
                 for e, a, nf in self.orders]
        return (f"ExchangeRange [{', '.join(parts)}] x{self.n_shards} "
                f"f={self.skew_factor}")


class DBroadcast(DNode):
    """All-gather the child to every shard (BroadcastExchangeExec)."""

    def __init__(self, child: P.PhysicalPlan):
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx):
        return broadcast_all(ctx, self.children[0].run(ctx))

    def __repr__(self):
        return "BroadcastExchange"


class DSkewJoin(PJoin):
    """Shuffled hash join with measured routing + hot-key splitting.

    Both sides co-partition through ONE balanced bucket→shard assignment
    (from the psum'd fine-bucket histograms of both sides).  Fine buckets
    whose probe-side count exceeds ``spread_frac x even-share`` are HOT:
    their probe rows spread round-robin over all shards while their build
    rows replicate to every shard, so the join stays exact with per-shard
    load near the even share.  Spreading is enabled only for join types
    whose build side never emits unmatched rows (inner/left/semi/anti).

    A PJoin, so the local join kernel is inherited, not duplicated."""

    def __init__(self, left, right, how, key_pairs, residual, schema,
                 factor, n_shards, skew_factor, fine_buckets,
                 spread_frac, allow_spread):
        PJoin.__init__(self, left, right, how, key_pairs, residual,
                       schema, factor)
        self.n_shards = n_shards
        self.skew_factor = skew_factor
        self.fine_buckets = fine_buckets
        self.spread_frac = spread_frac
        self.allow_spread = allow_spread

    def partitioning(self):
        return UNKNOWN

    def run(self, ctx):
        probe = self.children[0].run(ctx)
        build = self.children[1].run(ctx)
        n = self.n_shards
        B = self.fine_buckets
        lkeys, rkeys = _routing_key_pairs(self.key_pairs, probe.schema,
                                          build.schema)
        ph, bh = _hash(probe, lkeys), _hash(build, rkeys)
        plive = probe.row_valid_or_true()
        blive = build.row_valid_or_true()

        pfine, pcounts = fine_bucket_histogram(ctx, ph, plive, B)
        bfine, bcounts = fine_bucket_histogram(ctx, bh, blive, B)
        pfine, bfine = pfine.to(torch.int64), bfine.to(torch.int64)

        cap_p = exchange_cap(probe.capacity, n, self.skew_factor)
        cap_b = exchange_cap(build.capacity, n, self.skew_factor)

        if not self.allow_spread:
            # balanced assignment only (e.g. full outer, where replicated
            # build rows would duplicate unmatched-build output)
            assign, _loads = ctx.comm.once(ctx.shard, balanced_assignment,
                                           pcounts + bcounts, n)
            p_ex, p_ov = hash_exchange(ctx, probe, assign[pfine], n, cap_p)
            b_ex, b_ov = hash_exchange(ctx, build, assign[bfine], n, cap_b)
            ctx.add_flag(p_ov + b_ov, "exchange", max(cap_p, cap_b))
            return self._run_on(ctx, p_ex, b_ex)

        # hot = a fine bucket that alone exceeds spread_frac of the
        # per-shard even share of GLOBAL probe rows (float32, as the JAX
        # package computes it, so the hot set agrees at the edge)
        total = pcounts.sum()
        threshold = total.to(torch.float32) * torch.full(
            (), self.spread_frac / n, dtype=torch.float32, device=ctx.device)
        hot = pcounts.to(torch.float32) > threshold

        # balanced assignment over the NON-hot load of both sides
        routed = torch.where(hot, 0, pcounts + bcounts)
        assign, _loads = ctx.comm.once(ctx.shard, balanced_assignment,
                                       routed, n)

        p_hot = hot[pfine] & plive
        rr = (torch.arange(probe.capacity, dtype=torch.int32,
                           device=ctx.device) + ctx.shard) % n
        pbucket = torch.where(p_hot, rr, assign[pfine])
        p_ex, p_ov = hash_exchange(ctx, probe, pbucket, n, cap_p)

        b_hot = hot[bfine] & blive
        # hot build rows leave the routed path (bucket n == dropped) and
        # travel the replication path instead
        bbucket = torch.where(b_hot, n, assign[bfine])
        b_ex, b_ov = hash_exchange(ctx, build, bbucket, n, cap_b)
        hot_b, hot_ov = replicate_selected(ctx, build, b_hot, cap_b)

        build_all = _concat_batches(b_ex, hot_b)
        ctx.add_flag(p_ov + b_ov + hot_ov, "exchange", max(cap_p, cap_b))
        return self._run_on(ctx, p_ex, build_all)

    def __repr__(self):
        return (f"SkewJoin {self.how} "
                f"[{', '.join(f'{l!r}={r!r}' for l, r in self.key_pairs)}] "
                f"x{self.n_shards} f={self.skew_factor} "
                f"fine={self.fine_buckets} "
                f"spread={self.spread_frac if self.allow_spread else 'off'}")


def _concat_batches(a: ColumnBatch, b: ColumnBatch) -> ColumnBatch:
    """Row-concatenate two same-schema batches."""
    vectors = []
    for va, vb in zip(a.vectors, b.vectors):
        data = torch.cat([va.data, vb.data])
        if va.valid is None and vb.valid is None:
            valid = None
        else:
            valid = torch.cat([va.valid_or_true(), vb.valid_or_true()])
        vectors.append(ColumnVector(data, va.dtype, valid,
                                    va.dictionary or vb.dictionary))
    rv = torch.cat([a.row_valid_or_true(), b.row_valid_or_true()])
    return ColumnBatch(a.names, vectors, rv, a.capacity + b.capacity)


def _group_by_keys(key_vals, live, capacity):
    """The grouping prologue shared by the partial and final aggregation
    stages (so key grouping can never desynchronize between them): sort
    rows by (liveness, per-key null flag, key value), derive segment ids.
    Returns (perm, seg_ids, is_start, num_groups); perm/is_start/
    num_groups are None for the global (no keys) case.  Dead rows sort
    last and each takes its own segment id past every group (one shared
    spill segment would serialize their stores on the card)."""
    dev = live.device
    if not key_vals:
        return None, torch.zeros(capacity, dtype=torch.int64, device=dev), \
            None, None
    sort_cols = [(~live).to(torch.int8)]
    for v in key_vals:
        data = v.data.to(torch.int8) if v.data.dtype == torch.bool \
            else v.data
        if v.valid is None:
            sort_cols += [torch.zeros(capacity, dtype=torch.int8,
                                      device=dev), data]
        else:
            sort_cols += [torch.where(v.valid, 0, -1).to(torch.int8),
                          torch.where(v.valid, data,
                                      torch.zeros((), dtype=data.dtype,
                                                  device=dev))]
    perm = multi_key_argsort(sort_cols, capacity)
    live_s = live[perm]
    is_start = _segment_starts([c[perm] for c in sort_cols], live_s,
                               capacity)
    seg_ids = torch.cumsum(is_start.to(torch.int64), 0) - 1
    seg_ids = torch.where(live_s, seg_ids,
                          torch.arange(capacity, device=dev))
    num_groups = is_start.sum(dtype=torch.int64)
    return perm, seg_ids, is_start, num_groups


def _reduce_buf(data, perm, seg_ids, capacity, kind):
    """One aggregation-buffer reduction: segment reduce in SORTED
    coordinates with keys, whole-array reduce without (perm=None)."""
    if perm is None:
        return _global_reduce(data, kind, capacity)
    return segment_reduce(data[perm], seg_ids, capacity, kind)


def _emit_group_keys(keys, key_dts, key_vals, perm, seg_ids, is_start,
                     capacity):
    """Each group's key value at its slot; returns (names, vectors)."""
    names, vectors = [], []
    for k, dt, v in zip(keys, key_dts, key_vals):
        kd = _scatter_starts(v.data[perm], seg_ids, is_start, capacity)
        kv = None if v.valid is None else _scatter_starts(
            v.valid[perm], seg_ids, is_start, capacity)
        names.append(k.name)
        vectors.append(ColumnVector(kd.to(dt.torch_dtype), dt, kv,
                                    v.dictionary))
    return names, vectors


def _group_rows(keys, num_groups, capacity, device) -> torch.Tensor:
    idx = torch.arange(capacity, dtype=torch.int64, device=device)
    return idx < (num_groups if keys else 1)


def _dead_rank(is_last: bool) -> int:
    return -1 if is_last else 1 << 62


def _first_last_reduce(rank_s, dead_rank, value_s, validplane_s, seg_ids,
                       is_last, capacity, global_mode=False):
    """Shared (rank, value, validity) segment merge for first/last value-
    carry buffers — used identically by the partial and final stages so
    the rank encoding can never desynchronize.  With keys the inputs are
    in SORTED coordinates; ``global_mode`` (keyless) reduces whole-array.
    Returns (rank_red, value_red, valid_red int8)."""
    kind = "max" if is_last else "min"

    def red(d, k):
        return _global_reduce(d, k, capacity) if global_mode \
            else segment_reduce(d, seg_ids, capacity, k)

    r_red = red(rank_s, kind)
    r_mine = r_red[:1] if global_mode else r_red[seg_ids]
    win = (rank_s == r_mine) & (rank_s != dead_rank)
    if value_s.dtype == torch.bool:
        value_s = value_s.to(torch.int8)
    ident = torch.full((), identity("max", value_s.dtype),
                       dtype=value_s.dtype, device=value_s.device)
    v_red = red(torch.where(win, value_s, ident), "max")
    masked_valid = torch.where(win, validplane_s.to(torch.int8), 0) \
        .to(torch.int8)
    valid_red = red(masked_valid, "max")
    return r_red, v_red, valid_red


def _sorted(perm, *arrays):
    return arrays if perm is None else tuple(a[perm] for a in arrays)


class DPartialAggregate(DNode):
    """Per-shard partial aggregation: emits group keys + RAW buffer columns
    (mode=Partial of the reference's two-phase aggregation)."""

    def __init__(self, keys, slots, child):
        self.keys = list(keys)
        self.slots = list(slots)
        self.children = (child,)

    def buffer_names(self, slot_idx: int, func: AggregateFunction
                     ) -> List[str]:
        n = 3 if isinstance(func, First) else func.num_buffers()
        return [f"__buf_{slot_idx}_{j}" for j in range(n)]

    def schema(self):
        cs = self.children[0].schema()
        fields = [T.StructField(k.name, k.data_type(cs)) for k in self.keys]
        for i, (f, _n) in enumerate(self.slots):
            for bn in self.buffer_names(i, f):
                fields.append(T.StructField(bn, T.int64))  # refined at run
        return T.StructType(fields)

    def run(self, ctx):
        batch = self.children[0].run(ctx)
        ectx = EvalContext(batch)
        live = batch.row_valid_or_true().expand(batch.capacity)
        capacity = batch.capacity
        dev = batch.device

        key_vals = [ectx.broadcast(k.eval(ectx)) for k in self.keys]
        perm, seg_ids, is_start, num_groups = _group_by_keys(
            key_vals, live, capacity)
        names, vectors = _emit_group_keys(
            self.keys, [k.data_type(batch.schema) for k in self.keys],
            key_vals, perm, seg_ids, is_start, capacity)

        for i, (func, _n) in enumerate(self.slots):
            if isinstance(func, First):
                # value-carry buffers (rank, value, winner-validity): the
                # rank is unique across the mesh (shard << 48 | row), so
                # the final stage picks the globally-first/last row's
                # value AND nullness by masking on the reduced rank
                is_last = getattr(func, "ARGREDUCE", "first") == "last"
                v = ectx.broadcast(func.children[0].eval(ectx))
                contrib = live if (v.valid is None or not func.ignore_nulls) \
                    else (live & v.valid)
                dead_rank = _dead_rank(is_last)
                rank = ctx.shard_offset + torch.arange(
                    capacity, dtype=torch.int64, device=dev)
                rank = torch.where(contrib, rank, dead_rank)
                validplane = v.valid if v.valid is not None \
                    else torch.ones(capacity, dtype=torch.bool, device=dev)
                r_s, v_s, vp_s = _sorted(perm, rank, v.data, validplane)
                r_red, v_red, valid_red = _first_last_reduce(
                    r_s, dead_rank, v_s, vp_s, seg_ids, is_last,
                    capacity, global_mode=perm is None)
                names += self.buffer_names(i, func)
                # dictionary value buffers keep the STRING type so the
                # codes stay attached to their words across the exchange
                v_dt = func.children[0].data_type(batch.schema) \
                    if v.dictionary is not None \
                    else T.np_dtype_to_engine(T.torch_to_np_dtype(v_red.dtype))
                vectors.append(ColumnVector(r_red, T.int64, None, None))
                vectors.append(ColumnVector(v_red, v_dt, None, v.dictionary))
                vectors.append(ColumnVector(valid_red, T.int8, None, None))
                continue
            specs = func.make_buffers(ectx, live)
            odict = func.output_dictionary(ectx)
            for j, (bn, spec) in enumerate(zip(self.buffer_names(i, func),
                                               specs)):
                reduced = _reduce_buf(spec.data, perm, seg_ids, capacity,
                                      spec.kind)
                names.append(bn)
                if j == 0 and odict is not None:
                    # min/max over a dictionary column: the value buffer
                    # IS codes — type it as the string column it reduces
                    vectors.append(ColumnVector(
                        reduced, func.data_type(batch.schema), None, odict))
                    continue
                dt = T.boolean if spec.dtype == torch.bool else \
                    T.np_dtype_to_engine(T.torch_to_np_dtype(spec.dtype))
                vectors.append(ColumnVector(reduced, dt, None, None))
        return ColumnBatch(names, vectors,
                           _group_rows(self.keys, num_groups, capacity, dev),
                           capacity)

    def __repr__(self):
        return (f"PartialAggregate keys=[{', '.join(map(repr, self.keys))}] "
                f"aggs=[{', '.join(repr(f) for f, _ in self.slots)}]")


class DFinalAggregate(DNode):
    """Merge partial buffers after the exchange and finish.

    Re-groups by keys (partials from different shards collide here) and
    reduces each buffer with ITS OWN kind — sum-of-sums, min-of-mins."""

    def __init__(self, keys, slots, partial: DPartialAggregate, child):
        self.keys = list(keys)
        self.slots = list(slots)
        self.partial = partial
        self.children = (child,)

    def schema(self):
        cs_child = self.partial.children[0].schema()
        fields = [T.StructField(k.name, k.data_type(cs_child))
                  for k in self.keys]
        fields += [T.StructField(n, f.data_type(cs_child))
                   for f, n in self.slots]
        return T.StructType(fields)

    def run(self, ctx):
        batch = self.children[0].run(ctx)   # partial rows, exchanged
        ectx = EvalContext(batch)
        live = batch.row_valid_or_true().expand(batch.capacity)
        capacity = batch.capacity
        dev = batch.device

        key_vals = [ectx.broadcast(Col(k.name).eval(ectx)) for k in self.keys]
        perm, seg_ids, is_start, num_groups = _group_by_keys(
            key_vals, live, capacity)
        cs_child = self.partial.children[0].schema()
        names, vectors = _emit_group_keys(
            self.keys, [k.data_type(cs_child) for k in self.keys],
            key_vals, perm, seg_ids, is_start, capacity)

        for i, (func, n) in enumerate(self.slots):
            bnames = self.partial.buffer_names(i, func)
            if isinstance(func, First):
                is_last = getattr(func, "ARGREDUCE", "first") == "last"
                dead_rank = _dead_rank(is_last)
                val_col = batch.column(bnames[1])
                rank_m = torch.where(live, batch.column(bnames[0]).data,
                                     dead_rank)
                validplane = batch.column(bnames[2]).data != 0
                r_s, v_s, vp_s = _sorted(perm, rank_m, val_col.data,
                                         validplane)
                r_red, v_red, valid_red = _first_last_reduce(
                    r_s, dead_rank, v_s, vp_s, seg_ids, is_last,
                    capacity, global_mode=perm is None)
                got = (r_red != dead_rank) & (valid_red != 0)
                dt = func.data_type(cs_child)
                names.append(n)
                vectors.append(ColumnVector(v_red.to(dt.torch_dtype), dt,
                                            got, val_col.dictionary))
                continue
            bufs = []
            for j, kind in enumerate(self._buffer_kinds(func)):
                col = batch.column(bnames[j])
                ident = torch.full((), identity(kind, col.data.dtype),
                                   dtype=col.data.dtype, device=dev)
                masked = torch.where(live, col.data, ident)
                bufs.append(_reduce_buf(masked, perm, seg_ids, capacity,
                                        kind))
            out = func.finish(bufs)
            dt = func.data_type(cs_child)
            dictionary = out.dictionary
            if dictionary is None:
                # min/max over strings: the dictionary rides the value
                # buffer column
                dictionary = batch.column(bnames[0]).dictionary
            names.append(n)
            vectors.append(ColumnVector(out.data.to(dt.torch_dtype), dt,
                                        out.valid, dictionary))
        return ColumnBatch(names, vectors,
                           _group_rows(self.keys, num_groups, capacity, dev),
                           capacity)

    @staticmethod
    def _buffer_kinds(func: AggregateFunction) -> List[str]:
        """Reduction kind of each buffer (mirrors make_buffers order)."""
        if isinstance(func, (Sum, Avg)):
            return ["sum", "sum"]
        if isinstance(func, (Count, CountStar)):
            return ["sum"]
        if isinstance(func, Min):
            return ["min", "sum"]
        if isinstance(func, Max):
            return ["max", "sum"]
        if isinstance(func, VarianceBase):
            return ["sum", "sum", "sum"]
        raise NotImplementedError(f"distributed merge for {func!r}")

    def __repr__(self):
        return (f"FinalAggregate keys=[{', '.join(map(repr, self.keys))}] "
                f"aggs=[{', '.join(n for _, n in self.slots)}]")


class DMergePartial(DNode):
    """Merge partial-aggregate states into a MERGED PARTIAL (not finished)
    batch: re-groups by keys and reduces every buffer with its own kind,
    under the partial's buffer names and schema (mode=PartialMerge of
    ``AggUtils.scala``; ``spark_tpu/parallel/dist.py`` ``DMergePartial``).

    The multi-batch runner's cross-batch fold: fold(partials) is itself a
    valid partial, so folds chain without finishing, and first/last
    value-carry triples merge by the ``_first_last_reduce`` the final
    stage uses."""

    def __init__(self, keys, slots, partial: DPartialAggregate, child):
        self.keys = list(keys)
        self.slots = list(slots)
        self.partial = partial
        self.children = (child,)

    def schema(self):
        return self.partial.schema()

    def run(self, ctx):
        batch = self.children[0].run(ctx)
        ectx = EvalContext(batch)
        live = batch.row_valid_or_true().expand(batch.capacity)
        capacity = batch.capacity
        dev = batch.device

        key_vals = [ectx.broadcast(Col(k.name).eval(ectx)) for k in self.keys]
        perm, seg_ids, is_start, num_groups = _group_by_keys(
            key_vals, live, capacity)
        cs_child = self.partial.children[0].schema()
        names, vectors = _emit_group_keys(
            self.keys, [k.data_type(cs_child) for k in self.keys],
            key_vals, perm, seg_ids, is_start, capacity)

        for i, (func, _n) in enumerate(self.slots):
            bnames = self.partial.buffer_names(i, func)
            if isinstance(func, First):
                is_last = getattr(func, "ARGREDUCE", "first") == "last"
                dead_rank = _dead_rank(is_last)
                val_col = batch.column(bnames[1])
                rank_m = torch.where(live, batch.column(bnames[0]).data,
                                     dead_rank)
                validplane = batch.column(bnames[2]).data != 0
                r_s, v_s, vp_s = _sorted(perm, rank_m, val_col.data,
                                         validplane)
                r_red, v_red, valid_red = _first_last_reduce(
                    r_s, dead_rank, v_s, vp_s, seg_ids, is_last,
                    capacity, global_mode=perm is None)
                names += bnames
                vectors.append(ColumnVector(r_red, T.int64, None, None))
                vectors.append(ColumnVector(v_red.to(val_col.data.dtype),
                                            val_col.dtype, None,
                                            val_col.dictionary))
                vectors.append(ColumnVector(valid_red.to(torch.int8),
                                            T.int8, None, None))
                continue
            for j, kind in enumerate(DFinalAggregate._buffer_kinds(func)):
                col = batch.column(bnames[j])
                ident = torch.full((), identity(kind, col.data.dtype),
                                   dtype=col.data.dtype, device=dev)
                masked = torch.where(live, col.data, ident)
                names.append(bnames[j])
                vectors.append(ColumnVector(
                    _reduce_buf(masked, perm, seg_ids, capacity, kind),
                    col.dtype, None, col.dictionary))
        return ColumnBatch(names, vectors,
                           _group_rows(self.keys, num_groups, capacity, dev),
                           capacity)

    def __repr__(self):
        return (f"MergePartial keys=[{', '.join(map(repr, self.keys))}] "
                f"aggs=[{', '.join(n for _, n in self.slots)}]")


class DGlobalAggregate(DNode):
    """No-key aggregation: partial buffers per shard → psum → finish."""

    def __init__(self, slots, child):
        self.slots = list(slots)
        self.children = (child,)

    def schema(self):
        cs = self.children[0].schema()
        return T.StructType([T.StructField(n, f.data_type(cs))
                             for f, n in self.slots])

    def run(self, ctx):
        batch = self.children[0].run(ctx)
        ectx = EvalContext(batch)
        live = batch.row_valid_or_true()
        comm, shard = ctx.comm, ctx.shard
        names, vectors = [], []
        for func, n in self.slots:
            specs = func.make_buffers(ectx, live)
            reduced = []
            for s in specs:
                if s.kind == "sum":
                    reduced.append(comm.psum(shard, s.data.sum(dtype=s.dtype)))
                elif s.kind == "min":
                    reduced.append(comm.pmin(shard, s.data.min()))
                else:
                    reduced.append(comm.pmax(shard, s.data.max()))
            out = func.finish([r.reshape(1) for r in reduced])
            dt = func.data_type(batch.schema)
            data = out.data[0].to(dt.torch_dtype).expand(8)
            valid = None if out.valid is None else out.valid[0].expand(8)
            names.append(n)
            vectors.append(ColumnVector(data, dt, valid,
                                        func.output_dictionary(ectx)))
        # one global row, on shard 0
        rv = (torch.arange(8, device=ctx.device) < 1) & (shard == 0)
        return ColumnBatch(names, vectors, rv, 8)

    def __repr__(self):
        return f"GlobalAggregate [{', '.join(n for _, n in self.slots)}]"


class DLimit(DNode):
    """Globally exact limit: shards agree via all-gather of live counts."""

    def __init__(self, n: int, child: P.PhysicalPlan):
        self.n = n
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx):
        batch = self.children[0].run(ctx)
        live = batch.row_valid_or_true()
        count = live.sum(dtype=torch.int64)
        counts, = ctx.comm.all_gather(ctx.shard, [count])     # (n_shards,)
        prefix = counts[:ctx.shard].sum()
        local_rank = torch.cumsum(live.to(torch.int64), 0)    # 1-based
        keep = live & (prefix + local_rank <= self.n)
        return ColumnBatch(batch.names, batch.vectors, keep, batch.capacity)

    def __repr__(self):
        return f"GlobalLimit {self.n}"


def _mask_to_shard_zero(ctx, out: ColumnBatch) -> ColumnBatch:
    rv = out.row_valid_or_true() & (ctx.shard == 0)
    return ColumnBatch(out.names, out.vectors, rv, out.capacity)


class DGatherOne(DNode):
    """Gather every shard's rows onto shard 0 (other shards go empty), for
    operators that must see the whole dataset in one place."""

    def __init__(self, child: P.PhysicalPlan):
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx):
        return _mask_to_shard_zero(
            ctx, broadcast_all(ctx, self.children[0].run(ctx)))

    def __repr__(self):
        return "GatherToOne"


class DKeepShardZero(DNode):
    """Mask output rows to shard 0 — for operators (keyless aggregates)
    that produce an ALWAYS-VALID row on every shard even over all-dead
    gathered input; without the mask the shards' concatenation would emit
    one duplicate row per shard."""

    def __init__(self, child: P.PhysicalPlan):
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx):
        return _mask_to_shard_zero(ctx, self.children[0].run(ctx))

    def __repr__(self):
        return "KeepShardZero"


class DShardSort(DNode):
    """Per-shard local sort (used after a range exchange)."""

    def __init__(self, orders, child):
        self.orders = list(orders)
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx):
        batch = self.children[0].run(ctx)
        ectx = EvalContext(batch)
        schema = batch.schema
        keys = []
        for e, asc, nf in self.orders:
            v = ectx.broadcast(e.eval(ectx))
            keys.append((v.data, v.valid, e.data_type(schema), asc, nf))
        return sort_batch(batch, keys)

    def __repr__(self):
        parts = [f"{e!r} {'ASC' if a else 'DESC'} {'NF' if nf else 'NL'}"
                 for e, a, nf in self.orders]
        return f"ShardSort [{', '.join(parts)}]"
