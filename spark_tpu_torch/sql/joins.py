"""Join execution.

The one static-shape join algorithm of ``spark_tpu/sql/joins.py``
(replacing the reference's ``BroadcastHashJoinExec`` / ``SortMergeJoinExec``
zoo): sorted build + binary-search probe.

1. single-key joins search on an EXACT order-consistent int64 encoding of
   the key value (ints directly; floats via a NaN/-0.0-normalizing
   bitcast; dictionary strings via a host-canonicalized shared id space)
   — no hashing, collisions impossible.  Multi-key joins search on a
   62-bit-masked combined hash with NULL/dead sentinels outside the hash
   range;
2. the build side sorts by search key (dead rows sentineled to the end);
3. each probe row binary-searches its match range [lo, hi);
4. duplicate expansion uses the counts-cumsum-gather pattern into a STATIC
   output capacity (``spark.sql.join.outputCapacityFactor`` × probe
   capacity); the true total is returned as an overflow flag that drives
   the executor's adaptive capacity retry;
5. every candidate pair is verified by EXACT per-key comparison
   (null-aware); semi/anti existence and outer null-extension derive from
   a scatter-OR of verified pairs.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..capture import constant
from ..columnar import ColumnBatch, ColumnVector, pad_capacity
from ..expressions import (AnalysisException, Cast, Col, EQ, EvalContext,
                           Expression, ExprValue, Hash64, _u64, lsr64)
from ..kernels import apply_filter, multi_key_argsort, searchsorted, take_batch
from .logical import Join
from . import physical as P

Array = Any


def split_equi_condition(
    on: Optional[Expression], left_cols: set, right_cols: set,
) -> Tuple[List[Tuple[Expression, Expression]], List[Expression]]:
    """Split a join condition into equi-key pairs and residual conjuncts
    (the extraction half of ``ExtractEquiJoinKeys``)."""
    from .optimizer import split_conjuncts
    if on is None:
        return [], []
    keys, residual = [], []
    for c in split_conjuncts(on):
        if isinstance(c, EQ):
            l, r = c.children
            lr, rr = l.references(), r.references()
            # BOTH sides must reference columns: `lit = col` is a filter
            if lr and rr:
                if lr <= left_cols and rr <= right_cols:
                    keys.append((l, r))
                    continue
                if lr <= right_cols and rr <= left_cols:
                    keys.append((r, l))
                    continue
        residual.append(c)
    return keys, residual


def equi_join_keys(node: Join) -> List[Tuple[Expression, Expression]]:
    """Equi-key pairs of a LOGICAL join, oriented (left_expr, right_expr);
    empty for cross / pure-theta joins."""
    if node.using:
        return [(Col(n), Col(n)) for n in node.using]
    keys, _residual = split_equi_condition(
        node.on, set(node.left.schema().names),
        set(node.right.schema().names))
    return keys


class _Hash64B(Hash64):
    """Second, independent mix for match verification (bit-identical to
    ``spark_tpu.sql.joins._Hash64B``)."""

    @staticmethod
    def _mix(x: torch.Tensor) -> torch.Tensor:
        c1 = _u64(0x9E3779B97F4A7C15)
        c2 = _u64(0xBF58476D1CE4E5B9)
        x = x ^ lsr64(x, 31)
        x = x * c1
        x = x ^ lsr64(x, 29)
        x = x * c2
        x = x ^ lsr64(x, 32)
        return x

    @staticmethod
    def _string_hash_table(dictionary):
        import hashlib
        out = np.zeros(max(len(dictionary), 1), np.int64)
        for i, w in enumerate(dictionary):
            data = w if isinstance(w, bytes) else str(w).encode("utf-8")
            h = hashlib.blake2b(data, digest_size=8, key=b"spark-tpu-joinB").digest()
            out[i] = np.frombuffer(h, np.int64)[0]
        return out


# primary hash keys are masked to 62 bits (range [0, 2^62)) so the sentinels
# below are STRICTLY outside the hash range
_HASH_MASK = (1 << 62) - 1
_NULL_PROBE = -3
_NULL_BUILD = -5
_DEAD_BUILD = torch.iinfo(torch.int64).max
_CANON_NAN = int(np.float64(np.nan).view(np.int64))


def _orderable_f64(x: torch.Tensor) -> torch.Tensor:
    """Total-order monotonic int64 encoding of float64 (IEEE-754 sign
    flip): -0.0 folds to +0.0 and every NaN to one canonical pattern above
    +inf, then negative bit patterns flip their magnitude bits so the
    int64s ascend exactly as the floats do."""
    x = torch.where(x == 0.0, torch.zeros((), dtype=x.dtype, device=x.device), x)
    bits = x.contiguous().view(torch.int64)
    bits = torch.where(torch.isnan(x), _CANON_NAN, bits)
    return torch.where(bits < 0, bits ^ torch.iinfo(torch.int64).max, bits)


def _exact_encode_pair(pctx: EvalContext, bctx: EvalContext,
                       l: Expression, r: Expression):
    """Exact int64 encodings of one equi-key pair, value-comparable across
    sides; None when the pair's type has no exact 64-bit encoding (then
    verification for this pair falls back to the second hash).

    Floats are normalized so NaN == NaN and -0.0 == 0.0.  Dictionary
    strings map through a HOST-side canonical id space built from both
    dictionaries; the table moves to the batch's device for the gather."""
    lv = pctx.broadcast(l.eval(pctx))
    rv = bctx.broadcast(r.eval(bctx))

    def enc(side_ctx, v, other_dict):
        if v.dictionary is not None:
            words = [w if isinstance(w, str) else str(w) for w in v.dictionary]
            other = [w if isinstance(w, str) else str(w) for w in other_dict]
            pos = {w: i for i, w in enumerate(sorted(set(words) | set(other)))}
            table = constant(
                np.array([pos[w] for w in words] or [0], np.int64),
                side_ctx.device)
            codes = v.data.to(torch.int64).clamp(0, max(len(words) - 1, 0))
            return table[codes]
        if v.data.dtype.is_floating_point:
            return _orderable_f64(v.data.to(torch.float64))
        return v.data.to(torch.int64)

    has_dict = lv.dictionary is not None or rv.dictionary is not None
    if has_dict and (lv.dictionary is None or rv.dictionary is None):
        return None                      # string vs non-dict string
    if not has_dict and (lv.data.dtype.is_floating_point
                         != rv.data.dtype.is_floating_point):
        # mixed int/float pair: compare both as float64
        lv = ExprValue(lv.data.to(torch.float64), lv.valid, None)
        rv = ExprValue(rv.data.to(torch.float64), rv.valid, None)
    p_enc = enc(pctx, lv, rv.dictionary if has_dict else [])
    b_enc = enc(bctx, rv, lv.dictionary if has_dict else [])
    p_val = None if lv.valid is None else lv.valid.expand(pctx.capacity)
    b_val = None if rv.valid is None else rv.valid.expand(bctx.capacity)
    return p_enc, p_val, b_enc, b_val


def _scatter_or(size: int, idx: torch.Tensor, values: torch.Tensor
                ) -> torch.Tensor:
    """out[j] = OR of values where idx == j.  torch has no "drop" mode —
    an out-of-range index asserts on CUDA and raises on the CPU — so
    those entries are masked out first.  Entries that set nothing store
    into private scratch slots past the end (clamping them onto one slot
    would serialize them on the card), and every store to a real slot
    writes True, so plain stores need no atomics."""
    n = idx.shape[0]
    hit = values & (idx >= 0) & (idx < size)
    scratch = size + torch.arange(n, device=idx.device)
    out = torch.zeros(size + n, dtype=torch.bool, device=idx.device)
    out.index_put_((torch.where(hit, idx, scratch),), hit)
    return out[:size]


def _join_keys(ctx: EvalContext, exprs: Sequence[Expression],
               null_sentinel: int, dead_sentinel: Optional[int]
               ) -> Tuple[Array, Array]:
    """(hashA, hashB) int64 keys for one side; NULL/dead rows sentineled."""
    ha = ctx.broadcast(Hash64(*exprs).eval(ctx))
    hb = ctx.broadcast(_Hash64B(*exprs).eval(ctx))
    all_valid = None
    for e in exprs:
        v = e.eval(ctx)
        if v.valid is not None:
            nn = v.valid.expand(ctx.capacity)
            all_valid = nn if all_valid is None else (all_valid & nn)
    ka, kb = ha.data & _HASH_MASK, hb.data
    if all_valid is not None:
        ka = torch.where(all_valid, ka, null_sentinel)
    live = ctx.batch.row_valid_or_true()
    ka = torch.where(live, ka, dead_sentinel if dead_sentinel is not None
                     else null_sentinel)
    return ka, kb


class PJoin(P.PhysicalPlan):
    def __init__(self, left: P.PhysicalPlan, right: P.PhysicalPlan, how: str,
                 key_pairs: Sequence[Tuple[Expression, Expression]],
                 residual: Optional[Expression],
                 schema: T.StructType, out_capacity_factor: float = 1.0):
        self.children = (left, right)
        self.how = how
        self.key_pairs = list(key_pairs)
        self.residual = residual
        self._schema = schema
        self.factor = out_capacity_factor

    def schema(self):
        return self._schema

    def run(self, ctx: P.ExecContext) -> ColumnBatch:
        left = self.children[0].run(ctx)
        right = self.children[1].run(ctx)
        return self._run_on(ctx, left, right)

    # ------------------------------------------------------------------
    def _run_on(self, ctx: P.ExecContext, probe: ColumnBatch,
                build: ColumnBatch) -> ColumnBatch:
        how = self.how
        if how == "cross" or not self.key_pairs:
            return self._cross(probe, build)

        dev = probe.device
        pctx = EvalContext(probe)
        bctx = EvalContext(build)
        probe_live = probe.row_valid_or_true()
        build_live = build.row_valid_or_true()

        # exact int64 encodings per key pair (None → hashB verification)
        encs = [_exact_encode_pair(pctx, bctx, l, r) for l, r in self.key_pairs]

        if len(encs) == 1 and encs[0] is not None:
            # EXACT search path: sort/search the encoded value itself
            p_enc, p_val, b_enc, b_val = encs[0]
            b_ok = build_live if b_val is None else (build_live & b_val)
            # lexicographic (flag, key) sort puts valid keys first sorted
            # by value; null/dead rows sink into an INT64_MAX-keyed suffix
            b_flag = torch.where(b_ok, 0, 1).to(torch.int8)
            perm = multi_key_argsort([b_flag, b_enc], build.capacity)
            ba_s = torch.where(b_flag[perm] == 0, b_enc[perm], _DEAD_BUILD)
            pa = p_enc
            p_ok = probe_live if p_val is None else (probe_live & p_val)
        else:
            # multi-key / unencodable: combined-hash search with sentinels.
            # Mixed int/float pairs hash BOTH sides as float64
            lks, rks = [], []
            for l, r in self.key_pairs:
                try:
                    ldt = l.data_type(probe.schema)
                    rdt = r.data_type(build.schema)
                    if ldt.is_numeric and rdt.is_numeric \
                            and ldt.is_fractional != rdt.is_fractional:
                        l, r = Cast(l, T.float64), Cast(r, T.float64)
                except AnalysisException:
                    pass
                lks.append(l)
                rks.append(r)
            pa, _pb = _join_keys(pctx, lks, _NULL_PROBE, None)
            ba, _bb = _join_keys(bctx, rks, _NULL_BUILD, _DEAD_BUILD)
            perm = multi_key_argsort([ba], build.capacity)
            ba_s = ba[perm]
            p_ok = probe_live
        build_s = take_batch(build, perm)

        lo = searchsorted(ba_s, pa, side="left")
        hi = searchsorted(ba_s, pa, side="right")
        counts = torch.where(p_ok, hi - lo, 0)
        matched_hash = counts > 0

        out_cap = pad_capacity(int(probe.capacity * max(self.factor, 0.1)))
        if how in ("left", "full"):
            counts_eff = torch.where(probe_live, torch.clamp(counts, min=1), 0)
        else:
            counts_eff = counts

        offsets = torch.cumsum(counts_eff, 0) - counts_eff   # exclusive prefix
        total = counts_eff.sum()

        # output slot j → probe row i and duplicate index d
        slot = torch.arange(out_cap, dtype=torch.int64, device=dev)
        i = searchsorted(offsets + counts_eff, slot, side="right")
        i = i.clamp(0, probe.capacity - 1)
        d = slot - offsets[i]
        in_range = slot < total
        has_match = matched_hash[i]
        b_row = (lo[i] + d).clamp(0, build.capacity - 1)

        # EXACT per-pair verification (null-aware)
        build_live_s = build_live[perm]
        verify = in_range & has_match & build_live_s[b_row]
        hashb_needed = any(e is None for e in encs)
        for e in encs:
            if e is not None:
                pe, pv, be, bv = e
                ok = pe[i] == be[perm][b_row]
                if pv is not None:
                    ok = ok & pv[i]
                if bv is not None:
                    ok = ok & bv[perm][b_row]
                verify = verify & ok
        if hashb_needed:
            # unencodable pairs: the independent second hash over exactly
            # those pairs (collision ~2^-64, documented)
            exprs_l = [l for (l, _), e in zip(self.key_pairs, encs) if e is None]
            exprs_r = [r for (_, r), e in zip(self.key_pairs, encs) if e is None]
            pb2 = pctx.broadcast(_Hash64B(*exprs_l).eval(pctx)).data
            bb2 = bctx.broadcast(_Hash64B(*exprs_r).eval(bctx)).data[perm]
            verify = verify & (pb2[i] == bb2[b_row])

        left_out = take_batch(probe, i)
        right_out = take_batch(build_s, b_row)
        names: List[str] = list(left_out.names) + list(right_out.names)
        raw_vectors: List[ColumnVector] = \
            list(left_out.vectors) + list(right_out.vectors)

        if self.residual is not None:
            # non-equi ON conjuncts are part of the MATCH CONDITION
            rctx = EvalContext(
                ColumnBatch(names, raw_vectors, verify, out_cap))
            rv_res = rctx.broadcast(self.residual.eval(rctx))
            res_ok = rv_res.data.to(torch.bool)
            if rv_res.valid is not None:
                res_ok = res_ok & rv_res.valid   # NULL condition → no match
            verify = verify & res_ok

        # exact existence per probe row — drives semi/anti and outer
        # null-extension (never hash-range counts alone)
        exact_m = _scatter_or(probe.capacity, i, verify)

        ctx.add_flag(torch.clamp(total - out_cap, min=0), "join", out_cap)

        if how in ("left_semi", "left_anti"):
            keep = exact_m if how == "left_semi" \
                else (probe_live & ~exact_m)
            return ColumnBatch(probe.names, probe.vectors,
                               probe.row_valid_or_true() & keep,
                               probe.capacity)

        if how in ("left", "full"):
            # probe rows with zero VERIFIED matches emit one null-extended
            # row on their first slot
            null_slot = in_range & (d == 0) & ~exact_m[i] & probe_live[i]
            pair_ok = verify | null_slot
            null_right = verify
        else:
            pair_ok = verify
            null_right = None

        vectors: List[ColumnVector] = []
        for idx, v in enumerate(raw_vectors):
            if null_right is not None and idx >= len(left_out.vectors):
                base = v.valid if v.valid is not None \
                    else torch.ones(out_cap, dtype=torch.bool, device=dev)
                v = ColumnVector(v.data, v.dtype, base & null_right,
                                 v.dictionary)
            vectors.append(v)

        out = ColumnBatch(names, vectors, pair_ok, out_cap)

        if how == "full":
            hit_b = _scatter_or(build.capacity, b_row, verify)
            unmatched_b = build_live_s & ~hit_b
            out = self._append_unmatched_build(out, build_s, unmatched_b)
        return out

    # ------------------------------------------------------------------
    def _append_unmatched_build(self, inner_out: ColumnBatch,
                                build_s: ColumnBatch, unmatched):
        """FULL OUTER: append build rows with no VERIFIED match,
        null-extended on the left side."""
        dev = inner_out.device
        cap_b = build_s.capacity
        names = inner_out.names
        left_n = len(names) - len(build_s.names)
        ones_in = torch.ones(inner_out.capacity, dtype=torch.bool, device=dev)
        vectors: List[ColumnVector] = []
        for idx, v in enumerate(inner_out.vectors):
            if idx < left_n:
                data = torch.cat([v.data, torch.zeros(cap_b, dtype=v.data.dtype,
                                                      device=dev)])
                valid = torch.cat([
                    v.valid if v.valid is not None else ones_in,
                    torch.zeros(cap_b, dtype=torch.bool, device=dev)])
            else:
                bv = build_s.vectors[idx - left_n]
                data = torch.cat([v.data, bv.data])
                valid = torch.cat([
                    v.valid if v.valid is not None else ones_in,
                    bv.valid if bv.valid is not None
                    else torch.ones(cap_b, dtype=torch.bool, device=dev)])
            vectors.append(ColumnVector(data, v.dtype, valid, v.dictionary))
        rv = torch.cat([inner_out.row_valid_or_true(), unmatched])
        return ColumnBatch(names, vectors, rv, inner_out.capacity + cap_b)

    # ------------------------------------------------------------------
    def _cross(self, probe: ColumnBatch, build: ColumnBatch) -> ColumnBatch:
        """Cartesian product: all-pairs expansion (CartesianProductExec)."""
        np_, nb = probe.capacity, build.capacity
        out_cap = np_ * nb
        slot = torch.arange(out_cap, dtype=torch.int64, device=probe.device)
        i = torch.div(slot, nb, rounding_mode="floor")
        j = slot % nb
        left_out = take_batch(probe, i)
        right_out = take_batch(build, j)
        rv = probe.row_valid_or_true()[i] & build.row_valid_or_true()[j]
        out = ColumnBatch(left_out.names + right_out.names,
                          left_out.vectors + right_out.vectors, rv, out_cap)
        if self.residual is not None:
            out = apply_filter(out, self.residual)
        return out

    def __repr__(self):
        ks = ", ".join(f"{l!r}={r!r}" for l, r in self.key_pairs)
        return f"HashJoin {self.how} keys=[{ks}] residual={self.residual!r} f={self.factor}"


def plan_join(planner, node: Join, leaves) -> P.PhysicalPlan:
    ls, rs = node.left.schema(), node.right.schema()

    if node.how == "right":
        # right outer = left outer with sides swapped; _JoinOutput restores
        # column order and picks key values from the correct side
        swapped = Join(node.right, node.left, "left", node.on, node.using)
        inner = plan_join_raw(planner, swapped, leaves)
        rl = len(rs.names)
        return _JoinOutput(node.schema(), ls.names, rs.names,
                           left_base=rl, right_base=0,
                           using=node.using or [], how="right", child=inner)

    inner = plan_join_raw(planner, node, leaves)
    if node.how in ("left_semi", "left_anti"):
        return inner
    return _JoinOutput(node.schema(), ls.names, rs.names,
                       left_base=0, right_base=len(ls.names),
                       using=node.using or [], how=node.how, child=inner)


def plan_join_raw(planner, node: Join, leaves) -> P.PhysicalPlan:
    """Physical join emitting [all left cols + all right cols] (or probe-only
    for semi/anti); duplicate names allowed internally."""
    left_p = planner._to_physical(node.left, leaves)
    right_p = planner._to_physical(node.right, leaves)
    ls, rs = node.left.schema(), node.right.schema()

    overlap = set(ls.names) & set(rs.names)
    if node.using:
        key_pairs = [(Col(n), Col(n)) for n in node.using]
        residual_list: List[Expression] = []
        overlap -= set(node.using)
    else:
        key_pairs, residual_list = split_equi_condition(
            node.on, set(ls.names), set(rs.names))
    if overlap and node.how not in ("left_semi", "left_anti"):
        raise AnalysisException(
            f"ambiguous join output columns {sorted(overlap)}; rename before "
            f"joining (select/withColumnRenamed) or join with using=[...]")

    residual = None
    if residual_list:
        from .optimizer import join_conjuncts
        residual = join_conjuncts(residual_list)

    raw_schema = T.StructType(
        [T.StructField(f.name, f.dataType, True) for f in ls.fields]
        + [T.StructField(f.name, f.dataType, True) for f in rs.fields])

    if not key_pairs:
        if node.how not in ("cross", "inner"):
            raise AnalysisException(f"{node.how} join requires equi-join keys")
        return PJoin(left_p, right_p, "cross", [], residual, raw_schema, 1.0)

    return PJoin(left_p, right_p, node.how, key_pairs, residual, raw_schema,
                 planner.next_join_factor())


class _JoinOutput(P.PhysicalPlan):
    """Assembles the user-visible join output: drops duplicate USING key
    columns, restores left-then-right column order after a right-join swap,
    and coalesces key values across sides for FULL OUTER (Spark's USING
    semantics)."""

    def __init__(self, schema: T.StructType, left_names, right_names,
                 left_base: int, right_base: int, using: List[str], how: str,
                 child: P.PhysicalPlan):
        self._schema = schema
        self.left_names = list(left_names)
        self.right_names = list(right_names)
        self.left_base = left_base
        self.right_base = right_base
        self.using = list(using)
        self.how = how
        self.children = (child,)

    def schema(self):
        return self._schema

    def _left_idx(self, name: str) -> int:
        return self.left_base + self.left_names.index(name)

    def _right_idx(self, name: str) -> int:
        return self.right_base + self.right_names.index(name)

    def run(self, ctx):
        batch = self.children[0].run(ctx)
        names: List[str] = []
        vectors: List[ColumnVector] = []
        for f in self._schema.fields:
            n = f.name
            if n in self.using:
                lv = batch.vectors[self._left_idx(n)]
                rv = batch.vectors[self._right_idx(n)]
                if self.how == "full":
                    vec = _coalesce_vectors(lv, rv)
                elif self.how == "right":
                    vec = rv
                else:
                    vec = lv
            elif n in self.left_names:
                vec = batch.vectors[self._left_idx(n)]
            else:
                vec = batch.vectors[self._right_idx(n)]
            names.append(n)
            vectors.append(vec)
        return ColumnBatch(names, vectors, batch.row_valid, batch.capacity)

    def __repr__(self):
        return f"JoinOutput how={self.how} using={self.using}"


def _coalesce_vectors(a: ColumnVector, b: ColumnVector) -> ColumnVector:
    """a if valid else b — merging string dictionaries when needed."""
    av = a.valid_or_true()
    bv = b.valid_or_true()
    if a.dictionary is not None or b.dictionary is not None:
        from ..columnar import merge_dictionaries
        merged, ra, rb = merge_dictionaries(a.dictionary or (), b.dictionary or ())
        dev = a.data.device
        ad = constant(ra, dev)[a.data.long().clamp(min=0)] \
            if len(ra) else a.data
        bd = constant(rb, dev)[b.data.long().clamp(min=0)] \
            if len(rb) else b.data
        data = torch.where(av, ad, bd).to(torch.int32)
        return ColumnVector(data, a.dtype, av | bv, merged)
    return ColumnVector(torch.where(av, a.data, b.data), a.dtype, av | bv, None)
