"""Static-shape operator kernels over ColumnBatch, in torch.

The subset of ``spark_tpu/kernels.py`` on the single-device DataFrame
path (the replacement of the reference's Tungsten ``BytesToBytesMap``
aggregation, radix sort and iterator-chain operators):

* filter never compacts — it ANDs the row mask; ``compact`` is explicit;
* group-by has two forms: SORT-BASED (multi-key stable sort → segment
  boundaries → segment reductions) and the MXU form of the JAX package
  (bucket codes + 8-bit limb planes + one grouped accumulate), whose
  accumulate is the hand-written CUDA kernel ``cuda_agg.grouped_accumulate``;
* every kernel is a function of tensors on the batch's device; shapes
  depend on capacities, never on data.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from . import cuda_agg
from . import types as T
from .aggregates import AggregateFunction, First, identity
from .columnar import ColumnBatch, ColumnVector
from .expressions import Col, EvalContext, Expression, ExprValue

Array = Any

_I64_MIN = torch.iinfo(torch.int64).min
_I64_MAX = torch.iinfo(torch.int64).max


# ---------------------------------------------------------------------------
# sorting primitives
# ---------------------------------------------------------------------------

def _sortable(key: torch.Tensor) -> torch.Tensor:
    """An integer tensor that sorts as the JAX package sorts ``key``.

    bool sorts as int8.  Floats sort in ``lax.sort``'s canonical order —
    -0.0 equal to 0.0, every NaN (either sign) after +inf — made explicit
    as a monotone integer image of the bits, so the order never depends
    on how a device's sort treats the sign bit of zeros and NaNs."""
    if key.dtype == torch.bool:
        return key.to(torch.int8)
    if not key.dtype.is_floating_point:
        return key
    if key.dtype == torch.float64:
        idt, flip = torch.int64, _I64_MAX
    else:
        key = key.to(torch.float32)
        idt, flip = torch.int32, torch.iinfo(torch.int32).max
    key = torch.where(key == 0, torch.zeros((), dtype=key.dtype,
                                            device=key.device), key)
    key = torch.where(torch.isnan(key), torch.full((), float("nan"),
                                                   dtype=key.dtype,
                                                   device=key.device), key)
    bits = key.contiguous().view(idt)
    return torch.where(bits < 0, bits ^ flip, bits)


def multi_key_argsort(keys: Sequence[torch.Tensor], capacity: int) -> torch.Tensor:
    """Stable lexicographic argsort by keys[0], then keys[1], ... — chained
    stable sorts from the last key to the first (torch has no lexsort)."""
    perm: Optional[torch.Tensor] = None
    for k in reversed(list(keys)):
        k = _sortable(k)
        if k.dim() == 0:
            continue
        if perm is None:
            perm = torch.sort(k, stable=True).indices
        else:
            perm = perm[torch.sort(k[perm], stable=True).indices]
    if perm is None:
        device = keys[0].device if len(keys) else None
        return torch.arange(capacity, dtype=torch.int64, device=device)
    return perm


def searchsorted(a: torch.Tensor, v: torch.Tensor, side: str = "left"
                 ) -> torch.Tensor:
    """``np.searchsorted`` over a sorted 1-D tensor (int64 positions)."""
    return torch.searchsorted(a.contiguous(), v.to(a.dtype).contiguous(),
                              side=side)


def sort_key_transform(data: torch.Tensor, valid: Optional[torch.Tensor],
                       dtype: T.DataType, ascending: bool, nulls_first: bool
                       ) -> List[torch.Tensor]:
    """Turn one sort column into (null_rank, comparable_key) tensors.

    Dead rows are pushed to the very end by the caller's leading dead-key.
    Descending order flips integer bits (``~x``) / negates floats, the
    prefix trick of ``PrefixComparators.java``."""
    if data.dtype == torch.bool:
        data = data.to(torch.int8)
    if ascending:
        key = data
    elif data.dtype.is_floating_point:
        key = -data
    else:
        key = ~data
    if valid is None:
        null_rank = torch.zeros(data.shape[0], dtype=torch.int8,
                                device=data.device)
    else:
        # null_rank orders: nulls_first → nulls get -1 else +1
        rank_null = -1 if nulls_first else 1
        null_rank = torch.where(valid, 0, rank_null).to(torch.int8)
        ident = identity("min" if nulls_first else "max", key.dtype)
        key = torch.where(valid, key, torch.tensor(ident, dtype=key.dtype,
                                                   device=key.device))
    return [null_rank, key]


def sort_batch(batch: ColumnBatch,
               keys: Sequence[Tuple[Array, Optional[Array], T.DataType, bool, bool]],
               ) -> ColumnBatch:
    """Sort live rows by the given key specs; dead rows sink to the end.

    keys: (data, valid, dtype, ascending, nulls_first) per sort column.
    """
    dead = ~batch.row_valid_or_true()
    sort_cols: List[Array] = [dead.to(torch.int8)]
    for data, valid, dtype, asc, nf in keys:
        sort_cols += sort_key_transform(data, valid, dtype, asc, nf)
    perm = multi_key_argsort(sort_cols, batch.capacity)
    return take_batch(batch, perm)


def take_batch(batch: ColumnBatch, perm: torch.Tensor) -> ColumnBatch:
    """Gather all columns (and masks) through an index tensor; the output
    capacity is ``len(perm)``."""
    out_cap = int(perm.shape[0])
    vectors = []
    for v in batch.vectors:
        data = v.data[perm]
        valid = None if v.valid is None else v.valid[perm]
        vectors.append(ColumnVector(data, v.dtype, valid, v.dictionary))
    rv = None if batch.row_valid is None else batch.row_valid[perm]
    return ColumnBatch(batch.names, vectors, rv, out_cap)


def compact(batch: ColumnBatch) -> ColumnBatch:
    """Move live rows to the front, preserving order (one stable sort of
    the dead flag)."""
    if batch.row_valid is None:
        return batch
    perm = torch.sort((~batch.row_valid).to(torch.int8), stable=True).indices
    return take_batch(batch, perm)


# ---------------------------------------------------------------------------
# row-mask operators
# ---------------------------------------------------------------------------

def apply_filter(batch: ColumnBatch, pred: Expression) -> ColumnBatch:
    ctx = EvalContext(batch)
    v = pred.eval(ctx)
    keep = v.data
    if v.valid is not None:
        keep = keep & v.valid          # NULL predicate → drop (SQL WHERE)
    rv = batch.row_valid_or_true() & keep
    return ColumnBatch(batch.names, batch.vectors, rv, batch.capacity)


def apply_project(batch: ColumnBatch, exprs: Sequence[Expression]
                  ) -> ColumnBatch:
    ctx = EvalContext(batch)
    names, vectors = [], []
    schema = batch.schema
    for e in exprs:
        v = ctx.broadcast(e.eval(ctx))
        dt = e.data_type(schema)
        names.append(e.name)
        vectors.append(ColumnVector(v.data.to(dt.torch_dtype), dt, v.valid,
                                    v.dictionary))
    return ColumnBatch(names, vectors, batch.row_valid, batch.capacity)


def apply_limit(batch: ColumnBatch, n: int) -> ColumnBatch:
    rv = batch.row_valid_or_true()
    keep = torch.cumsum(rv.to(torch.int64), 0) <= n
    return ColumnBatch(batch.names, batch.vectors, rv & keep, batch.capacity)


# ---------------------------------------------------------------------------
# segment reductions
# ---------------------------------------------------------------------------

_SCATTER_KIND = {"min": "amin", "max": "amax"}


def _global_reduce(data: torch.Tensor, kind: str, capacity: int) -> torch.Tensor:
    """One-segment reduction: the whole (already contribute-masked)
    buffer collapses to slot 0; remaining slots hold the identity, as
    segment_reduce would leave them.  No sort, no scatter."""
    if capacity == 0:
        return torch.zeros(0, dtype=data.dtype, device=data.device)
    if kind == "sum":
        val = data.sum(dtype=data.dtype)
    elif kind == "min":
        val = data.min()
    else:
        val = data.max()
    rest = torch.full((capacity - 1,), identity(kind, data.dtype),
                      dtype=data.dtype, device=data.device)
    return torch.cat([val.reshape(1).to(data.dtype), rest])


def segment_reduce(data: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, kind: str) -> torch.Tensor:
    """out[s] = reduce(data[i] for seg_ids[i] == s); empty segments hold
    the reduction identity."""
    data = data.contiguous()
    if kind == "sum":
        out = torch.zeros(num_segments, dtype=data.dtype, device=data.device)
        return out.index_add_(0, seg_ids, data)
    out = torch.full((num_segments,), identity(kind, data.dtype),
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, seg_ids, data, _SCATTER_KIND[kind],
                               include_self=True)


# ---------------------------------------------------------------------------
# grouped aggregation
# ---------------------------------------------------------------------------

#: the MXU-form aggregation (bucket table + grouped-accumulate kernel).
#: None = auto: on for CUDA batches; tests set True/False explicitly.
MXU_AGG_ENABLED: "bool | None" = None


def _mxu_agg_on(device: torch.device) -> bool:
    if MXU_AGG_ENABLED is not None:
        return MXU_AGG_ENABLED
    return device.type == "cuda"


def grouped_aggregate(
    batch: ColumnBatch,
    key_exprs: Sequence[Expression],
    agg_slots: Sequence[Tuple[AggregateFunction, str]],
    bucket_cap: int = 4096,
) -> ColumnBatch:
    """GROUP BY keys with aggregate outputs; one batch in, one batch out.

    With keys, output capacity equals input capacity (worst case: every
    live row its own group) and ``row_valid`` marks real groups.  NULL is a
    group key value.  With no keys, the single global-aggregate row comes
    back as a capacity-1 batch.

    When keys are integral and their range fits ``bucket_cap`` buckets,
    aggregation takes the MXU form (``_mxu_grouped_aggregate``); otherwise,
    and whenever that form is off, the sort-based form.
    """
    if key_exprs and _mxu_agg_on(batch.device) \
            and _mxu_applicable(batch.schema, key_exprs, agg_slots):
        return _mxu_grouped_aggregate(batch, key_exprs, agg_slots,
                                      bucket_cap)
    return _sorted_grouped_aggregate(batch, key_exprs, agg_slots)


def _pad_to_one_row(batch: ColumnBatch) -> ColumnBatch:
    """A capacity-0 batch grown to one dead row."""
    dev = batch.device
    vectors = [ColumnVector(torch.zeros(1, dtype=v.data.dtype, device=dev),
                            v.dtype,
                            None if v.valid is None
                            else torch.zeros(1, dtype=torch.bool, device=dev),
                            v.dictionary) for v in batch.vectors]
    return ColumnBatch(batch.names, vectors,
                       torch.zeros(1, dtype=torch.bool, device=dev), 1)


def _segment_starts(sorted_cols: Sequence[torch.Tensor], live_s: torch.Tensor,
                    capacity: int) -> torch.Tensor:
    """Rows whose sort key differs from the previous row's (live only)."""
    change = torch.zeros(capacity, dtype=torch.bool, device=live_s.device)
    for c in sorted_cols:
        shifted = torch.cat([c[:1], c[:-1]])
        change = change | (c != shifted)
    if capacity:
        change[0] = True
    return change & live_s


def _sorted_grouped_aggregate(
    batch: ColumnBatch,
    key_exprs: Sequence[Expression],
    agg_slots: Sequence[Tuple[AggregateFunction, str]],
) -> ColumnBatch:
    """Sort-based grouping: multi-key sort → segment boundaries → segment
    reduce (the general path)."""
    if not key_exprs and batch.capacity == 0:
        # the global row exists even over an empty input (COUNT=0, SUM
        # NULL); one all-dead row lets the ordinary machinery produce it
        batch = _pad_to_one_row(batch)
    ctx = EvalContext(batch)
    capacity = batch.capacity
    dev = batch.device
    live = batch.row_valid_or_true()
    schema = batch.schema

    # ---- evaluate keys and build the composite sort key -----------------
    key_vals: List[ExprValue] = [ctx.broadcast(k.eval(ctx)) for k in key_exprs]
    sort_cols: List[Array] = [(~live).to(torch.int8)]
    for v in key_vals:
        data = v.data
        if data.dtype == torch.bool:
            data = data.to(torch.int8)
        if v.valid is None:
            sort_cols += [torch.zeros(capacity, dtype=torch.int8, device=dev),
                          data]
        else:
            # NULL forms its own group; rank it before all values
            sort_cols += [torch.where(v.valid, 0, -1).to(torch.int8),
                          torch.where(v.valid, data,
                                      torch.zeros((), dtype=data.dtype,
                                                  device=dev))]
    # keyless (global) aggregation needs NO sort: every buffer reduces
    # over one segment, and the reductions are order-independent
    perm = multi_key_argsort(sort_cols, capacity) if key_exprs else None

    # ---- segment boundaries --------------------------------------------
    if key_exprs:
        live_s = live[perm]
        is_start = _segment_starts([c[perm] for c in sort_cols], live_s,
                                   capacity)
        seg_ids = torch.cumsum(is_start.to(torch.int64), 0) - 1
        # dead rows sort last, at positions >= the live-row count >= the
        # group count, and carry every buffer's identity: each goes to its
        # own position, never a live group's slot.  One shared spill slot
        # (the JAX package's capacity - 1) would serialize an atomic per
        # dead row on the card; the output bits are the same.
        seg_ids = torch.where(live_s, seg_ids,
                              torch.arange(capacity, device=dev))
        num_groups = is_start.sum(dtype=torch.int64)
    else:
        seg_ids = torch.zeros(capacity, dtype=torch.int64, device=dev)
        is_start = None

    out_names: List[str] = []
    out_vectors: List[ColumnVector] = []

    # key output columns: value at each segment start scattered to group slot
    for k, v in zip(key_exprs, key_vals):
        dt = k.data_type(schema)
        data_s = v.data[perm]
        valid_s = None if v.valid is None else v.valid[perm]
        kdata = _scatter_starts(data_s, seg_ids, is_start, capacity)
        kvalid = None if valid_s is None else _scatter_starts(
            valid_s, seg_ids, is_start, capacity)
        out_names.append(k.name)
        out_vectors.append(ColumnVector(kdata.to(dt.torch_dtype), dt, kvalid,
                                        v.dictionary))

    for func, name in agg_slots:
        specs = func.make_buffers(ctx, live)
        if perm is None:
            reduced = [_global_reduce(s.data, s.kind, capacity) for s in specs]
        else:
            reduced = [segment_reduce(s.data[perm], seg_ids, capacity, s.kind)
                       for s in specs]
        dt = func.data_type(schema)
        if isinstance(func, First):
            # arg-reduced row index (pre-sort coordinates) → gather the value
            v = ctx.broadcast(func.children[0].eval(ctx))
            idx = reduced[0].clamp(0, capacity - 1)
            data = v.data[idx]
            got = (reduced[0] >= 0) & (reduced[0] < (1 << 62))
            valid = got if v.valid is None else (got & v.valid[idx])
            out = ExprValue(data, valid, v.dictionary)
        else:
            out = func.finish(reduced)
        dictionary = out.dictionary if out.dictionary is not None \
            else func.output_dictionary(ctx)
        out_names.append(name)
        out_vectors.append(ColumnVector(out.data.to(dt.torch_dtype), dt,
                                        out.valid, dictionary))

    if key_exprs:
        group_pos = torch.arange(capacity, dtype=torch.int64, device=dev)
        return ColumnBatch(out_names, out_vectors, group_pos < num_groups,
                           capacity)
    # keyless (global) aggregation: exactly ONE row, capacity 1
    out_vectors = [
        ColumnVector(v.data[:1], v.dtype,
                     None if v.valid is None else v.valid[:1], v.dictionary)
        for v in out_vectors
    ]
    return ColumnBatch(out_names, out_vectors, None, 1)


def _scatter_starts(sorted_data: torch.Tensor, seg_ids: torch.Tensor,
                    is_start: torch.Tensor, capacity: int) -> torch.Tensor:
    """out[g] = sorted_data[first row of segment g]; each non-start row
    lands in its own spill slot past the end, sliced away (one shared
    spill slot would serialize their stores on the card)."""
    n = sorted_data.shape[0]
    target = torch.where(is_start, seg_ids,
                         capacity + torch.arange(n, device=seg_ids.device))
    out = torch.zeros(capacity + n, dtype=sorted_data.dtype,
                      device=sorted_data.device)
    return out.index_put_((target,), sorted_data)[:capacity]


# ---------------------------------------------------------------------------
# MXU-form grouped aggregation (bucket table + grouped accumulate)
# ---------------------------------------------------------------------------
#
#     sums[b, p] = Σ_rows  [bucket[row] == b] · plane[row, p]
#
# where the planes are 8-bit limbs of the (offset-shifted) values plus
# count masks.  The grouped accumulate is exact (integer atomics), limb
# recombination is mod-2^64 two's complement — so integer sums are
# BIT-EXACT, overflow wraparound included, like Java long arithmetic.
# Buckets come from composite key codes (key - min, mixed radix over
# multiple keys, NULL = slot 0).  A host check that the key ranges fit the
# bucket capacity picks this form or the sort-based one.

def _integral_key(dt: T.DataType) -> bool:
    return (dt.is_integral or isinstance(dt, (T.BooleanType, T.DateType,
                                              T.TimestampType, T.DecimalType))
            or dt.is_string)  # strings group by dictionary code


def _mxu_applicable(schema: T.StructType, key_exprs, agg_slots) -> bool:
    from .aggregates import Avg, Count, CountStar, Sum
    try:
        for k in key_exprs:
            if not _integral_key(k.data_type(schema)):
                return False
        for f, _ in agg_slots:
            if getattr(f, "is_distinct", False):
                return False
            if isinstance(f, (Count, CountStar)):
                continue
            if isinstance(f, (Sum, Avg)):
                src = f.children[0].data_type(schema)
                if src.is_integral or isinstance(src, (T.BooleanType,
                                                       T.DecimalType)):
                    continue
                return False
            return False
    except Exception:
        return False
    return True


def _limb_plan(dtype: torch.dtype) -> Tuple[int, int]:
    """(n_limbs, offset) for a value dtype: offset shifts the value into
    [0, 2^(8·n_limbs)) so limbs are unsigned.  int64 takes the full width:
    its offset 2^63 is a flip of the sign bit, which in wrapping int64
    arithmetic is the value ``INT64_MIN``."""
    nbytes = torch.tensor([], dtype=dtype).element_size()
    if nbytes == 8:
        return 8, _I64_MIN
    return nbytes, 1 << (nbytes * 8 - 1)


def _mxu_grouped_aggregate(batch, key_exprs, agg_slots, bucket_cap):
    from .aggregates import Avg, Count, CountStar

    ctx = EvalContext(batch)
    capacity = batch.capacity
    dev = batch.device
    live = batch.row_valid_or_true().expand(capacity)
    schema = batch.schema
    B = int(min(bucket_cap, capacity))

    # ---- composite bucket codes (mixed radix over keys, NULL = 0) -------
    key_vals: List[ExprValue] = [ctx.broadcast(k.eval(ctx)) for k in key_exprs]
    key_dts = [k.data_type(schema) for k in key_exprs]
    codes = []          # per key: (code int32, radix int32, kmin int64, nullable)
    prod = torch.ones((), dtype=torch.float64, device=dev)  # overflow-safe fit check
    i64_max = torch.tensor(_I64_MAX, dtype=torch.int64, device=dev)
    i64_min = torch.tensor(_I64_MIN, dtype=torch.int64, device=dev)
    for v in key_vals:
        d64 = v.data.to(torch.int64)
        mask = live if v.valid is None else (live & v.valid)
        kmin = torch.where(mask, d64, i64_max).min()
        kmax = torch.where(mask, d64, i64_min).max()
        # the range estimate is float64 (int64 spans can exceed any integer
        # arithmetic); it is trusted only when `fits` proves it small
        rangef = torch.clamp(kmax.to(torch.float64) - kmin.to(torch.float64)
                             + 1.0, min=0.0)
        r32 = torch.clamp(rangef, 0.0, float(B + 2)).to(torch.int32)
        diff = (d64 - kmin).to(torch.int32)    # wraps; exact iff fits
        nullable = v.valid is not None
        if nullable:
            code = torch.where(mask, diff + 1, 0).to(torch.int32)
            r32 = r32 + 1
            prod = prod * (rangef + 1.0)
        else:
            code = diff
            r32 = torch.clamp(r32, min=1)
            prod = prod * torch.clamp(rangef, min=1.0)
        codes.append((code, r32, kmin, nullable))

    bucket = torch.zeros(capacity, dtype=torch.int32, device=dev)
    for code, r32, _, _ in codes:
        bucket = bucket * r32 + code   # wraps only when the ranges do not fit
    if not bool(prod <= B):            # one host sync picks the form
        return _sorted_fallback(batch, key_exprs, key_vals, key_dts,
                                agg_slots, ctx)
    bucket32 = torch.clamp(bucket, 0, B - 1)

    # ---- planes: 0 = live count; per Sum/Avg the value's limbs + its own
    # count; per Count its count.  uint8, every value in {0..255} --------
    planes: List[torch.Tensor] = [live.to(torch.uint8)]
    plane_info = []  # (func, kind, first_plane, offset, n_limbs)
    for func, _name in agg_slots:
        if isinstance(func, CountStar):
            plane_info.append((func, "countstar", None, 0, 0))
            continue
        v = ctx.broadcast(func.children[0].eval(ctx))
        m = live if v.valid is None else (live & v.valid)
        if isinstance(func, Count):
            plane_info.append((func, "count", len(planes), 0, 0))
            planes.append(m.to(torch.uint8))
            continue
        data = v.data.to(torch.int8) if v.data.dtype == torch.bool else v.data
        n_limbs, offset = _limb_plan(data.dtype)
        # wrapping int64: +2^63 flips the sign bit; narrower offsets do not
        # overflow.  The 0xFF mask makes the arithmetic shift harmless.
        x = data.to(torch.int64)
        x = x ^ offset if n_limbs == 8 else x + offset
        plane_info.append((func, "sum", len(planes), offset, n_limbs))
        for i in range(n_limbs):
            limb = torch.where(m, (x >> (8 * i)) & 0xFF, 0)
            planes.append(limb.to(torch.uint8))
        planes.append(m.to(torch.uint8))
    plane_mat = torch.stack(planes, dim=1)               # (N, P) uint8
    n_active = cuda_agg.n_active_chunks(prod, B)
    tot = cuda_agg.grouped_accumulate(bucket32, plane_mat, n_active, B)
    live_count = tot[:, 0]
    grow = live_count > 0                                # real groups

    out_datas: List[torch.Tensor] = []
    out_valids: List[torch.Tensor] = []
    # decode keys from the bucket index (mixed radix, most-significant first)
    rem = torch.arange(B, dtype=torch.int64, device=dev)
    strides = []
    s = torch.ones((), dtype=torch.int64, device=dev)
    for _, r, _, _ in reversed(codes):
        strides.append(s)
        s = s * r.to(torch.int64)
    strides.reverse()
    for (_code, r, kmin, nullable), stride, dt in zip(codes, strides, key_dts):
        digit = torch.div(rem, stride, rounding_mode="floor") \
            % torch.clamp(r, min=1).to(torch.int64)
        if nullable:
            kdata = kmin + digit - 1
            kvalid = grow & (digit > 0)
        else:
            kdata = kmin + digit
            kvalid = grow
        out_datas.append(kdata.to(dt.torch_dtype))
        out_valids.append(kvalid)

    for func, kind, start, offset, n_limbs in plane_info:
        if kind == "countstar":
            out_datas.append(live_count)
            out_valids.append(grow)
            continue
        if kind == "count":
            out_datas.append(tot[:, start])
            out_valids.append(grow)
            continue
        cnt = tot[:, start + n_limbs]
        acc = torch.zeros(B, dtype=torch.int64, device=dev)
        for i in range(n_limbs):
            acc = acc + (tot[:, start + i] << (8 * i))
        total = acc - cnt * offset                       # mod 2^64
        if isinstance(func, Avg):
            src = func.children[0].data_type(schema)
            f = total.to(torch.float64)
            if isinstance(src, T.DecimalType):
                f = f / (10 ** src.scale)
            safe = torch.where(cnt > 0, cnt, 1)
            out_datas.append(f / safe)
        else:
            out_datas.append(total.to(func.data_type(schema).torch_dtype))
        out_valids.append(grow & (cnt > 0))

    def pad(a):
        if B == capacity:
            return a
        return torch.cat([a, torch.zeros(capacity - B, dtype=a.dtype,
                                         device=dev)])

    return _assemble(key_exprs, key_vals, key_dts, agg_slots, ctx, schema,
                     [pad(d) for d in out_datas], [pad(v) for v in out_valids],
                     pad(grow), capacity)


def _sorted_fallback(batch, key_exprs, key_vals, key_dts, agg_slots, ctx):
    """The sort-based form, shaped as the MXU form's output (every column
    carries an explicit validity mask)."""
    capacity = batch.capacity
    cb = _sorted_grouped_aggregate(batch, key_exprs, agg_slots)
    datas = [v.data for v in cb.vectors]
    valids = [v.valid if v.valid is not None
              else torch.ones(capacity, dtype=torch.bool, device=batch.device)
              for v in cb.vectors]
    return _assemble(key_exprs, key_vals, key_dts, agg_slots, ctx,
                     batch.schema, datas, valids, cb.row_valid_or_true(),
                     capacity)


def _assemble(key_exprs, key_vals, key_dts, agg_slots, ctx, schema, datas,
              valids, row_valid, capacity) -> ColumnBatch:
    out_names: List[str] = []
    out_vectors: List[ColumnVector] = []
    i = 0
    for k, v, dt in zip(key_exprs, key_vals, key_dts):
        out_names.append(k.name)
        out_vectors.append(ColumnVector(datas[i], dt, valids[i], v.dictionary))
        i += 1
    for func, name in agg_slots:
        out_names.append(name)
        out_vectors.append(ColumnVector(datas[i], func.data_type(schema),
                                        valids[i], func.output_dictionary(ctx)))
        i += 1
    return ColumnBatch(out_names, out_vectors, row_valid, capacity)


def distinct(batch: ColumnBatch) -> ColumnBatch:
    """Deduplicate live rows (group by all columns)."""
    return grouped_aggregate(batch, [Col(n) for n in batch.names], [])
