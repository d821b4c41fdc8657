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
  depend on capacities, never on data;
* the cross-process exchange's map side buckets rows by destination on
  the card (``range_bucket``, ``partition_bucket``) and reads the live
  rows back in one packed copy (``partition_host_slices``); receivers
  are carved out of the host batch as views (``host_slice``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from . import cuda_agg
from . import types as T
from .capture import constant, decide
from .aggregates import AggregateFunction, First, identity
from .columnar import (ColumnBatch, ColumnVector, PlaneColumnVector,
                       bump_run_aware, unexpanded_plane, unmaterialized_runs)
from .expressions import (Col, EvalContext, Expression, ExprValue, Rand,
                          RowIndex, SparkPartitionId)

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
        key = torch.where(valid, key, constant(ident, key.device, key.dtype))
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
# run tables (``columnar.RunColumnVector`` / ``PlaneColumnVector``)
# ---------------------------------------------------------------------------

def rle_expand(run_values: torch.Tensor, run_lengths: torch.Tensor
               ) -> torch.Tensor:
    """A run table expanded to its dense tensor.  Its length is read from
    the lengths, so this is for host tables; inside a stage use
    ``run_expand``, whose length is the plane's capacity."""
    n = int(run_lengths.sum())
    return torch.repeat_interleave(run_values, run_lengths.to(torch.int64),
                                   output_size=n)


def run_row_ids(plane_lengths: torch.Tensor, capacity: int) -> torch.Tensor:
    """Row → run-slot map of a fixed-capacity run plane: the inclusive
    cumulative sum of the zero-padded lengths gives the run ends, and each
    row position is searched right of its end; zero-length (padding)
    slots repeat an end, which the right-side search skips, so every row
    lands on a real run.  Shapes depend on the capacity alone: no sync,
    capturable."""
    lengths = plane_lengths.to(torch.int64)
    ends = torch.cumsum(lengths, 0)
    rows = torch.arange(capacity, dtype=torch.int64, device=lengths.device)
    ids = torch.searchsorted(ends, rows, right=True)
    # rows past sum(lengths) (no well-formed plane has them) clamp into
    # range rather than index out of bounds
    return ids.clamp_(0, max(int(plane_lengths.shape[0]) - 1, 0))


def run_expand(plane_values: torch.Tensor, plane_lengths: torch.Tensor,
               capacity: int) -> torch.Tensor:
    """A run plane expanded to its ``capacity`` dense rows by a gather
    through ``run_row_ids``."""
    return plane_values[run_row_ids(plane_lengths, capacity)]


#: expressions whose value depends on the row's POSITION: a run head
#: cannot stand for its run under them
_POSITIONAL_EXPRS = (Rand, RowIndex, SparkPartitionId)


def _single_ref_run_pred(batch: ColumnBatch, pred: Expression, find):
    """The (name, run vector) a run-granularity filter may evaluate
    ``pred`` over: exactly one referenced column, an untouched run form
    (``find``) with no NULLs covering the batch, and no positional
    expression; else None."""
    refs = pred.references()
    if len(refs) != 1:
        return None
    name = next(iter(refs))
    if name not in batch.names:
        return None
    rv = find(batch.column(name))
    if rv is None or rv.valid is not None or rv.capacity != batch.capacity:
        return None
    stack = [pred]
    while stack:
        e = stack.pop()
        if isinstance(e, _POSITIONAL_EXPRS):
            return None
        stack.extend(e.children)
    return name, rv


def _head_keep(name: str, vec: ColumnVector, n: int,
               pred: Expression) -> torch.Tensor:
    """``pred`` evaluated once per run head: a boolean per run slot."""
    head = ColumnBatch([name], [vec], None, n)
    v = pred.eval(EvalContext(head))
    keep = torch.broadcast_to(v.data, (n,))
    if v.valid is not None:
        keep = keep & torch.broadcast_to(v.valid, (n,))
    return keep.to(torch.bool)


def _run_aware_filter(batch: ColumnBatch,
                      pred: Expression) -> Optional[ColumnBatch]:
    """A filter over a host run vector: the predicate once per run head,
    the keep mask repeated by run length (``spark_tpu/kernels.py``
    ``_run_aware_filter``).  None falls back to the dense path."""
    found = _single_ref_run_pred(batch, pred, unmaterialized_runs)
    if found is None:
        return None
    name, rv = found
    n_runs = int(rv.run_values.shape[0])
    keep = _head_keep(name, ColumnVector(rv.run_values, rv.dtype, None,
                                         rv.dictionary), n_runs, pred)
    keep = torch.repeat_interleave(keep, rv.run_lengths,
                                   output_size=rv.capacity)
    bump_run_aware(batch.capacity)
    out_rv = batch.row_valid_or_true() & keep
    return ColumnBatch(batch.names, batch.vectors, out_rv, batch.capacity)


def _plane_filter(batch: ColumnBatch,
                  pred: Expression) -> Optional[ColumnBatch]:
    """The stage form of ``_run_aware_filter`` over a run plane: the
    predicate once per plane slot, only the boolean keep mask expanded
    through ``run_row_ids``; the data column never expands
    (``spark_tpu/kernels.py`` ``_plane_filter``)."""
    found = _single_ref_run_pred(batch, pred, unexpanded_plane)
    if found is None:
        return None
    name, pv = found
    keep = _head_keep(name, ColumnVector(pv.plane_values, pv.dtype, None,
                                         pv.dictionary),
                      pv.plane_capacity, pred)
    keep_rows = keep[run_row_ids(pv.plane_lengths, batch.capacity)]
    out_rv = batch.row_valid_or_true() & keep_rows
    return ColumnBatch(batch.names, batch.vectors, out_rv, batch.capacity)


# ---------------------------------------------------------------------------
# row-mask operators
# ---------------------------------------------------------------------------

def apply_filter(batch: ColumnBatch, pred: Expression,
                 row_offset: int = 0) -> ColumnBatch:
    if row_offset == 0:
        out = _run_aware_filter(batch, pred)
        if out is not None:
            return out
    # no row_offset gate: the offset feeds positional expressions only,
    # which _plane_filter refuses
    out = _plane_filter(batch, pred)
    if out is not None:
        return out
    ctx = EvalContext(batch, row_offset)
    v = pred.eval(ctx)
    keep = v.data
    if v.valid is not None:
        keep = keep & v.valid          # NULL predicate → drop (SQL WHERE)
    rv = batch.row_valid_or_true() & keep
    return ColumnBatch(batch.names, batch.vectors, rv, batch.capacity)


def apply_project(batch: ColumnBatch, exprs: Sequence[Expression],
                  row_offset: int = 0) -> ColumnBatch:
    ctx = EvalContext(batch, row_offset)
    names, vectors = [], []
    schema = batch.schema
    for e in exprs:
        if isinstance(e, Col) and e._name in batch.names:
            # a bare column keeps its run form (plane or host run table):
            # evaluating it would expand it
            src = batch.column(e._name)
            if (unexpanded_plane(src) is not None
                    or unmaterialized_runs(src) is not None) \
                    and src.dtype.np_dtype == e.data_type(schema).np_dtype:
                names.append(e.name)
                vectors.append(src)
                continue
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
        if data.dtype.is_floating_point:
            # a float sum whose bits depend only on the segment's values in
            # their order, never on where the segment lies or on the timing
            # of atomics (index_add_ on a card): two groups of the same
            # rows sum to the same double, as in a sequential engine (a
            # ROLLUP level and its only child must tie: TPC-DS q67's rank)
            return out.index_put_((seg_ids,), data, accumulate=True)
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
    if not key_exprs:
        out = _run_aware_global_aggregate(batch, agg_slots)
        if out is None:
            out = _plane_global_aggregate(batch, agg_slots)
        if out is not None:
            return out
    return _sorted_grouped_aggregate(batch, key_exprs, agg_slots)


def _run_slots(batch: ColumnBatch, agg_slots, kinds, find, int_sums: bool):
    """Per slot ``(func, name, run form or None)`` when every slot is a
    non-distinct count(*) or one of ``kinds`` over a bare column whose
    vector is a run form (``find``) with no NULLs covering the batch, sums
    over integers only (integer products and sums wrap alike; float
    addition does not associate); else None."""
    from .aggregates import CountStar, Sum
    plans = []
    for func, name in agg_slots:
        if getattr(func, "is_distinct", False):
            return None
        if isinstance(func, CountStar):
            plans.append((func, name, None))
            continue
        if type(func) not in kinds:
            return None
        child = func.children[0]
        if not isinstance(child, Col) or child._name not in batch.names:
            return None
        rv = find(batch.column(child._name))
        if rv is None or rv.valid is not None \
                or rv.capacity != batch.capacity:
            return None
        if int_sums and isinstance(func, Sum) \
                and rv.dtype.torch_dtype.is_floating_point:
            return None
        plans.append((func, name, rv))
    if all(rv is None for _f, _n, rv in plans):
        return None           # nothing run-coded: nothing to claim
    return plans


def _run_aware_global_aggregate(batch: ColumnBatch, agg_slots
                                ) -> Optional[ColumnBatch]:
    """Keyless count/sum over host run vectors without expansion: a run
    contributes ``value x length`` in one multiply (``spark_tpu/
    kernels.py`` ``_run_aware_global_aggregate``).  Only over a fully live
    batch; None falls back to the general path."""
    from .aggregates import Count, CountStar, Sum
    if batch.row_valid is not None or batch.capacity == 0 or not agg_slots:
        return None
    plans = _run_slots(batch, agg_slots, (Count, Sum), unmaterialized_runs,
                       True)
    if plans is None:
        return None
    cap = batch.capacity
    schema = batch.schema
    names: List[str] = []
    vectors: List[ColumnVector] = []
    for func, name, rv in plans:
        dt = func.data_type(schema)
        tdt = dt.torch_dtype
        if rv is None or isinstance(func, (CountStar, Count)):
            # no NULLs and no dead rows: the count is the capacity
            out = ColumnVector(torch.full((1,), cap, dtype=tdt), dt, None,
                               None)
        else:
            total = (rv.run_values.to(tdt) * rv.run_lengths.to(tdt)).sum(
                dtype=tdt)
            out = ColumnVector(total.reshape(1), dt,
                               torch.ones(1, dtype=torch.bool), None)
        names.append(name)
        vectors.append(out)
    bump_run_aware(cap)
    return ColumnBatch(names, vectors, None, 1)


def _plane_global_aggregate(batch: ColumnBatch, agg_slots
                            ) -> Optional[ColumnBatch]:
    """The stage form over run planes, with min/max and a row mask:
    count/sum reduce ``plane values x live rows per run`` (one
    ``segment_reduce`` of the row mask over ``run_row_ids``), min/max
    reduce the run values under a per-run any-live mask; no arithmetic on
    expanded rows (``spark_tpu/kernels.py`` ``_plane_global_aggregate``).
    None falls back (the plane then expands, counted)."""
    from .aggregates import Count, CountStar, Max, Min, Sum
    if batch.capacity == 0 or not agg_slots:
        return None
    plans = _run_slots(batch, agg_slots, (Count, Sum, Min, Max),
                       unexpanded_plane, True)
    if plans is None:
        return None
    cap = batch.capacity
    dev = batch.device
    live = batch.row_valid      # row masks are dense, never planes
    n_live = torch.full((1,), cap, dtype=torch.int64, device=dev) \
        if live is None else live.sum(dtype=torch.int64).reshape(1)
    counts: dict = {}

    def run_live_counts(pv: PlaneColumnVector) -> torch.Tensor:
        """Live rows per run slot (zero on padding slots)."""
        if id(pv) not in counts:
            if live is None:
                c = pv.plane_lengths.to(torch.int64)
            else:
                ids = run_row_ids(pv.plane_lengths, cap)
                c = segment_reduce(live.to(torch.int64), ids,
                                   pv.plane_capacity, "sum")
            counts[id(pv)] = c
        return counts[id(pv)]

    schema = batch.schema
    names: List[str] = []
    vectors: List[ColumnVector] = []
    for func, name, pv in plans:
        dt = func.data_type(schema)
        tdt = dt.torch_dtype
        if pv is None or isinstance(func, (CountStar, Count)):
            out = ColumnVector(n_live.to(tdt), dt, None, None)
        elif isinstance(func, Sum):
            total = (pv.plane_values.to(tdt)
                     * run_live_counts(pv).to(tdt)).sum(dtype=tdt)
            out = ColumnVector(total.reshape(1), dt, n_live > 0, None)
        else:                                   # min / max
            red = torch.int8 if tdt == torch.bool else tdt
            ident = identity(func.kind, red)
            buf = torch.where(run_live_counts(pv) > 0,
                              pv.plane_values.to(red),
                              torch.full((), ident, dtype=red, device=dev))
            val = buf.min() if func.kind == "min" else buf.max()
            out = ColumnVector(val.reshape(1).to(tdt), dt, n_live > 0,
                               pv.dictionary)
        names.append(name)
        vectors.append(out)
    return ColumnBatch(names, vectors, None, 1)


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
    # a fill, not a store of a host value: no host-to-device copy
    change[:1].fill_(True)
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

    # every percentile slot over one child shares ONE value sort
    pct_results = {}
    by_child = {}
    for f, n in agg_slots:
        if getattr(f, "is_percentile", False):
            by_child.setdefault(repr(f.children[0]), []).append((f, n))
    for group in by_child.values():
        pct_results.update(_percentile_groups(ctx, group, sort_cols, live,
                                              capacity))

    for func, name in agg_slots:
        if name in pct_results:
            out_names.append(name)
            out_vectors.append(pct_results[name])
            continue
        if getattr(func, "is_collect", False):
            out_names.append(name)
            out_vectors.append(_collect_into_arrays(
                ctx, func, perm, sort_cols, seg_ids, is_start, live,
                capacity))
            continue
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


def _percentile_groups(ctx: EvalContext, slots, sort_cols: Sequence[Array],
                       live: torch.Tensor, capacity: int) -> dict:
    """Exact nearest-rank percentiles per group for every slot over one
    child, from ONE value sort: re-sort by (group keys, value) so each
    group's values are in order, then take the row whose position among
    its group's non-null values is floor(p * (n_valid - 1)).  Returns
    {slot name: ColumnVector}."""
    func = slots[0][0]
    v = ctx.broadcast(func.children[0].eval(ctx))
    vdata = v.data.to(torch.int8) if v.data.dtype == torch.bool else v.data
    dev = vdata.device
    keep = live if v.valid is None else (live & v.valid)
    # NULL and dead values sort to the end of their group
    ident = constant(identity("max", vdata.dtype), dev, vdata.dtype)
    vkey = torch.where(keep, vdata, ident)
    vnull = (~keep).to(torch.int8)
    perm = multi_key_argsort(list(sort_cols) + [vnull, vkey], capacity)
    live_s, keep_s = live[perm], keep[perm]
    is_start = _segment_starts([c[perm] for c in sort_cols], live_s, capacity)
    seg_ids = torch.cumsum(is_start.to(torch.int64), 0) - 1
    # dead rows sort last: each to its own slot past the groups (as in
    # _sorted_grouped_aggregate), never a live group's
    seg_ids = torch.where(live_s, seg_ids,
                          torch.arange(capacity, device=dev))
    keep64 = keep_s.to(torch.int64)
    n_valid = segment_reduce(keep64, seg_ids, capacity, "sum")
    ck = torch.cumsum(keep64, 0)
    far = constant(1 << 62, dev, torch.int64)
    seg_base = segment_reduce(torch.where(keep_s, ck - 1, far), seg_ids,
                              capacity, "min")
    pos = ck - 1 - seg_base[seg_ids]
    got = n_valid > 0
    vdata_s = vdata[perm]
    out = {}
    for f, name in slots:
        target = torch.floor(f.percentage * (n_valid - 1).to(torch.float64)
                             ).to(torch.int64)
        win = keep_s & (pos == target[seg_ids])
        # a max over exactly one winner is the gather; empty groups NULL
        red = segment_reduce(torch.where(win, vdata_s, ident), seg_ids,
                             capacity, "max")
        dt = f.data_type(ctx.batch.schema)
        out[name] = ColumnVector(red.to(dt.torch_dtype), dt, got,
                                 v.dictionary)
    return out


def _collect_into_arrays(ctx: EvalContext, func, perm, sort_cols,
                         seg_ids: torch.Tensor, is_start, live: torch.Tensor,
                         capacity: int) -> ColumnVector:
    """collect_list / collect_set inside the sort-based grouped aggregate:
    each group's kept values (non-null; for a set, the first of each run
    of equal values) scattered into a ``(groups, max_len)`` plane — the
    group's slot is the row, the value's position among its group's kept
    values the column.  Every other value (dead, NULL, a duplicate, past
    ``max_len``) goes to a spill slot of its own past the plane, so every
    store has its own address and the kept slots are deterministic."""
    from . import config as C
    dt = func.data_type(ctx.batch.schema)
    et = dt.element_type
    lmax = func.max_len or C.COLLECT_MAX_LEN.default
    dev = ctx.device
    v = ctx.broadcast(func.children[0].eval(ctx))
    rows = torch.arange(capacity, dtype=torch.int64, device=dev)
    if perm is None:                     # one global group, in row order
        perm, live_s = rows, live
    else:
        live_s = live[perm]
    if func.distinct_elements:
        # sort the values inside their groups so equal values are adjacent
        # and the first of each run stands for the run
        vdata = v.data.to(torch.int8) if v.data.dtype == torch.bool \
            else v.data
        vnull = torch.zeros(capacity, dtype=torch.int8, device=dev) \
            if v.valid is None else (~v.valid).to(torch.int8)
        perm = multi_key_argsort(list(sort_cols) + [vnull, vdata], capacity)
        live_s = live[perm]
        if is_start is not None:
            is_start = _segment_starts([c[perm] for c in sort_cols], live_s,
                                       capacity)
            seg_ids = torch.cumsum(is_start.to(torch.int64), 0) - 1
            seg_ids = torch.where(live_s, seg_ids, rows)
    value_s = v.data[perm]
    keep = live_s if v.valid is None else live_s & v.valid[perm]
    if func.distinct_elements:
        prev_v = torch.cat([value_s[:1], value_s[:-1]])
        prev_seg = torch.cat([seg_ids[:1] - 1, seg_ids[:-1]])
        keep = keep & ((value_s != prev_v) | (seg_ids != prev_seg))
    # position among the kept rows of the same group
    ck = torch.cumsum(keep.to(torch.int64), 0)
    far = constant(1 << 62, dev, torch.int64)
    seg_base = segment_reduce(torch.where(keep, ck - 1, far), seg_ids,
                              capacity, "min")
    pos = ck - 1 - seg_base[seg_ids]
    ok = keep & (pos >= 0) & (pos < lmax)
    target = torch.where(ok, seg_ids * lmax + pos.clamp(0, lmax - 1),
                         capacity * lmax + rows)
    out = torch.full((capacity * lmax + capacity,),
                     dt.element_sentinel().item(), dtype=et.torch_dtype,
                     device=dev)
    out.index_put_((target,), value_s.to(et.torch_dtype))
    return ColumnVector(out[:capacity * lmax].view(capacity, lmax), dt, None,
                        v.dictionary)


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
    nbytes = torch.empty(0, dtype=dtype).element_size()
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
    i64_max = constant(_I64_MAX, dev, torch.int64)
    i64_min = constant(_I64_MIN, dev, torch.int64)
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
    # one host decision picks the form: a sync on the eager lane, a
    # recorded answer guarded on the device under a stage capture
    if not decide(prod <= B):
        return _sorted_fallback(batch, key_exprs, key_vals, key_dts,
                                agg_slots, ctx)
    bucket32 = torch.clamp(bucket, 0, B - 1)

    # ---- planes: 0 = live count; per Sum/Avg the value's limbs + its own
    # count; per Count its count.  Described, not built: the kernel makes
    # each plane's byte from these columns as it reads them -------------
    row_mask = batch.row_valid                 # None: every row is live
    if row_mask is not None:
        row_mask = row_mask.expand(capacity).contiguous()
    planes: List[cuda_agg.Plane] = [cuda_agg.Plane(row_mask)]
    plane_info = []  # (func, kind, first_plane, offset, n_limbs)
    for func, _name in agg_slots:
        if isinstance(func, CountStar):
            plane_info.append((func, "countstar", None, 0, 0))
            continue
        v = ctx.broadcast(func.children[0].eval(ctx))
        m = row_mask if v.valid is None else (live & v.valid).contiguous()
        if isinstance(func, Count):
            plane_info.append((func, "count", len(planes), 0, 0))
            planes.append(cuda_agg.Plane(m))
            continue
        data = v.data.contiguous()
        # bool sums as int8; +2^63 on int64 is a flip of the sign bit
        n_limbs, offset = _limb_plan(
            torch.int8 if data.dtype == torch.bool else data.dtype)
        plane_info.append((func, "sum", len(planes), offset, n_limbs))
        planes.extend(cuda_agg.Plane(m, data, i, offset)
                      for i in range(n_limbs))
        planes.append(cuda_agg.Plane(m))
    n_active = cuda_agg.n_active_chunks(prod, B)
    tot = cuda_agg.grouped_accumulate_columns(bucket32, planes, n_active, B)
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


# ---------------------------------------------------------------------------
# cross-process exchange bucketing (parallel/crossproc.py)
# ---------------------------------------------------------------------------

def unsigned_mod(h: torch.Tensor, n: int) -> torch.Tensor:
    """``h`` read as uint64, modulo ``n`` (int64 result): the JAX
    package's ``h.astype(np.uint64) % np.uint64(n)`` in int64 arithmetic.
    A negative ``h`` stands for ``h + 2**64``, whose residue is
    ``(h mod n + 2**64 mod n) mod n``."""
    r = torch.remainder(h, n)
    wrap = (1 << 64) % n
    if wrap:
        r = torch.where(h < 0, torch.remainder(r + wrap, n), r)
    return r


def range_bucket(keys: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """Span id of each orderable int64 key against shared cut points
    (``spark_tpu/kernels.py`` ``range_bucket``): the number of cuts <= the
    key (``side="right"``), so every duplicate of a value lands in ONE
    span on every process.  int32, the ``part_ids`` of
    ``partition_bucket``."""
    cuts = torch.as_tensor(cuts, dtype=torch.int64, device=keys.device)
    if not cuts.numel():
        return torch.zeros(keys.shape[0], dtype=torch.int32,
                           device=keys.device)
    return searchsorted(cuts, keys, side="right").to(torch.int32)


def partition_bucket(batch: ColumnBatch, part_ids: torch.Tensor,
                     n_parts: int,
                     tie_keys: Optional[Sequence[torch.Tensor]] = None,
                     ) -> Tuple[ColumnBatch, torch.Tensor, torch.Tensor]:
    """Rows grouped by partition id in ONE stable sort
    (``spark_tpu/kernels.py`` ``partition_bucket``).  Dead rows take the
    virtual partition ``n_parts``, so live rows group contiguously by
    destination with the padding at the tail; ``tie_keys`` order the rows
    WITHIN each bucket (the range exchange's sorted runs).  Returns
    ``(bucketed, offsets, counts)`` (int32): partition ``p`` is
    ``bucketed[offsets[p]:offsets[p] + counts[p]]``."""
    live = batch.row_valid_or_true()
    pid = torch.where(live, part_ids.to(torch.int32),
                      torch.full((), n_parts, dtype=torch.int32,
                                 device=live.device))
    perm = multi_key_argsort([pid] + list(tie_keys or []), batch.capacity)
    bucketed = take_batch(batch, perm)
    # a scatter-add, not bincount: bincount on a card reads the maximum
    # back to size its output
    counts = torch.zeros(n_parts + 1, dtype=torch.int32, device=pid.device) \
        .index_add_(0, pid.long(), torch.ones_like(pid))[:n_parts]
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return bucketed, offsets, counts


def partition_host_slices(batch: ColumnBatch, part_ids: torch.Tensor,
                          n_parts: int,
                          tie_keys: Optional[Sequence[torch.Tensor]] = None,
                          ) -> Tuple[ColumnBatch, "np.ndarray", "np.ndarray"]:
    """``partition_bucket``, then ``bucketed_to_host``: the bucketed live
    rows on the host with their int32 ``(offsets, counts)``.  Any CONTIGUOUS
    range of partitions is one contiguous slice of the host batch
    (``host_slice``), which is what lets the exchange coordinator give a
    receiver several fine partitions without re-bucketing."""
    bucketed, _offsets, counts = partition_bucket(batch, part_ids, n_parts,
                                                  tie_keys)
    return bucketed_to_host(bucketed, counts)


def bucketed_to_host(bucketed: ColumnBatch, counts: torch.Tensor
                     ) -> Tuple[ColumnBatch, "np.ndarray", "np.ndarray"]:
    """The live rows of a bucketed batch on the host, with host int32
    ``(offsets, counts)``: the counts first (a few bytes), then every
    column's live prefix in ONE packed copy (``columnar.pack_to_host``) —
    the dead tail never leaves the device.  The host batch has no row
    mask: all its rows are live."""
    import numpy as np
    from .columnar import pack_to_host
    cnt = counts.cpu().numpy().astype(np.int32)
    n_live = int(cnt.sum(dtype=np.int64))
    tensors = []
    for v in bucketed.vectors:
        tensors.append(v.data[:n_live])
        if v.valid is not None:
            tensors.append(v.valid[:n_live])
    it = iter(pack_to_host(tensors))
    vectors = [ColumnVector(next(it), v.dtype,
                            None if v.valid is None else next(it),
                            v.dictionary) for v in bucketed.vectors]
    host = ColumnBatch(bucketed.names, vectors, None, n_live)
    off = (np.cumsum(cnt, dtype=np.int64) - cnt).astype(np.int32)
    return host, off, cnt


def host_slice(batch: ColumnBatch, start: int, count: int) -> ColumnBatch:
    """Rows ``[start, start + count)`` of a host batch as views sharing
    the parent's buffers, with no row mask: the rows are live
    (``partition_bucket`` put them there).  ``spark_tpu/kernels.py``
    ``slice_rows``; unlike ``columnar.slice_rows`` it never pads."""
    vectors = [ColumnVector(v.data[start:start + count], v.dtype,
                            None if v.valid is None
                            else v.valid[start:start + count],
                            v.dictionary)
               for v in batch.vectors]
    return ColumnBatch(list(batch.names), vectors, None, count)
