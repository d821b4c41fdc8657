"""Window functions (``sql/core/.../execution/window/`` and
``expressions/windowExpressions.scala`` analog): the port of
``spark_tpu/sql/window.py``.

One sort of (partition keys, order keys) per window spec; every window
function is then computed with vectorized scans over the sorted rows —
position arithmetic for row_number/rank/lag, prefix-sum differences for
running and bounded aggregate frames, segment totals for whole-partition
frames — and scattered back to the original row order through the
inverse permutation.  No per-partition loop and no host decision: a
window stage is one fixed sequence of torch ops, so it captures as a CUDA
graph like any other stage.

Frames follow Spark's defaults: with ORDER BY the frame is RANGE
UNBOUNDED PRECEDING..CURRENT ROW (peers included through value-group
ends), without ORDER BY the whole partition; ``rowsBetween`` gives
row-based frames (prefix differences clamped to the partition).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..aggregates import (AggregateFunction, Avg, Count, CountStar, Max, Min,
                          Sum, identity)
from ..capture import constant
from ..columnar import ColumnBatch, ColumnVector
from ..expressions import AnalysisException, Col, EvalContext, Expression
from ..kernels import multi_key_argsort, segment_reduce, sort_key_transform
from .logical import LogicalPlan, SortOrder

__all__ = [
    "Window", "WindowSpec", "WindowExpression", "RowNumber", "Rank",
    "DenseRank", "PercentRank", "CumeDist", "NTile", "Lag", "Lead",
    "WindowNode", "compute_windows",
]


class WindowSpec:
    def __init__(self, partition_by: Sequence[Expression] = (),
                 order_by: Sequence[SortOrder] = (),
                 frame: Optional[Tuple[Optional[int], Optional[int]]] = None,
                 frame_type: str = "range"):
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        # frame bounds in rows; None = unbounded on that side
        self.frame = frame
        self.frame_type = frame_type   # 'rows' | 'range'

    def partitionBy(self, *cols) -> "WindowSpec":
        return WindowSpec([_expr(c) for c in cols], self.order_by,
                          self.frame, self.frame_type)

    def orderBy(self, *cols) -> "WindowSpec":
        return WindowSpec(self.partition_by, [_order(c) for c in cols],
                          self.frame, self.frame_type)

    def rowsBetween(self, start: int, end: int) -> "WindowSpec":
        lo = None if start <= Window.unboundedPreceding else start
        hi = None if end >= Window.unboundedFollowing else end
        return WindowSpec(self.partition_by, self.order_by, (lo, hi), "rows")

    def rangeBetween(self, start: int, end: int) -> "WindowSpec":
        if start > Window.unboundedPreceding or end < Window.unboundedFollowing:
            raise AnalysisException(
                "bounded rangeBetween is not supported; use rowsBetween")
        return WindowSpec(self.partition_by, self.order_by, None, "range")

    def _key(self):
        return (tuple(repr(e) for e in self.partition_by),
                tuple(repr(o) for o in self.order_by))

    def __repr__(self):
        return (f"WindowSpec(partitionBy={self.partition_by}, "
                f"orderBy={self.order_by}, frame={self.frame})")


def _expr(c) -> Expression:
    from .column import Column
    if isinstance(c, Column):
        return c._e
    if isinstance(c, str):
        return Col(c)
    return c


def _order(c) -> SortOrder:
    from ..logicalutils import _SortOrderHandle
    if isinstance(c, SortOrder):
        return c
    if isinstance(c, _SortOrderHandle):
        return SortOrder(c.expr, c.ascending, c.nulls_first)
    return SortOrder(_expr(c), True)


class Window:
    """Static constructors of window specs (``expressions/Window.scala``)."""

    unboundedPreceding = -(1 << 62)
    unboundedFollowing = 1 << 62
    currentRow = 0

    @staticmethod
    def partitionBy(*cols) -> WindowSpec:
        return WindowSpec().partitionBy(*cols)

    @staticmethod
    def orderBy(*cols) -> WindowSpec:
        return WindowSpec().orderBy(*cols)

    @staticmethod
    def rowsBetween(start: int, end: int) -> WindowSpec:
        return WindowSpec().rowsBetween(start, end)


# ---------------------------------------------------------------------------
# window functions
# ---------------------------------------------------------------------------

class WindowFunction(Expression):
    """Rank-family functions; only meaningful under a WindowExpression."""

    requires_order = True
    children: Tuple[Expression, ...] = ()

    def data_type(self, schema) -> T.DataType:
        return T.int64

    def eval(self, ctx):
        raise AnalysisException(f"{self!r} must be used with .over(window)")

    def __repr__(self):
        return f"{type(self).__name__.lower()}()"


class RowNumber(WindowFunction):
    pass


class Rank(WindowFunction):
    pass


class DenseRank(WindowFunction):
    pass


class PercentRank(WindowFunction):
    def data_type(self, schema):
        return T.float64


class CumeDist(WindowFunction):
    def data_type(self, schema):
        return T.float64


class NTile(WindowFunction):
    def __init__(self, n: int):
        self.n = n
        self.children = ()


class _OffsetFunction(WindowFunction):
    def __init__(self, child: Expression, offset: int = 1, default=None):
        self.children = (child,)
        self.offset = offset
        self.default = default

    def data_type(self, schema):
        return self.children[0].data_type(schema)


class Lag(_OffsetFunction):
    pass


class Lead(_OffsetFunction):
    pass


class WindowExpression(Expression):
    """func OVER spec.  func is a WindowFunction or AggregateFunction."""

    def __init__(self, func, spec: WindowSpec):
        self.func = func
        self.spec = spec
        self.children = ()

    @property
    def name(self) -> str:
        return repr(self)

    def data_type(self, schema):
        return self.func.data_type(schema)

    # children stays () deliberately: generic aggregate extraction must NOT
    # slot-ify the window function itself.  Passes that need to see inside
    # (function resolution, the UDF lane check) use these two hooks.
    def sub_expressions(self):
        return (self.func, *self.spec.partition_by,
                *(o.child for o in self.spec.order_by))

    def map_parts(self, fn) -> "WindowExpression":
        spec = WindowSpec(
            [fn(p) for p in self.spec.partition_by],
            [type(o)(fn(o.child), o.ascending, o.nulls_first)
             for o in self.spec.order_by],
            self.spec.frame, self.spec.frame_type)
        return WindowExpression(fn(self.func), spec)

    def eval(self, ctx):
        raise AnalysisException(
            "window expressions are computed by the Window operator")

    def __repr__(self):
        return f"{self.func!r} OVER {self.spec!r}"


def contains_window(e: Expression) -> bool:
    if isinstance(e, WindowExpression):
        return True
    return any(contains_window(c) for c in e.children)


# ---------------------------------------------------------------------------
# logical node
# ---------------------------------------------------------------------------

class WindowNode(LogicalPlan):
    """Appends computed window columns to the child's output."""

    def __init__(self, wexprs: Sequence[Tuple[WindowExpression, str]],
                 child: LogicalPlan):
        self.wexprs = list(wexprs)
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.StructType:
        cs = self.child.schema()
        fields = list(cs.fields)
        for we, name in self.wexprs:
            fields.append(T.StructField(name, we.data_type(cs), True))
        return T.StructType(fields)

    def __repr__(self):
        return f"Window [{', '.join(n for _, n in self.wexprs)}]"


# ---------------------------------------------------------------------------
# the computation
# ---------------------------------------------------------------------------

def _cummax(a: torch.Tensor) -> torch.Tensor:
    return torch.cummax(a, 0).values


def _cummin(a: torch.Tensor) -> torch.Tensor:
    return torch.cummin(a, 0).values


def _next_flag_idx(flags: torch.Tensor, idx: torch.Tensor, cap: int
                   ) -> torch.Tensor:
    """For each row: the smallest j >= i with flags[j] (a reverse cummin)."""
    marked = torch.where(flags, idx, cap)
    return torch.flip(_cummin(torch.flip(marked, (0,))), (0,))


def _segment_scan_base(values: torch.Tensor, is_start: torch.Tensor):
    """For each row (sorted space): the value at its segment's first row."""
    idx = torch.arange(values.shape[0], dtype=torch.int64,
                       device=values.device)
    start_idx = _cummax(torch.where(is_start, idx, 0))
    return values[start_idx], start_idx


def _shift_changes(cols: Sequence[torch.Tensor], into: torch.Tensor
                   ) -> torch.Tensor:
    """``into`` OR each row where any of ``cols`` differs from the row
    before; row 0 always true."""
    for c in cols:
        shifted = torch.cat([c[:1], c[:-1]])
        into = into | (c != shifted)
    # a fill, not a store of a host value: no host-to-device copy
    into[:1].fill_(True)
    return into


def compute_windows(batch: ColumnBatch, spec: WindowSpec,
                    funcs: Sequence[Tuple[Any, str]]) -> ColumnBatch:
    """Append window columns (same capacity, original row order)."""
    ctx = EvalContext(batch)
    cap = batch.capacity
    dev = batch.device
    live = batch.row_valid_or_true().expand(cap)
    schema = batch.schema

    # ---- sort by (dead-last, partition keys, order keys) ----------------
    sort_cols: List[torch.Tensor] = [(~live).to(torch.int8)]
    for e in spec.partition_by:
        v = ctx.broadcast(e.eval(ctx))
        sort_cols += sort_key_transform(v.data, v.valid, e.data_type(schema),
                                        True, True)
    for o in spec.order_by:
        v = ctx.broadcast(o.child.eval(ctx))
        sort_cols += sort_key_transform(v.data, v.valid,
                                        o.child.data_type(schema),
                                        o.ascending, o.nulls_first)
    perm = multi_key_argsort(sort_cols, cap)
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    inv = torch.empty(cap, dtype=torch.int64, device=dev)
    inv[perm] = idx
    live_s = live[perm]

    # ---- segment starts (partition boundaries) in sorted space ----------
    n_part_cols = 1 + 2 * len(spec.partition_by)
    is_start = _shift_changes([c[perm] for c in sort_cols[:n_part_cols]],
                              torch.zeros(cap, dtype=torch.bool, device=dev))
    seg_start_idx = _cummax(torch.where(is_start, idx, 0))
    pos = idx - seg_start_idx                       # 0-based row in partition
    # last row of each row's segment: the nearest following boundary - 1
    next_start = torch.cat([is_start[1:],
                            torch.ones(1, dtype=torch.bool, device=dev)])
    seg_end_idx = _next_flag_idx(next_start, idx, cap)
    seg_len = seg_end_idx - seg_start_idx + 1

    # ---- order-key value groups (peers) ---------------------------------
    order_sorted = [c[perm] for c in sort_cols[n_part_cols:]]
    if order_sorted:
        vg_change = _shift_changes(order_sorted, is_start)
        vg_start_idx = _cummax(torch.where(vg_change, idx, 0))
        next_vg = torch.cat([vg_change[1:],
                             torch.ones(1, dtype=torch.bool, device=dev)])
        vg_end_idx = _next_flag_idx(next_vg, idx, cap)
    else:
        vg_change = is_start
        vg_start_idx, vg_end_idx = seg_start_idx, seg_end_idx

    geo = _Geometry(perm, idx, pos, seg_len, seg_start_idx, seg_end_idx,
                    vg_change, vg_start_idx, vg_end_idx, live_s, cap)
    names = list(batch.names)
    vectors = list(batch.vectors)
    for func, out_name in funcs:
        if isinstance(func, WindowFunction):
            data_s, valid_s, dt = _rank_family(func, ctx, geo, schema)
        elif isinstance(func, AggregateFunction):
            data_s, valid_s, dt = _window_aggregate(func, ctx, spec, geo,
                                                    schema)
        else:
            raise AnalysisException(f"not a window function: {func!r}")
        data = data_s[inv]
        valid = live if valid_s is None else valid_s[inv]
        dictionary = None
        if isinstance(func, (Lag, Lead)) or (isinstance(func, (Min, Max))
                                             and dt.is_string):
            dictionary = func.children[0].eval(ctx).dictionary
        names.append(out_name)
        vectors.append(ColumnVector(data.to(dt.torch_dtype), dt, valid,
                                    dictionary))
    return ColumnBatch(names, vectors, batch.row_valid, cap)


class _Geometry(NamedTuple):
    """The sorted space of one window spec: the permutation, each row's
    partition bounds and its peer group's bounds (indices into the sorted
    rows)."""

    perm: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor
    seg_len: torch.Tensor
    seg_start_idx: torch.Tensor
    seg_end_idx: torch.Tensor
    vg_change: torch.Tensor
    vg_start_idx: torch.Tensor
    vg_end_idx: torch.Tensor
    live_s: torch.Tensor
    cap: int


def _rank_family(func, ctx: EvalContext, g: _Geometry, schema):
    live_s = g.live_s
    if isinstance(func, RowNumber):
        return g.pos + 1, live_s, T.int64
    if isinstance(func, Rank):
        return g.vg_start_idx - g.seg_start_idx + 1, live_s, T.int64
    if isinstance(func, DenseRank):
        cs = torch.cumsum(g.vg_change.to(torch.int64), 0)
        base, _ = _segment_scan_base(cs, g.seg_start_idx == g.idx)
        return cs - base + 1, live_s, T.int64
    if isinstance(func, PercentRank):
        rank = g.vg_start_idx - g.seg_start_idx + 1
        denom = torch.clamp(g.seg_len - 1, min=1)
        out = (rank - 1).to(torch.float64) / denom.to(torch.float64)
        return torch.where(g.seg_len > 1, out, 0.0), live_s, T.float64
    if isinstance(func, CumeDist):
        covered = g.vg_end_idx - g.seg_start_idx + 1
        return (covered.to(torch.float64)
                / g.seg_len.to(torch.float64)), live_s, T.float64
    if isinstance(func, NTile):
        n = func.n
        # Spark: the first `rem` buckets get (len / n) + 1 rows
        base = g.seg_len // n
        rem = g.seg_len % n
        big = (base + 1) * rem
        tile = torch.where(g.pos < big,
                           g.pos // torch.clamp(base + 1, min=1),
                           rem + (g.pos - big) // torch.clamp(base, min=1))
        return tile + 1, live_s, T.int64
    if isinstance(func, (Lag, Lead)):
        v = ctx.broadcast(func.children[0].eval(ctx))
        dt = func.children[0].data_type(schema)
        data_s = v.data[g.perm]
        valid_s = None if v.valid is None else v.valid[g.perm]
        off = func.offset if isinstance(func, Lag) else -func.offset
        src = g.idx - off
        in_seg = (src >= g.seg_start_idx) & (src <= g.seg_end_idx)
        src_c = torch.clamp(src, 0, g.cap - 1)
        if func.default is not None:
            # the default is a constant of the stage run (no host copy
            # inside a capture)
            dv = constant(func.default, data_s.device, dt.torch_dtype)
            out = torch.where(in_seg, data_s[src_c].to(dt.torch_dtype), dv)
            ok = live_s if valid_s is None else \
                live_s & torch.where(in_seg, valid_s[src_c], True)
        else:
            out = torch.where(in_seg, data_s[src_c],
                              torch.zeros((), dtype=data_s.dtype,
                                          device=data_s.device))
            ok = in_seg & live_s
            if valid_s is not None:
                ok = ok & valid_s[src_c]
        return out, ok, dt
    raise AnalysisException(f"unsupported window function {func!r}")


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
          ) -> torch.Tensor:
    """``np.clip`` with per-row bounds."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _segmented_running_scan(buf: torch.Tensor, seg_id: torch.Tensor,
                            kind: str, cap: int) -> torch.Tensor:
    """Inclusive running min/max within segments: Hillis-Steele doubling,
    after pass k out[i] covers the last 2^k rows of its segment;
    ceil(log2(cap)) passes of fixed shapes."""
    op = torch.minimum if kind == "min" else torch.maximum
    out = buf
    shift = 1
    while shift < cap:
        prev = torch.cat([out[:shift], out[:-shift]])
        seg_prev = torch.cat([seg_id[:shift], seg_id[:-shift]])
        same = seg_id == seg_prev
        same[:shift].fill_(False)
        out = torch.where(same, op(out, prev), out)
        shift <<= 1
    return out


def _window_aggregate(func, ctx: EvalContext, spec: WindowSpec, g: _Geometry,
                      schema):
    """sum/count/avg/min/max over partition frames through prefix scans."""
    live_s, idx = g.live_s, g.idx
    if isinstance(func, CountStar):
        buf = live_s.to(torch.int64)
        valid_in = live_s
        dt_out = T.int64
        kind = "sum"
    else:
        v = ctx.broadcast(func.children[0].eval(ctx))
        data_s = v.data[g.perm]
        valid_in = live_s if v.valid is None else (live_s & v.valid[g.perm])
        dt_out = func.data_type(schema)
        if isinstance(func, Count):
            buf = valid_in.to(torch.int64)
            dt_out = T.int64
            kind = "sum"
        elif isinstance(func, (Sum, Avg)):
            # accumulate in the OUTPUT dtype: int64 prefix sums stay exact
            src = func.children[0].data_type(schema)
            if isinstance(func, Avg):
                acc = data_s.to(torch.float64)
                if isinstance(src, T.DecimalType):
                    acc = acc / (10 ** src.scale)
            else:
                acc = data_s.to(dt_out.torch_dtype)
            buf = torch.where(valid_in, acc, torch.zeros((), dtype=acc.dtype,
                                                         device=acc.device))
            kind = "sum"
        elif isinstance(func, (Min, Max)):
            kind = "min" if isinstance(func, Min) else "max"
            tdt = dt_out.torch_dtype
            red_dt = torch.int8 if tdt == torch.bool else tdt
            ident = constant(identity(kind, red_dt), data_s.device, red_dt)
            buf = torch.where(valid_in, data_s.to(red_dt), ident)
        else:
            raise AnalysisException(f"unsupported window aggregate {func!r}")
    cnt_buf = valid_in.to(torch.int64)
    has_order = bool(spec.order_by)
    frame = spec.frame

    if kind == "sum":
        # sums of rows < i, with a zero in the accumulator's own dtype: a
        # float zero would promote int64 prefixes and lose exactness
        cs0 = torch.cat([torch.zeros(1, dtype=buf.dtype, device=buf.device),
                         torch.cumsum(buf, 0)])
        ccnt0 = torch.cat([torch.zeros(1, dtype=torch.int64,
                                       device=buf.device),
                           torch.cumsum(cnt_buf, 0)])
        if frame is None and not has_order:
            lo_idx, hi_idx = g.seg_start_idx, g.seg_end_idx
        elif frame is None:
            lo_idx, hi_idx = g.seg_start_idx, g.vg_end_idx  # range: peers in
        else:
            lo, hi = frame
            lo_idx = g.seg_start_idx if lo is None else _clip(
                idx + lo, g.seg_start_idx, g.seg_end_idx + 1)
            hi_idx = g.seg_end_idx if hi is None else _clip(
                idx + hi, g.seg_start_idx - 1, g.seg_end_idx)
        total = cs0[hi_idx + 1] - cs0[lo_idx]
        count = ccnt0[hi_idx + 1] - ccnt0[lo_idx]
        if isinstance(func, (Count, CountStar)):
            return count, live_s, T.int64
        if isinstance(func, Avg):
            safe = torch.where(count > 0, count, 1)
            return total / safe, live_s & (count > 0), T.float64
        return total, live_s & (count > 0), dt_out

    # min/max: running or whole-partition frames only
    if frame is not None and frame != (None, 0) and frame != (None, None):
        raise AnalysisException(
            "min/max window frames support only UNBOUNDED PRECEDING")
    seg_id = torch.cumsum((g.seg_start_idx == idx).to(torch.int64), 0) - 1
    if frame == (None, 0) or (frame is None and has_order):
        run = _segmented_running_scan(buf, seg_id, kind, g.cap)
        c0 = torch.cat([torch.zeros(1, dtype=torch.int64, device=buf.device),
                        torch.cumsum(cnt_buf, 0)])
        if frame is None:
            # the default RANGE frame: the current row's ORDER BY peers are
            # in the frame — read the running value at the peer group's end
            run = run[g.vg_end_idx]
            count = c0[g.vg_end_idx + 1] - c0[g.seg_start_idx]
        else:
            count = c0[idx + 1] - c0[g.seg_start_idx]
        return run, live_s & (count > 0), dt_out
    # the whole partition
    reduced = segment_reduce(buf, seg_id, g.cap, kind)
    cnts = segment_reduce(cnt_buf, seg_id, g.cap, "sum")
    return reduced[seg_id], live_s & (cnts[seg_id] > 0), dt_out
