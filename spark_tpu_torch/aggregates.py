"""Aggregate functions, decomposed into segment-reducible buffers.

The subset of ``spark_tpu/aggregates.py`` the DataFrame path uses.  Every
aggregate is a small set of BUFFERS, each reduced with one of {sum, min,
max}; ``finish`` combines the reduced buffers into the output column (the
partial/final split of ``AggUtils.scala``).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import types as T
from .capture import constant
from .expressions import AnalysisException, EvalContext, Expression, ExprValue, and_valid

__all__ = [
    "AggregateFunction", "BufferSpec", "Sum", "Count", "CountStar", "Avg",
    "Min", "Max", "First", "Last", "CountDistinct", "SumDistinct",
    "VarianceBase", "VarSamp", "VarPop", "StddevSamp", "StddevPop",
    "PercentileApprox", "CollectList", "CollectSet", "is_aggregate",
    "IDENTITY", "MERGE_BY_KIND",
]


class BufferSpec(NamedTuple):
    """One reducible buffer: data to reduce, reduction kind, and its dtype
    (rows that do not contribute hold the reduction identity)."""

    data: Any            # tensor (capacity,)
    kind: str            # 'sum' | 'min' | 'max'
    dtype: torch.dtype   # buffer storage dtype


def _min_ident(dt):
    dt = np.dtype(dt)
    if dt == np.bool_:
        return True
    return np.inf if np.issubdtype(dt, np.floating) else np.iinfo(dt).max


def _max_ident(dt):
    dt = np.dtype(dt)
    if dt == np.bool_:
        return False
    return -np.inf if np.issubdtype(dt, np.floating) else np.iinfo(dt).min


#: reduction identity per kind, keyed by numpy dtype (as in the JAX package)
IDENTITY = {
    "sum": lambda dt: np.zeros((), dt).item() if np.issubdtype(dt, np.floating) else 0,
    "min": _min_ident,
    "max": _max_ident,
}


def identity(kind: str, dtype: torch.dtype):
    """Python value of the ``kind`` reduction identity for a torch dtype."""
    v = IDENTITY[kind](T.torch_to_np_dtype(dtype))
    return v.item() if hasattr(v, "item") else v


class AggregateFunction(Expression):
    """Base: children are input expressions; eval() is forbidden (aggregates
    are consumed by the Aggregate operator)."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def eval(self, ctx: EvalContext) -> ExprValue:
        raise AnalysisException(
            f"aggregate function {self!r} cannot be evaluated row-wise; "
            "use it under groupBy().agg(...)")

    # -- the buffer contract ---------------------------------------------
    def num_buffers(self) -> int:
        raise NotImplementedError

    def make_buffers(self, ctx: EvalContext, contribute) -> List[BufferSpec]:
        """Per-row buffer contributions.  ``contribute`` is the boolean mask
        of rows that exist; each buffer holds its reduction identity where
        a row does not contribute (or its input is NULL)."""
        raise NotImplementedError

    def finish(self, buffers: List[Any]) -> ExprValue:
        """Combine reduced buffers into the output column value."""
        raise NotImplementedError

    def output_dictionary(self, ctx: EvalContext):
        """Dictionary of the output column (min/max/first of strings)."""
        return None

    def _input(self, ctx: EvalContext, contribute) -> Tuple[Any, Any]:
        """Evaluate the single input expr; returns (data, valid&contribute)."""
        v = self.children[0].eval(ctx)
        valid = and_valid(v.valid, contribute)
        if valid is None:
            valid = torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device)
        data = v.data
        if data.dim() == 0:
            data = data.expand(ctx.capacity)
        if valid.dim() == 0:
            valid = valid.expand(ctx.capacity)
        return data, valid

    def _masked(self, data, valid, kind: str, dtype: torch.dtype) -> BufferSpec:
        ident = constant(identity(kind, dtype), data.device, dtype)
        return BufferSpec(torch.where(valid, data.to(dtype), ident), kind,
                          dtype)


class Sum(AggregateFunction):
    """sum(x): NULL if no non-null input (Sum.scala)."""

    def data_type(self, schema):
        dt = self.children[0].data_type(schema)
        if isinstance(dt, T.DecimalType):
            return T.DecimalType(T.DecimalType.MAX_PRECISION, dt.scale)
        if dt.is_integral or isinstance(dt, T.BooleanType):
            return T.int64
        return T.float64

    def num_buffers(self):
        return 2

    def make_buffers(self, ctx, contribute):
        data, valid = self._input(ctx, contribute)
        out_dt = self.data_type(ctx.batch.schema).torch_dtype
        return [self._masked(data, valid, "sum", out_dt),
                BufferSpec(valid.to(torch.int64), "sum", torch.int64)]

    def finish(self, buffers):
        total, cnt = buffers
        return ExprValue(total, cnt > 0)

    def __repr__(self):
        return f"sum({self.children[0]!r})"


class Count(AggregateFunction):
    """count(x): number of non-null inputs; never NULL."""

    def data_type(self, schema):
        return T.int64

    def num_buffers(self):
        return 1

    def make_buffers(self, ctx, contribute):
        _, valid = self._input(ctx, contribute)
        return [BufferSpec(valid.to(torch.int64), "sum", torch.int64)]

    def finish(self, buffers):
        return ExprValue(buffers[0], None)

    def __repr__(self):
        return f"count({self.children[0]!r})"


class CountStar(AggregateFunction):
    """count(*): counts rows regardless of nulls."""

    def __init__(self):
        super().__init__()

    def data_type(self, schema):
        return T.int64

    def num_buffers(self):
        return 1

    def make_buffers(self, ctx, contribute):
        c = contribute if contribute is not None else \
            torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device)
        return [BufferSpec(c.to(torch.int64), "sum", torch.int64)]

    def finish(self, buffers):
        return ExprValue(buffers[0], None)

    def __repr__(self):
        return "count(1)"


class Avg(AggregateFunction):
    def data_type(self, schema):
        return T.float64

    def num_buffers(self):
        return 2

    def make_buffers(self, ctx, contribute):
        data, valid = self._input(ctx, contribute)
        src = self.children[0].data_type(ctx.batch.schema)
        fdata = data.to(torch.float64)
        if isinstance(src, T.DecimalType):
            fdata = fdata / (10 ** src.scale)
        return [self._masked(fdata, valid, "sum", torch.float64),
                BufferSpec(valid.to(torch.int64), "sum", torch.int64)]

    def finish(self, buffers):
        total, cnt = buffers
        safe = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
        return ExprValue(total / safe, cnt > 0)

    def __repr__(self):
        return f"avg({self.children[0]!r})"


class _MinMax(AggregateFunction):
    kind = "min"

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def num_buffers(self):
        return 2

    def make_buffers(self, ctx, contribute):
        data, valid = self._input(ctx, contribute)
        dt = self.data_type(ctx.batch.schema).torch_dtype
        if dt == torch.bool:
            dt = torch.int8
        return [self._masked(data, valid, self.kind, dt),
                BufferSpec(valid.to(torch.int64), "sum", torch.int64)]

    def finish(self, buffers):
        val, cnt = buffers
        return ExprValue(val, cnt > 0)

    def output_dictionary(self, ctx: EvalContext):
        return self.children[0].eval(ctx).dictionary

    def __repr__(self):
        return f"{self.kind}({self.children[0]!r})"


class Min(_MinMax):
    kind = "min"


class Max(_MinMax):
    kind = "max"


class First(AggregateFunction):
    """first(x, ignoreNulls=True): value of x on the first contributing row.

    Contributes a min-reduced ROW INDEX buffer; the aggregate operator
    gathers the value at the reduced index (it holds the pre-reduction
    batch)."""

    def __init__(self, child: Expression, ignore_nulls: bool = True):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def num_buffers(self):
        return 1

    ARGREDUCE = "first"

    def _row_mask(self, ctx, contribute):
        _, valid = self._input(ctx, contribute)
        if not self.ignore_nulls:
            valid = contribute if contribute is not None else \
                torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device)
            if valid.dim() == 0:
                valid = valid.expand(ctx.capacity)
        return valid

    def make_buffers(self, ctx, contribute):
        valid = self._row_mask(ctx, contribute)
        idx = torch.arange(ctx.capacity, dtype=torch.int64, device=ctx.device)
        big = constant(1 << 62, ctx.device, torch.int64)
        return [BufferSpec(torch.where(valid, idx, big), "min", torch.int64)]

    def finish(self, buffers):
        raise AnalysisException("First/Last finish requires operator gather")

    def output_dictionary(self, ctx: EvalContext):
        return self.children[0].eval(ctx).dictionary

    def __repr__(self):
        return f"first({self.children[0]!r})"


class Last(First):
    ARGREDUCE = "last"

    def make_buffers(self, ctx, contribute):
        valid = self._row_mask(ctx, contribute)
        idx = torch.arange(ctx.capacity, dtype=torch.int64, device=ctx.device)
        none = constant(-1, ctx.device, torch.int64)
        return [BufferSpec(torch.where(valid, idx, none), "max", torch.int64)]

    def __repr__(self):
        return f"last({self.children[0]!r})"


class VarianceBase(AggregateFunction):
    """var/stddev from (count, sum, sum of squares) buffers, which merge as
    plain sums (the reference's ``CentralMomentAgg.scala`` keeps Welford
    moments, which do not).  A decimal input counts by its value."""

    ddof = 1

    def data_type(self, schema):
        return T.float64

    def num_buffers(self):
        return 3

    def make_buffers(self, ctx, contribute):
        data, valid = self._input(ctx, contribute)
        src = self.children[0].data_type(ctx.batch.schema)
        f = data.to(torch.float64)
        if isinstance(src, T.DecimalType):
            f = f / (10 ** src.scale)
        return [BufferSpec(valid.to(torch.int64), "sum", torch.int64),
                self._masked(f, valid, "sum", torch.float64),
                self._masked(f * f, valid, "sum", torch.float64)]

    def _variance(self, buffers):
        n, s, s2 = buffers
        nf = n.to(torch.float64)
        safe_n = torch.where(n > self.ddof, nf, 1.0)
        mean = s / torch.where(n > 0, nf, 1.0)
        var = torch.clamp(s2 - nf * mean * mean, min=0.0) \
            / torch.clamp(safe_n - self.ddof, min=1.0)
        return var, n > self.ddof

    def finish(self, buffers):
        var, valid = self._variance(buffers)
        return ExprValue(var, valid)


class VarSamp(VarianceBase):
    ddof = 1

    def __repr__(self):
        return f"var_samp({self.children[0]!r})"


class VarPop(VarianceBase):
    ddof = 0

    def __repr__(self):
        return f"var_pop({self.children[0]!r})"


class StddevSamp(VarianceBase):
    ddof = 1

    def finish(self, buffers):
        var, valid = self._variance(buffers)
        return ExprValue(torch.sqrt(var), valid)

    def __repr__(self):
        return f"stddev_samp({self.children[0]!r})"


class StddevPop(StddevSamp):
    ddof = 0

    def __repr__(self):
        return f"stddev_pop({self.children[0]!r})"


class PercentileApprox(AggregateFunction):
    """percentile_approx(x, p), computed EXACTLY: the nearest-rank value at
    floor(p * (n - 1)) of each group's sorted non-null values (what the
    reference's sketch answers at accuracy 1).  It has no buffers: the
    sort-based aggregate computes it (``kernels._percentile_groups``),
    and the mesh lane gathers its input to one shard."""

    is_percentile = True

    def __init__(self, child, percentage: float):
        super().__init__(child)
        if not (0.0 <= float(percentage) <= 1.0):
            raise AnalysisException(
                f"percentile must be in [0, 1], got {percentage}")
        self.percentage = float(percentage)

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def num_buffers(self):
        return 0

    def make_buffers(self, ctx, contribute):
        raise AnalysisException(
            "percentile_approx only runs on the sort-based aggregation "
            "path")

    def __repr__(self):
        return f"percentile_approx({self.children[0]!r}, {self.percentage})"


class CollectList(AggregateFunction):
    """collect_list(x): each group's non-null values as an array, in the
    group sort's order (stable, so in row order).  The arrays are
    ``max_len`` wide (``spark.tpu.collect.maxArrayLen``, which the planner
    binds when it plans the query); a longer group truncates.  It has no
    buffers: the sort-based aggregate computes it
    (``kernels._collect_into_arrays``), and the mesh lane gathers its
    input to one shard."""

    is_collect = True
    distinct_elements = False

    def __init__(self, child, max_len: Optional[int] = None):
        super().__init__(child)
        self.max_len = max_len

    def with_max_len(self, max_len: int) -> "CollectList":
        return type(self)(self.children[0], int(max_len))

    def map_children(self, fn):
        return type(self)(fn(self.children[0]), self.max_len)

    def data_type(self, schema):
        return T.ArrayType(self.children[0].data_type(schema))

    def num_buffers(self):
        return 0

    def make_buffers(self, ctx, contribute):
        raise AnalysisException(
            "collect_list/collect_set only run on the sort-based "
            "aggregation path")

    def __repr__(self):
        return f"collect_list({self.children[0]!r})"


class CollectSet(CollectList):
    """collect_set(x): each group's distinct non-null values as an array."""

    distinct_elements = True

    def __repr__(self):
        return f"collect_set({self.children[0]!r})"


class CountDistinct(Count):
    """count(DISTINCT x): the analyzer rewrites it into a two-level
    aggregation (``RewriteDistinctAggregates.scala`` restricted to one
    distinct column)."""

    is_distinct = True

    def __repr__(self):
        return f"count(DISTINCT {self.children[0]!r})"


class SumDistinct(Sum):
    is_distinct = True

    def __repr__(self):
        return f"sum(DISTINCT {self.children[0]!r})"


#: merge function per buffer reduction kind: streaming state merges fold
#: partial buffer columns with these
MERGE_BY_KIND = {"sum": Sum, "min": Min, "max": Max}


def is_aggregate(e: Expression) -> bool:
    if isinstance(e, AggregateFunction):
        return True
    return any(is_aggregate(c) for c in e.children)
