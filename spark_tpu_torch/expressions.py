"""Expression IR evaluated as torch tensor programs.

The subset of ``spark_tpu/expressions.py`` (Catalyst's
``expressions/Expression.scala`` analog) that the single-device DataFrame
path needs.  Every expression evaluates VECTORIZED over a whole
ColumnBatch on the batch's device; scalars are 0-dim tensors on the same
device.  NULLs are validity masks with Kleene three-valued AND/OR, and
string expressions work on dictionary codes (the host owns the words).

torch promotes differently from numpy and JAX: an int64 tensor with a
Python float gives float32, and a 0-dim tensor does not widen a
dimensioned one.  So every operator first casts its operands to the
declared result type, as the JAX package casts to ``np_dtype``.
"""

from __future__ import annotations

import re
import threading
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import types as T
from .capture import constant
from .columnar import ColumnBatch

__all__ = [
    "ExprValue", "EvalContext", "Expression", "Col", "Literal", "Alias",
    "Cast", "Add", "Sub", "Mul", "Div", "IntDiv", "Mod", "Neg", "EQ", "NE", "LT",
    "LE", "GT", "GE", "EqNullSafe", "And", "Or", "Not", "IsNull",
    "IsNotNull", "Coalesce", "If", "CaseWhen", "In", "Between", "Hash64",
    "StringPredicate", "Pow", "UnaryMath", "RoundExpr", "IsNaN", "Greatest",
    "Least", "BinaryMath", "StringTransform", "Substring", "StringLength",
    "Concat", "ParamStringTransform", "StringToInt", "ExtractDatePart",
    "DateArith", "NextDay", "TruncDate", "UnixTimestamp", "GroupingCall",
    "RowIndex", "Rand", "Randn", "SparkPartitionId", "MakeArray", "SplitStr",
    "ArraySize", "ElementAt", "ArrayReduce", "SortArray", "ArrayDistinct",
    "ArraySlice", "ArrayPosition", "LambdaVar", "ArrayTransform",
    "ArrayFilterFn", "ArrayExists", "ArrayAggregate", "ZipWith",
    "ArrayContains", "ExplodeMarker", "CreateStruct", "GetField",
    "CreateMap", "MapFromArrays", "MapKeys", "MapValues", "MapGet",
    "GetItem", "ArrayGather",
    "lit", "col", "AnalysisException",
]


class AnalysisException(Exception):
    """Resolution/type error (reference ``sql/AnalysisException.scala``)."""


class ExprValue(NamedTuple):
    """A vectorized value: data tensor (0-dim broadcasts), optional validity
    mask (None = no NULLs), optional string dictionary."""

    data: Any
    valid: Optional[Any]
    dictionary: Optional[Tuple] = None


def and_valid(a: Optional[torch.Tensor], b: Optional[torch.Tensor]
              ) -> Optional[torch.Tensor]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


class EvalContext:
    """Evaluation environment: a ColumnBatch and the device it lives on.

    ``row_offset`` decorrelates RowIndex/Rand across operators and shards
    (the upper-bits analog of MonotonicallyIncreasingID's partition id):
    a host int, a constant of the plan, never read from the device.
    ``lambda_bindings`` maps a bound lambda variable's name to the value
    its higher-order function gave it."""

    def __init__(self, batch: ColumnBatch, row_offset: int = 0):
        self.batch = batch
        self.device = batch.device
        self.capacity = batch.capacity
        self.row_offset = row_offset
        self.lambda_bindings: dict = {}

    def col(self, name: str) -> ExprValue:
        vec = self.batch.column(name)
        return ExprValue(vec.data, vec.valid, vec.dictionary)

    def scalar(self, value, dtype: torch.dtype) -> torch.Tensor:
        """A 0-dim tensor of a host value: a constant of the stage run
        (``capture.constant``), so a captured graph copies nothing."""
        return constant(value, self.device, dtype)

    def broadcast(self, value: ExprValue) -> ExprValue:
        """Materialize scalars to full capacity (project output)."""
        data = value.data
        if data.dim() == 0:
            data = data.expand(self.capacity)
        valid = value.valid
        if valid is not None and valid.dim() == 0:
            valid = valid.expand(self.capacity)
        return ExprValue(data, valid, value.dictionary)


def _true(ref: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=ref.device)


class Expression:
    """Base expression node: typed, vectorized, rewritable."""

    children: Tuple["Expression", ...] = ()

    # -- analysis ---------------------------------------------------------
    def data_type(self, schema: T.StructType) -> T.DataType:
        raise NotImplementedError

    def references(self) -> set:
        out = set()
        for c in self.children:
            out |= c.references()
        return out

    @property
    def foldable(self) -> bool:
        return bool(self.children) and all(c.foldable for c in self.children)

    def map_children(self, fn: Callable[["Expression"], "Expression"]) -> "Expression":
        """Rebuild this node with transformed children (rule rewrites)."""
        if not self.children:
            return self
        import copy
        new = copy.copy(self)
        new.children = tuple(fn(c) for c in self.children)
        return new

    def transform_up(self, fn) -> "Expression":
        node = self.map_children(lambda c: c.transform_up(fn))
        return fn(node)

    # -- execution --------------------------------------------------------
    def eval(self, ctx: EvalContext) -> ExprValue:
        raise NotImplementedError

    # -- display ----------------------------------------------------------
    @property
    def name(self) -> str:
        """Auto-generated output column name (Catalyst ``toString``)."""
        return repr(self)

    def __repr__(self) -> str:  # pragma: no cover
        args = ", ".join(repr(c) for c in self.children)
        return f"{type(self).__name__.lower()}({args})"

    # -- sugar (the user-facing Column API builds on these) ---------------
    def __add__(self, o): return Add(self, _wrap(o))
    def __radd__(self, o): return Add(_wrap(o), self)
    def __sub__(self, o): return Sub(self, _wrap(o))
    def __rsub__(self, o): return Sub(_wrap(o), self)
    def __mul__(self, o): return Mul(self, _wrap(o))
    def __rmul__(self, o): return Mul(_wrap(o), self)
    def __truediv__(self, o): return Div(self, _wrap(o))
    def __rtruediv__(self, o): return Div(_wrap(o), self)
    def __mod__(self, o): return Mod(self, _wrap(o))
    def __neg__(self): return Neg(self)
    def __eq__(self, o): return EQ(self, _wrap(o))  # type: ignore[override]
    def __ne__(self, o): return NE(self, _wrap(o))  # type: ignore[override]
    def __lt__(self, o): return LT(self, _wrap(o))
    def __le__(self, o): return LE(self, _wrap(o))
    def __gt__(self, o): return GT(self, _wrap(o))
    def __ge__(self, o): return GE(self, _wrap(o))
    def __and__(self, o): return And(self, _wrap(o))
    def __or__(self, o): return Or(self, _wrap(o))
    def __invert__(self): return Not(self)
    def __hash__(self):  # __eq__ is overloaded; identity hash keeps sets working
        return id(self)


def _wrap(v: Any) -> Expression:
    return v if isinstance(v, Expression) else Literal(v)


def lit(v: Any) -> Expression:
    return _wrap(v)


def col(name: str) -> "Col":
    return Col(name)


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

class Col(Expression):
    """Column reference (``AttributeReference`` after resolution)."""

    def __init__(self, name: str):
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    @property
    def foldable(self) -> bool:
        return False

    def data_type(self, schema: T.StructType) -> T.DataType:
        try:
            return schema[self._name].dataType
        except KeyError:
            raise AnalysisException(
                f"cannot resolve column '{self._name}' among ({', '.join(schema.names)})")

    def references(self) -> set:
        return {self._name}

    def eval(self, ctx: EvalContext) -> ExprValue:
        return ctx.col(self._name)

    def __repr__(self) -> str:
        return self._name


class _SlotBindings(threading.local):
    """Per-thread Literal→parameter bindings of a stage run.

    A stage entry (``sql/stagecompile.py``) runs ONE program per plan
    SHAPE; literals in arithmetic/comparison positions read a device
    scalar of the entry instead of their own value, and each dispatch
    copies the new values into those scalars.  The binding is
    thread-local and keyed by Literal object identity — never object
    mutation — so a concurrent run of a plan that shares Literal objects
    never sees another thread's scalars."""

    map: Optional[dict] = None


_slot_bindings = _SlotBindings()


class Literal(Expression):
    def __init__(self, value: Any, dtype: Optional[T.DataType] = None):
        self.value = value
        self.dtype = dtype or T.infer_type(value)

    @property
    def foldable(self) -> bool:
        return True

    def data_type(self, schema: T.StructType) -> T.DataType:
        return self.dtype

    def eval(self, ctx: EvalContext) -> ExprValue:
        bindings = _slot_bindings.map
        if bindings is not None:
            bound = bindings.get(id(self))
            if bound is not None:
                # slotted parameter: the VALUE is the stage entry's device
                # scalar, which each dispatch fills before the run
                return ExprValue(bound, None)
        if self.value is None:
            return ExprValue(ctx.scalar(0, self.dtype.torch_dtype),
                             ctx.scalar(False, torch.bool))
        if self.dtype.is_string:
            # a lone string literal: single-entry dictionary, code 0
            return ExprValue(ctx.scalar(0, torch.int32), None,
                             (str(self.value),))
        if isinstance(self.dtype, T.DecimalType):
            scaled = int(round(float(self.value) * 10 ** self.dtype.scale))
            return ExprValue(ctx.scalar(scaled, torch.int64), None)
        if isinstance(self.dtype, T.DateType):
            days = int(np.datetime64(self.value, "D").astype(np.int32))
            return ExprValue(ctx.scalar(days, torch.int32), None)
        if isinstance(self.dtype, T.TimestampType):
            us = int(np.datetime64(self.value, "us").astype(np.int64))
            return ExprValue(ctx.scalar(us, torch.int64), None)
        return ExprValue(ctx.scalar(self.value, self.dtype.torch_dtype), None)

    def __repr__(self) -> str:
        return repr(self.value)


class Alias(Expression):
    def __init__(self, child: Expression, alias: str):
        self.children = (child,)
        self._alias = alias

    @property
    def name(self) -> str:
        return self._alias

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def eval(self, ctx):
        return self.children[0].eval(ctx)

    def __repr__(self) -> str:
        return f"{self.children[0]!r} AS {self._alias}"


# ---------------------------------------------------------------------------
# Arithmetic (reference expressions/arithmetic.scala)
# ---------------------------------------------------------------------------

def _safe_divisor(r: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """``r`` with zeros replaced by one: an integer divide by zero raises on
    the CPU and gives garbage on CUDA, and those rows are NULL anyway."""
    return torch.where(zero, torch.ones((), dtype=r.dtype, device=r.device), r)


def _result_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    """numpy's array promotion of two operands (torch keeps a 0-dim
    operand's narrower type; numpy and JAX widen)."""
    return T.np_to_torch_dtype(np.result_type(
        T.torch_to_np_dtype(a.dtype), T.torch_to_np_dtype(b.dtype)))


class BinaryArithmetic(Expression):
    op_name = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def data_type(self, schema):
        lt_, rt = (c.data_type(schema) for c in self.children)
        if isinstance(lt_, T.NullType):
            return rt
        if isinstance(rt, T.NullType):
            return lt_
        return T.numeric_promote(lt_, rt)

    def _compute(self, a, b):
        raise NotImplementedError

    def _operands(self, ctx: EvalContext):
        """Both sides' values and their data in the result type's device
        representation: a decimal operand is rescaled to the result's
        scale (or to its value, for a double result), as ``_as_type``
        does for comparisons (the JAX package adds the held integers as
        they are: ROADMAP §3)."""
        l, r = (c.eval(ctx) for c in self.children)
        schema = ctx.batch.schema
        lt_, rt = (c.data_type(schema) for c in self.children)
        dt = self.data_type(schema)
        return l, r, dt, _as_type(l.data, lt_, dt), _as_type(r.data, rt, dt)

    def eval(self, ctx: EvalContext) -> ExprValue:
        l, r, _dt, a, b = self._operands(ctx)
        return ExprValue(self._compute(a, b), and_valid(l.valid, r.valid))

    def __repr__(self) -> str:
        return f"({self.children[0]!r} {self.op_name} {self.children[1]!r})"


class Add(BinaryArithmetic):
    op_name = "+"
    def _compute(self, a, b): return a + b


class Sub(BinaryArithmetic):
    op_name = "-"
    def _compute(self, a, b): return a - b


class Mul(BinaryArithmetic):
    """A decimal times a decimal keeps both scales (Spark's
    ``DecimalPrecision``: scale s1 + s2), so the held integers multiply
    as they are; a decimal times an integer keeps the decimal's scale."""

    op_name = "*"

    def data_type(self, schema):
        lt_, rt = (c.data_type(schema) for c in self.children)
        if isinstance(lt_, T.DecimalType) and isinstance(rt, T.DecimalType):
            return T.DecimalType(
                min(lt_.precision + rt.precision + 1,
                    T.DecimalType.MAX_PRECISION), lt_.scale + rt.scale)
        return super().data_type(schema)

    def _operands(self, ctx: EvalContext):
        l, r = (c.eval(ctx) for c in self.children)
        schema = ctx.batch.schema
        lt_, rt = (c.data_type(schema) for c in self.children)
        dt = self.data_type(schema)
        if isinstance(dt, T.DecimalType):
            # the product of the held integers already carries the
            # result's scale: no operand is rescaled
            return l, r, dt, l.data.to(torch.int64), r.data.to(torch.int64)
        return l, r, dt, _as_type(l.data, lt_, dt), _as_type(r.data, rt, dt)

    def _compute(self, a, b): return a * b


class Div(BinaryArithmetic):
    """True division; x/0 → NULL (ANSI-off Spark semantics)."""

    op_name = "/"

    def data_type(self, schema):
        dt = super().data_type(schema)
        # a quotient with a decimal operand is a double of the operands'
        # values (the JAX package divides the held integers and keeps
        # the decimal type: ROADMAP §3)
        return dt if dt.is_fractional and not isinstance(
            dt, T.DecimalType) else T.float64

    def eval(self, ctx: EvalContext) -> ExprValue:
        l, r, _dt, a, b = self._operands(ctx)
        zero = r.data == 0
        b = _safe_divisor(b, zero)
        valid = and_valid(and_valid(l.valid, r.valid), ~zero)
        return ExprValue(a / b, valid)


class IntDiv(Div):
    op_name = "div"

    def data_type(self, schema):
        return T.int64

    def eval(self, ctx: EvalContext) -> ExprValue:
        l, r = (c.eval(ctx) for c in self.children)
        zero = r.data == 0
        rt = _result_dtype(l.data, r.data)
        b = _safe_divisor(r.data, zero).to(rt)
        valid = and_valid(and_valid(l.valid, r.valid), ~zero)
        # floor division, as numpy's `//` in the JAX package
        return ExprValue(torch.floor_divide(l.data.to(rt), b).to(torch.int64),
                         valid)


class Mod(BinaryArithmetic):
    op_name = "%"

    def eval(self, ctx: EvalContext) -> ExprValue:
        l, r, dt, a, b = self._operands(ctx)
        tdt = dt.torch_dtype
        zero = r.data == 0
        b = _safe_divisor(b, zero)
        valid = and_valid(and_valid(l.valid, r.valid), ~zero)
        # Spark % keeps the sign of the dividend (Java semantics), i.e. fmod
        if dt.is_fractional and tdt.is_floating_point:
            res = torch.fmod(a, b)
        else:
            res = (torch.sign(a) * (torch.abs(a) % torch.abs(b))).to(tdt)
        return ExprValue(res, valid)


class Neg(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self, schema):
        return self.children[0].data_type(schema)

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        return ExprValue(-v.data, v.valid)

    def __repr__(self):
        return f"(- {self.children[0]!r})"


# ---------------------------------------------------------------------------
# Comparisons & boolean logic (reference expressions/predicates.scala)
# ---------------------------------------------------------------------------

def _comparison_operands(ctx: EvalContext, le: Expression, re_: Expression):
    """Evaluate both sides coerced to a common comparable representation.

    Strings compare by dictionary code, which is order-correct only when
    both sides share a dictionary; a string literal vs a column maps into
    the column's code space by a host search of the (sorted) dictionary.
    """
    l, r = le.eval(ctx), re_.eval(ctx)
    if l.dictionary is not None or r.dictionary is not None:
        if l.dictionary is not None and r.dictionary is not None:
            if l.dictionary == r.dictionary:
                return l, r, True
            if len(r.dictionary) == 1:  # literal side
                word = r.dictionary[0]
                idx = int(np.searchsorted(np.array(l.dictionary, dtype=object), word))
                exact = idx < len(l.dictionary) and l.dictionary[idx] == word
                # exact match → the code; else the half-step boundary below
                # idx, encoded by doubling both sides
                return (ExprValue(l.data.to(torch.int64) * 2, l.valid, None),
                        ExprValue(ctx.scalar(idx * 2 if exact else idx * 2 - 1,
                                             torch.int64), r.valid, None), True)
            if len(l.dictionary) == 1:
                word = l.dictionary[0]
                idx = int(np.searchsorted(np.array(r.dictionary, dtype=object), word))
                exact = idx < len(r.dictionary) and r.dictionary[idx] == word
                return (ExprValue(ctx.scalar(idx * 2 if exact else idx * 2 - 1,
                                             torch.int64), l.valid, None),
                        ExprValue(r.data.to(torch.int64) * 2, r.valid, None), True)
            # two dictionary-coded columns: merge the host dictionaries and
            # remap both code spaces on the device
            from .columnar import merge_dictionaries
            _merged, ra, rb = merge_dictionaries(l.dictionary, r.dictionary)
            ldata, rdata = l.data, r.data
            if len(ra):
                ldata = constant(ra, ctx.device)[
                    ldata.long().clamp(0, len(ra) - 1)]
            if len(rb):
                rdata = constant(rb, ctx.device)[
                    rdata.long().clamp(0, len(rb) - 1)]
            return (ExprValue(ldata, l.valid, None),
                    ExprValue(rdata, r.valid, None), True)
        raise AnalysisException("cannot compare string with non-string")
    return l, r, False


def _as_type(data: torch.Tensor, src: T.DataType,
             dst: T.DataType) -> torch.Tensor:
    """``data`` of type ``src`` in the device representation of ``dst``.
    A decimal is held as its value times 10**scale, so one that meets a
    float, an integer or another scale is rescaled first (the JAX
    package compares the held integers as they are: ROADMAP §3)."""
    s_src = src.scale if isinstance(src, T.DecimalType) else None
    s_dst = dst.scale if isinstance(dst, T.DecimalType) else None
    if s_src == s_dst or isinstance(src, T.NullType):
        return data.to(dst.torch_dtype)
    if s_dst is None:                  # decimal -> float
        return (data.to(torch.float64) / 10 ** s_src).to(dst.torch_dtype)
    return data.to(torch.int64) * 10 ** (s_dst - (s_src or 0))


class BinaryComparison(Expression):
    op_name = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def data_type(self, schema):
        lt_, rt = (c.data_type(schema) for c in self.children)
        if T.common_type(lt_, rt) is None and not (lt_ == rt):
            raise AnalysisException(f"cannot compare {lt_} and {rt}")
        return T.boolean

    def _compute(self, a, b):
        raise NotImplementedError

    def _operands(self, ctx: EvalContext):
        """Both sides' values and their data in one comparable form: the
        common type's device representation."""
        l, r, is_str = _comparison_operands(ctx, *self.children)
        if is_str:
            return l, r, l.data, r.data
        schema = ctx.batch.schema
        lt_, rt = (c.data_type(schema) for c in self.children)
        ct = T.common_type(lt_, rt) or T.float64
        return l, r, _as_type(l.data, lt_, ct), _as_type(r.data, rt, ct)

    def eval(self, ctx: EvalContext) -> ExprValue:
        l, r, a, b = self._operands(ctx)
        return ExprValue(self._compute(a, b), and_valid(l.valid, r.valid))

    def __repr__(self):
        return f"({self.children[0]!r} {self.op_name} {self.children[1]!r})"


class EQ(BinaryComparison):
    op_name = "="
    def _compute(self, a, b): return a == b


class NE(BinaryComparison):
    op_name = "!="
    def _compute(self, a, b): return a != b


class LT(BinaryComparison):
    op_name = "<"
    def _compute(self, a, b): return a < b


class LE(BinaryComparison):
    op_name = "<="
    def _compute(self, a, b): return a <= b


class GT(BinaryComparison):
    op_name = ">"
    def _compute(self, a, b): return a > b


class GE(BinaryComparison):
    op_name = ">="
    def _compute(self, a, b): return a >= b


class EqNullSafe(BinaryComparison):
    """<=> : NULL-safe equality, never NULL itself."""

    op_name = "<=>"

    def eval(self, ctx: EvalContext) -> ExprValue:
        l, r, a, b = self._operands(ctx)
        lv = l.valid if l.valid is not None else _true(l.data)
        rv = r.valid if r.valid is not None else _true(r.data)
        eq = (a == b) & lv & rv
        both_null = ~lv & ~rv
        return ExprValue(eq | both_null, None)


class And(Expression):
    """Kleene AND: F & NULL = F, T & NULL = NULL."""

    def __init__(self, left, right):
        self.children = (left, right)

    def data_type(self, schema):
        return T.boolean

    def eval(self, ctx):
        l, r = (c.eval(ctx) for c in self.children)
        lv = l.valid if l.valid is not None else _true(l.data)
        rv = r.valid if r.valid is not None else _true(r.data)
        data = (l.data | ~lv) & (r.data | ~rv)  # null treated true, then masked
        if l.valid is None and r.valid is None:
            return ExprValue(data, None)
        valid = (lv & rv) | (lv & ~l.data) | (rv & ~r.data)
        return ExprValue(data & valid, valid)

    def __repr__(self):
        return f"({self.children[0]!r} AND {self.children[1]!r})"


class Or(Expression):
    """Kleene OR: T | NULL = T, F | NULL = NULL."""

    def __init__(self, left, right):
        self.children = (left, right)

    def data_type(self, schema):
        return T.boolean

    def eval(self, ctx):
        l, r = (c.eval(ctx) for c in self.children)
        lv = l.valid if l.valid is not None else _true(l.data)
        rv = r.valid if r.valid is not None else _true(r.data)
        data = (l.data & lv) | (r.data & rv)
        valid = (lv & rv) | (lv & l.data) | (rv & r.data)
        if l.valid is None and r.valid is None:
            valid = None
        return ExprValue(data, valid)

    def __repr__(self):
        return f"({self.children[0]!r} OR {self.children[1]!r})"


class Not(Expression):
    def __init__(self, child):
        self.children = (child,)

    def data_type(self, schema):
        return T.boolean

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        return ExprValue(~v.data, v.valid)

    def __repr__(self):
        return f"(NOT {self.children[0]!r})"


# ---------------------------------------------------------------------------
# Null handling & conditionals (nullExpressions.scala, conditionalExpressions.scala)
# ---------------------------------------------------------------------------

class IsNull(Expression):
    def __init__(self, child):
        self.children = (child,)

    def data_type(self, schema):
        return T.boolean

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        if v.valid is None:
            return ExprValue(ctx.scalar(False, torch.bool), None)
        return ExprValue(~v.valid, None)

    def __repr__(self):
        return f"({self.children[0]!r} IS NULL)"


class IsNotNull(Expression):
    def __init__(self, child):
        self.children = (child,)

    def data_type(self, schema):
        return T.boolean

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        if v.valid is None:
            return ExprValue(ctx.scalar(True, torch.bool), None)
        return ExprValue(v.valid, None)

    def __repr__(self):
        return f"({self.children[0]!r} IS NOT NULL)"


def _align_value_dicts(ctx: EvalContext, vals):
    """Re-encode ExprValues that carry different string dictionaries onto
    one merged dictionary (host-merged, device-gathered).
    Returns (vals, merged_dictionary_or_None)."""
    dicts = [v.dictionary for v in vals if v.dictionary is not None]
    if not dicts:
        return vals, None
    if all(d == dicts[0] for d in dicts):
        return vals, dicts[0]
    merged = tuple(sorted(set().union(*[set(d) for d in dicts])))
    lookup = {w: i for i, w in enumerate(merged)}
    out = []
    for v in vals:
        if v.dictionary is None:
            out.append(v)
            continue
        remap = constant(
            np.fromiter((lookup[w] for w in v.dictionary), np.int32,
                        count=len(v.dictionary)), ctx.device)
        out.append(ExprValue(remap[v.data.long().clamp(min=0)], v.valid,
                             merged))
    return out, merged


class Coalesce(Expression):
    def __init__(self, *children):
        self.children = tuple(children)

    def data_type(self, schema):
        out = T.null_type
        for c in self.children:
            nxt = T.common_type(out, c.data_type(schema))
            if nxt is None:
                raise AnalysisException("incompatible coalesce branches")
            out = nxt
        return out

    def eval(self, ctx):
        tdt = self.data_type(ctx.batch.schema).torch_dtype
        vals = [c.eval(ctx) for c in self.children]
        vals, merged = _align_value_dicts(ctx, vals)
        out = ExprValue(vals[-1].data.to(tdt), vals[-1].valid, merged)
        for v in reversed(vals[:-1]):
            if v.valid is None:
                out = ExprValue(v.data.to(tdt), None, out.dictionary)
            else:
                taken_valid = out.valid if out.valid is not None \
                    else _true(v.data)
                out = ExprValue(
                    torch.where(v.valid, v.data.to(tdt), out.data),
                    v.valid | taken_valid, out.dictionary)
        return out

    def __repr__(self):
        return f"coalesce({', '.join(map(repr, self.children))})"


class If(Expression):
    def __init__(self, pred, then, otherwise):
        self.children = (pred, then, otherwise)

    def data_type(self, schema):
        t = T.common_type(self.children[1].data_type(schema),
                          self.children[2].data_type(schema))
        if t is None:
            raise AnalysisException("IF branches have incompatible types")
        return t

    def eval(self, ctx):
        p, a, b = (c.eval(ctx) for c in self.children)
        tdt = self.data_type(ctx.batch.schema).torch_dtype
        (a, b), merged = _align_value_dicts(ctx, [a, b])
        cond = p.data if p.valid is None else (p.data & p.valid)
        data = torch.where(cond, a.data.to(tdt), b.data.to(tdt))
        av = a.valid if a.valid is not None else _true(cond)
        bv = b.valid if b.valid is not None else _true(cond)
        valid = None if (a.valid is None and b.valid is None) \
            else torch.where(cond, av, bv)
        return ExprValue(data, valid, merged)

    def __repr__(self):
        p, a, b = self.children
        return f"if({p!r}, {a!r}, {b!r})"


class CaseWhen(Expression):
    """CASE WHEN p1 THEN v1 ... ELSE d END — desugars to nested If at eval."""

    def __init__(self, branches: Sequence[Tuple[Expression, Expression]],
                 otherwise: Optional[Expression] = None):
        self.branches = [(p, v) for p, v in branches]
        self.otherwise = otherwise if otherwise is not None else Literal(None)
        flat: List[Expression] = []
        for p, v in self.branches:
            flat += [p, v]
        flat.append(self.otherwise)
        self.children = tuple(flat)

    def map_children(self, fn):
        new_branches = [(fn(p), fn(v)) for p, v in self.branches]
        return CaseWhen(new_branches, fn(self.otherwise))

    def _as_if(self) -> Expression:
        node: Expression = self.otherwise
        for p, v in reversed(self.branches):
            node = If(p, v, node)
        return node

    def data_type(self, schema):
        return self._as_if().data_type(schema)

    def eval(self, ctx):
        return self._as_if().eval(ctx)

    def __repr__(self):
        parts = " ".join(f"WHEN {p!r} THEN {v!r}" for p, v in self.branches)
        return f"CASE {parts} ELSE {self.otherwise!r} END"


class In(Expression):
    """`x IN (lit, lit, ...)` — ORs of equality."""

    def __init__(self, child: Expression, values: Sequence[Any]):
        self.children = (child,)
        self.values = [v.value if isinstance(v, Literal) else v for v in values]

    def data_type(self, schema):
        return T.boolean

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        if v.dictionary is not None:
            member = constant(
                np.array([w in set(self.values) for w in v.dictionary], bool),
                ctx.device)
            if not len(v.dictionary):
                return ExprValue(torch.zeros_like(v.data, dtype=torch.bool),
                                 v.valid)
            hit = member[v.data.long().clamp(0, len(v.dictionary) - 1)]
            return ExprValue((v.data >= 0) & hit, v.valid)
        data = v.data
        dt = self.children[0].data_type(ctx.batch.schema)
        if isinstance(dt, T.DecimalType):
            data = _as_type(data, dt, T.float64)
        acc = ctx.scalar(False, torch.bool)
        for val in self.values:
            acc = acc | (data == val)
        return ExprValue(acc, v.valid)

    def __repr__(self):
        return f"({self.children[0]!r} IN {tuple(self.values)!r})"


class Between(Expression):
    def __repr__(self):
        c = self.children
        return f"({c[0]!r} BETWEEN {c[1]!r} AND {c[2]!r})"

    def __init__(self, child, low, high):
        self.children = (child, _wrap(low), _wrap(high))

    def data_type(self, schema):
        return T.boolean

    def eval(self, ctx):
        c, lo, hi = self.children
        return And(GE(c, lo), LE(c, hi)).eval(ctx)


def _dict_gather(ctx: EvalContext, table: np.ndarray,
                 codes: torch.Tensor) -> torch.Tensor:
    """``table[code]`` per row: the host-built per-word table goes to the
    device in one copy and the rows gather from it (codes of NULL or dead
    rows may be anything; they read some entry under their mask)."""
    t = constant(table, ctx.device)
    return t[codes.long().clamp(0, len(table) - 1)]


class StringPredicate(Expression):
    """LIKE / startswith / endswith / contains / rlike: host evaluates the
    predicate over the dictionary, device gathers a boolean."""

    def __init__(self, kind: str, child: Expression, pattern: str):
        assert kind in ("like", "startswith", "endswith", "contains", "rlike")
        self.kind = kind
        self.children = (child,)
        self.pattern = pattern

    def data_type(self, schema):
        return T.boolean

    def _matcher(self) -> Callable[[str], bool]:
        if self.kind == "like":
            # translate SQL LIKE to regex (% -> .*, _ -> .)
            out = []
            i = 0
            p = self.pattern
            while i < len(p):
                ch = p[i]
                if ch == "\\" and i + 1 < len(p):
                    out.append(re.escape(p[i + 1]))
                    i += 2
                    continue
                if ch == "%":
                    out.append(".*")
                elif ch == "_":
                    out.append(".")
                else:
                    out.append(re.escape(ch))
                i += 1
            rx = re.compile("^" + "".join(out) + "$", re.DOTALL)
            return lambda s: rx.match(s) is not None
        if self.kind == "rlike":
            rx = re.compile(self.pattern)
            return lambda s: rx.search(s) is not None
        if self.kind == "startswith":
            return lambda s: s.startswith(self.pattern)
        if self.kind == "endswith":
            return lambda s: s.endswith(self.pattern)
        return lambda s: self.pattern in s

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        m = self._matcher()
        table = np.array([m(w) for w in v.dictionary], bool) \
            if v.dictionary else np.zeros(1, bool)
        return ExprValue(_dict_gather(ctx, table, v.data), v.valid)

    def __repr__(self):
        return f"({self.children[0]!r} {self.kind} {self.pattern!r})"


# ---------------------------------------------------------------------------
# Cast (reference expressions/Cast.scala)
# ---------------------------------------------------------------------------

class Cast(Expression):
    def __init__(self, child: Expression, to: T.DataType):
        self.children = (child,)
        self.to = to

    def data_type(self, schema):
        return self.to

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        src = self.children[0].data_type(ctx.batch.schema)
        to = self.to
        if src == to:
            return v
        if v.dictionary is not None:
            # string → X: parse the dictionary on the host, gather on device
            if to.is_string:
                return v

            def parse(fn, default):
                arr, ok = [], []
                for w in v.dictionary:
                    try:
                        arr.append(fn(w)); ok.append(True)
                    except (ValueError, TypeError):
                        arr.append(default); ok.append(False)
                return (constant(np.array(arr, to.np_dtype), ctx.device),
                        constant(np.array(ok, bool), ctx.device))
            if to.is_numeric:
                if isinstance(to, T.DecimalType):
                    table, ok = parse(lambda w: int(round(float(w) * 10 ** to.scale)), 0)
                else:
                    table, ok = parse(float if to.is_fractional else (lambda w: int(float(w))), 0)
            elif isinstance(to, T.DateType):
                table, ok = parse(lambda w: np.datetime64(w, "D").astype(np.int32), 0)
            elif isinstance(to, T.TimestampType):
                table, ok = parse(lambda w: np.datetime64(w, "us").astype(np.int64), 0)
            elif isinstance(to, T.BooleanType):
                table, ok = parse(lambda w: w.strip().lower() in ("true", "t", "1", "yes", "y"), False)
            else:
                raise AnalysisException(f"unsupported cast string→{to}")
            codes = v.data.long().clamp(min=0)
            return ExprValue(table[codes], and_valid(v.valid, ok[codes]))
        if to.is_string:
            raise AnalysisException(
                "cast to string needs host materialization; it comes with "
                "the SQL front-end slice")
        tdt = to.torch_dtype
        if isinstance(src, T.DecimalType):
            f = v.data.to(torch.float64) / (10 ** src.scale)
            if isinstance(to, T.DecimalType):
                return ExprValue(torch.round(f * 10 ** to.scale).to(torch.int64), v.valid)
            return ExprValue(f.to(tdt), v.valid)
        if isinstance(to, T.DecimalType):
            return ExprValue(torch.round(v.data.to(torch.float64) * 10 ** to.scale)
                             .to(torch.int64), v.valid)
        if isinstance(src, T.DateType) and isinstance(to, T.TimestampType):
            return ExprValue(v.data.to(torch.int64) * 86_400_000_000, v.valid)
        if isinstance(src, T.TimestampType) and isinstance(to, T.DateType):
            return ExprValue(torch.floor_divide(v.data, 86_400_000_000)
                             .to(torch.int32), v.valid)
        if isinstance(to, T.BooleanType):
            return ExprValue(v.data != 0, v.valid)
        # float → integral: JVM-exact semantics ((long)f: truncate toward
        # zero, saturate at long bounds, NaN→0; then wrap into the narrow
        # type) — a direct conversion of out-of-range floats is undefined
        if v.data.dtype.is_floating_point and to.is_integral:
            f = v.data.to(torch.float64)
            t = torch.trunc(torch.where(torch.isnan(f), 0.0, f))
            if np.dtype(to.np_dtype).itemsize >= 8:
                # largest float64 strictly below 2^63 — clipping to
                # float(2^63-1) would round UP to 2^63 and wrap
                lo, hi = float(np.iinfo(np.int64).min), \
                    float(np.nextafter(2.0 ** 63, 0.0))
                sat = int(np.iinfo(np.int64).max)
            else:
                # JVM narrows through int: saturate at int32, then wrap
                lo, hi = float(np.iinfo(np.int32).min), \
                    float(np.iinfo(np.int32).max)
                sat = int(np.iinfo(np.int32).max)
            out = torch.clamp(t, lo, hi).to(torch.int64)
            out = torch.where(t > hi, torch.full_like(out, sat), out)
            return ExprValue(out.to(tdt), v.valid)
        # numeric/bool → numeric (truncating float→int like Spark)
        return ExprValue(v.data.to(tdt), v.valid)

    def __repr__(self):
        return f"CAST({self.children[0]!r} AS {self.to!r})"


# ---------------------------------------------------------------------------
# Hashing — bit-exact with the JAX package for partitioning and joins
# ---------------------------------------------------------------------------

def _u64(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def lsr64(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits: torch's ``>>`` is arithmetic, so
    mask off the copies of the sign bit."""
    return (x >> k) & ((1 << (64 - k)) - 1)


class Hash64(Expression):
    """Deterministic 64-bit mix hash (splitmix64/murmur3 finalizer) of one
    or more columns, bit-identical to ``spark_tpu.expressions.Hash64``:
    the uint64 arithmetic there is wrapping int64 arithmetic here, with
    logical shifts written out.  NULL hashes to a fixed constant; string
    columns hash their dictionary WORDS (host blake2b), not codes."""

    NULL_HASH = _u64(0x9E3779B97F4A7C15)

    def __init__(self, *children):
        self.children = tuple(children)

    def data_type(self, schema):
        return T.int64

    @staticmethod
    def _mix(x: torch.Tensor) -> torch.Tensor:
        c1 = _u64(0xFF51AFD7ED558CCD)
        c2 = _u64(0xC4CEB9FE1A85EC53)
        x = x ^ lsr64(x, 33)
        x = x * c1
        x = x ^ lsr64(x, 33)
        x = x * c2
        x = x ^ lsr64(x, 33)
        return x

    @staticmethod
    def _string_hash_table(dictionary: Tuple[str, ...]) -> np.ndarray:
        import hashlib
        out = np.zeros(max(len(dictionary), 1), np.int64)
        for i, w in enumerate(dictionary):
            data = w if isinstance(w, bytes) else str(w).encode("utf-8")
            h = hashlib.blake2b(data, digest_size=8).digest()
            out[i] = np.frombuffer(h, np.int64)[0]
        return out

    def eval(self, ctx):
        acc = ctx.scalar(42, torch.int64)
        for c in self.children:
            v = c.eval(ctx)
            if v.dictionary is not None:
                # clip BOTH ends: NULL (-1) codes and out-of-dictionary
                # sentinels must gather in bounds; both are masked downstream
                table = constant(self._string_hash_table(v.dictionary),
                                 ctx.device)
                h = table[v.data.long().clamp(0, max(len(v.dictionary) - 1, 0))]
            else:
                bits = v.data
                if bits.dtype.is_floating_point:
                    # normalize -0.0 → 0.0 then reinterpret the float64 bits
                    bits = torch.where(bits == 0, torch.zeros((), dtype=bits.dtype,
                                                              device=bits.device), bits)
                    bits = bits.to(torch.float64).contiguous().view(torch.int64)
                h = self._mix(bits.to(torch.int64))
            if v.valid is not None:
                h = torch.where(v.valid, h, ctx.scalar(self.NULL_HASH, torch.int64))
            acc = self._mix(acc * 31 + h)
        return ExprValue(acc, None)

    def __repr__(self):
        return f"hash64({', '.join(map(repr, self.children))})"


# ---------------------------------------------------------------------------
# Expression breadth: math (mathExpressions.scala), strings
# (stringExpressions.scala), dates (datetimeExpressions.scala) and the
# grouping-set marker, as in ``spark_tpu/expressions.py``.  String
# functions rewrite the dictionary on the host and gather codes on the
# device; every host-built table is a ``capture.constant``.
# ---------------------------------------------------------------------------

def _div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a host float ``c``, IEEE-divided on every device: CUDA
    turns a division by a host scalar into a multiplication by its
    reciprocal, whose last bit can differ from numpy's quotient (round
    gave 49.160000000000004 for 49.16 on an H100)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _as_float64(ctx: EvalContext, v: ExprValue, e: Expression) -> torch.Tensor:
    """``v`` (the value of ``e``) as float64 values: a decimal is its value,
    not its held integer (the JAX package converts the held integer:
    ROADMAP §3)."""
    return _as_type(v.data, e.data_type(ctx.batch.schema), T.float64)


class Pow(BinaryArithmetic):
    op_name = "pow"

    def data_type(self, schema):
        return T.float64

    def _compute(self, a, b):
        return torch.pow(a, b)


class UnaryMath(Expression):
    """sqrt/exp/log/sin/... — float64 elementwise functions; a domain error
    (log of <= 0, sqrt of < 0) is NULL."""

    FNS = {
        "sqrt": (lambda x: torch.sqrt(torch.clamp(x, min=0.0)), lambda x: x >= 0),
        "exp": (torch.exp, None),
        "ln": (lambda x: torch.log(torch.where(x > 0, x, 1.0)), lambda x: x > 0),
        "log10": (lambda x: torch.log10(torch.where(x > 0, x, 1.0)),
                  lambda x: x > 0),
        "log2": (lambda x: torch.log2(torch.where(x > 0, x, 1.0)),
                 lambda x: x > 0),
        "sin": (torch.sin, None),
        "cos": (torch.cos, None),
        "tan": (torch.tan, None),
        "asin": (lambda x: torch.asin(torch.clamp(x, -1, 1)),
                 lambda x: torch.abs(x) <= 1),
        "acos": (lambda x: torch.acos(torch.clamp(x, -1, 1)),
                 lambda x: torch.abs(x) <= 1),
        "atan": (torch.atan, None),
        "sinh": (torch.sinh, None),
        "cosh": (torch.cosh, None),
        "tanh": (torch.tanh, None),
        "floor": (torch.floor, None),
        "ceil": (torch.ceil, None),
        "radians": (lambda x: x * (np.pi / 180.0), None),
        "degrees": (lambda x: x * (180.0 / np.pi), None),
        "log1p": (lambda x: torch.log1p(torch.where(x > -1, x, 0.0)),
                  lambda x: x > -1),
        "expm1": (torch.expm1, None),
        "cbrt": (lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0), None),
        "rint": (torch.round, None),
        "abs": (None, None),
        "sign": (None, None),
    }

    def __init__(self, fn: str, child: Expression):
        assert fn in self.FNS, fn
        self.fn = fn
        self.children = (child,)

    def data_type(self, schema):
        if self.fn in ("floor", "ceil"):
            return T.int64
        if self.fn in ("abs", "sign"):
            return self.children[0].data_type(schema)
        return T.float64

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        if self.fn == "abs":
            return ExprValue(torch.abs(v.data), v.valid)
        if self.fn == "sign":
            dt = self.children[0].data_type(ctx.batch.schema)
            out = torch.sign(v.data)
            if out.dtype.is_floating_point:
                # torch gives sign(NaN) = 0; numpy, Spark: NaN
                out = torch.where(torch.isnan(v.data), v.data, out)
            if isinstance(dt, T.DecimalType):
                out = out * 10 ** dt.scale        # the value ±1, held scaled
            return ExprValue(out, v.valid)
        x = _as_float64(ctx, v, self.children[0])
        fn, domain = self.FNS[self.fn]
        out = fn(x)
        valid = v.valid
        if domain is not None:
            valid = and_valid(valid, domain(x))
        if self.fn in ("floor", "ceil"):
            out = out.to(torch.int64)
        return ExprValue(out, valid)

    def __repr__(self):
        return f"{self.fn}({self.children[0]!r})"


class RoundExpr(Expression):
    """round(x, d), HALF_UP.  A double rounds by the JAX package's formula
    (``floor(|x| * 10^d + 0.5) / 10^d * sign(x)``), so the bits match it.  A
    decimal(p, s) with d < s becomes decimal(p, d), rounded HALF_UP on
    its held integer, as Spark rounds it (the JAX package returns any
    non-float unchanged: ROADMAP §3).  Integers pass through."""

    def __init__(self, child: Expression, scale: int = 0):
        self.children = (child,)
        self.scale = scale

    def data_type(self, schema):
        dt = self.children[0].data_type(schema)
        if isinstance(dt, T.DecimalType) and 0 <= self.scale < dt.scale:
            return T.DecimalType(dt.precision, self.scale)
        return dt if dt.is_numeric else T.float64

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        src = self.children[0].data_type(ctx.batch.schema)
        out_dt = self.data_type(ctx.batch.schema)
        if isinstance(src, T.DecimalType) and out_dt != src:
            step = 10 ** (src.scale - self.scale)
            held = v.data.to(torch.int64)
            mag = (torch.abs(held) + step // 2) // step
            return ExprValue(torch.sign(held) * mag, v.valid)
        if not v.data.dtype.is_floating_point:
            return v
        factor = 10.0 ** self.scale
        out = _div_exact(torch.floor(torch.abs(v.data) * factor + 0.5),
                         factor) * torch.sign(v.data)
        return ExprValue(out, v.valid)

    def __repr__(self):
        return f"round({self.children[0]!r}, {self.scale})"


class IsNaN(Expression):
    def __init__(self, child):
        self.children = (child,)

    def data_type(self, schema):
        return T.boolean

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        if not v.data.dtype.is_floating_point:
            return ExprValue(ctx.scalar(False, torch.bool), None)
        return ExprValue(torch.isnan(v.data), None)

    def __repr__(self):
        return f"isnan({self.children[0]!r})"


class Greatest(Expression):
    """greatest(a, b, ...): NULL when any input is NULL (as the JAX package
    does it); operands meet in their promoted type."""

    _op = staticmethod(torch.maximum)

    def __init__(self, *children):
        self.children = tuple(children)

    def data_type(self, schema):
        out = self.children[0].data_type(schema)
        for c in self.children[1:]:
            out = T.numeric_promote(out, c.data_type(schema))
        return out

    def eval(self, ctx):
        schema = ctx.batch.schema
        dt = self.data_type(schema)
        out, valid = None, None
        for i, c in enumerate(self.children):
            v = c.eval(ctx)
            d = _as_type(v.data, c.data_type(schema), dt)
            out = d if out is None else self._op(out, d)
            valid = v.valid if i == 0 else and_valid(valid, v.valid)
        return ExprValue(out, valid)

    def __repr__(self):
        return f"{type(self).__name__.lower()}" \
               f"({', '.join(map(repr, self.children))})"


class Least(Greatest):
    _op = staticmethod(torch.minimum)


class BinaryMath(Expression):
    """hypot/atan2/nanvl — float64 elementwise binaries."""

    FNS = {
        "hypot": torch.hypot,
        "atan2": torch.atan2,
        "nanvl": lambda a, b: torch.where(torch.isnan(a), b, a),
    }

    def __init__(self, fn: str, left: Expression, right: Expression):
        assert fn in self.FNS, fn
        self.fn = fn
        self.children = (left, right)

    def data_type(self, schema):
        return T.float64

    def eval(self, ctx):
        a = ctx.broadcast(self.children[0].eval(ctx))
        b = ctx.broadcast(self.children[1].eval(ctx))
        out = self.FNS[self.fn](_as_float64(ctx, a, self.children[0]),
                                _as_float64(ctx, b, self.children[1]))
        return ExprValue(out, and_valid(a.valid, b.valid))

    def __repr__(self):
        return f"{self.fn}({self.children[0]!r}, {self.children[1]!r})"


# ---- strings: the host rewrites the dictionary, the device gathers codes --

def _rewrite_dictionary(ctx: EvalContext, v: ExprValue, fn,
                        empty: Tuple[str, ...] = ("",)) -> ExprValue:
    """The contract of every string→string transform: each word through
    ``fn`` on the host, the results re-sorted into a new dictionary (so
    comparisons by code stay order-correct), and a per-code remap table
    gathered on the device.  An empty dictionary becomes ``empty``."""
    transformed = [fn(w) for w in (v.dictionary or ())]
    new_dict = tuple(sorted(set(transformed))) or empty
    pos = {w: i for i, w in enumerate(new_dict)}
    remap = np.array([pos[w] for w in transformed], np.int32) \
        if transformed else np.zeros(1, np.int32)
    return ExprValue(_dict_gather(ctx, remap, v.data), v.valid, new_dict)


def _string_input(e: "Expression", schema, what: str) -> None:
    ct = e.data_type(schema)
    if not ct.is_string:
        raise AnalysisException(f"{what} expects string, got {ct}")


class StringTransform(Expression):
    """upper/lower/trim/reverse/initcap."""

    FNS = {
        "upper": str.upper,
        "lower": str.lower,
        "trim": str.strip,
        "ltrim": str.lstrip,
        "rtrim": str.rstrip,
        "reverse": lambda s: s[::-1],
        "initcap": lambda s: s.title(),
    }

    def __init__(self, fn: str, child: Expression):
        assert fn in self.FNS
        self.fn = fn
        self.children = (child,)

    def data_type(self, schema):
        _string_input(self.children[0], schema, self.fn)
        return T.string

    def eval(self, ctx):
        return _rewrite_dictionary(ctx, self.children[0].eval(ctx),
                                   self.FNS[self.fn])

    def __repr__(self):
        return f"{self.fn}({self.children[0]!r})"


class Substring(Expression):
    """substring(s, pos, len) with literal pos/len (1-based; a negative pos
    counts from the end)."""

    def __init__(self, child: Expression, pos: int, length: int):
        self.children = (child,)
        self.pos = pos
        self.length = length

    def data_type(self, schema):
        return T.string

    def _cut(self, w: str) -> str:
        start = self.pos - 1 if self.pos > 0 else self.pos
        s = w[start:] if start >= 0 else w[len(w) + start:]
        return s[:self.length]

    def eval(self, ctx):
        # an empty dictionary stays empty (the JAX package's rule here)
        return _rewrite_dictionary(ctx, self.children[0].eval(ctx),
                                   self._cut, empty=())

    def __repr__(self):
        return f"substring({self.children[0]!r}, {self.pos}, {self.length})"


class StringLength(Expression):
    def __init__(self, child):
        self.children = (child,)

    def data_type(self, schema):
        return T.int32

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        lens = np.array([len(w) for w in v.dictionary], np.int32) \
            if v.dictionary else np.zeros(1, np.int32)
        return ExprValue(_dict_gather(ctx, lens, v.data), v.valid)

    def __repr__(self):
        return f"length({self.children[0]!r})"


class Concat(Expression):
    """concat of string columns and literals.  The output dictionary is the
    cross product of the inputs' dictionaries, re-sorted; a product above
    ``MAX_DICT`` words is refused."""

    MAX_DICT = 1 << 20

    def __init__(self, *children):
        self.children = tuple(children)

    def data_type(self, schema):
        return T.string

    def eval(self, ctx):
        vals = [c.eval(ctx) for c in self.children]
        dicts = [v.dictionary if v.dictionary is not None else ("",)
                 for v in vals]
        size = 1
        for d in dicts:
            size *= max(len(d), 1)
        if size > self.MAX_DICT:
            raise AnalysisException(
                f"concat dictionary blowup ({size}); use host path")
        # pairwise fold: two dictionary-coded values at a time, through one
        # flattened (left code, right code) table
        cur, cur_dict = vals[0], dicts[0]
        for v, d in zip(vals[1:], dicts[1:]):
            new_dict = tuple(sorted({a + b for a in cur_dict for b in d}))
            pos = {w: i for i, w in enumerate(new_dict)}
            remap = np.array([pos[a + b] for a in cur_dict for b in d],
                             np.int32)
            width = max(len(d), 1)
            if not remap.size:
                remap, width = np.zeros(1, np.int32), 1
            left = cur.data.long().clamp(min=0)
            right = v.data.long().clamp(0, width - 1)
            code = _dict_gather(ctx, remap, left * width + right)
            cur = ExprValue(code, and_valid(cur.valid, v.valid), new_dict)
            cur_dict = new_dict
        return cur

    def __repr__(self):
        return f"concat({', '.join(map(repr, self.children))})"


def _soundex(word: str) -> str:
    codes = {"b": "1", "f": "1", "p": "1", "v": "1",
             "c": "2", "g": "2", "j": "2", "k": "2", "q": "2", "s": "2",
             "x": "2", "z": "2", "d": "3", "t": "3", "l": "4",
             "m": "5", "n": "5", "r": "6"}
    w = "".join(c for c in word.upper() if c.isalpha())
    if not w:
        return word
    out = [w[0]]
    prev = codes.get(w[0].lower(), "")
    for c in w[1:]:
        code = codes.get(c.lower(), "")
        if code and code != prev:
            out.append(code)
        if c.lower() not in ("h", "w"):
            prev = code
    return (out[0] + "".join(out[1:]) + "000")[:4]


class ParamStringTransform(Expression):
    """String→string transforms with literal parameters (regexp_replace,
    lpad, translate, md5, ...), under the dictionary-rewrite contract."""

    @staticmethod
    def _make(kind, params):
        import base64 as b64
        import hashlib
        if kind == "regexp_replace":
            pat, repl = params
            rx = re.compile(pat)
            return lambda s: rx.sub(repl, s)
        if kind == "regexp_extract":
            pat, idx = params
            rx = re.compile(pat)

            def ex(s):
                m = rx.search(s)
                return m.group(idx) if m else ""
            return ex
        if kind == "lpad":
            n, pad = params
            return lambda s: s.rjust(n, pad)[:n] if pad else s[:n]
        if kind == "rpad":
            n, pad = params
            return lambda s: s.ljust(n, pad)[:n] if pad else s[:n]
        if kind == "translate":
            frm, to = params
            table = str.maketrans(frm[:len(to)], to[:len(frm)],
                                  frm[len(to):])
            return lambda s: s.translate(table)
        if kind == "repeat":
            (n,) = params
            return lambda s: s * n
        if kind == "soundex":
            return _soundex
        if kind == "md5":
            return lambda s: hashlib.md5(s.encode()).hexdigest()
        if kind == "sha1":
            return lambda s: hashlib.sha1(s.encode()).hexdigest()
        if kind == "sha2":
            (bits,) = params
            return lambda s: hashlib.new(f"sha{bits}", s.encode()).hexdigest()
        if kind == "base64":
            return lambda s: b64.b64encode(s.encode()).decode()
        if kind == "unbase64":
            return lambda s: b64.b64decode(s.encode()).decode("utf-8",
                                                              "replace")
        if kind == "hex":
            return lambda s: s.encode().hex().upper()
        raise AnalysisException(f"unknown string transform {kind}")

    def __init__(self, kind: str, child: Expression, params: tuple = ()):
        self.kind = kind
        self.params = tuple(params)
        self._fn = self._make(kind, self.params)
        self.children = (child,)

    def data_type(self, schema):
        _string_input(self.children[0], schema, self.kind)
        return T.string

    def eval(self, ctx):
        return _rewrite_dictionary(ctx, self.children[0].eval(ctx), self._fn)

    def __repr__(self):
        return f"{self.kind}({self.children[0]!r}, {self.params})"


class StringToInt(Expression):
    """String→int64 through a host-computed per-word table (instr, locate,
    levenshtein against a literal, crc32)."""

    @staticmethod
    def _make(kind, params):
        import zlib
        if kind == "instr":
            (sub,) = params
            return lambda s: s.find(sub) + 1
        if kind == "locate":
            sub, start = params
            return lambda s: s.find(sub, max(start - 1, 0)) + 1
        if kind == "levenshtein":
            (other,) = params

            def lev(s):
                a, b = s, other
                if len(a) < len(b):
                    a, b = b, a
                prev = list(range(len(b) + 1))
                for i, ca in enumerate(a, 1):
                    cur = [i]
                    for j, cb in enumerate(b, 1):
                        cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                                       prev[j - 1] + (ca != cb)))
                    prev = cur
                return prev[-1]
            return lev
        if kind == "crc32":
            return lambda s: zlib.crc32(s.encode()) & 0xFFFFFFFF
        raise AnalysisException(f"unknown string→int transform {kind}")

    def __init__(self, kind: str, child: Expression, params: tuple = ()):
        self.kind = kind
        self.params = tuple(params)
        self._fn = self._make(kind, self.params)
        self.children = (child,)

    def data_type(self, schema):
        _string_input(self.children[0], schema, self.kind)
        return T.int64

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        table = np.array([self._fn(w) for w in (v.dictionary or ())] or [0],
                         np.int64)
        return ExprValue(_dict_gather(ctx, table, v.data), v.valid)

    def __repr__(self):
        return f"{self.kind}({self.children[0]!r}, {self.params})"


# ---- dates: integer calendar arithmetic (Hinnant's civil algorithms) -----

_US_PER_DAY = 86_400_000_000


def _civil_ymd_vec(days: torch.Tensor):
    """(y, m, d) int64 tensors from day numbers (civil_from_days)."""
    z = days + 719_468
    era = z // 146_097
    doe = z - era * 146_097
    yoe = (doe - doe // 1460 + doe // 36_524 - doe // 146_096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y: torch.Tensor, m: int, d: int) -> torch.Tensor:
    """Day numbers of years ``y`` at a fixed month and day."""
    y = y - (1 if m <= 2 else 0)
    era = y // 400
    yoe = y - era * 400
    mp = (m + 9) % 12
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146_097 + doe - 719_468


def _days_from_civil_vec(y, m, d):
    """Day numbers from (y, m, d) int64 tensors (days_from_civil)."""
    y = torch.where(m <= 2, y - 1, y)
    era = y // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146_097 + doe - 719_468


_MONTH_DAYS = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                       np.int64)


def _month_len_vec(ctx: EvalContext, y, m):
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    base = constant(_MONTH_DAYS, ctx.device)[torch.clamp(m - 1, 0, 11)]
    return torch.where((m == 2) & leap, 29, base)


def _as_days(v: ExprValue, dt: T.DataType) -> torch.Tensor:
    if isinstance(dt, T.TimestampType):
        return v.data.to(torch.int64) // _US_PER_DAY
    if isinstance(dt, T.DateType) or dt.is_integral:
        return v.data.to(torch.int64)
    raise AnalysisException(f"expected a date/timestamp, got {dt}")


def parse_duration(text) -> int:
    """'10 seconds' / '5 minutes' / '1 hour' / '2 days' -> microseconds
    (fixed-length units only: months and years are not fixed durations)."""
    if isinstance(text, (int, float)):
        return int(text)
    parts = str(text).strip().lower().split()
    if len(parts) != 2:
        raise AnalysisException(
            f"cannot parse duration {text!r}: expected '<n> <unit>'")
    try:
        n = float(parts[0])
    except ValueError:
        raise AnalysisException(f"cannot parse duration {text!r}")
    unit = parts[1].rstrip("s")
    scale = {"microsecond": 1, "millisecond": 1_000, "second": 1_000_000,
             "minute": 60_000_000, "hour": 3_600_000_000,
             "day": 86_400_000_000, "week": 7 * 86_400_000_000}.get(unit)
    if scale is None:
        raise AnalysisException(f"unknown duration unit {parts[1]!r}")
    return int(n * scale)


class TimeWindow(Expression):
    """Tumbling event-time bucket (``TimeWindow.scala``): start =
    floor(ts / duration) * duration; ``field`` picks start or end.  A
    sliding window (slide < duration) is expanded below its aggregate by
    the analyzer and cannot be evaluated as a plain expression."""

    def __init__(self, child: Expression, duration_us: int,
                 slide_us: Optional[int] = None, field: str = "start"):
        if int(duration_us) <= 0:
            raise AnalysisException(
                f"window duration must be positive, got {duration_us}us")
        slide = int(slide_us) if slide_us is not None else int(duration_us)
        if slide <= 0 or int(duration_us) % slide != 0:
            raise AnalysisException(
                "window slide must be positive and divide the duration "
                f"evenly; got duration={duration_us}us slide={slide}us")
        if int(duration_us) // slide > 512:
            raise AnalysisException(
                f"window duration/slide ratio {duration_us // slide} "
                "exceeds the supported maximum of 512 windows per event")
        assert field in ("start", "end"), field
        self.duration_us = int(duration_us)
        self.slide_us = slide
        self.field = field
        self.children = (child,)

    @property
    def is_sliding(self) -> bool:
        return self.slide_us != self.duration_us

    def map_children(self, fn):
        return TimeWindow(fn(self.children[0]), self.duration_us,
                          self.slide_us, self.field)

    @property
    def name(self):
        return "window" if self.field == "start" else "window_end"

    def data_type(self, schema):
        src = self.children[0].data_type(schema)
        if not (isinstance(src, T.TimestampType) or src.is_integral):
            raise AnalysisException(
                f"window() needs a timestamp/integral column, got {src}")
        return T.timestamp

    def eval(self, ctx):
        if self.is_sliding:
            raise AnalysisException(
                "sliding window() must be a grouping key (the analyzer "
                "expands events into their windows); it cannot be "
                "evaluated as a plain expression")
        v = self.children[0].eval(ctx)
        d = self.duration_us
        start = torch.div(v.data.to(torch.int64), d,
                          rounding_mode="floor") * d
        out = start if self.field == "start" else start + d
        return ExprValue(out, v.valid)

    def __repr__(self):
        return (f"window({self.children[0]!r}, {self.duration_us}us"
                + (f", slide={self.slide_us}us" if self.is_sliding else "")
                + f").{self.field}")


class ExtractDatePart(Expression):
    """year/month/day/... of a date (days) or timestamp (microseconds)."""

    PARTS = ("year", "month", "day", "dayofweek", "dayofyear", "quarter",
             "hour", "minute", "second", "weekofyear")

    def __init__(self, part: str, child: Expression):
        assert part in self.PARTS, part
        self.part = part
        self.children = (child,)

    def data_type(self, schema):
        return T.int32

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        src = self.children[0].data_type(ctx.batch.schema)
        if isinstance(src, T.TimestampType):
            days = v.data.to(torch.int64) // _US_PER_DAY
            micros = v.data.to(torch.int64) - days * _US_PER_DAY
        elif isinstance(src, T.DateType):
            days = v.data.to(torch.int64)
            micros = torch.zeros_like(days)
        else:
            raise AnalysisException(f"cannot extract {self.part} from {src}")
        part = self.part
        if part == "hour":
            out = micros // 3_600_000_000
        elif part == "minute":
            out = (micros // 60_000_000) % 60
        elif part == "second":
            out = (micros // 1_000_000) % 60
        elif part == "dayofweek":
            out = (days + 4) % 7 + 1            # 1 = Sunday; 1970-01-01 a Thursday
        elif part == "weekofyear":
            # ISO week: the week of the Thursday of this one
            thursday = days - (days + 3) % 7 + 3
            iso_year, _m, _d = _civil_ymd_vec(thursday)
            jan4 = _days_from_civil(iso_year, 1, 4)
            week1_mon = jan4 - (jan4 + 3) % 7
            out = (days - week1_mon) // 7 + 1
        else:
            y, m, d = _civil_ymd_vec(days)
            if part == "year":
                out = y
            elif part == "month":
                out = m
            elif part == "day":
                out = d
            elif part == "quarter":
                out = (m - 1) // 3 + 1
            else:                               # dayofyear
                out = days - _days_from_civil(y, 1, 1) + 1
        return ExprValue(out.to(torch.int32), v.valid)

    def __repr__(self):
        return f"{self.part}({self.children[0]!r})"


class DateArith(Expression):
    """date_add/date_sub/datediff/add_months/months_between/last_day."""

    KINDS = ("date_add", "date_sub", "datediff", "add_months",
             "months_between", "last_day")

    def __init__(self, kind: str, *children: Expression):
        assert kind in self.KINDS, kind
        self.kind = kind
        self.children = tuple(children)

    def data_type(self, schema):
        if self.kind == "datediff":
            return T.int32
        if self.kind == "months_between":
            return T.float64
        return T.date

    def eval(self, ctx):
        schema = ctx.batch.schema
        a = ctx.broadcast(self.children[0].eval(ctx))
        da = _as_days(a, self.children[0].data_type(schema))
        if self.kind == "last_day":
            y, m, _d = _civil_ymd_vec(da)
            out = _days_from_civil_vec(y, m, _month_len_vec(ctx, y, m))
            return ExprValue(out.to(torch.int32), a.valid)
        b = ctx.broadcast(self.children[1].eval(ctx))
        valid = and_valid(a.valid, b.valid)
        if self.kind in ("date_add", "date_sub"):
            n = b.data.to(torch.int64)
            out = da + (n if self.kind == "date_add" else -n)
            return ExprValue(out.to(torch.int32), valid)
        db = None if self.kind == "add_months" else \
            _as_days(b, self.children[1].data_type(schema))
        if self.kind == "datediff":
            return ExprValue((da - db).to(torch.int32), valid)
        y, m, d = _civil_ymd_vec(da)
        if self.kind == "add_months":
            total = (y * 12 + (m - 1)) + b.data.to(torch.int64)
            ny = total // 12
            nm = total - ny * 12 + 1
            nd = torch.minimum(d, _month_len_vec(ctx, ny, nm))
            out = _days_from_civil_vec(ny, nm, nd)
            return ExprValue(out.to(torch.int32), valid)
        # months_between: whole months when the days of month match or both
        # are month ends, else the day difference / 31, to 8 digits
        y2, m2, d2 = _civil_ymd_vec(db)
        whole = ((y - y2) * 12 + (m - m2)).to(torch.float64)
        last1 = d == _month_len_vec(ctx, y, m)
        last2 = d2 == _month_len_vec(ctx, y2, m2)
        frac = _div_exact((d - d2).to(torch.float64), 31.0)
        out = torch.where((d == d2) | (last1 & last2), whole, whole + frac)
        return ExprValue(_div_exact(torch.round(out * 1e8), 1e8), valid)

    def __repr__(self):
        return f"{self.kind}({', '.join(map(repr, self.children))})"


class NextDay(Expression):
    """next_day(date, 'Mon'): the first later date on that weekday."""

    DOW = {"sun": 0, "mon": 1, "tue": 2, "wed": 3, "thu": 4, "fri": 5,
           "sat": 6}

    def __init__(self, child: Expression, day_name: str):
        key = str(day_name).strip().lower()[:3]
        if key not in self.DOW:
            raise AnalysisException(f"unknown weekday {day_name!r}")
        self.day_name = key
        self.children = (child,)

    def data_type(self, schema):
        return T.date

    def eval(self, ctx):
        v = ctx.broadcast(self.children[0].eval(ctx))
        days = _as_days(v, self.children[0].data_type(ctx.batch.schema))
        cur = (days + 4) % 7                    # 0 = Sunday
        delta = (self.DOW[self.day_name] - cur + 7) % 7
        delta = torch.where(delta == 0, 7, delta)
        return ExprValue((days + delta).to(torch.int32), v.valid)

    def __repr__(self):
        return f"next_day({self.children[0]!r}, {self.day_name!r})"


class TruncDate(Expression):
    """trunc(date, 'year'|'month'|'week'|'quarter') -> date."""

    def __init__(self, child: Expression, fmt: str):
        key = str(fmt).strip().lower()
        key = {"yy": "year", "yyyy": "year", "mm": "month",
               "mon": "month"}.get(key, key)
        if key not in ("year", "month", "week", "quarter"):
            raise AnalysisException(f"unknown trunc unit {fmt!r}")
        self.fmt = key
        self.children = (child,)

    def data_type(self, schema):
        return T.date

    def eval(self, ctx):
        v = ctx.broadcast(self.children[0].eval(ctx))
        days = _as_days(v, self.children[0].data_type(ctx.batch.schema))
        if self.fmt == "week":                  # weeks start on Monday
            out = days - (days + 3) % 7
        else:
            y, m, _d = _civil_ymd_vec(days)
            if self.fmt == "year":
                m = torch.ones_like(m)
            elif self.fmt == "quarter":
                m = ((m - 1) // 3) * 3 + 1
            out = _days_from_civil_vec(y, m, torch.ones_like(days))
        return ExprValue(out.to(torch.int32), v.valid)

    def __repr__(self):
        return f"trunc({self.children[0]!r}, {self.fmt!r})"


class UnixTimestamp(Expression):
    """unix_timestamp(ts) -> seconds since the epoch (int64);
    ``inverse=True`` is from_unixtime, giving a TIMESTAMP (the JAX
    package's deviation: Spark formats a string)."""

    def __init__(self, child: Expression, inverse: bool = False):
        self.inverse = inverse
        self.children = (child,)

    def data_type(self, schema):
        return T.timestamp if self.inverse else T.int64

    def eval(self, ctx):
        v = ctx.broadcast(self.children[0].eval(ctx))
        dt = self.children[0].data_type(ctx.batch.schema)
        data = v.data.to(torch.int64)
        if self.inverse:
            return ExprValue(data * 1_000_000, v.valid)
        if isinstance(dt, T.DateType):
            return ExprValue(data * 86_400, v.valid)
        return ExprValue(data // 1_000_000, v.valid)

    def __repr__(self):
        op = "from_unixtime" if self.inverse else "unix_timestamp"
        return f"{op}({self.children[0]!r})"


class GroupingCall(Expression):
    """grouping(col) / grouping_id() under GROUP BY ROLLUP/CUBE/GROUPING
    SETS: the analyzer's grouping-set rewrite replaces it with a literal
    per branch."""

    def __init__(self, child: Optional[Expression]):
        self.children = (child,) if child is not None else ()

    @property
    def name(self):
        return "grouping_id()" if not self.children \
            else f"grouping({self.children[0].name})"

    def data_type(self, schema):
        return T.int64 if not self.children else T.int32

    def eval(self, ctx):
        raise AnalysisException(
            "grouping()/grouping_id() are only valid with GROUP BY "
            "ROLLUP/CUBE/GROUPING SETS")

    def __repr__(self):
        return self.name


# ---------------------------------------------------------------------------
# Row ids and random draws (``expressions/MonotonicallyIncreasingID.scala``,
# ``randomExpressions.scala``): functions of the row's position, made
# bit-identical to ``spark_tpu.expressions`` (its uint64 arithmetic is
# wrapping int64 arithmetic here, its shifts logical shifts)
# ---------------------------------------------------------------------------

class RowIndex(Expression):
    """Global row id: the batch-local index plus the context's offset
    (``monotonically_increasing_id``; the operator's id and, on the mesh
    lane, the shard sit in the offset's upper bits)."""

    def data_type(self, schema):
        return T.int64

    def eval(self, ctx):
        idx = torch.arange(ctx.capacity, dtype=torch.int64,
                           device=ctx.device)
        return ExprValue(idx + ctx.row_offset, None)

    def __repr__(self):
        return "monotonically_increasing_id()"


class Rand(Expression):
    """Deterministic per-row uniform [0, 1): a hash of the row id and the
    seed, so the draws are reproducible and the same on every lane
    (unlike Spark's per-partition XORShiftRandom)."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def data_type(self, schema):
        return T.float64

    def _draw(self, ctx, seed: int) -> torch.Tensor:
        idx = torch.arange(ctx.capacity, dtype=torch.int64,
                           device=ctx.device) + ctx.row_offset
        seed_mix = _u64((seed * 2654435761 + 1) & 0xFFFFFFFFFFFFFFFF)
        mixed = Hash64._mix(idx * _u64(0x9E3779B97F4A7C15) + seed_mix)
        return lsr64(mixed, 11).to(torch.float64) * (1.0 / (1 << 53))

    def eval(self, ctx):
        return ExprValue(self._draw(ctx, self.seed), None)

    def __repr__(self):
        return f"rand({self.seed})"


class Randn(Rand):
    """Standard-normal draws: Box-Muller over two Rand streams."""

    def eval(self, ctx):
        u1 = self._draw(ctx, self.seed).clamp(min=1e-12)
        u2 = self._draw(ctx, self.seed + 0x5DEECE66D)
        out = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * np.pi * u2)
        return ExprValue(out, None)

    def __repr__(self):
        return f"randn({self.seed})"


class SparkPartitionId(Expression):
    """spark_partition_id(): the mesh shard, carried in the row offset's
    bits from 48 up (0 on the single-device lane)."""

    children = ()

    def data_type(self, schema):
        return T.int32

    @property
    def name(self):
        return "SPARK_PARTITION_ID()"

    def eval(self, ctx):
        return ExprValue(ctx.scalar(ctx.row_offset >> 48, torch.int32), None)

    def __repr__(self):
        return "spark_partition_id()"


# ---------------------------------------------------------------------------
# Arrays (``complexTypeCreator.scala``, ``collectionOperations.scala``,
# ``higherOrderFunctions.scala``).  Layout: ``types.ArrayType`` — a
# (capacity, max_len) plane of the element dtype, each row's elements
# first, trailing slots holding the element sentinel.  Sorts along the
# last axis are stable, as the JAX package's are.
# ---------------------------------------------------------------------------

def _array_elem_mask(dt: "T.ArrayType", data: torch.Tensor) -> torch.Tensor:
    if dt.element_type.is_fractional:
        return ~torch.isnan(data)
    return data != dt.element_sentinel().item()


def _sentinel(dt: "T.ArrayType"):
    return dt.element_sentinel().item()


def _pack_front(data: torch.Tensor, keep: torch.Tensor, sent
                ) -> torch.Tensor:
    """The kept elements of each row first, in their order; the other
    slots hold the sentinel (one stable sort of the drop flags)."""
    order = torch.sort((~keep).to(torch.int8), dim=-1, stable=True).indices
    data = torch.take_along_dim(data, order, dim=-1)
    kept = torch.take_along_dim(keep, order, dim=-1)
    return torch.where(kept, data, sent)


def _array_type(e: Expression, schema, what: str) -> "T.ArrayType":
    ct = e.data_type(schema)
    if not isinstance(ct, T.ArrayType):
        raise AnalysisException(f"{what} expects an array, got {ct}")
    return ct


def _extremes(et: T.DataType):
    if et.is_fractional:
        return float("-inf"), float("inf")
    info = np.iinfo(et.np_dtype)
    return int(info.min), int(info.max)


class MakeArray(Expression):
    """array(e1, e2, ...): a fixed-width array from scalar expressions.
    String elements re-code onto one merged dictionary (host remap tables,
    ``capture.constant``s); a NULL element is dropped and the live ones
    packed to the front (the JAX package's deviation: the layout holds no
    NULL element)."""

    def __init__(self, *children: Expression):
        if not children:
            raise AnalysisException("array() needs at least one element")
        self.children = tuple(children)

    def map_children(self, fn):
        return MakeArray(*[fn(c) for c in self.children])

    @property
    def name(self):
        return f"array({', '.join(c.name for c in self.children)})"

    def data_type(self, schema):
        et = self.children[0].data_type(schema)
        for c in self.children[1:]:
            ct = c.data_type(schema)
            et = T.numeric_promote(et, ct) if et != ct else et
        return T.ArrayType(et)

    def eval(self, ctx):
        from .columnar import merge_dictionaries
        dt = self.data_type(ctx.batch.schema)
        et = dt.element_type
        vals = [ctx.broadcast(c.eval(ctx)) for c in self.children]
        sent = _sentinel(dt)
        out_dict = None
        if et.is_string:
            merged = vals[0].dictionary or ("",)
            remaps = [np.arange(len(merged), dtype=np.int32)]
            for v in vals[1:]:
                merged, ra, rb = merge_dictionaries(merged,
                                                    v.dictionary or ("",))
                remaps = [ra[r] for r in remaps] + [rb]
            vals = [ExprValue(constant(r, ctx.device)[
                        v.data.long().clamp(0, len(r) - 1)], v.valid, merged)
                    for v, r in zip(vals, remaps)]
            out_dict = merged
        cols, masks = [], []
        for v in vals:
            d = v.data.to(et.torch_dtype)
            if v.valid is not None:
                d = torch.where(v.valid, d, sent)
            masks.append(v.valid)
            cols.append(d)
        data = torch.stack(cols, dim=-1)
        if any(m is not None for m in masks):
            mask = torch.stack([m if m is not None else
                                torch.ones_like(cols[0], dtype=torch.bool)
                                for m in masks], dim=-1)
            data = _pack_front(data, mask, sent)
        return ExprValue(data, None, out_dict)

    def __repr__(self):
        return f"array({', '.join(map(repr, self.children))})"


class SplitStr(Expression):
    """split(str, regex[, limit]) -> array<string>: the dictionary is split
    on the host, the device gathers each row's element codes from a
    (dictionary size, max parts) table (a ``capture.constant``)."""

    def __init__(self, child: Expression, pattern: str, limit: int = -1):
        self.pattern = pattern
        self.limit = limit
        self.children = (child,)

    def map_children(self, fn):
        return SplitStr(fn(self.children[0]), self.pattern, self.limit)

    @property
    def name(self):
        return f"split({self.children[0].name}, {self.pattern!r})"

    def data_type(self, schema):
        ct = self.children[0].data_type(schema)
        if not ct.is_string:
            raise AnalysisException(f"split expects string, got {ct}")
        return T.ArrayType(T.string)

    def split_table(self, dictionary) -> Tuple[np.ndarray, Tuple[str, ...]]:
        """(code table, element dictionary) of one input dictionary."""
        rx = re.compile(self.pattern)
        # re.split maxsplit: 0 = unlimited; Spark's limit <= 0 splits fully
        maxsplit = 0 if self.limit <= 0 else self.limit - 1
        parts_per_word = [rx.split(w, maxsplit)
                          for w in (dictionary or ("",))]
        elem_dict = tuple(sorted({p for parts in parts_per_word
                                  for p in parts}))
        pos = {w: i for i, w in enumerate(elem_dict)}
        width = max(max((len(p) for p in parts_per_word), default=1), 1)
        table = np.full((len(parts_per_word), width), -1, np.int32)
        for i, parts in enumerate(parts_per_word):
            for j, p in enumerate(parts):
                table[i, j] = pos[p]
        return table, elem_dict

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        table, elem_dict = self.split_table(v.dictionary)
        codes = v.data.long().clamp(0, table.shape[0] - 1)
        return ExprValue(constant(table, ctx.device)[codes], v.valid,
                         elem_dict)

    def __repr__(self):
        return f"split({self.children[0]!r}, {self.pattern!r})"


class ArraySize(Expression):
    """size(arr): the element count (0 for an empty array; a NULL row
    follows the row's mask)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self, schema):
        ct = self.children[0].data_type(schema)
        if isinstance(ct, T.MapType):
            return T.int32        # size(map): rewritten to its keys plane
        if not isinstance(ct, T.ArrayType):
            raise AnalysisException(f"size expects an array, got {ct}")
        return T.int32

    def eval(self, ctx):
        dt = self.children[0].data_type(ctx.batch.schema)
        v = self.children[0].eval(ctx)
        mask = _array_elem_mask(dt, v.data)
        return ExprValue(mask.sum(dim=-1, dtype=torch.int32), v.valid)

    def __repr__(self):
        return f"size({self.children[0]!r})"


def _gather_1based_plane(dt, v: ExprValue, idx, capacity: int,
                         out_dtype: torch.dtype, device):
    """The 1-based array-plane gather (negative counts from the end; 0 or
    out of bounds is NULL), shared by ElementAt (a static index) and
    ArrayGather (an index per row).  Returns (data, ok mask)."""
    width = v.data.shape[-1]
    if width == 0:
        return (torch.zeros(capacity, dtype=out_dtype, device=device),
                torch.zeros(capacity, dtype=torch.bool, device=device))
    lengths = _array_elem_mask(dt, v.data).sum(dim=-1)
    if isinstance(idx, int):
        eff = lengths + idx if idx < 0 else torch.full_like(lengths, idx - 1)
        ok = (eff >= 0) & (eff < lengths)
    else:
        eff = torch.where(idx > 0, idx - 1, lengths + idx)
        ok = (idx != 0) & (eff >= 0) & (eff < lengths)
    gathered = torch.take_along_dim(
        v.data, eff.clamp(0, width - 1)[..., None], dim=-1)[..., 0]
    return gathered, ok


class ElementAt(Expression):
    """element_at(arr, i): 1-based; negative counts from the end; out of
    bounds is NULL (Spark's non-ANSI behavior)."""

    def __init__(self, child: Expression, index: int):
        if index == 0:
            raise AnalysisException("element_at index is 1-based; got 0")
        self.index = int(index)
        self.children = (child,)

    def map_children(self, fn):
        return ElementAt(fn(self.children[0]), self.index)

    @property
    def name(self):
        return f"element_at({self.children[0].name}, {self.index})"

    def data_type(self, schema):
        ct = self.children[0].data_type(schema)
        if isinstance(ct, T.MapType):
            return ct.value_type  # element_at(map, k): rewritten to MapGet
        if not isinstance(ct, T.ArrayType):
            raise AnalysisException(f"element_at expects an array, got {ct}")
        return ct.element_type

    def eval(self, ctx):
        dt = self.children[0].data_type(ctx.batch.schema)
        v = self.children[0].eval(ctx)
        out_dt = self.data_type(ctx.batch.schema).torch_dtype
        gathered, ok = _gather_1based_plane(dt, v, self.index, ctx.capacity,
                                            out_dt, ctx.device)
        return ExprValue(gathered, and_valid(v.valid, ok), v.dictionary)

    def __repr__(self):
        return f"element_at({self.children[0]!r}, {self.index})"


class ArrayReduce(Expression):
    """array_max / array_min: a sentinel-aware reduction over the plane."""

    def __init__(self, child: Expression, op: str):
        self.children = (child,)
        self.op = op                      # "max" | "min"

    def map_children(self, fn):
        return ArrayReduce(fn(self.children[0]), self.op)

    @property
    def name(self):
        return f"array_{self.op}({self.children[0].name})"

    def data_type(self, schema):
        return _array_type(self.children[0], schema,
                           f"array_{self.op}").element_type

    def eval(self, ctx):
        dt = self.children[0].data_type(ctx.batch.schema)
        v = self.children[0].eval(ctx)
        mask = _array_elem_mask(dt, v.data)
        lo, hi = _extremes(dt.element_type)
        filled = torch.where(mask, v.data, lo if self.op == "max" else hi)
        out = torch.amax(filled, dim=-1) if self.op == "max" \
            else torch.amin(filled, dim=-1)
        return ExprValue(out, and_valid(v.valid, mask.any(dim=-1)),
                         v.dictionary)

    def __repr__(self):
        return f"array_{self.op}({self.children[0]!r})"


class SortArray(Expression):
    """sort_array(arr[, asc]): a stable sort of each row's elements, the
    dead slots a trailing sentinel block in either direction."""

    def __init__(self, child: Expression, asc: bool = True):
        self.children = (child,)
        self.asc = bool(asc)

    def map_children(self, fn):
        return SortArray(fn(self.children[0]), self.asc)

    @property
    def name(self):
        return f"sort_array({self.children[0].name}, {self.asc})"

    def data_type(self, schema):
        return _array_type(self.children[0], schema, "sort_array")

    def eval(self, ctx):
        dt = self.children[0].data_type(ctx.batch.schema)
        v = self.children[0].eval(ctx)
        mask = _array_elem_mask(dt, v.data)
        # codes sort as words (sorted dictionaries).  Ascending: dead slots
        # carry the largest value and sink; descending: the smallest, sort
        # ascending, then flip the row (no negation, which would overflow)
        lo, hi = _extremes(dt.element_type)
        order = torch.sort(torch.where(mask, v.data, hi if self.asc else lo),
                           dim=-1, stable=True).indices
        if not self.asc:
            order = torch.flip(order, dims=(-1,))
        data = torch.take_along_dim(v.data, order, dim=-1)
        smask = torch.take_along_dim(mask, order, dim=-1)
        return ExprValue(torch.where(smask, data, _sentinel(dt)), v.valid,
                         v.dictionary)

    def __repr__(self):
        return f"sort_array({self.children[0]!r}, asc={self.asc})"


class ArrayDistinct(Expression):
    """array_distinct(arr): the first occurrence of each element, in order,
    packed to the front."""

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def name(self):
        return f"array_distinct({self.children[0].name})"

    def data_type(self, schema):
        return _array_type(self.children[0], schema, "array_distinct")

    def eval(self, ctx):
        dt = self.children[0].data_type(ctx.batch.schema)
        v = self.children[0].eval(ctx)
        mask = _array_elem_mask(dt, v.data)
        # element j survives iff no earlier equal live element exists: one
        # (L, L) comparison plane per row, L small and static
        width = v.data.shape[-1]
        eq = v.data[..., :, None] == v.data[..., None, :]
        earlier = torch.ones((width, width), dtype=torch.bool,
                             device=ctx.device).tril(diagonal=-1)
        dup = (eq & earlier & mask[..., None, :]
               & mask[..., :, None]).any(dim=-1)
        data = _pack_front(v.data, mask & ~dup, _sentinel(dt))
        return ExprValue(data, v.valid, v.dictionary)

    def __repr__(self):
        return f"array_distinct({self.children[0]!r})"


class ArraySlice(Expression):
    """slice(arr, start, length): 1-based, a negative start counts from the
    end."""

    def __init__(self, child: Expression, start: int, length: int):
        if start == 0:
            raise AnalysisException("slice start is 1-based; got 0")
        if length < 0:
            raise AnalysisException("slice length must be >= 0")
        self.children = (child,)
        self.start = int(start)
        self.length = int(length)

    def map_children(self, fn):
        return ArraySlice(fn(self.children[0]), self.start, self.length)

    @property
    def name(self):
        return f"slice({self.children[0].name}, {self.start}, {self.length})"

    def data_type(self, schema):
        return _array_type(self.children[0], schema, "slice")

    def eval(self, ctx):
        dt = self.children[0].data_type(ctx.batch.schema)
        v = self.children[0].eval(ctx)
        lengths = _array_elem_mask(dt, v.data).sum(dim=-1)
        width = v.data.shape[-1]
        eff = lengths + self.start if self.start < 0 \
            else torch.full_like(lengths, self.start - 1)
        # Spark: a negative start before element 0 gives the EMPTY array,
        # and the live elements land on the output's prefix
        valid_start = (eff >= 0) & (eff < lengths)
        pos = torch.arange(width, dtype=torch.int64, device=ctx.device)
        idx = eff[..., None] + pos
        in_range = valid_start[..., None] & (pos < self.length) \
            & (idx < lengths[..., None])
        gathered = torch.take_along_dim(v.data, idx.clamp(0, width - 1),
                                        dim=-1)
        return ExprValue(torch.where(in_range, gathered, _sentinel(dt)),
                         v.valid, v.dictionary)

    def __repr__(self):
        return f"slice({self.children[0]!r}, {self.start}, {self.length})"


class ArrayPosition(Expression):
    """array_position(arr, value): the 1-based first index, 0 when absent."""

    def __init__(self, child: Expression, value: Any):
        self.children = (child,)
        self.value = value

    def map_children(self, fn):
        return ArrayPosition(fn(self.children[0]), self.value)

    @property
    def name(self):
        return f"array_position({self.children[0].name}, {self.value!r})"

    def data_type(self, schema):
        _array_type(self.children[0], schema, "array_position")
        return T.int64

    def eval(self, ctx):
        dt = self.children[0].data_type(ctx.batch.schema)
        v = self.children[0].eval(ctx)
        mask = _array_elem_mask(dt, v.data)
        if dt.element_type.is_string:
            if v.dictionary is None or self.value not in v.dictionary:
                hit = torch.zeros_like(mask)
            else:
                hit = v.data == v.dictionary.index(self.value)
        else:
            hit = v.data == np.asarray(self.value).astype(
                dt.element_type.np_dtype).item()
        hit = hit & mask
        width = v.data.shape[-1]
        pos = torch.arange(width, dtype=torch.int64, device=ctx.device)
        first = torch.where(hit, pos, width).amin(dim=-1) \
            if width else torch.zeros(ctx.capacity, dtype=torch.int64,
                                      device=ctx.device)
        return ExprValue(torch.where(first < width, first + 1, 0), v.valid)

    def __repr__(self):
        return f"array_position({self.children[0]!r}, {self.value!r})"


class LambdaVar(Expression):
    """A lambda variable bound by a higher-order function to the ELEMENT
    PLANE (``NamedLambdaVariable``): an elementwise body is a plain
    vectorized program over the (capacity, max_len) plane.  ``dtype`` is
    bound by the enclosing function at type resolution.  The analyzer
    renames every variable of a plan ``source#k``, k its position in the
    plan, so two runs of one text key the same stage."""

    _counter = [0]

    def __init__(self, name: str = "x", uid: Optional[int] = None):
        self.children = ()
        if uid is None:
            LambdaVar._counter[0] += 1
            uid = LambdaVar._counter[0]
        self._name = f"{name}#{uid}"
        self.dtype: Optional[T.DataType] = None
        self.dictionary = None

    @property
    def source(self) -> str:
        return self._name.split("#")[0]

    @property
    def name(self):
        return self._name

    def references(self) -> set:
        return set()                   # bound, not a column reference

    def data_type(self, schema):
        if self.dtype is None:
            raise AnalysisException(
                f"lambda variable {self._name} used outside its "
                "higher-order function")
        return self.dtype

    def eval(self, ctx):
        bound = ctx.lambda_bindings.get(self._name)
        if bound is None:
            raise AnalysisException(
                f"lambda variable {self._name} evaluated without a binding")
        return bound

    def __repr__(self):
        return self.source


def _check_lambda_body(*bodies) -> None:
    for body in bodies:
        if body is not None and body.references():
            raise AnalysisException(
                "lambda body may reference only its lambda variables and "
                "literals in this engine (vectorized element-plane "
                f"evaluation); found column refs {sorted(body.references())}")


def _sub_context(ctx, bindings: dict) -> EvalContext:
    sub = EvalContext(ctx.batch, ctx.row_offset)
    sub.lambda_bindings = {**ctx.lambda_bindings, **bindings}
    return sub


class _HigherOrder(Expression):
    """Bind the element plane to the variable, evaluate the body over it.
    ``LAMBDA_VARS`` / ``LAMBDA_BODIES`` name the fields the analyzer's
    lambda resolution renames and substitutes."""

    LAMBDA_VARS = ("var",)
    LAMBDA_BODIES = ("body",)

    def __init__(self, child: Expression, var: LambdaVar, body: Expression):
        self.children = (child,)
        self.var = var
        self.body = body
        _check_lambda_body(body)

    def map_children(self, fn):
        return type(self)(fn(self.children[0]), self.var, self.body)

    def _array_type(self, schema) -> "T.ArrayType":
        ct = _array_type(self.children[0], schema, type(self).__name__)
        self.var.dtype = ct.element_type
        return ct

    def _plane(self, ctx):
        """(body value over the plane, element mask, array value)."""
        dt = self._array_type(ctx.batch.schema)
        v = self.children[0].eval(ctx)
        mask = _array_elem_mask(dt, v.data)
        sub = _sub_context(ctx, {self.var.name: ExprValue(v.data, None,
                                                          v.dictionary)})
        return self.body.eval(sub), mask, v

    def _kind(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return (f"{self._kind()}({self.children[0]!r}, {self.var!r} -> "
                f"{self.body!r})")

    @property
    def name(self):
        return (f"{self._kind()}({self.children[0].name}, {self.var!r} -> "
                f"{self.body.name})")


def _element_result_type(et: T.DataType, what: str) -> T.DataType:
    if et.is_string:
        raise AnalysisException(
            f"{what} to string elements is not supported yet")
    return T.int32 if isinstance(et, T.BooleanType) else et


class ArrayTransform(_HigherOrder):
    """transform(arr, x -> expr): an elementwise map over the plane."""

    def _kind(self):
        return "transform"

    def data_type(self, schema):
        self._array_type(schema)
        return T.ArrayType(_element_result_type(self.body.data_type(schema),
                                                "transform"))

    def eval(self, ctx):
        out, mask, v = self._plane(ctx)
        odt = self.data_type(ctx.batch.schema)
        data = out.data.to(odt.element_type.torch_dtype)
        ok = mask if out.valid is None else (mask & out.valid)
        return ExprValue(torch.where(ok, data, _sentinel(odt)), v.valid)


def _predicate(out: ExprValue) -> torch.Tensor:
    pred = out.data.to(torch.bool)
    return pred if out.valid is None else pred & out.valid


class ArrayFilterFn(_HigherOrder):
    """filter(arr, x -> pred): the matching elements packed to the front,
    in their order."""

    def _kind(self):
        return "filter"

    def data_type(self, schema):
        ct = self._array_type(schema)
        bt = self.body.data_type(schema)
        if not isinstance(bt, T.BooleanType):
            raise AnalysisException(
                f"filter lambda must return boolean, got {bt} "
                f"({self.body!r})")
        return ct

    def eval(self, ctx):
        out, mask, v = self._plane(ctx)
        dt = self.children[0].data_type(ctx.batch.schema)
        keep = mask & _predicate(out)
        return ExprValue(_pack_front(v.data, keep, _sentinel(dt)), v.valid,
                         v.dictionary)


class ArrayExists(_HigherOrder):
    """exists(arr, x -> pred) / forall(arr, x -> pred)."""

    def __init__(self, child, var, body, require_all: bool = False):
        super().__init__(child, var, body)
        self.require_all = require_all

    def map_children(self, fn):
        return ArrayExists(fn(self.children[0]), self.var, self.body,
                           self.require_all)

    def _kind(self):
        return "forall" if self.require_all else "exists"

    def data_type(self, schema):
        self._array_type(schema)
        bt = self.body.data_type(schema)
        if not isinstance(bt, T.BooleanType):
            raise AnalysisException(
                f"{self._kind()} lambda must return boolean, got {bt} "
                f"({self.body!r})")
        return T.boolean

    def eval(self, ctx):
        out, mask, v = self._plane(ctx)
        pred = _predicate(out)
        if self.require_all:
            res = torch.all(pred | ~mask, dim=-1)
        else:
            res = torch.any(pred & mask, dim=-1)
        return ExprValue(res, v.valid)


class ArrayAggregate(Expression):
    """aggregate(arr, init, (acc, x) -> merge[, acc -> finish]): a fold
    over the plane, unrolled over the static max_len (one masked select
    per slot, no data-dependent loop)."""

    LAMBDA_VARS = ("acc_var", "x_var", "finish_var")
    LAMBDA_BODIES = ("merge", "finish")

    def __init__(self, child: Expression, init: Expression,
                 acc_var: LambdaVar, x_var: LambdaVar, merge: Expression,
                 finish_var: Optional[LambdaVar] = None,
                 finish: Optional[Expression] = None):
        self.children = (child, init)
        self.acc_var = acc_var
        self.x_var = x_var
        self.merge = merge
        self.finish_var = finish_var
        self.finish = finish
        _check_lambda_body(merge, finish)

    def map_children(self, fn):
        return ArrayAggregate(fn(self.children[0]), fn(self.children[1]),
                              self.acc_var, self.x_var, self.merge,
                              self.finish_var, self.finish)

    @property
    def name(self):
        return f"aggregate({self.children[0].name})"

    def _bind_types(self, schema):
        ct = _array_type(self.children[0], schema, "aggregate")
        self.x_var.dtype = ct.element_type
        self.acc_var.dtype = self.children[1].data_type(schema)
        return ct

    def data_type(self, schema):
        self._bind_types(schema)
        if self.acc_var.dtype.is_string:
            raise AnalysisException(
                "aggregate with a string accumulator is not supported "
                "yet (dictionary state cannot thread through the fold)")
        mt = self.merge.data_type(schema)
        if mt.is_string:
            raise AnalysisException(
                "aggregate merge producing strings is not supported yet")
        if self.finish is not None:
            self.finish_var.dtype = mt
            return self.finish.data_type(schema)
        return mt

    def eval(self, ctx):
        dt = self._bind_types(ctx.batch.schema)
        v = self.children[0].eval(ctx)
        mask = _array_elem_mask(dt, v.data)
        init = ctx.broadcast(self.children[1].eval(ctx))
        acc_data, acc_valid = init.data, init.valid
        for i in range(v.data.shape[-1]):
            sub = _sub_context(ctx, {
                self.acc_var.name: ExprValue(acc_data, acc_valid),
                self.x_var.name: ExprValue(v.data[..., i], None,
                                           v.dictionary)})
            merged = sub.broadcast(self.merge.eval(sub))
            live = mask[..., i]
            acc_data = torch.where(live, merged.data, acc_data)
            if merged.valid is not None or acc_valid is not None:
                mv = merged.valid if merged.valid is not None \
                    else torch.ones_like(live)
                av = acc_valid if acc_valid is not None \
                    else torch.ones_like(live)
                acc_valid = torch.where(live, mv, av)
        out = ExprValue(acc_data, and_valid(v.valid, acc_valid))
        if self.finish is not None:
            self.finish_var.dtype = self.merge.data_type(ctx.batch.schema)
            sub = _sub_context(ctx, {self.finish_var.name: out})
            fin = sub.broadcast(self.finish.eval(sub))
            out = ExprValue(fin.data, and_valid(out.valid, fin.valid))
        return out

    def __repr__(self):
        fin = f", {self.finish_var!r} -> {self.finish!r}" \
            if self.finish is not None else ""
        return (f"aggregate({self.children[0]!r}, {self.children[1]!r}, "
                f"({self.acc_var!r}, {self.x_var!r}) -> "
                f"{self.merge!r}{fin})")


class ZipWith(Expression):
    """zip_with(a, b, (x, y) -> expr): an elementwise combine of two
    arrays; the shorter side's missing tail enters the lambda as NULL."""

    LAMBDA_VARS = ("x_var", "y_var")
    LAMBDA_BODIES = ("body",)

    def __init__(self, left: Expression, right: Expression,
                 x_var: LambdaVar, y_var: LambdaVar, body: Expression):
        self.children = (left, right)
        self.x_var = x_var
        self.y_var = y_var
        self.body = body
        _check_lambda_body(body)

    def map_children(self, fn):
        return ZipWith(fn(self.children[0]), fn(self.children[1]),
                       self.x_var, self.y_var, self.body)

    @property
    def name(self):
        return f"zip_with({self.children[0].name}, {self.children[1].name})"

    def _bind_types(self, schema):
        lt = self.children[0].data_type(schema)
        rt = self.children[1].data_type(schema)
        if not isinstance(lt, T.ArrayType) or not isinstance(rt, T.ArrayType):
            raise AnalysisException(
                f"zip_with expects two arrays, got {lt} and {rt}")
        self.x_var.dtype = lt.element_type
        self.y_var.dtype = rt.element_type
        return lt, rt

    def data_type(self, schema):
        self._bind_types(schema)
        return T.ArrayType(_element_result_type(self.body.data_type(schema),
                                                "zip_with"))

    def eval(self, ctx):
        lt, rt = self._bind_types(ctx.batch.schema)
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        am = _array_elem_mask(lt, a.data)
        bm = _array_elem_mask(rt, b.data)
        w = max(a.data.shape[-1], b.data.shape[-1])

        def widen(data, mask):
            extra = w - data.shape[-1]
            if not extra:
                return data, mask
            return (torch.nn.functional.pad(data, (0, extra), value=0),
                    torch.nn.functional.pad(mask, (0, extra), value=False))

        ad, am = widen(a.data, am)
        bd, bm = widen(b.data, bm)
        sub = _sub_context(ctx, {
            self.x_var.name: ExprValue(ad, am, a.dictionary),
            self.y_var.name: ExprValue(bd, bm, b.dictionary)})
        out = self.body.eval(sub)
        odt = self.data_type(ctx.batch.schema)
        live = am | bm
        ok = live if out.valid is None else (live & out.valid)
        data = torch.where(ok, out.data.to(odt.element_type.torch_dtype),
                           _sentinel(odt))
        return ExprValue(data, and_valid(a.valid, b.valid))

    def __repr__(self):
        return (f"zip_with({self.children[0]!r}, {self.children[1]!r}, "
                f"({self.x_var!r}, {self.y_var!r}) -> {self.body!r})")


class ArrayContains(Expression):
    """array_contains(arr, literal)."""

    def __init__(self, child: Expression, value: Any):
        self.value = value
        self.children = (child,)

    def map_children(self, fn):
        return ArrayContains(fn(self.children[0]), self.value)

    @property
    def name(self):
        return f"array_contains({self.children[0].name}, {self.value!r})"

    def data_type(self, schema):
        _array_type(self.children[0], schema, "array_contains")
        return T.boolean

    def eval(self, ctx):
        dt = self.children[0].data_type(ctx.batch.schema)
        v = self.children[0].eval(ctx)
        mask = _array_elem_mask(dt, v.data)
        none = torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
        if dt.element_type.is_string:
            words = v.dictionary or ()
            if self.value not in words:
                return ExprValue(none, v.valid)
            target = words.index(self.value)
        else:
            ed = np.dtype(dt.element_type.np_dtype)
            if np.issubdtype(ed, np.integer) and \
                    float(self.value) != int(self.value):
                # 1.5 never equals an integer element; a cast would
                # truncate it into a false positive
                return ExprValue(none, v.valid)
            target = np.asarray(self.value, ed).item()
        return ExprValue(((v.data == target) & mask).any(dim=-1), v.valid)

    def __repr__(self):
        return f"array_contains({self.children[0]!r}, {self.value!r})"


class ExplodeMarker(Expression):
    """explode()/posexplode() in a select list; the analyzer rewrites the
    Project holding it into the Explode operator."""

    def __init__(self, child: Expression, with_pos: bool = False):
        self.with_pos = with_pos
        self.children = (child,)

    def map_children(self, fn):
        return ExplodeMarker(fn(self.children[0]), self.with_pos)

    @property
    def name(self):
        return "col" if not self.with_pos else "posexplode"

    def data_type(self, schema):
        return _array_type(self.children[0], schema, "explode").element_type

    def eval(self, ctx):
        raise AnalysisException(
            "explode() is only supported as a top-level select expression")

    def __repr__(self):
        return f"explode({self.children[0]!r})"


# ---------------------------------------------------------------------------
# Structs and maps: object-layer values, as in the JAX package.  The
# optimizer's ``simplify_complex_ops`` rewrites every consumer into flat
# array/scalar expressions, so none holds a device plane of its own; a
# collected map or struct is built on the host from its flat planes.
# ---------------------------------------------------------------------------

_COMPLEX_EVAL_HINT = (
    " survived to execution: complex values are consumed via "
    "getField/map_keys/map_values/element_at/size (rewritten to flat "
    "columns by the optimizer) or collected at the top level.  A map/"
    "struct flowing through an operator that is neither is unsupported."
)


class _ObjectLayer(Expression):
    """A struct/map value: typed, never evaluated."""

    def eval(self, ctx):
        raise AnalysisException(f"{self!r}" + _COMPLEX_EVAL_HINT)


class CreateStruct(_ObjectLayer):
    """struct(...) / named_struct(...) — ``complexTypeCreator.scala``."""

    def __init__(self, field_names, *children: Expression):
        if not children or len(field_names) != len(children):
            raise AnalysisException("struct() needs one name per field")
        self.field_names = tuple(field_names)
        self.children = tuple(children)

    def map_children(self, fn):
        return CreateStruct(self.field_names,
                            *[fn(c) for c in self.children])

    @property
    def name(self):
        return f"struct({', '.join(c.name for c in self.children)})"

    def data_type(self, schema):
        return T.StructType([T.StructField(n, c.data_type(schema))
                             for n, c in zip(self.field_names,
                                             self.children)])

    def __repr__(self):
        parts = [f"{n}={c!r}" for n, c in zip(self.field_names,
                                              self.children)]
        return f"named_struct({', '.join(parts)})"


class GetField(_ObjectLayer):
    """struct.field — ``GetStructField``."""

    def __init__(self, child: Expression, field: str):
        self.children = (child,)
        self.field = field

    def map_children(self, fn):
        return GetField(fn(self.children[0]), self.field)

    @property
    def name(self):
        return self.field

    def data_type(self, schema):
        ct = self.children[0].data_type(schema)
        if not isinstance(ct, T.StructType):
            raise AnalysisException(f"getField expects a struct, got {ct}")
        for f in ct.fields:
            if f.name == self.field:
                return f.dataType
        raise AnalysisException(f"no field {self.field!r} in {ct.names}")

    def __repr__(self):
        return f"{self.children[0]!r}.{self.field}"


class CreateMap(_ObjectLayer):
    """map(k1, v1, k2, v2, ...) — ``CreateMap``."""

    def __init__(self, *children: Expression):
        if not children or len(children) % 2:
            raise AnalysisException(
                "map() needs an even, positive number of arguments "
                "(alternating keys and values)")
        self.children = tuple(children)

    def map_children(self, fn):
        return CreateMap(*[fn(c) for c in self.children])

    @property
    def keys(self):
        return self.children[0::2]

    @property
    def values(self):
        return self.children[1::2]

    @property
    def name(self):
        return f"map({', '.join(c.name for c in self.children)})"

    def _common(self, exprs, schema, what):
        dt = exprs[0].data_type(schema)
        for e in exprs[1:]:
            nxt = T.common_type(dt, e.data_type(schema))
            if nxt is None:
                raise AnalysisException(
                    f"map {what} types are incompatible: {dt} vs "
                    f"{e.data_type(schema)}")
            dt = nxt
        return dt

    def data_type(self, schema):
        return T.MapType(self._common(self.keys, schema, "key"),
                         self._common(self.values, schema, "value"))

    def __repr__(self):
        return f"map({', '.join(repr(c) for c in self.children)})"


class MapFromArrays(_ObjectLayer):
    """map_from_arrays(keys_array, values_array)."""

    def __init__(self, keys: Expression, values: Expression):
        self.children = (keys, values)

    def map_children(self, fn):
        return MapFromArrays(fn(self.children[0]), fn(self.children[1]))

    @property
    def name(self):
        return (f"map_from_arrays({self.children[0].name}, "
                f"{self.children[1].name})")

    def data_type(self, schema):
        kt = self.children[0].data_type(schema)
        vt = self.children[1].data_type(schema)
        if not isinstance(kt, T.ArrayType) or not isinstance(vt, T.ArrayType):
            raise AnalysisException(
                f"map_from_arrays expects two arrays, got {kt}, {vt}")
        return T.MapType(kt.element_type, vt.element_type)

    def __repr__(self):
        return (f"map_from_arrays({self.children[0]!r}, "
                f"{self.children[1]!r})")


class _MapExtract(_ObjectLayer):
    """The shape of map_keys / map_values."""

    WHICH = "keys"

    def __init__(self, child: Expression):
        self.children = (child,)

    def map_children(self, fn):
        return type(self)(fn(self.children[0]))

    @property
    def name(self):
        return f"map_{self.WHICH}({self.children[0].name})"

    def data_type(self, schema):
        ct = self.children[0].data_type(schema)
        if not isinstance(ct, T.MapType):
            raise AnalysisException(
                f"map_{self.WHICH} expects a map, got {ct}")
        return T.ArrayType(ct.key_type if self.WHICH == "keys"
                           else ct.value_type)

    def __repr__(self):
        return f"map_{self.WHICH}({self.children[0]!r})"


class MapKeys(_MapExtract):
    WHICH = "keys"


class MapValues(_MapExtract):
    WHICH = "values"


class MapGet(_ObjectLayer):
    """map[key] / element_at(map, key) — GetMapValue: NULL when absent."""

    def __init__(self, child: Expression, key: Expression):
        self.children = (child, key)

    def map_children(self, fn):
        return MapGet(fn(self.children[0]), fn(self.children[1]))

    @property
    def name(self):
        return f"element_at({self.children[0].name}, {self.children[1].name})"

    def data_type(self, schema):
        ct = self.children[0].data_type(schema)
        if isinstance(ct, T.ArrayType):
            return ct.element_type    # element_at(arr, expr): ArrayGather
        if not isinstance(ct, T.MapType):
            raise AnalysisException(f"element_at on {ct} needs a map")
        return ct.value_type

    def __repr__(self):
        return f"element_at({self.children[0]!r}, {self.children[1]!r})"


class GetItem(_ObjectLayer):
    """Column.getItem(key) / ``c[key]``: a 0-based position for arrays, a
    key for maps, a field name for structs — resolved by the optimizer
    once the child's type is known."""

    def __init__(self, child: Expression, key):
        self.children = (child,)
        self.key = key

    def map_children(self, fn):
        return GetItem(fn(self.children[0]), self.key)

    @property
    def name(self):
        return f"{self.children[0].name}[{self.key!r}]"

    def data_type(self, schema):
        ct = self.children[0].data_type(schema)
        if isinstance(ct, T.ArrayType):
            return ct.element_type
        if isinstance(ct, T.MapType):
            return ct.value_type
        if isinstance(ct, T.StructType) and isinstance(self.key, str):
            return GetField(self.children[0], self.key).data_type(schema)
        raise AnalysisException(f"getItem on {ct} is not supported")

    def __repr__(self):
        return f"{self.children[0]!r}[{self.key!r}]"


class ArrayGather(Expression):
    """The 1-based gather at a per-row position (0 or out of bounds is
    NULL): what ``MapGet(map_from_arrays(k, v), x)`` rewrites into."""

    def __init__(self, arr: Expression, pos: Expression):
        self.children = (arr, pos)

    def map_children(self, fn):
        return ArrayGather(fn(self.children[0]), fn(self.children[1]))

    @property
    def name(self):
        return f"element_at({self.children[0].name}, {self.children[1].name})"

    def data_type(self, schema):
        return _array_type(self.children[0], schema,
                           "array gather").element_type

    def eval(self, ctx):
        dt = self.children[0].data_type(ctx.batch.schema)
        v = self.children[0].eval(ctx)
        p = ctx.broadcast(self.children[1].eval(ctx))
        out_dt = self.data_type(ctx.batch.schema).torch_dtype
        gathered, ok = _gather_1based_plane(
            dt, v, p.data.to(torch.int64), ctx.capacity, out_dt, ctx.device)
        return ExprValue(gathered, and_valid(and_valid(v.valid, p.valid), ok),
                         v.dictionary)

    def __repr__(self):
        return f"array_gather({self.children[0]!r}, {self.children[1]!r})"
