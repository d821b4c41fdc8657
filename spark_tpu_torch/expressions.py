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
    "StringPredicate",
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
    (The JAX package's ``row_offset``, which decorrelates rand and row ids
    across operators, comes with those expressions.)"""

    def __init__(self, batch: ColumnBatch):
        self.batch = batch
        self.device = batch.device
        self.capacity = batch.capacity

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

    def eval(self, ctx: EvalContext) -> ExprValue:
        l, r = (c.eval(ctx) for c in self.children)
        dt = self.data_type(ctx.batch.schema).torch_dtype
        a = l.data.to(dt)
        b = r.data.to(dt)
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
    op_name = "*"
    def _compute(self, a, b): return a * b


class Div(BinaryArithmetic):
    """True division; x/0 → NULL (ANSI-off Spark semantics)."""

    op_name = "/"

    def data_type(self, schema):
        dt = super().data_type(schema)
        return dt if dt.is_fractional else T.float64

    def eval(self, ctx: EvalContext) -> ExprValue:
        l, r = (c.eval(ctx) for c in self.children)
        dt = self.data_type(ctx.batch.schema).torch_dtype
        zero = r.data == 0
        a = l.data.to(dt)
        b = _safe_divisor(r.data, zero).to(dt)
        if not dt.is_floating_point:
            # decimal operands are unscaled int64: numpy divides them in
            # float64, torch would pick float32 — widen before dividing
            a, b = a.to(torch.float64), b.to(torch.float64)
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
        l, r = (c.eval(ctx) for c in self.children)
        dt = self.data_type(ctx.batch.schema)
        tdt = dt.torch_dtype
        zero = r.data == 0
        a = l.data.to(tdt)
        b = _safe_divisor(r.data, zero).to(tdt)
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
