"""User-facing Column API (the analog of ``sql/core/.../Column.scala`` /
pyspark's ``Column``), a thin wrapper over the expression IR — the subset
of ``spark_tpu/sql/column.py``."""

from __future__ import annotations

from typing import Any, Union

from .. import types as T
from ..expressions import (Alias, Between, CaseWhen, Cast, EqNullSafe,
                           Expression, In, IsNaN, IsNotNull, IsNull,
                           StringPredicate, Substring, _wrap)
from ..logicalutils import sort_order

__all__ = ["Column", "ColumnOrName"]


def _expr(v: Any) -> Expression:
    if isinstance(v, Column):
        return v._e
    return _wrap(v)


class Column:
    """A named expression; arithmetic/comparison operators build new Columns."""

    def __init__(self, expr: Expression):
        self._e = expr

    # -- complex-type extractors -----------------------------------------
    def getField(self, name: str) -> "Column":
        from ..expressions import GetField
        return Column(GetField(self._e, name))

    def getItem(self, key) -> "Column":
        from ..expressions import GetItem
        return Column(GetItem(self._e, key))

    def __getitem__(self, key) -> "Column":
        return self.getItem(key)

    # -- naming -----------------------------------------------------------
    def alias(self, name: str) -> "Column":
        return Column(Alias(self._e, name))

    name = alias

    def cast(self, to: Union[str, T.DataType]) -> "Column":
        dt = T.type_for_name(to) if isinstance(to, str) else to
        return Column(Cast(self._e, dt))

    astype = cast

    # -- arithmetic -------------------------------------------------------
    def __add__(self, o): return Column(self._e + _expr(o))
    def __radd__(self, o): return Column(_expr(o) + self._e)
    def __sub__(self, o): return Column(self._e - _expr(o))
    def __rsub__(self, o): return Column(_expr(o) - self._e)
    def __mul__(self, o): return Column(self._e * _expr(o))
    def __rmul__(self, o): return Column(_expr(o) * self._e)
    def __truediv__(self, o): return Column(self._e / _expr(o))
    def __rtruediv__(self, o): return Column(_expr(o) / self._e)
    def __mod__(self, o): return Column(self._e % _expr(o))
    def __neg__(self): return Column(-self._e)

    # -- comparison / boolean --------------------------------------------
    def __eq__(self, o): return Column(self._e == _expr(o))  # type: ignore[override]
    def __ne__(self, o): return Column(self._e != _expr(o))  # type: ignore[override]
    def __lt__(self, o): return Column(self._e < _expr(o))
    def __le__(self, o): return Column(self._e <= _expr(o))
    def __gt__(self, o): return Column(self._e > _expr(o))
    def __ge__(self, o): return Column(self._e >= _expr(o))
    def __and__(self, o): return Column(self._e & _expr(o))
    def __rand__(self, o): return Column(_expr(o) & self._e)
    def __or__(self, o): return Column(self._e | _expr(o))
    def __ror__(self, o): return Column(_expr(o) | self._e)
    def __invert__(self): return Column(~self._e)
    def __hash__(self):
        return id(self)

    def eqNullSafe(self, o) -> "Column":
        return Column(EqNullSafe(self._e, _expr(o)))

    def isin(self, *values) -> "Column":
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        return Column(In(self._e, list(values)))

    def between(self, low, high) -> "Column":
        return Column(Between(self._e, _expr(low), _expr(high)))

    # -- null predicates --------------------------------------------------
    def isNull(self) -> "Column":
        return Column(IsNull(self._e))

    def isNotNull(self) -> "Column":
        return Column(IsNotNull(self._e))

    def isNaN(self) -> "Column":
        return Column(IsNaN(self._e))

    # -- strings ----------------------------------------------------------
    def like(self, pattern: str) -> "Column":
        return Column(StringPredicate("like", self._e, pattern))

    def rlike(self, pattern: str) -> "Column":
        return Column(StringPredicate("rlike", self._e, pattern))

    def startswith(self, prefix: str) -> "Column":
        return Column(StringPredicate("startswith", self._e, prefix))

    def endswith(self, suffix: str) -> "Column":
        return Column(StringPredicate("endswith", self._e, suffix))

    def contains(self, sub: str) -> "Column":
        return Column(StringPredicate("contains", self._e, sub))

    def substr(self, start: int, length: int) -> "Column":
        return Column(Substring(self._e, start, length))

    # -- conditionals -----------------------------------------------------
    def when(self, condition: "Column", value) -> "Column":
        e = self._e
        if not isinstance(e, CaseWhen):
            raise ValueError("when() follows functions.when(...)")
        return Column(CaseWhen(e.branches + [(condition._e, _expr(value))],
                               e.otherwise))

    def otherwise(self, value) -> "Column":
        e = self._e
        if not isinstance(e, CaseWhen):
            raise ValueError("otherwise() follows functions.when(...)")
        return Column(CaseWhen(e.branches, _expr(value)))

    # -- window -----------------------------------------------------------
    def over(self, window) -> "Column":
        from ..aggregates import AggregateFunction
        from .window import WindowExpression, WindowFunction
        e = self._e
        if isinstance(e, Alias):
            inner = e.children[0]
            if isinstance(inner, (AggregateFunction, WindowFunction)):
                return Column(Alias(WindowExpression(inner, window), e.name))
        return Column(WindowExpression(e, window))

    # -- sort orders ------------------------------------------------------
    def asc(self):
        return sort_order(self._e, True, None)

    def desc(self):
        return sort_order(self._e, False, None)

    def asc_nulls_first(self):
        return sort_order(self._e, True, True)

    def asc_nulls_last(self):
        return sort_order(self._e, True, False)

    def desc_nulls_first(self):
        return sort_order(self._e, False, True)

    def desc_nulls_last(self):
        return sort_order(self._e, False, False)

    def __repr__(self):
        return f"Column<{self._e!r}>"


ColumnOrName = Union[Column, str]
