"""Built-in function surface (the analog of ``sql/core/.../functions.scala``
and ``pyspark.sql.functions``): the subset of ``spark_tpu/sql/functions.py``
whose expressions the port has."""

from __future__ import annotations

from typing import Any, Union

from .. import aggregates as A
from .. import expressions as E
from .column import Column, ColumnOrName

__all__ = [
    "col", "column", "lit", "expr", "when", "coalesce", "isnull", "sum",
    "count", "avg", "mean", "min", "max", "first", "last", "countDistinct",
    "sumDistinct", "udf", "asc", "desc",
]


def _e(c: Union[ColumnOrName, Any]) -> E.Expression:
    if isinstance(c, Column):
        return c._e
    if isinstance(c, str):
        return E.Col(c)
    return E._wrap(c)


def _ev(v: Any) -> E.Expression:
    """value position: strings are literals."""
    if isinstance(v, Column):
        return v._e
    return E._wrap(v)


def col(name: str) -> Column:
    return Column(E.Col(name))


column = col


def lit(v: Any) -> Column:
    return Column(E._wrap(v))


def expr(sql_text: str) -> Column:
    from .parser import parse_expression
    return Column(parse_expression(sql_text))


def when(condition: Column, value) -> Column:
    return Column(E.CaseWhen([(condition._e, _ev(value))]))


def coalesce(*cols) -> Column:
    return Column(E.Coalesce(*[_e(c) for c in cols]))


def isnull(c) -> Column:
    return Column(E.IsNull(_e(c)))


# ---- aggregates -------------------------------------------------------------

def sum(c) -> Column:  # noqa: A001
    return Column(A.Sum(_e(c)))


def count(c) -> Column:
    e = _e(c) if not (isinstance(c, str) and c == "*") else None
    if e is None or (isinstance(e, E.Literal) and e.value is not None):
        return Column(A.CountStar())
    return Column(A.Count(e))


def avg(c) -> Column:
    return Column(A.Avg(_e(c)))


mean = avg


def min(c) -> Column:  # noqa: A001
    return Column(A.Min(_e(c)))


def max(c) -> Column:  # noqa: A001
    return Column(A.Max(_e(c)))


def first(c, ignorenulls: bool = True) -> Column:
    return Column(A.First(_e(c), ignorenulls))


def last(c, ignorenulls: bool = True) -> Column:
    return Column(A.Last(_e(c), ignorenulls))


def countDistinct(c) -> Column:
    return Column(A.CountDistinct(_e(c)))


def sumDistinct(c) -> Column:
    return Column(A.SumDistinct(_e(c)))


def udf(f=None, returnType="double", vectorized: bool = False):
    """Python UDF factory (`functions.udf`): a per-row function run on
    the host over the live rows (the row lane), or `vectorized=True` for
    a function of torch tensors on the session's device.  Usable
    directly or as a decorator."""
    from .udf import make_udf
    if f is None:
        return lambda fn: make_udf(fn, returnType, vectorized)
    return make_udf(f, returnType, vectorized)


# ---- sort orders ------------------------------------------------------------

def asc(name: str):
    return col(name).asc()


def desc(name: str):
    return col(name).desc()
