"""DataFrame: the user-facing lazy relational API.

The subset of ``spark_tpu/sql/dataframe.py`` (the analog of
``sql/core/.../Dataset.scala`` with pyspark's surface) the port has.
A DataFrame is (session, logical plan); every method builds a new plan,
and actions run it through QueryExecution on the session's device.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

from .. import types as T
from ..aggregates import Avg, Count, CountStar, Max, Min, Sum
from ..columnar import ColumnBatch
from ..expressions import Alias, AnalysisException, Col, Expression, Literal
from ..logicalutils import _SortOrderHandle
from . import logical as L
from .column import Column
from .row import Row

ColumnOrName = Union[Column, str]


def _to_expr(c: ColumnOrName) -> Expression:
    if isinstance(c, Column):
        return c._e
    if isinstance(c, str):
        return Col(c)
    if isinstance(c, Expression):
        return c
    raise TypeError(f"expected Column or str, got {type(c)}")


class DataFrame:
    def __init__(self, session, plan: L.LogicalPlan):
        self.session = session
        self._plan = plan

    # -- metadata ---------------------------------------------------------
    @property
    def schema(self) -> T.StructType:
        return self._qe_analyzed().schema()

    def _qe_analyzed(self) -> L.LogicalPlan:
        from .analyzer import Analyzer
        return Analyzer(self.session.catalog).analyze(self._plan)

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    @property
    def dtypes(self) -> List[Tuple[str, str]]:
        return [(f.name, f.dataType.simpleString()) for f in self.schema.fields]

    def printSchema(self) -> None:
        print("root")
        for f in self.schema.fields:
            print(f" |-- {f.name}: {f.dataType.simpleString()} "
                  f"(nullable = {str(f.nullable).lower()})")

    def explain(self, extended: bool = False) -> None:
        from .planner import QueryExecution
        qe = QueryExecution(self.session, self._plan)
        print(qe.explain_string() if extended else
              "== Physical Plan ==\n" + qe.planned.physical.tree_string())

    def __getitem__(self, item) -> Column:
        if isinstance(item, str):
            return Column(Col(item))
        raise TypeError(item)

    def __getattr__(self, name: str) -> Column:
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self.schema.names:
            return Column(Col(name))
        raise AttributeError(name)

    def alias(self, name: str) -> "DataFrame":
        return DataFrame(self.session, L.SubqueryAlias(name, self._plan))

    # -- transformations --------------------------------------------------
    def select(self, *cols: ColumnOrName) -> "DataFrame":
        if not cols:
            cols = ("*",)
        exprs: List[Expression] = []
        for c in cols:
            if isinstance(c, str) and c == "*":
                exprs += [Col(n) for n in self.schema.names]
            else:
                exprs.append(_to_expr(c))
        # select with aggregates and no grouping is a global aggregation
        # (Dataset.select's ungrouped-agg path)
        from .analyzer import build_aggregate, contains_aggregate
        if any(contains_aggregate(e) for e in exprs):
            for e in exprs:
                base = e.children[0] if isinstance(e, Alias) else e
                if not contains_aggregate(e) \
                        and not isinstance(base, Literal):
                    raise AnalysisException(
                        f"expression {e!r} is neither an aggregate nor "
                        "grouped; add it to groupBy() or aggregate it")
            return DataFrame(self.session,
                             build_aggregate([], exprs, self._plan))
        return DataFrame(self.session, L.Project(exprs, self._plan))

    def selectExpr(self, *exprs: str) -> "DataFrame":
        from .parser import parse_expression
        return self.select(*[Column(parse_expression(e)) for e in exprs])

    def filter(self, condition: Union[Column, str]) -> "DataFrame":
        if isinstance(condition, str):
            from .parser import parse_expression
            cond = parse_expression(condition)
        else:
            cond = condition._e
        return DataFrame(self.session, L.Filter(cond, self._plan))

    where = filter

    def withColumn(self, name: str, col: Column) -> "DataFrame":
        exprs: List[Expression] = []
        replaced = False
        for n in self.schema.names:
            if n == name:
                exprs.append(Alias(col._e, name))
                replaced = True
            else:
                exprs.append(Col(n))
        if not replaced:
            exprs.append(Alias(col._e, name))
        return DataFrame(self.session, L.Project(exprs, self._plan))

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        exprs = [Alias(Col(n), new) if n == old else Col(n)
                 for n in self.schema.names]
        return DataFrame(self.session, L.Project(exprs, self._plan))

    def drop(self, *names: str) -> "DataFrame":
        keep = [Col(n) for n in self.schema.names if n not in names]
        return DataFrame(self.session, L.Project(keep, self._plan))

    def groupBy(self, *cols: ColumnOrName) -> "GroupedData":
        return GroupedData(self, [_to_expr(c) for c in cols])

    groupby = groupBy

    def agg(self, *cols: Column) -> "DataFrame":
        return self.groupBy().agg(*cols)

    def orderBy(self, *cols, ascending: Optional[Any] = None) -> "DataFrame":
        orders: List[L.SortOrder] = []
        for i, c in enumerate(cols):
            if isinstance(c, _SortOrderHandle):
                orders.append(L.SortOrder(c.expr, c.ascending, c.nulls_first))
            else:
                asc = True
                if ascending is not None:
                    asc = ascending[i] if isinstance(ascending, (list, tuple)) \
                        else bool(ascending)
                orders.append(L.SortOrder(_to_expr(c), asc))
        return DataFrame(self.session, L.Sort(orders, self._plan))

    sort = orderBy

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self.session, L.Limit(n, self._plan))

    def distinct(self) -> "DataFrame":
        return DataFrame(self.session, L.Distinct(self._plan))

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self.session, L.Union([self._plan, other._plan]))

    unionAll = union

    def unionByName(self, other: "DataFrame") -> "DataFrame":
        reordered = other.select(*[Col(n) for n in self.schema.names])
        return self.union(reordered)

    def join(self, other: "DataFrame",
             on: Union[str, List[str], Column, None] = None,
             how: str = "inner") -> "DataFrame":
        using = None
        cond = None
        if isinstance(on, str):
            using = [on]
        elif isinstance(on, (list, tuple)) and on and isinstance(on[0], str):
            using = list(on)
        elif isinstance(on, Column):
            cond = on._e
        elif on is None:
            how = "cross" if how == "inner" else how
        return DataFrame(self.session,
                         L.Join(self._plan, other._plan, how, cond, using))

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self.session,
                         L.Join(self._plan, other._plan, "cross", None, None))

    # -- actions ----------------------------------------------------------
    def _execute(self) -> ColumnBatch:
        from .planner import QueryExecution
        return QueryExecution(self.session, self._plan).execute()

    def collect(self) -> List[Row]:
        batch = self._execute()
        return [Row(r, batch.names) for r in batch.to_pylist()]

    def count(self) -> int:
        agg = L.Aggregate([], [(CountStar(), "count")], self._plan)
        from .planner import QueryExecution
        out = QueryExecution(self.session, agg).execute()
        return int(out.to_pylist()[0][0])

    def first(self) -> Optional[Row]:
        rows = self.limit(1).collect()
        return rows[0] if rows else None

    def head(self, n: int = 1):
        rows = self.limit(n).collect()
        return rows[0] if n == 1 and rows else rows

    def take(self, n: int) -> List[Row]:
        return self.limit(n).collect()

    def show(self, n: int = 20, truncate: bool = True) -> None:
        batch = self.limit(n)._execute()
        names = batch.names
        rows = batch.to_pylist()
        cells = [[_fmt(v, truncate) for v in r] for r in rows]
        widths = [max([len(nm)] + [len(c[i]) for c in cells])
                  for i, nm in enumerate(names)]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        print(sep)
        print("|" + "|".join(f" {nm:<{w}} " for nm, w in zip(names, widths)) + "|")
        print(sep)
        for c in cells:
            print("|" + "|".join(f" {v:<{w}} " for v, w in zip(c, widths)) + "|")
        print(sep)

    def createOrReplaceTempView(self, name: str) -> None:
        self.session.catalog.register(name, self._plan)

    createTempView = createOrReplaceTempView

    def __repr__(self):
        cols = ", ".join(f"{f.name}: {f.dataType.simpleString()}"
                         for f in self.schema.fields)
        return f"DataFrame[{cols}]"


def _fmt(v, truncate) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return str(v).lower()
    s = str(v)
    if truncate and len(s) > 20:
        s = s[:17] + "..."
    return s


class GroupedData:
    """Result of groupBy() (``RelationalGroupedDataset`` analog)."""

    def __init__(self, df: DataFrame, keys: List[Expression]):
        self._df = df
        self._keys = keys

    def agg(self, *cols, **named) -> DataFrame:
        from .analyzer import build_aggregate
        exprs: List[Expression] = []
        if len(cols) == 1 and isinstance(cols[0], dict):
            for name, fn in cols[0].items():
                exprs.append(Alias(_AGG_BY_NAME[fn](Col(name)),
                                   f"{fn}({name})"))
        else:
            exprs = [c._e if isinstance(c, Column) else c for c in cols]
        for out_name, c in named.items():
            exprs.append(Alias(c._e if isinstance(c, Column) else c, out_name))
        plan = build_aggregate(self._keys, exprs, self._df._plan)
        return DataFrame(self._df.session, plan)

    def count(self) -> DataFrame:
        return self.agg(Column(Alias(CountStar(), "count")))

    def sum(self, *names: str) -> DataFrame:
        return self.agg(*[Column(Alias(Sum(Col(n)), f"sum({n})")) for n in names])

    def avg(self, *names: str) -> DataFrame:
        return self.agg(*[Column(Alias(Avg(Col(n)), f"avg({n})")) for n in names])

    mean = avg

    def min(self, *names: str) -> DataFrame:
        return self.agg(*[Column(Alias(Min(Col(n)), f"min({n})")) for n in names])

    def max(self, *names: str) -> DataFrame:
        return self.agg(*[Column(Alias(Max(Col(n)), f"max({n})")) for n in names])


_AGG_BY_NAME = {
    "sum": Sum, "count": Count, "avg": Avg, "mean": Avg, "min": Min, "max": Max,
}
