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
        self._cached: Optional[str] = None   # the cache manager's key

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
              "== Physical Plan ==\n"
              + qe.planned_preview().physical.tree_string())

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
        # explode()/posexplode() flows through a plain Project: the
        # analyzer's _rewrite_explode makes it the Explode operator (one
        # rewrite shared with the SQL path)
        from ..expressions import ExplodeMarker
        if any(isinstance(e.children[0] if isinstance(e, Alias) else e,
                          ExplodeMarker) for e in exprs):
            return DataFrame(self.session, L.Project(exprs, self._plan))
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

    def repartition(self, num: int, *cols) -> "DataFrame":
        """A logical no-op, as in the JAX package: one process runs a plan
        as one stage, and the mesh lane and the cross-process exchange
        choose their own partitioning (``spark.tpu.mesh.shards``, the
        exchange's reducer plan)."""
        return self

    def coalesce(self, num: int) -> "DataFrame":
        """A logical no-op (see ``repartition``)."""
        return self

    def withWatermark(self, eventTime: str, delayThreshold: str) -> "DataFrame":
        """Event-time watermark (``Dataset.withWatermark``); no-op in batch."""
        from ..expressions import parse_duration
        if eventTime not in self.schema.names:
            raise AnalysisException(
                f"watermark column {eventTime!r} not found among "
                f"{self.schema.names}")
        delay = parse_duration(delayThreshold)
        if delay < 0:
            raise AnalysisException(
                f"watermark delay must be >= 0, got {delayThreshold!r}")
        return DataFrame(self.session, L.EventTimeWatermark(
            eventTime, delay, self._plan))

    def distinct(self) -> "DataFrame":
        return DataFrame(self.session, L.Distinct(self._plan))

    def dropDuplicates(self, subset: Optional[List[str]] = None
                       ) -> "DataFrame":
        if not subset:
            return self.distinct()
        # the first row per subset key: group by the subset, first() the
        # other columns
        from ..aggregates import First
        names = self.schema.names
        aggs = [(First(Col(n)), n) for n in names if n not in subset]
        agg_plan = L.Aggregate([Col(n) for n in subset], aggs, self._plan)
        return DataFrame(self.session,
                         L.Project([Col(n) for n in names], agg_plan))

    drop_duplicates = dropDuplicates

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

    def sample(self, fraction: float, seed: int = 0) -> "DataFrame":
        return DataFrame(self.session, L.Sample(fraction, seed, self._plan))

    def dropna(self, how: str = "any", subset: Optional[List[str]] = None
               ) -> "DataFrame":
        from ..expressions import And, IsNotNull, Or
        preds = [IsNotNull(Col(n)) for n in (subset or self.schema.names)]
        join = And if how == "any" else Or
        cond = preds[0]
        for p in preds[1:]:
            cond = join(cond, p)
        return DataFrame(self.session, L.Filter(cond, self._plan))

    na = property(lambda self: _NAFunctions(self))

    def fillna(self, value: Any, subset: Optional[List[str]] = None
               ) -> "DataFrame":
        from ..expressions import Coalesce
        names = subset or self.schema.names
        exprs: List[Expression] = []
        for f in self.schema.fields:
            if f.name in names and _fill_compatible(f.dataType, value):
                exprs.append(Alias(Coalesce(Col(f.name), Literal(value)),
                                   f.name))
            else:
                exprs.append(Col(f.name))
        return DataFrame(self.session, L.Project(exprs, self._plan))

    # -- persistence --------------------------------------------------------
    def checkpoint(self, eager: bool = True) -> "DataFrame":
        """Truncate lineage by materializing to reliable storage
        (``Dataset.checkpoint``): parquet under ``spark.tpu.checkpoint.dir``
        (by default ``<warehouse>/_checkpoints``); the result reads back
        from the files.  ``eager=False`` defers the write to the first
        action (the lazy-checkpoint contract)."""
        import os
        import uuid

        from .. import config as C
        base = self.session.conf.get(C.CHECKPOINT_DIR) or os.path.join(
            self.session.conf.get(C.WAREHOUSE_DIR), "_checkpoints")
        path = os.path.join(base, uuid.uuid4().hex[:12])
        if eager:
            self.write.parquet(path)
            return self.session.read.parquet(path)
        return DataFrame(self.session, L.LazyCheckpoint(self._plan, path))

    def localCheckpoint(self, eager: bool = True) -> "DataFrame":
        return self.checkpoint(eager)

    def cache(self, level: Optional[str] = None) -> "DataFrame":
        """Materialize and register in the session's cache manager
        (``CacheManager.cacheQuery``); other queries containing this exact
        subtree read the cached batch instead of recomputing.  ``level`` is
        a ``memory.StorageLevel`` (default DEVICE; demotes under device
        memory pressure).  Caching a relation that is cached already
        keeps its one entry, moved to ``level`` when one is given."""
        from ..memory import StorageLevel
        from .planner import QueryExecution
        # key on the SUBSTITUTED analyzed plan: substitution runs bottom
        # up, so a cache-on-cache plan must be keyed the way other
        # queries' rewritten trees will look
        qe = QueryExecution(self.session, self._plan)
        plan = qe.analyzed
        if isinstance(plan, L.CachedRelation):
            key = plan.cache_key
            if level is not None:     # the same uid: plan keys hold
                self.session._cache.put(key, plan.batch, level)
        else:
            key = L.plan_cache_key(plan)
            self.session._cache.put(key, qe.execute(),
                                    level or StorageLevel.DEVICE)
        self._cached = key
        return self

    def persist(self, level: Optional[str] = None) -> "DataFrame":
        return self.cache(level)

    def unpersist(self) -> "DataFrame":
        if self._cached is not None:
            self.session._cache.remove(self._cached)
            self._cached = None
        return self

    def _cache_hit(self) -> Optional[ColumnBatch]:
        """This DataFrame's cached batch on the host (one packed copy from
        a DEVICE entry), or None."""
        if self._cached is None:
            return None
        hit = self.session._cache.get(self._cached)
        return None if hit is None else hit.packed_host()

    # -- actions ----------------------------------------------------------
    def _execute(self) -> ColumnBatch:
        hit = self._cache_hit()
        if hit is not None:
            return hit
        from .planner import QueryExecution
        return QueryExecution(self.session, self._plan).execute()

    # -- map / struct output ----------------------------------------------
    def _flatten_complex(self, schema: Optional[T.StructType] = None):
        """(flat DataFrame, assembly spec or None).  A top-level map or
        struct column holds no device plane (the object-layer contract):
        it runs as its flat columns — a map as its keys and values arrays,
        a struct as a column per field — and the spec rebuilds Python
        dicts and Rows per row after the decode."""
        schema = schema or self.schema
        if not any(isinstance(f.dataType, (T.MapType, T.StructType))
                   for f in schema.fields):
            return self, None
        from ..expressions import GetField, MapKeys, MapValues
        exprs: List[Expression] = []

        def flatten(expr, dtype, prefix, name):
            if isinstance(dtype, T.MapType):
                if isinstance(dtype.key_type, (T.MapType, T.StructType)) \
                        or isinstance(dtype.value_type,
                                      (T.MapType, T.StructType)):
                    raise AnalysisException(
                        "maps with map/struct keys or values cannot be "
                        "collected (they have no plane layout)")
                ki, vi = len(exprs), len(exprs) + 1
                exprs.append(Alias(MapKeys(expr), f"{prefix}__mkeys"))
                exprs.append(Alias(MapValues(expr), f"{prefix}__mvals"))
                return ("map", ki, vi, name)
            if isinstance(dtype, T.StructType):
                subs = [flatten(GetField(expr, sf.name), sf.dataType,
                                f"{prefix}__{sf.name}", sf.name)
                        for sf in dtype.fields]
                return ("struct", subs, name)
            exprs.append(Alias(expr, f"{prefix}__v"))
            return ("plain", len(exprs) - 1, name)

        spec = []
        for f in schema.fields:
            if isinstance(f.dataType, (T.MapType, T.StructType)):
                spec.append(flatten(Col(f.name), f.dataType, f"__{f.name}",
                                    f.name))
            else:
                spec.append(("plain", len(exprs), f.name))
                exprs.append(Col(f.name))
        return DataFrame(self.session, L.Project(exprs, self._plan)), spec

    @staticmethod
    def _assemble_rows(rows, spec) -> List[Row]:
        def build(sp, r):
            if sp[0] == "plain":
                return r[sp[1]]
            if sp[0] == "map":
                ks, vs = r[sp[1]], r[sp[2]]
                if ks is None:
                    return None
                # reversed, so the FIRST of duplicate keys wins, as
                # element_at's scan does
                return dict(zip(reversed(ks), reversed(vs or [])))
            return Row([build(sub, r) for sub in sp[1]],
                       [sub[-1] for sub in sp[1]])

        names = [sp[-1] for sp in spec]
        return Row._many(([build(sp, r) for sp in spec] for r in rows),
                         names)

    def collect(self) -> List[Row]:
        from .planner import QueryExecution
        qe = QueryExecution(self.session, self._plan)
        flat, spec = self._flatten_complex(qe.analyzed.schema())
        if spec is None:
            batch = self._cache_hit()
            if batch is None:
                batch = qe.execute()  # the analysis above is reused
            return Row._many(batch.to_pylist(), batch.names)
        return self._assemble_rows(flat._execute().to_pylist(), spec)

    def toLocalIterator(self):
        return iter(self.collect())

    def toPandas(self):
        """The result as a pandas DataFrame (maps as dicts, structs as
        Rows), built from the decoded rows as the JAX package builds it."""
        from ..io import rows_to_pandas
        flat, spec = self._flatten_complex()
        if spec is None:
            batch = flat._execute()
            return rows_to_pandas(batch.to_pylist(), batch.names)
        rows = self._assemble_rows(flat._execute().to_pylist(), spec)
        return rows_to_pandas(rows, [s[-1] for s in spec])

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
        flat, spec = self.limit(n)._flatten_complex()
        batch = flat._execute()
        if spec is None:
            names, rows = batch.names, batch.to_pylist()
        else:
            names = [sp[-1] for sp in spec]
            rows = [list(r) for r in
                    self._assemble_rows(batch.to_pylist(), spec)]
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

    @property
    def write(self):
        from ..io import DataFrameWriter
        return DataFrameWriter(self)

    @property
    def writeStream(self):
        from ..streaming.api import DataStreamWriter
        return DataStreamWriter(self)

    @property
    def isStreaming(self) -> bool:
        from ..streaming.core import StreamingRelation

        def walk(n) -> bool:
            return isinstance(n, StreamingRelation) \
                or any(walk(c) for c in n.children)
        return walk(self._plan)

    def createOrReplaceTempView(self, name: str) -> None:
        self.session.catalog.register(name, self._plan)

    createTempView = createOrReplaceTempView

    @property
    def rdd(self):
        """The rows as an RDD of the session's ``sparkContext``."""
        return self.session.sparkContext.parallelize(self.collect())

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


def _fill_compatible(dt: T.DataType, value: Any) -> bool:
    if isinstance(value, bool):
        return isinstance(dt, T.BooleanType)
    if isinstance(value, (int, float)):
        return dt.is_numeric
    if isinstance(value, str):
        return dt.is_string
    return False


class _NAFunctions:
    """``df.na``: drop and fill."""

    def __init__(self, df: DataFrame):
        self._df = df

    def drop(self, how: str = "any", subset=None) -> DataFrame:
        return self._df.dropna(how, subset)

    def fill(self, value, subset=None) -> DataFrame:
        return self._df.fillna(value, subset)


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

    def flatMapGroupsWithState(self, func, outputStructType,
                               outputMode: str = "append",
                               timeoutConf: str = "NoTimeout") -> DataFrame:
        """Arbitrary stateful per-group processing (pyspark's
        ``applyInPandasWithState`` shape).  ``func(key_tuple, rows,
        state)`` returns output tuples.  On a stream ``state`` persists
        across micro-batches and, with ``EventTimeTimeout``, times out by
        watermark; in batch mode each group sees one fresh state."""
        if timeoutConf not in ("NoTimeout", "EventTimeTimeout"):
            raise AnalysisException(
                f"unsupported timeoutConf {timeoutConf!r}; processing-time "
                "timeouts do not replay deterministically — use "
                "EventTimeTimeout")
        if outputMode not in ("append", "update"):
            raise AnalysisException(
                "flatMapGroupsWithState supports append/update output modes")
        key_names = []
        for k in self._keys:
            base = k.children[0] if isinstance(k, Alias) else k
            if not isinstance(base, Col):
                raise AnalysisException(
                    "flatMapGroupsWithState grouping keys must be plain "
                    "columns")
            key_names.append(k.name)
        return DataFrame(self._df.session, L.FlatMapGroupsWithState(
            func, key_names, outputStructType, outputMode, timeoutConf,
            self._df._plan))

    applyInPandasWithState = flatMapGroupsWithState

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
