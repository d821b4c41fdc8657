"""Logical plan nodes (a copy of ``spark_tpu/sql/logical.py``).

The analog of Catalyst's ``plans/logical/basicLogicalOperators.scala``:
immutable trees with schema propagation, transformed by analyzer/optimizer
rules.  Unlike the reference there is no separate "resolved" attribute
identity machinery (exprId); columns bind by name within a plan's scope,
with join-side disambiguation handled by qualified names (``left.key``)
and automatic uniquification at join time.
"""

from __future__ import annotations

import itertools
from typing import Callable, List, Optional, Sequence, Tuple

from .. import types as T
from ..aggregates import AggregateFunction
from ..columnar import ColumnBatch
from ..expressions import AnalysisException, Expression

__all__ = [
    "LogicalPlan", "LocalRelation", "RangeRelation", "Project", "Filter",
    "Aggregate", "Sort", "SortOrder", "Limit", "Join", "Union", "Distinct",
    "SubqueryAlias", "UnresolvedRelation", "FileRelation", "Sample",
    "Intersect", "Except", "Explode", "CachedRelation", "LazyCheckpoint",
    "plan_cache_key",
]


class SortOrder:
    def __init__(self, child: Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.child = child
        self.ascending = ascending
        # Spark default: NULLS FIRST for ASC, NULLS LAST for DESC
        self.nulls_first = nulls_first if nulls_first is not None else ascending

    def __repr__(self):
        d = "ASC" if self.ascending else "DESC"
        n = "NULLS FIRST" if self.nulls_first else "NULLS LAST"
        return f"{self.child!r} {d} {n}"


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    def schema(self) -> T.StructType:
        raise NotImplementedError

    def expressions(self) -> List[Expression]:
        return []

    def map_children(self, fn: Callable[["LogicalPlan"], "LogicalPlan"]) -> "LogicalPlan":
        if not self.children:
            return self
        import copy
        new = copy.copy(self)
        new.children = tuple(fn(c) for c in self.children)
        return new

    def transform_up(self, fn: Callable[["LogicalPlan"], "LogicalPlan"]) -> "LogicalPlan":
        node = self.map_children(lambda c: c.transform_up(fn))
        return fn(node)

    def map_expressions(self, fn: Callable[[Expression], Expression]) -> "LogicalPlan":
        """Rebuild with every expression rewritten (rule plumbing)."""
        return self

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + repr(self) + "\n"
        for c in self.children:
            s += c.tree_string(indent + 1)
        return s

    def __repr__(self):  # pragma: no cover
        return type(self).__name__


_cache_uids = itertools.count(1)


def _batch_uid(batch) -> int:
    """Monotonic uid attached to a batch on first use — identity that can
    never be recycled the way ``id()`` can after garbage collection (a
    replaced temp view's new batch never takes the old one's uid)."""
    uid = getattr(batch, "_cache_uid", None)
    if uid is None:
        uid = batch._cache_uid = next(_cache_uids)
    return uid


class LocalRelation(LogicalPlan):
    """In-memory data (``LocalRelation.scala``); leaf."""

    def __init__(self, batch: ColumnBatch):
        self.batch = batch

    def schema(self) -> T.StructType:
        return self.batch.schema

    def __repr__(self):
        return f"LocalRelation {self.batch.schema.simpleString()}"


def plan_cache_key(node: "LogicalPlan", _memo: Optional[dict] = None) -> str:
    """Stable fingerprint of a logical subtree for cached-relation lookup
    (``CacheManager.lookupCachedData`` plan matching).  Reprs alone are NOT
    trusted — several are elided for humans (Aggregate shows output names,
    not functions) — so the key serializes every non-child field of the
    node plus its expressions.  Identity-carrying fields never use raw
    ``repr``/``id`` (recyclable addresses): LocalRelation keys on a
    monotonic batch uid and callables on a uid attached the same way.
    Pass one ``_memo`` dict across many calls over a shared tree to stay
    O(n)."""
    if _memo is not None:
        hit = _memo.get(id(node))
        if hit is not None:
            return hit
    if isinstance(node, LocalRelation):
        key = f"LocalRelation#{_batch_uid(node.batch)}"
    else:
        fields = []
        for name in sorted(vars(node)):
            if name in ("children", "child") or name.startswith("_"):
                continue
            v = vars(node)[name]
            if isinstance(v, LogicalPlan) or (
                    isinstance(v, (list, tuple)) and v
                    and isinstance(v[0], LogicalPlan)):
                continue
            if callable(v) and not isinstance(v, type):
                fields.append(f"{name}=fn#{_batch_uid(v)}")
            else:
                fields.append(f"{name}={v!r}")
        inner = ",".join(plan_cache_key(c, _memo) for c in node.children)
        key = f"{type(node).__name__}[{';'.join(fields)}]({inner})"
    if _memo is not None:
        _memo[id(node)] = key
    return key


class CachedRelation(LocalRelation):
    """A subtree that ``DataFrame.cache()`` materialized, substituted by
    ``QueryExecution.analyzed`` (``InMemoryRelation`` analog): the batch
    the session's cache manager served, and the entry's key, under which
    the serving plan cache reads the entry again on a hit (the batch may
    have been demoted and promoted since)."""

    def __init__(self, batch: ColumnBatch, cache_key: str):
        super().__init__(batch)
        self.cache_key = cache_key


class RangeRelation(LogicalPlan):
    """range(start, end, step) → single bigint column `id` (``Range``)."""

    def __init__(self, start: int, end: int, step: int = 1, name: str = "id"):
        if step == 0:
            raise AnalysisException("range step cannot be 0")
        self.start, self.end, self.step = start, end, step
        self.name = name

    def num_rows(self) -> int:
        if self.step > 0:
            return max(0, (self.end - self.start + self.step - 1) // self.step)
        return max(0, (self.start - self.end - self.step - 1) // (-self.step))

    def schema(self) -> T.StructType:
        return T.StructType([T.StructField(self.name, T.int64, False)])

    def __repr__(self):
        return f"Range({self.start}, {self.end}, {self.step})"


class FileRelation(LogicalPlan):
    """A file-backed relation (parquet/csv/json/text/orc); ``io.py`` reads
    it into one host batch when the query is planned.

    ``columns`` (set by the optimizer's column pruning — the
    ``ColumnPruning``/``FileSourceStrategy`` analog) restricts the read to
    a subset of fields; ``pushed_filters`` are advisory ``(col, op,
    value)`` conjuncts that SKIP parquet row groups by footer min/max
    stats (``ParquetFilters.scala`` role) — the exact Filter stays in the
    plan."""

    def __init__(self, fmt: str, paths: List[str], schema: T.StructType,
                 options: Optional[dict] = None,
                 columns: Optional[List[str]] = None,
                 pushed_filters: Optional[List[tuple]] = None):
        self.fmt = fmt
        self.paths = paths
        self._schema = schema
        self.options = options or {}
        self.columns = columns
        self.pushed_filters = pushed_filters

    def schema(self) -> T.StructType:
        if self.columns is not None:
            keep = set(self.columns)
            return T.StructType([f for f in self._schema.fields
                                 if f.name in keep])
        return self._schema

    def __repr__(self):
        s = f"FileRelation[{self.fmt}] {self.paths}"
        if self.columns is not None:
            s += f" cols={self.columns}"
        if self.pushed_filters:
            s += f" pushed={self.pushed_filters}"
        return s


class UnresolvedRelation(LogicalPlan):
    """A table name from SQL text awaiting catalog lookup."""

    def __init__(self, name: str):
        self.name = name

    def schema(self) -> T.StructType:
        raise AnalysisException(f"unresolved relation {self.name}")

    def __repr__(self):
        return f"UnresolvedRelation {self.name}"


class Project(LogicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: LogicalPlan):
        self.exprs = list(exprs)
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def expressions(self):
        return list(self.exprs)

    def map_expressions(self, fn):
        # type(self): subclasses (e.g. the analyzer's _JoinSideRename marker)
        # must survive expression rewrites
        return type(self)([fn(e) for e in self.exprs], self.children[0])

    def schema(self) -> T.StructType:
        cs = self.child.schema()
        return T.StructType([
            T.StructField(e.name, e.data_type(cs)) for e in self.exprs])

    def __repr__(self):
        return f"Project [{', '.join(repr(e) for e in self.exprs)}]"


class Filter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.condition = condition
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def expressions(self):
        return [self.condition]

    def map_expressions(self, fn):
        return Filter(fn(self.condition), self.children[0])

    def schema(self) -> T.StructType:
        return self.child.schema()

    def __repr__(self):
        return f"Filter ({self.condition!r})"


class Aggregate(LogicalPlan):
    """GROUP BY: grouping exprs + aggregate output exprs.

    ``aggs`` are (AggregateFunction, output_name) pairs; post-aggregation
    scalar expressions over agg results (e.g. ``sum(x)/count(y)``) are
    rewritten by the analyzer into Project(Aggregate(...)).
    """

    def __init__(self, keys: Sequence[Expression],
                 aggs: Sequence[Tuple[AggregateFunction, str]],
                 child: LogicalPlan):
        self.keys = list(keys)
        self.aggs = list(aggs)
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def expressions(self):
        return list(self.keys) + [f for f, _ in self.aggs]

    def map_expressions(self, fn):
        return Aggregate([fn(k) for k in self.keys],
                         [(fn(f), n) for f, n in self.aggs],
                         self.children[0])

    def schema(self) -> T.StructType:
        cs = self.child.schema()
        fields = [T.StructField(k.name, k.data_type(cs)) for k in self.keys]
        fields += [T.StructField(n, f.data_type(cs)) for f, n in self.aggs]
        return T.StructType(fields)

    def __repr__(self):
        return (f"Aggregate [{', '.join(k.name for k in self.keys)}] "
                f"[{', '.join(n for _, n in self.aggs)}]")


class Sort(LogicalPlan):
    def __init__(self, orders: Sequence[SortOrder], child: LogicalPlan,
                 is_global: bool = True):
        self.orders = list(orders)
        self.children = (child,)
        self.is_global = is_global

    @property
    def child(self):
        return self.children[0]

    def expressions(self):
        return [o.child for o in self.orders]

    def map_expressions(self, fn):
        return Sort([SortOrder(fn(o.child), o.ascending, o.nulls_first)
                     for o in self.orders], self.children[0], self.is_global)

    def schema(self) -> T.StructType:
        return self.child.schema()

    def __repr__(self):
        return f"Sort [{', '.join(map(repr, self.orders))}]"


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        self.n = n
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.StructType:
        return self.child.schema()

    def __repr__(self):
        return f"Limit {self.n}"


class Join(LogicalPlan):
    JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti", "cross")

    #: planner hint: the build (right) side arrives key-sorted from the
    #: cross-process range exchange, and the physical planner picks the
    #: merge join that skips the build sort (set by ``crossproc``)
    _presorted_build = False

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 how: str, on: Optional[Expression] = None,
                 using: Optional[List[str]] = None):
        how = {"leftouter": "left", "left_outer": "left",
               "rightouter": "right", "right_outer": "right",
               "outer": "full", "fullouter": "full", "full_outer": "full",
               "semi": "left_semi", "leftsemi": "left_semi",
               "anti": "left_anti", "leftanti": "left_anti"}.get(how, how)
        if how not in self.JOIN_TYPES:
            raise AnalysisException(f"unsupported join type {how}")
        self.children = (left, right)
        self.how = how
        self.on = on          # boolean condition over both sides
        self.using = using    # USING / same-name key list

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def expressions(self):
        return [self.on] if self.on is not None else []

    def map_expressions(self, fn):
        out = Join(self.children[0], self.children[1], self.how,
                   fn(self.on) if self.on is not None else None, self.using)
        out._presorted_build = self._presorted_build
        return out

    def schema(self) -> T.StructType:
        ls, rs = self.left.schema(), self.right.schema()
        if self.how in ("left_semi", "left_anti"):
            return ls
        if self.using:
            rfields = [f for f in rs.fields if f.name not in self.using]
        else:
            rfields = rs.fields
        nullable_left = self.how in ("right", "full")
        nullable_right = self.how in ("left", "full")
        fields = [T.StructField(f.name, f.dataType, f.nullable or nullable_left)
                  for f in ls.fields]
        fields += [T.StructField(f.name, f.dataType, f.nullable or nullable_right)
                   for f in rfields]
        return T.StructType(fields)

    def __repr__(self):
        return f"Join {self.how} on={self.on!r} using={self.using}"


class Union(LogicalPlan):
    def __init__(self, children: Sequence[LogicalPlan]):
        if len(children) < 2:
            raise AnalysisException("union needs >=2 children")
        self.children = tuple(children)

    def schema(self) -> T.StructType:
        schemas = [c.schema() for c in self.children]
        first = schemas[0]
        for s in schemas[1:]:
            if len(s) != len(first):
                raise AnalysisException(
                    f"union arity mismatch: {len(first)} vs {len(s)}")
        fields = []
        for i, f in enumerate(schemas[0].fields):
            dt = f.dataType
            nullable = f.nullable
            for s in schemas[1:]:
                other = s.fields[i].dataType
                ct = T.common_type(dt, other)
                # string↔numeric implicit coercion is fine in comparisons but
                # NOT in union (it would reinterpret dictionary codes)
                if ct is None or (dt.is_string != other.is_string
                                  and not isinstance(dt, T.NullType)
                                  and not isinstance(other, T.NullType)):
                    raise AnalysisException(
                        f"union type mismatch at column {f.name}: "
                        f"{dt} vs {other}")
                dt = ct
                nullable = nullable or s.fields[i].nullable
            fields.append(T.StructField(f.name, dt, nullable))
        return T.StructType(fields)

    def __repr__(self):
        return f"Union({len(self.children)})"


class Intersect(LogicalPlan):
    """INTERSECT DISTINCT; analysis rewrites it to Distinct(left-semi join)
    on all columns (`ReplaceIntersectWithSemiJoin` analog).  NULL rows
    match only by plain equality here (no null-safe compare yet)."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan):
        self.children = (left, right)

    def schema(self) -> T.StructType:
        return self.children[0].schema()

    def __repr__(self):
        return "Intersect"


class Except(LogicalPlan):
    """EXCEPT DISTINCT -> Distinct(left-anti join)
    (`ReplaceExceptWithAntiJoin` analog)."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan):
        self.children = (left, right)

    def schema(self) -> T.StructType:
        return self.children[0].schema()

    def __repr__(self):
        return "Except"


class Distinct(LogicalPlan):
    def __init__(self, child: LogicalPlan):
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.StructType:
        return self.child.schema()


class Sample(LogicalPlan):
    """sample(fraction, seed): deterministic hash-based row sampling."""

    def __init__(self, fraction: float, seed: int, child: LogicalPlan):
        self.fraction = fraction
        self.seed = seed
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.StructType:
        return self.child.schema()

    def __repr__(self):
        return f"Sample({self.fraction})"


class SubqueryAlias(LogicalPlan):
    """Names a subtree so SQL can reference ``alias.column``."""

    def __init__(self, alias: str, child: LogicalPlan):
        self.alias = alias
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.StructType:
        return self.child.schema()

    def __repr__(self):
        return f"SubqueryAlias {self.alias}"


class Explode(LogicalPlan):
    """Row-generating projection: ``SELECT pre..., explode(arr) AS out``
    (``GenerateExec`` for explode/posexplode).  Its capacity is the
    child's times the array's width, dead element slots masked: row
    generation with static shapes."""

    def __init__(self, pre_exprs: List[Expression], array_expr: Expression,
                 out_name: str, with_pos: bool, pos_name: str,
                 child: LogicalPlan, insert_at: Optional[int] = None):
        self.pre_exprs = list(pre_exprs)
        self.array_expr = array_expr
        self.out_name = out_name
        self.with_pos = with_pos
        self.pos_name = pos_name
        self.insert_at = len(self.pre_exprs) if insert_at is None \
            else int(insert_at)
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def expressions(self):
        return list(self.pre_exprs) + [self.array_expr]

    def map_expressions(self, fn):
        return Explode([fn(e) for e in self.pre_exprs], fn(self.array_expr),
                       self.out_name, self.with_pos, self.pos_name,
                       self.children[0], insert_at=self.insert_at)

    def schema(self) -> T.StructType:
        cs = self.children[0].schema()
        gen = []
        if self.with_pos:
            gen.append(T.StructField(self.pos_name, T.int32, False))
        at = self.array_expr.data_type(cs)
        if not isinstance(at, T.ArrayType):
            raise AnalysisException(f"explode expects an array, got {at}")
        gen.append(T.StructField(self.out_name, at.element_type))
        fields = [T.StructField(e.name, e.data_type(cs))
                  for e in self.pre_exprs]
        i = min(self.insert_at, len(fields))
        return T.StructType(fields[:i] + gen + fields[i:])

    def __repr__(self):
        return (f"Explode[{self.array_expr!r} AS {self.out_name}"
                f"{' WITH pos' if self.with_pos else ''}]")


class GroupingSets(LogicalPlan):
    """GROUP BY ROLLUP/CUBE/GROUPING SETS — carried from the parser to the
    analyzer, which rewrites it into a UNION ALL of one Aggregate per
    grouping set with typed NULL literals for the absent keys (the
    reference's `Expand`-based plan re-shaped for static columnar
    execution: N fused aggregations beat one 3x-expanded scatter here).
    ``sets`` holds index tuples into ``keys``; ``grouping()`` calls in the
    select list resolve to per-branch literals."""

    def __init__(self, select_list: List[Expression], keys: List[Expression],
                 sets: List[Tuple[int, ...]], having: Optional[Expression],
                 child: LogicalPlan):
        self.select_list = list(select_list)
        self.keys = list(keys)
        self.sets = [tuple(s) for s in sets]
        self.having = having
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def expressions(self):
        return list(self.select_list) + list(self.keys) + (
            [self.having] if self.having is not None else [])

    def map_expressions(self, fn):
        return GroupingSets([fn(e) for e in self.select_list],
                            [fn(k) for k in self.keys], self.sets,
                            None if self.having is None
                            else fn(self.having), self.children[0])

    def schema(self) -> T.StructType:
        # representative schema: every key present (the full grouping
        # set), fields in SELECT-LIST order — exactly what the rewrite's
        # per-branch Project emits (set-op branches compare arity/order
        # against this before the rewrite runs)
        from .analyzer import build_aggregate
        rep = build_aggregate(self.keys, self.select_list, self.children[0])
        rs = rep.schema()
        by_name = {f.name: f for f in rs.fields}
        return T.StructType([by_name[e.name] for e in self.select_list])

    def __repr__(self):
        return f"GroupingSets[{len(self.sets)} sets over {self.keys!r}]"


class LazyCheckpoint(LogicalPlan):
    """checkpoint(eager=False): materializes the child to parquet on the
    FIRST execution touching this node (a plan-level memo — derived
    DataFrames share it), then scans the files."""

    def __init__(self, child: LogicalPlan, path: str):
        self.path = path
        # shared mutable box: analyzer/optimizer rewrites shallow-copy
        # nodes, and every copy must see the one materialization
        self.state = {"done": False}
        self.children = (child,)

    @property
    def child(self):
        return self.children[0]

    def schema(self) -> T.StructType:
        return self.children[0].schema()

    def __repr__(self):
        return f"LazyCheckpoint[{self.path}]"
