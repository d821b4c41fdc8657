"""Rule-based optimizer.

A copy of ``spark_tpu/sql/optimizer.py`` (the analog of
``catalyst/optimizer/Optimizer.scala``: batches of rewrite rules run to
fixed point by a RuleExecutor), with the file rules: column pruning into
file scans, advisory row-group filters, and join ordering from file
statistics (parquet footers, ANALYZE TABLE results, sampled NDVs).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ..aggregates import AggregateFunction
from ..columnar import ColumnBatch
from ..expressions import (GE, LE, Alias, AnalysisException, And, Between,
                           Col, EvalContext, Expression, Literal, Rand,
                           RowIndex)
from .logical import (
    Aggregate, Distinct, FileRelation, Filter, Join, Limit, LocalRelation,
    LogicalPlan, Project, RangeRelation, Sample, Sort, SubqueryAlias, Union,
)

MAX_ITERATIONS = 50


def is_deterministic(e: Expression) -> bool:
    """False for rand/randn and monotonically_increasing_id: their value
    is a function of the row's position in its operator, so no rule may
    move them past another operator or copy them."""
    if isinstance(e, (Rand, RowIndex)):
        return False
    return all(is_deterministic(c) for c in e.children)


def substitute(e: Expression, mapping: Dict[str, Expression]) -> Expression:
    if isinstance(e, Col):
        return mapping.get(e.name, e)
    return e.map_children(lambda c: substitute(c, mapping))


def _alias_map(p: Project) -> Optional[Dict[str, Expression]]:
    m: Dict[str, Expression] = {}
    for e in p.exprs:
        if isinstance(e, Alias):
            if not is_deterministic(e.children[0]):
                return None
            m[e.name] = e.children[0]
        elif isinstance(e, Col):
            m[e.name] = e
        else:
            if not is_deterministic(e):
                return None
            m[e.name] = e
    return m


# ---------------------------------------------------------------------------
# rules — each: LogicalPlan -> LogicalPlan (identity when not applicable)
# ---------------------------------------------------------------------------

def simplify_complex_ops(node: LogicalPlan) -> LogicalPlan:
    """Rewrite map/struct consumers over their creators into flat array/
    scalar expressions (``SimplifyExtractValueOps`` over
    ``complexTypeExtractors.scala``), once collapse_projects has put
    extractor and creator in one expression tree:

    * ``getField(struct(...), f)``        → the field expression
    * ``map_keys/values(map(...))``       → ``array(...)`` of that side
    * ``map_keys/values(map_from_arrays)``→ the plane array
    * ``element_at(map(...), k)``         → a first-match If chain
    * ``element_at(map_from_arrays, lit)``→ a plane gather by array_position
    * ``size(map)``                       → the size of the keys plane
    * ``arr[i]`` (GetItem)                → ``element_at(arr, i + 1)``

    Complex values never hold a device plane: whatever survives these
    rewrites raises at eval, as in the JAX package."""
    from .. import types as T
    from ..expressions import (
        ArrayGather, ArrayPosition, ArraySize, CreateMap, CreateStruct,
        ElementAt, GetField, GetItem, If, MakeArray, MapFromArrays, MapGet,
        MapKeys, MapValues,
    )


    # the child schema is computed only when a complex-type candidate is
    # met — computing it for every node is quadratic in the plan
    _unset = object()
    state = {"schema": _unset}

    def get_schema():
        if state["schema"] is _unset:
            state["schema"] = None
            if len(node.children) == 1:
                try:
                    state["schema"] = node.children[0].schema()
                except Exception:
                    pass
        return state["schema"]

    def dtype_of(e):
        schema = get_schema()
        if schema is None:
            return None
        try:
            return e.data_type(schema)
        except Exception:
            return None

    def creator(x):
        """The creator behind Alias wrapping."""
        while isinstance(x, Alias):
            x = x.children[0]
        return x

    def rw(e):
        e = e.map_children(rw)
        if isinstance(e, (MapKeys, MapValues)):
            c = creator(e.children[0])
            if isinstance(c, CreateMap):
                parts = c.keys if e.WHICH == "keys" else c.values
                return MakeArray(*parts)
            if isinstance(c, MapFromArrays):
                return c.children[0 if e.WHICH == "keys" else 1]
        if isinstance(e, GetField) \
                and isinstance(creator(e.children[0]), CreateStruct):
            st = creator(e.children[0])
            if e.field in st.field_names:
                return st.children[st.field_names.index(e.field)]
        if isinstance(e, GetItem):
            ct = dtype_of(e.children[0])
            if isinstance(ct, T.ArrayType):         # 0-based position
                if isinstance(e.key, int):
                    if e.key < 0:
                        # GetArrayItem: a negative ordinal is NULL (only
                        # element_at counts from the end)
                        return Literal(None, ct.element_type)
                    return ElementAt(e.children[0], e.key + 1)
            elif isinstance(ct, T.MapType):
                return rw(MapGet(e.children[0], Literal(e.key)))
            elif isinstance(ct, T.StructType) and isinstance(e.key, str):
                return rw(GetField(e.children[0], e.key))
        if isinstance(e, MapGet):
            m, k = e.children
            if isinstance(dtype_of(m), T.ArrayType):
                # dynamic element_at(arr, expr): the 1-based gather
                return ArrayGather(m, k)
            m = creator(m)
            if isinstance(m, CreateMap):
                vt = dtype_of(m)
                if not isinstance(vt, T.MapType):
                    try:
                        vt = m.data_type(None)  # literal-only maps
                    except Exception:
                        return e
                    if not isinstance(vt, T.MapType):
                        return e
                out = Literal(None, vt.value_type)
                # GetMapValue scans pairs in order, the first match wins:
                # build the chain inside out so pair 1 ends outermost
                for kk, vv in reversed(list(zip(m.keys, m.values))):
                    out = If(kk == k, vv, out)
                return out
            if isinstance(m, MapFromArrays) and isinstance(k, Literal):
                ka, va = m.children
                return ArrayGather(va, ArrayPosition(ka, k.value))
        if isinstance(e, ArraySize) \
                and isinstance(dtype_of(e.children[0]), T.MapType):
            return rw(ArraySize(MapKeys(e.children[0])))
        if isinstance(e, ElementAt) \
                and isinstance(dtype_of(e.children[0]), T.MapType):
            return rw(MapGet(e.children[0], Literal(e.index)))
        return e

    return node.map_expressions(rw)


def _has_extractors(plan: LogicalPlan) -> bool:
    """Whether any expression of the plan is one simplify_complex_ops
    rewrites.  No other rule makes one, so a plan without any needs the
    rule on no pass."""
    from ..expressions import (ArraySize, ElementAt, GetField, GetItem,
                               MapGet, MapKeys, MapValues)
    kinds = (GetField, GetItem, MapGet, MapKeys, MapValues, ArraySize,
             ElementAt)

    def has(e: Expression) -> bool:
        return isinstance(e, kinds) or any(has(c) for c in e.children)

    return any(has(e) for e in plan.expressions()) \
        or any(_has_extractors(c) for c in plan.children)


def eliminate_subquery_aliases(node: LogicalPlan) -> LogicalPlan:
    """Drop SubqueryAlias after analysis (``EliminateSubqueryAliases``)."""
    if isinstance(node, SubqueryAlias):
        return node.children[0]
    return node


def collapse_projects(node: LogicalPlan) -> LogicalPlan:
    """Project(Project(x)) → Project(x) with substitution
    (``CollapseProject`` in the reference)."""
    if isinstance(node, Project) and isinstance(node.child, Project):
        inner = node.child
        m = _alias_map(inner)
        if m is None:
            return node
        new_exprs = []
        for e in node.exprs:
            sub = substitute(e, m)
            if sub.name != e.name:
                sub = Alias(sub, e.name)
            new_exprs.append(sub)
        return Project(new_exprs, inner.child)
    return node


def push_project_through_limit(node: LogicalPlan) -> LogicalPlan:
    """Project(Limit(x)) → Limit(Project(x)): projection is row-wise, so
    it commutes with Limit."""
    if isinstance(node, Project) and isinstance(node.child, Limit) \
            and all(is_deterministic(e) for e in node.exprs):
        lim = node.child
        return Limit(lim.n, Project(node.exprs, lim.children[0]))
    return node


def _referenced_cols(e: Expression, out: set) -> None:
    if isinstance(e, Col):
        out.add(e.name)
    for c in e.children:
        _referenced_cols(c, out)


def push_project_through_sort(node: LogicalPlan) -> LogicalPlan:
    """Project(Sort(x)) → Sort(Project(x)) when the projection passes
    every column the sort orders reference straight through."""
    if not (isinstance(node, Project) and isinstance(node.child, Sort)
            and all(is_deterministic(e) for e in node.exprs)):
        return node
    sort = node.child
    needed: set = set()
    for o in sort.orders:
        _referenced_cols(o.child, needed)
    passed = set()
    for e in node.exprs:
        base = e.children[0] if isinstance(e, Alias) else e
        if isinstance(base, Col) and (not isinstance(e, Alias)
                                      or e.name == base.name):
            passed.add(base.name)
    if not needed <= passed:
        return node
    return Sort(sort.orders, Project(node.exprs, sort.children[0]),
                sort.is_global)


def prune_project_under_aggregate(node: LogicalPlan) -> LogicalPlan:
    """Aggregate(Project(x)): drop project columns the aggregate never
    references (``ColumnPruning`` restricted to the schema-discarding
    parent)."""
    if not (isinstance(node, Aggregate) and isinstance(node.child, Project)):
        return node
    proj = node.child
    needed: set = set()
    for e in list(node.keys) + [f for f, _n in node.aggs]:
        _referenced_cols(e, needed)
    keep = [e for e in proj.exprs if e.name in needed]
    if len(keep) == len(proj.exprs):
        return node
    if not keep:
        # count(*)-style: rows matter, values don't — keep one cheap col
        keep = [Alias(Literal(1), "__one")]
    return Aggregate(node.keys, node.aggs, Project(keep, proj.children[0]))


def combine_filters(node: LogicalPlan) -> LogicalPlan:
    """Filter(Filter(x)) → Filter(a AND b) (``CombineFilters``)."""
    if isinstance(node, Filter) and isinstance(node.child, Filter):
        inner = node.child
        return Filter(And(inner.condition, node.condition), inner.child)
    return node


def push_filter_through_project(node: LogicalPlan) -> LogicalPlan:
    """Filter(Project(x)) → Project(Filter(x)) (``PushDownPredicate``)."""
    if isinstance(node, Filter) and isinstance(node.child, Project):
        proj = node.child
        m = _alias_map(proj)
        if m is None or not is_deterministic(node.condition):
            return node
        return Project(proj.exprs, Filter(substitute(node.condition, m), proj.child))
    return node


def push_filter_through_alias(node: LogicalPlan) -> LogicalPlan:
    """Filter(SubqueryAlias(x)) → SubqueryAlias(Filter(x))."""
    if isinstance(node, Filter) and isinstance(node.child, SubqueryAlias):
        sa = node.child
        return SubqueryAlias(sa.alias, Filter(node.condition, sa.children[0]))
    return node


def push_filter_through_aggregate(node: LogicalPlan) -> LogicalPlan:
    """Filter conjuncts referencing only GROUPING KEYS move below the
    Aggregate (`PushDownPredicate`'s aggregate case)."""
    if not (isinstance(node, Filter) and isinstance(node.child, Aggregate)):
        return node
    agg = node.child
    if not agg.keys:
        return node
    key_map = {}
    for k in agg.keys:
        key_map[k.name] = k.children[0] if isinstance(k, Alias) else k
    push, keep = [], []
    for c in split_conjuncts(node.condition):
        refs = c.references()
        if refs and refs <= set(key_map) and is_deterministic(c):
            push.append(substitute(c, key_map))
        else:
            keep.append(c)
    if not push:
        return node
    new_agg = Aggregate(agg.keys, agg.aggs,
                        Filter(join_conjuncts(push), agg.children[0]))
    return Filter(join_conjuncts(keep), new_agg) if keep else new_agg


def push_filter_through_union(node: LogicalPlan) -> LogicalPlan:
    """Union output names come from the FIRST branch; the pushed condition
    must rebind to each branch's own column names positionally
    (`PushProjectionThroughUnion`'s rewrite contract)."""
    if isinstance(node, Filter) and isinstance(node.child, Union):
        u = node.child
        try:
            out_names = u.schema().names
        except AnalysisException:
            return node
        new_children = []
        for c in u.children:
            bnames = c.schema().names
            m = {o: Col(b) for o, b in zip(out_names, bnames) if o != b}
            cond = substitute(node.condition, m) if m else node.condition
            new_children.append(Filter(cond, c))
        return Union(new_children)
    return node


def push_filter_through_join(node: LogicalPlan) -> LogicalPlan:
    """Filter(Join) → push conjuncts referencing only one side below the join
    (a side only when it is not null-supplying)."""
    if not (isinstance(node, Filter) and isinstance(node.child, Join)):
        return node
    j = node.child
    if j.how in ("inner", "cross"):
        may_left, may_right = True, True
    elif j.how in ("left", "left_semi", "left_anti"):
        may_left, may_right = True, False
    elif j.how == "right":
        may_left, may_right = False, True
    else:
        return node
    left_cols = set(j.left.schema().names)
    right_cols = set(j.right.schema().names)
    conjuncts = split_conjuncts(node.condition)
    left_push, right_push, keep = [], [], []
    for c_ in conjuncts:
        refs = c_.references()
        if not is_deterministic(c_):
            keep.append(c_)
        elif refs <= left_cols and may_left:
            left_push.append(c_)
        elif refs <= right_cols and may_right and not (refs <= left_cols):
            right_push.append(c_)
        else:
            keep.append(c_)
    if not left_push and not right_push:
        return node
    new_left = Filter(join_conjuncts(left_push), j.left) if left_push else j.left
    new_right = Filter(join_conjuncts(right_push), j.right) if right_push else j.right
    new_join = Join(new_left, new_right, j.how, j.on, j.using)
    return Filter(join_conjuncts(keep), new_join) if keep else new_join


def _collect_cross_inner(node: LogicalPlan, rels: List[LogicalPlan],
                         conds: List[Expression]) -> None:
    """Flatten a tree of cross/inner joins into (relations, conjuncts);
    filters INSIDE the chain are hoisted into the conjunct pool."""
    if isinstance(node, Filter) and isinstance(node.children[0], (Join, Filter)):
        conds.extend(split_conjuncts(node.condition))
        _collect_cross_inner(node.children[0], rels, conds)
        return
    if isinstance(node, Filter) and isinstance(_unaliased(node.children[0]),
                                               FileRelation):
        # hoisted so that footer-stat selectivity feeds the ordering; the
        # conjunct re-attaches at this relation's join (or on top)
        conds.extend(split_conjuncts(node.condition))
        rels.append(node.children[0])
        return
    if isinstance(node, Join) and node.how in ("inner", "cross") \
            and not node.using:
        if node.on is not None:
            conds.extend(split_conjuncts(node.on))
        _collect_cross_inner(node.left, rels, conds)
        _collect_cross_inner(node.right, rels, conds)
    else:
        rels.append(node)


def _unaliased(node: LogicalPlan) -> LogicalPlan:
    while isinstance(node, SubqueryAlias):
        node = node.children[0]
    return node


def rows_estimate(node: LogicalPlan) -> int:
    """Crude cardinality upper bound for join ordering: batch capacities,
    and for files their row counts (parquet footers) shrunk by the
    selectivity of filters directly over them."""
    if isinstance(node, LocalRelation):
        return node.batch.capacity
    if isinstance(node, RangeRelation):
        return node.num_rows()
    if isinstance(node, FileRelation):
        est = node.__dict__.get("_est_rows")
        if est is None:
            from ..io import file_row_count
            try:
                est = file_row_count(node) or (1 << 20)
            except AnalysisException:
                est = 1 << 20
            node.__dict__["_est_rows"] = est
        return est
    if isinstance(node, Limit):
        return min(node.n, rows_estimate(node.children[0]))
    if isinstance(node, Union):
        return sum(rows_estimate(c) for c in node.children)
    if isinstance(node, Filter):
        est = rows_estimate(node.children[0])
        base = _unaliased(node.children[0])
        if isinstance(base, FileRelation):
            sel = filter_selectivity(split_conjuncts(node.condition), base)
            return max(int(est * sel), 1)
        return est
    if node.children:
        return max(rows_estimate(c) for c in node.children)
    return 1 << 10


def filter_selectivity(conjuncts: List[Expression], rel) -> float:
    """Combined selectivity of filter conjuncts over a file relation, from
    the column statistics (parquet footer min/max/null counts, or ANALYZE
    TABLE results; ``FilterEstimation.scala`` role).  Unknown shapes give
    1.0: estimates only shrink where the statistics justify it."""
    from ..io import file_column_stats
    stats = file_column_stats(rel)
    if not stats:
        return 1.0
    flip = {"EQ": "EQ", "LT": "GT", "LE": "GE", "GT": "LT", "GE": "LE"}

    def one(c: Expression) -> float:
        op = type(c).__name__
        if op not in flip:
            return 1.0
        l, r = c.children
        if isinstance(l, Col) and isinstance(r, Literal):
            col, lit = l, r
        elif isinstance(r, Col) and isinstance(l, Literal):
            col, lit, op = r, l, flip[op]
        else:
            return 1.0
        st = stats.get(col.name)
        if st is None or st["min"] is None or lit.value is None:
            return 1.0
        lo, hi, total = st["min"], st["max"], max(st["total"], 1)
        nn = max(1.0 - st["null_count"] / total, 0.0)
        v = lit.value
        if isinstance(lo, (int, float)) and isinstance(v, (int, float)) \
                and not isinstance(v, bool):
            if v < lo or v > hi:
                return 1.0 / total if op == "EQ" else \
                    (nn if (op in ("GT", "GE")) == (v < lo) else
                     1.0 / total)
            if op == "EQ":
                # integral domains: uniform 1/(hi-lo+1); fractional: the
                # reference's default 1/ndv with an unknown ndv
                width = (hi - lo + 1) if isinstance(lo, int) else 0
                return nn / width if width > 1 else \
                    (nn if width == 1 else 0.1 * nn)
            span = float(hi) - float(lo)
            if span <= 0:
                return nn
            frac = min(max((float(v) - float(lo)) / span, 0.0), 1.0)
            return nn * (frac if op in ("LT", "LE") else 1.0 - frac)
        if isinstance(lo, str) and isinstance(v, str) and op == "EQ":
            return 0.1 * nn if lo <= v <= hi else 1.0 / total
        return 1.0

    sel = 1.0
    for c in conjuncts:
        sel *= one(c)
    return max(sel, 1e-4)


def reorder_joins(node: LogicalPlan) -> LogicalPlan:
    """Reorder a comma-join chain so every join is condition-connected
    (`ReorderJoin` in `optimizer/joins.scala`).  Greedy: start from the
    largest relation (the probe side of every join in the left-deep tree),
    repeatedly attach the connected relation with the smallest estimated
    output (file statistics where the relation is a file); attach every
    conjunct that closes over the new schema."""
    if not (isinstance(node, Filter) and isinstance(node.child, Join)):
        return node
    j = node.child
    if j.how not in ("inner", "cross") or j.using:
        return node
    rels: List[LogicalPlan] = []
    conds: List[Expression] = []
    _collect_cross_inner(j, rels, conds)
    if len(rels) < 3:
        return node                  # pair case: push_filter_into_join
    conds = conds + split_conjuncts(node.condition)
    if not all(is_deterministic(c) for c in conds):
        return node
    schemas = [set(r.schema().names) for r in rels]

    # the base relation becomes the probe side of every join of the
    # left-deep tree: the largest relation AFTER its own filter conjuncts
    # (footer-stat selectivity; CostBasedJoinReorder's stats-driven pick)
    def effective_rows(i: int) -> float:
        est = float(rows_estimate(rels[i]))
        base_rel = _unaliased(rels[i])
        if isinstance(base_rel, FileRelation):
            mine = [c_ for c_ in conds if c_.references() <= schemas[i]]
            if mine:
                est *= filter_selectivity(mine, base_rel)
        return est

    def key_ndv(i: int, key_col: str) -> float:
        """NDV of a candidate's join-key column (sampled parquet stats or
        ANALYZE results); else the relation's row estimate (a PK
        assumption)."""
        base_rel = _unaliased(rels[i])
        if isinstance(base_rel, FileRelation):
            from ..io import file_column_ndv
            ndv = file_column_ndv(base_rel, [key_col]).get(key_col)
            if ndv:
                return ndv
        return max(float(rows_estimate(rels[i])), 1.0)

    base = max(range(len(rels)), key=effective_rows)
    joined = rels[base]
    joined_cols = set(schemas[base])
    remaining = [i for i in range(len(rels)) if i != base]
    unused = list(conds)
    cur_rows = max(effective_rows(base), 1.0)
    made_progress = base != 0
    while remaining:
        best = None                  # (est_out, idx)
        for idx in remaining:
            cand_cols = schemas[idx]
            connecting = [
                c_ for c_ in unused
                if (c_.references() & joined_cols)
                and (c_.references() & cand_cols)
                and c_.references() <= (joined_cols | cand_cols)
            ]
            if not connecting:
                continue
            # the textbook equi-join cardinality |L||R| / max(ndv(keys)):
            # on a star schema the dimensions attach most selective first
            cand_rows = max(effective_rows(idx), 1.0)
            ndv = 1.0
            for c_ in connecting:
                for col in (c_.references() & cand_cols):
                    ndv = max(ndv, key_ndv(idx, col))
            est_out = cur_rows * cand_rows / ndv
            if best is None or est_out < best[0]:
                best = (est_out, idx)
        if best is not None:
            pick = best[1]
            cur_rows = max(best[0], 1.0)
        else:
            pick = remaining[0]      # genuinely unconnected: cross join
            cur_rows *= max(effective_rows(pick), 1.0)
        cand_cols = schemas[pick]
        new_cols = joined_cols | cand_cols
        attach = [c_ for c_ in unused if c_.references() <= new_cols
                  and (c_.references() & cand_cols)]
        if attach and pick != remaining[0]:
            made_progress = True
        # identity filtering: Expression.__eq__ builds EQ nodes
        attach_ids = {id(x) for x in attach}
        unused = [c_ for c_ in unused if id(c_) not in attach_ids]
        how = "inner" if attach else "cross"
        joined = Join(joined, rels[pick], how,
                      join_conjuncts(attach) if attach else None, None)
        joined_cols = new_cols
        remaining.remove(pick)
    if not made_progress:
        return node                  # already in a connected order
    return Filter(join_conjuncts(unused), joined) if unused else joined


def push_filter_into_join(node: LogicalPlan) -> LogicalPlan:
    """Filter conjuncts over a cross/inner join that reference BOTH sides
    become the join condition (comma-join → equi inner join)."""
    if not (isinstance(node, Filter) and isinstance(node.child, Join)):
        return node
    j = node.child
    if j.how not in ("inner", "cross") or j.using:
        return node
    left_cols = set(j.left.schema().names)
    right_cols = set(j.right.schema().names)
    both, keep = [], []
    for c_ in split_conjuncts(node.condition):
        refs = c_.references()
        if is_deterministic(c_) and (refs & left_cols) and \
                (refs & right_cols) and refs <= (left_cols | right_cols):
            both.append(c_)
        else:
            keep.append(c_)
    if not both:
        return node
    cond = join_conjuncts(both + ([j.on] if j.on is not None else []))
    new_join = Join(j.left, j.right, "inner", cond, None)
    return Filter(join_conjuncts(keep), new_join) if keep else new_join


def split_conjuncts(e: Expression) -> List[Expression]:
    if isinstance(e, And):
        return split_conjuncts(e.children[0]) + split_conjuncts(e.children[1])
    return [e]


def join_conjuncts(es: List[Expression]) -> Expression:
    out = es[0]
    for e in es[1:]:
        out = And(out, e)
    return out


def prune_filters(node: LogicalPlan) -> LogicalPlan:
    """Remove Filter(true); keep Filter(false) (planner emits empty)."""
    if isinstance(node, Filter) and isinstance(node.condition, Literal):
        if node.condition.value is True:
            return node.child
    return node


def push_limit(node: LogicalPlan) -> LogicalPlan:
    """Limit(Limit) → min; Limit(Project) → Project(Limit)."""
    if isinstance(node, Limit):
        if isinstance(node.child, Limit):
            return Limit(min(node.n, node.child.n), node.child.child)
        if isinstance(node.child, Project):
            return Project(node.child.exprs, Limit(node.n, node.child.child))
    return node


def constant_fold_expr(e: Expression) -> Expression:
    if isinstance(e, (Literal, AggregateFunction)):
        return e
    if isinstance(e, Alias):  # fold inside, keep the output name
        return Alias(constant_fold_expr(e.children[0]), e.name)
    e2 = e.map_children(constant_fold_expr)
    if e2.foldable and is_deterministic(e2):
        try:
            from .. import types as T
            # a 1-row dummy batch on the host: folding is plan-time work
            ctx = EvalContext(ColumnBatch([], [], None, 1))
            dt = e2.data_type(ctx.batch.schema)
            # only plain numeric/boolean folds; dictionary-typed (string),
            # decimal (scaled int), and temporal literals stay symbolic
            if not (dt.is_numeric and not isinstance(dt, T.DecimalType)
                    or isinstance(dt, (T.BooleanType, T.NullType))):
                return e2
            v = e2.eval(ctx)
            data = v.data.reshape(-1)
            valid = None if v.valid is None else v.valid.reshape(-1)
            if valid is not None and not bool(valid[:1].all() if len(valid) else True):
                return Literal(None, dt)
            val = data[0].item() if len(data) else None
            return Literal(val, dt)
        except Exception:
            return e2
    return e2


def constant_folding(node: LogicalPlan) -> LogicalPlan:
    return node.map_expressions(constant_fold_expr)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# file-scan pruning (ColumnPruning + FileSourceStrategy/ParquetFilters role)
# ---------------------------------------------------------------------------

def _expr_refs(exprs) -> set:
    out: set = set()
    for e in exprs:
        if e is not None:
            out |= e.references()
    return out


def prune_file_columns(plan: LogicalPlan) -> LogicalPlan:
    """Top-down required-column propagation; file relations read only the
    columns the plan consumes (``FileSourceStrategy.scala``'s pruned
    schema)."""
    from .window import WindowNode

    def narrowest(fields) -> str:
        def width(f):
            if f.dataType.is_string:
                return 1 << 16
            return np.dtype(f.dataType.np_dtype).itemsize
        return min(fields, key=width).name

    def walk(node: LogicalPlan, required):
        if isinstance(node, FileRelation):
            if required is None:
                return node
            names = node.schema().names
            keep = [n for n in names if n in required]
            if not keep:
                # count(*)-style plans: one narrow column still carries
                # the row count
                keep = [narrowest(node.schema().fields)]
            if len(keep) == len(names):
                return node
            return FileRelation(node.fmt, node.paths, node._schema,
                                node.options, columns=keep,
                                pushed_filters=node.pushed_filters)
        if isinstance(node, Project):
            child = walk(node.child, _expr_refs(node.exprs))
            return Project(node.exprs, child) \
                if child is not node.child else node
        if isinstance(node, Filter):
            req = None if required is None \
                else (required | node.condition.references())
            child = walk(node.child, req)
            return Filter(node.condition, child) \
                if child is not node.child else node
        if isinstance(node, Aggregate):
            req = _expr_refs(node.keys) | _expr_refs(
                c for f, _n in node.aggs for c in f.children)
            child = walk(node.child, req)
            return Aggregate(node.keys, node.aggs, child) \
                if child is not node.child else node
        if isinstance(node, Sort):
            req = None if required is None \
                else (required | _expr_refs(o.child for o in node.orders))
            child = walk(node.child, req)
            return Sort(node.orders, child, node.is_global) \
                if child is not node.child else node
        if isinstance(node, Limit):
            child = walk(node.child, required)
            return Limit(node.n, child) if child is not node.child else node
        if isinstance(node, Distinct):
            child = walk(node.child, required)
            return Distinct(child) if child is not node.child else node
        if isinstance(node, Sample):
            child = walk(node.children[0], required)
            return Sample(node.fraction, node.seed, child) \
                if child is not node.children[0] else node
        if isinstance(node, SubqueryAlias):
            child = walk(node.children[0], required)
            return SubqueryAlias(node.alias, child) \
                if child is not node.children[0] else node
        if isinstance(node, WindowNode):
            # a WindowExpression's references live in sub_expressions()
            wrefs: set = set()
            for we, _n in node.wexprs:
                for sub in we.sub_expressions():
                    wrefs |= sub.references()
            req = None if required is None else (required | wrefs)
            child = walk(node.children[0], req)
            return WindowNode(node.wexprs, child) \
                if child is not node.children[0] else node
        if isinstance(node, Join):
            on_refs = node.on.references() if node.on is not None else set()
            using = set(node.using or [])
            lnames = set(node.left.schema().names)
            rnames = set(node.right.schema().names)
            if required is None:
                lreq = rreq = None
            else:
                lreq = (required & lnames) | (on_refs & lnames) | using
                rreq = (required & rnames) | (on_refs & rnames) | using
            left = walk(node.left, lreq)
            right = walk(node.right, rreq)
            if left is not node.left or right is not node.right:
                return Join(left, right, node.how, node.on, node.using)
            return node
        if isinstance(node, Union):
            if required is None:
                kids = [walk(c, None) for c in node.children]
            else:
                names = node.schema().names
                idx = [i for i, n in enumerate(names) if n in required]
                kids = []
                for c in node.children:
                    cn = c.schema().names
                    kids.append(walk(c, frozenset(cn[i] for i in idx)))
            if any(k is not c for k, c in zip(kids, node.children)):
                return Union(kids)
            return node
        # any other shape: everything below is required
        new_children = tuple(walk(c, None) for c in node.children)
        if any(nk is not c for nk, c in zip(new_children, node.children)):
            import copy
            clone = copy.copy(node)
            clone.children = new_children
            return clone
        return node

    return walk(plan, None)


#: comparison classes the row-group skipper understands, with the flipped
#: operator for ``literal op col`` forms
_PUSH_OPS = {"EQ": "==", "LT": "<", "LE": "<=", "GT": ">", "GE": ">="}
_FLIP = {"==": "==", "<": ">", "<=": ">=", ">": "<", ">=": "<="}


def push_scan_filters(node: LogicalPlan) -> LogicalPlan:
    """A Filter directly over a parquet FileRelation: its ``col op
    literal`` conjuncts on integer and string columns become ADVISORY
    row-group skip predicates (``ParquetFilters.scala`` role).  The exact
    Filter stays in the plan, so pushdown only drops rows that provably
    cannot match."""
    if not (isinstance(node, Filter) and isinstance(node.child, FileRelation)
            and node.child.fmt == "parquet"
            and node.child.pushed_filters is None):
        return node
    rel = node.child
    file_fields = {f.name: f.dataType for f in rel._schema.fields}
    pushed = []
    conjuncts = []
    for c in split_conjuncts(node.condition):
        if isinstance(c, Between):
            # ``col BETWEEN lo AND hi`` is ``col >= lo AND col <= hi``, as
            # Spark's optimizer rewrites it before pushdown (the JAX
            # package pushes no BETWEEN)
            e, lo, hi = c.children
            conjuncts += [GE(e, lo), LE(e, hi)]
        else:
            conjuncts.append(c)
    for c in conjuncts:
        op = _PUSH_OPS.get(type(c).__name__)
        if op is None:
            continue
        l, r = c.children
        if isinstance(l, Col) and isinstance(r, Literal):
            col, lit = l, r
        elif isinstance(r, Col) and isinstance(l, Literal):
            col, lit, op = r, l, _FLIP[op]
        else:
            continue
        dt = file_fields.get(col.name)
        if dt is None or lit.value is None:
            continue
        if dt.is_string and isinstance(lit.value, str):
            pushed.append((col.name, op, str(lit.value)))
        elif dt.is_numeric and not dt.is_fractional \
                and isinstance(lit.value, (int, np.integer)) \
                and not isinstance(lit.value, bool):
            pushed.append((col.name, op, int(lit.value)))
    if not pushed:
        return node
    return Filter(node.condition,
                  FileRelation(rel.fmt, rel.paths, rel._schema, rel.options,
                               columns=rel.columns, pushed_filters=pushed))


class Batch:
    def __init__(self, name: str, rules: List[Callable], once: bool = False):
        self.name = name
        self.rules = rules
        self.once = once


class Optimizer:
    """Fixed-point rule executor (``RuleExecutor.execute``)."""

    def __init__(self, conf=None):
        self.conf = conf
        self.batches = [
            Batch("finish-analysis", [eliminate_subquery_aliases,
                                      constant_folding], once=True),
            Batch("operator-pushdown", [
                combine_filters,
                push_filter_through_project,
                push_filter_through_alias,
                push_filter_through_aggregate,
                push_filter_through_union,
                push_filter_through_join,
                reorder_joins,
                push_filter_into_join,
                prune_filters,
                push_project_through_limit,
                push_project_through_sort,
                prune_project_under_aggregate,
                collapse_projects,
                simplify_complex_ops,
                push_limit,
            ]),
        ]

    def optimize(self, plan: LogicalPlan) -> LogicalPlan:
        # a pass of a rule copies every node: skip the complex-type rule
        # on the plans (most) that hold nothing it rewrites
        skip = () if _has_extractors(plan) else (simplify_complex_ops,)
        for batch in self.batches:
            iterations = 1 if batch.once else MAX_ITERATIONS
            rules = [r for r in batch.rules if r not in skip]
            for _ in range(iterations):
                new_plan = plan
                for rule in rules:
                    new_plan = new_plan.transform_up(rule)
                if _plans_equal(new_plan, plan):
                    plan = new_plan
                    break
                plan = new_plan
        if _has_files(plan):
            # file-scan pruning runs once, after operator pushdown has
            # parked filters directly above their scans
            plan = prune_file_columns(plan)
            plan = plan.transform_up(push_scan_filters)
        return plan


def _has_files(plan: LogicalPlan) -> bool:
    return isinstance(plan, FileRelation) \
        or any(_has_files(c) for c in plan.children)


def _plans_equal(a: LogicalPlan, b: LogicalPlan) -> bool:
    return a.tree_string() == b.tree_string()
