"""Rule-based optimizer.

A copy of ``spark_tpu/sql/optimizer.py`` (the analog of
``catalyst/optimizer/Optimizer.scala``: batches of rewrite rules run to
fixed point by a RuleExecutor) without what the port cannot reach yet:
the rules that read file statistics and the file-column pruning (the
port has no file scans) and the complex-type simplifier (no map/struct
types).  Join reordering estimates cardinality from batch capacities.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..aggregates import AggregateFunction
from ..columnar import ColumnBatch
from ..expressions import (Alias, AnalysisException, And, Col, EvalContext,
                           Expression, Literal)
from .logical import (
    Aggregate, Filter, Join, Limit, LocalRelation, LogicalPlan, Project,
    RangeRelation, Sort, SubqueryAlias, Union,
)

MAX_ITERATIONS = 50


def is_deterministic(e: Expression) -> bool:
    """No nondeterministic expression (rand, monotonically_increasing_id)
    is ported yet, so every expression of this slice is deterministic."""
    return True


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
    if isinstance(node, Join) and node.how in ("inner", "cross") \
            and not node.using:
        if node.on is not None:
            conds.extend(split_conjuncts(node.on))
        _collect_cross_inner(node.left, rels, conds)
        _collect_cross_inner(node.right, rels, conds)
    else:
        rels.append(node)


def rows_estimate(node: LogicalPlan) -> int:
    """Crude cardinality upper bound for join ordering (capacity-based)."""
    if isinstance(node, LocalRelation):
        return node.batch.capacity
    if isinstance(node, RangeRelation):
        return node.num_rows()
    if isinstance(node, Limit):
        return min(node.n, rows_estimate(node.children[0]))
    if isinstance(node, Union):
        return sum(rows_estimate(c) for c in node.children)
    if node.children:
        return max(rows_estimate(c) for c in node.children)
    return 1 << 10


def reorder_joins(node: LogicalPlan) -> LogicalPlan:
    """Reorder a comma-join chain so every join is condition-connected
    (`ReorderJoin` in `optimizer/joins.scala`).  Greedy: start from the
    largest relation (the probe side of every join in the left-deep tree),
    repeatedly attach the connected relation with the smallest estimated
    output; attach every conjunct that closes over the new schema."""
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

    def effective_rows(i: int) -> float:
        return float(rows_estimate(rels[i]))

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
            # |L||R| / ndv(key) with no column statistics: the key NDV is
            # the candidate's row estimate (a PK assumption), leaving |L|
            est_out = cur_rows
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
                push_limit,
            ]),
        ]

    def optimize(self, plan: LogicalPlan) -> LogicalPlan:
        for batch in self.batches:
            iterations = 1 if batch.once else MAX_ITERATIONS
            for _ in range(iterations):
                new_plan = plan
                for rule in batch.rules:
                    new_plan = new_plan.transform_up(rule)
                if _plans_equal(new_plan, plan):
                    plan = new_plan
                    break
                plan = new_plan
        # file-scan pruning (prune_file_columns, push_scan_filters) comes
        # with the scan slice
        return plan


def _plans_equal(a: LogicalPlan, b: LogicalPlan) -> bool:
    return a.tree_string() == b.tree_string()
