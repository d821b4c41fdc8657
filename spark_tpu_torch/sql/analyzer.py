"""Analyzer: resolution and normalization rewrites.

The part of ``spark_tpu/sql/analyzer.py`` (the slim analog of
``catalyst/analysis/Analyzer.scala``) that DataFrame-built plans need.
Columns bind by name directly against child schemas, so "resolution" is
validation plus these structural rewrites:

* ``ResolveAggregates``: `groupBy().agg(expr)` accepts arbitrary expressions
  mixing aggregate functions and scalars (``sum(x) + 1``); they are split
  into a Project over a pure Aggregate.
* ``RewriteDistinctAggregates``: single-column distinct aggregates expand to
  a two-level aggregation.
* ``ResolveRelations``: table names → catalog plans.
* join disambiguation, qualified-name resolution and ORDER BY references.
* UDF resolution, the subquery rewrite (``subquery.py``), star expansion
  and INTERSECT / EXCEPT as semi / anti joins, in the JAX package's order.
* ``ExtractWindowExpressions``: window expressions leave the select list
  for one ``WindowNode`` per window spec (a window over an aggregate reads
  the aggregate's slot).
* grouping sets: ROLLUP / CUBE / GROUPING SETS become a UNION ALL of one
  Aggregate per set, with typed NULLs for the absent keys and
  ``grouping()`` / ``grouping_id()`` as literals per branch.
* explode / posexplode: a Project holding one becomes the ``Explode``
  operator (shared by SQL text and the DataFrame API).
* lambda variables: every higher-order function's variables are renamed
  ``source#k``, k their position in the plan, and bound in its bodies, so
  a plan's names (and its stage key) are the same on every run of a text.
* ``s.field`` on a struct column becomes ``GetField``.
* eager schema validation for early, readable AnalysisException errors.

The sliding-window hook of the JAX package is not ported:
``_check_ported`` raises ``NotImplementedError`` naming the slice that
brings each plan node, and ``not_ported`` builds the parser's
``AnalysisException`` for each function name a later slice brings.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..aggregates import AggregateFunction, Count, CountDistinct, CountStar, Sum
from ..expressions import (Alias, AnalysisException, And, Col, EQ,
                           Expression, GroupingCall, Literal)
from .logical import (Aggregate, Distinct, Except, Explode, FileRelation,
                      Filter, GroupingSets, Intersect, Join, LazyCheckpoint,
                      Limit, LocalRelation, LogicalPlan, Project,
                      RangeRelation, Sample, Sort, SortOrder, SubqueryAlias,
                      Union, UnresolvedRelation)
from .window import WindowExpression, WindowNode, WindowSpec, contains_window

_STREAMING = "the streaming slice"

#: logical nodes of the JAX package whose execution a later slice of the
#: port brings, by class name, and that slice
_NOT_PORTED = {
    "FlatMapGroupsWithState": _STREAMING,
}

_PORTED_NODES = (LocalRelation, RangeRelation, FileRelation,
                 UnresolvedRelation, Project, Filter, Aggregate, Sort, Limit,
                 Join, Distinct, SubqueryAlias, Union, Intersect, Except,
                 WindowNode, GroupingSets, Sample, Explode, LazyCheckpoint)


def _names(names: str, where: str) -> Dict[str, str]:
    return {n: where for n in names.split()}


#: SQL function names the JAX package's parser registers whose expression
#: a later slice of the port brings, and that slice
NOT_PORTED_FUNCTIONS: Dict[str, str] = {
    **_names("window window_end", f"{_STREAMING} (event-time windows)"),
}


def not_ported(construct: str) -> AnalysisException:
    """The error for a function name a later slice brings: it names the
    construct and the slice, and is raised instead of any partial
    result."""
    return AnalysisException(
        f"{construct} is not ported yet: it comes with "
        f"{NOT_PORTED_FUNCTIONS[construct]}")


def _cols(e: Expression):
    if isinstance(e, Col):
        yield e.name
    for c in e.children:
        yield from _cols(c)


def _constructs(plan: LogicalPlan) -> set:
    """Which of a dotted column name ("dotted"), an explode ("explode") and
    a higher-order function ("lambda") the plan's expressions hold."""
    from ..expressions import ExplodeMarker
    found: set = set()

    def walk(e: Expression) -> None:
        if isinstance(e, Col):
            if "." in e.name:
                found.add("dotted")
        elif isinstance(e, ExplodeMarker):
            found.add("explode")
        elif getattr(e, "LAMBDA_VARS", ()):
            found.add("lambda")
        for c in e.children:
            walk(c)

    def visit(node: LogicalPlan) -> None:
        for e in node.expressions():
            walk(e)
        for c in node.children:
            visit(c)

    visit(plan)
    return found


def resolve_lambdas(e: Expression, counter: List[int],
                    env: Optional[Dict[str, Expression]] = None
                    ) -> Expression:
    """``e`` with every higher-order function's lambda variables renamed
    ``source#k`` (k from ``counter``, in the order met) and bound in its
    bodies: names that are deterministic and unique in the plan."""
    from ..expressions import LambdaVar
    env = env or {}
    if isinstance(e, LambdaVar):
        return env.get(e.name, e)
    e = e.map_children(lambda c: resolve_lambdas(c, counter, env))
    fields = getattr(e, "LAMBDA_VARS", ())
    if not fields:
        return e
    import copy
    new = copy.copy(e)
    inner = dict(env)
    for f in fields:
        var = getattr(e, f)
        if var is not None:
            counter[0] += 1
            inner[var.name] = LambdaVar(var.source, uid=counter[0])
            setattr(new, f, inner[var.name])
    for f in e.LAMBDA_BODIES:
        body = getattr(e, f)
        if body is not None:
            setattr(new, f, resolve_lambdas(body, counter, inner))
    return new


def fresh_name(prefix: str, basis: str, index: int) -> str:
    """DETERMINISTIC generated names: derived from the expression text and
    slot position, never a global counter — identical queries produce
    identical plans."""
    return f"__{prefix}_{index}_{basis}"


def split_aggregate_expr(e: Expression, slots: List[Tuple[AggregateFunction, str]],
                         ) -> Expression:
    """Replace AggregateFunction subtrees with Col refs to buffer slots;
    returns the residual scalar expression."""
    if isinstance(e, AggregateFunction):
        for f, n in slots:
            if f is e:
                return Col(n)
        name = fresh_name("agg", repr(e), len(slots))
        slots.append((e, name))
        return Col(name)
    if isinstance(e, WindowExpression):
        # a window over aggregates (SUM(SUM(x)) OVER ...): the window
        # function's ARGUMENTS become aggregate slots like any other
        # post-aggregate expression; the window computes over the
        # aggregated rows.  PARTITION / ORDER reference grouping keys
        f2 = e.func.map_children(lambda c: split_aggregate_expr(c, slots))
        p2 = [split_aggregate_expr(p, slots) for p in e.spec.partition_by]
        o2 = [type(o)(split_aggregate_expr(o.child, slots), o.ascending,
                      o.nulls_first) for o in e.spec.order_by]
        return WindowExpression(
            f2, WindowSpec(p2, o2, e.spec.frame, e.spec.frame_type))
    return e.map_children(lambda c: split_aggregate_expr(c, slots))


def substitute_grouping_keys(e: Expression,
                             keys: Sequence[Expression]) -> Expression:
    """Occurrences of a grouping EXPRESSION above the Aggregate become
    references to its output column (structural match via repr)."""
    for k in keys:
        if not isinstance(k, Col) and repr(e) == repr(k):
            return Col(k.name)
    return e.map_children(lambda c: substitute_grouping_keys(c, keys))


def contains_aggregate(e: Expression) -> bool:
    if isinstance(e, AggregateFunction):
        return True
    return any(contains_aggregate(c) for c in e.children)


def build_aggregate(keys: Sequence[Expression], agg_exprs: Sequence[Expression],
                    child: LogicalPlan) -> LogicalPlan:
    """Construct Aggregate (+ wrapping Project if needed) from user exprs.

    Grouping keys are also available in output; each agg output expression
    may reference keys and aggregate functions arbitrarily.
    """
    slots: List[Tuple[AggregateFunction, str]] = []
    out_exprs: List[Expression] = []
    key_out: List[Expression] = []
    key_names = []
    for k in keys:
        key_out.append(Col(k.name))
        key_names.append(k.name)

    needs_project = False
    for e in agg_exprs:
        name = e.name
        residual = split_aggregate_expr(e, slots)
        residual = substitute_grouping_keys(residual, keys)
        if isinstance(residual, Col) and not isinstance(e, Alias) \
                and residual.name not in key_names:
            # plain aggregate: rename slot to the pretty name
            for i, (f, n) in enumerate(slots):
                if n == residual.name:
                    slots[i] = (f, name)
                    residual = Col(name)
                    break
        out_exprs.append(Alias(residual, name) if not (
            isinstance(residual, Col) and residual.name == name) else residual)
        if not (isinstance(residual, Col)):
            needs_project = True

    agg = Aggregate(list(keys), slots, child)
    if needs_project or any(isinstance(e, Alias) for e in out_exprs):
        return Project(key_out + out_exprs, agg)
    return agg


def rewrite_distinct_aggregates(plan: Aggregate) -> LogicalPlan:
    """Expand single distinct-column aggregates into two-level aggregation."""
    distinct_slots = [(f, n) for f, n in plan.aggs
                      if getattr(f, "is_distinct", False)]
    if not distinct_slots:
        return plan
    regular = [(f, n) for f, n in plan.aggs
               if not getattr(f, "is_distinct", False)]
    from ..aggregates import Max, Min
    mergeable = (Sum, Count, CountStar, Min, Max)
    for f, _n in regular:
        if not isinstance(f, mergeable):
            raise AnalysisException(
                f"mixing DISTINCT aggregates with {f!r} is not supported: "
                "only sum/count/min/max merge through the two-level "
                "expansion (rewrite avg as sum/count)")
    inputs = {repr(f.children[0]) for f, _ in distinct_slots}
    if len(inputs) > 1:
        raise AnalysisException(
            "multiple different DISTINCT columns in one aggregate are not "
            "yet supported")
    dcol = distinct_slots[0][0].children[0]
    dname = fresh_name("distinct", repr(dcol), 0)
    # level 1: group by keys + distinct column (dedup); regular aggregates
    # evaluate per fine group and MERGE at level 2
    inner_keys = list(plan.keys) + [Alias(dcol, dname)]
    inner = Aggregate(inner_keys, list(regular), plan.child)
    # level 2: group by keys, aggregate the deduped column
    outer_slots = []
    for f, n in distinct_slots:
        base = Count if isinstance(f, CountDistinct) else Sum
        outer_slots.append((base(Col(dname)), n))
    for f, n in regular:
        merge = Sum if isinstance(f, (Sum, Count, CountStar)) \
            else (Min if isinstance(f, Min) else Max)
        outer_slots.append((merge(Col(n)), n))
    outer_keys = [Col(k.name) for k in plan.keys]
    return Aggregate(outer_keys, outer_slots, inner)


class _JoinSideRename(Project):
    """Marker Project inserted by join disambiguation: renames overlapping
    columns to their qualified names while passing other qualifiers through."""


def qualifier_map(plan: LogicalPlan) -> Dict[str, str]:
    """``alias.column`` → ``column`` visible from a plan subtree.

    A SubqueryAlias qualifies its output; schema-preserving nodes pass
    qualifiers through; Join unions both sides; Project/Aggregate reset the
    scope.
    """
    if isinstance(plan, _JoinSideRename):
        inner = qualifier_map(plan.children[0])
        visible = set(plan.schema().names)
        return {q: n for q, n in inner.items() if n in visible}
    if isinstance(plan, SubqueryAlias):
        return {f"{plan.alias}.{n}": n for n in plan.schema().names}
    if isinstance(plan, (Filter, Sort, Limit, Distinct)):
        return qualifier_map(plan.children[0])
    if isinstance(plan, Join):
        left = qualifier_map(plan.children[0])
        right = qualifier_map(plan.children[1])
        merged = dict(left)
        merged.update(right)
        return merged
    return {}


class Analyzer:
    def __init__(self, catalog=None):
        self.catalog = catalog

    def analyze(self, plan: LogicalPlan) -> LogicalPlan:
        plan = self._resolve_relations(plan)
        self._check_ported(plan)
        plan = plan.transform_up(self._resolve_functions)
        from .subquery import rewrite_subqueries

        def resolve_sub(p: LogicalPlan) -> LogicalPlan:
            # nested subquery plans need relation AND function resolution
            # (they are invisible to the outer transform_up passes)
            p = self._resolve_relations(p)
            self._check_ported(p)
            return p.transform_up(self._resolve_functions)

        plan = rewrite_subqueries(plan, resolve_sub)
        plan = plan.transform_up(self._disambiguate_joins)
        plan = plan.transform_up(self._expand_stars)
        plan = plan.transform_up(self._resolve_qualified)
        # the complex-type passes run only on plans that hold what they
        # rewrite: a pass copies every node, and most plans hold none
        found = _constructs(plan)
        if "dotted" in found:
            plan = plan.transform_up(self._resolve_struct_fields)
        # set-op replacement needs fully-resolved sides (stars expanded,
        # qualified refs bound) to build the all-column join condition
        plan = plan.transform_up(self._replace_set_ops)
        plan = plan.transform_up(self._rewrite_node)
        if "explode" in found:
            plan = plan.transform_up(self._rewrite_explode)
        plan = plan.transform_up(self._rewrite_grouping_sets)
        # the sliding-window rewrite: the streaming slice
        if "lambda" in found:
            counter = [0]
            plan = plan.transform_up(
                lambda n: n.map_expressions(
                    lambda e: resolve_lambdas(e, counter)))
        self._validate(plan)
        return plan

    @staticmethod
    def _rewrite_explode(node: LogicalPlan) -> LogicalPlan:
        """A Project holding explode()/posexplode() → the Explode operator
        (shared by SQL text and the DataFrame API)."""
        from ..expressions import ExplodeMarker
        if not isinstance(node, Project):
            return node

        def marker(e):
            base = e.children[0] if isinstance(e, Alias) else e
            return base if isinstance(base, ExplodeMarker) else None

        markers = [e for e in node.exprs if marker(e) is not None]
        if not markers:
            return node
        if len(markers) != 1:
            raise AnalysisException(
                "only one explode() per select is supported")
        m = markers[0]
        mk = marker(m)
        out_name = m.name if isinstance(m, Alias) else "col"
        pre = [e for e in node.exprs if marker(e) is None]
        # the select-list position (by identity: == builds an EQ node)
        insert_at = next(i for i, e in enumerate(node.exprs) if e is m)
        return Explode(pre, mk.children[0], out_name, mk.with_pos, "pos",
                       node.children[0], insert_at=insert_at)

    @staticmethod
    def _rewrite_grouping_sets(node: LogicalPlan) -> LogicalPlan:
        """GroupingSets → UNION ALL of one Aggregate per grouping set:
        absent keys project as typed NULLs, grouping()/grouping_id() calls
        become per-branch literals (the reference's Expand, unrolled)."""
        if not isinstance(node, GroupingSets):
            return node
        child_schema = node.children[0].schema()
        key_reprs = [repr(k) for k in node.keys]
        key_dts = [k.data_type(child_schema) for k in node.keys]
        want = [e.name for e in node.select_list]
        branches = []
        for s_idx in node.sets:
            present = set(s_idx)
            # grouping_id bitmask: bit i set when key i is aggregated away
            gid = 0
            for i in range(len(node.keys)):
                if i not in present:
                    gid |= 1 << (len(node.keys) - 1 - i)

            def subst(e: Expression) -> Expression:
                if isinstance(e, GroupingCall):
                    if not e.children:
                        return Literal(gid)
                    r = repr(e.children[0])
                    if r not in key_reprs:
                        raise AnalysisException(
                            f"grouping() argument {e.children[0]!r} is not "
                            "a grouping key")
                    return Literal(0 if key_reprs.index(r) in present else 1)
                if isinstance(e, AggregateFunction):
                    # aggregate ARGUMENTS see the child's rows: only the
                    # grouping OUTPUT columns become NULL
                    return e
                r = repr(e)
                if r in key_reprs and key_reprs.index(r) not in present:
                    return Literal(None, key_dts[key_reprs.index(r)])
                return e.map_children(subst)

            sel = []
            for e in node.select_list:
                if isinstance(e, Alias):
                    sel.append(Alias(subst(e.children[0]), e.name))
                else:
                    ne = subst(e)
                    sel.append(ne if ne.name == e.name else Alias(ne, e.name))
            keys_subset = [node.keys[i] for i in s_idx]
            branch = build_aggregate(keys_subset, sel, node.children[0])
            # the aggregate also outputs its keys; keep ONLY the select list
            if branch.schema().names != want:
                branch = Project([Col(n) for n in want], branch)
            if node.having is not None:
                hv = subst(node.having)
                slots: List[Tuple[AggregateFunction, str]] = []
                resid = split_aggregate_expr(hv, slots)
                if slots:
                    # HAVING with aggregates: aggregate again per branch
                    # with the extra slots, filter, project the select list
                    sel_h = sel + [Alias(f, n) for f, n in slots]
                    b2 = build_aggregate(keys_subset, sel_h, node.children[0])
                    branch = Project([Col(n) for n in want],
                                     Filter(resid, b2))
                else:
                    branch = Filter(hv, branch)
            branches.append(branch)
        return branches[0] if len(branches) == 1 else Union(branches)

    @staticmethod
    def _check_ported(plan: LogicalPlan) -> None:
        """Refuse plan nodes whose operators a later slice brings."""
        if not isinstance(plan, _PORTED_NODES):
            name = type(plan).__name__
            raise NotImplementedError(
                f"{name} is not ported yet: it comes with "
                f"{_NOT_PORTED.get(name, 'a later slice')}")
        for c in plan.children:
            Analyzer._check_ported(c)

    def _expand_stars(self, node: LogicalPlan) -> LogicalPlan:
        """Expand `*` / `tbl.*` left by the parser over unresolved relations
        (ResolveStar analog; runs after catalog resolution)."""
        from .parser import _Star
        if not isinstance(node, Project) \
                or not any(isinstance(e, _Star) for e in node.exprs):
            return node
        child = node.children[0]
        names = child.schema().names
        new: List[Expression] = []
        for e in node.exprs:
            if not isinstance(e, _Star):
                new.append(e)
            elif e.qualifier is None:
                new += [Col(n) for n in names]
            else:
                qmap = qualifier_map(child)
                pref = e.qualifier + "."
                # preserve child column order; a column belongs to the
                # qualifier if its (possibly join-renamed) name carries the
                # prefix literally, or a qualified alias maps to it
                qualified_plain = {v for k, v in qmap.items()
                                   if k.startswith(pref)}
                hits = [n for n in names
                        if n.startswith(pref) or n in qualified_plain]
                if not hits:
                    raise AnalysisException(
                        f"cannot resolve {e.qualifier}.* among ({', '.join(names)})")
                new += [Col(n) for n in hits]
        return Project(new, child)

    def _disambiguate_joins(self, node: LogicalPlan) -> LogicalPlan:
        """When both join sides expose a same-named column, rename each side's
        copy to its qualified name (``t.k`` / ``d.k``) so references bind
        unambiguously — the by-name analog of Catalyst exprId identity."""
        if not isinstance(node, Join) or node.using:
            return node
        try:
            ls = node.children[0].schema()
            rs = node.children[1].schema()
        except AnalysisException:
            return node
        overlap = set(ls.names) & set(rs.names)
        if not overlap:
            return node

        def rename(child, schema):
            rev: Dict[str, str] = {}
            for q, plain in qualifier_map(child).items():
                rev.setdefault(plain, q)
            exprs: List[Expression] = []
            changed = False
            for n in schema.names:
                if n in overlap and n in rev:
                    exprs.append(Alias(Col(n), rev[n]))
                    changed = True
                else:
                    exprs.append(Col(n))
            return _JoinSideRename(exprs, child) if changed else child

        left = rename(node.children[0], ls)
        right = rename(node.children[1], rs)
        if left is node.children[0] and right is node.children[1]:
            return node
        return Join(left, right, node.how, node.on, node.using)

    def _resolve_qualified(self, node: LogicalPlan) -> LogicalPlan:
        if not node.children or not node.expressions():
            return node
        qmap: Dict[str, str] = {}
        for c in node.children:
            try:
                qmap.update(qualifier_map(c))
            except AnalysisException:
                return node
        try:
            plain = {n for c in node.children for n in c.schema().names}
        except AnalysisException:
            return node
        if not qmap:
            return node

        def rewrite(e: Expression) -> Expression:
            if isinstance(e, Col) and e.name not in plain and e.name in qmap:
                return Col(qmap[e.name])
            if isinstance(e, AggregateFunction) or e.children:
                return e.map_children(rewrite)
            return e

        return node.map_expressions(rewrite)

    @staticmethod
    def _resolve_struct_fields(node: LogicalPlan) -> LogicalPlan:
        """``s.field`` where ``s`` is a struct column (and ``s.field`` no
        column of its own) → ``GetField(s, field)``, nested fields left to
        right."""
        from .. import types as T
        from ..expressions import GetField
        if len(node.children) != 1 or not any(
                "." in c for e in node.expressions() for c in _cols(e)):
            return node
        try:
            schema = node.children[0].schema()
        except AnalysisException:
            return node
        names = set(schema.names)

        def rewrite(e: Expression) -> Expression:
            if isinstance(e, Col) and e.name not in names and "." in e.name:
                head, *fields = e.name.split(".")
                if head in names and isinstance(schema[head].dataType,
                                                T.StructType):
                    out: Expression = Col(head)
                    for f in fields:
                        out = GetField(out, f)
                    return out
            if isinstance(e, AggregateFunction) or e.children:
                return e.map_children(rewrite)
            return e

        return node.map_expressions(rewrite)

    def _resolve_relations(self, plan: LogicalPlan, _depth: int = 0) -> LogicalPlan:
        if _depth > 32:
            raise AnalysisException("cyclic or too deeply nested view definitions")

        def fn(node: LogicalPlan) -> LogicalPlan:
            if isinstance(node, UnresolvedRelation):
                if self.catalog is None:
                    raise AnalysisException(f"table not found: {node.name}")
                resolved = self._resolve_relations(
                    self.catalog.lookup(node.name), _depth + 1)
                return SubqueryAlias(node.name, resolved)
            return node
        return plan.transform_up(fn)

    def _resolve_functions(self, node: LogicalPlan) -> LogicalPlan:
        """UnresolvedFunction -> registered UDF (FunctionRegistry lookup)."""
        from .udf import PythonUDF, UnresolvedFunction
        if not node.expressions():
            return node

        def fe(e: Expression) -> Expression:
            if isinstance(e, WindowExpression):
                # the window function lives in .func, not .children
                return e.map_parts(fe)
            e = e.map_children(fe)
            if isinstance(e, UnresolvedFunction):
                wrapper = None
                if self.catalog is not None \
                        and hasattr(self.catalog, "lookup_function"):
                    wrapper = self.catalog.lookup_function(e.fn_name)
                if wrapper is None:
                    raise AnalysisException(
                        f"undefined function: {e.fn_name}")
                # the registration's uid: every analysis of the same text
                # gives the same plan (and the same stage-cache key)
                return PythonUDF(e.fn_name, wrapper.fn, wrapper.returnType,
                                 list(e.children),
                                 getattr(wrapper, "_vectorized", False),
                                 getattr(wrapper, "uid", None))
            return e

        return node.map_expressions(fe)

    def _replace_set_ops(self, node: LogicalPlan) -> LogicalPlan:
        """INTERSECT -> Distinct(semi join); EXCEPT -> Distinct(anti join)
        (`ReplaceIntersectWithSemiJoin` / `ReplaceExceptWithAntiJoin`).
        The right side's columns are renamed fresh so the all-column
        equality condition binds unambiguously."""
        if not isinstance(node, (Intersect, Except)):
            return node
        left, right = node.children
        ls, rs = left.schema(), right.schema()
        if len(ls.names) != len(rs.names):
            raise AnalysisException(
                f"{node!r} requires same-arity sides: "
                f"{len(ls.names)} vs {len(rs.names)}")
        renamed = [f"__setop_{i}_{n}" for i, n in enumerate(rs.names)]
        rproj = Project([Alias(Col(n), rn)
                         for n, rn in zip(rs.names, renamed)], right)
        cond = None
        for ln, rn in zip(ls.names, renamed):
            eq = EQ(Col(ln), Col(rn))
            cond = eq if cond is None else And(cond, eq)
        how = "left_semi" if isinstance(node, Intersect) else "left_anti"
        return Distinct(Join(left, rproj, how, cond, None))

    def _rewrite_node(self, node: LogicalPlan) -> LogicalPlan:
        if isinstance(node, Aggregate):
            return rewrite_distinct_aggregates(node)
        if isinstance(node, Sort):
            return self._resolve_sort_references(node)
        if isinstance(node, Project):
            return self._extract_window_expressions(node)
        return node

    @staticmethod
    def _extract_window_expressions(node: Project) -> LogicalPlan:
        """ExtractWindowExpressions: pull `f(...) OVER spec` out of the
        select list into WindowNode operators (one per distinct spec),
        leaving Col references behind."""
        if not any(contains_window(e) for e in node.exprs):
            return node
        found: List[Tuple[WindowExpression, str]] = []

        def repl(e: Expression) -> Expression:
            if isinstance(e, WindowExpression):
                for we, n in found:
                    if repr(we) == repr(e):
                        return Col(n)
                name = fresh_name("win", repr(e), len(found))
                found.append((e, name))
                return Col(name)
            return e.map_children(repl)

        new_exprs = []
        for e in node.exprs:
            r = repl(e)
            # a bare window expression keeps its pretty name
            if isinstance(r, Col) and not isinstance(e, Alias):
                r = Alias(r, e.name) if r.name != e.name else r
            new_exprs.append(r)

        child = node.children[0]
        by_spec: Dict[Any, List[Tuple[WindowExpression, str]]] = {}
        for we, n in found:
            by_spec.setdefault(we.spec._key(), []).append((we, n))
        for group in by_spec.values():
            child = WindowNode(group, child)
        return type(node)(new_exprs, child)

    def _resolve_sort_references(self, node: Sort) -> LogicalPlan:
        """ORDER BY may reference input columns dropped by the SELECT list
        (Spark's ResolveSortReferences): push the Sort below the Project,
        substituting select-list aliases with their defining expressions."""
        child = node.children[0]
        if not isinstance(child, Project):
            return node
        proj = child
        out_names = set(proj.schema().names)
        refs = set()
        for o in node.orders:
            refs |= o.child.references()
        missing = refs - out_names
        if not missing:
            return node
        try:
            input_names = set(proj.children[0].schema().names)
        except AnalysisException:
            return node
        qmap = qualifier_map(proj.children[0])
        if not all(m in input_names or m in qmap for m in missing):
            return node  # genuinely unresolvable; validation will report
        amap: Dict[str, Expression] = {}
        for e in proj.exprs:
            if isinstance(e, Alias):
                amap[e.name] = e.children[0]

        def subst(e: Expression) -> Expression:
            if isinstance(e, Col):
                if e.name in amap:
                    return amap[e.name]
                if e.name not in input_names and e.name in qmap:
                    return Col(qmap[e.name])
            return e.map_children(subst)

        new_orders = [SortOrder(subst(o.child), o.ascending, o.nulls_first)
                      for o in node.orders]
        return Project(proj.exprs, Sort(new_orders, proj.children[0],
                                        node.is_global))

    def _validate(self, plan: LogicalPlan) -> None:
        # forces schema computation everywhere → surfacing unresolved
        # columns / type errors with plan context
        for c in plan.children:
            self._validate(c)
        try:
            plan.schema()
        except AnalysisException:
            raise
        except KeyError as e:
            raise AnalysisException(f"cannot resolve column {e} in {plan!r}")
