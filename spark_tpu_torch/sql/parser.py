"""SQL text → logical plan (a port of ``spark_tpu/sql/parser.py``).

The analog of the reference's ANTLR pipeline
(`sql/catalyst/src/main/antlr4/.../parser/SqlBase.g4` +
`parser/AstBuilder.scala` + `ParseDriver.scala`): a hand-written lexer +
recursive-descent/Pratt parser over the grammar subset a query engine
exercises:

* ``querySpecification``: SELECT [DISTINCT] list FROM relations [joins]
  [WHERE] [GROUP BY [exprs|ordinals]] [HAVING] [ORDER BY] [LIMIT]
* set operations: UNION [ALL | DISTINCT], INTERSECT, EXCEPT / MINUS
* WITH common table expressions
* relations: table names, aliased subqueries, JOIN ... ON/USING chains
* expressions: precedence-climbing over OR/AND/NOT/comparison/additive/
  multiplicative/unary, IS [NOT] NULL, [NOT] IN, [NOT] LIKE/RLIKE,
  BETWEEN, CASE WHEN, CAST(e AS type), function calls (incl. DISTINCT
  aggregates), scalar / IN / EXISTS subqueries, qualified names, ``*``,
  literals.
* statements: CREATE [OR REPLACE] TEMP VIEW, DROP VIEW/TABLE, SHOW TABLES,
  DESCRIBE, EXPLAIN, SET, and the persistent-catalog commands (CREATE
  TABLE, INSERT, databases, ANALYZE TABLE), which parse here and are
  refused by the session.

The grammar is the JAX package's, token for token.  The function tables
register only the expressions this package has; a name whose expression
a later slice brings (``analyzer.NOT_PORTED_FUNCTIONS``), an ``OVER``
clause, a lambda, ``||`` and ROLLUP / CUBE / GROUPING SETS raise
``AnalysisException`` naming the construct and that slice.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Sequence, Tuple

from .. import aggregates as A
from .. import types as T
from ..expressions import (Add, Alias, AnalysisException, And, Between,
                           CaseWhen, Cast, Coalesce, Col, Div, EQ, Expression,
                           GE, GT, Hash64, If, In, IsNotNull, IsNull, LE, LT,
                           Literal, Mod, Mul, NE, Neg, Not, Or, StringPredicate,
                           Sub)
from .analyzer import NOT_PORTED_FUNCTIONS, not_ported
from .logical import (
    Aggregate, Distinct, Except, Filter, Intersect, Join, Limit, LogicalPlan,
    Project, RangeRelation, Sort, SortOrder, SubqueryAlias, Union,
    UnresolvedRelation,
)

__all__ = [
    "parse_expression", "parse_query", "parse_statement", "ParseException",
    "Command", "CreateViewCommand", "DropViewCommand", "ShowTablesCommand",
    "DescribeCommand", "SetCommand", "ExplainCommand",
]


class ParseException(AnalysisException):
    pass


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<number>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?[lLdD]?)
  | (?P<string>'(?:[^'\\]|\\.|'')*'|"(?:[^"\\]|\\.)*")
  | (?P<bq>`[^`]*`)
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><=>|<>|!=|<=|>=|==|->|\|\||[=<>+\-*/%(),.])
""", re.VERBOSE)

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "SORT",
    "LIMIT", "AS", "AND", "OR", "NOT", "NULL", "TRUE", "FALSE", "IS", "IN",
    "LIKE", "RLIKE", "BETWEEN", "CASE", "WHEN", "THEN", "ELSE", "END",
    "CAST", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS",
    "SEMI", "ANTI", "ON", "USING", "UNION", "ALL", "DISTINCT", "ASC",
    "DESC", "NULLS", "FIRST", "LAST", "WITH", "CREATE", "OR", "REPLACE",
    "TEMP", "TEMPORARY", "VIEW", "TABLE", "DROP", "IF", "EXISTS", "SHOW",
    "TABLES", "DESCRIBE", "DESC", "EXPLAIN", "SET", "VALUES", "INTERVAL",
    "INTERSECT", "EXCEPT", "MINUS", "DATABASE", "DATABASES", "USE",
    "INSERT", "INTO", "OVERWRITE",
}


class Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind: str, value: str, pos: int):
        self.kind = kind      # KW, IDENT, NUMBER, STRING, OP, EOF
        self.value = value
        self.pos = pos

    def __repr__(self):  # pragma: no cover
        return f"{self.kind}:{self.value}"


def tokenize(text: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(text)
    while i < n:
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise ParseException(f"unexpected character {text[i]!r} at {i}")
        i = m.end()
        if m.lastgroup == "ws":
            continue
        v = m.group()
        if m.lastgroup == "ident":
            up = v.upper()
            if up in KEYWORDS:
                out.append(Token("KW", up, m.start()))
            else:
                out.append(Token("IDENT", v, m.start()))
        elif m.lastgroup == "bq":
            out.append(Token("IDENT", v[1:-1], m.start()))
        elif m.lastgroup == "number":
            out.append(Token("NUMBER", v, m.start()))
        elif m.lastgroup == "string":
            out.append(Token("STRING", v, m.start()))
        else:
            out.append(Token("OP", v, m.start()))
    out.append(Token("EOF", "", n))
    return out


def _unquote(raw: str) -> str:
    q = raw[0]
    body = raw[1:-1]
    if q == "'":
        body = body.replace("''", "'")
    return bytes(body, "utf-8").decode("unicode_escape") if "\\" in body else body


# ---------------------------------------------------------------------------
# Function registry (FunctionRegistry.scala analog): the ported expressions
# ---------------------------------------------------------------------------

def _one(args, name):
    if len(args) != 1:
        raise ParseException(f"{name} expects 1 argument, got {len(args)}")
    return args[0]


def _nullif(args):
    if len(args) != 2:
        raise ParseException("nullif expects 2 arguments")
    a, b = args
    return If(EQ(a, b), Literal(None), a)


def _nvl2(args):
    if len(args) != 3:
        raise ParseException("nvl2 expects 3 arguments")
    return If(IsNotNull(args[0]), args[1], args[2])


def _if_fn(args):
    if len(args) != 3:
        raise ParseException("if expects 3 arguments")
    return If(*args)


def _count(args, distinct):
    if len(args) != 1:
        raise ParseException("count expects 1 argument")
    e = args[0]
    if distinct:
        return A.CountDistinct(e)
    # count(non-null literal) ≡ count(*); count(NULL) must stay 0
    if isinstance(e, _Star) or (isinstance(e, Literal) and e.value is not None):
        return A.CountStar()
    return A.Count(e)


SCALAR_FUNCTIONS = {
    "coalesce": lambda a: Coalesce(*a),
    "nvl": lambda a: Coalesce(*a),
    "ifnull": lambda a: Coalesce(*a),
    "nullif": _nullif, "nvl2": _nvl2, "if": _if_fn,
    "isnull": lambda a: IsNull(_one(a, "isnull")),
    "isnotnull": lambda a: IsNotNull(_one(a, "isnotnull")),
    "pmod": lambda a: Mod(Add(Mod(a[0], a[1]), a[1]), a[1]),
    "hash": lambda a: Hash64(*a),
    "xxhash64": lambda a: Hash64(*a),
    "to_date": lambda a: Cast(_one(a, "to_date"), T.date),
    "to_timestamp": lambda a: Cast(_one(a, "to_timestamp"), T.timestamp),
    "double": lambda a: Cast(_one(a, "double"), T.float64),
    "float": lambda a: Cast(_one(a, "float"), T.float32),
    "int": lambda a: Cast(_one(a, "int"), T.int32),
    "bigint": lambda a: Cast(_one(a, "bigint"), T.int64),
    "string": lambda a: Cast(_one(a, "string"), T.string),
    "boolean": lambda a: Cast(_one(a, "boolean"), T.boolean),
}

AGG_FUNCTIONS = {
    "sum": lambda e: A.Sum(e),
    "avg": lambda e: A.Avg(e),
    "mean": lambda e: A.Avg(e),
    "min": lambda e: A.Min(e),
    "max": lambda e: A.Max(e),
    "first": lambda e: A.First(e),
    "first_value": lambda e: A.First(e),
    "last": lambda e: A.Last(e),
    "last_value": lambda e: A.Last(e),
}


class _Star(Expression):
    """`*` or `tbl.*` in a select list (UnresolvedStar)."""

    def __init__(self, qualifier: Optional[str] = None):
        self.qualifier = qualifier
        self.children = ()

    @property
    def name(self) -> str:
        return repr(self)

    def data_type(self, schema):
        raise AnalysisException("star must be expanded by the analyzer")

    def __repr__(self):
        return f"{self.qualifier + '.' if self.qualifier else ''}*"


# ---------------------------------------------------------------------------
# Commands (the RunnableCommand analog)
# ---------------------------------------------------------------------------

class Command:
    pass


class CreateViewCommand(Command):
    def __init__(self, name: str, query: LogicalPlan, replace: bool):
        self.name, self.query, self.replace = name, query, replace


class DropViewCommand(Command):
    def __init__(self, name: str, if_exists: bool, kind: str):
        self.name, self.if_exists, self.kind = name, if_exists, kind


class ShowTablesCommand(Command):
    pass


class DescribeCommand(Command):
    def __init__(self, name: str, extended: bool = False):
        self.name, self.extended = name, extended


class SetCommand(Command):
    def __init__(self, key: Optional[str], value: Optional[str]):
        self.key, self.value = key, value


class AnalyzeTableCommand(Command):
    """ANALYZE TABLE t COMPUTE STATISTICS [FOR {ALL COLUMNS|COLUMNS a,b}].
    ``columns``: None = row count only; [] = every column; else names."""

    def __init__(self, name: str, columns):
        self.name, self.columns = name, columns


class CreateDatabaseCommand(Command):
    def __init__(self, name: str, if_not_exists: bool):
        self.name, self.if_not_exists = name, if_not_exists


class DropDatabaseCommand(Command):
    def __init__(self, name: str, if_exists: bool):
        self.name, self.if_exists = name, if_exists


class UseDatabaseCommand(Command):
    def __init__(self, name: str):
        self.name = name


class ShowDatabasesCommand(Command):
    pass


class CreateTableCommand(Command):
    def __init__(self, name: str, fmt: str, query, columns,
                 if_not_exists: bool):
        self.name, self.fmt = name, fmt
        self.query = query          # CTAS body or None
        self.columns = columns      # [(name, typename)] or None
        self.if_not_exists = if_not_exists
        self.replace = False


class DropTableCommand(Command):
    def __init__(self, name: str, if_exists: bool):
        self.name, self.if_exists = name, if_exists


class InsertIntoCommand(Command):
    def __init__(self, name: str, query, overwrite: bool):
        self.name, self.query, self.overwrite = name, query, overwrite


class ExplainCommand(Command):
    def __init__(self, query: LogicalPlan, extended: bool):
        self.query, self.extended = query, extended


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

class Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = tokenize(text)
        self.i = 0

    # -- token plumbing ---------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "EOF":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "KW" and t.value in kws

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            t = self.peek()
            raise ParseException(
                f"expected {kw} at position {t.pos}, found {t.value!r} "
                f"in: {self.text}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.value in ops

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            t = self.peek()
            raise ParseException(
                f"expected {op!r} at position {t.pos}, found {t.value!r}")

    def ident(self) -> str:
        t = self.peek()
        # allow non-reserved keywords as identifiers in name position
        if t.kind in ("IDENT",) or (t.kind == "KW" and t.value in (
                "FIRST", "LAST", "VALUES", "TABLES", "SHOW", "LEFT", "RIGHT")):
            self.next()
            return t.value if t.kind == "IDENT" else t.value.lower()
        raise ParseException(
            f"expected identifier at position {t.pos}, found {t.value!r}")

    # -- statements -------------------------------------------------------
    def _at_word(self, word: str) -> bool:
        """Case-insensitive match of a NON-RESERVED statement word (kept
        out of the keyword set so user identifiers never break)."""
        t = self.peek()
        return t.kind == "IDENT" and t.value.upper() == word

    def _expect_word(self, word: str) -> None:
        if not self._at_word(word):
            t = self.peek()
            raise ParseException(
                f"expected {word} at position {t.pos}, found {t.value!r}")
        self.next()

    def parse_statement(self):
        if self._at_word("ANALYZE"):
            self.next()
            self.expect_kw("TABLE")
            name = self.ident()
            self._expect_word("COMPUTE")
            self._expect_word("STATISTICS")
            columns = None
            if self._at_word("FOR"):
                self.next()
                if self.accept_kw("ALL"):
                    self._expect_word("COLUMNS")
                    columns = []
                else:
                    self._expect_word("COLUMNS")
                    columns = [self.ident()]
                    while self.accept_op(","):
                        columns.append(self.ident())
            return AnalyzeTableCommand(name, columns)
        if self.at_kw("CREATE"):
            return self._create()
        if self.at_kw("DROP"):
            return self._drop()
        if self.at_kw("USE"):
            self.next()
            return UseDatabaseCommand(self.ident())
        if self.at_kw("INSERT"):
            return self._insert()
        if self.at_kw("SHOW"):
            self.next()
            if self.accept_kw("DATABASES"):
                return ShowDatabasesCommand()
            self.expect_kw("TABLES")
            return ShowTablesCommand()
        if self.at_kw("DESCRIBE"):
            self.next()
            # DESCRIBE [TABLE] [EXTENDED] name, and DESCRIBE EXTENDED name
            extended = self._at_word("EXTENDED")
            if extended:
                self.next()
            self.accept_kw("TABLE")
            if not extended and self._at_word("EXTENDED"):
                self.next()
                extended = True
            return DescribeCommand(self.ident(), extended)
        if self.at_kw("EXPLAIN"):
            self.next()
            extended = False
            t = self.peek()
            if t.kind == "IDENT" and t.value.upper() == "EXTENDED":
                self.next()
                extended = True
            cmd = ExplainCommand(self.parse_query(), extended)
            self._expect_eof()
            return cmd
        plan = self.parse_query()
        self._expect_eof()
        return plan

    def _expect_eof(self):
        t = self.peek()
        if t.kind != "EOF":
            raise ParseException(
                f"unexpected trailing input at position {t.pos}: {t.value!r}")

    def _create(self):
        self.expect_kw("CREATE")
        replace = False
        if self.accept_kw("OR"):
            self.expect_kw("REPLACE")
            replace = True
        if self.accept_kw("DATABASE"):
            if replace:
                raise ParseException(
                    "OR REPLACE is not supported for CREATE DATABASE")
            ine = self._if_not_exists()
            cmd = CreateDatabaseCommand(self.ident(), ine)
            self._expect_eof()
            return cmd
        if self.accept_kw("TABLE"):
            return self._create_table(replace)
        if not (self.accept_kw("TEMP") or self.accept_kw("TEMPORARY")):
            raise ParseException(
                "expected TEMP VIEW, TABLE, or DATABASE after CREATE")
        self.expect_kw("VIEW")
        name = self.ident()
        self.expect_kw("AS")
        query = self.parse_query()
        self._expect_eof()
        return CreateViewCommand(name, query, replace)

    def _if_not_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def _qualified_name(self) -> str:
        name = self.ident()
        while self.accept_op("."):
            name += "." + self.ident()
        return name

    def _create_table(self, replace: bool = False):
        # CREATE [OR REPLACE] TABLE [IF NOT EXISTS] name [(col type, ...)]
        #   [USING fmt] [AS query]
        ine = self._if_not_exists()
        name = self._qualified_name()
        columns = None
        if self.at_op("("):
            self.next()
            columns = []
            while True:
                cname = self.ident()
                tname = self.ident()
                if self.at_op("("):     # decimal(p,s)
                    self.next()
                    args = [self.next().value]
                    while self.accept_op(","):
                        args.append(self.next().value)
                    self.expect_op(")")
                    tname = f"{tname}({','.join(args)})"
                columns.append((cname, tname))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        fmt = "parquet"
        if self.accept_kw("USING"):
            fmt = self.ident()
        query = None
        if self.accept_kw("AS"):
            query = self.parse_query()
        self._expect_eof()
        if query is None and columns is None:
            raise ParseException(
                "CREATE TABLE needs a column list or AS <query>")
        cmd = CreateTableCommand(name, fmt, query, columns, ine)
        cmd.replace = replace
        return cmd

    def _insert(self):
        self.expect_kw("INSERT")
        overwrite = False
        if self.accept_kw("OVERWRITE"):
            overwrite = True
            self.accept_kw("TABLE")
        else:
            self.expect_kw("INTO")
            self.accept_kw("TABLE")
        name = self._qualified_name()
        query = self.parse_query()
        self._expect_eof()
        return InsertIntoCommand(name, query, overwrite)

    def _drop(self):
        self.expect_kw("DROP")
        if self.accept_kw("DATABASE"):
            if_exists = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            cmd = DropDatabaseCommand(self.ident(), if_exists)
            self._expect_eof()
            return cmd
        kind = "view" if self.accept_kw("VIEW") else "table"
        if kind == "table":
            self.expect_kw("TABLE")
        if_exists = False
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            if_exists = True
        name = self._qualified_name()
        self._expect_eof()
        if kind == "table":
            return DropTableCommand(name, if_exists)
        return DropViewCommand(name, if_exists, kind)

    # -- queries ----------------------------------------------------------
    def parse_query(self) -> LogicalPlan:
        ctes = {}
        from .subquery import SubqueryExpr

        def subst_plan(p: LogicalPlan) -> LogicalPlan:
            return p.transform_up(subst).transform_up(subst_exprs)

        def subst(node: LogicalPlan) -> LogicalPlan:
            if isinstance(node, UnresolvedRelation) and node.name.lower() in ctes:
                return ctes[node.name.lower()]
            return node

        def subst_exprs(node: LogicalPlan) -> LogicalPlan:
            # CTE references inside subquery EXPRESSIONS (scalar/IN/
            # EXISTS) are invisible to plan-level transform_up
            if not node.expressions():
                return node

            def fe(e):
                if isinstance(e, SubqueryExpr):
                    return e.with_plan(subst_plan(e.plan))
                return e.map_children(fe)
            return node.map_expressions(fe)

        if self.accept_kw("WITH"):
            while True:
                name = self.ident()
                self.expect_kw("AS")
                self.expect_op("(")
                sub = self.parse_query()
                self.expect_op(")")
                # chained CTEs: earlier CTEs are in scope for later bodies,
                # so substitute them now — the registered plan is
                # self-contained
                ctes[name.lower()] = SubqueryAlias(name, subst_plan(sub))
                if not self.accept_op(","):
                    break
        plan = self._set_op_query()
        if ctes:
            plan = subst_plan(plan)
        return plan

    def _set_op_query(self) -> LogicalPlan:
        # standard precedence: INTERSECT binds tighter than UNION/EXCEPT
        plan = self._intersect_term()
        while self.at_kw("UNION") or self.at_kw("EXCEPT") \
                or self.at_kw("MINUS"):
            op = self.next().value.upper()
            if op == "UNION":
                distinct = not self.accept_kw("ALL")
                if distinct:
                    self.accept_kw("DISTINCT")
                right = self._intersect_term()
                plan = Union([plan, right])
                if distinct:
                    plan = Distinct(plan)
            else:
                # EXCEPT/MINUS is a DISTINCT set op (no ALL variant)
                self.accept_kw("DISTINCT")
                right = self._intersect_term()
                plan = Except(plan, right)
        # ORDER BY / LIMIT after a set op applies to the whole thing
        plan = self._order_limit(plan, allow=True)
        return plan

    def _intersect_term(self) -> LogicalPlan:
        plan = self._query_term()
        while self.at_kw("INTERSECT"):
            self.next()
            self.accept_kw("DISTINCT")
            plan = Intersect(plan, self._query_term())
        return plan

    def _query_term(self) -> LogicalPlan:
        if self.accept_op("("):
            q = self.parse_query()
            self.expect_op(")")
            return q
        return self._select()

    def _select(self) -> LogicalPlan:
        self.expect_kw("SELECT")
        distinct = False
        if self.accept_kw("DISTINCT"):
            distinct = True
        else:
            self.accept_kw("ALL")

        select_list: List[Expression] = []
        while True:
            e = self.expr()
            if self.accept_kw("AS"):
                e = Alias(e, self.ident())
            elif (self.peek().kind == "IDENT"
                  or self.at_kw("FIRST", "LAST", "VALUES", "TABLES")):
                e = Alias(e, self.ident())
            select_list.append(e)
            if not self.accept_op(","):
                break

        if self.accept_kw("FROM"):
            plan = self._relation()
        else:
            plan = RangeRelation(0, 1, 1, name="__one_row")

        if self.accept_kw("WHERE"):
            plan = Filter(self.expr(), plan)

        group_keys: Optional[List[Expression]] = None
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            group_keys = self._grouping_spec()

        having = None
        if self.accept_kw("HAVING"):
            having = self.expr()

        plan = self._finish_select(select_list, plan, group_keys, having)
        if distinct:
            plan = Distinct(plan)
        # ORDER BY / LIMIT are parsed by _set_op_query (queryOrganization
        # applies to the whole set operation, not the last SELECT branch)
        return plan

    def _grouping_spec(self) -> List[Expression]:
        """GROUP BY keys.  ROLLUP(..) / CUBE(..) / GROUPING SETS((..)..)
        raise: grouping sets come with a later slice."""
        t = self.peek()
        word = t.value.upper() if t.kind == "IDENT" else None
        if word in ("ROLLUP", "CUBE"):
            raise not_ported(word)
        if word == "GROUPING" and self.peek(1).kind == "IDENT" \
                and self.peek(1).value.upper() == "SETS":
            raise not_ported("GROUPING SETS")
        group_keys = []
        while True:
            group_keys.append(self.expr())
            if not self.accept_op(","):
                break
        return group_keys

    def _order_limit(self, plan: LogicalPlan, allow: bool) -> LogicalPlan:
        if allow and (self.at_kw("ORDER") or self.at_kw("SORT")):
            is_global = self.peek().value == "ORDER"
            self.next()
            self.expect_kw("BY")
            orders = []
            names = None
            try:
                names = plan.schema().names
            except AnalysisException:
                names = None
            while True:
                e = self.expr()
                if names and isinstance(e, Literal) and isinstance(e.value, int) \
                        and 1 <= e.value <= len(names):
                    e = Col(names[e.value - 1])
                asc = True
                if self.accept_kw("ASC"):
                    asc = True
                elif self.accept_kw("DESC"):
                    asc = False
                nulls_first = None
                if self.accept_kw("NULLS"):
                    if self.accept_kw("FIRST"):
                        nulls_first = True
                    else:
                        self.expect_kw("LAST")
                        nulls_first = False
                orders.append(SortOrder(e, asc, nulls_first))
                if not self.accept_op(","):
                    break
            plan = Sort(orders, plan, is_global=is_global)
        if allow and self.accept_kw("LIMIT"):
            t = self.next()
            if t.kind != "NUMBER":
                raise ParseException(f"LIMIT expects a number, got {t.value!r}")
            plan = Limit(int(t.value), plan)
        return plan

    def _finish_select(self, select_list: Sequence[Expression],
                       plan: LogicalPlan,
                       group_keys: Optional[List[Expression]],
                       having: Optional[Expression]) -> LogicalPlan:
        from .analyzer import (contains_aggregate, split_aggregate_expr,
                               substitute_grouping_keys)

        # stars stay unexpanded here: the Analyzer expands them after catalog
        # resolution AND join disambiguation (ResolveStar), so `t.*` sees the
        # post-rename qualified schema
        expanded: List[Expression] = list(select_list)
        has_star = any(isinstance(e, _Star) for e in expanded)

        has_agg = any(contains_aggregate(e) for e in expanded) \
            or (having is not None and contains_aggregate(having)) \
            or group_keys is not None

        if not has_agg:
            return Project(expanded, plan)
        if has_star:
            raise ParseException("`*` is not allowed in an aggregating SELECT")

        keys = group_keys or []
        # GROUP BY ordinals (GROUP BY 1, 2)
        resolved_keys: List[Expression] = []
        for k in keys:
            if isinstance(k, Literal) and isinstance(k.value, int) \
                    and 1 <= k.value <= len(expanded):
                resolved_keys.append(expanded[k.value - 1])
            else:
                resolved_keys.append(k)

        slots: List[Tuple[A.AggregateFunction, str]] = []
        key_names = [k.name for k in resolved_keys]
        out_exprs: List[Expression] = []
        for e in expanded:
            name = e.name
            residual = substitute_grouping_keys(
                split_aggregate_expr(e, slots), resolved_keys)
            if isinstance(residual, Col) and not isinstance(e, Alias) \
                    and residual.name not in key_names:
                for j, (f, n) in enumerate(slots):
                    if n == residual.name:
                        slots[j] = (f, name)
                        residual = Col(name)
                        break
            out_exprs.append(
                residual if isinstance(residual, Col) and residual.name == name
                else Alias(residual, name))

        having_residual = None
        if having is not None:
            having_residual = substitute_grouping_keys(
                split_aggregate_expr(having, slots), resolved_keys)

        node: LogicalPlan = Aggregate(resolved_keys, slots, plan)
        if having_residual is not None:
            node = Filter(having_residual, node)
        # project to the visible output (drops hidden having slots, applies
        # scalar post-aggregation arithmetic)
        return Project(out_exprs, node)

    # -- relations --------------------------------------------------------
    def _relation(self) -> LogicalPlan:
        plan = self._join_chain()
        while self.accept_op(","):  # comma = cross join
            right = self._join_chain()
            plan = Join(plan, right, "cross")
        return plan

    def _join_chain(self) -> LogicalPlan:
        plan = self._primary_relation()
        while True:
            how = None
            if self.at_kw("JOIN"):
                how = "inner"
            elif self.at_kw("INNER"):
                self.next()
                how = "inner"
            elif self.at_kw("CROSS"):
                self.next()
                how = "cross"
            elif self.at_kw("LEFT"):
                self.next()
                if self.accept_kw("SEMI"):
                    how = "left_semi"
                elif self.accept_kw("ANTI"):
                    how = "left_anti"
                else:
                    self.accept_kw("OUTER")
                    how = "left"
            elif self.at_kw("RIGHT"):
                self.next()
                self.accept_kw("OUTER")
                how = "right"
            elif self.at_kw("FULL"):
                self.next()
                self.accept_kw("OUTER")
                how = "full"
            else:
                return plan
            self.expect_kw("JOIN")
            right = self._primary_relation()
            on = None
            using = None
            if self.accept_kw("ON"):
                on = self.expr()
            elif self.accept_kw("USING"):
                self.expect_op("(")
                using = [self.ident()]
                while self.accept_op(","):
                    using.append(self.ident())
                self.expect_op(")")
            plan = Join(plan, right, how, on=on, using=using)

    def _primary_relation(self) -> LogicalPlan:
        if self.accept_op("("):
            sub = self.parse_query()
            self.expect_op(")")
            self.accept_kw("AS")
            alias = self.ident()
            return SubqueryAlias(alias, sub)
        name = self.ident()
        if name.lower() == "range" and self.at_op("("):
            # table-valued range([start,] end[, step])
            self.next()
            args = [self.next()]
            while self.accept_op(","):
                args.append(self.next())
            self.expect_op(")")
            if any(t.kind != "NUMBER" for t in args) or not 1 <= len(args) <= 3:
                raise ParseException("range() expects 1-3 integer literals")
            vals = [int(t.value) for t in args]
            if len(vals) == 1:
                rng = RangeRelation(0, vals[0], 1)
            else:
                rng = RangeRelation(vals[0], vals[1],
                                    vals[2] if len(vals) > 2 else 1)
            if self.accept_kw("AS"):
                return SubqueryAlias(self.ident(), rng)
            if self.peek().kind == "IDENT":
                return SubqueryAlias(self.ident(), rng)
            return rng
        while self.accept_op("."):
            name += "." + self.ident()
        rel: LogicalPlan = UnresolvedRelation(name)
        if self.accept_kw("AS"):
            rel = SubqueryAlias(self.ident(), rel)
        elif self.peek().kind == "IDENT" and not self.at_kw():
            rel = SubqueryAlias(self.ident(), rel)
        return rel

    # -- expressions (Pratt) ----------------------------------------------
    def expr(self) -> Expression:
        return self._or_expr()

    def _or_expr(self) -> Expression:
        e = self._and_expr()
        while self.accept_kw("OR"):
            e = Or(e, self._and_expr())
        return e

    def _and_expr(self) -> Expression:
        e = self._not_expr()
        while self.accept_kw("AND"):
            e = And(e, self._not_expr())
        return e

    def _not_expr(self) -> Expression:
        if self.accept_kw("NOT"):
            return Not(self._not_expr())
        return self._predicate()

    def _predicate(self) -> Expression:
        e = self._additive()
        while True:
            if self.at_op("=", "==", "!=", "<>", "<", "<=", ">", ">=", "<=>"):
                op = self.next().value
                rhs = self._additive()
                if op == "<=>":
                    # null-safe equality: TRUE when both null, FALSE when
                    # exactly one is null, else plain equality
                    e = Or(And(IsNull(e), IsNull(rhs)),
                           Coalesce(EQ(e, rhs), Literal(False)))
                    continue
                cls = {"=": EQ, "==": EQ, "!=": NE, "<>": NE,
                       "<": LT, "<=": LE, ">": GT, ">=": GE}[op]
                e = cls(e, rhs)
                continue
            if self.at_kw("IS"):
                self.next()
                neg = self.accept_kw("NOT")
                self.expect_kw("NULL")
                e = IsNotNull(e) if neg else IsNull(e)
                continue
            neg = False
            save = self.i
            if self.accept_kw("NOT"):
                neg = True
            if self.accept_kw("BETWEEN"):
                lo = self._additive()
                self.expect_kw("AND")
                hi = self._additive()
                e = Between(e, lo, hi)
                if neg:
                    e = Not(e)
                continue
            if self.accept_kw("IN"):
                self.expect_op("(")
                if self.at_kw("SELECT") or self.at_kw("WITH"):
                    from .subquery import InSubquery
                    sub = self.parse_query()
                    self.expect_op(")")
                    e = InSubquery(e, sub)
                else:
                    vals = [self.expr()]
                    while self.accept_op(","):
                        vals.append(self.expr())
                    self.expect_op(")")
                    for v in vals:
                        if not isinstance(v, Literal):
                            raise ParseException("IN list must be literals")
                    e = In(e, vals)
                if neg:
                    e = Not(e)
                continue
            if self.accept_kw("LIKE") or self.at_kw("RLIKE"):
                kind = "like"
                if self.at_kw("RLIKE"):
                    self.next()
                    kind = "rlike"
                pat = self.next()
                if pat.kind != "STRING":
                    raise ParseException("LIKE pattern must be a string literal")
                e = StringPredicate(kind, e, _unquote(pat.value))
                if neg:
                    e = Not(e)
                continue
            if neg:
                self.i = save
            return e

    def _additive(self) -> Expression:
        e = self._multiplicative()
        while True:
            if self.accept_op("+"):
                e = Add(e, self._multiplicative())
            elif self.accept_op("-"):
                e = Sub(e, self._multiplicative())
            elif self.at_op("||"):
                raise not_ported("||")
            else:
                return e

    def _multiplicative(self) -> Expression:
        e = self._unary()
        while True:
            if self.accept_op("*"):
                e = Mul(e, self._unary())
            elif self.accept_op("/"):
                e = Div(e, self._unary())
            elif self.accept_op("%"):
                e = Mod(e, self._unary())
            else:
                return e

    def _unary(self) -> Expression:
        if self.accept_op("-"):
            return Neg(self._unary())
        if self.accept_op("+"):
            return self._unary()
        return self._primary()

    def _primary(self) -> Expression:
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            return Literal(self._number(t.value))
        if t.kind == "STRING":
            self.next()
            return Literal(_unquote(t.value))
        if self.accept_kw("TRUE"):
            return Literal(True)
        if self.accept_kw("FALSE"):
            return Literal(False)
        if self.accept_kw("NULL"):
            return Literal(None)
        if self.accept_kw("CASE"):
            return self._case()
        if self.accept_kw("CAST"):
            self.expect_op("(")
            e = self.expr()
            self.expect_kw("AS")
            tname = self.ident()
            if self.accept_op("("):   # decimal(p, s)
                args = [self.next().value]
                while self.accept_op(","):
                    args.append(self.next().value)
                self.expect_op(")")
                tname = f"{tname}({','.join(args)})"
            self.expect_op(")")
            try:
                to = T.type_for_name(tname)
            except ValueError as ex:
                raise ParseException(str(ex))
            return Cast(e, to)
        if t.kind == "KW" and t.value == "EXISTS":
            self.next()
            self.expect_op("(")
            if self.at_kw("SELECT") or self.at_kw("WITH"):
                from .subquery import ExistsSubquery
                sub = self.parse_query()
                self.expect_op(")")
                return ExistsSubquery(sub)
            # exists(arr, x -> pred): the higher-order array function
            raise not_ported("exists")
        if self.accept_op("("):
            if self.at_kw("SELECT") or self.at_kw("WITH"):
                from .subquery import ScalarSubquery
                sub = self.parse_query()
                self.expect_op(")")
                return ScalarSubquery(sub)
            e = self.expr()
            self.expect_op(")")
            return e
        if self.at_op("*"):
            self.next()
            return _Star()
        if t.kind == "IDENT" or (t.kind == "KW" and t.value in (
                "FIRST", "LAST", "LEFT", "RIGHT", "VALUES", "IF", "REPLACE")):
            name = self.ident() if t.kind == "IDENT" else self._kw_as_ident()
            if self.at_op("("):
                return self._function_call(name)
            full = name
            while self.at_op(".") and self.peek(1).kind in ("IDENT", "KW") \
                    or (self.at_op(".") and self.peek(1).kind == "OP"
                        and self.peek(1).value == "*"):
                self.next()
                if self.at_op("*"):
                    self.next()
                    return _Star(qualifier=full)
                full += "." + self.ident()
            return Col(full)
        raise ParseException(
            f"unexpected token {t.value!r} at position {t.pos} in: {self.text}")

    def _kw_as_ident(self) -> str:
        return self.next().value.lower()

    def _number(self, raw: str) -> Any:
        suffix = raw[-1] if raw[-1] in "lLdD" else ""
        if suffix:
            raw = raw[:-1]
        if suffix in ("d", "D") or "." in raw or "e" in raw.lower():
            return float(raw)
        return int(raw)

    def _case(self) -> Expression:
        # simple CASE expr WHEN v ... | searched CASE WHEN p ...
        subject = None
        if not self.at_kw("WHEN"):
            subject = self.expr()
        branches = []
        while self.accept_kw("WHEN"):
            cond = self.expr()
            if subject is not None:
                cond = EQ(subject, cond)
            self.expect_kw("THEN")
            val = self.expr()
            branches.append((cond, val))
        otherwise = None
        if self.accept_kw("ELSE"):
            otherwise = self.expr()
        self.expect_kw("END")
        if not branches:
            raise ParseException("CASE requires at least one WHEN branch")
        return CaseWhen(branches, otherwise)

    def _function_call(self, name: str) -> Expression:
        self.expect_op("(")
        lname = name.lower()
        # a name whose expression a later slice brings raises before its
        # arguments are parsed (the higher-order array functions among
        # them take lambdas, `x -> ...`, which this grammar lacks)
        if lname in NOT_PORTED_FUNCTIONS:
            raise not_ported(lname)
        distinct = False
        args: List[Expression] = []
        if not self.accept_op(")"):
            if self.accept_kw("DISTINCT"):
                distinct = True
            if self.at_op("*"):
                self.next()
                args.append(_Star())
            else:
                args.append(self.expr())
            while self.accept_op(","):
                args.append(self.expr())
            self.expect_op(")")

        out: Optional[Expression] = None
        if lname == "count":
            out = _count(args, distinct)
        elif lname == "approx_count_distinct":
            # served exactly through the two-level distinct expansion (the
            # approximation contract permits exact answers); the optional
            # rsd argument parses and is ignored
            if len(args) not in (1, 2):
                raise ParseException(
                    "approx_count_distinct expects (col[, rsd])")
            out = A.CountDistinct(args[0])
        elif lname in ("sum",) and distinct:
            out = A.SumDistinct(_one(args, "sum"))
        elif lname in AGG_FUNCTIONS:
            if distinct:
                raise ParseException(f"DISTINCT not supported for {lname}")
            out = AGG_FUNCTIONS[lname](_one(args, lname))
        elif lname in SCALAR_FUNCTIONS:
            out = SCALAR_FUNCTIONS[lname](args)
        else:
            # maybe a registered UDF: defer to analysis (FunctionRegistry
            # lookup happens with the session catalog in scope)
            if distinct:
                raise ParseException(
                    f"DISTINCT is not supported for {name}")
            from .udf import UnresolvedFunction
            out = UnresolvedFunction(name, args)

        # OVER ( [PARTITION BY ...] [ORDER BY ...] [ROWS BETWEEN ...] )
        t = self.peek()
        if t.kind == "IDENT" and t.value.upper() == "OVER":
            raise not_ported("OVER")
        return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def parse_expression(text: str) -> Expression:
    p = Parser(text)
    e = p.expr()
    if p.accept_kw("AS"):
        e = Alias(e, p.ident())
    t = p.peek()
    if t.kind != "EOF":
        raise ParseException(
            f"unexpected trailing input at position {t.pos}: {t.value!r} "
            f"in: {text}")
    return e


def parse_query(text: str) -> LogicalPlan:
    p = Parser(text)
    plan = p.parse_query()
    p._expect_eof()
    return plan


def parse_statement(text: str):
    """Returns a LogicalPlan for queries or a Command for DDL/utility."""
    # SET values may contain characters outside the SQL token alphabet
    # (paths, URLs); handle with a raw scan before tokenization
    m = re.match(r"\s*set\b(.*)$", text, re.IGNORECASE | re.DOTALL)
    if m:
        rest = m.group(1).strip()
        if not rest:
            return SetCommand(None, None)
        if "=" in rest:
            k, v = rest.split("=", 1)
            return SetCommand(k.strip(), v.strip())
        return SetCommand(rest, None)
    return Parser(text).parse_statement()
