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
* GROUP BY ROLLUP / CUBE / GROUPING SETS, window functions with
  ``OVER (PARTITION BY .. ORDER BY .. [ROWS BETWEEN ..])``, ``||``.
* statements: CREATE [OR REPLACE] TEMP VIEW, DROP VIEW/TABLE, SHOW TABLES,
  DESCRIBE, EXPLAIN, SET, and the persistent-catalog commands (CREATE
  TABLE, INSERT, databases, ANALYZE TABLE), which parse here and are
  refused by the session.

* higher-order functions with lambdas, ``x -> ...`` and
  ``(acc, x) -> ...``; the array, map and struct functions.

The grammar is the JAX package's, token for token, with two postfix
operators it lacks: ``e[key]`` (``GetItem``: a 0-based array position, a
map key or a struct field) and ``e.field`` after a call or a subscript
(``GetField``; ``s.field`` on a struct column resolves in the analyzer).
A name whose expression a later slice brings
(``analyzer.NOT_PORTED_FUNCTIONS``, empty since the event-time windows
came) raises ``AnalysisException`` naming the construct and that slice.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Sequence, Tuple

from .. import aggregates as A
from .. import expressions as E
from .. import types as T
from ..expressions import (Add, Alias, AnalysisException, And, Between,
                           BinaryMath, CaseWhen, Cast, Coalesce, Col, Concat,
                           DateArith, Div, EQ, Expression, ExtractDatePart,
                           GE, GT, Greatest, GroupingCall, Hash64, If, In,
                           IsNaN, IsNotNull, IsNull, LE, LT, Least, Literal,
                           Mod, Mul, NE, Neg, NextDay, Not, Or,
                           ParamStringTransform, Pow, RoundExpr,
                           StringLength, StringPredicate, StringToInt,
                           StringTransform, Sub, Substring, TruncDate,
                           UnaryMath, UnixTimestamp)
from . import window as W
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
  | (?P<op><=>|<>|!=|<=|>=|==|->|\|\||[=<>+\-*/%(),.\[\]])
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


def _fn_unary(name):
    return lambda args: UnaryMath(name, _one(args, name))


def _fn_stransform(name):
    return lambda args: StringTransform(name, _one(args, name))


def _fn_dpart(part):
    return lambda args: ExtractDatePart(part, _one(args, part))


def _litval(e, name):
    """The value of a literal argument (a negated literal folds)."""
    if isinstance(e, Neg) and isinstance(e.children[0], Literal):
        return -e.children[0].value
    if not isinstance(e, Literal):
        raise ParseException(f"{name} expects a literal argument")
    return e.value


def _substring(args):
    if len(args) != 3:
        raise ParseException("substring expects (str, pos, len)")
    s, pos, ln = args
    if not isinstance(pos, Literal) or not isinstance(ln, Literal):
        raise ParseException("substring pos/len must be literals")
    return Substring(s, int(pos.value), int(ln.value))


def _concat_ws(args):
    if not args or not isinstance(args[0], Literal):
        raise ParseException("concat_ws expects a literal separator")
    sep = str(args[0].value)
    parts: List[Expression] = []
    for i, c in enumerate(args[1:]):
        if i:
            parts.append(Literal(sep))
        parts.append(c)
    return Concat(*parts)


def _round(args):
    if len(args) == 1:
        return RoundExpr(args[0], 0)
    if len(args) == 2 and isinstance(args[1], Literal):
        return RoundExpr(args[0], int(args[1].value))
    raise ParseException("round expects (expr[, literal scale])")


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


def _time_window(args, field):
    from ..expressions import TimeWindow, parse_duration
    if len(args) not in (2, 3) \
            or any(not isinstance(a, Literal) for a in args[1:]):
        raise ParseException(
            "window expects (timeColumn, 'duration literal'"
            "[, 'slide literal'])")
    slide = parse_duration(args[2].value) if len(args) > 2 else None
    return TimeWindow(args[0], parse_duration(args[1].value), slide, field)


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
    "window": lambda a: _time_window(a, "start"),
    "window_end": lambda a: _time_window(a, "end"),
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
    # math
    "abs": _fn_unary("abs"), "sqrt": _fn_unary("sqrt"), "exp": _fn_unary("exp"),
    "ln": _fn_unary("ln"), "log": _fn_unary("ln"), "log10": _fn_unary("log10"),
    "log2": _fn_unary("log2"), "floor": _fn_unary("floor"),
    "ceil": _fn_unary("ceil"), "ceiling": _fn_unary("ceil"),
    "sin": _fn_unary("sin"), "cos": _fn_unary("cos"), "tan": _fn_unary("tan"),
    "asin": _fn_unary("asin"), "acos": _fn_unary("acos"),
    "atan": _fn_unary("atan"), "sinh": _fn_unary("sinh"),
    "cosh": _fn_unary("cosh"), "tanh": _fn_unary("tanh"),
    "signum": _fn_unary("sign"), "sign": _fn_unary("sign"),
    "radians": _fn_unary("radians"), "degrees": _fn_unary("degrees"),
    "log1p": _fn_unary("log1p"), "expm1": _fn_unary("expm1"),
    "cbrt": _fn_unary("cbrt"), "rint": _fn_unary("rint"),
    "isnan": lambda a: IsNaN(_one(a, "isnan")),
    "greatest": lambda a: Greatest(*a),
    "least": lambda a: Least(*a),
    "power": lambda a: Pow(a[0], a[1]),
    "pow": lambda a: Pow(a[0], a[1]),
    "round": _round,
    "hypot": lambda a: BinaryMath("hypot", a[0], a[1]),
    "atan2": lambda a: BinaryMath("atan2", a[0], a[1]),
    "nanvl": lambda a: BinaryMath("nanvl", a[0], a[1]),
    # strings
    "upper": _fn_stransform("upper"), "ucase": _fn_stransform("upper"),
    "lower": _fn_stransform("lower"), "lcase": _fn_stransform("lower"),
    "trim": _fn_stransform("trim"), "ltrim": _fn_stransform("ltrim"),
    "rtrim": _fn_stransform("rtrim"), "reverse": _fn_stransform("reverse"),
    "initcap": _fn_stransform("initcap"),
    "length": lambda a: StringLength(_one(a, "length")),
    "char_length": lambda a: StringLength(_one(a, "char_length")),
    "substring": _substring, "substr": _substring,
    "concat": lambda a: Concat(*a),
    "concat_ws": _concat_ws,
    "regexp_replace": lambda a: ParamStringTransform(
        "regexp_replace", a[0], (_litval(a[1], "regexp_replace"),
                                 _litval(a[2], "regexp_replace"))),
    "regexp_extract": lambda a: ParamStringTransform(
        "regexp_extract", a[0],
        (_litval(a[1], "regexp_extract"),
         int(_litval(a[2], "regexp_extract")) if len(a) > 2 else 1)),
    "lpad": lambda a: ParamStringTransform(
        "lpad", a[0], (int(_litval(a[1], "lpad")),
                       _litval(a[2], "lpad") if len(a) > 2 else " ")),
    "rpad": lambda a: ParamStringTransform(
        "rpad", a[0], (int(_litval(a[1], "rpad")),
                       _litval(a[2], "rpad") if len(a) > 2 else " ")),
    "translate": lambda a: ParamStringTransform(
        "translate", a[0], (_litval(a[1], "translate"),
                            _litval(a[2], "translate"))),
    "repeat": lambda a: ParamStringTransform(
        "repeat", a[0], (int(_litval(a[1], "repeat")),)),
    "soundex": lambda a: ParamStringTransform("soundex", a[0]),
    "md5": lambda a: ParamStringTransform("md5", a[0]),
    "sha1": lambda a: ParamStringTransform("sha1", a[0]),
    "sha2": lambda a: ParamStringTransform(
        "sha2", a[0], (int(_litval(a[1], "sha2")) if len(a) > 1 else 256,)),
    "base64": lambda a: ParamStringTransform("base64", a[0]),
    "unbase64": lambda a: ParamStringTransform("unbase64", a[0]),
    "hex": lambda a: ParamStringTransform("hex", a[0]),
    "instr": lambda a: StringToInt("instr", a[0], (_litval(a[1], "instr"),)),
    "locate": lambda a: StringToInt(
        "locate", a[1], (_litval(a[0], "locate"),
                         int(_litval(a[2], "locate")) if len(a) > 2 else 1)),
    "levenshtein": lambda a: StringToInt(
        "levenshtein", a[0], (_litval(a[1], "levenshtein"),)),
    "crc32": lambda a: StringToInt("crc32", a[0]),
    # dates
    "year": _fn_dpart("year"), "month": _fn_dpart("month"),
    "day": _fn_dpart("day"), "dayofmonth": _fn_dpart("day"),
    "dayofweek": _fn_dpart("dayofweek"), "dayofyear": _fn_dpart("dayofyear"),
    "quarter": _fn_dpart("quarter"), "hour": _fn_dpart("hour"),
    "minute": _fn_dpart("minute"), "second": _fn_dpart("second"),
    "weekofyear": _fn_dpart("weekofyear"),
    "date_add": lambda a: DateArith("date_add", a[0], a[1]),
    "date_sub": lambda a: DateArith("date_sub", a[0], a[1]),
    "datediff": lambda a: DateArith("datediff", a[0], a[1]),
    "add_months": lambda a: DateArith("add_months", a[0], a[1]),
    "months_between": lambda a: DateArith("months_between", a[0], a[1]),
    "last_day": lambda a: DateArith("last_day", a[0]),
    "next_day": lambda a: NextDay(a[0], _litval(a[1], "next_day")),
    "trunc": lambda a: TruncDate(a[0], _litval(a[1], "trunc")),
    "unix_timestamp": lambda a: UnixTimestamp(a[0]),
    "from_unixtime": lambda a: UnixTimestamp(a[0], inverse=True),
    # grouping sets
    "grouping": lambda a: GroupingCall(_one(a, "grouping")),
    "grouping_id": lambda a: GroupingCall(None),
    # random draws and partition ids
    "rand": lambda a: E.Rand(int(a[0].value) if a else 42),
    "randn": lambda a: E.Randn(int(a[0].value) if a else 42),
    "spark_partition_id": lambda a: E.SparkPartitionId(),
}


def _array_reduce(args, op):
    return E.ArrayReduce(_one(args, f"array_{op}"), op)


def _sort_array(args):
    if len(args) == 1:
        return E.SortArray(args[0], True)
    if len(args) == 2 and isinstance(args[1], Literal):
        return E.SortArray(args[0], bool(args[1].value))
    raise ParseException("sort_array expects (arr[, asc literal])")


def _array_slice(args):
    if len(args) != 3 or not all(isinstance(a, Literal) for a in args[1:]):
        raise ParseException("slice expects (arr, start literal, "
                             "length literal)")
    return E.ArraySlice(args[0], int(args[1].value), int(args[2].value))


def _array_position(args):
    if len(args) != 2:
        raise ParseException("array_position expects (arr, value)")
    return E.ArrayPosition(args[0], _litval(args[1], "array_position"))


def _element_at(a):
    if len(a) != 2:
        raise ParseException("element_at expects (col, index_or_key)")
    try:
        v = _litval(a[1], "element_at")   # folds e.g. unary minus
    except Exception:
        v = None
    if isinstance(v, int) and not isinstance(v, bool) and v != 0:
        return E.ElementAt(a[0], int(v))
    return E.MapGet(a[0], a[1])   # a map key (int 0 too) or a dynamic index


def _struct(a):
    names = [getattr(e, "name", None) or f"col{i + 1}"
             for i, e in enumerate(a)]
    return E.CreateStruct(names, *a)


def _named_struct(a):
    if len(a) % 2:
        raise ParseException("named_struct expects alternating name, value")
    names = [str(_litval(e, "named_struct")) for e in a[0::2]]
    return E.CreateStruct(names, *a[1::2])


def _map_from_arrays(a):
    if len(a) != 2:
        raise ParseException("map_from_arrays expects (keys, values)")
    return E.MapFromArrays(a[0], a[1])


SCALAR_FUNCTIONS.update({
    "array": lambda a: E.MakeArray(*a),
    "split": lambda a: E.SplitStr(a[0], _litval(a[1], "split"),
                                  int(_litval(a[2], "split"))
                                  if len(a) > 2 else -1),
    "size": lambda a: E.ArraySize(_one(a, "size")),
    "cardinality": lambda a: E.ArraySize(_one(a, "cardinality")),
    "element_at": _element_at,
    "map": lambda a: E.CreateMap(*a),
    "named_struct": _named_struct,
    "struct": _struct,
    "map_keys": lambda a: E.MapKeys(_one(a, "map_keys")),
    "map_values": lambda a: E.MapValues(_one(a, "map_values")),
    "map_from_arrays": _map_from_arrays,
    "array_contains": lambda a: E.ArrayContains(
        a[0], _litval(a[1], "array_contains")),
    "array_max": lambda a: _array_reduce(a, "max"),
    "array_min": lambda a: _array_reduce(a, "min"),
    "sort_array": _sort_array,
    "array_distinct": lambda a: E.ArrayDistinct(_one(a, "array_distinct")),
    "slice": _array_slice,
    "array_position": _array_position,
    "explode": lambda a: E.ExplodeMarker(_one(a, "explode")),
    "posexplode": lambda a: E.ExplodeMarker(_one(a, "posexplode"),
                                            with_pos=True),
})

AGG_FUNCTIONS = {
    "collect_list": lambda e: A.CollectList(e),
    "collect_set": lambda e: A.CollectSet(e),
    "sum": lambda e: A.Sum(e),
    "avg": lambda e: A.Avg(e),
    "mean": lambda e: A.Avg(e),
    "min": lambda e: A.Min(e),
    "max": lambda e: A.Max(e),
    "first": lambda e: A.First(e),
    "first_value": lambda e: A.First(e),
    "last": lambda e: A.Last(e),
    "last_value": lambda e: A.Last(e),
    "median": lambda e: A.PercentileApprox(e, 0.5),
    "stddev": lambda e: A.StddevSamp(e),
    "stddev_samp": lambda e: A.StddevSamp(e),
    "stddev_pop": lambda e: A.StddevPop(e),
    "variance": lambda e: A.VarSamp(e),
    "var_samp": lambda e: A.VarSamp(e),
    "var_pop": lambda e: A.VarPop(e),
}


def _win0(cls):
    return lambda a: cls()


def _lag_lead(cls):
    def f(a):
        off = int(a[1].value) if len(a) > 1 else 1
        default = a[2].value if len(a) > 2 else None
        return cls(a[0], off, default)
    return f


WINDOW_FUNCTIONS = {
    "row_number": _win0(W.RowNumber),
    "rank": _win0(W.Rank),
    "dense_rank": _win0(W.DenseRank),
    "percent_rank": _win0(W.PercentRank),
    "cume_dist": _win0(W.CumeDist),
    "ntile": lambda a: W.NTile(int(a[0].value)),
    "lag": _lag_lead(W.Lag),
    "lead": _lag_lead(W.Lead),
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
        grouping_sets = None            # list of index tuples into keys
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            group_keys, grouping_sets = self._grouping_spec()

        having = None
        if self.accept_kw("HAVING"):
            having = self.expr()

        if grouping_sets is not None:
            from .logical import GroupingSets
            plan = GroupingSets(list(select_list), group_keys,
                                grouping_sets, having, plan)
            if distinct:
                plan = Distinct(plan)
            return plan

        plan = self._finish_select(select_list, plan, group_keys, having)
        if distinct:
            plan = Distinct(plan)
        # ORDER BY / LIMIT are parsed by _set_op_query (queryOrganization
        # applies to the whole set operation, not the last SELECT branch)
        return plan

    def _grouping_spec(self):
        """GROUP BY keys | ROLLUP(..) | CUBE(..) | GROUPING SETS((..)..).
        Returns (keys, sets): sets None for plain grouping."""
        t = self.peek()
        word = t.value.upper() if t.kind == "IDENT" else None
        if word in ("ROLLUP", "CUBE"):
            self.next()
            self.expect_op("(")
            keys = [self.expr()]
            while self.accept_op(","):
                keys.append(self.expr())
            self.expect_op(")")
            n = len(keys)
            if word == "ROLLUP":
                sets = [tuple(range(n - i)) for i in range(n + 1)]
            else:
                sets = [tuple(j for j in range(n) if (m >> j) & 1)
                        for m in range((1 << n) - 1, -1, -1)]
            return keys, sets
        if word == "GROUPING":
            self.next()
            nxt = self.next()
            if not (nxt.kind == "IDENT" and nxt.value.upper() == "SETS"):
                raise ParseException("expected SETS after GROUPING")
            self.expect_op("(")
            keys: List[Expression] = []
            key_pos = {}
            sets = []
            while True:
                self.expect_op("(")
                cur = []
                if not self.accept_op(")"):
                    while True:
                        e = self.expr()
                        r = repr(e)
                        if r not in key_pos:
                            key_pos[r] = len(keys)
                            keys.append(e)
                        cur.append(key_pos[r])
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                sets.append(tuple(cur))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return keys, sets
        group_keys = []
        while True:
            group_keys.append(self.expr())
            if not self.accept_op(","):
                break
        return group_keys, None

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
            elif self.accept_op("||"):
                e = Concat(e, self._multiplicative())
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
        return self._postfix(self._primary())

    def _postfix(self, e: Expression) -> Expression:
        """``e[key]`` and, after a call or a subscript, ``e.field``."""
        while True:
            if self.accept_op("["):
                key = _litval(self.expr(), "subscript")
                self.expect_op("]")
                e = E.GetItem(e, key)
            elif not isinstance(e, (Col, Literal, _Star)) \
                    and self.at_op(".") \
                    and self.peek(1).kind in ("IDENT", "KW"):
                self.next()
                e = E.GetField(e, self.ident())
            else:
                return e

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
            # (SubqueryExpression and higherOrderFunctions disambiguate
            # the same way in the reference grammar)
            arr = self.expr()
            self.expect_op(",")
            var, body = self._lambda_arg()
            self.expect_op(")")
            return E.ArrayExists(arr, var, body)
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

    # `exists` is a KEYWORD (the subquery predicate) and reaches the
    # higher-order path through the EXISTS branch of _primary, never here
    _HOF_NAMES = frozenset({"transform", "filter", "forall",
                            "aggregate", "zip_with"})

    def _lambda_arg(self, n_vars: int = 1):
        """`x -> expr` or `(a, b) -> expr` (the lambda syntax of
        higherOrderFunctions.scala)."""
        names = []
        if self.accept_op("("):
            while True:
                t = self.peek()
                if t.kind != "IDENT":
                    raise ParseException(
                        f"expected lambda variable, got {t.value!r}")
                self.next()
                names.append(t.value)
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        else:
            t = self.peek()
            if t.kind != "IDENT":
                raise ParseException(
                    f"expected lambda variable, got {t.value!r}")
            self.next()
            names.append(t.value)
        if len(names) != n_vars:
            raise ParseException(
                f"lambda expects {n_vars} variable(s), got {names}")
        if len({nm.lower() for nm in names}) != len(names):
            raise ParseException(
                f"duplicate lambda variable names {names}")
        self.expect_op("->")
        variables = [E.LambdaVar(nm) for nm in names]
        by_name = {nm.lower(): v for nm, v in zip(names, variables)}
        # the body names the variables by their source names: parse it,
        # then substitute Col(name) -> the bound LambdaVar
        body = self.expr()

        def sub(e):
            if isinstance(e, Col) and e.name.lower() in by_name:
                return by_name[e.name.lower()]
            return e.map_children(sub)

        body = sub(body)
        if n_vars == 1:
            return variables[0], body
        return variables, body

    def _higher_order_call(self, lname: str) -> Expression:
        arr = self.expr()
        self.expect_op(",")
        if lname == "aggregate":
            init = self.expr()
            self.expect_op(",")
            (acc, x), merge = self._lambda_arg(2)
            fvar = fbody = None
            if self.accept_op(","):
                fvar, fbody = self._lambda_arg(1)
            self.expect_op(")")
            return E.ArrayAggregate(arr, init, acc, x, merge, fvar, fbody)
        if lname == "zip_with":
            other = self.expr()
            self.expect_op(",")
            (x, y), body = self._lambda_arg(2)
            self.expect_op(")")
            return E.ZipWith(arr, other, x, y, body)
        var, body = self._lambda_arg()
        self.expect_op(")")
        if lname == "transform":
            return E.ArrayTransform(arr, var, body)
        if lname == "filter":
            return E.ArrayFilterFn(arr, var, body)
        return E.ArrayExists(arr, var, body, require_all=(lname == "forall"))

    def _function_call(self, name: str) -> Expression:
        self.expect_op("(")
        lname = name.lower()
        # a name whose expression a later slice brings raises before its
        # arguments are parsed
        if lname in NOT_PORTED_FUNCTIONS:
            raise not_ported(lname)
        if lname in self._HOF_NAMES:
            return self._higher_order_call(lname)
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
        elif lname in ("percentile_approx", "approx_percentile"):
            if distinct:
                raise ParseException(f"DISTINCT not supported for {lname}")
            if len(args) not in (2, 3):
                raise ParseException(
                    "percentile_approx expects (col, percentage[, accuracy])")
            out = A.PercentileApprox(
                args[0], float(_litval(args[1], "percentile_approx")))
        elif lname in AGG_FUNCTIONS:
            if distinct:
                raise ParseException(f"DISTINCT not supported for {lname}")
            out = AGG_FUNCTIONS[lname](_one(args, lname))
        elif lname in SCALAR_FUNCTIONS:
            out = SCALAR_FUNCTIONS[lname](args)
        elif lname in WINDOW_FUNCTIONS:
            out = WINDOW_FUNCTIONS[lname](args)
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
            self.next()
            out = self._over_clause(out)
        return out

    def _over_clause(self, func: Expression) -> Expression:
        self.expect_op("(")
        spec = W.WindowSpec()
        t = self.peek()
        if t.kind == "IDENT" and t.value.upper() == "PARTITION":
            self.next()
            self.expect_kw("BY")
            parts = [self.expr()]
            while self.accept_op(","):
                parts.append(self.expr())
            spec = W.WindowSpec(parts, spec.order_by, spec.frame,
                                spec.frame_type)
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            orders = []
            while True:
                e = self.expr()
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
            spec = W.WindowSpec(spec.partition_by, orders, spec.frame,
                                spec.frame_type)
        t = self.peek()
        if t.kind == "IDENT" and t.value.upper() in ("ROWS", "RANGE"):
            kind = self.next().value.lower()
            self.expect_kw("BETWEEN")
            lo = self._frame_bound()
            self.expect_kw("AND")
            hi = self._frame_bound()
            if kind == "rows":
                spec = spec.rowsBetween(
                    lo if lo is not None else W.Window.unboundedPreceding,
                    hi if hi is not None else W.Window.unboundedFollowing)
        self.expect_op(")")
        return W.WindowExpression(func, spec)

    def _frame_bound(self) -> Optional[int]:
        t = self.peek()
        if t.kind == "IDENT" and t.value.upper() == "UNBOUNDED":
            self.next()
            t2 = self.next()
            if t2.value.upper() == "PRECEDING":
                return W.Window.unboundedPreceding
            return W.Window.unboundedFollowing
        if t.kind == "IDENT" and t.value.upper() == "CURRENT":
            self.next()
            self.next()    # ROW
            return 0
        if t.kind == "NUMBER":
            n = int(self.next().value)
            t2 = self.next()
            if t2.value.upper() == "PRECEDING":
                return -n
            return n
        raise ParseException(f"bad frame bound at {t.pos}: {t.value!r}")


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
