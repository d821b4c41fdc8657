"""Built-in function surface (the analog of ``sql/core/.../functions.scala``
and ``pyspark.sql.functions``): the subset of ``spark_tpu/sql/functions.py``
whose expressions the port has (not yet: rand, the array, map and struct
functions, collect_list / collect_set and the event-time windows)."""

from __future__ import annotations

from typing import Any, Union

from .. import aggregates as A
from .. import expressions as E
from .column import Column, ColumnOrName

__all__ = [
    "col", "column", "lit", "expr", "when", "coalesce", "isnull", "isnan",
    "greatest", "least", "abs", "sqrt", "exp", "log", "log10", "log2", "pow",
    "floor", "ceil", "round", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "tanh", "signum", "radians", "degrees", "hypot", "atan2",
    "nanvl", "log1p", "expm1", "cbrt", "rint",
    "upper", "lower", "trim", "ltrim", "rtrim", "reverse", "initcap",
    "length", "substring", "concat", "concat_ws", "regexp_replace",
    "regexp_extract", "lpad", "rpad", "translate", "repeat", "soundex", "md5",
    "sha1", "sha2", "base64", "unbase64", "hex", "instr", "locate",
    "levenshtein", "crc32",
    "year", "month", "dayofmonth", "dayofweek", "dayofyear", "quarter",
    "hour", "minute", "second", "weekofyear", "to_date", "to_timestamp",
    "date_add", "date_sub", "datediff", "add_months", "months_between",
    "last_day", "next_day", "trunc", "unix_timestamp", "from_unixtime",
    "sum", "count", "avg", "mean", "min", "max", "first", "last",
    "countDistinct", "sumDistinct", "variance", "var_samp", "var_pop",
    "stddev", "stddev_samp", "stddev_pop", "percentile_approx", "median",
    "grouping", "grouping_id",
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile",
    "lag", "lead", "udf", "asc", "desc",
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


def isnan(c) -> Column:
    return Column(E.IsNaN(_e(c)))


def greatest(*cols) -> Column:
    return Column(E.Greatest(*[_e(c) for c in cols]))


def least(*cols) -> Column:
    return Column(E.Least(*[_e(c) for c in cols]))


# ---- math -------------------------------------------------------------------

def _unary(fn):
    def f(c) -> Column:
        return Column(E.UnaryMath(fn, _e(c)))
    f.__name__ = fn
    return f


abs = _unary("abs")           # noqa: A001
sqrt = _unary("sqrt")
exp = _unary("exp")
log = _unary("ln")
log10 = _unary("log10")
log2 = _unary("log2")
floor = _unary("floor")
ceil = _unary("ceil")
sin = _unary("sin")
cos = _unary("cos")
tan = _unary("tan")
asin = _unary("asin")
acos = _unary("acos")
atan = _unary("atan")
sinh = _unary("sinh")
cosh = _unary("cosh")
tanh = _unary("tanh")
signum = _unary("sign")
radians = _unary("radians")
degrees = _unary("degrees")
log1p = _unary("log1p")
expm1 = _unary("expm1")
cbrt = _unary("cbrt")
rint = _unary("rint")


def pow(base, exponent) -> Column:  # noqa: A001
    return Column(E.Pow(_e(base), _e(exponent)))


def round(c, scale: int = 0) -> Column:  # noqa: A001
    return Column(E.RoundExpr(_e(c), scale))


def hypot(a, b) -> Column:
    return Column(E.BinaryMath("hypot", _e(a), _e(b)))


def atan2(a, b) -> Column:
    return Column(E.BinaryMath("atan2", _e(a), _e(b)))


def nanvl(a, b) -> Column:
    return Column(E.BinaryMath("nanvl", _e(a), _e(b)))


# ---- strings ----------------------------------------------------------------

def _stransform(fn):
    def f(c) -> Column:
        return Column(E.StringTransform(fn, _e(c)))
    f.__name__ = fn
    return f


upper = _stransform("upper")
lower = _stransform("lower")
trim = _stransform("trim")
ltrim = _stransform("ltrim")
rtrim = _stransform("rtrim")
reverse = _stransform("reverse")
initcap = _stransform("initcap")


def length(c) -> Column:
    return Column(E.StringLength(_e(c)))


def substring(c, pos: int, length_: int) -> Column:
    return Column(E.Substring(_e(c), pos, length_))


def concat(*cols) -> Column:
    return Column(E.Concat(*[_e(c) for c in cols]))


def concat_ws(sep: str, *cols) -> Column:
    parts = []
    for i, c in enumerate(cols):
        if i:
            parts.append(E.Literal(sep))
        parts.append(_e(c))
    return Column(E.Concat(*parts))


def _param_string(kind, c, params=()) -> Column:
    return Column(E.ParamStringTransform(kind, _e(c), params))


def regexp_replace(c, pattern: str, replacement: str) -> Column:
    return _param_string("regexp_replace", c, (pattern, replacement))


def regexp_extract(c, pattern: str, idx: int = 1) -> Column:
    return _param_string("regexp_extract", c, (pattern, idx))


def lpad(c, length: int, pad: str = " ") -> Column:
    return _param_string("lpad", c, (length, pad))


def rpad(c, length: int, pad: str = " ") -> Column:
    return _param_string("rpad", c, (length, pad))


def translate(c, matching: str, replace: str) -> Column:
    return _param_string("translate", c, (matching, replace))


def repeat(c, n: int) -> Column:
    return _param_string("repeat", c, (n,))


def soundex(c) -> Column:
    return _param_string("soundex", c)


def md5(c) -> Column:
    return _param_string("md5", c)


def sha1(c) -> Column:
    return _param_string("sha1", c)


def sha2(c, numBits: int = 256) -> Column:
    return _param_string("sha2", c, (numBits,))


def base64(c) -> Column:
    return _param_string("base64", c)


def unbase64(c) -> Column:
    return _param_string("unbase64", c)


def hex(c) -> Column:  # noqa: A001
    return _param_string("hex", c)


def instr(c, substr: str) -> Column:
    return Column(E.StringToInt("instr", _e(c), (substr,)))


def locate(substr: str, c, pos: int = 1) -> Column:
    return Column(E.StringToInt("locate", _e(c), (substr, pos)))


def levenshtein(c, other: str) -> Column:
    """Edit distance to a LITERAL string (the dictionary-table contract)."""
    return Column(E.StringToInt("levenshtein", _e(c), (other,)))


def crc32(c) -> Column:
    return Column(E.StringToInt("crc32", _e(c)))


# ---- dates ------------------------------------------------------------------

def _dpart(part):
    def f(c) -> Column:
        return Column(E.ExtractDatePart(part, _e(c)))
    f.__name__ = part
    return f


year = _dpart("year")
month = _dpart("month")
dayofmonth = _dpart("day")
dayofweek = _dpart("dayofweek")
dayofyear = _dpart("dayofyear")
quarter = _dpart("quarter")
hour = _dpart("hour")
minute = _dpart("minute")
second = _dpart("second")
weekofyear = _dpart("weekofyear")


def to_date(c) -> Column:
    from .. import types as T
    return Column(E.Cast(_e(c), T.date))


def to_timestamp(c) -> Column:
    from .. import types as T
    return Column(E.Cast(_e(c), T.timestamp))


def date_add(c, days) -> Column:
    return Column(E.DateArith("date_add", _e(c), _ev(days)))


def date_sub(c, days) -> Column:
    return Column(E.DateArith("date_sub", _e(c), _ev(days)))


def datediff(end, start) -> Column:
    return Column(E.DateArith("datediff", _e(end), _e(start)))


def add_months(c, months) -> Column:
    return Column(E.DateArith("add_months", _e(c), _ev(months)))


def months_between(end, start) -> Column:
    return Column(E.DateArith("months_between", _e(end), _e(start)))


def last_day(c) -> Column:
    return Column(E.DateArith("last_day", _e(c)))


def next_day(c, dayOfWeek: str) -> Column:
    return Column(E.NextDay(_e(c), dayOfWeek))


def trunc(c, fmt: str) -> Column:
    return Column(E.TruncDate(_e(c), fmt))


def unix_timestamp(c) -> Column:
    return Column(E.UnixTimestamp(_e(c)))


def from_unixtime(c) -> Column:
    """Returns TIMESTAMP (the JAX package's deviation: Spark formats a
    string)."""
    return Column(E.UnixTimestamp(_e(c), inverse=True))


def grouping(c) -> Column:
    return Column(E.GroupingCall(_e(c)))


def grouping_id() -> Column:
    return Column(E.GroupingCall(None))


# ---- window functions -------------------------------------------------------

def row_number() -> Column:
    from .window import RowNumber
    return Column(RowNumber())


def rank() -> Column:
    from .window import Rank
    return Column(Rank())


def dense_rank() -> Column:
    from .window import DenseRank
    return Column(DenseRank())


def percent_rank() -> Column:
    from .window import PercentRank
    return Column(PercentRank())


def cume_dist() -> Column:
    from .window import CumeDist
    return Column(CumeDist())


def ntile(n: int) -> Column:
    from .window import NTile
    return Column(NTile(n))


def lag(c, offset: int = 1, default=None) -> Column:
    from .window import Lag
    return Column(Lag(_e(c), offset, default))


def lead(c, offset: int = 1, default=None) -> Column:
    from .window import Lead
    return Column(Lead(_e(c), offset, default))


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


def variance(c) -> Column:
    return Column(A.VarSamp(_e(c)))


var_samp = variance


def var_pop(c) -> Column:
    return Column(A.VarPop(_e(c)))


def stddev(c) -> Column:
    return Column(A.StddevSamp(_e(c)))


stddev_samp = stddev


def stddev_pop(c) -> Column:
    return Column(A.StddevPop(_e(c)))


def percentile_approx(c, percentage: float, accuracy: int = 10000) -> Column:
    """The exact per-group percentile (``aggregates.PercentileApprox``);
    ``accuracy`` is accepted for the API and not used."""
    return Column(A.PercentileApprox(_e(c), percentage))


def median(c) -> Column:
    return percentile_approx(c, 0.5)


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
