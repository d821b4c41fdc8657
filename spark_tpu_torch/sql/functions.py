"""Built-in function surface (the analog of ``sql/core/.../functions.scala``
and ``pyspark.sql.functions``): the subset of ``spark_tpu/sql/functions.py``
whose expressions the port has (not yet: the event-time windows)."""

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


def window(c, windowDuration: str, slideDuration=None) -> Column:
    """Event-time bucket; evaluates to the window START timestamp (the
    struct-free flattening of the reference's window().start).  A slide
    shorter than the duration makes a sliding window (grouping key only)."""
    from ..expressions import TimeWindow, parse_duration
    slide = parse_duration(slideDuration) if slideDuration else None
    return Column(TimeWindow(_e(c), parse_duration(windowDuration), slide))


def window_end(c, windowDuration: str) -> Column:
    """END timestamp of the tumbling window containing c."""
    from ..expressions import TimeWindow, parse_duration
    return Column(TimeWindow(_e(c), parse_duration(windowDuration),
                             None, "end"))


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


# ---- hashing, approximate counts, file names --------------------------------

def hash(*cols) -> Column:  # noqa: A001
    return Column(E.Hash64(*[_e(c) for c in cols]))


xxhash64 = hash


def approx_count_distinct(c, rsd: float = 0.05) -> Column:
    """Answered exactly (the two-level distinct expansion meets any
    ``rsd``)."""
    return Column(A.CountDistinct(_e(c)))


def input_file_name() -> Column:
    """'' as in the reference when no file is attached to the task: every
    batch of the port is in memory."""
    return Column(E.Alias(E.Literal(""), "input_file_name()"))


# ---- random draws and row ids -----------------------------------------------

def rand(seed: int = 0) -> Column:
    return Column(E.Rand(seed))


def randn(seed: int = 0) -> Column:
    return Column(E.Randn(seed))


def monotonically_increasing_id() -> Column:
    return Column(E.RowIndex())


def spark_partition_id() -> Column:
    return Column(E.SparkPartitionId())


# ---- arrays, structs and maps -----------------------------------------------

def array(*cols) -> Column:
    return Column(E.MakeArray(*[_e(c) for c in cols]))


def split(c, pattern: str, limit: int = -1) -> Column:
    return Column(E.SplitStr(_e(c), pattern, limit))


def size(c) -> Column:
    return Column(E.ArraySize(_e(c)))


def element_at(c, index) -> Column:
    """A 1-based array index (a nonzero int) or a map key (anything
    else); the optimizer's complex-type rewrite dispatches the map case."""
    if isinstance(index, int) and not isinstance(index, bool) and index != 0:
        return Column(E.ElementAt(_e(c), index))
    return Column(E.MapGet(_e(c), _e(index) if isinstance(index, Column)
                           else E.Literal(index)))


def array_contains(c, value: Any) -> Column:
    return Column(E.ArrayContains(_e(c), value))


def array_max(c) -> Column:
    return Column(E.ArrayReduce(_e(c), "max"))


def array_min(c) -> Column:
    return Column(E.ArrayReduce(_e(c), "min"))


def sort_array(c, asc: bool = True) -> Column:
    return Column(E.SortArray(_e(c), asc))


def array_distinct(c) -> Column:
    return Column(E.ArrayDistinct(_e(c)))


def slice(c, start: int, length: int) -> Column:  # noqa: A001
    return Column(E.ArraySlice(_e(c), start, length))


def array_position(c, value: Any) -> Column:
    return Column(E.ArrayPosition(_e(c), value))


def explode(c) -> Column:
    return Column(E.ExplodeMarker(_e(c)))


def posexplode(c) -> Column:
    return Column(E.ExplodeMarker(_e(c), with_pos=True))


def _lambda(f, *names) -> tuple:
    """(lambda variables, body) from a Python function of Columns (the
    DataFrame half of higherOrderFunctions.scala)."""
    variables = [E.LambdaVar(n) for n in names]
    out = f(*[Column(v) for v in variables])
    if not isinstance(out, Column):
        raise E.AnalysisException(
            "a higher-order function's lambda must return a Column")
    return variables, out._e


def transform(c, f) -> Column:
    """transform(arr, x -> expr): evaluated over the whole element plane."""
    (var,), body = _lambda(f, "x")
    return Column(E.ArrayTransform(_e(c), var, body))


def filter(c, f) -> Column:  # noqa: A001
    (var,), body = _lambda(f, "x")
    return Column(E.ArrayFilterFn(_e(c), var, body))


def exists(c, f) -> Column:
    (var,), body = _lambda(f, "x")
    return Column(E.ArrayExists(_e(c), var, body))


def forall(c, f) -> Column:
    (var,), body = _lambda(f, "x")
    return Column(E.ArrayExists(_e(c), var, body, require_all=True))


def aggregate(c, initialValue, merge, finish=None) -> Column:
    """aggregate(arr, init, (acc, x) -> merge[, acc -> finish])."""
    (acc, x), merged = _lambda(merge, "acc", "x")
    fvar = fbody = None
    if finish is not None:
        (fvar,), fbody = _lambda(finish, "acc")
    return Column(E.ArrayAggregate(_e(c), _ev(initialValue), acc, x, merged,
                                   fvar, fbody))


def zip_with(a, b, f) -> Column:
    (x, y), body = _lambda(f, "x", "y")
    return Column(E.ZipWith(_e(a), _e(b), x, y, body))


def struct(*cols) -> Column:
    exprs = [_e(c) for c in cols]
    names = [getattr(e, "name", None) or f"col{i + 1}"
             for i, e in enumerate(exprs)]
    return Column(E.CreateStruct(names, *exprs))


def named_struct(*name_col_pairs) -> Column:
    if len(name_col_pairs) % 2:
        raise ValueError("named_struct needs alternating name, column")
    names = [str(n) for n in name_col_pairs[0::2]]
    return Column(E.CreateStruct(names,
                                 *[_e(c) for c in name_col_pairs[1::2]]))


def create_map(*cols) -> Column:
    return Column(E.CreateMap(*[_e(c) for c in cols]))


def map_from_arrays(keys, values) -> Column:
    return Column(E.MapFromArrays(_e(keys), _e(values)))


def map_keys(c) -> Column:
    return Column(E.MapKeys(_e(c)))


def map_values(c) -> Column:
    return Column(E.MapValues(_e(c)))


def collect_list(c) -> Column:
    return Column(A.CollectList(_e(c)))


def collect_set(c) -> Column:
    return Column(A.CollectSet(_e(c)))


__all__ += [
    "hash", "xxhash64", "approx_count_distinct", "input_file_name", "rand",
    "randn", "monotonically_increasing_id", "spark_partition_id", "array",
    "split", "size", "element_at", "array_contains", "array_max",
    "array_min", "sort_array", "array_distinct", "slice", "array_position",
    "explode", "posexplode", "transform", "filter", "exists", "forall",
    "aggregate", "zip_with", "struct", "named_struct", "create_map",
    "map_from_arrays", "map_keys", "map_values", "collect_list",
    "collect_set",
]
