"""Expression and aggregate breadth of the port against ``spark_tpu``: the
math, string and date expressions (one case each, on the reference's
interpreted numpy lane), the statistical aggregates and ROLLUP / CUBE /
GROUPING SETS with ``grouping()`` / ``grouping_id()`` (single-device and
at 4 shards of the port's mesh lane, against the reference's single
shard).

Inputs are made with numpy from a seed and go into both packages as the
same bits (``spark_tpu_torch.testing``): NULLs in every column, NaN in
the doubles, a string column whose dictionary is empty, dead rows.
Integers, dictionaries, codes and validity masks must be equal exactly;
doubles within ``FLOAT_RTOL`` = 1e-12 (torch's and numpy's elementwise
math differ in the last bits), aggregates within ``AGG_RTOL`` = 1e-9
(another summation order).  The reference's faults the port does not
share are held as both outcomes (ROADMAP §3).
"""

import decimal
import math

import numpy as np
import pytest

from spark_tpu import expressions as RE
from spark_tpu import kernels as RK
from spark_tpu import types as RT
from spark_tpu.columnar import ColumnBatch as RBatch
from spark_tpu.columnar import ColumnVector as RVector
from spark_tpu.sql import functions as RF
from spark_tpu_torch import config as TC
from spark_tpu_torch import expressions as TE
from spark_tpu_torch import kernels as TK
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql import logical as TL
from spark_tpu_torch.sql.dataframe import DataFrame as TDataFrame
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import (assert_parts_equal, assert_rows_equal,
                                     batch_parts, from_parts)

FLOAT_RTOL = 1e-12
AGG_RTOL = 1e-9
SHARDS = "spark.tpu.mesh.shards"

WORDS = ("", "  Apple pie ", "KIWI", "banana split", "lime", "Pear",
         "plum-7", "x1y22z333")
DAY0 = 10_957                         # 2000-01-01


def _pair(seed=3, n=100, cap=128):
    """A reference batch and the port's batch holding the same bits."""
    rng = np.random.default_rng(seed)

    def nulls(p=0.15):
        return rng.random(cap) > p

    i = rng.integers(-50, 50, cap).astype(np.int64)
    j = rng.integers(-5, 6, cap).astype(np.int32)
    f = rng.normal(0, 3, cap)
    f[rng.random(cap) < 0.1] = np.nan
    g = rng.normal(0, 30, cap)                   # no NaN: floor/ceil/rint
    s = rng.integers(0, len(WORDS), cap).astype(np.int32)
    s2 = rng.integers(0, 3, cap).astype(np.int32)
    empty = np.full(cap, -1, np.int32)
    days = (DAY0 + rng.integers(-4000, 4000, cap)).astype(np.int32)
    us = days.astype(np.int64) * 86_400_000_000 \
        + rng.integers(0, 86_400_000_000, cap)
    rv = np.zeros(cap, bool)
    rv[:n] = True
    rv[rng.random(cap) < 0.05] = False
    cols = [("i", "bigint", i, nulls(), None),
            ("j", "int", j, None, None),
            ("f", "double", f, nulls(), None),
            ("g", "double", g, nulls(), None),
            ("s", "string", s, nulls(), WORDS),
            ("s2", "string", s2, nulls(), ("a", "b", "c")),
            ("e", "string", empty, np.zeros(cap, bool), ()),
            ("dt", "date", days, nulls(), None),
            ("ts", "timestamp", us, nulls(), None)]
    vecs = [RVector(d, RT.type_for_name(t), v, dic)
            for _n, t, d, v, dic in cols]
    ref = RBatch([c[0] for c in cols], vecs, rv, cap)
    return ref, from_parts(batch_parts(ref))


def _c(E, name):
    return E.Col(name)


def _lit(E, v):
    return E.Literal(v)


#: one expression per case, built from either package's expression module
MATH = {
    "pow": lambda E: E.Pow(_c(E, "f"), _lit(E, 2)),
    "pow_int": lambda E: E.Pow(_c(E, "j"), _c(E, "i")),
    **{f"unary_{fn}": (lambda fn: lambda E: E.UnaryMath(
        fn, _c(E, "g" if fn in ("floor", "ceil", "rint") else "f")))(fn)
       for fn in ("sqrt", "exp", "ln", "log10", "log2", "sin", "cos", "tan",
                  "asin", "acos", "atan", "sinh", "cosh", "tanh", "floor",
                  "ceil", "abs", "sign", "radians", "degrees", "log1p",
                  "expm1", "cbrt", "rint")},
    "abs_int": lambda E: E.UnaryMath("abs", _c(E, "i")),
    "sign_int": lambda E: E.UnaryMath("sign", _c(E, "j")),
    "round_2": lambda E: E.RoundExpr(_c(E, "g"), 2),
    "round_0_nan": lambda E: E.RoundExpr(_c(E, "f"), 0),
    "round_int": lambda E: E.RoundExpr(_c(E, "i"), 1),
    "isnan": lambda E: E.IsNaN(_c(E, "f")),
    "isnan_int": lambda E: E.IsNaN(_c(E, "i")),
    "greatest": lambda E: E.Greatest(_c(E, "i"), _c(E, "j"), _lit(E, 3)),
    "least": lambda E: E.Least(_c(E, "g"), _c(E, "i")),
    "hypot": lambda E: E.BinaryMath("hypot", _c(E, "f"), _c(E, "i")),
    "atan2": lambda E: E.BinaryMath("atan2", _c(E, "f"), _c(E, "j")),
    "nanvl": lambda E: E.BinaryMath("nanvl", _c(E, "f"), _lit(E, 0.5)),
}

STRINGS = {
    **{f"transform_{fn}": (lambda fn: lambda E: E.StringTransform(
        fn, _c(E, "s")))(fn)
       for fn in ("upper", "lower", "trim", "ltrim", "rtrim", "reverse",
                  "initcap")},
    "upper_empty_dictionary": lambda E: E.StringTransform("upper",
                                                          _c(E, "e")),
    "substr_2_3": lambda E: E.Substring(_c(E, "s"), 2, 3),
    "substr_0_2": lambda E: E.Substring(_c(E, "s"), 0, 2),
    "substr_neg_3_2": lambda E: E.Substring(_c(E, "s"), -3, 2),
    "substr_neg_20_4": lambda E: E.Substring(_c(E, "s"), -20, 4),
    "substr_empty_dictionary": lambda E: E.Substring(_c(E, "e"), 1, 2),
    "length": lambda E: E.StringLength(_c(E, "s")),
    "length_empty_dictionary": lambda E: E.StringLength(_c(E, "e")),
    "concat": lambda E: E.Concat(_c(E, "s2"), _lit(E, "-"), _c(E, "s")),
    "regexp_replace": lambda E: E.ParamStringTransform(
        "regexp_replace", _c(E, "s"), ("[0-9]+", "#")),
    "regexp_extract": lambda E: E.ParamStringTransform(
        "regexp_extract", _c(E, "s"), ("([a-z]+)([0-9]*)", 2)),
    "lpad": lambda E: E.ParamStringTransform("lpad", _c(E, "s"), (6, "*")),
    "rpad": lambda E: E.ParamStringTransform("rpad", _c(E, "s"), (4, "")),
    "translate": lambda E: E.ParamStringTransform("translate", _c(E, "s"),
                                                  ("aei", "AE")),
    "repeat": lambda E: E.ParamStringTransform("repeat", _c(E, "s2"), (3,)),
    **{f"param_{kind}": (lambda kind: lambda E: E.ParamStringTransform(
        kind, _c(E, "s"), (256,) if kind == "sha2" else ()))(kind)
       for kind in ("soundex", "md5", "sha1", "sha2", "base64", "hex")},
    "instr": lambda E: E.StringToInt("instr", _c(E, "s"), ("i",)),
    "locate": lambda E: E.StringToInt("locate", _c(E, "s"), ("p", 3)),
    "levenshtein": lambda E: E.StringToInt("levenshtein", _c(E, "s"),
                                           ("kitten",)),
    "crc32": lambda E: E.StringToInt("crc32", _c(E, "s")),
}

DATES = {
    **{f"{part}_ts": (lambda part: lambda E: E.ExtractDatePart(
        part, _c(E, "ts")))(part)
       for part in ("year", "month", "day", "dayofweek", "dayofyear",
                    "quarter", "hour", "minute", "second", "weekofyear")},
    **{f"{part}_date": (lambda part: lambda E: E.ExtractDatePart(
        part, _c(E, "dt")))(part)
       for part in ("year", "month", "day", "dayofweek", "dayofyear",
                    "quarter", "weekofyear")},
    "date_add": lambda E: E.DateArith("date_add", _c(E, "dt"), _c(E, "j")),
    "date_sub": lambda E: E.DateArith("date_sub", _c(E, "ts"), _lit(E, 45)),
    "datediff": lambda E: E.DateArith("datediff", _c(E, "dt"), _c(E, "ts")),
    "add_months": lambda E: E.DateArith("add_months", _c(E, "dt"),
                                        _c(E, "i")),
    "months_between": lambda E: E.DateArith("months_between", _c(E, "dt"),
                                            _c(E, "ts")),
    "last_day": lambda E: E.DateArith("last_day", _c(E, "dt")),
    "next_day": lambda E: E.NextDay(_c(E, "dt"), "wed"),
    **{f"trunc_{fmt}": (lambda fmt: lambda E: E.TruncDate(
        _c(E, "ts" if fmt == "week" else "dt"), fmt))(fmt)
       for fmt in ("year", "month", "week", "quarter")},
    "unix_timestamp_ts": lambda E: E.UnixTimestamp(_c(E, "ts")),
    "unix_timestamp_date": lambda E: E.UnixTimestamp(_c(E, "dt")),
    "from_unixtime": lambda E: E.UnixTimestamp(_c(E, "i"), inverse=True),
}

EXPRESSIONS = {**MATH, **STRINGS, **DATES}


@pytest.mark.parametrize("name", list(EXPRESSIONS))
def test_expression(name):
    """One expression over the same batch in both packages: names, types,
    row mask, validity, data; string results with the same re-sorted
    dictionary and the same codes."""
    ref, got = _pair()
    build = EXPRESSIONS[name]
    r = RK.apply_project(np, ref, [RE.Alias(build(RE), "out")])
    g = TK.apply_project(got, [TE.Alias(build(TE), "out")])
    rp, gp = batch_parts(r.to_host()), batch_parts(g)
    assert_parts_equal(rp, gp, rtol=FLOAT_RTOL)
    if rp.dictionaries[0] is not None:
        assert rp.dictionaries[0] == gp.dictionaries[0]
        live = ref.row_valid & np.asarray(rp.valids[0] if rp.valids[0]
                                          is not None else True)
        assert np.array_equal(np.asarray(rp.datas[0])[live],
                              np.asarray(gp.datas[0])[live])


# ---------------------------------------------------------------------------
# statistical aggregates, single-device and at 4 shards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


def _stats_table(seed=5, n=400):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 7, n)
    v = np.round(rng.normal(10, 4, n), 3)
    w = rng.integers(-1000, 1000, n)
    return {"k": [None if x == 6 else int(x) for x in k],
            "v": [None if rng.random() < 0.1 else float(x) for x in v],
            "w": [int(x) for x in w],
            "c": [("north", "south", "east")[x % 3] if x != 5 else None
                  for x in rng.integers(0, 6, n)]}


def _frames(spark, tspark, data, schema=None):
    rdf = spark.createDataFrame(data, schema=schema)
    parts = batch_parts(rdf._plan.batch.to_host())
    return rdf, TDataFrame(tspark, TL.LocalRelation(from_parts(parts)))


def _collect_at(tspark, df, shards):
    tspark.conf.set(SHARDS, str(shards))
    try:
        return df.collect()
    finally:
        tspark.conf.set(SHARDS, "1")


STATS = {
    "var_samp": lambda F: [F.var_samp("v"), F.variance("w")],
    "var_pop": lambda F: [F.var_pop("v"), F.var_pop("w")],
    "stddev_samp": lambda F: [F.stddev_samp("v"), F.stddev("w")],
    "stddev_pop": lambda F: [F.stddev_pop("v"), F.stddev_pop("w")],
    "percentile_approx": lambda F: [F.percentile_approx("v", 0.25),
                                    F.percentile_approx("v", 0.9),
                                    F.median("w"),
                                    F.percentile_approx("w", 0.0)],
}


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("keyed", [True, False], ids=["grouped", "global"])
@pytest.mark.parametrize("name", list(STATS))
def test_statistical_aggregate(spark, tspark, name, keyed, shards):
    rdf, tdf = _frames(spark, tspark, _stats_table())

    def query(df, F):
        aggs = [a.alias(f"a{i}") for i, a in enumerate(STATS[name](F))]
        return df.groupBy("k").agg(*aggs) if keyed else df.agg(*aggs)

    ref = query(rdf, RF).collect()
    got = _collect_at(tspark, query(tdf, TF), shards)
    assert_rows_equal(ref, got, rtol=AGG_RTOL, ordered=False)


def test_float_segment_sums_depend_only_on_the_segment():
    """The same values in the same order sum to the same double wherever
    their segment lies (another offset, other neighbours): a ROLLUP level
    whose only child holds the same rows ties with it, as in sqlite.  On a
    card ``index_add_``'s atomics break this (TPC-DS q67's ranks)."""
    import torch
    rng = np.random.default_rng(4)
    parts, seg, sid = [], [], 0
    for rep in range(2):
        if rep:                                   # a different alignment
            parts.append(rng.normal(0, 1e3, 7))
            seg += [sid] * 7
            sid += 1
        vals = np.random.default_rng(5)
        for n in (1, 3, 33, 1000, 4097):
            parts.append(np.round(vals.normal(0, 1e4, n), 2) * 1.37)
            seg += [sid] * n
            sid += 1
    out = TK.segment_reduce(torch.from_numpy(np.concatenate(parts)),
                            torch.tensor(seg), sid, "sum").numpy()
    assert np.array_equal(out[:5], out[6:])
    ref = [math.fsum(p) for p in parts[:5]]
    assert np.allclose(out[:5], ref, rtol=AGG_RTOL, atol=0.0)


def test_stddev_of_a_decimal_column_reference_fault(spark, tspark):
    """stddev_samp over a decimal(7,2) column: the port takes the values
    (Spark's answer), the reference the held integers, 100 times larger
    (ROADMAP §3: ``aggregates.VarianceBase``)."""
    schema = RT.StructType([RT.StructField("d", RT.DecimalType(7, 2))])
    data = {"d": [decimal.Decimal("1.25"), decimal.Decimal("2.50"),
                  decimal.Decimal("4.00")]}
    rdf = spark.createDataFrame(data, schema=schema)
    tdf = TDataFrame(tspark, TL.LocalRelation(from_parts(batch_parts(
        rdf._plan.batch.to_host()))))
    want = float(np.std([1.25, 2.5, 4.0], ddof=1))
    (ref,), = rdf.agg(RF.stddev_samp("d")).collect()
    (got,), = tdf.agg(TF.stddev_samp("d")).collect()
    assert got == pytest.approx(want, rel=AGG_RTOL)
    assert ref == pytest.approx(100 * want, rel=AGG_RTOL)


# ---------------------------------------------------------------------------
# grouping sets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def views(spark, tspark):
    rdf, tdf = _frames(spark, tspark, _stats_table(seed=9))
    rdf.createOrReplaceTempView("gs")
    tdf.createOrReplaceTempView("gs")
    yield
    spark.catalog.dropTempView("gs")
    tspark.catalog.dropTempView("gs")


GROUPING_SETS = {
    "rollup": "SELECT k, c, SUM(w) AS s, COUNT(*) AS n, "
              "grouping_id() AS gid FROM gs GROUP BY ROLLUP(k, c)",
    "rollup_grouping": "SELECT c, k, grouping(c) + grouping(k) AS lvl, "
                       "AVG(v) AS a FROM gs GROUP BY ROLLUP(c, k)",
    "cube": "SELECT k, c, MAX(w) AS m, grouping(k) AS gk, grouping(c) AS gc, "
            "grouping_id() AS gid FROM gs GROUP BY CUBE(k, c)",
    "cube_having": "SELECT k, c, SUM(w) AS s FROM gs GROUP BY CUBE(k, c) "
                   "HAVING SUM(w) > 0",
    "grouping_sets": "SELECT k, c, MIN(v) AS lo, grouping_id() AS gid "
                     "FROM gs GROUP BY GROUPING SETS ((k, c), (c), ())",
    "rollup_stats": "SELECT c, STDDEV_SAMP(v) AS sd, VAR_POP(w) AS vp "
                    "FROM gs GROUP BY ROLLUP(c)",
    "rollup_order_limit": "SELECT k, SUM(w) AS s FROM gs GROUP BY ROLLUP(k) "
                          "ORDER BY k NULLS LAST LIMIT 5",
}


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("name", list(GROUPING_SETS))
def test_grouping_sets(spark, tspark, views, name, shards):
    sql = GROUPING_SETS[name]
    ref = spark.sql(sql).collect()
    got = _collect_at(tspark, tspark.sql(sql), shards)
    assert len(ref) > 0
    assert_rows_equal(ref, got, rtol=AGG_RTOL,
                      ordered="ORDER BY" in sql)


# ---------------------------------------------------------------------------
# faults of the reference the port does not share (ROADMAP §3)
# ---------------------------------------------------------------------------

def test_round_of_a_decimal_reference_fault(spark, tspark):
    """round(CAST(1.255 AS DECIMAL(7,3)), 2): the port rounds HALF_UP to a
    decimal(7,2), 1.26, as Spark does; the reference returns the decimal
    unchanged, 1.255 (``expressions.RoundExpr``)."""
    sql = "SELECT round(CAST(1.255 AS DECIMAL(7,3)), 2) AS r"
    (ref,), = spark.sql(sql).collect()
    tdf = tspark.sql(sql)
    (got,), = tdf.collect()
    assert float(ref) == 1.255
    assert float(got) == 1.26
    assert tdf.schema["r"].dataType == TE.T.DecimalType(7, 2)


@pytest.mark.parametrize("fn,want", [("floor", 1), ("ceil", 2),
                                     ("sqrt", 1.25 ** 0.5)])
def test_math_of_a_decimal_reference_fault(spark, tspark, fn, want):
    """floor / ceil / sqrt of a decimal(7,2): the port takes the value,
    the reference the held integer (125), so it answers 125, 125 and
    sqrt(125) (``expressions.UnaryMath``)."""
    sql = f"SELECT {fn}(CAST(1.25 AS DECIMAL(7,2))) AS r"
    (ref,), = spark.sql(sql).collect()
    (got,), = tspark.sql(sql).collect()
    assert got == pytest.approx(want, rel=FLOAT_RTOL)
    held = {"floor": 125, "ceil": 125, "sqrt": 125 ** 0.5}[fn]
    assert ref == pytest.approx(held, rel=FLOAT_RTOL)


def test_concat_with_an_empty_dictionary_reference_fault():
    """concat(s2, e) where e is NULL on every row (an empty dictionary):
    the port answers NULL on every row, as Spark does; the reference
    indexes its (1, 1) remap table with s2's codes and raises IndexError
    (``expressions.Concat``)."""
    ref, got = _pair()
    with pytest.raises(IndexError):
        RK.apply_project(np, ref, [RE.Alias(
            RE.Concat(RE.Col("s2"), RE.Col("e")), "out")])
    g = TK.apply_project(got, [TE.Alias(
        TE.Concat(TE.Col("s2"), TE.Col("e")), "out")])
    out = g.column("out")
    assert out.dictionary == ()
    assert not bool(out.valid.any())


def test_greatest_of_a_decimal_and_an_integer_reference_fault(spark, tspark):
    """greatest(CAST(1.25 AS DECIMAL(7,2)), 2): the port compares values and
    answers 2.00; the reference compares the held integer 125 with 2 and
    answers 1.25 (``expressions.Greatest``)."""
    sql = "SELECT greatest(CAST(1.25 AS DECIMAL(7,2)), 2) AS r"
    (ref,), = spark.sql(sql).collect()
    (got,), = tspark.sql(sql).collect()
    assert float(got) == 2.0
    assert float(ref) == 1.25


# ---------------------------------------------------------------------------
# the texts chip_smoke.py's [breadth] phase runs on the card, at a small size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def breadth_tables(tspark):
    from spark_tpu_torch import types as TT
    from spark_tpu_torch.testing import (hash_agg_table, q3_tables,
                                         register_sql_tables)
    tables = q3_tables(n_sales=8_000, n_items=3000, n_dates=3000)
    hash_table = hash_agg_table(4096, 64)
    session = tspark.newSession()
    register_sql_tables(session, hash_table, tables, TT)
    return session, tables, hash_table


@pytest.mark.parametrize("lane", ["graph", "eager", "mesh x4"])
@pytest.mark.parametrize("name", ["rollup", "window", "string keys",
                                  "statistics"])
def test_breadth_query_matches_oracle(breadth_tables, name, lane):
    """Each text of ``testing.BREADTH_QUERIES`` against its numpy oracle
    (integers and decimals exactly, the statistics within their stated
    rtol) on the graph lane, the eager lane and 4 shards of the mesh
    lane."""
    from spark_tpu_torch.testing import BREADTH_QUERIES, breadth_rows_match
    session, tables, hash_table = breadth_tables
    sql, oracle, approx, rtol = BREADTH_QUERIES[name]
    conf = {"eager": {"spark.sql.codegen.wholeStage": "false"},
            "mesh x4": {SHARDS: "4"}}.get(lane, {})
    for k, v in conf.items():
        session.conf.set(k, v)
    try:
        got = [tuple(r) for r in session.sql(sql).collect()]
    finally:
        for k in conf:
            session.conf.unset(k)
    want = oracle(tables, hash_table)
    assert len(want) > 0
    assert breadth_rows_match(got, want, approx, rtol), (got[:3], want[:3])
