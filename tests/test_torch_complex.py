"""Arrays, maps and structs, collect_list / collect_set, explode, the
higher-order functions, rand / sample and the DataFrame NA methods of the
port against ``spark_tpu``.

Inputs are made with numpy from a seed and go into both packages as the
same bits (``spark_tpu_torch.testing``): array planes with ragged rows,
NULL arrays, NaN-padded doubles, string codes, dead rows.  Integers,
codes, ``rand`` bits, row ids and element order must be equal exactly;
doubles within ``FLOAT_RTOL`` = 1e-12 (``randn``'s log and cos: torch's
and numpy's elementwise math differ in the last bits).  The texts of
``testing.COMPLEX_QUERIES`` run against their numpy oracles on the eager,
per-operator and graph lanes.  The reference's faults the port does not
share are held as both outcomes (ROADMAP §3).
"""

import numpy as np
import pytest

from spark_tpu import expressions as RE
from spark_tpu import kernels as RK
from spark_tpu import types as RT
from spark_tpu.columnar import ColumnBatch as RBatch
from spark_tpu.columnar import ColumnVector as RVector
from spark_tpu.sql import functions as RF
from spark_tpu.sql import parser as RP
from spark_tpu_torch import config as TC
from spark_tpu_torch import expressions as TE
from spark_tpu_torch import kernels as TK
from spark_tpu_torch import testing as TT
from spark_tpu_torch import types as TTypes
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql import logical as TL
from spark_tpu_torch.sql import parser as TP
from spark_tpu_torch.sql import stagecompile as TSC
from spark_tpu_torch.sql.dataframe import DataFrame as TDataFrame
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import (assert_parts_equal, assert_rows_equal,
                                     batch_parts, from_parts)

from test_torch_stagecompile import _trap_host_syncs

FLOAT_RTOL = 1e-12
SHARDS = "spark.tpu.mesh.shards"
MAX_LEN = "spark.tpu.collect.maxArrayLen"

WORDS = ("apple pie", "banana-split", "kiwi", "lime", "pear tree top", "plum")
WIDTH = 6


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


@pytest.fixture(scope="module", autouse=True)
def _drop_reference_views(spark):
    """The temp views this file registers on the conftest's shared
    reference session are dropped at its end: a worker runs other files
    on that session after this one, and a view ``t`` shadows their
    tables of that name (tests/test_catalog.py's ``db1.t``)."""
    before = set(spark.catalog._views)
    yield
    for name in set(spark.catalog._views) - before:
        spark.catalog.dropTempView(name)


def _pair(seed=5, n=100, cap=128):
    """A reference batch holding array planes and the port's batch of the
    same bits."""
    rng = np.random.default_rng(seed)
    i64, i32 = np.iinfo(np.int64).min, np.iinfo(np.int32).min

    def plane(width, dtype, sent, draw):
        lens = rng.integers(0, width + 1, cap)
        out = np.full((cap, width), sent, dtype)
        for r in range(cap):
            out[r, :lens[r]] = draw(lens[r])
        return out

    a = plane(WIDTH, np.int64, i64, lambda k: rng.integers(-5, 6, k))
    b = plane(4, np.int32, i32, lambda k: rng.integers(0, 9, k))
    f = plane(WIDTH, np.float64, np.nan,
              lambda k: np.round(rng.normal(0, 1, k), 1))
    s = plane(WIDTH, np.int32, -1, lambda k: rng.integers(0, len(WORDS), k))
    i = rng.integers(-50, 50, cap).astype(np.int64)
    j = rng.integers(-7, 8, cap).astype(np.int32)
    t = rng.integers(0, len(WORDS), cap).astype(np.int32)
    rv = np.zeros(cap, bool)
    rv[:n] = True
    rv[rng.random(cap) < 0.05] = False

    def nulls(p=0.1):
        return rng.random(cap) > p

    cols = [("a", "array<bigint>", a, nulls(), None),
            ("b", "array<int>", b, None, None),
            ("f", "array<double>", f, None, None),
            ("s", "array<string>", s, nulls(), WORDS),
            ("i", "bigint", i, nulls(), None),
            ("j", "int", j, None, None),
            ("t", "string", t, nulls(), WORDS)]
    vecs = [RVector(d, _rtype(ty), v, dic) for _n, ty, d, v, dic in cols]
    ref = RBatch([c[0] for c in cols], vecs, rv, cap)
    return ref, from_parts(batch_parts(ref))


def _rtype(name):
    if name.startswith("array<"):
        return RT.ArrayType(RT.type_for_name(name[6:-1]))
    return RT.type_for_name(name)


def _c(E, name):
    return E.Col(name)


def _lit(E, v):
    return E.Literal(v)


def _hof(cls, arr, body, **kw):
    """A one-variable higher-order function built in either package."""
    def build(E):
        var = E.LambdaVar("x")
        return getattr(E, cls)(_c(E, arr), var, body(E, var), **kw)
    return build


def _aggregate(finish):
    def build(E):
        acc, x = E.LambdaVar("acc"), E.LambdaVar("x")
        fv = E.LambdaVar("acc") if finish else None
        fb = E.Mul(fv, _lit(E, 2)) if finish else None
        return E.ArrayAggregate(_c(E, "a"), _lit(E, 0), acc, x,
                                E.Add(acc, x), fv, fb)
    return build


def _zip_with(E):
    x, y = E.LambdaVar("x"), E.LambdaVar("y")
    return E.ZipWith(_c(E, "a"), _c(E, "b"), x, y, E.Add(x, y))


#: one expression per case, built from either package's expression module
EXPRESSIONS = {
    "make_array": lambda E: E.MakeArray(_c(E, "i"), _c(E, "j"), _lit(E, 3)),
    "make_array_strings": lambda E: E.MakeArray(_c(E, "t"), _lit(E, "zz"),
                                                _c(E, "t")),
    "split": lambda E: E.SplitStr(_c(E, "t"), " "),
    "split_limit": lambda E: E.SplitStr(_c(E, "t"), "[ -]", 2),
    **{f"size_{c}": (lambda c: lambda E: E.ArraySize(_c(E, c)))(c)
       for c in "abfs"},
    **{f"element_at_{c}_{k}": (lambda c, k: lambda E: E.ElementAt(
        _c(E, c), k))(c, k)
       for c, k in (("a", 2), ("a", -1), ("a", -9), ("a", 7), ("s", 1),
                    ("f", 3))},
    **{f"array_{op}_{c}": (lambda c, op: lambda E: E.ArrayReduce(
        _c(E, c), op))(c, op)
       for c in "afs" for op in ("max", "min")},
    **{f"sort_{'asc' if asc else 'desc'}_{c}": (
        lambda c, asc: lambda E: E.SortArray(_c(E, c), asc))(c, asc)
       for c in "afs" for asc in (True, False)},
    **{f"distinct_{c}": (lambda c: lambda E: E.ArrayDistinct(_c(E, c)))(c)
       for c in "afs"},
    **{f"slice_{s}_{n}": (lambda s, n: lambda E: E.ArraySlice(
        _c(E, "a"), s, n))(s, n)
       for s, n in ((2, 3), (-2, 5), (-20, 2), (1, 0))},
    "position_a": lambda E: E.ArrayPosition(_c(E, "a"), 3),
    "position_s": lambda E: E.ArrayPosition(_c(E, "s"), "lime"),
    "transform_add": _hof("ArrayTransform", "a",
                          lambda E, x: E.Add(x, _lit(E, 1))),
    "transform_mul_float": _hof("ArrayTransform", "a",
                                lambda E, x: E.Mul(x, _lit(E, 2.5))),
    "transform_to_bool": _hof("ArrayTransform", "a",
                              lambda E, x: E.GT(x, _lit(E, 0))),
    "transform_f": _hof("ArrayTransform", "f",
                        lambda E, x: E.Sub(x, _lit(E, 1.0))),
    "filter_a": _hof("ArrayFilterFn", "a", lambda E, x: E.GT(x, _lit(E, 0))),
    "filter_f": _hof("ArrayFilterFn", "f",
                     lambda E, x: E.LT(x, _lit(E, 0.5))),
    "exists_a": _hof("ArrayExists", "a", lambda E, x: E.EQ(x, _lit(E, 4))),
    "forall_a": _hof("ArrayExists", "a", lambda E, x: E.GT(x, _lit(E, -3)),
                     require_all=True),
    "aggregate": _aggregate(False),
    "aggregate_finish": _aggregate(True),
    "zip_with": _zip_with,
    "contains_a": lambda E: E.ArrayContains(_c(E, "a"), 3),
    "contains_fraction": lambda E: E.ArrayContains(_c(E, "a"), 1.5),
    "contains_s": lambda E: E.ArrayContains(_c(E, "s"), "lime"),
    "contains_s_missing": lambda E: E.ArrayContains(_c(E, "s"), "nope"),
    "gather": lambda E: E.ArrayGather(_c(E, "a"), _c(E, "j")),
}


@pytest.mark.parametrize("name", list(EXPRESSIONS))
def test_expression(name):
    """One expression over the same batch in both packages: names, types,
    row mask, validity, data (2-D for an array: every slot, sentinels
    included, so element order and the live prefix are held too); string
    results with the same dictionary and codes."""
    ref, got = _pair()
    build = EXPRESSIONS[name]
    r = RK.apply_project(np, ref, [RE.Alias(build(RE), "out")])
    g = TK.apply_project(got, [TE.Alias(build(TE), "out")])
    rp, gp = batch_parts(r.to_host()), batch_parts(g)
    assert_parts_equal(rp, gp)
    assert rp.dictionaries == gp.dictionaries


@pytest.mark.parametrize("offset", [0, 5 << 33, (3 << 48) + (2 << 33)])
def test_row_ids_and_draws_bit_for_bit(offset):
    """monotonically_increasing_id, rand and spark_partition_id equal the
    reference bit for bit at an operator's and a shard's row offset;
    randn within FLOAT_RTOL (and 1e-15 absolute near its zeros)."""
    ref, got = _pair()
    exact = lambda E: [E.Alias(E.RowIndex(), "id"),  # noqa: E731
                       E.Alias(E.Rand(7), "r"), E.Alias(E.Rand(-3), "r2"),
                       E.Alias(E.SparkPartitionId(), "p")]
    r = RK.apply_project(np, ref, exact(RE), offset)
    g = TK.apply_project(got, exact(TE), offset)
    assert_parts_equal(batch_parts(r.to_host()), batch_parts(g),
                       live_only=False)
    assert np.array_equal(batch_parts(g).datas[1],
                          TT.rand_oracle(128, 7, offset))
    r = RK.apply_project(np, ref, [RE.Alias(RE.Randn(7), "n")], offset)
    g = TK.apply_project(got, [TE.Alias(TE.Randn(7), "n")], offset)
    a, b = np.asarray(r.vectors[0].data), g.vectors[0].data.numpy()
    assert np.allclose(a, b, rtol=FLOAT_RTOL, atol=1e-15)
    assert np.allclose(b, TT.randn_oracle(128, 7, offset), rtol=FLOAT_RTOL,
                       atol=1e-15)


# ---------------------------------------------------------------------------
# the DataFrame and SQL surface
# ---------------------------------------------------------------------------

def _table(seed=3, n=300):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 9, n)
    v = rng.integers(0, 12, n)
    return {"k": [None if x == 8 else int(x) for x in k],
            "v": [None if rng.random() < 0.15 else int(x) for x in v],
            "w": [float(x) for x in np.round(rng.normal(0, 2, n), 2)],
            "c": [("north", "south", "east")[x % 3] if x != 4 else None
                  for x in rng.integers(0, 6, n)]}


def _frames(spark, tspark, data=None):
    rdf = spark.createDataFrame(data or _table())
    parts = batch_parts(rdf._plan.batch.to_host())
    return rdf, TDataFrame(tspark, TL.LocalRelation(from_parts(parts)))


def _collect_at(tspark, df, shards):
    tspark.conf.set(SHARDS, str(shards))
    try:
        return df.collect()
    finally:
        tspark.conf.set(SHARDS, "1")


@pytest.fixture
def max_len(spark, tspark):
    """Sets ``spark.tpu.collect.maxArrayLen`` in both sessions."""
    def set_(n):
        spark.conf.set(MAX_LEN, str(n))
        tspark.conf.set(MAX_LEN, str(n))
    yield set_
    spark.conf.unset(MAX_LEN)
    tspark.conf.unset(MAX_LEN)


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("cap", [128, 3], ids=["whole", "truncated"])
@pytest.mark.parametrize("keyed", [True, False], ids=["grouped", "global"])
def test_collect_list_and_set(spark, tspark, max_len, keyed, cap, shards):
    """collect_list keeps each group's non-null values in row order,
    collect_set its distinct ones in value order; both skip NULLs and
    truncate at spark.tpu.collect.maxArrayLen.  At 4 shards the port
    gathers the rows to one shard (K2's gather)."""
    max_len(cap)
    rdf, tdf = _frames(spark, tspark)

    def query(df, F):
        aggs = [F.collect_list("v").alias("l"), F.collect_set("v").alias("s"),
                F.collect_list("c").alias("lc"), F.count("v").alias("n")]
        return df.groupBy("k").agg(*aggs).orderBy("k") if keyed \
            else df.agg(*aggs)

    ref = query(rdf, RF).collect()
    got = _collect_at(tspark, query(tdf, TF), shards)
    assert_rows_equal(ref, got)
    assert max(len(r.l) for r in got) == min(cap, max(r.n for r in got))


def test_explode_and_posexplode(spark, tspark):
    """explode / posexplode of collected lists: the rows, the position
    column, and the element columns' values equal the reference's."""
    rdf, tdf = _frames(spark, tspark)

    def query(df, F, pos):
        lists = df.groupBy("k").agg(F.collect_list("v").alias("l"))
        gen = F.posexplode("l") if pos else F.explode("l")
        return lists.select(gen, "k").orderBy("k")

    for pos in (False, True):
        assert_rows_equal(query(rdf, RF, pos).collect(),
                          query(tdf, TF, pos).collect())


def test_explode_select_position_reference_fault(spark, tspark):
    """``SELECT k, explode(l) AS item``: the port puts the generated column
    at its place in the select list, (k, item), as Spark does; the
    reference puts it first, (item, k) — ``spark_tpu/sql/analyzer.py``
    ``_rewrite_explode`` finds the marker with ``list.index``, whose
    ``==`` builds an EQ expression, which is truthy, so every index is 0.
    The rows agree up to that order."""
    sql = ("SELECT k, explode(l) AS item FROM (SELECT k, collect_list(v) "
           "AS l FROM t GROUP BY k) s ORDER BY k, item")
    rdf, tdf = _frames(spark, tspark)
    rdf.createOrReplaceTempView("t")
    tdf.createOrReplaceTempView("t")
    ref, got = spark.sql(sql).collect(), tspark.sql(sql).collect()
    assert spark.sql(sql).columns == ["item", "k"]
    assert tspark.sql(sql).columns == ["k", "item"]
    assert [(r[1], r[0]) for r in ref] == [tuple(r) for r in got]


SQL_TEXTS = {
    "arrays": "SELECT k, size(l) AS n, sort_array(l, false) AS d, "
              "element_at(l, -2) AS e, array_contains(l, 3) AS h, "
              "array_distinct(l) AS u, slice(l, 2, 2) AS sl, "
              "array_position(l, 5) AS p, array_min(l) AS mn "
              "FROM (SELECT k, collect_list(v) AS l FROM t GROUP BY k) s "
              "ORDER BY k",
    "higher-order": "SELECT k, transform(l, x -> x * 10) AS tr, "
                    "filter(l, x -> x % 2 = 0) AS ev, "
                    "exists(l, x -> x > 10) AS ex, "
                    "forall(l, x -> x >= 0) AS fa, "
                    "aggregate(l, 0, (acc, x) -> acc + x) AS sm, "
                    "aggregate(l, 0, (acc, x) -> acc + x, acc -> acc * 2) "
                    "AS sm2, zip_with(l, l, (x, y) -> x * y) AS sq "
                    "FROM (SELECT k, collect_list(v) AS l FROM t "
                    "GROUP BY k) s ORDER BY k",
    "maps and structs": "SELECT k, named_struct('a', k, 'b', v) AS st, "
                        "struct(k, w) AS st2, map(k, v) AS m, "
                        "map_keys(map(k, v, 99, 1)) AS mk, "
                        "element_at(map(k, v, 99, 1), 99) AS m99, "
                        "size(map(k, v)) AS ms FROM t ORDER BY w",
    "map_from_arrays": "SELECT k, element_at(map_from_arrays(l, l), 3) AS "
                       "m3, map_from_arrays(l, l) AS m FROM (SELECT k, "
                       "collect_set(v) AS l FROM t GROUP BY k) s ORDER BY k",
    "split": "SELECT c, split(c, 'o') AS parts, size(split(c, 'o')) AS n "
             "FROM t ORDER BY w",
    "array literal": "SELECT k, array(k, v, 7) AS a, "
                     "element_at(array(k, v, 7), 2) AS e FROM t ORDER BY w",
}


@pytest.mark.parametrize("name", list(SQL_TEXTS))
def test_sql_text_like_reference(spark, tspark, name):
    """Array, higher-order, map and struct functions from SQL text: the
    collected rows (maps as dicts, structs as Rows) equal the
    reference's."""
    rdf, tdf = _frames(spark, tspark)
    rdf.createOrReplaceTempView("t")
    tdf.createOrReplaceTempView("t")
    sql = SQL_TEXTS[name]
    assert_rows_equal(_plain(spark.sql(sql).collect()),
                      _plain(tspark.sql(sql).collect()))


def _plain(rows):
    """Rows with every nested struct (a Row of either package) as a
    tuple."""
    def value(v):
        if isinstance(v, tuple):
            return tuple(value(x) for x in v)
        if isinstance(v, dict):
            return {k: value(x) for k, x in v.items()}
        if isinstance(v, list):
            return [value(x) for x in v]
        return v
    return [tuple(value(x) for x in r) for r in rows]


def test_struct_field_and_subscript(tspark):
    """``s.field`` on a struct column, ``e.field`` after a call and
    ``arr[i]`` (a 0-based position; a negative one is NULL), which the
    reference grammar lacks, against element_at and the Column API's
    getField / getItem."""
    _r, tdf = _frames_port(tspark)
    tdf.createOrReplaceTempView("t")
    lists = "(SELECT k, collect_list(v) AS l FROM t GROUP BY k)"
    got = tspark.sql(
        "SELECT k, named_struct('a', k, 'b', size(l)).b AS b, l[0] AS l0, "
        "l[-1] AS ln, s.a AS sa FROM (SELECT k, l, named_struct('a', k) "
        f"AS s FROM {lists} y) x ORDER BY k").collect()
    want = tspark.sql(f"SELECT k, size(l) AS b, element_at(l, 1) AS l0, "
                      f"k AS sa FROM {lists} y ORDER BY k").collect()
    assert [(r.k, r.b, r.l0, r.sa) for r in got] == \
        [tuple(r) for r in want]
    assert all(r.ln is None for r in got)
    api = tdf.groupBy("k").agg(TF.collect_list("v").alias("l")).select(
        "k", TF.col("l").getItem(0).alias("l0"),
        TF.col("l")[-1].alias("ln"),
        TF.named_struct("a", TF.col("k")).getField("a").alias("sa")
    ).orderBy("k").collect()
    assert [(r.k, r.l0, r.ln, r.sa) for r in api] == \
        [(r.k, r.l0, r.ln, r.sa) for r in got]


def _frames_port(tspark):
    data = _table()
    return None, tspark.createDataFrame(data)


@pytest.mark.parametrize("text,message", [
    ("transform(a, (x, y) -> x)", "lambda expects 1 variable(s)"),
    ("aggregate(a, 0, (x, X) -> x + 1)", "duplicate lambda variable names"),
    ("zip_with(a, b, x -> x)", "lambda expects 2 variable(s)"),
    ("filter(a, 1 -> x)", "expected lambda variable"),
])
def test_lambda_errors_like_reference(text, message):
    """Malformed lambdas raise the reference's ParseException."""
    with pytest.raises(RP.ParseException) as r:
        RP.parse_expression(text)
    with pytest.raises(TP.ParseException) as t:
        TP.parse_expression(text)
    assert str(t.value) == str(r.value) and message in str(t.value)


def test_lambda_body_referencing_a_column_is_refused(tspark):
    with pytest.raises(TE.AnalysisException, match="lambda body may "
                       "reference only"):
        tspark.sql("SELECT transform(l, x -> x + k) FROM t")


def test_lambda_names_are_plan_positions(tspark):
    """Two runs of one text analyze to the same lambda names (and the same
    stage key); two variables of one plan never share a name."""
    from spark_tpu_torch.sql.planner import QueryExecution
    _r, tdf = _frames_port(tspark)
    tdf.createOrReplaceTempView("t")
    sql = ("SELECT transform(l, x -> x + 1) AS a, filter(l, x -> x > 2) "
           "AS b FROM (SELECT collect_list(v) AS l FROM t) s")
    plans = [QueryExecution(tspark, tspark.sql(sql)._plan).analyzed
             for _ in range(2)]
    assert plans[0].tree_string() == plans[1].tree_string()
    names = [e.children[0].var.name for e in plans[0].exprs]
    assert len(set(names)) == 2 and all(n.startswith("x#") for n in names)


# ---------------------------------------------------------------------------
# sampling, ids and the NA methods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 4])
def test_rand_and_ids_through_the_dataframe(spark, tspark, shards):
    """rand / randn / monotonically_increasing_id / spark_partition_id
    selected from a table, at 1 and 4 shards (each shard's rows carry
    its index in their ids' bits from 48 up): rand, the ids and the
    partition ids equal the reference's bit for bit, randn within
    FLOAT_RTOL; at 4 shards every partition id is in 0..3."""
    rdf, tdf = _frames(spark, tspark)

    def query(df, F):
        return df.select("k", F.rand(7).alias("r"), F.randn(3).alias("n"),
                         F.monotonically_increasing_id().alias("id"),
                         F.spark_partition_id().alias("p"))

    spark.conf.set(SHARDS, str(shards))
    try:
        ref = query(rdf, RF).collect()
    finally:
        spark.conf.set(SHARDS, "1")
    got = _collect_at(tspark, query(tdf, TF), shards)
    assert_rows_equal(ref, got, rtol=FLOAT_RTOL)
    # 300 rows in a capacity of 512: at 4 shards the last holds padding
    assert sorted({r.p for r in got}) == list(range(min(shards, 3)))


@pytest.mark.parametrize("shards", [1, 4])
def test_sample_like_reference(spark, tspark, shards):
    rdf, tdf = _frames(spark, tspark)
    spark.conf.set(SHARDS, str(shards))
    try:
        ref = rdf.sample(0.3, seed=7).collect()
    finally:
        spark.conf.set(SHARDS, "1")
    got = _collect_at(tspark, tdf.sample(0.3, seed=7), shards)
    assert_rows_equal(ref, got)
    assert 0 < len(got) < 300


def test_filter_on_rand_like_reference(spark, tspark):
    """A filter on a drawn rand() column stays above the projection that
    draws it (the optimizer's determinism guard; a pushed or copied draw
    would come from another operator's row offset): the same rows as the
    reference's, every one below the bound."""
    rdf, tdf = _frames(spark, tspark)

    def query(df, F):
        return df.select("k", F.rand(1).alias("r")).filter(F.col("r") < 0.5)

    got = query(tdf, TF).collect()
    assert_rows_equal(query(rdf, RF).collect(), got)
    assert got and all(r.r < 0.5 for r in got)


@pytest.mark.parametrize("case", ["dropDuplicates", "drop_duplicates_subset",
                                  "dropna_any", "dropna_all_subset",
                                  "na_drop", "fillna_number",
                                  "fillna_string_subset", "na_fill",
                                  "toLocalIterator"])
def test_dataframe_methods_like_reference(spark, tspark, case):
    rdf, tdf = _frames(spark, tspark)
    calls = {
        "dropDuplicates": lambda df: df.select("k", "c").dropDuplicates()
        .orderBy("k", "c"),
        "drop_duplicates_subset": lambda df: df.drop_duplicates(["k"])
        .orderBy("k"),
        "dropna_any": lambda df: df.dropna(),
        "dropna_all_subset": lambda df: df.dropna("all", ["v", "c"]),
        "na_drop": lambda df: df.na.drop(subset=["k"]),
        "fillna_number": lambda df: df.fillna(0),
        "fillna_string_subset": lambda df: df.fillna("none", ["c"]),
        "na_fill": lambda df: df.na.fill(-1, ["v"]),
        "toLocalIterator": lambda df: df,
    }
    if case == "toLocalIterator":
        assert_rows_equal(list(rdf.toLocalIterator()),
                          list(tdf.toLocalIterator()))
        return
    assert_rows_equal(calls[case](rdf).collect(), calls[case](tdf).collect())


FUNCTIONS = {
    "hash": lambda F: F.hash("k", "c"),
    "xxhash64": lambda F: F.xxhash64("w"),
    "cbrt": lambda F: F.cbrt("w"),
    "rint": lambda F: F.rint("w"),
    "log1p": lambda F: F.log1p(F.abs("w")),
    "expm1": lambda F: F.expm1("w"),
    "input_file_name": lambda F: F.input_file_name(),
}


@pytest.mark.parametrize("name", list(FUNCTIONS) + ["approx_count_distinct"])
def test_function_names_like_reference(spark, tspark, name):
    """The DataFrame names that the parser had and functions.py lacked."""
    rdf, tdf = _frames(spark, tspark)
    if name == "approx_count_distinct":
        def q(df, F):
            return df.groupBy("k").agg(
                F.approx_count_distinct("v").alias("n")).orderBy("k")
    else:
        def q(df, F):
            return df.select("k", FUNCTIONS[name](F).alias("x"))
    assert_rows_equal(q(rdf, RF).collect(), q(tdf, TF).collect(),
                      rtol=FLOAT_RTOL)


# ---------------------------------------------------------------------------
# the complex-type texts of chip_smoke.py, on three lanes
# ---------------------------------------------------------------------------

LANES = {"eager": {"spark.sql.codegen.wholeStage": "false"},
         "per-op": {"spark.tpu.stage.fusion": "false"},
         "graph": {}}


@pytest.fixture(scope="module")
def baskets(tspark):
    tables = TT.basket_tables(6000, 900)
    session = tspark.newSession()
    session.conf.set(MAX_LEN, "16")
    TT.register_basket_tables(session, tables, TTypes)
    return session, tables


@pytest.mark.parametrize("lane", list(LANES))
@pytest.mark.parametrize("name", list(TT.COMPLEX_QUERIES))
def test_complex_query_against_oracle(baskets, name, lane):
    session, tables = baskets
    sql, oracle = TT.COMPLEX_QUERIES[name]
    for k, v in LANES[lane].items():
        session.conf.set(k, v)
    try:
        parts = batch_parts(session.sql(sql)._execute())
    finally:
        for k in LANES[lane]:
            session.conf.unset(k)
    assert TT.complex_mismatch(parts, oracle(tables, 16)) is None


@pytest.mark.parametrize("lane", list(LANES))
def test_sampling_text_against_oracle(baskets, lane):
    """sample's rows and ticket sum, and rand / randn / row ids over
    store_sales, against the numpy formula at the plan's row offsets."""
    from spark_tpu_torch.sql import physical as P
    from spark_tpu_torch.sql.planner import QueryExecution
    session, tables = baskets
    for k, v in LANES[lane].items():
        session.conf.set(k, v)
    try:
        ss = session.table("store_sales")
        sampled = ss.sample(TT.SAMPLE_FRACTION, seed=TT.SAMPLE_SEED).agg(
            TF.count("*").alias("n"), TF.sum("ss_ticket_number").alias("t"))
        plan = QueryExecution(session, sampled._plan).planned.physical
        ops = [plan]
        while not isinstance(ops[-1], P.PSample):
            ops.append(ops[-1].children[0])
        want = TT.sample_oracle(tables, ops[-1].row_offset)
        assert tuple(sampled.collect()[0]) == want
        ids = ss.select(TF.rand(TT.SAMPLE_SEED).alias("r"),
                        TF.randn(TT.SAMPLE_SEED).alias("g"),
                        TF.monotonically_increasing_id().alias("id"))
        got = TT.result_columns(batch_parts(ids._execute()))
        n = len(tables["store_sales"]["ss_ticket_number"])
        offset = 1 << 33                  # the projection is operator 1
        assert np.array_equal(got["id"], np.arange(n) + offset)
        assert np.array_equal(got["r"],
                              TT.rand_oracle(n, TT.SAMPLE_SEED, offset))
        assert np.allclose(got["g"], TT.randn_oracle(n, TT.SAMPLE_SEED,
                                                     offset),
                           rtol=FLOAT_RTOL, atol=1e-15)
    finally:
        for k in LANES[lane]:
            session.conf.unset(k)


def test_complex_text_at_four_shards(baskets):
    """The baskets text on the mesh lane: the collect gathers its rows to
    one shard (K2's gather; its launches are counted on the card) and the
    result equals the one-device run."""
    from spark_tpu_torch.sql.planner import (QueryExecution,
                                             _needs_local_fallback)
    session, tables = baskets
    sql, oracle = TT.COMPLEX_QUERIES["baskets"]
    one = batch_parts(session.sql(sql)._execute())
    # without the ORDER BY: a sort of array columns is an exchange of
    # 2-D planes, which the mesh lane leaves to one device; the sort-based
    # aggregate already emits the tickets in order
    df = session.sql(TT.unordered(sql))
    assert not _needs_local_fallback(
        QueryExecution(session, df._plan).optimized)
    session.conf.set(SHARDS, "4")
    try:
        four = batch_parts(df._execute())
    finally:
        session.conf.set(SHARDS, "1")
    assert TT.complex_mismatch(four, oracle(tables, 16)) is None
    assert_parts_equal(one, four)


def test_array_stage_replays_without_host_reads(baskets, monkeypatch):
    """An array stage on the graph lane: the second run replays the first
    one's record (the split table, the dictionary remaps and every other
    host-built table served as constants) touching no host value of a
    tensor and building no tensor from host values, and equals the
    eager lane."""
    session, _tables = baskets
    sql = ("SELECT ss_ticket_number, sort_array(items, false) AS d, "
           "transform(items, x -> x * 2) AS t, "
           "array(ss_ticket_number, 7) AS a FROM " + TT._BASKETS +
           " ORDER BY ss_ticket_number")
    df = session.sql(sql)
    session.conf.set("spark.sql.codegen.wholeStage", "false")
    try:
        eager = batch_parts(df._execute())
    finally:
        session.conf.unset("spark.sql.codegen.wholeStage")
    cache = TSC.stage_cache()
    first = batch_parts(df._execute())
    before = cache.stats()
    _trap_host_syncs(monkeypatch)
    replayed = batch_parts(df._execute())
    monkeypatch.undo()
    after = cache.stats()
    assert after["dispatches"] == before["dispatches"] + 1
    assert after["variants"] == before["variants"]
    assert_parts_equal(eager, first)
    assert_parts_equal(eager, replayed)


@pytest.mark.parametrize("sql", [
    "SELECT k, transform(l, x -> x + 1) AS t FROM (SELECT k, "
    "collect_list(v) AS l FROM t GROUP BY k) s",
    "SELECT k, array(k, v, 3) AS a, rand(3) AS r FROM t",
    "SELECT k, explode(l) AS e FROM (SELECT k, collect_set(v) AS l FROM t "
    "GROUP BY k) s",
])
def test_plan_cache_cacheability_like_reference(spark, tspark, sql):
    """Lambdas, array literals, collects and explodes fingerprint in both
    packages (cacheable); in the port two runs of one text share the
    fingerprint, so a repeat is a hit."""
    from spark_tpu.serving.plancache import fingerprint as rfingerprint
    from spark_tpu.sql.planner import QueryExecution as RQE
    from spark_tpu_torch.serving.plancache import fingerprint
    from spark_tpu_torch.sql.planner import QueryExecution
    rdf, tdf = _frames(spark, tspark)
    rdf.createOrReplaceTempView("t")
    tdf.createOrReplaceTempView("t")
    ref = rfingerprint(spark, RQE(spark, spark.sql(sql)._plan).optimized)
    got = [fingerprint(tspark, QueryExecution(
        tspark, tspark.sql(sql)._plan).optimized) for _ in range(2)]
    assert ref is not None and got[0] is not None
    assert got[0].key == got[1].key


def test_reserve_counts_array_planes_and_exploded_rows(baskets):
    """The memory pre-flight counts a collect's scatter plane, the array
    columns' widths and an explode's capacity * width rows."""
    from spark_tpu_torch.sql.planner import (QueryExecution, _array_width_bound,
                                             _plan_reserve_bytes)
    session, _tables = baskets
    flat = QueryExecution(session, session.sql(
        "SELECT ss_ticket_number, COUNT(*) AS n FROM store_sales GROUP BY "
        "ss_ticket_number")._plan).planned
    exploded = QueryExecution(session, session.sql(
        TT.COMPLEX_QUERIES["explode"][0])._plan).planned
    assert _array_width_bound(exploded) == 16
    assert _plan_reserve_bytes(exploded) > _plan_reserve_bytes(flat) \
        + 16 * 8 * 8192


def test_only_the_streaming_and_scan_constructs_stay_refused(tspark):
    """What the array slice and the scan slice brought is no longer
    refused: the function names left are the event-time windows, the plan
    node the stateful groups (file scans came with the scan slice); Sample
    and Explode plan to real operators."""
    from spark_tpu_torch.sql import analyzer as TA
    from spark_tpu_torch.sql import physical as P
    from spark_tpu_torch.sql.planner import QueryExecution
    # the streaming slice brought the event-time windows and the stateful
    # groups: nothing is refused any more
    assert sorted(TA.NOT_PORTED_FUNCTIONS) == []
    assert sorted(TA._NOT_PORTED) == []
    _r, tdf = _frames_port(tspark)
    lists = tdf.groupBy("k").agg(TF.collect_list("v").alias("l"))
    for df, op in ((tdf.sample(0.5, 1), P.PSample),
                   (lists.select(TF.explode("l")), P.PExplode)):
        node = QueryExecution(tspark, df._plan).planned.physical
        kinds = []
        while True:
            kinds.append(type(node))
            if not node.children:
                break
            node = node.children[0]
        assert op in kinds
        df.collect()


def test_server_replies_arrays_as_lists_and_maps_as_objects(spark):
    """Over HTTP an array is a JSON list, a map a JSON object (keys as
    strings), a struct the list of its fields; the reference's reply
    agrees on the lists and sends a map as its Python text."""
    import json
    import urllib.request

    from spark_tpu import server as RS
    from spark_tpu_torch import server as TS

    def post(srv, sql):
        req = urllib.request.Request(
            f"http://{srv.host}:{srv.port}/sql",
            data=json.dumps({"query": sql}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    sql = ("SELECT k, collect_list(v) AS l, map(k, 10) AS m, "
           "named_struct('a', k, 'b', 'x') AS st FROM t GROUP BY k "
           "ORDER BY k")
    data = {"k": [1, 2, 1, 3], "v": [5, 6, None, 8]}
    root = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    root.createDataFrame(data).createOrReplaceTempView("t")
    rroot = spark.newSession()
    rroot.createDataFrame(data).createOrReplaceTempView("t")
    got, ref = [], []
    for impl, session, out in ((TS, root, got), (RS, rroot, ref)):
        srv = impl.SQLServer(session, port=0).start()
        try:
            out.append(post(srv, sql))
        finally:
            srv.stop()
    assert got[0]["columns"] == ["k", "l", "m", "st"]
    assert got[0]["rows"] == [[1, [5], {"1": 10}, [1, "x"]],
                              [2, [6], {"2": 10}, [2, "x"]],
                              [3, [8], {"3": 10}, [3, "x"]]]
    assert [[r[0], r[1], r[3]] for r in ref[0]["rows"]] == \
        [[r[0], r[1], r[3]] for r in got[0]["rows"]]
    assert [r[2] for r in ref[0]["rows"]] == ["{1: 10}", "{2: 10}",
                                              "{3: 10}"]
