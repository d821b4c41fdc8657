"""``spark.sql`` of the port against ``spark_tpu``: subqueries, set
operations, string predicates, ``selectExpr``/``expr``/string filters,
UDFs in both lanes, views and commands, and the mesh lane.  The same
tables go into both packages through ``batch_parts``/``from_parts`` (so
dictionary codes match); ``collect()`` rows must be equal — integers,
codes and strings exactly, floats within ``rel_tol = 1e-9``.
"""

import numpy as np
import pytest
import torch

from spark_tpu import types as RT
from spark_tpu.expressions import AnalysisException as RAnalysisException
from spark_tpu.sql import functions as RF
from spark_tpu_torch import config as TC
from spark_tpu_torch import types as TT
from spark_tpu_torch.expressions import AnalysisException
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql import logical as TL
from spark_tpu_torch.sql import udf as TU
from spark_tpu_torch.sql.dataframe import DataFrame as TDataFrame
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import (assert_rows_equal, batch_parts,
                                     from_parts)

RTOL = 1e-9


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


def _frames(spark, tspark, data, schema=None):
    """One table in both packages: the reference builds the batch, the
    port gets its parts."""
    rdf = spark.createDataFrame(data, schema=schema)
    parts = batch_parts(rdf._plan.batch.to_host())
    return rdf, TDataFrame(tspark, TL.LocalRelation(from_parts(parts)))


@pytest.fixture(scope="module")
def views(spark, tspark):
    """t, u (``tests/test_subquery.py``'s tables, with NULLs and strings),
    n (a subquery column holding a NULL), s1/s2 (string columns whose
    dictionaries differ)."""
    tables = {
        "t": ({"k": np.array([1, 2, 3, 4, 5, 6], np.int64),
               "g": ["a", "a", "b", "b", "c", None],
               "v": [1.0, 2.0, 3.0, 4.0, 10.0, None]}, None),
        "u": ({"k2": np.array([2, 3, 9], np.int64),
               "w": np.array([5.0, 6.0, 7.0])}, None),
        "n": ({"x": [2, None, 7]}, RT.StructType(
            [RT.StructField("x", RT.int64)])),
        "s1": ({"id": np.array([1, 2, 3, 4], np.int64),
                "name": ["apple", "banana", "cherry", None]}, None),
        "s2": ({"id": np.array([10, 20, 30], np.int64),
                "name": ["banana", "date", "apple pie"]}, None),
    }
    out = {}
    for name, (data, schema) in tables.items():
        rdf, tdf = _frames(spark, tspark, data, schema)
        rdf.createOrReplaceTempView(name)
        tdf.createOrReplaceTempView(name)
        out[name] = (rdf, tdf)
    yield out
    for name in tables:
        spark.catalog.dropTempView(name)
        tspark.catalog.dropTempView(name)


def both(spark, tspark, sql, ordered=None):
    if ordered is None:
        ordered = "ORDER BY" in sql.upper()
    ref = spark.sql(sql).collect()
    got = tspark.sql(sql).collect()
    assert_rows_equal(ref, got, rtol=RTOL, ordered=ordered)
    assert list(got[0].__fields__ if got else []) \
        == list(ref[0].__fields__ if ref else [])
    return got


# ---------------------------------------------------------------------------
# subqueries: every shape of tests/test_subquery.py
# ---------------------------------------------------------------------------

SUBQUERIES = {
    "scalar_uncorrelated":
        "SELECT k FROM t WHERE v > (SELECT AVG(v) FROM t) ORDER BY k",
    "scalar_correlated":
        "SELECT k FROM t t1 WHERE v > (SELECT AVG(t2.v) FROM t t2 "
        "WHERE t2.g = t1.g) ORDER BY k",
    "scalar_in_arithmetic":
        "SELECT k FROM t WHERE v > 0.5 * (SELECT MAX(v) FROM t) ORDER BY k",
    "scalar_missing_group_is_null":
        "SELECT k2 FROM u WHERE k2 > (SELECT SUM(t.k) FROM t "
        "WHERE t.k = u.k2) ORDER BY k2",
    "in": "SELECT k FROM t WHERE k IN (SELECT k2 FROM u) ORDER BY k",
    "not_in": "SELECT k FROM t WHERE k NOT IN (SELECT k2 FROM u) ORDER BY k",
    "not_in_null_in_subquery":
        "SELECT k FROM t WHERE k NOT IN (SELECT x FROM n) ORDER BY k",
    "in_null_in_subquery":
        "SELECT k FROM t WHERE k IN (SELECT x FROM n) ORDER BY k",
    "in_correlated":
        "SELECT k FROM t WHERE k IN (SELECT k2 FROM u WHERE u.w > t.v) "
        "ORDER BY k",
    "exists": "SELECT k FROM t WHERE EXISTS "
              "(SELECT * FROM u WHERE u.k2 = t.k) ORDER BY k",
    "not_exists": "SELECT k FROM t WHERE NOT EXISTS "
                  "(SELECT * FROM u WHERE u.k2 = t.k) ORDER BY k",
    "exists_non_equi_residual":
        "SELECT k FROM t WHERE EXISTS (SELECT * FROM u WHERE u.k2 = t.k "
        "AND u.w > 5.5) ORDER BY k",
    "exists_with_limit": "SELECT k FROM t WHERE EXISTS "
                         "(SELECT 1 FROM u WHERE u.k2 = t.k LIMIT 1)",
    "correlated_count_empty_group_is_zero":
        "SELECT k2 FROM u WHERE (SELECT COUNT(*) FROM t WHERE t.k = u.k2) "
        "= 0 ORDER BY k2",
    "nested": "SELECT k FROM t WHERE k IN (SELECT k2 FROM u "
              "WHERE w > (SELECT AVG(w) FROM u))",
    "cte_in_subquery":
        "WITH big AS (SELECT g, SUM(v) AS sv FROM t GROUP BY g) "
        "SELECT g FROM big b1 WHERE b1.sv > (SELECT AVG(sv) FROM big b2) "
        "ORDER BY g",
    "in_having":
        "SELECT g, SUM(v) AS sv FROM t GROUP BY g "
        "HAVING SUM(v) > (SELECT AVG(v) FROM t) ORDER BY g",
    "scalar_in_select_list":
        "SELECT k, (SELECT SUM(w) FROM u) AS s FROM t ORDER BY k",
    "scalar_inside_case":
        "SELECT k, CASE WHEN (SELECT MAX(w) FROM u) > 6.5 THEN 'big' "
        "ELSE 'small' END AS c FROM t ORDER BY k",
    "in_under_or":
        "SELECT k FROM t WHERE k = 6 OR k IN (SELECT k2 FROM u) ORDER BY k",
    "exists_under_or":
        "SELECT k FROM t WHERE k = 1 OR EXISTS (SELECT * FROM u "
        "WHERE u.k2 = t.k) ORDER BY k",
    "non_aggregate_scalar":
        "SELECT (SELECT w FROM u WHERE k2 = 9) + 1 AS r",
    "mixed_distinct_and_sum":
        "SELECT COUNT(DISTINCT g) AS dg, SUM(v) AS sv, MIN(k) AS mk FROM t",
    "chained_ctes":
        "WITH base AS (SELECT k AS x FROM t WHERE k < 3), "
        "doubled AS (SELECT x * 2 AS y FROM base), "
        "shifted AS (SELECT y + 10 AS z FROM doubled) "
        "SELECT z FROM shifted ORDER BY z",
}


@pytest.mark.parametrize("name", sorted(SUBQUERIES))
def test_subquery_matches_reference(spark, tspark, views, name):
    both(spark, tspark, SUBQUERIES[name])


def test_not_in_deviation_is_the_references(spark, tspark, views):
    """NOT IN over a subquery holding a NULL: Spark returns no rows; both
    packages treat the NULL as non-matching (the JAX package's documented
    deviation, kept)."""
    got = both(spark, tspark, SUBQUERIES["not_in_null_in_subquery"])
    assert [r[0] for r in got] == [1, 3, 4, 5, 6]


@pytest.mark.parametrize("sql,match", [
    ("SELECT k FROM t WHERE EXISTS (SELECT * FROM u)", "uncorrelated"),
    ("SELECT k2 FROM u WHERE (SELECT COUNT(*) + 1 FROM t "
     "WHERE t.k = u.k2) = 1", "count"),
    ("SELECT k FROM t WHERE k = 9 OR k IN (SELECT k2 FROM u "
     "WHERE u.w = t.v)", "correlated IN"),
    ("SELECT k IN (SELECT k2 FROM u) AS f FROM t", "SELECT list"),
])
def test_unsupported_subquery_raises_like_reference(spark, tspark, views,
                                                    sql, match):
    with pytest.raises(RAnalysisException, match=match):
        spark.sql(sql).collect()
    with pytest.raises(AnalysisException, match=match):
        tspark.sql(sql).collect()


# ---------------------------------------------------------------------------
# set operations, with string dictionaries that differ between branches
# ---------------------------------------------------------------------------

SET_OPS = {
    "union_all": "SELECT k FROM t UNION ALL SELECT k2 FROM u",
    "union": "SELECT k FROM t UNION SELECT k2 FROM u",
    "union_strings": "SELECT id, name FROM s1 UNION ALL "
                     "SELECT id, name FROM s2",
    "union_distinct_strings": "SELECT name FROM s1 UNION SELECT name FROM s2",
    "union_three_branches": "SELECT name FROM s1 UNION ALL SELECT name "
                            "FROM s2 UNION ALL SELECT g FROM t",
    "union_order_limit": "SELECT v FROM t WHERE k < 3 UNION ALL "
                         "SELECT w FROM u ORDER BY v DESC LIMIT 3",
    "union_filter_pushdown": "SELECT * FROM (SELECT k, g FROM t UNION ALL "
                             "SELECT k2, 'z' FROM u) x WHERE k > 2",
    "union_grouped": "SELECT name, COUNT(*) AS c FROM (SELECT name FROM s1 "
                     "UNION ALL SELECT name FROM s2) x GROUP BY name",
    "union_widening": "SELECT k FROM t UNION ALL SELECT w FROM u",
    "intersect": "SELECT k FROM t INTERSECT SELECT k2 FROM u",
    "intersect_strings": "SELECT name FROM s1 INTERSECT SELECT name FROM s2",
    "except": "SELECT k FROM t EXCEPT SELECT k2 FROM u",
    "except_strings": "SELECT name FROM s1 EXCEPT SELECT name FROM s2",
    "intersect_deduplicates": "SELECT g FROM t INTERSECT "
                              "SELECT 'a' AS x FROM u",
    "intersect_precedence": "SELECT k FROM t WHERE k = 1 UNION "
                            "SELECT k FROM t INTERSECT SELECT k2 FROM u",
    "intersect_star": "SELECT * FROM u INTERSECT SELECT * FROM u",
    "intersect_qualified": "SELECT t.k FROM t INTERSECT SELECT u.k2 FROM u",
}


@pytest.mark.parametrize("name", sorted(SET_OPS))
def test_set_operation_matches_reference(spark, tspark, views, name):
    both(spark, tspark, SET_OPS[name])


def test_union_all_keeps_branch_order(spark, tspark, views):
    """UNION ALL concatenates branch after branch: the row order of an
    unsorted result is the reference's."""
    both(spark, tspark, SET_OPS["union_strings"], ordered=True)


def test_dataframe_union_and_union_by_name(spark, tspark, views):
    def q(F, pair):
        a, b = pair
        x = a.select("id", "name")
        y = b.select(F.col("name"), (F.col("id") + 1).alias("id"))
        return x.union(b.select("id", "name")).collect(), \
            x.unionByName(y).collect(), x.unionAll(x).count()
    r = q(RF, (views["s1"][0], views["s2"][0]))
    g = q(TF, (views["s1"][1], views["s2"][1]))
    assert_rows_equal(r[0], g[0])
    assert_rows_equal(r[1], g[1])
    assert r[2] == g[2] == 8


# ---------------------------------------------------------------------------
# string predicates, selectExpr, expr, string filters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sql", [
    "SELECT id FROM s1 WHERE name LIKE 'a%'",
    "SELECT id FROM s1 WHERE name NOT LIKE '%an%'",
    "SELECT id FROM s2 WHERE name LIKE '_ate'",
    "SELECT id FROM s2 WHERE name RLIKE 'pie$|^b'",
    "SELECT id, name LIKE '%e%' AS e FROM s1 ORDER BY id",
])
def test_like_matches_reference(spark, tspark, views, sql):
    both(spark, tspark, sql)


@pytest.mark.parametrize("method,arg", [
    ("like", "%an%"), ("rlike", "^(a|c)"), ("startswith", "ba"),
    ("endswith", "e"), ("contains", "an"),
])
def test_string_predicate_matches_reference(views, method, arg):
    def q(df, F):
        return df.select("id", getattr(F.col("name"), method)(arg)
                         .alias("m")).orderBy("id").collect()
    assert_rows_equal(q(views["s1"][0], RF), q(views["s1"][1], TF))
    assert_rows_equal(q(views["s2"][0], RF), q(views["s2"][1], TF))


def test_select_expr_expr_and_string_filter(views):
    def q(df, F):
        return (df.selectExpr("k", "v * 2 AS v2", "coalesce(g, 'none') AS g",
                              "CASE WHEN k > 3 THEN 1 ELSE 0 END AS big")
                  .filter("v2 > 3 OR g = 'none'")
                  .where("k <> 5")
                  .select("k", F.expr("v2 + k AS s"), "g", "big")
                  .orderBy("k").collect())
    assert_rows_equal(q(views["t"][0], RF), q(views["t"][1], TF), rtol=RTOL)


def test_select_expr_aggregate(views):
    def q(df):
        return df.selectExpr("count(*) AS c", "sum(v) AS s",
                             "count(DISTINCT g) AS d").collect()
    assert_rows_equal(q(views["t"][0]), q(views["t"][1]), rtol=RTOL)


# ---------------------------------------------------------------------------
# UDFs in both lanes
# ---------------------------------------------------------------------------

def test_row_lane_udf_matches_reference(spark, tspark, views):
    def q(F, df):
        plus = F.udf(lambda a, b: a * 10 + (b or 0), "double")
        slen = F.udf(lambda s: len(s) if s is not None else None, "int")
        return df.select("k", plus(F.col("k"), F.col("v")).alias("o"),
                         slen(F.col("g")).alias("n")) \
            .filter(F.col("o") > 20).orderBy("k").collect()
    before = dict(TU.HOST_COPIES)
    got = q(TF, views["t"][1])
    assert_rows_equal(q(RF, views["t"][0]), got, rtol=RTOL)
    # one device→host and one host→device copy per UDF evaluation
    assert TU.HOST_COPIES["to_host"] - before["to_host"] \
        == TU.HOST_COPIES["to_device"] - before["to_device"] > 0


def test_vectorized_udf_matches_reference(views):
    import jax.numpy as jnp
    r = RF.udf(lambda v: jnp.where(v % 2 == 0, v * v, -v), "bigint",
               vectorized=True)
    t = TF.udf(lambda v: torch.where(v % 2 == 0, v * v, -v), "bigint",
               vectorized=True)
    seen = []

    def spy(v):
        seen.append(v)
        return torch.sqrt(v)
    t_sqrt = TF.udf(spy, "double", vectorized=True)
    r_sqrt = RF.udf(lambda v: jnp.sqrt(v), "double", vectorized=True)
    ref = views["u"][0].select(r(RF.col("k2")).alias("o"),
                               r_sqrt(RF.col("w")).alias("q")).collect()
    got = views["u"][1].select(t(TF.col("k2")).alias("o"),
                               t_sqrt(TF.col("w")).alias("q")).collect()
    assert_rows_equal(ref, got, rtol=RTOL)
    assert seen and all(isinstance(v, torch.Tensor) for v in seen)


def test_sql_registered_udfs_match_reference(spark, tspark, views):
    for s in (spark, tspark):
        s.udf.register("cube_it", lambda v: v ** 3, "bigint")
        s.udf.register("halve", lambda v: v / 2, "double", vectorized=True)
    both(spark, tspark,
         "SELECT k, cube_it(k) AS c, halve(v) AS h FROM t ORDER BY k")
    both(spark, tspark, "SELECT SUM(cube_it(k)) AS s FROM t "
                        "WHERE cube_it(k) > 5")
    both(spark, tspark, "SELECT g, SUM(cube_it(k)) AS s FROM t GROUP BY g "
                        "ORDER BY g")
    for s, exc in ((spark, RAnalysisException), (tspark, AnalysisException)):
        with pytest.raises(exc, match="undefined function"):
            s.sql("SELECT no_such_fn(k) FROM t").collect()
    assert tspark.catalog.listFunctions() == ["cube_it", "halve"]


def test_udf_limits_are_loud(tspark):
    with pytest.raises(AnalysisException, match="string/binary"):
        TF.udf(lambda v: str(v), "string")

    @TF.udf(returnType="bigint")
    def triple(v):
        return 3 * v
    df = tspark.createDataFrame({"k": np.arange(4, dtype=np.int64)})
    assert [r[0] for r in df.select(triple(TF.col("k"))).collect()] \
        == [0, 3, 6, 9]


# ---------------------------------------------------------------------------
# views and commands
# ---------------------------------------------------------------------------

def test_views_and_commands_match_reference(spark, tspark, views):
    for s in (spark, tspark):
        s.sql("CREATE OR REPLACE TEMP VIEW cv AS "
              "SELECT k * 2 AS y, g FROM t WHERE k < 4")
    both(spark, tspark, "SELECT y, g FROM cv ORDER BY y")
    both(spark, tspark, "DESCRIBE cv")
    both(spark, tspark, "DESCRIBE TABLE EXTENDED cv")
    both(spark, tspark, "SET spark.tpu.test.flag=17")
    assert tspark.conf.get("spark.tpu.test.flag") == "17"
    both(spark, tspark, "SET spark.tpu.test.flag")
    both(spark, tspark, "SET spark.tpu.test.path=/a:b;c{d}$e")
    names = [r[0] for r in tspark.sql("SHOW TABLES").collect()]
    assert {"cv", "t", "u"} <= set(names) and names == sorted(names)
    assert all(r[1] == "true" for r in tspark.sql("SHOW TABLES").collect())
    out = tspark.sql("EXPLAIN SELECT y FROM cv").collect()
    assert "Physical Plan" in out[0][0]
    assert tspark.sql("EXPLAIN EXTENDED SELECT y FROM cv").collect()[0][0]
    for s, exc in ((spark, RAnalysisException), (tspark, AnalysisException)):
        with pytest.raises(exc, match="already exists"):
            s.sql("CREATE TEMP VIEW cv AS SELECT 1 AS one")
        s.sql("DROP VIEW cv")
        with pytest.raises(exc):
            s.sql("SELECT * FROM cv").collect()
        s.sql("DROP VIEW IF EXISTS cv")
        with pytest.raises(exc):
            s.sql("DROP VIEW cv")


def test_select_without_from_and_range(spark, tspark):
    both(spark, tspark, "SELECT 1 + 1 AS two, 'x' AS s")
    both(spark, tspark, "SELECT id * 2 AS x FROM range(2, 5)")
    both(spark, tspark, "SELECT NULL <=> NULL AS a, 1 <=> NULL AS b, "
                        "1 <=> 1 AS c, 1 <=> 2 AS d")


@pytest.mark.parametrize("sql", [
    "CREATE TABLE pt (a int) USING parquet",
    "CREATE TABLE pt USING parquet AS SELECT 1 AS a",
    "INSERT INTO pt SELECT 1",
    "DROP TABLE pt",
    "CREATE DATABASE db",
    "DROP DATABASE db",
    "USE db",
    "SHOW DATABASES",
    "ANALYZE TABLE t COMPUTE STATISTICS",
])
def test_persistent_catalog_commands_name_the_scan_slice(tspark, sql):
    with pytest.raises(NotImplementedError,
                       match="is not ported yet: persistent catalog tables "
                             "come with the scan slice"):
        tspark.sql(sql)


def test_drop_table_drops_a_shadowing_view(tspark):
    tspark.sql("CREATE TEMP VIEW shadow AS SELECT 1 AS a")
    tspark.sql("DROP TABLE shadow")
    assert "shadow" not in tspark.catalog.listTables()


# ---------------------------------------------------------------------------
# the mesh lane
# ---------------------------------------------------------------------------

MESH_QUERIES = {
    "union_grouped": SET_OPS["union_grouped"],
    "union_all_strings": SET_OPS["union_strings"] + " ORDER BY id",
    "in_subquery": SUBQUERIES["in"],
    "scalar_correlated": SUBQUERIES["scalar_correlated"],
    "not_exists": SUBQUERIES["not_exists"],
    "intersect_strings": SET_OPS["intersect_strings"],
    # a keyless first() (the non-aggregate scalar subquery) raised on the
    # mesh: the global aggregate reduces buffers and gathers no row
    "non_aggregate_scalar": SUBQUERIES["non_aggregate_scalar"],
    # each scalar subquery is a cross join against a broadcast one-row
    # aggregate, which multiplied the probe's capacity by every shard's
    # summed capacity (32 at 4 shards): q9's fifteen could not allocate
    "many_scalar_subqueries":
        "SELECT k, " + ", ".join(
            f"(SELECT {f}(w) FROM u) AS s{i}" for i, f in
            enumerate(["MAX", "MIN", "SUM", "AVG", "COUNT", "MAX", "MIN",
                       "SUM"])) + " FROM t ORDER BY k",
}


@pytest.mark.parametrize("name", sorted(MESH_QUERIES))
def test_mesh_lane_matches_single_device(spark, tspark, views, name):
    """At ``spark.tpu.mesh.shards = 4`` the port's rows equal its
    single-device lane's and the reference's."""
    sql = MESH_QUERIES[name]
    ordered = "ORDER BY" in sql
    local = both(spark, tspark, sql, ordered)
    tspark.conf.set("spark.tpu.mesh.shards", "4")
    try:
        mesh = tspark.sql(sql).collect()
    finally:
        tspark.conf.set("spark.tpu.mesh.shards", "1")
    assert_rows_equal(local, mesh, rtol=RTOL, ordered=ordered)


def test_ports_own_q3_text_is_the_references():
    from spark_tpu.tpcds.queries import QUERIES
    from spark_tpu_torch.testing import Q3_SQL
    assert Q3_SQL == QUERIES["q3"]
    assert TT.type_for_name("decimal(7,2)") == TT.DecimalType(7, 2)


def test_chip_smoke_sql_queries_match_oracles_and_reference(spark, tspark):
    """The SQL queries ``chip_smoke.py`` runs on the card, at a few
    thousand rows: the port's rows equal their numpy oracles and the
    reference's — except the scalar subquery, which compares a decimal
    column with a double (ROADMAP §3: the reference compares the decimal's
    held cents; ``test_decimal_comparison_rescales``)."""
    import jax.numpy as jnp
    from spark_tpu_torch.testing import (HASH_AGG_SQL, Q3_SQL, SQL_QUERIES,
                                         hash_agg_oracle, hash_agg_table,
                                         q3_oracle, q3_tables,
                                         register_sql_tables,
                                         register_sql_udfs)
    hash_table = hash_agg_table(4096, 64)
    tables = q3_tables(n_sales=60000, n_items=2000)
    for s, T, ops in ((spark, RT, jnp), (tspark, TT, torch)):
        register_sql_tables(s, hash_table, tables, T)
        register_sql_udfs(s, ops)
    queries = dict(SQL_QUERIES)
    queries["hash-agg"] = (HASH_AGG_SQL, lambda t: hash_agg_oracle(hash_table),
                           False)
    queries["q3"] = (Q3_SQL, q3_oracle, True)
    try:
        for name, (sql, oracle, ordered) in queries.items():
            want = oracle(tables)
            assert want, name
            if name == "scalar subquery":
                got = tspark.sql(sql).collect()
                assert got != spark.sql(sql).collect()
            else:
                got = both(spark, tspark, sql, ordered)
            rows = [tuple(r) for r in got]
            assert (rows if ordered else sorted(rows)) \
                == (want if ordered else sorted(want)), name
    finally:
        for s in (spark, tspark):
            for v in ("hash_t", "store_sales", "date_dim", "item"):
                s.catalog.dropTempView(v)


def test_decimal_comparison_rescales(spark, tspark):
    """A decimal compared with a double, an integer or a decimal of
    another scale compares VALUES in the port.  The reference compares
    the decimal's held integer (value × 10**scale) with the other side as
    it is (ROADMAP §3), so it keeps 1.25 > 2.0."""
    schema = [("p", "decimal(7,2)"), ("q", "decimal(7,1)"),
              ("f", "double"), ("i", "bigint")]
    data = {"p": np.array([1.25, 100.5, 3.0]), "q": np.array([1.3, 100.5, 2.0]),
            "f": np.array([1.0, 100.0, 5.0]),
            "i": np.array([1, 100, 3], np.int64)}

    def frame(s, T):
        st = T.StructType([T.StructField(c, T.type_for_name(t))
                           for c, t in schema])
        s.createDataFrame(data, schema=st).createOrReplaceTempView("dec")

    frame(spark, RT)
    frame(tspark, TT)
    cases = {
        "p > 2.0": [100.5, 3.0], "p > f": [1.25, 100.5], "p > 2": [100.5, 3.0],
        "p > q": [3.0], "p = q": [100.5], "p >= i": [1.25, 100.5, 3.0],
        "p IN (1.25, 3)": [1.25, 3.0], "p BETWEEN 1 AND 4": [1.25, 3.0],
        "p <=> 3": [3.0],
        "p > (SELECT AVG(p) FROM dec)": [100.5],
    }
    try:
        for cond, want in cases.items():
            sql = f"SELECT p FROM dec WHERE {cond}"
            assert [r[0] for r in tspark.sql(sql).collect()] == want, cond
        assert [r[0] for r in spark.sql(
            "SELECT p FROM dec WHERE p > 2.0").collect()] == [1.25, 100.5, 3.0]
    finally:
        spark.catalog.dropTempView("dec")
        tspark.catalog.dropTempView("dec")
