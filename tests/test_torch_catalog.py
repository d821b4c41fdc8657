"""The port's persistent catalog, ANALYZE TABLE and the cost-based join
order from file statistics, against ``spark_tpu``: the counterparts of
``tests/test_catalog.py``, ``tests/test_analyze_table.py`` (without the
jdbc case, which comes with the jdbc source) and ``tests/test_cbo_ndv.py``.

Each package runs the same statements in a warehouse of its own under
one temporary directory; files a test reads are written once, from numpy
data made from a seed, and read by both.  Results are compared as
batches (data under the masks, the masks, ``row_valid``, decoded
dictionaries, row order), ANALYZE statistics as dicts, and the CBO
cases' join orders as the lists of their base relations.
"""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq
import pytest

import spark_tpu.config as RC
from spark_tpu import io as rio
from spark_tpu.expressions import AnalysisException as RAnalysisException
from spark_tpu.sql import logical as RL
from spark_tpu.sql.planner import QueryExecution as RQE
from spark_tpu_torch import config as TC
from spark_tpu_torch import io as tio
from spark_tpu_torch.expressions import AnalysisException
from spark_tpu_torch.sql import logical as TL
from spark_tpu_torch.sql.planner import QueryExecution as TQE
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import assert_parts_equal, batch_parts


@pytest.fixture()
def wh(spark, tmp_path):
    """(reference session, port session), each on a warehouse of its own.
    The reference side is a sibling of the shared conftest session, so no
    temp view another test file left there (a ``t`` of its own) hides a
    table of these cases."""
    r = spark.newSession()
    r.conf.set(RC.WAREHOUSE_DIR.key, str(tmp_path / "rwh"))
    t = TSession(TC.Conf({"spark.torch.device": "cpu",
                          "spark.sql.warehouse.dir": str(tmp_path / "twh")}))
    yield r, t
    t.stop()


def both(wh, sql):
    """Run ``sql`` in both sessions; equal results as batches."""
    r, t = wh
    assert_parts_equal(batch_parts(r.sql(sql)._execute()),
                       batch_parts(t.sql(sql)._execute()))


def each(wh, sql):
    for s in wh:
        s.sql(sql)


def rows(df):
    return sorted(tuple(r) for r in df.collect())


# ---------------------------------------------------------------------------
# tests/test_catalog.py counterparts
# ---------------------------------------------------------------------------

def test_ctas_roundtrip(wh):
    r, t = wh
    for s in wh:
        s.range(6).createOrReplaceTempView("src")
    each(wh, "CREATE TABLE t1 USING parquet AS SELECT id, id * 2 AS d "
             "FROM src")
    both(wh, "SELECT * FROM t1")
    assert rows(t.sql("SELECT * FROM t1")) == [(i, 2 * i) for i in range(6)]
    # survives in a sibling session sharing the warehouse
    t2 = t.newSession()
    assert rows(t2.sql("SELECT d FROM t1")) == [(2 * i,) for i in range(6)]
    each(wh, "DROP TABLE t1")
    with pytest.raises(AnalysisException):
        t.sql("SELECT * FROM t1").collect()
    with pytest.raises(RAnalysisException):
        r.sql("SELECT * FROM t1").collect()


def test_databases(wh):
    r, t = wh
    each(wh, "CREATE DATABASE db1")
    assert t.catalog.list_databases() == r.catalog.list_databases() \
        == ["default", "db1"]
    for s in wh:
        s.range(3).createOrReplaceTempView("src")
    each(wh, "CREATE TABLE db1.t USING parquet AS SELECT id FROM src")
    both(wh, "SELECT * FROM db1.t")
    each(wh, "USE db1")
    both(wh, "SELECT * FROM t")
    both(wh, "SHOW DATABASES")
    each(wh, "USE default")
    each(wh, "DROP DATABASE db1")
    assert "db1" not in t.catalog.list_databases()
    with pytest.raises(AnalysisException):
        t.sql("CREATE DATABASE default")
    t.sql("CREATE DATABASE IF NOT EXISTS default")


def test_empty_table_then_insert(wh):
    each(wh, "CREATE TABLE et (a bigint, b string) USING parquet")
    both(wh, "SELECT * FROM et")
    for s in wh:
        s.range(3).createOrReplaceTempView("src3")
    each(wh, "INSERT INTO et SELECT id AS a, 'x' AS b FROM src3")
    both(wh, "SELECT * FROM et ORDER BY a")
    each(wh, "INSERT INTO et SELECT id AS a, 'y' AS b FROM src3")
    both(wh, "SELECT * FROM et ORDER BY b, a")
    each(wh, "INSERT OVERWRITE et SELECT id AS a, 'z' AS b FROM src3")
    both(wh, "SELECT b FROM et")
    assert rows(wh[1].sql("SELECT b FROM et")) == [("z",)] * 3
    each(wh, "DROP TABLE et")


def test_save_as_table_and_show(wh):
    r, t = wh
    data = {"k": np.arange(4, dtype=np.int64), "v": ["a", "b", "c", "d"]}
    for s in wh:
        s.createDataFrame(data).write.saveAsTable("sat")
    assert rows(t.read.table("sat")) == [(0, "a"), (1, "b"), (2, "c"),
                                         (3, "d")]
    both(wh, "SELECT * FROM sat")
    # the persistent rows of SHOW TABLES (the shared reference session
    # holds other tests' temp views)
    shown = [[tuple(x) for x in s.sql("SHOW TABLES").collect()
              if x[1] == "false"] for s in wh]
    assert shown[0] == shown[1] == [("sat", "false")]
    with pytest.raises(AnalysisException):
        t.createDataFrame(data).write.saveAsTable("sat")
    t.createDataFrame(data).write.mode("overwrite").saveAsTable("sat")
    assert rows(t.read.table("sat")) == rows(r.read.table("sat"))
    each(wh, "DROP TABLE sat")


def test_insert_overwrite_self_reference(wh):
    """INSERT OVERWRITE t SELECT ... FROM t reads before clearing; a
    failing query, or one of the wrong arity, leaves the table as it
    was."""
    r, t = wh
    for s in wh:
        s.range(3).createOrReplaceTempView("srcio")
    each(wh, "CREATE TABLE io USING parquet AS SELECT id FROM srcio")
    each(wh, "INSERT OVERWRITE io SELECT id + 10 FROM io")
    both(wh, "SELECT * FROM io")
    assert rows(t.sql("SELECT * FROM io")) == [(10,), (11,), (12,)]
    with pytest.raises(AnalysisException):
        t.sql("INSERT OVERWRITE io SELECT no_col FROM srcio")
    with pytest.raises(AnalysisException):
        t.sql("INSERT INTO io SELECT id, id FROM srcio")
    assert rows(t.sql("SELECT * FROM io")) == [(10,), (11,), (12,)]
    each(wh, "DROP TABLE io")


def test_create_or_replace_table(wh):
    for s in wh:
        s.range(2).createOrReplaceTempView("srccr")
    each(wh, "CREATE TABLE cr USING parquet AS SELECT id FROM srccr")
    each(wh, "CREATE OR REPLACE TABLE cr USING parquet "
             "AS SELECT id * 5 AS id FROM srccr")
    both(wh, "SELECT * FROM cr")
    assert rows(wh[1].sql("SELECT * FROM cr")) == [(0,), (5,)]
    each(wh, "DROP TABLE cr")


@pytest.mark.parametrize("how", ["sql_view", "dataframe_view"])
def test_temp_view_shadows_table(wh, how):
    """A temp view may shadow a table of the same name; DROP TABLE drops
    the view first, then the table."""
    for s in wh:
        s.range(2).createOrReplaceTempView("src")
    each(wh, "CREATE TABLE sh USING parquet AS SELECT id FROM src")
    for s in wh:
        if how == "sql_view":
            s.sql("CREATE TEMP VIEW sh AS SELECT 42 AS id")
        else:
            s.createDataFrame({"id": np.array([99], np.int64)}) \
                .createOrReplaceTempView("sh")
    both(wh, "SELECT * FROM sh")
    each(wh, "DROP TABLE sh")                 # the VIEW
    both(wh, "SELECT * FROM sh ORDER BY id")
    assert rows(wh[1].sql("SELECT * FROM sh")) == [(0,), (1,)]
    each(wh, "DROP TABLE sh")


def test_csv_table_and_partitioned_table(wh):
    """Catalog tables in another format and partitioned: saveAsTable
    writes ``partitionBy`` directories, and INSERT appends part files."""
    r, t = wh
    data = {"k": np.arange(8, dtype=np.int64) % 3,
            "v": np.arange(8, dtype=np.int64)}
    for s in wh:
        s.createDataFrame(data).write.partitionBy("k").saveAsTable("pt")
        s.catalog.save_table("ct", s.createDataFrame(data), fmt="csv",
                             mode="overwrite",
                             options={"header": "true",
                                      "inferschema": "true"})
    both(wh, "SELECT k, sum(v) AS s FROM pt GROUP BY k ORDER BY k")
    both(wh, "SELECT * FROM ct ORDER BY v")
    assert sorted(os.listdir(t.catalog.table_path("pt"))) == \
        sorted(os.listdir(r.catalog.table_path("pt")))


# ---------------------------------------------------------------------------
# tests/test_analyze_table.py counterparts
# ---------------------------------------------------------------------------

@pytest.fixture()
def csv_view(wh, tmp_path):
    """The same csv file as a temp view ``analyze_me`` in both sessions."""
    d = tmp_path / "t.csv"
    d.mkdir()
    pacsv.write_csv(pa.table({"k": np.arange(500, dtype=np.int64) % 40,
                              "v": np.arange(500, dtype=np.int64) * 3}),
                    d / "part-0.csv")
    dfs = []
    for s in wh:
        df = (s.read.option("header", "true").option("inferschema", "true")
              .csv(str(d)))
        df.createOrReplaceTempView("analyze_me")
        dfs.append(df)
    return dfs


def _rel(df):
    rel = df._plan
    while isinstance(rel, (RL.SubqueryAlias, TL.SubqueryAlias)):
        rel = rel.children[0]
    return rel


def test_analyze_collects_and_registers(wh, csv_view):
    both(wh, "ANALYZE TABLE analyze_me COMPUTE STATISTICS FOR ALL COLUMNS")
    rdf, tdf = csv_view
    st = tio.analyzed_stats(_rel(tdf))
    ref = rio.analyzed_stats(_rel(rdf))
    assert {k: v for k, v in st.items() if k != "key"} == \
        {k: v for k, v in ref.items() if k != "key"}
    assert st["rows"] == 500
    assert st["columns"]["k"]["min"] == 0 and st["columns"]["k"]["max"] == 39
    assert st["columns"]["v"]["max"] == 499 * 3
    assert st["columns"]["k"]["null_count"] == 0
    assert abs(st["columns"]["k"]["ndv"] - 40) <= 4       # approx
    # the optimizer's statistics probes now see the csv relation
    rel = _rel(tdf)
    assert tio.file_column_stats(rel)["k"]["max"] == 39
    assert 30 <= tio.file_column_ndv(rel, ["k"])["k"] <= 50
    assert tio.file_row_count(rel) == 500


def test_analyze_specific_columns(wh, csv_view):
    r, t = wh
    each(wh, "ANALYZE TABLE analyze_me COMPUTE STATISTICS FOR COLUMNS k")
    assert list(tio.analyzed_stats(_rel(csv_view[1]))["columns"]) == ["k"]
    for s, exc in ((r, RAnalysisException), (t, AnalysisException)):
        with pytest.raises(exc, match="no such column"):
            s.sql("ANALYZE TABLE analyze_me COMPUTE STATISTICS "
                  "FOR COLUMNS nope")


def test_analyze_persists_with_catalog_table(wh):
    r, t = wh
    outs = []
    for s, pkg in ((r, rio), (t, tio)):
        df = s.createDataFrame({"a": np.arange(100, dtype=np.int64)})
        s.catalog.save_table("an_tbl", df, fmt="csv", mode="overwrite",
                             options={"header": "true",
                                      "inferschema": "true"})
        out = s.sql("ANALYZE TABLE an_tbl COMPUTE STATISTICS "
                    "FOR ALL COLUMNS").collect()
        assert out[0]["persisted"] == "true"
        # a fresh lookup (a fresh registry) re-registers from _meta.json
        pkg._ANALYZED_STATS.clear()
        st = pkg.analyzed_stats(s.catalog.lookup("an_tbl"))
        assert st is not None and st["rows"] == 100
        assert st["columns"]["a"]["max"] == 99
        outs.append({k: v for k, v in st.items() if k != "key"})
        s.catalog.drop_table("an_tbl")
    assert outs[0] == outs[1]


def test_stale_stats_dropped_on_file_change(wh):
    for s, pkg in zip(wh, (rio, tio)):
        df = s.createDataFrame({"a": np.arange(50, dtype=np.int64)})
        s.catalog.save_table("an_stale", df, fmt="csv", mode="overwrite",
                             options={"header": "true",
                                      "inferschema": "true"})
        s.sql("ANALYZE TABLE an_stale COMPUTE STATISTICS FOR ALL COLUMNS")
        # more data AFTER the analyze: the files change
        s.createDataFrame({"a": np.arange(50, 500, dtype=np.int64)}) \
            .write.mode("append").option("header", "true").format("csv") \
            .save(s.catalog.table_path("an_stale"))
        pkg._ANALYZED_STATS.clear()
        assert pkg.analyzed_stats(s.catalog.lookup("an_stale")) is None
        assert s.sql("SELECT count(*) FROM an_stale").collect()[0][0] == 500
        s.catalog.drop_table("an_stale")


def test_rows_only_refresh_preserves_column_stats(wh, csv_view):
    each(wh, "ANALYZE TABLE analyze_me COMPUTE STATISTICS FOR COLUMNS k")
    each(wh, "ANALYZE TABLE analyze_me COMPUTE STATISTICS")
    for df, pkg in zip(csv_view, (rio, tio)):
        st = pkg.analyzed_stats(_rel(df))
        assert st["rows"] == 500 and list(st["columns"]) == ["k"]


def test_shadow_view_does_not_persist_into_table(wh, tmp_path):
    d = tmp_path / "shadow.csv"
    d.mkdir()
    pacsv.write_csv(pa.table({"z": np.arange(7, dtype=np.int64)}),
                    d / "p.csv")
    for s in wh:
        s.catalog.save_table(
            "an_shadow",
            s.createDataFrame({"a": np.arange(10, dtype=np.int64)}),
            fmt="csv", mode="overwrite",
            options={"header": "true", "inferschema": "true"})
        # a temp view SHADOWS the table with other data
        (s.read.option("header", "true").option("inferschema", "true")
         .csv(str(d)).createOrReplaceTempView("an_shadow"))
        out = s.sql("ANALYZE TABLE an_shadow COMPUTE STATISTICS "
                    "FOR ALL COLUMNS").collect()
        assert out[0]["persisted"] == "false"
        with open(os.path.join(s.catalog.table_path("an_shadow"),
                               "_meta.json")) as f:
            assert "stats" not in json.load(f)
        s.catalog.drop("an_shadow")
        s.catalog.drop_table("an_shadow")


@pytest.mark.parametrize("stmt", ["DESCRIBE EXTENDED analyze_me",
                                  "DESCRIBE TABLE EXTENDED analyze_me",
                                  "DESCRIBE analyze_me"])
def test_describe_extended_shows_stats(wh, csv_view, stmt):
    each(wh, "ANALYZE TABLE analyze_me COMPUTE STATISTICS FOR ALL COLUMNS")
    both(wh, stmt)
    got = wh[1].sql(stmt).collect()
    by_name = {x["col_name"]: x["comment"] for x in got}
    if "EXTENDED" in stmt:
        assert got[-1]["col_name"] == "# rows" and by_name["# rows"] == "500"
        assert "min=0" in by_name["k"] and "max=39" in by_name["k"]
    else:
        assert all(x["comment"] == "" for x in got)


def test_analyze_refuses_a_computed_view(wh):
    r, t = wh
    for s in wh:
        s.range(3).createOrReplaceTempView("cv")
    for s, exc in ((r, RAnalysisException), (t, AnalysisException)):
        with pytest.raises(exc, match="carry statistics"):
            s.sql("ANALYZE TABLE cv COMPUTE STATISTICS")


# ---------------------------------------------------------------------------
# tests/test_cbo_ndv.py counterparts
# ---------------------------------------------------------------------------

@pytest.fixture()
def star(wh, tmp_path):
    """A small star: a fact of 4,096 rows, a clean PK dimension and an
    EXPLODING one (60 rows over 5 distinct join keys: joining it early
    multiplies the fact 12x), each a parquet file read by both
    sessions."""
    rng = np.random.default_rng(7)
    n = 4096
    tables = {
        "fact": {"k_good": rng.integers(0, 500, n),
                 "k_bad": rng.integers(0, 5, n),
                 "v": rng.integers(0, 100, n)},
        "dim_good": {"g_k": np.arange(500, dtype=np.int64),
                     "g_tag": np.arange(500, dtype=np.int64) % 7},
        "dim_bad": {"b_k": rng.integers(0, 5, 60).astype(np.int64),
                    "b_w": np.arange(60, dtype=np.int64)},
    }
    for name, cols in tables.items():
        p = str(tmp_path / f"{name}.parquet")
        pq.write_table(pa.table(cols), p)
        for s in wh:
            s.read.parquet(p).createOrReplaceTempView(name)
    return tables


def test_ndv_estimates(spark, wh, tmp_path):
    rng = np.random.default_rng(5)
    p = str(tmp_path / "nd.parquet")
    pq.write_table(pa.table({
        "unique_id": np.arange(50_000, dtype=np.int64),
        "enum": rng.integers(0, 12, 50_000)}), p, row_group_size=8192)
    r, t = wh
    rel = t.read.parquet(p)._plan
    assert isinstance(rel, TL.FileRelation)
    cols = ["unique_id", "enum", "missing"]
    ndv = tio.file_column_ndv(rel, cols)
    assert dict(ndv) == dict(rio.file_column_ndv(r.read.parquet(p)._plan,
                                                 cols))
    assert 10 <= ndv["enum"] <= 14                       # saturated domain
    assert 25_000 <= ndv["unique_id"] <= 100_000         # scales to total
    assert "missing" not in ndv


def _join_order(session, L, QE, sql):
    """Base relations in left-deep join order of the optimized plan."""
    plan = QE(session, session.sql(sql)._plan).optimized
    order = []

    def walk(n):
        if isinstance(n, L.Join):
            walk(n.children[0])
            walk(n.children[1])
        elif isinstance(n, L.FileRelation):
            order.append(n.paths[0].rsplit("/", 1)[-1].split(".")[0])
        else:
            for c in n.children:
                walk(c)
    walk(plan)
    return order


STAR_QUERIES = {
    # the clean PK dim attaches BEFORE the fan-out dim whatever the FROM
    # order; the fact (largest) is the base
    "low_fanout_first": """
        SELECT g_tag, SUM(v) AS s, COUNT(*) AS c
        FROM fact, dim_bad, dim_good
        WHERE k_bad = b_k AND k_good = g_k
        GROUP BY g_tag ORDER BY g_tag""",
    # the fan-out dim filtered to a sliver (by footer stats) now attaches
    # first: selective dims shrink the running cardinality earliest
    "filtered_dim_first": """
        SELECT SUM(v) AS s
        FROM fact, dim_bad, dim_good
        WHERE k_bad = b_k AND k_good = g_k AND b_w < 3""",
}


@pytest.mark.parametrize("name", sorted(STAR_QUERIES))
def test_join_reorder_from_file_statistics(wh, star, name):
    r, t = wh
    sql = STAR_QUERIES[name]
    order = _join_order(t, TL, TQE, sql)
    assert order == _join_order(r, RL, RQE, sql)
    assert order[0] == "fact", order
    first, second = ("dim_good", "dim_bad") if name == "low_fanout_first" \
        else ("dim_bad", "dim_good")
    assert order.index(first) < order.index(second), order
    both(wh, sql)
    if name == "low_fanout_first":
        f, g, b = star["fact"], star["dim_good"], star["dim_bad"]
        want = {}
        for kb, kg, v in zip(f["k_bad"], f["k_good"], f["v"]):
            m = int((b["b_k"] == kb).sum())
            tag = int(g["g_tag"][kg])
            s_, c_ = want.get(tag, (0, 0))
            want[tag] = (s_ + m * int(v), c_ + m)
        got = [tuple(x) for x in t.sql(sql).collect()]
        assert got == [(k,) + want[k] for k in sorted(want)]
