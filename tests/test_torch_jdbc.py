"""The port's jdbc source against the JAX package's
(``tests/test_jdbc.py``, case by case): the same sqlite file read through
both packages gives equal rows and schemas; the partition predicates,
the pushed WHERE and the write modes are the same; a table the port
writes is the table the JAX package writes, DDL and rows."""

import sqlite3

import numpy as np
import pytest

from spark_tpu import jdbc as RJ
from spark_tpu.expressions import AnalysisException as RAnalysis
from spark_tpu.sql import functions as RF
from spark_tpu_torch import config as TC
from spark_tpu_torch import jdbc as TJ
from spark_tpu_torch.expressions import AnalysisException as TAnalysis
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql.session import SparkSession as TSession


@pytest.fixture(scope="module")
def tspark(tmp_path_factory):
    s = TSession(TC.Conf({
        "spark.torch.device": "cpu",
        "spark.sql.warehouse.dir": str(tmp_path_factory.mktemp("wh"))}))
    yield s
    s.stop()


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """The JAX test's table: 500 rows of (id, dept, salary, age) from
    seed 7, with NULL ids and NULL depts."""
    path = tmp_path_factory.mktemp("jdbc") / "store.db"
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE emp (id INTEGER, dept TEXT, salary REAL, "
                 "age INTEGER)")
    rng = np.random.default_rng(7)
    rows = []
    for i in range(500):
        dept = ["eng", "sales", "hr"][i % 3]
        rows.append((i if i % 11 else None, dept if i % 7 else None,
                     float(rng.normal(50.0, 12.0)),
                     int(rng.integers(21, 65))))
    conn.executemany("INSERT INTO emp VALUES (?,?,?,?)", rows)
    conn.commit()
    conn.close()
    return f"jdbc:sqlite:{path}", rows


def _rows(df):
    return sorted((tuple(r) for r in df.collect()),
                  key=lambda t: tuple((v is None, v) for v in t))


def _schema(df):
    return [(f.name, f.dataType.simpleString()) for f in df.schema.fields]


def _both(spark, tspark, build):
    """``build(session, F)`` in both packages: equal rows and schema."""
    ref, got = build(spark, RF), build(tspark, TF)
    assert _schema(got) == _schema(ref)
    assert _rows(got) == _rows(ref)
    return _rows(got)


READS = {
    "whole-table": lambda s, F, url: s.read.jdbc(url, "emp"),
    "stride-partitions": lambda s, F, url: s.read.jdbc(
        url, "emp", column="id", lowerBound=100, upperBound=400,
        numPartitions=4),
    "explicit-predicates": lambda s, F, url: s.read.jdbc(
        url, "emp", predicates=["age < 40", "age >= 40"]),
    "pushdown": lambda s, F, url: (
        s.read.jdbc(url, "emp")
        .filter((F.col("age") >= 30) & (F.col("dept") == "eng"))
        .groupBy("dept").agg(F.sum("age").alias("s"))),
    "query-option": lambda s, F, url: (
        s.read.format("jdbc").option("url", url)
        .option("query", "SELECT dept, COUNT(*) AS n FROM emp "
                         "WHERE dept IS NOT NULL GROUP BY dept")
        .load(url).orderBy("dept")),
    "projection": lambda s, F, url: s.read.jdbc(url, "emp")
    .select("dept", "age").where(F.col("id").isNull()),
}


@pytest.mark.parametrize("case", sorted(READS))
def test_reads_match_reference(spark, tspark, db, case):
    url, rows = db
    got = _both(spark, tspark, lambda s, F: READS[case](s, F, url))
    if case in ("whole-table", "stride-partitions", "explicit-predicates"):
        assert len(got) == len(rows)     # every row exactly once


@pytest.mark.parametrize("opts", [
    {},
    {"partitioncolumn": "id", "lowerbound": "100", "upperbound": "400",
     "numpartitions": "4"},
    {"partitioncolumn": "id", "lowerbound": "0", "upperbound": "3",
     "numpartitions": "7"},
    {"predicates": "age < 40\x1fage >= 40"},
])
def test_partition_predicates_match_reference(opts):
    assert TJ.partition_predicates(opts) == RJ.partition_predicates(opts)


def test_pushed_where_and_select_match_reference():
    pushed = [("age", ">=", 30), ("dept", "==", "eng"),
              ("dept", "<", "x"), ("age", "!=", 3), ("k", "<=", 7.9)]
    opts = {"dbtable": "emp"}
    assert TJ._pushed_sql(pushed) == RJ._pushed_sql(pushed)
    for cols in (None, [], ["id", "age"]):
        assert TJ._select_sql(opts, cols, pushed, '"id" < 5', 10) \
            == RJ._select_sql(opts, cols, pushed, '"id" < 5', 10)


def test_pushdown_reaches_the_relation(tspark, db):
    """The port's optimizer pushes the filter into the jdbc relation
    (``pushed_filters``), as the JAX package's does."""
    from spark_tpu_torch.sql.logical import FileRelation
    from spark_tpu_torch.sql.planner import QueryExecution
    url, _rows_ = db
    df = (tspark.read.jdbc(url, "emp")
          .filter((TF.col("age") >= 30) & (TF.col("dept") == "eng")))
    qe = QueryExecution(tspark, df._plan)

    def rels(n, out):
        if isinstance(n, FileRelation):
            out.append(n)
        for c in n.children:
            rels(c, out)
        return out
    rel = rels(qe.optimized, [])[0]
    assert ("age", ">=", 30) in rel.pushed_filters
    assert ("dept", "==", "eng") in rel.pushed_filters


def test_schema_count_and_eviction_match_reference(db, tmp_path):
    url, rows = db
    opts = {"dbtable": "emp"}
    assert TJ.table_schema(url, opts).names \
        == RJ.table_schema(url, opts).names
    assert TJ.count_rows(url, opts) == RJ.count_rows(url, opts) == len(rows)
    assert TJ.count_rows(f"jdbc:sqlite:{tmp_path}/none.db", opts) is None
    key = (TJ._normalize_url(url), "emp", None)
    assert key in TJ._COUNT_CACHE
    TJ._evict_relation(url, "emp")
    assert key not in TJ._COUNT_CACHE


def _ddl(path, table):
    conn = sqlite3.connect(path)
    try:
        sql = conn.execute("SELECT sql FROM sqlite_master WHERE name = ?",
                           (table,)).fetchone()[0]
        rows = conn.execute(f'SELECT * FROM "{table}"').fetchall()
    finally:
        conn.close()
    return sql, sorted(rows, key=lambda t: tuple((v is None, v)
                                                 for v in t))


def test_write_modes_match_reference(spark, tspark, db, tmp_path):
    """Each package writes the same filtered table into its own file, in
    every mode: the same DDL and rows after each step, and both refuse
    errorifexists."""
    url, _rows_ = db
    outs = {}
    for key, s, F, exc in (("ref", spark, RF, RAnalysis),
                           ("port", tspark, TF, TAnalysis)):
        out = tmp_path / f"{key}.db"
        out_url = f"jdbc:sqlite:{out}"
        src = s.read.jdbc(url, "emp").filter(F.col("age") < 30)
        steps = []
        for mode in ("overwrite", "append", "overwrite", "ignore"):
            src.write.jdbc(out_url, "young", mode=mode)
            steps.append(_ddl(out, "young"))
        with pytest.raises(exc, match="already exists"):
            src.write.jdbc(out_url, "young", mode="errorifexists")
        outs[key] = steps
    assert outs["port"] == outs["ref"]
    n = len(outs["port"][0][1])
    assert [len(r) for _s, r in outs["port"]] == [n, 2 * n, n, n]


def test_port_writes_what_the_reference_reads(spark, tspark, tmp_path):
    """A table written by the port reads back through the JAX package
    (and the port) row for row, into a fresh database file."""
    cols = {"n": [1, 2, 3], "s": ["a", None, "c"], "x": [0.5, 1.5, None]}
    out = tmp_path / "fresh.db"                 # does NOT exist
    url = f"jdbc:sqlite:{out}"
    tspark.createDataFrame(cols).write.jdbc(url, "t", mode="overwrite")
    assert _rows(spark.read.jdbc(url, "t")) \
        == _rows(tspark.read.jdbc(url, "t")) \
        == [(1, "a", 0.5), (2, None, 1.5), (3, "c", None)]


def test_append_binds_by_column_name(tspark, tmp_path):
    db = tmp_path / "order.db"
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (id INTEGER, name TEXT)")
    conn.execute("INSERT INTO t VALUES (1, 'a')")
    conn.commit()
    conn.close()
    url = f"jdbc:sqlite:{db}"
    tspark.createDataFrame({"name": ["b"], "id": [2]}).write.jdbc(
        url, "t", mode="append")
    got = sorted((r["id"], r["name"])
                 for r in tspark.read.jdbc(url, "t").collect())
    assert got == [(1, "a"), (2, "b")]


def test_nulls_declared_schema_and_stream(spark, tspark, tmp_path):
    """A stride partition of only NULLs concatenates with typed ones; a
    declared schema is the scan's cast target; a relation above
    ``maxBatchRows`` streams — each as the JAX package does."""
    db = tmp_path / "nulls.db"
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (k INTEGER, v INTEGER)")
    conn.executemany("INSERT INTO t VALUES (?,?)",
                     [(i, None) for i in range(300)]
                     + [(i, i * 10) for i in range(300, 320)])
    conn.commit()
    conn.close()
    url = f"jdbc:sqlite:{db}"
    _both(spark, tspark, lambda s, F: s.read.jdbc(
        url, "t", column="k", lowerBound=0, upperBound=320,
        numPartitions=2))
    got = _both(spark, tspark, lambda s, F: (
        s.read.format("jdbc").option("url", url).option("dbtable", "t")
        .schema("k long, v long").load(url)))
    assert got[-1] == (319, 3190) and isinstance(got[-1][1], int)
    key = "spark.tpu.scan.maxBatchRows"
    old = tspark.conf.get(key)
    tspark.conf.set(key, "64")
    try:
        df = (tspark.read.jdbc(url, "t").groupBy((TF.col("k") % 3)
                                                 .alias("g"))
              .agg(TF.count("v").alias("n")).orderBy("g"))
        assert [tuple(r) for r in df.collect()] == [
            (g, sum(1 for i in range(300, 320) if i % 3 == g))
            for g in range(3)]
    finally:
        tspark.conf.set(key, str(old))


def test_jdbc_joins_with_files(tspark, db, tmp_path):
    """A jdbc relation is an ordinary relation: joinable against a
    parquet one the port wrote."""
    url, rows = db
    p = str(tmp_path / "bonus")
    tspark.createDataFrame({"dept": ["eng", "sales", "hr"],
                            "bonus": [3, 2, 1]}).write.parquet(p)
    df = (tspark.read.jdbc(url, "emp").join(tspark.read.parquet(p),
                                            on="dept")
          .groupBy("dept").agg(TF.count("*").alias("n"),
                               TF.max("bonus").alias("b")).orderBy("dept"))
    want = {}
    for _i, dept, _s, _a in rows:
        if dept is not None:
            want[dept] = want.get(dept, 0) + 1
    bonus = {"eng": 3, "sales": 2, "hr": 1}
    assert [tuple(r) for r in df.collect()] == [
        (d, want[d], bonus[d]) for d in sorted(want)]


@pytest.mark.parametrize("read,match", [
    (lambda s, url: s.read.jdbc(url, "emp_typo"), "no such table"),
    (lambda s, url: s.read.jdbc("jdbc:sqlite::memory:", "t"), "memory"),
    (lambda s, url: s.read.jdbc(url, "emp", column="id"), "together"),
])
def test_error_discipline_matches_reference(spark, tspark, db, read, match):
    url, _rows_ = db
    with pytest.raises(RAnalysis, match=match):
        read(spark, url)
    with pytest.raises(TAnalysis, match=match):
        read(tspark, url)
