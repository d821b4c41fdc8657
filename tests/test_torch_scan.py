"""File scans and writers of the port (``spark_tpu_torch/io.py``) against
``spark_tpu/io.py``: the counterparts of ``tests/test_io.py`` (the
``prefetch_iter`` tests with the streamed scan's, at the end),
``tests/test_orc.py`` and ``tests/test_scan_prune.py`` (without the
streamed row-group case).

Both packages read the SAME files, written from numpy data made from a
seed, and the results are compared as batches: data under the validity
masks, the masks, ``row_valid``, decoded dictionaries and row order
(``testing.assert_parts_equal``; floats bit for bit unless a tolerance is
stated).  Also: the out-of-core boundary (the streamed runners against
the reference's), and three faults of the reference's readers, each held
with both outcomes.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_tpu.config as RC
from spark_tpu import io as rio
from spark_tpu.expressions import AnalysisException as RAnalysisException
from spark_tpu.sql import functions as RF
from spark_tpu_torch import config as TC
from spark_tpu_torch import io as tio
from spark_tpu_torch.expressions import AnalysisException
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql.logical import FileRelation
from spark_tpu_torch.sql.planner import QueryExecution
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import assert_parts_equal, batch_parts


@pytest.fixture(scope="module")
def tspark(tmp_path_factory):
    s = TSession(TC.Conf({
        "spark.torch.device": "cpu",
        "spark.sql.warehouse.dir": str(tmp_path_factory.mktemp("wh"))}))
    yield s
    s.stop()


def same(ref_df, got_df, rtol=0.0):
    """Both results as batches, equal (``assert_parts_equal``)."""
    assert_parts_equal(batch_parts(ref_df._execute()),
                       batch_parts(got_df._execute()), rtol=rtol)


def rows(df):
    return sorted((tuple(r) for r in df.collect()),
                  key=lambda t: tuple(str(x) for x in t))


def sample_data(seed=5, n=6):
    rng = np.random.default_rng(seed)
    return {"id": np.arange(n, dtype=np.int64),
            "grp": list(rng.choice(["a", "b", "c"], n)),
            "x": rng.normal(0.0, 2.0, n)}


@pytest.fixture(params=["port", "reference"])
def writer(request, spark, tspark):
    """(session that writes, name): each file-writing case runs with the
    port's writer and with the reference's."""
    return (tspark if request.param == "port" else spark), request.param


# ---------------------------------------------------------------------------
# tests/test_io.py counterparts
# ---------------------------------------------------------------------------

def test_parquet_roundtrip(spark, tspark, writer, tmp_path):
    w, _name = writer
    p = str(tmp_path / "t.parquet")
    w.createDataFrame(sample_data()).write.parquet(p)
    assert os.path.exists(os.path.join(p, "_SUCCESS"))
    assert sorted(os.listdir(p)) == ["_SUCCESS", "part-00000.parquet"]
    back = tspark.read.parquet(p)
    assert back.schema.names == ["id", "grp", "x"]
    same(spark.read.parquet(p), back)


def test_parquet_overwrite_and_modes(spark, tspark, tmp_path):
    p = str(tmp_path / "m.parquet")
    df = tspark.createDataFrame(sample_data())
    df.write.parquet(p)
    with pytest.raises(AnalysisException):
        df.write.parquet(p)
    df.write.mode("ignore").parquet(p)
    df.write.mode("overwrite").parquet(p)
    assert len(rows(tspark.read.parquet(p))) == 6
    df.write.mode("append").parquet(p)
    assert sorted(os.listdir(p)) == ["_SUCCESS", "part-00000.parquet",
                                     "part-00001.parquet"]
    assert len(rows(tspark.read.parquet(p))) == 12
    same(spark.read.parquet(p), tspark.read.parquet(p))


def test_csv_roundtrip_header(spark, tspark, writer, tmp_path):
    w, _name = writer
    p = str(tmp_path / "t.csv")
    w.createDataFrame(sample_data()).write.option("header", True).csv(p)
    back = tspark.read.csv(p, header=True, inferSchema=True)
    assert back.schema.names == ["id", "grp", "x"]
    same(spark.read.csv(p, header=True, inferSchema=True), back)


def test_csv_no_infer_all_strings(spark, tspark, tmp_path):
    p = str(tmp_path / "s.csv")
    tspark.createDataFrame(sample_data()).write.option("header", True).csv(p)
    back = tspark.read.csv(p, header=True)
    assert all(dt == "string" for _, dt in back.dtypes)
    same(spark.read.csv(p, header=True), back)


def test_json_roundtrip(spark, tspark, writer, tmp_path):
    w, _name = writer
    p = str(tmp_path / "t.json")
    w.createDataFrame(sample_data()).write.json(p)
    back = tspark.read.json(p)
    assert set(back.schema.names) == {"id", "grp", "x"}
    same(spark.read.json(p).select("id", "grp", "x"),
         back.select("id", "grp", "x"))


def test_text_roundtrip(spark, tspark, writer, tmp_path):
    w, _name = writer
    p = str(tmp_path / "t.txt")
    w.createDataFrame({"value": ["hello", "tpu", "world"]}).write.text(p)
    back = tspark.read.text(p)
    assert [r[0] for r in back.collect()] == ["hello", "tpu", "world"]
    same(spark.read.text(p), back)


def test_partitioned_write_and_discovery(spark, tspark, writer, tmp_path):
    w, _name = writer
    p = str(tmp_path / "part.parquet")
    w.createDataFrame(sample_data()).write.partitionBy("grp").parquet(p)
    assert os.path.isdir(os.path.join(p, "grp=a"))
    back = tspark.read.parquet(p)
    assert set(back.schema.names) == {"id", "x", "grp"}
    same(spark.read.parquet(p), back)
    a_ref = spark.read.parquet(p)
    same(a_ref.filter(a_ref["grp"] == "a").select("id", "x"),
         back.filter(back["grp"] == "a").select("id", "x"))


def test_int_partition_values_inferred(spark, tspark, tmp_path):
    data = {"v": [1.0, 2.0, 3.0, 4.0],
            "year": np.array([2020, 2020, 2021, 2021], np.int64)}
    p = str(tmp_path / "byyear")
    tspark.createDataFrame(data).write.partitionBy("year").parquet(p)
    back = tspark.read.parquet(p)
    assert dict(back.dtypes)["year"] == "bigint"
    assert len(back.filter(back["year"] == 2021).collect()) == 2
    ref = spark.read.parquet(p)
    same(ref.filter(ref["year"] == 2021), back.filter(back["year"] == 2021))


def test_sql_over_file_relation(spark, tspark, tmp_path):
    p = str(tmp_path / "q.parquet")
    tspark.createDataFrame(sample_data(n=40)).write.parquet(p)
    q = ("SELECT grp, count(*) AS c, sum(x) AS s FROM filetbl "
         "GROUP BY grp ORDER BY grp")
    spark.read.parquet(p).createOrReplaceTempView("filetbl")
    tspark.read.parquet(p).createOrReplaceTempView("filetbl")
    try:
        # float sums may add in another order: 1e-12
        same(spark.sql(q), tspark.sql(q), rtol=1e-12)
    finally:
        spark.catalog.drop("filetbl")
        tspark.catalog.drop("filetbl")


def test_reader_schema_string(spark, tspark):
    assert tspark.read.schema("a int, b string")._schema.names == \
        spark.read.schema("a int, b string")._schema.names == ["a", "b"]


def test_nulls_roundtrip(spark, tspark, writer, tmp_path):
    w, _name = writer
    df = w.createDataFrame([(1, "x"), (2, None), (None, "z")], ["a", "b"])
    p = str(tmp_path / "n.parquet")
    df.write.parquet(p)
    back = tspark.read.parquet(p)
    assert rows(back) == [(1, "x"), (2, None), (None, "z")]
    same(spark.read.parquet(p), back)


def test_sql_on_file_format_qualified(spark, tspark, tmp_path):
    """SELECT ... FROM parquet.`/path` (ResolveSQLOnFile analog)."""
    p = str(tmp_path / "direct.parquet")
    tspark.createDataFrame({"a": np.arange(10, dtype=np.int64)}) \
        .write.parquet(p)
    q = f"SELECT sum(a) AS s FROM parquet.`{p}`"
    assert tspark.sql(q).collect()[0]["s"] == 45
    same(spark.sql(q), tspark.sql(q))
    with pytest.raises(AnalysisException, match="not found"):
        tspark.sql("SELECT 1 FROM parquet.`/no/such/path`").collect()


def _typed_table(n=64, seed=9):
    """Every engine type a file column maps to, NULLs in each: int8..64,
    float32/64, bool, date32, timestamp[us], decimal(7,2), string."""
    import datetime
    import decimal
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.2
    days = rng.integers(-1000, 20000, n)
    us = rng.integers(0, 2 * 10 ** 15, n)
    cents = rng.integers(-99999, 99999, n)

    def arr(vals, t):
        return pa.array([None if m else v for v, m in zip(vals, nulls)], t)

    epoch = datetime.date(1970, 1, 1)
    return pa.table({
        "i8": arr(rng.integers(-100, 100, n).tolist(), pa.int8()),
        "i16": arr(rng.integers(-3000, 3000, n).tolist(), pa.int16()),
        "i32": arr(rng.integers(-10 ** 9, 10 ** 9, n).tolist(), pa.int32()),
        "i64": arr(rng.integers(-10 ** 15, 10 ** 15, n).tolist(),
                   pa.int64()),
        "f32": arr(rng.normal(size=n).astype(np.float32).tolist(),
                   pa.float32()),
        "f64": arr(rng.normal(size=n).tolist(), pa.float64()),
        "b": arr((rng.random(n) < 0.5).tolist(), pa.bool_()),
        "d": arr([epoch + datetime.timedelta(days=int(x)) for x in days],
                 pa.date32()),
        "ts": arr([int(x) for x in us], pa.timestamp("us")),
        "s": arr([f"w{x}" for x in rng.integers(0, 12, n)], pa.string()),
        "dec": arr([decimal.Decimal(int(c)).scaleb(-2) for c in cents],
                   pa.decimal128(7, 2)),
    }), nulls, cents


def test_every_type_reads_like_arrow(spark, tspark, tmp_path):
    """The vectorized lanes: each column's values and NULLs as arrow holds
    them (dates as int32 days, timestamps as int64 µs, decimals as their
    unscaled int64, strings as sorted-dictionary codes); every column but
    the decimal one equal to the reference's read of the same file."""
    table, nulls, cents = _typed_table()
    p = str(tmp_path / "types.parquet")
    pq.write_table(table, p)
    got = tspark.read.parquet(p)
    types = dict(got.dtypes)
    assert types["dec"] == "decimal(7,2)" and types["d"] == "date" \
        and types["ts"] == "timestamp" and types["i8"] == "tinyint"
    parts = batch_parts(got._execute())
    dec = parts.names.index("dec")
    assert np.array_equal(parts.valids[dec][:len(cents)], ~nulls)
    assert np.array_equal(parts.datas[dec][:len(cents)][~nulls],
                          cents[~nulls])
    cols = [c for c in table.column_names if c != "dec"]
    same(spark.read.parquet(p).select(*cols), got.select(*cols))
    back = str(tmp_path / "types_back.parquet")
    got.write.parquet(back)
    assert pq.read_table(back).equals(table)


# ---------------------------------------------------------------------------
# faults of the reference's readers (ROADMAP §3): the port is right, and
# each test holds both outcomes
# ---------------------------------------------------------------------------

def test_decimal_column_reference_fault(spark, tspark, tmp_path):
    """``spark_tpu/io.py`` ``_table_to_batch`` reads a decimal column
    through Python ``Decimal`` objects and asks them for
    ``scaled_value``, which they do not have: the reference cannot read
    a decimal parquet column.  The port reads its unscaled integers."""
    import decimal
    p = str(tmp_path / "dec.parquet")
    pq.write_table(pa.table({"d": pa.array(
        [decimal.Decimal("1.25"), None, decimal.Decimal("-3.10")],
        pa.decimal128(7, 2))}), p)
    with pytest.raises(AttributeError, match="scaled_value"):
        spark.read.parquet(p).collect()
    assert [r[0] for r in tspark.read.parquet(p).collect()] == \
        [1.25, None, -3.1]


def test_partition_only_projection_reference_fault(spark, tspark, tmp_path):
    """``spark_tpu/io.py`` ``_read_parquet`` reads a file whose pruned
    columns are all partition-directory columns as a 0-column table, and
    a concat of 0-column tables has 0 rows: a filtered count over the
    partition column finds no rows and its partition column comes back
    as an empty bigint, which the reference cannot compare with the
    string literal.  The port carries one column through the concat."""
    p = str(tmp_path / "part.parquet")
    tspark.createDataFrame(sample_data()).write.partitionBy("grp").parquet(p)
    want = sum(1 for g in sample_data()["grp"] if g == "a")
    ref = spark.read.parquet(p)
    with pytest.raises(RAnalysisException, match="cannot compare"):
        ref.filter(ref["grp"] == "a").count()
    got = tspark.read.parquet(p)
    assert got.filter(got["grp"] == "a").count() == want


def test_rewrite_within_one_mtime_tick_reference_fault(spark, tspark,
                                                       tmp_path):
    """The relation caches key on the files' modification time.  A file
    rewritten within one tick of the clock the file system keeps (here:
    its mtime set back to the old value) is served stale by the
    reference, which keys on ``os.path.getmtime`` alone; the port also
    keys on the size, and reads the new file."""
    p = str(tmp_path / "tick.parquet")
    pq.write_table(pa.table({"a": np.arange(3, dtype=np.int64)}), p)
    st = os.stat(p)
    assert spark.read.parquet(p).count() == 3
    assert tspark.read.parquet(p).count() == 3
    # the reference's count() reads the file through the relation cache
    ref_rows = [r[0] for r in spark.read.parquet(p).collect()]
    got_rows = [r[0] for r in tspark.read.parquet(p).collect()]
    pq.write_table(pa.table({"a": np.arange(5, dtype=np.int64)}), p)
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert [r[0] for r in spark.read.parquet(p).collect()] == ref_rows
    assert [r[0] for r in tspark.read.parquet(p).collect()] == \
        got_rows + [3, 4]


# ---------------------------------------------------------------------------
# tests/test_orc.py counterparts
# ---------------------------------------------------------------------------

def orc_data():
    rng = np.random.default_rng(17)
    return {"id": np.arange(500, dtype=np.int64),
            "g": list(rng.choice(["x", "y", "z"], 500)),
            "v": rng.normal(0.0, 2.0, 500),
            "b": rng.integers(0, 2, 500).astype(bool)}


def test_orc_roundtrip(spark, tspark, writer, tmp_path):
    w, _name = writer
    path = str(tmp_path / "t.orc")
    w.createDataFrame(orc_data()).write.orc(path)
    back = tspark.read.orc(path)
    assert back.schema.names == ["id", "g", "v", "b"]
    same(spark.read.orc(path).orderBy("id"), back.orderBy("id"))


def test_orc_matches_parquet_read(spark, tspark, tmp_path):
    op, pp = str(tmp_path / "o.orc"), str(tmp_path / "p.parquet")
    src = tspark.createDataFrame(orc_data())
    src.write.orc(op)
    src.write.parquet(pp)

    def q(df, F):
        return df.groupBy("g").agg(F.sum("v").alias("s"),
                                   F.count("*").alias("c")).orderBy("g")
    same(q(tspark.read.parquet(pp), TF), q(tspark.read.orc(op), TF))
    same(q(spark.read.orc(op), RF), q(tspark.read.orc(op), TF), rtol=1e-12)


def test_orc_schema_without_reading(spark, tspark, tmp_path, monkeypatch):
    """Referencing an ORC table reads its metadata, no stripe."""
    path = str(tmp_path / "s.orc")
    tspark.createDataFrame(orc_data()).write.orc(path)

    def boom(*a, **k):
        raise AssertionError("stripes were read for schema access")
    monkeypatch.setattr(tio, "_read_orc", boom)
    assert tspark.read.orc(path).schema.names == \
        spark.read.orc(path).schema.names == ["id", "g", "v", "b"]


def test_orc_partitioned_roundtrip(spark, tspark, tmp_path):
    path = str(tmp_path / "part.orc")
    tspark.createDataFrame(orc_data()).write.partitionBy("g").orc(path)
    back = tspark.read.orc(path)
    assert "g" in back.schema.names
    same(spark.read.orc(path).groupBy("g").agg(RF.count("*").alias("c"))
         .orderBy("g"),
         back.groupBy("g").agg(TF.count("*").alias("c")).orderBy("g"))


def test_orc_column_pruning(spark, tspark, tmp_path, monkeypatch):
    """A query over one column pushes that pruning into the ORC reader."""
    path = str(tmp_path / "pr.orc")
    data = orc_data()
    tspark.createDataFrame(data).write.orc(path)
    tio.clear_relation_cache()
    seen = {}
    real = tio._read_orc

    def spy(paths, options, columns=None):
        seen["columns"] = columns
        return real(paths, options, columns=columns)
    monkeypatch.setattr(tio, "_read_orc", spy)
    (s,), = tspark.read.orc(path).agg(TF.sum("id").alias("s")).collect()
    assert s == int(data["id"].sum())
    assert seen["columns"] == ["id"]


# ---------------------------------------------------------------------------
# tests/test_scan_prune.py counterparts
# ---------------------------------------------------------------------------

@pytest.fixture()
def wide(tmp_path):
    """A 12-column table written with row groups of 500 rows, sorted by
    ``ord`` so that min/max statistics are selective."""
    n = 4000
    rng = np.random.default_rng(3)
    cols = {"ord": np.arange(n, dtype=np.int64)}
    for i in range(8):
        cols[f"pad{i}"] = rng.normal(size=n)
    cols["grp"] = rng.choice(["a", "b", "c"], n)
    cols["val"] = rng.integers(0, 100, n).astype(np.int64)
    d = tmp_path / "wide.parquet"
    os.makedirs(d)
    pq.write_table(pa.table(cols), d / "part-000.parquet",
                   row_group_size=500)
    return str(d), cols


def _scan(session, pkg_io, path, q):
    """Run ``q(df)`` over the file with the relation cache empty and the
    scan counters at 0; returns the result batch and the counters."""
    pkg_io._relation_cache.clear()
    for k in pkg_io.SCAN_STATS:
        pkg_io.SCAN_STATS[k] = 0
    batch = q(session.read.parquet(path))._execute()
    return batch, {k: pkg_io.SCAN_STATS[k] for k in
                   ("files", "row_groups", "row_groups_skipped", "rows",
                    "columns_read")}


@pytest.mark.parametrize("case", ["pruning", "row_group_skip", "count_star",
                                  "all_skipped"])
def test_scan_counters_match_reference(spark, tspark, wide, case):
    """Column pruning (a 2-column read of the 12-column table), row-group
    skipping (7 of 8 groups), ``count(*)`` over one narrow column and a
    filter that skips every group: results and ``SCAN_STATS`` equal
    across the packages."""
    path, cols = wide

    def q(df, F):
        if case == "pruning":
            return df.groupBy("grp").agg(F.sum("val").alias("sv")) \
                .orderBy("grp")
        if case == "row_group_skip":
            return df.filter(F.col("ord") >= 3500) \
                .agg(F.count("ord").alias("n"), F.sum("val").alias("s"))
        if case == "count_star":
            return df.agg(F.count("*").alias("n"))
        return df.filter(F.col("ord") < 0).agg(F.count("*").alias("n"))

    ref, ref_stats = _scan(spark, rio, path, lambda df: q(df, RF))
    got, got_stats = _scan(tspark, tio, path, lambda df: q(df, TF))
    assert_parts_equal(batch_parts(ref), batch_parts(got))
    assert got_stats == ref_stats
    want = {"pruning": {"columns_read": 2},
            "row_group_skip": {"row_groups_skipped": 7, "rows": 500},
            "count_star": {"columns_read": 1},
            "all_skipped": {"row_groups_skipped": 8, "rows": 0}}[case]
    assert {k: got_stats[k] for k in want} == want
    if case == "row_group_skip":
        sel = cols["ord"] >= 3500
        assert got.to_pylist() == [(500, int(cols["val"][sel].sum()))]


def test_pruned_plan_marks_relation(tspark, wide):
    path, _ = wide
    df = tspark.read.parquet(path).select("ord").filter(TF.col("ord") < 10)
    qe = QueryExecution(tspark, df._plan)
    rels = []

    def walk(n):
        if isinstance(n, FileRelation):
            rels.append(n)
        for c in n.children:
            walk(c)
    walk(qe.optimized)
    assert rels and rels[0].columns == ["ord"]
    assert ("ord", "<", 10) in (rels[0].pushed_filters or [])


def test_pushdown_never_changes_results(spark, tspark, wide):
    """Stats skipping is advisory; an equality band and a string filter
    both survive."""
    path, cols = wide

    def q(session, F):
        return (session.read.parquet(path)
                .filter((F.col("ord") >= 777) & (F.col("ord") < 1234)
                        & (F.col("grp") == "b"))
                .agg(F.count("ord").alias("n")))
    (n,), = q(tspark, TF).collect()
    exp = (cols["ord"] >= 777) & (cols["ord"] < 1234) & (cols["grp"] == "b")
    assert n == int(exp.sum())
    same(q(spark, RF), q(tspark, TF))


def test_window_inputs_survive_pruning(spark, tspark, wide):
    """A WindowExpression's references live in sub_expressions(): pruning
    keeps the window's partition, order and input columns."""
    from spark_tpu.sql.window import Window as RW
    from spark_tpu_torch.sql.window import Window as TW
    path, _ = wide

    def q(session, F, W):
        return (session.read.parquet(path)
                .select(F.col("ord"),
                        F.sum("val").over(W.partitionBy("grp")).alias("sv"))
                .orderBy("ord").limit(5))
    same(q(spark, RF, RW), q(tspark, TF, TW))


def test_footer_column_stats(spark, tspark, wide):
    path, cols = wide
    rel = tspark.read.parquet(path)._plan
    assert isinstance(rel, FileRelation)
    st = tio.file_column_stats(rel)
    assert st == rio.file_column_stats(spark.read.parquet(path)._plan)
    n = len(cols["ord"])
    assert st["ord"] == {"min": 0, "max": n - 1, "null_count": 0,
                         "total": n}
    assert st["grp"]["min"] == "a" and st["grp"]["max"] == "c"


def test_filter_selectivity_shrinks_estimates(spark, tspark, wide):
    from spark_tpu.sql.optimizer import rows_estimate as r_est
    from spark_tpu.sql.planner import QueryExecution as RQE
    from spark_tpu_torch.sql.optimizer import rows_estimate
    path, cols = wide
    n = len(cols["ord"])
    full = tspark.read.parquet(path)
    filtered = full.filter(TF.col("ord") < n // 10)
    est_full = rows_estimate(QueryExecution(tspark, full._plan).analyzed)
    est_f = rows_estimate(QueryExecution(tspark, filtered._plan).analyzed)
    assert est_full == n
    assert 1 <= est_f < n // 5          # ~10% by footer-range selectivity
    rfull = spark.read.parquet(path)
    ref_f = r_est(RQE(spark, rfull.filter(RF.col("ord") < n // 10)._plan)
                  .analyzed)
    assert est_f == ref_f


# ---------------------------------------------------------------------------
# the out-of-core boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["linear", "join", "join_stages_off",
                                  "multibatch_off", "limit_raised",
                                  "mesh"])
def test_out_of_core_boundary(spark, tspark, tmp_path, case):
    """A file above ``spark.tpu.scan.maxBatchRows`` is where both packages
    leave the eager path for their out-of-core runners: a one-child chain
    streams through the multi-batch runner (``linear``; at 2 shards,
    ``mesh``), a join through the stage DAG (``join``), and the answers
    agree.  With ``spark.tpu.multibatch.enabled`` false, or the limit
    above the file, both packages read one batch and agree; a join with
    ``spark.tpu.stages.enabled`` false is eager in both (the multi-batch
    runner takes one-child chains)."""
    from spark_tpu_torch.sql import multibatch as TMB
    p = str(tmp_path / "big.parquet")
    n = 3000
    rng = np.random.default_rng(1)
    tspark.createDataFrame({"k": rng.integers(0, 50, n).astype(np.int64),
                            "v": np.arange(n, dtype=np.int64)}) \
        .write.parquet(p)
    dim = {"k": np.arange(50, dtype=np.int64),
           "w": np.arange(50, dtype=np.int64) * 7}
    conf = {RC.SCAN_MAX_BATCH_ROWS.key: "1000"}
    if case == "join_stages_off":
        conf["spark.tpu.stages.enabled"] = "false"
    if case == "multibatch_off":
        conf[RC.MULTIBATCH_ENABLED.key] = "false"
    if case == "limit_raised":
        conf[RC.SCAN_MAX_BATCH_ROWS.key] = "4096"
    if case == "mesh":
        conf["spark.tpu.mesh.shards"] = "2"
    s = tspark.newSession()
    for k, v in conf.items():
        s.conf.set(k, v)

    def q(session, F):
        df = session.read.parquet(p)
        if case.startswith("join"):
            df = df.join(session.createDataFrame(dim), "k")
            return df.groupBy("k").agg(F.sum("w").alias("s")).orderBy("k")
        return df.groupBy("k").agg(F.sum("v").alias("s")).orderBy("k")

    TMB.reset_stream_stats()
    streamed = case in ("linear", "join", "mesh")
    old = {k: spark.conf.get(k, None) for k in conf}
    for k, v in conf.items():
        spark.conf.set(k, v)
    try:
        if streamed:
            # the merged result's capacity is each runner's own: rows
            from spark_tpu_torch.testing import assert_rows_equal
            assert_rows_equal(q(spark, RF).collect(), q(s, TF).collect())
        else:
            same(q(spark, RF), q(s, TF))
    finally:
        for k, v in old.items():
            if v is None:
                spark.conf.unset(k)
            else:
                spark.conf.set(k, v)
    # three batches of at most 1,000 rows each went through a step
    assert (TMB.STREAM_STATS["batches"] == 3) == streamed


def test_between_bounds_skip_row_groups(spark, tspark, wide):
    """``col BETWEEN lo AND hi`` pushes both bounds, as Spark's optimizer
    does: the port skips the row groups outside them, where the reference
    (which pushes no BETWEEN) reads all 8; the answers are equal."""
    path, cols = wide

    def q(df, F):
        return df.filter(F.col("ord").between(1000, 1499)) \
            .agg(F.count("ord").alias("n"), F.sum("val").alias("s"))
    ref, ref_stats = _scan(spark, rio, path, lambda df: q(df, RF))
    got, got_stats = _scan(tspark, tio, path, lambda df: q(df, TF))
    assert_parts_equal(batch_parts(ref), batch_parts(got))
    assert ref_stats["row_groups_skipped"] == 0
    assert got_stats["row_groups_skipped"] == 7 and got_stats["rows"] == 500
    sel = (cols["ord"] >= 1000) & (cols["ord"] <= 1499)
    assert got.to_pylist() == [(500, int(cols["val"][sel].sum()))]
    text = f"SELECT count(*) FROM parquet.`{path}` WHERE ord BETWEEN " \
           "1000 AND 1499"
    tio.reset_scan_stats()
    assert tspark.sql(text).collect()[0][0] == 500
    assert tio.SCAN_STATS["row_groups_skipped"] == 7


def test_decimal_write_reference_fault(spark, tspark, tmp_path):
    """``spark_tpu/io.py`` ``DataFrameWriter._arrow_table`` builds each
    arrow column from the decoded rows, where a decimal is a Python
    float, which arrow refuses for a decimal128 column: the reference
    cannot write a decimal column.  The port writes the unscaled
    integers, and reads back the same values."""
    import pyarrow.lib
    from spark_tpu import types as RT
    from spark_tpu_torch import types as TT
    vals = np.array([1.25, 2.5, np.nan, -3.1])
    ref = spark.createDataFrame({"d": vals}, schema=RT.StructType(
        [RT.StructField("d", RT.DecimalType(7, 2))]))
    with pytest.raises(pyarrow.lib.ArrowTypeError, match="Decimal"):
        ref.write.parquet(str(tmp_path / "r"))
    got = tspark.createDataFrame({"d": vals}, schema=TT.StructType(
        [TT.StructField("d", TT.DecimalType(7, 2))]))
    got.write.parquet(str(tmp_path / "t"))
    back = pq.read_table(str(tmp_path / "t")).column("d").to_pylist()
    assert [None if v is None else float(v) for v in back] == \
        [1.25, 2.5, None, -3.1]
    assert [r[0] for r in tspark.read.parquet(str(tmp_path / "t"))
            .collect()] == [1.25, 2.5, None, -3.1]


def test_parquet_dimension_broadcasts_on_the_mesh_lane(spark, tspark,
                                                       tmp_path):
    """A small parquet dimension takes the broadcast path at shards > 1:
    the mesh planner estimates a file relation's rows from its footers
    (``SparkStrategies.scala:116``), as the reference does; the answer at
    2 shards equals the single-device one and the reference's."""
    from spark_tpu_torch.parallel import dist as D
    from spark_tpu_torch.parallel.executor import DistributedPlanner
    rng = np.random.default_rng(4)
    fact, dim = str(tmp_path / "fact"), str(tmp_path / "dim")
    pq.write_table(pa.table({"k": rng.integers(0, 40, 2000),
                             "v": np.arange(2000, dtype=np.int64)}), fact)
    pq.write_table(pa.table({"k": np.arange(40, dtype=np.int64),
                             "w": rng.integers(0, 9, 40)}), dim)
    q = (f"SELECT w, sum(v) AS s FROM parquet.`{fact}` f JOIN "
         f"parquet.`{dim}` d ON f.k = d.k GROUP BY w ORDER BY w")
    s = tspark.newSession()
    s.conf.set("spark.tpu.mesh.shards", "2")
    optimized = QueryExecution(s, s.sql(q)._plan).optimized
    physical = DistributedPlanner(s, 2).plan(optimized).physical
    kinds = set()

    def walk(node):
        kinds.add(type(node))
        for c in node.children:
            walk(c)
    walk(physical)
    assert D.DBroadcast in kinds and D.DSkewJoin not in kinds
    got = s.sql(q)
    same(tspark.sql(q), got)
    same(spark.sql(q), got)


@pytest.mark.parametrize("shape", ["flat", "struct"])
def test_to_pandas_matches_reference(spark, tspark, tmp_path, shape):
    """``toPandas`` over a file: the same frame as the reference's (pandas
    is imported by ``io.rows_to_pandas`` only); a struct column comes
    back as Rows."""
    import pandas as pd
    p = str(tmp_path / "tp.parquet")
    tspark.createDataFrame([(1, "x", 0.5), (2, None, None), (None, "z", 2.0)],
                           ["a", "b", "c"]).write.parquet(p)
    if shape == "flat":
        frames = [s.read.parquet(p).toPandas() for s in (spark, tspark)]
        pd.testing.assert_frame_equal(frames[0], frames[1])
        assert list(frames[1].columns) == ["a", "b", "c"]
        return
    ref = spark.read.parquet(p)
    got = tspark.read.parquet(p)
    frames = [df.select("a", F.struct("b", "c").alias("s")).toPandas()
              for df, F in ((ref, RF), (got, TF))]
    assert list(frames[1].columns) == ["a", "s"]
    assert [tuple(r) if r is not None else None for r in frames[1]["s"]] \
        == [tuple(r) if r is not None else None for r in frames[0]["s"]]
    pd.testing.assert_series_equal(frames[0]["a"], frames[1]["a"])


# ---------------------------------------------------------------------------
# the streamed scan: prefetch_iter (tests/test_io.py's cases, both
# packages), scan_file_batches and the global string dictionaries
# ---------------------------------------------------------------------------

@pytest.fixture(params=["port", "reference"])
def prefetch_iter(request):
    return tio.prefetch_iter if request.param == "port" \
        else rio.prefetch_iter


def test_prefetch_iter_order_prep_and_depth_zero(prefetch_iter):
    assert list(prefetch_iter(iter(range(50)), lambda x: x * 2, depth=3)) \
        == [x * 2 for x in range(50)]
    seen = []

    def gen():
        for i in range(5):
            seen.append(i)
            yield i

    it = prefetch_iter(gen(), None, depth=0)
    assert next(it) == 0
    assert seen == [0]              # synchronous: nothing read ahead
    assert list(it) == [1, 2, 3, 4]


def test_prefetch_iter_exceptions_propagate(prefetch_iter):
    def gen():
        yield 1
        raise ValueError("boom")

    it = prefetch_iter(gen(), None, depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)

    def bad(x):
        if x == 3:
            raise RuntimeError("prep failed")
        return x

    with pytest.raises(RuntimeError, match="prep failed"):
        list(prefetch_iter(iter(range(10)), bad, depth=2))


def test_prefetch_iter_early_break_closes_inner(prefetch_iter):
    import time
    closed = []

    def gen():
        try:
            for i in range(10_000):
                yield i
        finally:
            closed.append(True)

    it = prefetch_iter(gen(), None, depth=2)
    for x in it:
        if x >= 3:
            break
    it.close()
    deadline = time.time() + 5
    while not closed and time.time() < deadline:
        time.sleep(0.05)
    assert closed == [True]


@pytest.mark.parametrize("fmt", ["parquet", "partitioned", "csv"])
def test_scan_file_batches_match_the_reference(spark, tspark, tmp_path, fmt):
    """The streamed scan's batches — sliced by ``maxBatchRows``, pruned
    columns and pushed row-group filters kept, each re-encoded onto the
    relation's global sorted dictionaries — equal the reference's,
    batch for batch."""
    n = 1000
    rng = np.random.default_rng(8)
    data = {"id": np.arange(n, dtype=np.int64),
            "grp": list(rng.choice(["kiwi", "fig", "plum", "date"], n)),
            "x": rng.normal(0.0, 1.0, n),
            "part": list(np.where(np.arange(n) < 600, "a", "b"))}
    p = str(tmp_path / "t")
    w = tspark.createDataFrame(data).write
    if fmt == "csv":
        w.option("header", True).csv(p)
        reads = (spark.read.csv(p, header=True, inferSchema=True),
                 tspark.read.csv(p, header=True, inferSchema=True))
    else:
        (w.partitionBy("part") if fmt == "partitioned" else w) \
            .option("rowGroupSize", 128).parquet(p)
        reads = (spark.read.parquet(p).filter(RF.col("id") >= 300)
                 .select("grp", "id", "x"),
                 tspark.read.parquet(p).filter(TF.col("id") >= 300)
                 .select("grp", "id", "x"))
    from spark_tpu.sql.planner import QueryExecution as RQE

    def rel(qe):
        node = qe.optimized
        while node.children:
            node = node.children[0]
        return node
    rrel = rel(RQE(spark, reads[0]._plan))
    trel = rel(QueryExecution(tspark, reads[1]._plan))
    rd = rio.scan_string_dictionaries(rrel, 256)
    td = tio.scan_string_dictionaries(trel, 256)
    assert rd == td and td
    ref = [rio.reencode_strings(b, rd)
           for b in rio.scan_file_batches(rrel, 256)]
    got = [tio.reencode_strings(b, td)
           for b in tio.scan_file_batches(trel, 256)]
    assert len(ref) == len(got) > 1
    for r, g in zip(ref, got):
        assert_parts_equal(batch_parts(r), batch_parts(g))
