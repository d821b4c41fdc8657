"""The file-backed TPC-DS subset of the port: the 13 ``SMOKE`` texts of
``tests/test_tpcds_filebacked.py`` with every fact table read from
parquet (3 part files each, ``generate(SF_ROWS)``'s data), through
``spark_tpu_torch``'s ``spark.sql`` on the CPU.

Each answer is held against the sqlite oracle by the rule of
``tests/test_tpcds.py`` (floats ``rel_tol = abs_tol = 1e-6``) and against
``spark_tpu`` reading the same files at its default settings: at
20,000 rows every fact table is below the default
``spark.tpu.scan.maxBatchRows`` (2^20), so both packages read each file
relation as one batch, through column pruning and row-group pushdown.
``test_filebacked_streamed`` sets the limit to 2,048 rows, below every
fact table: q3 streams through broadcast joins fused into the per-batch
step, q93 through a grace hash join (store_sales and store_returns both
exceed a batch) and q71 through a streamed UNION ALL of three fact
tables (then grace-joined with time_dim, itself above 2,048 rows) —
the stage DAG — each against sqlite.
"""

import math
import os
import sqlite3

import pytest

from spark_tpu.tpcds import ORACLE_OVERRIDES, QUERIES, generate
from spark_tpu.tpcds.oracle import (FACT_TABLES, norm_value as _norm,
                                    row_key as _key,
                                    sqlite_text as _sqlite_text)
from spark_tpu_torch import config as TC
from spark_tpu_torch.sql import logical as TL
from spark_tpu_torch.sql.dataframe import DataFrame as TDataFrame
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import batch_parts, from_parts

from test_tpcds_filebacked import SMOKE

SF_ROWS = 20_000


@pytest.fixture(scope="module")
def fb(spark, tmp_path_factory):
    """Both packages' views (fact tables over the same parquet part
    files, dimensions in memory with the reference's codes) and the
    sqlite oracle."""
    tables = generate(SF_ROWS)
    base = tmp_path_factory.mktemp("tpcds_fb_torch")
    tspark = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    con = sqlite3.connect(":memory:")
    for name, pdf in tables.items():
        if name in FACT_TABLES:
            d = base / name
            os.makedirs(d)
            parts = 3
            step = (len(pdf) + parts - 1) // parts
            for i in range(parts):
                pdf.iloc[i * step:(i + 1) * step].to_parquet(
                    d / f"part-{i:03d}.parquet", index=False)
            spark.read.parquet(str(d)).createOrReplaceTempView(name)
            tspark.read.parquet(str(d)).createOrReplaceTempView(name)
        else:
            rdf = spark.createDataFrame(pdf)
            rdf.createOrReplaceTempView(name)
            parts = batch_parts(rdf._plan.batch.to_host())
            TDataFrame(tspark, TL.LocalRelation(from_parts(parts))) \
                .createOrReplaceTempView(name)
        pdf.to_sql(name, con, index=False)
    yield spark, tspark, con
    con.close()
    tspark.stop()
    for name in tables:
        spark.catalog.dropTempView(name)


def _compare(got, exp, qname, what):
    got = sorted((tuple(_norm(v) for v in r) for r in got), key=_key)
    exp = sorted((tuple(_norm(v) for v in r) for r in exp), key=_key)
    assert len(got) == len(exp), \
        f"{qname}: {len(got)} rows != {what} {len(exp)}"
    for i, (g, e) in enumerate(zip(got, exp)):
        assert len(g) == len(e), f"{qname} row {i}: arity {len(g)}!={len(e)}"
        for j, (a, b) in enumerate(zip(g, e)):
            if isinstance(a, float) and isinstance(b, float):
                assert math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-6), \
                    f"{qname} row {i} col {j}: {a} != {what} {b}"
            else:
                assert a == b, f"{qname} row {i} col {j}: {a!r} != " \
                               f"{what} {b!r}"


@pytest.mark.parametrize("qname", SMOKE)
def test_filebacked_query(fb, qname):
    spark, tspark, con = fb
    sql = QUERIES[qname]
    got = [tuple(r) for r in tspark.sql(sql).collect()]
    exp = con.execute(_sqlite_text(ORACLE_OVERRIDES.get(qname, sql))) \
        .fetchall()
    assert exp, f"{qname}: oracle returned no rows"
    _compare(got, exp, qname, "sqlite")
    _compare(got, [tuple(r) for r in spark.sql(sql).collect()], qname,
             "spark_tpu")


@pytest.mark.parametrize("qname", ["q3", "q93", "q71"])
def test_filebacked_streamed(fb, qname):
    from spark_tpu_torch.sql import multibatch as TMB
    spark, tspark, con = fb
    sql = QUERIES[qname]
    tspark.conf.set("spark.tpu.scan.maxBatchRows", "2048")
    try:
        TMB.reset_stream_stats()
        got = [tuple(r) for r in tspark.sql(sql).collect()]
    finally:
        tspark.conf.unset("spark.tpu.scan.maxBatchRows")
    assert TMB.STREAM_STATS["batches"] >= 20_000 // 2048
    if qname == "q93":
        assert TMB.STREAM_STATS["grace_joins"] == 1
    exp = con.execute(_sqlite_text(ORACLE_OVERRIDES.get(qname, sql))) \
        .fetchall()
    assert exp, f"{qname}: oracle returned no rows"
    _compare(got, exp, qname, "sqlite")
