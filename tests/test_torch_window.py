"""Window functions of the port against ``spark_tpu``: each function under
partition and order with ties and NULL keys, ``rowsBetween`` /
``rangeBetween`` frames and lag / lead defaults, through the DataFrame
API and SQL text, single-device and at 4 shards of the port's mesh lane
(where the window's partition keys go through one hash exchange, K2's
plain version on the CPU); and a window stage on the graph lane, whose
replay must equal the eager lane bit for bit and touch no host value.

The same seeded table goes into both packages through ``batch_parts`` /
``from_parts``.  Integer results (ranks, row numbers, counts, integer
running sums, lag / lead of integers and strings) must be equal exactly;
doubles (averages, float running sums, percent_rank, cume_dist) within
``FLOAT_RTOL`` = 1e-9, because prefix sums add in another order than the
reference's.  Single-device rows come in the input's order, as the
reference defines it; at 4 shards rows come back in shard order and are
compared as sets.
"""

import numpy as np
import pytest

from spark_tpu.sql import functions as RF
from spark_tpu.sql.window import Window as RWindow
from spark_tpu_torch import config as TC
from spark_tpu_torch import expressions as TE
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql import logical as TL
from spark_tpu_torch.sql import stagecompile as TSC
from spark_tpu_torch.sql.dataframe import DataFrame as TDataFrame
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.sql.window import Window as TWindow
from spark_tpu_torch.testing import (assert_rows_equal, batch_parts,
                                     from_parts)

from test_torch_stagecompile import _trap_host_syncs

FLOAT_RTOL = 1e-9
SHARDS = "spark.tpu.mesh.shards"


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


def _table(seed=11, n=300):
    """Partition keys with NULLs and skew, order keys with ties and NULLs,
    NULL values, strings."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 6, n)
    o = rng.integers(0, 12, n)
    return {
        "k": [None if x == 5 else int(x) for x in k],
        "g": [("red", "green", "blue")[x] for x in rng.integers(0, 3, n)],
        "o": [None if rng.random() < 0.08 else int(x) for x in o],
        "t": [int(x) for x in rng.permutation(n)],        # a total order
        "v": [None if rng.random() < 0.1 else float(x)
              for x in np.round(rng.normal(0, 5, n), 2)],
        "w": [int(x) for x in rng.integers(-100, 100, n)],
        "s": [None if rng.random() < 0.1 else f"s{x:02d}"
              for x in rng.integers(0, 40, n)],
    }


@pytest.fixture(scope="module")
def frames(spark, tspark):
    rdf = spark.createDataFrame(_table())
    parts = batch_parts(rdf._plan.batch.to_host())
    tdf = TDataFrame(tspark, TL.LocalRelation(from_parts(parts)))
    rdf.createOrReplaceTempView("wt")
    tdf.createOrReplaceTempView("wt")
    yield rdf, tdf
    spark.catalog.dropTempView("wt")
    tspark.catalog.dropTempView("wt")


#: name → window columns, built from either package's (functions, Window)
CASES = {
    "row_number": lambda F, W: [F.row_number().over(
        W.partitionBy("k").orderBy("o", "t"))],
    "rank_ties": lambda F, W: [F.rank().over(
        W.partitionBy("k").orderBy(F.col("o").desc()))],
    "dense_rank_ties": lambda F, W: [F.dense_rank().over(
        W.partitionBy("g", "k").orderBy("o"))],
    "percent_rank": lambda F, W: [F.percent_rank().over(
        W.partitionBy("k").orderBy("o"))],
    "cume_dist": lambda F, W: [F.cume_dist().over(
        W.partitionBy("g").orderBy(F.col("o").asc_nulls_last()))],
    "ntile": lambda F, W: [F.ntile(4).over(
        W.partitionBy("k").orderBy("t"))],
    "lag_lead": lambda F, W: [
        F.lag("w").over(W.partitionBy("k").orderBy("t")),
        F.lead("v", 2).over(W.partitionBy("k").orderBy("t"))],
    "lag_lead_defaults": lambda F, W: [
        F.lag("w", 1, 0).over(W.partitionBy("g").orderBy("t")),
        F.lead("w", 3, -1).over(W.partitionBy("g").orderBy("t"))],
    "lag_string": lambda F, W: [F.lag("s").over(
        W.partitionBy("k").orderBy("t"))],
    "sum_partition": lambda F, W: [F.sum("w").over(W.partitionBy("k")),
                                   F.count("*").over(W.partitionBy("k"))],
    "sum_running_range_peers": lambda F, W: [
        F.sum("w").over(W.partitionBy("k").orderBy("o")),
        F.count("v").over(W.partitionBy("k").orderBy("o"))],
    "avg_rows_frame": lambda F, W: [F.avg("v").over(
        W.partitionBy("g").orderBy("t").rowsBetween(-2, 0))],
    "sum_rows_frame_centred": lambda F, W: [F.sum("w").over(
        W.partitionBy("k").orderBy("t").rowsBetween(-1, 2))],
    "sum_rows_unbounded": lambda F, W: [F.sum("v").over(
        W.partitionBy("k").orderBy("t").rowsBetween(
            W.unboundedPreceding, W.unboundedFollowing))],
    "sum_range_unbounded": lambda F, W: [F.sum("w").over(
        W.partitionBy("g").orderBy("o").rangeBetween(
            W.unboundedPreceding, W.unboundedFollowing))],
    "min_max_running": lambda F, W: [
        F.min("w").over(W.partitionBy("k").orderBy("t").rowsBetween(
            W.unboundedPreceding, W.currentRow)),
        F.max("v").over(W.partitionBy("k").orderBy("o"))],
    "max_string_partition": lambda F, W: [F.max("s").over(
        W.partitionBy("g"))],
    "no_partition": lambda F, W: [F.rank().over(W.orderBy("w")),
                                  F.sum("w").over(W.orderBy("t"))],
}

#: results with doubles (compared within FLOAT_RTOL)
_FLOATS = {"percent_rank", "cume_dist", "lag_lead", "avg_rows_frame",
           "sum_rows_unbounded", "min_max_running"}


def _select(df, F, W, name):
    cols = [c.alias(f"w{i}") for i, c in enumerate(CASES[name](F, W))]
    return df.select("k", "g", "o", "t", "w", *cols)


def _collect_at(tspark, df, shards):
    tspark.conf.set(SHARDS, str(shards))
    try:
        return df.collect()
    finally:
        tspark.conf.set(SHARDS, "1")


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_window_function(frames, tspark, name, shards):
    rdf, tdf = frames
    ref = _select(rdf, RF, RWindow, name).collect()
    got = _collect_at(tspark, _select(tdf, TF, TWindow, name), shards)
    assert len(ref) == 300
    assert_rows_equal(ref, got, rtol=FLOAT_RTOL if name in _FLOATS else 0.0,
                      ordered=shards == 1)


SQL = {
    "q98_shape": (
        "SELECT g, k, SUM(w) AS s, SUM(w) * 100 / SUM(SUM(w)) OVER "
        "(PARTITION BY g) AS ratio FROM wt GROUP BY g, k"),
    "rank_over_aggregate": (
        "SELECT g, k, SUM(w) AS s, RANK() OVER (PARTITION BY g ORDER BY "
        "SUM(w) DESC) AS r, LAG(SUM(w), 1, 0) OVER (PARTITION BY g ORDER "
        "BY k) AS prev FROM wt GROUP BY g, k"),
    "filter_on_rank": (
        "SELECT * FROM (SELECT g, t, w, ROW_NUMBER() OVER (PARTITION BY g "
        "ORDER BY w DESC, t) AS rn FROM wt) x WHERE rn <= 3"),
    "two_specs": (
        "SELECT t, AVG(v) OVER (PARTITION BY k ORDER BY t ROWS BETWEEN 1 "
        "PRECEDING AND 1 FOLLOWING) AS a, DENSE_RANK() OVER (ORDER BY g) "
        "AS d, NTILE(3) OVER (PARTITION BY g ORDER BY t) AS n FROM wt"),
}


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("name", list(SQL))
def test_window_sql(spark, tspark, frames, name, shards):
    ref = spark.sql(SQL[name]).collect()
    got = _collect_at(tspark, tspark.sql(SQL[name]), shards)
    assert len(ref) > 0
    assert_rows_equal(ref, got, rtol=FLOAT_RTOL, ordered=False)


def test_bounded_range_frame_refused_like_reference():
    for W in (RWindow, TWindow):
        with pytest.raises(Exception, match="bounded rangeBetween is not "
                           "supported; use rowsBetween"):
            W.orderBy("o").rangeBetween(-1, 0)


def test_window_expression_outside_a_window_operator_raises(tspark, frames):
    _rdf, tdf = frames
    with pytest.raises(TE.AnalysisException, match="must be used with"):
        tdf.select(TF.rank()).collect()


@pytest.mark.parametrize("name", ["rank_ties", "lag_lead_defaults",
                                  "sum_running_range_peers",
                                  "min_max_running", "q98_shape"])
def test_window_stage_replays_like_eager_lane(tspark, frames, monkeypatch,
                                              name):
    """A window query on the graph lane: its first run records the stage
    (decisions, constants; on a card the CUDA graph), the second replays
    the record, touching no host value of a tensor and building no tensor
    from host values; both equal the eager lane bit for bit."""
    _rdf, tdf = frames
    df = tspark.sql(SQL[name]) if name in SQL \
        else _select(tdf, TF, TWindow, name)
    tspark.conf.set("spark.sql.codegen.wholeStage", "false")
    try:
        eager = df.collect()
    finally:
        tspark.conf.unset("spark.sql.codegen.wholeStage")
    cache = TSC.stage_cache()
    cache.clear()
    first = df.collect()
    before = cache.stats()
    _trap_host_syncs(monkeypatch)
    replayed = df.collect()
    monkeypatch.undo()
    after = cache.stats()
    assert after["dispatches"] == before["dispatches"] + 1
    assert after["variants"] == before["variants"]
    assert_rows_equal(eager, first)
    assert_rows_equal(eager, replayed)


@pytest.mark.parametrize("sql,cacheable", [
    (SQL["rank_over_aggregate"], False),
    (SQL["two_specs"], False),
    ("SELECT g, k, SUM(w) AS s, grouping_id() AS gid FROM wt "
     "GROUP BY ROLLUP(g, k)", True),
    ("SELECT g, STDDEV_SAMP(v) AS sd, UPPER(g) AS u FROM wt GROUP BY g",
     True),
])
def test_plan_fingerprint_like_reference(spark, tspark, frames, sql,
                                         cacheable):
    """A window plan has no plan-cache fingerprint in either package (the
    reference's serializer cannot key a ``WindowSpec``): the port's plan
    cache counts it uncacheable.  A grouping-set plan and a plan of the
    breadth expressions are keyed in both."""
    from spark_tpu.serving.plancache import fingerprint as rfingerprint
    from spark_tpu.sql.planner import QueryExecution as RQE
    from spark_tpu_torch.serving.plancache import fingerprint
    from spark_tpu_torch.sql.planner import QueryExecution
    ref = rfingerprint(spark, RQE(spark, spark.sql(sql)._plan).optimized)
    got = fingerprint(tspark, QueryExecution(tspark,
                                             tspark.sql(sql)._plan).optimized)
    assert (ref is not None) == cacheable
    assert (got is not None) == cacheable


def test_window_avg_of_a_decimal_column_reference_fault(spark, tspark):
    """avg(d) OVER (PARTITION BY k) over decimal(7,2) values 1.25 and 2.50:
    the port averages the values, 1.875 (Spark's answer); the reference
    averages the held integers, 187.5 (``sql/window.py``
    ``_window_aggregate``).  The window sum agrees."""
    import decimal

    from spark_tpu import types as RT
    schema = RT.StructType([RT.StructField("k", RT.int64),
                            RT.StructField("d", RT.DecimalType(7, 2))])
    rdf = spark.createDataFrame(
        {"k": [1, 1], "d": [decimal.Decimal("1.25"), decimal.Decimal("2.50")]},
        schema=schema)
    tdf = TDataFrame(tspark, TL.LocalRelation(from_parts(batch_parts(
        rdf._plan.batch.to_host()))))
    ref = rdf.select(RF.avg("d").over(RWindow.partitionBy("k")).alias("a"),
                     RF.sum("d").over(RWindow.partitionBy("k")).alias("s")
                     ).collect()
    got = tdf.select(TF.avg("d").over(TWindow.partitionBy("k")).alias("a"),
                     TF.sum("d").over(TWindow.partitionBy("k")).alias("s")
                     ).collect()
    assert [tuple(r) for r in got] == [(1.875, 3.75)] * 2
    assert [tuple(r) for r in ref] == [(187.5, 3.75)] * 2
