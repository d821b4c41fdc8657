"""Stream-stream joins of the port against ``spark_tpu``'s on the CPU:
each test of ``tests/test_stream_join.py`` as one scenario through both
packages on the same micro-batches (the incremental inner delta, both
offsets across a restart, the watermark bounding a buffer, outer joins
null-extending on eviction), with the buffered rows compared per
trigger; then a seeded view/click join per trigger."""

import datetime
import os

import numpy as np
import pandas as pd
import pytest

from spark_tpu_torch import config as TC
from spark_tpu_torch.sql.session import SparkSession as TSession
from torch_stream_common import SEC, Pkg, both, state_rows

A = (("k", "int64"), ("a", "string"))
B = (("k2", "int64"), ("b", "int64"))
TS_A = (("ts", "timestamp"), ("k", "int64"))
TS_B = (("ts2", "timestamp"), ("k2", "int64"), ("b", "int64"))


def _ts(s):
    return datetime.datetime(1970, 1, 1) + datetime.timedelta(seconds=s)


@pytest.fixture(scope="module")
def tspark(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ssjoin")
    s = TSession(TC.Conf({"spark.torch.device": "cpu",
                          "spark.sql.warehouse.dir": str(root / "wh")}))
    yield s
    s.stop()


@pytest.fixture
def pkgs(spark, tspark):
    return [Pkg("spark_tpu", spark), Pkg("spark_tpu_torch", tspark)]


def _start(p, df, name, ckpt=None):
    w = (df.writeStream.format("memory").queryName(name)
         .outputMode("append").trigger(once=True))
    if ckpt:
        w = w.option("checkpointLocation", ckpt)
    return w.start()


def _inner(p, a, b):
    F = p.F
    return a.toDF(p.session).join(b.toDF(p.session),
                                  on=F.col("k") == F.col("k2"))


def _step(p, q, name, feeds):
    """Feed (side, rows) pairs, one trigger per list entry; the sink's
    rows and both buffers' live rows after each."""
    out = []
    for trig in feeds:
        for src, rows in trig:
            src.addData(rows)
        q.processAllAvailable()
        bufs = [None if b is None else state_rows(b)
                for b in q._ex._ss_buf]
        out.append((p.rows(name), bufs))
    return out


def _incremental(p):
    a, b = p.memory_stream(*A), p.memory_stream(*B)
    q = _start(p, _inner(p, a, b), "ssj1")
    out = _step(p, q, "ssj1", [
        [(a, [(1, "x"), (2, "y")]), (b, [(1, 10)])],
        [(a, [(1, "x2")]), (b, [(2, 20), (1, 11)])],
        [(b, [(2, 21)])]])
    q.stop()
    return out


def test_incremental_delta_no_duplicates(pkgs):
    ref = both(pkgs, _incremental)
    assert ref[1][0] == [(1, "x", 1, 10), (1, "x", 1, 11), (1, "x2", 1, 10),
                         (1, "x2", 1, 11), (2, "y", 2, 20)]
    assert (2, "y", 2, 21) in ref[2][0] and len(ref[2][0]) == 6


def _recovery_both_offsets(p, tmp):
    ckpt = os.path.join(tmp, p.root)
    a, b = p.memory_stream(*A), p.memory_stream(*B)
    q = _start(p, _inner(p, a, b), "ssj2", ckpt)
    out = _step(p, q, "ssj2", [[(a, [(5, "p")]), (b, [(5, 50)])]])
    q.stop()
    q2 = _start(p, _inner(p, a, b), "ssj3", ckpt)
    out += _step(p, q2, "ssj3", [[(b, [(5, 51)])]])
    q2.stop()
    return out


def test_recovery_resumes_both_offsets(pkgs, tmp_path):
    ref = both(pkgs, _recovery_both_offsets, str(tmp_path))
    assert ref[0][0] == [(5, "p", 5, 50)]
    assert ref[1][0] == [(5, "p", 5, 51)]


def _watermark_bounds(p):
    F = p.F
    a = p.memory_stream(*TS_A)
    b = p.memory_stream(*B)
    df = (a.toDF(p.session).withWatermark("ts", "2 seconds")
          .join(b.toDF(p.session), on=F.col("k") == F.col("k2")))
    q = _start(p, df, "ssjw")
    out = _step(p, q, "ssjw", [
        [(a, [(1 * SEC, 1), (2 * SEC, 2)])],
        [(a, [(20 * SEC, 3)])],
        [(b, [(1, 100), (3, 300)])]])
    q.stop()
    return out


def test_watermark_bounds_buffer(pkgs):
    ref = both(pkgs, _watermark_bounds)
    assert ref[1][1][0] == 1
    assert ref[2][0] == [(_ts(20), 3, 3, 300)]


def test_ssjoin_rejects_unsupported_shapes(pkgs):
    for p in pkgs:
        F, AE = p.F, p.AnalysisException
        a, b = p.memory_stream(*A), p.memory_stream(*B)
        joined = _inner(p, a, b)
        with pytest.raises(AE, match="append"):
            (joined.writeStream.format("memory").queryName("x1")
             .outputMode("complete").start())
        with pytest.raises(AE, match="[wW]atermark"):
            (a.toDF(p.session).join(b.toDF(p.session),
                                    on=F.col("k") == F.col("k2"),
                                    how="left")
             .writeStream.format("memory").queryName("x2")
             .outputMode("append").start())
        with pytest.raises(AE, match="inner/left/right"):
            (a.toDF(p.session).join(b.toDF(p.session),
                                    on=F.col("k") == F.col("k2"),
                                    how="full")
             .writeStream.format("memory").queryName("x2f")
             .outputMode("append").start())
        with pytest.raises(AE, match="aggregation|cannot run incrementally"):
            (joined.groupBy("k").agg(F.sum("b"))
             .writeStream.format("memory").queryName("x3")
             .outputMode("append").start())


def _filters(p):
    F = p.F
    a, b = p.memory_stream(*A), p.memory_stream(*B)
    df = (a.toDF(p.session).filter(F.col("k") > 0)
          .join(b.toDF(p.session), on=F.col("k") == F.col("k2"))
          .filter(F.col("b") >= 10)
          .select("a", "b"))
    q = _start(p, df, "ssjf")
    out = _step(p, q, "ssjf", [[(a, [(-1, "neg"), (1, "pos")]),
                                (b, [(1, 5), (1, 10), (-1, 99)])]])
    q.stop()
    return out


def test_filter_above_and_below_join(pkgs):
    assert both(pkgs, _filters)[0][0] == [("pos", 10)]


def _file_source_side(p, tmp):
    F = p.F
    base = os.path.join(tmp, p.root)
    fdir = os.path.join(base, "files_in")
    os.makedirs(fdir)
    pd.DataFrame({"k": [1, 2], "a": ["p", "q"]}).to_parquet(
        os.path.join(fdir, "f0.parquet"), index=False)
    ckpt = os.path.join(base, "ckpt_fs")
    b = p.memory_stream(*B)

    def mk(name):
        left = (p.session.readStream.format("parquet")
                .schema("k long, a string").load(fdir))
        df = left.join(b.toDF(p.session), on=F.col("k") == F.col("k2"))
        return _start(p, df, name, ckpt)

    q = mk("fsj1")
    out = _step(p, q, "fsj1", [[(b, [(1, 10)])]])
    q.stop()
    q2 = mk("fsj2")
    out += _step(p, q2, "fsj2", [[(b, [(2, 20)])]])
    q2.stop()
    return out


def test_recovery_with_file_source_metadata(pkgs, tmp_path):
    ref = both(pkgs, _file_source_side, str(tmp_path))
    assert ref[0][0] == [(1, "p", 1, 10)]
    assert ref[1][0] == [(2, "q", 2, 20)]


def _left_outer(p, tmp):
    F = p.F
    ckpt = os.path.join(tmp, p.root)
    a = p.memory_stream(*TS_A)
    b = p.memory_stream(*TS_B)

    def mk(name):
        df = (a.toDF(p.session).withWatermark("ts", "2 seconds")
              .join(b.toDF(p.session),
                    on=(F.col("k") == F.col("k2"))
                    & (F.col("ts2") >= F.col("ts")),
                    how="left"))
        return _start(p, df, name, ckpt)

    q = mk("ssjo1")
    out = _step(p, q, "ssjo1", [
        [(a, [(1 * SEC, 1), (2 * SEC, 2)]), (b, [(1 * SEC, 1, 10)])],
        [(a, [(20 * SEC, 3)])]])
    q.stop()
    q2 = mk("ssjo2")
    out += _step(p, q2, "ssjo2", [[(b, [(25 * SEC, 3, 30)])],
                                  [(a, [(40 * SEC, 4)])]])
    q2.stop()
    return out


def test_left_outer_null_extends_on_eviction_across_restart(pkgs,
                                                            tmp_path):
    ref = both(pkgs, _left_outer, str(tmp_path))
    assert ref[1][0] == [(_ts(1), 1, _ts(1), 1, 10),
                         (_ts(2), 2, None, None, None)]
    assert ref[3][0] == [(_ts(20), 3, _ts(25), 3, 30)]


def _right_outer(p):
    F = p.F
    a = p.memory_stream(*TS_A)
    b = p.memory_stream(*TS_B)
    df = (a.toDF(p.session)
          .join(b.toDF(p.session).withWatermark("ts2", "1 seconds"),
                on=(F.col("k") == F.col("k2"))
                & (F.col("ts") <= F.col("ts2")), how="right"))
    q = _start(p, df, "ssjr")
    out = _step(p, q, "ssjr", [
        [(a, [(1 * SEC, 1)]), (b, [(5 * SEC, 1, 100), (6 * SEC, 2, 200)])],
        [(b, [(30 * SEC, 9, 900)])]])
    q.stop()
    return out


def test_right_outer_preserves_right_side(pkgs):
    ref = both(pkgs, _right_outer)
    assert (None, None, _ts(6), 2, 200) in ref[1][0]
    assert (_ts(1), 1, _ts(5), 1, 100) in ref[1][0]


def test_outer_ssjoin_rejects_unbounded_condition(pkgs):
    for p in pkgs:
        F = p.F
        a, b = p.memory_stream(*TS_A), p.memory_stream(*B)
        with pytest.raises(p.AnalysisException,
                           match="bound future matches"):
            (a.toDF(p.session).withWatermark("ts", "2 seconds")
             .join(b.toDF(p.session), on=F.col("k") == F.col("k2"),
                   how="left")
             .writeStream.format("memory").queryName("ssju")
             .outputMode("append").start())


def test_left_outer_rejects_watermark_on_wrong_side(pkgs):
    for p in pkgs:
        F = p.F
        a, b = p.memory_stream(*A), p.memory_stream(*TS_B)
        with pytest.raises(p.AnalysisException, match="PRESERVED"):
            (a.toDF(p.session)
             .join(b.toDF(p.session).withWatermark("ts2", "1 seconds"),
                   on=F.col("k") == F.col("k2"), how="left")
             .writeStream.format("memory").queryName("wwx")
             .outputMode("append").start())


# ---------------------------------------------------------------------------
# seeded views ⋈ clicks under watermarks
# ---------------------------------------------------------------------------

def _seeded_views_clicks(p):
    F = p.F
    rng = np.random.default_rng(8)
    views = p.memory_stream(("vt", "timestamp"), ("ad", "int64"),
                            ("u", "int64"))
    clicks = p.memory_stream(("ct", "timestamp"), ("ad2", "int64"),
                             ("u2", "int64"))
    df = (views.toDF(p.session).withWatermark("vt", "5 seconds")
          .join(clicks.toDF(p.session), on=F.col("ad") == F.col("ad2")))
    q = _start(p, df, "vc")
    feeds = []
    for t in range(4):
        n = 60
        feeds.append([
            (views, [(SEC * int(x), int(a), int(u)) for x, a, u in zip(
                rng.integers(t * 10, t * 10 + 10, n),
                rng.integers(0, 20, n), rng.integers(0, 1000, n))]),
            (clicks, [(SEC * int(x), int(a), int(u)) for x, a, u in zip(
                rng.integers(t * 10, t * 10 + 10, n // 3),
                rng.integers(0, 20, n // 3),
                rng.integers(0, 1000, n // 3))])])
    out = _step(p, q, "vc", feeds)
    q.stop()
    return out


def test_seeded_view_click_join_per_trigger(pkgs):
    """Seeded views and clicks over four triggers: every trigger's joined
    rows and both buffers' sizes equal the reference's."""
    ref = both(pkgs, _seeded_views_clicks)
    assert len(ref[-1][0]) > 0
