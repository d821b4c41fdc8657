"""Event-time streaming of the port against ``spark_tpu``'s on the CPU:
``window()`` / ``window_end()`` in batch and SQL, the sliding-window
expansion, watermarks, append-mode windows emitted once, update-mode
eviction and streaming deduplication, each test of
``tests/test_eventtime.py`` as one scenario through both packages on the
same micro-batches, with the state rows and evictions compared too."""

import collections
import datetime
import os

import numpy as np
import pandas as pd
import pytest

from spark_tpu_torch import config as TC
from spark_tpu_torch.sql.session import SparkSession as TSession
from torch_stream_common import Pkg, both, sec, state_rows

TKV = (("ts", "timestamp"), ("k", "string"), ("v", "int64"))


def dt(n) -> datetime.datetime:
    return datetime.datetime(1970, 1, 1) + datetime.timedelta(seconds=n)


@pytest.fixture(scope="module")
def tspark(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eventtime")
    s = TSession(TC.Conf({"spark.torch.device": "cpu",
                          "spark.sql.warehouse.dir": str(root / "wh")}))
    yield s
    s.stop()


@pytest.fixture
def pkgs(spark, tspark):
    return [Pkg("spark_tpu", spark), Pkg("spark_tpu_torch", tspark)]


# ---------------------------------------------------------------------------
# batch semantics of window()
# ---------------------------------------------------------------------------

def _window_batch(p):
    df = p.session.createDataFrame(pd.DataFrame({
        "ts": [sec(1), sec(9), sec(10), sec(25)],
        "v": [1.0, 2.0, 3.0, 4.0]}))
    return [sorted(tuple(r) for r in
                   df.groupBy(p.F.window("ts", "10 seconds").alias("w"))
                   .agg(p.F.sum("v").alias("s")).collect())]


def test_window_batch(pkgs):
    assert both(pkgs, _window_batch) == [
        [(dt(0), 3.0), (dt(10), 3.0), (dt(20), 4.0)]]


def test_window_end_and_sliding_rejected(pkgs):
    got = []
    for p in pkgs:
        df = p.session.createDataFrame(pd.DataFrame({"ts": [sec(14)],
                                                     "v": [1.0]}))
        (w,) = df.select(p.F.window_end("ts", "10 seconds")
                         .alias("we")).collect()
        got.append(w[0])
        with pytest.raises(p.AnalysisException, match="sliding"):
            df.select(p.F.window("ts", "10 seconds", "5 seconds")).collect()
    assert got == [dt(20), dt(20)]


# ---------------------------------------------------------------------------
# append mode with watermark
# ---------------------------------------------------------------------------

def _windowed_query(p, src, name, checkpoint=None, mode="append"):
    agg = (src.toDF(p.session)
           .withWatermark("ts", "5 seconds")
           .groupBy(p.F.window("ts", "10 seconds").alias("w"))
           .agg(p.F.sum("v").alias("s")))
    w = (agg.writeStream.format("memory").queryName(name)
         .outputMode(mode).trigger(once=True))
    if checkpoint:
        w = w.option("checkpointLocation", checkpoint)
    return w.start()


def test_append_requires_watermark(pkgs):
    for p in pkgs:
        src = p.memory_stream(*TKV)
        agg = src.toDF(p.session).groupBy("k").agg(p.F.sum("v").alias("s"))
        with pytest.raises(p.AnalysisException, match="watermark"):
            (agg.writeStream.format("memory").queryName("nope")
             .outputMode("append").start())


def _feed(p, q, src, name, feeds):
    out = []
    for rows in feeds:
        src.addData(rows)
        q.processAllAvailable()
        ex = q._ex
        st = ex._agg_state if ex._agg_state is not None \
            else ex._dedup_state
        out.append((p.rows(name), ex.watermark_us,
                    None if st is None or st.state is None
                    else state_rows(st.state),
                    0 if st is None else st.evicted_rows))
    return out


def _append_windows(p):
    src = p.memory_stream(*TKV)
    q = _windowed_query(p, src, "ev_app")
    out = _feed(p, q, src, "ev_app", [
        [(sec(1), "a", 1), (sec(9), "a", 2)],
        [(sec(20), "a", 4)],
        [(sec(3), "a", 100)],
        [(sec(35), "a", 8)]])
    q.stop()
    return out


def test_append_windows_emit_once(pkgs):
    ref = both(pkgs, _append_windows)
    assert [o[0] for o in ref] == [
        [], [(dt(0), 3)], [(dt(0), 3)], [(dt(0), 3), (dt(20), 4)]]


def _append_recovery(p, tmp):
    ckpt = os.path.join(tmp, p.root)
    src = p.memory_stream(*TKV)
    q = _windowed_query(p, src, "ev_rec", checkpoint=ckpt)
    src.addData([(sec(2), "a", 5), (sec(8), "a", 6)])
    q.processAllAvailable()
    first = p.rows("ev_rec")
    q.stop()
    q2 = _windowed_query(p, src, "ev_rec2", checkpoint=ckpt)
    out = _feed(p, q2, src, "ev_rec2", [[(sec(21), "a", 1)],
                                        [(sec(5), "a", 50)]])
    q2.stop()
    return [first] + out


def test_append_recovery_across_restart(pkgs, tmp_path):
    ref = both(pkgs, _append_recovery, str(tmp_path))
    assert ref[0] == [] and ref[1][0] == [(dt(0), 11)] \
        and ref[2][0] == [(dt(0), 11)]


def _update_evicts(p):
    src = p.memory_stream(*TKV)
    q = _windowed_query(p, src, "ev_upd", mode="update")
    out = _feed(p, q, src, "ev_upd", [[(sec(1), "a", 1)],
                                      [(sec(30), "a", 2)]])
    q.stop()
    return out


def test_update_mode_evicts_state(pkgs):
    ref = both(pkgs, _update_evicts)
    assert ref[-1][2] == 1
    assert ref[-1][0] == [(dt(0), 1), (dt(30), 2)]


def _open_window(p):
    src = p.memory_stream(*TKV)
    q = _windowed_query(p, src, "ev_open")
    out = _feed(p, q, src, "ev_open", [[(sec(19), "a", 1)],
                                       [(sec(12), "a", 1)],
                                       [(sec(31), "a", 1)]])
    q.stop()
    return out


def test_open_window_late_rows_kept(pkgs):
    assert both(pkgs, _open_window)[-1][0][0] == (dt(10), 2)


def test_dedup_over_streaming_agg_rejected(pkgs):
    for p in pkgs:
        src = p.memory_stream(*TKV)
        with pytest.raises(p.AnalysisException,
                           match="deduplicating the output"):
            (src.toDF(p.session).groupBy("k").agg(p.F.sum("v").alias("x"))
             .distinct().writeStream.format("memory").queryName("bad_dd")
             .outputMode("update").start())


# ---------------------------------------------------------------------------
# streaming deduplication
# ---------------------------------------------------------------------------

def _dedup(p, df_fn, name, feeds, ckpt=None):
    src = p.memory_stream(*TKV)
    w = (df_fn(src.toDF(p.session)).writeStream.format("memory")
         .queryName(name).outputMode("append").trigger(once=True))
    if ckpt:
        w = w.option("checkpointLocation", ckpt)
    q = w.start()
    out = _feed(p, q, src, name, feeds)
    q.stop()
    return out


def test_drop_duplicates_subset(pkgs):
    ref = both(pkgs, _dedup, lambda d: d.dropDuplicates(["k"]), "dd1", [
        [(sec(1), "a", 1), (sec(2), "a", 2), (sec(3), "b", 3)],
        [(sec(4), "a", 9), (sec(5), "c", 5)]])
    assert ref[-1][0] == [(dt(1), "a", 1), (dt(3), "b", 3), (dt(5), "c", 5)]


def test_drop_duplicates_full_row(pkgs):
    ref = both(pkgs, _dedup, lambda d: d.distinct(), "dd2", [
        [(sec(1), "a", 1), (sec(1), "a", 1), (sec(1), "a", 2)],
        [(sec(1), "a", 1), (sec(2), "a", 1)]])
    assert ref[-1][0] == [(dt(1), "a", 1), (dt(1), "a", 2), (dt(2), "a", 1)]


def _dedup_recovery(p, tmp):
    ckpt = os.path.join(tmp, p.root)
    src = p.memory_stream(*TKV)

    def mk(name):
        return (src.toDF(p.session).withWatermark("ts", "5 seconds")
                .dropDuplicates(["k", "ts"])
                .writeStream.format("memory").queryName(name)
                .outputMode("append")
                .option("checkpointLocation", ckpt)
                .trigger(once=True).start())

    q = mk("dd3")
    out = _feed(p, q, src, "dd3", [[(sec(1), "a", 1), (sec(1), "a", 9)],
                                   [(sec(20), "b", 2)]])
    q.stop()
    q2 = mk("dd4")
    out += _feed(p, q2, src, "dd4", [[(sec(1), "a", 7), (sec(21), "c", 3)]])
    q2.stop()
    return out


def test_dedup_watermark_eviction_and_recovery(pkgs, tmp_path):
    ref = both(pkgs, _dedup_recovery, str(tmp_path))
    assert ref[0][0] == [(dt(1), "a", 1)]
    assert ref[1][2] == 1
    assert ref[2][0] == [(dt(21), "c", 3)]


def _sliding_batch(p):
    rng = np.random.default_rng(5)
    secs = rng.integers(0, 3600, 300)
    vals = rng.integers(1, 100, 300)
    df = p.session.createDataFrame(pd.DataFrame({
        "ts": pd.to_datetime(secs, unit="s"), "v": vals}))
    out = {r["w"]: r["s"] for r in
           df.groupBy(p.F.window("ts", "10 minutes", "5 minutes").alias("w"))
           .agg(p.F.sum("v").alias("s")).collect()}
    return [sorted(out.items())]


def test_sliding_window_batch_aggregation(pkgs):
    ref = both(pkgs, _sliding_batch)
    rng = np.random.default_rng(5)
    secs = rng.integers(0, 3600, 300)
    vals = rng.integers(1, 100, 300)
    exp = collections.Counter()
    for t, v in zip(secs.tolist(), vals.tolist()):
        last = (t // 300) * 300
        for i in range(2):
            exp[last - i * 300] += v
    assert ref == [sorted((dt(k), v) for k, v in exp.items())]


def _sliding_sql(p):
    rows = p.session.sql(
        "SELECT window(t, '4 seconds', '2 seconds') AS w, COUNT(*) AS c "
        "FROM (SELECT to_timestamp('1970-01-01 00:00:05') AS t) x "
        "GROUP BY window(t, '4 seconds', '2 seconds') ORDER BY w").collect()
    return [r["w"] for r in rows]


def test_sliding_window_end_field_and_sql(pkgs):
    assert both(pkgs, _sliding_sql) == [dt(2), dt(4)]


def test_sliding_window_rejects_bad_slide(pkgs):
    for p in pkgs:
        with pytest.raises(p.AnalysisException, match="divide"):
            p.F.window("ts", "10 minutes", "3 minutes")


def _sliding_stream(p, mode):
    src = p.memory_stream(*TKV)
    df = src.toDF(p.session)
    if mode == "append":
        df = df.withWatermark("ts", "2 seconds")
    q = (df.groupBy(p.F.window("ts", "4 seconds", "2 seconds").alias("w"))
         .agg(p.F.sum("v").alias("s"))
         .writeStream.format("memory").queryName(f"slide_{mode}")
         .outputMode(mode).trigger(once=True).start())
    feeds = ([[(sec(1), "a", 1), (sec(3), "a", 10)], [(sec(2), "b", 100)]]
             if mode == "complete" else
             [[(sec(1), "a", 1), (sec(3), "a", 10)], [(sec(9), "a", 5)],
              [(sec(14), "a", 2)]])
    out = _feed(p, q, src, f"slide_{mode}", feeds)
    q.stop()
    return out


def test_sliding_window_streaming_complete(pkgs):
    ref = both(pkgs, _sliding_stream, "complete")
    assert ref[-1][0] == [(dt(-2), 1), (dt(0), 111), (dt(2), 110)]


def test_sliding_window_streaming_append_watermark(pkgs):
    ref = both(pkgs, _sliding_stream, "append")
    assert ref[-1][0] == [(dt(-2), 1), (dt(0), 11), (dt(2), 10),
                          (dt(6), 5), (dt(8), 5)]


# ---------------------------------------------------------------------------
# seeded event streams: windows, dedup state and evictions per trigger
# ---------------------------------------------------------------------------

def _event_feeds(seed, n_batches=5, rows=300):
    rng = np.random.default_rng(seed)
    feeds = []
    for b in range(n_batches):
        t = rng.integers(b * 10, b * 10 + 14, rows)       # some lateness
        ks = rng.integers(0, 8, rows)
        vs = rng.integers(0, 100, rows)
        feeds.append([(sec(int(x)), f"u{int(k)}", int(v))
                      for x, k, v in zip(t, ks, vs)])
    return feeds


def _seeded_windows(p, mode):
    src = p.memory_stream(*TKV)
    agg = (src.toDF(p.session).withWatermark("ts", "4 seconds")
           .groupBy(p.F.window("ts", "5 seconds").alias("w"), "k")
           .agg(p.F.sum("v").alias("s"), p.F.count("*").alias("c")))
    q = (agg.writeStream.format("memory").queryName(f"sw_{mode}")
         .outputMode(mode).trigger(once=True).start())
    out = _feed(p, q, src, f"sw_{mode}", _event_feeds(3))
    q.stop()
    return out


@pytest.mark.parametrize("mode", ["append", "update"])
def test_seeded_windowed_counts_per_trigger(pkgs, mode):
    """Seeded event streams with late rows: every trigger's windowed
    sums and counts, the watermark, the state's live groups and the
    evicted groups equal the reference's."""
    both(pkgs, _seeded_windows, mode)


def _seeded_dedup(p):
    src = p.memory_stream(*TKV)
    q = (src.toDF(p.session).withWatermark("ts", "6 seconds")
         .dropDuplicates(["k", "ts"])
         .writeStream.format("memory").queryName("sdd")
         .outputMode("append").trigger(once=True).start())
    out = _feed(p, q, src, "sdd", _event_feeds(4))
    q.stop()
    return out


def test_seeded_dedup_state_and_evictions(pkgs):
    both(pkgs, _seeded_dedup)
