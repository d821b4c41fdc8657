"""Structured streaming of the port against ``spark_tpu``'s on the CPU:
each test of ``tests/test_streaming.py`` as one scenario that runs
through both packages on the same micro-batches; the outputs per trigger
are compared (integers and strings exactly, doubles within rtol 1e-9),
and the reference's own expectations are asserted on the JAX package's
answer.  Then the port's device-resident state: the merge and the
dedup key check run on the session's device, the state snapshot carries
the same rows at the capacity of the live rows, and the ledger accounting
gives the same spill events as the reference under a small host
budget."""

import os
import time

import numpy as np
import pytest

from spark_tpu_torch import config as TC
from spark_tpu_torch.sql.session import SparkSession as TSession
from torch_stream_common import Pkg, both, same

KV = (("k", "string"), ("v", "int64"))


@pytest.fixture(scope="module")
def tspark(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_streaming")
    s = TSession(TC.Conf({"spark.torch.device": "cpu",
                          "spark.sql.warehouse.dir": str(root / "wh")}))
    yield s
    s.stop()


@pytest.fixture
def pkgs(spark, tspark):
    return [Pkg("spark_tpu", spark), Pkg("spark_tpu_torch", tspark)]


def _memory(df, name, mode="append", ckpt=None):
    w = (df.writeStream.format("memory").queryName(name)
         .outputMode(mode).trigger(once=True))
    if ckpt:
        w = w.option("checkpointLocation", ckpt)
    return w.start()


# ---------------------------------------------------------------------------
# tests/test_streaming.py counterparts
# ---------------------------------------------------------------------------

def _stateless_append(p):
    src = p.memory_stream(*KV)
    df = src.toDF(p.session)
    q = _memory(df.filter(df["v"] > 10).select("k", "v"), "s_app")
    out = []
    src.addData([("a", 5), ("b", 20)])
    q.processAllAvailable()
    out.append(p.rows("s_app"))
    src.addData([("c", 30)])
    q.processAllAvailable()
    out.append(p.rows("s_app"))
    q.stop()
    return out


def test_stateless_append(pkgs):
    ref = both(pkgs, _stateless_append)
    assert ref == [[("b", 20)], [("b", 20), ("c", 30)]]


def _aggregation_complete(p):
    src = p.memory_stream(*KV)
    F = p.F
    agg = src.toDF(p.session).groupBy("k").agg(F.sum("v").alias("s"),
                                               F.count("*").alias("c"))
    q = _memory(agg, "s_agg", "complete")
    out = []
    for rows in ([("a", 1), ("b", 2), ("a", 3)], [("a", 10), ("c", 7)]):
        src.addData(rows)
        q.processAllAvailable()
        out.append(p.rows("s_agg"))
    q.stop()
    return out


def test_streaming_aggregation_complete(pkgs):
    ref = both(pkgs, _aggregation_complete)
    assert ref[-1] == [("a", 14, 3), ("b", 2, 1), ("c", 7, 1)]


def _avg_min_max(p):
    src = p.memory_stream(*KV)
    F = p.F
    agg = src.toDF(p.session).groupBy("k").agg(
        F.avg("v").alias("m"), F.min("v").alias("lo"),
        F.max("v").alias("hi"))
    q = _memory(agg, "s_avg", "complete")
    src.addData([("a", 1)])
    q.processAllAvailable()
    src.addData([("a", 3)])
    q.processAllAvailable()
    q.stop()
    return [p.rows("s_avg")]


def test_streaming_avg_min_max(pkgs):
    assert both(pkgs, _avg_min_max) == [[("a", 2.0, 1, 3)]]


def _foreach_batch(p):
    src = p.memory_stream(*KV)
    seen = []
    q = (src.toDF(p.session).writeStream
         .foreachBatch(lambda bdf, bid: seen.append((bid,
                                                     len(bdf.collect()))))
         .trigger(once=True).start())
    src.addData([("a", 1), ("b", 2)])
    q.processAllAvailable()
    src.addData([("c", 3)])
    q.processAllAvailable()
    q.stop()
    return seen


def test_foreach_batch(pkgs):
    assert both(pkgs, _foreach_batch) == [(0, 2), (1, 1)]


def _exactly_once_recovery(p, tmp):
    ckpt = os.path.join(tmp, p.root)
    F = p.F
    src = p.memory_stream(*KV)
    agg = src.toDF(p.session).groupBy("k").agg(F.sum("v").alias("s"))
    q1 = _memory(agg, "s_rec", "complete", ckpt)
    src.addData([("a", 1), ("a", 2)])
    q1.processAllAvailable()
    first = p.rows("s_rec")
    q1.stop()
    src2 = p.memory_stream(*KV)
    src2.addData([("a", 1), ("a", 2)])
    src2.addData([("b", 10)])
    agg2 = src2.toDF(p.session).groupBy("k").agg(F.sum("v").alias("s"))
    q2 = _memory(agg2, "s_rec2", "complete", ckpt)
    q2.processAllAvailable()
    q2.stop()
    return [first, p.rows("s_rec2")]


def test_exactly_once_recovery(pkgs, tmp_path):
    ref = both(pkgs, _exactly_once_recovery, str(tmp_path))
    assert ref == [[("a", 3)], [("a", 3), ("b", 10)]]


def _wal_before_compute(p, tmp):
    ckpt = os.path.join(tmp, p.root)
    src = p.memory_stream(*KV)
    q = _memory(src.toDF(p.session), "s_wal", ckpt=ckpt)
    src.addData([("a", 1)])
    q.processAllAvailable()
    q.stop()
    return [os.path.exists(os.path.join(ckpt, "offsets", "0")),
            os.path.exists(os.path.join(ckpt, "commits", "0"))]


def test_wal_before_compute(pkgs, tmp_path):
    assert both(pkgs, _wal_before_compute, str(tmp_path)) == [True, True]


def _file_stream_source(p, tmp):
    data_dir = os.path.join(tmp, p.root, "in")
    os.makedirs(data_dir)
    s = p.session
    s.createDataFrame({"x": np.array([1, 2], np.int64)}).write.json(
        os.path.join(data_dir, "f1"))
    stream = s.readStream.format("json").schema("x bigint").load(data_dir)
    assert stream.isStreaming
    q = stream.writeStream.format("memory").queryName("s_file") \
        .trigger(once=True).start()
    q.processAllAvailable()
    got1 = p.rows("s_file")
    s.createDataFrame({"x": np.array([3], np.int64)}).write.json(
        os.path.join(data_dir, "f2"))
    q.processAllAvailable()
    got2 = p.rows("s_file")
    q.stop()
    return [got1, got2]


def test_file_stream_source(pkgs, tmp_path):
    ref = both(pkgs, _file_stream_source, str(tmp_path))
    assert len(ref[1]) == len(ref[0]) + 1


def _file_sink_idempotent(p, tmp):
    out = os.path.join(tmp, p.root, "out")
    src = p.memory_stream(*KV)
    q = src.toDF(p.session).writeStream.format("json") \
        .trigger(once=True).start(out)
    src.addData([("a", 1), ("b", 2)])
    q.processAllAvailable()
    # a replay of batch 0 returns on its marker: no second part file
    q._ex.sink.add_batch(0, q._ex.source.get_batch(None, 2), "append")
    q.stop()
    back = sorted(tuple(r) for r in p.session.read.json(out).collect())
    return [back, sorted(f for f in os.listdir(out)
                         if not f.startswith("."))]


def test_file_sink_idempotent(pkgs, tmp_path):
    ref = both(pkgs, _file_sink_idempotent, str(tmp_path))
    assert len(ref[0]) == 2
    assert ref[1] == ["_SUCCESS", "_batch_0", "part-00000.json"] \
        or ref[1] == ["_batch_0", "part-00000.json"]


def _continuous_trigger_thread(p):
    src = p.memory_stream(*KV)
    q = (src.toDF(p.session).writeStream.format("memory").queryName("s_thr")
         .trigger(processingTime="50 milliseconds").start())
    src.addData([("a", 1)])
    deadline = time.time() + 5
    while time.time() < deadline:
        if q.lastProgress and q.lastProgress["numInputRows"] >= 1:
            break
        time.sleep(0.05)
    active = q.isActive
    q.stop()
    return [active, q.isActive, p.rows("s_thr")]


def test_continuous_trigger_thread(pkgs):
    assert both(pkgs, _continuous_trigger_thread) \
        == [True, False, [("a", 1)]]


def test_complete_requires_aggregation(pkgs):
    for p in pkgs:
        src = p.memory_stream(*KV)
        with pytest.raises(p.AnalysisException,
                           match="complete output mode requires"):
            _memory(src.toDF(p.session), "s_bad", "complete")


def test_streams_manager(pkgs):
    for p in pkgs:
        src = p.memory_stream(*KV)
        q = (src.toDF(p.session).writeStream.format("memory")
             .queryName("s_mgr").trigger(processingTime="1 seconds")
             .start())
        assert any(a.id == q.id for a in p.session.streams.active)
        q.stop()
        assert all(a.id != q.id for a in p.session.streams.active)


def _file_stream_replay_after_crash(p, tmp):
    base = os.path.join(tmp, p.root)
    data_dir = os.path.join(base, "in2")
    os.makedirs(data_dir)
    ckpt = os.path.join(base, "ckpt_replay")
    s = p.session
    s.createDataFrame({"x": np.array([1, 2], np.int64)}) \
        .write.json(os.path.join(data_dir, "f1"))
    stream = s.readStream.format("json").schema("x bigint").load(data_dir)
    q = _memory(stream, "s_crash", ckpt=ckpt)
    q.processAllAvailable()
    s.createDataFrame({"x": np.array([3], np.int64)}) \
        .write.json(os.path.join(data_dir, "f2"))
    q.processAllAvailable()
    first = p.rows("s_crash")
    q.stop()
    os.remove(os.path.join(ckpt, "commits", "1"))
    stream2 = s.readStream.format("json").schema("x bigint").load(data_dir)
    q2 = _memory(stream2, "s_crash2", ckpt=ckpt)
    q2.processAllAvailable()
    q2.stop()
    return [first, p.rows("s_crash2")]


def test_file_stream_replay_after_crash(pkgs, tmp_path):
    ref = both(pkgs, _file_stream_replay_after_crash, str(tmp_path))
    assert ref == [[(1,), (2,), (3,)], [(3,)]]


def test_append_mode_aggregation_rejected(pkgs):
    for p in pkgs:
        src = p.memory_stream(*KV)
        agg = src.toDF(p.session).groupBy("k").agg(p.F.sum("v").alias("s"))
        with pytest.raises(p.AnalysisException, match="append"):
            _memory(agg, "s_appagg")


def _update_mode(p):
    src = p.memory_stream(*KV)
    agg = src.toDF(p.session).groupBy("k").agg(p.F.sum("v").alias("s"))
    q = _memory(agg, "s_upd", "update")
    out = []
    for rows in ([("a", 1), ("b", 2)], [("a", 10)]):
        src.addData(rows)
        q.processAllAvailable()
        out.append(p.rows("s_upd"))
    q.stop()
    return out


def test_update_mode_emits_only_changed_groups(pkgs):
    ref = both(pkgs, _update_mode)
    assert ref[-1] == [("a", 1), ("a", 11), ("b", 2)]


def test_aggregate_under_unsupported_op_rejected(pkgs):
    for p in pkgs:
        src = p.memory_stream(*KV)
        agg = src.toDF(p.session).groupBy("k").agg(p.F.sum("v").alias("s"))
        static = p.session.createDataFrame(
            {"k": ["a"], "w": np.array([1], np.int64)})
        with pytest.raises(p.AnalysisException, match="incrementally"):
            _memory(agg.join(static, "k"), "s_aggjoin", "complete")


def _having(p):
    src = p.memory_stream(*KV)
    agg = src.toDF(p.session).groupBy("k").agg(p.F.sum("v").alias("s"))
    q = _memory(agg.filter(agg["s"] > 5), "s_hav", "complete")
    out = []
    for rows in ([("a", 3), ("b", 10)], [("a", 4)]):
        src.addData(rows)
        q.processAllAvailable()
        out.append(p.rows("s_hav"))
    q.stop()
    return out


def test_having_filter_above_aggregate_incremental(pkgs):
    ref = both(pkgs, _having)
    assert ref == [[("b", 10)], [("a", 7), ("b", 10)]]


def _stream_static_join(p):
    src = p.memory_stream(*KV)
    static = p.session.createDataFrame(
        {"k": ["a", "a", "b"], "w": np.array([1, 2, 5], np.int64)})
    sagg = static.groupBy("k").agg(p.F.sum("w").alias("tw"))
    q = _memory(src.toDF(p.session).join(sagg, "k"), "s_ssj")
    src.addData([("a", 10)])
    q.processAllAvailable()
    q.stop()
    return [p.rows("s_ssj")]


def test_stream_static_join_with_static_aggregate(pkgs):
    assert both(pkgs, _stream_static_join) == [[("a", 10, 3)]]


# ---------------------------------------------------------------------------
# the port's state on the device
# ---------------------------------------------------------------------------

def _random_feeds(seed, n_batches=4, rows=200, keys=30):
    rng = np.random.default_rng(seed)
    feeds = []
    for _ in range(n_batches):
        ks = rng.integers(0, keys, rows)
        vs = rng.integers(-50, 1000, rows)
        xs = rng.random(rows) * 100.0
        feeds.append([(f"k{k}", int(v), float(x))
                      for k, v, x in zip(ks, vs, xs)])
    return feeds


def _seeded_aggregate(p, mode):
    F = p.F
    src = p.memory_stream(("k", "string"), ("v", "int64"), ("x", "float64"))
    agg = src.toDF(p.session).groupBy("k").agg(
        F.sum("v").alias("s"), F.count("*").alias("c"),
        F.avg("x").alias("ax"), F.min("v").alias("lo"),
        F.max("x").alias("hx"))
    q = _memory(agg, f"s_seed_{mode}", mode)
    out = []
    for feed in _random_feeds(11):
        src.addData(feed)
        q.processAllAvailable()
        out.append(p.rows(f"s_seed_{mode}"))
    rows = [int(np.asarray(q._ex._agg_state.state.num_rows()))]
    q.stop()
    return out + [rows]


@pytest.mark.parametrize("mode", ["complete", "update"])
def test_seeded_aggregation_per_trigger(pkgs, mode):
    """Seeded batches of 200 rows over 30 string keys: every trigger's
    output of sum/count/avg/min/max equals the reference's, and so does
    the number of groups the state holds."""
    both(pkgs, _seeded_aggregate, mode)


def test_state_merge_runs_on_the_session_device(tspark, monkeypatch):
    """The merge calls the sort-based grouped aggregate on the state's
    device tensors: the state stays a device batch between triggers and
    no merge goes through numpy."""
    from spark_tpu_torch import kernels
    from spark_tpu_torch.streaming.core import AggregationState
    p = Pkg("spark_tpu_torch", tspark)
    calls = []
    orig = kernels._sorted_grouped_aggregate

    def spy(batch, keys, slots):
        calls.append(batch.device.type)
        return orig(batch, keys, slots)

    monkeypatch.setattr(kernels, "_sorted_grouped_aggregate", spy)
    src = p.memory_stream(*KV)
    agg = src.toDF(tspark).groupBy("k").agg(p.F.sum("v").alias("s"))
    q = _memory(agg, "s_dev", "complete")
    src.addData([("a", 1), ("b", 2)])
    q.processAllAvailable()
    src.addData([("a", 5)])
    q.processAllAvailable()
    st = q._ex._agg_state
    assert isinstance(st, AggregationState)
    assert st.state.device == tspark.device
    assert calls and set(calls) == {tspark.device.type}
    assert p.rows("s_dev") == [("a", 6), ("b", 2)]
    q.stop()


def _snapshot_rows(p, tmp):
    """The state snapshot a commit names: its groups and buffers (value
    order may differ) and its capacity."""
    import pickle
    ckpt = os.path.join(tmp, p.root)
    src = p.memory_stream(*KV)
    agg = src.toDF(p.session).groupBy("k").agg(p.F.sum("v").alias("s"),
                                               p.F.count("*").alias("c"))
    q = _memory(agg, "s_snap", "complete", ckpt)
    for feed in _random_feeds(5, n_batches=2):
        src.addData([(k, v) for k, v, _x in feed])
        q.processAllAvailable()
    q.stop()
    with open(os.path.join(ckpt, "state", "1.snapshot"), "rb") as f:
        payload = pickle.load(f)
    names = payload["names"]
    rv = np.asarray(payload["row_valid"], bool)
    kidx = names.index("k")
    keys = np.asarray(payload["dicts"][kidx], object)[
        np.asarray(payload["data"][kidx])[rv]]
    cols = {n: np.asarray(d)[rv] for n, d in zip(names, payload["data"])
            if n != "k"}
    rows = sorted(zip(keys.tolist(), *[c.tolist() for c in cols.values()]))
    return [rows, sorted(cols), int(payload["capacity"])]


def test_state_snapshot_holds_the_same_groups(pkgs, tmp_path):
    """The same groups and buffers in both packages; the port's snapshot
    at the capacity of its live groups, the JAX package's at that of
    every batch merged so far (ROADMAP §3)."""
    from spark_tpu_torch.columnar import pad_capacity
    outs = [_snapshot_rows(p, str(tmp_path)) for p in pkgs]
    same([o[:2] for o in outs])
    (rows, _cols, ref_cap), (_rows, _cols2, port_cap) = outs
    assert port_cap == pad_capacity(len(rows)) < ref_cap, (port_cap,
                                                           ref_cap)


def _spill_under_budget(p, tmp):
    """A host budget too small for the state: the ledger refuses its
    reservation after each commit and the state spills as a wire file,
    then comes back for the next trigger."""
    ckpt = os.path.join(tmp, p.root)
    s = p.session
    # the budget is set before the ledger is built: the reference's
    # ledger reads it once, at construction
    s.conf.set("spark.tpu.memory.hostBudget", "64")
    if p.is_port:
        from spark_tpu_torch.memory import HostMemoryLedger
    else:
        from spark_tpu.memory import HostMemoryLedger
    s._host_ledger = HostMemoryLedger(s.conf_obj)
    try:
        src = p.memory_stream(*KV)
        agg = src.toDF(s).groupBy("k").agg(p.F.sum("v").alias("s"))
        q = _memory(agg, "s_spill", "complete", ckpt)
        out = []
        for feed in _random_feeds(9, n_batches=3, rows=40, keys=6):
            src.addData([(k, v) for k, v, _x in feed])
            q.processAllAvailable()
            m = q._ex.metrics
            out.append((p.rows("s_spill"), m["spill_events"],
                        m["state_rows"]))
        q.stop()
        return out
    finally:
        s.conf.unset("spark.tpu.memory.hostBudget")
        s._host_ledger = None


def test_state_spills_under_a_small_host_budget(pkgs, tmp_path):
    ref = both(pkgs, _spill_under_budget, str(tmp_path))
    assert ref[-1][1] == 3


def test_commit_and_offset_payloads_match(pkgs, tmp_path):
    """The offset and commit logs of both packages for the same stream
    agree field by field, leaving out the time stamp and the state
    snapshot's CRC (a checksum of a pickle that names its package)."""
    from torch_stream_common import sec
    logs = []
    for p in pkgs:
        ckpt = str(tmp_path / p.root)
        src = p.memory_stream(("ts", "timestamp"), ("k", "string"),
                              ("v", "int64"))
        agg = (src.toDF(p.session).withWatermark("ts", "5 seconds")
               .groupBy(p.F.window("ts", "10 seconds").alias("w"))
               .agg(p.F.sum("v").alias("s")))
        q = _memory(agg, "s_logs", "append", ckpt)
        for rows in ([(sec(1), "a", 1), (sec(9), "a", 2)],
                     [(sec(20), "a", 4)], [(sec(35), "b", 8)]):
            src.addData(rows)
            q.processAllAvailable()
        q.stop()
        ml = p.core.MetadataLog
        offs = [ml(os.path.join(ckpt, "offsets")).get(i) for i in range(3)]
        coms = [ml(os.path.join(ckpt, "commits")).get(i) for i in range(3)]
        for c in coms:
            c.pop("ts")
            c["state"].pop("crc")
        logs.append((offs, coms))
    assert logs[0] == logs[1]
    assert logs[0][1][2]["wm"] == sec(30)


# ---------------------------------------------------------------------------
# the chip script's [stream] scenarios at a small size, against their
# numpy oracles (spark_tpu_torch/testing.py)
# ---------------------------------------------------------------------------

YAHOO_N, YAHOO_T = 1 << 11, 3
YAHOO_WATERMARK = 10


@pytest.fixture(scope="module")
def yahoo(tspark, tmp_path_factory):
    from spark_tpu_torch import testing as TT
    root = tmp_path_factory.mktemp("yahoo")
    staged = str(root / "staged")
    files = TT.yahoo_write(tspark, staged, YAHOO_N, YAHOO_T)
    feeds = [TT.yahoo_events(YAHOO_N, t) for t in range(YAHOO_T)]
    return root, files, feeds, TT.yahoo_ads()


@pytest.mark.parametrize("mode", ["update", "append"])
def test_yahoo_campaign_counts_match_the_oracle(tspark, yahoo, mode):
    """Scenarios (a) and (b): each trigger's windowed campaign counts
    equal the oracle's exactly; from the second trigger on no stage is
    captured anew; in append mode no window is emitted twice."""
    from spark_tpu_torch import testing as TT
    from spark_tpu_torch.sql import functions as F
    root, files, feeds, ads = yahoo
    got = TT.stream_counts(tspark, F, str(root / f"in-{mode}"), files,
                           tspark.createDataFrame(ads), mode)
    want = TT.yahoo_counts_oracle(feeds, ads, mode)
    assert [g["emit"] for g in got] == [w["emit"] for w in want]
    assert [g["progress"]["stageRebuilds"] for g in got][1:] \
        == [0] * (YAHOO_T - 1)
    assert [g["metrics"]["state_rows"] for g in got] \
        == [w["state_groups"] for w in want]
    if mode == "append":
        keys = [k for g in got for k in g["emit"]]
        assert len(keys) == len(set(keys)) and keys


def test_yahoo_dedup_matches_the_oracle(tspark, yahoo):
    """Scenario (c): the keys let through, the state's rows and the
    evictions per trigger equal the oracle's."""
    from spark_tpu_torch import testing as TT
    root, files, feeds, _ads = yahoo
    got = TT.stream_dedup(tspark, str(root / "in-dedup"), files, 20)
    want = TT.yahoo_dedup_oracle(feeds, 20)
    for g, w in zip(got, want):
        assert np.array_equal(g["emit"], w["emit"])
        assert g["metrics"]["state_rows"] == w["state_rows"]
    assert got[-1]["evicted"] == sum(w["evicted"] for w in want)


def test_yahoo_view_click_join_matches_the_oracle(tspark, tmp_path):
    """Scenario (d): each trigger's joined rows and the views buffer
    equal the oracle's."""
    from spark_tpu_torch import testing as TT
    from spark_tpu_torch.sql import functions as F
    vdirs, cdirs, sides = TT.write_join_sides(tspark, str(tmp_path), 1 << 9,
                                              3)
    got = TT.stream_join(tspark, F, str(tmp_path / "watch"), vdirs, cdirs,
                         YAHOO_WATERMARK)
    want = TT.stream_join_oracle(sides, YAHOO_WATERMARK)
    for g, w in zip(got, want):
        assert np.array_equal(g["emit"], w["rows"])
        assert g["view_buffer"] == w["view_buffer"]
        assert g["click_buffer"] == w["click_buffer"]
    assert sum(len(w["rows"]) for w in want) > 0


def test_session_counts_match_the_oracle(tspark):
    """Scenario (e): per-user session counts with an event-time timeout
    equal the plain-dictionary oracle's per trigger."""
    from spark_tpu_torch import testing as TT
    feeds = TT.session_events(1 << 10, 4, 100)
    got = TT.stream_sessions(tspark, feeds)
    assert [g["emit"] for g in got] == TT.session_oracle(feeds)
    assert any(closed for _u, _n, closed in got[-1]["emit"])


def test_yahoo_update_counts_match_the_jax_package(spark, tspark, yahoo):
    """Scenario (a)'s query through the JAX package on the same files:
    the same rows per trigger."""
    from spark_tpu.sql import functions as RF
    from spark_tpu_torch import testing as TT
    root, files, feeds, ads = yahoo
    ref = spark.newSession()
    in_dir = str(root / "in-ref")
    os.makedirs(in_dir)
    seen = []
    q = (TT.yahoo_campaign_counts(ref, RF, TT.yahoo_stream(ref, in_dir),
                                  ref.createDataFrame(ads))
         .writeStream.foreachBatch(
             lambda bdf, _b: seen.append(sorted(
                 (int(r["w"].timestamp() * 1e6) if hasattr(r["w"],
                                                           "timestamp")
                  else r["w"], r["campaign_id"], r["n"])
                 for r in bdf.collect())))
         .outputMode("update").trigger(once=True).start())
    for f in files:
        os.symlink(f, os.path.join(in_dir, os.path.basename(f)))
        q.processAllAvailable()
    q.stop()
    want = TT.yahoo_counts_oracle(feeds, ads, "update")
    assert len(seen) == YAHOO_T
    for s, w in zip(seen, want):
        assert sorted((c, n) for _w, c, n in s) \
            == sorted((c, n) for (_w, c), n in w["emit"].items())


def _capacity_growth(p):
    src = p.memory_stream(("ts", "timestamp"), ("k", "int64"),
                          ("v", "int64"))
    q = _memory(src.toDF(p.session).withWatermark("ts", "0 seconds")
                .dropDuplicates(["k", "ts"]), "s_capgrow")
    out = []
    for t in range(4):
        src.addData([(t * 10_000_000 + i, i, i) for i in range(8)])
        q.processAllAvailable()
        m = q._ex.metrics
        out.append((m["state_rows"], q._ex._dedup_state.state.capacity,
                    m["state_bytes"]))
    q.stop()
    return out


def test_state_capacity_grows_with_every_trigger_in_both_packages(pkgs):
    """Named for a fault of the JAX package as it was found, repaired in
    the port (ROADMAP §3): the reference's state is the compacted union
    of itself and each batch, so its capacity, and the bytes the ledger
    charges, grow with every trigger while one key lives.  The port cuts
    the state to the capacity of its live rows after each merge and
    eviction: the same live rows, at flat capacity and bytes."""
    ref, port = (_capacity_growth(p) for p in pkgs)
    assert ref == [(1, 8, 136), (1, 16, 272), (1, 24, 408), (1, 32, 544)]
    assert port == [(1, 8, 136)] * 4


def _null_only_string_keys(p, op, triggers):
    src = p.memory_stream(*KV)
    df = src.toDF(p.session)
    if op == "dedup":
        q = _memory(df.dropDuplicates(["k"]), "s_nullkey")
    else:
        q = _memory(df.groupBy("k").agg(p.F.sum("v").alias("s")),
                    "s_nullkey", "update")
    out = []
    try:
        for rows in triggers:
            src.addData(rows)
            q.processAllAvailable()
            out.append(p.rows("s_nullkey"))
    finally:
        q.stop()
    return out


@pytest.mark.parametrize("op", ["dedup", "update"])
@pytest.mark.parametrize("triggers", [
    [[(None, 1)]], [[("a", 1)], [(None, 2)]]], ids=["null", "a-then-null"])
def test_null_only_string_key_decode_reference_fault(pkgs, op, triggers):
    """Named for a fault of the JAX package (ROADMAP §3): a micro-batch
    whose string key is NULL on every row has an empty dictionary, and
    the reference's host decode of the key (``_decode_host_col``) indexes
    it at -1.  The port keys its state on the card and answers."""
    ref, port = pkgs
    with pytest.raises(IndexError):
        _null_only_string_keys(ref, op, triggers)
    got = _null_only_string_keys(port, op, triggers)
    if len(triggers) == 1:
        assert got == [[(None, 1)]]
    else:
        assert got == [[("a", 1)], [("a", 1), (None, 2)]]


def test_streaming_context_from_spark_context_reference_fault(
        spark, tspark, tmp_path):
    """Named for a fault of the JAX package (ROADMAP §3): its
    ``StreamingContext.__init__`` takes ``sparkContext._session`` — a
    method of ``SparkContext`` — as the session, so a DStream made from
    ``spark.sparkContext`` fails at ``textFileStream``.  The port calls
    the method and its DStream's batches arrive."""
    from spark_tpu.streaming.dstream import StreamingContext as RSC
    from spark_tpu_torch.streaming.dstream import DStream
    from spark_tpu_torch.streaming.dstream import StreamingContext as TSC
    d = tmp_path / "in"
    d.mkdir()
    (d / "part-0.txt").write_text("alpha\nbeta\ngamma\n")
    with pytest.raises(AttributeError, match="readStream"):
        RSC(spark.sparkContext, 0.2).textFileStream(str(d))
    ssc = TSC(tspark.sparkContext, 0.2)
    assert ssc._session is tspark
    stream = ssc.textFileStream(str(d))
    assert isinstance(stream, DStream)
    seen = []
    stream.foreachRDD(lambda df: seen.extend(r[0] for r in df.collect()))
    ssc.start()
    try:
        deadline = time.time() + 30
        while time.time() < deadline and len(seen) < 3:
            time.sleep(0.05)
    finally:
        ssc.stop()
    assert sorted(seen) == ["alpha", "beta", "gamma"]
