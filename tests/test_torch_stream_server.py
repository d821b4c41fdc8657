"""Standing queries of the port's SQL server against ``spark_tpu``'s on
the CPU: ``POST /stream``, ``GET /stream/<id>``, ``DELETE /stream/<id>``,
the session registry that keeps a session with a standing query from the
idle reaper, and admission's standing tenants under
``spark.tpu.server.maxStandingQueries`` (the JAX package's
``tests/test_serving.py`` stream tests, run on both servers).  Then the
port's spec with a watermark and a SQL text over the stream (a windowed
count joined to a static table), which the JAX package's server does not
take: its answer is held against the same query run through the
DataFrame API of the JAX package."""

import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from spark_tpu import config as RC
from spark_tpu import server as RS
from spark_tpu_torch import config as TC
from spark_tpu_torch import server as TS
from spark_tpu_torch.sql.session import SparkSession as TSession


def _impl(name, spark, tmp_path):
    if name == "reference":
        root = spark.newSession()
        ns = types.SimpleNamespace(name=name, root=root, srv=RS, C=RC)
    else:
        root = TSession(TC.Conf({"spark.torch.device": "cpu"}))
        ns = types.SimpleNamespace(name=name, root=root, srv=TS, C=TC)
    root.conf.set("spark.sql.warehouse.dir", str(tmp_path / name / "wh"))
    return ns


@pytest.fixture(params=["reference", "port"])
def impl(request, spark, tmp_path):
    return _impl(request.param, spark, tmp_path)


def _req(srv, path, method="GET", body=None):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}",
        data=body.encode() if isinstance(body, str) else body,
        method=method)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _start_json_stream(srv, sid, tmp_path, tag="s"):
    data = tmp_path / f"{tag}-in"
    data.mkdir(parents=True)
    srv.session.createDataFrame(
        {"x": np.arange(4, dtype=np.int64)}).write.json(str(data / "f1"))
    spec = {"session": sid,
            "source": {"format": "json", "path": str(data),
                       "schema": "x bigint"},
            "sink": {"format": "json", "path": str(tmp_path / f"{tag}-out")},
            "checkpoint": str(tmp_path / f"{tag}-ckpt"),
            "interval": 0.1}
    _, r = _req(srv, "/stream", "POST", json.dumps(spec))
    return r["streamId"]


def _wait_stream_commit(srv, stream_id, n=1, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        _, st = _req(srv, f"/stream/{stream_id}")
        if st["metrics"]["batches_committed"] >= n:
            return st
        time.sleep(0.05)
    raise AssertionError(f"stream {stream_id} never committed {n} batches")


def test_stream_endpoint_register_status_stop(impl, tmp_path):
    tmp = tmp_path / impl.name
    srv = impl.srv.SQLServer(impl.root, port=0).start()
    try:
        _, s = _req(srv, "/session", "POST")
        sid = s["sessionId"]
        stream_id = _start_json_stream(srv, sid, tmp)
        st = _wait_stream_commit(srv, stream_id)
        assert st["active"] and st["batchId"] >= 1
        assert st["metrics"]["replayed_batches"] == 0
        assert st["lastProgress"]["stageRebuilds"] is not None
        _, status = _req(srv, "/status")
        assert status["standingQueries"][stream_id]["session"] == sid
        assert status["admission"]["standingQueries"] == 1
        assert status["metrics"]["streaming"]["standing_queries"] == 1
        assert status["metrics"]["streaming"]["batches_committed"] >= 1
        out = tmp / "s-out"
        assert any(out.glob("part-*"))
        rows = sorted(json.loads(line)["x"] for p in out.glob("part-*")
                      for line in open(p) if line.strip())
        assert rows == [0, 1, 2, 3]
        _, r = _req(srv, f"/stream/{stream_id}", "DELETE")
        assert r["stopped"] == stream_id and r["batchesCommitted"] >= 1
        _, status = _req(srv, "/status")
        assert status["admission"]["standingQueries"] == 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(srv, f"/stream/{stream_id}")
        assert ei.value.code == 404
    finally:
        srv.stop()


def test_session_with_standing_query_never_idle_reaped(impl, tmp_path):
    tmp = tmp_path / impl.name
    impl.root.conf.set(impl.C.SERVER_SESSION_TIMEOUT.key, "10")
    srv = impl.srv.SQLServer(impl.root, port=0).start()
    try:
        _, s1 = _req(srv, "/session", "POST")
        _, s2 = _req(srv, "/session", "POST")
        sid1, sid2 = s1["sessionId"], s2["sessionId"]
        stream_id = _start_json_stream(srv, sid1, tmp)
        _wait_stream_commit(srv, stream_id)
        assert srv._expire_idle_sessions(now=time.time() + 60) == 1
        assert sid1 in srv._sessions and sid2 not in srv._sessions
        _, st = _req(srv, f"/stream/{stream_id}")
        assert st["active"]
        _req(srv, f"/stream/{stream_id}", "DELETE")
        assert srv._expire_idle_sessions(now=time.time() + 60) == 1
        assert sid1 not in srv._sessions
    finally:
        srv.stop()


def test_standing_query_cap_rejects_429_with_retry_after(impl, tmp_path):
    tmp = tmp_path / impl.name
    impl.root.conf.set(impl.C.SERVER_MAX_STANDING_QUERIES.key, "1")
    srv = impl.srv.SQLServer(impl.root, port=0).start()
    try:
        _, s = _req(srv, "/session", "POST")
        sid = s["sessionId"]
        stream_id = _start_json_stream(srv, sid, tmp, tag="a")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _start_json_stream(srv, sid, tmp, tag="b")
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        body = json.loads(ei.value.read())
        assert body["limit"] == "maxStandingQueries"
        _req(srv, f"/stream/{stream_id}", "DELETE")
        _start_json_stream(srv, sid, tmp, tag="c")
        _, status = _req(srv, "/status")
        assert status["admission"]["peakStandingQueries"] == 1
        assert srv._admission.demand_signal().standing == 1
    finally:
        srv.stop()


def test_closing_a_session_releases_its_streams(impl, tmp_path):
    tmp = tmp_path / impl.name
    srv = impl.srv.SQLServer(impl.root, port=0).start()
    try:
        _, s = _req(srv, "/session", "POST")
        stream_id = _start_json_stream(srv, s["sessionId"], tmp)
        _wait_stream_commit(srv, stream_id)
        _req(srv, f"/session/{s['sessionId']}", "DELETE")
        _, status = _req(srv, "/status")
        assert status["admission"]["standingQueries"] == 0
        assert stream_id not in status["standingQueries"]
    finally:
        srv.stop()


def test_sql_spec_windowed_count_matches_the_dataframe_query(spark,
                                                             tmp_path):
    """The port's spec extension: a watermark and a SQL text over the
    stream's temp view, joined to a static view of the session.  Its sink
    holds, per trigger, what the JAX package's DataFrame query of the same
    shape emits over the same files."""
    from spark_tpu.sql import functions as RF
    from spark_tpu.streaming.core import FileSink as RFileSink
    from spark_tpu.streaming.core import StreamExecution as RExec
    sec = 1_000_000
    feeds = [[(1, 10, "view"), (2, 12, "view"), (1, 14, "click")],
             [(1, 20, "view"), (3, 22, "view")],
             [(2, 35, "view"), (1, 41, "view")]]
    root = TSession(TC.Conf({"spark.torch.device": "cpu",
                             "spark.sql.warehouse.dir":
                             str(tmp_path / "wh")}))
    data = tmp_path / "in"
    data.mkdir()
    for i, rows in enumerate(feeds):
        root.createDataFrame({
            "ad_id": np.array([r[0] for r in rows], np.int64),
            "t": np.array([r[1] * sec for r in rows], "datetime64[us]"),
            "kind": [r[2] for r in rows]}).write.parquet(
                str(data / f"f{i}"))
    ads = {"ad_id": np.array([1, 2, 3], np.int64),
           "campaign": np.array([7, 7, 8], np.int64)}
    root.createDataFrame(ads).createOrReplaceTempView("ads")
    text = ("SELECT window(t, '10 seconds') AS w, campaign, COUNT(*) AS n "
            "FROM events JOIN ads ON events.ad_id = ads.ad_id "
            "WHERE kind = 'view' GROUP BY window(t, '10 seconds'), campaign")
    spec = {"source": {"format": "parquet", "path": str(data),
                       "schema": "ad_id long, t timestamp, kind string",
                       "options": {"maxFilesPerTrigger": "1"}},
            "watermark": {"column": "t", "delay": "5 seconds"},
            "view": "events", "sql": text, "mode": "update",
            "sink": {"format": "json", "path": str(tmp_path / "out")},
            "checkpoint": str(tmp_path / "ckpt"), "interval": 0.05}
    srv = TS.SQLServer(root, port=0).start()
    try:
        _, r = _req(srv, "/stream", "POST", json.dumps(spec))
        st = _wait_stream_commit(srv, r["streamId"], n=len(feeds))
        assert st["metrics"]["batches_committed"] == len(feeds)
        assert "merge_ms" in st["timings"]
        _req(srv, f"/stream/{r['streamId']}", "DELETE")
    finally:
        srv.stop()
    # the JAX package's DataFrame query of the same shape, same files
    ref = spark.newSession()
    ev = (ref.readStream.format("parquet")
          .schema("ad_id long, t timestamp, kind string")
          .option("maxFilesPerTrigger", 1).load(str(data)))
    rads = ref.createDataFrame(ads)
    df = (ev.withWatermark("t", "5 seconds")
          .filter(RF.col("kind") == "view").join(rads, "ad_id")
          .groupBy(RF.window("t", "10 seconds").alias("w"), "campaign")
          .agg(RF.count("*").alias("n")))
    ex = RExec(ref, df._plan, RFileSink("json", str(tmp_path / "rout"), {}),
               "update", str(tmp_path / "rckpt"), 0.1, None)
    ex.process_all_available()
    for i in range(len(feeds)):
        name = f"part-{i:05d}.json"
        got = sorted(json.dumps(json.loads(line), sort_keys=True) for line
                     in open(tmp_path / "out" / name) if line.strip())
        want = sorted(json.dumps(json.loads(line), sort_keys=True) for line
                      in open(tmp_path / "rout" / name) if line.strip())
        assert got == want, (i, got, want)
