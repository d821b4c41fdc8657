"""The port's SQL server (``spark_tpu_torch/server.py``) against the
reference's (``spark_tpu/server.py``) on the CPU.

Both servers answer the same statements over HTTP with equal
``columns`` and ``rows`` (integers exact, floats within ``RTOL``, dates
and decimals in their JSON forms).  Then the cases of the reference's
``tests/test_serving.py`` whose features this slice brings, each run
against BOTH servers and held to the reference's outcome: cross-session
sharing, repeat ``cacheHit`` fields, the two admission rejections, the
per-shape Retry-After, the admission stress run, cancel of a queued
statement, the idle-session TTL, the ``/status`` fields and the plan
cache disabled by conf.  The
statement deadline runs on the port alone: the reference's scenario
needs a streamed parquet scan, the port's is a slow row-lane UDF
cancelled at the next operator's checkpoint; the outcome asserted is
the reference test's.
"""

import json
import math
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from spark_tpu import config as RC
from spark_tpu import server as RS
from spark_tpu import serving as RV
from spark_tpu import types as RT
from spark_tpu_torch import config as TC
from spark_tpu_torch import server as TS
from spark_tpu_torch import serving as TV
from spark_tpu_torch import types as TT
from spark_tpu_torch.sql.session import SparkSession as TSession

#: float columns: the two packages sum in different orders
RTOL = 1e-12


def _impl(name, spark):
    if name == "reference":
        root = spark.newSession()
        return types.SimpleNamespace(name=name, root=root, srv=RS,
                                     C=RC, V=RV, T=RT)
    root = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    return types.SimpleNamespace(name=name, root=root, srv=TS, C=TC, V=TV,
                                 T=TT)


@pytest.fixture(params=["reference", "port"])
def impl(request, spark):
    """A fresh root session of one package (server-side conf experiments
    must not leak), with that package's server, conf, serving and types
    modules."""
    return _impl(request.param, spark)


def _req(srv, path, method="GET", body=None, headers=None):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}",
        data=body.encode() if isinstance(body, str) else body,
        method=method, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _sql(srv, query, sid=None, stmt_id=None):
    body = {"query": query}
    if sid:
        body["session"] = sid
    if stmt_id:
        body["id"] = stmt_id
    return _req(srv, "/sql", "POST", json.dumps(body))[1]


# ---------------------------------------------------------------------------
# the same statements, the same answers
# ---------------------------------------------------------------------------

def _register(impl):
    """One table with every JSON form: ints, floats with NaN, strings
    and NULLs, a decimal, dates."""
    T = impl.T
    rng = np.random.default_rng(11)
    n = 300
    f = rng.normal(0, 10, n)
    f[::17] = np.nan
    data = {"k": rng.integers(0, 7, n).astype(np.int64),
            "v": rng.integers(-50, 50, n).astype(np.int64),
            "f": f,
            "s": [None if i % 11 == 0 else f"w{i % 5}" for i in range(n)],
            "p": np.round(rng.uniform(0, 100, n), 2),
            "d": np.array("2001-01-01", dtype="datetime64[D]")
            + rng.integers(-400, 400, n)}
    st = T.StructType([T.StructField("k", T.int64), T.StructField("v", T.int64),
                       T.StructField("f", T.float64),
                       T.StructField("s", T.string),
                       T.StructField("p", T.DecimalType(7, 2)),
                       T.StructField("d", T.date)])
    impl.root.createDataFrame(data, schema=st).createOrReplaceTempView("t")


PARITY = [
    "SELECT id, id * 2 AS y FROM range(64) ORDER BY id",
    "SELECT sum(id) AS s FROM range(100) WHERE id < 77",
    "SELECT 1 AS one",
    "SELECT k, SUM(v) AS sv, COUNT(*) AS c, AVG(f) AS af FROM t "
    "GROUP BY k ORDER BY k",
    "SELECT s, MIN(d) AS md, MAX(p) AS mp FROM t GROUP BY s ORDER BY s",
    "SELECT k, v, f, s, p, d FROM t WHERE v > 40 ORDER BY k, v, f",
    "SELECT k, v FROM t WHERE v < 10 UNION ALL SELECT k, v FROM t "
    "WHERE v > 45 ORDER BY k, v",
    "SELECT k, COUNT(*) AS c FROM t WHERE s LIKE 'w1%' GROUP BY k "
    "ORDER BY k",
]


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=RTOL)
    return a == b and type(a) is type(b)


def test_port_answers_equal_reference(spark):
    ref = _impl("reference", spark)
    got = _impl("port", spark)
    servers = []
    try:
        for impl in (ref, got):
            _register(impl)
            servers.append(impl.srv.SQLServer(impl.root, port=0).start())
        for q in PARITY:
            a, b = (_sql(srv, q) for srv in servers)
            assert a["columns"] == b["columns"], q
            assert a["rowCount"] == b["rowCount"] == len(b["rows"]), q
            assert len(a["rows"]) > 0, q
            for ra, rb in zip(a["rows"], b["rows"]):
                assert len(ra) == len(rb), q
                assert all(_close(x, y) for x, y in zip(ra, rb)), (q, ra, rb)
        # the repeat is a plan-cache hit on both, with the same rows
        for q in PARITY[:2]:
            a, b = (_sql(srv, q) for srv in servers)
            assert a["cacheHit"] is b["cacheHit"] is True, q
            assert a["rows"] == b["rows"], q
    finally:
        for srv in servers:
            srv.stop()


def test_json_safe_equals_reference():
    import datetime
    for v in (None, True, 3, 2.5, float("nan"), float("inf"),
              float("-inf"), "x", datetime.date(1969, 12, 31),
              datetime.datetime(2001, 2, 3, 4, 5, 6, 7), [1, float("nan")],
              (2, "y")):
        assert TS._json_safe(v) == RS._json_safe(v), v


# ---------------------------------------------------------------------------
# the reference's serving cases, on both servers
# ---------------------------------------------------------------------------

def test_plan_cache_shared_across_sessions(impl):
    srv = impl.srv.SQLServer(impl.root, port=0).start()
    try:
        _, s1 = _req(srv, "/session", "POST")
        _, s2 = _req(srv, "/session", "POST")
        q = "SELECT id, id * 2 AS y FROM range(64) ORDER BY id"
        r1 = _sql(srv, q, s1["sessionId"])
        assert r1["cacheHit"] is False
        r2 = _sql(srv, q, s2["sessionId"])
        assert r2["cacheHit"] is True, \
            "session 2 must reuse session 1's plan"
        assert r2["planningSkippedMs"] > 0
        assert r2["rows"] == r1["rows"]
        _, st = _req(srv, "/status")
        assert st["planCache"]["hits"] >= 1
        assert st["planCache"]["entries"] >= 1
        assert st["metrics"]["serving"]["plan_cache_hits"] >= 1
    finally:
        srv.stop()


def test_response_cache_fields_on_repeat(impl):
    srv = impl.srv.SQLServer(impl.root, port=0).start()
    try:
        _, s = _req(srv, "/session", "POST")
        sid = s["sessionId"]
        q = "SELECT sum(id) AS s FROM range(100) WHERE id < 77"
        first = _sql(srv, q, sid)
        again = _sql(srv, q, sid)
        assert first["cacheHit"] is False
        assert again["cacheHit"] is True
        assert again["rows"] == first["rows"] == [[sum(range(77))]]
        assert set(again) >= {"columns", "rows", "rowCount", "durationMs",
                              "statementId", "cacheHit",
                              "planningSkippedMs"}
    finally:
        srv.stop()


def test_admission_rejects_over_global_cap(impl):
    impl.root.conf.set(impl.C.SERVER_MAX_CONCURRENT_STATEMENTS.key, "1")
    srv = impl.srv.SQLServer(impl.root, port=0, workers=2).start()
    try:
        _, sa = _req(srv, "/session", "POST")
        _, sb = _req(srv, "/session", "POST")
        ssa = srv._sessions[sa["sessionId"]]
        ssa.lock.acquire()               # wedge A mid-statement
        try:
            done = {}

            def post_a():
                done["a"] = _sql(srv, "SELECT 1", sa["sessionId"])

            th = threading.Thread(target=post_a)
            th.start()
            time.sleep(0.5)              # let A's statement be admitted
            with pytest.raises(urllib.error.HTTPError) as ei:
                _sql(srv, "SELECT 2", sb["sessionId"])
            assert ei.value.code == 429
            body = json.loads(ei.value.read())
            assert body["limit"] == "maxConcurrentStatements"
            assert body["cap"] == 1 and body["retryAfterSeconds"] >= 1
            assert int(ei.value.headers["Retry-After"]) >= 1
        finally:
            ssa.lock.release()
        th.join(60)
        assert done["a"]["rows"] == [[1]]    # the admitted one completed
        _, st = _req(srv, "/status")
        assert st["admission"]["rejected"] >= 1
        assert st["admission"]["rejectedBy"]["maxConcurrentStatements"] >= 1
        assert _sql(srv, "SELECT 3", sb["sessionId"])["rows"] == [[3]]
    finally:
        srv.stop()


def test_admission_rejects_deep_session_queue(impl):
    impl.root.conf.set(impl.C.SERVER_MAX_QUEUED_PER_SESSION.key, "2")
    srv = impl.srv.SQLServer(impl.root, port=0, workers=2).start()
    try:
        _, sa = _req(srv, "/session", "POST")
        sid = sa["sessionId"]
        ssa = srv._sessions[sid]
        ssa.lock.acquire()
        try:
            codes = []

            def post():
                try:
                    _sql(srv, "SELECT 1", sid)
                    codes.append(200)
                except urllib.error.HTTPError as e:
                    codes.append(e.code)

            backlog = [threading.Thread(target=post) for _ in range(2)]
            for t in backlog:
                t.start()
                time.sleep(0.25)         # deterministic queue depths
            with pytest.raises(urllib.error.HTTPError) as ei:
                _sql(srv, "SELECT 9", sid)
            assert ei.value.code == 429
            assert json.loads(ei.value.read())["limit"] == \
                "maxQueuedPerSession"
        finally:
            ssa.lock.release()
        for t in backlog:
            t.join(60)
        assert codes == [200, 200]       # admitted statements all ran
    finally:
        srv.stop()


def test_admission_retry_after_follows_the_shape(impl):
    """A rejection's Retry-After is the shape's own recent duration when
    the shape has history, else the global EWMA, times the statements
    running, never under 1 s."""
    impl.root.conf.set(impl.C.SERVER_MAX_CONCURRENT_STATEMENTS.key, "1")
    ac = impl.V.AdmissionController(impl.root.conf_obj)
    ac.admit(0, cost_key="scan")
    ac.release(30.0, cost_key="scan")
    ac.admit(0, cost_key="point")
    ac.release(0.05, cost_key="point")
    ac.admit(0)                          # holds the one slot
    waits = {}
    for key in ("scan", "point", "unseen"):
        with pytest.raises(impl.V.AdmissionRejected) as ei:
            ac.admit(0, cost_key=key)
        assert ei.value.limit == "maxConcurrentStatements"
        waits[key] = ei.value.retry_after_s
    ac.release()
    # global EWMA from 0.05 s: 0.8 * 0.05 + 0.2 * 30, then with 0.05
    assert waits == {"scan": 30.0, "point": 1.0,
                     "unseen": pytest.approx(0.8 * 6.04 + 0.2 * 0.05)}
    st = ac.stats()
    assert st["admitted"] == 3 and st["rejected"] == 3
    assert st["rejectedBy"] == {"maxConcurrentStatements": 3}
    assert st["active"] == 0 and st["costShapes"] == 2


def test_admission_stress_bounded_and_conserving(impl):
    """16 clients hammer 4 sessions through a 2-worker pool with tight
    caps: every response is 200 or a structured 429, every 200 is
    correct, no statement runs twice or vanishes, and stop() returns."""
    impl.root.conf.set(impl.C.SERVER_MAX_CONCURRENT_STATEMENTS.key, "4")
    impl.root.conf.set(impl.C.SERVER_MAX_QUEUED_PER_SESSION.key, "2")
    srv = impl.srv.SQLServer(impl.root, port=0, workers=2).start()
    try:
        sids = [_req(srv, "/session", "POST")[1]["sessionId"]
                for _ in range(4)]
        lock = threading.Lock()
        outcomes = []                    # (stmt_id, code, value)

        def client(cid):
            for k in range(6):
                stmt_id = f"stress-{cid}-{k}"
                try:
                    r = _sql(srv,
                             f"SELECT sum(id) + {cid} AS s "
                             f"FROM range(2000)",
                             sids[cid % 4], stmt_id)
                    with lock:
                        outcomes.append((stmt_id, 200, r["rows"][0][0]))
                except urllib.error.HTTPError as e:
                    body = json.loads(e.read())
                    with lock:
                        outcomes.append((stmt_id, e.code,
                                         body.get("limit")))
                except Exception as e:  # noqa: BLE001 — report, not die
                    # a client thread that dies on a non-HTTP error (a
                    # timeout, a reset connection) would leave only a
                    # short outcome count; recording it makes the codes
                    # assertion below name the error
                    with lock:
                        outcomes.append((stmt_id, type(e).__name__,
                                         repr(e)))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads), "client hung"
        assert len(outcomes) == 16 * 6
        codes = {code for _sid, code, _v in outcomes}
        assert codes <= {200, 429}, [o for o in outcomes
                                     if o[1] not in (200, 429)]
        assert 200 in codes
        ok = [(sid, v) for sid, code, v in outcomes if code == 200]
        expect = sum(range(2000))
        for stmt_id, v in ok:
            cid = int(stmt_id.split("-")[1])
            assert v == expect + cid, (stmt_id, v)
        rejected = [(sid, v) for sid, code, v in outcomes if code == 429]
        for _sid, limit in rejected:
            assert limit in ("maxConcurrentStatements",
                             "maxQueuedPerSession"), limit
        # conservation: exactly the admitted statements are registered,
        # each terminal exactly once; rejected ones left no trace
        ok_ids = {sid for sid, _v in ok}
        reg = {s.id: s.status for s in srv._statements.values()
               if s.id.startswith("stress-")}
        assert set(reg) == ok_ids
        assert all(st == "done" for st in reg.values())
        _, st = _req(srv, "/status")
        assert st["admission"]["rejected"] == len(rejected)
        assert st["admission"]["active"] == 0
    finally:
        t0 = time.monotonic()
        srv.stop()
        assert time.monotonic() - t0 < 10, "stop() must not hang"


def test_cancel_removes_queued_statement(impl):
    srv = impl.srv.SQLServer(impl.root, port=0, workers=2).start()
    try:
        _, sa = _req(srv, "/session", "POST")
        sid = sa["sessionId"]
        ssa = srv._sessions[sid]
        ssa.lock.acquire()               # first statement blocks running
        try:
            codes = {}

            def run(name, stmt_id):
                try:
                    _sql(srv, "SELECT 1", sid, stmt_id)
                    codes[name] = 200
                except urllib.error.HTTPError as e:
                    codes[name] = e.code

            t1 = threading.Thread(target=run, args=("head", "stmt-head"))
            t1.start()
            time.sleep(0.3)
            t2 = threading.Thread(target=run, args=("tail", "stmt-tail"))
            t2.start()
            time.sleep(0.3)              # tail is parked in the FIFO
            _, c = _req(srv, "/cancel", "POST",
                        json.dumps({"id": "stmt-tail"}))
            assert c["status"] == "cancelled"
            t2.join(10)
            assert codes["tail"] == 499
            with srv._reg_lock:
                assert all(item[0].id != "stmt-tail"
                           for item in ssa.queue)
        finally:
            ssa.lock.release()
        t1.join(60)
        assert codes["head"] == 200      # the head was untouched
        _, st = _req(srv, "/statement/stmt-tail")
        assert st["status"] == "cancelled"
        # the cancelled statement never ran: one statement executed
        assert st["statementId"] == "stmt-tail"
    finally:
        srv.stop()


def test_statement_deadline_cancels_long_run():
    """The port's deadline: a row-lane UDF sleeps past the deadline; the
    next operator's checkpoint aborts the statement with 499, its status
    is ``cancelled``, and the session still works."""
    root = TSession(TC.Conf({"spark.torch.device": "cpu"}))

    def slow(x):
        time.sleep(0.6)
        return x

    root.udf.register("slow_id", slow, TT.int64)
    srv = TS.SQLServer(root, port=0).start()
    try:
        _, s = _req(srv, "/session", "POST")
        sid = s["sessionId"]
        srv._sessions[sid].session.udf.register("slow_id", slow, TT.int64)
        _sql(srv, "SET spark.tpu.server.statementTimeout=0.3", sid)
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _sql(srv, "SELECT sum(y) AS s FROM (SELECT slow_id(id) AS y "
                 "FROM range(1)) q", sid, "stmt-deadline")
        assert ei.value.code == 499
        assert time.monotonic() - t0 < 45
        _, st = _req(srv, "/statement/stmt-deadline")
        assert st["status"] == "cancelled"
        _sql(srv, "SET spark.tpu.server.statementTimeout=0", sid)
        assert _sql(srv, "SELECT 5", sid)["rows"] == [[5]]
    finally:
        srv.stop()


def test_idle_session_ttl_eviction(impl):
    impl.root.conf.set(impl.C.SERVER_SESSION_TIMEOUT.key, "10")
    srv = impl.srv.SQLServer(impl.root, port=0).start()
    try:
        _, s1 = _req(srv, "/session", "POST")
        _, s2 = _req(srv, "/session", "POST")
        sid1, sid2 = s1["sessionId"], s2["sessionId"]
        _sql(srv, "SELECT 1", sid1)
        ss2 = srv._sessions[sid2]
        ss2.lock.acquire()
        try:
            th = threading.Thread(
                target=lambda: _sql(srv, "SELECT 1", sid2))
            th.start()
            time.sleep(0.3)
            n = srv._expire_idle_sessions(now=time.time() + 60)
            assert n == 1                # only the idle one went
            assert sid2 in srv._sessions
            assert sid1 not in srv._sessions
        finally:
            ss2.lock.release()
        th.join(60)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _sql(srv, "SELECT 1", sid1)
        assert ei.value.code == 404
        _, st = _req(srv, "/status")
        assert st["sessionsExpired"] == 1
        assert st["metrics"]["serving"]["sessions_expired"] == 1
    finally:
        srv.stop()


def test_status_exposes_serving_state(impl):
    srv = impl.srv.SQLServer(impl.root, port=0).start()
    try:
        _, s = _req(srv, "/session", "POST")
        sid = s["sessionId"]
        _sql(srv, "SELECT sum(id) AS s FROM range(128)", sid)
        _, st = _req(srv, "/status")
        assert st["sessionQueues"][sid] == {"queued": 0, "running": False}
        adm = st["admission"]
        assert adm["admitted"] >= 1 and adm["active"] == 0
        assert "rejectedBy" in adm and "avgStatementMs" in adm
        pc = st["planCache"]
        for k in ("hits", "misses", "evictions", "invalidations",
                  "entries", "bytes", "stage_entries"):
            assert k in pc
        serving = st["metrics"]["serving"]
        for k in ("plan_cache_hits", "plan_cache_misses",
                  "plan_cache_bytes", "admission_admitted",
                  "admission_rejected", "sessions_open"):
            assert k in serving
        for key in ("entries", "hits", "misses", "compile_ms",
                    "stages_fused", "ops_per_stage"):
            assert key in st["stageCache"], key
        if impl.name == "port":
            # the port's plan cache runs through the stage cache (the
            # reference's keeps its own executable beside it)
            assert st["stageCache"]["entries"] >= 1
            assert st["metrics"]["compile"]["stage_dispatches"] >= 1
    finally:
        srv.stop()


def test_plan_cache_disabled_by_conf(impl):
    impl.root.conf.set(impl.C.SERVER_PLAN_CACHE_ENABLED.key, "false")
    srv = impl.srv.SQLServer(impl.root, port=0).start()
    try:
        _, s = _req(srv, "/session", "POST")
        q = "SELECT id FROM range(8)"
        r1 = _sql(srv, q, s["sessionId"])
        r2 = _sql(srv, q, s["sessionId"])
        assert r1["cacheHit"] is False and r2["cacheHit"] is False
        _, st = _req(srv, "/status")
        assert "planCache" not in st
    finally:
        srv.stop()


def test_bearer_token_is_required(impl):
    srv = impl.srv.SQLServer(impl.root, port=0, token="s3cret").start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(srv, "/status")
        assert ei.value.code == 401
        code, _st = _req(srv, "/status",
                         headers={"Authorization": "Bearer s3cret"})
        assert code == 200
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# what the port leaves out refuses by name
# ---------------------------------------------------------------------------

def test_streams_and_pool_refuse_naming_their_slice(tmp_path):
    # standing queries are ported (the streaming slice): a spec without
    # source and sink paths is refused as the JAX package refuses it,
    # and an unknown stream id is a 404 (tests/test_torch_stream_server.py
    # drives the endpoints)
    root = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    srv = TS.SQLServer(root, port=0).start()
    try:
        for method, path, code in (("POST", "/stream", 400),
                                   ("GET", "/stream/x", 404),
                                   ("DELETE", "/stream/x", 404)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _req(srv, path, method, "{}" if method == "POST" else None)
            assert ei.value.code == code
            err = json.loads(ei.value.read())["error"]
            assert ("source.path and sink.path" in err) if code == 400 \
                else ("no such stream" in err)
        assert srv._admission.standing == 0
    finally:
        srv.stop()
    # the elastic pool is ported: the server starts its supervisor (no
    # demand, so no worker) and stops it with the server
    root.conf.set("spark.tpu.server.pool.enabled", "true")
    root.conf.set("spark.sql.warehouse.dir", str(tmp_path / "wh"))
    srv = TS.SQLServer(root, port=0).start()
    try:
        _code, st = _req(srv, "/status")
        assert st["poolActivity"]["live"] == 0
        assert srv._pool_supervisor is not None
    finally:
        srv.stop()
    assert srv._pool_supervisor is None


def test_server_without_a_card_raises(monkeypatch):
    """``python -m spark_tpu_torch.server`` runs on the card: without one
    its session refuses to start (no CPU fallback)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    active = TSession._active
    TSession._active = None
    try:
        with pytest.raises(RuntimeError, match="spark.torch.device"):
            TS.main(["--port", "0"])
    finally:
        TSession._active = active


def test_json_rows_equal_json_safe_of_collect():
    """The server's reply rows, decoded by column, are the values
    ``_json_safe`` gives on every value of ``collect()`` (the
    reference's reply), for every dtype the decode takes."""
    from test_torch_decode import KINDS, _pair
    for kind in KINDS:
        if kind == "binary":
            continue                   # bytes are not JSON values
        for nulls, row_mask in ((False, False), (True, True)):
            _ref, got = _pair(kind, KINDS.index(kind), nulls, row_mask)
            want = [[TS._json_safe(v) for v in r] for r in got.to_pylist()]
            have = TS._json_rows(got)
            assert json.dumps(have) == json.dumps(want), kind


def test_ddl_and_insert_over_http_evict_other_sessions(impl, tmp_path):
    """DDL and DML over HTTP, through the session: one client creates a
    catalog table and POSTs a query over it twice (the second a plan-cache
    hit whose file leaf was re-read), a second client's session INSERTs
    INTO the table, and the first client's third POST shows the new rows;
    the invalidation count rises.  Both servers, equal replies."""
    impl.root.conf.set("spark.sql.warehouse.dir", str(tmp_path / "wh"))
    srv = impl.srv.SQLServer(impl.root, port=0).start()
    try:
        _, s1 = _req(srv, "/session", "POST")
        _, s2 = _req(srv, "/session", "POST")
        a, b = s1["sessionId"], s2["sessionId"]
        _sql(srv, "CREATE TABLE ht USING parquet AS "
                  "SELECT id % 7 AS k, id AS v FROM range(70)", a)
        q = "SELECT k, sum(v) AS s, count(*) AS c FROM ht GROUP BY k " \
            "ORDER BY k"
        first, again = _sql(srv, q, a), _sql(srv, q, a)
        assert first["cacheHit"] is False and again["cacheHit"] is True
        assert again["rows"] == first["rows"] == [
            [k, sum(range(k, 70, 7)), 10] for k in range(7)]
        _, st = _req(srv, "/status")
        before = st["planCache"]["invalidations"]
        _sql(srv, "INSERT INTO ht SELECT 0, 1000 FROM range(3)", b)
        _, st = _req(srv, "/status")
        assert st["planCache"]["invalidations"] > before
        third = _sql(srv, q, a)
        assert third["rows"][0] == [0, sum(range(0, 70, 7)) + 3000, 13]
        assert third["rows"][1:] == first["rows"][1:]
        shown = _sql(srv, "SHOW TABLES", b)
        assert ["ht", "false"] in shown["rows"]
        _sql(srv, "DROP TABLE ht", b)
        assert _sql(srv, "SHOW TABLES", a)["rows"] == [] or \
            ["ht", "false"] not in _sql(srv, "SHOW TABLES", a)["rows"]
    finally:
        srv.stop()
