"""The port's elastic worker pool (``spark_tpu_torch/serving/pool.py``),
admission's demand signal and host-headroom check, and the server's
pool hooks and re-admit, beside the JAX package's ``tests/test_pool.py``.

The pure parts are held EXACTLY equal to the JAX package on identical
inputs: ``decide_target`` over a grid of demand snapshots, live counts,
clocks and hysteresis streaks; ``PoolPolicy.from_conf``; the demand
signal's consuming rejection delta; the headroom check with its grace
factor.  ``spawn_gang`` terminates and waits every started sibling when
an exec fails.  Then real processes on the CPU: a supervisor spawns
worker processes (``python -m spark_tpu_torch.serving.pool --worker``)
that serve a spooled SELECT and are reaped through hysteresis with their
leases handed over; the ``spawn-fail`` and ``reap`` chaos scenarios; a
``SQLServer`` with the pool on offloads a SELECT over a catalog table
and answers what the local run answers; and the server re-admits a
statement once after ``ExchangeFetchFailed`` while a second failure
surfaces.
"""

import itertools
import json
import os
import time
import urllib.error
import urllib.request

import pytest

import spark_tpu.config as RC
import spark_tpu.memory as RM
import spark_tpu.serving.admission as RA
import spark_tpu.serving.pool as RP
import spark_tpu_torch.config as TC
import spark_tpu_torch.memory as TM
import spark_tpu_torch.serving.admission as TA
import spark_tpu_torch.serving.pool as TP
from spark_tpu_torch.parallel.blockserver import BlockStore
from spark_tpu_torch.testing import (
    POOL_SQL, POOL_TABLE_ROWS, chaos_scenario, check_scenario, run_scenario)


# ---------------------------------------------------------------------------
# the pure policy, equal to the JAX package's
# ---------------------------------------------------------------------------

_SIGNALS = [dict(), dict(queued=5), dict(running=1, queued=2,
                                        rejected_recent=3),
            dict(running=9), dict(queued=1, host_free=100),
            dict(queued=4, host_free=10 ** 9), dict(running=2, host_free=0)]
_POLICIES = [dict(), dict(min_workers=1, max_workers=2,
                          statements_per_worker=3, scale_down_rounds=2,
                          cooldown_s=0.0),
             dict(min_headroom_bytes=1000, cooldown_s=5.0)]


@pytest.mark.parametrize("pol", range(len(_POLICIES)))
def test_decide_target_matches_reference_on_a_grid(pol):
    n = 0
    for sig, live, (now, last), low in itertools.product(
            _SIGNALS, [0, 1, 2, 4], [(100.0, 0.0), (100.0, 99.0),
                                     (100.0, 98.5)], [0, 1, 2, 5]):
        got = TP.decide_target(TP.PoolPolicy(**_POLICIES[pol]),
                               TA.DemandSignal(**sig), live, now, last, low)
        want = RP.decide_target(RP.PoolPolicy(**_POLICIES[pol]),
                                RA.DemandSignal(**sig), live, now, last,
                                low)
        assert tuple(got) == tuple(want), (sig, live, now, last, low)
        n += 1
    assert n == len(_SIGNALS) * 4 * 3 * 4


def test_decide_target_hysteresis_walk_matches_reference():
    """Threading ``low_rounds`` and ``last_scale_ts`` through a sequence
    of snapshots: every decision equal, and the pool scales up eagerly,
    down only after the streak."""
    seq = [dict(queued=6)] * 2 + [dict()] * 5 + [dict(queued=1)] \
        + [dict()] * 4
    out = []
    for P, A in ((TP, TA), (RP, RA)):
        pol = P.PoolPolicy(scale_down_rounds=3, cooldown_s=1.0)
        live, last, low, now, ds = 0, -1e9, 0, 0.0, []
        for sig in seq:
            now += 0.75
            d = P.decide_target(pol, A.DemandSignal(**sig), live, now,
                                last, low)
            low = d.low_rounds
            if d.action != "hold":
                live, last = d.target, now
            ds.append(tuple(d))
        out.append(ds)
    assert out[0] == out[1]
    assert out[0][0][1] == "up" and "down" in [d[1] for d in out[0]]


def test_policy_from_conf_matches_reference():
    pairs = {"spark.tpu.server.pool.minWorkers": "1",
             "spark.tpu.server.pool.maxWorkers": "3",
             "spark.tpu.server.pool.statementsPerWorker": "5",
             "spark.tpu.server.pool.scaleDownRounds": "4",
             "spark.tpu.server.pool.cooldownSeconds": "0.5",
             "spark.tpu.server.pool.minHostHeadroomBytes": "77"}
    assert tuple(TP.PoolPolicy.from_conf(TC.Conf(pairs))) \
        == tuple(RP.PoolPolicy.from_conf(RC.Conf(pairs)))
    assert tuple(TP.PoolPolicy.from_conf(TC.Conf())) \
        == tuple(RP.PoolPolicy.from_conf(RC.Conf()))


def test_demand_signal_snapshot_and_rejection_delta():
    """Running + queued + the rejections since the previous snapshot,
    equal in both packages; ``stats`` peeks without consuming."""
    out = []
    for C, A in ((TC, TA), (RC, RA)):
        conf = C.Conf({"spark.tpu.server.maxConcurrentStatements": "1"})
        depth = [0]
        ac = A.AdmissionController(conf, queued_supplier=lambda: depth[0])
        ac.admit(0)
        depth[0] = 2
        for _ in range(3):
            with pytest.raises(A.AdmissionRejected):
                ac.admit(0)
        sig, sig2 = ac.demand_signal(), ac.demand_signal()
        with pytest.raises(A.AdmissionRejected):
            ac.admit(0)
        peek = ac.stats()["demand"]["rejectedSinceSignal"]
        out.append((tuple(sig), tuple(sig2), peek,
                    tuple(ac.demand_signal())))
    assert out[0] == out[1]
    sig = out[0][0]
    assert sig[:3] == (1, 2, 3) and out[0][2] == 1


@pytest.mark.parametrize("grace", [0, 1])
def test_host_headroom_check_matches_reference(grace):
    """The headroom floor reads the session's host ledger; once a session
    has degraded into grace joins the floor doubles."""
    out = []
    for C, A, M in ((TC, TA, TM), (RC, RA, RM)):
        conf = C.Conf({"spark.tpu.server.admission.minHostHeadroomBytes":
                       "1000"})
        ledger = M.HostMemoryLedger(budget=2500)
        ac = A.AdmissionController(conf, lambda: ledger,
                                   grace_supplier=lambda: grace)
        verdicts = []
        for used in (0, 1000, 1400, 1600, 2000):
            ledger.release("t")
            if used:
                ledger.reserve("t", used)
            try:
                ac.admit(0)
                ac.release(0.01)
                verdicts.append("ok")
            except A.AdmissionRejected as e:
                verdicts.append((e.limit, e.observed, e.cap))
        out.append((verdicts, ac.demand_signal().host_free,
                    ac.stats()["rejectedBy"]))
    assert out[0] == out[1]
    assert ("hostMemoryHeadroom", 500, 1000 * (1 + grace)) in out[0][0]


# ---------------------------------------------------------------------------
# spawn_gang: all or none
# ---------------------------------------------------------------------------

class _FakeProc:
    def __init__(self):
        self.terminated = False
        self.waited = False

    def terminate(self):
        self.terminated = True

    def wait(self, timeout=None):
        self.waited = True


def test_spawn_gang_kills_and_waits_started_siblings_on_exec_error():
    started = []

    def popen(cmd, **kw):
        if len(started) == 2:
            raise OSError(8, "Exec format error")
        pr = _FakeProc()
        started.append(pr)
        return pr

    with pytest.raises(OSError):
        TP.spawn_gang([["a"], ["b"], ["c"], ["d"]], popen=popen)
    assert len(started) == 2
    assert all(pr.terminated and pr.waited for pr in started)


def test_spawn_gang_returns_all_on_success():
    procs = TP.spawn_gang([["a"], ["b"]],
                          popen=lambda cmd, **kw: _FakeProc())
    assert len(procs) == 2 and not any(p.terminated for p in procs)


def test_pool_execute_with_no_workers_falls_back(tmp_path):
    sup = TP.WorkerPoolSupervisor(str(tmp_path / "pool"), TC.Conf(),
                                  lambda: TA.DemandSignal())
    assert sup.execute("SELECT 1") is None
    assert sup.counters["offload_fallbacks"] == 1


#: a stand-in pool worker: claims spooled statements as the real one does,
#: answers each after 3 s, and reads its reap marker between statements
_SLOW_WORKER = r"""
import json, os, sys, time
root, wid = sys.argv[1], sys.argv[2]
spool = os.path.join(root, "spool")
while not os.path.exists(os.path.join(root, "reap", wid)):
    for n in sorted(os.listdir(spool)):
        if not n.endswith(".json") or ".claim" in n \
                or n.endswith(".result.json"):
            continue
        src = os.path.join(spool, n)
        os.rename(src, src + ".claim" + wid)
        time.sleep(3.0)
        res = src[:-len(".json")] + ".result.json"
        with open(res + ".tmp", "w") as f:
            json.dump({"ok": True, "result": {"rows": [[1]]}}, f)
        os.replace(res + ".tmp", res)
        os.remove(src + ".claim" + wid)
    time.sleep(0.02)
"""


def _reap_mid_statement(P, conf, root):
    """A worker is reaped while it runs a statement it has claimed:
    what the waiting client gets back, and how the worker ended."""
    import subprocess
    import sys
    import threading
    for sub in ("spool", "reap"):
        os.makedirs(os.path.join(root, sub))
    sup = P.WorkerPoolSupervisor(root, conf, lambda: None)
    pr = subprocess.Popen([sys.executable, "-c", _SLOW_WORKER, root, "3"])
    sup._workers[3] = pr
    got = []
    client = threading.Thread(
        target=lambda: got.append(sup.execute("SELECT 1", timeout_s=8.0)))
    client.start()
    spool = os.path.join(root, "spool")
    deadline = time.monotonic() + 30
    while not any(n.endswith(".claim3") for n in os.listdir(spool)) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    sup._reap(3)
    client.join()
    pr.wait(timeout=10)
    return (got[0], pr.returncode, sup.counters["offload_fallbacks"],
            sup.stats().get("reapClaimWaits", 0))


def test_reap_lets_a_claimed_statement_finish(tmp_path):
    """A reference fault repaired in the port (ROADMAP §3): the JAX
    package's ``_reap`` ends a worker two seconds after its marker, in
    the middle of a statement it claimed, so the client waits out the
    offload timeout and falls back; the port's reap waits for the
    claimed statement, the worker answers and exits by its marker."""
    pairs = {"spark.tpu.server.pool.pollSeconds": "0.1"}
    ref = _reap_mid_statement(RP, RC.Conf(pairs), str(tmp_path / "ref"))
    port = _reap_mid_statement(TP, TC.Conf(pairs), str(tmp_path / "port"))
    assert ref[0] is None and ref[1] != 0 and ref[2] == 1, ref
    assert port == ({"rows": [[1]]}, 0, 0, 1), port


# ---------------------------------------------------------------------------
# real worker processes on the CPU
# ---------------------------------------------------------------------------

def _cpu_session(tmp_path, **conf):
    from spark_tpu_torch.sql.session import SparkSession
    wh = str(tmp_path / "wh")
    pairs = {"spark.torch.device": "cpu", "spark.sql.warehouse.dir": wh}
    pairs.update(conf)
    return SparkSession(TC.Conf(pairs)), wh


def test_pool_spawns_serves_and_reaps_real_workers(tmp_path):
    """A burst spawns REAL workers; one serves a spooled SELECT over the
    shared warehouse (marked pooled, its readiness timed); idle demand
    then reaps both through hysteresis, each lease handed over."""
    s, wh = _cpu_session(
        tmp_path, **{"spark.tpu.server.pool.maxWorkers": "2",
                     "spark.tpu.server.pool.statementsPerWorker": "2",
                     "spark.tpu.server.pool.scaleDownRounds": "2",
                     "spark.tpu.server.pool.cooldownSeconds": "0.0",
                     "spark.tpu.server.pool.pollSeconds": "0.1"})
    s.createDataFrame([tuple(r) for r in POOL_TABLE_ROWS],
                      ["id", "name", "v"]).write.saveAsTable("pool_t")
    demand = [TA.DemandSignal()]
    sup = TP.WorkerPoolSupervisor(str(tmp_path / "pool"), s.conf_obj,
                                  lambda: demand[0], warehouse=wh,
                                  blockstore_root=str(tmp_path / "blocks"))
    try:
        sup.start(reconcile=False)
        assert sup.tick().action == "hold" and sup.live == 0
        demand[0] = TA.DemandSignal(queued=3)
        d = sup.tick()
        assert d.action == "up" and d.target == 2 and sup.live == 2
        res, deadline = None, time.monotonic() + 60
        while res is None and time.monotonic() < deadline:
            res = sup.execute(POOL_SQL, timeout_s=10.0)
        assert res is not None, sup.counters
        assert res["rows"] == POOL_TABLE_ROWS == [
            list(r) for r in s.sql(POOL_SQL).collect()]
        assert res["pooled"] is True and "poolWorker" in res
        assert sup.counters["pool_statements_served"] == 1
        assert sup.stats()["readyMs"]                 # spawn-to-ready
        demand[0] = TA.DemandSignal()
        deadline = time.monotonic() + 30
        while sup.live > 0 and time.monotonic() < deadline:
            sup.tick()
            time.sleep(0.02)
        assert sup.live == 0 and sup.counters["workers_reaped"] == 2
        store = BlockStore(str(tmp_path / "blocks"), s.conf_obj)
        for wid in (0, 1):
            assert store.lease_fresh(f"pool-{wid}", time.time()), wid
        assert sup.stats()["lastDecision"]["action"] == "down"
    finally:
        sup.stop()


@pytest.mark.parametrize("name", ["pool-spawn-exec-error",
                                  "pool-reap-mid-fetch",
                                  "pool-scaleup-midstream"])
def test_pool_chaos_scenario(tmp_path, name):
    """``spawn-fail``: the second exec raises, the pool settles below its
    target and the one worker still serves.  ``reap``: a worker reaped
    mid-fetch hands its lease over, and the survivor adopts its sealed
    output with zero re-execution, the reaped lease fresh through the
    heir.  ``scaleup``: the pool grows under a standing windowed
    aggregate and the stream's sink stays byte-identical."""
    sc = chaos_scenario(name)
    results, elapsed = run_scenario(sc, str(tmp_path / "run"), "cpu")
    bad = check_scenario(sc, results, elapsed)
    assert not bad, (bad, {p: out[-1500:] for p, (_rc, out)
                           in results.items()})
    out0 = results[0][1]
    if name == "pool-reap-mid-fetch":
        assert "retries=0" in out0 and "heir-lease=fresh" in out0, out0
        assert "reaped at xq000001-gather" in results[1][1]
        assert f"lease->{TP.SUPERVISOR_OWNER}" in results[1][1]
    elif name == "pool-scaleup-midstream":
        # 4 sink files equal to the no-pool lifetime's, a worker spawned,
        # served one statement and was reaped
        assert "OK 4 spawned=1 reaped=1 served=1" in out0, out0
    else:
        assert "spawn_failures=" in out0 and "served=1" in out0, out0


def _post(srv, body):
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}/sql",
                                 data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_server_offloads_a_select_to_the_pool(tmp_path):
    """A ``SQLServer`` with the pool on (one worker kept by
    ``minWorkers``): a SELECT over a catalog table is served by a worker
    and answers what the server's own session answers."""
    from spark_tpu_torch.server import SQLServer
    s, _wh = _cpu_session(
        tmp_path, **{"spark.tpu.server.pool.enabled": "true",
                     "spark.tpu.server.pool.minWorkers": "1",
                     "spark.tpu.server.pool.pollSeconds": "0.1"})
    s.createDataFrame([tuple(r) for r in POOL_TABLE_ROWS],
                      ["id", "name", "v"]).write.saveAsTable("pool_t")
    local = [list(r) for r in s.sql(POOL_SQL).collect()]
    srv = SQLServer(s, port=0).start()
    try:
        deadline = time.monotonic() + 60
        while not srv._pool_supervisor.stats()["readyMs"]:
            assert time.monotonic() < deadline, srv._pool_supervisor.stats()
            time.sleep(0.1)
        out = _post(srv, POOL_SQL)
        assert out.get("pooled") is True, out
        assert out["rows"] == local == POOL_TABLE_ROWS
        assert out["columns"] == ["id", "name", "v"]
        st = srv._status()
        assert st["poolActivity"]["counters"]["pool_statements_served"] == 1
        assert st["metrics"]["pool"]["pool_statements_served"] == 1
    finally:
        srv.stop()


def test_server_readmits_once_after_a_lost_exchange(tmp_path):
    """``ExchangeFetchFailed`` from a statement is re-admitted ONCE,
    transparently (``statement_readmits``); a second failure surfaces to
    the client."""
    from spark_tpu_torch.parallel.hostshuffle import ExchangeFetchFailed
    from spark_tpu_torch.server import SQLServer
    s, _wh = _cpu_session(tmp_path)
    srv = SQLServer(s, port=0).start()
    real = srv._run_admitted
    fails = [1]

    def flaky(*a, **kw):
        if fails[0]:
            fails[0] -= 1
            raise ExchangeFetchFailed("xq000001-jL", ["host-1"],
                                      ["s0001-r0000.part"])
        return real(*a, **kw)
    srv._run_admitted = flaky
    try:
        out = _post(srv, "SELECT 1 + 1 AS x")
        assert out["rows"] == [[2]]
        assert srv._statement_readmits == 1
        fails[0] = 2
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, "SELECT 2 AS y")
        body = json.loads(ei.value.read())
        assert "ExchangeFetchFailed" in body["error"]
        assert "host-1" in body["error"]
        assert srv._statement_readmits == 2
        assert s.metricsSystem.snapshots()["serving"][
            "statement_readmits"] == 2
    finally:
        srv.stop()


@pytest.mark.parametrize("entry", ["pool", "recovery"])
def test_workers_without_a_card_raise(tmp_path, monkeypatch, entry):
    """A pool or recovery worker told to run on the card raises when
    there is none; it never carries on on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "pool":
        (tmp_path / "config.json").write_text(json.dumps(
            {"conf": {"spark.torch.device": "cuda"}}))
        with pytest.raises(RuntimeError, match="spark.torch.device"):
            TP.worker_main(str(tmp_path), 0)
        assert not os.path.exists(tmp_path / "ready" / "0")
    else:
        from spark_tpu_torch.testing import recovery_worker
        with pytest.raises(RuntimeError, match="no CUDA device"):
            recovery_worker(["0", "2", str(tmp_path), "recover", "5",
                             "cuda"])
