"""The port's cross-process lanes in REAL processes on the CPU, held
against the JAX package.

Two and three of the port's workers (``python -m spark_tpu_torch.testing
crossproc-worker``, ``spark.torch.device=cpu``) run the battery of the
JAX package's ``tests/shuffled_join_worker.py`` over the same tables
(each process a strided slice of the fact tables, ``dim`` replicated):
the parity battery in the range, hash and gather join modes, the same
battery forced through the spill path under a capped host ledger, and
the grace battery under a ledger capped below the reducers' drains.  The
JAX package's single-process session answers every text over the whole
tables, here in the test process.  Every process must return the same
rows, equal to that answer (integers and strings exact), and the
service's lane counters must show what the JAX package's worker asserts
for the same battery.  Last, a worker killed while its peer waits at an
exchange barrier makes the peer raise the structured
``ExchangeFetchFailed`` within twice the exchange timeout.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from spark_tpu_torch.testing import (
    CROSSPROC_GRACE_QUERIES, CROSSPROC_JOIN_COUNTERS, CROSSPROC_MODES,
    CROSSPROC_QUERIES, crossproc_tables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the exchange timeout handed to the workers, seconds
TIMEOUT_S = 30.0


def _start(root, n, mode, timeout_s=TIMEOUT_S):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for pid in range(n):
        # output to files: a worker that fills an unread pipe would block
        # at its next barrier
        log = open(os.path.join(root, f"log-p{pid}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "spark_tpu_torch.testing",
             "crossproc-worker", str(pid), str(n), str(root), mode,
             str(timeout_s), "cpu"],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO), log))
    return procs


def _finish(procs, deadline_s=240.0):
    t_end = time.monotonic() + deadline_s
    try:
        for p, _log in procs:
            p.wait(timeout=max(1.0, t_end - time.monotonic()))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def _log(root, pid):
    with open(os.path.join(root, f"log-p{pid}.txt")) as f:
        return f.read()


def _results(root, n, mode, spark, texts):
    procs = _start(root, n, mode)
    for sql in texts:             # the oracle runs while the workers do
        _oracle(spark, sql)
    _finish(procs)
    out = []
    for pid, (p, _log_f) in enumerate(procs):
        assert p.returncode == 0, f"worker {pid}:\n{_log(root, pid)}"
        with open(os.path.join(root, f"result-p{pid}.json")) as f:
            out.append(json.load(f))
    return out


_ORACLE = {}
_BATTERY_TEXTS = [sql for _n, sql, _w in CROSSPROC_QUERIES]


def _oracle(spark, sql):
    """The JAX package's single-process answer over the whole tables."""
    if sql not in _ORACLE:
        s = spark.newSession()
        for name, cols in crossproc_tables().items():
            s.createDataFrame(cols).createOrReplaceTempView(name)
        _ORACLE[sql] = [tuple(_py(v) for v in r)
                        for r in s.sql(sql).collect()]
    return _ORACLE[sql]


def _py(v):
    return v.item() if hasattr(v, "item") else v


def _rows(run):
    return [tuple(r) for r in run["rows"]]


def _check_battery(spark, results, n):
    """Every process's rows equal each other's and the oracle's, and each
    join mode took its lane and no other."""
    for name, sql, want in CROSSPROC_QUERIES:
        exp = _oracle(spark, sql)
        for m, _smj, _sh in CROSSPROC_MODES:
            for r in results:
                run = r["queries"][name][m]
                assert _rows(run) == exp, (name, m, r["pid"])
                lane = want.get(m)
                if lane is not None:
                    assert run["delta"].get(lane, 0) > 0, (name, m, run)
                for c in CROSSPROC_JOIN_COUNTERS:
                    if c != lane:
                        assert c not in run["delta"], (name, m, run)
    for r in results:
        c, g = r["counters"], r["gauges"]
        # the JAX package's parity assertions for the same battery
        assert (c["range_merge_joins"], c["shuffled_joins"],
                c["fast_path_aggs"]) == (5, 5, 6), c
        assert c["partitions_coalesced"] > 0, c
        assert c["spans_split"] > 0, c
        assert c["sample_bytes"] > 0, c
        assert g["bytes_produced_raw"] >= g["bytes_shipped_raw"] > 0, g
        assert g["rows_produced"] >= g["rows_shipped"] > 0, g
        assert g["partition_bytes_max"] >= g["partition_bytes_median"], g
        assert g["range_cutpoints"] > 0, g
        assert g["dict_columns_encoded"] > 0, g
        assert g["dict_bytes_saved"] > 0, g
        assert g["codes_remapped"] > 0, g


@pytest.mark.parametrize("n", [2, 3])
def test_parity_battery(spark, tmp_path, n):
    _check_battery(spark, _results(tmp_path, n, "parity", spark,
                                   _BATTERY_TEXTS), n)


def test_spill_battery_two_processes(spark, tmp_path):
    """The battery with a 1 KiB spill threshold and a 32 MiB ledger:
    every join exchange stages its map output and fetched blocks on disk,
    the answers do not move, and the ledger's peak stays in budget."""
    results = _results(tmp_path, 2, "spill", spark, _BATTERY_TEXTS)
    _check_battery(spark, results, 2)
    for r in results:
        c, g = r["counters"], r["gauges"]
        assert c["spill_bytes"] > 0 and c["spill_events"] > 0, c
        assert 0 < g["peak_host_bytes"] <= g["host_budget_bytes"], g


def test_grace_battery_two_processes(spark, tmp_path):
    """A 7 KiB ledger below the reducers' drains: both join lanes grace-
    degrade and still equal the oracle; a huge advisory target narrows
    the reducer set (elastic); one grace bucket forces a salted re-split.
    The JAX package's worker asserts the same counters at two
    processes."""
    results = _results(tmp_path, 2, "grace", spark,
                       [sql for _n, sql in CROSSPROC_GRACE_QUERIES])
    lanes = {"range": "range_merge_joins", "hash": "shuffled_joins"}
    first_sql = CROSSPROC_GRACE_QUERIES[0][1]
    for r in results:
        q = r["queries"]
        for name, sql in CROSSPROC_GRACE_QUERIES:
            for m, lane in lanes.items():
                assert _rows(q[name][m]) == _oracle(spark, sql), (name, m)
                assert q[name][m]["delta"].get(lane, 0) > 0, (name, m)
        for m, lane in lanes.items():
            assert _rows(q["elastic"][m]) == _oracle(spark, first_sql), m
            assert q["elastic"][m]["delta"].get(lane, 0) > 0, m
        for tgt, run in q["resplit"].items():
            assert _rows(run) == _oracle(spark, first_sql), tgt
        c, g = r["counters"], r["gauges"]
        assert c["reducers_elastic"] > 0, c
        assert 0 < c["reducers_observed"] < c["reducers_planned"], c
        assert c["grace_buckets_used"] > 0, c
        assert c["grace_spill_bytes"] > 0, c
        assert c["grace_salted_resplits"] > 0, c
        assert 0 < g["peak_host_bytes"] <= g["host_budget_bytes"], g


def test_killed_peer_fails_structured_within_bound(tmp_path):
    """Process 1 stops before committing its first join exchange and is
    killed there; process 0, waiting at that exchange's barrier, sees
    its heartbeat go stale and raises ``ExchangeFetchFailed`` naming
    host-1 — within 2 x the exchange timeout, never hanging."""
    timeout_s = 20.0
    procs = _start(tmp_path, 2, "kill", timeout_s)
    try:
        t_end = time.monotonic() + 120.0
        marker = os.path.join(tmp_path, "p1-at-barrier")
        while not os.path.exists(marker):
            assert time.monotonic() < t_end, _log(tmp_path, 1)
            assert procs[1][0].poll() is None, _log(tmp_path, 1)
            time.sleep(0.05)
        procs[1][0].kill()
        procs[0][0].wait(timeout=2 * timeout_s + 30)
    finally:
        _finish(procs, deadline_s=1.0)
    assert procs[0][0].returncode == 0, _log(tmp_path, 0)
    with open(os.path.join(tmp_path, "result-p0.json")) as f:
        r = json.load(f)
    assert r["outcome"] == "ExchangeFetchFailed", r
    assert r["lost_hosts"] == ["host-1"], r
    assert r["elapsed_s"] < 2 * timeout_s, r
