"""The port's cross-process device tier in REAL processes on the CPU,
held against the JAX package.

Two (and, marked slow as in the JAX package, three) workers of
``python -m spark_tpu_torch.testing crossproc-worker <pid> <n> <dir>
ici`` run the battery of the JAX package's ``tests/shuffled_join_worker.py``
``ici`` mode: the device tier armed (every pid in one domain, no byte
floor), the parity battery in the range, hash and gather join modes
(its string sides stay on the host tier), then the dictionary-free
texts on the range and hash lanes, where every join side goes through
the senders' arenas (shared-memory files under the shuffle root on the
CPU) and each receiver pulls it with K2's plain version.  Beside them
the JAX package's own two-process ``ici`` run.  Every answer must equal
the JAX package's single-process answer, which its two-process run is
held to as well.

The two runs differ in the counters, by design: the JAX package's CPU
world is one process per JAX runtime, so its device collective cannot
span the domain and every attempt folds back onto the host tier
(``dcn_fallback_exchanges`` > 0, ``ici_exchanges`` 0); the port's
processes share a file system, so its tier runs (``ici_exchanges`` and
``ici_pulls`` > 0, no fold-back).

Last, the tier's two fault kinds (``testing.ici_scenarios``): process 1
refused the tier on its first join exchange (its spans fold back, both
answer, the fold-back counted in process 1 only), and process 1 dying at
the tier's copy point (process 0 recovers in an epoch, ledger at 0 B).
"""

import json
import os
import subprocess
import sys
import time

import pytest

from spark_tpu_torch.testing import (
    CROSSPROC_MODES, CROSSPROC_QUERIES, ICI_QUERIES, RECOVERY_SQL,
    check_scenario, crossproc_tables, ici_scenarios, recovery_oracle,
    recovery_tables, run_scenario)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

#: the exchange timeout handed to the workers, seconds
TIMEOUT_S = 30.0


def _start(root, n):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("SPARK_TPU_FAULT_PLAN", None)
    procs = []
    for pid in range(n):
        log = open(os.path.join(root, f"log-p{pid}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "spark_tpu_torch.testing",
             "crossproc-worker", str(pid), str(n), str(root), "ici",
             str(TIMEOUT_S), "cpu"],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO), log))
    return procs


def _start_reference(root, n):
    """The JAX package's own ``ici`` workers (its tests/test_ici.py run)."""
    os.makedirs(root, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("SPARK_TPU_FAULT_PLAN", None)
    procs = []
    for pid in range(n):
        log = open(os.path.join(root, f"log-p{pid}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE, "shuffled_join_worker.py"),
             str(pid), str(n), str(root), "ici", str(TIMEOUT_S)],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    return procs


def _finish(procs, deadline_s=300.0):
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


def _oracle(spark, sql, cache={}):
    """The JAX package's single-process answer over the whole tables."""
    if sql not in cache:
        s = spark.newSession()
        for name, cols in crossproc_tables().items():
            s.createDataFrame(cols).createOrReplaceTempView(name)
        cache[sql] = [[v.item() if hasattr(v, "item") else v for v in r]
                      for r in s.sql(sql).collect()]
    return cache[sql]


def _battery(spark, tmp_path, n, with_reference):
    root = tmp_path / "port"
    root.mkdir()
    procs = _start(root, n)
    ref_root = tmp_path / "reference"
    ref = _start_reference(ref_root, n) if with_reference else []
    texts = [sql for _n, sql, _w in CROSSPROC_QUERIES] \
        + [sql for _n, sql in ICI_QUERIES]
    for sql in texts:            # the oracle runs while the workers do
        _oracle(spark, sql)
    _finish(procs + ref)
    results = []
    for pid, (p, _log_f) in enumerate(procs):
        assert p.returncode == 0, f"worker {pid}:\n{_log(root, pid)}"
        with open(os.path.join(root, f"result-p{pid}.json")) as f:
            results.append(json.load(f))
    for name, sql, want in CROSSPROC_QUERIES:
        for m, _smj, _sh in CROSSPROC_MODES:
            for r in results:
                run = r["queries"][name][m]
                assert run["rows"] == _oracle(spark, sql), (name, m)
                lane = want.get(m)
                if lane is not None:
                    assert run["delta"].get(lane, 0) > 0, (name, m, run)
                if name == "string-key-agg":
                    # dictionary-coded join sides stay on the host tier
                    assert "ici_exchanges" not in run["delta"], (name, m)
                    assert "dcn_fallback_exchanges" not in run["delta"]
    lanes = {"range": "range_merge_joins", "hash": "shuffled_joins"}
    for name, sql in ICI_QUERIES:
        for m, lane in lanes.items():
            for r in results:
                run = r["queries"][name][m]
                d = run["delta"]
                assert run["rows"] == _oracle(spark, sql), (name, m)
                assert d.get(lane, 0) > 0, (name, m, d)
                # both join sides of every process took the device tier
                assert d.get("ici_exchanges", 0) == 2, (name, m, d)
                assert "dcn_fallback_exchanges" not in d, (name, m, d)
            assert sum(r["queries"][name][m]["delta"].get("ici_pulls", 0)
                       for r in results) > 0, (name, m)
    for r in results:
        c = r["counters"]
        assert c["tier_split_peers"] == n - 1, c
        assert c["dcn_fallback_exchanges"] == 0, c
        assert c["ici_exchanges"] > 0 and c["ici_bytes_moved"] > 0, c
        assert (c["range_merge_joins"], c["shuffled_joins"],
                c["fast_path_aggs"]) == (8, 8, 6), c
    for pid, (p, _log_f) in enumerate(ref):
        out = _log(ref_root, pid)
        assert p.returncode == 0, f"reference worker {pid}:\n{out}"
        # the JAX package's run: every answer equal to the same oracle
        # (its worker asserts that), every device attempt folded back
        assert f"[p{pid}] ALL-OK" in out, out
        assert out.count(f"[p{pid}] ICI-PARITY-OK") == len(ICI_QUERIES)
        line = [ln for ln in out.splitlines()
                if f"[p{pid}] ICI-FALLBACK-OK" in ln][0]
        assert int(line.split("fallbacks=")[1].split()[0]) > 0, line
        assert f"peers={n - 1}" in line, line


def test_ici_battery_two_processes(spark, tmp_path):
    _battery(spark, tmp_path, 2, with_reference=True)


@pytest.mark.slow
def test_ici_battery_three_processes(spark, tmp_path):
    _battery(spark, tmp_path, 3, with_reference=False)


def _jax_recovery_answer(spark):
    s = spark.newSession()
    for name, cols in recovery_tables("recover").items():
        s.createDataFrame(cols).createOrReplaceTempView(name)
    return [[v.item() if hasattr(v, "item") else v for v in r]
            for r in s.sql(RECOVERY_SQL).collect()]


@pytest.mark.parametrize("name", [sc["name"] for sc in ici_scenarios()])
def test_ici_fault_scenario(spark, tmp_path, name):
    sc = [s for s in ici_scenarios() if s["name"] == name][0]
    root = str(tmp_path / "run")
    results, elapsed = run_scenario(sc, root, "cpu")
    bad = check_scenario(sc, results, elapsed)
    assert not bad, (bad, {p: out[-1500:] for p, (_rc, out)
                           in results.items()})
    exp = _jax_recovery_answer(spark)
    assert exp == recovery_oracle("recover")
    res = {}
    for pid, want in sc["expect"].items():
        if want != "OK":
            continue
        with open(os.path.join(root, f"result-p{pid}.json")) as f:
            res[pid] = json.load(f)
        assert res[pid]["rows"] == exp, (name, pid)
        assert res[pid]["ledger_used"] == 0, res[pid]
    if name == "ici-unavailable-one-sided":
        # process 1's left spans folded back; its right side and both of
        # process 0's took the tier, and process 0 pulled what process 1
        # still shipped there
        d0, d1 = res[0]["delta"], res[1]["delta"]
        assert d1.get("dcn_fallback_exchanges") == 1, d1
        assert "dcn_fallback_exchanges" not in d0, d0
        assert d0.get("ici_exchanges") == 2 and d1.get("ici_exchanges") == 1
        assert "dying" not in results[1][1]
    else:
        assert "dying mid device copy in 'xq000001-jL'" in results[1][1]
        c = res[0]["counters"]
        assert c["stage_retries"] == 1, c
        assert res[0]["gauges"]["epoch"] == 1
