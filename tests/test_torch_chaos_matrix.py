"""The port's chaos matrix against the JAX package's
``tests/chaos_matrix.py``, on the CPU.

First the gate: every fault kind ``parallel.faults`` can inject has a
scenario, every exchange and streaming phase is covered, every row is
runnable, and every row of the JAX package's matrix has its counterpart
here with the same phase, process count, timeout, plans, verdicts and
tier.  Then the rows this port added last (the adaptive demotion's kill,
the corrupted and truncated blocks, disk full under the spill and grace
paths, and the device tier refused or killed in the crossproc worker),
each in real processes; then the worker tests of the JAX package's
``tests/test_faults.py`` (a join side's block dropped or corrupted, the
range lane's sample manifest dropped or corrupted, a spill on a full
disk, the adaptive stats round corrupted or dropped, a peer killed mid
demotion), each with its own plans and assertions.  Every process that
answers must return the JAX package's single-process answer over the
whole tables.  Last, the runner (``python -m spark_tpu_torch.testing
chaos``): a tier-1 run on the CPU, its seeded order, and its refusal to
run on ``cuda`` without a card.
"""

import json
import os
import subprocess
import sys

import pytest

from spark_tpu_torch.parallel.faults import FaultPlan as P
from spark_tpu_torch.testing import (
    ADAPTIVE_DEMOTE_SQL, CHAOS_PHASES, CROSSPROC_QUERIES, ICI_QUERIES,
    RECOVERY_SQL, STREAM_PHASES, WORKERS, adaptive_tables, all_kinds,
    chaos_scenario, chaos_todo, check_scenario, crossproc_tables,
    kinds_covered, matrix_scenarios, recovery_tables, run_scenario,
    stream_scenarios)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

#: the rows of the JAX package's matrix whose name differs here: its
#: analysis row, and the no-recovery form of the device tier's copy-point
#: kill (the recovery form, ``testing.ici_scenarios``, has the name)
RENAMED = {"skew-decision-divergence": "skew-decision",
           "ici-die-mid-device-copy": "ici-die-mid-device-copy-noretry"}

#: the JAX package's worker files → the port's worker entries
WORKER_OF = {"recovery_worker.py": "recovery-worker",
             "adaptive_worker.py": "adaptive-worker",
             "shuffled_join_worker.py": "crossproc-worker",
             "pool_worker.py": "pool-worker",
             "streaming_worker.py": "stream-chaos"}

TIER1 = {"mid-fetch-kill", "mid-fetch-kill-noretry", "grace-kill",
         "blockserver-adopt-zero-rerun", "pool-reap-mid-fetch"}

NEW_ROWS = ["mid-demotion-kill", "block-corrupted-alive-peer",
            "block-truncated-noretry", "spill-disk-full", "grace-disk-full",
            "ici-unavailable-fallback", "ici-die-mid-device-copy-noretry"]

_JAX = {}


def _jax_rows(spark, key, tables, sql):
    """The JAX package's single-process answer to ``sql`` over
    ``tables``, as JSON rows."""
    if key not in _JAX:
        s = spark.newSession()
        s.conf.set("spark.tpu.mesh.shards", "1")
        for name, cols in tables.items():
            s.createDataFrame(cols).createOrReplaceTempView(name)
        _JAX[key] = [[v.item() if hasattr(v, "item") else v for v in r]
                     for r in s.sql(sql).collect()]
    return _JAX[key]


def _answers(spark, sc):
    """The JAX package's answer to the text a scenario's workers run."""
    if sc["worker"] == "recovery-worker":
        return _jax_rows(spark, "recovery", recovery_tables("recover"),
                         RECOVERY_SQL)
    if sc["worker"] == "adaptive-worker":
        return _jax_rows(spark, "adaptive", adaptive_tables(),
                         ADAPTIVE_DEMOTE_SQL)
    sql = ICI_QUERIES[0][1] if sc["mode"] == "ici-fault" \
        else CROSSPROC_QUERIES[0][1]
    return _jax_rows(spark, "ici" if sc["mode"] == "ici-fault" else "join",
                     crossproc_tables(), sql)


def _line(out, pid):
    lines = [ln for ln in out.splitlines() if f"[p{pid}]" in ln]
    return lines[-1] if lines else ""


def _result(root, pid):
    with open(os.path.join(root, f"result-p{pid}.json")) as f:
        return json.load(f)


def _rules(plan):
    return json.loads(plan.to_env())


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def test_chaos_matrix_covers_every_fault_kind_and_phase():
    missing = all_kinds() - kinds_covered()
    assert not missing, (
        f"fault kind(s) {sorted(missing)} have no chaos scenario: add one "
        "to spark_tpu_torch/testing.py with the injector")
    table, stream = matrix_scenarios(), stream_scenarios()
    assert set(CHAOS_PHASES) <= {s["phase"] for s in table}
    assert set(STREAM_PHASES) <= {s["phase"] for s in stream}
    names = [s["name"] for s in table + stream]
    assert len(names) == len(set(names))
    for s in table + stream:
        assert s["worker"] in WORKERS, s
        assert set(s["expect"]) == set(range(s["n"])), s["name"]
        assert set(s["plans"]) <= set(range(s["n"])), s["name"]
        assert s["tier"] in ("tier1", "slow"), s["name"]
    assert {s["name"] for s in table + stream
            if s["tier"] == "tier1"} == TIER1


def test_every_jax_matrix_row_has_its_counterpart():
    """Each row of ``tests/chaos_matrix.py`` (exchange and streaming) is
    a row here: same phase, process count and plans; same timeout,
    verdicts and tier but for the analysis row, whose worker prints the
    divergence as ``FAILED-DIVERGED``."""
    sys.path.insert(0, HERE)
    import chaos_matrix as cm
    for ref in cm.SCENARIOS + cm.STREAM_SCENARIOS:
        ours = chaos_scenario(RENAMED.get(ref["name"], ref["name"]))
        assert ours["phase"] == ref["phase"] and ours["n"] == ref["n"], ref
        assert {p: _rules(b()) for p, b in ours["plans"].items()} == \
            {p: _rules(b()) for p, b in ref["plans"].items()}, ref["name"]
        if ref["name"] == "skew-decision-divergence":
            assert ours["worker"] == "analysis-worker"
            assert set(ours["expect"].values()) == {"FAILED-DIVERGED"}
            continue
        assert ours["worker"] == WORKER_OF[ref["worker"]], ref["name"]
        assert ours["mode"] == ref["mode"], ref["name"]
        assert ours["timeout_s"] == ref["timeout_s"], ref["name"]
        assert ours["expect"] == ref["expect"], ref["name"]
        assert ours["tier"] == ref["tier"], ref["name"]


# ---------------------------------------------------------------------------
# the rows added last, in real processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW_ROWS)
def test_matrix_row(spark, tmp_path, name):
    sc = chaos_scenario(name)
    root = str(tmp_path / "run")
    results, elapsed = run_scenario(sc, root, "cpu")
    bad = check_scenario(sc, results, elapsed)
    assert not bad, (bad, {p: out[-1500:] for p, (_rc, out)
                           in results.items()})
    exp = _answers(spark, sc)
    for pid, want in sc["expect"].items():
        if want == "OK":
            assert _result(root, pid)["rows"] == exp, (name, pid)
    out = {pid: o for pid, (_rc, o) in results.items()}
    if name == "mid-demotion-kill":
        assert "dying after put in 'xq000001-bcast'" in out[1]
        assert _result(root, 0)["outcome"] in ("ExchangeFetchFailed",
                                               "TimeoutError")
    elif name == "block-corrupted-alive-peer":
        assert "retries=1" in _line(out[0], 0), out[0]
    elif name == "block-truncated-noretry":
        for pid in (0, 1):
            r = _result(root, pid)
            assert r["outcome"] == "ExchangeFetchFailed", r
            assert r["counters"]["stage_retries"] == 0, r
    elif name in ("spill-disk-full", "grace-disk-full"):
        r = _result(root, 1)
        spill = "grace spill failed" if name == "grace-disk-full" \
            else "spill failed"
        assert r["owner"] and spill in r["error"], r
        assert r["owner"] in _line(out[1], 1)
        assert _result(root, 0)["outcome"] in ("ExchangeFetchFailed",
                                               "TimeoutError")
    elif name == "ici-unavailable-fallback":
        c0, c1 = _result(root, 0)["counters"], _result(root, 1)["counters"]
        assert c0["dcn_fallback_exchanges"] >= 1, c0
        assert c1["dcn_fallback_exchanges"] == 0, c1
        assert c0["shuffled_joins"] == c1["shuffled_joins"] == 1
    else:
        assert "dying mid device copy" in out[0]
        assert _result(root, 1)["outcome"] in ("ExchangeFetchFailed",
                                               "TimeoutError")


# ---------------------------------------------------------------------------
# the worker tests of the JAX package's tests/test_faults.py
# ---------------------------------------------------------------------------

def _heal_inside_refetch(root):
    """When p1's dropped ``xq000001-jL`` block for p0 must reappear to land
    past p0's inline retry window and inside its refetch's: 1.5 x the
    reader's backoff for that block (3 retries from 0.1 s, doubling, times
    ``hostshuffle._jitter`` of the block's path, which lies in [0.5,
    1.5)), so 0.53-1.58 s.  The JAX package's test uses 1.0 s, which falls
    after the refetch's window for a path whose jitter sums below 0.5 s."""
    from spark_tpu_torch.parallel.hostshuffle import _jitter
    path = os.path.join(root, "shuffle", "xq000001-jL", "s0001-r0000.part")
    return 1.5 * sum(0.1 * 2 ** a * _jitter(path, a) for a in range(3))


#: name → (worker, mode, timeout, victim plans (given the scenario's
#: root), verdicts)
FAULT_CASES = {
    # p1's left-side block for p0 vanishes after the put and reappears
    # past the inline retry window, inside the refetch re-barrier: both
    # answer
    "join-side-block-dropped-then-heals": (
        "crossproc-worker", "fault", 15.0,
        lambda root: {1: lambda: P().drop(
            exchange="xq000001-jL", receiver=0,
            heal_after_s=_heal_inside_refetch(root))},
        {0: "OK", 1: "OK"}),
    # size-preserving corruption, no heal: the checksum fails every
    # re-read, p0 fails naming host-1, p1 at its next barrier
    "join-side-block-corrupted-fails-bounded": (
        "crossproc-worker", "fault", 6.0,
        {1: lambda: P().corrupt(exchange="xq000001-jL", receiver=0)},
        {0: "FAILED", 1: "FAILED"}),
    # p1's sample manifest reappears 2 s after its publish: the round
    # completes, both derive the same cut points
    "range-sample-manifest-dropped-then-heals": (
        "crossproc-worker", "fault-sample", 20.0,
        {1: lambda: P().drop(exchange="xq000001-sample", heal_after_s=2.0)},
        {0: "OK", 1: "OK"}),
    # a flipped byte with no heal: BOTH fail naming host-1, never
    # diverged cut points
    "range-sample-manifest-corrupted-fails-bounded": (
        "crossproc-worker", "fault-sample", 6.0,
        {1: lambda: P().corrupt(exchange="xq000001-sample")},
        {0: "FAILED", 1: "FAILED"}),
    # the first map-side spill write hits ENOSPC: a structured
    # HostMemoryError in p1, p0 fails on its exchange deadline
    "spill-disk-full-fails-bounded": (
        "crossproc-worker", "spill-fault", 8.0,
        {1: lambda: P().disk_full(after_bytes=0)},
        {0: "FAILED", 1: "HOSTMEM"}),
    # p1's stats manifest corrupted: the lenient gather skips it on every
    # process, both keep the frozen hash plan and answer
    "adaptive-stats-corrupted-falls-back-to-frozen": (
        "adaptive-worker", "fault-adapt", 15.0,
        {1: lambda: P().corrupt(exchange="xq000001-plan")},
        {0: "OK", 1: "OK"}),
    # p1's stats manifest reappears 2 s after its publish: full stats,
    # the demotion still fires on both
    "adaptive-stats-dropped-then-heals-still-demotes": (
        "adaptive-worker", "fault-adapt", 20.0,
        {1: lambda: P().drop(exchange="xq000001-plan", heal_after_s=2.0)},
        {0: "OK", 1: "OK"}),
    # p1 dies right after its put into the demotion's gather: p0 takes
    # the same demotion and fails bounded at the -bcast barrier
    "peer-killed-mid-demotion-fails-bounded": (
        "adaptive-worker", "fault-adapt", 6.0,
        {1: lambda: P().die_after_put(exchange="xq000001-bcast")},
        {0: "FAILED", 1: "DIED"}),
}


@pytest.mark.parametrize("name", list(FAULT_CASES))
def test_fault_worker(spark, tmp_path, name):
    worker, mode, timeout_s, plans, expect = FAULT_CASES[name]
    root = str(tmp_path / "run")
    if callable(plans):
        plans = plans(root)
    sc = {"name": name, "worker": worker, "mode": mode, "n": 2,
          "timeout_s": timeout_s, "plans": plans, "expect": expect}
    results, elapsed = run_scenario(sc, root, "cpu")
    bad = check_scenario(sc, results, elapsed)
    assert not bad, (bad, {p: out[-1500:] for p, (_rc, out)
                           in results.items()})
    out = {pid: o for pid, (_rc, o) in results.items()}
    exp = _answers(spark, sc)
    for pid, want in expect.items():
        if want == "OK":
            assert _result(root, pid)["rows"] == exp, (name, pid)
        else:
            assert f"[p{pid}] OK" not in out[pid], out[pid]
    lines = {pid: _line(o, pid) for pid, o in out.items()}
    if name == "join-side-block-dropped-then-heals":
        # healed by the refetch, not by the inline retries
        c = _result(root, 0)["counters"]
        assert c["refetches"] == 1 and c["fetch_failures"] == 1, c
    elif name == "join-side-block-corrupted-fails-bounded":
        assert "host-1" in lines[0], out[0]
    elif name == "range-sample-manifest-corrupted-fails-bounded":
        assert "host-1" in lines[0] and "host-1" in lines[1], out
    elif name == "spill-disk-full-fails-bounded":
        assert lines[1].startswith("[p1] FAILED-HOSTMEM"), out[1]
    elif name == "adaptive-stats-corrupted-falls-back-to-frozen":
        for line in lines.values():
            assert "demotions=0" in line and "replans=0" in line, line
            assert "shuffled=1" in line and "bcast=0" in line, line
    elif name == "adaptive-stats-dropped-then-heals-still-demotes":
        for line in lines.values():
            assert "demotions=1" in line and "replans=1" in line, line
            assert "bcast=1" in line and "shuffled=0" in line, line
    elif name == "peer-killed-mid-demotion-fails-bounded":
        assert "dying after put in 'xq000001-bcast'" in out[1], out[1]


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _chaos(*args, env=None):
    e = dict(os.environ if env is None else env)
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "spark_tpu_torch.testing", "chaos", *args],
        cwd=REPO, env=e, capture_output=True, text=True, timeout=600)


def test_chaos_runner_tier1_on_the_cpu(tmp_path):
    p = _chaos("--tier", "tier1", "--only", "mid-fetch-kill", "--device",
               "cpu", "--root", str(tmp_path))
    assert p.returncode == 0, p.stdout + p.stderr
    rows = p.stdout.split("\nscenario ", 1)[1].splitlines()
    assert rows[0].split() == ["phase", "tier", "s", "verdict"]
    assert rows[1].split()[:3] == ["mid-fetch-kill", "mid-fetch", "tier1"]
    assert rows[2].split()[:3] == ["mid-fetch-kill-noretry", "mid-fetch",
                                   "tier1"]
    assert rows[1].endswith("PASS") and rows[2].endswith("PASS")
    assert "2/2 scenarios passed (seed 0)" in p.stdout


def test_chaos_seed_fixes_the_order():
    table = matrix_scenarios()
    names = [s["name"] for s in table]
    assert [s["name"] for s in chaos_todo(table)] == names
    a = [s["name"] for s in chaos_todo(table, seed=7)]
    assert a == [s["name"] for s in chaos_todo(table, seed=7)]
    assert a != names and sorted(a) == sorted(names)
    assert a != [s["name"] for s in chaos_todo(table, seed=8)]
    assert {s["name"] for s in chaos_todo(table, tier="tier1")} \
        == TIER1 & set(names)
    assert all(s["name"].startswith("pool-")
               for s in chaos_todo(table, pool=True))


def test_chaos_runner_refuses_cuda_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _chaos("--tier", "tier1", env=env)
    assert p.returncode != 0
    assert "CUDA card" in p.stderr, p.stderr
    assert "scenarios passed" not in p.stdout
