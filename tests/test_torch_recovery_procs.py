"""Lineage recovery and the block service in REAL processes of the port,
on the CPU: the JAX package's chaos matrix (``tests/chaos_matrix.py``)
scenarios that reach ported modules, each as 2 or 3 workers of
``python -m spark_tpu_torch.testing recovery-worker``
(``testing.chaos_scenarios``).

Each process writes its strided share of the join tables to parquet and
reads it back, so every leaf is a file whose recipe the digest round
publishes.  A ``FaultInjector`` armed from ``SPARK_TPU_FAULT_PLAN``
kills the victim at the scenario's exchange phase (exit 43).  Every
survivor must either return exactly the JAX package's single-process
answer over the whole tables (and numpy's), with the counters the JAX
package's worker asserts for that mode, or fail structured within the
bound; ``PARTIAL`` never appears.
"""

import json
import os

import pytest

from spark_tpu_torch.testing import (
    RECOVERY_SQL, chaos_scenario, chaos_scenarios, check_scenario,
    recovery_oracle, recovery_tables, run_scenario)

NAMES = [sc["name"] for sc in chaos_scenarios()
         if sc["worker"] == "recovery-worker"]
_JAX = {}


def _jax_answer(spark, mode):
    """The JAX package's single-process answer over the whole tables."""
    key = "grace" if mode == "grace-recover" else "base"
    if key not in _JAX:
        s = spark.newSession()
        for name, cols in recovery_tables(mode).items():
            s.createDataFrame(cols).createOrReplaceTempView(name)
        _JAX[key] = [[v.item() if hasattr(v, "item") else v for v in r]
                     for r in s.sql(RECOVERY_SQL).collect()]
    return _JAX[key]


def _line(out, pid):
    lines = [ln for ln in out.splitlines() if f"[p{pid}]" in ln]
    return lines[-1] if lines else ""


@pytest.mark.parametrize("name", NAMES)
def test_recovery_scenario(spark, tmp_path, name):
    sc = chaos_scenario(name)
    root = str(tmp_path / "run")
    results, elapsed = run_scenario(sc, root, "cpu")
    bad = check_scenario(sc, results, elapsed)
    assert not bad, (bad, {p: out[-1500:] for p, (_rc, out)
                           in results.items()})
    exp = _jax_answer(spark, sc["mode"])
    assert exp == recovery_oracle(sc["mode"])
    for pid, want in sc["expect"].items():
        if want != "OK":
            continue
        with open(os.path.join(root, f"result-p{pid}.json")) as f:
            r = json.load(f)
        assert r["rows"] == exp, (name, pid)
        assert r["ledger_used"] == 0, r      # every epoch's staging freed
    out0 = results[0][1]
    line = _line(out0, 0)
    if name in ("mid-fetch-kill", "grace-kill"):
        assert "retries=1" in line and "recovered=1" in line, out0
        assert "epoch=1" in line, out0
    if name == "mid-fetch-kill":
        assert "dying after put in 'xq000001-jL'" in results[1][1]
    if name.startswith("grace-kill"):
        assert int(line.split("grace=")[1].split()[0]) > 0, out0
    if name == "mid-fetch-kill-noretry":
        assert "host-1" in line and "retries=" not in line, out0
        with open(os.path.join(root, "result-p0.json")) as f:
            r = json.load(f)
        assert r["outcome"] == "ExchangeFetchFailed", r
        assert r["lost_hosts"] == ["host-1"], r
        assert r["elapsed_s"] < 2 * sc["timeout_s"], r
        assert r["counters"]["stage_retries"] == 0
        assert r["ledger_used"] == 0
    if name == "blockserver-adopt-zero-rerun":
        assert "retries=0" in line and "fallback=0" not in line, out0
        assert "dying after manifest in 'xq000001-gather'" \
            in results[1][1]


@pytest.mark.parametrize("worker", ["crossproc_worker", "recovery_worker",
                                    "pool_worker"])
@pytest.mark.parametrize("argv", [["0", "2", "ROOT", "recover", "5"],
                                  ["0", "2", "ROOT", "recover", "5", "tpu"]])
def test_worker_requires_a_device(tmp_path, worker, argv):
    """A worker never runs on the CPU by default: without ``cuda`` or
    ``cpu`` it raises, naming its argv, before it starts a session."""
    import spark_tpu_torch.testing as TT
    argv = [str(tmp_path) if a == "ROOT" else a for a in argv]
    with pytest.raises(ValueError, match=r"<device>.*got \["):
        getattr(TT, worker)(argv)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("device", [None, "gpu"])
def test_run_scenario_requires_a_device(tmp_path, device):
    sc = chaos_scenario(NAMES[0])
    with pytest.raises((TypeError, ValueError)):
        if device is None:
            run_scenario(sc, str(tmp_path / "run"))
        else:
            run_scenario(sc, str(tmp_path / "run"), device)
    assert not os.path.exists(tmp_path / "run")
