"""Exactly-once recovery of the port's standing queries against
``spark_tpu``'s on the CPU.

Each test of ``tests/test_streaming_recovery.py`` runs through both
packages: the engine is killed (a raised ``_SimKill`` through the fault
injector's ``die`` seam) mid-batch, after the state commit, or with its
commit entry torn; a fresh execution recovers from the same checkpoint
and its file sink must equal an uninterrupted run byte for byte, in each
package, and row for row across the packages.  Then one real process
exit: the port's ``stream-worker`` dies (exit 43) after a state commit,
a restarted worker resumes, tears its last commit entry and replays it.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from spark_tpu_torch import config as TC
from spark_tpu_torch.sql.session import SparkSession as TSession
from torch_stream_common import (Pkg, json_sink_rows, sec, sink_files,
                                 state_rows)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FEEDS = [
    [(sec(1), "a", 1), (sec(9), "b", 2)],
    [(sec(20), "a", 4), (sec(21), "b", 1)],
    [(sec(35), "c", 8), (sec(35), "c", 8)],     # in-batch duplicate
    [(sec(50), "a", 3), (sec(51), "d", 9)],
]

PHASES = ["mid_batch", "post_state_commit", "mid_commit"]
SHAPES = ["stateful_dedup", "windowed_agg"]


class _SimKill(BaseException):
    """Simulated hard process death."""


@pytest.fixture(scope="module")
def tspark(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_stream_recovery")
    s = TSession(TC.Conf({"spark.torch.device": "cpu",
                          "spark.sql.warehouse.dir": str(root / "wh")}))
    yield s
    s.stop()


@pytest.fixture
def pkgs(spark, tspark):
    prev = spark.conf.get("spark.tpu.mesh.shards")
    spark.conf.set("spark.tpu.mesh.shards", "1")
    yield [Pkg("spark_tpu", spark), Pkg("spark_tpu_torch", tspark)]
    spark.conf.set("spark.tpu.mesh.shards", str(prev))


def _schema(p):
    return p.schema(("ts", "timestamp"), ("k", "string"), ("v", "int64"))


def _write_inputs(p, in_dir):
    os.makedirs(in_dir, exist_ok=True)
    for i, rows in enumerate(FEEDS):
        p.session.createDataFrame({
            "ts": np.array([r[0] for r in rows], "datetime64[us]"),
            "k": [r[1] for r in rows],
            "v": np.array([r[2] for r in rows], np.int64),
        }).write.parquet(os.path.join(in_dir, f"f{i}"))


def _shape(p, shape, df):
    df = df.withWatermark("ts", "5 seconds")
    if shape == "windowed_agg":
        return (df.groupBy(p.F.window("ts", "10 seconds").alias("w"))
                .agg(p.F.sum("v").alias("s")))
    return df.dropDuplicates(["k", "ts"])


def _arm(p, ex, phase, at_batch):
    if phase == "mid_batch":
        orig = ex._execute_batch

        def execute(batch):
            out = orig(batch)
            if ex.batch_id == at_batch:
                raise _SimKill(f"mid-batch {ex.batch_id}")
            return out

        ex._execute_batch = execute
        return

    def raiser(code):
        raise _SimKill(code)

    P = p.faults.FaultPlan
    if phase == "post_state_commit":
        plan = P().die_after_state_commit(after_entries=at_batch)
    else:
        plan = P().torn_checkpoint(keep_bytes=11, after_entries=at_batch,
                                   die=True)
    inj = p.faults.FaultInjector(plan)
    inj.die = raiser
    inj.attach_stream(ex)


def _lifetime(p, shape, in_dir, ckpt, out, kill=None):
    core = p.core
    src = core.FileStreamSource("parquet", in_dir, _schema(p),
                                {"maxfilespertrigger": "1"})
    df = _shape(p, shape, p.DataFrame(p.session,
                                      core.StreamingRelation(src)))
    ex = core.StreamExecution(p.session, df._plan,
                              core.FileSink("json", out, {}), "append",
                              ckpt, 0.1, None)
    if kill is not None:
        _arm(p, ex, *kill)
    try:
        ex.process_all_available()
    finally:
        regs = getattr(p.session, "_stream_execs", [])
        if ex in regs:
            regs.remove(ex)
    return ex


def _kill_and_recover(p, tmp, shape, phase):
    base = os.path.join(tmp, p.root)
    in_dir = os.path.join(base, "in")
    _write_inputs(p, in_dir)
    oracle_out = os.path.join(base, "oracle_out")
    _lifetime(p, shape, in_dir, os.path.join(base, "oracle_ckpt"),
              oracle_out)
    oracle = sink_files(oracle_out)
    assert oracle
    ckpt, out = os.path.join(base, "ckpt"), os.path.join(base, "out")
    with pytest.raises(_SimKill):
        _lifetime(p, shape, in_dir, ckpt, out, kill=(phase, 1))
    ex = _lifetime(p, shape, in_dir, ckpt, out)
    assert ex.exception is None
    assert sink_files(out) == oracle
    assert ex.metrics["replayed_batches"] >= 1
    assert ex.metrics["batches_committed"] >= 1
    return [json_sink_rows(out), ex.metrics["replayed_batches"],
            ex.metrics["batches_committed"]]


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kill_at_phase_byte_parity(pkgs, tmp_path, shape, phase):
    ref, port = [_kill_and_recover(p, str(tmp_path), shape, phase)
                 for p in pkgs]
    assert ref == port


def test_corrupt_state_snapshot_aborts_structured(pkgs, tmp_path):
    for p in pkgs:
        base = str(tmp_path / p.root)
        in_dir = os.path.join(base, "in")
        _write_inputs(p, in_dir)
        ckpt, out = os.path.join(base, "ckpt"), os.path.join(base, "out")
        _lifetime(p, "windowed_agg", in_dir, ckpt, out)
        commits = os.path.join(ckpt, "commits")
        last = max(int(f) for f in os.listdir(commits) if f.isdigit())
        snap = os.path.join(ckpt, "state", f"{last}.snapshot")
        buf = open(snap, "rb").read()
        with open(snap, "wb") as f:
            f.write(buf[:-8] + bytes(b ^ 0xFF for b in buf[-8:]))
        with pytest.raises(p.core.CheckpointCorruption) as ei:
            _lifetime(p, "windowed_agg", in_dir, ckpt, out)
        assert ei.value.batch_id == last
        assert str(last) in str(ei.value)


def _torn_commit(p, tmp):
    base = os.path.join(tmp, p.root)
    in_dir = os.path.join(base, "in")
    _write_inputs(p, in_dir)
    ckpt, out = os.path.join(base, "ckpt"), os.path.join(base, "out")
    last = len(FEEDS) - 1
    plan = p.faults.FaultPlan().torn_checkpoint(keep_bytes=7,
                                                after_entries=last)
    core = p.core
    src = core.FileStreamSource("parquet", in_dir, _schema(p),
                                {"maxfilespertrigger": "1"})
    df = _shape(p, "stateful_dedup",
                p.DataFrame(p.session, core.StreamingRelation(src)))
    ex = core.StreamExecution(p.session, df._plan,
                              core.FileSink("json", out, {}), "append",
                              ckpt, 0.1, None)
    inj = p.faults.FaultInjector(plan)
    inj.attach_stream(ex)
    ex.process_all_available()
    torn = core.MetadataLog(os.path.join(ckpt, "commits")).get(last)
    ex.stop()
    ex2 = _lifetime(p, "stateful_dedup", in_dir, ckpt, out)
    back = core.MetadataLog(os.path.join(ckpt, "commits")).get(last)
    return [[s for s in inj.injected if s.startswith("torn_checkpoint:")],
            torn, ex2.metrics["replayed_batches"], back is not None,
            json_sink_rows(out)]


def test_torn_commit_replays_not_crashes(pkgs, tmp_path):
    ref, port = [_torn_commit(p, str(tmp_path)) for p in pkgs]
    assert ref == port
    assert ref[0] == ["torn_checkpoint:3"] and ref[1] is None
    assert ref[2] >= 1 and ref[3]


def _rebuilds(p, tmp):
    base = os.path.join(tmp, p.root)
    in_dir = os.path.join(base, "in")
    _write_inputs(p, in_dir)
    ex = _lifetime(p, "windowed_agg", in_dir, os.path.join(base, "ckpt"),
                   os.path.join(base, "out"))
    return [len(ex.progress), ex.progress[1]["stageRebuilds"],
            ex.progress[-1]["stageRebuilds"],
            state_rows(ex._agg_state.state)]


def test_second_batch_zero_stage_rebuilds(pkgs, tmp_path):
    ref, port = [_rebuilds(p, str(tmp_path)) for p in pkgs]
    assert ref == port
    assert ref[0] >= 2 and ref[1] == 0 and ref[2] == 0


def test_metadata_log_torn_entry_regression(pkgs, tmp_path):
    for p in pkgs:
        d = tmp_path / p.root / "log"
        log = p.core.MetadataLog(str(d))
        log.add(0, {"a": 1})
        log.add(1, {"b": 2})
        raw = (d / "1").read_bytes()
        (d / "1").write_bytes(raw[: len(raw) // 2])
        assert log.get(1) is None
        assert log.latest() == (0, {"a": 1})
        (d / "2").write_text('{"c": 3}')
        assert log.get(2) == {"c": 3}
        (d / "3").write_text('{"c": 3')
        assert log.get(3) is None
        assert log.latest() == (2, {"c": 3})
    # the entries of both packages are the same bytes
    a = (tmp_path / "spark_tpu" / "log" / "0").read_bytes()
    b = (tmp_path / "spark_tpu_torch" / "log" / "0").read_bytes()
    assert a == b


# ---------------------------------------------------------------------------
# a real process exit: the port's stream worker
# ---------------------------------------------------------------------------

def _worker(root, ckpt, out, plan=None, restart=False):
    from spark_tpu_torch.parallel.faults import FAULT_PLAN_ENV
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop(FAULT_PLAN_ENV, None)
    if plan is not None:
        env[FAULT_PLAN_ENV] = plan.to_env()
    argv = [sys.executable, "-m", "spark_tpu_torch.testing",
            "stream-worker", root, "wagg", ckpt, out, "cpu"]
    if restart:
        argv.append("restart")
    with open(out + ".log", "w") as log:
        proc = subprocess.run(argv, env=env, stdout=log,
                              stderr=subprocess.STDOUT, timeout=240)
    return proc.returncode, open(out + ".log").read()


def test_stream_worker_dies_after_state_commit_and_recovers(tspark,
                                                            tmp_path):
    """The worker exits 43 between batch 1's state commit and its sink
    write; a restarted worker replays batch 1 and finishes; its last
    commit entry is torn and a second lifetime in the same process
    replays that batch instead of crashing.  The sink equals an
    uninterrupted lifetime's byte for byte."""
    from spark_tpu_torch.parallel.faults import FaultPlan
    from spark_tpu_torch.testing import stream_lifetime
    p = Pkg("spark_tpu_torch", tspark)
    root = str(tmp_path)
    _write_inputs(p, os.path.join(root, "in"))
    oracle_out = os.path.join(root, "oracle_out")
    stream_lifetime(tspark, "wagg", os.path.join(root, "in"),
                    os.path.join(root, "oracle_ckpt"), oracle_out)
    ckpt, out = os.path.join(root, "ckpt"), os.path.join(root, "out")
    rc, log = _worker(root, ckpt, out,
                      FaultPlan().die_after_state_commit(after_entries=1))
    assert rc == 43, log
    assert "dying after state commit at batch 1" in log
    assert not os.path.exists(os.path.join(out, "_batch_1"))
    t0 = time.time()
    last = len(FEEDS) - 1
    rc, log = _worker(root, ckpt, out,
                      FaultPlan().torn_checkpoint(
                          keep_bytes=9, after_entries=last - 1),
                      restart=True)
    assert rc == 0, log
    res = json.load(open(out + ".result.json"))
    first, second = res["lifetimes"]
    assert first["metrics"]["replayed_batches"] == 1
    assert first["first_commit_unix"] >= t0
    assert res["injected"] == [f"torn_checkpoint:{last}"]
    assert second["metrics"]["replayed_batches"] == 1
    assert second["metrics"]["batches_committed"] == 1
    assert sink_files(out) == sink_files(oracle_out)


@pytest.mark.parametrize("argv", [["r", "wagg", "c", "o"],
                                  ["r", "wagg", "c", "o", "restart"]])
def test_stream_worker_requires_its_device(argv):
    """The worker's device is a required argument: left off, the entry
    point refuses instead of running on the CPU."""
    from spark_tpu_torch.testing import stream_worker
    with pytest.raises(ValueError, match="the device cuda or cpu"):
        stream_worker(argv)
