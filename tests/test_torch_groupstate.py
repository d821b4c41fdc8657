"""The versioned state store and flatMapGroupsWithState of the port
against ``spark_tpu``'s on the CPU: each test of
``tests/test_groupstate.py`` through both packages (delta/snapshot files,
replay from a fresh provider, maintenance; batch-mode fresh state,
state across micro-batches, recovery from a checkpoint, the event-time
timeout), with the store's files and payloads compared too."""

import os
import pickle

import numpy as np
import pytest

from spark_tpu_torch import config as TC
from spark_tpu_torch.sql.session import SparkSession as TSession
from torch_stream_common import Pkg, both


@pytest.fixture(scope="module")
def tspark(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_groupstate")
    s = TSession(TC.Conf({"spark.torch.device": "cpu",
                          "spark.sql.warehouse.dir": str(root / "wh")}))
    yield s
    s.stop()


@pytest.fixture
def pkgs(spark, tspark):
    return [Pkg("spark_tpu", spark), Pkg("spark_tpu_torch", tspark)]


def _conf(p, **kv):
    """A fresh conf of ``p``'s package with the streaming settings."""
    import importlib
    conf = importlib.import_module(f"{p.root}.config").Conf()
    for k, v in kv.items():
        conf.set(f"spark.tpu.streaming.{k}", str(v))
    return conf


# ------------------------------------------------------------- state store

def _versioned(p, tmp):
    prov = p.state.StateStoreProvider(os.path.join(tmp, p.root),
                                      operator_id=0)
    out = []
    s = prov.get_store()
    out.append(len(s))
    s.put(("a",), 1)
    s.put(("b",), 2)
    out.append(s.commit())
    s = prov.get_store()
    out += [s.get(("a",)), len(s)]
    s.remove(("a",))
    s.put(("c",), 3)
    out.append(s.commit())
    old, new = prov.get_store(1), prov.get_store(2)
    out += [old.get(("a",)), new.get(("a",)), new.get(("c",))]
    out.append(sorted(os.listdir(prov.dir)))
    return out


def test_state_store_versioned_commits(pkgs, tmp_path):
    assert both(pkgs, _versioned, str(tmp_path)) == [
        0, 1, 1, 2, 2, 1, None, 3, ["1.delta", "2.delta"]]


def _snapshot_replay(p, tmp):
    conf = _conf(p, stateSnapshotInterval=3, stateMinVersionsToRetain=100)
    d = os.path.join(tmp, p.root)
    prov = p.state.StateStoreProvider(d, conf=conf)
    for i in range(7):
        s = prov.get_store()
        s.put(i, i * 10)
        s.commit()
    files = sorted(os.listdir(prov.dir))
    # the files hold the same pickled payloads in both packages
    payloads = [pickle.load(open(os.path.join(prov.dir, f), "rb"))
                for f in files]
    s = p.state.StateStoreProvider(d, conf=conf).get_store()
    return [files, payloads, s.version, dict(s.iterator())]


def test_state_store_snapshot_and_replay(pkgs, tmp_path):
    ref = both(pkgs, _snapshot_replay, str(tmp_path))
    assert any(f.endswith(".snapshot") for f in ref[0])
    assert ref[2] == 7 and ref[3] == {i: i * 10 for i in range(7)}


def _maintenance(p, tmp):
    conf = _conf(p, stateSnapshotInterval=2, stateMinVersionsToRetain=2)
    d = os.path.join(tmp, p.root)
    prov = p.state.StateStoreProvider(d, conf=conf)
    for i in range(10):
        s = prov.get_store()
        s.put(i, i)
        s.commit()
    versions = sorted(int(f.split(".")[0]) for f in os.listdir(prov.dir))
    return [versions,
            len(p.state.StateStoreProvider(d, conf=conf).get_store())]


def test_state_store_maintenance_deletes_old_files(pkgs, tmp_path):
    ref = both(pkgs, _maintenance, str(tmp_path))
    assert ref[0][0] >= 6 and ref[1] == 10


# -------------------------------------------------------------- batch mode

def _out_schema(p):
    return p.schema(("k", "int64"), ("total", "int64"))


def _batch_mode(p):
    df = p.session.createDataFrame([(1, 10), (2, 20), (1, 30)], ["k", "v"])

    def fn(key, rows, state):
        assert not state.exists
        yield (key[0], sum(r["v"] for r in rows))

    out = df.groupBy("k").flatMapGroupsWithState(fn, _out_schema(p))
    return [sorted((r["k"], r["total"]) for r in out.collect())]


def test_flat_map_groups_batch_mode(pkgs):
    assert both(pkgs, _batch_mode) == [[(1, 40), (2, 20)]]


# ---------------------------------------------------------------- streaming

def _total(key, rows, state):
    total = (state.getOption() or 0) + sum(r["v"] for r in rows)
    state.update(total)
    yield (key[0], total)


def _run(p, df, name, ckpt=None):
    w = (df.writeStream.format("memory").queryName(name)
         .outputMode("append"))
    if ckpt:
        w = w.option("checkpointLocation", ckpt)
    q = w.start()
    q.processAllAvailable()
    return q


def _rows(p, name):
    return sorted((r["k"], r["total"]) for r in
                  p.session.sql(f"SELECT * FROM {name}").collect())


def _streaming_state(p):
    src = p.memory_stream(("k", "int64"), ("v", "int64"))
    src.add_data([(1, 5), (2, 7)])
    df = src.to_df(p.session).groupBy("k").flatMapGroupsWithState(
        _total, _out_schema(p))
    q = _run(p, df, "fmgws1")
    src.add_data([(1, 3)])
    q.processAllAvailable()
    q.stop()
    return [_rows(p, "fmgws1"), sorted(q._ex._fmgws_states.items())]


def test_flat_map_groups_streaming_state_persists(pkgs):
    ref = both(pkgs, _streaming_state)
    assert ref[0] == [(1, 5), (1, 8), (2, 7)]


def _recovery(p, tmp):
    ckpt = os.path.join(tmp, p.root)
    kv = (("k", "int64"), ("v", "int64"))
    src = p.memory_stream(*kv)
    src.add_data([(1, 5)])
    df = src.to_df(p.session).groupBy("k").flatMapGroupsWithState(
        _total, _out_schema(p))
    _run(p, df, "fmgws2", ckpt).stop()
    src2 = p.memory_stream(*kv)
    src2.add_data([(1, 5)])
    src2.add_data([(1, 2)])
    df2 = src2.to_df(p.session).groupBy("k").flatMapGroupsWithState(
        _total, _out_schema(p))
    q2 = _run(p, df2, "fmgws3", ckpt)
    q2.stop()
    files = sorted(os.listdir(os.path.join(ckpt, "state", "0", "0")))
    return [_rows(p, "fmgws3"), files]


def test_flat_map_groups_recovery_from_checkpoint(pkgs, tmp_path):
    ref = both(pkgs, _recovery, str(tmp_path))
    assert (1, 7) in ref[0]


def _timeout(p):
    MIN = 60_000_000
    src = p.memory_stream(("k", "int64"), ("ts", "int64"), ("v", "int64"))
    out_schema = p.schema(("k", "int64"), ("kind", "string"))

    def fn(key, rows, state):
        if state.hasTimedOut:
            state.remove()
            yield (key[0], "timeout")
        else:
            state.update(len(rows))
            state.setTimeoutTimestamp(max(r["ts"] for r in rows) + MIN)
            yield (key[0], "seen")

    src.add_data([(1, 0 * MIN, 1)])
    df = (src.to_df(p.session).withWatermark("ts", "0 seconds")
          .groupBy("k").flatMapGroupsWithState(
              fn, out_schema, timeoutConf="EventTimeTimeout"))
    q = (df.writeStream.format("memory").queryName("fmgws4")
         .outputMode("append").start())
    q.processAllAvailable()
    src.add_data([(2, 10 * MIN, 1)])
    q.processAllAvailable()
    src.add_data([(2, 11 * MIN, 1)])
    q.processAllAvailable()
    q.stop()
    return [sorted((r["k"], r["kind"]) for r in
                   p.session.sql("SELECT * FROM fmgws4").collect())]


def test_flat_map_groups_event_time_timeout(pkgs):
    assert (1, "timeout") in both(pkgs, _timeout)[0]


def _seeded_sessions(p):
    """Per-user session counts with an event-time timeout over seeded
    events (the chip script's scenario (e) at a small size)."""
    rng = np.random.default_rng(12)
    SEC = 1_000_000
    src = p.memory_stream(("user", "int64"), ("et", "int64"))
    out_schema = p.schema(("user", "int64"), ("events", "int64"),
                          ("closed", "boolean"))

    def fn(key, rows, state):
        if state.hasTimedOut:
            n = state.get()
            state.remove()
            yield (key[0], n, True)
            return
        n = (state.getOption() or 0) + len(rows)
        state.update(n)
        state.setTimeoutTimestamp(max(r["et"] for r in rows) + 5 * SEC)
        yield (key[0], n, False)

    df = (src.to_df(p.session).withWatermark("et", "2 seconds")
          .groupBy("user").flatMapGroupsWithState(
              fn, out_schema, timeoutConf="EventTimeTimeout"))
    q = (df.writeStream.format("memory").queryName("fmgws5")
         .outputMode("append").start())
    out = []
    for t in range(4):
        users = rng.integers(t * 10, t * 10 + 25, 80)
        ets = rng.integers(t * 6, t * 6 + 6, 80) * SEC
        src.add_data([(int(u), int(e)) for u, e in zip(users, ets)])
        q.processAllAvailable()
        out.append((sorted(tuple(r) for r in p.session.sql(
            "SELECT * FROM fmgws5").collect()),
            len(q._ex._fmgws_states)))
    q.stop()
    return out


def test_seeded_session_counts_with_timeout(pkgs):
    ref = both(pkgs, _seeded_sessions)
    assert any(closed for _u, _n, closed in ref[-1][0])
