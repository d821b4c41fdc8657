"""The port's host shuffle service and cluster runtime, held against the
JAX package's on the CPU.

- Wire blocks: the blocks and dictionary sidecars the port's service
  writes are byte for byte the JAX package's for equal batches, and a
  block either package writes decodes in the other's service (one root,
  one process of each package).
- The protocol: single-use ids, padding never on disk, the async and
  sync writers, sender order through the fetch pool, the loud straggler
  barrier, the strict coordination round, heartbeat exclusions turned
  into a structured ``ExchangeFetchFailed``, and the retrying reader's
  transient / fatal split.
- The reducer planners on equal inputs: ``plan_reducers`` and
  ``plan_range_reducers`` (the cases of ``tests/test_shuffled_join.py``
  and random ones) give the JAX package's bounds, owners and counters.
- ``parallel/cluster.py``: the launcher's environment contract,
  ``live_view`` and the host naming against the JAX package's, and the
  heartbeat monitor's verdicts.
"""

import json
import os

import numpy as np
import pytest

from spark_tpu import columnar as RCol
from spark_tpu.parallel import cluster as RCl
from spark_tpu.parallel.hostshuffle import HostShuffleService as RSvc
from spark_tpu_torch import config as C
from spark_tpu_torch import wire
from spark_tpu_torch.columnar import ColumnBatch
from spark_tpu_torch.parallel import cluster as TCl
from spark_tpu_torch.parallel.hostshuffle import (
    BlockFetchError, ExchangeFetchFailed, HostShuffleService,
    RetryingBlockReader)


def _batch(vals, capacity=None):
    return ColumnBatch.from_arrays({"v": np.asarray(vals, np.int64)},
                                   capacity=capacity)


def _values(batches):
    return [int(x) for b in batches
            for x, ok in zip(b.column("v").data.tolist(),
                             b.row_valid_or_true().tolist()) if ok]


def _svc(root, pid=0, n=1, **kw):
    kw.setdefault("timeout_s", 5.0)
    kw.setdefault("poll_s", 0.01)
    return HostShuffleService(str(root), pid, n, **kw)


def _block(root, exchange, sender, receiver):
    return os.path.join(str(root), exchange,
                        f"s{sender:04d}-r{receiver:04d}.part")


# ---------------------------------------------------------------------------
# wire blocks: the JAX package's bytes, readable both ways
# ---------------------------------------------------------------------------

def _mixed_cols():
    rng = np.random.default_rng(2)
    n = 300
    return {"i": rng.integers(-9, 9, n).astype(np.int64),
            "f": rng.normal(size=n),
            "s": np.array(["ash", "oak", "fir"])[rng.integers(0, 3, n)],
            "b": rng.random(n) < 0.5,
            "run": np.repeat(np.arange(10, dtype=np.int64), 30)}


@pytest.mark.parametrize("dict_codes", ["true", "false"])
def test_blocks_and_sidecars_are_the_reference_bytes(tmp_path, dict_codes):
    cols = _mixed_cols()
    conf = C.Conf().set("spark.tpu.shuffle.io.asyncWrite", "false") \
        .set("spark.tpu.shuffle.wire.dictCodes", dict_codes)
    from spark_tpu import config as RC
    rconf = RC.Conf().set("spark.tpu.shuffle.io.asyncWrite", "false") \
        .set("spark.tpu.shuffle.wire.dictCodes", dict_codes)
    t = _svc(tmp_path / "t", 0, 2, conf=conf)
    r = RSvc(str(tmp_path / "r"), 0, 2, timeout_s=5, conf=rconf)
    t.put("e", 1, [ColumnBatch.from_arrays(cols, capacity=512)])
    r.put("e", 1, [RCol.ColumnBatch.from_arrays(cols, capacity=512)])
    t.commit("e")
    r.commit("e")
    for name in os.listdir(tmp_path / "r" / "e"):
        if name.endswith(".done"):
            continue
        with open(tmp_path / "t" / "e" / name, "rb") as a, \
                open(tmp_path / "r" / "e" / name, "rb") as b:
            assert a.read() == b.read(), name
    with open(tmp_path / "t" / "e" / "s0000.done") as a, \
            open(tmp_path / "r" / "e" / "s0000.done") as b:
        ta, rb = json.load(a), json.load(b)
    for doc in (ta, rb):
        doc.pop("ts")
    assert ta == rb


def test_mixed_processes_read_each_others_blocks(tmp_path):
    """One root, the port's service as process 0 and the JAX package's as
    process 1: each collects the other's blocks, dictionary codes
    resolved through the other's sidecar."""
    root = tmp_path / "mixed"
    t = _svc(root, 0, 2)
    r = RSvc(str(root), 1, 2, timeout_s=5)
    t.put("e", 1, [ColumnBatch.from_arrays(
        {"v": np.array([1, 2, 3]), "s": ["oak", "ash", "oak"]})])
    r.put("e", 0, [RCol.ColumnBatch.from_arrays(
        {"v": np.array([7, 8]), "s": ["fir", "yew"]})])
    t.commit("e")
    r.commit("e")
    got_t = t.collect("e")
    got_r = r.collect("e")
    assert got_t[0].to_pylist() == [(7, "fir"), (8, "yew")]
    assert [tuple(x) for x in got_r[0].to_pylist()] == \
        [(1, "oak"), (2, "ash"), (3, "oak")]


def test_single_process_roundtrip_and_cleanup(tmp_path):
    svc = _svc(tmp_path)
    got = svc.exchange("e0", {0: [_batch([1, 2, 3])]})
    assert _values(got) == [1, 2, 3]
    with pytest.raises(ValueError, match="single-use"):
        svc.exchange("e0", {0: [_batch([1])]})
    svc.cleanup("e0")
    assert not os.path.exists(os.path.join(str(tmp_path), "e0"))


def test_padding_never_written(tmp_path):
    svc = _svc(tmp_path, 0, 2)
    b = _batch(np.arange(5), capacity=64)
    assert b.capacity == 64
    svc.put("e", 1, [b])
    svc.flush("e")
    with open(_block(tmp_path, "e", 0, 1), "rb") as f:
        data = f.read()
    assert data[:4] == wire.MAGIC
    (meta,) = wire.frame_info(data)["batches"]
    assert meta["capacity"] == 5 and meta["row_valid"] is None


def test_async_write_roundtrip_and_counters(tmp_path):
    svc0, svc1 = _svc(tmp_path, 0, 2), _svc(tmp_path, 1, 2)
    assert svc0.async_write
    svc1.put("e", 0, [_batch([9])])
    svc1.commit("e")
    got = svc0.exchange("e", {0: [_batch([1, 2])], 1: [_batch([3])]})
    assert sorted(_values(got)) == [1, 2, 9]
    c = svc0.counters
    assert c["blocks_written"] >= 1 and c["blocks_read"] >= 1
    assert c["bytes_written"] > 0 and c["bytes_read"] > 0
    assert svc0.timers["encode_s"] > 0 and svc0.timers["decode_s"] > 0
    snap = svc0.metrics_source().snapshot()
    assert snap["compression_ratio"] > 0
    assert snap["host_budget_bytes"] > 0


def test_sync_write_conf_path(tmp_path):
    conf = C.Conf().set("spark.tpu.shuffle.io.asyncWrite", "false")
    svc = _svc(tmp_path, 0, 2, conf=conf)
    assert not svc.async_write
    svc.put("e", 1, [_batch([4, 5])])
    assert svc._writer is None
    assert os.path.exists(_block(tmp_path, "e", 0, 1))


def test_concurrent_fetch_keeps_sender_order(tmp_path):
    svcs = [_svc(tmp_path, p, 4, timeout_s=10) for p in range(4)]
    for p in (1, 2, 3):
        svcs[p].put("e", 0, [_batch([p * 10, p * 10 + 1])])
        svcs[p].commit("e")
    got = svcs[0].exchange("e", {0: [_batch([0, 1])], 1: [], 2: [], 3: []})
    assert [int(b.column("v").data[0]) for b in got] == [0, 10, 20, 30]
    assert svcs[0].counters["blocks_read"] == 3


def test_straggler_barrier_is_loud(tmp_path):
    svc = _svc(tmp_path, 0, 2, timeout_s=0.3)
    svc.commit("e1")
    with pytest.raises(TimeoutError, match=r"senders \[1\]"):
        svc.barrier("e1")


def test_gather_manifests_strict_rejects_unreadable(tmp_path):
    svc0 = _svc(tmp_path, 0, 2, timeout_s=0.5)
    svc1 = _svc(tmp_path, 1, 2)
    n0 = svc0.publish_manifest("e", {"sample": {"points": [1, 2]}})
    svc1.publish_manifest("e", {"sample": {}})
    with open(svc1._done("e", 1), "wb") as f:    # a torn write
        f.write(b"\x82{ not json")
    with pytest.raises(ExchangeFetchFailed) as ei:
        svc0.gather_manifests("e", strict=True)
    assert ei.value.lost_hosts == ["host-1"]
    mans, total = svc0.gather_manifests("e")
    assert 0 in mans and 1 not in mans and total >= n0


def test_publish_and_gather_sizes(tmp_path):
    svc0, svc1 = _svc(tmp_path, 0, 2), _svc(tmp_path, 1, 2)
    svc0.publish_sizes("e", {0: 100, 2: 50})
    svc1.publish_sizes("e", {0: 11, 3: 7})
    assert svc0.gather_sizes("e", 4).tolist() == \
        svc1.gather_sizes("e", 4).tolist() == [111, 0, 50, 7]
    with pytest.raises(ValueError):
        svc0.publish_sizes("e", {0: 1})


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_heartbeat_dead_peer_fails_the_exchange_structured(tmp_path):
    """A peer whose beats went stale is excluded at the barrier and
    blacklisted, and the read raises ``ExchangeFetchFailed`` naming it
    (then a refetch fails the same way, fast: the blacklist persists)."""
    clock = _Clock()
    beats = str(tmp_path / "beats")
    conf = C.Conf().set("spark.tpu.cluster.heartbeatTimeoutMs", "1000")
    hb0 = TCl.HeartbeatMonitor(beats, "host-0", conf=conf, clock=clock)
    hb1 = TCl.HeartbeatMonitor(beats, "host-1", conf=conf, clock=clock)
    hb0.beat()
    hb1.beat()
    clock.t += 5.0                         # host-1 goes silent
    hb0.beat()
    svc = _svc(tmp_path / "root", 0, 2, timeout_s=5.0, heartbeat=hb0)
    with pytest.raises(ExchangeFetchFailed) as ei:
        svc.exchange("e", {0: [_batch([1])], 1: [_batch([2])]})
    assert ei.value.lost_hosts == ["host-1"]
    assert svc.blacklist == {1: "heartbeat-dead during 'e'"}
    assert svc.counters["peers_blacklisted"] == 1
    with pytest.raises(ExchangeFetchFailed):
        svc.refetch("e", {0: [_batch([1])]})


def test_retrying_reader_transient_and_fatal(tmp_path):
    waits = []
    reader = RetryingBlockReader(max_retries=3, retry_wait_s=0.01,
                                 sleep=waits.append)
    path = str(tmp_path / "b.part")
    with pytest.raises(BlockFetchError):
        reader.read(path)                      # never appears
    assert len(waits) == 3
    buf = wire.encode_batches([_batch([1, 2])])
    with open(path, "wb") as f:
        f.write(buf)
    assert _values(reader.read(path, expect_size=len(buf))) == [1, 2]
    with open(path, "wb") as f:                # same length, bad checksum
        f.write(buf[:-1] + bytes([buf[-1] ^ 1]))
    waits.clear()
    with pytest.raises(BlockFetchError):
        reader.read(path)
    assert len(waits) == 3                     # retried as transient
    with open(path, "wb") as f:                # not a wire frame at all
        f.write(b"XXXX" + buf[4:])
    waits.clear()
    with pytest.raises(BlockFetchError):
        reader.read(path)
    assert waits == []                         # fatal at once


# ---------------------------------------------------------------------------
# the reducer planners on equal inputs
# ---------------------------------------------------------------------------

def _pair(tmp_path, pid, n):
    return (_svc(tmp_path / f"t{pid}{n}", pid, n),
            RSvc(str(tmp_path / f"r{pid}{n}"), pid, n, timeout_s=5))


def _size_cases():
    rng = np.random.default_rng(4)
    cases = [(np.array([5] * 16), 0, 2, None),
             (np.array([10, 10, 10, 10, 500, 10, 10, 10]), 100, 2, None),
             (np.array([1, 1, 1, 100000, 1, 1, 1, 1]), 2, 4, None),
             (np.array([37, 0, 12, 900, 4, 4, 4, 250, 0, 66]), 200, 2, None),
             (np.array([37, 0, 12, 900, 4, 4, 4, 250, 0, 66]), 200, 4, 2)]
    for _ in range(20):
        n = int(rng.integers(1, 5))
        sizes = rng.integers(0, 5000, int(rng.integers(1, 40)))
        sizes[rng.random(len(sizes)) < 0.2] *= 50
        cases.append((sizes, int(rng.choice([0, 2048, 1 << 20])), n,
                      None if rng.random() < 0.5
                      else int(rng.integers(1, n + 1))))
    return cases


def test_plan_reducers_match_reference(tmp_path):
    for sizes, target, n, n_max in _size_cases():
        t, r = _pair(tmp_path, 0, n)
        sizes = np.asarray(sizes, np.int64)
        assert t.plan_reducers(sizes, target, n_max=n_max) == \
            r.plan_reducers(sizes, target, n_max=n_max)
        assert t.last_partition_bytes == r.last_partition_bytes
        for c in ("partitions_coalesced", "partitions_skewed"):
            assert t.counters[c] == r.counters[c], c


def test_plan_reducers_last_group_takes_the_rest_reference_fault(tmp_path):
    """A fault of the JAX package's coalescer, kept by the port (a mixed
    run must plan alike; ROADMAP §3): with far more bytes than processes
    x target, the first n-1 reducers close at about one target each and
    the last takes the rest.  64 fine partitions of 1 MiB, a 4 MiB
    target, 2 processes: 4 partitions for process 0, 60 for process 1."""
    sizes = np.full(64, 1 << 20, np.int64)
    t, r = _pair(tmp_path, 0, 2)
    assert t.plan_reducers(sizes, 4 << 20) == \
        r.plan_reducers(sizes, 4 << 20) == [0, 4, 64]
    assert t.last_partition_bytes == r.last_partition_bytes \
        == [4 << 20, 60 << 20]


def test_plan_range_reducers_match_reference(tmp_path):
    rng = np.random.default_rng(8)
    cases = [(np.array([10, 10, 100000, 10, 10]), np.array([5, 5, 50, 5, 5]),
              2048, 2, None),
             (np.array([7] * 8), np.zeros(8, np.int64), 100, 2, None)]
    for _ in range(20):
        k = int(rng.integers(1, 30))
        probe = rng.integers(0, 3000, k)
        probe[rng.random(k) < 0.15] *= 80
        cases.append((probe, rng.integers(0, 500, k),
                      int(rng.choice([0, 2048, 1 << 20])),
                      int(rng.integers(1, 5)), None))
    for probe, build, target, n, n_max in cases:
        t, r = _pair(tmp_path, 0, n)
        args = (np.asarray(probe, np.int64), np.asarray(build, np.int64),
                target)
        assert t.plan_range_reducers(*args, n_max=n_max) == \
            r.plan_range_reducers(*args, n_max=n_max)
        assert t.last_partition_bytes == r.last_partition_bytes
        for c in ("partitions_coalesced", "spans_split"):
            assert t.counters[c] == r.counters[c], c
        totals = args[0] + args[1]
        assert t.skew_spans(totals) == r.skew_spans(totals)


# ---------------------------------------------------------------------------
# the cluster runtime
# ---------------------------------------------------------------------------

def test_init_cluster_reads_the_launcher_contract(monkeypatch):
    for key in ("SPARK_TPU_COORDINATOR", "SPARK_TPU_NUM_PROCESSES",
                "SPARK_TPU_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    info = TCl.init_cluster()
    assert (info.process_index, info.process_count) == (0, 1)
    monkeypatch.setenv("SPARK_TPU_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("SPARK_TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("SPARK_TPU_PROCESS_ID", "3")
    info = TCl.init_cluster()
    assert (info.process_index, info.process_count, info.coordinator) == \
        (3, 4, "localhost:1234")
    assert TCl.default_host_name() == "host-3"
    assert TCl.init_cluster(num_processes=2, process_id=1).process_index == 1
    with pytest.raises(ValueError):
        TCl.init_cluster(num_processes=2, process_id=2)


def test_naming_and_live_view_match_reference():
    for host in ("host-0", "host-12", "pool-3", "host-x", "host-"):
        assert TCl.parse_host_pid(host) == RCl.parse_host_pid(host)
    for p in (0, 5):
        assert TCl.default_host_name(p) == RCl.default_host_name(p)
    cases = [(4, (), (), ()), (4, ("host-1",), (2,), ()),
             (3, ("host-0", "pool-1"), (), ("host-5", "pool-2", "host-x")),
             (2, (), (0, 1), ("host-1",))]
    for args in cases:
        assert TCl.live_view(*args) == RCl.live_view(*args)


def test_heartbeat_monitor_verdicts(tmp_path):
    clock = _Clock()
    conf = C.Conf().set("spark.tpu.cluster.heartbeatTimeoutMs", "1000")
    beats = str(tmp_path / "beats")
    me = TCl.HeartbeatMonitor(beats, "host-0", conf=conf, clock=clock)
    peer = TCl.HeartbeatMonitor(beats, "host-1", conf=conf, clock=clock)
    seen = []
    me.on_failure(seen.append)
    me.beat()
    peer.beat()
    assert me.dead_hosts() == [] and me.live_hosts() == ["host-0", "host-1"]
    clock.t += 2.0
    me.beat()
    assert me.dead_hosts() == ["host-1"] and me.dead_hosts() == ["host-1"]
    assert seen == ["host-1"]                   # the callback fires once
    with pytest.raises(RuntimeError, match="missed heartbeats"):
        me.check_or_raise()
    peer.retire()                               # a clean leave, not death
    assert me.dead_hosts() == []
