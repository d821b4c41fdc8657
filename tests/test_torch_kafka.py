"""The Kafka source of the port against ``spark_tpu``'s on the CPU, over
the same in-memory fake broker (``FakeBroker``, installed in each
package through ``set_client_factory``; neither machine has a ``kafka``
package): offset-range micro-batches, replay after a restart, the
offset WAL's per-partition payloads, snapshot pruning, and the
kafka-python adapter against a mocked module."""

import os
import sys
import types

import pytest

from spark_tpu_torch import config as TC
from spark_tpu_torch.sql.session import SparkSession as TSession
from torch_stream_common import Pkg, both


@pytest.fixture(scope="module")
def tspark(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_kafka")
    s = TSession(TC.Conf({"spark.torch.device": "cpu",
                          "spark.sql.warehouse.dir": str(root / "wh")}))
    yield s
    s.stop()


class FakeBroker:
    """partition → [(key, value, ts_us)], the KafkaClient surface."""

    def __init__(self, n_parts=2):
        self.logs = {p: [] for p in range(n_parts)}

    def send(self, partition, key, value, ts_us=0):
        self.logs[partition].append((key, value, ts_us))

    def partitions(self, topic):
        return sorted(self.logs)

    def latest_offsets(self, topic):
        return {p: len(log) for p, log in self.logs.items()}

    def fetch(self, topic, partition, start, end):
        return [(start + i, k, v, ts) for i, (k, v, ts)
                in enumerate(self.logs[partition][start:end])]


@pytest.fixture
def pkgs(spark, tspark):
    ps = [Pkg("spark_tpu", spark), Pkg("spark_tpu_torch", tspark)]
    yield ps
    for p in ps:
        p.kafka.set_client_factory(None)


def _with_broker(p):
    b = FakeBroker()
    p.kafka.set_client_factory(lambda _opts: b)
    return b


def _start(p, name, ckpt=None, mode="append"):
    sdf = (p.session.readStream.format("kafka")
           .option("subscribe", "events").load())
    w = (sdf.select("key", "value", "partition", "offset")
         .writeStream.format("memory").queryName(name).outputMode(mode)
         .trigger(once=True))
    if ckpt:
        w = w.option("checkpointLocation", ckpt)
    return w.start()


def _offset_ranges(p):
    broker = _with_broker(p)
    broker.send(0, "a", "v1")
    broker.send(1, None, "v2")
    q = _start(p, "kq1")
    q.processAllAvailable()
    out = [p.rows("kq1")]
    broker.send(0, "b", "v3")
    q.processAllAvailable()
    out.append(p.rows("kq1"))
    q.stop()
    return out


def test_kafka_offset_range_batches(pkgs):
    ref = both(pkgs, _offset_ranges)
    assert sorted(ref[1], key=repr) == sorted(
        [(None, "v2", 1, 0), ("a", "v1", 0, 0), ("b", "v3", 0, 1)], key=repr)


def _replay(p, tmp):
    ckpt = os.path.join(tmp, p.root)
    broker = _with_broker(p)
    broker.send(0, "a", "x1")
    broker.send(1, "b", "x2")
    q = _start(p, "kq2", ckpt=ckpt)
    q.processAllAvailable()
    first = p.rows("kq2")
    q.stop()
    broker.send(1, "c", "x3")
    q2 = _start(p, "kq3", ckpt=ckpt)
    q2.processAllAvailable()
    q2.stop()
    wal = p.core.MetadataLog(os.path.join(ckpt, "offsets"))
    return [first, p.rows("kq3"), wal.get(0), wal.get(1)]


def test_kafka_replay_after_restart(pkgs, tmp_path):
    ref = both(pkgs, _replay, str(tmp_path))
    assert len(ref[0]) == 2 and ref[1] == [("c", "x3", 1, 1)]
    # the offset WAL carries the per-partition map behind each offset
    assert ref[3]["meta"]["end_offsets"] == {"0": 1, "1": 2}


def test_kafka_requires_subscribe(pkgs):
    for p in pkgs:
        _with_broker(p)
        with pytest.raises(p.AnalysisException, match="subscribe"):
            p.session.readStream.format("kafka").load()


def test_kafka_no_client_is_loud(pkgs):
    for p in pkgs:
        p.kafka.set_client_factory(None)
        with pytest.raises(p.AnalysisException, match="client"):
            (p.session.readStream.format("kafka")
             .option("subscribe", "t").load())


def _latest(p):
    broker = _with_broker(p)
    broker.send(0, "old", "ignored")
    sdf = (p.session.readStream.format("kafka")
           .option("subscribe", "events")
           .option("startingOffsets", "latest").load())
    q = (sdf.select("value").writeStream.format("memory")
         .queryName("kq4").trigger(once=True).start())
    q.processAllAvailable()
    broker.send(0, "new", "seen")
    q.processAllAvailable()
    q.stop()
    return [p.rows("kq4")]


def test_kafka_starting_latest(pkgs):
    assert both(pkgs, _latest) == [[("seen",)]]


def _pruned(p):
    broker = _with_broker(p)
    broker.send(0, "a", "v")
    q = _start(p, "kq5")
    q.processAllAvailable()
    src = q._ex.source
    for i in range(20):
        broker.send(i % 2, None, f"m{i}")
        q.processAllAvailable()
    q.stop()
    return [len(src._snapshots), len(p.rows("kq5"))]


def test_kafka_snapshots_pruned_on_commit(pkgs):
    ref = both(pkgs, _pruned)
    assert ref[0] <= 3 and ref[1] == 21


class _FakeRecord:
    def __init__(self, offset, key, value, ts_ms):
        self.offset, self.timestamp = offset, ts_ms
        self.key = None if key is None else key.encode()
        self.value = value.encode()


class _FakeTP:
    def __init__(self, topic, partition):
        self.topic, self.partition = topic, partition

    def __hash__(self):
        return hash((self.topic, self.partition))

    def __eq__(self, o):
        return (self.topic, self.partition) == (o.topic, o.partition)


class _FakeConsumer:
    """The kafka-python KafkaConsumer surface the adapter uses; partition
    2 is a compacted log (offsets 0 and 5 survive)."""
    LOG = {0: [(0, "k0", "a"), (1, None, "b")], 1: [(0, "k1", "c")],
           2: [(0, "k2", "x"), (5, None, "y")]}
    ENDS = {0: 2, 1: 1, 2: 6}
    STALL = set()

    def __init__(self, bootstrap_servers=None, enable_auto_commit=True,
                 auto_offset_reset="latest"):
        assert enable_auto_commit is False
        assert auto_offset_reset == "none"
        self._pos = {}

    def partitions_for_topic(self, topic):
        return set(self.LOG)

    def end_offsets(self, tps):
        return {tp: self.ENDS[tp.partition] for tp in tps}

    def assign(self, tps):
        self._tp = tps[0]

    def seek(self, tp, off):
        self._pos[tp.partition] = off

    def position(self, tp):
        return self._pos.get(tp.partition, 0)

    def poll(self, timeout_ms=0):
        p = self._tp.partition
        if p in self.STALL:
            return {}
        start = self._pos.get(p, 0)
        recs = [_FakeRecord(off, k, v, 1_000 + off)
                for off, k, v in self.LOG[p] if off >= start]
        self._pos[p] = self.ENDS[p]
        return {self._tp: recs} if recs else {}


def test_kafka_python_adapter_mocked(pkgs, monkeypatch):
    fake = types.ModuleType("kafka")
    fake.KafkaConsumer = _FakeConsumer
    fake.TopicPartition = _FakeTP
    monkeypatch.setitem(sys.modules, "kafka", fake)
    got = []
    for p in pkgs:
        cli = p.kafka.KafkaPythonClient({"kafka.bootstrap.servers": "b:9092"})
        got.append([cli.partitions("t"), cli.latest_offsets("t"),
                    cli.fetch("t", 0, 0, 2), cli.fetch("t", 1, 0, 1),
                    cli.fetch("t", 2, 0, 6)])
        _FakeConsumer.STALL.add(0)
        try:
            with pytest.raises(p.AnalysisException, match="stalled"):
                cli.fetch("t", 0, 0, 2)
        finally:
            _FakeConsumer.STALL.discard(0)
    assert got[0] == got[1]
    assert got[0][4] == [(0, "k2", "x", 1_000_000), (5, None, "y", 1_005_000)]


@pytest.mark.skipif(
    not os.environ.get("SPARK_TPU_KAFKA_BOOTSTRAP"),
    reason="set SPARK_TPU_KAFKA_BOOTSTRAP=host:port (and install "
           "kafka-python) to run against a live broker, as the JAX "
           "package's own test does")
def test_kafka_real_broker_roundtrip(pkgs):
    import uuid
    from kafka import KafkaProducer
    servers = os.environ["SPARK_TPU_KAFKA_BOOTSTRAP"]
    topic = f"spark-tpu-smoke-{uuid.uuid4().hex[:8]}"
    prod = KafkaProducer(bootstrap_servers=servers.split(","))
    for i in range(5):
        prod.send(topic, key=f"k{i}".encode(), value=f"v{i}".encode())
    prod.flush()
    for p in pkgs:
        p.kafka.set_client_factory(None)
        sdf = (p.session.readStream.format("kafka")
               .option("kafka.bootstrap.servers", servers)
               .option("subscribe", topic)
               .option("startingOffsets", "earliest").load())
        q = (sdf.select("value").writeStream.format("memory")
             .queryName("kreal").trigger(once=True).start())
        q.processAllAvailable()
        assert sorted(r[0] for r in p.session.sql(
            "SELECT * FROM kreal").collect()) == [f"v{i}" for i in range(5)]
        q.stop()
