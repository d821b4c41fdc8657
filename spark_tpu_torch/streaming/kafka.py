"""Kafka source: offset-range micro-batches over a pluggable client.

The mechanics of the reference's `connector/kafka-0-10-sql/.../
KafkaSource.scala`: each micro-batch is an OFFSET RANGE per topic
partition, the range endpoints are persisted in the offset WAL before
compute (exactly-once replay), and the batch materializes as the
standard kafka schema (key, value, topic, partition, offset, timestamp).

The broker protocol is behind ``KafkaClient``, a three-method
interface.  A real client (kafka-python, where installed; it is imported
only when the default factory runs) plugs in via ``set_client_factory``;
tests drive the full offset/WAL/replay machinery with an in-memory fake.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import types as T
from ..columnar import ColumnBatch
from ..expressions import AnalysisException
from .core import Source

__all__ = ["KafkaClient", "KafkaSource", "set_client_factory"]

KAFKA_SCHEMA = T.StructType([
    T.StructField("key", T.string),
    T.StructField("value", T.string),
    T.StructField("topic", T.string),
    T.StructField("partition", T.int32),
    T.StructField("offset", T.int64),
    T.StructField("timestamp", T.timestamp),
])


class KafkaClient:
    """Minimal broker interface (KafkaConsumer's three relevant calls)."""

    def partitions(self, topic: str) -> List[int]:
        raise NotImplementedError

    def latest_offsets(self, topic: str) -> Dict[int, int]:
        """partition -> next offset to be written (end of log)."""
        raise NotImplementedError

    def fetch(self, topic: str, partition: int, start: int, end: int
              ) -> List[Tuple[int, Optional[str], str, int]]:
        """Records [start, end) as (offset, key, value, timestamp_us).

        Offsets are the broker's REAL record offsets: compacted and
        transactional topics have gaps, so the range may legitimately
        return fewer than end-start records — but an implementation must
        never return a silently truncated range (raise instead), because
        the caller's offset WAL has already committed to [start, end)."""
        raise NotImplementedError


_client_factory: Optional[Callable[[Dict[str, str]], KafkaClient]] = None


def set_client_factory(factory: Optional[Callable]) -> None:
    """Install the broker client factory (options dict -> KafkaClient).
    Tests install an in-memory fake; deployments wrap a real consumer."""
    global _client_factory
    _client_factory = factory


def _default_factory(options: Dict[str, str]) -> KafkaClient:
    """The kafka-python adapter; without the client installed (an
    optional dependency) the source raises naming the two ways out."""
    try:
        from kafka import KafkaConsumer
    except ImportError:
        raise AnalysisException(
            "kafka source: no client installed and no client factory "
            "registered; install kafka-python or call "
            "spark_tpu_torch.streaming.kafka.set_client_factory(...)")
    return KafkaPythonClient(options, KafkaConsumer)


class KafkaPythonClient(KafkaClient):
    """kafka-python-backed broker client — the deployment adapter behind
    ``KafkaClient`` (the reference links its consumer the same way:
    `connector/kafka-0-10-sql/.../KafkaOffsetReaderConsumer.scala`).

    Auto-commit stays OFF: offset progress is owned by the engine's WAL
    (ranges are persisted before compute), never by the broker's
    consumer-group machinery — committing there would break exactly-once
    replay after restart.  The adapter is tested against a mocked module,
    and against a live broker when SPARK_TPU_KAFKA_BOOTSTRAP names one."""

    def __init__(self, options: Dict[str, str], consumer_cls=None):
        if consumer_cls is None:
            from kafka import KafkaConsumer as consumer_cls
        servers = options.get("kafka.bootstrap.servers") \
            or options.get("bootstrap.servers")
        if not servers:
            raise AnalysisException(
                "kafka source requires kafka.bootstrap.servers")
        # auto_offset_reset="none": the default ("latest") silently
        # RESETS position past a retention-expired range — the WAL
        # already committed to [start, end), so truncation must raise
        self._consumer = consumer_cls(
            bootstrap_servers=servers.split(","),
            enable_auto_commit=False,
            auto_offset_reset="none")

    def partitions(self, topic: str) -> List[int]:
        parts = self._consumer.partitions_for_topic(topic)
        return sorted(parts or [])

    def latest_offsets(self, topic: str) -> Dict[int, int]:
        from kafka import TopicPartition
        tps = [TopicPartition(topic, p) for p in self.partitions(topic)]
        return {tp.partition: off
                for tp, off in self._consumer.end_offsets(tps).items()}

    def fetch(self, topic: str, partition: int, start: int, end: int
              ) -> List[Tuple[int, Optional[str], str, int]]:
        from kafka import TopicPartition
        tp = TopicPartition(topic, partition)
        self._consumer.assign([tp])
        self._consumer.seek(tp, start)
        out: List[Tuple[int, Optional[str], str, int]] = []
        empty_polls = 0

        def _text(b) -> str:
            # surrogateescape is LOSSLESS: binary payloads (Avro,
            # protobuf) arrive surrogate-escaped and re-encode back to
            # the original bytes — never a mid-batch UnicodeDecodeError
            # wedging the stream on a poison record
            return b.decode("utf-8", "surrogateescape")

        # position(tp) advances past compacted/transactional gaps, so
        # reaching `end` is the loop invariant — NOT record count
        while self._consumer.position(tp) < end:
            try:
                polled = self._consumer.poll(timeout_ms=2000)
            except Exception as e:
                if "OffsetOutOfRange" in type(e).__name__:
                    raise AnalysisException(
                        f"kafka offsets [{start}, {end}) for "
                        f"{topic}/{partition} expired from broker "
                        "retention but are committed in the offset WAL "
                        "— exactly-once replay is impossible; reset the "
                        "checkpoint or extend broker retention") from e
                raise
            recs = polled.get(tp, [])
            if not recs:
                empty_polls += 1
                if empty_polls >= 5:
                    raise AnalysisException(
                        f"kafka fetch stalled at offset "
                        f"{self._consumer.position(tp)} of [{start}, "
                        f"{end}) for {topic}/{partition}; refusing to "
                        "skip records the offset WAL already committed "
                        "to — retry the batch when the broker recovers")
                continue
            empty_polls = 0
            for rec in recs:
                if rec.offset >= end:
                    break
                key = _text(rec.key) if rec.key is not None else None
                val = _text(rec.value) if rec.value is not None else ""
                out.append((rec.offset, key, val,
                            int(rec.timestamp) * 1000))        # ms→us
        return out


class KafkaSource(Source):
    """Offset-range micro-batches from one subscribed topic.

    The engine's Source protocol speaks ONE monotone int offset; Kafka
    speaks per-partition offsets.  The bridge is the reference's own
    trick (KafkaSourceOffset → JSON in the WAL): the public offset is
    the CUMULATIVE record count across partitions, and the per-partition
    map behind each public offset rides the offset WAL via
    offset_metadata/restore_offset_metadata, so a logged-but-uncommitted
    batch replays the exact same ranges after restart."""

    def __init__(self, options: Dict[str, str]):
        topic = options.get("subscribe")
        if not topic:
            raise AnalysisException("kafka source requires the "
                                    "'subscribe' option (one topic)")
        self.topic = topic
        factory = _client_factory or _default_factory
        self.client = factory(options)
        starting = options.get("startingoffsets", "earliest")
        if starting not in ("earliest", "latest"):
            raise AnalysisException(
                f"startingOffsets must be earliest|latest, got {starting}")
        if starting == "latest":
            base = dict(self.client.latest_offsets(topic))
        else:
            base = {p: 0 for p in self.client.partitions(topic)}
        #: public offset -> per-partition offset map
        self._snapshots: Dict[int, Dict[int, int]] = {0: base}
        self._base = base

    def schema(self) -> T.StructType:
        return KAFKA_SCHEMA

    def _total(self, offsets: Dict[int, int]) -> int:
        return sum(max(offsets.get(p, 0) - self._base.get(p, 0), 0)
                   for p in offsets)

    def get_offset(self) -> Optional[int]:
        latest = dict(self.client.latest_offsets(self.topic))
        for p in self._base:
            latest.setdefault(p, self._base[p])
        total = self._total(latest)
        if total == 0:
            return None
        self._snapshots[total] = latest
        return total

    def offset_metadata(self, start: Optional[int], end: int
                        ) -> Optional[dict]:
        return {"end_offsets": {str(p): o for p, o in
                                self._snapshots[end].items()},
                "base": {str(p): o for p, o in self._base.items()}}

    def restore_offset_metadata(self, start: Optional[int], end: int,
                                meta: dict) -> None:
        self._base = {int(p): o for p, o in meta["base"].items()}
        self._snapshots[0] = dict(self._base)
        self._snapshots[end] = {int(p): o
                                for p, o in meta["end_offsets"].items()}

    def commit(self, end: int) -> None:
        """Offsets ≤ end are durable: prune snapshots below the committed
        public offset (the reference purges KafkaSourceOffset state the
        same way) — a long-running stream must not accumulate one offset
        map per trigger."""
        floor = self._snapshots.get(end)
        if floor is None:
            return
        self._snapshots = {k: v for k, v in self._snapshots.items()
                           if k >= end}
        self._snapshots[0] = dict(self._base)
        self._snapshots[end] = floor

    def get_batch(self, start: Optional[int], end: int) -> ColumnBatch:
        s_map = self._snapshots.get(start or 0)
        e_map = self._snapshots.get(end)
        if s_map is None or e_map is None:
            raise AnalysisException(
                f"kafka offset snapshot missing for range ({start}, {end}] "
                "— WAL metadata not restored?")
        keys: List[Optional[str]] = []
        vals: List[str] = []
        parts: List[int] = []
        offs: List[int] = []
        tss: List[int] = []
        for p in sorted(e_map):
            lo = s_map.get(p, self._base.get(p, 0))
            hi = e_map[p]
            if hi <= lo:
                continue
            for off, k, v, ts in self.client.fetch(self.topic, p, lo, hi):
                keys.append(k)
                vals.append(v)
                parts.append(p)
                offs.append(off)   # REAL broker offset (gaps on
                tss.append(ts)     # compacted/transactional topics)
        if not vals:
            return ColumnBatch.empty(KAFKA_SCHEMA)
        return ColumnBatch.from_arrays({
            "key": keys,
            "value": vals,
            "topic": [self.topic] * len(vals),
            "partition": np.asarray(parts, np.int32),
            "offset": np.asarray(offs, np.int64),
            "timestamp": np.asarray(tss, np.int64),
        }, schema=KAFKA_SCHEMA)
