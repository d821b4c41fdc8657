"""DataStreamReader / DataStreamWriter / StreamingQueryManager
(``sql/streaming/DataStreamReader.scala``, ``DataStreamWriter.scala``,
``StreamingQueryManager.scala`` analogs)."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import types as T
from ..expressions import AnalysisException
from .core import (
    ConsoleSink, FileSink, FileStreamSource, ForeachBatchSink, MemorySink,
    RateStreamSource, StreamExecution, StreamingQuery, StreamingRelation,
)

__all__ = ["DataStreamReader", "DataStreamWriter", "StreamingQueryManager"]


class DataStreamReader:
    def __init__(self, session):
        self._session = session
        self._fmt = "parquet"
        self._schema: Optional[T.StructType] = None
        self._options: Dict[str, str] = {}

    def format(self, source: str) -> "DataStreamReader":
        self._fmt = source.lower()
        return self

    def schema(self, s) -> "DataStreamReader":
        if isinstance(s, str):
            fields = []
            for part in s.split(","):
                name, tname = part.strip().rsplit(" ", 1)
                fields.append(T.StructField(name.strip(),
                                            T.type_for_name(tname)))
            s = T.StructType(fields)
        self._schema = s
        return self

    def option(self, key, value) -> "DataStreamReader":
        self._options[str(key).lower()] = str(value)
        return self

    def load(self, path: Optional[str] = None):
        from ..sql.dataframe import DataFrame
        if self._fmt == "rate":
            rps = int(self._options.get("rowspersecond", "1"))
            src = RateStreamSource(rps)
        elif self._fmt == "socket":
            from .core import SocketSource
            host = self._options.get("host")
            port = self._options.get("port")
            if not host or not port:
                raise AnalysisException(
                    "socket source requires host and port options")
            src = SocketSource(host, int(port))
        elif self._fmt == "kafka":
            from .kafka import KafkaSource
            src = KafkaSource(self._options)
        else:
            if path is None:
                raise AnalysisException("streaming load() requires a path")
            src = FileStreamSource(self._fmt, path, self._schema,
                                   self._options)
        return DataFrame(self._session, StreamingRelation(src))

    def parquet(self, path: str):
        return self.format("parquet").load(path)

    def csv(self, path: str):
        return self.format("csv").load(path)

    def json(self, path: str):
        return self.format("json").load(path)

    def text(self, path: str):
        return self.format("text").load(path)


class DataStreamWriter:
    def __init__(self, df):
        self._df = df
        self._fmt = "memory"
        self._mode = "append"
        self._options: Dict[str, str] = {}
        self._name: Optional[str] = None
        self._trigger = 0.1
        self._foreach_fn = None

    def format(self, source: str) -> "DataStreamWriter":
        self._fmt = source.lower()
        return self

    def outputMode(self, mode: str) -> "DataStreamWriter":
        mode = mode.lower()
        if mode not in ("append", "complete", "update"):
            raise AnalysisException(f"unknown output mode {mode}")
        self._mode = mode
        return self

    def option(self, key, value) -> "DataStreamWriter":
        self._options[str(key).lower()] = str(value)
        return self

    def queryName(self, name: str) -> "DataStreamWriter":
        self._name = name
        return self

    def trigger(self, processingTime: Optional[str] = None,
                once: bool = False) -> "DataStreamWriter":
        if once:
            self._trigger = None
        elif processingTime:
            parts = processingTime.split()
            val = float(parts[0])
            unit = parts[1] if len(parts) > 1 else "seconds"
            if unit.startswith("milli"):
                val /= 1000.0
            self._trigger = val
        return self

    def foreachBatch(self, fn) -> "DataStreamWriter":
        self._foreach_fn = fn
        self._fmt = "foreachbatch"
        return self

    def start(self, path: Optional[str] = None) -> StreamingQuery:
        session = self._df.session
        checkpoint = self._options.get("checkpointlocation")
        if self._foreach_fn is not None:
            sink = ForeachBatchSink(self._foreach_fn, session)
        elif self._fmt == "memory":
            if not self._name:
                raise AnalysisException("memory sink requires queryName()")
            sink = MemorySink(self._name, session)
        elif self._fmt == "console":
            sink = ConsoleSink()
        elif self._fmt in ("parquet", "csv", "json", "text"):
            if path is None:
                raise AnalysisException("file sink requires a path")
            sink = FileSink(self._fmt, path, self._options)
        else:
            raise AnalysisException(f"unsupported sink format {self._fmt}")

        ex = StreamExecution(session, self._df._plan, sink, self._mode,
                             checkpoint, self._trigger or 0.1, self._name)
        q = StreamingQuery(ex)
        q._sink = sink
        StreamingQueryManager.add(session, q)
        if self._trigger is None:
            ex.process_all_available()     # Trigger.Once
        else:
            ex.start_thread()
        return q


class StreamingQueryManager:
    _lock = threading.Lock()
    _by_session: Dict[int, List[StreamingQuery]] = {}
    _instances: Dict[int, "StreamingQueryManager"] = {}

    def __init__(self, session):
        self._session = session

    @classmethod
    def get(cls, session) -> "StreamingQueryManager":
        with cls._lock:
            return cls._instances.setdefault(id(session), cls(session))

    @classmethod
    def add(cls, session, q: StreamingQuery) -> None:
        with cls._lock:
            cls._by_session.setdefault(id(session), []).append(q)

    @classmethod
    def remove(cls, q: StreamingQuery) -> None:
        with cls._lock:
            for lst in cls._by_session.values():
                if q in lst:
                    lst.remove(q)

    @property
    def active(self) -> List[StreamingQuery]:
        with self._lock:
            return [q for q in self._by_session.get(id(self._session), [])
                    if q.isActive]

    def awaitAnyTermination(self, timeout: Optional[float] = None) -> None:
        import time as _t
        t0 = _t.time()
        while self.active:
            if timeout is not None and _t.time() - t0 > timeout:
                return
            _t.sleep(0.05)
