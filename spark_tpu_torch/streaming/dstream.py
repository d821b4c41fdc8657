"""DStream compat shim over structured streaming (docs/DECISIONS.md).

The reference's legacy `streaming/` package (StreamingContext, DStream,
socketTextStream, foreachRDD) is deprecated upstream; this shim keeps the
most common idioms importable, executing them as structured queries.
"""

from __future__ import annotations

from typing import Callable, List


class DStream:
    """A discretized stream view over a structured streaming DataFrame."""

    def __init__(self, ssc: "StreamingContext", df):
        self._ssc = ssc
        self._df = df

    def map_df(self, fn) -> "DStream":
        """Transform the underlying DataFrame (structured-API escape hatch
        — per-record lambdas should use UDFs on the DataFrame)."""
        return DStream(self._ssc, fn(self._df))

    def foreachRDD(self, fn: Callable) -> None:
        """`fn(batch_df)` per micro-batch (foreachRDD's rows become a
        DataFrame — the structured foreachBatch contract)."""
        self._ssc._sinks.append((self._df, fn))


class StreamingContext:
    """`StreamingContext(sc, batchDuration)` analog; wraps a session."""

    def __init__(self, sparkContext=None, batchDuration: float = 1.0):
        from ..rdd.context import SparkContext
        from ..sql.session import SparkSession
        # a SparkContext's ``_session`` is a method: call it (the JAX
        # package takes the bound method itself as the session); any
        # other holder's ``_session`` attribute is the session itself
        if isinstance(sparkContext, SparkContext):
            self._session = sparkContext._session()
        elif sparkContext is not None and hasattr(sparkContext,
                                                  "_session"):
            self._session = sparkContext._session
        else:
            self._session = SparkSession.builder.getOrCreate()
        self.batchDuration = batchDuration
        self._sinks: List = []
        self._queries: List = []

    def socketTextStream(self, hostname: str, port: int) -> DStream:
        df = (self._session.readStream.format("socket")
              .option("host", hostname).option("port", port).load())
        return DStream(self, df)

    def textFileStream(self, directory: str) -> DStream:
        df = self._session.readStream.format("text").load(directory)
        return DStream(self, df)

    def start(self) -> None:
        for df, fn in self._sinks:
            q = (df.writeStream.foreachBatch(lambda b, _id, f=fn: f(b))
                 .trigger(processingTime=f"{self.batchDuration} seconds")
                 .start())
            self._queries.append(q)

    def awaitTerminationOrTimeout(self, timeout: float) -> bool:
        import time
        time.sleep(timeout)
        return False

    def stop(self, stopSparkContext: bool = False) -> None:
        for q in self._queries:
            try:
                q.stop()
            except Exception:
                pass
        self._queries = []
