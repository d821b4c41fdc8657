"""Metrics system: named gauge sources × pluggable sinks.

The port of ``spark_tpu/metrics.py`` (the analog of the reference's
Dropwizard ``MetricsSystem`` with its ``metrics/source/`` per-component
gauges and ``metrics/sink/`` Console and CSV sinks): components register
SOURCES (a name + a dict of gauge callables); sinks poll them on demand
(``report``) or on a period (``start`` / ``stop``).  The SQL server
registers its ``serving`` source here and ``GET /status`` returns the
snapshots.  Query-level metrics stay on the listener bus and event log
(``session._post_event``).
"""

from __future__ import annotations

import csv
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import config as C

__all__ = ["MetricsSystem", "ConsoleSink", "CsvSink", "Source",
           "default_sources"]

METRICS_CONSOLE = C.conf("spark.tpu.metrics.console.enabled").doc(
    "Attach a console sink to the session metrics system "
    "(metrics/sink/ConsoleSink analog)."
).boolean(False)

METRICS_CSV_DIR = C.conf("spark.tpu.metrics.csv.dir").doc(
    "Directory for CSV metric snapshots (metrics/sink/CsvSink analog); "
    "empty = no CSV sink."
).string("")

METRICS_PERIOD = C.conf("spark.tpu.metrics.pollPeriodSeconds").doc(
    "Seconds between periodic sink reports when start() is called; "
    "report() always works on demand."
).int(10)


class Source:
    """A named set of gauges (callables returning numbers/strings)."""

    def __init__(self, name: str, gauges: Dict[str, Callable[[], Any]]):
        self.name = name
        self.gauges = dict(gauges)

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for g, fn in self.gauges.items():
            try:
                out[g] = fn()
            except Exception:
                out[g] = None
        return out


class ConsoleSink:
    def __init__(self, stream=None):
        self.stream = stream or sys.stderr

    def report(self, snapshots: Dict[str, Dict[str, Any]]) -> None:
        ts = time.strftime("%H:%M:%S")
        for source, gauges in snapshots.items():
            line = ", ".join(f"{k}={v}" for k, v in sorted(gauges.items()))
            print(f"[metrics {ts}] {source}: {line}", file=self.stream)


class CsvSink:
    """One CSV per source, a row per report (``CsvSink.scala`` layout)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def report(self, snapshots: Dict[str, Dict[str, Any]]) -> None:
        now = time.time()
        for source, gauges in snapshots.items():
            path = os.path.join(self.dir, f"{source}.csv")
            keys = sorted(gauges)
            header = ["timestamp"] + keys
            fresh = not os.path.exists(path)
            if not fresh:
                with open(path, newline="") as f:
                    old = next(csv.reader(f), None)
                if old != header:
                    # the gauge set changed: rotate rather than misalign
                    # the columns
                    os.replace(path, f"{path}.{int(now)}.old")
                    fresh = True
            with open(path, "a", newline="") as f:
                w = csv.writer(f)
                if fresh:
                    w.writerow(header)
                w.writerow([round(now, 3)] + [gauges[k] for k in keys])


class MetricsSystem:
    def __init__(self, conf=None):
        self.conf = conf
        self._sources: List[Source] = []
        self._sinks: List[Any] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if conf is not None:
            if conf.get(METRICS_CONSOLE):
                self._sinks.append(ConsoleSink())
            csv_dir = conf.get(METRICS_CSV_DIR)
            if csv_dir:
                self._sinks.append(CsvSink(csv_dir))

    # -- registry --------------------------------------------------------
    def register_source(self, source: Source) -> None:
        self._sources.append(source)

    def register_sink(self, sink) -> None:
        self._sinks.append(sink)

    def snapshots(self) -> Dict[str, Dict[str, Any]]:
        return {s.name: s.snapshot() for s in self._sources}

    # -- reporting -------------------------------------------------------
    def report(self) -> Dict[str, Dict[str, Any]]:
        """Snapshot every source and hand it to every sink (a failing
        sink never fails the caller)."""
        snaps = self.snapshots()
        for sink in self._sinks:
            try:
                sink.report(snaps)
            except Exception:  # noqa: BLE001 — a sink never fails the job
                pass
        return snaps

    def start(self) -> None:
        """Report every ``spark.tpu.metrics.pollPeriodSeconds`` on a
        daemon thread until ``stop``; a no-op without sinks."""
        if self._thread is not None or not self._sinks:
            return
        self._stop.clear()             # start() after stop() must restart
        period = self.conf.get(METRICS_PERIOD) if self.conf else 10

        def loop():
            while not self._stop.wait(period):
                self.report()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="metrics-poller")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None


def default_sources(session) -> List[Source]:
    """The built-in process gauges the port has: device memory, cached
    relations, queries executed, the analysis checks, the process stage
    cache and the session's standing queries."""
    mem, cache = session._memory, session._cache
    from .sql.stagecompile import metrics_source as _stage_gauges
    return [
        Source("memory", {
            "hbm_budget_bytes": lambda: mem.budget,
            "execution_used_bytes": lambda: mem.execution_used,
            "storage_used_bytes": lambda: mem.storage_used,
            "free_bytes": lambda: mem.free,
        }),
        Source("cache", {
            "entries": lambda: len(cache.entries()),
            "device_entries": lambda: sum(
                1 for e in cache.entries() if e["level"] == "DEVICE"),
        }),
        Source("queries", {
            "executed": lambda: session._query_count,
        }),
        # the plan verifier's accounting (analysis.maybe_verify_*) and
        # the decision-trace backstop (analysis.runtime.
        # verify_decision_trace): a divergence means a process's decision
        # pipeline split from its peers and its exchange aborted
        Source("analysis", {
            name: (lambda name=name, zero=zero:
                   session._analysis_stats.get(name, zero))
            for name, zero in (("plans_verified", 0),
                               ("plan_verify_ms", 0.0),
                               ("decision_trace_checks", 0),
                               ("decision_trace_divergence", 0))
        }),
        # whole-stage capture: the process stage cache (build cost, hit
        # ratio, fusion width — CodegenMetrics analog)
        Source("compile", _stage_gauges()),
        Source("streaming", _streaming_gauges(session)),
    ]


def _streaming_gauges(session) -> Dict[str, Callable[[], Any]]:
    """Standing-query health, summed over the session's registered
    executions (``session._stream_execs``, read per sample): commits and
    replays, stage rebuilds, state residency and spill, the watermark
    and the rows evicted past it."""
    def execs():
        return list(getattr(session, "_stream_execs", None) or [])

    def total(key):
        return lambda: sum(int(ex.metrics.get(key, 0)) for ex in execs())

    gauges: Dict[str, Callable[[], Any]] = {
        "standing_queries": lambda: len(execs())}
    for key in ("batches_committed", "replayed_batches",
                "stage_rebuilds_last", "state_bytes", "state_rows",
                "spill_bytes", "spill_events", "evicted_rows"):
        gauges[key] = total(key)
    gauges["watermark_us"] = lambda: max(
        [int(ex.metrics.get("watermark_us", 0)) for ex in execs()] or [0])
    gauges["admission_deferred"] = total("admission_deferred")
    gauges["state_versions_spilled"] = lambda: sum(
        int(ex._fmgws_provider.versions_spilled)
        for ex in execs() if ex._fmgws_provider is not None)
    return gauges
