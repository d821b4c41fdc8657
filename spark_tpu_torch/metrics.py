"""Metrics system: named gauge sources, polled on demand.

The source half of ``spark_tpu/metrics.py`` (the analog of the
reference's Dropwizard ``MetricsSystem`` with its ``metrics/source/``
per-component gauges): components register SOURCES (a name + a dict of
gauge callables) and ``snapshots()`` reads them all.  The SQL server
registers its ``serving`` source here and ``GET /status`` returns the
snapshots.  The sinks (console, CSV) and their polling thread come with
the observability slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

__all__ = ["MetricsSystem", "Source", "default_sources"]


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


class MetricsSystem:
    def __init__(self, conf=None):
        self.conf = conf
        self._sources: List[Source] = []

    def register_source(self, source: Source) -> None:
        self._sources.append(source)

    def snapshots(self) -> Dict[str, Dict[str, Any]]:
        return {s.name: s.snapshot() for s in self._sources}


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
