"""Admission control for the multi-tenant SQL server (a port of
``spark_tpu/serving/admission.py``).

The reference bounds serving load at two layers: the thriftserver's
session/operation pools and the scheduler's backpressure.  Here the
whole policy lives in front of the statement queue: a submission is
either ADMITTED (and will run to completion or cooperative cancel) or
REJECTED immediately with a structured ``AdmissionRejected`` naming the
exhausted limit — never parked in an unbounded queue, never deadlocked
on a session lock, never partially executed.

Two limits, both read live from the server session's conf (so SET
tunes a running server):

* ``spark.tpu.server.maxConcurrentStatements`` — global cap on admitted
  and unfinished statements across all sessions;
* ``spark.tpu.server.maxQueuedPerSession`` — cap on one session's FIFO
  depth (running + queued), bounding a single hot client.

The card's memory is guarded by the memory pre-flight of every query
(``memory.MemoryManager``), not here.  The reference's host-headroom
limit (it reads a host memory ledger), its standing-query cap and the
demand signal its elastic pool reads come with the slices that bring
those parts.

The Retry-After hint is PER QUERY SHAPE when history exists: releases
tagged with a ``cost_key`` (the server derives one per normalized
statement text) feed a
per-shape duration EWMA, so a rejected tenant running a 50 ms point
lookup is not told to wait behind the global average of 30 s scans.
Shapes never seen fall back to the global EWMA of recent statement
durations — both scaled by the current backlog, a serving-quality
answer, not a constant."""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from .. import config as C

__all__ = ["AdmissionController", "AdmissionRejected"]


class AdmissionRejected(RuntimeError):
    """Structured fast-fail: which limit, what was observed, the cap,
    and a retry hint.  The HTTP layer maps this to 429 + Retry-After."""

    def __init__(self, limit: str, observed, cap, retry_after_s: float):
        super().__init__(
            f"admission rejected: {limit} exhausted "
            f"(observed {observed}, limit {cap}); retry after "
            f"~{retry_after_s:.0f}s")
        self.limit = limit
        self.observed = observed
        self.cap = cap
        self.retry_after_s = retry_after_s

    def to_json(self) -> Dict[str, Any]:
        return {"error": str(self), "limit": self.limit,
                "observed": self.observed, "cap": self.cap,
                "retryAfterSeconds": round(self.retry_after_s, 1)}


class AdmissionController:
    def __init__(self, conf,
                 queued_supplier: Optional[Callable[[], int]] = None):
        self._conf = conf
        # total FIFO depth across server sessions, read OUTSIDE the
        # admission lock (the server's supplier takes its own
        # registration lock; admission->registration is the established
        # order and stats must not create the reverse nesting)
        self._queued = queued_supplier or (lambda: 0)
        self._lock = threading.Lock()
        self.active = 0                # admitted, not yet released
        self.peak_active = 0
        self.admitted = 0
        self.rejected = 0
        self.rejected_by: Dict[str, int] = {}
        self._ewma_s = 0.05            # recent statement duration estimate
        self._shape_ewma_s: Dict[str, float] = {}   # per-cost-key estimate

    #: per-shape table bound — a serving process must not leak one entry
    #: per distinct literal-normalized statement forever
    MAX_SHAPES = 1024

    # -- policy --------------------------------------------------------
    def admit(self, session_queue_depth: int,
              cost_key: Optional[str] = None) -> None:
        """Admit one statement or raise ``AdmissionRejected``.  Callers
        MUST pair a successful admit with exactly one ``release``.
        ``cost_key`` identifies the statement's query shape; on
        rejection the Retry-After hint uses that shape's duration
        history when any exists."""
        conf = self._conf
        with self._lock:
            cap = int(conf.get(C.SERVER_MAX_CONCURRENT_STATEMENTS))
            if cap > 0 and self.active >= cap:
                self._reject("maxConcurrentStatements", self.active, cap,
                             cost_key)
            qcap = int(conf.get(C.SERVER_MAX_QUEUED_PER_SESSION))
            if qcap > 0 and session_queue_depth >= qcap:
                self._reject("maxQueuedPerSession",
                             session_queue_depth, qcap, cost_key)
            self.active += 1
            self.admitted += 1
            self.peak_active = max(self.peak_active, self.active)

    def _reject(self, limit: str, observed, cap,
                cost_key: Optional[str] = None) -> None:
        self.rejected += 1
        self.rejected_by[limit] = self.rejected_by.get(limit, 0) + 1
        raise AdmissionRejected(limit, observed, cap,
                                self._retry_after_locked(cost_key))

    def release(self, duration_s: Optional[float] = None,
                cost_key: Optional[str] = None) -> None:
        with self._lock:
            self.active = max(0, self.active - 1)
            if duration_s is not None and duration_s >= 0:
                self._ewma_s = 0.8 * self._ewma_s + 0.2 * duration_s
                if cost_key is not None:
                    prev = self._shape_ewma_s.get(cost_key)
                    self._shape_ewma_s[cost_key] = duration_s \
                        if prev is None \
                        else 0.8 * prev + 0.2 * duration_s
                    if len(self._shape_ewma_s) > self.MAX_SHAPES:
                        # drop an arbitrary old entry (insertion order):
                        # a bound, not an LRU — shapes churn slowly
                        self._shape_ewma_s.pop(
                            next(iter(self._shape_ewma_s)))

    def _retry_after_locked(self, cost_key: Optional[str] = None
                            ) -> float:
        # expected wait ≈ statements ahead of you × recent duration —
        # THIS SHAPE's recent duration when we have seen it before, the
        # global EWMA otherwise; floor of 1s keeps well-behaved clients
        # from hammering
        est = self._shape_ewma_s.get(cost_key) \
            if cost_key is not None else None
        if est is None:
            est = self._ewma_s
        return max(1.0, est * max(1, self.active))

    # -- introspection -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        try:
            queued = int(self._queued() or 0)
        except Exception:
            queued = 0
        with self._lock:
            out = {
                "admitted": self.admitted, "rejected": self.rejected,
                "active": self.active, "peakActive": self.peak_active,
                "rejectedBy": dict(self.rejected_by),
                "avgStatementMs": round(self._ewma_s * 1000, 1),
                "costShapes": len(self._shape_ewma_s),
                "demand": {
                    "running": self.active, "queued": queued,
                    "backlogSeconds": round(
                        self._ewma_s * (self.active + queued), 3),
                },
            }
        return out

    def metrics_source(self) -> Dict[str, Callable[[], Any]]:
        return {
            "admission_admitted": lambda: self.stats()["admitted"],
            "admission_rejected": lambda: self.stats()["rejected"],
            "admission_active": lambda: self.stats()["active"],
            "admission_peak_active": lambda: self.stats()["peakActive"],
        }
