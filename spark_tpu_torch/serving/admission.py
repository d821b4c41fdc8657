"""Admission control for the multi-tenant SQL server (a port of
``spark_tpu/serving/admission.py``).

The reference bounds serving load at two layers: the thriftserver's
session/operation pools and the scheduler's backpressure.  Here the
whole policy lives in front of the statement queue: a submission is
either ADMITTED (and will run to completion or cooperative cancel) or
REJECTED immediately with a structured ``AdmissionRejected`` naming the
exhausted limit — never parked in an unbounded queue, never deadlocked
on a session lock, never partially executed.

Three limits, all read live from the server session's conf (so SET
tunes a running server):

* ``spark.tpu.server.maxConcurrentStatements`` — global cap on admitted
  and unfinished statements across all sessions;
* ``spark.tpu.server.maxQueuedPerSession`` — cap on one session's FIFO
  depth (running + queued), bounding a single hot client;
* ``spark.tpu.server.admission.minHostHeadroomBytes`` — when the session
  carries a ``memory.HostMemoryLedger`` (``enableHostShuffle``),
  statements are rejected while its free budget is below the floor; the
  floor doubles once a session has degraded into grace joins.

The card's memory is guarded by the memory pre-flight of every query
(``memory.MemoryManager``), not here.  ``demand_signal`` snapshots the
demand as a ``DemandSignal``, the elastic pool's one input
(``serving/pool.py``).  Standing (streaming) queries are long-lived
tenants: ``register_stream`` takes a slot under
``spark.tpu.server.maxStandingQueries`` and the headroom floor, held
until ``unregister_stream``, and each micro-batch passes the
non-raising-for-the-caller gate ``admit_stream_batch``.

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
from typing import Any, Callable, Dict, NamedTuple, Optional

from .. import config as C

__all__ = ["AdmissionController", "AdmissionRejected", "DemandSignal"]


class DemandSignal(NamedTuple):
    """One snapshot of serving demand, everything the elastic pool's
    policy reads.  ``running`` is admitted and unfinished statements,
    ``queued`` the FIFO depth behind them, ``rejected_recent`` the
    rejections since the previous snapshot, ``cost_ewma_s`` the recent
    statement duration and ``backlog_s`` its product with the demand.
    ``host_free`` is the host ledger's free budget (-1 = no ledger) and
    ``standing`` the registered standing (streaming) queries."""

    running: int = 0
    queued: int = 0
    rejected_recent: int = 0
    cost_ewma_s: float = 0.0
    backlog_s: float = 0.0
    host_free: int = -1
    standing: int = 0

    @property
    def demand(self) -> int:
        """Statements wanting service now: running + queued + what the
        caps just turned away."""
        return self.running + self.queued + self.rejected_recent


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
                 ledger_supplier: Optional[Callable[[], Any]] = None,
                 grace_supplier: Optional[Callable[[], int]] = None,
                 blockstore_supplier: Optional[Callable[[], Any]] = None,
                 queued_supplier: Optional[Callable[[], int]] = None):
        self._conf = conf
        self._ledger = ledger_supplier or (lambda: None)
        self._grace = grace_supplier or (lambda: 0)
        # the block service's store (or None): only observed, so one
        # /status shows disk ownership beside the admission counters
        self._blockstore = blockstore_supplier or (lambda: None)
        self._signal_rejected_mark = 0     # rejected at last demand_signal
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
        # standing (streaming) queries: long-lived tenants holding a slot
        # from register until unregister, with a per-micro-batch gate
        self.standing = 0
        self.peak_standing = 0
        self.streams_admitted = 0
        self.stream_batches = 0
        self.stream_batches_deferred = 0

    #: per-shape table bound — a serving process must not leak one entry
    #: per distinct literal-normalized statement forever
    MAX_SHAPES = 1024

    #: once a session has degraded into grace joins, the headroom floor
    #: is scaled by this: grace keeps queries correct under pressure but
    #: at spill speed, so the server sheds earlier
    GRACE_HEADROOM_FACTOR = 2.0

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
            self._check_headroom_locked(cost_key)
            self.active += 1
            self.admitted += 1
            self.peak_active = max(self.peak_active, self.active)

    def _check_headroom_locked(self, cost_key: Optional[str]) -> None:
        floor = int(self._conf.get(C.SERVER_MIN_HOST_HEADROOM))
        if floor <= 0:
            return
        try:
            degraded = int(self._grace() or 0)
        except Exception:
            degraded = 0
        if degraded > 0:
            floor = int(floor * self.GRACE_HEADROOM_FACTOR)
        ledger = self._ledger()
        if ledger is not None and ledger.free < floor:
            self._reject("hostMemoryHeadroom", int(ledger.free), floor,
                         cost_key)

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

    # -- standing (streaming) queries ------------------------------------
    def register_stream(self) -> None:
        """Admit one STANDING query, which holds its slot until
        ``unregister_stream``, or raise ``AdmissionRejected``: counts
        against ``spark.tpu.server.maxStandingQueries`` and the
        (grace-scaled) host-headroom floor."""
        with self._lock:
            cap = int(self._conf.get(C.SERVER_MAX_STANDING_QUERIES))
            if cap > 0 and self.standing >= cap:
                self._reject("maxStandingQueries", self.standing, cap)
            self._check_headroom_locked(None)
            self.standing += 1
            self.streams_admitted += 1
            self.peak_standing = max(self.peak_standing, self.standing)

    def unregister_stream(self) -> None:
        with self._lock:
            self.standing = max(0, self.standing - 1)

    def admit_stream_batch(self, cost_key: Optional[str] = None) -> None:
        """Per-micro-batch gate of a registered standing query: raises
        ``AdmissionRejected`` (with a shape-aware Retry-After) under host
        memory pressure; the caller defers the batch, which leaves no WAL
        entry and no state change."""
        with self._lock:
            self.stream_batches += 1
            try:
                self._check_headroom_locked(cost_key)
            except AdmissionRejected:
                self.stream_batches_deferred += 1
                raise

    # -- the demand signal (the elastic pool's input) -------------------
    def demand_signal(self) -> DemandSignal:
        """Snapshot serving demand.  Suppliers with locks of their own
        (queued depth, host ledger) are read OUTSIDE the admission lock;
        ``rejected_recent`` is the rejections since the previous call, so
        a burst is reported once."""
        try:
            queued = int(self._queued() or 0)
        except Exception:
            queued = 0
        host_free = -1
        try:
            ledger = self._ledger()
            if ledger is not None:
                host_free = int(ledger.free)
        except Exception:
            pass
        with self._lock:
            rejected_recent = self.rejected - self._signal_rejected_mark
            self._signal_rejected_mark = self.rejected
            running = self.active
            ewma = self._ewma_s
            standing = self.standing
        demand = running + queued + rejected_recent
        return DemandSignal(
            running=running, queued=queued,
            rejected_recent=rejected_recent,
            cost_ewma_s=ewma, backlog_s=ewma * demand,
            host_free=host_free, standing=standing)

    # -- introspection -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        store = None
        try:
            store = self._blockstore()
        except Exception:
            pass
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
                "graceDegraded": int(self._grace() or 0),
                "standingQueries": self.standing,
                "peakStandingQueries": self.peak_standing,
                "streamBatches": self.stream_batches,
                "streamBatchesDeferred": self.stream_batches_deferred,
                # a NON-consuming view of the demand signal (the delta
                # mark belongs to demand_signal's caller, the pool)
                "demand": {
                    "running": self.active, "queued": queued,
                    "rejectedSinceSignal":
                        self.rejected - self._signal_rejected_mark,
                    "backlogSeconds": round(
                        self._ewma_s * (self.active + queued), 3),
                },
            }
        if store is not None:
            out["blockStore"] = store.stats()
        return out

    def metrics_source(self) -> Dict[str, Callable[[], Any]]:
        return {
            "admission_admitted": lambda: self.stats()["admitted"],
            "admission_rejected": lambda: self.stats()["rejected"],
            "admission_active": lambda: self.stats()["active"],
            "admission_peak_active": lambda: self.stats()["peakActive"],
            "admission_standing_queries": lambda: self.standing,
            "admission_stream_batches_deferred":
                lambda: self.stream_batches_deferred,
        }
