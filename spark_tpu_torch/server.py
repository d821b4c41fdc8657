"""SQL-over-HTTP serving endpoint with multi-session support: a port of
``spark_tpu/server.py`` onto the card.

The serving role of the reference's `sql/hive-thriftserver` (HiveServer2:
`HiveThriftServer2.scala`, per-connection session handles in
`SparkSQLSessionManager.scala`, statement lifecycle + cancellation in
`SparkExecuteStatementOperation.scala:77`) re-based on the one wire
format every client already speaks: POST a SQL string, receive JSON rows.

Concurrency model: a bounded worker pool executes statements; each
server session wraps its own ``SparkSession.newSession()`` (isolated
temp views / conf — the Thrift session handle analog) with a per-session
lock making it single-writer, so DIFFERENT sessions run in parallel
while one session's statements stay serial.  Every session runs on the
root session's device: the card, unless the root session asks for the
CPU.  Cancellation is cooperative, like the reference's task
interruption: a statement checks its session's flag before planning,
after each eager operator and before a graph replay.

Multi-tenancy guards (serving/ package):

* every submission passes an ``AdmissionController`` BEFORE anything is
  registered — over global-concurrency, per-session-queue, or
  host-memory limits the client gets a structured 429 with Retry-After,
  never an unbounded queue entry;
* all server sessions share one ``PlanCache`` mapping optimized-plan
  fingerprints to planned queries and their captured graphs, so session
  B skips planning and capture for a statement session A already ran
  (responses carry ``cacheHit`` / ``planningSkippedMs``);
* per-statement deadlines (``spark.tpu.server.statementTimeout``) ride
  the cooperative-cancel machinery, and idle sessions are reaped after
  ``spark.tpu.server.sessionTimeout`` seconds;
* a statement whose cross-process exchange lost a peer past its
  in-query recovery budget (``ExchangeFetchFailed``) is re-admitted ONCE,
  transparently, over the surviving live set (``statement_readmits``);
* when the root session's host shuffle runs the block service, the
  server runs its orphan reaper (``parallel/blockserver.BlockServer``)
  while started;
* with ``spark.tpu.server.pool.enabled`` an elastic worker pool
  (``serving/pool.py``) grows and shrinks with the admission demand, and
  eligible SELECTs are offloaded to its workers (each a session on the
  card; replies carry ``pooled`` / ``poolWorker``).  A pool miss runs
  the statement on the server's own session, on the same card.

    python -m spark_tpu_torch.server --port 8123 --workers 4 &
    curl -d 'SELECT 1 AS x' localhost:8123/sql

Endpoints (Authorization: Bearer <token> required when a token is set
via --token or SPARK_TPU_SERVER_TOKEN):
    POST   /session             → {"sessionId"} (isolated temp views)
    DELETE /session/<id>        close a session
    POST   /sql                 body = SQL text or JSON {"query", ...,
                                "session": sid, "id": statement-id}
                                (or X-Session-Id / X-Statement-Id
                                headers) → {"columns", "rows",
                                "rowCount", "durationMs", "statementId",
                                "cacheHit", "planningSkippedMs"};
                                429 + Retry-After when admission rejects
    POST   /cancel              {"id": statement-id} → cooperative
                                cancel; queued statements are removed
                                from their session FIFO immediately
    GET    /statement/<id>      statement status (running/done/...)
    POST   /stream              register a STANDING incremental query:
                                {"session", "source": {"format", "path",
                                "schema"?, "options"?}, "watermark"?:
                                {"column", "delay"}, "sql"?, "view"?,
                                "select"?, "sink": {"format", "path"},
                                "mode"?, "checkpoint"?, "interval"?} →
                                {"streamId"}; with "sql" the stream is
                                the temp view "view" (default "stream")
                                of the session and the query is that
                                text over it.  The query is an admission
                                tenant (429 + Retry-After over
                                maxStandingQueries / headroom) and its
                                session is never idle-reaped while it
                                lives
    GET    /stream/<id>         standing-query status: batch id, commit/
                                replay/spill/watermark metrics, last
                                progress, the last trigger's time split,
                                deferral Retry-After
    DELETE /stream/<id>         stop a standing query, release its slot
    GET    /status              version, sessions, statements, per-
                                session queue depths, standing queries,
                                admission counters, plan-cache and
                                stage-cache stats, the metrics sources
"""

from __future__ import annotations

import collections
import hmac
import json
import os
import re
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from . import config as C
from .metrics import Source
from .serving import AdmissionController, AdmissionRejected, PlanCache

__all__ = ["SQLServer"]

_SQL_LITERALS = re.compile(r"'(?:[^']|'')*'|\b\d+(?:\.\d+)?\b")
_SQL_WS = re.compile(r"\s+")


def _cost_key(text: str) -> str:
    """Query-shape key for per-shape admission cost estimates: the
    statement with literals blanked and whitespace collapsed, so
    ``WHERE id = 7`` and ``WHERE id = 9`` share one duration history
    while a full-table scan keeps its own."""
    return _SQL_WS.sub(" ", _SQL_LITERALS.sub("?", text)).strip().lower()


def _json_safe(v: Any):
    if isinstance(v, float):
        # RFC 8259 has no NaN/Infinity literals; strict clients reject them
        if v != v:
            return None
        if v in (float("inf"), float("-inf")):
            return str(v)
        return v
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return str(v)


def _json_rows(batch, spec=None) -> list:
    """A result batch's rows in their JSON form, decoded by column
    (``ColumnBatch.decoded_columns``): the values ``[[_json_safe(v) for
    v in row] for row in df.collect()]`` gives (the JAX package's reply),
    without building a ``Row`` per row.  Only fractional columns can
    hold NaN or infinities, and only dates and timestamps become
    strings.  An array is a JSON list; with the assembly ``spec`` of
    ``DataFrame._flatten_complex``, a map is a JSON object and a struct
    a list of its fields."""
    import numpy as np

    from . import types as T
    cols, n = batch.decoded_columns()
    for v, vals in zip(batch.vectors, cols):
        dt = v.dtype
        if isinstance(dt, (T.DateType, T.TimestampType)):
            vals[:] = [None if x is None else str(x) for x in vals]
        elif isinstance(dt, T.ArrayType) and not (
                dt.element_type.is_integral or dt.element_type.is_string):
            vals[:] = [None if x is None else _json_safe(x) for x in vals]
        elif dt.is_fractional:
            # None becomes NaN here, and ``_json_safe(None)`` is None
            bad = ~np.isfinite(np.array(vals, dtype=np.float64))
            for i in np.flatnonzero(bad).tolist():
                vals[i] = _json_safe(vals[i])
    rows = [list(r) for r in zip(*cols)] if cols else [[] for _ in range(n)]
    if spec is None:
        return rows
    from .sql.dataframe import DataFrame
    return [[_json_value(x) for x in r]
            for r in DataFrame._assemble_rows(rows, spec)]


def _json_value(v: Any):
    """A collected map as a JSON object (keys as JSON strings), a struct
    as the list of its fields."""
    if isinstance(v, dict):
        return {str(k): _json_value(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return [_json_value(x) for x in v]
    return v


class _ServerSession:
    """One Thrift-session-handle analog: an isolated SparkSession plus the
    lock that makes it single-writer."""

    def __init__(self, session):
        self.session = session
        self.lock = threading.Lock()
        self.created = time.time()
        self.last_used = self.created
        # id of the statement currently executing on this session, guarded
        # by the server's _reg_lock: /cancel must only interrupt the
        # session when ITS target is the one running, not whatever
        # statement happens to hold the session lock by then
        self.running_stmt: Optional[str] = None
        # FIFO of (stmt, future, work) triples waiting on this session,
        # guarded by the server's _reg_lock.  A busy session drains its
        # queue on ONE pool slot (``draining`` marks the drainer alive) —
        # N statements stacked on one session must never pin N workers
        # while other sessions starve
        self.queue: collections.deque = collections.deque()
        self.draining = False
        # standing (streaming) queries registered on this session, keyed
        # by stream id: a session carrying one is ALWAYS live for the
        # idle reaper, however long since its last statement
        self.streams: Dict[str, Any] = {}


class _Statement:
    def __init__(self, stmt_id: str, session_id: str, query: str):
        self.id = stmt_id
        self.session_id = session_id
        self.query = query
        self.status = "queued"          # queued|running|done|error|cancelled
        self.cancel_requested = False
        self.submitted = time.time()


class SQLServer:
    def __init__(self, session, host: str = "127.0.0.1", port: int = 8123,
                 workers: int = 4, token: Optional[str] = None,
                 max_sessions: int = 64):
        self.session = session           # default/shared session
        self.host = host
        self.port = port
        self.token = token if token is not None \
            else os.environ.get("SPARK_TPU_SERVER_TOKEN") or None
        self.max_sessions = max_sessions
        self._default = _ServerSession(session)
        self._sessions: Dict[str, _ServerSession] = {}
        self._statements: Dict[str, _Statement] = {}
        self._reg_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=max(workers, 1),
                                        thread_name_prefix="sql-worker")
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # -- multi-tenant serving core: shared across ALL sessions -------
        self._admission = AdmissionController(
            session.conf_obj,
            lambda: getattr(session, "_host_ledger", None),
            grace_supplier=self._grace_total,
            blockstore_supplier=lambda: getattr(
                getattr(getattr(session, "_crossproc_svc", None),
                        "blockclient", None), "store", None),
            queued_supplier=self._queued_total)
        self._plan_cache: Optional[PlanCache] = None
        if session.conf_obj.get(C.SERVER_PLAN_CACHE_ENABLED):
            self._plan_cache = PlanCache(session.conf_obj)
        # the default session executes through the shared cache too
        session._plan_cache = self._plan_cache
        self._sessions_expired = 0
        self._stream_retry: Dict[str, float] = {}  # last deferral hints
        self._statement_readmits = 0     # transparent recovery re-admits
        self._reaper_stop = threading.Event()
        self._reaper: Optional[threading.Thread] = None
        # the block-service reaper, run while the server is started when
        # the root session's host shuffle has a block service
        self._blockserver = None
        # the elastic worker pool, started with the server when
        # spark.tpu.server.pool.enabled
        self._pool_supervisor = None
        self._register_metrics()

    @staticmethod
    def _grace_stats(session) -> Dict[str, int]:
        """One session's grace-mode activity, read off its host-shuffle
        counters (empty without host shuffle or grace)."""
        svc = getattr(session, "_crossproc_svc", None)
        counters = getattr(svc, "counters", None) if svc is not None \
            else None
        if not counters:
            return {}
        out = {k: int(counters.get(k, 0))
               for k in ("grace_buckets_used", "grace_spill_bytes",
                         "grace_salted_resplits", "reducers_elastic")}
        return out if any(out.values()) else {}

    @staticmethod
    def _ici_stats(session) -> Dict[str, int]:
        """One session's device-tier activity (sides shipped through the
        device arena, raw bytes packed, fold-backs onto the host tier, the
        agreed intra-domain peer count, K2 pulls and their bytes); empty
        without host shuffle or when the tier never engaged."""
        svc = getattr(session, "_crossproc_svc", None)
        counters = getattr(svc, "counters", None) if svc is not None \
            else None
        if not counters:
            return {}
        out = {k: int(counters.get(k, 0))
               for k in ("ici_exchanges", "ici_bytes_moved",
                         "dcn_fallback_exchanges", "tier_split_peers",
                         "ici_pulls", "ici_bytes_pulled")}
        return out if any(out.values()) else {}

    @staticmethod
    def _run_stats(session) -> Dict[str, int]:
        """One session's run-coded execution: columns shipped run-coded,
        wire bytes saved, and the process-wide run counters diffed
        against the service's birth; empty without host shuffle or when
        nothing moved."""
        svc = getattr(session, "_crossproc_svc", None)
        counters = getattr(svc, "counters", None) if svc is not None \
            else None
        if not counters:
            return {}
        from . import columnar as _col
        out = {k: int(counters.get(k, 0))
               for k in ("rle_columns_encoded", "run_bytes_saved")}
        base = getattr(svc, "_run_base", {})
        for k, v in _col.run_counters().items():
            out[k] = max(0, v - int(base.get(k, 0)))
        return out if any(out.values()) else {}

    def _grace_total(self) -> int:
        """Grace degradations across every session: admission's learned
        signal that running near the headroom floor now costs
        spill-speed joins."""
        try:
            with self._reg_lock:
                sessions = [ss.session for ss in self._sessions.values()]
            sessions.append(self.session)
            return sum(self._grace_stats(s).get("grace_buckets_used", 0)
                       for s in sessions)
        except Exception:
            return 0

    def _queued_total(self) -> int:
        """Total statements waiting on session FIFOs tier-wide — the
        ``queued`` component of the admission demand signal.  Takes only
        ``_reg_lock``; the admission controller consults it OUTSIDE its
        own lock."""
        try:
            with self._reg_lock:
                sessions = [self._default] + list(self._sessions.values())
                return sum(len(ss.queue) for ss in sessions)
        except Exception:
            return 0

    def _register_metrics(self) -> None:
        gauges = dict(self._admission.metrics_source())
        if self._plan_cache is not None:
            gauges.update(self._plan_cache.metrics_source())
        gauges["sessions_open"] = lambda: len(self._sessions)
        gauges["sessions_expired"] = lambda: self._sessions_expired
        gauges["statement_readmits"] = lambda: self._statement_readmits
        gauges["blockserver_attached"] = (
            lambda: int(self._blockserver is not None))
        gauges["blockserver_gc_runs"] = lambda: (
            self._blockserver.gc_runs if self._blockserver else 0)
        ms = self.session.metricsSystem
        # re-registering (e.g. a second SQLServer on the same session)
        # replaces rather than duplicates the sources
        ms._sources = [s for s in ms._sources
                       if s.name not in ("serving", "pool")]
        ms.register_source(Source("serving", gauges))

        def pool_counter(name):
            def get():
                sup = self._pool_supervisor
                return sup.counters.get(name, 0) if sup else 0
            return get

        ms.register_source(Source("pool", {k: pool_counter(k) for k in (
            "workers_spawned", "workers_reaped", "pool_target",
            "pool_live", "scale_decisions", "spawn_failures",
            "pool_statements_served", "offload_fallbacks")}))

    # -- session registry ------------------------------------------------
    def _open_session(self) -> str:
        with self._reg_lock:
            if len(self._sessions) >= self.max_sessions:
                raise RuntimeError(
                    f"session limit {self.max_sessions} reached")
            sess = self.session.newSession()
            sess._plan_cache = self._plan_cache   # shared plan cache
            # one standing-query registry across the whole tier
            if getattr(self.session, "_stream_execs", None) is None:
                self.session._stream_execs = []
            sess._stream_execs = self.session._stream_execs
            sid = uuid.uuid4().hex[:16]
            self._sessions[sid] = _ServerSession(sess)
        return sid

    def _close_session(self, sid: str) -> bool:
        with self._reg_lock:
            ss = self._sessions.pop(sid, None)
        if ss is None:
            return False
        self._release_session_streams(ss)
        ss.session.cancelAllQueries()
        ss.session._plan_cache = None
        return True

    def _release_session_streams(self, ss: _ServerSession) -> None:
        """Stop a departing session's standing queries and give their
        admission slots back: closing a session must not leak tenancy."""
        for stream_id, q in list(ss.streams.items()):
            try:
                q.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
            self._stream_retry.pop(stream_id, None)
            self._admission.unregister_stream()
        ss.streams.clear()

    def _resolve(self, sid: Optional[str]) -> _ServerSession:
        if not sid:
            return self._default
        ss = self._sessions.get(sid)
        if ss is None:
            raise KeyError(f"no such session {sid!r}")
        return ss

    def _expire_idle_sessions(self, now: Optional[float] = None) -> int:
        """Evict sessions idle longer than spark.tpu.server.sessionTimeout
        seconds.  Sessions with queued or running work are never touched —
        eviction must not lose admitted statements — and neither are
        sessions carrying a registered STANDING query: a stream triggers
        between client requests, so last_used says nothing about its
        liveness.  Returns the count."""
        ttl = float(self.session.conf_obj.get(C.SERVER_SESSION_TIMEOUT))
        if ttl <= 0:
            return 0
        if now is None:
            now = time.time()
        with self._reg_lock:
            victims = [(sid, ss) for sid, ss in self._sessions.items()
                       if not ss.queue and not ss.draining
                       and ss.running_stmt is None
                       and not ss.streams
                       and now - ss.last_used > ttl]
            for sid, _ss in victims:
                self._sessions.pop(sid, None)
            self._sessions_expired += len(victims)
        for _sid, ss in victims:
            ss.session.cancelAllQueries()
            ss.session._plan_cache = None
        return len(victims)

    def _reap_loop(self) -> None:
        while not self._reaper_stop.wait(5.0):
            try:
                self._expire_idle_sessions()
            except Exception:   # noqa: BLE001 — the reaper must survive
                pass

    # -- standing queries -------------------------------------------------
    def _start_stream(self, payload: Dict[str, Any]) -> dict:
        """Register a standing incremental query on a server session: an
        admission TENANT (``register_stream`` takes a slot held until
        DELETE /stream/<id>), each micro-batch then passing the batch
        gate; a deferred batch leaves no WAL entry."""
        from .sql.dataframe import DataFrame
        from .sql.planner import QueryExecution
        ss = self._resolve(payload.get("session"))
        src = payload.get("source") or {}
        sink = payload.get("sink") or {}
        if not src.get("path") or not sink.get("path"):
            raise ValueError("stream spec needs source.path and sink.path")
        # the slot is taken BEFORE anything starts: a rejected standing
        # query leaves no thread, no checkpoint dir, no registry entry
        self._admission.register_stream()
        try:
            reader = ss.session.readStream.format(
                src.get("format", "json"))
            if src.get("schema"):
                reader = reader.schema(src["schema"])
            for k, v in (src.get("options") or {}).items():
                reader = reader.option(k, v)
            df = reader.load(src.get("path"))
            wm = payload.get("watermark")
            if wm:
                df = df.withWatermark(wm["column"], wm["delay"])
            if payload.get("sql"):
                df.createOrReplaceTempView(payload.get("view", "stream"))
                text = ss.session.sql(payload["sql"])
                df = DataFrame(ss.session,
                               QueryExecution(ss.session,
                                              text._plan).analyzed)
            if payload.get("select"):
                df = df.select(*payload["select"])
            w = (df.writeStream.format(sink.get("format", "json"))
                 .outputMode(payload.get("mode", "append")))
            if payload.get("checkpoint"):
                w = w.option("checkpointLocation", payload["checkpoint"])
            w = w.trigger(
                processingTime=f"{float(payload.get('interval', 0.5))} "
                               "seconds")
            q = w.start(sink.get("path"))
        except Exception:
            self._admission.unregister_stream()
            raise
        return self.adopt_stream(payload.get("session"), q)

    def adopt_stream(self, sid: Optional[str], q) -> dict:
        """Wire a started StreamingQuery into the serving tier: the batch
        admission gate and the session's stream registry (reaper
        protection).  The caller owns the admission slot."""
        ss = self._resolve(sid)
        ex = q._ex
        key = f"stream:{ex.id[:8]}"

        def gate() -> bool:
            try:
                self._admission.admit_stream_batch(cost_key=key)
                self._stream_retry.pop(ex.id, None)
                return True
            except AdmissionRejected as e:
                self._stream_retry[ex.id] = e.retry_after_s
                return False

        ex._batch_admit = gate
        with self._reg_lock:
            ss.streams[ex.id] = q
        ss.last_used = time.time()
        return {"streamId": ex.id, "name": ex.name}

    def _find_stream(self, stream_id: str):
        with self._reg_lock:
            pool = [self._default] + list(self._sessions.values())
            for ss in pool:
                if stream_id in ss.streams:
                    return ss, ss.streams[stream_id]
        raise KeyError(f"no such stream {stream_id!r}")

    def _stream_status(self, stream_id: str) -> dict:
        _ss, q = self._find_stream(stream_id)
        ex = q._ex
        out = {"streamId": ex.id, "name": ex.name, "active": q.isActive,
               "batchId": ex.batch_id, "metrics": dict(ex.metrics),
               "lastProgress": q.lastProgress,
               "timings": dict(ex.timings)}
        if ex.exception is not None:
            out["error"] = \
                f"{type(ex.exception).__name__}: {ex.exception}"[:2000]
        retry = self._stream_retry.get(ex.id)
        if retry is not None:
            out["retryAfterSeconds"] = round(retry, 1)
        return out

    def _stop_stream(self, stream_id: str) -> dict:
        ss, q = self._find_stream(stream_id)
        q.stop()
        with self._reg_lock:
            ss.streams.pop(stream_id, None)
        self._stream_retry.pop(stream_id, None)
        self._admission.unregister_stream()
        ss.last_used = time.time()
        return {"stopped": stream_id,
                "batchesCommitted": q._ex.metrics["batches_committed"]}

    # -- statement execution ---------------------------------------------
    def _run_sql(self, text: str, sid: Optional[str],
                 stmt_id: Optional[str]) -> dict:
        from .parallel.hostshuffle import ExchangeFetchFailed

        ss = self._resolve(sid)          # unknown session → 404, nothing
        cost_key = _cost_key(text)
        # admission BEFORE registration: a rejected statement leaves no
        # trace — no registry entry, no queue slot, no partial execution
        with self._reg_lock:
            depth = len(ss.queue) + \
                (1 if (ss.running_stmt or ss.draining) else 0)
        # raises AdmissionRejected → 429; a known shape's Retry-After
        # comes from ITS duration history, not the global EWMA
        self._admission.admit(depth, cost_key=cost_key)
        admit_t = time.time()
        try:
            try:
                return self._run_admitted(ss, text, sid, stmt_id)
            except ExchangeFetchFailed:
                # a worker died and the in-query recovery spent its
                # budget (or was off): the exchange plane already agreed
                # the loss or blacklisted the peer, so ONE transparent
                # re-admit runs the statement over the survivors.  A
                # second fetch failure surfaces to the client.
                with self._reg_lock:
                    self._statement_readmits += 1
                return self._run_admitted(ss, text, sid, stmt_id)
        finally:
            # release feeds the EWMAs behind Retry-After with end-to-end
            # (queue + execute) latency — what a retrying client sees
            self._admission.release(time.time() - admit_t,
                                    cost_key=cost_key)

    def _offloadable(self, ss: _ServerSession, text: str) -> bool:
        """Pool-eligible statements: plain SELECTs over persistent
        tables only (a session temp view lives in this process, a worker
        cannot see it; anything else may change catalog state the
        session expects to observe)."""
        if self._pool_supervisor is None:
            return False
        if not ss.session.conf_obj.get(C.SERVER_POOL_OFFLOAD):
            return False
        if ss.session.catalog._views:
            return False
        return text.strip().lower().startswith("select")

    def _run_admitted(self, ss: _ServerSession, text: str,
                      sid: Optional[str], stmt_id: Optional[str]) -> dict:
        from .sql.session import QueryCancelled

        if self._offloadable(ss, text):
            # a miss (no live worker, timeout, worker error) returns None
            # and the statement runs in this session's FIFO, on the card
            out = self._pool_supervisor.execute(text)
            if out is not None:
                out.setdefault("statementId",
                               stmt_id or uuid.uuid4().hex[:16])
                ss.last_used = time.time()
                return out

        stmt = _Statement(stmt_id or uuid.uuid4().hex[:16], sid or "", text)
        with self._reg_lock:
            if stmt.id in self._statements and \
                    self._statements[stmt.id].status in ("queued", "running"):
                raise RuntimeError(f"statement id {stmt.id!r} already active")
            self._statements[stmt.id] = stmt
            self._evict_statements()
        ss.last_used = time.time()

        def work() -> dict:
            with ss.lock:                # session state is single-writer
                # order matters vs /cancel: the flag clears BEFORE the
                # status becomes observable as "running", and a cancel
                # that raced in is honored by the re-check after — a
                # /cancel acknowledged with 200 is never lost
                ss.session.clear_cancel()
                with self._reg_lock:
                    stmt.status = "running"
                    ss.running_stmt = stmt.id
                timer: Optional[threading.Timer] = None
                try:
                    if stmt.cancel_requested:
                        stmt.status = "cancelled"
                        raise QueryCancelled("cancelled before execution")
                    timeout_s = float(
                        ss.session.conf_obj.get(C.SERVER_STATEMENT_TIMEOUT))
                    if timeout_s > 0:
                        waited = time.time() - stmt.submitted
                        if waited >= timeout_s:
                            stmt.status = "cancelled"
                            raise QueryCancelled(
                                f"statement deadline {timeout_s:.1f}s "
                                f"exceeded while queued ({waited:.1f}s)")
                        # the deadline rides the cooperative-cancel
                        # machinery: when it fires mid-execution the next
                        # raise_if_cancelled checkpoint aborts the query
                        # (a graph already replaying finishes first)

                        def _deadline():
                            with self._reg_lock:
                                fire = ss.running_stmt == stmt.id
                            if fire:
                                stmt.cancel_requested = True
                                ss.session.cancelAllQueries()

                        timer = threading.Timer(timeout_s - waited,
                                                _deadline)
                        timer.daemon = True
                        timer.start()
                    ss.last_used = time.time()
                    t0 = time.time()
                    ss.session._last_plan_cache_info = None
                    df = ss.session.sql(stmt.query)
                    schema = df.schema
                    columns = list(schema.names)
                    flat, spec = df._flatten_complex(schema)
                    rows = _json_rows(flat._execute(), spec)
                    info = getattr(ss.session,
                                   "_last_plan_cache_info", None) or {}
                    return {"columns": columns, "rows": rows,
                            "rowCount": len(rows),
                            "durationMs":
                                round((time.time() - t0) * 1000, 1),
                            "statementId": stmt.id,
                            "cacheHit": bool(info.get("hit")),
                            "planningSkippedMs":
                                round(float(info.get("skippedMs", 0.0)), 1)}
                finally:
                    if timer is not None:
                        timer.cancel()
                    with self._reg_lock:
                        if ss.running_stmt == stmt.id:
                            ss.running_stmt = None

        # one pool slot per BUSY SESSION, not per statement: the work unit
        # joins the session's FIFO, and a drainer task is spawned only if
        # none is already running this session's queue.  The HTTP handler
        # thread (not a pool thread) blocks on the future, so a session
        # with a deep backlog cannot exhaust the worker pool.
        future: Future = Future()
        with self._reg_lock:
            ss.queue.append((stmt, future, work))
            spawn = not ss.draining
            if spawn:
                ss.draining = True
        if spawn:
            self._pool.submit(self._drain_session, ss)
        try:
            out = future.result()
            stmt.status = "done"
            return out
        except QueryCancelled:
            stmt.status = "cancelled"
            raise
        except Exception:
            if stmt.status != "cancelled":
                stmt.status = "error"
            raise

    def _drain_session(self, ss: _ServerSession) -> None:
        """Run one session's queued statements serially on this single
        worker slot; exits (clearing ``draining``) when the FIFO empties,
        holding ``_reg_lock`` for the check so no enqueue slips between
        'queue is empty' and 'drainer gone'."""
        while True:
            with self._reg_lock:
                if not ss.queue:
                    ss.draining = False
                    return
                _stmt, future, work = ss.queue.popleft()
            if not future.set_running_or_notify_cancel():
                continue
            try:
                future.set_result(work())
            except BaseException as e:  # noqa: BLE001 — deliver to waiter
                future.set_exception(e)

    _MAX_FINISHED_STATEMENTS = 1000

    def _evict_statements(self) -> None:
        """Cap the registry: drop oldest TERMINAL statements beyond the
        bound (caller holds _reg_lock) — a serving process must not leak
        one entry per request."""
        done = [s for s in self._statements.values()
                if s.status not in ("queued", "running")]
        excess = len(done) - self._MAX_FINISHED_STATEMENTS
        if excess > 0:
            for s in sorted(done, key=lambda s: s.submitted)[:excess]:
                self._statements.pop(s.id, None)

    def _cancel(self, stmt_id: str) -> dict:
        from .sql.session import QueryCancelled

        stmt = self._statements.get(stmt_id)
        if stmt is None:
            raise KeyError(f"no such statement {stmt_id!r}")
        stmt.cancel_requested = True
        try:
            ss: Optional[_ServerSession] = \
                self._resolve(stmt.session_id or None)
        except KeyError:      # session already closed; flag alone suffices
            ss = None
        removed = None
        fire = False
        if ss is not None:
            with self._reg_lock:
                # a QUEUED statement is cancelled synchronously: pulled
                # out of the FIFO here, its waiter resolved below — no
                # worker slot is ever spent on it
                for item in ss.queue:
                    if item[0] is stmt:
                        removed = item
                        break
                if removed is not None:
                    ss.queue.remove(removed)
                else:
                    # only interrupt the session if OUR statement is the
                    # one on it right now — between reading status and
                    # firing the cancel the target may have finished and
                    # a DIFFERENT statement started, and interrupting
                    # that innocent one would be the
                    # cancel-the-wrong-statement race
                    fire = ss.running_stmt == stmt_id
        if removed is not None:
            stmt.status = "cancelled"
            removed[1].set_exception(
                QueryCancelled("cancelled while queued"))
        elif fire:
            ss.session.cancelAllQueries()
        return {"statementId": stmt_id, "status": stmt.status,
                "cancelRequested": True}

    def _status(self) -> dict:
        with self._reg_lock:
            stmts = {s.id: s.status for s in self._statements.values()
                     if s.status in ("queued", "running")}
            n_sessions = len(self._sessions)
            queues = {sid: {"queued": len(ss.queue),
                            "running": ss.running_stmt is not None}
                      for sid, ss in self._sessions.items()}
            streams = {stream_id: {"session": sid, "active": q.isActive}
                       for sid, ss in [("default", self._default),
                                       *self._sessions.items()]
                       for stream_id, q in ss.streams.items()}
        out = {
            "version": self.session.version,
            "device": str(self.session.device),
            "queriesExecuted": self.session._query_count,
            "sessions": n_sessions,
            "sessionsExpired": self._sessions_expired,
            "activeStatements": stmts,
            "sessionQueues": queues,
            "standingQueries": streams,
            "admission": self._admission.stats(),
            "metrics": self.session.metricsSystem.snapshots(),
        }
        if self._plan_cache is not None:
            out["planCache"] = self._plan_cache.stats()
        for key, stats in (("graceActivity", self._grace_stats),
                           ("iciActivity", self._ici_stats),
                           ("runActivity", self._run_stats)):
            got = stats(self.session)
            if got:
                out[key] = got
        if self._blockserver is not None:
            out["blockStore"] = self._blockserver.stats()
        if self._pool_supervisor is not None:
            out["poolActivity"] = self._pool_supervisor.stats()
        from .sql.stagecompile import stage_cache
        out["stageCache"] = stage_cache().stats()
        return out

    # -- http plumbing ---------------------------------------------------
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *_a):      # quiet by default
                pass

            def _reply(self, code: int, payload: dict,
                       headers: Optional[Dict[str, str]] = None):
                body = json.dumps(payload, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _authed(self) -> bool:
                if server.token is None:
                    return True
                got = self.headers.get("Authorization", "")
                want = f"Bearer {server.token}"
                # constant-time compare: a == on secrets leaks a timing
                # oracle over the token prefix to anyone who can POST
                if hmac.compare_digest(got.encode(), want.encode()):
                    return True
                self._reply(401, {"error": "missing or bad bearer token"})
                return False

            def do_GET(self):
                if not self._authed():
                    return
                path = self.path.rstrip("/")
                if path in ("", "/status"):
                    self._reply(200, server._status())
                elif path.startswith("/statement/"):
                    stmt = server._statements.get(path.rsplit("/", 1)[1])
                    if stmt is None:
                        self._reply(404, {"error": "no such statement"})
                    else:
                        self._reply(200, {
                            "statementId": stmt.id, "status": stmt.status,
                            "submitted": stmt.submitted})
                elif path.startswith("/stream/"):
                    try:
                        self._reply(200, server._stream_status(
                            path.rsplit("/", 1)[1]))
                    except KeyError as e:
                        self._reply(404, {"error": str(e)})
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_DELETE(self):
                if not self._authed():
                    return
                path = self.path.rstrip("/")
                if path.startswith("/session/"):
                    sid = path.rsplit("/", 1)[1]
                    if server._close_session(sid):
                        self._reply(200, {"closed": sid})
                    else:
                        self._reply(404, {"error": f"no session {sid!r}"})
                elif path.startswith("/stream/"):
                    try:
                        self._reply(200, server._stop_stream(
                            path.rsplit("/", 1)[1]))
                    except KeyError as e:
                        self._reply(404, {"error": str(e)})
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if not self._authed():
                    return
                path = self.path.rstrip("/")
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n).decode("utf-8", "replace")
                payload: Dict[str, Any] = {}
                if raw.lstrip().startswith("{"):
                    try:
                        payload = json.loads(raw)
                    except json.JSONDecodeError:
                        payload = {}
                if path == "/session":
                    try:
                        self._reply(200, {"sessionId": server._open_session()})
                    except RuntimeError as e:
                        self._reply(429, {"error": str(e)})
                    return
                if path == "/stream":
                    try:
                        self._reply(200, server._start_stream(payload))
                    except AdmissionRejected as e:
                        self._reply(429, e.to_json(), headers={
                            "Retry-After": str(max(1, int(
                                e.retry_after_s + 0.999)))})
                    except KeyError as e:
                        self._reply(404, {"error": str(e)})
                    except Exception as e:  # noqa: BLE001 — to client
                        self._reply(400, {
                            "error": f"{type(e).__name__}: {e}"[:2000]})
                    return
                if path == "/cancel":
                    sid = payload.get("id") or \
                        self.headers.get("X-Statement-Id")
                    try:
                        self._reply(200, server._cancel(sid or ""))
                    except KeyError as e:
                        self._reply(404, {"error": str(e)})
                    return
                if path != "/sql":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                text = payload.get("query", "") if payload else raw
                sid = (payload.get("session")
                       or self.headers.get("X-Session-Id"))
                stmt_id = (payload.get("id")
                           or self.headers.get("X-Statement-Id"))
                if not isinstance(text, str) or not text.strip():
                    self._reply(400, {"error": "empty or non-string query"})
                    return
                from .sql.session import QueryCancelled
                try:
                    self._reply(200, server._run_sql(text, sid, stmt_id))
                except AdmissionRejected as e:
                    self._reply(429, e.to_json(), headers={
                        "Retry-After": str(max(1, int(e.retry_after_s
                                                      + 0.999)))})
                except QueryCancelled as e:
                    self._reply(499, {"error": f"cancelled: {e}",
                                      "statementId": stmt_id})
                except KeyError as e:
                    self._reply(404, {"error": str(e)})
                except Exception as e:    # noqa: BLE001 — surface to client
                    self._reply(400, {
                        "error": f"{type(e).__name__}: {e}"[:2000]})

        return Handler

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "SQLServer":
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]     # resolve port 0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"sql-server-{self.port}")
        self._thread.start()
        self._reaper_stop.clear()
        self._reaper = threading.Thread(
            target=self._reap_loop, daemon=True,
            name=f"sql-server-reaper-{self.port}")
        self._reaper.start()
        conf = self.session.conf_obj
        bc = getattr(getattr(self.session, "_crossproc_svc", None),
                     "blockclient", None)
        if bc is not None and self._blockserver is None:
            from .parallel.blockserver import BlockServer
            self._blockserver = BlockServer(
                bc.store, roots=(bc.store.root,),
                interval_s=float(conf.get(C.BLOCKSERVER_GC_INTERVAL)))
            self._blockserver.start()
        if conf.get(C.SERVER_POOL_ENABLED) and self._pool_supervisor is None:
            from .serving.pool import WorkerPoolSupervisor
            svc = getattr(self.session, "_crossproc_svc", None)
            warehouse = os.path.abspath(conf.get(C.WAREHOUSE_DIR))
            pool_root = os.path.join(
                getattr(svc, "root", None) or warehouse + "-ctl", "_pool")
            self._pool_supervisor = WorkerPoolSupervisor(
                pool_root, conf,
                demand_supplier=self._admission.demand_signal,
                warehouse=warehouse,
                blockstore_root=bc.store.root if bc is not None else None)
            self._pool_supervisor.start()
        return self

    def stop(self) -> None:
        self._reaper_stop.set()
        if self._reaper is not None:
            self._reaper.join(timeout=2.0)
            self._reaper = None
        if self._pool_supervisor is not None:
            self._pool_supervisor.stop()
            self._pool_supervisor = None
        if self._blockserver is not None:
            self._blockserver.stop()
            self._blockserver = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._pool.shutdown(wait=False, cancel_futures=True)
        with self._reg_lock:
            sessions = list(self._sessions.values())
        for ss in [self._default] + sessions:
            self._release_session_streams(ss)
        for ss in sessions:
            ss.session._plan_cache = None
        self.session._plan_cache = None
        ms = self.session.metricsSystem
        ms._sources = [s for s in ms._sources
                       if s.name not in ("serving", "pool")]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8123)
    ap.add_argument("--workers", type=int, default=4,
                    help="bounded statement worker pool size")
    ap.add_argument("--token", default=None,
                    help="shared-secret bearer token (or "
                    "SPARK_TPU_SERVER_TOKEN)")
    ap.add_argument("--device", default=None,
                    help=f"{C.TORCH_DEVICE.key} of every session (default "
                    "'cuda': the server refuses to start without a card; "
                    "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from .sql.session import SparkSession
    builder = SparkSession.builder.appName("sql-server")
    if args.device is not None:
        builder = builder.config(C.TORCH_DEVICE.key, args.device)
    session = builder.getOrCreate()
    srv = SQLServer(session, args.host, args.port, workers=args.workers,
                    token=args.token).start()
    auth = "token-protected" if srv.token else "no auth"
    print(f"spark_tpu_torch SQL server on http://{srv.host}:{srv.port} "
          f"({session.device}; {args.workers} workers, {auth}; POST /sql, "
          f"/session, /cancel; GET /status)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
