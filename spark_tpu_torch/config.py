"""Typed configuration registry of the PyTorch engine.

The ``ConfigEntry``/``Conf`` machinery of ``spark_tpu/config.py`` (the
analog of ``SparkConf.scala`` + ``ConfigBuilder.scala`` + ``SQLConf.scala``)
with the entries the single-device DataFrame path and the mesh lane read.
Key names are
the JAX package's, so one conf dict configures a session of either
package; ``spark.torch.device`` is the port's own.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generic, Optional, TypeVar

T = TypeVar("T")

_REGISTRY: Dict[str, "ConfigEntry"] = {}


class ConfigEntry(Generic[T]):
    def __init__(self, key: str, default: T, value_type: type,
                 doc: str = "", validator: Optional[Callable[[T], bool]] = None,
                 fallback: Optional["ConfigEntry"] = None):
        self.key = key
        self.default = default
        self.value_type = value_type
        self.doc = doc
        self.validator = validator
        self.fallback = fallback
        if key in _REGISTRY:
            raise ValueError(f"duplicate config key {key}")
        _REGISTRY[key] = self

    def parse(self, raw: Any) -> T:
        if isinstance(raw, str):
            if self.value_type is bool:
                low = raw.strip().lower()
                if low in ("true", "1", "yes"):
                    v = True
                elif low in ("false", "0", "no"):
                    v = False
                else:
                    raise ValueError(f"invalid boolean {raw!r} for config {self.key}")
            elif self.value_type in (int, float):
                v = self.value_type(raw.strip())
            else:
                v = raw
        else:
            v = self.value_type(raw) if raw is not None else raw
        if self.validator is not None and not self.validator(v):
            raise ValueError(f"invalid value {v!r} for config {self.key}")
        return v  # type: ignore[return-value]


class ConfigBuilder:
    """Fluent builder mirroring ``ConfigBuilder.scala``."""

    def __init__(self, key: str):
        self.key = key
        self._doc = ""
        self._validator: Optional[Callable] = None
        self._fallback: Optional[ConfigEntry] = None

    def doc(self, text: str) -> "ConfigBuilder":
        self._doc = text
        return self

    def check(self, fn: Callable[[Any], bool]) -> "ConfigBuilder":
        self._validator = fn
        return self

    def fallback(self, entry: ConfigEntry) -> "ConfigBuilder":
        self._fallback = entry
        return self

    def _make(self, default, value_type) -> ConfigEntry:
        return ConfigEntry(self.key, default, value_type, self._doc,
                           self._validator, self._fallback)

    def boolean(self, default: bool) -> ConfigEntry:
        return self._make(default, bool)

    def int(self, default: int) -> ConfigEntry:
        return self._make(default, int)

    def float(self, default: float) -> ConfigEntry:
        return self._make(default, float)

    def string(self, default: Optional[str]) -> ConfigEntry:
        return self._make(default, str)


def conf(key: str) -> ConfigBuilder:
    return ConfigBuilder(key)


class Conf:
    """A mutable configuration: overrides on top of registered defaults
    (the ``SparkConf`` and ``RuntimeConfig`` roles in one object)."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._overrides: Dict[str, Any] = dict(overrides or {})

    def clone(self) -> "Conf":
        return Conf(self._overrides)

    def set(self, key_or_entry, value: Any) -> "Conf":
        key = key_or_entry.key if isinstance(key_or_entry, ConfigEntry) else key_or_entry
        self._overrides[key] = value
        return self

    def unset(self, key: str) -> None:
        self._overrides.pop(key, None)

    def get(self, key_or_entry, default: Any = None) -> Any:
        if isinstance(key_or_entry, ConfigEntry):
            entry = key_or_entry
        else:
            entry = _REGISTRY.get(key_or_entry)
            if entry is None:
                return self._overrides.get(key_or_entry, default)
        if entry.key in self._overrides:
            return entry.parse(self._overrides[entry.key])
        if entry.fallback is not None and entry.fallback.key in self._overrides:
            return self.get(entry.fallback)
        return entry.default

    def __getitem__(self, entry: ConfigEntry) -> Any:
        return self.get(entry)

    def items(self):
        return dict(self._overrides).items()


# ---------------------------------------------------------------------------
# Entries of the single-device DataFrame path
# ---------------------------------------------------------------------------

APP_NAME = conf("spark.app.name").doc("Application name.").string("spark-tpu")

MASTER = conf("spark.master").doc(
    "Execution target, as the reference names it: local[*] or tpu.  The "
    "port reads no value of it: the card a session runs on is "
    "spark.torch.device, and the mesh's cards come from "
    "spark.tpu.mesh.shards.  Its default is the reference's, so one conf "
    "dict answers the same in both packages."
).string("tpu")

DEFAULT_PARALLELISM = conf("spark.default.parallelism").doc(
    "Default number of partitions for RDDs and shuffles."
).int(8)

SHUFFLE_PARTITIONS = conf("spark.sql.shuffle.partitions").doc(
    "Number of logical shuffle buckets for exchanges (SQLConf analog)."
).int(8)

BATCH_CAPACITY = conf("spark.sql.execution.batch.capacity").doc(
    "Default device batch row capacity (padded, static shape)."
).int(1 << 16)

SESSION_TIME_ZONE = conf("spark.sql.session.timeZone").string("UTC")

SPECULATION = conf("spark.speculation").boolean(False)

MAX_RESULT_ROWS = conf("spark.driver.maxResultRows").doc(
    "Safety cap on collect() row counts (maxResultSize analog)."
).int(1 << 26)

EAGER_EVAL = conf("spark.sql.repl.eagerEval.enabled").boolean(False)

CROSS_JOIN_ENABLED = conf("spark.sql.crossJoin.enabled").boolean(True)

TORCH_DEVICE = conf("spark.torch.device").doc(
    "torch device every batch of the session lives on and every kernel "
    "runs on: 'cuda' (the default; a session refuses to start when no "
    "card is visible), 'cuda:N', or 'cpu' (tests, where kernels run "
    "their plain PyTorch versions)."
).string("cuda")

JOIN_OUTPUT_FACTOR = conf("spark.sql.join.outputCapacityFactor").doc(
    "Static output capacity of an equi-join as a multiple of the probe-side "
    "capacity; overflow is detected and reported (dynamic-shape escape hatch)."
).float(1.0)

AGG_OUTPUT_ROWS = conf("spark.sql.agg.outputCapacity").doc(
    "Static output capacity of keyed aggregate/distinct results when the "
    "input batch is larger: the group table is sliced to this many rows "
    "so a downstream sort/join does not pay full-input-capacity work for "
    "a handful of live groups.  An overflow flag + adaptive retry grows "
    "it when the true group count exceeds it."
).int(1 << 16)

JOIN_OUTPUT_MAX_ROWS = conf("spark.sql.join.maxOutputRows").doc(
    "Upper bound on an ADAPTIVELY GROWN join output allocation (probe "
    "capacity x grown factor, in rows): beyond it the query fails with "
    "an actionable error instead of attempting an allocation that "
    "exhausts memory."
).int(1 << 27)

MESH_SHARDS = conf("spark.tpu.mesh.shards").doc(
    "Number of mesh shards for distributed execution.  n > 1 runs every "
    "query as n shards of one SPMD program (parallel/executor.py), placed "
    "on the visible cards from the session's (spark.torch.device) as the "
    "reference places them on devs[:n]: shard s on card s * C // n, C = "
    "min(n, cards).  On one card every shard shares it and an exchange is "
    "one all-to-all kernel launch; on several, one launch on each "
    "receiving card between device-side barriers, reading peers over "
    "NVLink.  A CPU session keeps every shard on the CPU.  1 = the "
    "single-device lane.  0 = all visible cards (the reference's "
    "len(jax.devices())): 1 on one card or on the CPU, so there the "
    "single-device lane stays the default unless shards are asked for."
).int(0)

AUTO_BROADCAST_JOIN_THRESHOLD = conf("spark.sql.autoBroadcastJoinThreshold").doc(
    "Max estimated row count of a relation that will be broadcast for joins "
    "on the mesh lane (the reference uses bytes; rows here because "
    "columnar batches make row counts the natural stat)."
).int(1 << 22)

EXCHANGE_SKEW_FACTOR = conf("spark.sql.exchange.skewFactor").doc(
    "Per-destination bucket capacity of an all-to-all exchange as a "
    "multiple of the even split (capacity/num_shards); overflow is "
    "detected at run time and retried with a grown factor."
).float(4.0)

ADAPTIVE_ENABLED = conf("spark.sql.adaptive.enabled").doc(
    "Adaptive exchanges (ExchangeCoordinator analog, in-program): hash "
    "exchanges route through a measured balanced fine-bucket→shard "
    "assignment (coalescing + balancing), and shuffled joins split hot "
    "keys (probe rows spread, build rows replicate)."
).boolean(True)

EXCHANGE_FINE_BUCKETS = conf("spark.tpu.exchange.fineBucketsPerShard").doc(
    "Fine buckets PER SHARD for adaptive hash exchanges; their psum'd "
    "counts drive the balanced bucket→shard assignment."
).int(32)

EXCHANGE_SPREAD_FRAC = conf("spark.tpu.exchange.spreadThreshold").doc(
    "A fine bucket whose probe-side row count exceeds this fraction of "
    "the per-shard even share is HOT in a shuffled join: its probe rows "
    "spread round-robin and its build rows replicate to every shard."
).float(0.5)

ANALYSIS_VERIFY_PLANS = conf("spark.tpu.analysis.verifyPlans").doc(
    "Plan-invariant verification (analysis.verify_plan) plus the "
    "cross-process exchange runtime checks. auto = on under pytest (the "
    "port's tests and the worker processes they start), off otherwise; "
    "on/off = explicit."
).string("auto")

CODEGEN_ENABLED = conf("spark.sql.codegen.wholeStage").doc(
    "Run each planned single-device query as one compiled program "
    "(WholeStageCodegen analog): on a card, one CUDA graph captured once "
    "and replayed from the process-local stage cache "
    "(sql/stagecompile.py).  Off = the eager lane: every operator's "
    "kernels launched one by one from the host."
).boolean(True)

STAGE_FUSION = conf("spark.tpu.stage.fusion").doc(
    "Whole-stage capture: every single-device query runs as ONE program "
    "obtained from the process-local stage cache (sql/stagecompile.py), "
    "a replayed CUDA graph on a card.  Off drops to per-operator "
    "dispatch — one eager step per physical node, its flags read back "
    "after each — the baseline the graph lane is measured against."
).boolean(True)

STAGE_RUN_PLANES = conf("spark.tpu.stage.runPlanes").doc(
    "Run planes at the stage boundary: an eligible lazy run column (no "
    "NULLs, run table at most half the dense capacity after pow-2 "
    "padding) enters the stage as a fixed-capacity (run_values, "
    "run_lengths) plane instead of materializing dense.  Taught kernels "
    "(segmented filter, keyless count/sum/min/max, bare-column project) "
    "work at run granularity; every other operator expands the plane "
    "inside the stage by a cumulative-sum and searchsorted gather "
    "(counted in run_plane_expansions).  Off = every run column "
    "materializes dense at the boundary."
).boolean(True)

STAGE_CACHE_MAX_ENTRIES = conf("spark.tpu.stage.cacheMaxEntries").doc(
    "Entry bound of the process-local stage cache (LRU beyond it).  The "
    "cache is per PROCESS, not per session."
).int(256)

CASE_SENSITIVE = conf("spark.sql.caseSensitive").boolean(False)

METRICS_ENABLED = conf("spark.sql.metrics.enabled").doc(
    "Record per-operator output row counts (SQLMetrics analog). Adds one "
    "fetched scalar per operator to every query; off by default."
).boolean(False)

EVENT_LOG_DIR = conf("spark.eventLog.dir").doc(
    "Directory for JSON-lines query event logs (EventLoggingListener "
    "analog); empty = disabled."
).string("")


# ---------------------------------------------------------------------------
# The SQL server (server.py, serving/): the JAX package's entries and
# defaults
# ---------------------------------------------------------------------------

SERVER_MAX_CONCURRENT_STATEMENTS = conf(
    "spark.tpu.server.maxConcurrentStatements").doc(
    "Global cap on statements admitted and not yet finished (queued + "
    "running) across ALL server sessions.  Over the cap, POST /sql fails "
    "fast with a structured 429 + Retry-After instead of queueing "
    "unboundedly.  0 = unlimited."
).int(0)

SERVER_MAX_QUEUED_PER_SESSION = conf(
    "spark.tpu.server.maxQueuedPerSession").doc(
    "Cap on statements waiting on ONE server session's FIFO (running + "
    "queued).  A client hammering a single busy session gets 429s once "
    "its backlog is this deep.  0 = unlimited."
).int(64)

SERVER_MIN_HOST_HEADROOM = conf(
    "spark.tpu.server.admission.minHostHeadroomBytes").doc(
    "Host-memory-aware admission: when the session has a HostMemoryLedger "
    "(enableHostShuffle) and its free budget is below this many bytes, new "
    "statements are rejected with 429 until pressure clears (the floor "
    "doubles once a session has degraded into grace joins).  0 = off."
).int(0)

SERVER_STATEMENT_TIMEOUT = conf("spark.tpu.server.statementTimeout").doc(
    "Per-statement deadline in SECONDS, riding the cooperative cancel "
    "machinery: a statement still queued past its deadline is dropped, a "
    "running one is cancelled at its next cancellation checkpoint "
    "(before planning, between eager operators, before a graph "
    "replay).  0 = no deadline."
).float(0.0)

SERVER_MAX_STANDING_QUERIES = conf(
    "spark.tpu.server.maxStandingQueries").doc(
    "Cap on STANDING (streaming) queries registered across all server "
    "sessions.  A standing query is a long-lived tenant: it holds its "
    "admission slot from registration until stop, and each of its "
    "micro-batches passes a non-blocking headroom gate (deferred batches "
    "retry at the trigger interval).  Over the cap, POST /stream fails "
    "fast with 429 + Retry-After.  0 = unlimited."
).int(16)

SERVER_SESSION_TIMEOUT = conf("spark.tpu.server.sessionTimeout").doc(
    "Idle server-session TTL in SECONDS: sessions with no activity for "
    "this long are closed by the reaper.  0 = sessions never expire."
).float(3600.0)

SERVER_PLAN_CACHE_ENABLED = conf("spark.tpu.server.planCache.enabled").doc(
    "Cross-session plan cache of the SQL server: optimized logical plans "
    "are fingerprinted (literals slotted out) and each fingerprint keeps "
    "its physical plan and its stage-cache entry (the captured CUDA "
    "graph), shared across ALL server sessions."
).boolean(True)

SERVER_PLAN_CACHE_MAX_ENTRIES = conf(
    "spark.tpu.server.planCache.maxEntries").doc(
    "Entry bound of the serving plan cache (LRU beyond it)."
).int(256)

SERVER_PLAN_CACHE_MAX_BYTES = conf("spark.tpu.server.planCache.maxBytes").doc(
    "Byte bound of the serving plan cache: an entry's host plan (a fixed "
    "estimate per entry); its graph's device bytes are charged to the "
    "memory manager by the stage cache."
).int(256 << 20)


# -- the elastic worker pool (serving/pool.py) ------------------------------

SERVER_POOL_ENABLED = conf("spark.tpu.server.pool.enabled").doc(
    "Elastic worker pool: the SQL server runs a supervisor that derives "
    "a target pool size from the admission demand signal and reconciles "
    "it by starting real worker processes, each a session on the card "
    "(the dynamic-allocation analog).  Scale-down stops a worker's "
    "heartbeat and hands its block-service lease to the supervisor, "
    "never a drain barrier.  Off by default."
).boolean(False)

SERVER_POOL_MIN_WORKERS = conf("spark.tpu.server.pool.minWorkers").doc(
    "Floor of the elastic pool (0 = the pool may drain completely when "
    "idle)."
).check(lambda v: v >= 0).int(0)

SERVER_POOL_MAX_WORKERS = conf("spark.tpu.server.pool.maxWorkers").doc(
    "Ceiling of the elastic pool: never more live workers than this."
).check(lambda v: v >= 1).int(4)

SERVER_POOL_STATEMENTS_PER_WORKER = conf(
    "spark.tpu.server.pool.statementsPerWorker").doc(
    "Demand divisor of the pool policy: target = ceil((running + queued "
    "+ recently rejected) / this), clamped to [minWorkers, maxWorkers]."
).check(lambda v: v >= 1).int(2)

SERVER_POOL_SCALE_DOWN_ROUNDS = conf(
    "spark.tpu.server.pool.scaleDownRounds").doc(
    "Hysteresis: demand must sit below the pool size for this many "
    "CONSECUTIVE evaluations before the policy scales down."
).check(lambda v: v >= 1).int(3)

SERVER_POOL_COOLDOWN = conf("spark.tpu.server.pool.cooldownSeconds").doc(
    "Minimum seconds between pool resizes (up or down)."
).check(lambda v: v >= 0).float(2.0)

SERVER_POOL_POLL = conf("spark.tpu.server.pool.pollSeconds").doc(
    "Period of the supervisor's reconcile loop (demand sample, policy, "
    "spawn or reap)."
).check(lambda v: v > 0).float(0.25)

SERVER_POOL_HEADROOM = conf(
    "spark.tpu.server.pool.minHostHeadroomBytes").doc(
    "Host-memory clamp on scale-up: with free host budget below this, "
    "the policy never raises the target above the live count.  0 = off."
).check(lambda v: v >= 0).int(0)

SERVER_POOL_OFFLOAD = conf("spark.tpu.server.pool.offload").doc(
    "Route eligible admitted statements (SELECTs, no session temp views) "
    "to pool workers through the filesystem spool.  A miss (no live "
    "worker, timeout, worker error) runs the statement on the server's "
    "own session, on the same card."
).boolean(True)

COLLECT_MAX_LEN = conf("spark.tpu.collect.maxArrayLen").doc(
    "Static element capacity of collect_list/collect_set output arrays; "
    "larger groups truncate (static shapes need a bound).  Read when a "
    "query is planned, so it is part of the plan and of its stage key."
).int(128)


# ---------------------------------------------------------------------------
# File scans and the persistent catalog (io.py, sql/session.py Catalog)
# ---------------------------------------------------------------------------

MULTIBATCH_ENABLED = conf("spark.tpu.multibatch.enabled").doc(
    "Stream file scans larger than spark.tpu.scan.maxBatchRows through "
    "the out-of-core runners instead of one eager device batch: a chain "
    "of one-child operators over one file runs through the multi-batch "
    "runner (sql/multibatch.py), any other plan through the stage DAG "
    "(sql/stages.py).  The card holds one padded batch and its partial "
    "result at a time; host RAM, then disk, hold the rest.  False reads "
    "every file relation as one batch."
).boolean(True)

SCAN_MAX_BATCH_ROWS = conf("spark.tpu.scan.maxBatchRows").doc(
    "Row count per streamed scan batch; file relations above this row "
    "count take the out-of-core path instead of one eager device batch."
).int(1 << 20)

STAGES_ENABLED = conf("spark.tpu.stages.enabled").doc(
    "Run multi-relation plans over oversized file relations through the "
    "streamed stage DAG (grace hash joins, broadcast joins fused into "
    "the per-batch step, the cross-batch mergers as breakers) instead of "
    "one eager device batch."
).boolean(True)

SCAN_PREFETCH_BATCHES = conf("spark.tpu.scan.prefetchBatches").doc(
    "How many scan batches a background thread decodes ahead of the "
    "per-batch step.  0 disables the thread (a synchronous scan); -1 = "
    "auto: 2 on a cuda session, 0 when the step itself runs on the host "
    "CPU (where the decode thread would compete for the same cores)."
).int(-1)

SPILL_MEMORY_ROWS = conf("spark.tpu.spill.hostMemoryRows").doc(
    "Host-RAM row budget for multi-batch intermediates (sorted runs, "
    "concatenated spine output, grace buckets); beyond it, runs spill to "
    "disk under spark.tpu.spill.dir."
).int(1 << 24)

SPILL_DIR = conf("spark.tpu.spill.dir").doc(
    "Directory for spilled intermediate runs; empty = a directory per "
    "process under the system's temporary directory."
).string("")

AGG_FOLD_ROWS = conf("spark.tpu.multibatch.aggFoldRows").doc(
    "Accumulated partial-aggregate rows that trigger an intermediate "
    "buffer-merge fold during a multi-batch aggregation."
).int(1 << 18)

MULTIBATCH_CKPT = conf("spark.tpu.multibatch.checkpointDir").doc(
    "Directory for multi-batch run checkpoints (merger state + scan "
    "cursor); empty = no checkpointing.  A rerun of the same query over "
    "unchanged files resumes at the last checkpointed batch."
).string("")

MULTIBATCH_CKPT_INTERVAL = conf(
    "spark.tpu.multibatch.checkpointInterval").doc(
    "Scan batches between checkpoints when checkpointDir is set."
).int(32)

GRACE_AGG_BUCKETS = conf("spark.tpu.graceAgg.buckets").doc(
    "Key-hash spill buckets for grace hash aggregation (collect_list/"
    "collect_set/percentile over a streamed scan); each bucket is "
    "aggregated on the host at the end."
).int(32)

GRACE_MAX_BUCKETS = conf("spark.tpu.join.graceMaxBuckets").doc(
    "Upper bound on grace-hash-join partition count per join; skewed "
    "buckets beyond batch capacity re-partition recursively with a salted "
    "hash, then fall back to a chunked probe/build loop."
).int(1024)

SHUFFLE_WIRE_CODEC = conf("spark.tpu.shuffle.wire.codec").doc(
    "Per-column byte codec of the framed columnar wire format (the "
    "SpilledRuns spill files): one of codec.CODECS ('none', 'zlib', "
    "'lzma', 'bz2').  Applied per column buffer above "
    "compressThreshold, kept only when it shrinks the buffer."
).string("zlib")

SHUFFLE_WIRE_COMPRESS_THRESHOLD = conf(
    "spark.tpu.shuffle.wire.compressThreshold").doc(
    "Column buffers at or above this many bytes are candidates for wire "
    "compression; smaller ones skip the codec call."
).check(lambda v: v >= 0).int(1 << 20)

SHUFFLE_WIRE_RUN_CODES = conf("spark.tpu.shuffle.wire.runCodes").doc(
    "Run-length/delta encode eligible wire columns (a per-column "
    "sampled-benefit probe); a still-lazy run column ships its run "
    "table.  Receivers keep run-coded columns lazy (columnar."
    "RunColumnVector) into the receiving stage, where they enter as "
    "run planes (spark.tpu.stage.runPlanes)."
).boolean(True)

SHUFFLE_SPILL_THRESHOLD = conf("spark.tpu.shuffle.spillThresholdBytes").doc(
    "Raw bytes of sorted or concatenated runs held in host RAM before "
    "they spill to disk, beside spark.tpu.spill.hostMemoryRows; and, on "
    "the cross-process exchange, the raw bytes of one side's bucketed map "
    "output at or above which its partition slices spill to disk as wire "
    "frames that receivers are served from directly (fetched blocks at "
    "or above it land in run files too).  0 = the row budget alone, and "
    "an exchange spills only when the host ledger "
    "(spark.tpu.memory.hostBudget) cannot reserve a side."
).check(lambda v: v >= 0).int(0)

# -- the cross-process host shuffle (parallel/hostshuffle.py) --------------

SHUFFLE_WIRE_DICT_CODES = conf("spark.tpu.shuffle.wire.dictCodes").doc(
    "Ship each dictionary ONCE per (exchange, sender) in a framed sidecar "
    "and stamp blocks with an 8-byte fingerprint instead of repeating the "
    "word list in every block header.  Off = per-block inline "
    "dictionaries (always decodable)."
).boolean(True)

SHUFFLE_IO_MAX_RETRIES = conf("spark.tpu.shuffle.io.maxRetries").doc(
    "Re-read attempts for a missing/partial host-shuffle block before it "
    "is declared lost (spark.shuffle.io.maxRetries analog)."
).check(lambda v: v >= 0).int(3)

SHUFFLE_IO_RETRY_WAIT_MS = conf("spark.tpu.shuffle.io.retryWaitMs").doc(
    "Base wait between block re-read attempts; it grows exponentially per "
    "attempt with deterministic per-block jitter "
    "(spark.shuffle.io.retryWait analog)."
).check(lambda v: v >= 0).int(100)

SHUFFLE_IO_ATTEMPT_TIMEOUT_MS = conf(
    "spark.tpu.shuffle.io.attemptTimeoutMs").doc(
    "Cap on a SINGLE block retry cycle (backoff + re-read): the backoff "
    "never sleeps longer than this."
).check(lambda v: v > 0).int(2000)

SHUFFLE_IO_ASYNC_WRITE = conf("spark.tpu.shuffle.io.asyncWrite").doc(
    "Stage shuffle blocks through a background writer thread so encoding "
    "and disk writes overlap the caller's next step; commit() drains the "
    "queue before publishing the manifest.  Off = every put() writes "
    "synchronously."
).boolean(True)

SHUFFLE_IO_FETCH_THREADS = conf("spark.tpu.shuffle.io.fetchThreads").doc(
    "Concurrent block fetch+decode workers per exchange read (file reads "
    "and zlib release the interpreter lock).  1 = serial reads."
).check(lambda v: v >= 1).int(4)

SHUFFLE_IO_MAX_INFLIGHT = conf("spark.tpu.shuffle.io.maxInFlightBytes").doc(
    "Bound on the encoded bytes the fetch pool may hold in flight at once "
    "(spark.reducer.maxSizeInFlight analog); a single larger block still "
    "proceeds alone.  0 = unbounded."
).check(lambda v: v >= 0).int(64 << 20)

SHUFFLE_FETCH_RETRY_ENABLED = conf(
    "spark.tpu.shuffle.fetchRetryEnabled").doc(
    "Allow one re-barrier and re-read of an exchange after a lost block "
    "(a peer that committed before dying left its blocks on the shared "
    "filesystem).  Off = every lost block fails the query at once with "
    "ExchangeFetchFailed."
).boolean(True)

SHUFFLE_BLACKLIST_ENABLED = conf("spark.tpu.shuffle.blacklistEnabled").doc(
    "Exclude heartbeat-confirmed-dead peers from exchange barriers and "
    "remember them for the rest of the query (HealthTracker analog)."
).boolean(True)

RECOVERY_MAX_STAGE_RETRIES = conf("spark.tpu.recovery.maxStageRetries").doc(
    "Lineage recovery budget per statement (the DAGScheduler resubmit "
    "analog): when a cross-process exchange loses a peer past its block "
    "retries, the survivors agree on the loss in an epoch-tagged "
    "{xid}-recover round, re-plan ownership over the live set, re-read "
    "the lost partitions from their leaf recipes and re-execute the "
    "statement under a fresh epoch, up to this many times before the "
    "structured ExchangeFetchFailed propagates.  0 = every exhausted "
    "fetch aborts the statement, bounded.  Read at each statement, so a "
    "SET after enableHostShuffle holds."
).check(lambda v: v >= 0).int(1)

BLOCKSERVER_ENABLED = conf("spark.tpu.blockserver.enabled").doc(
    "Block service (the external-shuffle-service analog): the shuffle "
    "service hard-links every committed block, spill frame and dictionary "
    "sidecar into <root>/_blockstore/ and seals a per-sender registration "
    "record at commit.  A survivor whose peer died after registering "
    "ADOPTS that output (zero map re-execution); while the service is "
    "down the client degrades to peer-direct reads and lineage "
    "recovery.  Read when the service is built."
).boolean(False)

BLOCKSERVER_ORPHAN_TTL = conf("spark.tpu.blockserver.orphanTtlSeconds").doc(
    "TTL of the orphaned-block reaper: an exchange whose every owner lease "
    "has been silent this long (and whose files are as stale) is "
    "reclaimed, as are raw exchange dirs under swept shuffle roots.  "
    "Registered state dirs are reclaimed only after an explicit release "
    "plus this TTL."
).check(lambda v: v >= 0).int(3600)

BLOCKSERVER_GC_INTERVAL = conf("spark.tpu.blockserver.gcIntervalSeconds").doc(
    "Period of the block-service reaper thread the SQL server runs while "
    "started.  0 = reaper disabled."
).check(lambda v: v >= 0).int(60)

SHUFFLE_RANGE_SAMPLE_SIZE = conf("spark.tpu.shuffle.rangeSampleSize").doc(
    "Per-process, per-side number of join-key sample points published in "
    "the range exchange's sample round."
).check(lambda v: v >= 8).int(256)

SHUFFLE_TARGET_PARTITION_BYTES = conf(
    "spark.tpu.shuffle.targetPartitionBytes").doc(
    "Advisory reduce-partition size for cross-process shuffles "
    "(spark.sql.adaptive.advisoryPartitionSizeInBytes analog): adjacent "
    "fine partitions below it coalesce into one reducer.  0 = static "
    "contiguous assignment."
).check(lambda v: v >= 0).int(1 << 22)

SHUFFLE_FINE_PARTITIONS = conf("spark.tpu.shuffle.finePartitionsPerProc").doc(
    "Fine hash partitions PER PROCESS for cross-process shuffled joins; "
    "the manifest-driven coordinator coalesces them into at most "
    "n_processes contiguous reducer ranges."
).check(lambda v: v >= 1).int(8)

SHUFFLE_ICI_ENABLED = conf("spark.tpu.shuffle.ici.enabled").doc(
    "The cross-process device exchange tier: a join side's spans bound "
    "for peers in this process's device domain are packed into a device "
    "arena and each receiver pulls them with one launch of kernel K2 "
    "(CUDA IPC on a card; a shared-memory file under the shuffle root "
    "on the CPU), instead of riding wire blocks through the shuffle "
    "directory.  Each sender's choice rides its own arena sidecar and "
    "commit manifest; every control round (plan manifests, adaptive "
    "stats, recovery agreement) stays on the host tier, and an injected "
    "fault, a pack overflow or a lost peer folds that sender's spans "
    "back onto the host tier, counted (dcn_fallback_exchanges)."
).boolean(False)

SHUFFLE_ICI_MIN_BYTES = conf("spark.tpu.shuffle.ici.minBytes").doc(
    "Smallest AGREED side byte total (summed over the gathered plan-"
    "round manifests, so every process derives the same verdict) that "
    "takes the device tier; smaller sides stay on the host tier."
).check(lambda v: v >= 0).int(1 << 16)

SHUFFLE_ICI_TIER_OVERRIDE = conf("spark.tpu.shuffle.ici.tierOverride").doc(
    "Manual device-domain map: pipe-separated comma groups of process ids "
    "('0,1|2,3').  Empty = probe: live processes grouped by the card "
    "they run on (its UUID, published by every process at "
    "enableHostShuffle); on the CPU every process is its own domain."
).string("")

CROSSPROC_DEDUP_REPLICATED = conf("spark.tpu.crossproc.dedupReplicated").doc(
    "On the cross-process generic path, collapse leaf relations that are "
    "byte-identical across processes to ONE copy (replicated tables need "
    "no annotation).  Off = union semantics."
).boolean(True)

CROSSPROC_SHUFFLED_JOIN = conf("spark.tpu.crossproc.shuffledJoin").doc(
    "Cross-process shuffled hash join: an equi-join whose two sides BOTH "
    "hold partitioned leaves co-partitions both sides by join-key hash "
    "and joins each disjoint key range locally.  Off = gather."
).boolean(True)

CROSSPROC_SORT_MERGE_JOIN = conf("spark.tpu.crossproc.sortMergeJoin").doc(
    "Cross-process range-partitioned sort-merge join: eligible "
    "equi-joins agree on cut points through a sample round, exchange "
    "rows by key range as sorted runs, split skewed spans across "
    "reducers, and merge-join each span.  Off = hash or gather."
).boolean(True)

CROSSPROC_AUTO_BROADCAST = conf(
    "spark.tpu.crossproc.autoBroadcastThreshold").doc(
    "Cross-process broadcast join threshold in bytes: a partitioned join "
    "side whose global size is at most this AND under the other side's "
    "per-process share is gathered everywhere, and no co-partitioning "
    "exchange runs.  0 = never broadcast."
).check(lambda v: v >= 0).int(1 << 20)

CROSSPROC_ADAPTIVE_REPLAN = conf(
    "spark.tpu.crossproc.adaptiveReplan").doc(
    "Re-decide a hash/range join strategy at its stats barrier from the "
    "OBSERVED per-side totals (demotion to broadcast only), and record "
    "them in the session's StatsFeedback for later plan-time decisions.  "
    "Needs a positive autoBroadcastThreshold."
).boolean(True)

CROSSPROC_GRACE_BUCKETS = conf("spark.tpu.crossproc.graceBuckets").doc(
    "Grace-partition fan-out for the distributed join lanes' degraded "
    "mode: a reducer that cannot reserve its drained shard re-buckets "
    "both sides by join-key hash into this many spill files and joins "
    "bucket by bucket.  0 = post-exchange pressure stays a bounded "
    "HostMemoryError."
).check(lambda v: v >= 0).int(32)

WAREHOUSE_DIR = conf("spark.sql.warehouse.dir").doc(
    "Root directory for persistent (non-temp) tables and databases "
    "(CREATE TABLE ... USING, saveAsTable)."
).string("spark-warehouse")

CHECKPOINT_DIR = conf("spark.tpu.checkpoint.dir").doc(
    "Directory of DataFrame.checkpoint's parquet files; empty = "
    "<spark.sql.warehouse.dir>/_checkpoints."
).string("")
