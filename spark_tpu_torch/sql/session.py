"""SparkSession: the entry point (``sql/SparkSession.scala:77`` analog).

The subset of ``spark_tpu/sql/session.py`` the port has: the builder,
the conf, the catalog (temp views, functions, and the persistent
databases and tables under ``spark.sql.warehouse.dir``), ``read``,
``createDataFrame``, ``range``, ``sql`` with its DDL and DML commands,
``udf`` and ``stop``.  The session
owns ONE torch device, named by
``spark.torch.device`` (default ``"cuda"``): every batch it creates lives
there and every query runs there.  Asking for a card that is not there
raises; the session never falls back to the CPU.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Union

import torch

from .. import config as C
from .. import types as T
from ..columnar import ColumnBatch
from ..expressions import AnalysisException
from . import logical as L
from .dataframe import DataFrame


class _ListenerManager:
    """Query-event fan-out (``LiveListenerBus`` in miniature): listeners
    are callables receiving event dicts; their failures are swallowed."""

    def __init__(self):
        self._listeners: List[Any] = []

    def register(self, fn) -> None:
        self._listeners.append(fn)

    def unregister(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass


class QueryCancelled(Exception):
    """Raised at a cancellation checkpoint after
    ``session.cancelAllQueries()`` — the cooperative analog of the
    reference's ``SparkContext.cancelJobGroup`` task interruption."""


def _pandas_columns(df) -> dict:
    """A pandas DataFrame's columns as numpy arrays, object and nullable
    extension columns as lists with None for NA (the reference's
    ``ColumnBatch.from_pandas``)."""
    data = {}
    for name in df.columns:
        s = df[name]
        if s.dtype == object or str(s.dtype) in ("string", "str") \
                or str(s.dtype).startswith(("Int", "Float", "boolean")):
            na = s.isna().to_numpy()
            data[str(name)] = [None if na[i] else v
                               for i, v in enumerate(s.tolist())]
        else:
            data[str(name)] = s.to_numpy()
    return data


def resolve_device(name: str) -> torch.device:
    """The session's device; a CUDA device that is not there raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{C.TORCH_DEVICE.key}={name!r} but torch.cuda.is_available() "
            "is False: no CUDA device is visible to this process.  The "
            "engine does not fall back to the CPU; set "
            f"{C.TORCH_DEVICE.key}=cpu explicitly to run on the host")
    return device


class Catalog:
    """Temp views + functions + PERSISTENT databases and tables
    (``SessionCatalog`` + ``InMemoryCatalog``): the filesystem IS the
    external catalog — ``<warehouse>/<db>.db/<table>/`` holds the data
    files and a ``_meta.json`` (format, schema, options, ANALYZE
    statistics), so there is no separate metastore to run.  Sessions that
    share a warehouse share its tables."""

    def __init__(self, session=None):
        self._session = session
        self._views: Dict[str, L.LogicalPlan] = {}
        self._functions: Dict[str, Any] = {}
        self.current_database = "default"

    # -- functions ---------------------------------------------------------
    def register_function(self, name: str, wrapper) -> None:
        self._functions[name.lower()] = wrapper

    def lookup_function(self, name: str):
        return self._functions.get(name.lower())

    def listFunctions(self) -> List[str]:
        return sorted(self._functions)

    # -- temp views ----------------------------------------------------------

    def register(self, name: str, plan: L.LogicalPlan) -> None:
        self._views[name.lower()] = plan

    def drop(self, name: str) -> bool:
        return self._views.pop(name.lower(), None) is not None

    dropTempView = drop

    # -- persistent layer ---------------------------------------------------
    def _warehouse(self) -> str:
        if self._session is not None:
            return self._session.conf.get(C.WAREHOUSE_DIR)
        return C.WAREHOUSE_DIR.default

    def _db_dir(self, db: str) -> str:
        wh = self._warehouse()
        return wh if db == "default" else os.path.join(wh, f"{db}.db")

    def _split(self, name: str):
        parts = name.split(".")
        if len(parts) == 2:
            return parts[0].lower(), parts[1].lower()
        return self.current_database, parts[0].lower()

    def table_path(self, name: str) -> str:
        db, tbl = self._split(name)
        return os.path.join(self._db_dir(db), tbl)

    def create_database(self, name: str, if_not_exists: bool = False) -> None:
        if name.lower() == "default":
            if if_not_exists:
                return
            raise AnalysisException("database default already exists")
        d = self._db_dir(name.lower())
        if os.path.isdir(d):
            if if_not_exists:
                return
            raise AnalysisException(f"database {name} already exists")
        os.makedirs(d, exist_ok=True)

    def drop_database(self, name: str, if_exists: bool = False) -> None:
        if name.lower() == "default":
            raise AnalysisException("cannot drop the default database")
        d = self._db_dir(name.lower())
        if not os.path.isdir(d):
            if if_exists:
                return
            raise AnalysisException(f"database not found: {name}")
        shutil.rmtree(d)

    def list_databases(self) -> List[str]:
        wh = self._warehouse()
        out = ["default"]
        if os.path.isdir(wh):
            out += sorted(f[:-3] for f in os.listdir(wh)
                          if f.endswith(".db")
                          and os.path.isdir(os.path.join(wh, f)))
        return out

    listDatabases = list_databases

    def setCurrentDatabase(self, name: str) -> None:
        if name.lower() not in self.list_databases():
            raise AnalysisException(f"database not found: {name}")
        self.current_database = name.lower()

    @staticmethod
    def _write_meta(path: str, meta: dict) -> None:
        with open(os.path.join(path, "_meta.json"), "w") as f:
            json.dump(meta, f, default=str)

    @staticmethod
    def _read_meta(path: str) -> Optional[dict]:
        meta_p = os.path.join(path, "_meta.json")
        if not os.path.isfile(meta_p):
            return None
        with open(meta_p) as f:
            return json.load(f)

    def save_table(self, name: str, df, fmt: str = "parquet",
                   mode: str = "error", options: Optional[dict] = None,
                   partition_by: Optional[List[str]] = None) -> None:
        """CTAS / saveAsTable: write the data files and ``_meta.json``."""
        from ..io import DataFrameWriter
        path = self.table_path(name)
        w = DataFrameWriter(df).format(fmt).mode(mode)
        if partition_by:
            w = w.partitionBy(*partition_by)
        for k, v in (options or {}).items():
            w = w.option(k, v)
        w.save(path)
        self._write_meta(path, {
            "format": fmt, "options": options or {},
            "schema": [[f.name, f.dataType.simpleString()]
                       for f in df.schema.fields]})

    def save_table_stats(self, name: str, stats: dict) -> bool:
        """Persist ANALYZE TABLE results into the table's ``_meta.json``;
        False when ``name`` is not a persistent table (a temp view keeps
        session-only statistics)."""
        path = self.table_path(name)
        meta = self._read_meta(path)
        if meta is None:
            return False
        meta["stats"] = stats
        self._write_meta(path, meta)
        return True

    def create_empty_table(self, name: str, schema: T.StructType,
                           fmt: str = "parquet") -> None:
        path = self.table_path(name)
        if os.path.isdir(path):
            raise AnalysisException(f"table {name} already exists")
        os.makedirs(path)
        self._write_meta(path, {
            "format": fmt, "options": {},
            "schema": [[f.name, f.dataType.simpleString()]
                       for f in schema.fields]})

    def drop_table(self, name: str, if_exists: bool = False) -> None:
        path = self.table_path(name)
        if not os.path.isdir(path):
            if if_exists:
                return
            raise AnalysisException(f"table not found: {name}")
        shutil.rmtree(path)

    def _persistent_plan(self, name: str) -> Optional[L.LogicalPlan]:
        path = self.table_path(name)
        meta = self._read_meta(path)
        if meta is None:
            return None
        schema = T.StructType([
            T.StructField(n, T.type_for_name(t)) for n, t in meta["schema"]])
        pats = {"parquet": "*.parquet", "csv": "*.csv", "json": "*.json",
                "text": "*.txt"}
        fmt = meta["format"]
        has_data = [p for p in _glob.glob(
            os.path.join(path, "**", pats.get(fmt, "*")), recursive=True)
            if not os.path.basename(p).startswith(("_", "."))]
        if not has_data:
            device = "cpu" if self._session is None else self._session.device
            return L.LocalRelation(ColumnBatch.empty(schema, device=device))
        rel = L.FileRelation(fmt, [path], schema,
                             dict(meta.get("options") or {}))
        if meta.get("stats"):
            # ANALYZE results persisted with the table are re-registered
            # ONLY while the files are unchanged since ANALYZE (the stats
            # carry the files+stat key they were gathered under)
            from .. import io as tio
            if meta["stats"].get("key") == tio.stats_key_token(rel):
                tio.register_analyzed_stats(rel, meta["stats"])
        return rel

    # -- unified lookup -----------------------------------------------------
    def lookup(self, name: str) -> L.LogicalPlan:
        key = name.lower()
        if key in self._views:
            return self._views[key]
        plan = self._persistent_plan(name)
        if plan is not None:
            return plan
        plan = self._file_format_plan(name)
        if plan is not None:
            return plan
        raise AnalysisException(f"Table or view not found: {name}")

    def _file_format_plan(self, name: str) -> Optional[L.LogicalPlan]:
        """``SELECT * FROM parquet.`/path``` — a file queried directly by
        its format-qualified path (``rules/ResolveSQLOnFile.scala:44``
        analog).  The parser delivers the identifier as
        ``<format>.<path>``."""
        fmt, dot, path = name.partition(".")
        fmt = fmt.lower()
        if not dot or fmt not in ("parquet", "orc", "csv", "json", "text"):
            return None
        if not os.path.exists(path):
            return None
        from ..io import DataFrameReader
        return DataFrameReader(self._session).format(fmt).load(path)._plan

    def list_persistent_tables(self, db: Optional[str] = None) -> List[str]:
        d = self._db_dir((db or self.current_database).lower())
        if not os.path.isdir(d):
            return []
        return sorted(
            t for t in os.listdir(d)
            if os.path.isfile(os.path.join(d, t, "_meta.json")))

    def listTables(self) -> List[str]:
        return sorted(set(self._views) | set(self.list_persistent_tables()))


class Builder:
    def __init__(self):
        self._options: Dict[str, Any] = {}

    def appName(self, name: str) -> "Builder":
        self._options["spark.app.name"] = name
        return self

    def master(self, master: str) -> "Builder":
        self._options["spark.master"] = master
        return self

    def config(self, key: str, value: Any = None) -> "Builder":
        self._options[key] = value
        return self

    def enableHiveSupport(self) -> "Builder":
        """Accepted and ignored, as in the reference: the catalog's
        persistent half is always on."""
        return self

    def getOrCreate(self) -> "SparkSession":
        opts = dict(self._options)
        if SparkSession._active is None:
            # --conf pairs handed down by ``cli launch`` ride the
            # environment (the launcher builds no session itself); they
            # SEED the session only — re-applying them on later
            # getOrCreate() calls would revert runtime conf.set overrides
            launch_conf = os.environ.get("SPARK_TPU_LAUNCH_CONF")
            if launch_conf:
                for pair in launch_conf.split("\x1f"):
                    k, _, v = pair.partition("=")
                    opts.setdefault(k, v)
            SparkSession._active = SparkSession(C.Conf(opts))
        else:
            for k, v in opts.items():
                SparkSession._active.conf.set(k, v)
        return SparkSession._active


class SparkSession:
    _active: Optional["SparkSession"] = None
    _tls = threading.local()         # per-thread executing session

    class _BuilderAccessor:
        def __get__(self, obj, objtype=None) -> Builder:
            return Builder()

    builder = _BuilderAccessor()

    def __init__(self, conf: Optional[C.Conf] = None):
        self.conf_obj = conf or C.Conf()
        self.conf = self.conf_obj  # Conf has get/set directly
        #: the one device every batch and kernel of this session uses
        self.device = resolve_device(self.conf_obj.get(C.TORCH_DEVICE))
        self.catalog = Catalog(self)
        self._last_qe = None              # most recent QueryExecution
        # learned capacity factors from adaptive overflow retries, keyed by
        # the pre-adaptation plan key — later executions of the same query
        # shape start at the factor that worked
        self._adapted_factors: Dict[str, Any] = {}
        # device memory accounting: queries reserve their static bytes
        # before dispatch; the stage cache's graphs and the cached
        # relations are its storage, and pressure takes the least
        # recently used of either first (memory.evict_lru)
        from ..memory import DeviceCacheManager, MemoryManager, evict_lru
        from .stagecompile import stage_cache
        self._memory = MemoryManager(self.conf_obj, self.device)
        self._cache = DeviceCacheManager(self._memory, self.conf_obj,
                                         self.device)
        self._memory.set_eviction_callback(
            lambda nbytes: evict_lru(self._memory, nbytes,
                                     (stage_cache(), self._cache)))
        self._query_count = 0
        self._cancel_requested = False
        # plan verifications and decision-trace checks (analysis/), the
        # ``analysis`` metrics source
        self._analysis_stats: Dict[str, Any] = {
            "plans_verified": 0, "plan_verify_ms": 0.0}
        # the serving plan cache (serving/plancache.py), attached by the
        # SQL server to every session it serves; None elsewhere
        self._plan_cache = None
        self._last_plan_cache_info = None
        # the cross-process host shuffle (enableHostShuffle) and its host
        # memory ledger, kept across re-enables
        self._crossproc_svc = None
        self._host_ledger = None
        # the listener bus and the RDD entry point (sparkContext), made
        # at first use
        self._listener_manager = _ListenerManager()
        self._sc = None
        from ..metrics import MetricsSystem, default_sources
        self._metrics_system = MetricsSystem(self.conf_obj)
        for src in default_sources(self):
            self._metrics_system.register_source(src)
        # pyspark semantics: constructing a session makes it the active one
        SparkSession._active = self

    @classmethod
    def getActiveSession(cls) -> Optional["SparkSession"]:
        """The session executing a query on this thread (set per query by
        ``QueryExecution.execute``), else the last session built."""
        tls = getattr(cls._tls, "active", None)
        return tls if tls is not None else cls._active

    @classmethod
    def _set_thread_active(cls, session) -> None:
        cls._tls.active = session

    @property
    def memoryManager(self):
        """Device execution/storage accounting (UnifiedMemoryManager
        analog)."""
        return self._memory

    def card_memory(self, device):
        """The memory manager of ``device``: the session's own for its
        card, and one per other card a mesh places shards on (made at
        first use, its storage evicted from the stage cache the same
        way)."""
        from ..cuda_a2a import same_card
        if same_card(device, self.device):
            return self._memory
        from ..memory import MemoryManager, evict_lru
        from .stagecompile import stage_cache
        key = str(torch.device(device))
        managers = self.__dict__.setdefault("_card_memories", {})
        m = managers.get(key)
        if m is None:
            m = managers[key] = MemoryManager(self.conf_obj, device)
            m.set_eviction_callback(
                lambda nbytes: evict_lru(m, nbytes, (stage_cache(),)))
        return m

    @property
    def cacheManager(self):
        """Cached relations of ``df.cache()`` (CacheManager analog)."""
        return self._cache

    @property
    def metricsSystem(self):
        """Process-gauge sources (``metrics/MetricsSystem.scala``
        analog); ``snapshots()`` reads them on demand."""
        return self._metrics_system

    # -- observability (LiveListenerBus + EventLoggingListener analogs) ---
    @property
    def listenerManager(self):
        return self._listener_manager

    def _events_wanted(self) -> bool:
        """Whether a posted event reaches anyone: a listener, or the
        event log (``spark.eventLog.dir``)."""
        return bool(self._listener_manager._listeners
                    or self.conf.get(C.EVENT_LOG_DIR))

    def _post_event(self, event: Dict[str, Any]) -> None:
        """Every listener gets the event (a failing one never fails the
        query); with ``spark.eventLog.dir`` set it is appended to
        ``<dir>/eventlog.jsonl``."""
        for fn in list(self._listener_manager._listeners):
            try:
                fn(event)
            except Exception:  # noqa: BLE001 — listeners never fail a query
                pass
        log_dir = self.conf.get(C.EVENT_LOG_DIR)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, "eventlog.jsonl"), "a") as f:
                f.write(json.dumps(event, default=str) + "\n")

    @property
    def sparkContext(self):
        """The RDD entry point bound to this session (made at first
        use)."""
        if self._sc is None:
            from ..rdd.context import SparkContext
            self._sc = SparkContext(conf=self.conf_obj, session=self)
        return self._sc

    # -- cooperative statement cancellation (cancelJobGroup analog) ------
    #
    # A launched kernel or a replayed CUDA graph runs to its end, like a
    # running Spark task; cancellation lands between units of work: before
    # planning, after each operator of the eager lane, and before a
    # graph's replay (QueryExecution).
    def cancelAllQueries(self) -> None:
        self._cancel_requested = True

    def clear_cancel(self) -> None:
        self._cancel_requested = False

    def raise_if_cancelled(self) -> None:
        if self._cancel_requested:
            raise QueryCancelled("query cancelled by user request")

    def newSession(self) -> "SparkSession":
        """A sibling session: same conf VALUES and device, but isolated
        temp views, conf object, learned factors and cancellation state
        (``SparkSession.scala:236 newSession``).  The stage cache is per
        process, so siblings share its captured graphs."""
        return SparkSession(self.conf_obj.clone())

    def enableHostShuffle(self, root: str, process_id: Optional[int] = None,
                          n_processes: Optional[int] = None,
                          timeout_s: float = 120.0, heartbeat=None):
        """Register the cross-process host shuffle on this session: from
        now on every query plans its cross-process exchange through a
        ``HostShuffleService`` rooted at ``root``, a directory every
        process mounts (``spark_tpu/sql/session.py`` ``enableHostShuffle``;
        ``ExternalShuffleBlockResolver.java:57``'s registration).  Each
        process's leaves are its partitions; byte-identical leaves are
        replicated.

        ``process_id`` and ``n_processes`` default to the launcher's
        environment contract (``parallel.cluster.init_cluster``:
        ``SPARK_TPU_PROCESS_ID``, ``SPARK_TPU_NUM_PROCESSES``); with
        neither given nor in the environment the call raises.
        ``heartbeat`` (a ``parallel.cluster.HeartbeatMonitor``) turns
        confirmed-dead peers into barrier exclusions.  The session keeps
        ONE ``HostMemoryLedger`` across re-enables, and the service's
        counters register as the ``shuffle`` metrics source."""
        import os
        from ..memory import HostMemoryLedger
        from ..parallel import cluster
        from ..parallel.hostshuffle import HostShuffleService
        if process_id is None or n_processes is None:
            if not os.environ.get(cluster.ENV_NUM_PROCESSES) \
                    or not os.environ.get(cluster.ENV_PROCESS_ID):
                raise ValueError(
                    "enableHostShuffle needs process_id and n_processes, "
                    f"or {cluster.ENV_PROCESS_ID} and "
                    f"{cluster.ENV_NUM_PROCESSES} in the environment")
            info = cluster.init_cluster()
            process_id = info.process_index if process_id is None \
                else process_id
            n_processes = info.process_count if n_processes is None \
                else n_processes
        if self._host_ledger is None:
            self._host_ledger = HostMemoryLedger(self.conf_obj)
        self._crossproc_svc = HostShuffleService(
            root, process_id=process_id, n_processes=n_processes,
            timeout_s=timeout_s, conf=self.conf_obj, heartbeat=heartbeat,
            ledger=self._host_ledger)
        # the card this process runs on, where every process reads the
        # same facts: the device tier's auto probe groups by it
        from ..parallel.ici import publish_device
        publish_device(self._crossproc_svc, self.device)
        ms = self.metricsSystem
        ms._sources = [src for src in ms._sources if src.name != "shuffle"]
        ms.register_source(self._crossproc_svc.metrics_source())
        return self._crossproc_svc

    def disableHostShuffle(self) -> None:
        self._crossproc_svc = None

    @property
    def statsFeedback(self):
        """The session's adaptive-execution ``StatsFeedback``: per-side
        cardinalities the cross-process replanner observed at exchange
        stats barriers, consulted by later join decisions."""
        from ..parallel.crossproc import _session_feedback
        return _session_feedback(self)

    def _invalidate_plan_cache(self, path: Optional[str] = None,
                               conf_key: Optional[str] = None,
                               old: Any = None, new: Any = None) -> None:
        """Serving plan-cache hook: catalog mutations and file writes evict
        the entries that read the mutated table or database path, from
        every session; a SET of a planning-relevant conf evicts entries
        built under this session's old value.  No-op outside a serving
        deployment."""
        cache = self._plan_cache
        if cache is None:
            return
        if path is not None:
            cache.invalidate_paths(path)
        if conf_key is not None:
            cache.invalidate_conf(conf_key, old, new)

    @property
    def version(self) -> str:
        from .. import __version__
        return __version__

    def stop(self) -> None:
        if SparkSession._active is self:
            SparkSession._active = None
        self._metrics_system.stop()
        self._adapted_factors.clear()
        self._cache.clear()           # releases the entries' device charges

    # ------------------------------------------------------------------
    def range(self, start: int, end: Optional[int] = None, step: int = 1
              ) -> DataFrame:
        if end is None:
            start, end = 0, start
        return DataFrame(self, L.RangeRelation(start, end, step))

    def createDataFrame(self, data, schema: Union[None, List[str], T.StructType] = None,
                        ) -> DataFrame:
        """Rows (list of tuples/dicts/Rows), a pandas DataFrame or a dict
        of columns (numpy arrays or lists) → DataFrame whose batch lives
        on the session's device (``SparkSession.createDataFrame``
        analog)."""
        struct: Optional[T.StructType] = None
        names: Optional[List[str]] = None
        if isinstance(schema, T.StructType):
            struct = schema
            names = schema.names
        elif isinstance(schema, (list, tuple)):
            names = list(schema)

        if hasattr(data, "columns") and hasattr(data, "dtypes"):
            data = _pandas_columns(data)
        if isinstance(data, dict):
            batch = ColumnBatch.from_arrays(data, schema=struct,
                                            device=self.device)
            return DataFrame(self, L.LocalRelation(batch))

        rows = list(data)
        if not rows:
            if struct is None:
                raise AnalysisException("cannot infer schema from empty data")
            return DataFrame(self, L.LocalRelation(
                ColumnBatch.empty(struct, device=self.device)))

        first = rows[0]
        if isinstance(first, dict):
            names = names or list(first.keys())
            cols = {n: [r.get(n) for r in rows] for n in names}
        elif hasattr(first, "__fields__"):
            names = names or list(first.__fields__)
            cols = {n: [r[i] for r in rows] for i, n in enumerate(names)}
        elif isinstance(first, (tuple, list)):
            names = names or [f"_{i + 1}" for i in range(len(first))]
            cols = {n: [r[i] for r in rows] for i, n in enumerate(names)}
        else:  # scalars → single column
            names = names or ["value"]
            cols = {names[0]: rows}
        batch = ColumnBatch.from_arrays(cols, schema=struct, device=self.device)
        return DataFrame(self, L.LocalRelation(batch))

    @property
    def udf(self):
        """`spark.udf.register(name, fn, returnType)` (UDFRegistration)."""
        from .udf import UDFRegistration
        return UDFRegistration(self)

    def sql(self, query: str) -> DataFrame:
        from . import parser as P
        st = P.parse_statement(query)
        if not isinstance(st, P.Command):
            return DataFrame(self, st)
        return self._run_command(st)

    @staticmethod
    def _unwrap_aliases(node):
        while isinstance(node, L.SubqueryAlias):
            node = node.children[0]
        return node

    def _analyze_table(self, cmd, string_df) -> DataFrame:
        """ANALYZE TABLE … COMPUTE STATISTICS [FOR COLUMNS …]: the row
        count and per-column min/max/null_count/NDV gathered through the
        engine's own scan, registered for the optimizer and persisted with
        catalog tables (``AnalyzeTableCommand`` / ``AnalyzeColumnCommand``
        analog)."""
        from .. import io as tio
        from . import functions as F
        df = self.table(cmd.name)
        node = self._unwrap_aliases(self.catalog.lookup(cmd.name))
        if not isinstance(node, L.FileRelation):
            raise AnalysisException(
                f"ANALYZE TABLE {cmd.name}: only file-backed tables and "
                "views carry statistics (views over computed plans "
                "re-derive them at query time)")
        rows = df.count()
        stats: dict = {"rows": int(rows), "columns": {},
                       "key": tio.stats_key_token(node)}
        if cmd.columns is None:
            # a rows-only refresh keeps earlier column statistics
            prev = tio.analyzed_stats(node)
            if prev:
                stats["columns"] = prev.get("columns", {})
        else:
            names = [f.name for f in node.schema().fields]
            selected = names if cmd.columns == [] else list(cmd.columns)
            aggs = []
            for c in selected:
                if c not in names:
                    raise AnalysisException(
                        f"ANALYZE TABLE: no such column {c!r}")
                aggs += [F.min(c).alias(f"__mn_{c}"),
                         F.max(c).alias(f"__mx_{c}"),
                         F.count(c).alias(f"__ct_{c}")]
            row = df.agg(*aggs).collect()[0]
            # NDV per column: one aggregate carries one distinct column
            ndvs = {c: float(df.agg(F.approx_count_distinct(c).alias("nd"))
                             .collect()[0]["nd"]) for c in selected}

            def plain(v):
                # only JSON-native values survive a persist and reload
                # unchanged in type
                v = v.item() if hasattr(v, "item") else v
                return v if isinstance(v, (int, float, str, bool)) \
                    or v is None else None

            for c in selected:
                stats["columns"][c] = {
                    "min": plain(row[f"__mn_{c}"]),
                    "max": plain(row[f"__mx_{c}"]),
                    "null_count": int(rows) - int(row[f"__ct_{c}"]),
                    "total": int(rows),
                    "ndv": ndvs[c],
                }
        tio.register_analyzed_stats(node, stats)
        # persisted only where the name resolves to the persistent table:
        # a temp view shadowing a table must not plant its statistics there
        persisted = False
        if cmd.name.lower() not in self.catalog._views:
            persisted = self.catalog.save_table_stats(cmd.name, stats)
        return string_df({
            "table": [cmd.name],
            "rows": [str(rows)],
            "columns_analyzed": [str(len(stats["columns"]))],
            "persisted": [str(persisted).lower()],
        })

    def _insert_into(self, cmd) -> None:
        """INSERT [OVERWRITE] INTO a catalog table.  The query runs
        BEFORE the table directory is touched (``INSERT OVERWRITE t SELECT
        ... FROM t`` reads the old data; a failing query destroys
        nothing); columns bind by POSITION against the table schema."""
        from ..io import DataFrameWriter
        path = self.catalog.table_path(cmd.name)
        meta = self.catalog._read_meta(path)
        if meta is None:
            raise AnalysisException(f"table not found: {cmd.name}")
        src = DataFrame(self, cmd.query)
        table_schema = [n for n, _t in meta["schema"]]
        if len(src.schema.names) != len(table_schema):
            raise AnalysisException(
                f"INSERT into {cmd.name}: query produces "
                f"{len(src.schema.names)} columns, table has "
                f"{len(table_schema)}")
        batch = src._execute()
        batch = ColumnBatch(list(table_schema), batch.vectors,
                            batch.row_valid, batch.capacity)
        DataFrameWriter(src).format(meta["format"]) \
            .mode("overwrite" if cmd.overwrite else "append") \
            ._write(path, batch)
        if cmd.overwrite:
            # overwrite cleared the directory, the metadata with it
            self.catalog._write_meta(path, meta)
        self._invalidate_plan_cache(path=path)

    def _describe(self, cmd) -> dict:
        """DESCRIBE [EXTENDED]: the schema, and with EXTENDED the ANALYZE
        TABLE statistics where registered (``DescribeTableCommand``)."""
        from .. import io as tio
        plan = self.catalog.lookup(cmd.name)
        schema = DataFrame(self, plan).schema
        names = [f.name for f in schema.fields]
        dts = [f.dataType.simpleString() for f in schema.fields]
        if not cmd.extended:
            return {"col_name": names, "data_type": dts,
                    "comment": [""] * len(names)}
        node = self._unwrap_aliases(plan)
        st = tio.analyzed_stats(node) \
            if isinstance(node, L.FileRelation) else None
        cols = st.get("columns", {}) if st else {}

        def fmt_stats(name):
            rec = cols.get(name)
            if not rec:
                return ""
            return (f"min={rec.get('min')} max={rec.get('max')} "
                    f"nulls={rec.get('null_count')} ndv={rec.get('ndv')}")

        return {"col_name": names + ["# rows"], "data_type": dts + [""],
                "comment": [fmt_stats(n) for n in names]
                + [str(st["rows"]) if st else "<not analyzed>"]}

    def _run_command(self, cmd) -> DataFrame:
        from . import parser as P

        def string_df(cols: dict) -> DataFrame:
            names = list(cols)
            struct = T.StructType(
                [T.StructField(n, T.string) for n in names])
            vals = list(cols.values())
            if vals and len(vals[0]) == 0:
                return DataFrame(self, L.LocalRelation(
                    ColumnBatch.empty(struct, device=self.device)))
            return DataFrame(self, L.LocalRelation(ColumnBatch.from_arrays(
                cols, schema=struct, device=self.device)))

        if isinstance(cmd, P.AnalyzeTableCommand):
            out = self._analyze_table(cmd, string_df)
            # fresh statistics change what the planner would build (join
            # order, broadcast sides): entries over the table are stale
            self._invalidate_plan_cache(path=self.catalog.table_path(cmd.name))
            return out
        if isinstance(cmd, P.CreateViewCommand):
            if not cmd.replace and cmd.name.lower() in self.catalog._views:
                raise AnalysisException(f"temp view {cmd.name} already exists")
            self.catalog.register(cmd.name, cmd.query)
            return string_df({})
        if isinstance(cmd, P.DropViewCommand):
            found = self.catalog.drop(cmd.name)
            if not found and not cmd.if_exists:
                raise AnalysisException(f"view not found: {cmd.name}")
            return string_df({})
        if isinstance(cmd, P.DropTableCommand):
            # a temp view may shadow a table of the same name (Spark drops
            # the view first)
            if self.catalog.drop(cmd.name):
                return string_df({})
            self.catalog.drop_table(cmd.name, cmd.if_exists)
            self._invalidate_plan_cache(path=self.catalog.table_path(cmd.name))
            return string_df({})
        if isinstance(cmd, P.CreateDatabaseCommand):
            self.catalog.create_database(cmd.name, cmd.if_not_exists)
            return string_df({})
        if isinstance(cmd, P.DropDatabaseCommand):
            db_dir = self.catalog._db_dir(cmd.name.lower())
            self.catalog.drop_database(cmd.name, cmd.if_exists)
            self._invalidate_plan_cache(path=db_dir)
            return string_df({})
        if isinstance(cmd, P.UseDatabaseCommand):
            self.catalog.setCurrentDatabase(cmd.name)
            return string_df({})
        if isinstance(cmd, P.ShowDatabasesCommand):
            return string_df({"namespace": self.catalog.list_databases()})
        if isinstance(cmd, P.CreateTableCommand):
            if os.path.isdir(self.catalog.table_path(cmd.name)):
                if cmd.if_not_exists:
                    return string_df({})
                if not cmd.replace:
                    raise AnalysisException(f"table {cmd.name} already exists")
                self.catalog.drop_table(cmd.name)
            if cmd.query is not None:
                self.catalog.save_table(cmd.name, DataFrame(self, cmd.query),
                                        cmd.fmt)
            else:
                schema = T.StructType([T.StructField(n, T.type_for_name(t))
                                       for n, t in cmd.columns])
                self.catalog.create_empty_table(cmd.name, schema, cmd.fmt)
            self._invalidate_plan_cache(path=self.catalog.table_path(cmd.name))
            return string_df({})
        if isinstance(cmd, P.InsertIntoCommand):
            self._insert_into(cmd)
            return string_df({})
        if isinstance(cmd, P.ShowTablesCommand):
            persistent = set(self.catalog.list_persistent_tables())
            names = self.catalog.listTables()
            return string_df({
                "tableName": names,
                "isTemporary": ["false" if n in persistent else "true"
                                for n in names]})
        if isinstance(cmd, P.DescribeCommand):
            return string_df(self._describe(cmd))
        if isinstance(cmd, P.SetCommand):
            if cmd.key is not None and cmd.value is not None:
                # a planning entry is part of every stage key and plan
                # fingerprint (serving/plancache.py PLANNING_CONF_ENTRIES):
                # the plan cache evicts entries built under the old value;
                # stage entries are unreachable and age out of the LRU
                old = self.conf.get(cmd.key, None)
                self.conf.set(cmd.key, cmd.value)
                new = self.conf.get(cmd.key, None)
                if new != old:
                    self._invalidate_plan_cache(conf_key=cmd.key, old=old,
                                                new=new)
            key = cmd.key if cmd.key is not None else ""
            value = str(self.conf.get(cmd.key, "<undefined>")) \
                if cmd.key is not None else ""
            return string_df({"key": [key], "value": [value]})
        if isinstance(cmd, P.ExplainCommand):
            from .planner import QueryExecution
            qe = QueryExecution(self, cmd.query)
            text = qe.explain_string() if cmd.extended else \
                "== Physical Plan ==\n" + \
                qe.planned_preview().physical.tree_string()
            return string_df({"plan": [text]})
        raise AnalysisException(f"unsupported command {type(cmd).__name__}")

    def table(self, name: str) -> DataFrame:
        return DataFrame(self, L.UnresolvedRelation(name))

    @property
    def read(self):
        from ..io import DataFrameReader
        return DataFrameReader(self)

    @property
    def readStream(self):
        from ..streaming.api import DataStreamReader
        return DataStreamReader(self)

    @property
    def streams(self):
        from ..streaming.api import StreamingQueryManager
        return StreamingQueryManager.get(self)
