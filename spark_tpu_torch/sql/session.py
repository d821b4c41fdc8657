"""SparkSession: the entry point (``sql/SparkSession.scala:77`` analog).

The subset of ``spark_tpu/sql/session.py`` the port has: the builder,
the conf, a temp-view and function catalog, ``createDataFrame``,
``range``, ``sql`` with its commands, ``udf`` and ``stop``.  The session
owns ONE torch device, named by
``spark.torch.device`` (default ``"cuda"``): every batch it creates lives
there and every query runs there.  Asking for a card that is not there
raises; the session never falls back to the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch

from .. import config as C
from .. import types as T
from ..columnar import ColumnBatch
from ..expressions import AnalysisException
from . import logical as L
from .dataframe import DataFrame


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


#: where the persistent catalog (tables, databases, their statistics)
#: comes from: it needs ``io.py``'s readers and writers
PERSISTENT_SLICE = "the scan slice (io.py readers and writers)"


class Catalog:
    """Temp views + functions (``SessionCatalog``'s session half; the
    persistent tables and databases come with the scan slice)."""

    def __init__(self, session=None):
        self._session = session
        self._views: Dict[str, L.LogicalPlan] = {}
        self._functions: Dict[str, Any] = {}

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

    def lookup(self, name: str) -> L.LogicalPlan:
        key = name.lower()
        if key in self._views:
            return self._views[key]
        raise AnalysisException(f"Table or view not found: {name}")

    def listTables(self) -> List[str]:
        return sorted(self._views)


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

    def getOrCreate(self) -> "SparkSession":
        opts = dict(self._options)
        if SparkSession._active is None:
            SparkSession._active = SparkSession(C.Conf(opts))
        else:
            for k, v in opts.items():
                SparkSession._active.conf.set(k, v)
        return SparkSession._active


class SparkSession:
    _active: Optional["SparkSession"] = None

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
        # before dispatch; the stage cache's graphs are its storage, and
        # pressure evicts the least recently used of them
        from ..memory import MemoryManager
        from .stagecompile import stage_cache
        self._memory = MemoryManager(self.conf_obj, self.device)
        self._memory.set_eviction_callback(
            lambda nbytes: stage_cache().evict(self._memory, nbytes))
        # pyspark semantics: constructing a session makes it the active one
        SparkSession._active = self

    @property
    def memoryManager(self):
        """Device execution/storage accounting (UnifiedMemoryManager
        analog)."""
        return self._memory

    @property
    def version(self) -> str:
        from .. import __version__
        return __version__

    def stop(self) -> None:
        if SparkSession._active is self:
            SparkSession._active = None
        self._adapted_factors.clear()

    # ------------------------------------------------------------------
    def range(self, start: int, end: Optional[int] = None, step: int = 1
              ) -> DataFrame:
        if end is None:
            start, end = 0, start
        return DataFrame(self, L.RangeRelation(start, end, step))

    def createDataFrame(self, data, schema: Union[None, List[str], T.StructType] = None,
                        ) -> DataFrame:
        """Rows (list of tuples/dicts/Rows) or a dict of columns (numpy
        arrays or lists) → DataFrame whose batch lives on the session's
        device (``SparkSession.createDataFrame`` analog)."""
        struct: Optional[T.StructType] = None
        names: Optional[List[str]] = None
        if isinstance(schema, T.StructType):
            struct = schema
            names = schema.names
        elif isinstance(schema, (list, tuple)):
            names = list(schema)

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

        if isinstance(cmd, (P.AnalyzeTableCommand, P.CreateTableCommand,
                            P.InsertIntoCommand, P.DropTableCommand,
                            P.CreateDatabaseCommand, P.DropDatabaseCommand,
                            P.UseDatabaseCommand, P.ShowDatabasesCommand)):
            if isinstance(cmd, P.DropTableCommand) \
                    and self.catalog.drop(cmd.name):
                return string_df({})   # a temp view shadows the table
            what = type(cmd).__name__[:-len("Command")]
            raise NotImplementedError(
                f"{what} is not ported yet: persistent catalog tables come "
                f"with {PERSISTENT_SLICE}")
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
        if isinstance(cmd, P.ShowTablesCommand):
            names = self.catalog.listTables()
            return string_df({"tableName": names,
                              "isTemporary": ["true"] * len(names)})
        if isinstance(cmd, P.DescribeCommand):
            schema = DataFrame(self, self.catalog.lookup(cmd.name)).schema
            names = [f.name for f in schema.fields]
            dts = [f.dataType.simpleString() for f in schema.fields]
            comments = [""] * len(schema.fields)
            if cmd.extended:
                # no view of the port is file-backed, so none carries
                # ANALYZE TABLE statistics
                names, dts = names + ["# rows"], dts + [""]
                comments = comments + ["<not analyzed>"]
            return string_df({"col_name": names, "data_type": dts,
                              "comment": comments})
        if isinstance(cmd, P.SetCommand):
            if cmd.key is not None and cmd.value is not None:
                # a planning entry is part of every stage key
                # (serving/plancache.py PLANNING_CONF_ENTRIES): entries
                # built under the old value are unreachable from now on
                # and age out of the LRU
                self.conf.set(cmd.key, cmd.value)
            key = cmd.key if cmd.key is not None else ""
            value = str(self.conf.get(cmd.key, "<undefined>")) \
                if cmd.key is not None else ""
            return string_df({"key": [key], "value": [value]})
        if isinstance(cmd, P.ExplainCommand):
            from .planner import QueryExecution
            qe = QueryExecution(self, cmd.query)
            text = qe.explain_string() if cmd.extended else \
                "== Physical Plan ==\n" + qe.planned.physical.tree_string()
            return string_df({"plan": [text]})
        raise AnalysisException(f"unsupported command {type(cmd).__name__}")

    def table(self, name: str) -> DataFrame:
        return DataFrame(self, L.UnresolvedRelation(name))
