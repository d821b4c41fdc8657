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
    "query as n shards of one SPMD program (parallel/executor.py), every "
    "exchange between shards one launch of the all-to-all kernel; all n "
    "shards live on the session's device (spark.torch.device).  1 = the "
    "single-device lane.  0 = all local devices, which is 1 here: the "
    "engine spans one device, so the single-device lane stays the "
    "default unless shards are asked for."
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

STAGE_CACHE_MAX_ENTRIES = conf("spark.tpu.stage.cacheMaxEntries").doc(
    "Entry bound of the process-local stage cache (LRU beyond it).  The "
    "cache is per PROCESS, not per session."
).int(256)

CASE_SENSITIVE = conf("spark.sql.caseSensitive").boolean(False)

METRICS_ENABLED = conf("spark.sql.metrics.enabled").doc(
    "Record per-operator output row counts (SQLMetrics analog). Adds one "
    "fetched scalar per operator to every query; off by default."
).boolean(False)
