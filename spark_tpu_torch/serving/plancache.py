"""Cross-session plan cache for the SQL server: a port of
``spark_tpu/serving/plancache.py``.

The reference amortizes query compilation across sessions: the
thriftserver keeps one compiled plan serving many sessions.  On the card
the costs a repeated statement can skip are the planner
(``Planner.plan``), the stage key (``stagecompile.stage_fingerprint``
over the physical plan) and the stage-cache entry's build (an eager
warm-up and a CUDA-graph capture).

This module provides it:

* ``fingerprint(session, plan)`` — a stable string key over the
  OPTIMIZED logical plan: node structure, every non-child field,
  expression trees, leaf identities (LocalRelation batch uids; a
  FileRelation's format, paths, options, pruned columns and pushed
  filters) and the planning-relevant conf values.  Literals in
  arithmetic/comparison positions are SLOTTED OUT — replaced by typed ``?i`` markers — so
  ``WHERE v < 10`` and ``WHERE v < 20`` share one entry; their values
  ride into the captured program as the stage entry's device scalars
  (``expressions._slot_bindings``), never baked constants.  Anything the
  serializer cannot PROVE stable makes the plan uncacheable rather than
  wrongly shared.  The same serializer keys the stage cache
  (``sql/stagecompile.py``) over the physical plan.
* ``PlanCache`` — a thread-safe, entry- and byte-bounded LRU from
  fingerprint → (physical plan, its leaves, stage key, the slot map onto
  the stage entry's parameters).  ``try_execute(qe)`` is the whole
  integration surface for ``QueryExecution``: it returns a finished host
  batch on a usable entry (building one on a miss) or ``None`` to fall
  through to the normal adaptive path.  A hit goes straight to the
  stage-cache entry with this statement's literal values as its
  parameters.

Safety properties:

* value-dependent PLANNING is covered by fingerprinting AFTER the
  optimizer: constant folding and filter pushdown have already consumed
  literal values, so variants that optimized differently get different
  fingerprints.  A hit skips the planner and the stage key, not
  analysis and optimization.
* SET of a planning conf evicts entries built under the old value
  (``invalidate_conf``); the fingerprint's conf component is the
  correctness backstop for sessions the hook cannot see.  A catalog
  command or a write evicts the entries that read the path it mutated
  (``invalidate_paths``), from any session.
* a file leaf is re-read on every hit, through the relation cache
  (``io._load_batch``): an answer is never staler than the files, and a
  changed file keys a new stage entry (its stage key signs the files'
  stat).
* a cached physical plan's static output capacities may not fit another
  literal variant's data: overflow flags are checked exactly like the
  normal path, and an overflowing fingerprint is POISONED (excluded
  from caching) and re-run through the adaptive replan loop.  Where
  that loop finds capacities that fit, the fingerprint is re-keyed to
  the plan it found (``adopt``), so the next run hits.
* a build that raises is re-raised: no entry is kept and nothing falls
  back to another lane.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import config as C
from .. import expressions as E
from .. import types as T

__all__ = ["PLANNING_CONF_ENTRIES", "EXCHANGE_CONF_ENTRIES",
           "PLANNING_CONF_KEYS", "PlanCache",
           "PlanFingerprint", "fingerprint"]


class _Unfingerprintable(Exception):
    """Plan contains a field the serializer cannot key soundly."""


class _StaleEntry(Exception):
    """A hit's leaves no longer match the planned schemas (a table's
    schema changed underneath the cache without a hook firing)."""


# Literal parents whose eval() consumes the literal ONLY through
# Literal.eval (vectorized, dtype-stable): safe positions to replace the
# value with a runtime parameter.  Everything else (In/Between bounds,
# string ops, function args that read .value host-side) keeps the value
# in the fingerprint.
_SLOT_PARENTS = (E.Add, E.Sub, E.Mul, E.Div, E.IntDiv, E.Mod,
                 E.EQ, E.NE, E.LT, E.LE, E.GT, E.GE)

# dtypes whose Literal.eval is a plain scalar (no host-side string /
# decimal / datetime conversion): eligible for slotting
_SLOT_DTYPES = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
                T.LongType, T.FloatType, T.DoubleType)

#: conf entries that change what the planner/optimizer would build; their
#: values are part of every fingerprint and stage key, and SET of one
#: evicts plan-cache entries built under the old value.  The reference's
#: list, restricted to the entries this package has.
PLANNING_CONF_ENTRIES = (
    C.CODEGEN_ENABLED, C.MESH_SHARDS, C.AUTO_BROADCAST_JOIN_THRESHOLD,
    C.JOIN_OUTPUT_FACTOR, C.AGG_OUTPUT_ROWS, C.JOIN_OUTPUT_MAX_ROWS,
    C.CASE_SENSITIVE, C.ADAPTIVE_ENABLED, C.METRICS_ENABLED,
    C.EXCHANGE_SKEW_FACTOR, C.COLLECT_MAX_LEN,
    # the out-of-core boundary, and where catalog tables resolve to
    C.SCAN_MAX_BATCH_ROWS, C.MULTIBATCH_ENABLED, C.WAREHOUSE_DIR,
    # whole-stage fusion toggles the fused-vs-per-op execution shape
    C.STAGE_FUSION,
)

#: the cross-process exchange's shaping confs: fine-partition count,
#: reducer coalescing target and range-sample density move work between
#: processes; dedupReplicated changes the gather plan; adaptive replanning
#: and the broadcast bar change which lane a join takes; the device tier's
#: switch, byte floor and domain override, and run codes on the wire,
#: change how blocks travel.  They are planning confs (a SET evicts plans
#: built under the old value, as in the reference) but shape no single
#: process's stage, so the stage key leaves them out
#: (``stagecompile._conf_component``): toggling the tier between runs
#: replays the same graphs.
EXCHANGE_CONF_ENTRIES = (
    C.CROSSPROC_AUTO_BROADCAST, C.CROSSPROC_SHUFFLED_JOIN,
    C.CROSSPROC_SORT_MERGE_JOIN, C.SHUFFLE_FINE_PARTITIONS,
    C.SHUFFLE_TARGET_PARTITION_BYTES, C.SHUFFLE_RANGE_SAMPLE_SIZE,
    C.CROSSPROC_DEDUP_REPLICATED, C.CROSSPROC_ADAPTIVE_REPLAN,
    C.SHUFFLE_ICI_ENABLED, C.SHUFFLE_ICI_MIN_BYTES,
    C.SHUFFLE_ICI_TIER_OVERRIDE, C.SHUFFLE_WIRE_RUN_CODES,
)

#: everything a plan fingerprint signs and an entry's snapshot records
FINGERPRINT_CONF_ENTRIES = PLANNING_CONF_ENTRIES + EXCHANGE_CONF_ENTRIES

PLANNING_CONF_KEYS = frozenset(e.key for e in FINGERPRINT_CONF_ENTRIES)

# identity of callables in plan fields (UDF bodies): a never-reused
# number per function object, so address recycling cannot alias two
_fn_uids: "weakref.WeakKeyDictionary[Any, int]" = weakref.WeakKeyDictionary()
_fn_counter = itertools.count()


def _fn_uid(fn) -> int:
    try:
        uid = _fn_uids.get(fn)
        if uid is None:
            uid = _fn_uids[fn] = next(_fn_counter)
    except TypeError:               # not weakly referenceable
        raise _Unfingerprintable(f"{type(fn).__name__} callable") from None
    return uid


def _ser_expr(e: E.Expression, slots: List[E.Literal],
              slot_ok: bool) -> str:
    if type(e) is E.Literal:
        if slot_ok and e.value is not None \
                and isinstance(e.dtype, _SLOT_DTYPES):
            # one literal object shared by two places of the plan (a CTE
            # used twice) is ONE parameter: a back-reference keeps that
            # sharing in the key, so a text whose two places hold two
            # values never takes this plan
            for i, seen in enumerate(slots):
                if seen is e:
                    return f"?{i}:{e.dtype.simpleString()}"
            slots.append(e)
            return f"?{len(slots) - 1}:{e.dtype.simpleString()}"
        return f"lit[{e.value!r}:{e.dtype.simpleString()}]"
    child_ok = isinstance(e, _SLOT_PARENTS)
    fields = []
    if isinstance(e, (E.Col, E.Alias, E.LambdaVar)):
        # the identity of these nodes lives in a PRIVATE field the vars()
        # walk below skips — without it `sum(a)` and `sum(b)` serialize
        # identically and two different plans share one stage entry (a
        # lambda variable's name is its position in the plan: the
        # analyzer's lambda resolution)
        fields.append(f"name={e.name!r}")
    for name in sorted(vars(e)):
        if name == "children" or name.startswith("_"):
            continue
        fields.append(f"{name}={_ser_val(vars(e)[name], slots)}")
    inner = ",".join(_ser_expr(c, slots, child_ok) for c in e.children)
    return f"{type(e).__name__}[{';'.join(fields)}]({inner})"


def _ser_val(v: Any, slots: List[E.Literal]) -> str:
    if isinstance(v, E.Expression):
        return _ser_expr(v, slots, False)
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return repr(v)
    if isinstance(v, T.DataType):
        return v.simpleString()
    from ..sql.logical import SortOrder
    if isinstance(v, SortOrder):
        return (f"SortOrder[{int(v.ascending)}{int(v.nulls_first)}]"
                f"({_ser_expr(v.child, slots, False)})")
    if isinstance(v, (list, tuple)):
        inner = ",".join(_ser_val(x, slots) for x in v)
        return ("L(" if isinstance(v, list) else "T(") + inner + ")"
    if isinstance(v, dict):
        items = sorted(((repr(k), _ser_val(x, slots))
                        for k, x in v.items()))
        return "{" + ",".join(f"{k}:{x}" for k, x in items) + "}"
    if callable(v) and not isinstance(v, type):
        # identity-keyed: same function object = same behavior; a
        # re-created lambda keys fresh
        return f"fn#{_fn_uid(v)}"
    raise _Unfingerprintable(f"{type(v).__name__} in plan fields")


class PlanFingerprint:
    """Key + the slotted Literal objects of THIS query's plan (positional;
    the serialization is deterministic, so slot i in any fingerprint-equal
    plan denotes the same parameter)."""

    def __init__(self, key: str, slots: List[E.Literal]):
        self.key = key
        self.slots = slots


def _ser_plan(node, slots: List[E.Literal]) -> str:
    from ..sql import logical as L
    if isinstance(node, L.LocalRelation):
        # batch identity, not content hash: the uid is monotonic per batch
        # object, so two sessions' same-shaped temp views never collide
        return (f"Local#{L._batch_uid(node.batch)}"
                f":{node.batch.schema.simpleString()}")
    fields = []
    for name in sorted(vars(node)):
        if name in ("children", "child") or name.startswith("_"):
            continue
        v = vars(node)[name]
        if isinstance(v, L.LogicalPlan) or (
                isinstance(v, (list, tuple)) and v
                and isinstance(v[0], L.LogicalPlan)):
            continue
        fields.append(f"{name}={_ser_val(v, slots)}")
    inner = ",".join(_ser_plan(c, slots) for c in node.children)
    return f"{type(node).__name__}[{';'.join(fields)}]({inner})"


def fingerprint(session, plan) -> Optional[PlanFingerprint]:
    """Fingerprint an OPTIMIZED plan, or None if it cannot be keyed."""
    slots: List[E.Literal] = []
    try:
        body = _ser_plan(plan, slots)
    except (_Unfingerprintable, RecursionError):
        return None
    conf = ";".join(f"{e.key}={session.conf.get(e)!r}"
                    for e in FINGERPRINT_CONF_ENTRIES)
    return PlanFingerprint(f"{body}|{conf};device={session.device}", slots)


class _Entry:
    """One cached plan: the physical plan and where its leaves come from,
    the key of its stage-cache entry with the step that builds it, and
    where each of the stage's parameters comes from."""

    __slots__ = ("key", "physical", "recipes", "leaves", "leaf_schemas",
                 "body", "pslots", "skey", "make", "n_ops", "param_src",
                 "reserve_bytes", "paths", "conf_snapshot", "nbytes",
                 "planning_ms", "hits")

    def __init__(self, key: str, pq, body: str, pslots, skey, make, n_ops,
                 param_src, reserve_bytes, conf_snapshot, nbytes):
        self.key = key
        self.physical = pq.physical
        #: per leaf, in planner order: ("local", LocalRelation),
        #: ("file", FileRelation), re-read through the relation cache on
        #: every hit (an answer is never staler than the files), or
        #: ("cached", CachedRelation), read from the session's cache
        #: manager on every hit (the entry as it is now)
        self.recipes = list(pq.leaf_recipes)
        # the leaves the entry was built on; a cached relation's is not
        # kept (a demoted entry's old device batch must be let go)
        self.leaves = [None if kind == "cached" else b
                       for (kind, _n), b in zip(self.recipes, pq.leaves)]
        self.leaf_schemas = [b.schema.simpleString() for b in pq.leaves]
        self.body = body                # the physical plan's fingerprint
        self.pslots = pslots            # its slotted literals
        self.skey = skey                # the stage-cache entry's key
        self.make = make                # builds that entry's step
        self.n_ops = n_ops
        # per stage parameter: (index into the fingerprint's slots, or
        # None for a literal the plan itself fixes, its value, its dtype)
        self.param_src = param_src
        self.reserve_bytes = reserve_bytes
        self.paths: List[str] = [os.path.abspath(p)
                                 for kind, node in self.recipes
                                 if kind == "file" for p in node.paths]
        self.conf_snapshot = conf_snapshot
        self.nbytes = nbytes
        self.planning_ms = 0.0
        self.hits = 0

    def params(self, fp: PlanFingerprint) -> Tuple:
        """The stage entry's parameter values for the statement ``fp``."""
        return tuple(
            np.asarray(value if i is None else fp.slots[i].value, dtype=dt)
            for i, value, dt in self.param_src)


class _StageEntry:
    """One cached MESH-LANE statement: bookkeeping only.

    The mesh lane cannot be one captured program (its shards take turns
    at every collective), so what the plan cache stores for it is the
    STATEMENT-level record — its fingerprint, the conf snapshot
    invalidation needs, and the stage-cache build cost its first run
    paid.  A hit reports ``cacheHit`` to the server and runs the
    statement again."""

    __slots__ = ("key", "kind", "paths", "conf_snapshot", "planning_ms",
                 "hits")

    def __init__(self, key: str, kind: str, paths, conf_snapshot,
                 planning_ms: float):
        self.key = key
        self.kind = kind                # dist (multibatch/stages: later)
        self.paths = paths
        self.conf_snapshot = conf_snapshot
        self.planning_ms = planning_ms
        self.hits = 0


#: fixed per-entry estimate of the host plan objects an entry holds; its
#: graph's device bytes are charged to the memory manager by the stage
#: cache, not here
_ENTRY_OVERHEAD_BYTES = 64 << 10


class PlanCache:
    """Thread-safe LRU: fingerprint → cached plan, shared across every
    ``_ServerSession`` (attach via ``session._plan_cache``)."""

    def __init__(self, conf):
        self._conf = conf
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, _Entry]" = \
            collections.OrderedDict()
        self._bytes = 0
        # fingerprints whose cached run overflowed its static capacities:
        # they need the adaptive replan loop, so caching would thrash
        self._poisoned: set = set()
        # per-fingerprint single-flight build locks: N sessions missing
        # the same plan at once must pay ONE build, not N
        self._building: Dict[str, threading.Lock] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.uncacheable = 0
        self._stage_entries: "collections.OrderedDict[str, _StageEntry]" \
            = collections.OrderedDict()
        self.stage_hits = 0
        self.stage_misses = 0

    # -- stats ---------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "uncacheable": self.uncacheable,
                "entries": len(self._entries), "bytes": self._bytes,
                "stage_entries": len(self._stage_entries),
                "stage_hits": self.stage_hits,
                "stage_misses": self.stage_misses,
            }

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- bounded LRU mechanics ----------------------------------------
    def _get(self, key: str) -> Optional[_Entry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
            return entry

    def _put(self, entry: _Entry) -> None:
        max_entries = int(self._conf.get(C.SERVER_PLAN_CACHE_MAX_ENTRIES))
        max_bytes = int(self._conf.get(C.SERVER_PLAN_CACHE_MAX_BYTES))
        if entry.nbytes > max_bytes:
            with self._lock:
                self.uncacheable += 1
            return
        with self._lock:
            old = self._entries.pop(entry.key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[entry.key] = entry
            self._bytes += entry.nbytes
            while self._entries and (
                    len(self._entries) > max_entries
                    or self._bytes > max_bytes):
                _k, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                self.evictions += 1

    def _drop(self, key: str, count_invalidation: bool = False) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._bytes -= entry.nbytes
                if count_invalidation:
                    self.invalidations += 1

    def _poison(self, key: str) -> None:
        with self._lock:
            if len(self._poisoned) > 1024:
                self._poisoned.clear()
            self._poisoned.add(key)

    def _evict_where(self, pred) -> int:
        """Drop every entry and stage entry ``pred`` holds for (caller
        holds the lock); returns how many went."""
        victims = [k for k, e in self._entries.items() if pred(e)]
        for k in victims:
            self._bytes -= self._entries.pop(k).nbytes
        stage_victims = [k for k, e in self._stage_entries.items()
                         if pred(e)]
        for k in stage_victims:
            del self._stage_entries[k]
        n = len(victims) + len(stage_victims)
        self.invalidations += n
        return n

    # -- invalidation --------------------------------------------------
    def invalidate_paths(self, path: str) -> int:
        """Evict every entry reading under/above ``path`` (a table or
        database directory a DDL/DML or a write just mutated), whichever
        session built it."""
        p = os.path.abspath(path)

        def overlaps(entry):
            return any(leaf == p or leaf.startswith(p + os.sep)
                       or p.startswith(leaf + os.sep)
                       for leaf in entry.paths)

        with self._lock:
            return self._evict_where(overlaps)

    def invalidate_conf(self, key: str, old: Any, new: Any) -> int:
        """A planning-relevant conf changed in SOME session: evict
        entries built under the session's old value.  (The fingerprint's
        conf component already guarantees correctness — this is hygiene,
        freeing entries the setting session can no longer hit.)"""
        if key not in PLANNING_CONF_KEYS or old == new:
            return 0
        with self._lock:
            return self._evict_where(
                lambda e: e.conf_snapshot.get(key) == old)

    def invalidate_all(self) -> None:
        with self._lock:
            self._evict_where(lambda e: True)

    # -- execution integration ----------------------------------------
    def try_execute(self, qe) -> Optional[Any]:
        """The QueryExecution hook: run ``qe`` through the cache.

        Returns the finished host ColumnBatch, or None to fall through
        to the normal adaptive execution path (uncacheable plan, a lane
        that captures nothing, poisoned fingerprint, or capacity
        overflow)."""
        session = qe.session
        info = {"hit": False, "skippedMs": 0.0}
        session._last_plan_cache_info = info
        if not (session.conf.get(C.CODEGEN_ENABLED)
                and session.conf.get(C.STAGE_FUSION)):
            return None                  # eager / per-op: nothing to cache
        from ..sql.udf import plan_has_slow_udf
        if plan_has_slow_udf(qe.optimized):
            return None                  # row-lane UDF: runs eager
        fp = fingerprint(session, qe.optimized)
        if fp is None:
            with self._lock:
                self.uncacheable += 1
            return None
        qe._plan_fp = fp                 # for adopt() after an overflow
        entry = self._get(fp.key)
        if entry is None:
            with self._lock:
                if fp.key in self._poisoned:
                    self.misses += 1
                    return None
                build_lock = self._building.setdefault(
                    fp.key, threading.Lock())
            # single-flight: the herd blocks here while one thread
            # builds, then re-checks and takes the hit path
            with build_lock:
                entry = self._get(fp.key)
                if entry is None:
                    with self._lock:
                        self.misses += 1
                    try:
                        return self._build_and_run(qe, fp)
                    finally:
                        with self._lock:
                            self._building.pop(fp.key, None)
        try:
            out = self._run_entry(qe, entry, fp)
        except _StaleEntry:
            self._drop(fp.key, count_invalidation=True)
            with self._lock:
                self.misses += 1
            return self._build_and_run(qe, fp)
        if out is None:                  # overflow under THIS data shape
            self._drop(fp.key)
            self._poison(fp.key)
            with self._lock:
                self.misses += 1
            return None
        with self._lock:
            self.hits += 1
        entry.hits += 1
        info["hit"] = True
        info["skippedMs"] = entry.planning_ms
        return out

    def run_staged(self, qe, kind: str, thunk) -> Any:
        """The cache hook for statements of the MESH LANE (``kind``
        ``dist``) and of the OUT-OF-CORE runners (``multibatch``,
        ``stages``), which stream, fork and shard: there is no single
        program to store.  Execution always goes through ``thunk`` — the
        per-batch steps live in the process stage cache, keyed by their
        fingerprints — and what is cached cross-session is the
        statement-level ``_StageEntry``.  A hit reports
        ``cacheHit``/``planningSkippedMs`` to the server; literals in
        slot positions share one entry by the same fingerprint slotting
        as the local path."""
        session = qe.session
        info = {"hit": False, "skippedMs": 0.0}
        session._last_plan_cache_info = info
        if not session.conf.get(C.CODEGEN_ENABLED):
            return thunk()
        fp = fingerprint(session, qe.optimized)
        if fp is None:
            with self._lock:
                self.uncacheable += 1
            return thunk()
        key = f"stage|{kind}|{fp.key}"
        with self._lock:
            entry = self._stage_entries.get(key)
            if entry is not None:
                self._stage_entries.move_to_end(key)
        if entry is not None:
            out = thunk()
            # sub-plans the thunk ran eagerly (a stage DAG's broadcast
            # sides, grace bucket joins) reported on their own: the
            # statement's report is this one
            session._last_plan_cache_info = info
            with self._lock:
                self.stage_hits += 1
            entry.hits += 1
            info["hit"] = True
            info["skippedMs"] = entry.planning_ms
            return out
        # miss: run the statement, charging it the stage-cache build cost
        # paid during this execution — the cost every later
        # fingerprint-equal statement skips
        from ..sql.stagecompile import stage_cache
        sc = stage_cache(session)
        ms0 = sc.stats()["compile_ms"]
        out = thunk()                    # exceptions propagate unrecorded
        session._last_plan_cache_info = info
        paths = [os.path.abspath(p) for rel in _file_relations(qe.optimized)
                 for p in rel.paths]
        conf_snapshot = {e.key: session.conf.get(e)
                         for e in FINGERPRINT_CONF_ENTRIES}
        planning_ms = round(max(sc.stats()["compile_ms"] - ms0, 0.0), 1)
        entry = _StageEntry(key, kind, paths, conf_snapshot, planning_ms)
        max_entries = int(self._conf.get(C.SERVER_PLAN_CACHE_MAX_ENTRIES))
        with self._lock:
            self.stage_misses += 1
            self._stage_entries[key] = entry
            while len(self._stage_entries) > max(max_entries, 1):
                self._stage_entries.popitem(last=False)
                self.evictions += 1
        return out

    def _build_and_run(self, qe, fp: PlanFingerprint) -> Optional[Any]:
        t0 = time.perf_counter()
        entry = self._new_entry(qe, fp, qe.planned)
        if entry is None:
            return None
        out = self._run_entry(qe, entry, fp)
        if out is None:
            self._poison(fp.key)
            return None
        # first-build cost ≈ what every later hit skips (plan, stage key
        # and the stage entry's warm-up + capture dominate a first run)
        entry.planning_ms = round((time.perf_counter() - t0) * 1000, 1)
        self._put(entry)
        return out

    def adopt(self, qe, pq, planning_ms: float) -> None:
        """Keep the plan the adaptive replan loop found for a statement
        whose cached capacities overflowed (``qe._plan_fp``, poisoned by
        ``try_execute``): the fingerprint is un-poisoned and its entry is
        that plan, whose stage entry the loop has just built.  (The JAX
        package leaves such a fingerprint poisoned, so its repeats never
        hit.)"""
        fp = getattr(qe, "_plan_fp", None)
        if fp is None:
            return
        entry = self._new_entry(qe, fp, pq)
        if entry is None:
            return
        entry.planning_ms = round(planning_ms, 1)
        with self._lock:
            self._poisoned.discard(fp.key)
        self._put(entry)

    def _new_entry(self, qe, fp: PlanFingerprint, pq) -> Optional[_Entry]:
        """The entry of ``pq`` under ``fp``, or None (counted) when it
        cannot be cached."""
        from ..sql.planner import (_plan_reserve_bytes, compose_stage_key,
                                   stage_maker)
        from ..sql.stagecompile import count_ops, stage_fingerprint

        # the planner's in-memory leaves must be the plan's own batches,
        # which the fingerprint names by uid; file leaves are named by
        # their relation's fields
        named = {id(r.batch) for r in _leaf_relations(qe.optimized)}
        body, pslots = stage_fingerprint(pq.physical)
        skey = compose_stage_key(qe.session, body, pq.leaves)
        # every slotted literal of the statement must be a parameter of
        # the stage, or a variant would replay this one's value
        where = {id(lit): i for i, lit in enumerate(fp.slots)}
        param_src = [(where.get(id(l)), l.value, l.dtype.np_dtype)
                     for l in pslots]
        recipes = pq.leaf_recipes
        if recipes is None or len(recipes) != len(pq.leaves) or any(
                kind == "opaque" or kind in ("local", "cached")
                and id(node.batch) not in named
                for kind, node in recipes) or \
                {i for i, _v, _d in param_src} - {None} \
                != set(range(len(fp.slots))):
            with self._lock:
                self.uncacheable += 1
            return None
        conf_snapshot = {e.key: qe.session.conf.get(e)
                         for e in FINGERPRINT_CONF_ENTRIES}
        return _Entry(fp.key, pq, body, pslots, skey,
                      stage_maker(pq, pslots, qe.session.device, skey),
                      count_ops(pq.physical), param_src,
                      _plan_reserve_bytes(pq), conf_snapshot,
                      _ENTRY_OVERHEAD_BYTES)

    @staticmethod
    def _materialize(recipe, session):
        kind, node = recipe
        if kind == "local":
            return node.batch
        if kind == "cached":
            batch = session._cache.get(node.cache_key)
            if batch is None:
                raise _StaleEntry(f"cached relation {node.cache_key[:60]}"
                                  " was unpersisted")
            return batch
        from ..io import read_file_relation
        return read_file_relation(node, session)

    def _run_entry(self, qe, entry: _Entry,
                   fp: PlanFingerprint) -> Optional[Any]:
        from ..sql.planner import (PlannedQuery, _plan_reserve_bytes,
                                   compose_stage_key, stage_maker)
        session = qe.session
        skey, make, reserve = entry.skey, entry.make, entry.reserve_bytes
        if entry.paths or any(b is None for b in entry.leaves):
            # file leaves are read again (a relation-cache hit while the
            # files are unchanged; a changed file keys a new stage entry),
            # and cached relations from the cache manager
            leaves = [self._materialize(r, session) for r in entry.recipes]
            if any(a is not b for a, b in zip(leaves, entry.leaves)):
                pq = PlannedQuery(entry.physical, leaves, entry.recipes)
                skey = compose_stage_key(session, entry.body, leaves)
                make = stage_maker(pq, entry.pslots, session.device, skey)
                reserve = _plan_reserve_bytes(pq)
        else:
            leaves = entry.leaves
        for batch, want in zip(leaves, entry.leaf_schemas):
            if batch.schema.simpleString() != want:
                raise _StaleEntry(
                    f"leaf schema drifted: {batch.schema.simpleString()}"
                    f" != {want}")
        mem = session._memory
        owner = f"query:{id(qe)}"
        mem.acquire_execution(owner, reserve)
        try:
            result, ratio = qe._dispatch_stage(
                PlannedQuery(entry.physical, leaves), skey, make,
                entry.n_ops, entry.params(fp))
        finally:
            mem.release_execution(owner)
        return None if ratio > 0.0 else result

    def metrics_source(self):
        """Gauges for the metrics system ('serving' Source half; the
        server merges admission gauges in)."""
        return {
            "plan_cache_hits": lambda: self.stats()["hits"],
            "plan_cache_misses": lambda: self.stats()["misses"],
            "plan_cache_evictions": lambda: self.stats()["evictions"],
            "plan_cache_invalidations":
                lambda: self.stats()["invalidations"],
            "plan_cache_bytes": lambda: self.stats()["bytes"],
            "plan_cache_entries": lambda: self.stats()["entries"],
            "plan_cache_stage_entries":
                lambda: self.stats()["stage_entries"],
            "plan_cache_stage_hits": lambda: self.stats()["stage_hits"],
            "plan_cache_stage_misses":
                lambda: self.stats()["stage_misses"],
        }


def _relations(plan, cls) -> list:
    out = []

    def walk(node):
        if isinstance(node, cls):
            out.append(node)
        for c in node.children:
            walk(c)

    walk(plan)
    return out


def _leaf_relations(plan) -> list:
    """The LocalRelation leaves of an optimized plan."""
    from ..sql import logical as L
    return _relations(plan, L.LocalRelation)


def _file_relations(plan) -> list:
    """The FileRelation leaves of an optimized plan."""
    from ..sql import logical as L
    return _relations(plan, L.FileRelation)
