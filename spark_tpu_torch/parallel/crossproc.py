"""Cross-process query execution over the host shuffle service.

The port of ``spark_tpu/parallel/crossproc.py``: query state that
crosses PROCESS boundaries moves through ``HostShuffleService`` blocks
(the ``ExternalShuffleBlockResolver.java:57`` role).  Inside a process
every local run is the ordinary engine on the session's card.

Entry points:

- ``crossproc_execute`` — the planner's: ``session.enableHostShuffle``
  registers the service, and from then on every ``session.sql`` /
  DataFrame action routes here (``QueryExecution._execute_inner``).
- ``host_exchange_group_agg`` — the explicit helper: one keyed
  aggregate over a caller's service.

Leaf contract: every process runs the same queries in the same order,
and each leaf (``createDataFrame``, a file scan) holds THIS process's
partition.  Leaves that are byte-identical in every process are
replicated (one digest exchange tells them apart); set
``spark.tpu.crossproc.dedupReplicated=false`` to force union semantics.

Execution shapes:

1. keyed-aggregate FAST path — the root (under Project/Sort/Limit) is a
   keyed, mergeable Aggregate over a subtree with no global operator,
   whose joins are partition-safe, with exactly ONE partitioned leaf:
   each process runs the subtree and ``DPartialAggregate`` on its card,
   buckets the partial states by key hash on the card, reads them back
   in ONE packed copy, exchanges them, merges and finishes its key range
   (``DFinalAggregate``, on the host), and gathers the result.
2. shuffled HASH join — the per-row spine roots in an equi-join whose
   sides BOTH hold one partitioned leaf: both sides co-partition by
   join-key hash into fine partitions (bucketed on the card), a
   manifest-only size round fixes the reducer plan everywhere alike,
   and each process joins one disjoint key range locally.  A side that
   is a keyed Aggregate whose keys subsume the join keys ships partial
   state instead of rows.
3. RANGE merge join — one orderable equi key: a sample round agrees on
   cut points, rows ship as per-span sorted runs (skewed spans split
   across reducers with the build span replicated), and the receiver
   k-way-merges its build runs for ``PMergeJoin``.
4. BROADCAST join — one side's global volume under
   ``spark.tpu.crossproc.autoBroadcastThreshold`` and under the other
   side's per-process share: only that side gathers.
5. GENERIC path — everything else: partitioned leaves gather through the
   service, then the whole plan runs locally, identically everywhere.

Past an exchange, a reducer whose drained shard will not fit the host
ledger degrades into GRACE buckets: both sides re-bucket by join-key
hash into spill files and join bucket by bucket on the card (each pair a
pinned ``LocalRelation``, so it reaches a captured graph by
``non_blocking`` copies).

Failures: a lost peer surfaces as a structured ``ExchangeFetchFailed``
(after one refetch), bounded in time.  Up to
``spark.tpu.recovery.maxStageRetries`` times per statement the survivors
then agree on the loss (``HostShuffleService.recover_round``), re-read
the dead peer's partitioned leaves from the file recipes it published in
the digest round, and re-execute the statement under a fresh epoch
(``{xid}e<epoch>`` exchange ids, so the dead epoch's blocks are never
read).  A loss that lineage cannot cover (in-memory leaves, a peer lost
before its recipes were published, a diverged agreement) aborts with
``recoverable=False``.  With the block service on, a sealed dead
sender's output is adopted at the barrier before any loss surfaces.
With ``spark.tpu.shuffle.ici.enabled`` the hash and range lanes put the
device tier in front of the host exchange (``_tiered_exchange_with_
refetch``): spans for processes on the same card go through the
sender's device arena and are pulled by kernel K2 (``ici.py``).

``STATS`` accumulates this process's time split (local runs, bucketing
on the card, read-backs, host merges) for the chip script.
"""

from __future__ import annotations

import copy
import hashlib
import os
import pickle
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as C
from .. import kernels as K
from .. import types as T
from .. import wire
from ..columnar import (ColumnBatch, ColumnVector, live_prefix, union_all,
                        unmaterialized_runs)
from ..expressions import Col, EvalContext, Hash64, Literal
from ..memory import HostMemoryError, HostMemoryPressure
from ..sql import physical as P
from .hostshuffle import ExchangeFetchFailed, FetchSink, HostShuffleService

__all__ = ["host_exchange_group_agg", "crossproc_execute",
           "choose_join_strategy", "adaptive_join_decision",
           "observed_side_stats", "elastic_reducer_width", "StatsFeedback",
           "ExchangeFetchFailed", "STATS", "reset_stats", "RECOVERY_STATS",
           "reset_recovery_stats"]

#: this process's time split, milliseconds: ``local_ms`` in local runs
#: (engine and read-back of their results), ``bucket_ms`` the device time
#: of hashing and bucketing map sides on the card (CUDA events; host time
#: on a CPU session), ``readback_ms`` the packed copies of bucketed sides
#: to the host, ``merge_ms`` host merges past the hop (final aggregates,
#: k-way merges, unions), ``bytes_readback`` what those copies moved
STATS: Dict[str, float] = {}


def reset_stats() -> None:
    STATS.clear()
    STATS.update(local_ms=0.0, bucket_ms=0.0, readback_ms=0.0,
                 merge_ms=0.0, bytes_readback=0, bucketings=0)


reset_stats()


def _one_dead_row(batch: ColumnBatch) -> ColumnBatch:
    """A capacity-1 batch of ``batch``'s schema whose one row is DEAD: it
    stands in for an empty shard (a capacity-0 input makes the join and
    aggregate gathers ill-formed)."""
    vectors = [
        ColumnVector(torch.zeros((1,) + tuple(v.data.shape[1:]),
                                 dtype=v.data.dtype), v.dtype,
                     torch.zeros(1, dtype=torch.bool), v.dictionary)
        for v in batch.vectors
    ]
    return ColumnBatch(list(batch.names), vectors,
                       torch.zeros(1, dtype=torch.bool), 1)


def _live(batch: ColumnBatch) -> int:
    return int(batch.num_rows())


def _concat(batches: List[ColumnBatch]) -> ColumnBatch:
    return union_all(batches) if len(batches) > 1 else batches[0]


def _host(batch: ColumnBatch) -> ColumnBatch:
    return K.compact(batch.to_host())


# ---------------------------------------------------------------------------
# shared predicates + pipeline pieces
# ---------------------------------------------------------------------------

def _has_global_ops(node) -> bool:
    """Operators whose result depends on the GLOBAL multiset: computed per
    process over a partitioned input they are wrong."""
    from ..sql import logical as L
    from ..sql.window import WindowNode
    if isinstance(node, (L.Aggregate, L.Distinct, L.Limit, L.Sample)) \
            or isinstance(node, WindowNode):
        return True
    return any(_has_global_ops(c) for c in node.children)


def _mergeable(agg) -> bool:
    """A keyed aggregate whose every function has a fixed-width partial
    form that merges across processes (not collect_list/set, not a
    percentile)."""
    return bool(agg.keys) and not any(
        getattr(f, "is_collect", False) or getattr(f, "is_percentile", False)
        for f, _n in agg.aggs)


def _joins_maybe_safe(node) -> bool:
    """Cheap pre-filter before the digest exchange: outer joins can never
    run per process below a partial aggregate (they null-extend once PER
    PROCESS)."""
    from ..sql import logical as L
    if isinstance(node, L.Join) and node.how not in (
            "inner", "cross", "left_semi", "left_anti"):
        return False
    return all(_joins_maybe_safe(c) for c in node.children)


def _n_leaves(node) -> int:
    from ..sql import logical as L
    n = sum(_n_leaves(c) for c in node.children)
    if isinstance(node, (L.LocalRelation, L.FileRelation)):
        n += 1
    return n


def _joins_partition_safe(node, flags: List[bool], base: int = 0) -> bool:
    """Flag-aware join guard for per-process local execution: INNER and
    CROSS joins are always safe; LEFT SEMI/ANTI when the right side is
    fully REPLICATED.  ``flags`` is the digest classification in
    ``_leaf_batches`` order, ``base`` this subtree's first leaf."""
    from ..sql import logical as L
    if isinstance(node, L.Join):
        nl = _n_leaves(node.children[0])
        nr = _n_leaves(node.children[1])
        if node.how not in ("inner", "cross"):
            right_partitioned = any(flags[base + nl: base + nl + nr])
            if node.how not in ("left_semi", "left_anti") \
                    or right_partitioned:
                return False
        return (_joins_partition_safe(node.children[0], flags, base)
                and _joins_partition_safe(node.children[1], flags,
                                          base + nl))
    b = base
    for c in node.children:
        if not _joins_partition_safe(c, flags, b):
            return False
        b += _n_leaves(c)
    return True


def _find_spine_join(node):
    """The topmost Join reachable through per-row single-child operators
    only (alias/project/filter), or None."""
    from ..sql import logical as L
    while isinstance(node, (L.SubqueryAlias, L.Project, L.Filter)):
        node = node.children[0]
    return node if isinstance(node, L.Join) else None


def _replace_node(root, target, replacement):
    """``root`` with the (identity-matched) ``target`` subtree swapped for
    ``replacement``; untouched subtrees are shared."""
    if root is target:
        return replacement
    new_children = tuple(_replace_node(c, target, replacement)
                         for c in root.children)
    if new_children == tuple(root.children):
        return root
    out = copy.copy(root)
    out.children = new_children
    return out


def _batch_digest(batch: ColumnBatch) -> int:
    """Order-sensitive content digest of a host batch (the replication
    check), over the same bytes the JAX package digests."""
    h = hashlib.sha256()
    b = batch.to_host()
    h.update(pickle.dumps(list(b.names)))
    for v in b.vectors:
        rv = unmaterialized_runs(v)
        if rv is not None:
            # a run-coded column digests its run TABLE: the wire's run
            # coding is content-deterministic, and the probe charges no
            # materialization for rows no operator touched
            h.update(b"runs:")
            h.update(np.ascontiguousarray(rv.run_values.numpy()).tobytes())
            h.update(np.ascontiguousarray(rv.run_lengths.numpy()).tobytes())
            h.update(b"|" if v.valid is None else
                     np.ascontiguousarray(v.valid.numpy()).tobytes())
            h.update(pickle.dumps(v.dictionary))
            continue
        h.update(b"dense:")
        h.update(np.ascontiguousarray(v.data.numpy()).tobytes())
        h.update(b"|" if v.valid is None else
                 np.ascontiguousarray(v.valid.numpy()).tobytes())
        h.update(pickle.dumps(v.dictionary))
    return int.from_bytes(h.digest()[:8], "little", signed=True)


class _Timer:
    """Device time of a stretch of queued work on a card (CUDA events,
    read after the next synchronizing copy), host time on a CPU
    session."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.end.record()
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3

    def elapsed_ms(self) -> float:
        return self.start.elapsed_time(self.end) if self.cuda else self.ms


def _bucket_to_host(batch: ColumnBatch, ids_fn, n_parts: int,
                    tie_keys_fn=None
                    ) -> Tuple[ColumnBatch, np.ndarray, np.ndarray]:
    """Map-side bucketing on the batch's device, then ONE packed copy to
    the host (``kernels.bucketed_to_host``).  ``ids_fn(batch)`` computes
    the partition ids (and ``tie_keys_fn`` the in-bucket order) on the
    device, inside the timed stretch."""
    timer = _Timer(batch.device)
    ids = ids_fn(batch)
    ties = tie_keys_fn(batch) if tie_keys_fn is not None else None
    bucketed, _off, counts = K.partition_bucket(batch, ids, n_parts, ties)
    timer.stop()
    t0 = time.perf_counter()
    host, off, cnt = K.bucketed_to_host(bucketed, counts)
    STATS["readback_ms"] += (time.perf_counter() - t0) * 1e3
    STATS["bucket_ms"] += timer.elapsed_ms()
    STATS["bucketings"] += 1
    STATS["bytes_readback"] += wire.raw_nbytes([host]) + cnt.nbytes
    return host, off, cnt


def _hash_ids(exprs, n_parts: int, owners: Optional[Sequence[int]] = None):
    """``ids_fn`` of ``_bucket_to_host``: ``Hash64(exprs)`` as uint64
    modulo ``n_parts``, mapped through ``owners`` (a pid per residue)
    when given — bit-exact with the JAX package's numpy bucketing."""
    def ids(batch: ColumnBatch) -> torch.Tensor:
        ectx = EvalContext(batch)
        h = ectx.broadcast(Hash64(*exprs).eval(ectx)).data
        r = K.unsigned_mod(h, n_parts)
        if owners is not None:
            r = torch.as_tensor(list(owners), dtype=torch.int64,
                                device=batch.device)[r]
        return r.to(torch.int32)
    return ids


def _timed_merge(fn):
    """``fn()``, its host time added to ``STATS["merge_ms"]``."""
    t0 = time.perf_counter()
    try:
        return fn()
    finally:
        STATS["merge_ms"] += (time.perf_counter() - t0) * 1e3


def _leaf_relation(session, batch: ColumnBatch):
    """A host batch as a plan leaf: pinned on a card session, so it
    reaches a captured graph by ``non_blocking`` copies."""
    from ..sql import logical as L
    if session.device.type == "cuda" and batch.device.type == "cpu" \
            and batch.vectors and not batch.is_pinned():
        batch = batch.pinned()
    return L.LocalRelation(batch)


def _route_exchange_merge(session, plan, partial_node, partial: ColumnBatch,
                          svc: HostShuffleService, xid: str) -> ColumnBatch:
    """The aggregation exchange shared by both entry points: route the
    partial states by key hash (bucketed on their device, one packed
    read-back), hop, merge colliding partials and finish with the final
    node the mesh lane uses."""
    from .dist import DFinalAggregate

    key_refs = [Col(k.name) for k in plan.keys]
    # key hash → LIVE pid: agreed-lost peers own no key range
    lv = svc.live_pids()
    bucketed, off, cnt = _bucket_to_host(
        partial, _hash_ids(key_refs, len(lv), lv), svc.n)
    routed = {int(r): [K.host_slice(bucketed, int(off[r]), int(cnt[r]))]
              for r in lv}
    # partial states are read exactly once by the final merge: raw frames
    svc.mark_raw(xid)
    received = _exchange_with_refetch(svc, xid, routed)

    def merge():
        alive = [b for b in received if _live(b)] or [_one_dead_row(bucketed)]
        state = _concat(alive)
        final = DFinalAggregate(plan.keys, plan.aggs, partial_node,
                                P.PScan(0, state.schema)).run(
            P.ExecContext("cpu", [state]))
        return K.compact(final)
    return _timed_merge(merge)


def _partial_over(plan, child_batch: ColumnBatch, svc=None) -> Tuple:
    """``DPartialAggregate`` over a local result, on its device.  First/
    last ranks carry the process id in their high bits (``pid << 48``,
    the mesh encoding), so "globally first" means the same thing in
    every process (the JAX package rebases them afterwards:
    ``_rebase_first_ranks``)."""
    from .dist import DPartialAggregate
    child_schema = plan.children[0].schema()
    partial_node = DPartialAggregate(plan.keys, plan.aggs,
                                     P.PScan(0, child_schema))
    ctx = P.ExecContext(child_batch.device, [child_batch])
    if svc is not None and svc.n > 1:
        ctx.shard_offset = svc.pid << 48
    # the groups are the live prefix of the partial's capacity (one
    # scalar read): everything after works on the groups alone
    return partial_node, live_prefix(partial_node.run(ctx))


# ---------------------------------------------------------------------------
# the explicit helper
# ---------------------------------------------------------------------------

def host_exchange_group_agg(session, df, svc: HostShuffleService,
                            exchange_id: str) -> ColumnBatch:
    """Run ``df`` (whose plan must root in a keyed groupBy aggregate)
    with its aggregation exchange crossing PROCESS boundaries through
    ``svc``; each process returns the final rows of its key range."""
    from ..sql import logical as L
    from ..sql.multibatch import host_run
    from ..sql.planner import QueryExecution

    plan = QueryExecution(session, df._plan).optimized
    above: List = []                     # Projects over the aggregate
    while isinstance(plan, (L.SubqueryAlias, L.Project)):
        if isinstance(plan, L.Project):
            above.append(plan)
        plan = plan.children[0]
    if not isinstance(plan, L.Aggregate):
        raise ValueError(
            f"host_exchange_group_agg needs a groupBy aggregate at the "
            f"root, got {type(plan).__name__}")
    if not plan.keys:
        raise ValueError("global aggregates have no key range to "
                         "exchange; run them per process and combine")
    if _has_global_ops(plan.children[0]):
        raise ValueError(
            "a global operator below the cross-process exchange would "
            "compute per process over a partitioned input; route through "
            "session.enableHostShuffle, whose generic path handles it")
    if not _mergeable(plan):
        raise ValueError("the aggregate has no mergeable partial form")
    child_batch = _run_local(session, plan.children[0], on_device=True)
    partial_node, partial = _partial_over(plan, child_batch, svc)
    result = _route_exchange_merge(session, plan, partial_node, partial,
                                   svc, exchange_id)
    for proj in reversed(above):
        result = host_run(session, L.Project(proj.exprs,
                                             L.LocalRelation(result)))
    return result


# ---------------------------------------------------------------------------
# planner-citizen execution
# ---------------------------------------------------------------------------

def _run_local(session, plan, on_device: bool = False) -> ColumnBatch:
    """Run a plan through the normal LOCAL engine on the session's card,
    with the cross-process hop off so the recursion grounds out, the mesh
    pinned to one shard, and the outer query's ``_last_qe`` kept.  The
    result is compacted, on the host — or, with ``on_device``, left on the
    card (``QueryExecution.keep_on_device``) for bucketing there."""
    from ..sql.planner import QueryExecution
    svc = session._crossproc_svc
    last_qe = session._last_qe
    old_shards = session.conf._overrides.get(C.MESH_SHARDS.key)
    session._crossproc_svc = None
    session.conf.set(C.MESH_SHARDS.key, "1")
    t0 = time.perf_counter()
    try:
        qe = QueryExecution(session, plan)
        qe.keep_on_device = on_device
        out = qe.execute()
        return out.to_device(session.device) if on_device else out.to_host()
    finally:
        STATS["local_ms"] += (time.perf_counter() - t0) * 1e3
        session._crossproc_svc = svc
        session._last_qe = last_qe
        if old_shards is None:
            session.conf.unset(C.MESH_SHARDS.key)
        else:
            session.conf.set(C.MESH_SHARDS.key, old_shards)


def _leaf_batches(session, node, out: List[ColumnBatch]) -> None:
    """The host batch of every leaf relation, in deterministic plan order
    (same plan in every process → same order)."""
    from ..sql import logical as L
    for c in node.children:
        _leaf_batches(session, c, out)
    if isinstance(node, L.LocalRelation):
        out.append(_host(node.batch))
    elif isinstance(node, L.FileRelation):
        from ..io import read_file_relation
        out.append(_host(read_file_relation(node, session)))


def _harvest_leaf_recipes(node) -> List[dict]:
    """The re-read recipe of every leaf in ``_leaf_batches`` order: a
    ``FileRelation`` names its files (the lineage a survivor could
    re-read for a dead peer), a ``LocalRelation`` lives only in its
    process (``kind: local``)."""
    from ..sql import logical as L
    out: List[dict] = []

    def walk(nd):
        for c in nd.children:
            walk(c)
        if isinstance(nd, L.FileRelation):
            ps = [str(p) for p in getattr(nd, "paths", None) or ()]
            out.append({"kind": "file", "fmt": nd.fmt, "paths": ps} if ps
                       else {"kind": "local"})
        elif isinstance(nd, L.LocalRelation):
            out.append({"kind": "local"})

    walk(node)
    return out


def _leaf_partition_flags(session, node, svc: HostShuffleService,
                          xid: str,
                          batches_out: Optional[List[ColumnBatch]] = None,
                          sizes_out: Optional[List[int]] = None
                          ) -> List[bool]:
    """One digest exchange classifying every leaf: True = partitioned
    (content differs across processes), False = replicated.  The leaf
    batches land in ``batches_out`` so a later gather never re-reads
    them; ``sizes_out`` receives each leaf's GLOBAL raw byte size
    (partitioned: summed; replicated: one copy), the broadcast planner's
    statistics.  The manifests carry every sender's leaf recipes."""
    batches: List[ColumnBatch] = []
    _leaf_batches(session, node, batches)
    if batches_out is not None:
        batches_out.extend(batches)
    if not batches:
        return []
    digests = np.array([_batch_digest(b) for b in batches], np.int64)
    nbytes = np.array([wire.raw_nbytes([b]) for b in batches], np.int64)

    def col(a):
        return ColumnVector(torch.from_numpy(a), T.int64, None, None)
    probe = ColumnBatch(
        ["leaf", "digest", "bytes"],
        [col(np.arange(len(digests), dtype=np.int64)), col(digests),
         col(nbytes)], None, len(digests))
    received = svc.exchange(
        xid, {r: [probe] for r in range(svc.n)},
        extra={"recipes": _harvest_leaf_recipes(node),
               "epoch": svc.epoch})
    # setdefault keeps the statement's FIRST (pre-loss) recipes through
    # its epochs; ``begin_statement`` clears them between statements
    for s in range(svc.n):
        man = svc.read_manifest(xid, s)
        if man is not None and isinstance(man.get("recipes"), list):
            svc.leaf_recipes.setdefault(s, man["recipes"])
    flags = np.zeros(len(digests), bool)
    totals = np.zeros(len(digests), np.int64)
    n_seen = 0
    for b in received:
        other = b.column("digest").data.numpy()
        flags |= other[: len(digests)] != digests
        totals += b.column("bytes").data.numpy()[: len(digests)]
        n_seen += 1
    if sizes_out is not None:
        sizes_out.extend(
            int(totals[i]) if flags[i]
            else int(totals[i]) // max(n_seen, 1)
            for i in range(len(digests)))
    return flags.tolist()


def _gather_all(svc: HostShuffleService, xid: str, batch: ColumnBatch,
                dedup: bool) -> ColumnBatch:
    """Every process contributes ``batch`` and receives the union; with
    ``dedup``, byte-identical contributions collapse to one copy."""
    received = svc.exchange(xid, {r: [batch] for r in range(svc.n)})

    def merge():
        if dedup and len(received) > 1 \
                and len({_batch_digest(b) for b in received}) == 1:
            return received[0]
        alive = [b for b in received if _live(b)]
        return _concat(alive) if alive else received[0]
    return _timed_merge(merge)


def _gather_leaf_relations(session, plan, svc: HostShuffleService,
                           xid: str, dedup: bool,
                           preloaded: Optional[List[ColumnBatch]] = None):
    """``plan`` with every leaf relation replaced by the gathered union of
    all processes' copies (byte-identical ones kept once with
    ``dedup``).  ``preloaded`` are the digest probe's leaf batches."""
    from ..sql import logical as L
    counter = [0]

    def walk(node):
        new_children = tuple(walk(c) for c in node.children)
        if new_children != tuple(node.children):
            node = copy.copy(node)
            node.children = new_children
        if isinstance(node, (L.LocalRelation, L.FileRelation)):
            i = counter[0]
            counter[0] += 1
            if preloaded is not None and i < len(preloaded):
                local = preloaded[i]
            else:
                local_out: List[ColumnBatch] = []
                _leaf_batches(session, node, local_out)
                local = local_out[0]
            full = _gather_all(svc, f"{xid}-leaf{i}", local, dedup=dedup)
            return _leaf_relation(session, full)
        return node

    return walk(plan)


def _exchange_with_refetch(svc: HostShuffleService, xid: str,
                           routed: Dict[int, List[ColumnBatch]],
                           sink=None, extra=None, pull=None
                           ) -> List[ColumnBatch]:
    """One exchange hop with the loss policy: on a structured fetch
    failure, ONE refetch after a re-barrier; a second loss propagates
    within the 2×-deadline bound.  A ``FetchSink`` keeps retries
    idempotent (a sender's delivery is replaced).  ``extra`` rides the
    commit manifest; ``pull`` is the device tier's receiver half."""
    try:
        return svc.exchange(xid, routed, sink=sink, extra=extra, pull=pull)
    except ExchangeFetchFailed:
        if not svc.refetch_enabled:
            raise
        return svc.refetch(xid, routed, sink=sink, pull=pull)


def _exchange_spilled_with_refetch(svc: HostShuffleService, xid: str,
                                   spill_path: str, routed: Dict[int, list],
                                   meta: Dict[int, Tuple[int, int]],
                                   sink=None, extra=None, pull=None
                                   ) -> List[ColumnBatch]:
    """``_exchange_with_refetch`` for a side whose map output lives in a
    spill file."""
    try:
        return svc.exchange_spilled(xid, spill_path, routed, meta,
                                    sink=sink, extra=extra, pull=pull)
    except ExchangeFetchFailed:
        if not svc.refetch_enabled:
            raise
        return svc.refetch_spilled(xid, spill_path, routed, sink=sink,
                                   pull=pull)


def _ici_tier(session, svc: HostShuffleService):
    """The device-tier confs and the agreed tier split for this exchange
    plan: ``(tier, min_bytes)``, ``tier`` None when the tier is off or
    leaves this process without domain peers.  On the auto path the
    domains are the cards the processes published at
    ``enableHostShuffle`` (every CPU process is its own).  The split's
    fingerprint rides ``decision_inputs`` into the plan round."""
    from . import ici
    if not session.conf.get(C.SHUFFLE_ICI_ENABLED):
        return None, 0
    override = session.conf.get(C.SHUFFLE_ICI_TIER_OVERRIDE)
    live = svc.live_pids()
    facts = None if override else ici.card_facts(svc, live)
    tier = ici.probe_topology(override, svc.pid, svc.n, live, facts)
    with svc._lock:
        svc.counters["tier_split_peers"] = len(tier.peers())
    return (tier if tier.peers() else None), \
        int(session.conf.get(C.SHUFFLE_ICI_MIN_BYTES))


def _fold_back(svc: HostShuffleService) -> None:
    with svc._lock:
        svc.counters["dcn_fallback_exchanges"] += 1


def _tiered_exchange_with_refetch(svc: HostShuffleService, session, plan,
                                  xid: str,
                                  routed: Dict[int, List[ColumnBatch]],
                                  sink, template) -> List[ColumnBatch]:
    """``_exchange_with_refetch`` with the device tier in front: when the
    agreed ``plan`` is active, this process's spans for its domain peers
    go through its device arena (``ici.device_publish``) and leave the
    host routing; the rest, and the commit barrier every peer meets, ride
    the host tier.  Whatever this process did, it pulls the spans its
    peers published for it (``ici.device_pull``) into the sink, keyed by
    sender, where they merge in the canonical own-first, sorted-sender
    order.  A structured device-tier failure here (an injected fault, a
    pack overflow) folds THIS sender's spans back onto the host tier,
    counted; its receivers read them there."""
    from . import ici
    if plan is None or not plan.active \
            or not ici.schema_eligible(template):
        return _exchange_with_refetch(svc, xid, routed, sink=sink)
    dev = {r: bs for r, bs in routed.items()
           if r != svc.pid and plan.tier.same_domain(r)}

    def pull(sink):
        ici.device_pull(svc, session, plan, xid, template, sink)
    try:
        extra = ici.device_publish(svc, session, plan, xid, dev, template)
    except ici.IciUnavailable:
        _fold_back(svc)
        return _exchange_with_refetch(svc, xid, routed, sink=sink,
                                      pull=pull)
    host_routed = {r: bs for r, bs in routed.items() if r not in dev}
    return _exchange_with_refetch(svc, xid, host_routed, sink=sink,
                                  extra=extra, pull=pull)


def _tiered_exchange_spilled_with_refetch(svc: HostShuffleService, session,
                                          plan, xid: str, spill_path: str,
                                          routed: Dict[int, list],
                                          meta: Dict[int, Tuple[int, int]],
                                          sink, template
                                          ) -> List[ColumnBatch]:
    """The spilled-side face of ``_tiered_exchange_with_refetch``: the
    spans for domain peers decode from the spill file (one batch per
    frame, so the run boundaries survive) and go through the arena;
    every other span ships as spill-file byte spans untouched."""
    from . import ici
    if plan is None or not plan.active \
            or not ici.schema_eligible(template):
        return _exchange_spilled_with_refetch(svc, xid, spill_path,
                                              routed, meta, sink=sink)

    def pull(sink):
        ici.device_pull(svc, session, plan, xid, template, sink)
    dev: Dict[int, List[ColumnBatch]] = {}
    try:
        for r in sorted(routed):
            if r != svc.pid and plan.tier.same_domain(r):
                dev[r] = svc.decode_spilled(xid, spill_path, routed[r])
        extra = ici.device_publish(svc, session, plan, xid, dev, template)
    except ici.IciUnavailable:
        _fold_back(svc)
        return _exchange_spilled_with_refetch(svc, xid, spill_path, routed,
                                              meta, sink=sink, pull=pull)
    host_routed = {r: parts for r, parts in routed.items() if r not in dev}
    host_meta = {r: m for r, m in meta.items() if r not in dev}
    return _exchange_spilled_with_refetch(svc, xid, spill_path, host_routed,
                                          host_meta, sink=sink, extra=extra,
                                          pull=pull)


def _exchange_spill_dir(session, xid: str) -> str:
    """A fresh per-query directory for exchange spill files (map-side
    partition frames, reduce-side fetch runs) under the spill root; the
    caller removes it."""
    from ..sql.multibatch import default_spill_dir
    root = default_spill_dir(session.conf)
    os.makedirs(root, exist_ok=True)
    return tempfile.mkdtemp(prefix=f"xspill-{xid}-", dir=root)


class _StagedSide:
    """One join side's bucketed map output, staged in RAM (ledger
    reservation held) or in a spill file of per-partition wire frames."""

    __slots__ = ("kind", "bucketed", "off", "cnt", "path", "offsets",
                 "raw", "rows", "dead")

    def __init__(self, kind, bucketed=None, off=None, cnt=None,
                 path=None, offsets=None, raw=None, rows=None, dead=None):
        self.kind = kind              # "mem" | "disk"
        self.bucketed = bucketed
        self.off = off
        self.cnt = cnt
        self.path = path              # spill file ("disk")
        self.offsets = offsets        # per-partition byte offsets, n+1
        self.raw = raw                # per-partition raw bytes (int64)
        self.rows = rows              # per-partition row counts (int64)
        self.dead = dead              # schema template for empty shards


def _stage_map_side(svc: HostShuffleService, exchange: str,
                    owner: str, bucketed: ColumnBatch, off, cnt,
                    raw: np.ndarray, spill_dir: str) -> _StagedSide:
    """Where one side's bucketed output lives until the exchange lands:
    host RAM under a ledger reservation, or — at or above
    ``spark.tpu.shuffle.spillThresholdBytes``, or when the ledger cannot
    reserve it — a spill file of per-partition wire frames that receivers
    are served from.  A failed spill write is a structured
    ``HostMemoryError``."""
    side_raw = int(raw.sum())
    thresh = svc.spill_threshold
    if not (0 < thresh <= side_raw) \
            and svc.ledger.try_reserve(owner, side_raw):
        return _StagedSide("mem", bucketed=bucketed, off=off, cnt=cnt,
                           raw=raw, dead=bucketed)
    dead = _one_dead_row(bucketed)
    path = os.path.join(spill_dir, f"{exchange}.map")
    slices = [K.host_slice(bucketed, int(off[p]), int(cnt[p]))
              if int(cnt[p]) else None for p in range(len(cnt))]
    try:
        offsets = svc.spill_map_partitions(exchange, slices, path)
    except OSError as e:
        raise HostMemoryError(
            owner, side_raw, svc.ledger.budget,
            holders={owner: svc.ledger.held(owner)}, exchange=exchange,
            detail=f"map-side spill failed: {e}")
    return _StagedSide("disk", path=path, offsets=offsets, raw=raw,
                       rows=np.asarray(cnt, np.int64), dead=dead)


def _bucket_payload_sizes(bucketed: ColumnBatch, cnt: np.ndarray
                          ) -> np.ndarray:
    """Per-bucket payload bytes of a bucketed host batch (live rows first,
    grouped by bucket): raw bytes are a function of per-bucket row
    counts, dtypes and mask presence, and a dictionary column adds the
    characters of the distinct words each bucket references — the JAX
    package's ``_bucket_payload_sizes``, value for value, so every
    process plans the same reducers."""
    n_parts = len(cnt)
    cnt = np.asarray(cnt, np.int64)
    n_live = int(cnt.sum())
    fine = np.repeat(np.arange(n_parts, dtype=np.int64), cnt)
    raw = np.zeros(n_parts, np.int64)
    cap = int(bucketed.capacity)
    for v in bucketed.vectors:
        data = v.data.numpy()
        raw += cnt * (data.nbytes // cap if cap else 0)
        if v.valid is not None:
            raw += (cnt + 7) // 8
        words = v.dictionary
        if words:
            nw = len(words)
            codes = data[:n_live].ravel()
            bf = fine if data.ndim == 1 else np.repeat(fine, data.shape[1])
            ok = (codes >= 0) & (codes < nw)
            pair = np.unique(bf[ok] * nw + codes[ok].astype(np.int64))
            wl = np.fromiter((len(w) for w in words), np.int64, nw)
            np.add.at(raw, pair // nw, wl[pair % nw])
    return raw


def _demote_locals_to_broadcast(svc: HostShuffleService, xid: str,
                                decision: str, locals_: List[ColumnBatch]
                                ) -> Tuple[ColumnBatch, ColumnBatch]:
    """Hash-lane demotion: the big side never moves, the small side's
    local rows gather through ``{xid}-bcast``."""
    small_i = 0 if decision == "broadcast_left" else 1
    small = _gather_all(svc, f"{xid}-bcast", locals_[small_i], dedup=False)
    if not _live(small):
        small = _one_dead_row(locals_[small_i])
    out = [None, None]
    out[small_i] = small
    out[1 - small_i] = locals_[1 - small_i]
    return out[0], out[1]


class _AggSideSpec:
    """A join side qualifying for partial-aggregate pushdown: the keyed
    ``Aggregate`` core, the pass-through projections between it and the
    join (outermost first), and the join-key name map through them (outer
    name → aggregate key name)."""

    __slots__ = ("agg", "projs", "key_map")

    def __init__(self, agg, projs, key_map):
        self.agg = agg
        self.projs = projs
        self.key_map = key_map


def _finish_agg_side(session, spec: _AggSideSpec, partial_node,
                     state: ColumnBatch) -> ColumnBatch:
    """A pushed-down side's shipped partial state finished, then its
    pass-through projections re-applied (innermost first) so the shard's
    schema is the join side's."""
    from ..sql import logical as L
    out = _finalize_partial_side(spec.agg, partial_node, state)
    for p in reversed(spec.projs):
        out = _run_local(session, L.Project(p.exprs,
                                            _leaf_relation(session, out)))
    return out


def _shuffled_join_shards(session, join, key_pairs,
                          svc: HostShuffleService, xid: str,
                          adaptive=None, side_aggs: Tuple = (None, None)
                          ) -> Tuple[ColumnBatch, ColumnBatch,
                                     Optional[str]]:
    """Co-partition BOTH join sides by join-key hash; returns this
    process's disjoint (left, right) key range and the verdict — None
    when the hash exchange ran, a broadcast decision when the stats
    barrier demoted the plan before any data block shipped, or "grace"
    (then the first element is the already-joined shard).

    1. each side runs locally on the card; a side carrying a pushed-down
       aggregate ships partial state instead of rows;
    2. rows bucket by ``Hash64(keys) % n_fine`` on the card and come back
       in one packed copy;
    3. a manifest-ONLY size round gives every process the same totals,
       hence the same reducer bounds (``plan_reducers``), and carries each
       side's observed totals for the adaptive re-decision;
    4. data ships at receiver granularity (a reducer's contiguous fine
       range is one slice), staged in RAM or spilled under the ledger.
    Dictionary keys hash their WORDS, so equal keys meet however the code
    spaces differ; the exchange then unifies the code spaces."""
    from . import ici
    n_fine = svc.n * session.conf.get(C.SHUFFLE_FINE_PARTITIONS)
    target = session.conf.get(C.SHUFFLE_TARGET_PARTITION_BYTES)
    tier, ici_min_bytes = _ici_tier(session, svc)
    sdir = _exchange_spill_dir(session, xid)
    try:
        pending = []
        sizes: Dict[int, int] = {}
        side_obs: Dict[str, List[int]] = {}
        partial_nodes = [None, None]
        side_exprs: List[list] = []       # join keys on the side OUTPUT
        side_hash_exprs: List[list] = []  # join keys on the SHIPPED rows
        for i, (skey, (subtree, exprs)) in enumerate(zip(
                ("l", "r"), (
                    (join.children[0], [l for l, _ in key_pairs]),
                    (join.children[1], [r for _, r in key_pairs])))):
            spec = side_aggs[i]
            if spec is not None:
                below = _run_local(session, spec.agg.children[0],
                                   on_device=True)
                partial_nodes[i], local = _partial_over(spec.agg, below,
                                                        svc)
                hash_exprs = [Col(spec.key_map[e.name]) for e in exprs]
            else:
                local = _run_local(session, subtree, on_device=True)
                hash_exprs = exprs
            side_exprs.append(exprs)
            side_hash_exprs.append(hash_exprs)
            bucketed, off, cnt = _bucket_to_host(
                local, _hash_ids(hash_exprs, n_fine), n_fine)
            raw = _bucket_payload_sizes(bucketed, cnt)
            for p in range(n_fine):
                if int(cnt[p]):
                    sizes[p] = sizes.get(p, 0) + int(raw[p])
            side_obs[skey] = [int(raw.sum()), int(cnt.sum())]
            pending.append((local, bucketed, off, cnt, raw))

        # ONE coordination round covers both sides (the assignment must be
        # shared, or matching keys would land on different processes);
        # its manifests carry each side's observed totals and the
        # decision trace of this process's replicated inputs
        from ..analysis import runtime as _az
        checks = _az.runtime_checks_enabled(session)
        dt_in = decision_inputs(svc, "hash", tier=tier)
        svc.publish_sizes(f"{xid}-plan", sizes,
                          extra={"sides": side_obs,
                                 "dtrace": {"h": _az.decision_trace(dt_in),
                                            "c": dt_in}})
        totals, mans = svc.gather_sizes_ex(f"{xid}-plan", n_fine)
        decision = _adaptive_redecide(join, svc, xid, adaptive, "hash",
                                      mans)
        n_live = len(svc.live_pids())
        bt = adaptive.broadcast_threshold if adaptive is not None else 0
        # the trace check runs BEFORE the demote branch: a DIVERGENT
        # demotion must abort structured here, not deadlock its peers at
        # the one-sided ``-bcast`` gather
        if checks:
            _trace_check(session, join, svc, f"{xid}-plan", mans, dt_in,
                         {"frozen": "hash", "how": join.how,
                          "adaptive": adaptive is not None,
                          "broadcast_threshold": bt, "n_live": n_live,
                          "decision": decision})
        if decision != "hash":
            left, right = _demote_locals_to_broadcast(
                svc, xid, decision, [_host(p[0]) for p in pending])
            return left, right, decision
        width = _elastic_width(svc, session, join, mans, target)
        if checks:
            _trace_check(session, join, svc, f"{xid}-plan", mans, dt_in,
                         {"frozen": "hash", "n_live": n_live,
                          "width": width, "target": target})
        bounds = svc.plan_reducers(totals, target, n_max=width)
        # device-tier activation per side, from the AGREED manifest totals
        # only; max_runs covers a spilled side, whose receiver range
        # decodes to one run per non-empty fine partition
        ici_plans = {k: ici.plan_side(tier, mans, k, ici_min_bytes,
                                      max_runs=n_fine) for k in ("l", "r")}

        sides: List[_StagedSide] = []
        for tag, (_local, bucketed, off, cnt, raw) in zip(("jL", "jR"),
                                                          pending):
            sides.append(_stage_map_side(
                svc, f"{xid}-{tag}", f"shuffle:{xid}:{tag}-map",
                bucketed, off, cnt, raw, sdir))
        del pending, bucketed      # a spilled side frees its rows here

        shards: List[Optional[ColumnBatch]] = []
        sinks: List[FetchSink] = []
        grace_from: Optional[int] = None
        try:
            for i, (tag, side) in enumerate(zip(("jL", "jR"), sides)):
                sink = FetchSink(svc, f"shuffle:{xid}:{tag}-fetch",
                                 f"{xid}-{tag}", sdir)
                sinks.append(sink)
                # once a SIBLING side pressured into grace, later sides
                # exchange delivery-only for the grace pass to stream
                sink.defer_drain = grace_from is not None
                exch = f"{xid}-{tag}"
                plan = ici_plans["l" if i == 0 else "r"]
                try:
                    if side.kind == "mem":
                        routed: Dict[int, List[ColumnBatch]] = {}
                        for g, (lo, hi) in enumerate(zip(bounds,
                                                         bounds[1:])):
                            n_rows = int(side.cnt[lo:hi].sum())
                            if n_rows:
                                routed[svc.group_owner(g)] = [K.host_slice(
                                    side.bucketed, int(side.off[lo]),
                                    n_rows)]
                        received = _tiered_exchange_with_refetch(
                            svc, session, plan, exch, routed, sink,
                            side.dead)
                    else:
                        # a reducer's contiguous fine range is one
                        # contiguous byte span of the spill file
                        parts_routed: Dict[int, list] = {}
                        meta: Dict[int, Tuple[int, int]] = {}
                        for g, (lo, hi) in enumerate(zip(bounds,
                                                         bounds[1:])):
                            length = side.offsets[hi] - side.offsets[lo]
                            if length:
                                owner = svc.group_owner(g)
                                parts_routed[owner] = [(side.offsets[lo],
                                                        length)]
                                meta[owner] = (int(side.raw[lo:hi].sum()),
                                               int(side.rows[lo:hi].sum()))
                        received = _tiered_exchange_spilled_with_refetch(
                            svc, session, plan, exch, side.path,
                            parts_routed, meta, sink, side.dead)
                except HostMemoryPressure:
                    # every block landed; only the DRAIN failed, with the
                    # sink intact: grace takes over
                    if not svc.grace_buckets:
                        raise
                    grace_from = i
                    shards.append(None)
                    svc.ledger.release(f"shuffle:{xid}:{tag}-map")
                    continue
                svc.ledger.release(f"shuffle:{xid}:{tag}-map")
                if sink.defer_drain:
                    shards.append(None)
                    continue

                def merge(received=received, side=side):
                    alive = [b for b in received if _live(b)] or \
                        [_one_dead_row(side.dead)]
                    return _concat(alive)
                shard = _timed_merge(merge)
                if partial_nodes[i] is not None:
                    shard = _finish_agg_side(session, side_aggs[i],
                                             partial_nodes[i], shard)
                shards.append(shard)
                # the own share is re-accounted by the sink; the map-side
                # reservation must not inflate the ledger meanwhile
                sink.close()
            if grace_from is not None:
                grace_sides = []
                for i, side in enumerate(sides):
                    if shards[i] is not None:
                        # drained before the pressure: re-bucket the
                        # finished shard by its OUTPUT join keys, its
                        # drain-time reservation given back first
                        svc.ledger.release(sinks[i].owner)
                        grace_sides.append((("batches", [shards[i]]),
                                            side_exprs[i], None,
                                            shards[i]))
                        continue
                    finisher = None
                    if partial_nodes[i] is not None:
                        def finisher(batch, i=i):
                            return _finish_agg_side(
                                session, side_aggs[i], partial_nodes[i],
                                batch)
                    grace_sides.append((("sink", sinks[i]),
                                        side_hash_exprs[i], finisher,
                                        side.dead))
                joined = _grace_bucket_join(session, join, svc, xid,
                                            sdir, grace_sides)
                return joined, None, "grace"
        finally:
            for s in sinks:
                s.close()
        if checks:
            _az.verify_hash_copartition(join, key_pairs, bounds, n_fine,
                                        svc.live_pids().index(svc.pid),
                                        shards[0], shards[1])
            _az.verify_unified_dictionaries(join, shards)
        return shards[0], shards[1], None
    finally:
        shutil.rmtree(sdir, ignore_errors=True)


#: join types whose RIGHT side may be broadcast while the left stays
#: partitioned (each left row lives on one process); broadcasting the
#: preserved side of an outer join would null-extend once PER PROCESS
_BCAST_RIGHT_OK = ("inner", "left", "left_semi", "left_anti")
_BCAST_LEFT_OK = ("inner", "right")


def choose_join_strategy(how: str, range_eligible: bool,
                         sort_merge_enabled: bool, shuffled_enabled: bool,
                         broadcast_threshold: int, n_procs: int,
                         left_bytes: int, right_bytes: int,
                         observed_left: Optional[Tuple[int, int]] = None,
                         observed_right: Optional[Tuple[int, int]] = None,
                         feedback: Optional["StatsFeedback"] = None,
                         left_sig: Optional[str] = None,
                         right_sig: Optional[str] = None) -> str:
    """The cross-process equi-join strategy as a PURE function of the
    statistics: ``broadcast_left`` / ``broadcast_right`` / ``range`` /
    ``hash`` / ``gather``.

    Broadcast wins first, when one side's GLOBAL volume fits the
    threshold AND the other side's per-process share; then range (an
    orderable key), then hash, then gather.  ``observed_*`` ``(bytes,
    rows)`` measurements replace the probe's estimate of their side; a
    side without one consults ``feedback`` under its plan signature."""
    if feedback is not None:
        if observed_left is None and left_sig is not None:
            observed_left = feedback.lookup(left_sig)
        if observed_right is None and right_sig is not None:
            observed_right = feedback.lookup(right_sig)
    if observed_left is not None:
        left_bytes = int(observed_left[0])
    if observed_right is not None:
        right_bytes = int(observed_right[0])
    if broadcast_threshold > 0:
        share = max(n_procs, 1)
        cand = []
        if how in _BCAST_RIGHT_OK and right_bytes <= broadcast_threshold \
                and right_bytes <= left_bytes // share:
            cand.append(("broadcast_right", right_bytes))
        if how in _BCAST_LEFT_OK and left_bytes <= broadcast_threshold \
                and left_bytes <= right_bytes // share:
            cand.append(("broadcast_left", left_bytes))
        if cand:
            return min(cand, key=lambda c: c[1])[0]
    if range_eligible and sort_merge_enabled:
        return "range"
    if shuffled_enabled:
        return "hash"
    return "gather"


class StatsFeedback:
    """Observed per-side output cardinalities recorded by the adaptive
    replanner under a STRUCTURAL plan signature, consulted by
    ``choose_join_strategy`` for later stages of the session
    (``session.statsFeedback``).  An estimate source only: a stale entry
    costs plan quality, never results."""

    __slots__ = ("_observed", "hits")

    def __init__(self):
        self._observed: Dict[str, Tuple[int, int, str]] = {}
        self.hits = 0

    @staticmethod
    def signature(plan) -> str:
        """Structural signature of a plan subtree: node types, expression
        reprs and leaf schemas / file paths; the same in every process."""
        from ..sql import logical as L
        parts: List[str] = []

        def walk(node):
            parts.append(type(node).__name__)
            for attr in ("exprs", "condition", "keys", "on", "using",
                         "how", "alias"):
                v = getattr(node, attr, None)
                if v is not None:
                    parts.append(f"{attr}={v!r}"[:200])
            if isinstance(node, L.Aggregate):
                parts.append(",".join(n for _f, n in node.aggs))
            if isinstance(node, L.LocalRelation):
                b = node.batch
                parts.append(",".join(
                    f"{n}:{v.dtype}" for n, v in zip(b.names, b.vectors)))
            if isinstance(node, L.FileRelation):
                parts.append(repr(getattr(node, "path", ""))[:200])
            for c in node.children:
                walk(c)

        walk(plan)
        return "|".join(parts)

    def record(self, sig: str, nbytes: int, rows: int,
               xid: str = "") -> None:
        self._observed[sig] = (int(nbytes), int(rows), xid)

    def lookup(self, sig: str) -> Optional[Tuple[int, int]]:
        """(bytes, rows) for ``sig``, counting the hit; ``peek`` does
        not count."""
        rec = self._observed.get(sig)
        if rec is None:
            return None
        self.hits += 1
        return rec[0], rec[1]

    def peek(self, sig: str) -> Optional[Tuple[int, int]]:
        rec = self._observed.get(sig)
        return None if rec is None else (rec[0], rec[1])

    def clear(self) -> None:
        self._observed.clear()
        self.hits = 0

    def snapshot(self) -> Dict[str, Tuple[int, int, str]]:
        return dict(self._observed)

    def __len__(self) -> int:
        return len(self._observed)


def observed_side_stats(mans: Dict[int, dict], n_senders: int
                        ) -> Optional[Tuple[int, int, int, int]]:
    """The per-side observed totals piggybacked on a stats round:
    ``(left_bytes, left_rows, right_bytes, right_rows)``, or None when the
    round is INCOMPLETE or malformed (then the frozen plan stands)."""
    if len(mans) < n_senders:
        return None
    l_bytes = l_rows = r_bytes = r_rows = 0
    for s in mans:
        sides = mans[s].get("sides") if isinstance(mans[s], dict) else None
        if not isinstance(sides, dict):
            return None
        try:
            lb, lr = sides["l"]
            rb, rr = sides["r"]
            l_bytes += int(lb)
            l_rows += int(lr)
            r_bytes += int(rb)
            r_rows += int(rr)
        except (KeyError, TypeError, ValueError):
            return None
    return l_bytes, l_rows, r_bytes, r_rows


def elastic_reducer_width(observed_bytes: Optional[int],
                          target_bytes: int, n_live: int) -> int:
    """Reducer-set width from OBSERVED exchange volume: enough reducers
    to keep each near the advisory target, within [1, n_live].  No
    statistics or no target keep the full width."""
    if observed_bytes is None or target_bytes <= 0 or n_live <= 0:
        return n_live
    return max(1, min(n_live,
                      -(-int(observed_bytes) // int(target_bytes))))


def _elastic_width(svc: HostShuffleService, session, join,
                   mans: Dict[int, dict], target: int) -> int:
    """The elastic reducer width of one exchange from its plan round's
    side totals, accounted (and, with the runtime checks on, held to the
    width the shared manifests imply)."""
    n_live = len(svc.live_pids())
    obs = observed_side_stats(mans, n_live)
    width = elastic_reducer_width(
        (int(obs[0]) + int(obs[2])) if obs is not None else None,
        target, n_live)
    svc.bump("reducers_planned", n_live)
    svc.bump("reducers_observed", width)
    if width != n_live:
        svc.bump("reducers_elastic")
    from ..analysis import runtime as _az
    if _az.runtime_checks_enabled(session):
        _az.verify_elastic_reducer_plan(join, width, mans, n_live, target)
    return width


def _trace_check(session, join, svc: HostShuffleService, exchange: str,
                 mans: Dict[int, dict], dt_in: Dict[str, object],
                 local: Dict[str, object]) -> None:
    """``verify_decision_trace`` at a lane's plan round.  A divergence
    is published for the statement's peers before it raises
    (``HostShuffleService.publish_divergence``), so a peer waiting at
    this exchange's next barrier ends in the same structured error
    instead of its barrier deadline."""
    from ..analysis import PlanInvariantError
    from ..analysis import runtime as _az
    svc.note_round(exchange, mans)
    try:
        _az.verify_decision_trace(session, join, svc, exchange, mans,
                                  dt_in, local=local)
    except PlanInvariantError as e:
        svc.publish_divergence(exchange, e.property, e.detail)
        raise


def decision_inputs(svc: HostShuffleService, frozen: str, cuts=None,
                    est_splits=None, tier=None) -> Dict[str, object]:
    """The replicated pre-round decision components: the frozen plan-time
    strategy, the epoch, the live set, the agreed-lost set, (range lane)
    the cut points and the sample-estimated skew splits, and the device
    tier's split.  Every process must derive this dict identically; it
    rides the plan round's manifest."""
    d: Dict[str, object] = {
        "frozen": frozen,
        "epoch": int(svc.epoch),
        "live": [int(p) for p in svc.live_pids()],
        "adopt": sorted(int(p) for p in svc.recovered_pids),
    }
    if cuts is not None:
        d["cuts"] = [str(c) for c in cuts]
    if est_splits is not None:
        d["splits"] = sorted(int(p) for p in est_splits)
    if tier is not None:
        d["tier"] = tier.fingerprint()
    return d


def adaptive_join_decision(frozen: str, how: str, broadcast_threshold: int,
                           n_procs: int,
                           observed: Optional[Tuple[int, int, int, int]]
                           ) -> str:
    """Re-decide at the stats barrier from the frozen choice and the
    observed totals: the only legal move is DEMOTING hash/range to a
    broadcast.  No statistics keep the frozen strategy."""
    if observed is None or frozen not in ("hash", "range"):
        return frozen
    l_bytes, _l_rows, r_bytes, _r_rows = observed
    redecided = choose_join_strategy(
        how, False, False, True, broadcast_threshold, n_procs,
        int(l_bytes), int(r_bytes))
    if redecided in ("broadcast_left", "broadcast_right"):
        return redecided
    return frozen


class _AdaptiveCtx:
    """Per-query adaptive context threaded into the exchange lanes: the
    plan-time broadcast threshold (the demotion bar), the session's
    ``StatsFeedback`` and both side signatures, the equi-key pairs (for
    the runtime decision check), and whether the analysis runtime checks
    are on."""

    __slots__ = ("broadcast_threshold", "feedback", "left_sig",
                 "right_sig", "key_pairs", "checks")

    def __init__(self, broadcast_threshold, feedback, left_sig, right_sig,
                 key_pairs, checks):
        self.broadcast_threshold = broadcast_threshold
        self.feedback = feedback
        self.left_sig = left_sig
        self.right_sig = right_sig
        self.key_pairs = key_pairs
        self.checks = checks


def _adaptive_redecide(join, svc: HostShuffleService, xid: str,
                       adaptive: Optional[_AdaptiveCtx], frozen: str,
                       mans: Dict[int, dict]) -> str:
    """The adaptive re-decision at a lane's stats barrier: every input is
    shared (the gathered manifests) or derived identically at plan time,
    so every process returns the same strategy."""
    if adaptive is None:
        return frozen
    n_live = len(svc.live_pids())
    observed = observed_side_stats(mans, n_live)
    if observed is None:
        # lost stats round: the frozen strategy stands, and its legality
        # is still held against a recompute from the same inputs
        if adaptive.checks:
            from ..analysis import runtime as _az
            _az.verify_join_strategy(
                join, frozen, frozen == "range", adaptive.key_pairs,
                frozen=frozen, observed=None,
                broadcast_threshold=adaptive.broadcast_threshold,
                n_procs=n_live)
        return frozen
    svc.bump("adaptive_replans")
    if adaptive.feedback is not None:
        if adaptive.left_sig:
            adaptive.feedback.record(adaptive.left_sig, observed[0],
                                     observed[1], xid)
        if adaptive.right_sig:
            adaptive.feedback.record(adaptive.right_sig, observed[2],
                                     observed[3], xid)
    decision = adaptive_join_decision(
        frozen, join.how, adaptive.broadcast_threshold, n_live, observed)
    if adaptive.checks:
        from ..analysis import runtime as _az
        _az.verify_join_strategy(
            join, decision, frozen == "range", adaptive.key_pairs,
            frozen=frozen, observed=observed,
            broadcast_threshold=adaptive.broadcast_threshold,
            n_procs=n_live)
    if decision != frozen:
        svc.bump("strategy_demotions")
    return decision


def _staged_local_rows(svc: HostShuffleService, exchange: str,
                       side: _StagedSide) -> ColumnBatch:
    """One side's LOCAL rows back from its staged map output (a demotion
    after bucketing): the live prefix of the bucketed batch, or every
    partition frame of the spill file."""
    if side.kind == "mem":
        n_live = int(np.asarray(side.cnt).sum())
        if not n_live:
            return _one_dead_row(side.dead)
        return K.host_slice(side.bucketed, 0, n_live)
    parts = [(int(side.offsets[p]),
              int(side.offsets[p + 1] - side.offsets[p]))
             for p in range(len(side.offsets) - 1)
             if side.offsets[p + 1] > side.offsets[p]]
    if not parts:
        return _one_dead_row(side.dead)
    got = svc.decode_spilled(exchange, side.path, parts)
    alive = [b for b in got if _live(b)]
    if not alive:
        return _one_dead_row(side.dead)
    return _concat(alive)


def _demote_to_broadcast(svc: HostShuffleService, xid: str, decision: str,
                         staged: List[_StagedSide],
                         tags: Tuple[str, str]
                         ) -> Tuple[ColumnBatch, ColumnBatch]:
    """A range-lane demotion: both sides' local rows back from staging,
    both map reservations dropped, and ONLY the small side gathered
    (``{xid}-bcast``)."""
    locals_ = [_staged_local_rows(svc, f"{xid}-{tag}", side)
               for tag, side in zip(tags, staged)]
    for tag in tags:
        svc.ledger.release(f"shuffle:{xid}:{tag}-map")
    small_i = 0 if decision == "broadcast_left" else 1
    small = _gather_all(svc, f"{xid}-bcast", locals_[small_i], dedup=False)
    if not _live(small):
        small = _one_dead_row(staged[small_i].dead)
    out = [None, None]
    out[small_i] = small
    out[1 - small_i] = locals_[1 - small_i]
    return out[0], out[1]


def _finalize_partial_side(agg_node, partial_node, state: ColumnBatch
                           ) -> ColumnBatch:
    """Finish a pushed-down partial aggregate over one reducer's shipped
    state rows (on the host).  The aggregate keys subsume the join keys,
    so every partial of a group landed on this reducer."""
    from .dist import DFinalAggregate

    def merge():
        final = K.compact(DFinalAggregate(
            agg_node.keys, agg_node.aggs, partial_node,
            P.PScan(0, state.schema)).run(P.ExecContext("cpu", [state])))
        return final if int(final.capacity) else _one_dead_row(final)
    return _timed_merge(merge)


# ---------------------------------------------------------------------------
# grace-partitioned degraded mode: when a reducer's drained shard cannot
# be reserved under the host ledger, both sides re-bucket by join-key
# hash into spill files and join bucket by bucket on the card.  A single
# key overflowing its bucket re-splits under a constant salt; only a
# bucket that still cannot fit after _GRACE_MAX_SALT_DEPTH re-splits
# raises the bounded HostMemoryError.
# ---------------------------------------------------------------------------

_GRACE_SUB_BUCKETS = 16
_GRACE_MAX_SALT_DEPTH = 3


def _grace_bucket_ids(batch: ColumnBatch, key_exprs, n_buckets: int,
                      salt: int) -> torch.Tensor:
    """Per-row grace bucket ids ``Hash64(salt?, keys) % n_buckets``:
    dictionary keys hash their words, so the assignment holds across the
    differing per-sender code spaces a sink streams."""
    exprs = ([Literal(int(salt), T.int64)] if salt else []) + \
        list(key_exprs)
    return _hash_ids(exprs, n_buckets)(batch)


def _grace_skip(how: str, l_empty: bool, r_empty: bool) -> bool:
    """Buckets a join type cannot produce rows from."""
    if how in ("inner", "cross", "left_semi"):
        return l_empty or r_empty
    if how in ("left", "left_anti"):
        return l_empty
    if how == "right":
        return r_empty
    return l_empty and r_empty               # full


def _grace_spill_buckets(svc: HostShuffleService, xid: str, sdir: str,
                         tag: str, batches, key_exprs,
                         n_buckets: int, salt: int) -> Dict[int, list]:
    """Re-bucket a stream of host batches by (salted) join-key hash into
    wire-framed spill files; returns ``bucket -> [path, raw_bytes,
    rows]`` for the buckets that got rows.  A failed spill write is a
    structured ``HostMemoryError``."""
    exch = f"{xid}-grace"
    out: Dict[int, list] = {}
    for b in batches:
        host = b.to_host()
        if not _live(host):
            continue
        bucketed, off, cnt = K.partition_host_slices(
            host, _grace_bucket_ids(host, key_exprs, n_buckets, salt),
            n_buckets)
        for p in range(n_buckets):
            c = int(cnt[p])
            if not c:
                continue
            sub = K.host_slice(bucketed, int(off[p]), c)
            buf = wire.encode_batches(
                [sub], codec=svc.wire_codec,
                compress_threshold=svc.wire_threshold,
                run_codes=svc.run_codes)
            path = os.path.join(sdir, f"{exch}-{tag}-b{p:04d}.run")
            entry = out.setdefault(p, [path, 0, 0])
            try:
                svc.spill_write(path, buf, append=entry[2] > 0,
                                exchange=exch)
            except OSError as e:
                raise HostMemoryError(
                    f"shuffle:{xid}:grace", wire.raw_nbytes([sub]),
                    svc.ledger.budget,
                    holders={o: svc.ledger.held(o)
                             for o in svc.ledger.owners()},
                    exchange=exch, detail=f"grace spill failed: {e}")
            entry[1] += int(wire.raw_nbytes([sub]))
            entry[2] += c
            svc.bump("grace_spill_bytes", len(buf))
    return out


def _read_run_file(path: str, keep_runs: bool = False
                   ) -> List[ColumnBatch]:
    with open(path, "rb") as f:
        return wire.decode_frames(f.read(), keep_runs=keep_runs)


def _grace_join_bucket(session, join, svc: HostShuffleService, xid: str,
                       sdir: str, lmeta, rmeta, grace_sides,
                       n_buckets: int, depth: int, bucket: int,
                       outputs: List[ColumnBatch]) -> None:
    """Join ONE grace bucket under a hard ledger reservation, or — when
    it cannot fit — re-split it under a constant salt and recurse.
    ``grace_sides[i] = (source, key_exprs, finisher, dead)``."""
    from ..sql import logical as L

    owner = f"shuffle:{xid}:grace"
    exch = f"{xid}-grace"
    l_empty = lmeta is None or not lmeta[2]
    r_empty = rmeta is None or not rmeta[2]

    def _drop_files():
        for meta in (lmeta, rmeta):
            if meta is not None:
                try:
                    os.remove(meta[0])
                except OSError:
                    pass

    if _grace_skip(join.how, l_empty, r_empty):
        _drop_files()
        return
    need = (int(lmeta[1]) if lmeta else 0) + \
        (int(rmeta[1]) if rmeta else 0)
    if not svc.ledger.try_reserve(owner, need):
        if depth >= _GRACE_MAX_SALT_DEPTH:
            # genuinely unspillable: one key's rows exceed the budget even
            # after salted re-splits — fail structured (a raced release
            # that lets this reserve through is given back)
            svc.ledger.reserve(owner, need, exchange=exch)
            svc.ledger.release(owner, need)
        svc.bump("grace_salted_resplits")
        subs: List[Dict[int, list]] = []
        for i, meta in enumerate((lmeta, rmeta)):
            if meta is None:
                subs.append({})
                continue
            frames = _read_run_file(meta[0], keep_runs=svc.run_codes)
            os.remove(meta[0])
            subs.append(_grace_spill_buckets(
                svc, xid, sdir, f"d{depth + 1}-b{bucket:04d}-s{i}",
                frames, grace_sides[i][1], _GRACE_SUB_BUCKETS,
                salt=depth + 1))
        for sb in sorted(set(subs[0]) | set(subs[1])):
            _grace_join_bucket(session, join, svc, xid, sdir,
                               subs[0].get(sb), subs[1].get(sb),
                               grace_sides, _GRACE_SUB_BUCKETS,
                               depth + 1, sb, outputs)
        return
    try:
        from ..analysis import runtime as _az
        assembled: List[ColumnBatch] = []
        for i, meta in enumerate((lmeta, rmeta)):
            _source, _exprs, _finisher, dead = grace_sides[i]
            if meta is None or not meta[2]:
                side_b = _one_dead_row(dead)
            else:
                side_b = _timed_merge(lambda m=meta: _concat(
                    svc.unify_code_space(_read_run_file(
                        m[0], keep_runs=svc.run_codes))))
            assembled.append(side_b)
        if _az.runtime_checks_enabled(session):
            _az.verify_grace_bucket_partition(
                join, grace_sides[0][1], grace_sides[1][1], n_buckets,
                depth, bucket, assembled[0], assembled[1])
        for i in range(2):
            finisher = grace_sides[i][2]
            if finisher is not None:
                assembled[i] = finisher(assembled[i])
        joined = _run_local(session, L.Join(
            _leaf_relation(session, assembled[0]),
            _leaf_relation(session, assembled[1]),
            join.how, join.on, join.using))
        if _live(joined):
            outputs.append(joined)
        svc.bump("grace_buckets_used")
    finally:
        svc.ledger.release(owner, need)
        _drop_files()


def _grace_bucket_join(session, join, svc: HostShuffleService, xid: str,
                       sdir: str, grace_sides) -> ColumnBatch:
    """The degraded-mode join: stream both sides (a pressured or deferred
    ``FetchSink``, or an already-drained shard) through the grace
    re-bucketing pass, join bucket by bucket, and union the outputs.
    ``source`` is ``("sink", FetchSink)`` or ``("batches", [...])``; a
    side's ``finisher`` (a pushed-down aggregate's finish) runs per
    assembled bucket."""
    from ..sql import logical as L

    n_buckets = max(1, int(svc.grace_buckets))
    per_side: List[Dict[int, list]] = []
    for i, (source, key_exprs, _finisher, _dead) in \
            enumerate(grace_sides):
        kind, payload = source
        batches = payload.pop_entries() if kind == "sink" else payload
        per_side.append(_grace_spill_buckets(
            svc, xid, sdir, f"d0-s{i}", batches, key_exprs, n_buckets,
            salt=0))
        if kind == "sink":
            payload.close()
    outputs: List[ColumnBatch] = []
    for b in sorted(set(per_side[0]) | set(per_side[1])):
        _grace_join_bucket(session, join, svc, xid, sdir,
                           per_side[0].get(b), per_side[1].get(b),
                           grace_sides, n_buckets, 0, b, outputs)
    if outputs:
        return _timed_merge(lambda: _concat(svc.unify_code_space(outputs)))
    # every bucket skipped: the JOINED schema from the two dead templates
    dead_sides = []
    for _source, _exprs, finisher, dead in grace_sides:
        d = _one_dead_row(dead)
        dead_sides.append(finisher(d) if finisher is not None else d)
    empty = _run_local(session, L.Join(
        _leaf_relation(session, dead_sides[0]),
        _leaf_relation(session, dead_sides[1]),
        join.how, join.on, join.using))
    return empty if int(empty.capacity) else _one_dead_row(empty)


def _estimated_span_weights(pts, wts, cuts) -> np.ndarray:
    """The sample round's ESTIMATE of each span's mass: the sample points
    bucketed by the agreed cuts (``range_bucket``'s ``side="right"``
    rule), their weights summed."""
    n_spans = len(cuts) + 1
    est = np.zeros(n_spans, np.float64)
    if len(pts):
        spans = np.searchsorted(np.asarray(cuts), np.asarray(pts),
                                side="right")
        np.add.at(est, spans, np.asarray(wts, np.float64))
    return est


def _session_feedback(session) -> StatsFeedback:
    fb = getattr(session, "_stats_feedback", None)
    if fb is None:
        fb = StatsFeedback()
        session._stats_feedback = fb
    return fb


def _range_cuts(mans: Dict[int, dict], n_fine: int, is_str: bool):
    """Cut points every process derives identically from the sample
    round: all points in sorted-sender order, a stable sort, weighted
    quantiles, duplicates collapsed (a hot key becomes ONE wide span).
    String cuts stay words.  Returns ``(cuts, estimated span weights or
    None)``."""
    pt_dtype = object if is_str else np.int64
    pts_all, wts_all = [], []
    for s in sorted(mans):
        for tag in ("l", "r"):
            d = mans[s].get("sample", {}).get(tag, {})
            if d.get("points"):
                pts_all.append(np.asarray(d["points"], pt_dtype))
                wts_all.append(np.full(len(d["points"]),
                                       float(d.get("weight", 1.0))))
    if not pts_all:
        return np.zeros(0, pt_dtype), None
    pts = np.concatenate(pts_all)
    wts = np.concatenate(wts_all)
    order = np.argsort(pts, kind="stable")
    pts, wts = pts[order], wts[order]
    cum = np.cumsum(wts)
    qs = np.asarray([cum[-1] * j / n_fine for j in range(1, n_fine)])
    cut_idx = np.clip(np.searchsorted(cum, qs, side="left"),
                      0, len(pts) - 1)
    cuts = np.unique(pts[cut_idx])
    return cuts, _estimated_span_weights(pts, wts, cuts)


def _side_sample(enc: torch.Tensor, ok: torch.Tensor, kdict, is_str: bool,
                 sample_k: int) -> dict:
    """Evenly spaced points of a side's sorted keys (sorted on its
    device; only the points come to the host), weighted by rows per
    point so the quantiles track row mass."""
    keys = torch.sort(enc[ok]).values
    n = int(keys.numel())
    if not n:
        return {"points": [], "weight": 0.0}
    idx = np.linspace(0, n - 1, num=min(sample_k, n)).astype(np.int64)
    pts = keys[torch.from_numpy(idx).to(keys.device)].cpu().numpy()
    points = [str(kdict[int(c)]) for c in pts] if is_str \
        else [int(x) for x in pts]
    return {"points": points, "weight": n / len(pts)}


def _merge_build_runs(build_runs: List[ColumnBatch], r_expr,
                      r_as_float: bool) -> ColumnBatch:
    """The k-way merge of a reducer's build runs: each run is (flag,
    key)-sorted; every run's keyed prefix merges by key
    (``native.merge.merge_sorted_runs``) and the null tails follow — one
    batch in the (flag, key) order ``PMergeJoin`` searches without a
    sort."""
    from ..native.merge import merge_sorted_runs
    from ..sql.joins import range_encode_key
    keyed, tails, run_keys = [], [], []
    for b in build_runs:
        enc, ok = range_encode_key(EvalContext(b), r_expr, r_as_float)
        n_ok = int(ok.sum())
        if n_ok:
            keyed.append(K.host_slice(b, 0, n_ok))
            run_keys.append(enc[:n_ok].numpy())
        if n_ok < b.capacity:
            tails.append(K.host_slice(b, n_ok, b.capacity - n_ok))
    if keyed:
        perm = torch.from_numpy(merge_sorted_runs(run_keys))
        parts = [K.take_batch(_concat(keyed), perm)] + tails
    else:
        parts = tails
    return _concat(parts)


def _range_merge_join_shards(session, join, spec,
                             svc: HostShuffleService, xid: str,
                             adaptive=None
                             ) -> Tuple[ColumnBatch, ColumnBatch,
                                        Optional[str]]:
    """Co-partition BOTH join sides by key RANGE and deliver this
    process's spans with the build side already sorted — or, after a
    demotion, the local big side and the broadcast small side (the
    SortMergeJoinExec + RangePartitioner protocol):

    1. each side runs on the card; its join keys get the monotone int64
       image (``range_encode_key_ex``);
    2. SAMPLE round (manifest-only, strict): evenly spaced points of each
       side's sorted keys; every process derives the SAME cut points;
    3. rows bucket into spans on the card with a (null_flag, key) tie
       sort, so every span slice is a sorted run; a size round and
       ``plan_range_reducers`` assign spans, SPLITTING skewed ones (the
       probe span divides among k owners, the build span replicates);
    4. data ships through the ordinary exchange; the receiver k-way
       merges its build runs for ``PMergeJoin``.
    NULL keys take INT64_MIN → span 0: probe-side nulls still reach a
    reducer (left/anti need them), build-side nulls sink to each run's
    tail."""
    from ..sql.joins import range_encode_key_ex

    l_expr, r_expr, l_as_float, r_as_float, is_str = spec
    n_fine = svc.n * session.conf.get(C.SHUFFLE_FINE_PARTITIONS)
    target = session.conf.get(C.SHUFFLE_TARGET_PARTITION_BYTES)
    sample_k = session.conf.get(C.SHUFFLE_RANGE_SAMPLE_SIZE)
    from . import ici
    tier, ici_min_bytes = _ici_tier(session, svc)

    # 1. local runs + monotone key images (string keys: local codes,
    # monotone in the words; the sample round exchanges WORDS)
    sides = []
    for subtree, expr, as_f in ((join.children[0], l_expr, l_as_float),
                                (join.children[1], r_expr, r_as_float)):
        local = _run_local(session, subtree, on_device=True)
        encoded = range_encode_key_ex(EvalContext(local), expr, as_f)
        if encoded is None:      # guarded by range_key_spec upstream
            raise RuntimeError("range join key lost its orderable "
                               "encoding between planning and execution")
        enc, ok, kdict = encoded
        sides.append((local, enc, ok, kdict or ()))

    # 2. the sample round
    sample = {tag: _side_sample(enc, ok, kdict, is_str, sample_k)
              for tag, (_l, enc, ok, kdict) in zip(("l", "r"), sides)}
    svc.publish_manifest(f"{xid}-sample", {"sample": sample})
    mans, man_bytes = svc.gather_manifests(f"{xid}-sample", strict=True)
    svc.bump("sample_bytes", man_bytes)
    cuts, est_span_w = _range_cuts(mans, n_fine, is_str)
    svc.last_range_cutpoints = [str(c) for c in cuts] if is_str \
        else [int(c) for c in cuts]
    n_spans = len(cuts) + 1
    from ..analysis import runtime as _az
    checks = _az.runtime_checks_enabled(session)
    if checks:
        _az.verify_range_cutpoints(join, list(cuts), is_str)

    # 3. span bucketing on the card with the (null_flag, key) tie sort;
    # a string side maps the shared cut WORDS into its local code space
    # (the smallest code whose word is >= the cut), so a row's span
    # depends only on its word
    sdir = _exchange_spill_dir(session, xid)
    try:
        staged_sides: List[_StagedSide] = []
        sizes: Dict[int, int] = {}
        side_obs: Dict[str, List[int]] = {}
        for tag in ("rL", "rR"):
            svc.mark_presorted(f"{xid}-{tag}")
        for (base, tag), (local, enc, ok, kdict) in zip(
                ((0, "rL"), (n_spans, "rR")), sides):
            local_cuts = np.searchsorted(
                np.asarray(kdict, object), np.asarray(cuts, object),
                side="left").astype(np.int64) if is_str \
                else np.asarray(cuts, np.int64)
            bucketed, off, cnt = _bucket_to_host(
                local,
                lambda b, enc=enc, lc=local_cuts: K.range_bucket(
                    enc, torch.from_numpy(lc)),
                n_spans,
                lambda b, enc=enc, ok=ok: [(~ok).to(torch.int8), enc])
            raw = np.zeros(n_spans, np.int64)
            for p in range(n_spans):
                if int(cnt[p]):
                    # payload, not raw: a span of fat strings weighs its
                    # dictionary words, or byte skew stays invisible
                    raw[p] = wire.payload_nbytes(
                        [K.host_slice(bucketed, int(off[p]), int(cnt[p]))])
                    sizes[base + p] = sizes.get(base + p, 0) + int(raw[p])
            side_obs["l" if base == 0 else "r"] = [
                int(raw.sum()), int(np.asarray(cnt, np.int64).sum())]
            staged_sides.append(_stage_map_side(
                svc, f"{xid}-{tag}", f"shuffle:{xid}:{tag}-map",
                bucketed, off, cnt, raw, sdir))
            del bucketed
        del sides
        est_split = svc.skew_spans(est_span_w.astype(np.int64)) \
            if est_span_w is not None else set()
        dt_in = decision_inputs(svc, "range",
                                cuts=svc.last_range_cutpoints,
                                est_splits=est_split, tier=tier)
        svc.publish_sizes(f"{xid}-plan", sizes,
                          extra={"sides": side_obs,
                                 "dtrace": {"h": _az.decision_trace(dt_in),
                                            "c": dt_in}})
        totals, mans = svc.gather_sizes_ex(f"{xid}-plan", 2 * n_spans)
        decision = _adaptive_redecide(join, svc, xid, adaptive, "range",
                                      mans)
        n_live = len(svc.live_pids())
        bt = adaptive.broadcast_threshold if adaptive is not None else 0
        # trace check BEFORE the demote branch: a divergent demotion
        # aborts structured instead of deadlocking the ``-bcast`` gather
        if checks:
            _trace_check(session, join, svc, f"{xid}-plan", mans, dt_in,
                         {"frozen": "range", "how": join.how,
                          "adaptive": adaptive is not None,
                          "broadcast_threshold": bt, "n_live": n_live,
                          "decision": decision})
        if decision != "range":
            left, right = _demote_to_broadcast(
                svc, xid, decision, staged_sides, ("rL", "rR"))
            return left, right, decision
        width = _elastic_width(svc, session, join, mans, target)
        if checks:
            _trace_check(session, join, svc, f"{xid}-plan", mans, dt_in,
                         {"frozen": "range", "n_live": n_live,
                          "width": width, "target": target})
        owners = svc.plan_range_reducers(totals[:n_spans],
                                         totals[n_spans:], target,
                                         n_max=width)
        if est_span_w is not None:
            # splits only the observed weights revealed
            svc.bump("post_sample_skew_splits", sum(
                1 for p in range(n_spans)
                if len(owners[p]) > 1 and p not in est_split))
        if checks:
            _az.verify_span_owners(join, owners, n_spans, svc.n)
            _az.verify_skew_split(join, owners)
        # device-tier activation per side (agreed inputs only); every span
        # is a presorted run and ships as one, so a receiver gets at most
        # one run per span
        ici_plans = {k: ici.plan_side(tier, mans, k, ici_min_bytes,
                                      max_runs=n_spans) for k in ("l", "r")}

        # 4a. probe side: a split span's sorted slice chops into
        # contiguous sub-runs, one per owner; build side: each span slice
        # replicates to every owner of that span
        def route(side: _StagedSide, is_build: bool
                  ) -> Dict[int, List[ColumnBatch]]:
            bucketed, off, cnt = side.bucketed, side.off, side.cnt
            routed: Dict[int, List[ColumnBatch]] = {}
            for p in range(n_spans):
                c, o = int(cnt[p]), int(off[p])
                if not c:
                    continue
                ps = owners[p]
                if is_build or len(ps) == 1:
                    sl = K.host_slice(bucketed, o, c)
                    for r in (ps if is_build else ps[:1]):
                        routed.setdefault(r, []).append(sl)
                else:
                    k = len(ps)
                    bnds = [o + (c * j) // k for j in range(k + 1)]
                    for j, r in enumerate(ps):
                        if bnds[j + 1] > bnds[j]:
                            routed.setdefault(r, []).append(
                                K.host_slice(bucketed, bnds[j],
                                             bnds[j + 1] - bnds[j]))
            return routed

        def route_spilled(side: _StagedSide, exch: str, is_build: bool):
            """Whole spans ship as spill-file byte spans (a build span's
            bytes replicate to every owner undecoded); only a skew-SPLIT
            probe span decodes, to chop into sub-runs re-encoded as
            ready frames."""
            routed: Dict[int, list] = {}
            meta: Dict[int, List[int]] = {}

            def add(r, part, rb, rw):
                routed.setdefault(r, []).append(part)
                m = meta.setdefault(r, [0, 0])
                m[0] += rb
                m[1] += rw

            for p in range(n_spans):
                length = side.offsets[p + 1] - side.offsets[p]
                if not length:
                    continue
                ps = owners[p]
                if is_build or len(ps) == 1:
                    for r in (ps if is_build else ps[:1]):
                        add(r, (side.offsets[p], length),
                            int(side.raw[p]), int(side.rows[p]))
                else:
                    sb = _concat(svc.decode_spilled(
                        exch, side.path, [(side.offsets[p], length)]))
                    c = int(sb.capacity)
                    k = len(ps)
                    bnds = [(c * j) // k for j in range(k + 1)]
                    for j, r in enumerate(ps):
                        nrows = bnds[j + 1] - bnds[j]
                        if nrows:
                            sub = K.host_slice(sb, bnds[j], nrows)
                            add(r, svc.encode_frames(exch, [sub]),
                                wire.raw_nbytes([sub]), nrows)
            return routed, {r: (m[0], m[1]) for r, m in meta.items()}

        recvs: List[Optional[List[ColumnBatch]]] = []
        sinks: List[FetchSink] = []
        grace_from: Optional[int] = None
        try:
            for i, (side, tag, is_build) in enumerate((
                    (staged_sides[0], "rL", False),
                    (staged_sides[1], "rR", True))):
                exch = f"{xid}-{tag}"
                sink = FetchSink(svc, f"shuffle:{xid}:{tag}-fetch",
                                 exch, sdir)
                sinks.append(sink)
                sink.defer_drain = grace_from is not None
                plan = ici_plans["r" if is_build else "l"]
                try:
                    if side.kind == "mem":
                        received = _tiered_exchange_with_refetch(
                            svc, session, plan, exch, route(side, is_build),
                            sink, side.dead)
                    else:
                        parts_routed, meta = route_spilled(side, exch,
                                                           is_build)
                        received = _tiered_exchange_spilled_with_refetch(
                            svc, session, plan, exch, side.path,
                            parts_routed, meta, sink, side.dead)
                except HostMemoryPressure:
                    if not svc.grace_buckets:
                        raise
                    grace_from = i
                    recvs.append(None)
                    svc.ledger.release(f"shuffle:{xid}:{tag}-map")
                    continue
                svc.ledger.release(f"shuffle:{xid}:{tag}-map")
                if sink.defer_drain:
                    recvs.append(None)
                else:
                    recvs.append(received)
                    sink.close()
            if grace_from is not None:
                grace_sides = []
                for i, expr in enumerate((l_expr, r_expr)):
                    if recvs[i] is not None:
                        svc.ledger.release(sinks[i].owner)
                        src = ("batches",
                               [b for b in recvs[i] if _live(b)])
                    else:
                        src = ("sink", sinks[i])
                    grace_sides.append((src, [expr], None,
                                        staged_sides[i].dead))
                joined = _grace_bucket_join(session, join, svc, xid,
                                            sdir, grace_sides)
                return joined, None, "grace"
        finally:
            for s in sinks:
                s.close()
        probe_recv, build_recv = recvs

        def merge():
            probe_runs = [b for b in probe_recv if _live(b)]
            probe = _concat(probe_runs) if probe_runs \
                else _one_dead_row(staged_sides[0].dead)
            build_runs = [b for b in build_recv if _live(b)]
            build = _merge_build_runs(build_runs, r_expr, r_as_float) \
                if build_runs else _one_dead_row(staged_sides[1].dead)
            return probe, build
        probe_shard, build_shard = _timed_merge(merge)
        if checks:
            _az.verify_presorted_build(join, build_shard, r_expr,
                                       r_as_float)
            _az.verify_unified_dictionaries(join, (probe_shard,
                                                   build_shard))
        return probe_shard, build_shard, None
    finally:
        shutil.rmtree(sdir, ignore_errors=True)


def _unrecoverable(xid: str, hosts: List[str], detail: str
                   ) -> ExchangeFetchFailed:
    err = ExchangeFetchFailed(xid, hosts, [], detail=detail)
    err.recoverable = False
    return err


def _require_recoverable(svc: HostShuffleService, flags: List[bool]
                         ) -> None:
    """Post-loss admissibility of a statement: with agreed-lost peers, a
    PARTITIONED statement is answerable only if every lost pid published
    a file recipe for every partitioned leaf.  Checks recipes only,
    never the local leaf's type (an adopter's leaf is a
    ``LocalRelation`` after a re-execution).  Replicated-only statements
    always pass."""
    if not svc.recovered_pids or not any(flags):
        return
    for p in sorted(svc.recovered_pids):
        rec = svc.leaf_recipes.get(p)
        for i, partitioned in enumerate(flags):
            if not partitioned:
                continue
            r = rec[i] if rec is not None and i < len(rec) else None
            if not (isinstance(r, dict) and r.get("kind") == "file"
                    and r.get("paths")):
                raise _unrecoverable(
                    "recovery", [svc.host_name(p)],
                    f"statement reads partitioned leaf {i} but lost pid "
                    f"{p} left no file recipe for its partition")


#: this process's recovery time split, milliseconds, of the statements
#: that lost a peer: ``fail_ms`` from the epoch's start to the structured
#: failure (detection, the refetch included), ``round_ms`` the agreement
#: round and the ledger release, ``adopt_ms`` re-reading the lost leaves,
#: ``rerun_ms`` the re-executed epoch; ``epochs`` counts them and
#: ``failed_at`` is the wall clock (``time.time()``) of the last failure
RECOVERY_STATS: Dict[str, float] = {}


def reset_recovery_stats() -> None:
    RECOVERY_STATS.clear()
    RECOVERY_STATS.update(fail_ms=0.0, round_ms=0.0, adopt_ms=0.0,
                          rerun_ms=0.0, epochs=0, failed_at=0.0)


reset_recovery_stats()


def _recover_epoch(svc: HostShuffleService, xid: str, epoch: int,
                   err: ExchangeFetchFailed, checks: bool = False) -> None:
    """One agreed recovery step after a lost exchange: map the failure's
    lost hosts (and locally blacklisted peers) to pids, run the
    ``{xid}-recover`` agreement round, verify the agreement (with the
    runtime checks on), and drop every host reservation the dead epoch
    staged so the re-execution starts from a clean ledger."""
    lost_now = set()
    world = {svc.host_name(p) for p in range(svc.n)}
    for p in range(svc.n):
        if p == svc.pid or p in svc.recovered_pids:
            continue
        if svc.host_name(p) in err.lost_hosts or p in svc.blacklist:
            lost_now.add(p)
    # hosts OUTSIDE the exchange world (a reaped pool-* tenant) are
    # counted and dropped: letting them into the agreement would diverge
    # the lost set across survivors whose views of the wider world differ
    foreign = set(err.lost_hosts) - world
    if foreign:
        with svc._lock:
            fresh = foreign - svc._foreign_seen
            svc._foreign_seen |= fresh
            svc.counters["foreign_hosts_ignored"] += len(fresh)
    svc.recover_round(xid, epoch, lost_now)
    from ..analysis import runtime as _az
    if checks:
        _az.verify_recovery_agreement(svc, xid, epoch)
    # the aborted epoch's reservations (map staging, fetch sinks) must
    # not shrink the re-execution's budget: released now, not at exit
    svc.ledger.release_prefix(f"shuffle:{xid}")
    if checks:
        _az.verify_epoch_released(svc.ledger, xid)
    # survivors never delete a dead peer's registered blocks: they expire
    # its LEASE (safe after agreement) and the reaper's clock runs
    if svc.blockclient is not None:
        for p in sorted(svc.recovered_pids):
            svc.blockclient.expire_owner(svc.host_name(p))
    with svc._lock:
        svc.counters["stage_retries"] += 1
        svc.counters["recovered_partitions"] += max(
            1, len(err.lost_blocks))


def _adopt_lost_leaves(session, optimized, svc: HostShuffleService):
    """The statement's plan for re-execution over the live set: for every
    PARTITIONED leaf (the epoch-0 flags), the survivor ``recovery_adopt``
    assigns a lost pid re-reads that pid's partition from its published
    file recipe and unions it into its own leaf.  Always starts from the
    PRISTINE optimized plan, so adoption composes across epochs.  Raises
    a non-recoverable structured failure when lineage cannot cover the
    loss: no recipes (the peer died before the digest round), a lost
    partition held only in process memory, or an own leaf with no file
    template to re-read through."""
    if not svc.recovered_pids:
        return optimized
    from ..io import read_file_relation
    from ..sql import logical as L
    flags = svc.last_leaf_flags
    if flags is None:
        raise _unrecoverable(
            "recovery", [svc.host_name(p)
                         for p in sorted(svc.recovered_pids)],
            "peer lost before the statement's leaf recipes were "
            "published — no lineage to re-execute its map stage from")
    if not any(flags):
        return optimized            # replicated only: nothing to adopt
    _require_recoverable(svc, flags)
    leaves: List = []

    def collect(nd):
        for c in nd.children:
            collect(c)
        if isinstance(nd, (L.LocalRelation, L.FileRelation)):
            leaves.append(nd)

    collect(optimized)
    mine = [p for p in sorted(svc.recovered_pids)
            if svc.recovery_adopt.get(p) == svc.pid]
    if not mine:
        return optimized            # another survivor adopts the loss
    plan = optimized
    for i, partitioned in enumerate(flags):
        if not partitioned or i >= len(leaves):
            continue
        leaf = leaves[i]
        if not isinstance(leaf, L.FileRelation):
            raise _unrecoverable(
                "recovery", [svc.host_name(p) for p in mine],
                f"adopter's leaf {i} is in-memory while the lost "
                "partition is a file — no template to re-read the "
                "recipe through")
        parts = [_host(read_file_relation(leaf, session))]
        for p in mine:
            ghost = copy.copy(leaf)
            ghost.paths = list(svc.leaf_recipes[p][i]["paths"])
            parts.append(_host(read_file_relation(ghost, session)))
        plan = _replace_node(plan, leaf,
                             _leaf_relation(session, _concat(parts)))
    return plan


def crossproc_execute(session, optimized, svc: HostShuffleService
                      ) -> ColumnBatch:
    """Execute one optimized plan across processes; every process
    returns the SAME complete result (the collect() contract).

    A structured ``ExchangeFetchFailed`` is recovered up to
    ``spark.tpu.recovery.maxStageRetries`` times (read at each
    statement): the survivors agree on the loss, adopt the dead peer's
    partitioned leaves from its recipes, and re-execute the whole
    statement under ``{xid}e<epoch>`` exchange ids.  A failure carrying
    ``recoverable=False`` aborts at once; with the budget at 0 every
    loss aborts.  Every host reservation the statement staged, in any
    epoch, is released on the way out."""
    seq = getattr(session, "_crossproc_seq", 0) + 1
    session._crossproc_seq = seq
    xid = f"xq{seq:06d}"
    from ..analysis import runtime as _az
    checks = _az.runtime_checks_enabled(session)
    svc.begin_statement(xid if checks else None)
    budget = svc.max_stage_retries
    plan = optimized
    epoch = 0
    try:
        while True:
            run_xid = xid if epoch == 0 else f"{xid}e{epoch}"
            pre_owners = set(svc.ledger.owners()) if checks else set()
            t0 = time.perf_counter()
            try:
                out = _crossproc_execute(session, plan, svc, run_xid)
                if checks:
                    # on success only (the finally below releases either
                    # way): every reservation the exchanges staged sits
                    # under the shuffle:<xid> scope
                    _az.verify_ledger_scope(svc.ledger, pre_owners, xid)
                if epoch:
                    RECOVERY_STATS["rerun_ms"] += \
                        (time.perf_counter() - t0) * 1e3
                return out
            except ExchangeFetchFailed as err:
                RECOVERY_STATS["failed_at"] = time.time()
                if epoch >= budget or not getattr(err, "recoverable", True):
                    raise
                t1 = time.perf_counter()
                RECOVERY_STATS["fail_ms"] += (t1 - t0) * 1e3
                epoch += 1
                # agreement and adoption raise non-recoverable errors of
                # their own: recovery never retries itself
                _recover_epoch(svc, xid, epoch, err, checks)
                t2 = time.perf_counter()
                plan = _adopt_lost_leaves(session, optimized, svc)
                RECOVERY_STATS["round_ms"] += (t2 - t1) * 1e3
                RECOVERY_STATS["adopt_ms"] += \
                    (time.perf_counter() - t2) * 1e3
                RECOVERY_STATS["epochs"] += 1
    finally:
        # epoch-suffixed owners share the shuffle:<xid> prefix, so one
        # release pairs with every epoch
        svc.ledger.release_prefix(f"shuffle:{xid}")


def _side_spec(side, base: int, join_exprs, flags: List[bool]):
    """How a join side runs under the exchange: ``("plain", None)`` (a
    per-row subtree), ``("agg", _AggSideSpec)`` (a keyed Aggregate whose
    keys SUBSUME the join keys: it ships partial state), or None (the
    side does not hold exactly one partitioned leaf, or cannot run per
    process)."""
    from ..expressions import Alias
    from ..sql import logical as L

    n = _n_leaves(side)
    if sum(flags[base: base + n]) != 1:
        return None

    def base_col(e):
        while isinstance(e, Alias):
            e = e.children[0]
        return e if isinstance(e, Col) else None

    core = side
    projs = []            # pass-through Projects, outermost first
    while True:
        if isinstance(core, L.SubqueryAlias):
            core = core.children[0]
        elif isinstance(core, L.Project) and all(
                base_col(e) is not None for e in core.exprs):
            projs.append(core)
            core = core.children[0]
        else:
            break
    if isinstance(core, L.Aggregate):
        if not _mergeable(core):
            return None

        def inner_name(nm):
            for p in projs:
                nxt = next((base_col(e).name for e in p.exprs
                            if e.name == nm), None)
                if nxt is None:
                    return None
                nm = nxt
            return nm

        key_names = {k.name for k in core.keys}
        key_map = {}
        for e in join_exprs:
            if not isinstance(e, Col):
                return None
            nm = inner_name(e.name)
            if nm not in key_names:
                return None
            key_map[e.name] = nm
        if _has_global_ops(core.children[0]) \
                or not _joins_partition_safe(core.children[0], flags, base):
            return None
        return ("agg", _AggSideSpec(core, tuple(projs), key_map))
    if _has_global_ops(side) or not _joins_partition_safe(side, flags, base):
        return None
    return ("plain", None)


def _crossproc_execute(session, optimized, svc: HostShuffleService,
                       xid: str) -> ColumnBatch:
    from ..sql import logical as L
    from ..sql.joins import equi_join_keys, range_key_spec
    from ..sql.multibatch import _with_child

    above = []
    node = optimized
    while isinstance(node, (L.SubqueryAlias, L.Project, L.Sort, L.Limit)):
        above.append(node)
        node = node.children[0]

    maybe_fast = (isinstance(node, L.Aggregate) and _mergeable(node)
                  and not _has_global_ops(node.children[0])
                  and _joins_maybe_safe(node.children[0]))

    # exchange-join candidate: the topmost join on the per-row spine
    # (under a keyed, mergeable root Aggregate when there is one)
    shuffled_on = session.conf.get(C.CROSSPROC_SHUFFLED_JOIN)
    smj_on = session.conf.get(C.CROSSPROC_SORT_MERGE_JOIN)
    bcast_threshold = session.conf.get(C.CROSSPROC_AUTO_BROADCAST)
    join = None
    key_pairs: List[Tuple] = []
    if shuffled_on or smj_on or bcast_threshold > 0:
        spine = node.children[0] if isinstance(node, L.Aggregate) \
            and _mergeable(node) else node
        join = _find_spine_join(spine)
        if join is not None:
            key_pairs = equi_join_keys(join)
            if not key_pairs:
                join = None                    # cross/theta: no hash keys

    leaf_cache: List[ColumnBatch] = []
    leaf_sizes: List[int] = []
    flags: Optional[List[bool]] = None
    if maybe_fast or join is not None or svc.recovered_pids:
        # one digest exchange classifies every leaf and carries per-leaf
        # global byte sizes; the generic fallback reuses the batches.
        # After a loss it runs for every statement: a partitioned one
        # cannot know the lost pid's rows (abort structured), a
        # replicated-only one can proceed
        flags = _leaf_partition_flags(session, node, svc, f"{xid}-digest",
                                      leaf_cache, leaf_sizes)
    if flags is not None:
        if svc.last_leaf_flags is None:
            # the statement's epoch-0 classification: adoption keys off
            # THESE flags (the adopter's leaf is a LocalRelation on a
            # re-run)
            svc.last_leaf_flags = list(flags)
        _require_recoverable(svc, flags)

    # fast path: EXACTLY one partitioned leaf (all-replicated would make
    # every process contribute identical partials), joins partition-safe
    fast = (maybe_fast and flags is not None and sum(flags) == 1
            and _joins_partition_safe(node.children[0], flags))

    l_side_spec = r_side_spec = None
    if not fast and join is not None and flags is not None:
        l_side_spec = _side_spec(join.children[0], 0,
                                 [l for l, _ in key_pairs], flags)
        r_side_spec = _side_spec(join.children[1],
                                 _n_leaves(join.children[0]),
                                 [r for _, r in key_pairs], flags)
    sides_ok = l_side_spec is not None and r_side_spec is not None
    has_agg_side = sides_ok and (l_side_spec[0] == "agg"
                                 or r_side_spec[0] == "agg")

    # the strategy, a pure function of the digest statistics; an agg side
    # pins the lane to hash (broadcasting the other side would leave its
    # partials split, and the range lane would finish them per span)
    strategy: Optional[str] = None
    range_spec = None
    adaptive_on = False
    feedback = None
    l_sig = r_sig = None
    actx = None
    if sides_ok:
        if not has_agg_side:
            range_spec = range_key_spec(join, join.children[0].schema(),
                                        join.children[1].schema())
        ln = _n_leaves(join.children[0])
        rn = _n_leaves(join.children[1])
        eff_threshold = 0 if has_agg_side else bcast_threshold
        adaptive_on = (session.conf.get(C.CROSSPROC_ADAPTIVE_REPLAN)
                       and eff_threshold > 0)
        hits0 = 0
        if adaptive_on:
            feedback = _session_feedback(session)
            l_sig = StatsFeedback.signature(join.children[0])
            r_sig = StatsFeedback.signature(join.children[1])
            hits0 = feedback.hits
        strategy = choose_join_strategy(
            join.how, range_spec is not None, smj_on, shuffled_on,
            eff_threshold, len(svc.live_pids()),
            sum(leaf_sizes[:ln]), sum(leaf_sizes[ln:ln + rn]),
            feedback=feedback, left_sig=l_sig, right_sig=r_sig)
        if adaptive_on:
            svc.bump("stats_feedback_hits", feedback.hits - hits0)
        from ..analysis import runtime as _az
        checks = _az.runtime_checks_enabled(session)
        if checks:
            _az.verify_join_strategy(join, strategy,
                                     range_spec is not None, key_pairs)
        if strategy == "gather":
            strategy = None
        if adaptive_on and strategy in ("hash", "range"):
            actx = _AdaptiveCtx(bcast_threshold, feedback, l_sig, r_sig,
                                key_pairs, checks)

    if fast:
        svc.bump("fast_path_aggs")
        child_batch = _run_local(session, node.children[0], on_device=True)
        partial_node, partial = _partial_over(node, child_batch, svc)
        mine = _route_exchange_merge(session, node, partial_node, partial,
                                     svc, xid)
        full = _gather_all(svc, f"{xid}-gather", mine, dedup=False)
    elif strategy is not None:
        if strategy in ("broadcast_left", "broadcast_right"):
            # gather ONLY the small side; the big side stays put
            svc.bump("broadcast_joins")
            side_i = 0 if strategy == "broadcast_left" else 1
            side = join.children[side_i]
            sig = (l_sig, r_sig)[side_i]
            if adaptive_on and sig is not None \
                    and feedback.peek(sig) is not None:
                # the decision came from a RECORDED output cardinality:
                # gather the side's executed OUTPUT, the measured quantity
                side_out = _run_local(session, side)
                full_small = _gather_all(svc, f"{xid}-bcast", side_out,
                                         dedup=False)
                if not _live(full_small):
                    full_small = _one_dead_row(side_out)
                join2 = _replace_node(join, side,
                                      _leaf_relation(session, full_small))
            else:
                base = 0 if side_i == 0 else _n_leaves(join.children[0])
                nl = _n_leaves(side)
                side2 = _gather_leaf_relations(
                    session, side, svc, xid, dedup=True,
                    preloaded=leaf_cache[base: base + nl] or None)
                join2 = _replace_node(join, side, side2)
        elif strategy == "range":
            left_shard, right_shard, demoted = _range_merge_join_shards(
                session, join, range_spec, svc, xid, adaptive=actx)
            if demoted == "grace":
                # the grace pass already JOINED this process's spans
                svc.bump("range_merge_joins")
                join2 = _leaf_relation(session, left_shard)
            else:
                join2 = L.Join(_leaf_relation(session, left_shard),
                               _leaf_relation(session, right_shard),
                               join.how, join.on, join.using)
                if demoted is None:
                    svc.bump("range_merge_joins")
                    # the build arrives (flag, key)-sorted: PMergeJoin
                    join2._presorted_build = True
                else:
                    svc.bump("broadcast_joins")
        else:
            left_shard, right_shard, demoted = _shuffled_join_shards(
                session, join, key_pairs, svc, xid, adaptive=actx,
                side_aggs=(l_side_spec[1], r_side_spec[1]))
            svc.bump("shuffled_joins" if demoted in (None, "grace")
                     else "broadcast_joins")
            if demoted == "grace":
                join2 = _leaf_relation(session, left_shard)
            else:
                join2 = L.Join(_leaf_relation(session, left_shard),
                               _leaf_relation(session, right_shard),
                               join.how, join.on, join.using)
        if isinstance(node, L.Aggregate) and _mergeable(node):
            # a keyed Aggregate above the join merges through the
            # partial → route → merge pipeline: each joined row crosses
            # once, as state
            child2 = _replace_node(node.children[0], join, join2)
            child_batch = _run_local(session, child2, on_device=True)
            partial_node, partial = _partial_over(node, child_batch, svc)
            mine = _route_exchange_merge(session, node, partial_node,
                                         partial, svc, f"{xid}-fin")
        else:
            # a per-row spine above the join commutes with the shard
            # union: run it per process, gather only the final rows
            mine = _run_local(session, _replace_node(node, join, join2))
        full = _gather_all(svc, f"{xid}-gather", mine, dedup=False)
    else:
        # generic path: centralize the partitioned leaves, then run the
        # whole plan locally (identically everywhere)
        svc.bump("generic_gathers")
        dedup = session.conf.get(C.CROSSPROC_DEDUP_REPLICATED)
        plan2 = _gather_leaf_relations(session, node, svc, xid, dedup,
                                       leaf_cache or None)
        full = _run_local(session, plan2)

    node2 = _leaf_relation(session, full)
    for op in reversed(above):
        rebuilt = _with_child(op, node2)
        if rebuilt is not None:          # SubqueryAlias is execution-inert
            node2 = rebuilt
    return _run_local(session, node2)
