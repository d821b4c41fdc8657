"""Whole-plan CUDA-graph capture with a process-local stage cache.

The counterpart of ``spark_tpu/sql/stagecompile.py``.  There, the
physical tree of one stage traces into ONE jitted XLA program, cached
process-wide by a structural fingerprint.  On the card the counterpart
of that executable is a captured CUDA graph: the plan's kernels — K1's
cluster launch among them — recorded once and replayed with one host
launch, instead of hundreds of eager launches per query.

``StageCache`` owns those programs: a process-local, thread-safe LRU from
a STRUCTURAL stage key — the physical plan serialized with literal
slotting (``serving/plancache.py``), the leaf batch-shape/dtype
signature and the planning-conf values — to an entry.  Builds are
single-flight per key; literals in arithmetic/comparison positions ride
in as the entry's device scalars, so ``WHERE v < 10`` and ``WHERE v <
20`` share one entry.

A dispatch on a card:

1. the first time, one EAGER warm-up run on the session's stream.  It
   records the plan's host decisions and host-built constants
   (``capture.py``), loads the kernels' libraries and makes their
   first-call settings, and its result is this dispatch's result;
2. a ``torch.cuda.CUDAGraph`` capture (``capture_error_mode=
   "thread_local"``) of a REPLAY of that record into the entry's own
   private memory pool, reading the entry's static input buffers and
   parameter scalars;
3. each later call copies the leaves into the static buffers and the
   slotted literal values into the scalars (from pinned host tensors),
   replays the graph and reads the result's flags, the guard flags
   among them, back in one transfer.  A false guard means a recorded
   decision does not hold for these data: the result is thrown away,
   the plan runs eagerly again and that VARIANT is captured too.

What the host decided depends on the leaves' string dictionaries and on
which leaves carry validity masks (in the JAX package they sit in the
pytree aux, so jit retraces when one changes): each entry keeps its
variants keyed by that ``leaf_aux`` and by the recorded decisions.

A mesh entry (``dist{n}|…`` for a query, ``mbdist{n}|…`` and
``stream|mesh{n}|…`` for a streamed step) is the same: its step is one
SPMD program (``spmd.run_shards``), whose shard threads enqueue onto the
capture stream and record and replay a shard record each
(``capture.shard_scope``); the capture holds ``_capture_turn`` for the
whole program, and K2's frozen pointer tables are checked against the
entry's stable memory (``_StableMemory``).  A streamed mesh step's
result is its shards' outputs one after another (``segments``).  A mesh
whose shards span several cards (its step's ``cards``) captures one graph
per card, each into that card's private pool, all begun and ended
together under ``_capture_turn``: every shard thread enqueues onto its
card's capture stream, K2's launches on a card go into that card's
graph, and the pointer check accepts the static buffers, constants and
pools of every card of the entry.  Its leaves are already cut per card
(``executor.place_leaves``), its parameter scalars are one set per card,
and a replay copies each card's leaves into that card's static buffers
and launches every card's graph before the one read-back from shard 0's
card.

On the CPU a dispatch runs the same record and replay code eagerly,
without a capture, so the CPU tests exercise the decisions, the
constant pool and the guards.  A capture or replay that fails raises:
nothing falls back to the eager lane.

Each graph's private pool stays allocated between queries; its bytes
(with the static input buffers) are charged to the session's
``MemoryManager`` as storage under ``stage:<key>``.  The session's
eviction callback (``memory.evict_lru``) takes the least recently used
storage first, graphs and cached relations alike: each use of an entry
takes a tick of the memory module's clock (``last_used``).  A dropped
entry's graphs, pools and static buffers go back to the card
(``_release``).

``run_per_op`` is the measured BASELINE (``spark.tpu.stage.fusion=
false``): one eager step per operator, its flags read back after each.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as C
from .. import cuda_a2a, cuda_agg, cuda_lpt
from ..capture import StageRecord, stage_run
from ..memory import evict_lru, tick

__all__ = [
    "Stage", "StageCache", "stage_cache", "stage_fingerprint",
    "leaf_signature", "leaf_aux", "count_ops", "metrics_source",
    "run_per_op", "plan_leaves", "entry_leaves",
]

_log = logging.getLogger("spark_tpu_torch.stagecompile")

#: graph variants one entry keeps (oldest dropped first)
MAX_VARIANTS = 4


# ---------------------------------------------------------------------------
# stage fingerprints
# ---------------------------------------------------------------------------

def count_ops(physical) -> int:
    """Number of physical operators fused into one stage program."""
    return 1 + sum(count_ops(c) for c in physical.children)


def leaf_signature(leaves) -> str:
    """Batch-shape/dtype signature of a stage's input leaves: the part of
    the key ``PhysicalPlan.key()`` cannot see (capacities and vector
    dtypes decide the program's shapes).  A file leaf also signs with the
    token of its files and their stat (``ColumnBatch.source``): a text
    over unchanged files keeps its key, and after a file changes the next
    run gets a new one.

    A run plane signs as ``dtype~r{plane_capacity}``: the plane capacity
    is a ``pad_capacity`` bucket of the run count, so a run count past
    the bucket re-keys the stage and captures a graph for the larger
    plane instead of replaying one built for other shapes."""
    return "x".join(
        f"{b.capacity}[{','.join(_vector_sig(v) for v in b.vectors)}]"
        + ("" if b.source is None else f"@{b.source}")
        for b in leaves)


def _vector_sig(v) -> str:
    """A vector's dtype; a run plane's with its plane capacity
    (``~r{cap}``); an array plane's with its width (``/L``)."""
    from ..columnar import unexpanded_plane, unmaterialized_runs
    p = unexpanded_plane(v)
    if p is not None:
        return f"{v.dtype}~r{p.plane_capacity}"
    if unmaterialized_runs(v) is not None:
        return str(v.dtype)           # run tables are 1-D
    if v.data.dim() == 2:
        return f"{v.dtype}/{v.data.shape[1]}"
    return str(v.dtype)


def leaf_aux(leaves) -> tuple:
    """What a variant of an entry depends on beyond its key: per leaf,
    whether it carries a row mask and, per vector, whether it carries a
    validity mask and its string dictionary (host tables built from
    dictionaries are constants of the capture)."""
    return tuple(
        (b.row_valid is None,
         tuple((v.valid is None, v.dictionary) for v in b.vectors))
        for b in leaves)


def _leaf_tensors(leaves) -> List[torch.Tensor]:
    """Every tensor of the leaves, in ``leaf_aux`` order (a run plane's
    values and lengths where a dense vector has its data)."""
    from ..columnar import PlaneColumnVector
    out = []
    for b in leaves:
        for v in b.vectors:
            if isinstance(v, PlaneColumnVector):
                out += [v.plane_values, v.plane_lengths]
            else:
                out.append(v.data)
            if v.valid is not None:
                out.append(v.valid)
        if b.row_valid is not None:
            out.append(b.row_valid)
    return out


def _ser_physical(node, slots: List) -> str:
    """Slot-aware structural serialization of a physical tree: every
    non-child field, expression fields through ``plancache._ser_expr``
    so int/float/bool literals in arithmetic/comparison positions slot
    out as ``?i`` markers."""
    from ..serving.plancache import _ser_val
    from .. import types as T
    fields = []
    for name in sorted(vars(node)):
        if name == "children":
            continue
        v = vars(node)[name]
        if name.startswith("_"):
            # private fields are planner memos EXCEPT the schema, which
            # decides the leaf layout the program was built for
            if name == "_schema" and isinstance(v, T.StructType):
                fields.append(f"schema={v.simpleString()}")
            continue
        fields.append(f"{name}={_ser_val(v, slots)}")
    inner = ",".join(_ser_physical(c, slots) for c in node.children)
    return f"{type(node).__name__}[{';'.join(fields)}]({inner})"


def stage_fingerprint(physical) -> Tuple[str, List]:
    """(structural key, slotted Literal objects) for one stage tree.

    Falls back to the un-slotted ``physical.key()`` (literal values
    inlined, no parameters) when a field defeats the serializer —
    degraded sharing, never wrong sharing."""
    from ..serving.plancache import _Unfingerprintable
    slots: List = []
    try:
        body = _ser_physical(physical, slots)
    except (_Unfingerprintable, RecursionError):
        return physical.key(), []
    return body, slots


def _conf_component(session) -> str:
    """Planning-conf values, and the device with the grouped-aggregate
    form it selects: sessions that differ in them must not share an
    entry.  The cross-process exchange's confs
    (``plancache.EXCHANGE_CONF_ENTRIES``) shape no stage and are left
    out."""
    if session is None:
        return ""
    from ..kernels import _mxu_agg_on
    from ..serving.plancache import PLANNING_CONF_ENTRIES
    conf = ";".join(f"{e.key}={session.conf.get(e)!r}"
                    for e in PLANNING_CONF_ENTRIES)
    return f"{conf};device={session.device};mxu={_mxu_agg_on(session.device)}"


def param_values(slots) -> Tuple:
    """Runtime argument tuple for one execution of a slotted stage —
    positionally aligned with any fingerprint-equal plan's slots."""
    return tuple(np.asarray(l.value, dtype=l.dtype.np_dtype) for l in slots)


class Stage:
    """One stage: the physical tree plus the input/output schemas at its
    cut points, recorded when the entry is built."""

    __slots__ = ("physical", "in_schemas", "out_schema", "key", "n_ops")

    def __init__(self, physical, in_schemas, out_schema, key: str = "",
                 n_ops: int = 0):
        self.physical = physical
        self.in_schemas = list(in_schemas)   # [StructType] in leaf order
        self.out_schema = out_schema         # StructType at the out cut
        self.key = key
        self.n_ops = n_ops or count_ops(physical)


# ---------------------------------------------------------------------------
# one entry and its variants
# ---------------------------------------------------------------------------

def _read_back(scalars: Sequence[torch.Tensor]) -> List[int]:
    """Device scalars as host ints, in ONE device → host transfer."""
    return _stack(scalars).cpu().tolist()


def _stack(scalars: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([s.reshape(()).to(torch.int64) for s in scalars])


#: packed read-backs of streamed steps (``ship_rows``): one per batch
PACKED_READS = 0
#: second reads of a streamed step whose live rows exceeded ``ship_rows``
PACKED_REREADS = 0
#: host ms in those read-backs, from the copy's call to its return (on a
#: card this holds the wait for the step's kernels to finish)
READBACK_MS = 0.0


class _StreamStep(threading.local):
    """Set while a streamed step is dispatched (``ship_rows``) and while
    its one read-back runs: what the CPU tests trap host reads by."""
    active = False
    reading = False


STREAM_STEP = _StreamStep()


def _read_result(out, vec: torch.Tensor, ship_rows: Optional[int],
                 segments: int = 1):
    """(result batch, host ints) of one run: ``out`` with the scalars read
    back in one transfer (``ship_rows`` None: the caller reads ``out``
    itself), or — a streamed step — the scalars and the first
    ``ship_rows`` rows of every column of ``out`` in ONE packed copy
    (``columnar.pack_to_host``).  When more rows are live than shipped,
    a second copy brings the rest (``PACKED_REREADS``).

    A mesh step's ``out`` is ``segments`` shard outputs one after another,
    each with its live rows first and its most live rows in the first
    scalar: the copy ships the first rows of every segment, and the
    batch it returns holds them one segment after another."""
    global PACKED_READS, PACKED_REREADS, READBACK_MS
    if ship_rows is None:
        return out, vec.cpu().tolist()
    from ..columnar import pad_capacity
    STREAM_STEP.reading = True
    t0 = time.perf_counter()
    try:
        seg_cap = out.capacity // segments
        rows = min(ship_rows, seg_cap)
        host = _pack_rows(out, rows, segments, vec)
        PACKED_READS += 1
        ints = host[0].tolist()
        if ints[0] > rows:
            PACKED_REREADS += 1
            rows = min(pad_capacity(ints[0]), seg_cap)
            if segments == 1:
                return out.packed_host(rows), ints
            host = [None] + _pack_rows(out, rows, segments)
        return _rows_batch(out, host[1:], rows * segments), ints
    finally:
        STREAM_STEP.reading = False
        READBACK_MS += (time.perf_counter() - t0) * 1e3


def _pack_rows(out, rows: int, segments: int,
               vec: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """``vec`` (when given) and the first ``rows`` rows of each of the
    ``segments`` equal segments of every column of ``out``, on the host
    in one packed copy."""
    from ..columnar import pack_to_host
    seg_cap = out.capacity // segments

    def head(t: torch.Tensor) -> torch.Tensor:
        if segments == 1:
            return t[:rows]
        rest = tuple(t.shape[1:])
        return t.reshape((segments, seg_cap) + rest)[:, :rows] \
            .reshape((segments * rows,) + rest)

    parts = [] if vec is None else [vec]
    for v in out.vectors:
        parts.append(head(v.data))
        if v.valid is not None:
            parts.append(head(v.valid))
    if out.row_valid is not None:
        parts.append(head(out.row_valid))
    return pack_to_host(parts)


def _rows_batch(out, host: List[torch.Tensor], capacity: int):
    """A batch of ``out``'s schema over its packed host columns."""
    from ..columnar import ColumnBatch, ColumnVector
    it = iter(host)
    vectors = [ColumnVector(next(it), v.dtype,
                            None if v.valid is None else next(it),
                            v.dictionary) for v in out.vectors]
    rv = None if out.row_valid is None else next(it)
    return ColumnBatch(out.names, vectors, rv, capacity)


class _Variant:
    """One recorded run of an entry: its record (decisions, constants),
    the host metadata of its result and, on a card, its captured graph
    with the static buffers the graph reads and writes."""

    __slots__ = ("aux", "record", "meta", "graph", "static", "params",
                 "pinned", "out", "scalars", "n_guards", "pool_bytes",
                 "static_bytes", "k1_launches", "k2_launches",
                 "lpt_launches", "graphs", "card_params", "card_bytes",
                 "k2_cards", "barrier_cards", "static_cards")

    def __init__(self, aux, record: StageRecord, meta):
        self.aux = aux
        self.record = record
        self.meta = meta
        self.graph = None
        self.static: List[torch.Tensor] = []
        self.params: List[torch.Tensor] = []
        self.pinned: List[torch.Tensor] = []
        self.out = None
        self.scalars: Optional[torch.Tensor] = None
        self.n_guards = 0
        self.pool_bytes = 0
        self.static_bytes = 0
        #: K1 launches captured into ``graph``, by entry, and K2's and
        #: lpt_assign's (a mesh entry): each replay runs them again
        self.k1_launches: Dict[str, int] = {}
        self.k2_launches = 0
        self.lpt_launches = 0
        #: shards on several cards: one graph per card (``graph`` is card
        #: 0's), one list of parameter scalars per card, each card's pool
        #: and static bytes, and K2's copy and barrier launches captured on
        #: each card (by device index)
        self.graphs: List[Any] = []
        self.static_cards: List[int] = []
        self.card_params: Optional[List[List[torch.Tensor]]] = None
        self.card_bytes: List[int] = []
        self.k2_cards: Dict[int, int] = {}
        self.barrier_cards: Dict[int, int] = {}

    @property
    def nbytes(self) -> int:
        return self.pool_bytes + self.static_bytes


class _CachedStage:
    """Payload of one cache entry: the stage step (built ONCE by the
    cache's caller), the entry-owned ``Stage`` record and the captured
    variants.

    ``fn(leaves, params) -> (compacted batch, [device scalars], meta)``
    runs the plan once; its scalars start with the row count."""

    __slots__ = ("key", "fn", "aux", "n_ops", "segments", "compile_ms",
                 "hits", "variants", "guard_misses", "in_use", "charged_to",
                 "last_used", "_lock", "cards", "charged_cards")

    def __init__(self, key: str, fn, aux, n_ops: int, segments: int = 1):
        self.key = key
        self.fn = fn
        self.aux = aux
        self.n_ops = n_ops
        #: a mesh step's shard outputs in its result (``_read_result``)
        self.segments = segments
        self.compile_ms = 0.0
        self.hits = 0
        self.variants: List[_Variant] = []
        self.guard_misses = 0
        self.in_use = 0
        #: the MemoryManager this entry's graph bytes are charged to
        self.charged_to = None
        #: the storage clock's tick of the last use (``memory.tick``)
        self.last_used = tick()
        self._lock = threading.Lock()
        #: a mesh step whose shards span several cards: the cards (its
        #: step's ``cards``); None on one card
        self.cards = getattr(fn, "cards", None)
        #: the other cards' managers their graph bytes are charged to
        self.charged_cards: List[Any] = []

    @property
    def storage_key(self) -> str:
        return f"stage:{self.key}"

    @property
    def nbytes(self) -> int:
        return sum(v.nbytes for v in self.variants)

    def card_nbytes(self) -> List[int]:
        """Shards on several cards: the variants' bytes on each card, in
        ``cards`` order (empty on one card)."""
        if not self.cards:
            return []
        out = [0] * len(self.cards)
        for v in self.variants:
            for c, nb in enumerate(v.card_bytes):
                out[c] += nb
        return out

    def variant_for(self, aux) -> Optional[_Variant]:
        """The newest variant recorded for leaves of this ``aux``."""
        for v in reversed(self.variants):
            if v.aux == aux:
                return v
        return None

    def _run(self, leaves, params, record: StageRecord, replay: bool):
        """One run of the step over ``record``: (batch, scalars with the
        guards last, meta, number of guards)."""
        with stage_run(record, replay) as run:
            out, scalars, meta = self.fn(leaves, params)
            run.check_consumed()
        return out, list(scalars) + run.guards, meta, len(run.guards)

    # -- the CPU: the same record and replay, eagerly -------------------
    def dispatch_eager(self, leaves, params, finish, device,
                       ship_rows=None):
        """(result, build ms or None when an existing variant served)."""
        aux = leaf_aux(leaves)
        if self.cards:
            ptensors = [[torch.as_tensor(p, device=c) for p in params]
                        for c in self.cards]
        else:
            ptensors = [torch.as_tensor(p, device=device) for p in params]
        v = self.variant_for(aux)
        if v is not None:
            out, scalars, meta, ng = self._run(leaves, ptensors, v.record,
                                               True)
            res, host = _read_result(out, _stack(scalars), ship_rows,
                                     self.segments)
            if all(host[len(host) - ng:]):
                return finish(res, host[:len(host) - ng], meta), None
            self.guard_misses += 1
        t0 = time.perf_counter()
        record = StageRecord()
        out, scalars, meta, _ng = self._run(leaves, ptensors, record, False)
        res, host = _read_result(out, _stack(scalars), ship_rows,
                                 self.segments)
        self._add(_Variant(aux, record, meta))
        result = finish(res, host, meta)
        return result, (time.perf_counter() - t0) * 1e3

    # -- a card: warm-up, capture, replay --------------------------------
    def dispatch_graph(self, leaves, params, finish, device,
                       ship_rows=None):
        """(result, build ms or None when a replay served).  A leaf is a
        batch on the card or a pinned host batch (a file leaf): either is
        copied into the graph's static buffers, outside the capture, by
        ``non_blocking`` copies on the current stream."""
        aux = leaf_aux(leaves)
        v = self.variant_for(aux)
        if v is not None:
            if self.cards:
                self._replay_cards(v, leaves, params)
            else:
                for dst, src in zip(v.static, _leaf_tensors(leaves)):
                    dst.copy_(src, non_blocking=True)
                self._set_params(v, params)
                v.graph.replay()
            _count_replay(v)
            res, host = _read_result(v.out, v.scalars, ship_rows,
                                     self.segments)
            n = len(host) - v.n_guards
            if all(host[n:]):
                return finish(res, host[:n], v.meta), None
            self.guard_misses += 1
        t0 = time.perf_counter()
        if self.cards:
            # each card's part is on its card already
            v, result = self._build_variant_cards(aux, leaves, params,
                                                  finish, ship_rows)
        else:
            leaves = [b.to_device(device, non_blocking=True)
                      for b in leaves]
            v, result = self._build_variant(aux, leaves, params, finish,
                                            device, ship_rows)
        self._add(v)
        return result, (time.perf_counter() - t0) * 1e3

    @staticmethod
    def _set_params(v: _Variant, params, streams=None) -> None:
        """The parameter scalars from pinned host tensors; on several cards
        ``v.params`` holds one set per card, set on that card's stream of
        ``streams`` (or the current one)."""
        n = len(params)
        for i, (dev, pin) in enumerate(zip(v.params, v.pinned)):
            pin.fill_(params[i % n].item())
            with torch.cuda.stream(streams[i // n]) if streams \
                    else contextlib.nullcontext():
                dev.copy_(pin, non_blocking=True)

    def _replay_cards(self, v: _Variant, leaves, params) -> None:
        """One replay of a variant whose shards span several cards: each
        card's leaves into its static buffers and its parameter scalars
        set, on its stream, then every card's graph launched, all before
        the caller reads anything back."""
        streams = [torch.cuda.current_stream(d) for d in self.cards]
        for dst, src, c in zip(v.static, _leaf_tensors(leaves),
                               v.static_cards):
            with torch.cuda.stream(streams[c]):
                dst.copy_(src, non_blocking=True)
        self._set_params(v, params, streams)
        for g, st in zip(v.graphs, streams):
            with torch.cuda.stream(st):
                g.replay()

    def _build_variant(self, aux, leaves, params, finish, device,
                       ship_rows=None):
        record = StageRecord()
        v = _Variant(aux, record, None)
        # the entry's parameter scalars, filled from pinned host tensors:
        # the warm-up and the graph read the same addresses
        for p in params:
            dt = torch.from_numpy(np.asarray(p)).dtype
            v.pinned.append(torch.empty((), dtype=dt).pin_memory())
            v.params.append(torch.empty((), dtype=dt, device=device))
        self._set_params(v, params)
        # 1. the eager warm-up: records decisions and constants, loads
        #    the kernels and makes their first-call settings
        out, scalars, meta, _ng = self._run(leaves, v.params, record, False)
        res, host = _read_result(out, _stack(scalars), ship_rows,
                                 self.segments)
        result = finish(res, host, meta)
        del out, scalars, res
        # 2. the capture, over the entry's own copies of the leaves
        static_leaves = [_clone_batch(b) for b in leaves]
        v.static = _leaf_tensors(static_leaves)
        v.static_bytes = sum(t.numel() * t.element_size() for t in v.static)
        graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        with _capture_turn():
            k1_before = dict(cuda_agg.CAPTURED_LAUNCHES)
            k2_before = cuda_a2a.CAPTURED_LAUNCHES
            lpt_before = cuda_lpt.CAPTURED_LAUNCHES
            # K2's pointer table is frozen into the graph: it may point
            # only at the static buffers, the record's constants and the
            # pool (a mesh entry's shards allocate there too: the
            # allocator routes by the capture stream they run on)
            cuda_a2a.CAPTURE_SOURCES = _StableMemory(
                device, pool, v.static + v.params, record)
            try:
                with torch.cuda.graph(graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    out, scalars, meta, ng = self._run(
                        static_leaves, v.params, record, True)
                    vec = _stack(scalars)
            finally:
                cuda_a2a.CAPTURE_SOURCES = None
            v.k1_launches = {e: n - k1_before[e] for e, n in
                             cuda_agg.CAPTURED_LAUNCHES.items()
                             if n > k1_before[e]}
            v.k2_launches = cuda_a2a.CAPTURED_LAUNCHES - k2_before
            v.lpt_launches = cuda_lpt.CAPTURED_LAUNCHES - lpt_before
        v.pool_bytes = _pool_bytes(device, pool)
        v.graph, v.out, v.scalars, v.n_guards, v.meta = \
            graph, out, vec, ng, meta
        return v, result

    def _build_variant_cards(self, aux, leaves, params, finish,
                             ship_rows=None):
        """Warm-up and capture of a variant whose shards span several
        cards: one graph per card, each in its own private pool, begun
        together, captured while every shard thread enqueues onto its
        card's capture stream, and ended together."""
        from ..parallel.spmd import card_streams
        cards = self.cards
        record = StageRecord()
        v = _Variant(aux, record, None)
        v.card_params = []
        for dev in cards:
            mine = []
            for p in params:
                dt = torch.from_numpy(np.asarray(p)).dtype
                v.pinned.append(torch.empty((), dtype=dt).pin_memory())
                mine.append(torch.empty((), dtype=dt, device=dev))
            v.card_params.append(mine)
            v.params += mine
        self._set_params(v, params)
        # 1. the eager warm-up on each card's current stream
        out, scalars, meta, _ng = self._run(leaves, v.card_params, record,
                                            False)
        res, host = _read_result(out, _stack(scalars), ship_rows,
                                 self.segments)
        result = finish(res, host, meta)
        del out, scalars, res
        # 2. the capture: one graph per card over the entry's own copies
        #    of each card's leaves
        static_leaves = [_clone_batch(b) for b in leaves]
        v.static = _leaf_tensors(static_leaves)
        # leaf i is card i % C's (``place_leaves``' parts, then each
        # replicated leaf once per card)
        v.static_cards = [i % len(cards) for i, b in
                          enumerate(static_leaves)
                          for _t in _leaf_tensors([b])]
        # each graph is instantiated once every capture has ended: the
        # capturing thread may instantiate nothing while a capture of its
        # is open
        graphs = [torch.cuda.CUDAGraph(keep_graph=True) for _ in cards]
        pools = [torch.cuda.graph_pool_handle() for _ in cards]
        streams = [torch.cuda.Stream(device=d) for d in cards]
        # as ``torch.cuda.graph`` does before a capture: the warm-up's freed
        # blocks go back to each card, so the pools can have them
        gc.collect()
        for d in sorted({cuda_a2a._index(d) for d in cards}):
            torch.cuda.synchronize(d)
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
        with _capture_turn():
            k1_before = dict(cuda_agg.CAPTURED_LAUNCHES)
            k2_before = cuda_a2a.CAPTURED_LAUNCHES
            k2c_before = dict(cuda_a2a.CARD_CAPTURED)
            bar_before = dict(cuda_a2a.CARD_CAPTURED_BARRIERS)
            lpt_before = cuda_lpt.CAPTURED_LAUNCHES
            cuda_a2a.CAPTURE_SOURCES = _StableMemory(
                cards, pools, v.static + v.params, record)
            began, failed = [], None
            try:
                # "relaxed": this thread opens one capture per card, and
                # torch's capture_begin on a card makes that card's graph
                # generator state with an allocation, which the
                # thread-local mode forbids to a thread with a capture
                # open (a sync on a capturing stream still fails)
                for dev, g, pool, st in zip(cards, graphs, pools, streams):
                    with torch.cuda.device(dev), torch.cuda.stream(st):
                        g.capture_begin(pool=pool,
                                        capture_error_mode="relaxed")
                    began.append((dev, g, st))
                with contextlib.ExitStack() as scope:
                    scope.enter_context(torch.cuda.device(cards[0]))
                    scope.enter_context(torch.cuda.stream(streams[0]))
                    scope.enter_context(card_streams(streams))
                    out, scalars, meta, ng = self._run(
                        static_leaves, v.card_params, record, True)
                    vec = _stack(scalars)
            except BaseException as e:
                failed = e
                raise
            finally:
                ends = []
                for dev, g, st in reversed(began):
                    try:
                        with torch.cuda.device(dev), torch.cuda.stream(st):
                            g.capture_end()
                    except Exception as e:       # noqa: BLE001 — raised below
                        ends.append(e)
                cuda_a2a.CAPTURE_SOURCES = None
                if ends and failed is None:
                    raise RuntimeError(
                        f"the capture of {self.key[:60]}… on "
                        f"{len(cards)} cards failed: {ends[0]}") from ends[0]
            for dev, g in zip(cards, graphs):
                with torch.cuda.device(dev):
                    g.instantiate()
            v.k1_launches = {e: n - k1_before[e] for e, n in
                             cuda_agg.CAPTURED_LAUNCHES.items()
                             if n > k1_before[e]}
            v.k2_launches = cuda_a2a.CAPTURED_LAUNCHES - k2_before
            v.k2_cards = {d: n - k2c_before.get(d, 0) for d, n in
                          cuda_a2a.CARD_CAPTURED.items()
                          if n > k2c_before.get(d, 0)}
            v.barrier_cards = {d: n - bar_before.get(d, 0) for d, n in
                               cuda_a2a.CARD_CAPTURED_BARRIERS.items()
                               if n > bar_before.get(d, 0)}
            v.lpt_launches = cuda_lpt.CAPTURED_LAUNCHES - lpt_before
        v.card_bytes = []
        for dev, pool in zip(cards, pools):
            mine = [t for t in v.static + v.params
                    if cuda_a2a.same_card(t.device, dev)]
            v.card_bytes.append(_pool_bytes(dev, pool) + sum(
                t.numel() * t.element_size() for t in mine))
        v.pool_bytes = sum(_pool_bytes(d, p) for d, p in zip(cards, pools))
        v.static_bytes = sum(t.numel() * t.element_size() for t in v.static)
        v.graphs = graphs
        v.graph, v.out, v.scalars, v.n_guards, v.meta = \
            graphs[0], out, vec, ng, meta
        return v, result

    def _add(self, v: _Variant) -> None:
        self.variants.append(v)
        del self.variants[:-MAX_VARIANTS]


def _count_replay(v: _Variant) -> None:
    """A replay launches the variant's captured kernels again: count them
    on the host (the wrappers are not called)."""
    for entry, n in v.k1_launches.items():
        cuda_agg.REPLAYED_LAUNCHES[entry] += n
    cuda_a2a.REPLAYED_LAUNCHES += v.k2_launches
    cuda_a2a.CARD_REPLAYED.update(v.k2_cards)
    cuda_a2a.CARD_REPLAYED_BARRIERS.update(v.barrier_cards)
    cuda_lpt.REPLAYED_LAUNCHES += v.lpt_launches


class _StableMemory:
    """Whether an address lies in memory a replay of the variant being
    captured finds unchanged: its static tensors, its record's constants
    (every shard's too) or its graph pool — every card's pool, when the
    variant spans several cards (``device`` and ``pool`` then lists).  The
    pools' segments are read from the allocator's snapshot again when an
    address is in none of the known ranges (a pool grows during the
    capture)."""

    def __init__(self, device, pool, static: Sequence[torch.Tensor],
                 record: StageRecord):
        if not isinstance(device, (list, tuple)):
            device, pool = [device], [pool]
        self.device, self.pool = list(device), list(pool)
        tensors = list(static)
        todo = [record]
        while todo:
            r = todo.pop()
            tensors += r.constants
            todo += r.shards
        self.fixed = [(t.data_ptr(), t.data_ptr() + t.numel()
                       * t.element_size()) for t in tensors]
        self.segments: List[Tuple[int, int]] = []

    def _inside(self, ptr: int, ranges) -> bool:
        return any(lo <= ptr < hi for lo, hi in ranges)

    def __call__(self, ptr: int) -> bool:
        if self._inside(ptr, self.fixed) or self._inside(ptr, self.segments):
            return True
        self.segments = [seg for d, p in zip(self.device, self.pool)
                         for seg in _pool_segments(d, p)]
        return self._inside(ptr, self.segments)


def _pool_segments(device, pool) -> List[Tuple[int, int]]:
    """(start, end) of each segment the caching allocator holds in graph
    pool ``pool`` on ``device``."""
    return [(seg["address"], seg["address"] + seg["total_size"])
            for seg in _pool_snapshot(device, pool)]


def _pool_snapshot(device, pool) -> List[dict]:
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    want = tuple(pool)
    return [seg for seg in torch.cuda.memory_snapshot()
            if seg["device"] == index
            and tuple(seg.get("segment_pool_id", ())) == want]


def _pool_bytes(device, pool) -> int:
    """Bytes the caching allocator holds in graph pool ``pool`` on
    ``device``: its segments, read from the allocator's snapshot (the
    change of ``memory_reserved`` across a capture would also count what
    other threads allocate meanwhile)."""
    return sum(seg["total_size"] for seg in _pool_snapshot(device, pool))


def entry_leaves(leaves, device) -> list:
    """A stage entry's leaves: a pinned host batch (a file leaf on a card)
    as it is — the entry copies it into its static buffers — and every
    other batch on ``device``, a run vector that did not become a plane
    dense (its key signs it so)."""
    from ..columnar import dense_runs
    device = torch.device(device)
    return [b if device.type == "cuda" and b.device.type == "cpu"
            and b.is_pinned() else dense_runs(b, device) for b in leaves]


def _clone_batch(b):
    from ..columnar import ColumnBatch, ColumnVector, PlaneColumnVector
    return ColumnBatch(
        b.names,
        [v.clone() if isinstance(v, PlaneColumnVector)
         else ColumnVector(v.data.clone(), v.dtype,
                           None if v.valid is None else v.valid.clone(),
                           v.dictionary) for v in b.vectors],
        None if b.row_valid is None else b.row_valid.clone(), b.capacity)


# ---------------------------------------------------------------------------
# the process-local stage cache
# ---------------------------------------------------------------------------

class StageCache:
    """Thread-safe process-local LRU: stage key → entry."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, _CachedStage]" = \
            collections.OrderedDict()
        # per-key single-flight build locks: N threads missing one stage
        # build it once, not N times
        self._building: Dict[str, threading.Lock] = {}
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.dispatches = 0
        self.compile_ms = 0.0
        self.total_ops = 0
        self.variants = 0
        self.guard_misses = 0

    # -- lookup / build ------------------------------------------------
    def get_or_build(self, key: str, make_fn: Callable[[], Tuple],
                     n_ops: int = 1, session=None,
                     segments: int = 1) -> _CachedStage:
        """``make_fn`` returns ``(step, aux)`` — the stage step and any
        entry-owned metadata; built once per key.  An ``aux`` that is the
        stage's ``Stage`` record has its cut contract verified for
        ``session`` before the entry exists
        (``analysis.maybe_verify_stage_contract``).  ``segments``: the
        shard outputs a mesh step's result holds (``_read_result``)."""
        if session is not None:
            self.max_entries = int(
                session.conf.get(C.STAGE_CACHE_MAX_ENTRIES))
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                entry.hits += 1
                entry.last_used = tick()
                return entry
            build_lock = self._building.setdefault(key, threading.Lock())
        with build_lock:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:      # lost the build race: a hit
                    self._entries.move_to_end(key)
                    self.hits += 1
                    entry.hits += 1
                    entry.last_used = tick()
                    return entry
            fn, aux = make_fn()
            if session is not None and isinstance(aux, Stage):
                from ..analysis import maybe_verify_stage_contract
                maybe_verify_stage_contract(session, aux)
            entry = _CachedStage(key, fn, aux, n_ops, segments)
            with self._lock:
                self.misses += 1
                self.builds += 1
                self.total_ops += n_ops
                self._entries[key] = entry
                victims = []
                while len(self._entries) > max(self.max_entries, 1):
                    victims.append(self._entries.popitem(last=False)[1])
                self._building.pop(key, None)
            _release(victims)
            return entry

    def dispatch(self, entry: _CachedStage, leaves, params,
                 finish: Callable, device, memory=None,
                 ship_rows: Optional[int] = None, card_memory=None):
        """Run one entry on ``leaves`` (batches on ``device``)
        with the slotted literal values ``params``; ``finish(batch,
        host_ints, meta)`` turns the device result into the caller's
        result while the entry's buffers still hold it.  The first run
        of each variant is timed as the entry's build cost (warm-up plus
        capture on a card).

        With ``ship_rows`` (a streamed step of the out-of-core runners)
        ``finish`` gets the HOST batch instead: the result's first
        ``ship_rows`` rows, read back with the flags in one packed copy
        (``_read_result``).

        An entry whose shards span several cards charges each card's
        graph bytes to that card's manager (``card_memory(device)``; the
        session's own, ``memory``, for its card)."""
        with self._lock:
            self.dispatches += 1
            entry.in_use += 1
            entry.last_used = tick()
        try:
            with entry._lock:
                n_variants, misses = len(entry.variants), entry.guard_misses
                on_card = torch.device(device).type == "cuda"
                run = entry.dispatch_graph if on_card else \
                    entry.dispatch_eager
                STREAM_STEP.active = ship_rows is not None
                try:
                    result, ms = run(leaves, params, finish, device,
                                     ship_rows)
                finally:
                    STREAM_STEP.active = False
                built = ms is not None
                nbytes = entry.nbytes
                by_card = entry.card_nbytes()
            with self._lock:
                self.guard_misses += entry.guard_misses - misses
                if built:
                    self.variants += 1
                    entry.compile_ms += ms
                    self.compile_ms += ms
            if built and on_card and memory is not None:
                if by_card and card_memory is not None:
                    self._charge_cards(entry, memory, card_memory, by_card)
                else:
                    self._charge(entry, memory, nbytes)
            return result
        finally:
            with self._lock:
                entry.in_use -= 1

    def _charge(self, entry: _CachedStage, memory, nbytes: int) -> None:
        """Charge the entry's graph bytes as storage; an entry that
        cannot be held is dropped (its graphs are freed once this query
        lets go of them)."""
        memory.release_storage(entry.storage_key)
        entry.charged_to = memory
        if not memory.try_acquire_storage(entry.storage_key, nbytes):
            _log.warning("stage entry of %d B does not fit the device "
                         "memory budget: dropped after this run", nbytes)
            self._drop(entry)
            return
        with self._lock:
            kept = self._entries.get(entry.key) is entry
        if not kept:                     # evicted meanwhile
            memory.release_storage(entry.storage_key)
            entry.charged_to = None

    def _charge_cards(self, entry: _CachedStage, memory, card_memory,
                      by_card: List[int]) -> None:
        """``_charge`` per card: card 0's bytes to ``memory`` (the entry's
        ``charged_to``, which evicts it), every other card's to its own
        manager; an entry one card cannot hold is dropped."""
        for m in entry.charged_cards:
            m.release_storage(entry.storage_key)
        entry.charged_cards = []
        for dev, nbytes in zip(entry.cards[1:], by_card[1:]):
            m = card_memory(dev)
            if not m.try_acquire_storage(entry.storage_key, nbytes):
                _log.warning("stage entry's %d B on %s do not fit its "
                             "device memory budget: dropped after this "
                             "run", nbytes, dev)
                self._drop(entry)
                return
            entry.charged_cards.append(m)
        self._charge(entry, memory, by_card[0])

    def _drop(self, entry: _CachedStage) -> None:
        with self._lock:
            if self._entries.get(entry.key) is entry:
                del self._entries[entry.key]
        _release([entry])

    def evict(self, memory, nbytes: int) -> int:
        """Drop least recently used entries charged to ``memory`` that no
        query is running, until ``nbytes`` are released.  Returns the
        bytes released.  (A session evicts through ``memory.evict_lru``
        over this cache and its cached relations.)"""
        return evict_lru(memory, nbytes, (self,))

    def eviction_candidates(self, memory) -> list:
        """``(last tick, evict)`` of each entry charged to ``memory`` that
        no query is running (a storage tenant of ``memory.evict_lru``)."""
        with self._lock:
            return [(e.last_used, lambda e=e: self._evict_one(memory, e))
                    for e in self._entries.values()
                    if e.charged_to is memory and not e.in_use]

    def _evict_one(self, memory, entry: _CachedStage) -> int:
        with self._lock:
            if self._entries.get(entry.key) is not entry or entry.in_use:
                return 0
            del self._entries[entry.key]
        freed = memory.storage_held(entry.storage_key)
        _release([entry])
        return freed

    # -- introspection -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._entries)
            return {
                "hits": self.hits, "misses": self.misses,
                "builds": self.builds, "dispatches": self.dispatches,
                "compile_ms": round(self.compile_ms, 2),
                "entries": n, "max_entries": self.max_entries,
                "stages_fused": self.builds,
                "ops_per_stage": round(
                    self.total_ops / self.builds, 2) if self.builds else 0.0,
                "variants": self.variants,
                "guard_misses": self.guard_misses,
                "graph_bytes": sum(e.nbytes for e in self._entries.values()),
                "graph_bytes_by_card": _bytes_by_card(
                    self._entries.values()),
                "capture_waits": CAPTURE_WAITS,
            }

    def entries(self) -> List[_CachedStage]:
        with self._lock:
            return list(self._entries.values())

    def clear(self) -> None:
        with self._lock:
            victims = list(self._entries.values())
            self._entries.clear()
            self._building.clear()
            self.hits = self.misses = self.builds = 0
            self.dispatches = 0
            self.compile_ms = 0.0
            self.total_ops = 0
            self.variants = self.guard_misses = 0
        _release(victims)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: one capture at a time, and no pool returned to the card during one:
#: the caching allocator asserts that no capture is underway (on any
#: thread) when it frees its cached blocks, and ``empty_cache`` does
#: that.  Replays and eager work of other threads go on during a
#: capture (``capture_error_mode="thread_local"``).
_CAPTURE_LOCK = threading.Lock()
#: times a capture or a pool release waited for the other (or for
#: another capture)
CAPTURE_WAITS = 0


def _bytes_by_card(entries) -> Dict[str, int]:
    """The graph bytes of the entries whose shards span several cards, per
    card."""
    out: Dict[str, int] = {}
    for e in entries:
        for dev, nb in zip(e.cards or (), e.card_nbytes()):
            if not nb:
                continue
            key = f"cuda:{cuda_a2a._index(dev)}"
            out[key] = out.get(key, 0) + nb
    return out


class _capture_turn:
    """Hold ``_CAPTURE_LOCK``, counting a wait in ``CAPTURE_WAITS``."""

    def __enter__(self):
        global CAPTURE_WAITS
        if not _CAPTURE_LOCK.acquire(blocking=False):
            _CAPTURE_LOCK.acquire()
            CAPTURE_WAITS += 1            # counted under the lock

    def __exit__(self, *exc):
        _CAPTURE_LOCK.release()


def _release(entries) -> None:
    """Release dropped entries (outside the cache lock: the memory
    manager's lock is taken before the cache's): their storage charges,
    and their graphs with the private pools and static buffers, which go
    back to the card (``torch.cuda.empty_cache``) so a long-running
    server gets the bytes back.  A replay in flight finishes first (the
    entry's lock)."""
    freed, cards = False, set()
    for entry in entries:
        mem, entry.charged_to = entry.charged_to, None
        if mem is not None:
            mem.release_storage(entry.storage_key)
        for m in entry.charged_cards:
            m.release_storage(entry.storage_key)
        entry.charged_cards = []
        with entry._lock:
            freed |= any(v.graph is not None for v in entry.variants)
            if entry.cards and freed:
                cards |= {cuda_a2a._index(d) for d in entry.cards}
            entry.variants = []
    if freed:
        with _capture_turn():
            torch.cuda.empty_cache()
            for d in sorted(cards):
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()


#: THE process-local cache
_CACHE: Optional[StageCache] = None
_CACHE_LOCK = threading.Lock()


def stage_cache(session=None) -> StageCache:
    global _CACHE
    if _CACHE is None:
        with _CACHE_LOCK:
            if _CACHE is None:
                _CACHE = StageCache()
    return _CACHE


def metrics_source() -> Dict[str, Callable]:
    """Gauges for a 'compile' metrics source: resolved per read, so a
    source registered before the first build still reports live
    numbers."""
    from .. import columnar as _col
    def g(key, default=0):
        def read():
            return stage_cache().stats().get(key, default)
        return read
    return {
        "stage_compile_ms": g("compile_ms", 0.0),
        "stage_cache_hits": g("hits"),
        "stage_cache_misses": g("misses"),
        "stage_cache_entries": g("entries"),
        "stage_dispatches": g("dispatches"),
        "stages_fused": g("stages_fused"),
        "ops_per_stage": g("ops_per_stage", 0.0),
        # run planes at the stage boundary: how often a stage ran over
        # compressed leaves, and both fallback counters
        "run_plane_stages": _col.run_plane_stages,
        "run_plane_rows": _col.run_plane_rows,
        "run_plane_overflows": _col.run_plane_overflows,
        "run_plane_expansions": _col.run_plane_expansions,
    }


# ---------------------------------------------------------------------------
# run planes at the stage boundary
# ---------------------------------------------------------------------------

def plan_leaves(session, leaves, device=None):
    """How each lazy run column of a stage's leaves enters the stage
    (``spark_tpu/sql/stagecompile.py`` ``plan_leaves``): as a fixed-
    capacity run PLANE, or dense.

    A plane is taken only where it compresses: the padded plane at most
    half the dense capacity (``pad_capacity(n_runs) * 2 <= capacity``).
    A run vector that fails bumps ``run_plane_overflows`` and enters
    dense, as does every run vector with the conf off.  Called BEFORE the
    stage key: a plane changes ``leaf_signature``, so plane-shaped inputs
    never meet a graph captured for dense ones or for another plane
    size.  Returns the leaves with every run vector a plane or dense
    (on ``device`` when one is given, else on the host)."""
    from ..columnar import (ColumnBatch, PlaneColumnVector, RunColumnVector,
                            bump_plane_overflow, bump_plane_rows,
                            bump_plane_stage, pad_capacity,
                            unmaterialized_runs)
    on = session is not None and session.conf.get(C.STAGE_RUN_PLANES)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    checks = None  # resolved lazily, only if a plane candidate shows up
    out, any_planes = [], False
    for b in leaves:
        vecs = None
        for i, v in enumerate(b.vectors):
            if not isinstance(v, RunColumnVector):
                continue
            if vecs is None:
                vecs = list(b.vectors)
            rv = unmaterialized_runs(v)
            if on and rv is not None and rv.valid is None \
                    and rv.capacity == b.capacity:
                plane_cap = pad_capacity(len(rv.run_values))
                if plane_cap * 2 <= b.capacity:
                    if checks is None:
                        from ..analysis import runtime_checks_enabled
                        checks = runtime_checks_enabled(session)
                    if checks:
                        from ..analysis.runtime import verify_run_plane
                        verify_run_plane(rv, b.capacity)
                    vecs[i] = PlaneColumnVector.from_runs(rv, plane_cap)
                    bump_plane_rows(b.capacity)
                    any_planes = True
                    continue
                bump_plane_overflow()
            vecs[i] = v.dense_on(dev)
        out.append(b if vecs is None
                   else ColumnBatch(b.names, vecs, b.row_valid, b.capacity,
                                    b.source))
    if any_planes:
        bump_plane_stage()
    return out


# ---------------------------------------------------------------------------
# per-operator dispatch baseline (fusion off)
# ---------------------------------------------------------------------------

class _Fixed:
    """Leaf stand-in holding an already-computed child output so one
    operator can run in isolation."""

    children: Tuple = ()
    op_id: int = 0

    def __init__(self, batch, schema):
        self._batch = batch
        self._schema = schema

    def schema(self):
        return self._schema

    def key(self) -> str:
        return "Fixed"

    def run(self, ctx):
        return self._batch


def run_per_op(physical, leaves, device
               ) -> Tuple[Any, int, int, List[int], List[int], List[str]]:
    """Execute a physical tree as ONE EAGER STEP PER OPERATOR, each
    step's flags read back before the next — the dispatch structure
    without whole-stage capture, kept as the measured baseline for the
    graph lane (``spark.tpu.stage.fusion=false``).

    Returns ``(compacted device batch, n_rows, dispatch count, int
    overflow flags, flag caps, flag kinds)``.  Per-op execution drops the
    device-side metric counters (each op runs in its own context), which
    is why this is a baseline/debug lane, not a production mode."""
    import copy

    from ..kernels import compact
    from . import physical as P

    dev = [b.to_device(device) for b in leaves]
    n_dispatch = 0
    int_flags: List[int] = []
    flag_caps: List[int] = []
    flag_kinds: List[str] = []

    def rec(node):
        nonlocal n_dispatch
        kids = [rec(c) for c in node.children]
        one = copy.copy(node)
        one.children = tuple(
            _Fixed(k, c.schema()) for k, c in zip(kids, node.children))
        ctx = P.ExecContext(device, dev)
        out = one.run(ctx)
        n_dispatch += 1
        if ctx.flags:
            int_flags.extend(_read_back(ctx.flags))
        flag_caps.extend(ctx.flag_caps)
        flag_kinds.extend(ctx.flag_kinds)
        return out

    out = compact(rec(physical))
    n_dispatch += 1
    return out, _read_back([out.num_rows()])[0], n_dispatch, int_flags, \
        flag_caps, flag_kinds
