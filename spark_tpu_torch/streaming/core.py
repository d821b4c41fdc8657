"""Structured streaming: the micro-batch engine with its WAL and state.

The design is the reference's structured streaming
(``execution/streaming/StreamExecution.scala``): a trigger thread drives
``constructNextBatch`` (poll the sources for offsets, durably log them
to the offset WAL BEFORE computing) → ``runBatch`` (the sources' new data
replaces the streaming relation, the plan runs as a normal query,
stateful operators merge with their versioned state) → the commit log
marks the batch done.  Exactly once = offset WAL + idempotent sink +
versioned state; recovery replays the last uncommitted batch from its
logged offsets.

Where the work runs: every micro-batch is padded to a power-of-two
capacity on the host, copied to the session's device in one step, and
the plan below the stateful operator runs there through the planner and
the stage cache (a trigger of the same shape replays the captured
stage).  The state of an aggregation (partial aggregate buffers per
group) and of a deduplication (the keys seen) rests on the same device
between triggers, and each trigger merges into it there with the sort-
based grouped aggregate and a sort-based key match.  The stream-stream
join keeps its two row buffers there too and runs its probes through the
planner.  After every merge and eviction a state batch or buffer is cut
to the power-of-two capacity of its live rows: the JAX package keeps the
capacity of every batch the state was ever merged with, so its state
grows with each trigger however few rows live.  The host holds the
offsets, the commit protocol, the flatMapGroupsWithState user function
and the snapshots written at each commit.  The host ledger's accounting
of the state (owner ``stream:<id>:state``, ``memory.batch_nbytes``
bytes, spill to a wire file under the checkpoint) is the JAX package's.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import threading
import time
import uuid
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..aggregates import MERGE_BY_KIND, AggregateFunction, First, Last
from ..columnar import (ColumnBatch, ColumnVector, pad_capacity,
                        pad_to_capacity, union_all)
from ..expressions import AnalysisException, Col, EvalContext
from ..kernels import (_segment_starts, compact, multi_key_argsort,
                       take_batch)
from ..sql import logical as L

_log = logging.getLogger("spark_tpu_torch.streaming")

__all__ = [
    "StreamingRelation", "Source", "MemoryStream", "FileStreamSource",
    "RateStreamSource", "SocketSource", "KafkaSourceUnavailable",
    "MemorySink", "ConsoleSink", "FileSink", "ForeachBatchSink",
    "StreamExecution", "StreamingQuery", "MetadataLog",
    "CheckpointCorruption", "AggregationState", "DedupState",
]


class CheckpointCorruption(RuntimeError):
    """Unrecoverable checkpoint damage: a COMMITTED batch's durable state
    snapshot disagrees with the fingerprint its commit entry recorded.
    A torn or truncated LOG entry is not this: it fails its checksum and
    reads as uncommitted, so the batch replays."""

    def __init__(self, batch_id: int, detail: str):
        self.batch_id = batch_id
        super().__init__(
            f"checkpoint corrupt at batch {batch_id}: {detail}")


# ---------------------------------------------------------------------------
# streaming relation + sources
# ---------------------------------------------------------------------------

class StreamingRelation(L.LogicalPlan):
    """Leaf marking a streaming source in a logical plan."""

    def __init__(self, source: "Source"):
        self.source = source

    def schema(self) -> T.StructType:
        return self.source.schema()

    def __repr__(self):
        return f"StreamingRelation[{type(self.source).__name__}]"


class Source:
    """``Source.scala``: an offset-based, replayable input."""

    def schema(self) -> T.StructType:
        raise NotImplementedError

    def get_offset(self) -> Optional[int]:
        """Latest available offset, or None if no data yet."""
        raise NotImplementedError

    def get_batch(self, start: Optional[int], end: int) -> ColumnBatch:
        """Rows in (start, end] as a host batch; replayable."""
        raise NotImplementedError

    # Sources whose offset → data mapping lives in process memory (the
    # file source's seen-file list) persist it in the offset WAL, or a
    # logged-but-uncommitted batch could not be replayed after a restart.
    def offset_metadata(self, start: Optional[int], end: int) -> Optional[dict]:
        """JSON payload stored in the offset WAL entry for this batch."""
        return None

    def restore_offset_metadata(self, start: Optional[int], end: int,
                                meta: dict) -> None:
        """Rebuild in-memory offset state from a WAL entry on recovery."""

    def commit(self, end: int) -> None:
        """Offsets ≤ end are durably committed; the source may release
        what it buffered below them."""


class MemoryStream(Source):
    """``streaming/memory.scala`` MemoryStream: rows added by the test or
    the caller, one offset per row."""

    def __init__(self, schema_or_names, session=None):
        if isinstance(schema_or_names, T.StructType):
            self._schema = schema_or_names
        else:
            raise AnalysisException("MemoryStream needs a StructType schema")
        self._rows: List[tuple] = []
        self._lock = threading.Lock()
        self._session = session

    def schema(self) -> T.StructType:
        return self._schema

    def add_data(self, rows: List[tuple]) -> None:
        with self._lock:
            self._rows.extend(rows)

    addData = add_data

    def get_offset(self) -> Optional[int]:
        with self._lock:
            return len(self._rows) if self._rows else None

    def get_batch(self, start, end) -> ColumnBatch:
        lo = start or 0
        with self._lock:
            rows = self._rows[lo:end]
        if not rows:
            return ColumnBatch.empty(self._schema)
        cols = {f.name: [r[i] for r in rows]
                for i, f in enumerate(self._schema.fields)}
        return ColumnBatch.from_arrays(cols, schema=self._schema)

    def to_df(self, session):
        from ..sql.dataframe import DataFrame
        return DataFrame(session, StreamingRelation(self))

    toDF = to_df


class FileStreamSource(Source):
    """New files in a directory (``FileStreamSource.scala``): offset =
    number of files seen, ordered by (mtime, name).  Files decode through
    the port's readers (``io._decode_files``), one host batch per
    trigger, never kept in the relation cache."""

    def __init__(self, fmt: str, path: str, schema: Optional[T.StructType],
                 options: Dict[str, str]):
        self.fmt = fmt
        self.path = path
        self.options = options
        self._seen: List[str] = []
        self._schema = schema
        # bounded trigger (maxFilesPerTrigger): a backlog after a restart
        # drains as the SAME batch sequence a live run would have made
        self.max_per_trigger = int(options.get("maxfilespertrigger", 0)
                                   or 0)

    def _list(self) -> List[str]:
        if not os.path.isdir(self.path):
            return []
        files = [os.path.join(self.path, f) for f in os.listdir(self.path)
                 if not f.startswith(("_", "."))]
        return sorted(files, key=lambda f: (os.path.getmtime(f), f))

    def _decode(self, files: List[str]) -> ColumnBatch:
        from ..io import SCAN_STATS, _decode_files, _resolve_paths
        t0 = time.perf_counter()
        resolved = _resolve_paths(files)
        batch = _decode_files(self.fmt, resolved, files, self.options)
        SCAN_STATS["files"] += len(resolved)
        SCAN_STATS["decode_ms"] += (time.perf_counter() - t0) * 1e3
        return batch

    def schema(self) -> T.StructType:
        if self._schema is None:
            files = self._list()
            if not files:
                raise AnalysisException(
                    f"cannot infer streaming schema: no files in {self.path}; "
                    "provide .schema(...)")
            self._schema = self._decode([files[0]]).schema
        return self._schema

    def get_offset(self) -> Optional[int]:
        files = self._list()
        for f in files:
            if f not in self._seen:
                self._seen.append(f)
        return len(self._seen) or None

    def get_batch(self, start, end) -> ColumnBatch:
        lo = start or 0
        files = self._seen[lo:end]
        if not files:
            return ColumnBatch.empty(self.schema())
        return self._decode(files)

    def offset_metadata(self, start, end) -> dict:
        lo = start or 0
        return {"files": self._seen[lo:end]}

    def restore_offset_metadata(self, start, end, meta) -> None:
        # the WAL's file list is authoritative: offsets replay to the exact
        # files originally assigned, not to a re-listing's order
        lo = start or 0
        if len(self._seen) < end:
            self._seen.extend([""] * (end - len(self._seen)))
        self._seen[lo:end] = meta["files"]


class RateStreamSource(Source):
    """``RateStreamSource``: (timestamp, value) rows at rowsPerSecond
    from ``t0`` (the construction time; tests pin it)."""

    def __init__(self, rows_per_second: int = 1):
        self.rps = rows_per_second
        self.t0 = time.time()

    def schema(self) -> T.StructType:
        return T.StructType([T.StructField("timestamp", T.timestamp, False),
                             T.StructField("value", T.int64, False)])

    def get_offset(self) -> Optional[int]:
        n = int((time.time() - self.t0) * self.rps)
        return n or None

    def get_batch(self, start, end) -> ColumnBatch:
        lo = start or 0
        vals = np.arange(lo, end, dtype=np.int64)
        ts = (np.float64(self.t0) + vals / self.rps) * 1e6
        return ColumnBatch.from_arrays({
            "timestamp": ts.astype(np.int64),
            "value": vals,
        }, schema=self.schema())


# ---------------------------------------------------------------------------
# sinks (each receives a compacted HOST batch)
# ---------------------------------------------------------------------------

class MemorySink:
    """The batches a query emitted, kept as host batches and served as a
    temp view of their union (complete mode keeps the last one)."""

    def __init__(self, name: str, session):
        self.name = name
        self.session = session
        self._batches: List[ColumnBatch] = []

    def add_batch(self, batch_id: int, batch: ColumnBatch, mode: str) -> None:
        if mode == "complete":
            self._batches = [batch]
        elif int(batch.num_rows()) or not self._batches:
            self._batches.append(batch)
        if self.name:
            from ..sql.dataframe import DataFrame
            rel = compact(union_all(self._batches)) \
                if len(self._batches) > 1 else self._batches[0]
            DataFrame(self.session, L.LocalRelation(rel)) \
                .createOrReplaceTempView(self.name)

    def rows(self) -> List[tuple]:
        return [r for b in self._batches for r in b.to_pylist()]


class ConsoleSink:
    def add_batch(self, batch_id: int, batch: ColumnBatch, mode: str) -> None:
        print(f"-------------------------------------------\n"
              f"Batch: {batch_id}\n"
              f"-------------------------------------------")
        for r in batch.to_pylist():
            print(r)


class FileSink:
    """Idempotent per-batch file sink: batch id → ONE deterministic part
    file plus a commit marker, both placed by atomic rename.  A replayed
    batch either returns early on the marker or overwrites the same part
    file with the same bytes: the sink never duplicates and never tears
    (the sink half of the exactly-once protocol)."""

    def __init__(self, fmt: str, path: str, options: Dict[str, str]):
        self.fmt = fmt
        self.path = path
        self.options = options

    def _part_path(self, batch_id: int) -> str:
        ext = {"parquet": ".parquet", "csv": ".csv",
               "json": ".json", "text": ".txt"}[self.fmt]
        return os.path.join(self.path, f"part-{batch_id:05d}{ext}")

    def add_batch(self, batch_id: int, batch: ColumnBatch, mode: str) -> None:
        marker = os.path.join(self.path, f"_batch_{batch_id}")
        if os.path.exists(marker):
            return
        from ..io import DataFrameWriter, batch_to_arrow
        w = DataFrameWriter(None).format(self.fmt).mode("append")
        for k, v in self.options.items():
            w.option(k, v)
        os.makedirs(self.path, exist_ok=True)
        out = self._part_path(batch_id)
        tmp = f"{out}.{os.getpid()}.tmp"
        w._write_table(batch_to_arrow(batch), self.path,
                       os.path.splitext(out)[1], out=tmp)
        os.replace(tmp, out)
        mtmp = f"{marker}.{os.getpid()}.tmp"
        with open(mtmp, "w") as f:
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, marker)
        _fsync_dir(self.path)


class ForeachBatchSink:
    def __init__(self, fn, session):
        self.fn = fn
        self.session = session

    def add_batch(self, batch_id: int, batch: ColumnBatch, mode: str) -> None:
        from ..sql.dataframe import DataFrame
        self.fn(DataFrame(self.session, L.LocalRelation(batch)), batch_id)


# ---------------------------------------------------------------------------
# WAL logs (``HDFSMetadataLog`` / ``OffsetSeqLog`` / ``BatchCommitLog``)
# ---------------------------------------------------------------------------

def _fsync_dir(path: str) -> None:
    """Durably record a rename: fsync the DIRECTORY so the new entry
    survives a crash."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class MetadataLog:
    """Checksummed atomic WAL: every entry is one file ``<batch_id>``
    whose content is ``<adler32-hex> <compact-json>``, written tmp →
    flush → fsync → atomic rename → directory fsync.  A torn, truncated
    or bit-flipped entry fails its checksum and reads as ABSENT, so the
    batch replays.  Plain-JSON entries without a checksum still parse."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def add(self, batch_id: int, payload: dict) -> None:
        body = json.dumps(payload, separators=(",", ":"))
        line = f"{zlib.adler32(body.encode()) & 0xFFFFFFFF:08x} {body}"
        tmp = os.path.join(self.path, f".{batch_id}.tmp")
        with open(tmp, "w") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, str(batch_id)))
        _fsync_dir(self.path)

    def get(self, batch_id: int) -> Optional[dict]:
        p = os.path.join(self.path, str(batch_id))
        try:
            with open(p) as f:
                raw = f.read()
        except OSError:
            return None
        return self._parse(raw)

    @staticmethod
    def _parse(raw: str) -> Optional[dict]:
        raw = raw.strip()
        if not raw:
            return None
        if raw.startswith("{"):
            try:
                out = json.loads(raw)
            except ValueError:
                return None
            return out if isinstance(out, dict) else None
        crc, _, body = raw.partition(" ")
        if len(crc) != 8 or not body:
            return None
        try:
            if int(crc, 16) != (zlib.adler32(body.encode()) & 0xFFFFFFFF):
                return None
            out = json.loads(body)
        except ValueError:
            return None
        return out if isinstance(out, dict) else None

    def latest(self) -> Tuple[Optional[int], Optional[dict]]:
        ids = sorted((int(f) for f in os.listdir(self.path)
                      if f.isdigit()), reverse=True)
        # a torn tail entry is an uncommitted batch: skip back to the
        # newest entry that verifies
        for i in ids:
            payload = self.get(i)
            if payload is not None:
                return i, payload
        return None, None


# ---------------------------------------------------------------------------
# device key matching
# ---------------------------------------------------------------------------

def _group_ids(vectors: List[ColumnVector], capacity: int) -> torch.Tensor:
    """Group id of every row by its key vectors' VALUES (NULLs group
    together), on the vectors' device: one multi-key sort, segment
    starts, a cumulative sum scattered back to row order."""
    dev = vectors[0].data.device
    cols: List[torch.Tensor] = []
    for v in vectors:
        data = v.data
        if data.dtype == torch.bool:
            data = data.to(torch.int8)
        if v.valid is None:
            cols.append(data)
        else:
            cols += [v.valid.to(torch.int8),
                     torch.where(v.valid, data,
                                 torch.zeros((), dtype=data.dtype,
                                             device=dev))]
    perm = multi_key_argsort(cols, capacity)
    everyone = torch.ones(capacity, dtype=torch.bool, device=dev)
    starts = _segment_starts([c[perm] for c in cols], everyone, capacity)
    seg = torch.cumsum(starts.to(torch.int64), 0) - 1
    gid = torch.empty_like(seg)
    gid[perm] = seg
    return gid


def _joint_codes(a: ColumnBatch, b: ColumnBatch, names: List[str]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group ids of two row sets in ONE code space, compared by value:
    the key columns are concatenated (string columns onto a merged
    dictionary) and grouped together."""
    ka = ColumnBatch(names, [a.column(n) for n in names], None, a.capacity)
    kb = ColumnBatch(names, [b.column(n) for n in names], None, b.capacity)
    u = union_all([ka, kb])
    gid = _group_ids(u.vectors, u.capacity)
    return gid[:a.capacity], gid[a.capacity:]


def _member(codes: torch.Tensor, pool_codes: torch.Tensor,
            pool_live: torch.Tensor, n_codes: int) -> torch.Tensor:
    """Whether each code occurs among the LIVE entries of a pool (a
    scatter-max, no read-back)."""
    has = torch.zeros(n_codes, dtype=torch.int8, device=codes.device)
    has.scatter_reduce_(0, pool_codes, pool_live.to(torch.int8), "amax")
    return has[codes].bool()


# ---------------------------------------------------------------------------
# stateful aggregation: partial-buffer state merged on the device
# ---------------------------------------------------------------------------

def _torch_to_engine(dt: torch.dtype) -> T.DataType:
    return T.np_dtype_to_engine(T.torch_to_np_dtype(dt))


def _host_payload(batch: Optional[ColumnBatch]) -> Optional[dict]:
    """A batch as plain numpy parts (one packed device → host copy)."""
    if batch is None:
        return None
    host = batch.packed_host()
    return {
        "names": list(host.names),
        "data": [v.data.numpy() for v in host.vectors],
        "valid": [None if v.valid is None else v.valid.numpy()
                  for v in host.vectors],
        "dtypes": [v.dtype.simpleString() for v in host.vectors],
        "dicts": [v.dictionary for v in host.vectors],
        "row_valid": None if host.row_valid is None
        else host.row_valid.numpy(),
        "capacity": host.capacity,
    }


def _from_payload(payload: dict, device) -> ColumnBatch:
    return ColumnBatch.from_numpy_parts(
        payload["names"], payload["dtypes"], payload["data"],
        payload["valid"], payload["row_valid"], payload["dicts"],
        payload["capacity"], device=device)


def _fit(batch: ColumnBatch) -> ColumnBatch:
    """The live rows, in order, at the front of a batch of
    ``pad_capacity(live rows)`` (one read-back of the count).  State is
    rebuilt each trigger from itself and the new rows, and ``compact``
    keeps a batch's capacity: without this cut the state would keep the
    capacity of every batch it ever met, as the JAX package's does."""
    if batch.row_valid is None:
        return batch
    cap = pad_capacity(int(batch.row_valid.sum()))
    if cap >= batch.capacity:
        return compact(batch)
    perm = torch.sort((~batch.row_valid).to(torch.int8), stable=True).indices
    return take_batch(batch, perm[:cap])


def _keep_rows(batch: ColumnBatch, keep: torch.Tensor) -> ColumnBatch:
    return _fit(ColumnBatch(batch.names, batch.vectors, keep,
                            batch.capacity))


class AggregationState:
    """State = one device batch of (key columns + raw partial buffer
    columns), merged per trigger with each buffer's own reduction (the
    two-phase aggregation contract, so avg/count/sum/min/max merge
    exactly)."""

    def __init__(self, keys: List[Any], slots: List[Tuple[AggregateFunction, str]],
                 child_schema: T.StructType, device="cpu"):
        self.keys = keys
        self.slots = slots
        self.child_schema = child_schema
        self.device = torch.device(device)
        self.state: Optional[ColumnBatch] = None
        self.evicted_rows = 0           # watermark-finalized groups dropped
        self._buf_names: List[str] = []
        for f, name in slots:
            for j in range(f.num_buffers()):
                self._buf_names.append(f"__buf_{name}_{j}")

    def _partial_rows(self, batch: ColumnBatch) -> ColumnBatch:
        """Key columns + per-row buffer contributions for one input batch."""
        ctx = EvalContext(batch)
        live = batch.row_valid_or_true()
        names: List[str] = []
        vectors: List[ColumnVector] = []
        for k in self.keys:
            v = ctx.broadcast(k.eval(ctx))
            names.append(k.name)
            vectors.append(ColumnVector(v.data, k.data_type(batch.schema),
                                        v.valid, v.dictionary))
        i = 0
        for f, _name in self.slots:
            for spec in f.make_buffers(ctx, live):
                names.append(self._buf_names[i])
                vectors.append(ColumnVector(spec.data,
                                            _torch_to_engine(spec.dtype),
                                            None, None))
                i += 1
        return ColumnBatch(names, vectors, live, batch.capacity)

    def _merge_aggs(self):
        """Aggregate slots that merge buffer columns by their kind."""
        out = []
        i = 0
        for (f, _name) in self.slots:
            kinds = self._buffer_kinds(f)
            for j in range(f.num_buffers()):
                bname = self._buf_names[i]
                out.append((MERGE_BY_KIND[kinds[j]](Col(bname)), bname))
                i += 1
        return out

    def _buffer_kinds(self, f: AggregateFunction) -> List[str]:
        probe = ColumnBatch.empty(self.child_schema)
        ctx = EvalContext(probe)
        live = torch.zeros(probe.capacity, dtype=torch.bool)
        return [s.kind for s in f.make_buffers(ctx, live)]

    def merge(self, new_batch: ColumnBatch) -> ColumnBatch:
        """Fold one batch's partial buffers into the state (no finish);
        returns THIS batch's partial rows (changed-group tracking)."""
        from ..kernels import _sorted_grouped_aggregate
        partial = self._partial_rows(new_batch)
        allp = partial if self.state is None \
            else union_all([self.state, partial])
        key_cols = [Col(k.name) for k in self.keys]
        merged = _sorted_grouped_aggregate(allp, key_cols,
                                           self._merge_aggs())
        self.state = _fit(merged)
        return partial

    def update(self, new_batch: ColumnBatch,
               changed_only: bool = False) -> ColumnBatch:
        """Merge one micro-batch; returns the finished output.
        ``changed_only`` (update output mode) keeps the groups THIS batch
        touched (``StateStoreSaveExec``'s update path)."""
        partial = self.merge(new_batch)
        finished = self.finished()
        if changed_only:
            keep = self._changed_mask(finished, partial)
            finished = _keep_rows(finished,
                                  finished.row_valid_or_true() & keep)
        return finished

    def finished(self) -> ColumnBatch:
        """Output columns (keys + finished aggregates) from the state."""
        merged = self.state
        if merged is None:
            raise AnalysisException("no batches merged yet")
        names: List[str] = [k.name for k in self.keys]
        vectors: List[ColumnVector] = [
            merged.vectors[merged.names.index(k.name)] for k in self.keys]
        i = 0
        for f, out_name in self.slots:
            bufs = []
            for _j in range(f.num_buffers()):
                bufs.append(merged.vectors[
                    merged.names.index(self._buf_names[i])].data)
                i += 1
            if isinstance(f, (First, Last)):
                raise AnalysisException(
                    "first/last are not yet supported in streaming aggregation")
            out = f.finish(bufs)
            dt = f.data_type(self.child_schema)
            names.append(out_name)
            vectors.append(ColumnVector(out.data.to(dt.torch_dtype), dt,
                                        out.valid, out.dictionary))
        return ColumnBatch(names, vectors, merged.row_valid, merged.capacity)

    def _changed_mask(self, finished: ColumnBatch,
                      batch_partial: ColumnBatch) -> torch.Tensor:
        """Which finished rows' keys occur among the live rows of this
        batch's partial: one joint grouping and a scatter, on the device."""
        nk = len(self.keys)
        live_b = batch_partial.row_valid_or_true()
        if nk == 0:
            return live_b.any().expand(finished.capacity)
        names = [k.name for k in self.keys]
        cf, cb = _joint_codes(finished, batch_partial, names)
        return _member(cf, cb, live_b,
                       finished.capacity + batch_partial.capacity)

    def evict_finalized(self, key_idx: int, dur_us: int, wm_us: int,
                        emit: bool = True) -> Optional[ColumnBatch]:
        """Groups whose event-time key is final under the watermark
        (windows with start + duration <= wm, raw event keys < wm) leave
        the state; their finished rows come back when ``emit``."""
        if self.state is None:
            return None
        live = self.state.row_valid_or_true()
        kv, kvalid = _numeric_event_col(self.state.vectors[key_idx],
                                        self.state.capacity)
        if dur_us:
            final = live & kvalid & ((kv + dur_us) <= wm_us)
        else:
            final = live & kvalid & (kv < wm_us)
        n_final = int(final.sum())
        if not n_final:
            return None
        self.evicted_rows += n_final
        out = None
        if emit:
            finished = self.finished()
            out = _keep_rows(finished, finished.row_valid_or_true() & final)
        self.state = _keep_rows(self.state, live & ~final)
        return out

    def snapshot(self, path: str, batch_id: int) -> int:
        """Atomically write the state snapshot for ``batch_id`` and return
        its adler32 fingerprint, which rides the commit entry: recovery
        verifies the snapshot it restores is the one the commit named."""
        os.makedirs(path, exist_ok=True)
        buf = pickle.dumps(_host_payload(self.state),
                           protocol=pickle.HIGHEST_PROTOCOL)
        crc = zlib.adler32(buf) & 0xFFFFFFFF
        from .state import snapshot_file
        dest = snapshot_file(path, batch_id)
        tmp = f"{dest}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(buf)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dest)
        _fsync_dir(path)
        return crc

    def restore(self, path: str, batch_id: int,
                expected_crc: Optional[int] = None) -> bool:
        from .state import snapshot_file
        p = snapshot_file(path, batch_id)
        if not os.path.exists(p):
            return False
        with open(p, "rb") as f:
            buf = f.read()
        if expected_crc is not None \
                and (zlib.adler32(buf) & 0xFFFFFFFF) != expected_crc:
            raise CheckpointCorruption(
                batch_id, f"state snapshot {p} fails its committed "
                f"fingerprint (expected {expected_crc:08x})")
        try:
            payload = pickle.loads(buf)
        except Exception as e:
            if expected_crc is not None:
                raise CheckpointCorruption(
                    batch_id, f"state snapshot {p} unreadable: {e}")
            return False
        self.state = None if payload is None \
            else _from_payload(payload, self.device)
        return True


def _numeric_event_col(vec: ColumnVector, cap: int):
    """(int64 values, valid) of an EVENT-TIME column for threshold math;
    a dictionary-coded column would compare codes, not values: refused."""
    if vec.dictionary is not None:
        raise AnalysisException(
            "event-time watermark columns must be timestamps/integers, "
            "not strings")
    data = vec.data.to(torch.int64)
    valid = vec.valid_or_true()
    return data, valid


class DedupState:
    """Streaming dropDuplicates (``StreamingDeduplicateExec``): the state
    is the keys seen so far, on the device; each batch emits only rows
    whose key is new.  With a watermark on one of the columns, old keys
    evict."""

    def __init__(self, key_names: List[str], schema: T.StructType,
                 wm_col: Optional[str] = None, device="cpu"):
        self.key_names = list(key_names)
        self.schema = schema
        # the state carries ONLY what it reads: the key columns plus the
        # watermark column for eviction
        keep = list(key_names)
        if wm_col and wm_col not in keep and wm_col in schema.names:
            keep.append(wm_col)
        self._state_cols = keep
        self.state: Optional[ColumnBatch] = None
        self.evicted_rows = 0
        self._io = AggregationState([], [], schema, device)

    def update(self, batch: ColumnBatch) -> ColumnBatch:
        """New-key rows of ``batch`` (the first occurrence within the
        batch, none seen before); extends the state with them."""
        batch = compact(batch)
        live = batch.row_valid_or_true()
        if not bool(live.any()):
            return batch
        cap = batch.capacity
        dev = live.device
        if self.state is not None:
            sc, bc = _joint_codes(self.state, batch, self.key_names)
            n_codes = self.state.capacity + cap
            seen = _member(bc, sc, self.state.row_valid_or_true(), n_codes)
        else:
            bc = _group_ids([batch.column(n) for n in self.key_names], cap)
            n_codes = cap
            seen = torch.zeros(cap, dtype=torch.bool, device=dev)
        # intra-batch: keep the FIRST live occurrence of each key
        pos = torch.arange(cap, dtype=torch.int64, device=dev)
        big = torch.full((), cap, dtype=torch.int64, device=dev)
        first = torch.full((n_codes,), cap, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, bc, torch.where(live, pos, big), "amin")
        emit = live & (first[bc] == pos) & ~seen
        out = _keep_rows(batch, emit)
        new_keys = ColumnBatch(self._state_cols,
                               [out.column(n) for n in self._state_cols],
                               out.row_valid, out.capacity)
        self.state = new_keys if self.state is None \
            else _fit(union_all([self.state, new_keys]))
        return out

    def evict(self, col_name: str, wm_us: int) -> int:
        if self.state is None or col_name not in self.state.names:
            return 0
        kv, kvalid = _numeric_event_col(self.state.column(col_name),
                                        self.state.capacity)
        live = self.state.row_valid_or_true()
        drop = live & kvalid & (kv < wm_us)
        n = int(drop.sum())
        self.evicted_rows += n
        self.state = _keep_rows(self.state, live & ~drop)
        return n

    def snapshot(self, path: str, batch_id: int) -> int:
        self._io.state = self.state
        return self._io.snapshot(path, batch_id)

    def restore(self, path: str, batch_id: int,
                expected_crc: Optional[int] = None) -> bool:
        ok = self._io.restore(path, batch_id, expected_crc)
        if ok:
            self.state = self._io.state
        return ok


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _find_nodes(plan: L.LogicalPlan, cls) -> list:
    out = []

    def walk(n):
        if isinstance(n, cls):
            out.append(n)
        for c in n.children:
            walk(c)
    walk(plan)
    return out


def _find_streaming(plan: L.LogicalPlan) -> List[StreamingRelation]:
    return _find_nodes(plan, StreamingRelation)


class _Timer:
    """Device time of a span on a ``cuda`` device (an event pair, read
    at the end of the trigger); host time elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.t0 = time.perf_counter()
            self.ms = 0.0

    def stop(self) -> "_Timer":
        if self.cuda:
            self.b.record()
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3
        return self

    def elapsed(self) -> float:
        if self.cuda:
            self.b.synchronize()
            return float(self.a.elapsed_time(self.b))
        return self.ms


#: the least capacity of the relation above a stateful operator: emitted
#: row counts that vary under it share one captured stage
_ABOVE_MIN_CAPACITY = 1 << 10


class StreamExecution:
    """One micro-batch driver (``StreamExecution.scala`` runBatches)."""

    def __init__(self, session, plan: L.LogicalPlan, sink, output_mode: str,
                 checkpoint: Optional[str], trigger_interval: float,
                 query_name: Optional[str]):
        self.session = session
        self.device = session.device
        self.plan = plan
        self.sink = sink
        # sinks write through the owning session, never another tenant's
        try:
            self.sink._session = session
        except Exception:
            pass
        self.mode = output_mode
        self.checkpoint = checkpoint
        self.interval = trigger_interval
        self.name = query_name
        self.id = str(uuid.uuid4())

        sources = _find_streaming(plan)
        self._ssjoin_node = None
        if len(sources) == 2:
            # stream-stream JOIN: both join subtrees read a stream
            # (``StreamingSymmetricHashJoinExec``)
            self._ssjoin_node = self._find_ssjoin(plan)
            if output_mode != "append":
                raise AnalysisException(
                    "stream-stream joins support append output mode only")
        elif len(sources) != 1:
            raise AnalysisException(
                f"at most two streaming sources supported, "
                f"got {len(sources)}")
        self.sources = [s.source for s in sources]
        self.source = self.sources[0]
        self._multi = len(self.sources) > 1
        self._ss_buf = [None, None]          # per-side row buffers (device)
        self._ss_matched: set = set()        # preserved-side matched rids
        self._ss_rid_next = 0                # monotonic preserved-row ids

        self.offset_log = MetadataLog(os.path.join(checkpoint, "offsets")) \
            if checkpoint else _MemLog()
        self.commit_log = MetadataLog(os.path.join(checkpoint, "commits")) \
            if checkpoint else _MemLog()
        self.state_dir = os.path.join(checkpoint, "state") if checkpoint \
            else None

        self.batch_id = 0
        self.committed_offset = [None] * len(sources) \
            if len(sources) > 1 else None
        # event-time watermark (EventTimeWatermarkExec accumulation)
        wms = _find_nodes(plan, L.EventTimeWatermark)
        if len(wms) > 1:
            raise AnalysisException("multiple watermarks are not supported")
        self._wm_col: Optional[str] = wms[0].col_name if wms else None
        self._wm_delay: int = wms[0].delay_us if wms else 0
        self._wm_src = 0
        if self._wm_col is not None:
            owners = [i for i, s in enumerate(self.sources)
                      if self._wm_col in s.schema().names]
            if not owners:
                raise AnalysisException(
                    f"watermark column {self._wm_col!r} must come from a "
                    "streaming source schema")
            self._wm_src = owners[0]
        self.watermark_us: Optional[int] = None
        self._max_event_us: Optional[int] = None
        self._dedup_state: Optional[DedupState] = None
        self._dedup_node = None
        self._event_key = None
        self._agg_state = self._build_agg_state()
        self._stopped = threading.Event()
        # the trigger thread and processAllAvailable() callers never run
        # a micro-batch concurrently: state merges are not idempotent
        self._batch_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.exception: Optional[BaseException] = None
        self.progress: List[dict] = []
        # -- serving-tier tenancy: the state is a host-ledger tenant, re-
        # accounted per batch under stream:<id>:state; over budget it
        # parks as a wire-format spill file until the next batch
        self._ledger = getattr(session, "_host_ledger", None)
        self._ledger_owner = f"stream:{self.id[:8]}:state"
        self._spilled: set = set()
        self.metrics: Dict[str, int] = {
            "batches_committed": 0, "replayed_batches": 0,
            "stage_rebuilds_last": 0, "state_bytes": 0, "state_rows": 0,
            "spill_bytes": 0, "spill_events": 0, "evicted_rows": 0,
            "watermark_us": 0, "admission_deferred": 0,
        }
        #: the last trigger's time split (ms) and its copy to the device
        self.timings: Dict[str, float] = {}
        self._h2d_timers: List["_Timer"] = []
        self._above_cap = 0            # see _finish_above
        # fault hook between the state commit and the sink write
        # (parallel.faults die_after_state_commit arms it)
        self._post_state_commit_hook = None
        # serving admission: a callback returning False defers the batch
        self._batch_admit = None
        # -- block-service checkpoint ownership (blockserver.py): the
        # checkpoint registers under a key derived from its PATH, stable
        # across restarts; every durable commit renews the lease and only
        # stop() releases it
        self._blockclient = None
        self._ck_owner: Optional[str] = None
        _bc = getattr(getattr(session, "_crossproc_svc", None),
                      "blockclient", None)
        if _bc is not None and checkpoint:
            self._blockclient = _bc
            digest = hashlib.sha256(
                os.path.abspath(checkpoint).encode()).hexdigest()[:16]
            self._ck_owner = f"stream-{digest}"
            _bc.register_state(self._ck_owner, checkpoint,
                               owner=self._ck_owner)
        self._recover()
        # register only AFTER recovery: a CheckpointCorruption abort must
        # not leave a half-built execution on the session
        regs = getattr(session, "_stream_execs", None)
        if regs is None:
            regs = []
            session._stream_execs = regs
        regs.append(self)

    # -- stateful plan surgery (UnsupportedOperationChecker analog) -------
    def _check_stateless_path(self, anchor, what: str,
                              allowed=(L.Project, L.Filter)) -> None:
        """Root → anchor must cross only stateless single-child operators
        the finish step can re-apply per batch."""
        node = self.plan
        while node is not anchor:
            if not isinstance(node, allowed) or len(node.children) != 1:
                raise AnalysisException(
                    f"{what} under {type(node).__name__} cannot run "
                    "incrementally")
            node = node.children[0]

    def _find_ssjoin(self, plan: L.LogicalPlan) -> L.Join:
        joins = [j for j in _find_nodes(plan, L.Join)
                 if _find_streaming(j.left) and _find_streaming(j.right)]
        if len(joins) != 1:
            raise AnalysisException(
                "exactly one stream-stream join is supported per query")
        j = joins[0]
        if j.how not in ("inner", "left", "right"):
            raise AnalysisException(
                f"stream-stream {j.how} joins are not supported; "
                "inner/left/right only (full outer needs watermark "
                "finalization on BOTH sides, and this engine carries one "
                "watermark per query)")
        if len(_find_streaming(j.left)) != 1 \
                or len(_find_streaming(j.right)) != 1:
            raise AnalysisException(
                "each stream-stream join side must read exactly one "
                "stream")
        self._check_stateless_path(j, "stream-stream join")
        return j

    # -- stream-stream join state ----------------------------------------
    def _ssjoin_snapshot(self, batch_id: int) -> None:
        if not self.state_dir:
            return
        d = os.path.join(self.state_dir, "ssjoin")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"state-{batch_id}.pkl")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"bufs": [_host_payload(b) for b in self._ss_buf],
                         "matched": self._ss_matched,
                         "rid_next": self._ss_rid_next}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        stale = os.path.join(d, f"state-{batch_id - 2}.pkl")
        try:
            os.remove(stale)
        except OSError:
            pass

    def _ssjoin_restore(self, batch_id: int) -> None:
        if not self.state_dir:
            return
        path = os.path.join(self.state_dir, "ssjoin",
                            f"state-{batch_id}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                payload = pickle.load(f)
            self._ss_buf = [None if b is None
                            else _from_payload(b, self.device)
                            for b in payload["bufs"]]
            self._ss_matched = payload["matched"]
            self._ss_rid_next = payload["rid_next"]

    def _validate_outer_ssjoin(self) -> None:
        """LEFT/RIGHT outer stream-stream joins finalize unmatched rows
        only when the watermark evicts them: the PRESERVED side carries
        the query's watermark, its event-time column reaches the join,
        and the condition bounds future matches."""
        j = self._ssjoin_node
        if j is None or j.how == "inner":
            return
        pres_plan = j.left if j.how == "left" else j.right
        pres_rel = _find_streaming(pres_plan)[0]
        pres_src = self.sources.index(pres_rel.source)
        if self._wm_col is None or self._wm_src != pres_src:
            raise AnalysisException(
                f"stream-stream {j.how} outer joins require withWatermark "
                "on the PRESERVED side: unmatched rows can only "
                "null-extend once the watermark proves no future match")
        if self._wm_col not in pres_plan.schema().names:
            raise AnalysisException(
                f"the watermark column {self._wm_col!r} must survive to "
                f"the {j.how} outer join input (it drives unmatched-row "
                "finalization)")
        from ..expressions import EQ, GE, GT, LE, LT
        from ..sql.optimizer import split_conjuncts
        other_plan = j.right if j.how == "left" else j.left
        pres_cols = set(pres_plan.schema().names)
        other_cols = set(other_plan.schema().names)
        bound = False
        for c in (split_conjuncts(j.on) if j.on is not None else []):
            if not isinstance(c, (EQ, GE, GT, LE, LT)):
                continue
            l, r = c.children
            for mine, theirs in ((l.references(), r.references()),
                                 (r.references(), l.references())):
                if mine and theirs and mine <= pres_cols \
                        and self._wm_col in mine \
                        and theirs <= other_cols:
                    bound = True
        if not bound:
            raise AnalysisException(
                f"stream-stream {j.how} outer join condition cannot "
                "bound future matches: add a time-range constraint "
                "between both sides' event times involving the watermark "
                f"column {self._wm_col!r} (e.g. ts <= ts2), or an "
                "event-time equality — without it, a null-extended row "
                "could still match a future arrival")

    def _build_agg_state(self) -> Optional[AggregationState]:
        self._validate_outer_ssjoin()
        self._fmgws_node = None
        self._fmgws_provider = None
        self._fmgws_states: dict = {}
        self._agg_node = None
        if self._ssjoin_node is not None:
            stateful = (
                [a for a in _find_nodes(self.plan, L.Aggregate)
                 if _find_streaming(a)]
                + [d for d in _find_nodes(self.plan, L.Distinct)
                   if _find_streaming(d)]
                + [f for f in _find_nodes(self.plan,
                                          L.FlatMapGroupsWithState)
                   if _find_streaming(f)])
            if stateful:
                raise AnalysisException(
                    "aggregation/deduplication over a stream-stream join "
                    "is not supported yet")
            return None
        # arbitrary stateful processing (FlatMapGroupsWithStateExec)
        fmgws = [n for n in _find_nodes(self.plan, L.FlatMapGroupsWithState)
                 if _find_streaming(n)]
        if fmgws:
            if len(fmgws) > 1:
                raise AnalysisException(
                    "multiple flatMapGroupsWithState operators are not "
                    "supported on one stream")
            node = fmgws[0]
            others = ([a for a in _find_nodes(self.plan, L.Aggregate)
                       if _find_streaming(a)]
                      + [d for d in _find_nodes(self.plan, L.Distinct)
                         if _find_streaming(d)])
            if others:
                raise AnalysisException(
                    "flatMapGroupsWithState cannot be combined with "
                    "streaming aggregation/deduplication in one query")
            self._check_stateless_path(node, "flatMapGroupsWithState")
            if node.timeout_conf == "EventTimeTimeout" \
                    and self._wm_col is None:
                raise AnalysisException(
                    "EventTimeTimeout requires withWatermark on the stream")
            if self.mode == "complete":
                raise AnalysisException(
                    "complete output mode is not supported for "
                    "flatMapGroupsWithState (its output is incremental "
                    "operator output, not a result table)")
            self._fmgws_node = node
            from .state import StateStoreProvider
            self._fmgws_provider = (
                StateStoreProvider(
                    self.checkpoint, operator_id=0,
                    conf=self.session.conf_obj,
                    ledger_supplier=lambda: getattr(
                        self.session, "_host_ledger", None),
                    ledger_owner=f"stream:{self.id[:8]}:versions",
                    on_commit=lambda _v: self._renew_ownership())
                if self.checkpoint else None)
            return None
        # streaming dropDuplicates: a Distinct (all columns) or an
        # all-First Aggregate (dropDuplicates(subset)) over the stream
        dedups = [d for d in _find_nodes(self.plan, L.Distinct)
                  if _find_streaming(d)]
        first_aggs = [
            a for a in _find_nodes(self.plan, L.Aggregate)
            if _find_streaming(a) and a.aggs
            and all(isinstance(f, First) for f, _n in a.aggs)
        ]
        if dedups or first_aggs:
            if self.mode == "complete":
                raise AnalysisException(
                    "complete output mode is not supported for streaming "
                    "deduplication")
            if len(dedups) + len(first_aggs) > 1:
                raise AnalysisException(
                    "multiple streaming deduplications are not supported")
            node = (dedups or first_aggs)[0]
            inner_aggs = [a for a in _find_nodes(node.children[0],
                                                 L.Aggregate)
                          if _find_streaming(a)]
            if inner_aggs:
                raise AnalysisException(
                    "deduplicating the output of a streaming aggregation "
                    "cannot be executed incrementally")
            self._check_stateless_path(node, "streaming deduplication")
            if isinstance(node, L.Aggregate):
                for f, n in node.aggs:
                    if not (isinstance(f.children[0], Col)
                            and f.children[0].name == n):
                        raise AnalysisException(
                            "streaming first() aggregates are only "
                            "supported in the dropDuplicates(subset) shape")
                keys = [k.name for k in node.keys]
            else:
                keys = list(node.schema().names)
            self._dedup_node = node
            self._dedup_state = DedupState(keys, node.child.schema(),
                                           self._wm_col, self.device)
            return None
        # only aggregates whose subtree reads the STREAM are stateful
        aggs = [a for a in _find_nodes(self.plan, L.Aggregate)
                if _find_streaming(a)]
        if not aggs:
            if self.mode == "complete":
                raise AnalysisException(
                    "complete output mode requires an aggregation")
            return None
        if len(aggs) > 1:
            raise AnalysisException(
                "multiple streaming aggregations are not supported")
        agg = aggs[0]
        node = self.plan
        while node is not agg:
            if not isinstance(node, (L.Project, L.Filter, L.Sort, L.Limit)) \
                    or len(node.children) != 1:
                raise AnalysisException(
                    f"streaming aggregation under "
                    f"{type(node).__name__} cannot be executed "
                    f"incrementally")
            if isinstance(node, L.Sort) and self.mode != "complete":
                raise AnalysisException(
                    "sorting a streaming aggregation is only supported in "
                    "complete output mode")
            node = node.children[0]
        for f, _n in agg.aggs:
            if getattr(f, "is_percentile", False) \
                    or getattr(f, "is_collect", False):
                raise AnalysisException(
                    f"{f!r} has no mergeable partial form; streaming "
                    "aggregations support sum/count/avg/min/max/first/"
                    "last/variance")
        # sliding window() keys: the analyzer's Expand rewrite below the
        # aggregate, so the state only ever sees window-start keys
        self._agg_anchor = agg
        sliding_key = self._sliding_event_key(agg)
        if sliding_key is not None or self._has_sliding(agg):
            from ..sql.analyzer import Analyzer
            agg = Analyzer._rewrite_sliding_window(agg)
        self._event_key = self._find_event_key(agg)
        if self._event_key is None:
            self._event_key = sliding_key
        if self.mode == "append" and self._event_key is None:
            raise AnalysisException(
                "append output mode for streaming aggregations requires a "
                "watermark on an event-time grouping key "
                "(withWatermark + window()/the event column in groupBy)")
        self._agg_node = agg
        return AggregationState(agg.keys, agg.aggs, agg.child.schema(),
                                self.device)

    @staticmethod
    def _has_sliding(agg: L.Aggregate) -> bool:
        from ..expressions import Alias, TimeWindow
        for k in agg.keys:
            b = k.children[0] if isinstance(k, Alias) else k
            if isinstance(b, TimeWindow) and b.is_sliding:
                return True
        return False

    def _sliding_event_key(self, agg: L.Aggregate):
        """(key index, window duration) when a SLIDING window key is tied
        to the watermark column, captured BEFORE the rewrite."""
        from ..expressions import Alias, TimeWindow
        if self._wm_col is None:
            return None
        for i, k in enumerate(agg.keys):
            base = k.children[0] if isinstance(k, Alias) else k
            if isinstance(base, TimeWindow) and base.is_sliding \
                    and base.field == "start" \
                    and isinstance(base.children[0], Col) \
                    and base.children[0].name.split(".")[-1] == self._wm_col:
                return i, base.duration_us
        return None

    def _find_event_key(self, agg: L.Aggregate):
        """(key index, window duration) of the event-time grouping key tied
        to the watermark column; duration 0 = the raw event column."""
        from ..expressions import Alias, TimeWindow
        if self._wm_col is None:
            return None
        for i, k in enumerate(agg.keys):
            base = k.children[0] if isinstance(k, Alias) else k
            if isinstance(base, TimeWindow) and base.field == "start" \
                    and isinstance(base.children[0], Col) \
                    and base.children[0].name.split(".")[-1] == self._wm_col:
                return i, base.duration_us
            if isinstance(base, Col) \
                    and base.name.split(".")[-1] == self._wm_col:
                return i, 0
        return None

    def _recover(self):
        last_commit, commit_meta = self.commit_log.latest()
        if commit_meta:
            if commit_meta.get("max_event") is not None:
                self._max_event_us = commit_meta["max_event"]
            if commit_meta.get("wm") is not None:
                self.watermark_us = commit_meta["wm"]
        last_offset_batch, off = self.offset_log.latest()
        if last_offset_batch is None:
            return
        # rebuild the source's in-memory offset state from the WAL so every
        # logged batch (committed or not) replays to the same data
        for b in range(last_offset_batch + 1):
            entry = self.offset_log.get(b)
            if entry is not None and entry.get("meta") is not None:
                if self._multi:
                    for src, st, e, m in zip(self.sources,
                                             entry.get("start"),
                                             entry["end"], entry["meta"]):
                        if m is not None:
                            src.restore_offset_metadata(st, e, m)
                else:
                    self.source.restore_offset_metadata(
                        entry.get("start"), entry["end"], entry["meta"])
            if entry is not None and entry.get("wm") is not None:
                if self.watermark_us is None \
                        or entry["wm"] > self.watermark_us:
                    self.watermark_us = entry["wm"]
        state_crc = (commit_meta or {}).get("state", {}).get("crc") \
            if isinstance((commit_meta or {}).get("state"), dict) else None
        com_off = (commit_meta or {}).get("off")
        if last_commit is not None and isinstance(com_off, dict):
            wal = self.offset_log.get(last_commit)
            if wal is not None and wal.get("end") != com_off.get("end"):
                raise CheckpointCorruption(
                    last_commit,
                    f"commit covers offsets {com_off} but the offset WAL "
                    f"recorded end={wal.get('end')!r}")
        if last_commit is not None and self._agg_state is not None \
                and self.state_dir:
            self._agg_state.restore(self.state_dir, last_commit,
                                    expected_crc=state_crc)
        if last_commit is not None and self._dedup_state is not None \
                and self.state_dir:
            self._dedup_state.restore(self.state_dir, last_commit,
                                      expected_crc=state_crc)
        if last_commit is not None and self._ssjoin_node is not None:
            self._ssjoin_restore(last_commit)
        if last_commit is not None and self._fmgws_node is not None \
                and self._fmgws_provider is not None:
            # the state after committed batch b is version b+1
            self._fmgws_states = dict(
                self._fmgws_provider.get_store(last_commit + 1).iterator())
        if last_commit is not None and last_commit == last_offset_batch:
            self.batch_id = last_commit + 1
            self.committed_offset = off["end"]
        else:
            # logged but not committed: replay it
            self.batch_id = last_offset_batch
            prev = self.offset_log.get(last_offset_batch - 1) \
                if last_offset_batch > 0 else None
            self.committed_offset = prev["end"] if prev else (
                [None] * len(self.sources) if self._multi else None)

    # -- the loop ---------------------------------------------------------
    def process_all_available(self) -> None:
        while self._run_one_batch():
            pass

    processAllAvailable = process_all_available

    def _run_one_batch(self) -> bool:
        with self._batch_lock:
            return self._run_one_batch_locked()

    def _run_one_batch_locked(self) -> bool:
        if self._multi:
            return self._run_one_batch_multi()
        # serving admission: a deferred batch leaves NOTHING behind
        if self._batch_admit is not None and not self._batch_admit():
            self.metrics["admission_deferred"] += 1
            return False
        # replay path: offsets already logged for this batch id
        logged = self.offset_log.get(self.batch_id)
        if logged is not None:
            start, end = logged.get("start"), logged["end"]
            if "wm" in logged:
                self.watermark_us = logged["wm"]
            self.metrics["replayed_batches"] += 1
        else:
            end = self.source.get_offset()
            start = self.committed_offset
            if end is None or end == start:
                return False
            cap = int(getattr(self.source, "max_per_trigger", 0) or 0)
            if cap > 0 and end - (start or 0) > cap:
                # bounded trigger: a backlog drains as several
                # deterministic batches
                end = (start or 0) + cap
            # phase 1 — offset WAL BEFORE compute, with the source's
            # offset → data mapping and the start-of-batch watermark
            payload = {"start": start, "end": end}
            if self._wm_col is not None:
                payload["wm"] = self.watermark_us
            meta = self.source.offset_metadata(start, end)
            if meta is not None:
                payload["meta"] = meta
            self.offset_log.add(self.batch_id, payload)
        t0 = time.perf_counter()
        self._start_timings()
        # phase 2 — compute: the stage cache's rebuild delta shows the
        # second batch reusing the first batch's captured stages
        self._unspill_state()
        batch = self.source.get_batch(start, end)
        self.timings["source_ms"] = (time.perf_counter() - t0) * 1e3
        if self._wm_col is not None:
            batch = self._apply_watermark_input(batch)
        n_rows = int(batch.num_rows())
        builds0 = self._stage_builds()
        out = self._execute_batch(batch)
        self.metrics["stage_rebuilds_last"] = \
            self._stage_builds() - builds0
        t_state = time.perf_counter()
        # phase 3 — state versions durably (atomic snapshot writes); the
        # fingerprint rides the commit entry below
        state_crc = None
        if self._agg_state is not None and self.state_dir:
            state_crc = self._agg_state.snapshot(self.state_dir,
                                                 self.batch_id)
        if self._dedup_state is not None and self.state_dir:
            state_crc = self._dedup_state.snapshot(self.state_dir,
                                                   self.batch_id)
        if self._fmgws_node is not None and self._fmgws_provider is not None:
            # the state AFTER batch b is version b+1
            store = self._fmgws_provider.get_store(self.batch_id)
            changed, removed = getattr(self, "_fmgws_changes", (set(), set()))
            for k in changed:
                store.put(k, self._fmgws_states[k])
            for k in removed:
                store.remove(k)
            store.commit()
        self.timings["state_commit_ms"] = \
            (time.perf_counter() - t_state) * 1e3
        if self._post_state_commit_hook is not None:
            # kill point: state durable, sink and commit not
            self._post_state_commit_hook(self.batch_id)
        # phase 4 — sink write, idempotent by batch id
        t_sink = time.perf_counter()
        self.sink.add_batch(self.batch_id, out, self.mode)
        self.timings["sink_ms"] = (time.perf_counter() - t_sink) * 1e3
        # phase 5 — THE commit point: offsets + state fingerprint + sink
        # batch id as ONE checksummed atomic-rename entry
        t_commit = time.perf_counter()
        commit_payload = {"ts": time.time(),
                          "off": {"start": start, "end": end},
                          "sink": self.batch_id}
        if state_crc is not None:
            commit_payload["state"] = {"ver": self.batch_id,
                                       "crc": state_crc}
        if self._wm_col is not None:
            # recovery must not rewind the watermark
            commit_payload["max_event"] = self._max_event_us
            commit_payload["wm"] = self.watermark_us
        self.commit_log.add(self.batch_id, commit_payload)
        self.timings["commit_ms"] = (time.perf_counter() - t_commit) * 1e3
        # phase 6 — post-commit: ledger re-accounting (may spill), source
        # release, progress
        self.metrics["batches_committed"] += 1
        self._renew_ownership()
        self._account_state()
        wall = time.perf_counter() - t0
        self._end_timings(wall)
        self.progress.append({
            "batchId": self.batch_id, "numInputRows": n_rows,
            "processedRowsPerSecond": n_rows / max(wall, 1e-9),
            "stageRebuilds": self.metrics["stage_rebuilds_last"],
        })
        self.committed_offset = end
        try:
            self.source.commit(end)
        except Exception:
            _log.warning("source.commit(%s) failed", end, exc_info=True)
        self.batch_id += 1
        return True

    def _renew_ownership(self) -> None:
        """Renew the block-service checkpoint lease on every durable
        commit; a no-op without a service."""
        if self._blockclient is not None and self._ck_owner:
            self._blockclient.touch_owner(self._ck_owner)

    # -- stage cache, device copies, ledger tenancy -----------------------
    def _stage_builds(self) -> int:
        from ..sql.stagecompile import stage_cache
        return int(stage_cache(self.session).stats()["builds"])

    @staticmethod
    def _pad(batch: ColumnBatch) -> ColumnBatch:
        """Pad a micro-batch relation to a power-of-two capacity: the
        stage cache keys a captured stage on leaf capacity, so unpadded
        batches of 3 then 5 rows would capture anew every trigger."""
        cap = pad_capacity(batch.capacity)
        return pad_to_capacity(batch, cap) if cap != batch.capacity \
            else batch

    def _to_card(self, batch: ColumnBatch) -> ColumnBatch:
        """The padded host batch on the session's device: one copy per
        tensor (from page-locked memory on a card), timed."""
        if batch.device == self.device:
            return batch
        from ..memory import batch_nbytes
        if self.device.type == "cuda":
            batch = batch.pinned()
        tm = _Timer(self.device)
        out = batch.to_device(self.device, non_blocking=True)
        self._h2d_timers.append(tm.stop())
        self.timings["h2d_bytes"] += batch_nbytes(batch)
        return out

    def _start_timings(self) -> None:
        self.timings = {"merge_ms": 0.0, "below_ms": 0.0, "h2d_ms": 0.0,
                        "h2d_bytes": 0, "fmgws_host_ms": 0.0}
        self._h2d_timers: List[_Timer] = []

    def _end_timings(self, wall_s: float) -> None:
        self.timings["h2d_ms"] = sum(t.elapsed() for t in self._h2d_timers)
        self.timings["wall_ms"] = wall_s * 1e3

    def _run_below(self, plan: L.LogicalPlan) -> ColumnBatch:
        """The plan below the stateful operator, through the planner and
        the stage cache; its compacted result stays on the device."""
        from ..sql.planner import QueryExecution
        t0 = time.perf_counter()
        qe = QueryExecution(self.session, plan)
        qe.keep_on_device = True
        out = qe.execute()
        if out.device != self.device:
            out = out.to_device(self.device)
        self.timings["below_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def _state_parts(self) -> List[Tuple[str, Any]]:
        out = []
        if self._agg_state is not None:
            out.append(("agg", self._agg_state))
        if self._dedup_state is not None:
            out.append(("dedup", self._dedup_state))
        return out

    def _account_state(self) -> None:
        """Re-account this stream's state bytes under the host ledger; a
        refused reservation spills the state in wire format (reloaded at
        the next batch)."""
        from ..memory import batch_nbytes
        nbytes = rows = 0
        for _tag, st in self._state_parts():
            if st.state is not None:
                nbytes += batch_nbytes(st.state)
                rows += int(st.state.num_rows())
        self.metrics["state_bytes"] = nbytes
        self.metrics["state_rows"] = rows
        self.metrics["evicted_rows"] = sum(
            st.evicted_rows for _t, st in self._state_parts())
        if self.watermark_us is not None:
            self.metrics["watermark_us"] = int(self.watermark_us)
        led = self._ledger
        if led is None:
            return
        led.release(self._ledger_owner)
        if nbytes and not led.try_reserve(self._ledger_owner, nbytes):
            self._spill_state()

    def _spill_state(self) -> None:
        """Ledger pressure: park the state batches as wire-format files
        under the checkpoint and drop the device copies.  The durable
        snapshot already exists; without a checkpoint the state stays."""
        if not self.state_dir:
            return
        from .. import config as C
        from ..wire import encode_batches
        run_codes = self.session.conf.get(C.SHUFFLE_WIRE_RUN_CODES)
        d = os.path.join(self.state_dir, "spill")
        os.makedirs(d, exist_ok=True)
        for tag, st in self._state_parts():
            if st.state is None:
                continue
            buf = encode_batches([st.state.packed_host()],
                                 run_codes=run_codes)
            dest = os.path.join(d, f"{tag}.wire")
            tmp = f"{dest}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(buf)
            os.replace(tmp, dest)
            self.metrics["spill_bytes"] += len(buf)
            self.metrics["spill_events"] += 1
            st.state = None
            self._spilled.add(tag)
        self.metrics["state_bytes"] = 0

    def _unspill_state(self) -> None:
        if not self._spilled:
            return
        from .. import config as C
        from ..columnar import dense_runs
        from ..wire import decode_batches
        run_codes = self.session.conf.get(C.SHUFFLE_WIRE_RUN_CODES)
        d = os.path.join(self.state_dir, "spill")
        for tag, st in self._state_parts():
            if tag in self._spilled:
                with open(os.path.join(d, f"{tag}.wire"), "rb") as f:
                    back = decode_batches(f.read(), keep_runs=run_codes)[0]
                st.state = dense_runs(back, self.device)
        self._spilled.clear()

    # -- watermark bookkeeping --------------------------------------------
    def _apply_watermark_input(self, batch: ColumnBatch) -> ColumnBatch:
        """Track the batch's max event time (one host read: the batch is
        still on the host here); DROP rows whose state is already final
        under the current (start-of-batch) watermark."""
        if self._wm_col not in batch.names:
            return batch
        vec = batch.column(self._wm_col)
        data = vec.data.to(torch.int64)
        valid = vec.valid_or_true()
        live = batch.row_valid_or_true()
        vals = data[live & valid]
        if vals.numel():
            mx = int(vals.max())
            if self._max_event_us is None or mx > self._max_event_us:
                self._max_event_us = mx
        if self.watermark_us is not None:
            # a row is TOO LATE only when the state it would update is
            # final: its window END <= wm for windowed aggregation, its
            # event value < wm for dedup/raw-key state
            wm = self.watermark_us
            late = None
            if self._agg_state is not None and self._event_key is not None:
                _idx, dur = self._event_key
                if dur:
                    late = (torch.div(data, dur, rounding_mode="floor")
                            + 1) * dur <= wm
                else:
                    late = data < wm
            elif self._dedup_state is not None:
                late = data < wm
            if late is not None:
                keep = live & (~valid | ~late)
                if int(keep.sum()) != int(live.sum()):
                    batch = ColumnBatch(batch.names, batch.vectors, keep,
                                        batch.capacity)
        return batch

    def _run_one_batch_multi(self) -> bool:
        """One micro-batch over TWO sources (stream-stream join): offsets
        for both sides ride one WAL entry, each side's NEW rows run its
        join subplan, and the incremental inner join emits
        Δ(A⋈B) = ΔA⋈(B∪ΔB) ∪ A⋈ΔB against the buffered past rows.  A
        watermark on a side bounds that side's buffer."""
        if self._batch_admit is not None and not self._batch_admit():
            self.metrics["admission_deferred"] += 1
            return False
        logged = self.offset_log.get(self.batch_id)
        if logged is not None:
            starts, ends = logged["start"], logged["end"]
            if "wm" in logged:
                self.watermark_us = logged["wm"]
            metas = logged.get("meta") or [None] * len(self.sources)
            for src, st, e, m in zip(self.sources, starts, ends, metas):
                if m is not None:
                    src.restore_offset_metadata(st, e, m)
            self.metrics["replayed_batches"] += 1
        else:
            starts = list(self.committed_offset)
            ends = []
            progressed = False
            for i, src in enumerate(self.sources):
                e = src.get_offset()
                if e is None:
                    e = starts[i]
                if e != starts[i]:
                    progressed = True
                ends.append(e)
            if not progressed:
                return False
            payload = {"start": starts, "end": ends}
            if self._wm_col is not None:
                payload["wm"] = self.watermark_us
            metas = [src.offset_metadata(st, e)
                     if e is not None and e != st else None
                     for src, st, e in zip(self.sources, starts, ends)]
            if any(m is not None for m in metas):
                payload["meta"] = metas
            self.offset_log.add(self.batch_id, payload)

        t0 = time.perf_counter()
        self._start_timings()
        batches = []
        for i, (src, st, e) in enumerate(zip(self.sources, starts, ends)):
            if e is None or e == st:
                b = ColumnBatch.empty(src.schema())
            else:
                b = src.get_batch(st, e)
            if self._wm_col is not None and i == self._wm_src:
                b = self._apply_watermark_input(b)
            batches.append(b)
        self.timings["source_ms"] = (time.perf_counter() - t0) * 1e3
        n_rows = sum(int(b.num_rows()) for b in batches)

        builds0 = self._stage_builds()
        out = self._execute_ssjoin(batches)
        self.metrics["stage_rebuilds_last"] = \
            self._stage_builds() - builds0
        t_sink = time.perf_counter()
        self.sink.add_batch(self.batch_id, out, self.mode)
        self.timings["sink_ms"] = (time.perf_counter() - t_sink) * 1e3
        t_commit = time.perf_counter()
        self._ssjoin_snapshot(self.batch_id)
        commit_payload = {"ts": time.time()}
        if self._wm_col is not None:
            commit_payload["max_event"] = self._max_event_us
            commit_payload["wm"] = self.watermark_us
        self.commit_log.add(self.batch_id, commit_payload)
        self.timings["commit_ms"] = (time.perf_counter() - t_commit) * 1e3
        self.metrics["batches_committed"] += 1
        self._renew_ownership()
        self.metrics["state_rows"] = sum(
            int(b.num_rows()) for b in self._ss_buf if b is not None)
        wall = time.perf_counter() - t0
        self._end_timings(wall)
        self.progress.append({
            "batchId": self.batch_id, "numInputRows": n_rows,
            "processedRowsPerSecond": n_rows / max(wall, 1e-9),
            "stageRebuilds": self.metrics["stage_rebuilds_last"],
        })
        self.committed_offset = list(ends)
        for src, e in zip(self.sources, ends):
            if e is not None:
                try:
                    src.commit(e)
                except Exception:
                    _log.warning("source.commit(%s) failed", e,
                                 exc_info=True)
        self.batch_id += 1
        return True

    _SS_RID = "__ss_rid__"

    def _execute_ssjoin(self, batches: List[ColumnBatch]) -> ColumnBatch:
        """One micro-batch of the symmetric stream-stream join.  Inner
        matches emit the trigger they occur; for LEFT/RIGHT outer, the
        preserved side's buffered rows carry a monotonic row id, matches
        are recorded through semi joins, and rows the watermark evicts
        while still unmatched null-extend into the same trigger's output.
        Every probe is a query on the device; the buffers stay there.

        Known bound (as in the JAX package): only the watermark side's
        buffer evicts."""
        j = self._ssjoin_node
        rels = [_find_streaming(j.left)[0], _find_streaming(j.right)[0]]
        order = [self.sources.index(r.source) for r in rels]
        new_sides = []
        for side_plan, src_idx in zip((j.left, j.right), order):
            data = self._to_card(self._pad(batches[src_idx]))
            below = self._replace_source(side_plan, data)
            new_sides.append(self._run_below(below))
        new_wm = self._advance_watermark()
        how = j.how
        pres = None if how == "inner" else (0 if how == "left" else 1)
        RID = self._SS_RID
        dev = self.device

        def tag(b: ColumnBatch) -> ColumnBatch:
            rids = torch.arange(self._ss_rid_next,
                                self._ss_rid_next + b.capacity,
                                dtype=torch.int64, device=dev)
            self._ss_rid_next += b.capacity
            return ColumnBatch(
                list(b.names) + [RID],
                list(b.vectors) + [ColumnVector(rids, T.int64, None, None)],
                b.row_valid, b.capacity)

        def untag(b: ColumnBatch) -> ColumnBatch:
            if RID not in b.names:
                return b
            i = b.names.index(RID)
            return ColumnBatch(
                [n for k, n in enumerate(b.names) if k != i],
                [v for k, v in enumerate(b.vectors) if k != i],
                b.row_valid, b.capacity)

        def join_of(a: ColumnBatch, b: ColumnBatch,
                    how2: str = "inner") -> ColumnBatch:
            plan = L.Join(L.LocalRelation(a), L.LocalRelation(b),
                          how2, j.on, j.using)
            return self._run_below(plan)

        old_a, old_b = self._ss_buf
        new_a, new_b = new_sides
        if pres == 0:
            new_a = tag(new_a)
        elif pres == 1:
            new_b = tag(new_b)
        all_b = new_b if old_b is None else union_all([old_b, new_b])
        parts = [join_of(untag(new_a), untag(all_b))]
        if old_a is not None:
            parts.append(join_of(untag(old_a), untag(new_b)))

        if pres is not None:
            # which preserved rows matched: semi joins on the tagged side
            if pres == 0:
                semis = [(new_a, untag(all_b))]
                if old_a is not None:
                    semis.append((old_a, untag(new_b)))
            else:
                all_a = new_a if old_a is None \
                    else union_all([old_a, new_a])
                semis = [(new_b, untag(all_a))]
                if old_b is not None:
                    semis.append((old_b, untag(new_a)))
            for tagged, other in semis:
                m = join_of(tagged, other, "left_semi")
                nr = int(m.num_rows())
                rids = m.column(RID).data[:nr].cpu().tolist()
                self._ss_matched.update(int(r) for r in rids)

        parts = [p for p in parts if int(p.num_rows())]

        wm_side = None
        if self._wm_col is not None:
            wm_side = order.index(self._wm_src) \
                if self._wm_src in order else None

        null_parts: List[ColumnBatch] = []

        def fold(side, old, new):
            buf = _fit(new if old is None else union_all([old, new]))
            if new_wm is not None and side == wm_side \
                    and self._wm_col in buf.names:
                kv, kvalid = _numeric_event_col(
                    buf.column(self._wm_col), buf.capacity)
                live = buf.row_valid_or_true()
                drop = live & kvalid & (kv < new_wm)
                if side == pres and bool(drop.any()):
                    rids = buf.column(RID).data
                    matched = torch.isin(rids, torch.tensor(
                        sorted(self._ss_matched), dtype=torch.int64,
                        device=rids.device))
                    un = drop & ~matched
                    if bool(un.any()):
                        rows = _keep_rows(buf, un)
                        other_plan = j.right if pres == 0 else j.left
                        other_b = all_b if pres == 0 else untag(new_a)
                        other_dicts = {
                            n: v.dictionary for n, v in
                            zip(other_b.names, other_b.vectors)
                            if v.dictionary}
                        from ..sql.stages import _null_extend
                        null_parts.append(_null_extend(
                            untag(rows).packed_host(), j.schema(),
                            other_plan.schema(), other_dicts))
                    # evicted rids can never be asked about again
                    for r in rids[drop].cpu().tolist():
                        self._ss_matched.discard(int(r))
                buf = _keep_rows(buf, live & ~drop)
            return buf

        self._ss_buf = [fold(0, old_a, new_a), fold(1, old_b, new_b)]
        parts = [p.packed_host() for p in parts]
        parts += [p for p in null_parts if int(p.num_rows())]
        if parts:
            out = compact(union_all(parts)) if len(parts) > 1 else parts[0]
        else:
            out = ColumnBatch.empty(j.schema())
        return self._finish_above(j, out)

    def _advance_watermark(self) -> Optional[int]:
        """Monotonic watermark update from the max event time seen so far,
        applied at the END of the batch that observed the events."""
        if self._wm_col is None:
            return None
        if self._max_event_us is not None:
            cand = self._max_event_us - self._wm_delay
            if self.watermark_us is None or cand > self.watermark_us:
                self.watermark_us = cand
        return self.watermark_us

    def _execute_batch(self, data: ColumnBatch) -> ColumnBatch:
        from ..sql.planner import QueryExecution

        # every per-batch relation lands on a power-of-two capacity, on
        # the device, so the second trigger replays the first one's stage
        data = self._to_card(self._pad(data))
        if self._fmgws_node is not None:
            from .groupstate import run_flat_map_groups
            node = self._fmgws_node
            below = self._replace_source(node.child, data)
            pre = self._run_below(below)
            new_wm = self._advance_watermark()
            t_host = time.perf_counter()
            out, new_states, changed, removed = run_flat_map_groups(
                node.func, node.key_names, pre, node.out_schema,
                self._fmgws_states, watermark_us=new_wm,
                timeout_conf=node.timeout_conf)
            self.timings["fmgws_host_ms"] = \
                (time.perf_counter() - t_host) * 1e3
            self._fmgws_states = new_states
            self._fmgws_changes = (changed, removed)
            return self._finish_above(node, self._pad(out))

        if self._dedup_state is not None:
            below = self._replace_source(self._dedup_node.child, data)
            pre = self._run_below(below)
            tm = _Timer(self.device)
            emit = self._dedup_state.update(pre)
            new_wm = self._advance_watermark()
            if new_wm is not None:
                self._dedup_state.evict(self._wm_col, new_wm)
            self.timings["merge_ms"] = tm.stop().elapsed()
            # reorder to the dedup node's output schema, then re-apply
            # whatever sits above it
            names = self._dedup_node.schema().names
            plan = L.Project([Col(n) for n in names],
                             L.LocalRelation(self._pad(emit)))
            above = self._rebuild_above_plan(self._dedup_node, plan)
            return QueryExecution(self.session, above).execute()

        if self._agg_node is not None:
            # the plan BELOW the aggregate on the new data, then merge with
            # the state and (re)finish (StateStoreRestore/Save in one)
            below = self._replace_source(self._agg_node.child, data)
            pre = self._run_below(below)
            anchor = getattr(self, "_agg_anchor", None) or self._agg_node
            tm = _Timer(self.device)
            if self.mode == "append":
                # emit ONLY groups the advanced watermark finalizes; they
                # leave the state (exactly-once emission)
                self._agg_state.merge(pre)
                idx, dur = self._event_key
                new_wm = self._advance_watermark()
                emit = None
                if new_wm is not None:
                    emit = self._agg_state.evict_finalized(
                        idx, dur, new_wm, emit=True)
                self.timings["merge_ms"] = tm.stop().elapsed()
                if emit is None:
                    emit = ColumnBatch.empty(self._agg_node.schema(),
                                             device=self.device)
                return self._finish_above(anchor, emit)
            finished = self._agg_state.update(
                pre, changed_only=(self.mode == "update"))
            if self.mode == "update" and self._event_key is not None:
                new_wm = self._advance_watermark()
                if new_wm is not None:
                    idx, dur = self._event_key
                    self._agg_state.evict_finalized(
                        idx, dur, new_wm, emit=False)
            self.timings["merge_ms"] = tm.stop().elapsed()
            return self._finish_above(anchor, finished)
        self._advance_watermark()
        plan = self._replace_source(self.plan, data)
        return QueryExecution(self.session, plan).execute()

    def _replace_source(self, plan: L.LogicalPlan, data: ColumnBatch
                        ) -> L.LogicalPlan:
        def fn(n):
            if isinstance(n, StreamingRelation):
                return L.LocalRelation(data)
            return n
        return plan.transform_up(fn)

    def _finish_above(self, anchor: L.LogicalPlan,
                      result: ColumnBatch) -> ColumnBatch:
        """Re-apply the nodes above the stateful operator to its result
        and bring the answer to the host.  The result's capacity follows
        the state's, which moves with its live rows: the relation above
        is its live prefix
        at the largest power-of-two capacity this query has needed (at
        least ``_ABOVE_MIN_CAPACITY``), so a trigger of the same shape
        replays the same stage.  With nothing above the operator the live
        prefix is the answer."""
        from ..sql.planner import QueryExecution
        out = compact(result)
        n = int(out.num_rows())
        if anchor is self.plan:
            return out.packed_host(min(pad_capacity(max(n, 1)),
                                       out.capacity))
        self._above_cap = max(self._above_cap, pad_capacity(n),
                              _ABOVE_MIN_CAPACITY)
        cap = self._above_cap
        leaf = pad_to_capacity(out, cap) if cap >= out.capacity \
            else ColumnBatch(
                out.names,
                [ColumnVector(v.data[:cap], v.dtype,
                              None if v.valid is None else v.valid[:cap],
                              v.dictionary) for v in out.vectors],
                out.row_valid_or_true()[:cap], cap)
        above = self._rebuild_above_plan(anchor, L.LocalRelation(leaf))
        return QueryExecution(self.session, above).execute()

    def _rebuild_above_plan(self, anchor: L.LogicalPlan,
                            plan: L.LogicalPlan) -> L.LogicalPlan:
        stack = []
        node = self.plan
        while node is not anchor:
            stack.append(node)
            node = node.children[0]
        for n in reversed(stack):
            inner = plan
            plan = n.map_children(lambda _c: inner)
        return plan

    # -- thread control ---------------------------------------------------
    def start_thread(self):
        def loop():
            try:
                while not self._stopped.is_set():
                    progressed = self._run_one_batch()
                    if not progressed:
                        self._stopped.wait(self.interval)
            except BaseException as e:   # surfaced via .exception
                self.exception = e
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"stream-{self.id[:8]}")
        self._thread.start()

    def stop(self):
        self._stopped.set()
        if self._thread:
            self._thread.join(timeout=10)
        # release the ledger tenancy and leave the session registry
        if self._ledger is not None:
            try:
                self._ledger.release_prefix(f"stream:{self.id[:8]}:")
            except Exception:
                pass
        regs = getattr(self.session, "_stream_execs", None)
        if regs is not None and self in regs:
            regs.remove(self)
        # EXPLICIT checkpoint-ownership release: only a stopped query
        # starts the reaper's release + TTL clock
        if self._blockclient is not None and self._ck_owner:
            self._blockclient.release_state(self._ck_owner,
                                            owner=self._ck_owner)


class _MemLog(MetadataLog):
    def __init__(self):
        self._d: Dict[int, dict] = {}

    def add(self, batch_id, payload):
        self._d[batch_id] = payload

    def get(self, batch_id):
        return self._d.get(batch_id)

    def latest(self):
        if not self._d:
            return None, None
        i = max(self._d)
        return i, self._d[i]


class StreamingQuery:
    """User handle (``StreamingQuery.scala``)."""

    def __init__(self, execution: StreamExecution):
        self._ex = execution

    @property
    def id(self):
        return self._ex.id

    @property
    def name(self):
        return self._ex.name

    @property
    def isActive(self) -> bool:
        return self._ex._thread is not None \
            and not self._ex._stopped.is_set()

    @property
    def lastProgress(self) -> Optional[dict]:
        return self._ex.progress[-1] if self._ex.progress else None

    @property
    def recentProgress(self) -> List[dict]:
        return list(self._ex.progress)

    def exception(self):
        return self._ex.exception

    def processAllAvailable(self) -> None:
        if self._ex.exception:
            raise self._ex.exception
        self._ex.process_all_available()
        if self._ex.exception:
            raise self._ex.exception

    def awaitTermination(self, timeout: Optional[float] = None) -> bool:
        t0 = time.time()
        while self.isActive:
            if timeout is not None and time.time() - t0 > timeout:
                return False
            time.sleep(0.05)
        return True

    def stop(self) -> None:
        self._ex.stop()
        from .api import StreamingQueryManager
        StreamingQueryManager.remove(self)


class SocketSource(Source):
    """``socket`` text source (``TextSocketSource.scala``): line-delimited
    UTF-8 from host:port into one ``value`` string column.  Not
    replayable (data is read once off the wire), as in the reference."""

    def __init__(self, host: str, port: int):
        import socket as _socket
        self._schema = T.StructType([T.StructField("value", T.string)])
        self._lines: List[str] = []
        self._base = 0              # absolute offset of _lines[0]
        self._lock = threading.Lock()
        self._sock = _socket.create_connection((host, port), timeout=10)
        self._stopped = threading.Event()

        def reader():
            buf = b""
            try:
                while not self._stopped.is_set():
                    chunk = self._sock.recv(4096)
                    if not chunk:
                        break
                    buf += chunk
                    *lines, buf = buf.split(b"\n")
                    if lines:
                        with self._lock:
                            self._lines.extend(
                                l.decode("utf-8", "replace") for l in lines)
            except OSError:
                pass

        self._thread = threading.Thread(target=reader, daemon=True)
        self._thread.start()

    def schema(self) -> T.StructType:
        return self._schema

    def get_offset(self) -> Optional[int]:
        with self._lock:
            return (self._base + len(self._lines)) or None

    def get_batch(self, start, end) -> ColumnBatch:
        s = start or 0
        with self._lock:
            rows = self._lines[max(s - self._base, 0):end - self._base]
        return ColumnBatch.from_arrays(
            {"value": rows}, schema=self._schema) if rows \
            else ColumnBatch.empty(self._schema)

    def commit(self, end: int) -> None:
        """Drop committed lines; offsets stay absolute through _base."""
        with self._lock:
            drop = min(max(end - self._base, 0), len(self._lines))
            if drop:
                del self._lines[:drop]
                self._base += drop

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass


class KafkaSourceUnavailable(Source):
    """Placeholder for a ``kafka`` source without a client library:
    construction fails with the dependency story instead of a KeyError."""

    def __init__(self, *_a, **_k):
        raise AnalysisException(
            "kafka source requires the kafka-python client, which is not "
            "installed in this environment; install it and register a "
            "Source subclass, or use file/socket/rate/memory sources")
