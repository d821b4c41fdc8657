"""The host shuffle service: cross-process block exchange over a shared
filesystem.

The port of ``spark_tpu/parallel/hostshuffle.py`` (the external shuffle
service's role, ``ExternalShuffleBlockResolver.java:57`` /
``ShuffleBlockFetcherIterator``).  When query state must cross PROCESS
boundaries, every process stages per-receiver blocks in a directory all
of them mount, and the receivers read them back.  Within one process the
mesh lane's exchanges stay kernel K2 (``cuda_a2a``); this service is the
hop between processes, whichever cards they run on.

Protocol per exchange id::

    <root>/<exchange>/s<sender>-r<receiver>.part   one framed wire block
    <root>/<exchange>/s<sender>.dict               dictionary sidecar
    <root>/<exchange>/s<sender>.done               sender's commit marker

Block payloads are the columnar wire format of ``wire.py``, byte for
byte the JAX package's: a block either package writes decodes in the
other.  ``put`` trims dead rows before anything reaches the disk.
Writers publish blocks with atomic renames, then commit a JSON MANIFEST
naming every block (receiver → byte size, the MapStatus analog); every
participant then barriers on the full set of markers, so a missing or
short block is a detected fault, not silence.

- WRITE side: ``put`` hands host batches to a background writer thread
  (``spark.tpu.shuffle.io.asyncWrite``); ``commit`` drains it before the
  manifest is published.
- READ side: blocks of several senders are fetched and decoded by a
  small thread pool (``spark.tpu.shuffle.io.fetchThreads``) under an
  in-flight byte bound (``maxInFlightBytes``), optionally landing in a
  ``FetchSink`` that spills to run files under the host ledger
  (``memory.HostMemoryLedger``).
- Faults: ``RetryingBlockReader`` re-reads missing, short, torn or
  corrupt blocks with exponential backoff and deterministic jitter; a
  wired ``HeartbeatMonitor`` turns a confirmed-dead peer into a barrier
  exclusion and a blacklist entry; every unrecoverable loss is a
  structured ``ExchangeFetchFailed`` naming the lost hosts and blocks,
  raised within a bounded time (one attempt ≤ ``timeout_s``; one
  ``refetch`` re-barrier makes it ≤ 2×).  A live but silent straggler
  fails the barrier with ``TimeoutError``.

Left out until the recovery slice: the block service (``blockclient``)
and the recovery round (``recover_round``, epochs, leaf-recipe
adoption); until then no loss is ever agreed, and ``live_pids`` is every
process.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import config as C
from .. import wire
from ..columnar import ColumnBatch, ColumnVector, remap_codes

__all__ = ["HostShuffleService", "RetryingBlockReader", "BlockFetchError",
           "ExchangeFetchFailed", "FetchSink"]


class BlockFetchError(OSError):
    """One block stayed missing/partial through every retry."""

    def __init__(self, path: str, attempts: int, reason: str):
        self.path = path
        self.attempts = attempts
        self.reason = reason
        super().__init__(
            f"block {os.path.basename(path)} unreadable after "
            f"{attempts} attempt(s): {reason}")


class ExchangeFetchFailed(RuntimeError):
    """A cross-process exchange lost blocks it cannot recover
    (FetchFailedException analog): names the exchange, the hosts whose
    data is gone and the blocks, so a caller can decide what to rerun
    without parsing a message."""

    def __init__(self, exchange: str, lost_hosts: Sequence[str],
                 lost_blocks: Sequence[str], elapsed_s: float = 0.0,
                 detail: str = ""):
        self.exchange = exchange
        self.lost_hosts = sorted(set(lost_hosts))
        self.lost_blocks = sorted(set(lost_blocks))
        self.elapsed_s = elapsed_s
        msg = (f"host shuffle {exchange!r}: lost blocks "
               f"{self.lost_blocks} from hosts {self.lost_hosts} "
               f"after {elapsed_s:.2f}s")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


def _jitter(seed: str, attempt: int) -> float:
    """Deterministic backoff jitter in [0.5, 1.5): reproducible, yet each
    block and attempt hashes differently so readers do not stampede."""
    h = zlib.crc32(f"{seed}#{attempt}".encode())
    return 0.5 + (h % 1024) / 1024.0


def _decode_block(data: bytes,
                  dict_table: Optional[Dict[str, tuple]] = None
                  ) -> List[ColumnBatch]:
    """A block's batches.  A block may hold SEVERAL back-to-back frames
    (map-side spill spans copied straight from a spill file); all of them
    decode.  ``dict_table`` resolves fingerprint-only dictionaries.  Only
    wire frames are blocks here: the JAX package's pickled pre-wire
    blocks fail as ``WireFormatError``."""
    return wire.decode_frames(data, dict_table=dict_table)


def _live_rows(batch: ColumnBatch) -> int:
    return int(batch.num_rows())


class _InflightGate:
    """Bounded in-flight-bytes admission for the fetch pool
    (``spark.tpu.shuffle.io.maxInFlightBytes``): a fetch worker waits for
    room instead of every sender's block piling up in host RAM at once.
    A block larger than the whole bound is admitted once it is ALONE;
    ``max_bytes <= 0`` disables the gate."""

    def __init__(self, max_bytes: int,
                 on_wait: Optional[Callable[[], None]] = None):
        self.max_bytes = max_bytes
        self._on_wait = on_wait
        self._inflight = 0
        self._cv = threading.Condition()

    def acquire(self, nbytes: int) -> None:
        if self.max_bytes <= 0:
            return
        nbytes = int(nbytes)
        with self._cv:
            waited = False
            while self._inflight > 0 \
                    and self._inflight + nbytes > self.max_bytes:
                if not waited and self._on_wait is not None:
                    self._on_wait()
                waited = True
                self._cv.wait()
            self._inflight += nbytes

    def release(self, nbytes: int) -> None:
        if self.max_bytes <= 0:
            return
        with self._cv:
            self._inflight -= int(nbytes)
            self._cv.notify_all()


class FetchSink:
    """Reduce-side landing zone for fetched blocks under the host ledger:
    each decoded batch either reserves its raw bytes and stays in RAM, or
    spills to a local run file in the wire format (the
    ExternalAppendOnlyMap insert-spill analog).  Batch boundaries survive
    the round trip, so a spilled presorted run drains back as the same
    run.

    ``add`` REPLACES a sender's previous delivery (a ``refetch`` stays
    idempotent).  Own batches arrive keyed at sender -1, so ``drain``
    returns own-first, then sorted-sender order."""

    def __init__(self, svc: "HostShuffleService", owner: str,
                 exchange: str, spill_dir: str,
                 spill_threshold: Optional[int] = None):
        self.svc = svc
        self.owner = owner
        self.exchange = exchange
        self.spill_dir = spill_dir
        self.spill_threshold = (svc.spill_threshold
                                if spill_threshold is None
                                else spill_threshold)
        self._lock = threading.Lock()
        #: sender → (ordered entries, run-file path or None, file end);
        #: an entry is ("mem", batch, nbytes) or ("disk", start, length, raw)
        self._senders: Dict[int, Tuple[list, Optional[str], int]] = {}
        #: set by the grace mode once a SIBLING side hit pressure: the
        #: exchange completes delivery-only and the grace pass streams
        #: this sink's entries itself (``pop_entries``)
        self.defer_drain = False

    def _run_path(self, sender: int) -> str:
        return os.path.join(self.spill_dir,
                            f"{self.exchange}-s{sender:04d}.fetch")

    def _evict_sender(self, sender: int) -> None:
        entries, path, _end = self._senders.pop(sender, ([], None, 0))
        mem_held = sum(e[2] for e in entries if e[0] == "mem")
        if mem_held:
            self.svc.ledger.release(self.owner, mem_held)
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass

    def add(self, sender: int, batches: Sequence[ColumnBatch]) -> None:
        from ..memory import HostMemoryError
        ledger = self.svc.ledger
        with self._lock:
            self._evict_sender(sender)
            entries: list = []
            path: Optional[str] = None
            end = 0
            for b in batches:
                nb = wire.raw_nbytes([b])
                force = 0 < self.spill_threshold <= nb
                if not force and ledger.try_reserve(self.owner, nb):
                    entries.append(("mem", b, nb))
                    continue
                # over the threshold or no ledger room: a run-file frame
                # (inline dictionaries: fetched batches resolved theirs)
                buf = wire.encode_batches(
                    [b], codec=self.svc.wire_codec,
                    compress_threshold=self.svc.wire_threshold,
                    run_codes=self.svc.run_codes
                    and self.exchange not in self.svc._raw_exchanges)
                if path is None:
                    path = self._run_path(sender)
                try:
                    self.svc.spill_write(path, buf, append=end > 0,
                                         exchange=self.exchange)
                except OSError as e:
                    raise HostMemoryError(
                        self.owner, nb, ledger.budget,
                        holders={self.owner: ledger.held(self.owner)},
                        exchange=self.exchange,
                        detail=f"spill failed: {e}")
                entries.append(("disk", end, len(buf), nb))
                end += len(buf)
            self._senders[sender] = (entries, path, end)

    @staticmethod
    def _read_span(path: str, start: int, length: int) -> bytes:
        with open(path, "rb") as f:
            f.seek(start)
            data = f.read(length)
        if len(data) != length:
            raise OSError(f"spill run {path}: short read {len(data)} "
                          f"of {length} B at {start}")
        return data

    def drain(self) -> List[ColumnBatch]:
        """Everything delivered, own-first then sorted sender order,
        spilled runs loaded back under a HARD ledger reservation.  A
        reservation failure raises ``HostMemoryPressure`` with every
        drain-made reservation rolled back and the entries intact, so a
        grace-capable caller can re-stream the sink (``pop_entries``)."""
        from ..memory import HostMemoryError, HostMemoryPressure
        if self.defer_drain:
            return []
        out: List[ColumnBatch] = []
        drained = 0                  # hard bytes reserved by THIS drain
        with self._lock:
            for sender in sorted(self._senders):
                entries, path, _end = self._senders[sender]
                for entry in entries:
                    if entry[0] == "mem":
                        out.append(entry[1])
                        continue
                    _kind, start, length, raw = entry
                    try:
                        self.svc.ledger.reserve(self.owner, raw,
                                                exchange=self.exchange)
                    except HostMemoryError as e:
                        if drained:
                            self.svc.ledger.release(self.owner, drained)
                        raise HostMemoryPressure(
                            self.owner, int(raw), self.svc.ledger.budget,
                            holders=e.holders, exchange=self.exchange,
                            detail="drained shard exceeds the host "
                                   "budget; sink entries intact for a "
                                   "grace pass")
                    drained += int(raw)
                    out.extend(wire.decode_frames(
                        self._read_span(path, start, length)))
        return out

    def pop_entries(self):
        """Destructively stream every delivered batch in ``drain`` order
        WITHOUT accumulating: a mem entry's reservation is released as it
        is yielded, a disk frame decodes one entry at a time, and run
        files go as their senders are exhausted."""
        with self._lock:
            senders = sorted(self._senders)
        for sender in senders:
            with self._lock:
                entries, path, _end = self._senders.pop(
                    sender, ([], None, 0))
            for entry in entries:
                if entry[0] == "mem":
                    _kind, batch, nb = entry
                    self.svc.ledger.release(self.owner, nb)
                    yield batch
                    continue
                _kind, start, length, _raw = entry
                yield from wire.decode_frames(
                    self._read_span(path, start, length))
            if path is not None:
                try:
                    os.remove(path)
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            for sender in list(self._senders):
                self._evict_sender(sender)


class _RetryBudget:
    """Shared retry allowance for one (exchange, sender) pair: N fetch
    threads retrying against the SAME dead host split one budget instead
    of each paying the whole backoff schedule."""

    def __init__(self, total: int):
        self.total = total
        self._left = total
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        with self._lock:
            if self._left <= 0:
                return False
            self._left -= 1
            return True


class RetryingBlockReader:
    """Re-reads one filesystem block until it is whole or hopeless (the
    ``RetryingBlockFetcher.java`` role): a missing file, a size short of
    the sender's manifest, a torn frame (``TruncatedBlockError``) or a
    checksum mismatch (``ChecksumError``) is retried with exponential
    backoff and deterministic jitter, each wait capped at
    ``attempt_timeout_s`` and the whole read bounded by the caller's
    ``deadline`` — then ``BlockFetchError``.  Stateless across calls."""

    RETRYABLE = (FileNotFoundError, EOFError, BlockFetchError,
                 wire.TruncatedBlockError, wire.ChecksumError)

    def __init__(self, max_retries: int = 3, retry_wait_s: float = 0.1,
                 attempt_timeout_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 on_retry: Optional[Callable[[str], None]] = None,
                 on_read: Optional[Callable[[int, float], None]] = None):
        self.max_retries = max_retries
        self.retry_wait_s = retry_wait_s
        self.attempt_timeout_s = attempt_timeout_s
        self._clock = clock
        self._sleep = sleep
        self._on_retry = on_retry
        self._on_read = on_read

    def _try_read(self, path: str, expect_size: Optional[int],
                  decode: Optional[Callable[[bytes], Any]] = None):
        size = os.path.getsize(path)          # FileNotFoundError retries
        if expect_size is not None and size != expect_size:
            raise BlockFetchError(
                path, 1, f"partial block: {size} of {expect_size} bytes")
        with open(path, "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        out = (decode or _decode_block)(data)
        if self._on_read is not None:
            self._on_read(len(data), time.perf_counter() - t0)
        return out

    def read(self, path: str, expect_size: Optional[int] = None,
             deadline: Optional[float] = None,
             decode: Optional[Callable[[bytes], Any]] = None,
             budget: Optional[_RetryBudget] = None):
        """Decoded payload of ``path``.  ``expect_size`` is the sender's
        manifested size (a mismatch is a partial write, retried);
        ``decode`` overrides the block decoder; ``budget`` is consumed one
        token per backoff sleep."""
        last: Optional[BaseException] = None
        attempt = 0
        for attempt in range(self.max_retries + 1):
            try:
                return self._try_read(path, expect_size, decode)
            except self.RETRYABLE as e:
                last = e
            except wire.WireFormatError as e:
                # bad magic/version in a full-length frame: not ours, and
                # no amount of re-reading fixes it
                raise BlockFetchError(path, attempt + 1, repr(e))
            if attempt >= self.max_retries:
                break
            if budget is not None and not budget.try_acquire():
                raise BlockFetchError(
                    path, attempt + 1,
                    f"shared retry budget exhausted "
                    f"({budget.total} total): {last!r}")
            wait = min(self.retry_wait_s * (2 ** attempt)
                       * _jitter(path, attempt), self.attempt_timeout_s)
            if deadline is not None:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                wait = min(wait, remaining)
            if self._on_retry is not None:
                self._on_retry(path)
            self._sleep(wait)
        raise BlockFetchError(path, attempt + 1, repr(last))


class HostShuffleService:
    """One process's end of the host shuffle: write, commit, barrier,
    fetch, plus the manifest-only coordination rounds the exchange lanes
    plan with (sizes, samples) and the reducer planners over them."""

    #: a reduce partition this many times the median is flagged skewed
    #: (spark.sql.adaptive.skewJoin.skewedPartitionFactor's default role)
    SKEW_FACTOR = 5.0

    def __init__(self, root: str, process_id: int, n_processes: int,
                 timeout_s: float = 120.0,
                 poll_s: float = 0.05,
                 conf: Optional[C.Conf] = None,
                 heartbeat=None,
                 host_names: Optional[Callable[[int], str]] = None,
                 max_retries: Optional[int] = None,
                 retry_wait_s: Optional[float] = None,
                 attempt_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 ledger=None):
        conf = conf or C.Conf()
        if not 0 <= int(process_id) < int(n_processes):
            raise ValueError(f"process id {process_id} is outside "
                             f"{n_processes} process(es)")
        self.root = root
        self.pid = int(process_id)
        self.n = int(n_processes)
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self.heartbeat = heartbeat
        self.blacklist_enabled = conf.get(C.SHUFFLE_BLACKLIST_ENABLED)
        self.refetch_enabled = conf.get(C.SHUFFLE_FETCH_RETRY_ENABLED)
        self.async_write = conf.get(C.SHUFFLE_IO_ASYNC_WRITE)
        self.fetch_threads = conf.get(C.SHUFFLE_IO_FETCH_THREADS)
        self.wire_codec = conf.get(C.SHUFFLE_WIRE_CODEC)
        self.wire_threshold = conf.get(C.SHUFFLE_WIRE_COMPRESS_THRESHOLD)
        self.dict_codes = conf.get(C.SHUFFLE_WIRE_DICT_CODES)
        self.run_codes = conf.get(C.SHUFFLE_WIRE_RUN_CODES)
        #: exchanges whose map output is presorted span slices (the range
        #: lane): the wire encoder tags their runs without its probe
        self._presorted_exchanges: set = set()
        #: exchanges consumed exactly once right after the hop (partial
        #: state into a final merge): they ship raw columns
        self._raw_exchanges: set = set()
        if host_names is None:
            from .cluster import default_host_name
            host_names = default_host_name
        self._host_names = host_names
        self._clock = clock
        self._sleep = sleep
        #: peer blacklist, pid → reason; persists across the exchanges of
        #: a session (the HealthTracker executor-exclusion analog)
        self.blacklist: Dict[int, str] = {}
        #: out-of-world host names already counted as ignored
        self._foreign_seen: set = set()
        self.counters: Dict[str, int] = {
            "exchanges": 0, "block_retries": 0, "blocks_lost": 0,
            "barrier_excluded": 0, "peers_blacklisted": 0,
            # heartbeat verdicts naming hosts OUTSIDE the exchange world
            # (pool tenants, late joiners): counted and ignored
            "foreign_hosts_ignored": 0,
            "fetch_failures": 0, "refetches": 0,
            "blocks_written": 0, "blocks_read": 0,
            "bytes_written": 0, "bytes_raw": 0, "bytes_read": 0,
            # produced = everything the map side handed to an exchange
            # (own partition included); shipped = what other processes got
            "rows_produced": 0, "rows_shipped": 0, "bytes_own_raw": 0,
            # reducer coordination: fine partitions merged into a
            # neighbor, skewed reduce partitions, range spans split,
            # sample-round manifest bytes
            "partitions_coalesced": 0, "partitions_skewed": 0,
            "spans_split": 0, "sample_bytes": 0,
            # execution shapes (crossproc_execute)
            "shuffled_joins": 0, "fast_path_aggs": 0,
            "range_merge_joins": 0, "broadcast_joins": 0,
            "generic_gathers": 0,
            # adaptive re-planning from observed exchange statistics
            "adaptive_replans": 0, "strategy_demotions": 0,
            "post_sample_skew_splits": 0, "stats_feedback_hits": 0,
            # dictionary codes on the wire: columns framed as codes with
            # a deduplicated sidecar, and receiver-side remaps
            "dict_columns_encoded": 0, "dict_bytes_saved": 0,
            "codes_remapped": 0,
            # run-length/delta columns on the wire and the bytes saved
            "rle_columns_encoded": 0, "run_bytes_saved": 0,
            # memory-pressure ladder: spill on either side of an exchange
            # and fetch workers that waited for in-flight room
            "spill_bytes": 0, "spill_events": 0,
            "fetch_backpressure_waits": 0, "retry_budget_exhausted": 0,
            # degraded mode past the exchange, and the elastic reducer plan
            "grace_buckets_used": 0, "grace_spill_bytes": 0,
            "grace_salted_resplits": 0,
            "reducers_planned": 0, "reducers_observed": 0,
            "reducers_elastic": 0,
        }
        #: reduce-partition byte sizes of the last reducer plan
        self.last_partition_bytes: Optional[List[int]] = None
        #: cut points of the last range exchange (int64 images or words)
        self.last_range_cutpoints: Optional[List[Any]] = None
        #: cumulative seconds per data-plane stage: encode/write on the
        #: writer thread, decode/fetch on the reader pool, and the
        #: caller's wait for the writer at commit
        self.timers: Dict[str, float] = {
            "encode_s": 0.0, "write_s": 0.0, "decode_s": 0.0,
            "fetch_s": 0.0, "commit_wait_s": 0.0, "barrier_s": 0.0,
        }
        #: the statement's leaf recipes from its digest round, sender →
        #: list (the lineage the recovery slice re-reads a lost leaf from)
        self.leaf_recipes: Dict[int, list] = {}
        #: pids every survivor agreed are lost: empty until the recovery
        #: slice brings the agreement round
        self.recovered_pids: set = set()
        self._lock = threading.Lock()
        if ledger is None:
            from ..memory import HostMemoryLedger
            ledger = HostMemoryLedger(conf)
        #: host-RAM reservations for exchange staging; sides that cannot
        #: reserve spill to disk through ``spill_write``
        self.ledger = ledger
        self._conf = conf
        self.max_inflight_bytes = conf.get(C.SHUFFLE_IO_MAX_INFLIGHT)
        self._gate = _InflightGate(self.max_inflight_bytes,
                                   on_wait=self._count_backpressure)
        self._reader = RetryingBlockReader(
            max_retries=(max_retries if max_retries is not None
                         else conf.get(C.SHUFFLE_IO_MAX_RETRIES)),
            retry_wait_s=(retry_wait_s if retry_wait_s is not None
                          else conf.get(C.SHUFFLE_IO_RETRY_WAIT_MS) / 1000.0),
            attempt_timeout_s=(
                attempt_timeout_s if attempt_timeout_s is not None
                else conf.get(C.SHUFFLE_IO_ATTEMPT_TIMEOUT_MS) / 1000.0),
            clock=clock, sleep=sleep, on_retry=self._count_retry,
            on_read=self._count_read)
        self._staged: Dict[str, Dict[int, int]] = {}
        #: sender side — every dictionary framed in an exchange's blocks,
        #: by fingerprint; written ONCE into a sidecar at commit()
        self._dict_refs: Dict[str, Dict[str, tuple]] = {}
        #: receiver side — (exchange, sender) → fingerprint → words
        self._dict_tables: Dict[Tuple[str, int], Dict[str, tuple]] = {}
        self._write_q: "queue.Queue[Optional[Tuple[str, int, List[ColumnBatch]]]]" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self._pending = 0
        self._drained = threading.Condition(self._lock)
        self._write_errors: List[BaseException] = []
        os.makedirs(root, exist_ok=True)

    @property
    def grace_buckets(self) -> int:
        """Grace fan-out, read LIVE from the conf so ``SET`` tunes a
        running service (0 = grace disabled)."""
        return int(self._conf.get(C.CROSSPROC_GRACE_BUCKETS))

    @property
    def spill_threshold(self) -> int:
        """Side bytes at or above which an exchange side stages to disk,
        read LIVE from the conf like ``grace_buckets`` (the reference
        reads it once, when the service is built: ROADMAP §3)."""
        return int(self._conf.get(C.SHUFFLE_SPILL_THRESHOLD))

    def _count_retry(self, _path: str) -> None:
        with self._lock:
            self.counters["block_retries"] += 1

    def _count_read(self, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.counters["blocks_read"] += 1
            self.counters["bytes_read"] += nbytes
            self.timers["decode_s"] += seconds

    def _count_backpressure(self) -> None:
        with self._lock:
            self.counters["fetch_backpressure_waits"] += 1

    def bump(self, name: str, n: int = 1) -> None:
        """Add ``n`` to a counter under the service lock."""
        with self._lock:
            self.counters[name] += n

    def host_name(self, pid: int) -> str:
        return self._host_names(pid)

    # -- paths -----------------------------------------------------------
    def _dir(self, exchange: str) -> str:
        return os.path.join(self.root, exchange)

    def _part(self, exchange: str, sender: int, receiver: int) -> str:
        return os.path.join(self._dir(exchange),
                            f"s{sender:04d}-r{receiver:04d}.part")

    def _done(self, exchange: str, sender: int) -> str:
        return os.path.join(self._dir(exchange), f"s{sender:04d}.done")

    def _dict_path(self, exchange: str, sender: int) -> str:
        return os.path.join(self._dir(exchange), f"s{sender:04d}.dict")

    def _check_unused(self, exchange: str) -> None:
        if os.path.exists(self._done(exchange, self.pid)):
            raise ValueError(
                f"host shuffle exchange id {exchange!r} was already used "
                "by this process; ids are single-use (stale commit "
                "markers would unblock the barrier early)")

    # -- write side ------------------------------------------------------
    def mark_presorted(self, exchange: str) -> None:
        """Declare ``exchange``'s map output presorted span slices: the
        wire encoder tags their runs directly (``run_hint``)."""
        with self._lock:
            self._presorted_exchanges.add(exchange)

    def mark_raw(self, exchange: str) -> None:
        """Declare ``exchange``'s payload read exactly once right after
        the hop: every encode site ships it as plain columns."""
        with self._lock:
            self._raw_exchanges.add(exchange)

    def _encode(self, exchange: str, batches: Sequence[ColumnBatch]
                ) -> Tuple[bytes, Dict[str, int]]:
        refs: Optional[Dict[str, tuple]] = None
        stats: Dict[str, int] = {}
        with self._lock:
            if self.dict_codes:
                refs = self._dict_refs.setdefault(exchange, {})
            run_codes = self.run_codes \
                and exchange not in self._raw_exchanges
            run_hint = exchange in self._presorted_exchanges
        # refs is mutated outside the lock: one exchange's blocks are
        # encoded by one thread (the writer loop, or the caller)
        buf = wire.encode_batches(
            list(batches), codec=self.wire_codec,
            compress_threshold=self.wire_threshold,
            dict_refs=refs, stats=stats, run_codes=run_codes,
            run_hint=run_hint)
        return buf, stats

    def _publish(self, path: str, buf: bytes) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(buf)
        os.replace(tmp, path)

    def _write_block(self, exchange: str, receiver: int,
                     batches: List[ColumnBatch]) -> None:
        """Encode and atomically publish one block; record its manifest
        size.  Runs on the writer thread when asyncWrite is on."""
        path = self._part(exchange, self.pid, receiver)
        t0 = time.perf_counter()
        buf, stats = self._encode(exchange, batches)
        t1 = time.perf_counter()
        self._publish(path, buf)
        t2 = time.perf_counter()
        with self._lock:
            self._staged.setdefault(exchange, {})[receiver] = len(buf)
            self.counters["blocks_written"] += 1
            self.counters["bytes_written"] += len(buf)
            self.counters["bytes_raw"] += wire.raw_nbytes(batches)
            self.counters["rows_shipped"] += sum(
                int(b.capacity) for b in batches)
            self.timers["encode_s"] += t1 - t0
            self.timers["write_s"] += t2 - t1
            for k, v in stats.items():
                self.counters[k] += v

    def _writer_loop(self) -> None:
        while True:
            item = self._write_q.get()
            if item is None:
                return
            exchange, receiver, batches = item
            try:
                self._write_block(exchange, receiver, batches)
            except BaseException as e:    # surfaced by the next flush()
                with self._lock:
                    self._write_errors.append(e)
            finally:
                with self._drained:
                    self._pending -= 1
                    if self._pending == 0:
                        self._drained.notify_all()

    def put(self, exchange: str, receiver: int,
            batches: Sequence[ColumnBatch]) -> None:
        """Stage this process's blocks for one receiver.  Batches come to
        the host and are TRIMMED first: padding rows never reach the
        exchange directory."""
        os.makedirs(self._dir(exchange), exist_ok=True)
        host = [wire.trim_host(b.to_host()) for b in batches]
        if self.async_write:
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop, daemon=True,
                    name=f"shuffle-writer-{self.pid}")
                self._writer.start()
            with self._drained:
                self._pending += 1
            self._write_q.put((exchange, receiver, host))
        else:
            self._write_block(exchange, receiver, host)

    def flush(self, exchange: Optional[str] = None) -> None:
        """Block until every queued write is on disk; re-raise the first
        writer failure (a sender must not commit a manifest naming blocks
        that never landed)."""
        with self._drained:
            while self._pending:
                self._drained.wait()
            if self._write_errors:
                err = self._write_errors[0]
                self._write_errors = []
                raise err

    def commit(self, exchange: str,
               extra: Optional[dict] = None) -> None:
        """All of this sender's blocks are published: write the marker
        with its manifest (receiver → block size), so readers tell a lost
        block from a sender that had nothing for them.  ``extra`` merges
        more JSON keys into the marker."""
        t0 = time.perf_counter()
        self.flush(exchange)
        with self._lock:
            self.timers["commit_wait_s"] += time.perf_counter() - t0
            staged = dict(self._staged.get(exchange, {}))
            refs = dict(self._dict_refs.get(exchange, {}))
        os.makedirs(self._dir(exchange), exist_ok=True)
        man = {"ts": time.time(),
               "host": self.host_name(self.pid),
               "blocks": {str(r): sz for r, sz in staged.items()}}
        if extra:
            man.update(extra)
        if refs:
            # the dictionary sidecar, published BEFORE the manifest that
            # names its size (the order data blocks rely on too)
            blob = wire.encode_dict_table(refs)
            self._publish(self._dict_path(exchange, self.pid), blob)
            man["dict_bytes"] = len(blob)
            with self._lock:
                self.counters["bytes_written"] += len(blob)
        path = self._done(exchange, self.pid)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(man, f)
        os.replace(tmp, path)

    # -- spill side (memory-pressure ladder) ----------------------------
    def spill_write(self, path: str, data: bytes, append: bool = False,
                    exchange: str = "") -> None:
        """The ONE primitive every spill byte goes through: write
        ``data`` to a local spill file and account it."""
        with open(path, "ab" if append else "wb") as f:
            f.write(data)
        with self._lock:
            self.counters["spill_bytes"] += len(data)
            self.counters["spill_events"] += 1

    def encode_frames(self, exchange: str,
                      batches: Sequence[ColumnBatch]) -> bytes:
        """Host batches as one wire frame under this exchange's
        dictionary refs: byte-identical to what ``_write_block`` would
        publish, so receivers cannot tell a spilled span from an
        in-memory one."""
        t0 = time.perf_counter()
        buf, stats = self._encode(exchange, batches)
        with self._lock:
            self.timers["encode_s"] += time.perf_counter() - t0
            for k, v in stats.items():
                self.counters[k] += v
        return buf

    def spill_map_partitions(self, exchange: str,
                             slices: Sequence[Optional[ColumnBatch]],
                             path: str) -> List[int]:
        """A side's partition slices spilled to ONE file, one frame per
        non-empty slice.  Returns byte ``offsets`` (``len(slices) + 1``):
        slice ``p`` is ``[offsets[p], offsets[p+1])``, so a CONTIGUOUS
        slice range is one contiguous byte span."""
        offsets = [0]
        for sl in slices:
            if sl is None or int(sl.capacity) == 0:
                offsets.append(offsets[-1])
                continue
            buf = self.encode_frames(exchange, [sl])
            self.spill_write(path, buf, append=os.path.exists(path),
                             exchange=exchange)
            offsets.append(offsets[-1] + len(buf))
        return offsets

    def _read_parts(self, spill_path: Optional[str], parts) -> bytes:
        """A receiver's parts concatenated: ``(start, length)`` ranges of
        ``spill_path`` and/or ready ``bytes`` frames, in order.  A short
        range is an ``OSError`` (the file is local and fully written)."""
        chunks: List[bytes] = []
        f = None
        try:
            for part in parts:
                if isinstance(part, (bytes, bytearray, memoryview)):
                    chunks.append(bytes(part))
                    continue
                start, length = part
                if length <= 0:
                    continue
                if f is None:
                    f = open(spill_path, "rb")
                f.seek(start)
                data = f.read(length)
                if len(data) != length:
                    raise OSError(
                        f"spill file {spill_path}: short read "
                        f"{len(data)} of {length} B at {start}")
                chunks.append(data)
        finally:
            if f is not None:
                f.close()
        return b"".join(chunks)

    def put_frames(self, exchange: str, receiver: int, parts,
                   spill_path: Optional[str], raw_bytes: int,
                   rows: int) -> None:
        """Publish one receiver's block STRAIGHT from spill-file byte
        spans (and ready frames): no decode, no re-encode.  ``raw_bytes``
        and ``rows`` carry the accounting ``_write_block`` derives from
        live batches."""
        os.makedirs(self._dir(exchange), exist_ok=True)
        path = self._part(exchange, self.pid, receiver)
        t0 = time.perf_counter()
        buf = self._read_parts(spill_path, parts)
        self._publish(path, buf)
        with self._lock:
            self._staged.setdefault(exchange, {})[receiver] = len(buf)
            self.counters["blocks_written"] += 1
            self.counters["bytes_written"] += len(buf)
            self.counters["bytes_raw"] += int(raw_bytes)
            self.counters["rows_shipped"] += int(rows)
            self.timers["write_s"] += time.perf_counter() - t0

    def read_manifest(self, exchange: str, sender: int) -> Optional[dict]:
        """The sender's commit manifest, or None when it is missing or
        does not parse."""
        try:
            with open(self._done(exchange, sender)) as f:
                man = json.load(f)
            return man if isinstance(man, dict) else None
        except (OSError, ValueError):
            return None

    # -- manifest-only coordination rounds ------------------------------
    def publish_manifest(self, exchange: str,
                         payload: Optional[dict] = None) -> int:
        """Manifest-ONLY commit: this sender's marker carrying a JSON
        ``payload`` and no blocks (the size round and the range sample
        round).  Returns the marker's byte size."""
        self._check_unused(exchange)
        os.makedirs(self._dir(exchange), exist_ok=True)
        doc = {"ts": time.time(), "host": self.host_name(self.pid),
               "blocks": {}}
        doc.update(payload or {})
        buf = json.dumps(doc)
        path = self._done(exchange, self.pid)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(buf)
        os.replace(tmp, path)
        return len(buf)

    def gather_manifests(self, exchange: str, strict: bool = False
                         ) -> Tuple[Dict[int, dict], int]:
        """Barrier on the commit markers, then every sender's manifest:
        ``(sender → manifest, total manifest bytes)``.  ``strict``
        (coordination rounds whose readers must agree) re-reads an
        unparseable marker until the deadline, then fails with
        ``ExchangeFetchFailed``; otherwise a lost manifest only loses its
        statistics."""
        t0 = self._clock()
        deadline = t0 + self.timeout_s
        excluded = set(self.barrier(exchange, deadline=deadline))
        out: Dict[int, dict] = {}
        nbytes = 0
        pending = [s for s in range(self.n) if s not in excluded]
        while True:
            still: List[int] = []
            for s in pending:
                man = self.read_manifest(exchange, s)
                if man is None:
                    still.append(s)
                    continue
                out[s] = man
                try:
                    nbytes += os.path.getsize(self._done(exchange, s))
                except OSError:
                    pass
            if not still or not strict:
                break
            if self._clock() >= deadline:
                self.bump("fetch_failures")
                raise ExchangeFetchFailed(
                    exchange,
                    [self.host_name(s) for s in still],
                    [os.path.basename(self._done(exchange, s))
                     for s in still],
                    elapsed_s=self._clock() - t0,
                    detail="unreadable commit manifests on a "
                           "coordination round")
            self._sleep(self.poll_s)
            pending = still
        return out, nbytes

    def publish_sizes(self, exchange: str, sizes: Dict[int, int],
                      extra: Optional[dict] = None) -> None:
        """Manifest-ONLY commit of this sender's per-fine-partition byte
        counts (the MapOutputStatistics half of the ExchangeCoordinator
        protocol); ``extra`` merges more keys into the same marker."""
        payload = {
            "partitions": {str(p): int(sz) for p, sz in sizes.items()}}
        if extra:
            payload.update(extra)
        self.publish_manifest(exchange, payload)

    def gather_sizes_ex(self, exchange: str, n_partitions: int
                        ) -> Tuple[np.ndarray, Dict[int, dict]]:
        """``gather_sizes`` plus the manifests it summed."""
        mans, _nbytes = self.gather_manifests(exchange)
        totals = np.zeros(n_partitions, np.int64)
        for man in mans.values():
            for p, sz in man.get("partitions", {}).items():
                if 0 <= int(p) < n_partitions:
                    totals[int(p)] += int(sz)
        return totals, mans

    def gather_sizes(self, exchange: str, n_partitions: int) -> np.ndarray:
        """Barrier on the size manifests and sum every sender's counts:
        every process reads the same set and computes the SAME totals, so
        ``plan_reducers`` needs no driver."""
        return self.gather_sizes_ex(exchange, n_partitions)[0]

    def plan_reducers(self, sizes: np.ndarray, target_bytes: int,
                      n_max: Optional[int] = None) -> List[int]:
        """Fine-partition → reducer assignment off the manifest totals
        (``ExchangeCoordinator.doEstimationIfNecessary`` analog).

        Returns contiguous group BOUNDS ``b`` (``b[0] = 0``, ``b[-1] =
        n_fine``); group ``g`` covers ``[b[g], b[g+1])`` and belongs to
        the g-th live process.  With a positive target, adjacent fine
        partitions accumulate until the target is reached (tiny
        neighbours coalesce, counted); with 0 the split is static and
        even.  ``n_max`` caps the width (the elastic plan).  Deterministic
        in its inputs."""
        sizes = np.asarray(sizes, np.int64)
        n_fine = len(sizes)
        n_live = len(self.live_pids())
        if n_max is not None:
            n_live = max(1, min(int(n_max), n_live))
        if target_bytes <= 0:
            bounds = sorted({round(g * n_fine / n_live)
                             for g in range(n_live + 1)})
            coalesced = 0
        else:
            bounds = [0]
            acc = 0
            coalesced = 0
            for i in range(n_fine):
                if i > bounds[-1]:           # current group is non-empty
                    if acc >= target_bytes and len(bounds) < n_live:
                        bounds.append(i)
                        acc = 0
                    elif acc < target_bytes:
                        coalesced += 1       # i merges into a tiny group
                acc += int(sizes[i])
            bounds.append(n_fine)
        group_bytes = [int(sizes[lo:hi].sum())
                       for lo, hi in zip(bounds, bounds[1:])]
        med = float(np.median(group_bytes)) if group_bytes else 0.0
        skewed = sum(1 for b in group_bytes
                     if med > 0 and b > self.SKEW_FACTOR * med)
        with self._lock:
            self.counters["partitions_coalesced"] += coalesced
            self.counters["partitions_skewed"] += skewed
            self.last_partition_bytes = group_bytes
        return bounds

    def skew_spans(self, totals: np.ndarray) -> set:
        """The spans of ``totals`` above ``SKEW_FACTOR`` × the median of
        the positive weights."""
        totals = np.asarray(totals, np.int64)
        pos = totals[totals > 0]
        med = float(np.median(pos)) if len(pos) else 0.0
        return {s for s in range(len(totals))
                if med > 0 and totals[s] > self.SKEW_FACTOR * med}

    def plan_range_reducers(self, probe_sizes: np.ndarray,
                            build_sizes: np.ndarray, target_bytes: int,
                            n_max: Optional[int] = None
                            ) -> List[List[int]]:
        """Key-span → reducer assignment of the RANGE exchange, with
        skew-span SPLITTING (the OptimizeSkewedJoin mitigation).

        Returns ``owners``: for each span, the processes that reduce it.
        A span above ``SKEW_FACTOR`` × median is split across ``k = min(n,
        ceil(total / target))`` owners — its probe rows divide among them
        while its build rows replicate to all k.  Other spans coalesce
        greedily into contiguous under-target runs; runs and split shares
        go to the least-loaded process in span order.  Deterministic."""
        probe = np.asarray(probe_sizes, np.int64)
        build = np.asarray(build_sizes, np.int64)
        totals = probe + build
        n_spans = len(totals)
        pos = totals[totals > 0]
        med = float(np.median(pos)) if len(pos) else 0.0
        split_target = float(target_bytes) if target_bytes > 0 \
            else max(med, 1.0)
        split_set = self.skew_spans(totals)

        work: List[Tuple[str, List[int]]] = []
        cur: List[int] = []
        acc = 0
        coalesced = 0
        for s in range(n_spans):
            if s in split_set:
                if cur:
                    work.append(("run", cur))
                    cur, acc = [], 0
                work.append(("split", [s]))
                continue
            if cur and (target_bytes <= 0 or acc >= target_bytes):
                work.append(("run", cur))
                cur, acc = [], 0
            elif cur:
                coalesced += 1
            cur.append(s)
            acc += int(totals[s])
        if cur:
            work.append(("run", cur))

        owners: List[List[int]] = [[] for _ in range(n_spans)]
        loads = [0] * self.n
        live = self.live_pids()
        if n_max is not None:        # elastic: the first n_max live pids
            live = live[:max(1, min(int(n_max), len(live)))]

        def least_loaded(k: int) -> List[int]:
            return sorted(live, key=lambda p: (loads[p], p))[:k]

        for kind, spans in work:
            if kind == "run":
                p = least_loaded(1)[0]
                for s in spans:
                    owners[s] = [p]
                loads[p] += int(sum(int(totals[s]) for s in spans))
            else:
                s = spans[0]
                k = int(min(len(live), max(
                    2, int(np.ceil(float(totals[s]) / split_target)))))
                ps = least_loaded(k)
                owners[s] = ps
                for p in ps:                 # probe split + build replica
                    loads[p] += int(probe[s]) // k + int(build[s])
        reducer_bytes = [b for b in loads if b > 0]
        with self._lock:
            self.counters["partitions_coalesced"] += coalesced
            self.counters["spans_split"] += len(split_set)
            self.last_partition_bytes = reducer_bytes or None
        return owners

    # -- barrier + read side --------------------------------------------
    def barrier(self, exchange: str,
                deadline: Optional[float] = None) -> List[int]:
        """Wait until every non-blacklisted sender committed.

        Returns the senders EXCLUDED: blacklisted peers with no marker (a
        dead peer that committed before dying counts as arrived — its
        blocks outlive it).  While waiting, a wired ``HeartbeatMonitor``
        turns confirmed-dead stragglers into exclusions; live but silent
        ones raise ``TimeoutError`` at the deadline."""
        t0 = time.perf_counter()
        if deadline is None:
            deadline = self._clock() + self.timeout_s
        try:
            while True:
                missing = [s for s in range(self.n)
                           if not os.path.exists(self._done(exchange, s))]
                waiting = [s for s in missing if s not in self.blacklist]
                if not waiting:
                    with self._lock:
                        self.counters["barrier_excluded"] += len(missing)
                    return missing
                if self.heartbeat is not None and self.blacklist_enabled:
                    dead = set(self.heartbeat.dead_hosts())
                    world = {self.host_name(s) for s in range(self.n)}
                    foreign = dead - world
                    if foreign:
                        with self._lock:
                            fresh = foreign - self._foreign_seen
                            self._foreign_seen |= fresh
                            self.counters["foreign_hosts_ignored"] += \
                                len(fresh)
                        dead &= world
                    for s in waiting:
                        if self.host_name(s) in dead:
                            self._blacklist_peer(
                                s, f"heartbeat-dead during {exchange!r}")
                if self._clock() >= deadline:
                    raise TimeoutError(
                        f"host shuffle {exchange!r}: senders {waiting} "
                        f"did not commit within {self.timeout_s}s — "
                        "aborting step")
                self._sleep(self.poll_s)
        finally:
            with self._lock:
                self.timers["barrier_s"] += time.perf_counter() - t0

    def _blacklist_peer(self, pid: int, reason: str) -> None:
        with self._lock:
            if pid in self.blacklist:
                return
            self.blacklist[pid] = reason
            self.counters["peers_blacklisted"] += 1

    def begin_statement(self) -> None:
        """Reset the per-statement state (the leaf recipes)."""
        self.leaf_recipes = {}

    def live_pids(self) -> List[int]:
        """The process ids every planning decision runs over: all but the
        agreed-lost.  A locally blacklisted peer stays in (planning must
        be a function of SHARED state, or processes diverge)."""
        return [p for p in range(self.n) if p not in self.recovered_pids]

    def group_owner(self, g: int) -> int:
        """Owner of hash-reducer group ``g``: the g-th live process."""
        return self.live_pids()[g]

    def _pool(self, n_tasks: int) -> ThreadPoolExecutor:
        return ThreadPoolExecutor(
            max_workers=max(1, min(self.fetch_threads, n_tasks)),
            thread_name_prefix=f"shuffle-fetch-{self.pid}")

    # -- dictionary sidecars ---------------------------------------------
    def _load_dict_table(self, exchange: str, sender: int,
                         deadline: Optional[float] = None
                         ) -> Dict[str, tuple]:
        """Fetch and cache one sender's dictionary sidecar, through the
        retrying reader (a sidecar is a block like any other)."""
        man = self.read_manifest(exchange, sender) or {}
        table = self._reader.read(
            self._dict_path(exchange, sender),
            expect_size=man.get("dict_bytes"), deadline=deadline,
            decode=wire.decode_dict_table)
        with self._lock:
            self._dict_tables[(exchange, sender)] = table
        return table

    def _decode_with_dicts(self, exchange: str, sender: int, data: bytes,
                           deadline: Optional[float] = None
                           ) -> List[ColumnBatch]:
        """Decode one block, resolving fingerprint-only dictionaries
        against the sender's cached sidecar (loaded at the first miss)."""
        with self._lock:
            table = self._dict_tables.get((exchange, sender))
        try:
            return _decode_block(data, table)
        except wire.DictFingerprintError:
            table = self._load_dict_table(exchange, sender, deadline)
            return _decode_block(data, table)

    def collect(self, exchange: str,
                receiver: Optional[int] = None) -> List[ColumnBatch]:
        """Every block addressed to ``receiver`` (default: this process)
        in sender order; missing blocks are skipped (``exchange`` /
        ``refetch`` detect loss from the manifests)."""
        r = self.pid if receiver is None else receiver
        work = [(s, p) for s in range(self.n)
                if os.path.exists(p := self._part(exchange, s, r))]
        if not work:
            return []

        def read_one(item: Tuple[int, str]) -> List[ColumnBatch]:
            s, path = item
            with open(path, "rb") as f:
                data = f.read()
            t0 = time.perf_counter()
            out = self._decode_with_dicts(exchange, s, data)
            self._count_read(len(data), time.perf_counter() - t0)
            return out

        out: List[ColumnBatch] = []
        with self._pool(len(work)) as pool:
            for batches in pool.map(read_one, work):
                out.extend(batches)
        return out

    def _fetch_remote(self, exchange: str, t0: float,
                      sink=None) -> List[ColumnBatch]:
        """One bounded fetch attempt: barrier, then manifest-driven reads
        with per-block retry, concurrently across senders.  Raises
        ``ExchangeFetchFailed`` naming every lost host and block; the
        whole attempt shares ONE ``timeout_s`` deadline.  With a
        ``FetchSink`` the decoded batches land there (the return value is
        then empty)."""
        deadline = self._clock() + self.timeout_s
        excluded = set(self.barrier(exchange, deadline=deadline))
        lost_hosts: List[str] = []
        lost_blocks: List[str] = []
        #: (sender, path, manifested size, host name)
        work: List[Tuple[int, str, Optional[int], str]] = []
        for s in range(self.n):
            if s == self.pid:
                continue
            path = self._part(exchange, s, self.pid)
            if s in excluded:
                lost_hosts.append(self.host_name(s))
                lost_blocks.append(os.path.basename(path))
                continue
            man = self.read_manifest(exchange, s)
            if man is None:
                # a marker without a manifest: read what is there, unsized
                if os.path.exists(path):
                    work.append((s, path, None, self.host_name(s)))
                continue
            size = man.get("blocks", {}).get(str(self.pid))
            if size is None:
                continue                         # sender had nothing for us
            work.append((s, path, size, man.get("host", self.host_name(s))))

        results: Dict[int, List[ColumnBatch]] = {}
        if work:
            tf0 = time.perf_counter()
            budgets = {s: _RetryBudget(self._reader.max_retries)
                       for s, _p, _sz, _h in work}

            def fetch_one(item):
                s, path, size, _host = item
                held = int(size or 0)
                self._gate.acquire(held)
                try:
                    batches = self._reader.read(
                        path, expect_size=size, deadline=deadline,
                        decode=lambda d, s=s: self._decode_with_dicts(
                            exchange, s, d, deadline),
                        budget=budgets[s])
                    if sink is not None:
                        sink.add(s, batches)
                        batches = []
                finally:
                    self._gate.release(held)
                return s, batches

            with self._pool(len(work)) as pool:
                futures = [pool.submit(fetch_one, item) for item in work]
                for item, fut in zip(work, futures):
                    try:
                        s, batches = fut.result()
                        results[s] = batches
                    except BlockFetchError as e:
                        if "retry budget exhausted" in e.reason:
                            self.bump("retry_budget_exhausted")
                        lost_hosts.append(item[3])
                        lost_blocks.append(os.path.basename(item[1]))
            with self._lock:
                self.timers["fetch_s"] += time.perf_counter() - tf0
        if lost_blocks:
            with self._lock:
                self.counters["blocks_lost"] += len(lost_blocks)
                self.counters["fetch_failures"] += 1
            raise ExchangeFetchFailed(
                exchange, lost_hosts, lost_blocks,
                elapsed_s=self._clock() - t0,
                detail="blacklisted peers "
                       f"{sorted(self.blacklist)}" if self.blacklist
                       else "no peers blacklisted")
        out: List[ColumnBatch] = []
        for s in sorted(results):                # sender order, always
            out.extend(results[s])
        return out

    def _own(self, per_receiver: Dict[int, Sequence[ColumnBatch]]
             ) -> List[ColumnBatch]:
        """This process's own partition, trimmed exactly like every
        published block (so replicated-leaf digests agree between the
        local copy and a peer's round-tripped one)."""
        return [wire.trim_host(b.to_host())
                for b in per_receiver.get(self.pid, [])]

    def unify_code_space(self, batches: List[ColumnBatch]
                         ) -> List[ColumnBatch]:
        """Per-sender dictionaries merged into ONE sorted dictionary per
        column, every batch's codes remapped into it (monotone remaps: a
        block its sender sorted stays sorted).  Untouched when the senders
        already share one dictionary."""
        merged_by_name: Dict[str, tuple] = {}
        for name in {n for b in batches for n, v in zip(b.names, b.vectors)
                     if v.dictionary is not None}:
            dicts = {b.column(name).dictionary for b in batches
                     if name in b and b.column(name).dictionary is not None}
            if len(dicts) > 1:
                merged_by_name[name] = tuple(sorted(set().union(*dicts)))
        if not merged_by_name:
            return batches
        remaps: Dict[Tuple[str, tuple], np.ndarray] = {}
        out: List[ColumnBatch] = []
        n_remapped = 0
        for b in batches:
            vectors = list(b.vectors)
            changed = False
            for i, (name, v) in enumerate(zip(b.names, b.vectors)):
                merged = merged_by_name.get(name)
                if (merged is None or v.dictionary is None
                        or v.dictionary == merged):
                    continue
                key = (name, v.dictionary)
                rm = remaps.get(key)
                if rm is None:
                    pos = {w: j for j, w in enumerate(merged)}
                    rm = np.asarray([pos[w] for w in v.dictionary],
                                    np.int32)
                    remaps[key] = rm
                vectors[i] = ColumnVector(remap_codes(v.data, rm), v.dtype,
                                          v.valid, merged)
                n_remapped += int(v.data.shape[0])
                changed = True
            out.append(ColumnBatch(b.names, vectors, b.row_valid,
                                   b.capacity) if changed else b)
        if n_remapped:
            self.bump("codes_remapped", n_remapped)
        return out

    def _gather(self, exchange: str, own: List[ColumnBatch], t0: float,
                sink=None) -> List[ColumnBatch]:
        """The read tail of every exchange shape: fetch remote blocks
        (optionally into a ``FetchSink``), then unify code spaces over
        own-first, sorted-sender batches."""
        if sink is not None:
            sink.add(-1, own)           # own partition sorts first
            self._fetch_remote(exchange, t0, sink=sink)
            return self.unify_code_space(sink.drain())
        remote = self._fetch_remote(exchange, t0)
        return self.unify_code_space(own + remote)

    def exchange(self, exchange: str,
                 per_receiver: Dict[int, Sequence[ColumnBatch]],
                 sink=None, extra: Optional[dict] = None
                 ) -> List[ColumnBatch]:
        """One full all-to-all hop: publish, commit, barrier, collect.
        Exchange ids are SINGLE-USE; the caller cleans the directory up
        once every participant is done."""
        self._check_unused(exchange)
        t0 = self._clock()
        own = self._own(per_receiver)
        with self._lock:
            self.counters["exchanges"] += 1
            self.counters["rows_produced"] += sum(
                int(b.capacity) for b in own) + sum(
                _live_rows(b) for r, bs in per_receiver.items()
                if r != self.pid for b in bs)
            self.counters["bytes_own_raw"] += wire.raw_nbytes(own)
        for r, batches in per_receiver.items():
            if r != self.pid:      # the own partition never touches disk
                self.put(exchange, r, batches)
        self.commit(exchange, extra=extra)
        return self._gather(exchange, own, t0, sink=sink)

    def exchange_spilled(self, exchange: str, spill_path: str,
                         routed: Dict[int, list],
                         meta: Dict[int, Tuple[int, int]],
                         sink=None) -> List[ColumnBatch]:
        """``exchange`` for a side whose map output lives in a spill
        file: each receiver's block is byte-span parts of ``spill_path``
        (``spill_map_partitions``) published by ``put_frames``.
        ``meta[r] = (raw_bytes, rows)``; the own partition decodes from
        the file here."""
        self._check_unused(exchange)
        t0 = self._clock()
        own = self._decode_spilled_own(exchange, spill_path, routed)
        with self._lock:
            self.counters["exchanges"] += 1
            self.counters["rows_produced"] += sum(
                int(b.capacity) for b in own) + sum(
                int(meta.get(r, (0, 0))[1]) for r in routed
                if r != self.pid)
            self.counters["bytes_own_raw"] += wire.raw_nbytes(own)
        for r, parts in routed.items():
            if r != self.pid:
                raw, rows = meta.get(r, (0, 0))
                self.put_frames(exchange, r, parts, spill_path, raw, rows)
        self.commit(exchange)
        return self._gather(exchange, own, t0, sink=sink)

    def decode_spilled(self, exchange: str, spill_path: Optional[str],
                       parts) -> List[ColumnBatch]:
        """Decode spill-file parts this process encoded itself; the
        exchange's dictionary refs are the decoder's fingerprint table."""
        with self._lock:
            table = dict(self._dict_refs.get(exchange) or {}) or None
        return wire.decode_frames(self._read_parts(spill_path, parts),
                                  dict_table=table)

    def _decode_spilled_own(self, exchange: str, spill_path: str,
                            routed: Dict[int, list]) -> List[ColumnBatch]:
        parts = routed.get(self.pid) or []
        if not parts:
            return []
        return self.decode_spilled(exchange, spill_path, parts)

    def refetch(self, exchange: str,
                per_receiver: Optional[Dict[int, Sequence[ColumnBatch]]]
                = None, sink=None) -> List[ColumnBatch]:
        """ONE more fetch attempt after an ``ExchangeFetchFailed``: a
        fresh barrier and read under a fresh ``timeout_s`` deadline (so
        exchange + refetch ≤ 2× the bound).  A peer that committed before
        dying is recovered here.  Nothing is re-put."""
        if not self.refetch_enabled:
            raise ExchangeFetchFailed(
                exchange, [], [], detail="refetch disabled by "
                f"{C.SHUFFLE_FETCH_RETRY_ENABLED.key}")
        self.bump("refetches")
        own = self._own(per_receiver or {})
        return self._gather(exchange, own, self._clock(), sink=sink)

    def refetch_spilled(self, exchange: str, spill_path: str,
                        routed: Dict[int, list],
                        sink=None) -> List[ColumnBatch]:
        """``refetch`` for a spilled map side."""
        if not self.refetch_enabled:
            raise ExchangeFetchFailed(
                exchange, [], [], detail="refetch disabled by "
                f"{C.SHUFFLE_FETCH_RETRY_ENABLED.key}")
        self.bump("refetches")
        own = self._decode_spilled_own(exchange, spill_path, routed)
        return self._gather(exchange, own, self._clock(), sink=sink)

    # -- observability ---------------------------------------------------
    def metrics_source(self):
        """The ``shuffle`` gauges for ``metrics.MetricsSystem``: counters,
        byte volumes, the wire compression ratio, per-stage seconds, the
        blacklist and the host ledger's peak against its budget."""
        from ..metrics import Source
        gauges = {k: (lambda k=k: self.counters[k]) for k in self.counters}
        for k in self.timers:
            gauges[k] = (lambda k=k: round(self.timers[k], 4))
        gauges["compression_ratio"] = lambda: round(
            self.counters["bytes_raw"]
            / max(1, self.counters["bytes_written"]), 3)
        gauges["bytes_produced_raw"] = lambda: (
            self.counters["bytes_raw"] + self.counters["bytes_own_raw"])
        gauges["bytes_shipped_raw"] = lambda: self.counters["bytes_raw"]
        gauges["ship_fraction"] = lambda: round(
            self.counters["bytes_raw"]
            / max(1, self.counters["bytes_raw"]
                  + self.counters["bytes_own_raw"]), 3)
        gauges["partition_bytes_max"] = lambda: (
            max(self.last_partition_bytes)
            if self.last_partition_bytes else 0)
        gauges["partition_bytes_median"] = lambda: (
            int(np.median(self.last_partition_bytes))
            if self.last_partition_bytes else 0)
        gauges["range_cutpoints"] = lambda: (
            len(self.last_range_cutpoints)
            if self.last_range_cutpoints is not None else 0)
        gauges["blacklisted_peers"] = lambda: len(self.blacklist)
        gauges["blacklist"] = lambda: ",".join(
            self.host_name(p) for p in sorted(self.blacklist)) or ""
        gauges["peak_host_bytes"] = lambda: int(self.ledger.peak)
        gauges["host_budget_bytes"] = lambda: int(self.ledger.budget)
        return Source("shuffle", gauges)

    def cleanup(self, exchange: str) -> None:
        try:
            self.flush(exchange)       # a late writer must not re-create
        except Exception:              # files after the rmdir below (its
            pass                       # failure was the exchange's)
        d = self._dir(exchange)
        with self._lock:
            self._staged.pop(exchange, None)
            self._dict_refs.pop(exchange, None)
            self._presorted_exchanges.discard(exchange)
            self._raw_exchanges.discard(exchange)
            for key in [k for k in self._dict_tables if k[0] == exchange]:
                del self._dict_tables[key]
        try:
            for name in os.listdir(d):
                try:
                    os.remove(os.path.join(d, name))
                except OSError:
                    pass
            os.rmdir(d)
        except OSError:
            pass
