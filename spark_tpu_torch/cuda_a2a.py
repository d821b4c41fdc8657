"""All-to-all exchange (kernel K2): the Pallas direct all-to-all of the
JAX package, written in CUDA C++ for Hopper.

``all_to_all(planes)`` takes, per plane ``k``, every participant's send
buffer ``planes[k][s]`` of shape ``(n, cap, ...)`` (row ``d`` bound for
participant ``d``) and returns per plane one ``(n, n, cap, ...)`` tensor
``out[k]`` with ``out[k][d][s] = planes[k][s][d]``: participant ``d``'s
received buffer is ``out[k][d]``.  That is ``lax.all_to_all(x,
split_axis=0, concat_axis=0, tiled=True)`` over the mesh axis, and what
``spark_tpu/parallel/ici.py`` ``_pallas_a2a`` does, self block included.
With ``gather=True`` each ``planes[k][s]`` is one ``(cap, ...)`` buffer
sent whole to every participant: ``out[k][d][s] = planes[k][s]`` (the
tiled ``all_gather``).

Across processes (the device tier, ``parallel/ici.py``) a receiver
PULLS with a kernel of its own, ``pull_kernel`` in the same source:
``pull(sources, outs, nbytes)`` copies, per plane ``k``, ``nbytes[k]``
bytes from device address ``sources[k][s]`` (a slot of sender ``s``'s
arena, mapped from another process by CUDA IPC) into row ``s`` of
``outs[k]``: one launch for every plane and sender.  Persistent blocks
move the bytes through a ring of shared-memory stages with the Tensor
Memory Accelerator; ``pull_plan`` is its division of work (segments,
their 16-byte aligned bodies and the heads and tails peeled off them,
items per block), which the kernel follows.  Its plain version,
``pull_plain``, stacks CPU tensors (the arena of a CPU session is a
shared-memory file).  The arena itself (``Arena``) is one ``cudaMalloc``
allocation of the kernel's library, exported and mapped by the library's
IPC entry points.

Within one process the participants live on one card or on several
cards of one host.  On one card ``all_to_all`` launches
``csrc/all_to_all.cu`` once for all planes, their pointers in a table
passed as a kernel parameter — built with ``nvcc`` at first use into
``build/kernels/`` and bound with ctypes — or raises; on CPU tensors it
runs the plain PyTorch version (one ``torch.stack`` per plane).  On
several cards ``all_to_all_cards`` makes one exchange as ONE launch of
``exchange_kernel`` on every card's stream, with the table
``a2a_card_plan`` cuts for that card: its receivers' copy items (its
senders' buffers read where they are, over NVLink) and the order across
cards that the Pallas kernel's barrier semaphore gave — the card arrives,
each item waits for its own sender's card only, and the launch ends once
every card reading this card's sources is done.  A card with no
receivers (the gathers to card 0) launches with no copy items: it
arrives and waits.  Peer access between every pair of the cards is
enabled first (``enable_peer_access``), or the call raises naming the
pair; a wait that times out raises at the next exchange or
``check_barriers``.  ``barrier`` (``barrier_kernel``) is the separate
barrier an exchange once took before and after its copy, kept to time
that order against this one.  There is no fallback from one to the
other: no host-staged copy, no CPU.

A mesh query's stage-cache entry captures its exchanges into a CUDA
graph, which freezes each launch's pointer table.  That is right only
because every pointer in it is to memory whose address a replay finds
unchanged — the entry's static buffers, its record's constants, its
graph pool — and the wrapper raises under a capture on any other
(``CAPTURE_SOURCES``).  A replay launches the kernel without calling the
wrapper: the stage cache counts those launches (``REPLAYED_LAUNCHES``).
"""

from __future__ import annotations

import ctypes
import os
import threading
from array import array
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build

#: bytes one CUDA block copies (the kernel's kChunk)
CHUNK_BYTES = 64 * 1024

#: int64 entries of the largest pointer table one launch takes (the
#: kernel's kMaxEntries): P planes of n participants need P*(n+4)+1
MAX_TABLE_ENTRIES = 4088

#: kernel launches so far (a plain count: ``chip_smoke.py`` zeroes it and
#: reads it around the main path to show the path went through the
#: kernel).  A launch made while a CUDA graph is captured (a mesh query's
#: stage-cache entry) counts here and in ``CAPTURED_LAUNCHES``; the
#: graph's replays launch the kernel without the wrapper, and the stage
#: cache adds each replayed graph's captured launches to
#: ``REPLAYED_LAUNCHES``
LAUNCHES = 0
CAPTURED_LAUNCHES = 0
REPLAYED_LAUNCHES = 0

#: the same counts per card (keyed by the card's device index), launches
#: with copy items only; ``*_BARRIERS`` count the cross-card exchanges'
#: arrive-and-wait launches (a card with no receivers) the same way
CARD_LAUNCHES: Counter = Counter()
CARD_CAPTURED: Counter = Counter()
CARD_REPLAYED: Counter = Counter()
CARD_BARRIERS: Counter = Counter()
CARD_CAPTURED_BARRIERS: Counter = Counter()
CARD_REPLAYED_BARRIERS: Counter = Counter()

#: a wait for a peer card (an arrival, a peer done reading, a barrier)
#: that took this long gives up and sets its card's error word (the
#: wrapper raises on it)
BARRIER_TIMEOUT_S = 20.0

#: int64 entries of the order across cards before its per-sender and
#: per-card ones (the kernel's kCrossHead)
CROSS_HEAD = 5

#: set by the stage cache while it captures a mesh entry: ``fn(ptr)`` is
#: True for an address a replay finds unchanged (the entry's static
#: buffers, its record's constants, its graph pool).  A capture freezes
#: the pointer table into the graph, so a capture without it, or one that
#: meets another address, raises
CAPTURE_SOURCES = None

#: cross-process pull launches so far (``pull``), counted apart from the
#: in-process exchanges of ``LAUNCHES``
PULL_LAUNCHES = 0

#: the pull kernel's launch (``tools/k2_pull_sweep.py`` chose them on an
#: H100): shared-memory ring stages of PULL_STAGE_BYTES (a multiple of
#: 16; one work item of a segment's body each), and the persistent
#: blocks on each SM
PULL_STAGES = 2
PULL_STAGE_BYTES = 16 * 1024
PULL_BLOCKS_PER_SM = 4

SOURCE = os.path.join(cuda_build.CSRC, "all_to_all.cu")


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {
        "spark_all_to_all": [vp, i, i, i, ll, vp],
        "spark_all_to_all_part": [vp, i, i, i, i, i, i, ll, vp],
        "spark_enable_peer_access": [i, i],
        "spark_barrier_max_cards": [],
        "spark_barrier_alloc": [i, ctypes.POINTER(vp)],
        "spark_barrier_reset": [i, vp],
        "spark_barrier_read": [i, vp, vp],
        "spark_barrier_error_words": [i, ctypes.POINTER(vp)],
        "spark_barrier": [vp, i, i, vp, ll, vp],
        "spark_barrier_state_bytes": [],
        "spark_exchange_part": [vp, i, i, i, i, i, i, ll, vp],
        "spark_flag_pingpong": [vp, vp, vp, vp, i, ll, vp],
        "spark_a2a_pull": [vp, i, i, i, ll, i, i, i, i, vp],
        "spark_ipc_handle_bytes": [],
        "spark_ipc_alloc": [i, ll, ctypes.POINTER(vp)],
        "spark_ipc_free": [i, vp],
        "spark_ipc_get_handle": [i, vp, ctypes.c_char_p],
        "spark_ipc_open": [i, ctypes.c_char_p, ctypes.POINTER(vp)],
        "spark_ipc_close": [i, vp],
        "spark_ipc_copy": [i, vp, vp, ll, vp],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int


def _check(planes: Sequence[Sequence[torch.Tensor]], gather: bool,
           one_device: bool = True) -> int:
    """Validate the plane table; returns the participant count n.  With
    ``one_device`` False participant s may be on its own device (every
    plane's participant s on the same one)."""
    if not planes:
        raise ValueError("all_to_all: no planes")
    n = len(planes[0])
    if n < 1:
        raise ValueError("all_to_all: no participants")
    device = planes[0][0].device
    for k, shards in enumerate(planes):
        if len(shards) != n:
            raise ValueError(f"all_to_all: plane {k} has {len(shards)} "
                             f"participants, plane 0 has {n}")
        head = shards[0]
        for s, x in enumerate(shards):
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"all_to_all: plane {k} participant {s} is "
                                f"not a tensor")
            want = device if one_device else planes[0][s].device
            if x.device != want:
                raise ValueError(f"all_to_all: plane {k} participant {s} is "
                                 f"on {x.device}, plane 0's on {want}")
            if x.dtype != head.dtype or x.shape != head.shape:
                raise ValueError(
                    f"all_to_all: plane {k} participant {s} is "
                    f"{x.dtype}{tuple(x.shape)}, participant 0 is "
                    f"{head.dtype}{tuple(head.shape)}")
            if not x.is_contiguous():
                raise ValueError(f"all_to_all: plane {k} participant {s} is "
                                 f"not contiguous")
        if not gather and (head.dim() < 1 or head.shape[0] != n):
            raise ValueError(f"all_to_all: plane {k} has shape "
                             f"{tuple(head.shape)}; its leading dimension "
                             f"must be the participant count {n}")
    return n


def all_to_all_plain(planes: Sequence[Sequence[torch.Tensor]],
                     gather: bool = False,
                     card_of: Optional[Sequence[int]] = None,
                     devices: Optional[Sequence[torch.device]] = None,
                     receivers: Optional[range] = None):
    """Plain PyTorch version: ``stack`` over senders puts block ``[d][s]``
    where the exchange puts it.

    The cross-device form (``card_of``: participant s's card, ``devices``:
    each card's device; ``receivers``: the receiving participants, all by
    default) returns per card, per plane, what ``all_to_all_cards``
    returns: the ``(n_dst, n, ...)`` blocks of the card's receivers, each
    block ``.to()`` its receiver's device, or None for a card with no
    receiver."""
    if card_of is not None:
        n = len(planes[0])
        out = []
        for c, dev in enumerate(devices):
            d0, n_dst = card_receivers(card_of, c, receivers)
            if not n_dst:
                out.append(None)
                continue
            if gather:
                out.append([torch.stack([x.to(dev) for x in shards])
                            .unsqueeze(0)
                            .expand((n_dst, n) + tuple(shards[0].shape))
                            .contiguous() for shards in planes])
            else:
                out.append([torch.stack([x[d0:d0 + n_dst].to(dev)
                                         for x in shards], dim=1)
                            for shards in planes])
        return out
    if gather:
        n = len(planes[0])
        return [torch.stack(list(shards)).unsqueeze(0)
                .expand((n,) + (n,) + tuple(shards[0].shape)).contiguous()
                for shards in planes]
    return [torch.stack(list(shards), dim=1) for shards in planes]


def all_to_all(planes: Sequence[Sequence[torch.Tensor]],
               gather: bool = False) -> List[torch.Tensor]:
    """Exchange every plane among the n participants in one launch; see
    the module docstring.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    global LAUNCHES, CAPTURED_LAUNCHES
    n = _check(planes, gather)
    device = planes[0][0].device
    if device.type == "cpu":
        return all_to_all_plain(planes, gather)
    if device.type != "cuda":
        raise ValueError(f"all_to_all: unsupported device {device}")
    outs, src, dst, nbytes, stride, first = [], [], [], [], [], [0]
    for shards in planes:
        head = shards[0]
        lead = (n, n) if gather else (n,)
        out = torch.empty(lead + tuple(head.shape), dtype=head.dtype,
                          device=device)
        outs.append(out)
        bb = head.numel() * head.element_size() // (1 if gather else n)
        src += [x.data_ptr() for x in shards]
        dst.append(out.data_ptr())
        nbytes.append(bb)
        stride.append(0 if gather else bb)
        first.append(first[-1] + n * n * (-(-bb // CHUNK_BYTES)))
    total = first[-1]
    if total == 0:
        return outs
    entries = src + dst + nbytes + stride + first
    if len(entries) > MAX_TABLE_ENTRIES:
        raise ValueError(f"all_to_all: {len(planes)} planes of {n} "
                         f"participants need {len(entries)} table entries; "
                         f"one launch takes {MAX_TABLE_ENTRIES}")
    capturing = torch.cuda.is_current_stream_capturing()
    if capturing:
        _check_captured_pointers(src + dst)
    table = (ctypes.c_longlong * len(entries))(*entries)
    lib = cuda_build.load(SOURCE, _bind)
    with torch.cuda.device(device):      # the launch uses the current card
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.spark_all_to_all(table, len(entries), len(planes), n, total,
                                  stream)
    if rc != 0:
        raise RuntimeError(f"all_to_all kernel failed: CUDA error {rc} "
                           f"(planes={len(planes)}, n={n}, items={total})")
    LAUNCHES += 1
    if capturing:
        CAPTURED_LAUNCHES += 1
    return outs


# ---------------------------------------------------------------------------
# across cards: the per-card plan, peer access, the barrier
# ---------------------------------------------------------------------------

def card_receivers(card_of: Sequence[int], card: int,
                   receivers: Optional[range] = None) -> Tuple[int, int]:
    """(d0, n_dst): the receivers on ``card`` — a contiguous range of
    participants, as the mesh places them — within ``receivers``."""
    mine = [d for d, c in enumerate(card_of) if c == card
            and (receivers is None or d in receivers)]
    if not mine:
        return 0, 0
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(f"all_to_all: card {card}'s participants {mine} "
                         "are not contiguous")
    return mine[0], len(mine)


def first_sender(n: int, d0: int, n_dst: int) -> int:
    """The sender a card's launch starts from: its own first (a card's
    senders are its receivers, ``d0 ..``), then the next card's, and so
    on, so that at any moment the cards read from different senders (see
    ``all_to_all_kernel``), and a card's first items wait for no other
    card's arrival (``exchange_kernel``)."""
    return d0 % n


def a2a_card_plan(src: Sequence[Sequence[int]],
                  dst: Sequence[Sequence[Optional[int]]],
                  nbytes: Sequence[int], stride: Sequence[int],
                  card_of: Sequence[int],
                  receivers: Optional[range] = None,
                  cross: Optional[Tuple[Sequence[int], Sequence[int], int]]
                  = None) -> List[Tuple[int, int, List[int], int]]:
    """Each card's launch: per card ``c``, ``(d0, n_dst, table, total)`` —
    its receivers ``d0 .. d0 + n_dst - 1``, its int64 table (laid out as
    in ``csrc/all_to_all.cu``) and its number of work items (0: the card
    copies nothing); the launch takes its senders from
    ``first_sender(n, d0, n_dst)`` on.

    ``src[k][s]`` is sender s's buffer of plane k (any card), ``dst[c][k]``
    card c's output of plane k (``(n_dst, n, ...)`` on card c),
    ``nbytes[k]`` one block's bytes and ``stride[k]`` the source stride
    over receivers (``nbytes[k]``, or 0 in the gather form).  Block
    ``(k, s, d)`` goes to card ``card_of[d]`` alone.

    Without ``cross`` the table is ``all_to_all_kernel``'s copy part.
    With ``cross = (states, errors, timeout_ns)`` — each card's
    ``BarrierState`` address and error word address, by card, and the
    time limit of a wait — it is ``exchange_kernel``'s: the copy part,
    then the order across cards: the number of cards, this card's rank,
    its error word, the readers (bit c set when card c has receivers),
    the limit, each sender's card and every card's state.  Every card
    keeps its table then, a card without receivers one with no copy
    items (an arrive-and-wait launch)."""
    n = len(card_of)
    P = len(nbytes)
    n_cards = max(card_of) + 1
    ranges = [card_receivers(card_of, c, receivers) for c in range(n_cards)]
    readers = sum(1 << c for c, (_d0, n_dst) in enumerate(ranges) if n_dst)
    out = []
    for c, (d0, n_dst) in enumerate(ranges):
        first = [0]
        for bb in nbytes:
            first.append(first[-1] + n * n_dst * (-(-bb // CHUNK_BYTES)))
        table = [p for plane in src for p in plane]
        table += [dst[c][k] if n_dst else 0 for k in range(P)]
        table += list(nbytes) + list(stride) + first
        if cross is not None:
            states, errors, timeout_ns = cross
            table += [n_cards, c, errors[c], readers, timeout_ns]
            table += list(card_of) + list(states)
        if len(table) > MAX_TABLE_ENTRIES:
            raise ValueError(f"all_to_all: {P} planes of {n} participants "
                             f"need {len(table)} table entries; one launch "
                             f"takes {MAX_TABLE_ENTRIES}")
        out.append((d0, n_dst, table, first[-1] if n_dst else 0))
    return out


def a2a_table_blocks(table: Sequence[int], P: int, n: int, d0: int,
                     n_dst: int, rot: int = 0,
                     interleave: bool = False) -> List[tuple]:
    """What one card's launch copies, in its order of work items, decoded
    as ``all_to_all_kernel`` decodes its table (or, with ``interleave``,
    ``exchange_kernel``: a plane's items chunk by chunk, each chunk's
    receiver by receiver and sender by sender), its senders taken from
    ``rot`` on: per work item ``(plane, sender, receiver, source address,
    destination address, bytes)``."""
    src_ptr = table[:P * n]
    dst_ptr = table[P * n:P * n + P]
    bbs = table[P * n + P:P * n + 2 * P]
    stride = table[P * n + 2 * P:P * n + 3 * P]
    first = table[P * n + 3 * P:P * n + 4 * P + 1]
    out = []
    for item in range(first[P]):
        k = 0
        while k + 1 < P and first[k + 1] <= item:
            k += 1
        bb = bbs[k]
        per = -(-bb // CHUNK_BYTES)
        local = item - first[k]
        if interleave:
            ch, rest = divmod(local, n * n_dst)
            r, i = divmod(rest, n)
        else:
            blk, ch = divmod(local, per)
            i, r = divmod(blk, n_dst)
        s = (i + rot) % n
        off = ch * CHUNK_BYTES
        out.append((k, s, d0 + r,
                    src_ptr[k * n + s] + (d0 + r) * stride[k] + off,
                    dst_ptr[k] + (r * n + s) * bb + off,
                    min(CHUNK_BYTES, bb - off)))
    return out


def _index(device: torch.device) -> int:
    device = torch.device(device)
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def same_card(a, b) -> bool:
    """Whether two devices name one card (``cuda`` is the current one)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    return a.type != "cuda" or _index(a) == _index(b)


_PEERS_ENABLED: set = set()
_BARRIER_LOCK = threading.Lock()


def enable_peer_access(devices: Sequence[torch.device]) -> None:
    """Enable peer access between every ordered pair of distinct cards in
    ``devices``; raises naming a pair that
    ``torch.cuda.can_device_access_peer`` refuses.  No host-staged
    fallback exists."""
    idx = sorted({_index(d) for d in devices})
    lib = None
    for a in idx:
        for b in idx:
            if a == b or (a, b) in _PEERS_ENABLED:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(
                    f"all_to_all: card cuda:{a} has no peer access to "
                    f"cuda:{b}; shards on several cards need every pair "
                    f"(there is no host-staged exchange)")
            lib = lib or _lib()
            _check_rc(lib.spark_enable_peer_access(a, b),
                      f"peer access cuda:{a} -> cuda:{b}")
            _PEERS_ENABLED.add((a, b))


#: addresses of allocations kept for the process's life (the barrier
#: sets' states and error words): a captured launch may hold them
_PROCESS_LIFETIME: set = set()


class BarrierSet:
    """The order state of one set of distinct cards (their device indices
    in rank order): one zeroed state allocation per card and an error word
    per card in mapped host memory, allocated once, outside every graph
    pool, and kept for the process's life (graphs hold their addresses).
    The exchanges across these cards (``exchange_kernel``) and the
    separate ``barrier_kernel`` share it."""

    def __init__(self, indices: Sequence[int]):
        self.indices = tuple(indices)
        if len(set(self.indices)) != len(self.indices):
            raise ValueError(f"barrier: cards {list(self.indices)} repeat a "
                             f"card; each card of a barrier is a distinct "
                             f"device")
        lib = _lib()
        if len(self.indices) > lib.spark_barrier_max_cards():
            raise ValueError(f"barrier: {len(self.indices)} cards; it takes "
                             f"{lib.spark_barrier_max_cards()}")
        self.states = []
        for d in self.indices:
            ptr = ctypes.c_void_p()
            _check_rc(lib.spark_barrier_alloc(d, ctypes.byref(ptr)),
                      f"barrier state on cuda:{d}")
            self.states.append(int(ptr.value))
        self.table = (ctypes.c_longlong * len(self.states))(*self.states)
        words = ctypes.c_void_p()
        _check_rc(lib.spark_barrier_error_words(len(self.indices),
                                                ctypes.byref(words)),
                  "barrier error words")
        self.errors = ctypes.cast(words, ctypes.POINTER(ctypes.c_uint))
        self.error_base = int(words.value)
        _PROCESS_LIFETIME.update(self.pointers())

    def pointers(self) -> List[int]:
        """Every card's state and error word address."""
        return self.states + [self.error_base + 4 * r
                              for r in range(len(self.indices))]

    def cross(self, timeout_s: float) -> Tuple[List[int], List[int], int]:
        """``a2a_card_plan``'s ``cross`` for this set: the states, the
        error words and the time limit of a wait in ns."""
        return (list(self.states),
                [self.error_base + 4 * r for r in range(len(self.indices))],
                int(timeout_s * 1e9))

    def failed(self) -> List[Tuple[int, int]]:
        """(rank, the peer rank it waited for) of each timed-out card."""
        return [(r, self.errors[r] - 1) for r in range(len(self.indices))
                if self.errors[r]]

    def check(self) -> None:
        """Raise if a barrier of this set timed out; then synchronize
        every card and zero the states, so the next barrier starts from
        equal epochs."""
        bad = self.failed()
        if not bad:
            return
        lib = _lib()
        for d in self.indices:
            torch.cuda.synchronize(d)
        for r, (d, ptr) in enumerate(zip(self.indices, self.states)):
            _check_rc(lib.spark_barrier_reset(d, ptr), "barrier reset")
            self.errors[r] = 0
        what = ", ".join(f"cuda:{self.indices[r]} (rank {r}) waited for "
                         f"rank {p}" for r, p in bad)
        raise RuntimeError(f"all_to_all: a cross-card barrier timed out "
                           f"after {BARRIER_TIMEOUT_S} s: {what}; the "
                           f"exchange's outputs are not valid")

    def read_state(self, rank: int) -> Dict[str, object]:
        """Card ``rank``'s state copied to the host (a synchronizing read,
        for checks): its epoch, arrival ticket and failure mark, the
        arrival and done slot of each card of the set, and the block
        counter."""
        lib = _lib()
        m = lib.spark_barrier_max_cards()
        host = (ctypes.c_ulonglong * -(-lib.spark_barrier_state_bytes()
                                       // 8))()
        _check_rc(lib.spark_barrier_read(self.indices[rank],
                                         self.states[rank], host),
                  "barrier state read")
        n = len(self.indices)
        return {"epoch": int(host[m]),
                "flags": [int(host[p]) for p in range(n)],
                "done": [int(host[m + 1 + p]) for p in range(n)],
                "arrived": int(host[2 * m + 1]),
                "failed": int(host[2 * m + 2]),
                "blocks": int(host[2 * m + 3]) & 0xffffffff}

    def read(self, rank: int) -> Tuple[int, List[int]]:
        """(epoch, the arrival slot of each card) of card ``rank``'s
        state."""
        st = self.read_state(rank)
        return st["epoch"], st["flags"]

    def launch(self, rank: int, stream, timeout_s: float) -> None:
        rc = _lib().spark_barrier(
            self.table, len(self.states), rank,
            self.error_base + 4 * rank, int(timeout_s * 1e9),
            stream.cuda_stream)
        _check_rc(rc, f"barrier launch on cuda:{self.indices[rank]}")


_BARRIERS: Dict[tuple, BarrierSet] = {}


def barrier_set(devices: Sequence[torch.device]) -> BarrierSet:
    """The process's ``BarrierSet`` of these cards, made at first use."""
    key = tuple(_index(d) for d in devices)
    with _BARRIER_LOCK:
        b = _BARRIERS.get(key)
        if b is None:
            b = _BARRIERS[key] = BarrierSet(key)
        return b


def check_barriers() -> None:
    """Raise if any cross-card barrier of this process timed out (read
    from the mapped error words: no synchronization)."""
    for b in list(_BARRIERS.values()):
        b.check()


def barrier(devices: Sequence[torch.device], streams: Sequence) -> None:
    """One separate barrier over every card of ``devices``:
    ``barrier_kernel`` launched on each card's stream (``streams[c]``,
    that card current), all before this returns.  Every card of the set
    must launch it the same number of times, in the same order of
    exchanges.  No exchange takes it: it times the order an exchange once
    had (barrier, copy, barrier) against ``exchange_kernel``'s."""
    b = barrier_set(devices)
    for rank, (dev, st) in enumerate(zip(devices, streams)):
        with torch.cuda.device(dev):
            b.launch(rank, st, BARRIER_TIMEOUT_S)


def _capturing(stream) -> bool:
    with torch.cuda.stream(stream):
        return torch.cuda.is_current_stream_capturing()


def all_to_all_cards(planes: Sequence[Sequence[torch.Tensor]],
                     card_of: Sequence[int],
                     devices: Sequence[torch.device],
                     streams: Optional[Sequence] = None,
                     gather: bool = False,
                     receivers: Optional[range] = None):
    """The exchange among participants on several cards: participant s's
    buffers are on card ``card_of[s]`` (``devices[c]``); returns per card,
    per plane, the ``(n_dst, n, ...)`` blocks of its receivers
    (``card_receivers``), or None for a card without one — what
    ``all_to_all_plain`` returns in its cross-device form, which CPU
    tensors take.  On the cards: one ``exchange_kernel`` launch per card
    on its stream (``streams[c]``, by default each card's current
    stream) — its copy items and the order across cards in one launch, an
    arrive-and-wait launch where the card receives nothing — all enqueued
    before this returns."""
    global LAUNCHES, CAPTURED_LAUNCHES
    n = _check(planes, gather, one_device=False)
    if len(card_of) != n:
        raise ValueError(f"all_to_all: {len(card_of)} card indices for "
                         f"{n} participants")
    for s, c in enumerate(card_of):
        if not same_card(planes[0][s].device, devices[c]):
            raise ValueError(f"all_to_all: participant {s} is on "
                             f"{planes[0][s].device}, its card is "
                             f"{devices[c]}")
    kinds = {torch.device(d).type for d in devices}
    if kinds == {"cpu"}:
        return all_to_all_plain(planes, gather, card_of, devices, receivers)
    if kinds != {"cuda"}:
        raise ValueError(f"all_to_all: cards {list(devices)} mix devices")
    if streams is None:
        streams = [torch.cuda.current_stream(d) for d in devices]
    enable_peer_access(devices)
    order = barrier_set(devices)
    order.check()
    outs: List[Optional[List[torch.Tensor]]] = []
    ranges = [card_receivers(card_of, c, receivers)
              for c in range(len(devices))]
    nbytes, stride = [], []
    for shards in planes:
        head = shards[0]
        bb = head.numel() * head.element_size() // (1 if gather else n)
        nbytes.append(bb)
        stride.append(0 if gather else bb)
    for (d0, n_dst), dev, st in zip(ranges, devices, streams):
        if not n_dst:
            outs.append(None)
            continue
        with torch.cuda.device(dev), torch.cuda.stream(st):
            outs.append([torch.empty((n_dst, n) + tuple(
                shards[0].shape[0 if gather else 1:]),
                dtype=shards[0].dtype, device=dev) for shards in planes])
    src = [[x.data_ptr() for x in shards] for shards in planes]
    dst = [[o.data_ptr() for o in out] if out is not None else None
           for out in outs]
    plan = a2a_card_plan(src, dst, nbytes, stride, card_of, receivers,
                         cross=order.cross(BARRIER_TIMEOUT_S))
    capturing = _capturing(streams[0])
    if capturing:
        _check_captured_pointers(
            [p for plane in src for p in plane]
            + [p for out in dst if out is not None for p in out]
            + order.pointers())
    lib = _lib()
    for (d0, n_dst, table, total), dev, st in zip(plan, devices, streams):
        buf = (ctypes.c_longlong * len(table))(*table)
        with torch.cuda.device(dev):
            rc = lib.spark_exchange_part(buf, len(table), len(planes), n,
                                         d0, n_dst,
                                         first_sender(n, d0, n_dst)
                                         if n_dst else 0, total,
                                         st.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"exchange kernel failed on {dev}: CUDA "
                               f"error {rc} (planes={len(planes)}, n={n}, "
                               f"receivers {d0}..{d0 + n_dst - 1}, "
                               f"items={total})")
        card = _index(dev)
        if not total:
            CARD_BARRIERS[card] += 1
            if capturing:
                CARD_CAPTURED_BARRIERS[card] += 1
            continue
        LAUNCHES += 1
        CARD_LAUNCHES[card] += 1
        if capturing:
            CAPTURED_LAUNCHES += 1
            CARD_CAPTURED[card] += 1
    return outs


def _check_captured_pointers(pointers: Sequence[int]) -> None:
    """Under a capture the launch's pointer table is frozen into the
    graph: every pointer in it must be to memory whose address a replay
    finds unchanged — the entry's (``CAPTURE_SOURCES``), or an
    allocation kept for the process's life (a barrier set's states and
    error words) — or the capture raises."""
    ok = CAPTURE_SOURCES
    if ok is None:
        raise RuntimeError(
            "all_to_all: captured outside a mesh stage-cache entry; its "
            "pointer table would freeze addresses nothing keeps")
    bad = [p for p in pointers if p not in _PROCESS_LIFETIME and not ok(p)]
    if bad:
        raise RuntimeError(
            f"all_to_all: a captured launch reads or writes "
            f"{len(bad)} address(es) outside the entry's static buffers, "
            f"constants and graph pool (first 0x{bad[0]:x}); a replay "
            f"would follow them after they are freed")


# ---------------------------------------------------------------------------
# across processes: the pull and the arena
# ---------------------------------------------------------------------------

def pull_plain(blocks: Sequence[Sequence[torch.Tensor]],
               rows: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """Plain version of ``pull``: per plane, the senders' blocks stacked
    (``out[k][s] = blocks[k][s]``); with ``rows``, plane ``k``'s output
    rows are ``rows[k]`` elements long and zero past the block."""
    outs = [torch.stack(list(b)) for b in blocks]
    if rows is None:
        return outs
    padded = []
    for out, r in zip(outs, rows):
        full = out.new_zeros((out.shape[0], int(r)) + tuple(out.shape[2:]))
        full[:, :out.shape[1]] = out
        padded.append(full)
    return padded


def pull_plan(sources: Sequence[Sequence[int]], dst: Sequence[int],
              nbytes: Sequence[int], stride: Sequence[int],
              stage_bytes: int) -> Tuple[array, int]:
    """The pull's division of work, which ``pull_kernel`` follows: the
    kernel's table (int64, as laid out in ``csrc/all_to_all.cu``) and its
    number of work items.

    Segment ``g = k * n + s`` copies ``nbytes[k]`` bytes from
    ``sources[k][s]`` to ``dst[k] + s * stride[k]``.  When both ends agree
    mod 16, its head (up to the destination's next 16-byte boundary) and
    tail (each at most 15 bytes) go to plain threads and its body, 16-byte
    aligned at both ends, through the ring: ``max(1, ceil(body /
    stage_bytes))`` items, the first of which also copies the head and the
    tail.  Otherwise plain threads copy it, ``ceil(nbytes / stage_bytes)``
    items.  A segment of 0 bytes has no item.  (At a few segments, plain
    Python ints build the table faster than numpy's per-call overhead.)"""
    segs, first, total = [], [0], 0
    for ptrs, d, nb, st in zip(sources, dst, nbytes, stride):
        for a in ptrs:
            if nb:
                if (a ^ d) & 15:
                    total += -(-nb // stage_bytes)
                else:
                    head = min(nb, -d & 15)
                    body = (nb - head) & -16
                    total += -(-body // stage_bytes) if body else 1
            first.append(total)
            segs.append(a)
            d += st
    segs += dst
    segs += nbytes
    segs += stride
    segs += first
    return array("q", segs), total


def pull_grid(total: int, sms: int, blocks_per_sm: int) -> int:
    """Blocks of a pull launch on a card of ``sms`` SMs (the kernel sizes
    it so): ``blocks_per_sm`` per SM, never more than the work items;
    block ``b`` takes items ``b``, ``b + grid``, ``b + 2 * grid``, ..."""
    return min(total, blocks_per_sm * sms)


def pull_item_copies(table: Sequence[int], P: int, n: int,
                     stage_bytes: int, item: int) -> List[tuple]:
    """The copies work item ``item`` makes, as ``pull_kernel`` decodes it:
    ``(segment, route, offset in the segment, bytes)``, route ``ring`` (a
    bulk copy through a shared-memory stage), ``peel`` (a head or tail,
    by plain threads) or ``plain`` (plain threads, ends that disagree mod
    16)."""
    segs = P * n
    first = table[segs + 3 * P:]
    lo, hi = 0, segs
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if first[mid] <= item:
            lo = mid
        else:
            hi = mid
    k, s = divmod(lo, n)
    src = table[lo]
    dst = table[segs + k] + s * table[segs + 2 * P + k]
    nb = table[segs + P + k]
    j = item - first[lo]
    if (src ^ dst) & 15:
        off = j * stage_bytes
        return [(lo, "plain", off, min(stage_bytes, nb - off))]
    head = min(nb, (16 - (dst & 15)) & 15)
    body = (nb - head) & -16
    out = []
    if body:
        off = head + j * stage_bytes
        out.append((lo, "ring", off, min(stage_bytes, body - j * stage_bytes)))
    if j == 0:
        if head:
            out.append((lo, "peel", 0, head))
        if nb - head - body:
            out.append((lo, "peel", head + body, nb - head - body))
    return out


def pull(sources: Sequence[Sequence[int]], outs: Sequence[torch.Tensor],
         nbytes: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """Copy ``nbytes[k]`` bytes (default: a whole row) from device
    address ``sources[k][s]`` into row ``s`` of ``outs[k]`` for every
    plane and sender in ONE launch of ``pull_kernel``; ``outs[k]`` is a
    contiguous ``(n_src, ...)`` CUDA tensor, the bytes past ``nbytes[k]``
    in each row left as they were.  Raises on anything else; the caller
    synchronizes."""
    global PULL_LAUNCHES
    P = len(outs)
    if not P or len(sources) != P or (nbytes is not None
                                      and len(nbytes) != P):
        raise ValueError(f"pull: {len(sources)} source planes for {P} "
                         "outputs")
    n_src = len(sources[0])
    device = outs[0].device
    if device.type != "cuda":
        raise ValueError(f"pull: outputs on {device}; the plain version "
                         "is pull_plain")
    dst, lens, strides = [], [], []
    for k in range(P):
        out = outs[k]
        if len(sources[k]) != n_src or out.shape[0] != n_src \
                or not out.is_contiguous() or out.device != device:
            raise ValueError(f"pull: plane {k} has {len(sources[k])} "
                             f"sources and output {tuple(out.shape)} on "
                             f"{out.device}")
        row = out.numel() * out.element_size() // n_src if n_src else 0
        nb = row if nbytes is None else int(nbytes[k])
        if not 0 <= nb <= row:
            raise ValueError(f"pull: plane {k} copies {nb} B into rows of "
                             f"{row} B")
        dst.append(out.data_ptr())
        lens.append(nb)
        strides.append(row)
    table, total = pull_plan(sources, dst, lens, strides, PULL_STAGE_BYTES)
    if total == 0:
        return list(outs)
    if len(table) > MAX_TABLE_ENTRIES:
        raise ValueError(f"pull: {P} planes of {n_src} senders need "
                         f"{len(table)} table entries; one launch takes "
                         f"{MAX_TABLE_ENTRIES}")
    rc = _lib().spark_a2a_pull(
        table.buffer_info()[0], len(table), P, n_src, total, PULL_STAGES,
        PULL_STAGE_BYTES, PULL_BLOCKS_PER_SM, device.index or 0,
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pull kernel failed: CUDA error {rc} "
                           f"(planes={P}, senders={n_src}, items={total})")
    PULL_LAUNCHES += 1
    return list(outs)


def _lib() -> ctypes.CDLL:
    return cuda_build.load(SOURCE, _bind)


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


class Arena:
    """One ``cudaMalloc`` allocation on ``device`` that other processes
    map by its IPC handle (``handle`` is its bytes, hex-encoded)."""

    def __init__(self, device: torch.device, nbytes: int):
        self.device = torch.device(device)
        self.index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        self.nbytes = int(nbytes)
        lib = _lib()
        ptr = ctypes.c_void_p()
        _check_rc(lib.spark_ipc_alloc(self.index, self.nbytes,
                                      ctypes.byref(ptr)),
                  f"arena allocation of {self.nbytes} B")
        self.ptr = int(ptr.value or 0)
        buf = ctypes.create_string_buffer(lib.spark_ipc_handle_bytes())
        try:
            _check_rc(lib.spark_ipc_get_handle(self.index, self.ptr, buf),
                      "cudaIpcGetMemHandle")
        except RuntimeError:
            self.free()
            raise
        self.handle = buf.raw.hex()

    def write(self, offset: int, host: "np.ndarray") -> None:
        """Queue a copy of ``host``'s bytes to ``offset`` on the current
        stream; the caller synchronizes before publishing."""
        host = np.ascontiguousarray(host)
        if host.nbytes == 0:
            return
        if offset < 0 or offset + host.nbytes > self.nbytes:
            raise ValueError(f"arena write of {host.nbytes} B at {offset} "
                             f"outside {self.nbytes} B")
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _check_rc(_lib().spark_ipc_copy(
            self.index, self.ptr + offset, host.ctypes.data, host.nbytes,
            stream), "arena copy")

    def free(self) -> None:
        if self.ptr:
            _lib().spark_ipc_free(self.index, self.ptr)
            self.ptr = 0


def open_handle(device: torch.device, handle: str) -> int:
    """Map a peer's arena into this process; returns its base address.
    Raises ``RuntimeError`` when the handle cannot be opened (its owner
    exited, or this process opened it already)."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    ptr = ctypes.c_void_p()
    _check_rc(_lib().spark_ipc_open(index, bytes.fromhex(handle),
                                    ctypes.byref(ptr)),
              "cudaIpcOpenMemHandle")
    return int(ptr.value or 0)


def close_handle(device: torch.device, ptr: int) -> None:
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    _lib().spark_ipc_close(index, ptr)
