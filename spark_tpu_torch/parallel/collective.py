"""Collective data movement between the shards of one SPMD program.

The port of ``spark_tpu/parallel/collective.py`` (the engine's data plane
— what ``ShuffleExchange.scala:38`` + ``UnsafeShuffleWriter.java`` +
``ShuffleBlockFetcherIterator`` do in the reference).  Every function
takes the shard's ``ShardContext`` where the JAX package names a mesh
axis; each row exchange is ONE all-to-all (kernel K2) over every plane
of the batch:

* ``hash_exchange``: bucket rows, pack per-destination send buffers
  (static per-bucket capacity = skew factor × even split), one
  all-to-all, unpack.  Rows beyond a destination's capacity are dropped
  and counted (the adaptive retry grows the capacity);
* ``broadcast_all``: all-gather a batch to every shard
  (``BroadcastExchangeExec`` without a round-trip through one process);
* ``fine_bucket_histogram`` + ``balanced_assignment``: measured,
  balanced routing of fine hash buckets onto shards.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..columnar import ColumnBatch, ColumnVector, pad_capacity
from ..kernels import multi_key_argsort, searchsorted, take_batch

_I64_MAX = torch.iinfo(torch.int64).max


def umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """``h.astype(uint64) % n`` for int64 ``h`` holding uint64 bits: a
    negative h stands for h + 2^64, so add 2^64 mod n to its (non-negative)
    remainder."""
    r = torch.remainder(h, n)
    wrap = (1 << 64) % n
    if wrap:
        r = torch.where(h < 0, (r + wrap) % n, r)
    return r


def hash_exchange(ctx, batch: ColumnBatch, bucket: torch.Tensor,
                  n_shards: int, cap_out: int
                  ) -> Tuple[ColumnBatch, torch.Tensor]:
    """Repartition rows so shard d receives every live row with
    ``bucket == d``.

    Returns (received batch of capacity n_shards*cap_out, overflow count).
    Rows beyond a destination's ``cap_out`` are dropped and counted.
    Send buffers are GATHERED from the bucket-sorted rows (slot j of
    destination d is the j-th row bound for d), which leaves the same
    bits as the JAX package's scatter and never sends a dropped row to a
    shared address."""
    C = batch.capacity
    dev = batch.device
    live = batch.row_valid_or_true()
    b = torch.where(live, bucket.to(torch.int32),
                    torch.tensor(n_shards, dtype=torch.int32, device=dev))

    perm = multi_key_argsort([b], C)
    bs = b[perm]
    starts = searchsorted(bs, torch.arange(n_shards + 1, dtype=torch.int32,
                                           device=dev))
    counts = starts[1:] - starts[:-1]          # live rows bound for each d
    kept = torch.clamp(counts, max=cap_out)
    overflow = counts.sum() - kept.sum()

    j = torch.arange(cap_out, dtype=torch.int64, device=dev)
    ok = j[None, :] < kept[:, None]                        # (n, cap_out)
    rows = perm[torch.clamp(starts[:-1, None] + j[None, :], 0,
                            max(C - 1, 0))]

    def pack(x: torch.Tensor) -> torch.Tensor:
        return x[rows].masked_fill_(~ok, 0)

    planes: List[torch.Tensor] = []
    for v in batch.vectors:
        planes.append(pack(v.data))
        if v.valid is not None:
            planes.append(pack(v.valid.expand(C)))
    planes.append(ok)                 # a kept row is a live row
    got = iter(ctx.comm.all_to_all(ctx.shard, planes))

    received = []
    for v in batch.vectors:
        data = next(got).reshape(-1)
        valid = None if v.valid is None else next(got).reshape(-1)
        received.append(ColumnVector(data, v.dtype, valid, v.dictionary))
    rv = next(got).reshape(-1)
    return ColumnBatch(batch.names, received, rv, n_shards * cap_out), \
        overflow


def fine_bucket_histogram(ctx, h: torch.Tensor, live: torch.Tensor,
                          n_fine: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fine bucket id per row, GLOBAL live-row count per fine bucket):
    per-shard counts, then one ``psum``.  Dead rows add into private
    scratch slots past the table (never one shared address)."""
    fine = umod(h, n_fine).to(torch.int32)
    C = h.shape[0]
    idx = torch.where(live, fine.to(torch.int64),
                      n_fine + torch.arange(C, device=h.device))
    local = torch.zeros(n_fine + C, dtype=torch.int64, device=h.device)
    local = local.index_add_(0, idx, live.to(torch.int64))[:n_fine]
    return fine, ctx.comm.psum(ctx.shard, local)


def balanced_assignment(counts: torch.Tensor, n_shards: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy LPT packing of fine buckets onto shards: heaviest bucket
    first (a STABLE order, so equal counts keep bucket order), always onto
    the least-loaded shard (the first one on a tie).  A pure function of
    the psum'd counts, so every shard gets the same assignment; it has
    only n_fine steps and runs on the host after one transfer — callers
    run it once per collective (``Communicator.once``).  Returns
    (assignment (B,) int32, per-shard loads (n_shards,)) on the counts'
    device."""
    c = counts.cpu().numpy()
    order = np.argsort(-c, kind="stable")
    loads = np.zeros(n_shards, c.dtype)
    assign = np.zeros(c.shape[0], np.int32)
    for j in order:
        s = int(np.argmin(loads))
        loads[s] += c[j]
        assign[j] = s
    dev = counts.device
    return torch.from_numpy(assign).to(dev), torch.from_numpy(loads).to(dev)


def replicate_selected(ctx, batch: ColumnBatch, mask: torch.Tensor,
                       hot_cap: int) -> Tuple[ColumnBatch, torch.Tensor]:
    """Every shard receives ALL rows where ``mask`` (from every shard):
    selected rows pack into a ``hot_cap`` send buffer, one all-gather
    replicates them.  Returns (batch of capacity n_shards*hot_cap,
    overflow count of selected rows beyond hot_cap)."""
    C = batch.capacity
    hot_cap = min(hot_cap, C)       # a slice can't exceed the source batch
    sel = mask & batch.row_valid_or_true()
    perm = multi_key_argsort([torch.where(sel, 0, 1).to(torch.int8)], C)
    n_sel = sel.sum(dtype=torch.int64)
    overflow = torch.clamp(n_sel - hot_cap, min=0)
    head = perm[:hot_cap]
    packed = take_batch(batch, head)
    packed = ColumnBatch(packed.names, packed.vectors, sel[head], hot_cap)
    return broadcast_all(ctx, packed), overflow


def round_robin_exchange(ctx, batch: ColumnBatch, n_shards: int
                         ) -> ColumnBatch:
    """Spread rows evenly round-robin (RoundRobinPartitioning analog),
    before a range exchange: when input order correlates with the sort key
    whole shards would map to one range bucket.  Capacity is exact — this
    exchange cannot overflow."""
    C = batch.capacity
    bucket = torch.arange(C, dtype=torch.int32, device=batch.device) \
        % n_shards
    cap_out = pad_capacity(-(-C // n_shards))
    out, _ = hash_exchange(ctx, batch, bucket, n_shards, cap_out)
    return out


def broadcast_all(ctx, batch: ColumnBatch) -> ColumnBatch:
    """Every shard receives the concatenation of all shards' rows, in
    shard order (one all-gather of every plane)."""
    planes: List[torch.Tensor] = []
    for v in batch.vectors:
        planes.append(v.data)
        if v.valid is not None:
            planes.append(v.valid.expand(batch.capacity))
    planes.append(batch.row_valid_or_true())
    got = iter(ctx.comm.all_gather(ctx.shard, planes))
    vectors = []
    for v in batch.vectors:
        data = next(got).reshape(-1)
        valid = None if v.valid is None else next(got).reshape(-1)
        vectors.append(ColumnVector(data, v.dtype, valid, v.dictionary))
    rv = next(got).reshape(-1)
    return ColumnBatch(batch.names, vectors, rv, batch.capacity * ctx.n_shards)


def psum_arrays(ctx, arrays: List[torch.Tensor]) -> List[torch.Tensor]:
    return [ctx.comm.psum(ctx.shard, a) for a in arrays]


def sampled_splitters_multi(ctx, keys: List[torch.Tensor],
                            live: torch.Tensor, n_shards: int,
                            samples_per_shard: int = 64
                            ) -> List[torch.Tensor]:
    """Lexicographic multi-key range splitters (RangePartitioner over the
    FULL sort key): a strided sample of key TUPLES per shard → all-gather
    → stable lexicographic sort → quantile tuples.  Returns one
    (n_shards-1,) tensor per key column, identical on every shard."""
    C = keys[0].shape[0]
    dev = keys[0].device
    stride = max(C // samples_per_shard, 1)
    idx = torch.arange(samples_per_shard, device=dev) * stride % C
    big = torch.tensor(_I64_MAX, dtype=torch.int64, device=dev)
    samples = [torch.where(live[idx], k[idx], big) for k in keys]
    cols = [g.reshape(-1) for g in ctx.comm.all_gather(ctx.shard, samples)]
    order = multi_key_argsort(cols, cols[0].shape[0])
    total = samples_per_shard * n_shards
    pos = torch.arange(1, n_shards, device=dev) * total // n_shards
    return [c[order][pos] for c in cols]


def lex_bucket(keys: List[torch.Tensor], splitters: List[torch.Tensor]
               ) -> torch.Tensor:
    """bucket[row] = number of splitter tuples <= the row's key tuple
    (lexicographic searchsorted, vectorized over (capacity, n-1))."""
    C, n1 = keys[0].shape[0], splitters[0].shape[0]
    dev = keys[0].device
    gt = torch.zeros((C, n1), dtype=torch.bool, device=dev)
    eq = torch.ones((C, n1), dtype=torch.bool, device=dev)
    for k, s in zip(keys, splitters):
        kv, sv = k[:, None], s[None, :]
        gt = gt | (eq & (kv > sv))
        eq = eq & (kv == sv)
    return (gt | eq).sum(dim=1).to(torch.int32)


def sampled_splitters(ctx, key: torch.Tensor, live: torch.Tensor,
                      n_shards: int, samples_per_shard: int = 64
                      ) -> torch.Tensor:
    """Single-key convenience wrapper over sampled_splitters_multi."""
    return sampled_splitters_multi(ctx, [key], live, n_shards,
                                   samples_per_shard)[0]
