"""Greedy LPT assignment of fine hash buckets onto shards (``lpt_assign``),
written in CUDA C++ for Hopper.

``lpt_assign(counts, n_shards)`` packs the fine buckets of an adaptive
exchange onto the shards: heaviest bucket first (a STABLE order, so
equal counts keep bucket order), always onto the least-loaded shard
(the first one on a tie).  It returns ``(assignment (n_fine,) int32,
per-shard loads (n_shards,))`` on the counts' device.  This is
``spark_tpu/parallel/collective.py`` ``balanced_assignment``, which the
JAX package runs on the device as a ``lax.fori_loop``; it is no Pallas
kernel, but on the mesh lane it sits inside every adaptive exchange, so
it runs on the card where the graph of a mesh query can hold it.

On a CUDA tensor the wrapper launches ``csrc/lpt_assign.cu`` once — one
block, built with ``nvcc`` at first use into ``build/kernels/`` and bound
with ctypes (``cuda_build``) — or raises.  Up to ``RANK_MAX`` buckets the
kernel computes the stable heaviest-first order itself (``lpt_rank_plain``
is that ranking in PyTorch); beyond it the wrapper sorts the counts
(``torch.sort(-counts, stable=True)``) and the kernel follows that order.
On a CPU tensor it runs the plain PyTorch version, a loop of torch ops
that reads nothing to the host.  There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from . import cuda_build

#: the wrapper's kernel launches so far (a plain count: ``chip_smoke.py``
#: zeroes it and reads it around the main path).  A launch made while a
#: CUDA graph is captured counts here and in ``CAPTURED_LAUNCHES``; the
#: graph's replays launch the kernel without the wrapper, and the stage
#: cache adds each replayed graph's captured launches to
#: ``REPLAYED_LAUNCHES``
LAUNCHES = 0
CAPTURED_LAUNCHES = 0
REPLAYED_LAUNCHES = 0

SOURCE = os.path.join(cuda_build.CSRC, "lpt_assign.cu")

#: buckets the kernel ranks itself (its kRankMax): 16 shards at the
#: default 32 fine buckets per shard; past it the wrapper sorts
RANK_MAX = 512


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.spark_lpt_assign
    fn.argtypes = [vp, vp, i, i, vp, vp, vp]
    fn.restype = i
    lib.spark_lpt_rank_max.argtypes = []
    lib.spark_lpt_rank_max.restype = i
    if lib.spark_lpt_rank_max() != RANK_MAX:
        raise RuntimeError(f"lpt_assign: the kernel ranks "
                           f"{lib.spark_lpt_rank_max()} buckets, the wrapper "
                           f"expects {RANK_MAX}")


def _check(counts: torch.Tensor, n_shards: int) -> None:
    if counts.dtype != torch.int64 or counts.dim() != 1:
        raise ValueError(f"lpt_assign: counts must be a 1-D int64 tensor, "
                         f"got {counts.dtype}{tuple(counts.shape)}")
    if n_shards < 1:
        raise ValueError(f"lpt_assign: n_shards must be >= 1, got "
                         f"{n_shards}")


def lpt_rank_plain(counts: torch.Tensor) -> torch.Tensor:
    """The kernel's ranking in PyTorch: bucket i's rank is the number of
    buckets heavier than it, or as heavy with a lower index, and the
    bucket goes to that place — the stable heaviest-first order
    (``torch.sort(-counts, stable=True).indices``), as int64."""
    n = counts.shape[0]
    idx = torch.arange(n, device=counts.device)
    c_i, c_j = counts[:, None], counts[None, :]
    ahead = (c_j > c_i) | ((c_j == c_i) & (idx[None, :] < idx[:, None]))
    rank = ahead.sum(1)
    return torch.empty_like(idx).scatter_(0, rank, idx)


def lpt_assign_plain(counts: torch.Tensor, n_shards: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one step per bucket, on the counts' device,
    with no host read (``torch.argmin`` returns the first least)."""
    _check(counts, n_shards)
    dev = counts.device
    order = torch.sort(-counts, stable=True).indices
    loads = torch.zeros(n_shards, dtype=counts.dtype, device=dev)
    assign = torch.zeros(counts.shape[0], dtype=torch.int32, device=dev)
    for i in range(counts.shape[0]):
        j = order[i:i + 1]
        s = torch.argmin(loads).reshape(1)
        loads.index_add_(0, s, counts.index_select(0, j))
        assign.index_copy_(0, j, s.to(torch.int32))
    return assign, loads


def lpt_assign(counts: torch.Tensor, n_shards: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The assignment and the loads; see the module docstring.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global LAUNCHES, CAPTURED_LAUNCHES
    _check(counts, n_shards)
    device = counts.device
    if device.type == "cpu":
        return lpt_assign_plain(counts, n_shards)
    if device.type != "cuda":
        raise ValueError(f"lpt_assign: unsupported device {device}")
    counts = counts.contiguous()
    n_fine = counts.shape[0]
    # past RANK_MAX buckets the kernel follows a sorted order
    order = torch.sort(-counts, stable=True).indices \
        if n_fine > RANK_MAX else None
    assign = torch.empty(n_fine, dtype=torch.int32, device=device)
    loads = torch.empty(n_shards, dtype=torch.int64, device=device)
    lib = cuda_build.load(SOURCE, _bind)
    with torch.cuda.device(device):      # the launch uses the current card
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.spark_lpt_assign(counts.data_ptr(),
                                  order.data_ptr() if order is not None
                                  else None,
                                  n_fine, n_shards, assign.data_ptr(),
                                  loads.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"lpt_assign kernel failed: CUDA error {rc} "
                           f"(n_fine={n_fine}, n_shards={n_shards})")
    LAUNCHES += 1
    if torch.cuda.is_current_stream_capturing():
        CAPTURED_LAUNCHES += 1
    return assign, loads
