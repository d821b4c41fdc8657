"""Grouped accumulate (kernel K1): the MXU hash map of the JAX package,
written in CUDA C++ for Hopper.

``grouped_accumulate(bucket32, planes, n_active, B)`` returns the (B, P)
int64 table ``out[b, p] = Σ planes[i, p]`` over rows ``i`` with
``bucket[i] == b``, counting only buckets below ``n_active * 512``.  It
replaces ``spark_tpu/pallas_agg.py`` ``grouped_accumulate`` (the Pallas
kernel ``_kernel``): same function, exact, with uint8 planes (every value
is in {0..255}; bf16 was only the TPU matrix unit's input type).

On a CUDA tensor the wrapper launches ``csrc/grouped_accumulate.cu`` — built
with ``nvcc`` at first use into ``build/kernels/`` and bound with ctypes
(``cuda_build``) — or raises; on a CPU tensor it runs the plain PyTorch
version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import cuda_build

#: bucket chunk width in which ``n_active`` is counted (the TPU kernel's BB)
CHUNK = 512

#: kernel launches so far (a plain count: ``chip_smoke.py`` zeroes it and
#: reads it around the main path to show the path went through the kernel)
LAUNCHES = 0

SOURCE = os.path.join(cuda_build.CSRC, "grouped_accumulate.cu")


def n_active_chunks(prod: torch.Tensor, B: int) -> torch.Tensor:
    """Device int32 count of leading CHUNK-wide bucket chunks covering
    buckets [0, prod) — the kernel skips the rest (``prod`` is the float64
    product of the key ranges)."""
    return torch.clamp(torch.ceil(prod / float(CHUNK)), 1.0,
                       float(-(-B // CHUNK))).to(torch.int32).reshape(1)


def grouped_accumulate_plain(bucket32: torch.Tensor, planes: torch.Tensor,
                             n_active: torch.Tensor, B: int) -> torch.Tensor:
    """Plain PyTorch version: mask rows past the live chunks, then one
    ``index_add_`` into a (B, P) int64 table."""
    limit = n_active.reshape(()).to(torch.int64) * CHUNK
    live = bucket32.to(torch.int64) < limit
    idx = torch.where(live, bucket32.to(torch.int64), 0)
    vals = planes.to(torch.int64) * live.to(torch.int64)[:, None]
    out = torch.zeros((B, planes.shape[1]), dtype=torch.int64,
                      device=planes.device)
    return out.index_add_(0, idx, vals)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.spark_grouped_accumulate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def grouped_accumulate(bucket32: torch.Tensor, planes: torch.Tensor,
                       n_active: torch.Tensor, B: int) -> torch.Tensor:
    """Per-bucket column sums, exact: (B, P) int64.

    bucket32: (N,) int32 in [0, B).  planes: (N, P) uint8.  n_active: int32
    device scalar, the number of leading 512-bucket chunks that may hold a
    live bucket.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    global LAUNCHES
    n = bucket32.shape[0]
    if bucket32.dtype != torch.int32 or bucket32.dim() != 1:
        raise ValueError("bucket32 must be a 1-D int32 tensor")
    if planes.dtype != torch.uint8 or planes.dim() != 2 \
            or planes.shape[0] != n:
        raise ValueError("planes must be an (N, P) uint8 tensor")
    if n_active.dtype != torch.int32 or n_active.numel() != 1:
        raise ValueError("n_active must be one int32 element")
    if not (planes.device == bucket32.device == n_active.device):
        raise ValueError("grouped_accumulate: inputs on different devices")
    if B < 1:
        raise ValueError(f"B must be >= 1, got {B}")
    if bucket32.device.type == "cpu":
        return grouped_accumulate_plain(bucket32, planes, n_active, B)
    if bucket32.device.type != "cuda":
        raise ValueError(f"grouped_accumulate: unsupported device "
                         f"{bucket32.device}")
    bucket32 = bucket32.contiguous()
    planes = planes.contiguous()
    P = planes.shape[1]
    out = torch.zeros((B, P), dtype=torch.int64, device=planes.device)
    if n == 0:
        return out
    lib = cuda_build.load(SOURCE, _bind)
    with torch.cuda.device(planes.device):   # the launch uses the current card
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        rc = lib.spark_grouped_accumulate(
            bucket32.data_ptr(), planes.data_ptr(), n_active.data_ptr(),
            out.data_ptr(), n, P, B, stream)
    if rc != 0:
        raise RuntimeError(f"grouped_accumulate kernel failed: CUDA error "
                           f"{rc} (N={n}, P={P}, B={B})")
    LAUNCHES += 1
    return out
