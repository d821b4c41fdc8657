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

All participants live on one device.  On CUDA tensors the wrapper
launches ``csrc/all_to_all.cu`` once for all planes, their pointers in a
table passed as a kernel parameter — built with ``nvcc`` at first use
into ``build/kernels/`` and bound with ctypes — or raises; on CPU tensors
it runs the plain PyTorch version (one ``torch.stack`` per plane).  There
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Sequence

import torch

from . import cuda_build

#: bytes one CUDA block copies (the kernel's kChunk)
CHUNK_BYTES = 64 * 1024

#: int64 entries of the largest pointer table one launch takes (the
#: kernel's kMaxEntries): P planes of n participants need P*(n+4)+1
MAX_TABLE_ENTRIES = 4088

#: kernel launches so far (a plain count: ``chip_smoke.py`` zeroes it and
#: reads it around the main path to show the path went through the kernel)
LAUNCHES = 0

SOURCE = os.path.join(cuda_build.CSRC, "all_to_all.cu")


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.spark_all_to_all
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _check(planes: Sequence[Sequence[torch.Tensor]], gather: bool) -> int:
    """Validate the plane table; returns the participant count n."""
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
            if x.device != device:
                raise ValueError(f"all_to_all: plane {k} participant {s} is "
                                 f"on {x.device}, plane 0 on {device}")
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
                     gather: bool = False) -> List[torch.Tensor]:
    """Plain PyTorch version: ``stack`` over senders puts block ``[d][s]``
    where the exchange puts it."""
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
    global LAUNCHES
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
    return outs
