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

Across processes (the device tier, ``parallel/ici.py``) the same kernel
PULLS: ``pull(sources, outs)`` copies, per plane ``k``, block ``s`` from
device address ``sources[k][s]`` (a slot of sender ``s``'s arena, mapped
from another process by CUDA IPC) into ``outs[k][s]``: one launch for
every plane and sender.  Its plain version, ``pull_plain``, stacks CPU
tensors (the arena of a CPU session is a shared-memory file).  The arena
itself (``Arena``) is one ``cudaMalloc`` allocation of the kernel's
library, exported and mapped by the library's IPC entry points.

Within one process all participants live on one device.  On CUDA tensors
the wrapper
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

import numpy as np
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

#: cross-process pull launches so far (``pull``), counted apart from the
#: in-process exchanges of ``LAUNCHES``
PULL_LAUNCHES = 0

SOURCE = os.path.join(cuda_build.CSRC, "all_to_all.cu")


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {
        "spark_all_to_all": [vp, i, i, i, ll, vp],
        "spark_a2a_pull": [vp, i, i, i, ll, vp],
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


# ---------------------------------------------------------------------------
# across processes: the pull and the arena
# ---------------------------------------------------------------------------

def pull_plain(blocks: Sequence[Sequence[torch.Tensor]]
               ) -> List[torch.Tensor]:
    """Plain version of ``pull``: per plane, the senders' blocks stacked
    (``out[k][s] = blocks[k][s]``)."""
    return [torch.stack(list(b)) for b in blocks]


def pull(sources: Sequence[Sequence[int]],
         outs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Copy block ``s`` of plane ``k`` from device address
    ``sources[k][s]`` into ``outs[k][s]`` for every plane and sender in
    ONE launch of the kernel (``n_dst = 1``); ``outs[k]`` is a contiguous
    ``(n_src, ...)`` CUDA tensor whose row size is the block size.  Raises
    on anything else; the caller synchronizes."""
    global PULL_LAUNCHES
    if not outs or len(sources) != len(outs):
        raise ValueError(f"pull: {len(sources)} source planes for "
                         f"{len(outs)} outputs")
    n_src = len(sources[0])
    device = outs[0].device
    if device.type != "cuda":
        raise ValueError(f"pull: outputs on {device}; the plain version "
                         "is pull_plain")
    src, dst, nbytes, stride, first = [], [], [], [], [0]
    for k, (ptrs, out) in enumerate(zip(sources, outs)):
        if len(ptrs) != n_src or out.shape[0] != n_src \
                or not out.is_contiguous() or out.device != device:
            raise ValueError(f"pull: plane {k} has {len(ptrs)} sources and "
                             f"output {tuple(out.shape)} on {out.device}")
        bb = out[0].numel() * out.element_size() if n_src else 0
        src += [int(p) for p in ptrs]
        dst.append(out.data_ptr())
        nbytes.append(bb)
        stride.append(0)
        first.append(first[-1] + n_src * (-(-bb // CHUNK_BYTES)))
    total = first[-1]
    if total == 0:
        return list(outs)
    entries = src + dst + nbytes + stride + first
    if len(entries) > MAX_TABLE_ENTRIES:
        raise ValueError(f"pull: {len(outs)} planes of {n_src} senders "
                         f"need {len(entries)} table entries; one launch "
                         f"takes {MAX_TABLE_ENTRIES}")
    table = (ctypes.c_longlong * len(entries))(*entries)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _lib().spark_a2a_pull(table, len(entries), len(outs), n_src,
                                total, stream)
    if rc != 0:
        raise RuntimeError(f"pull kernel failed: CUDA error {rc} "
                           f"(planes={len(outs)}, senders={n_src}, "
                           f"items={total})")
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
