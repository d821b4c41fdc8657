"""Grouped accumulate (kernel K1): the MXU hash map of the JAX package,
written in CUDA C++ for Hopper.

``grouped_accumulate(bucket32, planes, n_active, B)`` returns the (B, P)
int64 table ``out[b, p] = Σ planes[i, p]`` over rows ``i`` with
``bucket[i] == b``, counting only buckets below ``n_active * 512``.  It
replaces ``spark_tpu/pallas_agg.py`` ``grouped_accumulate`` (the Pallas
kernel ``_kernel``): same function, exact, with uint8 planes (every value
is in {0..255}; bf16 was only the TPU matrix unit's input type).

``grouped_accumulate_columns(bucket32, planes, n_active, B)`` returns the
same table for planes described by ``Plane`` specs instead of stored: the
kernel computes each plane's byte in registers from the columns it comes
from (a mask, or one limb of an integer value), so the (N, P) plane
matrix the grouped aggregate used to build is never written.

On a CUDA tensor each wrapper launches ``csrc/grouped_accumulate.cu`` —
built with ``nvcc`` at first use into ``build/kernels/`` and bound with
ctypes (``cuda_build``) — or raises; on a CPU tensor it runs the plain
PyTorch version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from . import cuda_build

#: bucket chunk width in which ``n_active`` is counted (the TPU kernel's BB)
CHUNK = 512

#: kernel launches so far, both entries, and by entry (plain counts:
#: ``chip_smoke.py`` zeroes them and reads them around the main path to
#: show the path went through the kernel).  They count the wrapper's
#: launch calls: one made while a CUDA graph is being captured counts
#: here and in ``CAPTURED_LAUNCHES``; the graph's replays run the kernel
#: without calling the wrapper, and a profiler counts those
LAUNCHES = 0
ENTRY_LAUNCHES = {"grouped_accumulate": 0, "grouped_accumulate_columns": 0}
CAPTURED_LAUNCHES = {"grouped_accumulate": 0, "grouped_accumulate_columns": 0}

#: rows one int32 accumulator lane may take before it is flushed:
#: ⌊(2^31 − 1) / 255⌋, so a lane of 8-bit plane values stays exact
ROWS_PER_FLUSH = 8_421_504

#: the columns entry takes at most this many planes and distinct columns
#: per launch (the plane table rides in the kernel's parameters); the
#: wrapper splits wider calls into several launches
MAX_PLANES = 64
MAX_COLUMNS = 16

#: the keys of ``launch_shape``
SHAPE_KEYS = ("grid", "threads", "smem_bytes", "cluster", "tile_rows",
              "acc_buckets", "stages")

SOURCE = os.path.join(cuda_build.CSRC, "grouped_accumulate.cu")

_VALUE_DTYPES = (torch.bool, torch.int8, torch.int16, torch.int32,
                 torch.int64)
_MASK_DTYPES = (torch.bool, torch.uint8)
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


class Plane(NamedTuple):
    """One plane of ``grouped_accumulate_columns``.

    ``value`` None: the plane is 1 where ``mask`` is nonzero (every row
    when ``mask`` is None).  Otherwise, with ``x`` the value as int64 (bool
    as 0/1): ``mask ? ((x ^ offset if x is 8 bytes wide else x + offset)
    >> 8·limb) & 0xFF : 0``, in wrapping int64 arithmetic."""
    mask: Optional[torch.Tensor] = None
    value: Optional[torch.Tensor] = None
    limb: int = 0
    offset: int = 0


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


def plane_values(plane: Plane, n: int, device) -> torch.Tensor:
    """A plane's (N,) uint8 values, in plain PyTorch."""
    m = None if plane.mask is None else plane.mask != 0
    if plane.value is None:
        if m is None:
            return torch.ones(n, dtype=torch.uint8, device=device)
        return m.to(torch.uint8)
    x = plane.value
    if x.dtype == torch.bool:
        x = x.to(torch.int8)
    wide = x.element_size() == 8
    x = x.to(torch.int64)
    # wrapping int64: the 0xFF mask makes the arithmetic shift harmless
    x = x ^ plane.offset if wide else x + plane.offset
    limb = (x >> (8 * plane.limb)) & 0xFF
    if m is not None:
        limb = torch.where(m, limb, 0)
    return limb.to(torch.uint8)


def grouped_accumulate_columns_plain(bucket32: torch.Tensor,
                                     planes: Sequence[Plane],
                                     n_active: torch.Tensor,
                                     B: int) -> torch.Tensor:
    """Plain PyTorch version: build the (N, P) uint8 plane matrix from the
    specs, then ``grouped_accumulate_plain``."""
    n = bucket32.shape[0]
    mat = torch.stack([plane_values(p, n, bucket32.device) for p in planes],
                      dim=1)
    return grouped_accumulate_plain(bucket32, mat, n_active, B)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.spark_grouped_accumulate
    fn.argtypes = [vp, vp, vp, vp, ll, i, i, ll, vp]
    fn.restype = i
    fn = lib.spark_grouped_accumulate_columns
    fn.argtypes = [vp, vp, vp, i, vp, vp, vp, vp, i, vp, vp, ll, i, ll, vp]
    fn.restype = i
    fn = lib.spark_grouped_accumulate_shape
    fn.argtypes = [i, ll, i, i, i, ll, vp]
    fn.restype = i


def _check_common(bucket32, n_active, B, name):
    if bucket32.dtype != torch.int32 or bucket32.dim() != 1:
        raise ValueError("bucket32 must be a 1-D int32 tensor")
    if n_active.dtype != torch.int32 or n_active.numel() != 1:
        raise ValueError("n_active must be one int32 element")
    if n_active.device != bucket32.device:
        raise ValueError(f"{name}: inputs on different devices")
    if B < 1:
        raise ValueError(f"B must be >= 1, got {B}")


def _check_column(t, dtypes, n, device, what):
    if t.dtype not in dtypes:
        raise ValueError(f"{what} must have a dtype in {dtypes}, got "
                         f"{t.dtype}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{what} must be 1-D with {n} rows, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, the buckets on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _run(entry, fn, device, out, *args):
    global LAUNCHES
    with torch.cuda.device(device):      # the launch uses the current card
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ROWS_PER_FLUSH, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel failed: CUDA error {rc} "
                           f"(out {tuple(out.shape)})")
    LAUNCHES += 1
    ENTRY_LAUNCHES[entry] += 1
    if torch.cuda.is_current_stream_capturing():
        CAPTURED_LAUNCHES[entry] += 1
    return out


def launch_shape(columns: bool, n: int, P: int, B: int, row_width: int,
                 device="cuda") -> Dict[str, int]:
    """The launch an entry makes on ``device`` for ``n`` rows of
    ``row_width`` input bytes (``P`` for the planes entry, the distinct
    columns' widths summed for the columns entry), ``P`` planes and ``B``
    buckets, without launching it: {key in SHAPE_KEYS: value}."""
    lib = cuda_build.load(SOURCE, _bind)
    info = (ctypes.c_int * len(SHAPE_KEYS))()
    with torch.cuda.device(device):
        rc = lib.spark_grouped_accumulate_shape(int(columns), n, P, B,
                                                row_width, ROWS_PER_FLUSH,
                                                info)
    if rc != 0:
        raise RuntimeError(f"launch_shape failed: CUDA error {rc}")
    return dict(zip(SHAPE_KEYS, info))


def grouped_accumulate(bucket32: torch.Tensor, planes: torch.Tensor,
                       n_active: torch.Tensor, B: int) -> torch.Tensor:
    """Per-bucket column sums, exact: (B, P) int64.

    bucket32: (N,) int32 in [0, B).  planes: (N, P) uint8.  n_active: int32
    device scalar, the number of leading 512-bucket chunks that may hold a
    live bucket.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    _check_common(bucket32, n_active, B, "grouped_accumulate")
    n = bucket32.shape[0]
    if planes.dtype != torch.uint8 or planes.dim() != 2 \
            or planes.shape[0] != n:
        raise ValueError("planes must be an (N, P) uint8 tensor")
    if planes.device != bucket32.device:
        raise ValueError("grouped_accumulate: inputs on different devices")
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
    return _run("grouped_accumulate", lib.spark_grouped_accumulate,
                planes.device, out,
                bucket32.data_ptr(), planes.data_ptr(), n_active.data_ptr(),
                out.data_ptr(), n, P, B)


def _column_key(t: torch.Tensor):
    return (t.data_ptr(), t.dtype)


def plane_groups(planes: Sequence[Plane]) -> List[List[Plane]]:
    """Consecutive runs of planes, each within one launch's limits
    (MAX_PLANES planes, MAX_COLUMNS distinct columns)."""
    groups: List[List[Plane]] = []
    cols: set = set()
    for p in planes:
        new = {_column_key(t) for t in (p.mask, p.value) if t is not None}
        if not groups or len(groups[-1]) == MAX_PLANES \
                or len(cols | new) > MAX_COLUMNS:
            groups.append([])
            cols = set()
        groups[-1].append(p)
        cols |= new
    return groups


def _launch_columns(lib, bucket32, planes, n_active, B):
    cols: List[torch.Tensor] = []
    index: Dict[tuple, int] = {}

    def slot(t):
        if t is None:
            return -1
        key = _column_key(t)
        if key not in index:
            index[key] = len(cols)
            cols.append(t)
        return index[key]

    P = len(planes)
    value = (ctypes.c_int * P)(*[slot(p.value) for p in planes])
    mask = (ctypes.c_int * P)(*[slot(p.mask) for p in planes])
    limb = (ctypes.c_int * P)(*[p.limb for p in planes])
    offset = (ctypes.c_longlong * P)(*[p.offset for p in planes])
    nc = len(cols)
    ptrs = (ctypes.c_ulonglong * max(nc, 1))(*[t.data_ptr() for t in cols])
    widths = (ctypes.c_int * max(nc, 1))(*[t.element_size() for t in cols])
    out = torch.zeros((B, P), dtype=torch.int64, device=bucket32.device)
    n = bucket32.shape[0]
    if n == 0:
        return out
    return _run("grouped_accumulate_columns",
                lib.spark_grouped_accumulate_columns, bucket32.device, out,
                bucket32.data_ptr(), ptrs, widths, nc, value, mask, limb,
                offset, P, n_active.data_ptr(), out.data_ptr(), n, B)


def grouped_accumulate_columns(bucket32: torch.Tensor,
                               planes: Sequence[Plane],
                               n_active: torch.Tensor,
                               B: int) -> torch.Tensor:
    """Per-bucket sums of planes computed from columns, exact: (B, P)
    int64, equal to ``grouped_accumulate`` over the stacked planes.

    Each mask is a contiguous (N,) bool or uint8 tensor, each value a
    contiguous (N,) bool/int8/int16/int32/int64 tensor, on the buckets'
    device.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (one launch per ``plane_groups`` group) or raise."""
    _check_common(bucket32, n_active, B, "grouped_accumulate_columns")
    n, dev = bucket32.shape[0], bucket32.device
    if not planes:
        raise ValueError("grouped_accumulate_columns needs at least one plane")
    checked = set()                  # each column once, not once a plane
    for k, p in enumerate(planes):
        if p.mask is not None and (id(p.mask), "mask") not in checked:
            _check_column(p.mask, _MASK_DTYPES, n, dev, f"plane {k} mask")
            checked.add((id(p.mask), "mask"))
        if p.value is None:
            if p.limb != 0 or p.offset != 0:
                raise ValueError(f"plane {k}: a mask plane takes no limb "
                                 "or offset")
            continue
        if (id(p.value), "value") not in checked:
            _check_column(p.value, _VALUE_DTYPES, n, dev, f"plane {k} value")
            checked.add((id(p.value), "value"))
        if not 0 <= p.limb < 8:
            raise ValueError(f"plane {k}: limb {p.limb} not in [0, 8)")
        if not _I64_MIN <= p.offset <= _I64_MAX:
            raise ValueError(f"plane {k}: offset {p.offset} is not int64")
    if dev.type == "cpu":
        return grouped_accumulate_columns_plain(bucket32, planes, n_active, B)
    if dev.type != "cuda":
        raise ValueError(f"grouped_accumulate_columns: unsupported device "
                         f"{dev}")
    bucket32 = bucket32.contiguous()
    lib = cuda_build.load(SOURCE, _bind)
    outs = [_launch_columns(lib, bucket32, g, n_active, B)
            for g in plane_groups(planes)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
