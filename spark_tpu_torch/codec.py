"""Host byte-stream codecs and the cache's columnar block encodings.

The port of ``spark_tpu/codec.py``:

- the codec registry (the ``CompressionCodec.scala`` analog): zlib, lzma
  and bz2 from the standard library, registered under the reference's
  names and levels; lz4 and zstd register themselves only when their
  wheels are importable.  The wire format (``wire.py``) runs a column
  buffer through the session's codec when that shrinks it;
- the cache block encodings (``compressionSchemes.scala``): a column of
  a HOST_COMPRESSED cache entry (``memory.DeviceCacheManager``) is
  RunLength, Dictionary or the plain byte codec, whichever measures
  smallest.  For a 1-D array the scheme and payload are the
  reference's, with one exception: runs are found on the values' BITS,
  so ``-0.0`` after ``0.0`` starts a run and comes back as ``-0.0``
  (the reference compares floats by value and merges them).  An array
  column's ``(capacity, max_len)`` plane goes to the byte codec whole.

Everything here runs on the host: the card holds only dense columns.
"""

from __future__ import annotations

import bz2
import lzma
import zlib
from typing import Callable, Dict, Tuple

import numpy as np

CODECS: Dict[str, Tuple[Callable[[bytes], bytes], Callable[[bytes], bytes]]] = {
    "none": (lambda b: b, lambda b: b),
    "zlib": (lambda b: zlib.compress(b, 1), zlib.decompress),
    "lzma": (lambda b: lzma.compress(b, preset=0), lzma.decompress),
    "bz2": (lambda b: bz2.compress(b, 1), bz2.decompress),
}

try:  # optional wheels: registered only when importable
    import lz4.frame as _lz4  # pragma: no cover

    CODECS["lz4"] = (_lz4.compress, _lz4.decompress)  # pragma: no cover
except Exception:
    pass

try:
    import zstandard as _zstd  # pragma: no cover

    CODECS["zstd"] = (  # pragma: no cover
        lambda b: _zstd.ZstdCompressor().compress(b),
        lambda b: _zstd.ZstdDecompressor().decompress(b))
except Exception:
    pass


def compress(data: bytes, codec: str) -> bytes:
    return CODECS[codec][0](data)


def decompress(data: bytes, codec: str) -> bytes:
    return CODECS[codec][1](data)


# ---------------------------------------------------------------------------
# columnar encodings (compressionSchemes.scala analog)
# ---------------------------------------------------------------------------

class EncodedColumn:
    """One encoded fixed-width column; scheme chosen by measured size.
    ``shape`` is the array's (a plane's two dimensions)."""

    __slots__ = ("scheme", "dtype", "shape", "payload")

    def __init__(self, scheme: str, dtype, shape: Tuple[int, ...], payload):
        self.scheme = scheme
        self.dtype = dtype
        self.shape = shape
        self.payload = payload

    @property
    def length(self) -> int:
        return self.shape[0]

    @property
    def nbytes(self) -> int:
        if self.scheme in ("rle", "dict"):
            a, b = self.payload
            return a.nbytes + b.nbytes
        return len(self.payload)


def _bits(arr: np.ndarray) -> np.ndarray:
    """``arr`` as unsigned integers of its width: equal bits compare
    equal (``-0.0`` differs from ``0.0``, a NaN equals itself)."""
    if arr.dtype.kind == "f":
        return arr.view(f"u{arr.itemsize}")
    return arr


def _rle(arr: np.ndarray):
    """(run lengths int32, each run's value) of a 1-D array."""
    if len(arr) == 0:
        return np.zeros(0, np.int32), arr
    bits = _bits(arr)
    change = np.empty(len(arr), bool)
    change[0] = True
    np.not_equal(bits[1:], bits[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    lengths = np.diff(np.append(starts, len(arr))).astype(np.int32)
    return lengths, arr[starts]


def encode_column(arr: np.ndarray, codec: str = "zlib") -> EncodedColumn:
    """Pick RunLength / Dictionary / plain codec by measured size; a
    plane (2-D) goes to the byte codec."""
    arr = np.ascontiguousarray(arr)
    n = len(arr)
    candidates = []
    if arr.ndim == 1:
        lengths, vals = _rle(arr)
        size = len(vals) * (arr.itemsize + 4)
        if size < arr.nbytes:
            candidates.append(("rle", (lengths, vals), size))
        if n and arr.dtype.kind in "iub":
            uniq, codes = np.unique(arr, return_inverse=True)
            size = len(uniq) * arr.itemsize + n * 2
            if len(uniq) <= 0xFFFF and size < arr.nbytes:
                candidates.append(("dict", (codes.astype(np.uint16), uniq),
                                   size))
    packed = compress(arr.tobytes(), codec)
    candidates.append((codec, packed, len(packed)))
    scheme, payload, _ = min(candidates, key=lambda c: c[2])
    return EncodedColumn(scheme, arr.dtype, arr.shape, payload)


def decode_column(enc: EncodedColumn) -> np.ndarray:
    if enc.scheme == "rle":
        lengths, vals = enc.payload
        return np.repeat(vals, lengths)
    if enc.scheme == "dict":
        codes, vals = enc.payload
        return vals[codes]
    raw = decompress(enc.payload, enc.scheme)
    return np.frombuffer(raw, enc.dtype).reshape(enc.shape).copy()
