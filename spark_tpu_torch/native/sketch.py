"""BloomFilter / CountMinSketch (``common/sketch`` analogs) for int64
items, through the C++ library (``src/sketch.cpp``, built at first use by
``build.py``).

The port of ``spark_tpu/native/sketch.py``.  Both sketches hash with
Murmur3_x86_32 by the reference's convention (``BloomFilterImpl.java``,
``CountMinSketchImpl.java``).  The numpy functions at the end are the
plain versions, bit for bit the reference's numpy lane; only tests and
``chip_smoke.py`` call them, to hold the C++ lane against.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from .build import load_library


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _longs(items) -> np.ndarray:
    return np.ascontiguousarray(np.atleast_1d(np.asarray(items, np.int64)))


def murmur3_hash_long(items, seed) -> np.ndarray:
    """Murmur3_x86_32 hashLong of each item; ``seed`` a scalar or one per
    item.  Returns int32."""
    items = _longs(items)
    out = np.empty(len(items), np.int32)
    seeds = None
    if np.ndim(seed):
        seeds = np.ascontiguousarray(
            np.broadcast_to(np.asarray(seed, np.int32), items.shape))
    load_library().murmur3_hash_longs(
        _ptr(items, ctypes.c_int64),
        None if seeds is None else _ptr(seeds, ctypes.c_int32),
        0 if seeds is not None else int(seed), len(items),
        _ptr(out, ctypes.c_int32))
    return out


class BloomFilter:
    """``util/sketch/BloomFilter.java`` for int64 items."""

    def __init__(self, expected_items: int, fpp: float = 0.03):
        n = max(int(expected_items), 1)
        m = int(math.ceil(-n * math.log(fpp) / (math.log(2) ** 2)))
        self.num_bits = max((m + 63) // 64 * 64, 64)
        self.num_hashes = max(int(round(self.num_bits / n * math.log(2))), 1)
        self.bits = np.zeros(self.num_bits // 64, np.uint64)

    @staticmethod
    def create(expected_items: int, fpp: float = 0.03) -> "BloomFilter":
        return BloomFilter(expected_items, fpp)

    def put_long(self, items) -> None:
        items = _longs(items)
        load_library().bloom_put_longs(
            _ptr(self.bits, ctypes.c_uint64), self.num_bits,
            self.num_hashes, _ptr(items, ctypes.c_int64), len(items))

    putLong = put_long

    def might_contain_long(self, items) -> np.ndarray:
        items = _longs(items)
        out = np.zeros(len(items), np.uint8)
        load_library().bloom_might_contain_longs(
            _ptr(self.bits, ctypes.c_uint64), self.num_bits,
            self.num_hashes, _ptr(items, ctypes.c_int64), len(items),
            _ptr(out, ctypes.c_uint8))
        return out.astype(bool)

    mightContainLong = might_contain_long

    def merge(self, other: "BloomFilter") -> "BloomFilter":
        if (self.num_bits, self.num_hashes) != (other.num_bits,
                                                other.num_hashes):
            raise ValueError("cannot merge Bloom filters of different "
                             "sizes or hash counts")
        self.bits |= other.bits
        return self


class CountMinSketch:
    """``util/sketch/CountMinSketch.java`` for int64 items."""

    def __init__(self, eps: float = 0.001, confidence: float = 0.99):
        self.width = int(math.ceil(2.0 / eps))
        self.depth = int(math.ceil(-math.log(1 - confidence) / math.log(2)))
        self.table = np.zeros((self.depth, self.width), np.int64)
        self.total = 0

    @staticmethod
    def create(eps: float = 0.001, confidence: float = 0.99
               ) -> "CountMinSketch":
        return CountMinSketch(eps, confidence)

    def add_long(self, items, count: int = 1) -> None:
        items = _longs(items)
        self.total += count * len(items)
        load_library().cms_add_longs(
            _ptr(self.table, ctypes.c_int64), self.depth, self.width,
            _ptr(items, ctypes.c_int64), len(items), count)

    addLong = add_long

    def estimate_count(self, items) -> np.ndarray:
        items = _longs(items)
        out = np.zeros(len(items), np.int64)
        load_library().cms_estimate_longs(
            _ptr(self.table, ctypes.c_int64), self.depth, self.width,
            _ptr(items, ctypes.c_int64), len(items),
            _ptr(out, ctypes.c_int64))
        return out

    estimateCount = estimate_count

    def merge(self, other: "CountMinSketch") -> "CountMinSketch":
        if self.table.shape != other.table.shape:
            raise ValueError("cannot merge count-min sketches of different "
                             "depth or width")
        self.table += other.table
        self.total += other.total
        return self


# ---------------------------------------------------------------------------
# the plain versions (numpy), bit for bit the reference's numpy lane
# ---------------------------------------------------------------------------

def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32)


def _mix_k1(k1):
    k1 = (k1 * np.uint32(0xcc9e2d51)).astype(np.uint32)
    k1 = ((k1 << np.uint32(15)) | (k1 >> np.uint32(17))).astype(np.uint32)
    return (k1 * np.uint32(0x1b873593)).astype(np.uint32)


def _mix_h1(h1, k1):
    h1 = (h1 ^ k1).astype(np.uint32)
    h1 = ((h1 << np.uint32(13)) | (h1 >> np.uint32(19))).astype(np.uint32)
    return (h1 * np.uint32(5) + np.uint32(0xe6546b64)).astype(np.uint32)


def murmur3_hash_long_plain(items, seed) -> np.ndarray:
    items = np.asarray(items, np.int64)
    x = items.view(np.uint64)
    low = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    high = (x >> np.uint64(32)).astype(np.uint32)
    h1 = _u32(np.broadcast_to(np.asarray(seed, np.int32), items.shape))
    h1 = _mix_h1(h1, _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    h = (h1 ^ np.uint32(8)).astype(np.uint32)
    h ^= h >> np.uint32(16)
    h = (h * np.uint32(0x85ebca6b)).astype(np.uint32)
    h ^= h >> np.uint32(13)
    h = (h * np.uint32(0xc2b2ae35)).astype(np.uint32)
    h ^= h >> np.uint32(16)
    return h.view(np.int32)


def _probe_positions(items: np.ndarray, num_hashes: int,
                     num_bits: int) -> np.ndarray:
    """(n, k) bit positions, BloomFilterImpl's double-hash scheme."""
    h1 = murmur3_hash_long_plain(items, 0)
    h2 = murmur3_hash_long_plain(items, h1)
    i = np.arange(1, num_hashes + 1, dtype=np.int32)
    combined = (h1[:, None] + i[None, :] * h2[:, None]).astype(np.int32)
    combined = np.where(combined < 0, ~combined, combined)
    return combined.astype(np.int64) % num_bits


def bloom_put_plain(bf: BloomFilter, items) -> None:
    pos = _probe_positions(_longs(items), bf.num_hashes, bf.num_bits)
    np.bitwise_or.at(bf.bits, pos.ravel() >> 6,
                     np.uint64(1) << (pos.ravel() & 63).astype(np.uint64))


def bloom_might_contain_plain(bf: BloomFilter, items) -> np.ndarray:
    pos = _probe_positions(_longs(items), bf.num_hashes, bf.num_bits)
    word = bf.bits[pos >> 6]
    bit = np.uint64(1) << (pos & 63).astype(np.uint64)
    return ((word & bit) != 0).all(axis=1)


def _cms_columns(cms: CountMinSketch, items: np.ndarray) -> np.ndarray:
    h = np.stack([murmur3_hash_long_plain(items, s)
                  for s in range(cms.depth)], 1)
    h = np.where(h < 0, ~h, h)
    return h.astype(np.int64) % cms.width


def cms_add_plain(cms: CountMinSketch, items, count: int = 1) -> None:
    items = _longs(items)
    cms.total += count * len(items)
    cols = _cms_columns(cms, items)
    for i in range(cms.depth):
        np.add.at(cms.table[i], cols[:, i], count)


def cms_estimate_plain(cms: CountMinSketch, items) -> np.ndarray:
    cols = _cms_columns(cms, _longs(items))
    return np.stack([cms.table[i][cols[:, i]]
                     for i in range(cms.depth)], 1).min(axis=1)
