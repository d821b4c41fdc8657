"""Columnar wire format: framed blocks of raw column buffers, no pickle.

The port of ``spark_tpu/wire.py``, byte for byte: a frame written by
either package decodes in the other.  Here it is the spill format of
``sql/multibatch.SpilledRuns``.  A batch list is framed as a compact
JSON header (schema, row counts, dtypes, dictionaries, buffer table)
followed by per-column contiguous raw buffers::

    0   4   magic  b"STCB"
    4   1   format version (1)
    5   3   reserved (zero)
    8   4   u32  header length
    12  8   u64  payload length
    20  4   u32  adler32(header bytes + payload bytes)
    24  ..  header (JSON, utf-8)
    ..  ..  payload (concatenated column buffers)

Buffers at or above ``spark.tpu.shuffle.wire.compressThreshold`` bytes
go through the session codec (``codec.CODECS``) and are kept only when
smaller; validity masks are bit-packed.  With ``run_codes`` an integral
column ships the cheaper of raw, a run table (``rle``) or narrow deltas
(``delta``), tagged ``"enc"`` in its header entry.  A frame shorter
than its own length fields raises ``TruncatedBlockError``; a same-length
corruption fails the checksum as ``ChecksumError``.

Everything here runs on the host (numpy): batches on a card come to the
host first.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import codec as _codec
from . import config as C
from . import types as T
from .columnar import ColumnBatch, ColumnVector

__all__ = [
    "MAGIC", "WIRE_VERSION", "WireFormatError", "ChecksumError",
    "TruncatedBlockError", "DictFingerprintError", "encode_batches",
    "decode_batches", "decode_frames", "dict_fingerprint",
    "encode_dict_table", "decode_dict_table", "frame_info",
    "frame_length", "raw_nbytes", "payload_nbytes", "trim_host",
    "rle_encode", "delta_encode", "delta_decode",
]

MAGIC = b"STCB"
WIRE_VERSION = 1
_PREFIX = struct.Struct("<4sB3xIQI")        # magic, ver, hlen, plen, cksum
PREFIX_LEN = _PREFIX.size                   # 24


class WireFormatError(ValueError):
    """The bytes are not a well-formed wire block (bad magic/version,
    malformed header, or one of the typed subclasses below)."""


class TruncatedBlockError(WireFormatError):
    """The frame is shorter than its own declared lengths (torn write)."""


class ChecksumError(WireFormatError):
    """Frame-length bytes arrived but the checksum disagrees."""


class DictFingerprintError(WireFormatError):
    """A column references a deduplicated dictionary by fingerprint that
    the caller's dictionary table does not hold (the block is intact)."""

    def __init__(self, msg: str, fingerprint: str = ""):
        super().__init__(msg)
        self.fingerprint = fingerprint


def default_codec(conf: Optional[C.Conf] = None) -> str:
    return (conf or C.Conf()).get(C.SHUFFLE_WIRE_CODEC)


def default_threshold(conf: Optional[C.Conf] = None) -> int:
    return (conf or C.Conf()).get(C.SHUFFLE_WIRE_COMPRESS_THRESHOLD)


# ---------------------------------------------------------------------------
# run-length / delta codecs (host numpy; the "enc" tags)
# ---------------------------------------------------------------------------

def rle_encode(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(run_values, run_lengths)`` of a 1-D host array."""
    data = np.asarray(data)
    n = len(data)
    if n == 0:
        return data[:0], np.zeros(0, np.int64)
    change = np.nonzero(data[1:] != data[:-1])[0] + 1
    starts = np.concatenate([np.zeros(1, np.int64), change])
    lengths = np.diff(np.concatenate([starts, np.asarray([n], np.int64)]))
    return data[starts], lengths.astype(np.int64)


def delta_encode(data: np.ndarray) -> Optional[Tuple[int, np.ndarray]]:
    """``(base, diffs)`` with diffs in the narrowest of int8/int16/int32
    that bounds them (int64 modular arithmetic, so the cumsum decode is
    exact across wraparound); None when no narrower dtype exists."""
    data = np.asarray(data)
    if len(data) < 2:
        return None
    d64 = np.diff(data.astype(np.int64))
    lo, hi = int(d64.min()), int(d64.max())
    for cand in (np.int8, np.int16, np.int32):
        if np.dtype(cand).itemsize >= data.dtype.itemsize:
            break
        info = np.iinfo(cand)
        if info.min <= lo and hi <= info.max:
            return int(data[0]), d64.astype(cand)
    return None


def delta_decode(base: int, diffs: np.ndarray, np_dtype, n: int
                 ) -> np.ndarray:
    """cumsum reconstruction of a delta-encoded column."""
    if n == 0:
        return np.zeros(0, np_dtype)
    d = np.asarray(diffs).astype(np.int64)
    prefix = np.concatenate([np.zeros(1, np.int64), np.cumsum(d)])
    return (np.int64(base) + prefix).astype(np_dtype)


# ---------------------------------------------------------------------------
# dictionaries in the header
# ---------------------------------------------------------------------------

def _dict_to_header(d: Optional[Tuple]) -> Optional[dict]:
    """A column dictionary as JSON: strings directly, bytes via base64."""
    if d is None:
        return None
    if any(isinstance(v, (bytes, bytearray)) for v in d):
        return {"enc": "b64",
                "items": [base64.b64encode(bytes(v)).decode("ascii")
                          for v in d]}
    return {"enc": "str", "items": list(d)}


def _dict_from_header(h: Optional[dict]) -> Optional[Tuple]:
    if h is None:
        return None
    if h["enc"] == "b64":
        return tuple(base64.b64decode(v) for v in h["items"])
    return tuple(h["items"])


_FP_MEMO: Dict[Tuple, str] = {}


def dict_fingerprint(words: Tuple) -> str:
    """Content fingerprint of a column dictionary (8-byte blake2b, hex),
    length-prefixed per word; the empty dictionary has one too."""
    fp = _FP_MEMO.get(words)
    if fp is not None:
        return fp
    h = hashlib.blake2b(digest_size=8)
    for w in words:
        b = w if isinstance(w, (bytes, bytearray)) else str(w).encode("utf-8")
        h.update(len(b).to_bytes(4, "little"))
        h.update(bytes(b))
    fp = h.hexdigest()
    if len(_FP_MEMO) >= 1024:
        _FP_MEMO.clear()
    _FP_MEMO[words] = fp
    return fp


def _dict_inline_cost(words: Tuple) -> int:
    return len(json.dumps(_dict_to_header(words), separators=(",", ":")))


# ---------------------------------------------------------------------------
# buffer table
# ---------------------------------------------------------------------------

class _PayloadWriter:
    """Accumulates column buffers; compresses above the threshold when it
    shrinks the buffer."""

    def __init__(self, codec: str, threshold: int):
        self.codec = codec if codec in _codec.CODECS else "zlib"
        self.threshold = threshold
        self.parts: List[bytes] = []
        self.offset = 0

    def add(self, raw: bytes) -> dict:
        codec = "none"
        out = raw
        if self.codec != "none" and len(raw) >= self.threshold:
            packed = _codec.compress(raw, self.codec)
            if len(packed) < len(raw):
                out, codec = packed, self.codec
        entry = {"off": self.offset, "len": len(out), "raw": len(raw),
                 "codec": codec}
        self.parts.append(out)
        self.offset += len(out)
        return entry

    def payload(self) -> bytes:
        return b"".join(self.parts)


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _buffer_view(payload: memoryview, entry: dict) -> memoryview:
    off, ln = entry["off"], entry["len"]
    view = payload[off:off + ln]
    if entry["codec"] != "none":
        return memoryview(_codec.decompress(bytes(view), entry["codec"]))
    return view


def _decode_array(payload: memoryview, entry: dict, np_dtype,
                  shape: Sequence[int]) -> np.ndarray:
    arr = np.frombuffer(_buffer_view(payload, entry), dtype=np_dtype)
    return arr.reshape(tuple(shape))


def _decode_bitmask(payload: memoryview, entry: dict, n: int) -> np.ndarray:
    buf = _buffer_view(payload, entry)
    return np.unpackbits(np.frombuffer(buf, np.uint8), count=n).astype(bool)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def raw_nbytes(batches: Sequence[ColumnBatch]) -> int:
    """Uncompressed payload size of ``batches`` (arithmetic only)."""
    total = 0
    for b in batches:
        for v in b.vectors:
            total += v.data.numel() * v.data.element_size()
            if v.valid is not None:
                total += (b.capacity + 7) // 8
        if b.row_valid is not None:
            total += (b.capacity + 7) // 8
    return total


def payload_nbytes(batches: Sequence[ColumnBatch]) -> int:
    """``raw_nbytes`` plus the dictionary words the codes reference."""
    total = raw_nbytes(batches)
    for b in batches:
        for v in b.vectors:
            words = v.dictionary
            if not words:
                continue
            codes = _np(v.data.cpu()).ravel()
            codes = codes[(codes >= 0) & (codes < len(words))]
            for c in np.unique(codes):
                total += len(words[int(c)])
    return total


#: header growth an "enc" tag must beat before a column leaves raw
_ENC_MARGIN = 48

#: columns shorter than this never probe
_MIN_RUN_ROWS = 16


def _choose_run_encoding(data: np.ndarray, run_hint: bool):
    """The cheapest of rle/delta/raw for one 1-D integral column:
    ``("rle", values, lengths)``, ``("delta", base, diffs)`` or None."""
    n = len(data)
    itemsize = data.dtype.itemsize
    raw_cost = n * itemsize
    delta_eligible = data.dtype.kind == "i" and itemsize >= 2
    if not run_hint:
        sample = data[:512]
        changes = int(np.count_nonzero(sample[1:] != sample[:-1]))
        est_runs = max(1, (changes * n) // max(1, len(sample) - 1))
        rle_plausible = est_runs * (itemsize + 8) + _ENC_MARGIN < raw_cost
        if not rle_plausible and not delta_eligible:
            return None
    best = None
    best_cost = raw_cost - _ENC_MARGIN
    rvals, rlens = rle_encode(data)
    rle_cost = rvals.nbytes + rlens.nbytes
    if rle_cost < best_cost:
        best, best_cost = ("rle", rvals, rlens), rle_cost
    if delta_eligible:
        de = delta_encode(data)
        if de is not None:
            base, diffs = de
            if diffs.nbytes + 16 < best_cost:
                best = ("delta", base, diffs)
    return best


def _bump(stats: Optional[Dict[str, int]], key: str, n: int) -> None:
    if stats is not None and n:
        stats[key] = stats.get(key, 0) + n


def _packbits(mask) -> bytes:
    return np.packbits(_np(mask).astype(bool)).tobytes()


def encode_batches(batches: Sequence[ColumnBatch], *,
                   codec: Optional[str] = None,
                   compress_threshold: Optional[int] = None,
                   conf: Optional[C.Conf] = None,
                   dict_refs: Optional[Dict[str, Tuple]] = None,
                   stats: Optional[Dict[str, int]] = None,
                   run_codes: bool = False,
                   run_hint: bool = False) -> bytes:
    """One framed wire block holding ``batches`` (batches on a card come
    to the host first).  Capacity, row masks, validity and dictionaries
    round-trip exactly; padding removal is the caller's (``trim_host``).

    ``dict_refs`` (a {fingerprint: words} registry) switches dictionary
    columns to the deduplicated encoding: the header carries an 8-byte
    ``"dfp"`` and ``decode_batches`` needs the table back.
    ``run_codes`` turns on the per-column run-length/delta encoding;
    ``run_hint`` skips its sampled probe."""
    codec = codec if codec is not None else default_codec(conf)
    threshold = (compress_threshold if compress_threshold is not None
                 else default_threshold(conf))
    w = _PayloadWriter(codec, threshold)
    metas: List[dict] = []
    for b in batches:
        b = b.to_host()
        cols: List[dict] = []
        for v in b.vectors:
            enc_meta = None
            data_entry = None
            data = _np(v.data)
            if run_codes and data.ndim == 1 and data.dtype.kind in "iub" \
                    and len(data) >= _MIN_RUN_ROWS:
                choice = _choose_run_encoding(data, run_hint)
                if choice is not None and choice[0] == "rle":
                    _, rvals, rlens = choice
                    data_entry = w.add(np.ascontiguousarray(rvals).tobytes())
                    enc_meta = {"k": "rle", "nr": int(len(rvals)),
                                "lens": w.add(np.ascontiguousarray(
                                    rlens).tobytes())}
                    _bump(stats, "rle_columns_encoded", 1)
                    _bump(stats, "run_bytes_saved",
                          data.nbytes - rvals.nbytes - rlens.nbytes)
                elif choice is not None:
                    _, base, diffs = choice
                    data_entry = w.add(np.ascontiguousarray(diffs).tobytes())
                    enc_meta = {"k": "delta", "base": base,
                                "dnp": diffs.dtype.str}
                    _bump(stats, "rle_columns_encoded", 1)
                    _bump(stats, "run_bytes_saved",
                          data.nbytes - diffs.nbytes)
            if data_entry is None:
                data_entry = w.add(np.ascontiguousarray(data).tobytes())
            cm = {
                "dtype": v.dtype.simpleString(),
                "np": data.dtype.str,
                "shape": list(data.shape),
                "dict": _dict_to_header(v.dictionary),
                "data": data_entry,
                "valid": None if v.valid is None else w.add(_packbits(v.valid)),
            }
            if enc_meta is not None:
                cm["enc"] = enc_meta
            if dict_refs is not None and v.dictionary is not None:
                fp = dict_fingerprint(v.dictionary)
                if stats is not None:
                    stats["dict_columns_encoded"] = \
                        stats.get("dict_columns_encoded", 0) + 1
                    if fp in dict_refs:
                        stats["dict_bytes_saved"] = \
                            stats.get("dict_bytes_saved", 0) \
                            + _dict_inline_cost(v.dictionary)
                dict_refs[fp] = v.dictionary
                cm["dict"] = None
                cm["dfp"] = fp
            cols.append(cm)
        metas.append({
            "names": list(b.names),
            "capacity": int(b.capacity),
            "columns": cols,
            "row_valid": None if b.row_valid is None
            else w.add(_packbits(b.row_valid)),
        })
    header = json.dumps({"batches": metas},
                        separators=(",", ":")).encode("utf-8")
    payload = w.payload()
    cksum = zlib.adler32(payload, zlib.adler32(header))
    prefix = _PREFIX.pack(MAGIC, WIRE_VERSION, len(header), len(payload),
                          cksum)
    return prefix + header + payload


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _split_frame(buf) -> Tuple[dict, memoryview]:
    if len(buf) < PREFIX_LEN:
        if bytes(buf[:4]) == MAGIC[:min(4, len(buf))] and len(buf) > 0:
            raise TruncatedBlockError(
                f"frame prefix truncated: {len(buf)} of {PREFIX_LEN} bytes")
        raise WireFormatError("not a wire block: shorter than the prefix")
    magic, ver, hlen, plen, cksum = _PREFIX.unpack_from(buf)
    if magic != MAGIC:
        raise WireFormatError(f"bad magic {bytes(magic)!r}")
    if ver != WIRE_VERSION:
        raise WireFormatError(f"unsupported wire version {ver}")
    if len(buf) < PREFIX_LEN + hlen + plen:
        raise TruncatedBlockError(
            f"frame truncated: {len(buf)} of {PREFIX_LEN + hlen + plen} "
            "bytes")
    mv = memoryview(buf)
    header_b = mv[PREFIX_LEN:PREFIX_LEN + hlen]
    payload = mv[PREFIX_LEN + hlen:PREFIX_LEN + hlen + plen]
    got = zlib.adler32(payload, zlib.adler32(header_b))
    if got != cksum:
        raise ChecksumError(
            f"block checksum mismatch: stored {cksum:#010x}, "
            f"computed {got:#010x}")
    try:
        header = json.loads(bytes(header_b))
    except json.JSONDecodeError as e:   # checksum passed: an encoder bug
        raise WireFormatError(f"unparseable header: {e}")
    return header, payload


def frame_info(buf: bytes) -> dict:
    """The decoded frame header; every column meta gains ``"enc_tag"``
    (``raw``/``rle``/``delta``)."""
    header, _ = _split_frame(buf)
    for meta in header.get("batches", []):
        for cm in meta.get("columns", []):
            enc = cm.get("enc")
            cm["enc_tag"] = enc["k"] if enc else "raw"
    return header


def frame_length(buf) -> int:
    """Total byte length of the frame at the start of ``buf``, from the
    prefix alone (the walk over a file of back-to-back frames)."""
    if len(buf) < PREFIX_LEN:
        if bytes(buf[:4]) == MAGIC[:min(4, len(buf))] and len(buf) > 0:
            raise TruncatedBlockError(
                f"frame prefix truncated: {len(buf)} of {PREFIX_LEN} bytes")
        raise WireFormatError("not a wire block: shorter than the prefix")
    magic, ver, hlen, plen, _ = _PREFIX.unpack_from(buf)
    if magic != MAGIC:
        raise WireFormatError(f"bad magic {bytes(magic)!r}")
    if ver != WIRE_VERSION:
        raise WireFormatError(f"unsupported wire version {ver}")
    return PREFIX_LEN + hlen + plen


def _decode_run_column(payload: memoryview, cm: dict) -> np.ndarray:
    """The dense data of one ``enc``-tagged column; the run or delta
    table is validated against the declared row count, so a malformed
    frame fails as ``WireFormatError``.  A run-coded column decodes to a
    dense vector here: lazy run vectors, which keep the run table
    through run-aware operators, come with the next slice."""
    enc = cm["enc"]
    kind = enc.get("k")
    n = int(cm["shape"][0])
    np_dt = np.dtype(cm["np"])
    try:
        if kind == "rle":
            nr = int(enc["nr"])
            rvals = _decode_array(payload, cm["data"], np_dt, [nr])
            rlens = _decode_array(payload, enc["lens"], np.int64, [nr])
        elif kind == "delta":
            diffs = _decode_array(payload, cm["data"],
                                  np.dtype(enc["dnp"]), [max(0, n - 1)])
        else:
            raise WireFormatError(f"unknown column encoding {kind!r}")
    except ValueError as e:
        raise WireFormatError(f"malformed {kind} column buffers: {e}")
    if kind == "delta":
        return delta_decode(int(enc["base"]), diffs, np_dt, n)
    if len(rlens) and int(rlens.min()) < 0:
        raise WireFormatError("malformed run table: negative run length")
    total = int(rlens.sum())
    if total != n:
        raise WireFormatError(
            f"malformed run table: lengths sum to {total}, header "
            f"declares {n} rows")
    return np.repeat(rvals, rlens)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    # frombuffer views are read-only; torch wants a writable array
    return torch.from_numpy(np.array(arr, copy=True))


def decode_batches(buf, dict_table: Optional[Dict[str, Tuple]] = None
                   ) -> List[ColumnBatch]:
    """One framed block back into host ``ColumnBatch`` objects.  A column
    holding only a ``"dfp"`` fingerprint resolves through ``dict_table``
    (``DictFingerprintError`` when it is missing)."""
    header, payload = _split_frame(buf)
    out: List[ColumnBatch] = []
    for meta in header["batches"]:
        cap = meta["capacity"]
        vectors: List[ColumnVector] = []
        for cm in meta["columns"]:
            dt = T.type_for_name(cm["dtype"])
            fp = cm.get("dfp")
            if cm["dict"] is not None:
                d = _dict_from_header(cm["dict"])
            elif fp is not None:
                if dict_table is None or fp not in dict_table:
                    raise DictFingerprintError(
                        f"block references unknown dictionary {fp}",
                        fingerprint=fp)
                d = dict_table[fp]
            else:
                d = None
            valid = None if cm["valid"] is None else torch.from_numpy(
                _decode_bitmask(payload, cm["valid"], cap))
            if cm.get("enc") is not None:
                data = _decode_run_column(payload, cm)
            else:
                data = _decode_array(payload, cm["data"], np.dtype(cm["np"]),
                                     cm["shape"])
            vectors.append(ColumnVector(_tensor(data), dt, valid, d))
        rv = None if meta["row_valid"] is None else torch.from_numpy(
            _decode_bitmask(payload, meta["row_valid"], cap))
        out.append(ColumnBatch(meta["names"], vectors, rv, cap))
    return out


def decode_frames(buf, dict_table: Optional[Dict[str, Tuple]] = None
                  ) -> List[ColumnBatch]:
    """Every frame of a buffer of back-to-back wire blocks, in order."""
    mv = memoryview(buf)
    out: List[ColumnBatch] = []
    off = 0
    while off < len(mv) or off == 0:
        ln = frame_length(mv[off:])
        out.extend(decode_batches(mv[off:], dict_table=dict_table))
        off += ln
        if off >= len(mv):
            break
    return out


# ---------------------------------------------------------------------------
# dictionary sidecar
# ---------------------------------------------------------------------------

def encode_dict_table(table: Dict[str, Tuple]) -> bytes:
    """A {fingerprint: words} table as its own checksummed frame."""
    header = json.dumps(
        {"dicts": {fp: _dict_to_header(words)
                   for fp, words in sorted(table.items())}},
        separators=(",", ":")).encode("utf-8")
    cksum = zlib.adler32(header)
    return _PREFIX.pack(MAGIC, WIRE_VERSION, len(header), 0, cksum) + header


def decode_dict_table(buf: bytes) -> Dict[str, Tuple]:
    header, _ = _split_frame(buf)
    if "dicts" not in header:
        raise WireFormatError("not a dictionary sidecar frame")
    return {fp: _dict_from_header(h) for fp, h in header["dicts"].items()}


# ---------------------------------------------------------------------------
# padding removal
# ---------------------------------------------------------------------------

def trim_host(batch: ColumnBatch) -> ColumnBatch:
    """Drop the dead rows of a host batch: capacity becomes the live row
    count and ``row_valid`` disappears (order-preserving)."""
    if batch.row_valid is None:
        return batch
    rv = batch.row_valid
    if bool(rv.all()):
        return ColumnBatch(list(batch.names), list(batch.vectors), None,
                           batch.capacity)
    idx = torch.nonzero(rv).flatten()
    vectors = [ColumnVector(v.data[idx], v.dtype,
                            None if v.valid is None else v.valid[idx],
                            v.dictionary) for v in batch.vectors]
    return ColumnBatch(list(batch.names), vectors, None, int(idx.numel()))
