"""Host byte-stream codecs of the wire format.

The port of the codec registry of ``spark_tpu/codec.py`` (the
``CompressionCodec.scala`` analog): zlib, lzma and bz2 from the standard
library, registered under the reference's names and levels; lz4 and zstd
register themselves only when their wheels are importable.  The wire
format (``wire.py``) runs a column buffer through the session's codec
when that shrinks it.  The cache block encodings of the reference
(``EncodedColumn``) come with the host cache of the next slice.
"""

from __future__ import annotations

import bz2
import lzma
import zlib
from typing import Callable, Dict, Tuple

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
