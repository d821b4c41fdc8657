"""Build and load the port's C++ host library at first use.

``src/sketch.cpp`` is compiled with ``g++ -O3 -shared -fPIC`` into
``build/native/`` at the checkout's root (named by a hash of the source
and the flags, so an edited source rebuilds) and bound with ctypes.  A
build that fails raises: nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "src", "sketch.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG)), "build",
                         "native")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def library_path(source: str, build_dir: str = BUILD_DIR) -> str:
    with open(source, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()
                             ).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(build_dir, f"lib{stem}_{tag}.so")


def _compile(source: str, out: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's C++ host library "
                           f"({os.path.basename(source)}) cannot be built")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, source, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {os.path.basename(source)} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)          # atomic against concurrent builds


def load_library(source: str = SOURCE,
                 build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """The compiled library of ``source``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            out = library_path(source, build_dir)
            if not os.path.exists(out):
                _compile(source, out)
            lib = ctypes.CDLL(out)
            if source == SOURCE:
                _sign(lib)
            _LIBS[source] = lib
        return lib


def _sign(lib: ctypes.CDLL) -> None:
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    p_i32 = ctypes.POINTER(i32)
    p_i64 = ctypes.POINTER(i64)
    p_u64 = ctypes.POINTER(ctypes.c_uint64)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.murmur3_hash_longs.restype = None
    lib.murmur3_hash_longs.argtypes = [p_i64, p_i32, i32, i64, p_i32]
    lib.bloom_put_longs.restype = None
    lib.bloom_put_longs.argtypes = [p_u64, i64, i32, p_i64, i64]
    lib.bloom_might_contain_longs.restype = None
    lib.bloom_might_contain_longs.argtypes = [p_u64, i64, i32, p_i64, i64,
                                              p_u8]
    lib.cms_add_longs.restype = None
    lib.cms_add_longs.argtypes = [p_i64, i32, i32, p_i64, i64, i64]
    lib.cms_estimate_longs.restype = None
    lib.cms_estimate_longs.argtypes = [p_i64, i32, i32, p_i64, i64, p_i64]
