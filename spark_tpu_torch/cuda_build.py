"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
under ``build/kernels/`` (named by a hash of the source and the flags, so
an edited source rebuilds) and bound with ctypes.  Builds happen at first
use, never at import; ``build_all`` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Sequence

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def library_path(source: str) -> str:
    with open(source, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                             ).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "only where the CUDA toolkit is installed")
    return nvcc


def build_all(sources: Sequence[str], verbose: bool = False) -> list:
    """Compile every source not built yet, one ``nvcc`` process each, all
    started together; returns the shared libraries' paths in order."""
    outs = [library_path(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not os.path.exists(o)]
    if not todo:
        return outs
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for src, out in todo:
        tmp = f"{out}.{os.getpid()}.tmp"      # ``load`` serializes threads
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, src]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        _stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n"
                          f"{stderr}")
            continue
        if verbose:
            print(stderr, end="")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return outs


def load(source: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The kernel's shared library, built at first use; ``bind`` sets the
    C functions' ``argtypes``/``restype`` once."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(build_all([source])[0])
            bind(lib)
            _LIBS[source] = lib
        return lib
