#!/usr/bin/env python3
"""The in-process all-to-all (K2's ``all_to_all_kernel``) on one GPU, this
checkout's build against another's, in turns.

    python3 tools/k2_inprocess_ab.py OTHER_CHECKOUT

Builds ``spark_tpu_torch/csrc/all_to_all.cu`` of OTHER_CHECKOUT with this
checkout's ``nvcc`` flags into ``build/kernels/ab/`` and loads it beside
this checkout's library.  The inputs have the shapes of shuffled q3's
largest exchange at 4 shards (``chip_smoke.py``'s ``[k2]`` line: 4
participants, int32 x 3, int64 x 2 and bool planes of (4, 16,777,216)
each, 7.78 GB), random from a fixed seed.  Both libraries' outputs must
equal the plain version's.  Then, in turns OTHER, this, this, OTHER, each
is timed through ``cuda_a2a.all_to_all``: the kernel alone
(``torch.profiler``, the mean of 5 launches that one profile saw), back
to back (25 calls in one event pair) and per call (CUDA events, median of
25).  Prints the card's name and power limit and one JSON line per turn.
Needs a GPU and ``nvcc``; imports neither JAX nor the JAX package.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

CAP = 1 << 24


def main(argv) -> int:
    import torch
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k2_inprocess_ab: no CUDA device", file=sys.stderr)
        return 2
    from spark_tpu_torch import cuda_a2a, cuda_build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    other_src = os.path.join(os.path.abspath(argv[0]), "spark_tpu_torch",
                             "csrc", "all_to_all.cu")
    out_dir = os.path.join(cuda_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    other_lib = os.path.join(out_dir, "liball_to_all_other.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    other_lib, other_src], check=True)
    other = ctypes.CDLL(other_lib)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    other.spark_all_to_all.argtypes = [vp, i, i, i, ll, vp]
    other.spark_all_to_all.restype = i
    this = cuda_a2a._lib()

    i32, i64, b8 = torch.int32, torch.int64, torch.bool
    specs = [(i32, (CAP,))] * 3 + [(i64, (CAP,))] * 2 + [(b8, (CAP,))]
    planes = CS._random_planes(4, specs, 16)
    want = cuda_a2a.all_to_all_plain(planes)
    libs = {"other": other, "this": this}
    for name, lib in libs.items():
        cuda_build._LIBS[cuda_a2a.SOURCE] = lib
        got = cuda_a2a.all_to_all(planes)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        del got
    del want
    nbytes = 2 * CS._a2a_bytes(planes, False)
    try:
        for name in ("other", "this", "this", "other"):
            cuda_build._LIBS[cuda_a2a.SOURCE] = libs[name]

            def fn():
                cuda_a2a.all_to_all(planes)

            print(json.dumps({
                "build": name, "bytes": nbytes,
                "bound_ms": nbytes / CS.HBM_BYTES_PER_S * 1e3,
                "alone_ms": CS.kernel_device_ms(fn, "all_to_all_kernel",
                                                reps=5),
                "b2b_ms": CS.cuda_ms_back_to_back(fn),
                "ms": CS.cuda_ms(fn)}), flush=True)
    finally:
        cuda_build._LIBS[cuda_a2a.SOURCE] = this
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
