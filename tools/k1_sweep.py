#!/usr/bin/env python3
"""Design sweep of the grouped-accumulate kernel (K1) on one GPU.

    python3 tools/k1_sweep.py

Builds a copy of ``spark_tpu_torch/csrc/grouped_accumulate.cu`` per
variant of its tuning constants (threads a CTA, CTAs an SM aims for,
shared memory a CTA may take, ring stages, largest tile, CTAs of a
cluster), each with those lines changed, into ``build/kernels/sweep/``,
and times each on the hash-agg query's K1 inputs (2^22 rows of
``testing.hash_agg_table``, B = 4,096, n_active = 2; the planes of
``sum(v), count(*)``).  Every time is the kernel alone
(``torch.profiler``, mean of 20 launches):

* ``planes`` / ``columns`` — the two entries at those inputs;
* ``planes_dead`` / ``columns_dead`` — every bucket in a dead chunk: the
  tile pipeline with no accumulation;
* ``planes_zero`` — all planes zero: the row loop with no atomics;
* ``planes_small`` — the first 2^15 rows: one tile per CTA, so mostly
  launch, first load and flush.

A time is null where the profiler did not see every launch.

Each variant is first held bit-exact against the plain versions.  Prints
the card's name and power limit and one JSON line per variant, with the
launch each entry makes.  Needs a GPU and ``nvcc``; imports neither JAX nor the JAX
package.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

#: each variant: the source's tuning constants it changes (the source's
#: own values are kThreads 1024, kMinBlocks 1, kSmemBudget 232448,
#: kStages 2, kMaxTileRows 4096, kCluster 2)
VARIANTS = {
    "default": {},
    "cluster1": {"kCluster": 1},
    "cluster4": {"kCluster": 4},
    "cluster8": {"kCluster": 8},
    "stages3": {"kStages": 3},
    "stages3_rows3072": {"kStages": 3, "kMaxTileRows": 3072},
    "stages4_rows3072": {"kStages": 4, "kMaxTileRows": 3072},
    "stages4_rows2048": {"kStages": 4, "kMaxTileRows": 2048},
    "threads512": {"kThreads": 512},
    "threads512x2_stages4_rows1024": {
        "kThreads": 512, "kMinBlocks": 2, "kSmemBudget": 113664,
        "kStages": 4, "kMaxTileRows": 1024},
}


def variant_source(text, consts):
    """The kernel source with each ``constexpr int NAME = ...;`` of
    ``consts`` set to its value."""
    for name, value in consts.items():
        text, count = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
        if count != 1:
            raise ValueError(f"{name}: {count} definitions in the source")
    return text


def kernel_ms(fn, reps=20):
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "grouped_accumulate_kernel" in e.key]
    count = sum(e.count for e in hits)
    if count != reps:             # the profiler lost launches: no number
        return None
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from spark_tpu_torch import cuda_agg, cuda_build
    from spark_tpu_torch.testing import hash_agg_table

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = os.path.join(cuda_build.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    with open(cuda_agg.SOURCE) as f:
        text = f.read()
    procs = {}
    for name, consts in VARIANTS.items():
        src = os.path.join(out_dir, f"k1_{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(text, consts))
        lib = os.path.join(out_dir, f"libk1_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        _out, err = proc.communicate()
        regs = [ln.split("info    :")[-1].strip() for ln in err.splitlines()
                if "Used" in ln or "spill" in ln]
        print(f"[build] {name}: rc {proc.returncode}; {regs}", flush=True)
        if proc.returncode == 0:
            lib = ctypes.CDLL(path)
            cuda_agg._bind(lib)
            libs[name] = lib

    dev = torch.device("cuda")
    table = hash_agg_table(1 << 22, 1024)
    bucket = torch.from_numpy(table["k"].astype("int32")).to(dev)
    v = torch.from_numpy(table["v"]).to(dev)
    dead = bucket + 1024                       # chunks 2..3: past n_active
    B, na = 4096, torch.tensor([2], dtype=torch.int32, device=dev)
    planes = ([cuda_agg.Plane()]
              + [cuda_agg.Plane(None, v, i, -(1 << 63)) for i in range(8)]
              + [cuda_agg.Plane()])
    mat = torch.stack([cuda_agg.plane_values(p, v.shape[0], dev)
                       for p in planes], 1).contiguous()
    zero = torch.zeros_like(mat)
    small_b, small_m = bucket[:1 << 15].contiguous(), mat[:1 << 15].contiguous()
    want = cuda_agg.grouped_accumulate_plain(bucket, mat, na, B)
    for name, lib in libs.items():
        cuda_build._LIBS[cuda_agg.SOURCE] = lib
        exact = (torch.equal(cuda_agg.grouped_accumulate(bucket, mat, na, B),
                             want) and torch.equal(
            cuda_agg.grouped_accumulate_columns(bucket, planes, na, B), want))
        ms = {
            "planes": kernel_ms(lambda: cuda_agg.grouped_accumulate(
                bucket, mat, na, B)),
            "columns": kernel_ms(lambda: cuda_agg.grouped_accumulate_columns(
                bucket, planes, na, B)),
            "planes_dead": kernel_ms(lambda: cuda_agg.grouped_accumulate(
                dead, mat, na, B)),
            "columns_dead": kernel_ms(
                lambda: cuda_agg.grouped_accumulate_columns(
                    dead, planes, na, B)),
            "planes_zero": kernel_ms(lambda: cuda_agg.grouped_accumulate(
                bucket, zero, na, B)),
            "planes_small": kernel_ms(lambda: cuda_agg.grouped_accumulate(
                small_b, small_m, na, B)),
        }
        n = bucket.shape[0]
        launch = {"planes": cuda_agg.launch_shape(False, n, 10, B, 10),
                  "columns": cuda_agg.launch_shape(True, n, 10, B, 8)}
        print(json.dumps({"variant": name, "consts": VARIANTS[name],
                          "bit_exact": exact, "ms": ms, "launch": launch}),
              flush=True)
    cuda_build._LIBS.pop(cuda_agg.SOURCE, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
