#!/usr/bin/env python3
"""Probe and design sweep of K2's cross-process pull on one GPU.

    python3 tools/k2_pull_sweep.py            # the probe, then the sweep
    python3 tools/k2_pull_sweep.py probe      # the probe only

Over the bytes of ``chip_smoke.py``'s idle-peer pull (6 int64 planes, 1
sender, at 85,467,840 B and at 64 MiB as that script rounds it,
67,108,896 B) and at 67,108,848 B (an odd row count: planes 1, 3 and 5
start at 8 mod 16), from two kinds of source memory:

* ``ipc`` — an arena held by an idle peer process (``python -m
  spark_tpu_torch.testing arena-peer``), mapped here by CUDA IPC, as the
  device tier's pull reads it;
* ``local`` — a ``cudaMalloc`` arena of this process (``cuda_a2a.Arena``).

The probe times, on each: ``a2a_kernel`` (``all_to_all_kernel`` launched
with one participant, which is the launch the pull made before it had a
kernel of its own: the same grid of 64 KiB chunks and the same 32 KB
table, built per call as that wrapper built it) and ``copy_`` (one
``torch.Tensor.copy_`` per plane, the library call).  The sweep times
``cuda_a2a.pull`` at each (ring stages, stage bytes, blocks per SM) of
``VARIANTS`` into output rows padded to 16 bytes, as ``device_pull``
allocates them.  Every route is first checked equal to the peer's
bytes.

Each time: per call (CUDA events around each call, median of 25), back
to back (25 calls in one event pair), alone (``torch.profiler``: the
device records of 20 calls, between two one-element fills, inside 50 ms
of idle at each end; null where a profile did not see every record) and
the host time of one call from an idle device.  Prints the card's name
and power limit, then one JSON line per (size, memory, route) and the
best variant per size.  Needs a GPU and ``nvcc``; imports neither JAX
nor the JAX package.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

PLANES = CS.ICI_IDLE_PLANES
SIZES = (85_467_840, 67_108_896, 67_108_848)

#: (ring stages, stage bytes, blocks per SM) of the pull kernel
VARIANTS = [(2, 32768, 1), (4, 32768, 1), (3, 65536, 1), (8, 16384, 1),
            (2, 32768, 2), (4, 16384, 2), (3, 32768, 2), (2, 16384, 4),
            (4, 8192, 4), (3, 16384, 4), (2, 8192, 8), (4, 4096, 8)]


def _a2a_before(lib, sources, outs):
    """The pull as it ran before its own kernel: ``all_to_all_kernel``
    with one participant (n_dst = 1), the 32 KB table built per call."""
    import torch
    src, dst, nbytes, stride, first = [], [], [], [], [0]
    for ptrs, out in zip(sources, outs):
        bb = out[0].numel() * out.element_size()
        src += [int(p) for p in ptrs]
        dst.append(out.data_ptr())
        nbytes.append(bb)
        stride.append(0)
        first.append(first[-1] + -(-bb // (64 * 1024)))
    entries = src + dst + nbytes + stride + first
    table = (ctypes.c_longlong * len(entries))(*entries)
    with torch.cuda.device(outs[0].device):
        stream = torch.cuda.current_stream(outs[0].device).cuda_stream
        rc = lib.spark_all_to_all(table, len(entries), len(outs), 1,
                                  first[-1], stream)
    if rc != 0:
        raise RuntimeError(f"all_to_all_kernel failed: CUDA error {rc}")


def alone_ms(fn, per_call, reps=20, attempts=3):
    """Device time per call under ``torch.profiler``: every device record
    but the markers, over ``reps`` calls; None unless one profile saw
    ``per_call * reps`` records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(CS.PROFILE_PAD_S)
            marker.fill_(1.0)
            for _ in range(reps):
                fn()
            marker.fill_(1.0)
            torch.cuda.synchronize()
            time.sleep(CS.PROFILE_PAD_S)
        recs = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "FillFunctor" not in e.key]
        count = sum(e.count for e in recs)
        if count == per_call * reps:
            us = sum(getattr(e, "self_device_time_total", 0) for e in recs)
            return us / reps / 1e3
    return None


def host_split(lib, cuda_a2a, sources, outs, nbytes):
    """The pull wrapper's host time split: the plan and table
    (``pull_plan``), the stream lookup, and the library call that
    launches (from a table built once), each from an idle device."""
    import torch
    dev = outs[0].device
    dst = [o.data_ptr() for o in outs]
    rows = [o.nbytes // o.shape[0] for o in outs]
    table, total = cuda_a2a.pull_plan(sources, dst, nbytes, rows,
                                      cuda_a2a.PULL_STAGE_BYTES)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = lib.spark_a2a_pull(
            table.buffer_info()[0], len(table), len(outs), len(sources[0]),
            total, cuda_a2a.PULL_STAGES, cuda_a2a.PULL_STAGE_BYTES,
            cuda_a2a.PULL_BLOCKS_PER_SM, dev.index or 0, stream)
        assert rc == 0, rc

    return {"pull_ms": CS.host_ms(lambda: cuda_a2a.pull(sources, outs,
                                                        nbytes)),
            "plan_ms": CS.host_ms(lambda: cuda_a2a.pull_plan(
                sources, dst, nbytes, rows, cuda_a2a.PULL_STAGE_BYTES)),
            "stream_ms": CS.host_ms(
                lambda: torch.cuda.current_stream(dev).cuda_stream),
            "launch_ms": CS.host_ms(launch)}


def timings(fn, per_call):
    return {"ms": CS.cuda_ms(fn), "b2b_ms": CS.cuda_ms_back_to_back(fn),
            "alone_ms": alone_ms(fn, per_call), "host_ms": CS.host_ms(fn)}


def _start_peer(root, nbytes):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    log = open(os.path.join(root, "peer.txt"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_tpu_torch.testing", "arena-peer", root,
         str(nbytes)], env=env, stdout=log, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 120
    while not os.path.exists(os.path.join(root, "arena.json")):
        if proc.poll() is not None or time.monotonic() > deadline:
            raise RuntimeError("the arena peer did not start: " + open(
                os.path.join(root, "peer.txt")).read()[-2000:])
        time.sleep(0.05)
    with open(os.path.join(root, "arena.json")) as f:
        return proc, log, json.load(f)["handle"]


def main(argv) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k2_pull_sweep: no CUDA device", file=sys.stderr)
        return 2
    from spark_tpu_torch import cuda_a2a
    from spark_tpu_torch.parallel.ici import _padded_rows
    from spark_tpu_torch.testing import arena_pattern
    probe_only = "probe" in argv
    default = (cuda_a2a.PULL_STAGES, cuda_a2a.PULL_STAGE_BYTES,
               cuda_a2a.PULL_BLOCKS_PER_SM)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    lib = cuda_a2a._lib()
    big = max(SIZES)
    pattern = arena_pattern(big)
    root = tempfile.mkdtemp(prefix="k2_pull_sweep_")
    proc, log, handle = _start_peer(root, big)
    local = cuda_a2a.Arena(dev, big)
    bases = {}
    try:
        bases["ipc"] = cuda_a2a.open_handle(dev, handle)
        local.write(0, pattern)
        torch.cuda.synchronize()
        bases["local"] = local.ptr
        best = {}
        for nbytes in SIZES:
            width = nbytes // PLANES // 8
            want = torch.from_numpy(pattern[:PLANES * width * 8]
                                    .view(np.int64).copy())
            outs = [torch.empty((1, width), dtype=torch.int64, device=dev)
                    for _ in range(PLANES)]
            pouts = [torch.empty((1, _padded_rows(width, 8)),
                                 dtype=torch.int64, device=dev)
                     for _ in range(PLANES)]
            bound = 2 * PLANES * width * 8 / CS.HBM_BYTES_PER_S * 1e3
            for memory, base in bases.items():
                sources = [[base + k * width * 8] for k in range(PLANES)]
                views = [torch.as_tensor(CS._DevicePointer(p[0], width * 8),
                                         device=dev).view(torch.int64)
                         for p in sources]

                def copy():
                    for o, v in zip(outs, views):
                        o[0].copy_(v)

                def pull():
                    cuda_a2a.pull(sources, pouts, [width * 8] * PLANES)

                routes = [("a2a_kernel", None,
                           lambda: _a2a_before(lib, sources, outs), 1, outs),
                          ("copy_", None, copy, PLANES, outs)]
                if not probe_only:
                    routes += [("pull", v, pull, 1, pouts)
                               for v in [None] + VARIANTS]
                for route, variant, fn, per_call, dest in routes:
                    (cuda_a2a.PULL_STAGES, cuda_a2a.PULL_STAGE_BYTES,
                     cuda_a2a.PULL_BLOCKS_PER_SM) = variant or default
                    for o in dest:
                        o.fill_(-1)
                    fn()
                    torch.cuda.synchronize()
                    exact = torch.equal(
                        torch.cat([o[0, :width].cpu() for o in dest]), want)
                    row = {"bytes": PLANES * width * 8, "memory": memory,
                           "route": route,
                           "variant": variant or (default if route == "pull"
                                                  else None),
                           "bit_exact": exact, "bound_ms": bound}
                    if exact:
                        row.update(timings(fn, per_call))
                    print(json.dumps(row), flush=True)
                    if route == "pull" and variant and exact \
                            and row["alone_ms"]:
                        key = (nbytes, memory)
                        if key not in best or row["alone_ms"] < \
                                best[key]["alone_ms"]:
                            best[key] = row
        if not probe_only:
            width = SIZES[0] // PLANES // 8
            pouts = [torch.empty((1, width), dtype=torch.int64, device=dev)
                     for _ in range(PLANES)]
            split = host_split(lib, cuda_a2a,
                               [[bases["ipc"] + k * width * 8]
                                for k in range(PLANES)], pouts,
                               [width * 8] * PLANES)
            print(json.dumps({"bytes": SIZES[0], "memory": "ipc",
                              "host_split": split}), flush=True)
        for (nbytes, memory), row in sorted(best.items()):
            print(f"[best] {nbytes} B from {memory} memory: variant "
                  f"{row['variant']} alone {row['alone_ms']:.4f} ms, per "
                  f"call {row['ms']:.4f} ms (bound {row['bound_ms']:.4f})",
                  flush=True)
    finally:
        (cuda_a2a.PULL_STAGES, cuda_a2a.PULL_STAGE_BYTES,
         cuda_a2a.PULL_BLOCKS_PER_SM) = default
        if "ipc" in bases:
            cuda_a2a.close_handle(dev, bases["ipc"])
        local.free()
        open(os.path.join(root, "done"), "w").close()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
