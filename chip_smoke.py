#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spark_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. device — requires ``torch.cuda.is_available()``; prints the card's
   name and power limit as ``nvidia-smi`` reports them;
2. build — compiles the grouped-accumulate kernel (K1) and the
   all-to-all kernel (K2) from ``spark_tpu_torch/csrc/`` with ``nvcc`` for
   ``sm_90a``, one ``nvcc`` per source, started together; prints
   ``-Xptxas -v`` (registers, spills) and the atomics in K1's SASS;
3. kernel check — K1's two entries against their plain PyTorch versions
   on the card, bit-exact: the columns entry (the main path's) at the
   hash-agg query's own plane specs (captured from one warm-up run), at
   each value width with NULLs and dtype extremes (sums that wrap),
   with dead-chunk rows, at N > 2^23 and at B = 10,000 with more planes
   than one accumulator pass holds; the planes entry at the main path's
   planes stacked, the edge shapes of the Pallas kernel's tests, dead
   chunks, N > 2^23 and B = 10,000; both at N = 2^24 rows in one bucket
   with every limb 255, also with the flush forced every 5,000 rows.
   Then each entry's time at the main-path shape — per call (CUDA
   events, the kernels line's ``ms``), back to back, the kernel alone
   (``torch.profiler``) and the wrapper's host time per call — beside its
   byte bound, its plain version's time and, for the planes entry, the
   one-call ``index_add_`` yardstick (which the port never calls); and
   the launch's grid, shared memory and cluster size;
4. slice — a ``SparkSession`` on the default device (the card) runs the
   hash-agg lane (2^22 rows, 1,024 groups) and TPC-DS q3 at SF1 row
   counts through the DataFrame API, on the default lane: each query's
   first run builds its stage-cache entry (an eager warm-up, then a CUDA
   graph capture) and later runs replay the graph.  Each result is held
   against a numpy oracle computed here (integers exact); the hash-agg
   query's first run must call K1 twice through the columns entry (the
   warm-up's launch and the captured one) and no ``aten::stack``; each
   query's warm wall time is the median of 5 runs;
5. SQL — the same session registers the hash-agg table and q3's tables
   as temp views and runs through ``spark.sql`` the hash-agg query
   (exactly one K1 launch, through the columns entry), q3's SQL text,
   and the queries of ``testing.SQL_QUERIES`` over q3's tables: UNION
   ALL, INTERSECT, EXCEPT, q3 with an IN subquery, a scalar and a
   correlated EXISTS subquery, LIKE, and one UDF per lane (the row
   lane's host copies reported); each result is held against its numpy
   oracle (``spark_tpu_torch/testing.py``); the SQL hash-agg and q3
   walls in turns with the DataFrame ones, each query's warm wall (with
   and without decoding the rows) and profile line; then q3's SQL text
   at ``spark.tpu.mesh.shards = 4``, where K2's launch count must rise;
6. stage — the stage cache: hash-agg and q3, each from the DataFrame API
   and from SQL text, as captured graphs.  Per query the build (warm-up
   plus capture) timed apart from 5 warm replays; the result against its
   oracle and bit for bit against the eager lane
   (``spark.sql.codegen.wholeStage=false``) and the per-operator lane
   (``spark.tpu.stage.fusion=false``); a profile of each lane (host
   launch calls, device kernels, device-busy share; the hash-agg replay
   must run K1 exactly once); the graph's pool bytes beside
   ``_plan_reserve_bytes``; walls in turns eager, graph, graph, eager,
   with and without the row decode.  Then one guard miss (the same
   shape on keys too wide for the bucket table) and its re-capture, one
   slotted-literal pair that shares an entry, and one
   ``HBMOutOfMemoryError`` raised before dispatch;
7. mesh slice — the same session with ``spark.tpu.mesh.shards = 4`` (all
   four shards on the card) runs the hash-agg lane, q3 with its
   broadcast joins and q3 with ``spark.sql.autoBroadcastJoinThreshold =
   0`` (both joins shuffled through the skew join), recording every K2
   call's inputs; each result is held against the same numpy oracle;
   K2's launch count must rise during each query; warm wall time (median
   of 5) and a profile line for each;
8. K2 check — K2 against its plain PyTorch version on the card,
   bit-exact, at every exchange the three mesh queries made, at n = 2, 4
   and 8 with bool planes and int32 run tables whose blocks are not
   multiples of 16 bytes, at cap = 1, in the gather form and with 50
   planes (a wide pointer table); then K2's time at the largest recorded
   all-to-all (CUDA events, warm-up, median of 25; 25 launches back to
   back, which hides the wrapper's host work; and the kernel alone under
   ``torch.profiler``) beside its byte bound,
   its plain version's time and the one-call
   ``transpose(0, 1).contiguous()`` yardstick on the same bytes
   pre-stacked (which the port never calls), per call and back to back;
9. a ``{"kernels": [...]}`` line (each kernel's ``sql_launches``: its
   launches in the SQL phase's counted run; K1's ``captured_launches``:
   those of its launches made while a graph was captured, and
   ``replayed_launches``: its launches the profiler saw in one replay of
   each hash-agg query), the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Every profile line gives, beside the largest kernels, each hand-written
kernel's own device time, its launches and its share of the run's
device time.

Query data are made with numpy from fixed seeds, the kernels' extra
check inputs with seeded torch generators.  The script imports neither
JAX nor the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
MAIN_N, MAIN_GROUPS = 1 << 22, 1024
Q3_ROWS = {"store_sales": 2_880_404, "date_dim": 73_049, "item": 18_000}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def cuda_ms(fn, warmup=3, reps=25):
    """Median device time of one call, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_back_to_back(fn, warmup=3, reps=25):
    """Device time per call over ``reps`` calls enqueued back to back
    between one pair of CUDA events: the host's enqueue work overlaps the
    device's, so this is the kernel's time without the wrapper's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, warmup=3, reps=25):
    """Median host time of one call from an idle device: the wrapper's
    work up to its last enqueue, not the device's."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def zero_counts():
    """Every kernel's launch count to 0, just before a main-path run."""
    from spark_tpu_torch import cuda_a2a, cuda_agg
    cuda_agg.LAUNCHES = 0
    for entry in cuda_agg.ENTRY_LAUNCHES:
        cuda_agg.ENTRY_LAUNCHES[entry] = 0
        cuda_agg.CAPTURED_LAUNCHES[entry] = 0
    cuda_a2a.LAUNCHES = 0


def clear_stage_cache():
    """Drop every captured graph, so the next run of each query builds
    (warm-up and capture) its entry anew."""
    from spark_tpu_torch.sql.stagecompile import stage_cache
    stage_cache().clear()


def wall_ms(fn, warmup=1, reps=5):
    """Median host wall time of a call that ends in a device sync."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_device():
    import torch
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | {card}",
          flush=True)
    return card


def phase_build():
    from spark_tpu_torch import cuda_a2a, cuda_agg, cuda_build
    t0 = time.perf_counter()
    paths = cuda_build.build_all([cuda_agg.SOURCE, cuda_a2a.SOURCE],
                                 verbose=True)
    print(f"[build] {', '.join(os.path.relpath(p) for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s (in parallel)", flush=True)
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", paths[0]], capture_output=True,
                          text=True, timeout=120).stdout
    atomics = {}
    for tok in sass.replace(";", " ").split():
        if tok.startswith(("ATOMS", "ATOMG", "RED")):
            atomics[tok] = atomics.get(tok, 0) + 1
    print(f"[build] K1 SASS atomics (instructions): {atomics}", flush=True)


def _random_inputs(n, B, P, n_active, seed, dead_rows=0):
    """Rows in live chunks; ``dead_rows`` padding rows parked at B-1 with
    zero planes (the chunk past n_active when B is wide enough)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    live_b = min(B, n_active * 512)
    bucket = rng.integers(0, live_b, n).astype(np.int32)
    planes = rng.integers(0, 256, (n, P)).astype(np.uint8)
    if dead_rows:
        bucket[-dead_rows:] = B - 1
        planes[-dead_rows:] = 0
    dev = torch.device("cuda")
    return (torch.from_numpy(bucket).to(dev), torch.from_numpy(planes).to(dev),
            torch.tensor([n_active], dtype=torch.int32, device=dev), B)


#: value columns of the fused entry's checks: dtype name, as the grouped
#: aggregate hands them over (a decimal is its int64 unscaled value)
VALUE_KINDS = ("int8", "int16", "int32", "int64", "bool", "decimal")


def _sum_planes(value, mask):
    """The planes one Sum/Avg of ``value`` makes, as
    ``kernels._mxu_grouped_aggregate`` describes them: limbs, then the
    count of its non-NULL rows."""
    from spark_tpu_torch import cuda_agg
    n_limbs = value.element_size()
    offset = -(1 << 63) if n_limbs == 8 else 1 << (8 * n_limbs - 1)
    return [cuda_agg.Plane(mask, value, i, offset) for i in range(n_limbs)] \
        + [cuda_agg.Plane(mask)]


def _column_inputs(n, B, n_active, kinds, seed, nullable=True,
                   dead_rows=0, bucket=None):
    """Columns on the card and the planes of a grouped aggregate over
    them: plane 0 counts live rows (a row mask), then per value column a
    Count plane and the Sum planes.  Values hold each dtype's extremes, so
    the limb sums recombine to wrapping int64 sums; ``dead_rows`` rows
    sit in the chunk past n_active with nonzero planes."""
    import torch
    from spark_tpu_torch import cuda_agg
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    if bucket is None:
        bucket = torch.randint(0, min(B, n_active * 512), (n,), generator=g,
                               device=dev, dtype=torch.int32)
        if dead_rows:
            bucket[-dead_rows:] = torch.randint(
                n_active * 512, B, (dead_rows,), generator=g, device=dev,
                dtype=torch.int32)
    live = torch.rand(n, generator=g, device=dev) < 0.9
    planes = [cuda_agg.Plane(live)]
    for kind in kinds:
        if kind == "bool":
            x = torch.rand(n, generator=g, device=dev) < 0.5
        else:
            dt = getattr(torch, "int64" if kind == "decimal" else kind)
            info = torch.iinfo(dt)
            lo, hi = (-10 ** 17, 10 ** 17) if kind == "decimal" else \
                (info.min, info.max)
            x = torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=dt)
            x[:4] = torch.tensor([info.min, info.max, info.max, -1], dtype=dt)
        m = live
        if nullable:
            m = (live & (torch.rand(n, generator=g, device=dev) < 0.7)
                 ).contiguous()
        planes.append(cuda_agg.Plane(m))
        planes.extend(_sum_planes(x, m))
    return (bucket, planes,
            torch.tensor([n_active], dtype=torch.int32, device=dev), B)


def _stacked(planes, n):
    """The (N, P) uint8 plane matrix of ``planes``, built in plain torch."""
    import torch
    from spark_tpu_torch import cuda_agg
    return torch.stack([cuda_agg.plane_values(p, n, "cuda") for p in planes],
                       dim=1).contiguous()


#: idle seconds kept inside each profiler window before the first launch
#: and after the last kernel ends: kineto drops a device record whose
#: span, on the host's clock, falls outside the window, so a kernel that
#: ends just before the window closes can go missing
PROFILE_PAD_S = 0.05


def kernel_device_ms(fn, name, reps=20, attempts=3):
    """Mean device time of the kernel named ``name`` over ``reps`` calls,
    from ``torch.profiler`` (the kernel alone: no wrapper, no fill).  A
    profile that saw fewer than ``reps`` launches is taken again, at most
    ``attempts`` times in all, and each short one is printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        hits = [(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)), e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.key]
        us, count = sum(h[0] for h in hits), sum(h[1] for h in hits)
        if count == reps:
            return us / count / 1e3
        print(f"[profile] attempt {attempt}: the profiler saw {count} "
              f"launches of {name}, expected {reps}", flush=True)
    check(False, f"profiler saw {count} launches of {name}, expected "
          f"{reps}, in each of {attempts} profiles")


def _check_cases(name, cases, fn, plain):
    """Each case's kernel result against its plain version, bit-exact;
    returns the largest absolute difference (0)."""
    import torch
    max_err = 0
    for case, args in cases:
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"{name} differs from its plain "
              f"version at {case} (max abs err {err})")
        print(f"[kernel] {name} {case}: bit-exact", flush=True)
    return max_err


def _stress_cases(n):
    """N rows in one bucket, every limb plane 255: the int32 lanes take
    every row's 255 with no carry, the int64 sums exceed 2^32."""
    import torch
    from spark_tpu_torch import cuda_agg
    dev = torch.device("cuda")
    bucket = torch.full((n,), 7, dtype=torch.int32, device=dev)
    na = torch.tensor([1], dtype=torch.int32, device=dev)
    x = torch.full((n,), (1 << 63) - 1, dtype=torch.int64, device=dev)
    planes = [cuda_agg.Plane()] + _sum_planes(x, None)
    mat = torch.full((n, 10), 255, dtype=torch.uint8, device=dev)
    return (bucket, mat, na, 512), (bucket, planes, na, 512)


def phase_kernel_check(session, hash_df):
    """K1's two entries against their plain versions, bit-exact; timings
    at the main path's inputs.  Returns the entries for the kernels line
    (launches filled in by the slice phase)."""
    import torch
    from spark_tpu_torch import cuda_agg

    # the main path's own inputs: the first run of the hash-agg query on
    # the graph lane calls K1 twice, in its eager warm-up and in its
    # capture; the warm-up's inputs hold data
    captured = []
    launch = cuda_agg.grouped_accumulate_columns

    def spy(bucket32, planes, n_active, B):
        captured.append((bucket32, list(planes), n_active, B))
        return launch(bucket32, planes, n_active, B)

    clear_stage_cache()
    zero_counts()
    cuda_agg.grouped_accumulate_columns = spy
    try:
        hash_df.collect()
    finally:
        cuda_agg.grouped_accumulate_columns = launch
    check(len(captured) == 2 and cuda_agg.CAPTURED_LAUNCHES[
        "grouped_accumulate_columns"] == 1,
          f"hash-agg query's first run made {len(captured)} K1 calls "
          f"({cuda_agg.CAPTURED_LAUNCHES} captured), expected 2: the "
          "warm-up's and the capture's")
    main = captured[0]
    b, planes, na, B = main
    n, P = b.shape[0], len(planes)
    print(f"[kernel] main-path inputs: N={n} B={B} P={P} "
          f"n_active={int(na)}; columns read: "
          f"{', '.join(d for d, _ in _columns(planes).values()) or 'none'}",
          flush=True)
    check((n, B, P, int(na)) == (MAIN_N, 4096, 10, 2),
          "main-path K1 shape is not N=2^22, B=4096, P=10, n_active=2")
    main_planes = (b, _stacked(planes, n), na, B)

    # planes in: the one-to-one counterpart of the Pallas kernel
    cases = [("main path (its planes, stacked)", main_planes)]
    for i, (cn, cb, cp) in enumerate([(1000, 512, 3), (4096, 4096, 11),
                                      (70, 100, 1), (2048, 1024, 24)]):
        cases.append((f"edge N={cn} B={cb} P={cp}",
                      _random_inputs(cn, cb, cp, -(-cb // 512), 10 + i)))
    cases.append(("dead chunks N=3000 B=4096 P=5 n_active=1",
                  _random_inputs(3000, 4096, 5, 1, 20, dead_rows=10)))
    cases.append(("N>2^23 N=8388685 B=1024 P=3",
                  _random_inputs((1 << 23) + 77, 1024, 3, 2, 21)))
    cases.append(("B=10000 N=100000 P=4",
                  _random_inputs(100_000, 10_000, 4, 20, 22)))
    cases.append(("B=10000 N=100000 P=19 (several accumulator passes)",
                  _random_inputs(100_000, 10_000, 19, 20, 23)))
    stress_planes, stress_columns = _stress_cases(1 << 24)
    cases.append(("N=2^24 in one bucket, planes 255", stress_planes))
    planes_err = _check_cases("planes in", cases, cuda_agg.grouped_accumulate,
                              cuda_agg.grouped_accumulate_plain)

    # columns in: the fused entry the main path calls
    cases = [("main path (its own specs)", main)]
    for i, kind in enumerate(VALUE_KINDS):
        cases.append((f"{kind} values, nullable", _column_inputs(
            1 << 20, 2048, 2, [kind], 30 + i)))
    cases.append(("int64 values, no NULLs", _column_inputs(
        1 << 20, 2048, 2, ["int64"], 40, nullable=False)))
    cases.append(("dead chunks N=3000 B=4096 n_active=1", _column_inputs(
        3000, 4096, 1, ["int32"], 41, dead_rows=50)))
    cases.append(("N>2^23 N=8388685 B=1024", _column_inputs(
        (1 << 23) + 77, 1024, 2, ["int64", "int16"], 42)))
    wide = _column_inputs(100_000, 10_000, 20, ["int64", "int64"], 43)
    cases.append((f"B=10000 N=100000 P={len(wide[1])} (several accumulator "
                  "passes)", wide))
    cases.append(("N=2^24 in one bucket, limbs 255", stress_columns))
    columns_err = _check_cases("columns in", cases,
                               cuda_agg.grouped_accumulate_columns,
                               cuda_agg.grouped_accumulate_columns_plain)

    # exactness past ROWS_PER_FLUSH: the same stress with the flush every
    # few tiles, so every CTA flushes and re-zeroes many times
    rows_per_flush = cuda_agg.ROWS_PER_FLUSH
    cuda_agg.ROWS_PER_FLUSH = 5000
    try:
        planes_err = max(planes_err, _check_cases(
            "planes in", [("N=2^24 one bucket, flush every 5000 rows",
                           stress_planes)],
            cuda_agg.grouped_accumulate, cuda_agg.grouped_accumulate_plain))
        columns_err = max(columns_err, _check_cases(
            "columns in", [("N=2^24 one bucket, flush every 5000 rows",
                            stress_columns)],
            cuda_agg.grouped_accumulate_columns,
            cuda_agg.grouped_accumulate_columns_plain))
    finally:
        cuda_agg.ROWS_PER_FLUSH = rows_per_flush
    del stress_planes, stress_columns, wide, cases

    entries = []
    for name, fn, plain, args, err, row_width in (
            ("grouped_accumulate", cuda_agg.grouped_accumulate,
             cuda_agg.grouped_accumulate_plain, main_planes, planes_err, P),
            ("grouped_accumulate_columns",
             cuda_agg.grouped_accumulate_columns,
             cuda_agg.grouped_accumulate_columns_plain, main, columns_err,
             sum(b for _, b in _columns(planes).values()))):
        entries.append(_time_k1(name, fn, plain, args, err, P, row_width))
    return entries


def _columns(planes):
    """The distinct columns ``planes`` read: {key: (role and dtype, bytes
    a row)}."""
    seen = {}
    for p in planes:
        for role, t in (("mask", p.mask), ("value", p.value)):
            if t is not None:
                seen.setdefault((t.data_ptr(), t.dtype), (
                    f"{role} {str(t.dtype).replace('torch.', '')}",
                    t.element_size()))
    return seen


def _time_k1(name, fn, plain, args, max_err, P, row_width):
    """One K1 entry's numbers at the main path's inputs: ``P`` planes from
    ``row_width`` input bytes a row beside the bucket code."""
    import torch
    from spark_tpu_torch import cuda_agg
    b, _planes, na, B = args
    n = b.shape[0]
    per_call = cuda_ms(lambda: fn(*args))
    b2b = cuda_ms_back_to_back(lambda: fn(*args))
    kernel = kernel_device_ms(lambda: fn(*args), "grouped_accumulate_kernel")
    host = host_ms(lambda: fn(*args))
    launch = cuda_agg.launch_shape(name == "grouped_accumulate_columns", n,
                                   P, B, row_width)
    plain_ms = cuda_ms(lambda: plain(*args))
    library_ms = None
    if name == "grouped_accumulate":
        # yardstick: one library call on the same inputs (every main-path
        # row lies in a live chunk, so no masking is needed)
        b64, p64 = b.long(), args[1].long()
        out = torch.zeros((B, p64.shape[1]), dtype=torch.int64,
                          device=b.device)
        check(torch.equal(out.index_add_(0, b64, p64), plain(*args)),
              "index_add_ yardstick disagrees with the plain version")
        library_ms = cuda_ms(lambda: out.index_add_(0, b64, p64))
    nbytes = n * (4 + row_width) + B * P * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[kernel] {name} at the main path: {per_call:.4f} ms per call, "
          f"{b2b:.4f} ms back to back (CUDA events: wrapper and output fill "
          f"included); kernel alone {kernel:.4f} ms (profiler, "
          f"{bound_ms / kernel:.1%} of the bound's rate); wrapper host time "
          f"{host:.4f} ms per call; bound {bound_ms:.4f} ms by bytes "
          f"({nbytes} B at 3.35 TB/s); plain {plain_ms:.4f} ms; index_add_ "
          f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}; "
          f"launch {launch}", flush=True)
    return {"name": name, "route": "cuda",
            "source": "spark_tpu_torch/csrc/grouped_accumulate.cu",
            "replaces": "spark_tpu/pallas_agg.py:56",
            "launches": None, "max_abs_err": max_err, "ms": per_call,
            "kernel_ms": per_call, "kernel_alone_ms": kernel,
            "ms_back_to_back": b2b, "host_ms": host, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "launch": launch}


def phase_slice(session, hash_df, hash_table, k1_entries):
    from spark_tpu_torch import cuda_agg
    from spark_tpu_torch import types as T
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.testing import (hash_agg_oracle, q3_oracle,
                                         q3_query, q3_tables)

    t0 = time.perf_counter()
    tables = q3_tables(Q3_ROWS["store_sales"], Q3_ROWS["item"],
                       Q3_ROWS["date_dim"])
    q3_df = q3_query(session, F, T, tables)
    print(f"[slice] q3 tables at SF1 row counts {Q3_ROWS} made and moved "
          f"to the card in {time.perf_counter() - t0:.2f} s", flush=True)

    # the main path's run: counts zeroed just before, read just after.
    # On the graph lane each query's first run builds its entry: the
    # wrapper launches K1 once in the eager warm-up and once more while
    # the graph is captured (replays launch it without the wrapper; the
    # [stage] phase counts those from the profiler)
    clear_stage_cache()
    zero_counts()
    hash_rows = hash_df.collect()
    hash_launches = dict(cuda_agg.ENTRY_LAUNCHES)
    hash_captured = dict(cuda_agg.CAPTURED_LAUNCHES)
    q3_rows = q3_df.collect()
    q3_launches = cuda_agg.LAUNCHES - sum(hash_launches.values())
    check(hash_launches == {"grouped_accumulate": 0,
                            "grouped_accumulate_columns": 2}
          and hash_captured["grouped_accumulate_columns"] == 1,
          f"hash-agg query's K1 launches {hash_launches} ({hash_captured} "
          "captured), expected two through the columns entry: one in the "
          "warm-up, one captured")
    for entry in k1_entries:
        entry["launches"] = cuda_agg.ENTRY_LAUNCHES[entry["name"]]
        entry["captured_launches"] = \
            cuda_agg.CAPTURED_LAUNCHES[entry["name"]]

    got = sorted((r["k"], r["s"], r["c"]) for r in hash_rows)
    check(got == hash_agg_oracle(hash_table),
          "hash-agg result differs from the numpy oracle")
    want_q3 = q3_oracle(tables)
    got_q3 = [tuple(r) for r in q3_rows]
    check(len(want_q3) > 0, "q3 oracle selected no rows")
    check(got_q3 == want_q3, f"q3 result differs from the numpy oracle "
          f"(first rows {got_q3[:2]} vs {want_q3[:2]})")
    print(f"[slice] hash-agg: {len(got)} groups equal to the oracle; K1 "
          f"wrapper launches during the query's first run: {hash_launches} "
          f"(MXU-form branch; {hash_captured} of them captured)",
          flush=True)
    branch = "MXU-form (K1)" if q3_launches else "sort-based"
    print(f"[slice] q3: {len(got_q3)} rows equal to the oracle; K1 launches "
          f"during the query: {q3_launches} ({branch} branch)", flush=True)

    hash_ms = wall_ms(hash_df.collect)
    q3_ms = wall_ms(q3_df.collect)
    print(f"[slice] warm wall time, median of 5: hash-agg {hash_ms:.2f} ms "
          f"(N={MAIN_N}, {MAIN_GROUPS} groups); q3 {q3_ms:.2f} ms", flush=True)
    stacks = stacked_shapes(hash_df.collect)
    check(not [s for s in stacks if any(t and t[0] == MAIN_N for t in s)],
          f"hash-agg stacked {MAIN_N}-row planes: {stacks}")
    print(f"[slice] hash-agg: no torch.stack of {MAIN_N}-row planes (every "
          f"torch.stack's inputs: {stacks})", flush=True)
    profile_query("hash-agg", hash_df.collect)
    profile_query("q3", q3_df.collect)
    return tables, q3_df


def stacked_shapes(fn):
    """The input shapes of every ``torch.stack`` call one run of ``fn``
    makes."""
    import torch
    seen = []
    stack = torch.stack

    def spy(tensors, *args, **kwargs):
        tensors = list(tensors)
        seen.append([tuple(t.shape) for t in tensors])
        return stack(tensors, *args, **kwargs)

    torch.stack = spy
    try:
        fn()
    finally:
        torch.stack = stack
    return seen


#: the hand-written kernels by the name of their ``__global__`` function
OWN_KERNELS = (("K1", "grouped_accumulate_kernel"),
               ("K2", "all_to_all_kernel"))


#: CUDA runtime/driver calls that put work on a stream: a profile's host
#: launch calls are its CPU-side events of these names
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cudaLaunchKernelEx", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy",
                     "cudaMemset")


def profile_query(name, fn, top=6):
    """Where one warm run's time goes: device time summed over the kernels
    ``torch.profiler`` saw, against the run's wall time under the
    profiler (which adds host overhead), the host's launch calls, each
    hand-written kernel's own time, launches and share of the device
    time, and the largest kernels.  Returns those numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
    rows, host_calls = [], {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.key in HOST_LAUNCH_CALLS:
                host_calls[e.key] = host_calls.get(e.key, 0) + e.count
            continue
        # device kernels only: an aten op's row repeats its kernels' time
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, e.count, e.key))
    device_ms = sum(us for us, _c, _k in rows) / 1e3
    rows.sort(reverse=True)
    own, own_txt = {}, []
    for kid, fn_name in OWN_KERNELS:
        hits = [(us, c) for us, c, k in rows if fn_name in k]
        ms = sum(us for us, _c in hits) / 1e3
        count = sum(c for _u, c in hits)
        share = ms / device_ms if device_ms else 0.0
        own[kid] = (count, ms)
        own_txt.append(f"{kid} {fn_name} x{count} {ms:.4f} ms ({share:.2%} "
                       "of device time)")
    tops = "; ".join(f"{k[:60]} x{c} {us / 1e3:.3f} ms"
                     for us, c, k in rows[:top])
    n_device = sum(c for _u, c, _k in rows)
    n_host = sum(host_calls.values())
    print(f"[profile] {name}: wall {wall:.2f} ms under the profiler, device "
          f"busy {device_ms:.3f} ms ({device_ms / wall:.1%}), "
          f"{n_device} device kernels and copies from {n_host} host launch "
          f"calls {host_calls}; {'; '.join(own_txt)}; top: {tops}",
          flush=True)
    return {"wall_ms": wall, "device_ms": device_ms, "busy": device_ms / wall,
            "device_ops": n_device, "host_launch_calls": n_host,
            "host_calls": host_calls, "own": own}


def phase_sql(session, hash_df, hash_table, q3_df, tables, k1_entries):
    """``spark.sql`` on the card: the hash-agg query and q3 from SQL text,
    and the set-operation, subquery, LIKE and UDF queries over q3's tables
    (``testing.SQL_QUERIES``), each held against its numpy oracle; SQL
    q3 again on the mesh lane.  Returns K2's launches in that mesh run."""
    import torch
    from spark_tpu_torch import cuda_a2a, cuda_agg
    from spark_tpu_torch import types as T
    from spark_tpu_torch.sql import udf
    from spark_tpu_torch.testing import (HASH_AGG_SQL, Q3_SQL, SQL_QUERIES,
                                         hash_agg_oracle, q3_oracle,
                                         register_sql_tables,
                                         register_sql_udfs)

    t0 = time.perf_counter()
    register_sql_tables(session, hash_table, tables, T)
    register_sql_udfs(session, torch)
    print(f"[sql] temp views hash_t, store_sales, date_dim, item registered "
          f"(moved to the card) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    queries = [("hash-agg", HASH_AGG_SQL,
                lambda t: hash_agg_oracle(hash_table), False),
               ("q3", Q3_SQL, q3_oracle, True)]
    queries += [(name, sql, oracle, ordered)
                for name, (sql, oracle, ordered) in SQL_QUERIES.items()]
    frames = [(name, session.sql(sql)) for name, sql, _o, _d in queries]

    # the SQL path's run: counts zeroed just before, read just after; each
    # query builds its stage entry (K1: warm-up launch + captured launch)
    results = []
    clear_stage_cache()
    zero_counts()
    for name, df in frames:
        before = (dict(cuda_agg.ENTRY_LAUNCHES), dict(udf.HOST_COPIES))
        rows = df.collect()
        results.append((rows, {k: v - before[0][k] for k, v in
                               cuda_agg.ENTRY_LAUNCHES.items()},
                        {k: v - before[1][k] for k, v in
                         udf.HOST_COPIES.items()}))
    for entry in k1_entries:
        entry["sql_launches"] = cuda_agg.ENTRY_LAUNCHES[entry["name"]]

    for (name, _sql, oracle, ordered), (rows, k1, copies) in \
            zip(queries, results):
        got = [tuple(r) for r in rows]
        want = oracle(tables)
        check(len(want) > 0, f"SQL {name}: the oracle selected no rows")
        if not ordered:
            got, want = sorted(got), sorted(want)
        check(got == want, f"SQL {name} differs from its numpy oracle "
              f"(first rows {got[:2]} vs {want[:2]})")
        if name == "hash-agg":
            check(k1 == {"grouped_accumulate": 0,
                         "grouped_accumulate_columns": 2},
                  f"SQL hash-agg's K1 launches {k1}, expected two through "
                  "the columns entry: the warm-up's and the capture's")
        extra = ""
        if copies["to_host"] or copies["to_device"]:
            extra = (f"; UDF row lane: {copies['to_host']} device->host "
                     f"copy ({copies['to_host_bytes']} B), "
                     f"{copies['to_device']} host->device copy "
                     f"({copies['to_device_bytes']} B)")
        print(f"[sql] {name}: {len(got)} rows equal to the oracle; K1 "
              f"launches {k1}{extra}", flush=True)

    # the SQL front end's host cost: SQL and DataFrame walls in turns
    for name, df in (("hash-agg", hash_df), ("q3", q3_df)):
        sql_df = dict(frames)[name]
        walls = [wall_ms(df.collect), wall_ms(sql_df.collect),
                 wall_ms(sql_df.collect), wall_ms(df.collect)]
        print(f"[sql] {name} warm wall time, median of 5, in turns "
              f"DataFrame, SQL, SQL, DataFrame: "
              f"{', '.join(f'{w:.2f}' for w in walls)} ms", flush=True)
    for name, df in frames:
        # _execute: the same run up to the host batch, without turning
        # its rows into Python objects
        print(f"[sql] {name}: warm wall time, median of 5: "
              f"{wall_ms(df.collect):.2f} ms ({wall_ms(df._execute):.2f} ms "
              "without decoding the rows)", flush=True)
        profile_query(f"sql {name}", df.collect)

    # SQL q3 on the mesh lane
    _mesh(session, MESH_SHARDS)
    try:
        zero_counts()
        rows = session.sql(Q3_SQL).collect()
        k2 = cuda_a2a.LAUNCHES
        check(k2 > 0, "K2 was not launched during SQL q3 on the mesh lane")
        got = [tuple(r) for r in rows]
        check(got == q3_oracle(tables), f"mesh SQL q3 differs from the "
              f"oracle (first rows {got[:2]})")
        print(f"[sql] mesh q3 x{MESH_SHARDS} shards: {len(got)} rows equal "
              f"to the oracle; K2 launches during the query: {k2}",
              flush=True)
        mesh_q3 = session.sql(Q3_SQL)
        print(f"[sql] mesh q3 x{MESH_SHARDS}: warm wall time, median of 5: "
              f"{wall_ms(mesh_q3.collect):.2f} ms", flush=True)
        profile_query(f"sql mesh q3 x{MESH_SHARDS}", mesh_q3.collect)
    finally:
        _mesh(session, 1)
    return k2


LANES = {"eager": {"spark.sql.codegen.wholeStage": "false"},
         "per-op": {"spark.tpu.stage.fusion": "false"},
         "graph": {}}


def _lane(session, lane):
    """Select one of the single-device lanes for the session."""
    for conf in LANES.values():
        for key in conf:
            session.conf.unset(key)
    for key, value in LANES[lane].items():
        session.conf.set(key, value)


def _grouped_oracle(table, where=None):
    """(k, sum(v), count) rows of ``table`` (``where``: a row mask), for
    keys of any range."""
    import numpy as np
    k, v = table["k"], table["v"]
    if where is not None:
        k, v = k[where], v[where]
    keys, inv = np.unique(k, return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, v)
    counts = np.bincount(inv, minlength=len(keys))
    return sorted(zip(keys.tolist(), sums.tolist(), counts.tolist()))


def phase_stage(session, hash_df, hash_table, q3_df, tables):
    """The stage cache on the card: hash-agg and q3, each from the
    DataFrame API and from SQL text, as captured graphs.  Per query: the
    build (warm-up plus capture) timed apart from 5 warm replays; the
    result against its numpy oracle and bit for bit against the eager
    and per-op lanes; each lane's profile (host launch calls, device
    kernels, device-busy share; K1 once per hash-agg replay); the entry's
    graph pool and static buffers beside ``_plan_reserve_bytes``; walls
    in turns eager, graph, graph, eager, with and without the row
    decode.  Then one guard miss and its re-capture, one slotted-literal
    pair sharing an entry, and one ``HBMOutOfMemoryError`` raised before
    dispatch.  Returns K1's replayed launches per hash-agg query."""
    import numpy as np
    import torch
    from spark_tpu_torch import config as C
    from spark_tpu_torch.memory import HBMOutOfMemoryError, MemoryManager
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql.planner import (QueryExecution,
                                             _plan_reserve_bytes)
    from spark_tpu_torch.sql import stagecompile as SC
    from spark_tpu_torch.sql.stagecompile import stage_cache
    from spark_tpu_torch.testing import (HASH_AGG_SQL, Q3_SQL,
                                         assert_parts_equal, batch_parts,
                                         hash_agg_query, q3_oracle)

    cache = stage_cache()
    hash_rows = _grouped_oracle(hash_table)
    q3_want = q3_oracle(tables)
    queries = [
        ("hash-agg", hash_df, lambda rows: sorted(
            (r["k"], r["s"], r["c"]) for r in rows) == hash_rows),
        ("q3", q3_df, lambda rows: [tuple(r) for r in rows] == q3_want),
        ("sql hash-agg", session.sql(HASH_AGG_SQL), lambda rows: sorted(
            (r["k"], r["s"], r["c"]) for r in rows) == hash_rows),
        ("sql q3", session.sql(Q3_SQL),
         lambda rows: [tuple(r) for r in rows] == q3_want),
    ]
    k1_replays = {}
    for name, df, correct in queries:
        _lane(session, "graph")
        clear_stage_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = df.collect()
        first_ms = (time.perf_counter() - t0) * 1e3
        check(correct(rows), f"[stage] {name}: first run differs from the "
              "numpy oracle")
        build = cache.stats()
        (entry,) = cache.entries()
        replay_ms = wall_ms(df.collect, warmup=0, reps=5)
        after = cache.stats()
        check(correct(df.collect()), f"[stage] {name}: replay differs from "
              "the numpy oracle")
        check((build["builds"], build["variants"], after["builds"],
               after["variants"], after["guard_misses"]) == (1, 1, 1, 1, 0),
              f"[stage] {name}: replays built again: {after}")
        variant = entry.variants[-1]
        reserve = _plan_reserve_bytes(
            QueryExecution(session, df._plan).planned)
        print(f"[stage] {name}: build (warm-up + capture) "
              f"{build['compile_ms']:.2f} ms of a first run of "
              f"{first_ms:.2f} ms; 5 warm replays, median wall "
              f"{replay_ms:.2f} ms; {entry.n_ops} operators in one graph; "
              f"graph pool {variant.pool_bytes} B + static inputs "
              f"{variant.static_bytes} B beside _plan_reserve_bytes "
              f"{reserve} B; {variant.n_guards} guard flag(s); storage "
              f"charged {session._memory.storage_used} B", flush=True)

        # bit for bit against the eager and per-op lanes
        parts = {}
        for lane in ("graph", "eager", "per-op"):
            _lane(session, lane)
            parts[lane] = batch_parts(df._execute())
        for lane in ("eager", "per-op"):
            assert_parts_equal(parts["graph"], parts[lane])
        print(f"[stage] {name}: graph lane bit-exact against the eager and "
              f"per-op lanes ({len(parts['graph'].names)} columns, "
              f"capacity {parts['graph'].capacity})", flush=True)

        # each lane's launches and device-busy share
        prof = {}
        for lane in ("eager", "per-op", "graph"):
            _lane(session, lane)
            df.collect()                      # warm
            prof[lane] = profile_query(f"stage {name} {lane}", df.collect)
        if "hash-agg" in name:
            count, ms = prof["graph"]["own"]["K1"]
            check(count == 1, f"[stage] {name}: the profiler saw K1 x{count} "
                  "in one replay, expected exactly one")
            k1_replays[name] = count
            print(f"[stage] {name}: one replay ran K1 x{count}, "
                  f"{ms:.4f} ms on the device", flush=True)
        print(f"[stage] {name}: host launch calls per query eager "
              f"{prof['eager']['host_launch_calls']}, per-op "
              f"{prof['per-op']['host_launch_calls']}, graph "
              f"{prof['graph']['host_launch_calls']}; device-busy share "
              f"eager {prof['eager']['busy']:.1%}, per-op "
              f"{prof['per-op']['busy']:.1%}, graph "
              f"{prof['graph']['busy']:.1%}", flush=True)

        # the host's share of a replayed query: planning (analyze,
        # optimize, plan) and the stage key, each per query
        _lane(session, "graph")
        pq = QueryExecution(session, df._plan).planned
        plan_ms = host_ms(lambda: QueryExecution(session, df._plan).planned,
                          warmup=1, reps=5)
        key_ms = host_ms(lambda: (
            SC.stage_fingerprint(pq.physical), SC.leaf_signature(pq.leaves),
            SC._conf_component(session)), warmup=1, reps=5)
        print(f"[stage] {name}: host time per query, median of 5: analyze + "
              f"optimize + plan {plan_ms:.3f} ms, stage key {key_ms:.3f} ms",
              flush=True)

        # walls in turns
        walls = []
        for lane in ("eager", "graph", "graph", "eager"):
            _lane(session, lane)
            walls.append((wall_ms(df.collect), wall_ms(df._execute)))
        print(f"[stage] {name}: warm wall, median of 5, in turns eager, "
              f"graph, graph, eager: "
              f"{', '.join(f'{a:.2f}' for a, _b in walls)} ms; without "
              f"decoding the rows: "
              f"{', '.join(f'{b:.2f}' for _a, b in walls)} ms", flush=True)
    _lane(session, "graph")

    # one guard miss and its re-capture: the same shape on keys whose
    # range does not fit the bucket table
    rng = np.random.default_rng(29)
    wide = {"k": rng.choice(rng.integers(0, 10 ** 12, 5000), MAIN_N),
            "v": rng.integers(0, 100, MAIN_N).astype(np.int64)}
    wide_df = hash_agg_query(session, F, wide)
    hash_df.collect()
    before = cache.stats()
    got = sorted((r["k"], r["s"], r["c"]) for r in wide_df.collect())
    miss = cache.stats()
    check(got == _grouped_oracle(wide), "[stage] guard-miss result differs "
          "from the numpy oracle")
    check((miss["builds"], miss["guard_misses"], miss["variants"]) ==
          (before["builds"], before["guard_misses"] + 1,
           before["variants"] + 1),
          f"[stage] wide keys did not miss the guard: {before} -> {miss}")
    again = sorted((r["k"], r["s"], r["c"]) for r in wide_df.collect())
    check(again == got and cache.stats()["guard_misses"]
          == miss["guard_misses"], "[stage] the re-captured variant did not "
          "serve the wide keys")
    print(f"[stage] guard miss: hash-agg on {len(got)} keys spread over "
          f"10^12 (same shape) failed the recorded fits-the-bucket-table "
          f"guard, re-ran eagerly (sorted form) and captured a second "
          f"variant ({miss['compile_ms'] - before['compile_ms']:.2f} ms); "
          "its replay serves the next run; results equal the oracle",
          flush=True)

    # one slotted-literal pair sharing an entry
    text = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM hash_t WHERE v < {} " \
        "GROUP BY k"
    pair = []
    for bound in (50, 80):
        before = cache.stats()
        rows = sorted((r["k"], r["s"], r["c"])
                      for r in session.sql(text.format(bound)).collect())
        pair.append(cache.stats()["builds"] - before["builds"])
        check(rows == _grouped_oracle(hash_table, hash_table["v"] < bound),
              f"[stage] v < {bound} differs from the numpy oracle")
    check(pair == [1, 0], f"[stage] the literal pair built {pair} entries")
    print("[stage] slotted literals: v < 50 built one entry, v < 80 "
          "replayed it with the new value; both equal the oracle",
          flush=True)

    # one HBMOutOfMemoryError before dispatch
    reserve = _plan_reserve_bytes(QueryExecution(session, hash_df._plan)
                                  .planned)
    saved = session._memory
    session._memory = MemoryManager(
        C.Conf({"spark.tpu.memory.hbmBudget": reserve // 2}), session.device)
    before = cache.stats()["dispatches"]
    try:
        hash_df.collect()
        check(False, "[stage] a half-size budget ran hash-agg")
    except HBMOutOfMemoryError as e:
        message = str(e)
    finally:
        session._memory = saved
    check(cache.stats()["dispatches"] == before, "[stage] the refused query "
          "was dispatched")
    print(f"[stage] budget {reserve // 2} B: HBMOutOfMemoryError before "
          f"dispatch: {message}", flush=True)
    print(f"[stage] cache {cache.stats()}", flush=True)
    return k1_replays


MESH_SHARDS = 4
SHARDS_KEY = "spark.tpu.mesh.shards"
THRESHOLD_KEY = "spark.sql.autoBroadcastJoinThreshold"


def _mesh(session, shards, threshold=None):
    session.conf.set(SHARDS_KEY, str(shards))
    if threshold is None:
        session.conf.unset(THRESHOLD_KEY)
    else:
        session.conf.set(THRESHOLD_KEY, str(threshold))


def _a2a_bytes(planes, gather):
    """Bytes one exchange moves: every (sender, receiver) block once."""
    n = len(planes[0])
    return sum(x.numel() * x.element_size() * (n if gather else 1)
               for shards in planes for x in shards)


def _a2a_desc(planes, gather):
    n = len(planes[0])
    kinds = ", ".join(f"{str(p[0].dtype).replace('torch.', '')}"
                      f"{tuple(p[0].shape)}" for p in planes)
    return f"n={n} {'gather ' if gather else ''}planes [{kinds}]"


def _random_planes(n, specs, seed, gather=False):
    """Planes on the card: ``specs`` is a list of (dtype, trailing shape);
    each sender's plane is (n, *shape), or (*shape) in the gather form."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    planes = []
    for dtype, shape in specs:
        full = tuple(shape) if gather else (n,) + tuple(shape)
        if dtype == torch.bool:
            make = lambda: torch.rand(full, generator=g,  # noqa: E731
                                      device="cuda") < 0.5
        elif dtype.is_floating_point:
            make = lambda: torch.randn(full, generator=g,  # noqa: E731
                                       device="cuda", dtype=dtype)
        else:
            make = lambda: torch.randint(  # noqa: E731
                -1000, 1000, full, generator=g, device="cuda", dtype=dtype)
        planes.append([make() for _ in range(n)])
    return planes


def phase_k2_check(captured, launches):
    """K2 against its plain version, bit-exact, at every recorded mesh
    exchange and at edge shapes; timings at the largest recorded
    all-to-all.  Returns the kernel's entry for the kernels line."""
    import torch
    from spark_tpu_torch import cuda_a2a

    cases = [(f"{query} call {i}", planes, gather)
             for i, (query, planes, gather) in enumerate(captured)]
    i32, i64, f64, b8 = torch.int32, torch.int64, torch.float64, torch.bool
    for n in (2, 4, 8):
        specs = [(i64, (1000,)), (f64, (1000,)), (b8, (1000,)),
                 (i32, (3 + n,))]
        cases.append((f"n={n} int64/float64/bool cap=1000, int32 runs "
                      f"{3 + n}", _random_planes(n, specs, 30 + n), False))
        cases.append((f"n={n} cap=1", _random_planes(
            n, [(i64, (1,)), (b8, (1,)), (i32, (1,))], 40 + n), False))
    cases.append(("n=4 cap=2^20+3 (chunk tails)", _random_planes(
        4, [(i64, ((1 << 20) + 3,)), (b8, ((1 << 20) + 3,))], 50), False))
    cases.append(("n=4 gather int64/bool cap=37", _random_planes(
        4, [(i64, (37,)), (b8, (37,)), (i32, ())], 51, gather=True), True))
    cases.append(("n=8 50 planes (a 32 KB pointer table)", _random_planes(
        8, [(i32, (9,))] * 25 + [(b8, (13,))] * 25, 52), False))
    max_err = 0
    for name, planes, gather in cases:
        got = cuda_a2a.all_to_all(planes, gather)
        want = cuda_a2a.all_to_all_plain(planes, gather)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"K2 output {g.dtype}{tuple(g.shape)} vs plain "
                  f"{w.dtype}{tuple(w.shape)} at {name}")
            if g.dtype != torch.bool and g.numel():
                max_err = max(max_err, float((g.double() - w.double())
                                             .abs().max()))
            check(torch.equal(g, w), f"K2 differs from its plain version "
                  f"at {name}")
        print(f"[k2] {name}: bit-exact", flush=True)

    query, planes, gather = max((c for c in captured if not c[2]),
                                key=lambda c: _a2a_bytes(c[1], c[2]))
    n = len(planes[0])
    kernel_ms = cuda_ms(lambda: cuda_a2a.all_to_all(planes, gather))
    plain_ms = cuda_ms(lambda: cuda_a2a.all_to_all_plain(planes, gather))
    b2b_ms = cuda_ms_back_to_back(lambda: cuda_a2a.all_to_all(planes, gather))
    alone_ms = kernel_device_ms(lambda: cuda_a2a.all_to_all(planes, gather),
                                "all_to_all_kernel", reps=5)
    # yardstick: the same bytes pre-stacked as one (n, n, bytes) tensor,
    # moved by one library call
    per_plane = [torch.stack(list(p)).view(torch.uint8).reshape(n, n, -1)
                 for p in planes]
    stacked = torch.cat(per_plane, dim=2)
    want = torch.cat([o.view(torch.uint8).reshape(n, n, -1) for o in
                      cuda_a2a.all_to_all_plain(planes, gather)], dim=2)
    check(torch.equal(stacked.transpose(0, 1).contiguous(), want),
          "transpose yardstick disagrees with the plain version")
    library_ms = cuda_ms(lambda: stacked.transpose(0, 1).contiguous())
    library_b2b_ms = cuda_ms_back_to_back(
        lambda: stacked.transpose(0, 1).contiguous())
    nbytes = 2 * _a2a_bytes(planes, gather)       # read once, write once
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[k2] all_to_all at the largest exchange ({query}), "
          f"{_a2a_desc(planes, gather)}: "
          f"{kernel_ms:.4f} ms (bound {bound_ms:.4f} ms by bytes, {nbytes} "
          f"B at 3.35 TB/s); plain {plain_ms:.4f} ms; transpose "
          f"{library_ms:.4f} ms; back to back {b2b_ms:.4f} ms per call, "
          f"transpose back to back {library_b2b_ms:.4f} ms per call; "
          f"kernel alone {alone_ms:.4f} ms (profiler)", flush=True)
    return {"name": "all_to_all", "route": "cuda",
            "source": "spark_tpu_torch/csrc/all_to_all.cu",
            "replaces": "spark_tpu/parallel/ici.py:352",
            "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "kernel_alone_ms": alone_ms,
            "ms_back_to_back": b2b_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms,
            "library_ms_back_to_back": library_b2b_ms}


def phase_mesh(session, hash_df, hash_table, q3_df, tables):
    """The mesh lane's three queries at 4 shards on the card.  Returns
    every K2 call's inputs from their counted run, as (query, planes,
    gather), and K2's launch count over that run."""
    from spark_tpu_torch import cuda_a2a
    from spark_tpu_torch.testing import hash_agg_oracle, q3_oracle

    want_hash = hash_agg_oracle(hash_table)
    want_q3 = q3_oracle(tables)
    runs = [("hash-agg", hash_df, None),
            ("q3 broadcast joins", q3_df, None),
            ("q3 shuffled joins", q3_df, 0)]

    # record every K2 call's inputs for the kernel check (the spy only
    # passes the call on: the count rises inside the wrapper it calls)
    captured = []
    launch = cuda_a2a.all_to_all
    query = [None]

    def spy(planes, gather=False):
        captured.append((query[0], [list(p) for p in planes], gather))
        return launch(planes, gather)

    # the mesh lane's run: counts zeroed just before, read just after
    counts = []
    cuda_a2a.all_to_all = spy
    try:
        zero_counts()
        for name, df, threshold in runs:
            _mesh(session, MESH_SHARDS, threshold)
            query[0] = name
            before = cuda_a2a.LAUNCHES
            rows = df.collect()
            counts.append((name, df, rows, cuda_a2a.LAUNCHES - before))
        launches = cuda_a2a.LAUNCHES
    finally:
        cuda_a2a.all_to_all = launch
    for name, df, rows, count in counts:
        check(count > 0, f"K2 was not launched during {name}")
        if df is hash_df:
            got = sorted((r["k"], r["s"], r["c"]) for r in rows)
            check(got == want_hash, f"mesh {name} differs from the oracle")
        else:
            got = [tuple(r) for r in rows]
            check(got == want_q3, f"mesh {name} differs from the oracle "
                  f"(first rows {got[:2]} vs {want_q3[:2]})")
        print(f"[mesh] {name} x{MESH_SHARDS} shards: {len(got)} rows equal "
              f"to the oracle; K2 launches during the query: {count}",
              flush=True)
    for query_name, planes, gather in captured:
        print(f"[k2]   {query_name}: {_a2a_desc(planes, gather)}: "
              f"{_a2a_bytes(planes, gather)} B", flush=True)

    for name, df, threshold in runs:
        _mesh(session, MESH_SHARDS, threshold)
        ms = wall_ms(df.collect)
        print(f"[mesh] {name} x{MESH_SHARDS}: warm wall time, median of 5: "
              f"{ms:.2f} ms", flush=True)
        profile_query(f"mesh {name}", df.collect)
    _mesh(session, 1)
    return captured, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import spark_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql.session import SparkSession
    from spark_tpu_torch.testing import hash_agg_query, hash_agg_table

    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    session = SparkSession.builder.appName("chip_smoke").getOrCreate()
    check(session.device.type == "cuda", "default session is not on the card")
    hash_table = hash_agg_table(MAIN_N, MAIN_GROUPS)
    hash_df = hash_agg_query(session, F, hash_table)
    k1_entries = phase_kernel_check(session, hash_df)
    tables, q3_df = phase_slice(session, hash_df, hash_table, k1_entries)
    k2_sql_launches = phase_sql(session, hash_df, hash_table, q3_df, tables,
                                k1_entries)
    k1_replays = phase_stage(session, hash_df, hash_table, q3_df, tables)
    for entry in k1_entries:
        # the profiler's count of K1 in one replay of each hash-agg query
        entry["replayed_launches"] = \
            k1_replays if entry["name"] == "grouped_accumulate_columns" \
            else {}
    captured, k2_launches = phase_mesh(session, hash_df, hash_table, q3_df,
                                       tables)
    k2_entry = phase_k2_check(captured, k2_launches)
    k2_entry["sql_launches"] = k2_sql_launches
    session.stop()
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": k1_entries + [k2_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
