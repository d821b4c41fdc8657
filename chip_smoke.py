#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spark_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. device — requires ``torch.cuda.is_available()``; prints the card's
   name and power limit as ``nvidia-smi`` reports them;
2. build — compiles the grouped-accumulate kernel (K1) and the
   all-to-all kernel (K2) from ``spark_tpu_torch/csrc/`` with ``nvcc`` for
   ``sm_90a``, one ``nvcc`` per source, started together;
3. kernel check — K1 against its plain PyTorch version on the card,
   bit-exact, at the main path's own inputs (captured from one warm-up
   run of the hash-agg query), at the edge shapes of the Pallas kernel's
   tests, at N > 2^23 and at B = 10,000; then K1's time at the main-path
   shape (CUDA events, warm-up, median of 25) beside its byte bound, its
   plain version's time and the one-call ``index_add_`` yardstick
   (which the port never calls);
4. slice — a ``SparkSession`` on the default device (the card) runs the
   hash-agg lane (2^22 rows, 1,024 groups) and TPC-DS q3 at SF1 row
   counts through the DataFrame API; each result is held against a numpy
   oracle computed here (integers exact); K1's launch count must rise
   during the hash-agg query; each query's warm wall time is the median
   of 5 runs;
5. mesh slice — the same session with ``spark.tpu.mesh.shards = 4`` (all
   four shards on the card) runs the hash-agg lane, q3 with its
   broadcast joins and q3 with ``spark.sql.autoBroadcastJoinThreshold =
   0`` (both joins shuffled through the skew join), recording every K2
   call's inputs; each result is held against the same numpy oracle;
   K2's launch count must rise during each query; warm wall time (median
   of 5) and a profile line for each;
6. K2 check — K2 against its plain PyTorch version on the card,
   bit-exact, at every exchange the three mesh queries made, at n = 2, 4
   and 8 with bool planes and int32 run tables whose blocks are not
   multiples of 16 bytes, at cap = 1, in the gather form and with 50
   planes (a wide pointer table); then K2's time at the largest recorded
   all-to-all (CUDA events, warm-up, median of 25; and 25 launches back
   to back, which hides the wrapper's host work) beside its byte bound,
   its plain version's time and the one-call
   ``transpose(0, 1).contiguous()`` yardstick on the same bytes
   pre-stacked (which the port never calls);
7. a ``{"kernels": [...]}`` line, the card line, and as the last line
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


def zero_counts():
    """Every kernel's launch count to 0, just before a main-path run."""
    from spark_tpu_torch import cuda_a2a, cuda_agg
    cuda_agg.LAUNCHES = 0
    cuda_a2a.LAUNCHES = 0


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


def phase_kernel_check(session, hash_df):
    """K1 against its plain version, bit-exact; timings at the main path's
    inputs.  Returns the kernel's entry for the kernels line (launches
    filled in by the slice phase)."""
    import torch
    from spark_tpu_torch import cuda_agg

    # the main path's own inputs: one warm-up run of the hash-agg query
    captured = []
    launch = cuda_agg.grouped_accumulate

    def spy(bucket32, planes, n_active, B):
        captured.append((bucket32, planes, n_active, B))
        return launch(bucket32, planes, n_active, B)

    cuda_agg.grouped_accumulate = spy
    try:
        hash_df.collect()
    finally:
        cuda_agg.grouped_accumulate = launch
    check(len(captured) == 1, f"hash-agg query made {len(captured)} K1 "
          "calls, expected 1")
    main = captured[0]
    n, P = main[1].shape
    print(f"[kernel] main-path inputs: N={n} B={main[3]} P={P} "
          f"n_active={int(main[2])}", flush=True)
    check((n, main[3], P, int(main[2])) == (MAIN_N, 4096, 10, 2),
          "main-path K1 shape is not N=2^22, B=4096, P=10, n_active=2")

    cases = [("main path", main)]
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
    max_err = 0
    for name, (b, p, na, B) in cases:
        got = cuda_agg.grouped_accumulate(b, p, na, B)
        want = cuda_agg.grouped_accumulate_plain(b, p, na, B)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"K1 differs from its plain version "
              f"at {name} (max abs err {err})")
        print(f"[kernel] {name}: bit-exact", flush=True)

    b, p, na, B = main
    kernel_ms = cuda_ms(lambda: cuda_agg.grouped_accumulate(b, p, na, B))
    plain_ms = cuda_ms(lambda: cuda_agg.grouped_accumulate_plain(b, p, na, B))
    # yardstick: one library call on the same inputs (every main-path row
    # lies in a live chunk, so no masking is needed for the same result)
    b64, p64 = b.long(), p.long()
    out = torch.zeros((B, P), dtype=torch.int64, device=b.device)
    check(torch.equal(out.index_add_(0, b64, p64),
                      cuda_agg.grouped_accumulate_plain(b, p, na, B)),
          "index_add_ yardstick disagrees with the plain version")
    library_ms = cuda_ms(lambda: out.index_add_(0, b64, p64))
    nbytes = n * (4 + P) + B * P * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[kernel] grouped_accumulate at N={n} B={B} P={P}: "
          f"{kernel_ms:.4f} ms (bound {bound_ms:.4f} ms by bytes, "
          f"{nbytes} B at 3.35 TB/s); plain {plain_ms:.4f} ms; "
          f"index_add_ {library_ms:.4f} ms", flush=True)
    return {"name": "grouped_accumulate", "route": "cuda",
            "source": "spark_tpu_torch/csrc/grouped_accumulate.cu",
            "replaces": "spark_tpu/pallas_agg.py:56",
            "launches": None, "max_abs_err": max_err, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def hash_agg_oracle(table):
    import numpy as np
    k, v = table["k"], table["v"]
    groups = int(k.max()) + 1
    counts = np.bincount(k, minlength=groups)
    total = np.zeros(groups, np.int64)
    np.add.at(total, k, v)
    return sorted((int(g), int(total[g]), int(counts[g]))
                  for g in range(groups) if counts[g] > 0)


def q3_oracle(tables):
    """q3 in numpy: the joins as lookups by surrogate key, exact cents."""
    import numpy as np
    ss, dd, it = tables["store_sales"], tables["date_dim"], tables["item"]
    d_idx = ss["ss_sold_date_sk"] - dd["d_date_sk"][0]
    i_idx = ss["ss_item_sk"] - 1
    keep = (dd["d_moy"][d_idx] == 11) & (it["i_manufact_id"][i_idx] == 28)
    cents = np.round(ss["ss_ext_sales_price"][keep] * 100).astype(np.int64)
    year = dd["d_year"][d_idx[keep]]
    brand_id = it["i_brand_id"][i_idx[keep]]
    brand = it["i_brand"][i_idx[keep]]
    groups = {}
    for y, bi, bn, c in zip(year.tolist(), brand_id.tolist(), brand.tolist(),
                            cents.tolist()):
        groups[(y, bi, bn)] = groups.get((y, bi, bn), 0) + c
    rows = sorted(groups.items(),
                  key=lambda kv: (kv[0][0], -kv[1], kv[0][1], kv[0][2]))
    return [(y, bi, bn, c / 100.0) for (y, bi, bn), c in rows[:100]]


def phase_slice(session, hash_df, hash_table, kernel_entry):
    from spark_tpu_torch import cuda_agg
    from spark_tpu_torch import types as T
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.testing import q3_tables, q3_query

    t0 = time.perf_counter()
    tables = q3_tables(Q3_ROWS["store_sales"], Q3_ROWS["item"],
                       Q3_ROWS["date_dim"])
    q3_df = q3_query(session, F, T, tables)
    print(f"[slice] q3 tables at SF1 row counts {Q3_ROWS} made and moved "
          f"to the card in {time.perf_counter() - t0:.2f} s", flush=True)

    # the main path's run: counts zeroed just before, read just after
    zero_counts()
    hash_rows = hash_df.collect()
    hash_launches = cuda_agg.LAUNCHES
    q3_rows = q3_df.collect()
    total_launches = cuda_agg.LAUNCHES
    q3_launches = total_launches - hash_launches
    check(hash_launches > 0, "K1 was not launched during the hash-agg query")
    kernel_entry["launches"] = total_launches

    got = sorted((r["k"], r["s"], r["c"]) for r in hash_rows)
    check(got == hash_agg_oracle(hash_table),
          "hash-agg result differs from the numpy oracle")
    want_q3 = q3_oracle(tables)
    got_q3 = [tuple(r) for r in q3_rows]
    check(len(want_q3) > 0, "q3 oracle selected no rows")
    check(got_q3 == want_q3, f"q3 result differs from the numpy oracle "
          f"(first rows {got_q3[:2]} vs {want_q3[:2]})")
    print(f"[slice] hash-agg: {len(got)} groups equal to the oracle; K1 "
          f"launches during the query: {hash_launches} (MXU-form branch)",
          flush=True)
    branch = "MXU-form (K1)" if q3_launches else "sort-based"
    print(f"[slice] q3: {len(got_q3)} rows equal to the oracle; K1 launches "
          f"during the query: {q3_launches} ({branch} branch)", flush=True)

    hash_ms = wall_ms(hash_df.collect)
    q3_ms = wall_ms(q3_df.collect)
    print(f"[slice] warm wall time, median of 5: hash-agg {hash_ms:.2f} ms "
          f"(N={MAIN_N}, {MAIN_GROUPS} groups); q3 {q3_ms:.2f} ms", flush=True)
    profile_query("hash-agg", hash_df.collect)
    profile_query("q3", q3_df.collect)
    return tables, q3_df


#: the hand-written kernels by the name of their ``__global__`` function
OWN_KERNELS = (("K1", "grouped_accumulate_kernel"),
               ("K2", "all_to_all_kernel"))


def profile_query(name, fn, top=6):
    """Where one warm run's time goes: device time summed over the kernels
    ``torch.profiler`` saw, against the run's wall time under the
    profiler (which adds host overhead), each hand-written kernel's own
    time, launches and share of the device time, and the largest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device kernels only: an aten op's row repeats its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, e.count, e.key))
    device_ms = sum(us for us, _c, _k in rows) / 1e3
    rows.sort(reverse=True)
    own = []
    for kid, fn_name in OWN_KERNELS:
        hits = [(us, c) for us, c, k in rows if fn_name in k]
        ms = sum(us for us, _c in hits) / 1e3
        share = ms / device_ms if device_ms else 0.0
        own.append(f"{kid} {fn_name} x{sum(c for _u, c in hits)} "
                   f"{ms:.4f} ms ({share:.2%} of device time)")
    tops = "; ".join(f"{k[:60]} x{c} {us / 1e3:.3f} ms"
                     for us, c, k in rows[:top])
    print(f"[profile] {name}: wall {wall:.2f} ms under the profiler, device "
          f"busy {device_ms:.3f} ms ({device_ms / wall:.1%}), "
          f"{sum(c for _u, c, _k in rows)} kernel launches; "
          f"{'; '.join(own)}; top: {tops}", flush=True)


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
    nbytes = 2 * _a2a_bytes(planes, gather)       # read once, write once
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[k2] all_to_all at the largest exchange ({query}), "
          f"{_a2a_desc(planes, gather)}: "
          f"{kernel_ms:.4f} ms (bound {bound_ms:.4f} ms by bytes, {nbytes} "
          f"B at 3.35 TB/s); plain {plain_ms:.4f} ms; transpose "
          f"{library_ms:.4f} ms; back to back {b2b_ms:.4f} ms per call",
          flush=True)
    return {"name": "all_to_all", "route": "cuda",
            "source": "spark_tpu_torch/csrc/all_to_all.cu",
            "replaces": "spark_tpu/parallel/ici.py:352",
            "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def phase_mesh(session, hash_df, hash_table, q3_df, tables):
    """The mesh lane's three queries at 4 shards on the card.  Returns
    every K2 call's inputs from their counted run, as (query, planes,
    gather), and K2's launch count over that run."""
    from spark_tpu_torch import cuda_a2a

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
    entry = phase_kernel_check(session, hash_df)
    tables, q3_df = phase_slice(session, hash_df, hash_table, entry)
    captured, k2_launches = phase_mesh(session, hash_df, hash_table, q3_df,
                                       tables)
    k2_entry = phase_k2_check(captured, k2_launches)
    session.stop()
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [entry, k2_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
