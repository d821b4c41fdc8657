#!/usr/bin/env python3
"""The hash-agg query on one GPU, this checkout against another, in turns.

    python3 tools/hash_agg_ab.py OTHER_CHECKOUT

Runs ``groupBy(k).agg(sum(v), count(*))`` over 2^22 rows and 1,024
groups (``testing.hash_agg_table``, seed 7) on the card in four fresh
processes — OTHER, this, this, OTHER — so that both trees meet the same
host and card.  Each process prints one JSON line: warm wall time (median
of 5 after one warm-up, ``torch.cuda.synchronize()`` before and after
each ``collect()``), and over one more run under ``torch.profiler`` the
summed device time of its kernels and their launch count.  Every result
is checked against a numpy oracle.  Needs a GPU; imports neither JAX nor
the JAX package.
"""

import json
import os
import subprocess
import sys

RUN = r'''
import json, statistics, sys, time
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
from spark_tpu_torch.sql import functions as F
from spark_tpu_torch.sql.session import SparkSession
from spark_tpu_torch.testing import hash_agg_query, hash_agg_table
spark = SparkSession.builder.getOrCreate()
table = hash_agg_table(1 << 22, 1024)
df = hash_agg_query(spark, F, table)
rows = sorted((r["k"], r["s"], r["c"]) for r in df.collect())
k, v = table["k"], table["v"]
sums = np.zeros(1024, np.int64)
np.add.at(sums, k, v)
counts = np.bincount(k, minlength=1024)
want = [(g, int(sums[g]), int(counts[g])) for g in range(1024)]
assert rows == want, "hash-agg differs from the numpy oracle"
times = []
for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df.collect()
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    df.collect()
    torch.cuda.synchronize()
kern = [e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA]
print(json.dumps({"wall_ms": statistics.median(times), "walls_ms": times,
                  "device_ms": sum(e.self_device_time_total for e in kern) / 1e3,
                  "launches": sum(e.count for e in kern)}))
'''


def run(tree):
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, tree in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        print(json.dumps({"tree": name, "path": tree, **run(tree)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
