#!/usr/bin/env python3
"""Two forms of KMeans's Lloyd step on one GPU, in turns.

    python3 tools/lloyd_ab.py

The port's ``ml.clustering.lloyd`` sums each cluster's rows as a one-hot
matmul (n x k)' (n x d); the JAX package's step is ``segment_sum``, whose
literal torch form is ``index_add_`` over the assignments (with
``bincount`` for the counts).  Both run 20 steps over the points of
``chip_smoke.py``'s ``[ml]`` (c) (2^22 x 20 float64 around 10 seeded
Gaussian centres, the same numpy starts), on the card.  The two must
give centres within rtol 1e-9 of each other.  Then, in turns one-hot,
index_add_, index_add_, one-hot, three timed runs each after one
warm-up (CUDA events, median).  Prints the card's name and power limit
first and one JSON line per turn.  Needs a GPU; imports neither JAX nor
the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402


def lloyd_index_add(X, centers, iters):
    """``lloyd`` with the sums as ``index_add_`` and the counts as
    ``bincount``."""
    import torch
    from spark_tpu_torch.ml.clustering import _sq_dists
    k, d = centers.shape
    for _ in range(iters):
        assign = _sq_dists(X, centers).argmin(dim=1)
        sums = torch.zeros((k, d), dtype=X.dtype,
                           device=X.device).index_add_(0, assign, X)
        counts = torch.bincount(assign, minlength=k).to(X.dtype)
        centers = torch.where(counts[:, None] > 0,
                              sums / counts.clamp_min(1.0)[:, None],
                              centers)
    return centers


def median_ms(fn, reps=3):
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("lloyd_ab: no CUDA device", file=sys.stderr)
        return 2
    from spark_tpu_torch.ml.clustering import lloyd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(CS.ML_SEED + 2)
    centres = rng.normal(0, 10, (CS.ML_KM_K, CS.ML_KM_DIM))
    X = centres[rng.integers(0, CS.ML_KM_K, CS.ML_KM_ROWS)] \
        + rng.normal(0, 1, (CS.ML_KM_ROWS, CS.ML_KM_DIM))
    start = X[np.random.default_rng(CS.ML_SEED).choice(
        CS.ML_KM_ROWS, CS.ML_KM_K, replace=False)]
    Xd = torch.from_numpy(X).cuda()
    Cd = torch.from_numpy(start).cuda()
    forms = {"one_hot": lambda: lloyd(Xd, Cd, CS.ML_KM_ITERS),
             "index_add": lambda: lloyd_index_add(Xd, Cd, CS.ML_KM_ITERS)}
    a, b = forms["one_hot"]().cpu(), forms["index_add"]().cpu()
    if not torch.allclose(a, b, rtol=1e-9, atol=0):
        print(f"lloyd_ab: the forms differ by {(a - b).abs().max()}",
              file=sys.stderr)
        return 1
    for name in ("one_hot", "index_add", "index_add", "one_hot"):
        print(json.dumps({"form": name, "rows": CS.ML_KM_ROWS,
                          "dim": CS.ML_KM_DIM, "k": CS.ML_KM_K,
                          "steps": CS.ML_KM_ITERS,
                          "median_ms": median_ms(forms[name])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
