#!/usr/bin/env python3
"""How a float segment sum on the card depends on where its segment lies.

    python3 tools/segment_sum_probe.py

The sort-based grouped aggregate (``spark_tpu_torch/kernels.py``
``segment_reduce``) needs float sums whose bits depend only on a group's
values and their order: a ROLLUP level whose only child holds the same
rows must tie with it, as in sqlite (TPC-DS q67 ranks the two).  For each
of three ways to sum float64 segments on the card — ``index_add_``
(atomics), ``index_put_(accumulate=True)`` (the one the port uses) and
``torch.segment_reduce`` — it prints whether two runs give the same bits,
whether the same values at two offsets (runs of 1 to 300,001 values) sum
to the same double, and the median time of one call over 2^22 rows in
1,024 groups (CUDA events, 3 warm-ups, 10 calls), with 1,024 output slots
and with 2^22 (the aggregate's shape: a slot per input row, the groups'
first).  Prints the card's name and power limit first.  Needs a GPU;
imports neither JAX nor the JAX package.
"""

import statistics
import subprocess
import sys

LENGTHS = (1, 2, 3, 31, 32, 33, 100, 1000, 4097, 65536, 300001)


def _twice_placed(torch):
    """The same value sequences at two offsets, with other values between:
    (values, segment ids, number of segments, first copy's ids, second's)."""
    parts, segs, sid = [], [], 0
    first, second = [], []
    for rep in range(2):
        if rep:
            parts.append(torch.full((7,), 12345.67, dtype=torch.float64))
            segs.append(torch.full((7,), sid))
            sid += 1
        g = torch.Generator().manual_seed(2)
        for n in LENGTHS:
            parts.append(torch.randint(0, 10 ** 6, (n,), generator=g)
                         .double() / 100.0 * 1.37)
            segs.append(torch.full((n,), sid))
            (second if rep else first).append(sid)
            sid += 1
    return torch.cat(parts), torch.cat(segs), sid, first, second


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("segment_sum_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])

    def index_add(x, seg, k):
        return torch.zeros(k, dtype=x.dtype, device=x.device) \
            .index_add_(0, seg, x)

    def index_put(x, seg, k):
        return torch.zeros(k, dtype=x.dtype, device=x.device) \
            .index_put_((seg,), x, accumulate=True)

    def segment_reduce(x, seg, k):
        lengths = torch.bincount(seg, minlength=k)
        return torch.segment_reduce(x, "sum", lengths=lengths, unsafe=True)

    x, seg, k, first, second = _twice_placed(torch)
    x, seg = x.cuda(), seg.cuda()
    first, second = torch.tensor(first).cuda(), torch.tensor(second).cuda()
    g = torch.Generator().manual_seed(0)
    n = 1 << 22
    bx = torch.rand(n, generator=g, dtype=torch.float64).cuda()
    bseg = torch.sort(torch.randint(0, 1024, (n,), generator=g)).values.cuda()
    for name, fn in (("index_add_", index_add), ("index_put_ accumulate",
                                                  index_put),
                     ("segment_reduce", segment_reduce)):
        a, b = fn(x, seg, k), fn(x, seg, k)
        same_runs = bool((a == b).all())
        same_place = bool((a[first] == a[second]).all())
        ms = []
        for slots in (1024, n):
            for _ in range(3):
                fn(bx, bseg, slots)
            times = []
            for _ in range(10):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(bx, bseg, slots)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            ms.append(statistics.median(times))
        print(f"{name}: two runs equal {same_runs}; the same values at two "
              f"offsets sum equal {same_place}; 2^22 rows in 1,024 groups "
              f"{ms[0]:.4f} ms into 1,024 slots, {ms[1]:.4f} ms into 2^22")
    return 0


if __name__ == "__main__":
    sys.exit(main())
