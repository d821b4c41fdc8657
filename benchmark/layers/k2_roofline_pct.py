"""K2 (``cuda_a2a.py``, ``csrc/all_to_all.cu``): the cross-card bound of
one statement's shuffles over ``exchange_kernel``'s time on the slowest
card.  The bound copies PERF.md's rule: on a card, the larger of its
NVLink time (the bytes it sends or receives at 450 GB/s) and its memory
time (its bytes read once and written once at 3.35 TB/s), for the rows
the shuffle moves, counted from the generated tables
(``harness.bytemodel.star_shuffle_bytes``) and spread evenly over the
shards and their destinations.  The time is the sum of the card's
``exchange_kernel`` records between the first and the last request that
lie wholly in the profiled window, over those requests: with one client
they run one after another.  The kernel's waits for other cards are
inside that time and not split from its copy."""

import importlib

from harness import bytemodel, peaks, spec

KERNEL = "exchange_kernel"


def read(ctx):
    info = ctx.trace
    if info is None or int(ctx.cell.mix["clients"]) != 1 \
            or len(ctx.cell.texts) != 1:
        return None
    (text,) = ctx.cell.texts
    w0, w1 = info.window
    reqs = sorted((s, e) for t, s, e in info.requests if s >= w0 and e <= w1)
    if not reqs:
        return None
    r0, r1 = reqs[0][0], reqs[-1][1]
    per_card = []
    for c in info.device:
        recs = [(s, e) for s, e in info.kernel_records(c, KERNEL)
                if s >= r0 and e <= r1]
        per_card.append(sum(e - s for s, e in recs) / 1e6 / len(reqs))
    slowest = max(per_card)
    if slowest <= 0:
        return None
    params = importlib.import_module(f"reference.{text}").PARAMS
    total = bytemodel.star_shuffle_bytes(
        ctx.tables, spec.generator(ctx.cell).SCHEMA, params)
    p = len(info.device)
    share = total / p
    bound_s = max(share * (p - 1) / p / peaks.NVLINK_BYTES_PER_S,
                  2 * share / peaks.HBM_BYTES_PER_S)
    return 100.0 * bound_s / slowest
