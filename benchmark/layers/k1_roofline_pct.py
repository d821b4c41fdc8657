"""K1 (``cuda_agg.py``, ``csrc/grouped_accumulate.cu``): its byte bound
over its device time.  The bound is the aggregate's own work, counted
from the generated tables whatever kernel does it (``harness.bytemodel``:
live input rows' keys and value at their SQL widths read once, the
groups written once) at the card's HBM rate; the time is the mean of
``grouped_accumulate_kernel``'s records in the profiled window.  The
texts that launch K1 are those whose capture in set-up counted a launch
(the program's ``cuda_agg.CAPTURED_LAUNCHES``), each weighted by its
requests in the window."""

import importlib

from harness import bytemodel, peaks, spec

KERNEL = "grouped_accumulate_kernel"


def read(ctx):
    info = ctx.trace
    if info is None:
        return None
    recs = [r for c in info.device for r in info.kernel_records(c, KERNEL)]
    texts = [t for t, n in ctx.captured.items() if n.get("k1")]
    if not recs or not texts:
        return None
    if any(ctx.captured[t]["k1"] != 1 for t in texts):
        return None                      # one aggregate per text is modelled
    w0, w1 = info.window
    weight = {t: sum(1 for x, s, e in info.requests
                     if x == t and s >= w0 and e <= w1) for t in texts}
    if not sum(weight.values()):
        return None
    schema = spec.generator(ctx.cell).SCHEMA
    bound_s = 0.0
    for t in texts:
        params = importlib.import_module(f"reference.{t}").PARAMS
        read_b, written_b = bytemodel.star_aggregate_bytes(
            ctx.tables, schema, params)
        bound_s += weight[t] * (read_b + written_b) / peaks.HBM_BYTES_PER_S
    bound_s /= sum(weight.values())
    mean_s = sum(e - s for s, e in recs) / len(recs) / 1e6
    return 100.0 * bound_s / mean_s
