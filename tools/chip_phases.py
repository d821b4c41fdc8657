"""Run chosen phases of ``chip_smoke.py`` alone on the card, each as
many times as it is named, and report how every run ended: a phase that
fails now and then inside the whole script is repeated here without the
rest.  The phases get the whole script's inputs: the kernels built, the
hash-agg table and q3's tables at the main path's sizes, and K1's
entries of the kernels line from its kernel check.

    python3 tools/chip_phases.py pool pool pool pool stream

Phases: ``pool``, ``stream``, ``analysis``, ``ml``.  The last line is a JSON
list of the runs (phase, ok, seconds, the failure); the exit code is 1
if any run failed, 2 without a card or with an unknown phase."""

import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as CS  # noqa: E402

PHASES = {
    "pool": lambda c: CS.phase_pool(c["session"], c["hash_table"],
                                    c["tables"], c["k1"], c["k2"]),
    "stream": lambda c: CS.phase_stream(c["session"], c["k1"], c["k2"]),
    "analysis": lambda c: CS.phase_analysis(
        c["session"], c["hash_table"], c["tables"], c["k1"], c["k2"],
        c["pull"]),
    "ml": lambda c: CS.phase_ml(c["session"], c["k1"], c["k2"], c["pull"]),
}


def main(names) -> int:
    import torch
    if not names or any(n not in PHASES for n in names):
        print(f"usage: python3 tools/chip_phases.py {{{'|'.join(PHASES)}}}"
              "...", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql.session import SparkSession
    from spark_tpu_torch.testing import (hash_agg_query, hash_agg_table,
                                         q3_tables)

    print(CS.phase_device(), flush=True)
    CS.phase_build()
    session = SparkSession.builder.appName("chip_phases").getOrCreate()
    hash_table = hash_agg_table(CS.MAIN_N, CS.MAIN_GROUPS)
    ctx = {"session": session, "hash_table": hash_table,
           "tables": q3_tables(CS.Q3_ROWS["store_sales"], CS.Q3_ROWS["item"],
                               CS.Q3_ROWS["date_dim"]),
           "k1": CS.phase_kernel_check(
               session, hash_agg_query(session, F, hash_table)),
           "k2": {"name": "all_to_all"}, "pull": {"name": "pull"}}
    runs = []
    for name in names:
        t0 = time.perf_counter()
        try:
            PHASES[name](ctx)
            err = None
        except Exception as e:  # noqa: BLE001 — reported, then the next run
            traceback.print_exc()
            err = f"{type(e).__name__}: {e}"[:2000]
        runs.append({"phase": name, "ok": err is None,
                     "seconds": time.perf_counter() - t0, "error": err})
        print(f"[chip_phases] {name} run {len(runs)}: "
              f"{'ok' if err is None else 'FAILED'}", flush=True)
    session.stop()
    print(json.dumps(runs))
    return 0 if all(r["ok"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
