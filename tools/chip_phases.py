"""Run chosen phases of ``chip_smoke.py`` alone on the card, each as
many times as it is named, and report how every run ended: a phase that
fails now and then inside the whole script is repeated here without the
rest.  The phases get the whole script's inputs: the kernels built, the
hash-agg table and q3's tables at the main path's sizes, and K1's
entries of the kernels line from its kernel check.

    python3 tools/chip_phases.py pool pool pool pool stream

Phases: ``mesh`` (the mesh lane's three queries at 4 shards, captured,
then K2's and ``lpt_assign``'s checks), ``pool``, ``stream``, ``analysis``,
``ml``, ``cards`` (shards on several cards, phase 23, which needs two
cards or more, run on a host with four; it prints its kernels line).  K1's kernel
check runs first unless ``cards`` alone is named.  The last line is a
JSON
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

def _mesh(c):
    captured, k2, numbers, lpt_inputs, lpt_launches = CS.phase_mesh(
        c["session"], c["hash_df"], c["hash_table"], c["q3_df"], c["tables"])
    CS.phase_k2_check(captured, k2)
    del captured
    CS.phase_lpt_check(lpt_inputs, lpt_launches,
                       {n: m["lpt_replayed"] for n, m in numbers.items()})


def _cards(c):
    import torch
    CS.check(torch.cuda.device_count() >= 2, "[cards] needs two cards or "
             f"more; {torch.cuda.device_count()} visible")
    entries = CS.phase_cards(c["session"], c["hash_df"], c["hash_table"],
                             c["q3_df"], c["tables"])
    print(json.dumps({"kernels": entries}), flush=True)


PHASES = {
    "cards": _cards,
    "mesh": _mesh,
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
    from spark_tpu_torch import types as T
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql.session import SparkSession
    from spark_tpu_torch.testing import (hash_agg_query, hash_agg_table,
                                         q3_query, q3_tables)

    print(CS.phase_device(), flush=True)
    CS.phase_build()
    session = SparkSession.builder.appName("chip_phases").getOrCreate()
    hash_table = hash_agg_table(CS.MAIN_N, CS.MAIN_GROUPS)
    tables = q3_tables(CS.Q3_ROWS["store_sales"], CS.Q3_ROWS["item"],
                       CS.Q3_ROWS["date_dim"])
    hash_df = hash_agg_query(session, F, hash_table)
    ctx = {"session": session, "hash_table": hash_table, "tables": tables,
           "hash_df": hash_df, "q3_df": q3_query(session, F, T, tables),
           "k1": None if set(names) == {"cards"}
           else CS.phase_kernel_check(session, hash_df),
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
