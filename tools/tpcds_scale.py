#!/usr/bin/env python3
"""The ``[tpcds]`` phase of ``chip_smoke.py`` at several scales.

    python3 tools/tpcds_scale.py [SF_ROWS ...]     (default 20000 50000 100000)

Starts ``SQLServer`` on a card session, as ``chip_smoke.py`` does, and
runs its ``phase_tpcds`` at each ``sf_rows`` in turn (the rows of
``store_sales``; the other tables scale off it), with every check of
that phase: the 66 ported texts POSTed twice and held against sqlite,
each repeat a plan-cache hit, the 33 others refused by name.  Prints
the card's name and power limit, then per scale the phase's seconds by
part (generate, to the card, the sqlite oracle, the server's replies)
as one JSON line.  This is what sets ``chip_smoke.TPCDS_SF_ROWS``: the
largest scale whose phase keeps the whole script within its time
budget.  Needs a GPU and ``nvcc``; imports neither JAX nor the JAX
package.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("tpcds_scale: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from spark_tpu_torch.server import SQLServer
    from spark_tpu_torch.sql.session import SparkSession

    sizes = [int(a) for a in argv] or [20_000, 50_000, 100_000]
    card = cs.phase_device()
    cs.phase_build()
    session = SparkSession.builder.appName("tpcds_scale").getOrCreate()
    srv = SQLServer(session, host="127.0.0.1", port=0,
                    workers=cs.SERVER_CLIENTS).start()
    try:
        for sf_rows in sizes:
            parts = cs.phase_tpcds(session, srv, sf_rows)
            print(json.dumps({"sf_rows": sf_rows, "seconds": parts,
                              "card": card}), flush=True)
    finally:
        srv.stop()
        session.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
