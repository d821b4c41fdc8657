"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``, then ``checks``: each number the correctness check
compared, with its limit.  The same checks are the last lines of
standard error.  Without the cards, without the program beside this
folder, or with a JAX module loaded, it exits non-zero and prints no
result.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _process_age_s() -> float:
    """Seconds since this process started (Linux: ``/proc/self/stat``'s
    start time against the boot clock), so set-up counts the
    interpreter's own start too."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(time.clock_gettime(time.CLOCK_BOOTTIME) - start, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


_STARTED -= _process_age_s() - (time.perf_counter() - _STARTED)

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)


def main(argv=None, device: str = "cuda", rows=None) -> int:
    """The command line's run; the tests call it with ``device="cpu"``
    and tiny ``rows`` (the harness's CPU path)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if BENCH_DIR not in sys.path:
        sys.path.insert(0, BENCH_DIR)
    sys.path.insert(1, CHECKOUT)
    from harness import driver
    try:
        out = driver.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device=device, rows=rows,
                         started=_STARTED)
    except driver.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    bad = driver.forbidden_loaded()
    if bad:
        print(f"no result: modules loaded that no run may load: {bad}",
              file=sys.stderr)
        return 3
    for name, c in out.checks.items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**out.result, "checks": out.checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
