"""Command-line entry points of the PyTorch port (the port of
``spark_tpu/cli.py``; the ``bin/`` + ``launcher/`` analog).

The reference ships shell scripts that assemble a JVM command line
(`bin/spark-submit` -> `launcher/Main.java` -> `SparkSubmit.scala:109`);
here the driver IS Python, so the launcher collapses to argv dispatch:

    python -m spark_tpu_torch.cli submit app.py [args...]   # spark-submit
    python -m spark_tpu_torch.cli sql [-e QUERY] [-f FILE]  # spark-sql shell
    python -m spark_tpu_torch.cli shell                     # pyspark REPL
    python -m spark_tpu_torch.cli launch --processes N app.py [args...]

A session built here runs on ``spark.torch.device`` — ``cuda`` unless a
``--conf spark.torch.device=cpu`` says otherwise; without a card the
default session refuses to start (no CPU fallback).
"""

from __future__ import annotations

import argparse
import code
import runpy
import sys
from typing import List, Optional


def _parse_conf_pair(pair: str):
    if "=" not in pair:
        raise SystemExit(f"--conf expects key=value, got {pair!r}")
    return pair.split("=", 1)


def _run_script(script: str, script_args) -> int:
    sys.argv = [script] + list(script_args)
    runpy.run_path(script, run_name="__main__")
    return 0


def _session(conf_pairs: List[str]):
    from .sql.session import SparkSession
    # --conf must flow through the BUILDER: SparkSession.__init__ reads
    # config (the device, the memory budget) during construction
    b = SparkSession.builder.appName("spark-tpu-cli")
    for pair in conf_pairs or []:
        k, v = _parse_conf_pair(pair)
        b = b.config(k, v)
    return b.getOrCreate()


def split_sql_statements(text: str) -> List[str]:
    """Split a script on ';' outside quotes (single, double, and '--'
    line comments), so literals like SELECT ';' survive."""
    out: List[str] = []
    buf: List[str] = []
    quote: Optional[str] = None
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if quote:
            buf.append(ch)
            if ch == quote:
                # doubled quote inside a literal is an escape ('' / "")
                if i + 1 < n and text[i + 1] == quote:
                    buf.append(text[i + 1])
                    i += 1
                else:
                    quote = None
        elif ch in ("'", '"'):
            quote = ch
            buf.append(ch)
        elif ch == "-" and i + 1 < n and text[i + 1] == "-":
            while i < n and text[i] != "\n":
                i += 1
            continue
        elif ch == ";":
            out.append("".join(buf).strip())
            buf = []
        else:
            buf.append(ch)
        i += 1
    tail = "".join(buf).strip()
    if tail:
        out.append(tail)
    return [s for s in out if s]


def statements_if_complete(text: str) -> Optional[List[str]]:
    """Statements of ``text`` if it ends with a ';' OUTSIDE any string
    literal/comment; None while a literal is open or no terminator yet."""
    quote: Optional[str] = None
    ends_semi = False
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if quote:
            if ch == quote:
                if i + 1 < n and text[i + 1] == quote:
                    i += 1
                else:
                    quote = None
        elif ch in ("'", '"'):
            quote = ch
            ends_semi = False     # a literal after ';' starts a new stmt
        elif ch == "-" and i + 1 < n and text[i + 1] == "-":
            while i < n and text[i] != "\n":
                i += 1
            continue
        elif ch == ";":
            ends_semi = True
        elif not ch.isspace():
            ends_semi = False
        i += 1
    if quote is not None or not ends_semi:
        return None
    return split_sql_statements(text)


def _show(df) -> None:
    df.show(100)


def cmd_submit(args) -> int:
    """Run a user script with sys.argv rewritten (SparkSubmit.runMain:
    the script builds its own session via SparkSession.builder)."""
    _session(args.conf)     # pre-warm the active session with --conf
    return _run_script(args.script, args.script_args)


def cmd_launch(args) -> int:
    """Multi-process launcher (the SparkSubmit → Master/Worker role,
    `deploy/SparkSubmit.scala:66` + `master/Master.scala:41`, collapsed:
    no Master daemon — a coordinator address and a process index are the
    entire control plane).

    Modes:
    * fan-out (no --process-id): spawn --processes local workers through
      the pool's all-or-none ``serving.pool.spawn_gang``, each
      re-entering this command with its own index — the local-cluster
      dev mode;
    * worker (--process-id given): export the cluster coordinates via
      SPARK_TPU_* env (``parallel.cluster``'s contract, which
      ``enableHostShuffle`` and ``init_cluster`` read) and run the
      script.  On a multi-host deployment the operator runs THIS mode
      once per host."""
    import os
    import socket

    if args.process_id is None:
        # negatives clamp to 0 (no infinite-restart mode: a crash-looping
        # gang burns the TPU reservation; supervise with a real orchestrator
        # if unbounded restarts are wanted)
        max_restarts = max(0, getattr(args, "max_restarts", 0) or 0)
        for attempt in range(max_restarts + 1):
            coord = args.coordinator
            if coord is None:
                # ephemeral-port probe: closed before process 0 rebinds
                # it — a small window another process could steal the
                # port in; pass --coordinator explicitly on busy shared
                # hosts.  Re-probed per attempt: a crashed gang can leave
                # the old port in TIME_WAIT.
                with socket.socket() as s:
                    s.bind(("localhost", 0))
                    coord = f"localhost:{s.getsockname()[1]}"
            cmds = []
            for i in range(args.processes):
                argv = [sys.executable, "-m", "spark_tpu_torch.cli",
                        "launch", "--coordinator", coord,
                        "--processes", str(args.processes),
                        "--process-id", str(i)]
                for c in args.conf:
                    argv += ["--conf", c]
                argv += [args.script] + list(args.script_args)
                cmds.append(argv)
            # all-or-none through the pool's spawn seam: on a partial
            # spawn the already-started workers are terminated AND waited
            from .serving.pool import spawn_gang
            procs = spawn_gang(cmds)
            # any worker failing (incl. SIGNAL deaths, which report
            # negative) fails the attempt and kills the siblings —
            # otherwise survivors wait at their first barrier for its
            # full timeout.  The REPORTED code is the FIRST
            # failure's (the cause), not the SIGTERM this launcher then
            # sends to the others.
            first_rc = 0
            pending = set(procs)
            while pending:
                for pr in list(pending):
                    status = pr.poll()
                    if status is None:
                        continue
                    pending.discard(pr)
                    if status != 0 and first_rc == 0:
                        first_rc = 128 + abs(status) if status < 0 \
                            else status
                        for other in pending:
                            other.terminate()
                if pending:
                    import time as _t
                    _t.sleep(0.1)
            if first_rc == 0:
                return 0
            if attempt < max_restarts:
                # WHOLE-gang restart: checkpointed queries resume from
                # their WAL / multibatch checkpoints — `spark-submit
                # --supervise` (deploy/Client.scala) semantics at gang
                # granularity
                print(f"[spark-tpu-launch] gang failed (rc={first_rc}); "
                      f"restart {attempt + 1}/{max_restarts}",
                      file=sys.stderr)
        return first_rc

    env_coord = args.coordinator
    if env_coord is not None:
        os.environ["SPARK_TPU_COORDINATOR"] = env_coord
    if args.processes:
        os.environ["SPARK_TPU_NUM_PROCESSES"] = str(args.processes)
    os.environ["SPARK_TPU_PROCESS_ID"] = str(args.process_id)
    # UNLIKE cmd_submit, no session pre-warm here: the script builds
    # its own session (and its host shuffle) from the environment.
    # --conf pairs ride the environment and seed that session.
    if args.conf:
        pairs = ["=".join(_parse_conf_pair(p)) for p in args.conf]
        os.environ["SPARK_TPU_LAUNCH_CONF"] = "\x1f".join(pairs)
    return _run_script(args.script, args.script_args)


def cmd_sql(args) -> int:
    """spark-sql: execute -e/-f statements or run an interactive loop
    (`SparkSQLCLIDriver` analog)."""
    spark = _session(args.conf)
    if args.e:
        _show(spark.sql(args.e))
        return 0
    if args.f:
        with open(args.f) as fh:
            text = fh.read()
        for stmt in split_sql_statements(text):
            _show(spark.sql(stmt))
        return 0
    print("spark-tpu-sql interactive shell; end statements with ';', "
          "exit with 'quit;'")
    buf: List[str] = []
    while True:
        try:
            line = input("spark-sql> " if not buf else "         > ")
        except EOFError:
            break
        buf.append(line)
        joined = "\n".join(buf)
        stmts = statements_if_complete(joined)
        if stmts is None:          # open literal or no terminating ';'
            continue
        buf = []
        for stmt in stmts:
            if stmt.lower() in ("quit", "exit"):
                return 0
            try:
                _show(spark.sql(stmt))
            except Exception as e:        # noqa: BLE001 — REPL keeps going
                print(f"Error: {e}", file=sys.stderr)
    return 0


def cmd_shell(args) -> int:
    """pyspark-style Python REPL with `spark` and its SparkContext `sc`
    bound."""
    spark = _session(args.conf)
    ns = {"spark": spark, "sc": spark.sparkContext}
    banner = ("spark_tpu_torch shell\nSparkSession available as 'spark'. "
              "SparkContext as 'sc'.")
    code.interact(banner=banner, local=ns)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="spark_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("submit", help="run a python app (spark-submit)")
    ps.add_argument("--conf", action="append", default=[])
    ps.add_argument("script")
    ps.add_argument("script_args", nargs=argparse.REMAINDER)
    ps.set_defaults(fn=cmd_submit)

    pl = sub.add_parser(
        "launch", help="multi-process launcher (spark-submit --deploy)")
    pl.add_argument("--processes", type=int, default=1,
                    help="total processes in the cluster")
    pl.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (auto for local fan-out)")
    pl.add_argument("--process-id", type=int, default=None,
                    help="this process's index; omit to fan out locally")
    pl.add_argument("--max-restarts", type=int, default=0,
                    help="supervise: relaunch the WHOLE gang up to N "
                         "times after a failure (checkpointed queries "
                         "resume); the spark-submit --supervise role")
    pl.add_argument("--conf", action="append", default=[])
    pl.add_argument("script")
    pl.add_argument("script_args", nargs=argparse.REMAINDER)
    pl.set_defaults(fn=cmd_launch)

    pq = sub.add_parser("sql", help="SQL shell (spark-sql)")
    pq.add_argument("-e", help="execute one statement and exit")
    pq.add_argument("-f", help="execute statements from a file")
    pq.add_argument("--conf", action="append", default=[])
    pq.set_defaults(fn=cmd_sql)

    pr = sub.add_parser("shell", help="python REPL with a session (pyspark)")
    pr.add_argument("--conf", action="append", default=[])
    pr.set_defaults(fn=cmd_shell)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
