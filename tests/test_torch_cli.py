"""The port's command line (``python -m spark_tpu_torch.cli``) against the
JAX package's (``tests/test_cli_examples.py``): ``sql -e`` / ``sql -f``
answer as the JAX package's CLI does, ``submit`` runs a script,
``launch`` fans a gang out and reports its first failure, the two
statement splitters agree with the JAX package's, and a session built
without ``--conf spark.torch.device=cpu`` refuses to start on a machine
with no card."""

import os
import subprocess
import sys

import pytest
import torch

from spark_tpu import cli as RC
from spark_tpu_torch import cli as TC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "SPARK_TPU_PLATFORM": "cpu",
       "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
CPU = ["--conf", "spark.torch.device=cpu"]


def run(args, **kw):
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=240, env=ENV, cwd=ROOT, **kw)


def _table(out):
    """The lines of a ``show()`` table."""
    return [ln for ln in out.splitlines() if ln.startswith(("+", "|"))]


@pytest.mark.parametrize("sql", [
    "SELECT 1 AS one, 'x' AS s",
    "SELECT id % 3 AS g, count(*) AS c, sum(id) AS s FROM range(20) "
    "GROUP BY id % 3 ORDER BY g",
])
def test_sql_e_answers_as_the_reference(sql):
    ref = run(["-m", "spark_tpu.cli", "sql", "-e", sql])
    got = run(["-m", "spark_tpu_torch.cli", "sql", "-e", sql] + CPU)
    assert ref.returncode == 0, ref.stderr[-800:]
    assert got.returncode == 0, got.stderr[-800:]
    assert _table(got.stdout) and _table(got.stdout) == _table(ref.stdout)


def test_sql_file_answers_as_the_reference(tmp_path):
    f = tmp_path / "q.sql"
    f.write_text("CREATE TEMP VIEW v AS SELECT id FROM range(3);\n"
                 "-- a comment; with a semicolon\n"
                 "SELECT count(*) AS c, ';' AS sc FROM v;")
    ref = run(["-m", "spark_tpu.cli", "sql", "-f", str(f)])
    got = run(["-m", "spark_tpu_torch.cli", "sql", "-f", str(f)] + CPU)
    assert ref.returncode == 0, ref.stderr[-800:]
    assert got.returncode == 0, got.stderr[-800:]
    assert _table(got.stdout) == _table(ref.stdout)
    assert any("| 3 " in ln and "| ; " in ln for ln in _table(got.stdout))


def test_submit_runs_script(tmp_path):
    app = tmp_path / "app.py"
    app.write_text(
        "import sys\n"
        "from spark_tpu_torch.sql.session import SparkSession\n"
        "spark = SparkSession.builder.getOrCreate()\n"
        "print('ROWS', spark.range(int(sys.argv[1])).count(),"
        " spark.device)\n")
    r = run(["-m", "spark_tpu_torch.cli", "submit"] + CPU + [str(app), "7"])
    assert r.returncode == 0, r.stderr[-800:]
    assert "ROWS 7 cpu" in r.stdout


def test_default_device_is_cuda_and_refuses_without_a_card():
    """Without ``--conf spark.torch.device=cpu`` the CLI's session is a
    ``cuda`` one, and with no card it refuses to start: no CPU
    fallback."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine with no card")
    r = run(["-m", "spark_tpu_torch.cli", "sql", "-e", "SELECT 1"])
    assert r.returncode != 0
    assert "spark.torch.device='cuda'" in r.stderr
    assert "+---" not in r.stdout


def test_launch_fans_out_with_the_conf(tmp_path):
    """``launch --processes 2`` starts two workers through the pool's
    gang spawn; each sees its index, the process count and the --conf
    pairs, which seed the session it builds."""
    app = tmp_path / "app.py"
    app.write_text(
        "import os\n"
        "from spark_tpu_torch.sql.session import SparkSession\n"
        "s = SparkSession.builder.getOrCreate()\n"
        "print('P', os.environ['SPARK_TPU_PROCESS_ID'],"
        " os.environ['SPARK_TPU_NUM_PROCESSES'], s.device,"
        " s.conf.get('spark.sql.shuffle.partitions'), flush=True)\n")
    r = run(["-m", "spark_tpu_torch.cli", "launch", "--processes", "2"]
            + CPU + ["--conf", "spark.sql.shuffle.partitions=7", str(app)])
    assert r.returncode == 0, r.stderr[-1500:]
    got = sorted(ln for ln in r.stdout.splitlines() if ln.startswith("P "))
    assert got == ["P 0 2 cpu 7", "P 1 2 cpu 7"]


def test_launch_reports_the_first_failure(tmp_path):
    app = tmp_path / "app.py"
    app.write_text("import os, sys\n"
                   "sys.exit(3 if os.environ['SPARK_TPU_PROCESS_ID'] == '1'"
                   " else 0)\n")
    r = run(["-m", "spark_tpu_torch.cli", "launch", "--processes", "2",
             str(app)])
    assert r.returncode == 3, (r.stdout[-800:], r.stderr[-800:])


SPLITS = [
    "SELECT 1; SELECT 2;",
    "SELECT ';' AS s; SELECT 2",
    "SELECT 'it''s; here'; SELECT \"a;b\"",
    "SELECT 1 -- trailing; comment\n; SELECT 2",
    "  ;; SELECT 1 ;  ",
    "SELECT 'open; literal",
    "",
    "SELECT 1;\nSELECT 'x'\n;",
    "SELECT 1; -- done;",
    "SELECT 'a'; 'b'",
]


@pytest.mark.parametrize("text", SPLITS)
def test_statement_splitters_match_reference(text):
    assert TC.split_sql_statements(text) == RC.split_sql_statements(text)
    assert TC.statements_if_complete(text) \
        == RC.statements_if_complete(text)


def test_shell_binds_spark_and_its_spark_context(monkeypatch):
    """``shell`` hands the REPL ``spark`` and ``sc`` (the session's
    SparkContext, which the JAX package's shell binds too)."""
    import argparse
    import code
    from spark_tpu_torch.rdd import SparkContext
    from spark_tpu_torch.sql.session import SparkSession
    seen = {}
    monkeypatch.setattr(code, "interact",
                        lambda banner, local: seen.update(local, b=banner))
    active = SparkSession._active
    SparkSession._active = None
    try:
        assert TC.cmd_shell(argparse.Namespace(
            conf=["spark.torch.device=cpu"])) == 0
        spark = seen["spark"]
        assert isinstance(seen["sc"], SparkContext)
        assert seen["sc"] is spark.sparkContext
        assert seen["sc"]._session() is spark
        assert "'sc'" in seen["b"]
        assert seen["sc"].parallelize([1, 2, 3]).toDF(["x"]).count() == 3
        spark.stop()
    finally:
        SparkSession._active = active
