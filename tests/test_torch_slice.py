"""The port's single-device DataFrame path end to end against ``spark_tpu``:
the hash-agg lane and the TPC-DS q3 shape through ``SparkSession`` /
``DataFrame`` on both packages, at a few thousand rows.  ``collect()``
rows must be equal.  Also: the device policy, the state carry-over
function, and the rule that the port imports neither JAX nor
``spark_tpu``.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spark_tpu import types as RT
from spark_tpu.columnar import ColumnBatch as RBatch
from spark_tpu.sql import functions as RF
from spark_tpu_torch import config as TC
from spark_tpu_torch import kernels as TK
from spark_tpu_torch import types as TT
from spark_tpu_torch.columnar import ColumnBatch as TBatch
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import (assert_parts_equal, assert_rows_equal,
                                     batch_parts, hash_agg_query,
                                     hash_agg_table, q3_query, q3_tables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


@pytest.mark.parametrize("mxu", [True, False])
def test_hash_agg_lane_matches_reference(spark, tspark, mxu, monkeypatch):
    monkeypatch.setattr(TK, "MXU_AGG_ENABLED", mxu)
    table = hash_agg_table(4096, 64)
    ref = hash_agg_query(spark, RF, table).collect()
    got = hash_agg_query(tspark, TF, table).collect()
    assert len(got) == 64
    assert_rows_equal(ref, got)


@pytest.mark.parametrize("mxu", [True, False])
def test_q3_matches_reference(spark, tspark, mxu, monkeypatch):
    """q3 over few-thousand-row tables: two joins, the pushed-down filters,
    a three-key group-by whose brand-id range is too wide for the bucket
    table (the sort-based branch), a decimal sum, a mixed-direction sort
    and a limit."""
    monkeypatch.setattr(TK, "MXU_AGG_ENABLED", mxu)
    tables = q3_tables(n_sales=60000, n_items=400, n_dates=4000)
    ref = q3_query(spark, RF, RT, tables).collect()
    got = q3_query(tspark, TF, TT, tables).collect()
    assert len(got) > 20
    assert_rows_equal(ref, got)
    assert list(got[0].__fields__) == ["d_year", "i_brand_id", "i_brand",
                                       "sum_agg"]


def test_dataframe_surface(spark, tspark):
    """select / withColumn / where / orderBy / limit / count / distinct
    on both packages."""
    def q(session, F):
        df = session.createDataFrame(
            [(1, "a", 2.5), (2, "b", None), (3, None, -1.0), (4, "a", 0.5),
             (5, "b", 7.0)], ["id", "s", "x"])
        out = (df.withColumn("y", F.col("id") * 3 - 1)
                 .where(F.col("x").isNotNull() | (F.col("s") == "b"))
                 .select("id", "s", (F.col("y") / 2).alias("h"))
                 .orderBy(F.col("s").desc(), "id").limit(3).collect())
        return out, df.count(), df.select("s").distinct().count()
    r_rows, r_n, r_d = q(spark, RF)
    g_rows, g_n, g_d = q(tspark, TF)
    assert_rows_equal(r_rows, g_rows)
    assert (r_n, r_d) == (g_n, g_d) == (5, 3)


def test_operator_metrics_match_reference(spark, tspark):
    """spark.sql.metrics.enabled: per-operator output row counts of a
    join + filter + aggregate plan, keyed by (operator id, label)."""
    key = "spark.sql.metrics.enabled"

    def q(session, F):
        tables = q3_tables(n_sales=3000, n_items=200, n_dates=2000)
        q3_query(session, F, RT if F is RF else TT, tables).collect()
        return session._last_qe.metrics

    spark.conf.set(key, "true")
    tspark.conf.set(key, "true")
    try:
        ref, got = q(spark, RF), q(tspark, TF)
    finally:
        spark.conf.unset(key)
        tspark.conf.unset(key)
    assert got and got == ref


def test_state_carry_over_from_reference_batch():
    """``ColumnBatch.from_numpy_parts`` rebuilds a reference batch's
    ``to_host()`` parts bit for bit."""
    rb = RBatch.from_arrays({
        "i": [1, None, 3], "s": ["x", None, "y"],
        "d": np.array([1.25, 2.5, np.nan])},
        schema=RT.StructType([RT.StructField("i", RT.int64),
                              RT.StructField("s", RT.string),
                              RT.StructField("d", RT.DecimalType(7, 2))]))
    host = rb.to_host()
    tb = TBatch.from_numpy_parts(
        host.names, [v.dtype.simpleString() for v in host.vectors],
        [v.data for v in host.vectors], [v.valid for v in host.vectors],
        host.row_valid, [v.dictionary for v in host.vectors],
        host.capacity, "cpu")
    assert_parts_equal(batch_parts(host), batch_parts(tb), live_only=False)
    assert tb.vectors[2].data.dtype == TT.DecimalType(7, 2).torch_dtype \
        == torch.int64


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default session runs there")
    active = TSession._active
    TSession._active = None
    try:
        with pytest.raises(RuntimeError, match="spark.torch.device"):
            TSession.builder.getOrCreate()
    finally:
        TSession._active = active
    assert TC.Conf().get(TC.TORCH_DEVICE) == "cuda"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "spark_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


#: what the port may not import: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "spark_tpu")
#: the host decoder and toPandas' frame: imported only inside the
#: functions of ``spark_tpu_torch/io.py``, so no import of the port loads
#: them
HOST_IO = ("pyarrow", "pandas")


def _module_level_imports(path):
    """Import names of a file's module-level statements (not inside a
    function)."""
    tree = ast.parse(open(path).read(), path)

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module or ""
            yield from walk(child)

    return list(walk(tree))


def test_the_guard_walks_the_streaming_package():
    """The streaming engine is part of what the guard reads: every module
    of ``spark_tpu_torch/streaming/``."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    want = {f"spark_tpu_torch/streaming/{m}.py" for m in (
        "__init__", "api", "core", "dstream", "groupstate", "kafka",
        "state")}
    assert want <= files


def test_the_guard_walks_the_analysis_package():
    """The analysis package, the jdbc source and the command line are
    part of what the guard reads."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    want = {f"spark_tpu_torch/analysis/{m}.py" for m in (
        "__init__", "confcheck", "determinism", "errors", "lint",
        "protocol", "runtime", "verifier", "waivers")}
    want |= {"spark_tpu_torch/jdbc.py", "spark_tpu_torch/cli.py"}
    assert want <= files


def test_port_never_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        for name in _imports(path):
            top = name.split(".")[0]
            if top in FORBIDDEN or (top in HOST_IO
                                    and rel != "spark_tpu_torch/io.py"):
                bad.append((rel, name))
        for name in _module_level_imports(path):
            if name.split(".")[0] in HOST_IO:
                bad.append((rel, name))
    assert not bad, bad


def test_importing_the_port_loads_neither():
    code = ("import sys, pkgutil, importlib, spark_tpu_torch\n"
            "for m in pkgutil.walk_packages(spark_tpu_torch.__path__,"
            " 'spark_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            f" {FORBIDDEN + HOST_IO!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("entry", ["pool", "recovery", "ici", "stream",
                                   "analysis"])
def test_worker_entries_load_neither(tmp_path, entry):
    """The processes this package starts by itself, run as they are
    started: a pool worker (``python -m spark_tpu_torch.serving.pool
    --worker``, here told to retire at once), a one-process recovery
    worker, one with the device tier armed (its arena, sidecar and pull
    modules loaded), and a stream worker (the streaming engine over an
    empty source).  None may load jax or the JAX package."""
    import json as _json
    root = tmp_path / "root"
    os.makedirs(root / "reap")
    if entry == "pool":
        (root / "config.json").write_text(_json.dumps(
            {"conf": {"spark.torch.device": "cpu"}, "poll_s": 0.05}))
        (root / "reap" / "0").write_text("reap")
        mod, argv = "spark_tpu_torch.serving.pool", [
            "--worker", str(root), "0"]
    elif entry == "stream":
        mod, argv = "spark_tpu_torch.testing", [
            "stream-worker", str(root), "wagg", str(root / "ckpt"),
            str(root / "out"), "cpu"]
    elif entry == "analysis":
        mod, argv = "spark_tpu_torch.testing", [
            "analysis-worker", "0", "1", str(root), "trace", "20", "cpu"]
    else:
        mode = "norecover" if entry == "recovery" else "ici-unavail"
        mod, argv = "spark_tpu_torch.testing", [
            "recovery-worker", "0", "1", str(root), mode, "20", "cpu"]
    code = ("import runpy, sys, json\n"
            f"sys.argv = [{mod!r}] + {argv!r}\n"
            "rc = None\n"
            "try:\n"
            f"    runpy.run_module({mod!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            f" {FORBIDDEN!r}]\n"
            "print('RESULT', json.dumps({'rc': rc, 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("SPARK_TPU_FAULT_PLAN", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    assert line, (proc.stdout[-2000:], proc.stderr[-2000:])
    got = _json.loads(line[-1].split(" ", 1)[1])
    assert got == {"rc": 0, "bad": []}, (got, proc.stdout[-2000:])


def test_the_guard_walks_the_rdd_ml_graphx_packages():
    """RDD, ML, MLlib, GraphX and the history page are part of what the
    guard reads."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    want = {f"spark_tpu_torch/ml/{m}.py" for m in (
        "__init__", "ann", "base", "classification", "clustering",
        "evaluation", "feature", "fpm", "recommendation", "regression",
        "stat", "tree", "tuning")}
    want |= {f"spark_tpu_torch/rdd/{m}.py" for m in ("__init__", "context",
                                                     "rdd")}
    want |= {f"spark_tpu_torch/graphx/{m}.py" for m in ("__init__", "graph",
                                                        "lib")}
    want |= {"spark_tpu_torch/mllib/__init__.py", "spark_tpu_torch/ui.py"}
    assert want <= files


def test_every_module_of_the_jax_package_has_a_counterpart():
    """A tree diff of module paths: every ``spark_tpu/**.py`` has a
    ``spark_tpu_torch/**.py`` of the same path, but the Pallas kernel's
    module, whose Hopper counterpart is ``cuda_agg.py``."""
    def modules(pkg):
        base = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(root, f), base)
                for root, _dirs, files in os.walk(base)
                for f in files if f.endswith(".py")}
    missing = modules("spark_tpu") - modules("spark_tpu_torch")
    assert missing == {"pallas_agg.py"}
    assert os.path.exists(os.path.join(REPO, "spark_tpu_torch",
                                       "cuda_agg.py"))
