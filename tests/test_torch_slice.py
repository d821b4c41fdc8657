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


def test_port_never_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "spark_tpu"):
                bad.append((os.path.relpath(path, REPO), name))
    assert not bad, bad


def test_importing_the_port_loads_neither():
    code = ("import sys, pkgutil, importlib, spark_tpu_torch\n"
            "for m in pkgutil.walk_packages(spark_tpu_torch.__path__,"
            " 'spark_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'spark_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
