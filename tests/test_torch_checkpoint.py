"""``DataFrame.checkpoint`` / ``localCheckpoint`` of the port against
``spark_tpu``'s on the CPU: the same seeded int, double and string
columns written as parquet under ``spark.tpu.checkpoint.dir`` and read
back, eagerly or at the first action; the read-back answers equal the
reference's (integers and strings exactly, doubles within rtol 1e-9).
Decimal columns are left out: the reference's writer cannot write them
(a fault of the reference recorded in ROADMAP §3).
"""

import os

import numpy as np
import pytest

from spark_tpu.sql import functions as RF
from spark_tpu_torch import config as TC
from spark_tpu_torch.serving.plancache import PlanCache
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql import logical as TL
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import assert_rows_equal

RTOL = 1e-9


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(21)
    n = 2000
    return {"k": rng.integers(0, 25, n).astype(np.int64),
            "x": rng.random(n) * 100.0,
            "s": np.array([f"w{i}" for i in rng.integers(0, 40, n)])}


@pytest.fixture(scope="module")
def tspark(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ckpt")
    s = TSession(TC.Conf({"spark.torch.device": "cpu",
                          "spark.sql.warehouse.dir": str(root / "wh")}))
    yield s
    s.stop()


@pytest.fixture
def dirs(spark, tspark, tmp_path):
    """Each package's checkpoint directory under ``tmp_path``."""
    out = {}
    for name, session in (("ref", spark), ("port", tspark)):
        d = str(tmp_path / name)
        session.conf.set("spark.tpu.checkpoint.dir", d)
        out[name] = d
    yield out
    spark.conf.unset("spark.tpu.checkpoint.dir")
    tspark.conf.unset("spark.tpu.checkpoint.dir")


def _source(session, F, table):
    return session.createDataFrame(table).filter(F.col("x") > 20.0)


def _query(F, df):
    return df.groupBy("s").agg(F.count("*").alias("n"),
                               F.sum("k").alias("sk"),
                               F.sum("x").alias("sx"))


def _checkpoints(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


@pytest.mark.parametrize("method", ["checkpoint", "localCheckpoint"])
def test_eager_checkpoint_writes_at_once(spark, tspark, table, dirs,
                                         method):
    ref = getattr(_source(spark, RF, table), method)()
    got = getattr(_source(tspark, TF, table), method)()
    assert len(_checkpoints(dirs["ref"])) == 1
    assert len(_checkpoints(dirs["port"])) == 1
    assert isinstance(got._plan, TL.FileRelation)
    assert_rows_equal(_query(RF, ref).collect(), _query(TF, got).collect(),
                      rtol=RTOL, ordered=False)
    assert_rows_equal(ref.collect(), got.collect(), rtol=RTOL,
                      ordered=False)


def test_lazy_checkpoint_writes_at_first_action(spark, tspark, table, dirs,
                                                capsys):
    ref = _source(spark, RF, table).checkpoint(eager=False)
    got = _source(tspark, TF, table).checkpoint(eager=False)
    assert _checkpoints(dirs["port"]) == []
    derived = [_query(TF, got), got.filter(TF.col("k") < 5)]
    derived[0].explain()
    got.explain(extended=True)
    assert "Scan" in capsys.readouterr().out
    assert _checkpoints(dirs["port"]) == []         # explain wrote nothing
    want = _query(RF, ref).collect()
    assert_rows_equal(want, derived[0].collect(), rtol=RTOL, ordered=False)
    written = _checkpoints(dirs["port"])
    assert len(written) == 1
    path = os.path.join(dirs["port"], written[0])
    mtimes = {f: os.stat(os.path.join(path, f)).st_mtime_ns
              for f in os.listdir(path)}
    # a second DataFrame over the same checkpoint reads the one
    # materialization: nothing is written again
    assert_rows_equal(ref.filter(RF.col("k") < 5).collect(),
                      derived[1].collect(), rtol=RTOL, ordered=False)
    assert _checkpoints(dirs["port"]) == written
    assert {f: os.stat(os.path.join(path, f)).st_mtime_ns
            for f in os.listdir(path)} == mtimes
    assert len(_checkpoints(dirs["ref"])) == 1


def test_default_directory_is_under_the_warehouse(tspark, table):
    got = _source(tspark, TF, table).checkpoint()
    base = os.path.join(tspark.conf.get(TC.WAREHOUSE_DIR), "_checkpoints")
    assert got._plan.paths[0].startswith(base)
    assert got.count() == _source(tspark, TF, table).count()


def test_plan_with_a_lazy_checkpoint_is_uncacheable(tspark, table, dirs,
                                                    monkeypatch):
    """The serving plan cache keeps no plan over a lazy checkpoint (its
    files are an opaque leaf), as the reference's does; the answers stay
    right."""
    want = _query(TF, _source(tspark, TF, table)).collect()
    got = _query(TF, _source(tspark, TF, table).checkpoint(eager=False))
    pc = PlanCache(tspark.conf_obj)
    monkeypatch.setattr(tspark, "_plan_cache", pc)
    for _ in range(2):
        assert_rows_equal(want, got.collect(), rtol=RTOL, ordered=False)
    st = pc.stats()
    assert st["uncacheable"] == 2 and st["hits"] == 0
    # the one entry is the checkpoint's write of its child
    assert not any("LazyCheckpoint" in k for k in pc._entries)
