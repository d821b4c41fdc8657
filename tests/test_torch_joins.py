"""The port's joins (``PJoin`` through the DataFrame API) against
``spark_tpu``: every join type, duplicate and NULL keys, int, float (NaN,
-0.0) and dictionary-string keys, the multi-key hash search, and a forced
output overflow that the adaptive retry grows.  Rows must match exactly,
in order.

The reference runs on its interpreted numpy lane here (each new plan
shape would cost its jax lane a compile); ``test_join_then_aggregate``
holds the port against the jax lane.
"""

import numpy as np
import pytest

from spark_tpu.sql import functions as RF
from spark_tpu_torch import config as TC
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import assert_rows_equal

HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti"]


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


@pytest.fixture
def ref_np(spark):
    """The conftest session on its interpreted numpy lane."""
    key = "spark.sql.codegen.wholeStage"
    spark.conf.set(key, "false")
    try:
        yield spark
    finally:
        spark.conf.unset(key)


def _tables(seed):
    rng = np.random.default_rng(seed)
    nl, nr = 120, 70
    words_l = ["ash", "birch", "cedar", "elm", "fir", None]
    words_r = ["birch", "elm", "fir", "oak", None]
    fl = np.array([0.0, -0.0, 1.5, 2.5, -3.0])
    left = {
        "lk": [None if rng.random() < 0.1 else int(x)
               for x in rng.integers(0, 15, nl)],
        "lv": rng.integers(-100, 100, nl).astype(np.int64),
        "ls": [words_l[i] for i in rng.integers(0, len(words_l), nl)],
        "lx": fl[rng.integers(0, len(fl), nl)],
        "lw": np.where(rng.random(nl) < 0.15, np.inf, 0.0),
    }
    right = {
        "rk": [None if rng.random() < 0.1 else int(x)
               for x in rng.integers(5, 20, nr)],
        "rv": rng.integers(-100, 100, nr).astype(np.int64),
        "rs": [words_r[i] for i in rng.integers(0, len(words_r), nr)],
        "rx": fl[rng.integers(0, len(fl), nr)],
        "rw": np.where(rng.random(nr) < 0.15, np.inf, 0.0),
    }
    return left, right


def _frames(session, F, seed):
    left, right = _tables(seed)
    L = session.createDataFrame(left)
    R = session.createDataFrame(right)
    # x + x*w: x itself where w = 0 (keeping -0.0), NaN where x = 0 and
    # w = inf, ±inf elsewhere — NaN keys cannot be ingested directly
    L = L.withColumn("lf", F.col("lx") + F.col("lx") * F.col("lw"))
    R = R.withColumn("rf", F.col("rx") + F.col("rx") * F.col("rw"))
    return L, R


def _cond(L, R, key):
    if key == "int":
        return L["lk"] == R["rk"]
    if key == "float":
        return L["lf"] == R["rf"]
    if key == "string":
        return L["ls"] == R["rs"]
    return (L["lk"] == R["rk"]) & (L["ls"] == R["rs"])   # multi-key hash


def _run(session, F, key, how, seed=0):
    L, R = _frames(session, F, seed)
    out = L.join(R, _cond(L, R, key), how)
    cols = ["lk", "lv", "ls", "lf"]
    if how not in ("left_semi", "left_anti"):
        cols += ["rk", "rv", "rs", "rf"]
    return out.select(*cols).collect()


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("key", ["int", "float", "string", "multi"])
def test_join_matches_reference(ref_np, tspark, key, how):
    ref = _run(ref_np, RF, key, how)
    got = _run(tspark, TF, key, how)
    assert_rows_equal(ref, got)


def test_join_then_aggregate(spark, tspark):
    def q(session, F):
        L, R = _frames(session, F, 3)
        return (L.join(R, L["lk"] == R["rk"], "left")
                 .groupBy("ls").agg(F.sum("rv").alias("s"),
                                    F.count("*").alias("n"))
                 .orderBy("ls").collect())
    assert_rows_equal(q(spark, RF), q(tspark, TF))


def _fanout_query(session, F):
    rng = np.random.default_rng(4)
    L = session.createDataFrame(
        {"a": rng.integers(0, 4, 200).astype(np.int64)})
    R = session.createDataFrame(
        {"b": rng.integers(0, 4, 40).astype(np.int64),
         "c": np.arange(40, dtype=np.int64)})
    return (L.join(R, L["a"] == R["b"]).groupBy("a")
             .agg(F.count("*").alias("n"), F.sum("c").alias("s"))
             .orderBy("a").collect())


def test_forced_output_overflow_grows_and_retries(ref_np, tspark):
    """A join factor far below the true fan-out overflows the static
    output capacity; the executor measures the overflow, grows the
    factor and replans until the result fits."""
    key = "spark.sql.join.outputCapacityFactor"
    q = _fanout_query
    ref_np.conf.set(key, "0.25")
    tspark.conf.set(key, "0.25")
    try:
        tspark._adapted_factors.clear()
        ref, got = q(ref_np, RF), q(tspark, TF)
    finally:
        ref_np.conf.unset(key)
        tspark.conf.unset(key)
    assert_rows_equal(ref, got)
    # the true fan-out is ~2000 rows over a 64-row buffer: it grew
    grown = [v["join"] for v in tspark._adapted_factors.values()]
    assert grown and any(f is not None and f > 0.25 for f in grown[0])


def test_grown_join_past_max_output_rows_fails_on_both(ref_np, tspark):
    """Growth past spark.sql.join.maxOutputRows stops with the fan-out
    error instead of allocating."""
    from spark_tpu.sql.planner import JoinFanoutError as RErr
    from spark_tpu_torch.sql.planner import JoinFanoutError as TErr
    conf = {"spark.sql.join.outputCapacityFactor": "0.25",
            "spark.sql.join.maxOutputRows": "128"}
    for s in (ref_np, tspark):
        for k, v in conf.items():
            s.conf.set(k, v)
    try:
        # factors learned by an earlier run of this plan already fit
        ref_np._adapted_factors.clear()
        tspark._adapted_factors.clear()
        with pytest.raises(RErr):
            _fanout_query(ref_np, RF)
        with pytest.raises(TErr):
            _fanout_query(tspark, TF)
    finally:
        for s in (ref_np, tspark):
            for k in conf:
                s.conf.unset(k)
