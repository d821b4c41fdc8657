"""The port's stage cache (``spark_tpu_torch/sql/stagecompile.py``) against
``spark_tpu/sql/stagecompile.py`` on the CPU.

On the CPU a dispatch runs the same record/replay protocol as on a card,
eagerly and without a capture: the first run of an entry records its host
decisions and host-built constants, later runs replay them and read the
guard flags back.  The claims under test, each against the reference:

* hash-agg (both grouped-aggregate forms), q3 and a string-keyed join give
  equal rows under all three lanes (``spark.sql.codegen.wholeStage=false``,
  ``spark.tpu.stage.fusion=false``, the default), integers bit for bit,
  floats within 0 (the same ``assert_rows_equal`` the slice tests use);
* ``count_ops`` and ``run_per_op``'s dispatch count are equal;
* the cache's counters after one query sequence are equal;
* a recorded decision that does not hold for new data fails its guard and
  re-runs to the reference's answer.
"""

import numpy as np
import pytest
import torch

from spark_tpu import types as RT
from spark_tpu.sql import functions as RF
from spark_tpu.sql import stagecompile as RSC
from spark_tpu.sql.planner import Planner as RPlanner
from spark_tpu.sql.planner import QueryExecution as RQE
from spark_tpu_torch import capture
from spark_tpu_torch import config as TC
from spark_tpu_torch import kernels as TK
from spark_tpu_torch import types as TT
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql import stagecompile as TSC
from spark_tpu_torch.sql.planner import QueryExecution as TQE
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import (assert_rows_equal, hash_agg_query,
                                     hash_agg_table, q3_query, q3_tables)

CODEGEN = "spark.sql.codegen.wholeStage"
FUSION = "spark.tpu.stage.fusion"
LANES = {"eager": {CODEGEN: "false"}, "per-op": {FUSION: "false"},
         "stage": {}}


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


class _conf:
    """Set conf keys on both sessions for a block, then unset them."""

    def __init__(self, sessions, values):
        self.sessions, self.values = sessions, values

    def __enter__(self):
        for s in self.sessions:
            for k, v in self.values.items():
                s.conf.set(k, v)

    def __exit__(self, *exc):
        for s in self.sessions:
            for k in self.values:
                s.conf.unset(k)


def _string_join(session, F):
    """A join on a string key whose two sides have different
    dictionaries, then a grouped count by the key."""
    left = session.createDataFrame({
        "name": ["apple", "kiwi", "pear", "apple", "fig", "kiwi", None],
        "x": np.arange(7, dtype=np.int64)})
    right = session.createDataFrame({
        "name2": ["kiwi", "apple", "plum", "kiwi"],
        "y": np.array([10, 20, 30, 40], np.int64)})
    return (left.join(right, left["name"] == right["name2"])
                .groupBy("name").agg(F.sum("y").alias("s"),
                                     F.count("*").alias("c"))
                .orderBy("name"))


QUERIES = {
    "hash-agg": lambda s, F, T: hash_agg_query(s, F, hash_agg_table(2048, 40)),
    "q3": lambda s, F, T: q3_query(
        s, F, T, q3_tables(n_sales=20000, n_items=300, n_dates=3000)),
    "string join": lambda s, F, T: _string_join(s, F),
}

CASES = [("hash-agg", True), ("hash-agg", False), ("q3", True),
         ("string join", False)]


@pytest.mark.parametrize("lane", list(LANES))
@pytest.mark.parametrize("query,mxu", CASES)
def test_lanes_match_reference(spark, tspark, monkeypatch, query, mxu, lane):
    """Each lane of each package, run twice (the second default-lane run
    of the port is a replay of the first one's record)."""
    monkeypatch.setattr(TK, "MXU_AGG_ENABLED", mxu)
    ordered = query != "hash-agg"
    with _conf([spark, tspark], LANES[lane]):
        ref = QUERIES[query](spark, RF, RT).collect()
        tdf = QUERIES[query](tspark, TF, TT)
        first, second = tdf.collect(), tdf.collect()
    assert len(ref) >= 2
    assert_rows_equal(ref, first, ordered=ordered)
    assert_rows_equal(ref, second, ordered=ordered)


def _planned_ref(spark, df):
    return RPlanner(spark).plan(RQE(spark, df._plan).optimized)


@pytest.mark.parametrize("query", list(QUERIES))
def test_count_ops_and_per_op_dispatches_match_reference(spark, tspark,
                                                         query):
    rpq = _planned_ref(spark, QUERIES[query](spark, RF, RT))
    tpq = TQE(tspark, QUERIES[query](tspark, TF, TT)._plan).planned
    assert TSC.count_ops(tpq.physical) == RSC.count_ops(rpq.physical)
    r = RSC.run_per_op(rpq.physical, rpq.leaves)
    t = TSC.run_per_op(tpq.physical, tpq.leaves, tspark.device)
    # (batch, rows, dispatches, flags, caps, kinds): all but the batch
    assert t[1:] == r[1:]
    assert t[2] == TSC.count_ops(tpq.physical) + 1


def _filter_table(session, n, seed=5):
    rng = np.random.default_rng(seed)
    session.createDataFrame({
        "k": rng.integers(0, 9, n).astype(np.int64),
        "v": rng.integers(0, 100, n).astype(np.int64),
    }).createOrReplaceTempView("scq")


STATS_KEYS = ("hits", "misses", "builds", "dispatches", "entries",
              "ops_per_stage")


def test_stage_cache_stats_match_reference(spark, tspark):
    """``v < 10`` then ``v < 20`` (one entry); the same text at another
    capacity; a SET of a planning entry and the text again (a new key);
    the text once more (a hit)."""
    caches = (RSC.stage_cache(), TSC.stage_cache())
    rows = {}
    for c in caches:
        c.clear()
    try:
        for name, s in (("ref", spark), ("port", tspark)):
            q = "SELECT k, v FROM scq WHERE v < {}"
            _filter_table(s, 200)
            out = [s.sql(q.format(10)).collect(), s.sql(q.format(20)).collect()]
            _filter_table(s, 600, seed=6)
            out.append(s.sql(q.format(10)).collect())
            s.sql("SET spark.sql.agg.outputCapacity=1024")
            out.append(s.sql(q.format(30)).collect())
            out.append(s.sql(q.format(30)).collect())
            rows[name] = out
        ref, got = caches[0].stats(), caches[1].stats()
        gauges = {k: read() for k, read in TSC.metrics_source().items()}
    finally:
        for s in (spark, tspark):
            s.conf.unset("spark.sql.agg.outputCapacity")
            s.catalog.dropTempView("scq")
        for c in caches:
            c.clear()
    for r, g in zip(rows["ref"], rows["port"]):
        assert_rows_equal(r, g)
    assert all(v < 20 for _k, v in rows["port"][1])
    assert [got[k] for k in STATS_KEYS] == [ref[k] for k in STATS_KEYS]
    assert (got["hits"], got["builds"], got["entries"]) == (2, 3, 3)
    assert (gauges["stage_cache_hits"], gauges["stage_cache_misses"],
            gauges["stage_dispatches"], gauges["stages_fused"]) == \
        (got["hits"], got["misses"], got["dispatches"], got["builds"])


def test_guard_miss_reruns_to_reference_slow_branch(spark, tspark,
                                                    monkeypatch):
    """Record hash-agg on keys whose range fits the bucket table (the
    grouped-accumulate form), then run the same shape on keys that do
    not: the guard of the recorded decision fails, the result is thrown
    away and the re-run takes the sorted form — the reference's
    ``lax.cond`` slow branch."""
    monkeypatch.setattr(TK, "MXU_AGG_ENABLED", True)
    rng = np.random.default_rng(3)
    narrow = {"k": rng.integers(0, 50, 4000).astype(np.int64),
              "v": rng.integers(0, 100, 4000).astype(np.int64)}
    wide = {"k": rng.integers(0, 10 ** 12, 4000).astype(np.int64),
            "v": rng.integers(0, 100, 4000).astype(np.int64)}
    cache = TSC.stage_cache()
    hash_agg_query(tspark, TF, narrow).collect()
    before = cache.stats()
    got = hash_agg_query(tspark, TF, wide).collect()
    after = cache.stats()
    ref = hash_agg_query(spark, RF, wide).collect()
    assert_rows_equal(ref, got, ordered=False)
    assert len(got) > 3000
    assert after["guard_misses"] == before["guard_misses"] + 1
    assert after["builds"] == before["builds"]         # the same entry
    assert after["variants"] == before["variants"] + 1
    # the new variant now serves this shape without a miss
    again = hash_agg_query(tspark, TF, wide).collect()
    assert_rows_equal(ref, again, ordered=False)
    assert cache.stats()["guard_misses"] == after["guard_misses"]


def test_slotted_literals_share_an_entry_with_new_values(tspark):
    _filter_table(tspark, 300)
    try:
        cache = TSC.stage_cache()
        q = "SELECT k, v FROM scq WHERE v * 2 < {} AND k != {}"
        tspark.sql(q.format(40, 3)).collect()
        before = cache.stats()
        got = tspark.sql(q.format(100, 5)).collect()
        after = cache.stats()
    finally:
        tspark.catalog.dropTempView("scq")
    assert after["builds"] == before["builds"]
    assert after["hits"] == before["hits"] + 1
    assert got and all(v * 2 < 100 and k != 5 for k, v in got)
    assert any(v * 2 >= 40 for _k, v in got)


def test_fingerprint_slots_literals_and_keeps_names(tspark):
    df = tspark.createDataFrame({"a": np.arange(4, dtype=np.int64),
                                 "b": np.arange(4, dtype=np.int64)})

    def fp(d):
        return TSC.stage_fingerprint(TQE(tspark, d._plan).planned.physical)

    k10, s10 = fp(df.filter(TF.col("a") < 10))
    k20, s20 = fp(df.filter(TF.col("a") < 20))
    kb, _ = fp(df.filter(TF.col("b") < 10))
    assert k10 == k20 and [l.value for l in s10 + s20] == [10, 20]
    assert kb != k10
    # a literal outside an arithmetic/comparison position stays in the key
    kin, sin = fp(df.filter(TF.col("a").isin(1, 2)))
    assert not sin and "values=L(1,2)" in kin


def test_row_udf_plan_runs_eager_lane(tspark):
    tspark.udf.register("plus_one_row", lambda x: x + 1, "bigint")
    df = tspark.createDataFrame({"x": np.arange(5, dtype=np.int64)})
    df.createOrReplaceTempView("udf_t")
    cache = TSC.stage_cache()
    try:
        before = cache.stats()["dispatches"]
        rows = tspark.sql("SELECT plus_one_row(x) AS y FROM udf_t").collect()
        row_lane = cache.stats()["dispatches"] - before
        tspark.sql("SELECT x + 1 AS y FROM udf_t").collect()
        fused = cache.stats()["dispatches"] - before - row_lane
    finally:
        tspark.catalog.dropTempView("udf_t")
    assert sorted(r[0] for r in rows) == [1, 2, 3, 4, 5]
    assert (row_lane, fused) == (0, 1)


def test_cache_entry_bound_is_lru(tspark):
    cache = TSC.stage_cache()
    cache.clear()
    with _conf([tspark], {"spark.tpu.stage.cacheMaxEntries": "2"}):
        df = tspark.createDataFrame({"a": np.arange(8, dtype=np.int64)})
        for e in (TF.col("a") + 1, TF.col("a") - 1, TF.col("a") * 3):
            df.select(e.alias("z")).collect()
        assert len(cache) == 2
    cache.clear()


def test_replay_serves_the_record_and_guards_decisions():
    rec = capture.StageRecord()
    pred = torch.tensor(True)
    with capture.stage_run(rec, replay=False) as run:
        assert capture.decide(pred) is True
        t = capture.constant(np.arange(3), "cpu")
        run.check_consumed()
    with capture.stage_run(rec, replay=True) as run:
        assert capture.decide(torch.tensor(False)) is True
        assert capture.constant(np.arange(3), "cpu") is t
        run.check_consumed()
    assert [bool(g) for g in run.guards] == [False]
    # outside a run: built, and decided by a sync
    assert capture.decide(torch.tensor(False)) is False
    with capture.stage_run(rec, replay=True):
        capture.decide(pred)
        with pytest.raises(capture.StageDivergence):
            capture.constant(np.arange(4), "cpu")
    with capture.stage_run(rec, replay=True) as run:
        with pytest.raises(capture.StageDivergence):
            run.check_consumed()


def _trap_host_syncs(monkeypatch):
    """Make every host read of a tensor and every tensor built from host
    values raise while a REPLAY run is active: on a card such a call
    inside a capture would sync with the device or copy from pageable
    memory, so the replay of a record must make none (the CPU rehearsal
    of the capture)."""
    def replaying():
        run = capture._active.run
        return run is not None and run.replay

    def trap(name, orig, allow=lambda *a, **k: False):
        def f(*args, **kwargs):
            if replaying() and not allow(*args, **kwargs):
                raise AssertionError(f"{name} inside a replay run")
            return orig(*args, **kwargs)
        return f

    for name in ("__bool__", "__int__", "__float__", "__index__", "item",
                 "tolist", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name,
                            trap(name, getattr(torch.Tensor, name)))
    for name in ("tensor", "from_numpy", "nonzero", "unique",
                 "masked_select"):
        monkeypatch.setattr(torch, name, trap(name, getattr(torch, name)))

    def by_value(_t, index, *value):
        # a bool-mask index (or a tuple holding one) sizes its result
        # from the data: nonzero, a sync on a card; a host value stored
        # into a tensor is a host-to-device copy on a card
        idx = index if isinstance(index, tuple) else (index,)
        return not any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                       for i in idx) \
            and all(isinstance(v, torch.Tensor) for v in value)

    for name in ("__getitem__", "__setitem__"):
        monkeypatch.setattr(torch.Tensor, name, trap(
            name, getattr(torch.Tensor, name), allow=by_value))
    monkeypatch.setattr(torch, "as_tensor", trap(
        "as_tensor", torch.as_tensor,
        allow=lambda data, *a, **k: isinstance(data, torch.Tensor)))


def _sql_cases():
    from spark_tpu_torch.testing import SQL_QUERIES
    return [name for name in SQL_QUERIES if name != "UDF row"]


@pytest.mark.parametrize("name", ["hash-agg", "hash-agg wide keys", "q3"]
                         + _sql_cases())
def test_replay_makes_no_host_sync_or_copy(tspark, monkeypatch, name):
    """The queries ``chip_smoke.py`` runs through the graph lane (hash-agg
    also on keys too wide for the bucket table, the sorted form; q3's
    brand ids take it too): the second run replays the first one's
    record and must touch no host value of a tensor and build no tensor
    from host values."""
    from spark_tpu_torch.testing import (SQL_QUERIES, register_sql_tables,
                                         register_sql_udfs)
    monkeypatch.setattr(TK, "MXU_AGG_ENABLED", True)
    tables = q3_tables(n_sales=5000, n_items=3000, n_dates=3000)
    hash_table = hash_agg_table(2048, 40)
    register_sql_tables(tspark, hash_table, tables, TT)
    register_sql_udfs(tspark, torch)
    if name == "hash-agg":
        df = hash_agg_query(tspark, TF, hash_table)
    elif name == "hash-agg wide keys":
        df = hash_agg_query(tspark, TF, {
            "k": hash_table["k"] * 10 ** 9, "v": hash_table["v"]})
    elif name == "q3":
        df = q3_query(tspark, TF, TT, tables)
    else:
        df = tspark.sql(SQL_QUERIES[name][0])
    want = df.collect()
    cache = TSC.stage_cache()
    before = cache.stats()
    _trap_host_syncs(monkeypatch)
    got = df.collect()
    monkeypatch.undo()
    after = cache.stats()
    assert_rows_equal(want, got)
    assert after["dispatches"] == before["dispatches"] + 1
    assert (after["variants"], after["guard_misses"]) == \
        (before["variants"], before["guard_misses"])
