"""The port's device memory pre-flight (``spark_tpu_torch/memory.py``,
``planner._plan_reserve_bytes``) against ``spark_tpu``'s on the CPU: the
same plans reserve the same bytes, the same small budget refuses the same
query before anything is dispatched, and the stage cache's storage is
evicted least recently used first when an execution reservation needs
room.
"""

import numpy as np
import pytest

from spark_tpu import memory as RM
from spark_tpu import types as RT
from spark_tpu.sql import functions as RF
from spark_tpu.sql.planner import Planner as RPlanner
from spark_tpu.sql.planner import QueryExecution as RQE
from spark_tpu.sql.planner import _plan_reserve_bytes as r_reserve
from spark_tpu_torch import config as TC
from spark_tpu_torch import memory as TM
from spark_tpu_torch import types as TT
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql import stagecompile as TSC
from spark_tpu_torch.sql.planner import QueryExecution as TQE
from spark_tpu_torch.sql.planner import _plan_reserve_bytes as t_reserve
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import (assert_rows_equal, hash_agg_query,
                                     hash_agg_table, q3_query, q3_tables)


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


def _pair(session, seed):
    rng = np.random.default_rng(seed)
    a = session.createDataFrame({
        "k": rng.integers(0, 20, 300).astype(np.int64),
        "x": rng.integers(0, 1000, 300).astype(np.int64)})
    b = session.createDataFrame({
        "k2": rng.integers(0, 30, 90).astype(np.int64),
        "y": rng.random(90)})
    return a, b


def _full_outer(session, F, T):
    a, b = _pair(session, 1)
    return a.join(b, a["k"] == b["k2"], "full")


def _union(session, F, T):
    a, _b = _pair(session, 2)
    return a.union(a.filter(F.col("x") > 500)).union(a.select("k", "k"))


def _cross(session, F, T):
    a, b = _pair(session, 3)
    return a.filter(F.col("k") < 3).crossJoin(b.select("y"))


QUERIES = {
    "hash-agg": lambda s, F, T: hash_agg_query(s, F, hash_agg_table(3000, 50)),
    "q3": lambda s, F, T: q3_query(
        s, F, T, q3_tables(n_sales=20000, n_items=300, n_dates=3000)),
    "full outer join": _full_outer,
    "union": _union,
    "cross join": _cross,
}


@pytest.mark.parametrize("query", list(QUERIES))
def test_plan_reserve_bytes_matches_reference(spark, tspark, query):
    rdf = QUERIES[query](spark, RF, RT)
    tdf = QUERIES[query](tspark, TF, TT)
    rpq = RPlanner(spark).plan(RQE(spark, rdf._plan).optimized)
    tpq = TQE(tspark, tdf._plan).planned
    assert t_reserve(tpq) == r_reserve(rpq) > 0
    assert [TM.batch_nbytes(b) for b in tpq.leaves] \
        == [RM.batch_nbytes(b) for b in rpq.leaves]


class _budget:
    """Give both sessions a memory manager of ``nbytes`` for a block."""

    def __init__(self, spark, tspark, nbytes):
        self.spark, self.tspark, self.nbytes = spark, tspark, nbytes

    def __enter__(self):
        key = "spark.tpu.memory.hbmBudget"
        self.saved = (self.spark._memory, self.tspark._memory)
        self.spark._memory = RM.MemoryManager(
            self.spark.conf_obj.clone().set(key, self.nbytes))
        self.tspark._memory = TM.MemoryManager(
            TC.Conf({key: self.nbytes}), self.tspark.device)

    def __exit__(self, *exc):
        self.spark._memory, self.tspark._memory = self.saved


def test_small_budget_raises_before_dispatch_in_both(spark, tspark):
    """With the same budget both packages run the small query and refuse
    the cross join, before dispatching it."""
    small = QUERIES["full outer join"]
    big = QUERIES["cross join"]
    tpq = TQE(tspark, big(tspark, TF, TT)._plan).planned
    budget = (t_reserve(tpq) + t_reserve(
        TQE(tspark, small(tspark, TF, TT)._plan).planned)) // 2
    cache = TSC.stage_cache()
    with _budget(spark, tspark, budget):
        assert_rows_equal(small(spark, RF, RT).collect(),
                          small(tspark, TF, TT).collect(), ordered=False)
        with pytest.raises(RM.HBMOutOfMemoryError):
            big(spark, RF, RT).collect()
        before = cache.stats()["dispatches"]
        with pytest.raises(TM.HBMOutOfMemoryError, match="query:"):
            big(tspark, TF, TT).collect()
        assert cache.stats()["dispatches"] == before
        assert tspark._memory.execution_used == 0


def test_execution_reservation_and_oom():
    mm = TM.MemoryManager(TC.Conf({"spark.tpu.memory.hbmBudget": 1000}))
    mm.acquire_execution("q1", 600)
    with pytest.raises(TM.HBMOutOfMemoryError, match="q2: need 500 B"):
        mm.acquire_execution("q2", 500)
    mm.release_execution("q1")
    mm.acquire_execution("q2", 500)
    assert mm.execution_held("q2") == 500 and mm.free == 500


def test_device_budget_defaults():
    assert TM.MemoryManager(TC.Conf(), "cpu").budget == 16 << 30
    mm = TM.MemoryManager(TC.Conf({"spark.tpu.memory.hbmBudget": 4096,
                                   "spark.tpu.memory.storageFraction": 0.25}))
    assert (mm.budget, mm.storage_floor) == (4096, 1024)


def _entry(cache, key, nbytes):
    entry = cache.get_or_build(key, lambda: (None, None))
    v = TSC._Variant((), None, None)
    v.pool_bytes = nbytes
    entry.variants.append(v)
    return entry


def test_graph_storage_evicted_lru_for_an_execution_reservation():
    """Entries charged as storage (a card's graph pools) are dropped
    least recently used first when a query's reservation needs room, down
    to the protected floor; an entry a query is running is never
    dropped."""
    cache = TSC.StageCache()
    mm = TM.MemoryManager(TC.Conf({"spark.tpu.memory.hbmBudget": 1000,
                                   "spark.tpu.memory.storageFraction": 0.1}))
    mm.set_eviction_callback(lambda n: cache.evict(mm, n))
    entries = [_entry(cache, f"k{i}", 200) for i in range(4)]
    for e in entries:
        cache._charge(e, mm, e.nbytes)
    assert mm.storage_used == 800 and len(cache) == 4
    cache.get_or_build("k0", None)             # k0 is now the newest
    entries[1].in_use = 1                      # a query runs k1
    mm.acquire_execution("q", 500)             # needs 300 B of storage
    assert mm.storage_held("stage:k1") == 200
    assert [e.key for e in cache.entries()] == ["k1", "k0"]
    assert mm.storage_used == 400 and mm.free == 100
    cache.clear()
    assert mm.storage_used == 0


def test_entry_that_cannot_be_held_is_dropped():
    cache = TSC.StageCache()
    mm = TM.MemoryManager(TC.Conf({"spark.tpu.memory.hbmBudget": 100}))
    e = _entry(cache, "big", 500)
    cache._charge(e, mm, e.nbytes)
    assert len(cache) == 0 and mm.storage_used == 0
