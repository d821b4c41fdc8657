"""The port's serving plan cache (``spark_tpu_torch/serving/plancache.py``)
and the session hooks around it, on the CPU.

Each case that the reference's ``tests/test_serving.py`` has is also run
on the reference and held to its outcome: literal variants share one
entry, SET of a planning conf invalidates with oracle-exact results.
Then the port's own contracts: a replaced temp view's new data misses
(leaf identity by batch uid, never a recycled ``id()``), a variant whose
data overflow the cached capacities is poisoned, answered by the
adaptive replan loop and re-keyed to its plan, a build that raises is re-raised with no entry
kept, a mesh-lane repeat reports ``cacheHit`` through ``run_staged``,
and the cooperative cancellation checkpoints.
"""

import numpy as np
import pytest

from spark_tpu.serving import PlanCache as RPlanCache
from spark_tpu_torch import config as TC
from spark_tpu_torch import types as TT
from spark_tpu_torch.columnar import ColumnBatch
from spark_tpu_torch.memory import HBMOutOfMemoryError, MemoryManager
from spark_tpu_torch.serving import PlanCache
from spark_tpu_torch.serving.plancache import _ser_plan, fingerprint
from spark_tpu_torch.sql import logical as L
from spark_tpu_torch.sql.session import QueryCancelled
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.sql.stagecompile import stage_cache


@pytest.fixture()
def tsession():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


def _rows(df):
    return [tuple(r) for r in df.collect()]


def _attached(root, cls):
    cache = cls(root.conf_obj)
    s = root.newSession()
    s._plan_cache = cache
    return s, cache


def test_literal_variants_share_one_entry(spark, tsession):
    for root, cls in ((spark, RPlanCache), (tsession, PlanCache)):
        s, cache = _attached(root, cls)
        r1 = _rows(s.sql("SELECT id FROM range(30) WHERE id < 10"))
        r2 = _rows(s.sql("SELECT id FROM range(30) WHERE id < 20"))
        assert r1 == [(i,) for i in range(10)]
        assert r2 == [(i,) for i in range(20)]
        st = cache.stats()
        # the literal is slotted out of the fingerprint: ONE entry, and
        # the second variant is a hit run with a different parameter
        assert st["entries"] == 1, st
        assert st["hits"] == 1 and st["misses"] == 1, st


def _table(session):
    rng = np.random.default_rng(5)
    data = {"k": np.arange(50, dtype=np.int64),
            "v": (np.arange(50) * 3).astype(np.int64),
            "w": rng.integers(0, 9, 50).astype(np.int64)}
    session.createDataFrame(data).createOrReplaceTempView("pc_t")
    return data


Q_GROUPED = ("SELECT k % 5 AS g, sum(v) AS sv FROM pc_t WHERE v < 120 "
             "GROUP BY k % 5 ORDER BY g")


def _grouped_oracle(data, bound=120):
    sel = data["v"] < bound
    return [(g, int(data["v"][sel & (data["k"] % 5 == g)].sum()))
            for g in range(5)]


def test_set_invalidation_oracle_exact(spark, tsession):
    """Two sessions share the entry; SET of a planning conf in one evicts
    entries built under the old value and the next run stays equal to
    the oracle (the reference's case, over a temp view both sessions
    hold: the port's persistent tables come with the scan slice)."""
    outcomes = []
    for root, cls, key in (
            (spark, RPlanCache, "spark.tpu.crossproc.autoBroadcastThreshold"),
            (tsession, PlanCache, "spark.sql.autoBroadcastJoinThreshold")):
        s1, cache = _attached(root, cls)
        s2 = root.newSession()
        s2._plan_cache = cache
        data = _table(s1)
        s2.catalog.register("pc_t", s1.catalog.lookup("pc_t"))
        a1, a2 = _rows(s1.sql(Q_GROUPED)), _rows(s2.sql(Q_GROUPED))
        assert a1 == a2 == _grouped_oracle(data)
        assert cache.stats()["hits"] >= 1
        before = cache.stats()["invalidations"]
        s1.sql(f"SET {key}=12345")
        assert cache.stats()["invalidations"] > before
        assert _rows(s1.sql(Q_GROUPED)) == _grouped_oracle(data)
        outcomes.append((cache.stats()["hits"], cache.stats()["misses"]))
    assert outcomes[0] == outcomes[1]


def test_replaced_view_misses(tsession):
    """A temp view replaced by new data keys a new entry: the new batch
    has a new uid, even if the old one's ``id()`` were recycled."""
    s, cache = _attached(tsession, PlanCache)
    data = _table(s)
    assert _rows(s.sql(Q_GROUPED)) == _grouped_oracle(data)
    assert _rows(s.sql(Q_GROUPED)) == _grouped_oracle(data)
    assert cache.stats()["hits"] == 1
    old = s.catalog.lookup("pc_t")
    old_uid = L._batch_uid(old.batch)
    data2 = {"k": data["k"], "v": data["v"] + 1, "w": data["w"]}
    s.createDataFrame(data2).createOrReplaceTempView("pc_t")
    new = s.catalog.lookup("pc_t")
    assert L._batch_uid(new.batch) != old_uid
    assert _ser_plan(new, []) != _ser_plan(old, [])
    assert fingerprint(s, new).key != fingerprint(s, old).key
    assert _rows(s.sql(Q_GROUPED)) == _grouped_oracle(data2)
    st = cache.stats()
    assert (st["hits"], st["misses"], st["entries"]) == (1, 2, 2), st


def test_batch_uid_is_monotonic_and_slotted():
    a = ColumnBatch.from_arrays({"x": np.arange(3)})
    b = ColumnBatch.from_arrays({"x": np.arange(3)})
    ua, ub = L._batch_uid(a), L._batch_uid(b)
    assert ub > ua and L._batch_uid(a) == ua
    assert "_cache_uid" in ColumnBatch.__slots__
    key = _ser_plan(L.LocalRelation(a), [])
    assert key == f"Local#{ua}:{a.schema.simpleString()}"


def _fanout(session, n=64):
    """u(k = 0, v = 0..n-1): a self-join on k under ``v < X`` on both
    sides makes X*X rows from probe capacity n."""
    session.createDataFrame({
        "k": np.zeros(n, np.int64),
        "v": np.arange(n, dtype=np.int64)}).createOrReplaceTempView("fan")


Q_FANOUT = ("SELECT a.v AS av, b.v AS bv FROM fan a JOIN fan b "
            "ON a.k = b.k WHERE a.v < {x} AND b.v < {x} "
            "ORDER BY av, bv")


def test_overflow_poisons_and_replans(tsession):
    """The small variant builds the entry; the large one takes it,
    overflows the join's cached capacity, is poisoned and answered by
    the adaptive replan loop, whose plan then becomes the fingerprint's
    entry (``adopt``): the next runs of either variant hit it."""
    s, cache = _attached(tsession, PlanCache)
    _fanout(s)
    small = _rows(s.sql(Q_FANOUT.format(x=4)))
    assert small == [(i, j) for i in range(4) for j in range(4)]
    big = _rows(s.sql(Q_FANOUT.format(x=20)))
    assert big == [(i, j) for i in range(20) for j in range(20)]
    assert s._last_plan_cache_info["hit"] is False
    st = cache.stats()
    assert (st["hits"], st["misses"], st["entries"]) == (0, 2, 1), st
    assert not cache._poisoned
    assert _rows(s.sql(Q_FANOUT.format(x=20))) == big
    assert s._last_plan_cache_info["hit"] is True
    assert _rows(s.sql(Q_FANOUT.format(x=4))) == small
    assert cache.stats()["hits"] == 2


def test_build_that_raises_is_reraised(tsession):
    """A build that fails (here the memory pre-flight) raises to the
    caller, keeps no entry and leaves the fingerprint buildable."""
    s, cache = _attached(tsession, PlanCache)
    data = _table(s)
    saved = s._memory
    s._memory = MemoryManager(
        TC.Conf({"spark.tpu.memory.hbmBudget": 1024}), s.device)
    try:
        with pytest.raises(HBMOutOfMemoryError):
            s.sql(Q_GROUPED).collect()
    finally:
        s._memory = saved
    assert cache.stats()["entries"] == 0 and not cache._building
    assert _rows(s.sql(Q_GROUPED)) == _grouped_oracle(data)
    assert cache.stats()["entries"] == 1


def test_mesh_lane_repeat_is_a_hit(tsession):
    s, cache = _attached(tsession, PlanCache)
    data = _table(s)
    s.sql("SET spark.tpu.mesh.shards=4")
    first = _rows(s.sql(Q_GROUPED))
    assert s._last_plan_cache_info["hit"] is False
    again = _rows(s.sql(Q_GROUPED))
    assert s._last_plan_cache_info["hit"] is True
    assert first == again == _grouped_oracle(data)
    st = cache.stats()
    assert (st["stage_hits"], st["stage_misses"], st["stage_entries"]) \
        == (1, 1, 1)
    # SET of the planning conf evicts the statement entry too
    s.sql("SET spark.tpu.mesh.shards=2")
    assert cache.stats()["stage_entries"] == 0


def test_uncacheable_lanes_fall_through(tsession):
    """The eager and per-op lanes capture nothing: the statement runs,
    the cache keeps nothing."""
    s, cache = _attached(tsession, PlanCache)
    data = _table(s)
    for key in ("spark.sql.codegen.wholeStage", "spark.tpu.stage.fusion"):
        s.conf.set(key, "false")
        assert _rows(s.sql(Q_GROUPED)) == _grouped_oracle(data)
        s.conf.unset(key)
    assert cache.stats()["entries"] == 0


def test_fingerprint_keys_conf_device_and_slots(tsession):
    s = tsession.newSession()
    _table(s)
    a = s.sql("SELECT k FROM pc_t WHERE v < 10")
    b = s.sql("SELECT k FROM pc_t WHERE v < 99")
    from spark_tpu_torch.sql.planner import QueryExecution
    fa = fingerprint(s, QueryExecution(s, a._plan).optimized)
    fb = fingerprint(s, QueryExecution(s, b._plan).optimized)
    assert fa.key == fb.key and [l.value for l in fb.slots] == [99]
    assert "device=cpu" in fa.key
    s.conf.set("spark.sql.join.outputCapacityFactor", "3.0")
    fc = fingerprint(s, QueryExecution(s, a._plan).optimized)
    assert fc.key != fa.key


# ---------------------------------------------------------------------------
# cooperative cancellation
# ---------------------------------------------------------------------------

def test_cancel_before_planning(tsession):
    s = tsession.newSession()
    before = stage_cache().stats()["dispatches"]
    s.cancelAllQueries()
    with pytest.raises(QueryCancelled):
        s.sql("SELECT sum(id) AS x FROM range(10)").collect()
    assert stage_cache().stats()["dispatches"] == before
    s.clear_cancel()
    assert _rows(s.sql("SELECT sum(id) AS x FROM range(10)")) == [(45,)]


def test_cancel_between_eager_operators(tsession):
    """A row-lane UDF (the eager lane) cancels its own session while it
    runs; the next operator's checkpoint raises."""
    s = tsession.newSession()
    ran = []

    def cancelling(x):
        ran.append(x)
        s.cancelAllQueries()
        return x

    s.udf.register("cancelling", cancelling, TT.int64)
    with pytest.raises(QueryCancelled):
        s.sql("SELECT sum(y) AS t FROM (SELECT cancelling(id) AS y "
              "FROM range(3)) q").collect()
    assert ran
    s.clear_cancel()
    assert _rows(s.sql("SELECT 7 AS x")) == [(7,)]


def test_shared_literal_is_one_parameter(spark, tsession):
    """A CTE used twice shares its literal objects: they key as ONE
    parameter (a back-reference), so a text that spells the two places
    with two values takes its own entry and its own answer.  The
    reference keys both texts alike and binds its one literal object to
    the last value, so it answers the second text with 7 + 7 rows
    (ROADMAP §3)."""
    cte = ("WITH c AS (SELECT id FROM range(20) WHERE id < 5) "
           "SELECT id FROM c UNION ALL SELECT id FROM c")
    two = ("SELECT id FROM range(20) WHERE id < 5 UNION ALL "
           "SELECT id FROM range(20) WHERE id < 7")
    r, _rcache = _attached(spark, RPlanCache)
    assert len(r.sql(cte).collect()) == 10
    assert len(r.sql(two).collect()) == 14
    assert r._last_plan_cache_info["hit"] is True
    s, cache = _attached(tsession, PlanCache)
    assert sorted(_rows(s.sql(cte))) == sorted(
        [(i,) for i in range(5)] * 2)
    assert sorted(_rows(s.sql(two))) == sorted(
        [(i,) for i in range(5)] + [(i,) for i in range(7)])
    assert s._last_plan_cache_info["hit"] is False
    assert cache.stats()["entries"] == 2


def test_concurrent_sessions_share_entries(tsession):
    """Eight threads, each on its own session over the same views, run
    four statements (two literal variants) at once with a tiny switch
    interval: every answer equals the oracle, each fingerprint is built
    once (single flight) and no hit or miss is lost."""
    import sys
    import threading
    root = tsession.newSession()
    data = _table(root)
    cache = PlanCache(root.conf_obj)
    texts = {f"SELECT k % 5 AS g, sum(v) AS sv FROM pc_t WHERE v < {b} "
             f"GROUP BY k % 5 ORDER BY g": b for b in (30, 120)}
    texts["SELECT count(*) AS n FROM pc_t WHERE w < 4"] = None
    texts["SELECT k, v FROM pc_t WHERE v < 15 ORDER BY k"] = None
    n_threads, reps = 8, 3
    errors = []

    def work(i):
        s = root.newSession()
        s._plan_cache = cache
        s.catalog.register("pc_t", root.catalog.lookup("pc_t"))
        try:
            for _ in range(reps):
                for text, bound in texts.items():
                    rows = _rows(s.sql(text))
                    if bound is not None:
                        assert rows == _grouped_oracle(data, bound)
                    elif text.startswith("SELECT count"):
                        assert rows == [(int((data["w"] < 4).sum()),)]
                    else:
                        assert rows == [(int(k), int(v)) for k, v in
                                        zip(data["k"], data["v"]) if v < 15]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    st = cache.stats()
    assert st["entries"] == 3, st        # the two literal variants share
    assert st["misses"] == 3 and st["uncacheable"] == 0, st
    assert st["hits"] + st["misses"] == n_threads * reps * len(texts), st


# ---------------------------------------------------------------------------
# file leaves: catalog tables and files written through the API
# ---------------------------------------------------------------------------

Q_TABLE = ("SELECT k % 5 AS g, sum(v) AS sv FROM pcinv_t "
           "WHERE v < 120 GROUP BY k % 5 ORDER BY g")


def _warehouse_root(root, tmp_path, name):
    s = root.newSession()
    s.conf.set("spark.sql.warehouse.dir", str(tmp_path / name))
    return s


def test_insert_from_another_session_invalidates(spark, tsession, tmp_path):
    """The reference's case (``tests/test_serving.py``): two sessions
    share an entry over a catalog table (a parquet file leaf); the
    second's hit re-reads the file through the relation cache; an INSERT
    from the second session evicts the entry, and the next run sees the
    new rows, equal to a fresh session's; DROP TABLE makes the text
    fail.  Both packages, same outcomes."""
    outcomes = []
    for root, cls, name in ((spark, RPlanCache, "rwh"),
                            (tsession, PlanCache, "twh")):
        root = _warehouse_root(root, tmp_path, name)
        s1, cache = _attached(root, cls)
        s2 = root.newSession()
        s2._plan_cache = cache
        s1.sql("CREATE TABLE pcinv_t USING parquet AS "
               "SELECT id AS k, id * 3 AS v FROM range(50)")
        a1, a2 = _rows(s1.sql(Q_TABLE)), _rows(s2.sql(Q_TABLE))
        assert a1 == a2 and cache.stats()["hits"] == 1
        s2.sql("INSERT INTO pcinv_t SELECT id AS k, id AS v FROM range(5)")
        assert cache.stats()["invalidations"] >= 1
        a3 = _rows(s1.sql(Q_TABLE))
        assert a3 == _rows(root.newSession().sql(Q_TABLE)) and a3 != a1
        s1.sql("DROP TABLE pcinv_t")
        with pytest.raises(Exception):
            s1.sql(Q_TABLE).collect()
        outcomes.append((a1, a3))
    assert outcomes[0] == outcomes[1]


def test_dataframe_write_invalidates(spark, tsession, tmp_path):
    """A DataFrame-API overwrite of a path evicts the entries whose file
    leaves read it (the reference's regression case), in both
    packages."""
    q = "SELECT k % 4 AS g, sum(v) AS sv FROM pcw GROUP BY k % 4 ORDER BY g"
    outcomes = []
    for root, cls, name in ((spark, RPlanCache, "r.parquet"),
                            (tsession, PlanCache, "t.parquet")):
        s, cache = _attached(root, cls)
        path = str(tmp_path / name)
        s.sql("SELECT id AS k, id * 3 AS v FROM range(40)") \
            .write.parquet(path)
        s.read.parquet(path).createOrReplaceTempView("pcw")
        a1 = _rows(s.sql(q))
        assert _rows(s.sql(q)) == a1 and cache.stats()["hits"] == 1
        before = cache.stats()["invalidations"]
        s.sql("SELECT id AS k, id AS v FROM range(60)") \
            .write.mode("overwrite").parquet(path)
        assert cache.stats()["invalidations"] > before
        a2 = _rows(s.sql(q))
        assert a2 != a1
        outcomes.append((a1, a2))
    assert outcomes[0] == outcomes[1]


def test_file_leaf_hit_rereads_the_files(tsession, tmp_path):
    """A hit over a file leaf reads the files again through the relation
    cache: while they are unchanged it gets the same batch and the same
    stage entry; a file rewritten behind the catalog's back (no hook
    fires) is read anew on the next hit, which keys a new stage entry —
    the answer is never staler than the files."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from spark_tpu_torch import io as tio
    path = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"k": np.arange(30, dtype=np.int64),
                             "v": np.arange(30, dtype=np.int64)}), path)
    s, cache = _attached(tsession, PlanCache)
    q = f"SELECT k % 3 AS g, sum(v) AS sv FROM parquet.`{path}` " \
        "GROUP BY k % 3 ORDER BY g"
    stages = stage_cache()
    a1 = _rows(s.sql(q))
    builds = stages.stats()["builds"]
    hits0 = tio.SCAN_STATS["cache_hits"]
    assert _rows(s.sql(q)) == a1
    assert cache.stats()["hits"] == 1
    assert stages.stats()["builds"] == builds          # same stage entry
    assert tio.SCAN_STATS["cache_hits"] > hits0        # same batch
    pq.write_table(pa.table({"k": np.arange(31, dtype=np.int64),
                             "v": np.arange(31, dtype=np.int64) * 2}), path)
    a3 = _rows(s.sql(q))
    assert cache.stats()["hits"] == 2
    assert stages.stats()["builds"] == builds + 1      # a new stage key
    want = [(g, int(sum(2 * k for k in range(31) if k % 3 == g)))
            for g in range(3)]
    assert a3 == want
