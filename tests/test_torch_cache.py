"""Cached relations of the port (``spark_tpu_torch/memory.py``
``DeviceCacheManager``, ``codec.encode_column``, ``DataFrame.cache``)
against ``spark_tpu``'s on the CPU, on the same seeded inputs.

The block encodings pick the reference's scheme and payload for 1-D
arrays and round-trip bit for bit; queries over a cached subtree at each
storage level answer as the reference and as the uncached run do
(integers exactly, floats within rtol 1e-9); the same put / get /
demotion sequence leaves the same levels in both packages.  Then what
only the port has: one eviction rule for the stage cache's graphs and
the cached relations, the entry's uid kept through demotion and
promotion (no new graph), a plan-cache hit after a demotion, and pinned
host entries on a card session.
"""

import numpy as np
import pytest
import torch

from spark_tpu import codec as RCodec
from spark_tpu import config as RC
from spark_tpu import memory as RM
from spark_tpu import types as RT
from spark_tpu.columnar import ColumnBatch as RBatch
from spark_tpu.sql import functions as RF
from spark_tpu.sql.session import SparkSession as RSession
from spark_tpu_torch import codec as TCodec
from spark_tpu_torch import config as TC
from spark_tpu_torch import memory as TM
from spark_tpu_torch import types as TT
from spark_tpu_torch.columnar import ColumnBatch as TBatch
from spark_tpu_torch.serving.plancache import PlanCache
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql import logical as TL
from spark_tpu_torch.sql import multibatch as TMB
from spark_tpu_torch.sql import stagecompile as TSC
from spark_tpu_torch.sql.planner import QueryExecution as TQE
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import (assert_rows_equal, hash_agg_table,
                                     q3_tables)

RTOL = 1e-9
LEVELS = ["DEVICE", "HOST", "HOST_COMPRESSED"]


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


@pytest.fixture(scope="module")
def tables():
    return q3_tables(n_sales=3000, n_items=200, n_dates=2000, seed=5)


@pytest.fixture
def fresh_stage_cache(monkeypatch):
    """The process stage cache replaced by an empty one for one test."""
    cache = TSC.StageCache()
    monkeypatch.setattr(TSC, "_CACHE", cache)
    return cache


def _frames(session, T, tables):
    def frame(name, cols):
        schema = T.StructType([T.StructField(c, T.type_for_name(t))
                               for c, t in cols])
        return session.createDataFrame(
            {c: tables[name][c] for c, _t in cols}, schema=schema)
    ss = frame("store_sales", [("ss_sold_date_sk", "bigint"),
                               ("ss_item_sk", "bigint"),
                               ("ss_ext_sales_price", "double")])
    dd = frame("date_dim", [("d_date_sk", "bigint"), ("d_year", "int"),
                            ("d_moy", "int")])
    it = frame("item", [("i_item_sk", "bigint"), ("i_brand", "string"),
                        ("i_manufact_id", "int")])
    return ss, dd, it


def _subtree(F, ss, it):
    """The cached subtree: sales joined to item, a filter over both."""
    return (ss.join(it, ss["ss_item_sk"] == it["i_item_sk"])
              .filter(F.col("i_manufact_id") < 60))


def _queries(F, sub, dd):
    """Queries that contain the cached subtree: a filter, a join and an
    aggregate over it."""
    return {
        "filter": sub.filter(F.col("ss_ext_sales_price") > 10000.0)
                     .select("ss_item_sk", "i_brand", "ss_ext_sales_price"),
        "join": sub.join(dd, sub["ss_sold_date_sk"] == dd["d_date_sk"])
                   .groupBy("d_year").agg(F.count("*").alias("n"),
                                          F.sum("ss_item_sk").alias("s")),
        "aggregate": sub.groupBy("i_brand").agg(
            F.sum("ss_ext_sales_price").alias("rev"),
            F.max("ss_sold_date_sk").alias("last")),
    }


def _answers(F, sub, dd):
    return {k: q.collect() for k, q in _queries(F, sub, dd).items()}


# -- the block encodings ----------------------------------------------------

def _arrays():
    rng = np.random.default_rng(3)
    return {
        "int64": rng.integers(0, 1000, 4096).astype(np.int64),
        "int32 few values": rng.integers(0, 7, 4096).astype(np.int32),
        "bool": rng.random(4096) < 0.3,
        "float64": rng.random(4096),
        "float runs": np.repeat(rng.random(64), 64),
        "sorted": np.sort(rng.integers(0, 50, 4096)).astype(np.int64),
        "constant": np.full(4096, 42, np.int64),
        "high cardinality": rng.permutation(100_000).astype(np.int64),
        "empty": np.zeros(0, np.int64),
    }


@pytest.mark.parametrize("name", list(_arrays()))
def test_encode_column_matches_reference(name):
    arr = _arrays()[name]
    ref = RCodec.encode_column(arr)
    got = TCodec.encode_column(arr)
    assert got.scheme == ref.scheme and got.length == ref.length
    if ref.scheme in ("rle", "dict"):
        for g, r in zip(got.payload, ref.payload):
            assert g.dtype == r.dtype and np.array_equal(g, r)
    else:
        assert got.payload == ref.payload
    assert got.nbytes == ref.nbytes
    back = TCodec.decode_column(got)
    assert back.dtype == arr.dtype and back.tobytes() == arr.tobytes()


def test_negative_zero_reference_fault():
    """The reference finds runs by float comparison, so a ``-0.0`` after
    ``0.0`` joins its run and decodes as ``0.0``; the port compares bits
    and gives ``-0.0`` back (ROADMAP §3)."""
    arr = np.array([0.0] * 32 + [-0.0] * 32)
    ref = RCodec.decode_column(RCodec.encode_column(arr))
    got = TCodec.decode_column(TCodec.encode_column(arr))
    assert not np.signbit(ref).any()
    assert got.tobytes() == arr.tobytes()


def test_planes_and_nulls_round_trip():
    """An array column's plane goes to the byte codec and a NULL-bearing
    column keeps its mask: the batch comes back bit for bit."""
    rng = np.random.default_rng(4)
    plane = rng.integers(0, 5, (64, 4)).astype(np.int64)
    enc = TCodec.encode_column(plane)
    assert enc.scheme == "zlib" and enc.shape == (64, 4)
    assert np.array_equal(TCodec.decode_column(enc), plane)

    vals = [None if i % 7 == 0 else float(i % 5) for i in range(100)]
    batch = TBatch.from_arrays({
        "x": vals, "s": [None if i % 3 else f"w{i % 4}" for i in range(100)],
        "a": [[i % 3] * (i % 4) for i in range(100)]})
    back = TM._decompress_batch(TM._compress_batch(batch, "zlib"))
    for v, w in zip(batch.vectors, back.vectors):
        assert v.dtype == w.dtype and v.dictionary == w.dictionary
        assert torch.equal(v.data, w.data)
        assert (v.valid is None) == (w.valid is None)
        assert v.valid is None or torch.equal(v.valid, w.valid)
    assert torch.equal(batch.row_valid, back.row_valid)


# -- cached relations against the reference ----------------------------------

@pytest.fixture(scope="module")
def uncached(tspark, tables):
    ss, dd, it = _frames(tspark, TT, tables)
    return _answers(TF, _subtree(TF, ss, it), dd)


def _keys(session):
    return {e["key"] for e in session.cacheManager.entries()}


def _added(session, before):
    """The entries of ``session``'s cache manager whose keys are not in
    ``before``: what one test put.  The reference's ``spark`` fixture is
    shared by every test file of a worker, and other files leave entries
    there (``tests/test_dataframe.py`` ``test_cache``)."""
    return [e for e in session.cacheManager.entries()
            if e["key"] not in before]


@pytest.mark.parametrize("level", LEVELS)
def test_cached_subtree_answers_like_reference(spark, tspark, tables,
                                               uncached, level):
    _check_cached_subtree(spark, tspark, tables, uncached, level)


def _check_cached_subtree(spark, tspark, tables, uncached, level):
    rbefore, tbefore = _keys(spark), _keys(tspark)
    ref_frames = _frames(spark, RT, tables)
    rsub = _subtree(RF, ref_frames[0], ref_frames[2]).cache(level)
    ss, dd, it = _frames(tspark, TT, tables)
    tsub = _subtree(TF, ss, it).cache(level)
    try:
        assert [e["level"] for e in _added(tspark, tbefore)] == \
            [e["level"] for e in _added(spark, rbefore)] == [level]
        # the subtree is substituted in every query over it
        plan = TQE(tspark, _queries(TF, tsub, dd)["join"]._plan).analyzed
        assert "CachedRelation" in {type(n).__name__
                                    for n in _walk(plan)}
        ref = _answers(RF, rsub, ref_frames[1])
        got = _answers(TF, tsub, dd)
        for name in ref:
            ordered = False
            assert_rows_equal(ref[name], got[name], rtol=RTOL,
                              ordered=ordered)
            assert_rows_equal(uncached[name], got[name], rtol=RTOL,
                              ordered=ordered)
        assert_rows_equal(rsub.collect(), tsub.collect(), rtol=RTOL,
                          ordered=False)
    finally:
        rsub.unpersist()
        tsub.unpersist()


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


def _batches(n, seed):
    """The same batch in both packages (1-D columns: both packages
    charge itemsize x capacity per column, plus masks)."""
    t = hash_agg_table(n, 16, seed=seed)
    return RBatch.from_arrays(t), TBatch.from_arrays(t)


def test_entry_levels_follow_reference_under_budget(fresh_stage_cache):
    """The same put / get sequence under one small budget: each batch is
    X = 1,024 B in both packages, the budget 2.5 X, so the card holds two
    entries and a third demotes the least recently used."""
    x = 1024
    conf = {"spark.tpu.memory.hbmBudget": int(2.5 * x)}
    rmm = RM.MemoryManager(RC.Conf(conf))
    rcm = RM.DeviceCacheManager(rmm, RC.Conf(conf))
    tmm = TM.MemoryManager(TC.Conf(conf))
    tcm = TM.DeviceCacheManager(tmm, TC.Conf(conf))
    tmm.set_eviction_callback(lambda n: TM.evict_lru(tmm, n, (tcm,)))
    pairs = {k: _batches(64, seed) for seed, k in enumerate("abcdef")}
    assert RM.batch_nbytes(pairs["a"][0]) == TM.batch_nbytes(pairs["a"][1]) \
        == x
    big = _batches(4096, 9)

    def levels(cm):
        return {e["key"]: e["level"] for e in cm.entries()}

    steps = [("put", "a", "DEVICE"), ("put", "b", "DEVICE"),
             ("put", "c", "DEVICE"),      # demotes a
             ("get", "a", None),          # promotes a, demotes b
             ("get", "c", None),
             ("put", "d", "HOST"), ("put", "e", "HOST_COMPRESSED"),
             ("get", "b", None),          # promotes b, demotes a
             ("remove", "c", None),
             ("get", "a", None),          # room again: promoted
             ("put", "big", "DEVICE")]    # never fits: demoted on entry
    for op, key, level in steps:
        r, t = big if key == "big" else pairs.get(key, (None, None))
        if op == "put":
            rcm.put(key, r, level)
            tcm.put(key, t, level)
        elif op == "get":
            rb, tb = rcm.get(key), tcm.get(key)
            assert np.array_equal(np.asarray(rb.vectors[1].data),
                                  tb.vectors[1].data.numpy())
        else:
            assert rcm.remove(key) and tcm.remove(key)
        assert levels(tcm) == levels(rcm), (op, key)
        assert tmm.storage_used == rmm.storage_used, (op, key)
    assert levels(tcm)["big"] == "HOST"


def test_unpersist_and_stop_release_the_charge(spark, tables):
    session = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    ss, dd, it = _frames(session, TT, tables)
    sub = _subtree(TF, ss, it).cache()
    entry = session.cacheManager.entries()[0]
    assert session.memoryManager.storage_used == entry["nbytes"] > 0
    assert session.metricsSystem.snapshots()["cache"] == \
        {"entries": 1, "device_entries": 1}
    sub.unpersist()
    assert session.cacheManager.entries() == []
    assert session.memoryManager.storage_used == 0
    plan = TQE(session, _queries(TF, sub, dd)["filter"]._plan).analyzed
    assert "CachedRelation" not in {type(n).__name__ for n in _walk(plan)}
    sub.cache()
    uid = session.cacheManager.entries()[0]["uid"]
    sub.cache("HOST")                  # cached already: one entry, moved
    assert [(e["level"], e["uid"]) for e in
            session.cacheManager.entries()] == [("HOST", uid)]
    assert session.memoryManager.storage_used == 0
    session.stop()
    assert session.cacheManager.entries() == []
    assert session.memoryManager.storage_used == 0
    # the reference's stop() empties its cache the same way
    ref = RSession(RC.Conf())
    try:
        rss, _rdd, rit = _frames(ref, RT, tables)
        _subtree(RF, rss, rit).cache()
        assert len(ref.cacheManager.entries()) == 1
        ref.stop()
        assert ref.cacheManager.entries() == []
    finally:
        RSession._active = spark


def test_second_cache_reference_fault(spark, tspark, tables):
    """The reference keys a second ``cache()`` of a cached relation on
    the substituted plan, ``LocalRelation#uid``, and holds a second copy;
    the port keeps its one entry (ROADMAP §3)."""
    _check_second_cache(spark, tspark, tables)


def _check_second_cache(spark, tspark, tables):
    counts = []
    for session, F, T in ((spark, RF, RT), (tspark, TF, TT)):
        before = _keys(session)
        ss, _dd, it = _frames(session, T, tables)
        sub = _subtree(F, ss, it).cache()
        first = sub._cached
        sub.cache()
        counts.append(len(_added(session, before)))
        session.cacheManager.remove(first)
        sub.unpersist()
    assert counts == [2, 1]


def test_cache_on_cache_keyed_like_reference(spark, tspark, tables):
    """A cache over a cached subtree is keyed on the substituted plan:
    its key names the inner entry by uid, not the inner subtree."""
    _check_cache_on_cache(spark, tspark, tables)


def _check_cache_on_cache(spark, tspark, tables):
    keys = []
    for session, F, T in ((spark, RF, RT), (tspark, TF, TT)):
        before = _keys(session)
        ss, _dd, it = _frames(session, T, tables)
        inner = _subtree(F, ss, it).cache()
        outer = inner.select("ss_item_sk", "i_brand").cache()
        try:
            entries = _added(session, before)
            inner_key = [e["key"] for e in entries
                         if e["key"] != outer._cached][0]
            assert outer._cached.count("LocalRelation#") == 1
            assert "Join" not in outer._cached and "Join" in inner_key
            keys.append(outer._cached.split("[")[0])
            assert len(outer.collect()) == len(inner.collect())
        finally:
            outer.unpersist()
            inner.unpersist()
    assert keys == ["Project", "Project"]


def test_checks_hold_beside_a_leftover_reference_entry(spark, tspark,
                                                        tables, uncached):
    """Another file's ``cache()`` on the shared reference session (as
    ``tests/test_dataframe.py`` leaves one) changes none of the checks
    above: each reads only the entries it added."""
    left = spark.range(7).select((RF.col("id") * 3).alias("x")).cache()
    try:
        assert left._cached in _keys(spark)
        for level in LEVELS:
            _check_cached_subtree(spark, tspark, tables, uncached, level)
        _check_second_cache(spark, tspark, tables)
        _check_cache_on_cache(spark, tspark, tables)
        assert left._cached in _keys(spark)
    finally:
        left.unpersist()


# -- the port only -----------------------------------------------------------

def _graph(cache, memory, key, nbytes):
    """A stage-cache entry whose 'graph' holds ``nbytes``, charged to
    ``memory`` as a card's graph would be."""
    entry = cache.get_or_build(key, lambda: (None, None))
    v = TSC._Variant((), None, None)
    v.pool_bytes = nbytes
    entry.variants.append(v)
    cache._charge(entry, memory, nbytes)
    return entry


def test_one_eviction_path_for_graphs_and_relations(fresh_stage_cache):
    """The session's one eviction callback takes the least recently used
    storage first across both tenants: a cold graph before a hot
    relation, a cold relation before a hot graph, and both when a
    reservation needs both; neither tenant's eviction replaces the
    other's."""
    x = 1024
    session = TSession(TC.Conf({
        "spark.torch.device": "cpu",
        "spark.tpu.memory.hbmBudget": 4 * x,
        "spark.tpu.memory.storageFraction": 0.0}))
    try:
        mm, cm, sc = session.memoryManager, session.cacheManager, \
            fresh_stage_cache
        g1 = _graph(sc, mm, "g1", x)
        cm.put("r", _batches(64, 1)[1])            # X bytes, DEVICE
        g2 = _graph(sc, mm, "g2", x)
        assert mm.storage_used == 3 * x
        mm.acquire_execution("q1", 2 * x)          # needs one X: g1 goes
        assert sc.entries() == [g2] and cm.level("r") == "DEVICE"
        mm.release_execution("q1")
        cm.get("r")                                # r is now the newest
        g3 = _graph(sc, mm, "g3", x)
        mm.acquire_execution("q2", 2 * x)          # needs one X: g2 goes
        assert sc.entries() == [g3] and cm.level("r") == "DEVICE"
        mm.release_execution("q2")
        sc.get_or_build("g3", None)                # g3 newer than r
        mm.acquire_execution("q3", 3 * x)          # one X: r demotes
        assert sc.entries() == [g3] and cm.level("r") == "HOST_COMPRESSED"
        mm.release_execution("q3")
        assert cm.get("r") is not None and cm.level("r") == "DEVICE"
        mm.acquire_execution("q4", 4 * x)          # needs both
        assert sc.entries() == [] and cm.level("r") == "HOST_COMPRESSED"
        assert mm.storage_used == 0
    finally:
        session.stop()


def _demote_all(session):
    for e in list(session.cacheManager._entries.values()):
        session.cacheManager._demote(e)


def test_uid_kept_through_demote_and_promote(tspark, tables,
                                             fresh_stage_cache):
    """Demote → decompress → promote serves new batch objects with the
    entry's uid, so the warm query keeps its stage key: no new graph and
    no guard miss."""
    ss, dd, it = _frames(tspark, TT, tables)
    sub = _subtree(TF, ss, it).cache()
    try:
        q = _queries(TF, sub, dd)["aggregate"]
        want = q.collect()
        uid = tspark.cacheManager.entries()[0]["uid"]
        before = fresh_stage_cache.stats()
        _demote_all(tspark)
        assert tspark.cacheManager.entries()[0]["level"] == \
            "HOST_COMPRESSED"
        assert_rows_equal(want, q.collect())
        after = fresh_stage_cache.stats()
        assert tspark.cacheManager.entries()[0]["level"] == "DEVICE"
        assert after["builds"] == before["builds"]
        assert after["variants"] == before["variants"]
        assert after["guard_misses"] == before["guard_misses"] == 0
        batch = tspark.cacheManager.get(sub._cached)
        assert batch._cache_uid == uid
    finally:
        sub.unpersist()


def test_plan_cache_hit_after_demotion_reads_the_entry(tspark, tables,
                                                       fresh_stage_cache,
                                                       monkeypatch):
    """A plan over a cached relation is fingerprinted by the entry's uid;
    its plan-cache entry keeps no batch of the relation, and a hit after
    a demotion runs over the entry as it is now."""
    ss, dd, it = _frames(tspark, TT, tables)
    sub = _subtree(TF, ss, it).cache()
    pc = PlanCache(tspark.conf_obj)
    monkeypatch.setattr(tspark, "_plan_cache", pc)
    try:
        q = _queries(TF, sub, dd)["aggregate"]
        want = q.collect()
        assert_rows_equal(want, q.collect())
        assert pc.stats()["hits"] == 1
        (entry,) = pc._entries.values()
        assert [k for k, _n in entry.recipes] == ["cached"]
        assert entry.leaves == [None]
        _demote_all(tspark)
        seen = []
        dispatch = fresh_stage_cache.dispatch

        def spy(e, leaves, *a, **kw):
            seen.append(list(leaves))
            return dispatch(e, leaves, *a, **kw)
        monkeypatch.setattr(fresh_stage_cache, "dispatch", spy)
        assert_rows_equal(want, q.collect())
        assert pc.stats()["hits"] == 2
        now = tspark.cacheManager.get(sub._cached)
        assert [v.data.data_ptr() for v in seen[0][0].vectors] == \
            [v.data.data_ptr() for v in now.vectors]
    finally:
        sub.unpersist()


def test_host_entries_are_pinned_on_a_card_session(monkeypatch):
    """On a ``cuda`` session a HOST entry, an entry demoted on entry and a
    decompressed copy are pinned (the pin is stubbed: the CPU has none)."""
    pinned = []

    def pin(self):
        pinned.append(self)
        return self
    monkeypatch.setattr(TBatch, "pinned", pin)
    monkeypatch.setattr(TBatch, "is_pinned", lambda self: self in pinned)
    conf = TC.Conf({"spark.tpu.memory.hbmBudget": 100})
    mm = TM.MemoryManager(conf)
    cm = TM.DeviceCacheManager(mm, conf, "cuda")
    batch = _batches(64, 2)[1]
    cm.put("host", batch, "HOST")
    cm.put("full", batch, "DEVICE")             # 1,024 B > 100: HOST
    cm.put("blocks", batch, "HOST_COMPRESSED")
    assert cm.level("full") == "HOST"
    for key in ("host", "full", "blocks"):
        got = cm.get(key)
        assert got.is_pinned() and got.device.type == "cpu"
        assert torch.equal(got.vectors[1].data, batch.vectors[1].data)
    assert len(pinned) == 3


def test_cached_file_scan_does_not_stream(spark, tspark, tmp_path):
    """A plan over a cached file scan reads no file: the out-of-core
    routing passes it by, and the answer is the streamed run's."""
    table = hash_agg_table(2000, 16, seed=3)
    path = str(tmp_path / "t")
    tspark.createDataFrame(table).write.parquet(path)
    tspark.conf.set("spark.tpu.scan.maxBatchRows", "256")
    try:
        df = tspark.read.parquet(path).filter(TF.col("v") < 90)
        q = df.groupBy("k").agg(TF.sum("v").alias("s"))
        TMB.reset_stream_stats()
        streamed = q.collect()
        assert TMB.STREAM_STATS["batches"] > 0
        df.cache()
        TMB.reset_stream_stats()
        got = q.collect()
        assert TMB.STREAM_STATS["batches"] == 0
        assert_rows_equal(streamed, got, ordered=False)
        ref = (spark.read.parquet(path).filter(RF.col("v") < 90)
               .groupBy("k").agg(RF.sum("v").alias("s")).collect())
        assert_rows_equal(ref, got, ordered=False)
        df.unpersist()
    finally:
        tspark.conf.unset("spark.tpu.scan.maxBatchRows")


@pytest.mark.parametrize("level", ["DEVICE", "HOST_COMPRESSED"])
def test_mesh_lane_over_a_cached_relation(tspark, level):
    """Hash-agg over a cached table at 4 shards (the mesh lane's
    exchange) equals the one-device run over the same entry.  (A
    LocalRelation itself is never substituted: the cached relation is a
    projection of one.)"""
    df = tspark.createDataFrame(hash_agg_table(4096, 64, seed=12)) \
        .select("k", "v").cache(level)
    q = df.groupBy("k").agg(TF.sum("v").alias("s"), TF.count("*").alias("c"))
    assert any(isinstance(n, TL.CachedRelation)
               for n in _walk(TQE(tspark, q._plan).analyzed))
    try:
        want = q.collect()
        tspark.conf.set("spark.tpu.mesh.shards", "4")
        assert_rows_equal(want, q.collect(), ordered=False)
    finally:
        tspark.conf.unset("spark.tpu.mesh.shards")
        df.unpersist()
