"""The port's stage DAG (``spark_tpu_torch/sql/stages.py``) against the
reference's (``spark_tpu/sql/stages.py``): the counterparts of
``tests/test_stages.py`` and of the stage-runner case of
``tests/test_multibatch_hard_aggs.py``.

The same parquet files, written from numpy data made from a seed, are
read at ``spark.tpu.scan.maxBatchRows`` = 256 by the reference (the
conftest ``spark`` session) and by the port (``spark.torch.device`` =
``cpu``): broadcast joins fused into the per-batch step, grace hash
joins of two oversized sides (every join type, skewed buckets, the
chunked paths), streamed unions, breakers over joined streams, the mesh
lane at 2 shards, the DataFrame API, ``spark.sql`` and the SQL server's
plan cache.  Keys, integers, order, NULLs and words compare exactly,
float sums within ``rtol=1e-12``.
"""

import logging
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu.sql import functions as RF
from spark_tpu_torch import config as TC
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql import multibatch as TMB
from spark_tpu_torch.sql.planner import (JoinFanoutError, QueryExecution,
                                         check_factor_cap)
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.sql.stages import StageExecution, plan_stages
from spark_tpu_torch.testing import assert_rows_equal

BATCH = 256          # rows per streamed batch (tiny for tests)
NFACT = 1100         # > 4 batches


def _write(dirpath, cols, parts=4):
    os.makedirs(dirpath)
    n = len(next(iter(cols.values())))
    step = -(-n // parts)
    for i in range(parts):
        sl = slice(i * step, (i + 1) * step)
        pq.write_table(pa.table({k: v[sl] for k, v in cols.items()}),
                       os.path.join(dirpath, f"part-{i:03d}.parquet"))
    return str(dirpath)


def _fact(seed=11, n=NFACT):
    rng = np.random.default_rng(seed)
    return {"sk": np.arange(n, dtype=np.int64),
            "item_k": rng.integers(0, 40, n).astype(np.int64),
            "date_k": rng.integers(0, 30, n).astype(np.int64),
            "qty": rng.integers(1, 9, n).astype(np.int64),
            "price": rng.normal(25.0, 9.0, n)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("tst")
    rng = np.random.default_rng(5)
    item = {"item_k": np.arange(40, dtype=np.int64),
            "brand": np.asarray([f"brand#{i % 7}" for i in range(40)],
                                object),
            "cat": np.asarray(rng.choice(["sports", "music", "home"], 40),
                              object)}
    date = {"date_k": np.arange(30, dtype=np.int64),
            "moy": (np.arange(30, dtype=np.int64) % 12) + 1,
            "year": 2000 + (np.arange(30, dtype=np.int64) // 12)}
    rets = {"ret_sk": np.random.default_rng(3).permutation(
                _fact(seed=23, n=900)["sk"]),
            "ret_qty": np.random.default_rng(9).integers(1, 5, 900)
            .astype(np.int64)}
    return {"fact": _write(base / "fact.parquet", _fact()),
            "item": _write(base / "item.parquet", item, parts=1),
            "date": _write(base / "date.parquet", date, parts=1),
            "rets": _write(base / "rets.parquet", rets, parts=2)}


@pytest.fixture(scope="module")
def tspark(tmp_path_factory):
    s = TSession(TC.Conf({
        "spark.torch.device": "cpu",
        "spark.sql.warehouse.dir": str(tmp_path_factory.mktemp("wh"))}))
    yield s
    s.stop()


class _conf:
    """Set conf keys on both sessions for a block, then restore them."""

    def __init__(self, spark, tspark, **kv):
        self.sessions = (spark, tspark)
        kv.setdefault("spark.tpu.scan.maxBatchRows", BATCH)
        kv.setdefault("spark.tpu.collect.maxArrayLen", 1024)
        self.kv = {k: str(v) for k, v in kv.items()}

    def __enter__(self):
        self.old = [{k: s.conf.get(k, None) for k in self.kv}
                    for s in self.sessions]
        for s in self.sessions:
            for k, v in self.kv.items():
                s.conf.set(k, v)

    def __exit__(self, *exc):
        for s, old in zip(self.sessions, self.old):
            for k, v in old.items():
                if v is None:
                    s.conf.unset(k)
                else:
                    s.conf.set(k, v)


def _parity(spark, tspark, q, ordered=True, rtol=1e-12, conf=None,
            stages=True, post=None):
    """``q(session, F, read)`` through both packages; the port's run
    must take the stage DAG."""
    post = post or (lambda rows: rows)
    with _conf(spark, tspark, **(conf or {})):
        tdf = q(tspark, TF)
        if stages:
            qe = QueryExecution(tspark, tdf._plan)
            assert isinstance(plan_stages(tspark, qe.optimized),
                              StageExecution)
        TMB.reset_stream_stats()
        got = post(tdf.collect())
        ref = post(q(spark, RF).collect())
    assert_rows_equal(ref, got, rtol=rtol, ordered=ordered)
    return got


def _sort_key(r):
    return tuple((x is None, x if x is not None else 0) for x in r)


def test_q3_shape_star_join(spark, tspark, data):
    """fact ⋈ item ⋈ date, filter, group, order/limit: the q3 pattern
    through broadcast joins fused into the step."""
    def q(s, F):
        fact = s.read.parquet(data["fact"])
        return (fact.join(s.read.parquet(data["item"]), on="item_k")
                .join(s.read.parquet(data["date"]), on="date_k")
                .filter(F.col("moy") == 11)
                .groupBy("brand", "year")
                .agg(F.sum(F.col("price") * F.col("qty")).alias("rev"))
                .orderBy(F.col("rev").desc()).limit(10))
    _parity(spark, tspark, q)
    assert TMB.STREAM_STATS["grace_joins"] == 0
    assert TMB.STREAM_STATS["batches"] >= NFACT // BATCH


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
def test_grace_join_big_big(spark, tspark, data, how):
    """Both sides exceed a batch: the grace hash join, every join type."""
    def q(s, F):
        fact = s.read.parquet(data["fact"])
        rets = s.read.parquet(data["rets"])
        return fact.join(rets, on=F.col("sk") == F.col("ret_sk"), how=how)
    got = _parity(spark, tspark, q, ordered=False,
                  post=lambda rows: sorted(map(tuple, rows), key=_sort_key))
    assert TMB.STREAM_STATS["grace_joins"] == 1
    assert len(got) > 0


def test_grace_join_then_agg(spark, tspark, data):
    """big ⋈ big ⋈ small dim, then an aggregate (the q17 shape)."""
    def q(s, F):
        fact = s.read.parquet(data["fact"])
        rets = s.read.parquet(data["rets"])
        return (fact.join(rets, on=F.col("sk") == F.col("ret_sk"))
                .join(s.read.parquet(data["item"]), on="item_k")
                .groupBy("cat")
                .agg(F.sum("ret_qty").alias("rq"), F.count("sk").alias("n"),
                     F.avg("price").alias("ap")).orderBy("cat"))
    _parity(spark, tspark, q)


def test_grace_skewed_single_key(spark, tspark, tmp_path):
    """Every row shares ONE join key on both sides: salting cannot split
    the bucket, so the hot-bucket path (the host sort-merge emit) runs."""
    lp = _write(tmp_path / "skl.parquet", {
        "k": np.zeros(600, np.int64), "a": np.arange(600, dtype=np.int64)})
    rp = _write(tmp_path / "skr.parquet", {
        "k2": np.zeros(300, np.int64), "b": np.arange(300, dtype=np.int64)})

    def q(s, F):
        return (s.read.parquet(lp)
                .join(s.read.parquet(rp), on=F.col("k") == F.col("k2"))
                .agg(F.count("a").alias("n"), F.sum("b").alias("sb")))
    got = _parity(spark, tspark, q)
    assert tuple(got[0]) == (600 * 300, 600 * int(np.arange(300).sum()))


def test_grace_skewed_bucket_salts(spark, tspark, tmp_path):
    """A bucket above a batch whose keys differ re-partitions with a
    salted hash (no single key holds more than a batch)."""
    rng = np.random.default_rng(4)
    keys = np.concatenate([np.repeat(np.arange(8, dtype=np.int64), 150),
                           rng.integers(100, 10_000, 300)])
    lp = _write(tmp_path / "sal.parquet", {
        "k": keys, "a": np.arange(len(keys), dtype=np.int64)})
    rp = _write(tmp_path / "sar.parquet", {
        "k2": np.concatenate([np.arange(8, dtype=np.int64),
                              rng.integers(100, 10_000, 600)]),
        "b": np.arange(608, dtype=np.int64)})

    def q(s, F):
        return (s.read.parquet(lp)
                .join(s.read.parquet(rp), on=F.col("k") == F.col("k2"))
                .groupBy("k").agg(F.count("a").alias("n"),
                                  F.sum("b").alias("sb")).orderBy("k"))
    _parity(spark, tspark, q, conf={"spark.tpu.join.graceMaxBuckets": 2})


def test_grace_chunked_probe_build(spark, tspark, tmp_path):
    """A hot bucket of two join keys (the sort-merge emit covers one key
    only): the chunked probe/build loop of single-batch joins, with the
    probe rows' matches tracked on the host — inner and left."""
    lp = _write(tmp_path / "chl.parquet", {
        "k": np.repeat(np.array([0, 1], np.int64), 300),
        "j": np.zeros(600, np.int64),
        "a": np.arange(600, dtype=np.int64)})
    rp = _write(tmp_path / "chr.parquet", {
        "k2": np.concatenate([np.zeros(300, np.int64),
                              np.full(10, 7, np.int64)]),
        "j2": np.zeros(310, np.int64),
        "b": np.arange(310, dtype=np.int64)})
    for how in ("inner", "left", "left_anti"):
        def q(s, F, how=how):
            df = s.read.parquet(lp).join(
                s.read.parquet(rp),
                on=(F.col("k") == F.col("k2")) & (F.col("j") == F.col("j2")),
                how=how)
            return df.groupBy("k").agg(F.count("a").alias("n"),
                                       F.sum("a").alias("sa")).orderBy("k")
        _parity(spark, tspark, q)


def test_grace_string_keys(spark, tspark, tmp_path):
    """String join keys across per-batch dictionaries."""
    rng = np.random.default_rng(2)
    lp = _write(tmp_path / "stl.parquet", {
        "w": np.asarray(rng.choice([f"word{i:03d}" for i in range(80)], 700),
                        object),
        "a": np.arange(700, dtype=np.int64)})
    rp = _write(tmp_path / "str.parquet", {
        "w2": np.asarray([f"word{i:03d}" for i in range(0, 120, 2)] * 12,
                         object),
        "b": np.tile(np.arange(60, dtype=np.int64), 12)}, parts=3)

    def q(s, F):
        return (s.read.parquet(lp)
                .join(s.read.parquet(rp), on=F.col("w") == F.col("w2"))
                .select("w", "b"))
    _parity(spark, tspark, q, ordered=False)


def test_stream_above_breaker_filter(spark, tspark, data):
    """A HAVING-style filter above the aggregate of a joined stream."""
    def q(s, F):
        return (s.read.parquet(data["fact"])
                .join(s.read.parquet(data["item"]), on="item_k")
                .groupBy("brand").agg(F.sum("qty").alias("q"))
                .filter(F.col("q") > 100).orderBy("brand"))
    _parity(spark, tspark, q)


def test_nonmergeable_agg_over_stream(spark, tspark, data):
    """collect/percentile over a joined stream: the grace aggregate."""
    def q(s, F):
        return (s.read.parquet(data["fact"])
                .join(s.read.parquet(data["item"]), on="item_k")
                .filter(F.col("qty") >= 3).groupBy("item_k")
                .agg(F.collect_list("qty").alias("qs"),
                     F.percentile_approx("price", 0.5).alias("mp"))
                .orderBy("item_k"))
    _parity(spark, tspark, q, post=lambda rows: [
        (r[0], sorted(r[1]), r[2]) for r in rows])


def test_stage_runner_first_and_collect(spark, tspark, data):
    """first() and collect_set over a joined stream (the hard aggs'
    stage-runner case): first in scan order."""
    def q(s, F):
        return (s.read.parquet(data["fact"])
                .join(s.read.parquet(data["item"]), on="item_k")
                .groupBy("cat").agg(F.first("sk").alias("f"),
                                    F.collect_set("qty").alias("v"))
                .orderBy("cat"))
    _parity(spark, tspark, q, post=lambda rows: [
        (r[0], r[1], sorted(r[2])) for r in rows])


def test_streamed_union_of_big_facts(spark, tspark, data, tmp_path):
    other = _write(tmp_path / "fact2.parquet", _fact(seed=101, n=900),
                   parts=3)

    def q(s, F):
        return (s.read.parquet(data["fact"]).union(s.read.parquet(other))
                .groupBy("item_k")
                .agg(F.count("sk").alias("n"), F.sum("qty").alias("q"))
                .orderBy("item_k"))
    _parity(spark, tspark, q)


def test_streamed_union_with_strings_and_join(spark, tspark, tmp_path):
    rng = np.random.default_rng(31)
    p1 = _write(tmp_path / "u1.parquet", {
        "w": np.asarray(rng.choice(["ash", "oak", "elm"], 700), object),
        "v": rng.integers(0, 9, 700).astype(np.int64)}, parts=3)
    p2 = _write(tmp_path / "u2.parquet", {
        "w": np.asarray(rng.choice(["elm", "fir", "yew"], 600), object),
        "v": rng.integers(0, 9, 600).astype(np.int64)}, parts=3)
    dim = {"w": ["ash", "oak", "elm", "fir", "yew"],
           "score": [1, 2, 3, 4, 5]}

    def q(s, F):
        return (s.read.parquet(p1).union(s.read.parquet(p2))
                .join(s.createDataFrame(dim), on="w")
                .groupBy("w").agg(F.sum("v").alias("sv"),
                                  F.max("score").alias("sc"))
                .orderBy("w"))
    _parity(spark, tspark, q)


def test_streamed_union_unknown_words_falls_back(spark, tspark, tmp_path,
                                                 caplog):
    """A union branch that COMPUTES words outside the scan dictionaries
    falls back to the eager path, loudly, and stays right."""
    rng = np.random.default_rng(41)
    p1 = _write(tmp_path / "uf1.parquet", {
        "w": np.asarray(rng.choice(["ash", "oak"], 700), object),
        "v": rng.integers(0, 9, 700).astype(np.int64)}, parts=3)

    def q(s, F):
        a = s.read.parquet(p1)
        b = s.read.parquet(p1).select(F.upper("w").alias("w"), "v")
        return a.union(b).groupBy("w").agg(F.sum("v").alias("s")) \
            .orderBy("w")
    with caplog.at_level(logging.WARNING, logger="spark_tpu_torch.execution"):
        _parity(spark, tspark, q)
    assert any("fallback" in m for m in caplog.messages)


def test_fanout_intermediate_join_reroutes_to_grace(spark, tspark, tmp_path,
                                                    caplog):
    """A join of two MATERIALIZED intermediates whose hot-key fanout
    exceeds ``spark.sql.join.maxOutputRows`` eagerly re-routes through the
    grace spill path (the q14/q23 shape)."""
    nkeys, dup_l, dup_r = 16, 200, 8
    lp = _write(tmp_path / "fan_l.parquet", {
        "k": np.repeat(np.arange(nkeys, dtype=np.int64), dup_l),
        "v": np.tile(np.arange(dup_l, dtype=np.int64), nkeys)})
    rp = _write(tmp_path / "fan_r.parquet", {
        "k": np.repeat(np.arange(nkeys, dtype=np.int64), dup_r),
        "w": np.tile(np.arange(dup_r, dtype=np.int64), nkeys)}, parts=1)

    def q(s, F):
        return (s.read.parquet(lp).distinct()
                .join(s.read.parquet(rp).distinct(), on="k")
                .select("k", "v", "w"))
    with caplog.at_level(logging.WARNING, logger="spark_tpu_torch.stages"):
        got = _parity(spark, tspark, q, ordered=False,
                      conf={"spark.sql.join.maxOutputRows": 10000})
    assert len(got) == nkeys * dup_l * dup_r
    assert any("grace spill path" in m for m in caplog.messages)


def test_factor_cap_guard_is_typed(tspark):
    """``check_factor_cap`` raises the TYPED ``JoinFanoutError`` that the
    stage DAG's ``_Builder`` catches, with its guidance."""
    s = tspark.newSession()
    s.conf.set("spark.sql.join.maxOutputRows", "10000")
    check_factor_cap(4.0, 2000, s)                  # 8k rows: fine
    with pytest.raises(JoinFanoutError, match="maxOutputRows"):
        check_factor_cap(8.0, 2000, s)              # 16k > cap


def test_grace_bucket_fanout_chunks_instead_of_dying(spark, tspark, tmp_path,
                                                     caplog):
    """A bucket pair that fits a batch but whose join OUTPUT fans out past
    ``spark.sql.join.maxOutputRows`` is chunked, and stays exact."""
    nkeys, dup = 64, 20
    lp = _write(tmp_path / "bf_l.parquet", {
        "k": np.repeat(np.arange(nkeys, dtype=np.int64), dup),
        "v": np.tile(np.arange(dup, dtype=np.int64), nkeys)})
    rp = _write(tmp_path / "bf_r.parquet", {
        "k": np.repeat(np.arange(nkeys, dtype=np.int64), dup),
        "w": np.tile(np.arange(dup, dtype=np.int64) * 7, nkeys)})

    def q(s, F):
        return s.read.parquet(lp).join(s.read.parquet(rp), on="k") \
            .select("k", "v", "w")
    with caplog.at_level(logging.WARNING, logger="spark_tpu_torch.stages"):
        got = _parity(spark, tspark, q, ordered=False,
                      conf={"spark.sql.join.maxOutputRows": 4000})
    assert len(got) == nkeys * dup * dup
    assert any("chunking the bucket pair" in m for m in caplog.messages)


def test_empty_streamed_union_global_agg(spark, tspark, tmp_path):
    """A global aggregate over a streamed UNION whose branches all filter
    empty still gives its one row; keyed and sorted breakers stay
    empty."""
    t = {"k": np.arange(1100, dtype=np.int64),
         "v": np.ones(1100, np.int64)}
    pa_ = _write(tmp_path / "ea.parquet", t)
    pb_ = _write(tmp_path / "eb.parquet", t)

    def u(s, F):
        return s.read.parquet(pa_).filter(F.col("k") < 0).union(
            s.read.parquet(pb_).filter(F.col("k") < 0))
    _parity(spark, tspark, lambda s, F: u(s, F).agg(
        F.sum("v").alias("s"), F.count("*").alias("c")))
    _parity(spark, tspark, lambda s, F: u(s, F).groupBy("k").agg(
        F.sum("v").alias("s")))
    _parity(spark, tspark, lambda s, F: u(s, F).orderBy("v").limit(5))


def test_sql_text_over_the_stage_dag(spark, tspark, data):
    """The same join through ``spark.sql`` over temp views of the files."""
    def q(s, F):
        s.read.parquet(data["fact"]).createOrReplaceTempView("st_fact")
        s.read.parquet(data["item"]).createOrReplaceTempView("st_item")
        return s.sql("SELECT brand, SUM(qty) AS q, COUNT(*) AS n "
                     "FROM st_fact JOIN st_item USING (item_k) "
                     "WHERE price > 20 GROUP BY brand ORDER BY brand")
    _parity(spark, tspark, q)


def test_server_plan_cache_stages_kind(tspark, data):
    """Through the serving plan cache: the second run of a stage-DAG
    statement from another session is a ``cacheHit`` of the ``stages``
    kind, with the first run's answer."""
    from spark_tpu_torch.serving.plancache import PlanCache
    s1 = tspark.newSession()
    s1.conf.set("spark.tpu.scan.maxBatchRows", str(BATCH))
    plans = PlanCache(s1.conf_obj)
    s2 = tspark.newSession()
    s2.conf.set("spark.tpu.scan.maxBatchRows", str(BATCH))
    for s in (s1, s2):
        s._plan_cache = plans
        s.read.parquet(data["fact"]).createOrReplaceTempView("pc_fact")
        s.read.parquet(data["item"]).createOrReplaceTempView("pc_item")
    text = ("SELECT cat, SUM(qty) AS q FROM pc_fact JOIN pc_item "
            "USING (item_k) GROUP BY cat ORDER BY cat")
    first = s1.sql(text).collect()
    assert not s1._last_plan_cache_info["hit"]
    again = s2.sql(text).collect()
    assert s2._last_plan_cache_info["hit"]
    assert_rows_equal(first, again)
    assert plans.stats()["stage_hits"] == 1


# ---------------------------------------------------------------------------
# the stage DAG under the mesh lane (2 shards)
# ---------------------------------------------------------------------------

def test_sharded_stage_star_join(spark, tspark, data):
    """A broadcast-fused streamed join with the step run per shard (the
    build side replicated) at 2 shards in both packages."""
    def q(s, F):
        return (s.read.parquet(data["fact"])
                .join(s.read.parquet(data["item"]), on="item_k")
                .groupBy("brand")
                .agg(F.sum("qty").alias("q"), F.count("sk").alias("n"))
                .orderBy("brand"))
    _parity(spark, tspark, q, conf={"spark.tpu.mesh.shards": 2},
            stages=False)


def test_sharded_stage_grace_join(spark, tspark, data, monkeypatch):
    """A grace join under the mesh lane: the bucket joins re-enter the
    distributed executor, whose exchanges are K2's wrapper (its plain
    version on the CPU)."""
    from spark_tpu_torch import cuda_a2a
    calls = []
    orig = cuda_a2a.all_to_all
    monkeypatch.setattr(cuda_a2a, "all_to_all",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))

    def q(s, F):
        return (s.read.parquet(data["fact"])
                .join(s.read.parquet(data["rets"]),
                      on=F.col("sk") == F.col("ret_sk"))
                .agg(F.count("sk").alias("n"), F.sum("ret_qty").alias("s")))
    _parity(spark, tspark, q, conf={"spark.tpu.mesh.shards": 2},
            stages=False)
    assert TMB.STREAM_STATS["grace_joins"] == 1
    assert calls
