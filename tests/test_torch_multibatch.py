"""The port's multi-batch runner (``spark_tpu_torch/sql/multibatch.py``)
against the reference's (``spark_tpu/sql/multibatch.py``).

The counterparts of ``tests/test_multibatch.py``,
``tests/test_multibatch_hard_aggs.py`` and
``tests/test_multibatch_dist.py``: the same parquet files, written from
numpy data made from a seed, are read at ``spark.tpu.scan.maxBatchRows``
= 256 by the reference (the conftest ``spark`` session) and by the port
(``spark.torch.device`` = ``cpu``), and the answers are compared: keys,
integers, order, NULLs and words exactly, float sums within
``rtol=1e-12`` (both fold in the reference's order).  Beside them: the
oversized relation never reaches the whole-file ``_load_batch`` and no
step leaf exceeds ``pad_capacity(batch_rows)``; a batch loop in which
every host read but the one packed read-back raises; no guard miss
across batches whose own dictionaries differ; checkpoint and resume
after a killed run; spill to disk.
"""

import glob
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_tpu.sql import functions as RF
from spark_tpu_torch import capture
from spark_tpu_torch import config as TC
from spark_tpu_torch import io as tio
from spark_tpu_torch.columnar import pad_capacity
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql import multibatch as TMB
from spark_tpu_torch.sql import stagecompile as TSC
from spark_tpu_torch.sql.planner import QueryExecution
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import assert_rows_equal

BATCH = 256          # rows per streamed batch (tiny for tests)
N = 2000             # ~8 batches


def _write_parts(d, cols, parts=4):
    os.makedirs(d)
    n = len(next(iter(cols.values())))
    step = -(-n // parts)
    for i in range(parts):
        sl = slice(i * step, (i + 1) * step)
        pq.write_table(pa.table({k: v[sl] for k, v in cols.items()}),
                       os.path.join(d, f"part-{i:03d}.parquet"))
    return str(d)


def _data(seed=7, nulls=False, words=("apple", "pear", "plum", "fig",
                                      "kiwi")):
    rng = np.random.default_rng(seed)
    x = rng.normal(10.0, 5.0, N)
    if nulls:
        x = pa.array(x, mask=rng.random(N) < 0.07)
    return {"id": np.arange(N, dtype=np.int64),
            "grp": np.asarray(rng.choice(list(words), N), dtype=object),
            "x": x,
            "k": rng.integers(0, 50, N).astype(np.int64)}


@pytest.fixture(scope="module")
def bigfile(tmp_path_factory):
    base = tmp_path_factory.mktemp("tmb")
    return {"plain": _write_parts(base / "big.parquet", _data()),
            "nulls": _write_parts(base / "hard.parquet",
                                  _data(13, nulls=True,
                                        words=("ash", "beech", "cedar",
                                               "doum", "elm")))}


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
        self.kv = {k.replace("_", "."): str(v) for k, v in kv.items()}

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


def _batch_conf(spark, tspark, **extra):
    return _conf(spark, tspark, **{"spark_tpu_scan_maxBatchRows": BATCH,
                                   "spark_tpu_collect_maxArrayLen": 1024},
                 **extra)


def _uses_multibatch(session, df, mesh=None):
    qe = QueryExecution(session, df._plan)
    return TMB.plan_multibatch(session, qe.optimized, mesh=mesh)


def _sorted_lists(rows):
    return [tuple(sorted(x) if isinstance(x, list) else x for x in r)
            for r in rows]


# ---------------------------------------------------------------------------
# the reference's cases, as parity cases: name -> (query, ordered)
# ---------------------------------------------------------------------------

def _q(path_key, build, ordered=True, post=None):
    return path_key, build, ordered, post


CASES = {
    # tests/test_multibatch.py
    "groupby_agg": _q("plain", lambda r, F: r.groupBy("grp").agg(
        F.sum("x").alias("sx"), F.count("x").alias("c"),
        F.avg("k").alias("ak"), F.min("x").alias("mn"),
        F.max("x").alias("mx")).orderBy("grp")),
    "global_agg_no_keys": _q("plain", lambda r, F: r.agg(
        F.sum("k").alias("s"), F.count("x").alias("c"),
        F.min("id").alias("mn"))),
    "string_min_max": _q("plain", lambda r, F: r.groupBy("k").agg(
        F.min("grp").alias("mn"), F.max("grp").alias("mx")).orderBy("k")),
    "filter_project_concat": _q("plain", lambda r, F: r.filter(
        F.col("k") < 10).select("id", (F.col("x") * 2).alias("x2"))),
    "sort": _q("plain", lambda r, F: r.select("id").orderBy(
        F.col("x").desc())),
    "topk_order_by_limit": _q("plain", lambda r, F: r.orderBy(
        F.col("x").desc()).limit(17)),
    "distinct": _q("plain", lambda r, F: r.select("grp").distinct(),
                   ordered=False),
    "ops_above_breaker": _q("plain", lambda r, F: r.groupBy("k").agg(
        F.sum("x").alias("sx")).filter(F.col("sx") > 0).orderBy(
        F.col("sx").desc()).limit(5)),
    "eager_path_shape": _q("plain", lambda r, F: r.filter(
        F.col("k") % 3 == 0).groupBy("grp").agg(
        F.avg("x").alias("a"), F.count("id").alias("c")).orderBy("grp")),
    # tests/test_multibatch_hard_aggs.py
    "first_last_scan_order": _q("nulls", lambda r, F: r.groupBy("grp").agg(
        F.first("id").alias("f"), F.last("id").alias("l")).orderBy("grp")),
    "first_last_ignore_nulls": _q("nulls", lambda r, F: r.groupBy(
        "grp").agg(F.first("x", ignorenulls=True).alias("f"),
                   F.last("x", ignorenulls=True).alias("l")).orderBy("grp")),
    "first_string": _q("nulls", lambda r, F: r.groupBy("k").agg(
        F.first("grp").alias("f")).orderBy("k")),
    "global_first_last": _q("nulls", lambda r, F: r.agg(
        F.first("id").alias("f"), F.last("id").alias("l"))),
    "count_distinct": _q("nulls", lambda r, F: r.groupBy("grp").agg(
        F.countDistinct("k").alias("cd")).orderBy("grp")),
    "sum_distinct": _q("nulls", lambda r, F: r.groupBy("grp").agg(
        F.sumDistinct("k").alias("sd")).orderBy("grp")),
    "collect_list": _q("nulls", lambda r, F: r.groupBy("grp").agg(
        F.collect_list("k").alias("vals")).orderBy("grp"),
        post=_sorted_lists),
    "collect_set": _q("nulls", lambda r, F: r.groupBy("grp").agg(
        F.collect_set("k").alias("vals")).orderBy("grp"),
        post=_sorted_lists),
    "percentile": _q("nulls", lambda r, F: r.groupBy("grp").agg(
        F.percentile_approx("k", 0.5).alias("med")).orderBy("grp")),
    "grace_mixed_with_plain_aggs": _q("nulls", lambda r, F: r.groupBy(
        "grp").agg(F.collect_set("k").alias("vals"), F.sum("k").alias("s"),
                   F.count("id").alias("c")).orderBy("grp"),
        post=_sorted_lists),
    "global_collect": _q("nulls", lambda r, F: r.agg(
        F.collect_set("grp").alias("vals")), post=_sorted_lists),
}


@pytest.mark.parametrize("name", list(CASES))
def test_multibatch_parity(spark, tspark, bigfile, name):
    key, build, ordered, post = CASES[name]
    path = bigfile[key]
    post = post or (lambda rows: rows)
    with _batch_conf(spark, tspark):
        tdf = build(tspark.read.parquet(path), TF)
        assert _uses_multibatch(tspark, tdf) is not None
        ref = post(build(spark.read.parquet(path), RF).collect())
        got = post(tdf.collect())
    assert tdf.schema.simpleString() == \
        build(spark.read.parquet(path), RF).schema.simpleString()
    assert_rows_equal(ref, got, rtol=1e-12, ordered=ordered)


def test_limit_early_exit(spark, tspark, bigfile):
    """A plain LIMIT stops the scan early: 40 rows, every one a row of
    the file, and fewer batches than the file holds."""
    with _batch_conf(spark, tspark):
        TMB.reset_stream_stats()
        got = tspark.read.parquet(bigfile["plain"]).limit(40).collect()
    assert len(got) == 40
    assert TMB.STREAM_STATS["batches"] < N // BATCH
    assert len({r["id"] for r in got}) == 40


def test_matches_one_batch_run(spark, tspark, bigfile):
    """The streamed run equals the port's own one-batch run (multibatch
    off), and the reference's streamed run."""
    path = bigfile["plain"]

    def q(s, F):
        return s.read.parquet(path).filter(F.col("k") % 3 == 0) \
            .groupBy("grp").agg(F.avg("x").alias("a"),
                                F.count("id").alias("c")).orderBy("grp")
    with _batch_conf(spark, tspark):
        multi = q(tspark, TF).collect()
        ref = q(spark, RF).collect()
    with _conf(spark, tspark, spark_tpu_multibatch_enabled="false"):
        one = q(tspark, TF).collect()
    assert_rows_equal(ref, multi, rtol=1e-12)
    assert_rows_equal(one, multi, rtol=1e-12)


def test_disk_spill(spark, tspark, bigfile, tmp_path):
    """The sorted-run accumulator over its host budget: runs spill to
    disk in the wire format, the merged result stays exact, the spill
    files are gone afterwards."""
    path = bigfile["plain"]
    spill_dir = str(tmp_path / "spill")
    with _batch_conf(spark, tspark,
                     spark_tpu_spill_hostMemoryRows=BATCH,
                     spark_tpu_spill_dir=spill_dir):
        TMB.reset_stream_stats()
        got = tspark.read.parquet(path).select("id", "x").orderBy(
            "x").collect()
        ref = spark.read.parquet(path).select("id", "x").orderBy(
            "x").collect()
    assert TMB.STREAM_STATS["spill_files"] >= 2
    assert_rows_equal(ref, got)
    assert not glob.glob(os.path.join(spill_dir, "**", "*.spill"),
                         recursive=True)


def test_aggregation_fold_small_threshold(spark, tspark, bigfile):
    """Partial folds after every batch stay exact."""
    path = bigfile["plain"]
    with _batch_conf(spark, tspark, spark_tpu_multibatch_aggFoldRows=8):
        got = tspark.read.parquet(path).groupBy("grp").agg(
            TF.sum("k").alias("s")).orderBy("grp").collect()
        ref = spark.read.parquet(path).groupBy("grp").agg(
            RF.sum("k").alias("s")).orderBy("grp").collect()
    assert_rows_equal(ref, got)


def test_count_rows_csv_scan(spark, tspark, tmp_path):
    """A CSV file streams as slices of one uncached host table."""
    p = str(tmp_path / "big.csv")
    d = _data(11)
    tspark.createDataFrame({k: (list(v) if v.dtype == object else v)
                            for k, v in d.items()}) \
        .write.option("header", True).csv(p)
    with _batch_conf(spark, tspark):
        back = tspark.read.csv(p, header=True, inferSchema=True)
        assert back.count() == N
        got = back.groupBy("grp").agg(TF.count("id").alias("c")) \
            .orderBy("grp").collect()
        ref = spark.read.csv(p, header=True, inferSchema=True) \
            .groupBy("grp").agg(RF.count("id").alias("c")) \
            .orderBy("grp").collect()
    assert_rows_equal(ref, got)


def test_oversized_relation_never_read_whole(spark, tspark, bigfile,
                                             monkeypatch):
    """The spy: an oversized relation never reaches the whole-file
    ``_load_batch`` (the relation cache), and no step leaf is larger than
    ``pad_capacity(batch_rows)``."""
    path = bigfile["plain"]
    loads, caps = [], []
    orig_load = tio._load_batch
    orig_run = TMB.StreamedStep.run

    def spy_load(fmt, raw_paths, *a, **k):
        loads.append(raw_paths)
        return orig_load(fmt, raw_paths, *a, **k)

    def spy_run(self, leaf):
        caps.append(leaf.capacity)
        return orig_run(self, leaf)

    monkeypatch.setattr(tio, "_load_batch", spy_load)
    monkeypatch.setattr(TMB.StreamedStep, "run", spy_run)
    with _batch_conf(spark, tspark):
        df = tspark.read.parquet(path)
        df.groupBy("grp").agg(TF.sum("k")).collect()
        df.orderBy("x").limit(5).collect()
        dim = tspark.createDataFrame({"k": np.arange(50, dtype=np.int64),
                                      "w": np.arange(50, dtype=np.int64)})
        df.join(dim, "k").groupBy("k").agg(TF.sum("w")).collect()
    assert not [p for p in loads if os.path.abspath(str(p)).startswith(
        os.path.abspath(path))]
    assert caps and max(caps) <= pad_capacity(BATCH)


def _trap_host_reads(monkeypatch):
    """Every host read of a tensor raises inside a streamed step's
    dispatch, but for its one packed read-back (on a card each such read
    would be a sync inside the batch loop); inside a replay run, building
    a tensor from host values raises too."""
    def in_step():
        st = TSC.STREAM_STEP
        run = capture._active.run
        return (st.active and not st.reading) or (
            run is not None and run.replay)

    def trap(name, orig, allow=lambda *a, **k: False):
        def f(*args, **kwargs):
            if in_step() and not allow(*args, **kwargs):
                raise AssertionError(f"{name} inside a streamed step")
            return orig(*args, **kwargs)
        return f

    for name in ("__bool__", "__int__", "__float__", "__index__", "item",
                 "tolist", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name,
                            trap(name, getattr(torch.Tensor, name)))
    for name in ("nonzero", "unique", "masked_select", "from_numpy",
                 "tensor"):
        monkeypatch.setattr(torch, name, trap(name, getattr(torch, name)))

    def by_value(_t, index, *value):
        idx = index if isinstance(index, tuple) else (index,)
        return not any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                       for i in idx) \
            and all(isinstance(v, torch.Tensor) for v in value)

    for name in ("__getitem__", "__setitem__"):
        monkeypatch.setattr(torch.Tensor, name, trap(
            name, getattr(torch.Tensor, name), allow=by_value))


@pytest.mark.parametrize("shape", ["agg", "topk", "join"])
def test_batch_loop_makes_one_read_back(spark, tspark, bigfile, monkeypatch,
                                        shape):
    """In the batch loop the one host read of each step is its packed
    read-back: every other host read of a tensor inside a step's dispatch
    raises, and the packed reads equal the batches."""
    path = bigfile["plain"]
    with _batch_conf(spark, tspark):
        df = tspark.read.parquet(path)
        if shape == "agg":
            q = df.groupBy("grp").agg(TF.sum("x").alias("s"),
                                      TF.min("grp").alias("m"))
        elif shape == "topk":
            q = df.orderBy(TF.col("x").desc()).limit(9)
        else:
            dim = tspark.createDataFrame({
                "k": np.arange(50, dtype=np.int64),
                "w": np.arange(50, dtype=np.int64) * 3})
            q = df.join(dim, "k").groupBy("grp").agg(TF.sum("w").alias("s"))
        want = q.collect()
        TMB.reset_stream_stats()
        reads = TSC.PACKED_READS
        _trap_host_reads(monkeypatch)
        got = q.collect()
        monkeypatch.undo()
    assert_rows_equal(want, got)
    assert TSC.PACKED_READS - reads == TMB.STREAM_STATS["batches"] > 1


def test_no_guard_miss_across_batch_dictionaries(spark, tspark, tmp_path):
    """Every file part holds other words, so every batch's own dictionary
    differs; re-encoded onto the global dictionary, with every mask
    explicit, all batches run one variant of the step: no guard miss, one
    build, and the reference's answer."""
    rng = np.random.default_rng(3)
    parts = []
    for i in range(4):
        words = [f"w{i}_{j}" for j in range(6)] + ["shared"]
        parts.append({"s": np.asarray(rng.choice(words, 500), object),
                      "v": rng.integers(0, 9, 500).astype(np.int64)})
    d = tmp_path / "dicts.parquet"
    os.makedirs(d)
    for i, c in enumerate(parts):
        pq.write_table(pa.table(c), str(d / f"part-{i:03d}.parquet"))
    with _batch_conf(spark, tspark):
        q = lambda s, F: s.read.parquet(str(d)).groupBy("s").agg(  # noqa
            F.sum("v").alias("t"), F.max("s").alias("m")).orderBy("s")
        q(tspark, TF).collect()
        before = TSC.stage_cache().stats()
        got = q(tspark, TF).collect()
        after = TSC.stage_cache().stats()
        ref = q(spark, RF).collect()
    assert_rows_equal(ref, got)
    assert after["guard_misses"] == before["guard_misses"]
    assert after["variants"] == before["variants"]


def test_checkpoint_resume_after_killed_run(spark, tspark, tmp_path):
    """A run killed after its first checkpoint leaves the checkpoint
    behind; a fresh run of the same query resumes at its cursor (fewer
    merger adds than batches) and gives the reference's answer."""
    rng = np.random.default_rng(9)
    n = 4000
    d = _write_parts(tmp_path / "data", {
        "k": rng.integers(0, 8, n).astype(np.int64),
        "v": rng.integers(0, 100, n).astype(np.int64)}, parts=2)
    ckpt_dir = str(tmp_path / "ckpt")
    with _batch_conf(spark, tspark,
                     spark_tpu_multibatch_checkpointDir=ckpt_dir,
                     spark_tpu_multibatch_checkpointInterval=3):
        q = tspark.read.parquet(d).groupBy("k").agg(TF.sum("v").alias("s"))
        ref = spark.read.parquet(d).groupBy("k").agg(
            RF.sum("v").alias("s")).orderBy("k").collect()
        assert_rows_equal(ref, q.orderBy("k").collect())
        assert not glob.glob(os.path.join(ckpt_dir, "*.ckpt"))

        class _Crash(Exception):
            pass

        mb = _uses_multibatch(tspark, q)
        real_save = mb._ckpt_save

        def crashing_save(path, n_batches, merger):
            real_save(path, n_batches, merger)
            raise _Crash()

        mb._ckpt_save = crashing_save
        with pytest.raises(_Crash):
            mb.execute()
        assert glob.glob(os.path.join(ckpt_dir, "*.ckpt"))

        mb2 = _uses_multibatch(tspark, q)
        adds = []
        orig_make = mb2._make_merger

        def counting_make(*a, **k):
            merger = orig_make(*a, **k)
            orig_add = merger.add
            merger.add = lambda b: adds.append(1) or orig_add(b)
            return merger

        mb2._make_merger = counting_make
        out = mb2.execute()
        assert not glob.glob(os.path.join(ckpt_dir, "*.ckpt"))
    got = sorted(out.to_pylist())
    assert got == [tuple(r) for r in ref]
    assert len(adds) <= -(-n // BATCH) - 3


def test_bucket_store_pickle_truncates_appended_spills(tmp_path):
    """``_BucketStore`` appends to its spill files; a store restored from
    a pickle truncates them to their pickled sizes, so rows spilled after
    a checkpoint are not counted twice (the reference's case)."""
    import pickle
    from spark_tpu_torch import types as T
    from spark_tpu_torch.columnar import ColumnBatch, ColumnVector
    from spark_tpu_torch.sql.stages import _BucketStore

    def batch(vals):
        t = torch.tensor(vals, dtype=torch.int64)
        return ColumnBatch(["x"], [ColumnVector(t, T.int64)], None, len(t))

    store = _BucketStore(2, budget_rows=2, spill_dir=str(tmp_path))
    store.add(batch([1, 2, 3]), np.array([0, 0, 1]))     # spills (3 > 2)
    blob = pickle.dumps(store)
    store.add(batch([4, 5, 6]), np.array([0, 1, 1]))     # after the ckpt
    store._spill()
    assert sum(b.capacity for b in store.load(0)) == 3   # 1, 2, 4
    resumed = pickle.loads(blob)
    rows = [int(v) for b in resumed.load(0) + resumed.load(1)
            for v in b.vectors[0].data]
    assert sorted(rows) == [1, 2, 3]
    store.close()


# ---------------------------------------------------------------------------
# tests/test_multibatch_dist.py: the runner under the mesh lane (2 shards)
# ---------------------------------------------------------------------------

DIST_CASES = {
    "groupby_agg": lambda r, F: r.groupBy("grp").agg(
        F.sum("x").alias("sx"), F.count("x").alias("c"),
        F.min("k").alias("mn"), F.max("x").alias("mx")).orderBy("grp"),
    "global_agg": lambda r, F: r.agg(F.sum("k").alias("s"),
                                     F.count("x").alias("c")),
    "string_minmax": lambda r, F: r.groupBy("k").agg(
        F.min("grp").alias("mn"), F.max("grp").alias("mx")).orderBy("k"),
    "sort_topk": lambda r, F: r.orderBy(F.col("x").desc()).limit(23),
    "global_sort": lambda r, F: r.select("id").orderBy(F.col("id").desc()),
    "distinct": lambda r, F: r.select("grp").distinct().orderBy("grp"),
    "first_last": lambda r, F: r.groupBy("grp").agg(
        F.first("id").alias("f"), F.last("id").alias("l")).orderBy("grp"),
    "filtered_avg": lambda r, F: r.filter(F.col("k") < 25).groupBy(
        "grp").agg(F.avg("x").alias("a"), F.sum("k").alias("sk"))
    .orderBy("grp"),
}


@pytest.mark.parametrize("name", list(DIST_CASES))
def test_sharded_multibatch_parity(spark, tspark, bigfile, name):
    """2 shards in both packages: the port's per-shard step, each shard's
    partial one run of the merger, against the reference's shard_map
    step; also equal to the port's one-shard streamed run."""
    from spark_tpu_torch.parallel.mesh import get_mesh
    build = DIST_CASES[name]
    path = bigfile["plain"]
    with _batch_conf(spark, tspark, spark_tpu_mesh_shards=2):
        tdf = build(tspark.read.parquet(path), TF)
        mb = _uses_multibatch(tspark, tdf, mesh=get_mesh(2, "cpu"))
        assert isinstance(mb, TMB.DistributedMultiBatchExecution)
        got = tdf.collect()
        ref = build(spark.read.parquet(path), RF).collect()
    with _batch_conf(spark, tspark):
        local = build(tspark.read.parquet(path), TF).collect()
    assert_rows_equal(ref, got, rtol=1e-12)
    assert_rows_equal(local, got, rtol=1e-12)


@pytest.mark.parametrize("name", ["groupby_agg", "sort_topk",
                                  "filtered_avg"])
def test_sharded_step_replays_without_host_reads(spark, tspark, bigfile,
                                                 monkeypatch, name):
    """The 2-shard step is one stage-cache entry (``mbdist2|…``): a second
    run replays it for every batch, each shard thread over its own shard
    record, and every host read but the one packed read-back of each
    batch raises — in the shard threads too."""
    build = DIST_CASES[name]
    with _batch_conf(spark, tspark, spark_tpu_mesh_shards=2):
        q = build(tspark.read.parquet(bigfile["plain"]), TF)
        want = q.collect()
        TMB.reset_stream_stats()
        reads = TSC.PACKED_READS
        before = TSC.stage_cache().stats()
        _trap_host_reads(monkeypatch)
        got = q.collect()
        monkeypatch.undo()
        after = TSC.stage_cache().stats()
    assert_rows_equal(want, got)
    assert TSC.PACKED_READS - reads == TMB.STREAM_STATS["batches"] > 1
    assert after["dispatches"] - before["dispatches"] \
        == TMB.STREAM_STATS["batches"]
    assert (after["variants"], after["guard_misses"]) == \
        (before["variants"], before["guard_misses"])
    assert any(e.key.startswith("mbdist2|")
               for e in TSC.stage_cache().entries())


def test_sharded_limit(spark, tspark, bigfile):
    with _batch_conf(spark, tspark, spark_tpu_mesh_shards=2):
        got = tspark.read.parquet(bigfile["plain"]).limit(37).collect()
    assert len(got) == 37 and len({r["id"] for r in got}) == 37
