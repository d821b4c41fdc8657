"""The port's cross-process planner pieces against the JAX package's, on
the CPU, one process.

- The pure decisions on equal inputs: ``choose_join_strategy`` (the
  cases of ``tests/test_crossproc_planner.py`` and a grid),
  ``adaptive_join_decision``, ``observed_side_stats``,
  ``elastic_reducer_width`` and ``decision_inputs``.
- Map-side bucketing on equal tables: ``Hash64`` bucket ids modulo the
  partition count, ``partition_host_slices``' bucketed rows, offsets and
  counts (with the range lane's tie keys), ``range_bucket`` and the
  range key image, bit for bit — the processes of a mixed run must agree
  on ownership.
- The n=1 degenerate lane (every exchange a self-loop) over the texts of
  ``tests/test_crossproc_planner.py``: the q3 shape, DISTINCT, a window,
  LIMIT, string min/max/first and global aggregates, each equal to the
  JAX package's plain session.
- The session surface: the launcher's environment contract, the one
  ledger kept across re-enables, and the device tier refused with peers.
"""

import itertools
import os

import numpy as np
import pytest
import torch

from spark_tpu import columnar as RCol
from spark_tpu import kernels as RK
from spark_tpu.expressions import Col as RColE
from spark_tpu.expressions import EvalContext as REval
from spark_tpu.expressions import Hash64 as RHash
from spark_tpu.parallel import crossproc as RX
from spark_tpu.parallel.hostshuffle import HostShuffleService as RSvc
from spark_tpu.sql import joins as RJ
from spark_tpu_torch import columnar as TCol
from spark_tpu_torch import kernels as TK
from spark_tpu_torch.expressions import Col as TColE
from spark_tpu_torch.expressions import EvalContext as TEval
from spark_tpu_torch.parallel import crossproc as TX
from spark_tpu_torch.parallel.hostshuffle import HostShuffleService as TSvc
from spark_tpu_torch.sql import joins as TJ
from spark_tpu_torch.sql.session import SparkSession as TSession


# ---------------------------------------------------------------------------
# the pure decisions, on equal inputs
# ---------------------------------------------------------------------------

_BASE = dict(how="inner", range_eligible=True, sort_merge_enabled=True,
             shuffled_enabled=True, broadcast_threshold=1 << 20,
             n_procs=4, left_bytes=1 << 30, right_bytes=1 << 10)

#: the overrides of ``tests/test_crossproc_planner.py``'s strategy cases
_PLANNER_CASES = [
    {}, dict(left_bytes=1 << 10, right_bytes=1 << 30),
    dict(n_procs=1, left_bytes=100, right_bytes=200),
    dict(right_bytes=2 << 20), dict(left_bytes=4000, right_bytes=1500),
    dict(broadcast_threshold=0),
    dict(how="left", left_bytes=1 << 10, right_bytes=1 << 30),
    dict(how="left"), dict(how="left_semi"),
    dict(how="right", left_bytes=1 << 10, right_bytes=1 << 30),
    dict(how="right"),
    dict(left_bytes=1 << 30, right_bytes=1 << 30),
    dict(range_eligible=False, left_bytes=1 << 30, right_bytes=1 << 30),
    dict(sort_merge_enabled=False, left_bytes=1 << 30, right_bytes=1 << 30),
    dict(range_eligible=False, shuffled_enabled=False,
         left_bytes=1 << 30, right_bytes=1 << 30),
    dict(observed_right=(1 << 30, 1000)),
    dict(left_bytes=1 << 30, right_bytes=1 << 30,
         observed_right=(1 << 10, 7)),
]


def _grid():
    for how, rng_ok, smj, sh, thr, n, lb, rb in itertools.product(
            ("inner", "left", "right", "full", "left_semi", "left_anti"),
            (True, False), (True, False), (True, False), (0, 4096),
            (1, 2, 3), (0, 100, 5000, 1 << 20), (0, 100, 5000, 1 << 20)):
        yield dict(how=how, range_eligible=rng_ok, sort_merge_enabled=smj,
                   shuffled_enabled=sh, broadcast_threshold=thr, n_procs=n,
                   left_bytes=lb, right_bytes=rb)


@pytest.mark.parametrize("case", range(len(_PLANNER_CASES)))
def test_choose_join_strategy_planner_cases(case):
    kw = dict(_BASE, **_PLANNER_CASES[case])
    assert TX.choose_join_strategy(**kw) == RX.choose_join_strategy(**kw)


def test_choose_join_strategy_grid():
    for kw in _grid():
        assert TX.choose_join_strategy(**kw) == \
            RX.choose_join_strategy(**kw), kw


def test_choose_join_strategy_feedback_matches():
    fbs = (TX.StatsFeedback(), RX.StatsFeedback())
    for fb in fbs:
        fb.record("sigR", 1 << 10, 7, "xq000001")
    for extra in (dict(right_sig="sigR"),
                  dict(right_sig="sigR", observed_right=(1 << 30, 1000)),
                  dict(right_sig="nope")):
        kw = dict(_BASE, left_bytes=1 << 30, right_bytes=1 << 30, **extra)
        got = [mod.choose_join_strategy(feedback=fb, **kw)
               for mod, fb in zip((TX, RX), fbs)]
        assert got[0] == got[1], extra
    assert fbs[0].hits == fbs[1].hits == 1
    assert fbs[0].peek("sigR") == fbs[1].peek("sigR") == (1 << 10, 7)


def test_adaptive_join_decision_matches():
    observed = [None, (1 << 30, 1000, 1 << 10, 7), (1 << 10, 7, 1 << 30, 9),
                (1 << 30, 1000, 1 << 30, 1000), (0, 0, 0, 0)]
    for frozen, how, thr, n, obs in itertools.product(
            ("hash", "range", "broadcast_right", "gather"),
            ("inner", "left", "right", "left_semi"), (0, 1 << 20), (1, 2, 4),
            observed):
        args = (frozen, how, thr, n, obs)
        assert TX.adaptive_join_decision(*args) == \
            RX.adaptive_join_decision(*args), args


def test_observed_side_stats_matches():
    good = {"sides": {"l": [100, 10], "r": [6, 2]}}
    cases = [({0: good, 1: good}, 2), ({0: good}, 2)]
    for bad in ({}, {"sides": "x"}, {"sides": {"l": [1, 2]}},
                {"sides": {"l": [1], "r": [2, 3]}},
                {"sides": {"l": [1, "x"], "r": [2, 3]}}):
        cases.append(({0: good, 1: bad}, 2))
    for mans, n in cases:
        assert TX.observed_side_stats(mans, n) == \
            RX.observed_side_stats(mans, n)
    assert TX.observed_side_stats(cases[0][0], 2) == (200, 20, 12, 4)


def test_elastic_reducer_width_matches():
    for obs, tgt, n in itertools.product(
            (None, 0, 1, 4095, 4096, 8192, 8193, 10_000, 1 << 30),
            (0, 4096, 1 << 20), (0, 1, 2, 4, 8)):
        assert TX.elastic_reducer_width(obs, tgt, n) == \
            RX.elastic_reducer_width(obs, tgt, n), (obs, tgt, n)


def test_decision_inputs_match(tmp_path):
    for n, pid in ((1, 0), (3, 2)):
        t = TSvc(str(tmp_path / f"t{n}"), pid, n, timeout_s=5)
        r = RSvc(str(tmp_path / f"r{n}"), pid, n, timeout_s=5)
        for kw in ({}, dict(cuts=[3, 9, "oak"], est_splits={2, 0})):
            assert TX.decision_inputs(t, "range", **kw) == \
                RX.decision_inputs(r, "range", **kw)


def test_stats_feedback_signature_is_structural():
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql import logical as L
    batch = TCol.ColumnBatch.from_arrays(
        {"k": np.arange(4, dtype=np.int64)})
    a = L.Filter(F.col("k") > F.lit(1), L.LocalRelation(batch))
    b = L.Filter(F.col("k") > F.lit(1), L.LocalRelation(batch))
    c = L.Filter(F.col("k") > F.lit(2), L.LocalRelation(batch))
    sig = TX.StatsFeedback.signature
    assert sig(a) == sig(b)
    assert sig(a) != sig(c)


# ---------------------------------------------------------------------------
# map-side bucketing, bit for bit
# ---------------------------------------------------------------------------

def _tables(n=2000, seed=5):
    rng = np.random.default_rng(seed)
    k = rng.integers(-50, 50, n).astype(np.int64)
    k[rng.random(n) < 0.3] = 7                       # a hot key
    f = rng.normal(size=n)
    f[::97] = np.nan
    f[::89] = -0.0
    w = np.array(["ash", "oak", "fir", "elm", "pine", "yew"])[
        rng.integers(0, 6, n)]
    vals = rng.integers(0, 1000, n).astype(np.int64)
    null_k = rng.random(n) < 0.05
    return {"k": k, "f": f, "w": w, "v": vals}, null_k


def _batches(n=2000, seed=5, dead_tail=37):
    cols, null_k = _tables(n, seed)
    rb = RCol.ColumnBatch.from_arrays(cols)
    tb = TCol.ColumnBatch.from_arrays(cols)
    assert rb.capacity == tb.capacity
    live = np.zeros(rb.capacity, bool)          # padding rows are dead
    live[:n - dead_tail] = True
    null_k = np.concatenate([null_k, np.zeros(rb.capacity - n, bool)])
    # the same NULL keys and dead rows in both packages
    rk = rb.column("k")
    rb = RCol.ColumnBatch(
        rb.names, [RCol.ColumnVector(rk.data, rk.dtype, ~null_k, None)]
        + list(rb.vectors[1:]), live, rb.capacity)
    tk = tb.column("k")
    tb = TCol.ColumnBatch(
        tb.names, [TCol.ColumnVector(tk.data, tk.dtype,
                                     torch.from_numpy(~null_k), None)]
        + list(tb.vectors[1:]), torch.from_numpy(live), tb.capacity)
    return rb, tb


def _ref_ids(rb, names, n_parts):
    ectx = REval(rb, np)
    h = ectx.broadcast(RHash(*[RColE(c) for c in names]).eval(ectx)).data
    return (np.asarray(h).astype(np.uint64)
            % np.uint64(n_parts)).astype(np.int32)


@pytest.mark.parametrize("names", [("k",), ("f",), ("w",), ("k", "w", "f")])
@pytest.mark.parametrize("n_parts", [1, 3, 16, 64])
def test_hash_bucket_ids_offsets_counts_bit_exact(names, n_parts):
    rb, tb = _batches()
    want = _ref_ids(rb, names, n_parts)
    got = TX._hash_ids([TColE(c) for c in names], n_parts)(tb)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    r_b, r_off, r_cnt = RK.partition_host_slices(np, rb, want, n_parts)
    t_b, t_off, t_cnt = TK.partition_host_slices(tb, got, n_parts)
    assert np.array_equal(t_off, np.asarray(r_off))
    assert np.array_equal(t_cnt, np.asarray(r_cnt))
    n_live = int(np.asarray(r_cnt).sum())
    for name in tb.names:
        assert np.array_equal(
            t_b.column(name).data[:n_live].numpy(),
            np.asarray(r_b.column(name).data)[:n_live]), name


def test_hash_ids_through_live_owners():
    rb, tb = _batches()
    owners = [0, 2, 3]
    want = np.asarray(owners, np.int32)[_ref_ids(rb, ("k",), 3)]
    got = TX._hash_ids([TColE("k")], 3, owners)(tb)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("key,as_float", [("k", False), ("f", False),
                                          ("k", True), ("w", False)])
def test_range_key_image_and_span_buckets_bit_exact(key, as_float):
    rb, tb = _batches()
    r_enc, r_ok, r_dict = RJ.range_encode_key_ex(REval(rb, np),
                                                 RColE(key), as_float)
    t_enc, t_ok, t_dict = TJ.range_encode_key_ex(TEval(tb), TColE(key),
                                                 as_float)
    assert np.array_equal(t_enc.numpy(), np.asarray(r_enc))
    assert np.array_equal(t_ok.numpy(), np.asarray(r_ok))
    assert (t_dict or None) == (r_dict or None)
    keys = np.sort(np.asarray(r_enc)[np.asarray(r_ok)])
    cuts = np.unique(keys[np.linspace(0, len(keys) - 1, 9).astype(int)])
    r_spans = RK.range_bucket(np, np.asarray(r_enc), cuts)
    t_spans = TK.range_bucket(t_enc, torch.from_numpy(cuts))
    assert np.array_equal(t_spans.numpy(), np.asarray(r_spans))
    n_spans = len(cuts) + 1
    r_flag = (~np.asarray(r_ok)).astype(np.int8)
    r_b, r_off, r_cnt = RK.partition_host_slices(
        np, rb, r_spans, n_spans, tie_keys=[r_flag, np.asarray(r_enc)])
    t_b, t_off, t_cnt = TK.partition_host_slices(
        tb, t_spans, n_spans, tie_keys=[(~t_ok).to(torch.int8), t_enc])
    assert np.array_equal(t_off, np.asarray(r_off))
    assert np.array_equal(t_cnt, np.asarray(r_cnt))
    n_live = int(np.asarray(r_cnt).sum())
    for name in tb.names:
        assert np.array_equal(
            t_b.column(name).data[:n_live].numpy(),
            np.asarray(r_b.column(name).data)[:n_live]), name


def test_range_bucket_spans_and_duplicates():
    keys = torch.tensor([-5, 9, 10, 15, 20, 99, 10, 10])
    spans = TK.range_bucket(keys, torch.tensor([10, 20]))
    assert spans.dtype == torch.int32
    assert spans.tolist() == [0, 0, 1, 1, 2, 2, 1, 1]
    assert TK.range_bucket(keys, torch.zeros(0, dtype=torch.int64)) \
        .tolist() == [0] * 8


def test_range_key_spec_matches():
    from spark_tpu.sql import logical as RL
    from spark_tpu.sql import functions as RF
    from spark_tpu_torch.sql import functions as TF
    from spark_tpu_torch.sql import logical as TL
    cols = {"a": np.arange(4, dtype=np.int64), "x": np.arange(4.0),
            "s": np.array(["p", "q", "r", "s"]),
            "b": np.arange(4, dtype=np.int64), "y": np.arange(4.0),
            "t": np.array(["p", "q", "r", "s"])}
    left = ("a", "x", "s")
    right = ("b", "y", "t")
    for how in ("inner", "left", "right", "left_semi", "full"):
        for lk, rk in itertools.product(left, right):
            got = []
            for Lm, F, Cm in ((TL, TF, TCol), (RL, RF, RCol)):
                lb = Cm.ColumnBatch.from_arrays({c: cols[c] for c in left})
                rbb = Cm.ColumnBatch.from_arrays({c: cols[c] for c in right})
                j = Lm.Join(Lm.LocalRelation(lb), Lm.LocalRelation(rbb), how,
                            F.col(lk) == F.col(rk), None)
                spec = (TJ if Lm is TL else RJ).range_key_spec(
                    j, lb.schema, rbb.schema)
                got.append(None if spec is None else
                           (spec[0].name, spec[1].name) + tuple(spec[2:]))
            assert got[0] == got[1], (how, lk, rk)


# ---------------------------------------------------------------------------
# the n=1 degenerate lane against the JAX package's plain session
# ---------------------------------------------------------------------------

@pytest.fixture()
def xs(tmp_path):
    s = TSession.builder.config("spark.torch.device", "cpu").getOrCreate() \
        .newSession()
    s.conf.set("spark.tpu.mesh.shards", "1")
    s.enableHostShuffle(str(tmp_path / "hs"), process_id=0, n_processes=1,
                        timeout_s=30.0)
    yield s
    s.disableHostShuffle()


def _mk(s):
    rng = np.random.default_rng(3)
    s.createDataFrame({
        "sk": rng.integers(0, 16, 500).astype(np.int64),
        "price": rng.integers(1, 100, 500).astype(np.int64),
    }).createOrReplaceTempView("fact")
    s.createDataFrame({
        "d_sk": np.arange(16, dtype=np.int64),
        "brand": (np.arange(16, dtype=np.int64) % 5),
        "year": np.where(np.arange(16) % 2 == 0, 2000, 2001).astype(np.int64),
    }).createOrReplaceTempView("dim")


def _rows(s, q):
    return [tuple(v.item() if hasattr(v, "item") else v for v in r)
            for r in s.sql(q).collect()]


_DEGENERATE_TEXTS = [
    ("SELECT brand, sum(price) AS rev FROM fact JOIN dim ON sk = d_sk "
     "WHERE year = 2000 GROUP BY brand ORDER BY rev DESC, brand"),
    "SELECT DISTINCT sk FROM fact WHERE sk < 6 ORDER BY sk",
    ("SELECT sk, price, rank() OVER (PARTITION BY sk ORDER BY price) AS r "
     "FROM fact WHERE sk = 3 ORDER BY price, r LIMIT 5"),
    "SELECT sk FROM fact ORDER BY sk LIMIT 7",
    "SELECT sum(price) AS s, count(*) AS c FROM fact",
    ("SELECT brand, count(*) AS c FROM fact JOIN dim ON sk = d_sk "
     "GROUP BY brand ORDER BY brand"),
]


def test_degenerate_lane_texts(xs, spark):
    _mk(xs)
    _mk(spark)
    svc = xs._crossproc_svc
    for q in _DEGENERATE_TEXTS:
        assert _rows(xs, q) == _rows(spark, q), q
    # n=1: every leaf is "replicated" — no join strategy ever engages
    assert svc.counters["exchanges"] > 0
    for c in ("broadcast_joins", "range_merge_joins", "shuffled_joins",
              "fast_path_aggs"):
        assert svc.counters[c] == 0, c


def test_degenerate_string_minmax_first(xs, spark):
    rng = np.random.default_rng(11)
    k = rng.integers(0, 7, 300).astype(np.int64)
    words = np.array(["pine", "ash", "oak", "elm", "fir"])[k % 5]
    for s in (xs, spark):
        s.createDataFrame({"k": k, "g": words}).createOrReplaceTempView("st")
    for q in ("SELECT k, min(g) AS lo, max(g) AS hi, first(g) AS fv, "
              "count(*) AS c FROM st GROUP BY k ORDER BY k",
              "SELECT k, max(g) AS hi FROM st GROUP BY k ORDER BY k"):
        assert _rows(xs, q) == _rows(spark, q), q


def test_disable_restores_local_path(xs):
    _mk(xs)
    xs.disableHostShuffle()
    assert xs.sql("SELECT count(*) AS c FROM fact").collect()[0]["c"] == 500


def test_host_exchange_group_agg_single_process(xs, spark):
    from spark_tpu_torch.sql import functions as F
    _mk(xs)
    df = xs.table("fact").groupBy("sk").agg(F.sum("price").alias("s"))
    out = TX.host_exchange_group_agg(xs, df, xs._crossproc_svc, "hx")
    got = sorted(zip(out.column("sk").data.tolist(),
                     out.column("s").data.tolist()))
    _mk(spark)
    assert got == sorted(_rows(spark, "SELECT sk, sum(price) AS s FROM fact "
                                      "GROUP BY sk"))


# ---------------------------------------------------------------------------
# the session surface
# ---------------------------------------------------------------------------

def test_enable_host_shuffle_reads_the_launcher_contract(tmp_path,
                                                        monkeypatch):
    s = TSession.builder.config("spark.torch.device", "cpu").getOrCreate() \
        .newSession()
    monkeypatch.delenv("SPARK_TPU_PROCESS_ID", raising=False)
    monkeypatch.delenv("SPARK_TPU_NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="SPARK_TPU_PROCESS_ID"):
        s.enableHostShuffle(str(tmp_path / "a"))
    monkeypatch.setenv("SPARK_TPU_PROCESS_ID", "1")
    monkeypatch.setenv("SPARK_TPU_NUM_PROCESSES", "3")
    svc = s.enableHostShuffle(str(tmp_path / "b"))
    assert (svc.pid, svc.n) == (1, 3)
    ledger = s._host_ledger
    svc2 = s.enableHostShuffle(str(tmp_path / "c"), process_id=0,
                               n_processes=1)
    assert svc2.ledger is ledger                     # kept across re-enables
    names = [src.name for src in s.metricsSystem._sources]
    assert names.count("shuffle") == 1
    s.disableHostShuffle()


def test_device_tier_with_peers_raises(xs, tmp_path):
    from spark_tpu_torch.parallel.hostshuffle import HostShuffleService
    svc = HostShuffleService(str(tmp_path / "t"), 0, 2, timeout_s=5)
    xs.conf.set("spark.tpu.shuffle.ici.enabled", "true")
    TX._check_device_tier(xs, svc)                  # auto probe: singletons
    xs.conf.set("spark.tpu.shuffle.ici.tierOverride", "0,1")
    with pytest.raises(NotImplementedError, match="device tier"):
        TX._check_device_tier(xs, svc)
    xs.conf.unset("spark.tpu.shuffle.ici.tierOverride")
    xs.conf.unset("spark.tpu.shuffle.ici.enabled")


def test_cached_relation_and_lazy_checkpoint_keep_their_rules(xs, tmp_path,
                                                              monkeypatch):
    """Through the cross-process entry (n=1): a query over a cached
    relation reads the cached batch in its local runs, and a plan over a
    lazy checkpoint stays uncacheable for the serving plan cache."""
    from spark_tpu_torch.serving.plancache import PlanCache
    from spark_tpu_torch.sql import functions as F
    from spark_tpu_torch.sql import logical as L
    from spark_tpu_torch.sql.planner import QueryExecution
    _mk(xs)
    src = xs.table("fact").select("sk", "price")
    want = sorted(tuple(r) for r in src.groupBy("sk")
                  .agg(F.sum("price").alias("s")).collect())
    src.cache()
    df = src.groupBy("sk").agg(F.sum("price").alias("s"))
    plan = QueryExecution(xs, df._plan).optimized
    leaves = []

    def walk(n):
        leaves.append(n)
        for c in n.children:
            walk(c)
    walk(plan)
    assert any(isinstance(n, L.CachedRelation) for n in leaves)
    assert sorted(tuple(r) for r in df.collect()) == want
    xs.conf.set("spark.tpu.checkpoint.dir", str(tmp_path / "ckpt"))
    lazy = xs.table("fact").select("sk", "price").checkpoint(eager=False)
    pc = PlanCache(xs.conf_obj)
    monkeypatch.setattr(xs, "_plan_cache", pc)
    q = lazy.groupBy("sk").agg(F.sum("price").alias("s"))
    for _ in range(2):
        assert sorted(tuple(r) for r in q.collect()) == want
    st = pc.stats()
    assert st["uncacheable"] >= 2 and st["hits"] == 0
    assert len(os.listdir(tmp_path / "ckpt")) == 1
