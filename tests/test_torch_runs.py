"""The run and plane vectors of the port (``columnar.RunColumnVector``,
``PlaneColumnVector``), its run kernels, the wire's lazy decode and the
stage boundary (``stagecompile.plan_leaves``, ``leaf_signature``),
against ``spark_tpu``'s on the same seeded inputs.

Integers are held bit for bit, floats within rtol 1e-9.  The JAX
package's run kernels have two lanes (numpy on host run tables, jax on
device planes); the port's one torch lane is held against each on its
own form.  Last, the run counters on q93's join over run-coded shards
(the receiving stage of the range lane): the port must move exactly the
counters the JAX package moves (``testing.ICI_RUN_COUNTERS``, which
``chip_smoke.py``'s [ici] phase checks on the card).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_tpu import columnar as RCol
from spark_tpu import kernels as RK
from spark_tpu import types as RT
from spark_tpu import wire as RW
from spark_tpu.aggregates import Count as RCount, CountStar as RCountStar, \
    Max as RMax, Min as RMin, Sum as RSum
from spark_tpu.expressions import Add as RAdd, Col as RColE, GT as RGT, \
    Literal as RLit, LT as RLT, Rand as RRand
from spark_tpu.sql import logical as RL
from spark_tpu.sql import stagecompile as RSC
from spark_tpu.sql.dataframe import DataFrame as RDataFrame
from spark_tpu_torch import columnar as TCol
from spark_tpu_torch import config as TC
from spark_tpu_torch import kernels as TK
from spark_tpu_torch import types as TT
from spark_tpu_torch import wire as TW
from spark_tpu_torch.aggregates import Count as TCount, \
    CountStar as TCountStar, Max as TMax, Min as TMin, Sum as TSum
from spark_tpu_torch.expressions import Add as TAdd, Col as TColE, \
    GT as TGT, Literal as TLit, LT as TLT, Rand as TRand
from spark_tpu_torch.sql import logical as TL
from spark_tpu_torch.sql import stagecompile as TSC
from spark_tpu_torch.sql.dataframe import DataFrame as TDataFrame
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import (ICI_RUN_COUNTERS, OOC_SCHEMAS,
                                     Q93_PACKED_SQL, assert_rows_equal,
                                     ooc_tables)

RTOL = 1e-9


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


def _runs(seed, n_runs=12, dtype=np.int64, max_len=9):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-50, 50, n_runs).astype(dtype)
    lens = rng.integers(1, max_len, n_runs).astype(np.int64)
    return vals, lens


def _both_runs(vals, lens, rdt=RT.LongType(), tdt=TT.LongType(), d=None):
    return (RCol.RunColumnVector(vals, lens, rdt, None, d),
            TCol.RunColumnVector(torch.from_numpy(vals.copy()),
                                 torch.from_numpy(lens.copy()), tdt, None, d))


# -- the vectors --------------------------------------------------------------

def test_run_vector_materializes_once_and_counts_like_reference():
    vals, lens = _runs(1)
    rv, tv = _both_runs(vals, lens)
    assert rv.capacity == tv.capacity == int(lens.sum())
    assert RCol.unmaterialized_runs(rv) is rv
    assert TCol.unmaterialized_runs(tv) is tv
    r0, t0 = RCol.runs_materialized(), TCol.runs_materialized()
    assert np.array_equal(np.asarray(rv.data), tv.data.numpy())
    tv.data, rv.data                         # memoized: counted once
    assert RCol.runs_materialized() - r0 == TCol.runs_materialized() - t0 \
        == int(lens.sum())
    assert TCol.unmaterialized_runs(tv) is None
    # a dictionary remap keeps the runs
    tr = TCol.RunColumnVector(torch.tensor([2, 0, 1], dtype=torch.int32),
                              torch.tensor([3, 1, 2]), TT.StringType(),
                              None, ("a", "b", "c"))
    moved = tr.with_run_values(torch.tensor([0, 2, 1], dtype=torch.int32),
                               ("x", "y", "z"))
    assert moved.run_lengths.tolist() == [3, 1, 2]
    assert moved.dictionary == ("x", "y", "z")
    assert TCol.unmaterialized_runs(moved) is moved


@pytest.mark.parametrize("n_runs", [1, 5, 13])
def test_plane_from_runs_and_expansion_match_reference(n_runs):
    vals, lens = _runs(n_runs, n_runs)
    rv, tv = _both_runs(vals, lens)
    cap = TCol.pad_capacity(n_runs)
    rp = RCol.PlaneColumnVector.from_runs(rv, cap, device=False)
    tp = TCol.PlaneColumnVector.from_runs(tv, cap)
    assert tp.plane_capacity == rp.plane_capacity == cap
    assert tp.capacity == rp.capacity and tp.n_runs == rp.n_runs == n_runs
    assert np.array_equal(np.asarray(rp.plane_values),
                          tp.plane_values.numpy())
    assert np.array_equal(np.asarray(rp.plane_lengths),
                          tp.plane_lengths.numpy())
    assert TCol.unexpanded_plane(tp) is tp
    e0 = TCol.run_plane_expansions()
    assert np.array_equal(np.asarray(rp.data), tp.data.numpy())
    tp.data
    assert TCol.run_plane_expansions() - e0 == 1
    assert TCol.unexpanded_plane(tp) is None


# -- the run kernels ----------------------------------------------------------

@pytest.mark.parametrize("seed,n_runs,pad", [(3, 7, 0), (4, 20, 12),
                                             (5, 1, 7)])
def test_run_kernels_match_reference(seed, n_runs, pad):
    vals, lens = _runs(seed, n_runs)
    cap = int(lens.sum())
    pv = np.concatenate([vals, np.zeros(pad, vals.dtype)])
    pl = np.concatenate([lens, np.zeros(pad, np.int64)])
    assert np.array_equal(np.asarray(RK.rle_expand(np, vals, lens)),
                          TK.rle_expand(torch.from_numpy(vals),
                                        torch.from_numpy(lens)).numpy())
    for xp in (np, jnp):
        want_ids = np.asarray(RK.run_row_ids(xp, xp.asarray(pl), cap))
        got_ids = TK.run_row_ids(torch.from_numpy(pl), cap).numpy()
        assert np.array_equal(want_ids, got_ids)
        want = np.asarray(RK.run_expand(xp, xp.asarray(pv), xp.asarray(pl),
                                        cap))
        got = TK.run_expand(torch.from_numpy(pv), torch.from_numpy(pl),
                            cap).numpy()
        assert np.array_equal(want, got)


def _filter_batches(seed, row_valid):
    vals, lens = _runs(seed, 16)
    rv, tv = _both_runs(vals, lens)
    cap = rv.capacity
    other = np.arange(cap, dtype=np.int64)
    rvalid = None if not row_valid else \
        np.random.default_rng(seed).random(cap) < 0.8
    rb = RCol.ColumnBatch(["r", "o"], [rv, RCol.ColumnVector(
        other, RT.LongType(), None, None)], rvalid, cap)
    tb = TCol.ColumnBatch(["r", "o"], [tv, TCol.ColumnVector(
        torch.from_numpy(other.copy()), TT.LongType(), None, None)],
        None if rvalid is None else torch.from_numpy(rvalid.copy()), cap)
    return rb, tb, vals, lens


PREDS = {
    "gt": (lambda C, L, G, A, Lt: G(C("r"), L(5))),
    "arith": (lambda C, L, G, A, Lt: Lt(A(C("r"), L(3)), L(-10))),
}


@pytest.mark.parametrize("pred", list(PREDS))
@pytest.mark.parametrize("row_valid", [False, True])
def test_run_aware_and_plane_filters_match_reference(pred, row_valid):
    rb, tb, vals, lens = _filter_batches(7, row_valid)
    rp = PREDS[pred](RColE, RLit, RGT, RAdd, RLT)
    tp = PREDS[pred](TColE, TLit, TGT, TAdd, TLT)
    a0, b0 = RCol.run_aware_op_rows(), TCol.run_aware_op_rows()
    want = RK._run_aware_filter(rb, rp)
    got = TK._run_aware_filter(tb, tp)
    assert np.array_equal(np.asarray(want.row_valid), got.row_valid.numpy())
    assert RCol.run_aware_op_rows() - a0 == TCol.run_aware_op_rows() - b0
    # the plane form: the reference on jax planes, the port on its planes
    cap = TCol.pad_capacity(len(vals))
    rplane = RCol.PlaneColumnVector.from_runs(rb.vectors[0], cap)
    tplane = TCol.PlaneColumnVector.from_runs(tb.vectors[0], cap)
    rbp = RCol.ColumnBatch(rb.names, [rplane, rb.vectors[1]],
                           None if rb.row_valid is None
                           else jnp.asarray(rb.row_valid), rb.capacity)
    tbp = TCol.ColumnBatch(tb.names, [tplane, tb.vectors[1]], tb.row_valid,
                           tb.capacity)
    want = RK._plane_filter(jnp, rbp, rp)
    got = TK._plane_filter(tbp, tp)
    assert np.array_equal(np.asarray(want.row_valid), got.row_valid.numpy())
    assert TCol.unexpanded_plane(tplane) is tplane    # data never expanded
    # a positional predicate or a second column refuses the run forms
    for p in (TGT(TColE("r"), TColE("o")), TLT(TRand(3), TLit(0.5))):
        assert TK._run_aware_filter(tb, p) is None
        assert TK._plane_filter(tbp, p) is None
    for p in (RGT(RColE("r"), RColE("o")), RLT(RRand(3), RLit(0.5))):
        assert RK._run_aware_filter(rb, p) is None


def _agg_slots(mod):
    Count, CountStar, Sum, Min, Max, C = mod
    return [(CountStar(), "n"), (Count(C("r")), "c"), (Sum(C("r")), "s")], \
        [(CountStar(), "n"), (Sum(C("r")), "s"), (Min(C("r")), "lo"),
         (Max(C("r")), "hi")]


@pytest.mark.parametrize("row_valid", [False, True])
def test_run_aware_and_plane_aggregates_match_reference(row_valid):
    rb, tb, vals, _lens = _filter_batches(9, row_valid)
    r_host, r_plane = _agg_slots((RCount, RCountStar, RSum, RMin, RMax,
                                  RColE))
    t_host, t_plane = _agg_slots((TCount, TCountStar, TSum, TMin, TMax,
                                  TColE))

    def cols(b):
        return [(np.asarray(v.data).tolist(),
                 None if v.valid is None else np.asarray(v.valid).tolist())
                for v in b.vectors]
    want = RK._run_aware_global_aggregate(rb, r_host)
    got = TK._run_aware_global_aggregate(tb, t_host)
    if row_valid:
        assert want is None and got is None       # fully live batches only
    else:
        assert want.names == got.names and cols(want) == cols(got)
    cap = TCol.pad_capacity(len(vals))
    rbp = RCol.ColumnBatch(rb.names, [RCol.PlaneColumnVector.from_runs(
        rb.vectors[0], cap), rb.vectors[1]], None if rb.row_valid is None
        else jnp.asarray(rb.row_valid), rb.capacity)
    tbp = TCol.ColumnBatch(tb.names, [TCol.PlaneColumnVector.from_runs(
        tb.vectors[0], cap), tb.vectors[1]], tb.row_valid, tb.capacity)
    want = RK._plane_global_aggregate(jnp, rbp, r_plane)
    got = TK._plane_global_aggregate(tbp, t_plane)
    assert want.names == got.names and cols(want) == cols(got)
    assert TCol.unexpanded_plane(tbp.vectors[0]) is not None
    # a float sum is refused: float addition does not associate
    fb = TCol.ColumnBatch(["f"], [TCol.RunColumnVector(
        torch.tensor([1.5, 2.5]), torch.tensor([2, 3]), TT.DoubleType())],
        None, 5)
    assert TK._run_aware_global_aggregate(fb, [(TSum(TColE("f")), "s")]) \
        is None


def test_union_all_keeps_runs_like_reference():
    """A decoded run piece beside a compressible dense sibling stays a run
    table; an incompressible sibling falls back to the dense concat."""
    vals, lens = _runs(11, 10)
    rv, tv = _both_runs(vals, lens)
    sib = np.repeat(np.array([4, 4, 9], np.int64), [20, 20, 20])
    noisy = np.arange(60, dtype=np.int64)
    for dense, keeps in ((sib, True), (noisy, False)):
        rpieces = [RCol.ColumnBatch(["k"], [RCol.ColumnVector(
            dense, RT.LongType(), None, None)], None, len(dense)),
            RCol.ColumnBatch(["k"], [rv], None, rv.capacity)]
        tpieces = [TCol.ColumnBatch(["k"], [TCol.ColumnVector(
            torch.from_numpy(dense.copy()), TT.LongType(), None, None)],
            None, len(dense)), TCol.ColumnBatch(["k"], [tv], None,
                                                tv.capacity)]
        want = RK.union_all(rpieces).vectors[0]
        got = TCol.union_all(tpieces).vectors[0]
        assert (RCol.unmaterialized_runs(want) is not None) == keeps
        assert (TCol.unmaterialized_runs(got) is not None) == keeps
        if keeps:
            assert np.array_equal(np.asarray(want.run_values),
                                  got.run_values.numpy())
            assert np.array_equal(np.asarray(want.run_lengths),
                                  got.run_lengths.numpy())
        assert np.array_equal(np.asarray(want.data), got.data.numpy())


# -- the wire -----------------------------------------------------------------

def _run_shaped(seed, n=600):
    rng = np.random.default_rng(seed)
    return {"t": np.repeat(np.arange(n // 12, dtype=np.int64), 12),
            "v": rng.integers(0, 9, n).astype(np.int64),
            "f": rng.random(n)}


def test_wire_lazy_decode_matches_reference():
    """A frame the port encodes with run codes decodes in both packages
    with ``keep_runs``: the same run tables (lazy in both), the same
    dense columns; a still-lazy run vector ships its table as it is."""
    data = _run_shaped(13)
    tb = TCol.ColumnBatch.from_arrays(data)
    rb = RCol.ColumnBatch.from_arrays(data)
    tstats, rstats = {}, {}
    tbuf = TW.encode_batches([tb], run_codes=True, stats=tstats)
    rbuf = RW.encode_batches([rb], run_codes=True, stats=rstats)
    assert tbuf == rbuf and tstats == rstats
    for buf in (tbuf, rbuf):
        got = TW.decode_batches(buf, keep_runs=True)[0]
        want = RW.decode_batches(buf, keep_runs=True)[0]
        assert TCol.unmaterialized_runs(got.vectors[0]) is not None
        for g, w in zip(got.vectors, want.vectors):
            assert (TCol.unmaterialized_runs(g) is None) == \
                (RCol.unmaterialized_runs(w) is None)
            if TCol.unmaterialized_runs(g) is not None:
                assert np.array_equal(g.run_values.numpy(),
                                      np.asarray(w.run_values))
                assert np.array_equal(g.run_lengths.numpy(),
                                      np.asarray(w.run_lengths))
            assert np.array_equal(g.data.numpy(), np.asarray(w.data))
    lazy = TW.decode_batches(tbuf, keep_runs=True)
    m0 = TCol.runs_materialized()
    again = TW.encode_batches(lazy, run_codes=True)
    assert TCol.runs_materialized() == m0        # shipped un-inflated
    assert again == RW.encode_batches(RW.decode_batches(rbuf,
                                                        keep_runs=True),
                                      run_codes=True)
    assert TW.raw_nbytes(lazy) == RW.raw_nbytes(
        RW.decode_batches(rbuf, keep_runs=True))


def test_malformed_run_table_still_fails_the_lazy_decode():
    data = _run_shaped(14)
    buf = bytearray(TW.encode_batches([TCol.ColumnBatch.from_arrays(data)],
                                      run_codes=True))
    import json as _json
    import zlib
    magic, ver, hlen, plen, _ = TW._PREFIX.unpack_from(buf)
    header = _json.loads(bytes(buf[TW.PREFIX_LEN:TW.PREFIX_LEN + hlen]))
    header["batches"][0]["columns"][0]["enc"]["nr"] += 1
    hb = _json.dumps(header, separators=(",", ":")).encode()
    payload = bytes(buf[TW.PREFIX_LEN + hlen:])
    ck = zlib.adler32(payload, zlib.adler32(hb))
    bad = TW._PREFIX.pack(magic, ver, len(hb), plen, ck) + hb + payload
    for keep in (False, True):
        with pytest.raises(TW.WireFormatError):
            TW.decode_batches(bad, keep_runs=keep)
        with pytest.raises(RW.WireFormatError):
            RW.decode_batches(bad, keep_runs=keep)


# -- the stage boundary -------------------------------------------------------

class _Conf:
    def __init__(self, conf):
        self.conf = conf


def _leaf_pair(n_runs):
    vals, lens = _runs(n_runs, n_runs, max_len=3)
    rv, tv = _both_runs(vals, lens)
    cap = rv.capacity
    return (RCol.ColumnBatch(["r", "o"], [rv, RCol.ColumnVector(
        np.arange(cap, dtype=np.int64), RT.LongType(), None, None)], None,
        cap),
        TCol.ColumnBatch(["r", "o"], [tv, TCol.ColumnVector(
            torch.arange(cap, dtype=torch.int64), TT.LongType(), None,
            None)], None, cap))


def test_plan_leaves_and_leaf_signature_match_reference(spark):
    """A compressing run leaf enters as a plane signed ``dtype~r{cap}``
    in both packages; an overflow (a plane above half the rows) bumps the
    counter and signs as dense; more runs re-key with a larger plane."""
    rsess = spark
    tsess = _Conf(TC.Conf())
    sigs = []
    for n_runs, spread in ((5, 40), (9, 40), (40, 1)):
        rng = np.random.default_rng(n_runs)
        vals = rng.integers(0, 9, n_runs).astype(np.int64)
        lens = np.full(n_runs, spread, np.int64)
        rv, tv = _both_runs(vals, lens)
        rb = RCol.ColumnBatch(["r"], [rv], None, rv.capacity)
        tb = TCol.ColumnBatch(["r"], [tv], None, tv.capacity)
        r0 = (RCol.run_plane_overflows(), RCol.run_plane_stages())
        t0 = (TCol.run_plane_overflows(), TCol.run_plane_stages())
        rl = RSC.plan_leaves(rsess, [rb])
        tl = TSC.plan_leaves(tsess, [tb])
        rsig, tsig = RSC.leaf_signature(rl), TSC.leaf_signature(tl)
        assert rsig == tsig
        assert (RCol.run_plane_overflows() - r0[0],
                RCol.run_plane_stages() - r0[1]) == \
            (TCol.run_plane_overflows() - t0[0],
             TCol.run_plane_stages() - t0[1])
        sigs.append(tsig)
    assert sigs[0] == "200[bigint~r8]" and sigs[1] == "360[bigint~r16]"
    assert sigs[2] == "40[bigint]"          # 40 runs of 1: an overflow
    # the conf off: every run leaf enters dense
    off = _Conf(TC.Conf({"spark.tpu.stage.runPlanes": "false"}))
    _rb, tb = _leaf_pair(6)
    (dense,) = TSC.plan_leaves(off, [tb])
    assert type(dense.vectors[0]) is TCol.ColumnVector


def test_plane_stage_rekeys_and_answers_like_reference(spark, tspark):
    """A filter and a keyless aggregate over a run leaf, through each
    package's stage lane: the plane taught kernels answer equal, a larger
    run count gives a new stage key (never a stale graph), and no host
    materialization happens on the plane path."""
    from spark_tpu.sql import functions as RF
    from spark_tpu_torch.sql import functions as TF
    answers = []
    for n_runs in (6, 20):
        vals, lens = _runs(n_runs, n_runs, max_len=60)
        lens = lens + 40
        rv, tv = _both_runs(vals, lens)
        rdf = RDataFrame(spark, RL.LocalRelation(RCol.ColumnBatch(
            ["r"], [rv], None, rv.capacity)))
        tdf = TDataFrame(tspark, TL.LocalRelation(TCol.ColumnBatch(
            ["r"], [tv], None, tv.capacity)))
        m0 = TCol.runs_materialized()
        e0 = TCol.run_plane_expansions()
        got = tdf.filter(TF.col("r") > 0).agg(
            TF.sum("r").alias("s"), TF.count("*").alias("n"),
            TF.max("r").alias("m")).collect()
        want = rdf.filter(RF.col("r") > 0).agg(
            RF.sum("r").alias("s"), RF.count("*").alias("n"),
            RF.max("r").alias("m")).collect()
        assert_rows_equal(want, got)
        assert TCol.runs_materialized() == m0
        assert TCol.run_plane_expansions() == e0
        answers.append(TSC.leaf_signature(TSC.plan_leaves(
            tspark, [TCol.ColumnBatch(["r"], [tv], None, tv.capacity)])))
    assert answers[0] != answers[1]


# -- the run counters on q93's join over run-coded shards -------------------

COUNTERS = ("runs_materialized", "run_aware_op_rows", "run_plane_stages",
            "run_plane_rows", "run_plane_overflows", "run_plane_expansions")


def _ref_counters():
    return {"runs_materialized": RCol.runs_materialized(),
            "run_aware_op_rows": RCol.run_aware_op_rows(),
            "run_plane_stages": RCol.run_plane_stages(),
            "run_plane_rows": RCol.run_plane_rows(),
            "run_plane_overflows": RCol.run_plane_overflows(),
            "run_plane_expansions": RCol.run_plane_expansions()}


def test_q93_run_counters_match_reference(spark, tspark):
    """The range lane's receiving stage at a small size: q93's store_sales
    side sorted by its packed key (ticket, item), half of it the
    reducer's own dense share and half a peer's block encoded with run
    codes (presorted) and decoded lazily; their union is the probe shard,
    store_returns the build.  q93's packed-key text over both, in each
    package's stage lane: equal answers, and the same run counters
    move."""
    tables, _rows = ooc_tables({"store_sales": 6000, "store_returns": 600,
                                "date_dim": 400, "item": 300, "reason": 35,
                                "customer": 500}, seed=19)
    ss = tables["store_sales"]
    order = np.lexsort((ss["ss_item_sk"], ss["ss_ticket_number"]))
    cols = [c for c, _t in OOC_SCHEMAS["store_sales"]]
    ss = {c: np.asarray(ss[c])[order] for c in cols}
    half = len(order) // 2
    moved = []
    outs = []
    for (Col_, T_, W_, union, DF, L_, sess) in (
            (RCol, RT, RW, RK.union_all, RDataFrame, RL, spark),
            (TCol, TT, TW, TCol.union_all, TDataFrame, TL, tspark)):
        def batch(cols_, types):
            st = T_.StructType([T_.StructField(c, T_.type_for_name(t))
                                for c, t in types])
            return Col_.ColumnBatch.from_arrays(cols_, schema=st)
        own = batch({c: v[:half] for c, v in ss.items()},
                    OOC_SCHEMAS["store_sales"])
        peer = batch({c: v[half:] for c, v in ss.items()},
                     OOC_SCHEMAS["store_sales"])
        buf = W_.encode_batches([peer], run_codes=True, run_hint=True)
        decoded = W_.decode_batches(buf, keep_runs=True)[0]
        shard = union([own, decoded])
        sr = batch({c: tables["store_returns"][c] for c, _t in
                    OOC_SCHEMAS["store_returns"]},
                   OOC_SCHEMAS["store_returns"])
        DF(sess, L_.LocalRelation(shard)).createOrReplaceTempView("ss93")
        DF(sess, L_.LocalRelation(sr)).createOrReplaceTempView("sr93")
        before = _ref_counters() if Col_ is RCol else TCol.run_counters()
        outs.append(sess.sql(Q93_PACKED_SQL).collect())
        after = _ref_counters() if Col_ is RCol else TCol.run_counters()
        moved.append({c for c in COUNTERS if after[c] != before[c]})
    assert_rows_equal(outs[0], outs[1], rtol=RTOL)
    assert moved[0] == moved[1], moved
    assert set(ICI_RUN_COUNTERS) <= moved[1], moved
