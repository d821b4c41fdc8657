"""The port's mesh lane (``spark.tpu.mesh.shards`` > 1) against the JAX
package's mesh lane.

Both packages run every query as 4 shards: the reference as a
``shard_map`` program over four of the conftest's eight virtual CPU
devices, the port as four shard threads on the CPU whose exchanges take
the all-to-all kernel's plain version.  Inputs come from numpy seeds.
``collect()`` rows must be equal, in order wherever the query has ORDER
BY.  Integers, string codes and sort results match bit for bit; float
SUMS match within ``rtol = 1e-9``: each shard adds its partial sums in
the same order as the reference, but the psum that merges the shards'
partials may group them differently.

Port-only checks hold the lane at 2 and 8 shards against the port's own
single-device lane (no reference program to compile there).
"""

import threading

import numpy as np
import pytest

from spark_tpu import types as RT
from spark_tpu.sql import functions as RF
from spark_tpu_torch import config as TC
from spark_tpu_torch import types as TT
from spark_tpu_torch.parallel import collective as tcol
from spark_tpu_torch.parallel import spmd
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import (assert_rows_equal, hash_agg_query,
                                     hash_agg_table, q3_query, q3_tables)

SHARDS = "spark.tpu.mesh.shards"
THRESHOLD = "spark.sql.autoBroadcastJoinThreshold"
SKEW = "spark.sql.exchange.skewFactor"
JOIN_FACTOR = "spark.sql.join.outputCapacityFactor"
FLOAT_RTOL = 1e-9


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


# ---------------------------------------------------------------------------
# the queries, written once against either package's modules
# ---------------------------------------------------------------------------

def _q3_tables():
    return q3_tables(n_sales=20000, n_items=400, n_dates=4000)


def _skewed_join_tables(seed=5, n=4000):
    """A probe side where key 7 holds about 40% of the rows, and a build
    side with duplicate keys, keys no probe row has, and key 7 twice."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 200, n)
    k[rng.random(n) < 0.4] = 7
    bk = rng.integers(0, 240, 300)
    bk[:2] = 7
    return ({"k": k.astype(np.int64),
             "v": rng.integers(0, 1000, n).astype(np.int64)},
            {"bk": bk.astype(np.int64),
             "w": rng.integers(-50, 50, 300).astype(np.int64)})


def _mixed_table(seed=9, n=3000):
    """Nullable int / float / string columns and a unique id."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-20, 20, n)
    x = np.round(rng.normal(size=n) * 100, 3)
    words = np.array(["ash", "birch", "cedar", "elm", "fir", "oak"])
    s = words[rng.integers(0, len(words), n)]
    a_null, x_null, s_null = (rng.random((3, n)) < 0.1)
    return {
        "id": np.arange(n, dtype=np.int64),
        "g": rng.integers(0, 25, n).astype(np.int64),
        "a": [None if m else int(v) for v, m in zip(a, a_null)],
        "x": [None if m else float(v) for v, m in zip(x, x_null)],
        "p": [None if m else float(abs(v)) + 0.5
              for v, m in zip(x, x_null)],
        "s": [None if m else str(v) for v, m in zip(s, s_null)],
    }


def q_hash_agg(session, F, T):
    return hash_agg_query(session, F, hash_agg_table(4096, 64))


def q_q3(session, F, T):
    return q3_query(session, F, T, _q3_tables())


def q_skew_join(session, F, T):
    probe, build = _skewed_join_tables()
    p = session.createDataFrame(probe)
    b = session.createDataFrame(build)
    return p.join(b, p["k"] == b["bk"])


def q_full_outer(session, F, T):
    probe, build = _skewed_join_tables(seed=6)
    p = session.createDataFrame(probe)
    b = session.createDataFrame(build)
    return p.join(b, p["k"] == b["bk"], "full")


def q_global_sort(session, F, T):
    """Float sort keys of one sign: the reference routes a range exchange
    on an int64 image of the floats that is monotone only within one sign
    (ROADMAP.md, faults); ``q_signed_sort`` covers both signs."""
    df = session.createDataFrame(_mixed_table())
    return df.orderBy(F.col("a").desc_nulls_last(), F.col("s").asc_nulls_first(),
                      F.col("p").desc(), "id")


def q_signed_sort(session, F, T):
    df = session.createDataFrame(_mixed_table())
    return df.orderBy(F.col("x").asc_nulls_first(), F.col("a").desc(), "id")


def q_limit(session, F, T):
    df = session.createDataFrame(_mixed_table())
    return df.filter(F.col("id") % 3 == 1).limit(37)


def q_keyless(session, F, T):
    df = session.createDataFrame(_mixed_table())
    return df.agg(F.sum("x").alias("sx"), F.avg("x").alias("ax"),
                  F.count("*").alias("n"), F.count("a").alias("na"),
                  F.min("a").alias("lo"), F.max("s").alias("hi"),
                  F.sum("g").alias("sg"))


def q_distinct(session, F, T):
    return session.createDataFrame(_mixed_table()).select("g", "s").distinct()


def q_first_last(session, F, T):
    df = session.createDataFrame(_mixed_table())
    return df.groupBy("g").agg(F.first("x").alias("fx"),
                               F.last("x").alias("lx"),
                               F.first("s", ignorenulls=False).alias("fs"),
                               F.last("a", ignorenulls=False).alias("la"))


def q_range(session, F, T):
    """``range`` splits into per-shard slices (DRange)."""
    df = session.range(5, 5000, 7)
    return df.withColumn("g", F.col("id") % 11).groupBy("g").agg(
        F.sum("id").alias("s"), F.count("*").alias("c"))


def q_overflow(session, F, T):
    df = session.createDataFrame(_mixed_table())
    return df.groupBy("id").agg(F.sum("g").alias("sg"))


#: name → (query, conf overrides, ORDER BY?, float tolerance)
CASES = {
    "hash_agg": (q_hash_agg, {}, False, 0.0),
    "q3_broadcast": (q_q3, {}, True, 0.0),
    "q3_skew_join": (q_q3, {THRESHOLD: "0"}, True, 0.0),
    "skewed_inner_join": (q_skew_join, {THRESHOLD: "0"}, False, 0.0),
    # a join factor with room: the reference's full-outer skew join does
    # not recover from a join-output overflow (see ROADMAP.md, faults)
    "full_outer_join": (q_full_outer, {THRESHOLD: "0", JOIN_FACTOR: "4.0"},
                        False, 0.0),
    "global_sort": (q_global_sort, {}, True, 0.0),
    "limit": (q_limit, {}, False, 0.0),
    "keyless_aggregate": (q_keyless, {}, False, FLOAT_RTOL),
    "distinct": (q_distinct, {}, False, 0.0),
    "first_last": (q_first_last, {}, False, 0.0),
    "overflow_retry": (q_overflow, {SKEW: "0.25"}, False, 0.0),
    "range": (q_range, {}, False, 0.0),
}
#: held against the port's single-device lane only: a float sort key of
#: both signs, and the full-outer join at the default join factor, whose
#: join-output overflow the port's adaptive retry absorbs
PORT_CASES = {"signed_float_sort": (q_signed_sort, {}, True, 0.0),
              "full_outer_join_retry": (q_full_outer, {THRESHOLD: "0"},
                                        False, 0.0)}


def _run(session, F, T, query, conf, shards):
    session.conf.set(SHARDS, str(shards))
    for k, v in conf.items():
        session.conf.set(k, v)
    try:
        return query(session, F, T).collect()
    finally:
        session.conf.set(SHARDS, "1")
        for k in conf:
            session.conf.unset(k)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_lane_matches_reference(spark, tspark, case):
    query, conf, ordered, rtol = CASES[case]
    ref = _run(spark, RF, RT, query, conf, 4)
    got = _run(tspark, TF, TT, query, conf, 4)
    assert len(got) > 0
    assert_rows_equal(ref, got, rtol=rtol, ordered=ordered)
    if case == "overflow_retry":
        # both executors grew the exchange capacity and remembered it
        for session in (spark, tspark):
            adapted = [v for k, v in session._adapted_factors.items()
                       if k.startswith("dist4:adapt:")]
            assert any(v["skew"] and v["skew"] > 0.25 for v in adapted)


def test_mesh_lane_runs_the_mesh_plan(tspark):
    """shards > 1 plans the distributed operators (partial/final
    aggregate, the adaptive exchange, range exchange, global limit)."""
    from spark_tpu_torch.parallel.executor import DistributedPlanner
    df = q_q3(tspark, TF, TT)
    tree = DistributedPlanner(tspark, 4).plan(
        _optimized(tspark, df)).physical.tree_string()
    for node in ("PartialAggregate", "ExchangeHash", "FinalAggregate",
                 "BroadcastExchange", "ExchangeRange", "ShardSort",
                 "GlobalLimit"):
        assert node in tree, (node, tree)
    df = q_range(tspark, TF, TT)
    tree = DistributedPlanner(tspark, 4).plan(
        _optimized(tspark, df)).physical.tree_string()
    assert "DRange(" in tree, tree


def _optimized(session, df):
    from spark_tpu_torch.sql.planner import QueryExecution
    return QueryExecution(session, df._plan).optimized


# ---------------------------------------------------------------------------
# port-only: the lane at 2 and 8 shards against the single-device lane
# ---------------------------------------------------------------------------

PORT_ONLY = ["hash_agg", "q3_skew_join", "skewed_inner_join",
             "full_outer_join", "global_sort", "first_last",
             "signed_float_sort", "full_outer_join_retry"]


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("case", PORT_ONLY)
def test_mesh_lane_matches_single_device(tspark, case, shards):
    query, conf, ordered, rtol = {**CASES, **PORT_CASES}[case]
    want = _run(tspark, TF, TT, query, conf, 1)
    got = _run(tspark, TF, TT, query, conf, shards)
    assert_rows_equal(want, got, rtol=rtol, ordered=ordered)


def test_zero_shards_is_the_single_device_lane(tspark, monkeypatch):
    """spark.tpu.mesh.shards = 0 ("all local devices") is one shard here:
    the query takes the single-device lane."""
    from spark_tpu_torch.parallel import executor

    def refuse(*_a, **_k):
        raise AssertionError("the mesh lane ran")

    monkeypatch.setattr(executor.DistributedExecution, "execute", refuse)
    tspark.conf.set(SHARDS, "0")
    try:
        assert len(q_hash_agg(tspark, TF, TT).collect()) == 64
    finally:
        tspark.conf.set(SHARDS, "1")


def test_mesh_lane_is_deterministic(tspark):
    """Shard threads race; results must not: the same query twice gives
    the same rows in the same order."""
    query, conf, _o, _r = CASES["skewed_inner_join"]
    first = _run(tspark, TF, TT, query, conf, 4)
    for _ in range(2):
        assert [tuple(r) for r in _run(tspark, TF, TT, query, conf, 4)] \
            == [tuple(r) for r in first]


# ---------------------------------------------------------------------------
# routing helpers against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4, 7, 256])
def test_umod_is_the_unsigned_modulo_of_the_hash(n):
    """``h.astype(uint64) % n`` on hashes held as wrapping int64."""
    import torch
    rng = np.random.default_rng(n)
    h = rng.integers(-2**63, 2**63 - 1, 2000, dtype=np.int64, endpoint=True)
    h[:4] = [-1, -2**63, 2**63 - 1, 0]
    want = (h.view(np.uint64) % np.uint64(n)).astype(np.int64)
    assert np.array_equal(tcol.umod(torch.from_numpy(h), n).numpy(), want)


@pytest.mark.parametrize("n_shards,counts_kind", [
    pytest.param(n, kind, id=str(n) if kind == "small" else f"{n}-{kind}")
    for n in (2, 4, 8) for kind in ("small", "random", "tied")])
def test_balanced_assignment_matches_reference(n_shards, counts_kind):
    """Equal fine-bucket counts are common; the stable heavy-first order
    and the first least-loaded shard decide where each bucket goes.  On
    the CPU the port's assignment is ``lpt_assign``'s plain version."""
    import jax.numpy as jnp
    import torch
    from spark_tpu.parallel import collective as rcol
    rng = np.random.default_rng(n_shards)
    counts = rng.integers(0, 4, 32 * n_shards).astype(np.int64)
    counts[rng.integers(0, counts.size, 3)] = 40        # a few hot buckets
    if counts_kind == "random":
        counts = rng.integers(0, 10**6, 32 * n_shards).astype(np.int64)
    elif counts_kind == "tied":
        counts = np.full(32 * n_shards, 3, np.int64)     # every bucket tied
    ra, rl = rcol.balanced_assignment(jnp.asarray(counts), n_shards)
    ta, tl = tcol.balanced_assignment(torch.from_numpy(counts), n_shards)
    assert np.array_equal(np.asarray(ra), ta.numpy())
    assert np.array_equal(np.asarray(rl), tl.numpy())


# ---------------------------------------------------------------------------
# spmd: a failing shard stops every shard and its error comes back
# ---------------------------------------------------------------------------

def _run_shards_bounded(n, fn, timeout=60.0):
    """``spmd.run_shards`` on the CPU, failing the test instead of hanging
    if the shards never finish."""
    out = {}

    def go():
        try:
            out["result"] = spmd.run_shards(n, "cpu", fn)
        except BaseException as e:       # noqa: BLE001 — re-raised below
            out["error"] = e

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"run_shards did not finish in {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["result"]


def test_failing_shard_aborts_the_others():
    import torch

    def fn(shard, comm):
        if shard == 2:
            raise ValueError("shard 2 failed")
        x = comm.psum(shard, torch.ones(3))        # shard 2 never arrives
        return comm.psum(shard, x)

    with pytest.raises(ValueError, match="shard 2 failed"):
        _run_shards_bounded(4, fn)


def test_collectives_see_shards_in_order():
    import torch

    def fn(shard, comm):
        got, = comm.all_gather(shard, [torch.tensor([shard * 10])])
        total = comm.psum(shard, torch.tensor(shard + 1))
        lo = comm.pmin(shard, torch.tensor(shard - 5))
        hi = comm.pmax(shard, torch.tensor(shard * 2))
        once = comm.once(shard, lambda v: v * 100, torch.tensor(shard + 7))
        sent = torch.arange(4 * 2).reshape(4, 2) + 100 * shard
        recv, = comm.all_to_all(shard, [sent])
        return got.reshape(-1).tolist(), int(total), int(lo), int(hi), \
            int(once), recv.tolist()

    out = _run_shards_bounded(4, fn)
    for d, (got, total, lo, hi, once, recv) in enumerate(out):
        assert got == [0, 10, 20, 30]
        assert (total, lo, hi, once) == (10, -5, 6, 700)
        assert recv == [[100 * s + 2 * d, 100 * s + 2 * d + 1]
                        for s in range(4)]


def test_collectives_under_thread_switch_stress():
    """More shards than cores and a tiny switch interval: every round's
    collectives still see every shard's own value, none lost or swapped."""
    import sys
    import torch
    n, rounds = 24, 40
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def fn(shard, comm):
            seen = []
            for r in range(rounds):
                total = comm.psum(shard, torch.tensor(shard * rounds + r))
                sent = torch.full((n, 1), shard * 1000 + r)
                recv, = comm.all_to_all(shard, [sent])
                seen.append((int(total), recv.reshape(-1).tolist()))
            return seen

        out = _run_shards_bounded(n, fn)
    finally:
        sys.setswitchinterval(old)
    for shard_seen in out:
        for r, (total, recv) in enumerate(shard_seen):
            assert total == sum(s * rounds + r for s in range(n))
            assert recv == [s * 1000 + r for s in range(n)]
