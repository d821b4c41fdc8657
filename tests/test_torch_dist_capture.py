"""The port's mesh lane under the stage cache: each 4-shard query is one
stage-cache entry (``dist4|…``), recorded on its first run and replayed
after, against the JAX package's mesh lane.

On the CPU a replay re-runs the entry's record eagerly (there is no
capture), with every shard thread replaying its own shard record: what
the graph of a card would freeze.  The reference runs its ``shard_map``
lane on four of the conftest's eight CPU devices; inputs come from numpy
seeds.  Rows must equal the reference's under ``test_torch_dist.py``'s
tolerances, and the eager mesh lane's (``spark.sql.codegen.wholeStage =
false``) bit for bit: both lanes run one program.
"""

import numpy as np
import pytest
import torch

from spark_tpu import types as RT
from spark_tpu.sql import functions as RF
from spark_tpu_torch import capture, cuda_lpt
from spark_tpu_torch import config as TC
from spark_tpu_torch import types as TT
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql import stagecompile as TSC
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import (BREADTH_QUERIES, assert_rows_equal,
                                     hash_agg_query, hash_agg_table,
                                     q3_tables, register_sql_tables)
from test_torch_dist import CASES, SHARDS, _run
from test_torch_stagecompile import _trap_host_syncs

WHOLE_STAGE = "spark.sql.codegen.wholeStage"


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


def _mesh_entries():
    return {e.key: e for e in TSC.stage_cache().entries()
            if e.key.startswith("dist4|")}


def _window_df(session):
    tables = q3_tables(n_sales=20000, n_items=400, n_dates=4000)
    register_sql_tables(session, hash_agg_table(256, 8), tables, TT)
    return session.sql(BREADTH_QUERIES["window"][0]), tables


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_replay_matches_reference_and_eager_lane(spark, tspark, case):
    """Every mesh query twice on the default lane — the first run records
    the entry, the second replays it — then once on the eager lane."""
    query, conf, ordered, rtol = CASES[case]
    ref = _run(spark, RF, RT, query, conf, 4)
    first = _run(tspark, TF, TT, query, conf, 4)
    before = TSC.stage_cache().stats()
    second = _run(tspark, TF, TT, query, conf, 4)
    after = TSC.stage_cache().stats()
    tspark.conf.set(WHOLE_STAGE, "false")
    try:
        eager = _run(tspark, TF, TT, query, conf, 4)
    finally:
        tspark.conf.unset(WHOLE_STAGE)
    assert TSC.stage_cache().stats()["dispatches"] == after["dispatches"]
    assert after["dispatches"] == before["dispatches"] + 1
    assert after["variants"] == before["variants"]
    for got in (first, second):
        assert_rows_equal(ref, got, rtol=rtol, ordered=ordered)
        assert [tuple(r) for r in got] == [tuple(r) for r in eager]


@pytest.mark.parametrize("name", ["hash_agg", "q3_broadcast", "q3_skew_join",
                                  "window"])
def test_mesh_replay_makes_no_host_sync_or_copy(tspark, monkeypatch, name):
    """The queries ``chip_smoke.py`` captures at 4 shards: the replay must
    touch no host value of a tensor and build no tensor from host values
    in any shard thread (each has its own replay run, so the trap sees
    it) — on a card such a call would fail the capture."""
    tspark.conf.set(SHARDS, "4")
    try:
        if name == "window":
            df, tables = _window_df(tspark)
            conf = {}
        else:
            query, conf, _o, _r = CASES[name]
            for k, v in conf.items():
                tspark.conf.set(k, v)
            df = query(tspark, TF, TT)
        want = df.collect()
        before = TSC.stage_cache().stats()
        _trap_host_syncs(monkeypatch)
        got = df.collect()
        monkeypatch.undo()
        after = TSC.stage_cache().stats()
    finally:
        tspark.conf.set(SHARDS, "1")
        for k in conf:
            tspark.conf.unset(k)
    assert [tuple(r) for r in got] == [tuple(r) for r in want]
    if name == "window":
        oracle = BREADTH_QUERIES["window"][1](tables, None)
        assert_rows_equal(oracle, got)
    assert after["dispatches"] == before["dispatches"] + 1
    assert (after["variants"], after["guard_misses"]) == \
        (before["variants"], before["guard_misses"])


def test_mesh_entry_serves_a_second_data_set(spark, tspark):
    """Hash-agg over two seeded tables of one shape: the second runs
    through the first one's entry and variant (on a card, the frozen K2
    table reads the new static buffers) and equals its own reference
    answer."""
    def rows(session, F, seed):
        session.conf.set(SHARDS, "4")
        try:
            return hash_agg_query(session, F,
                                  hash_agg_table(4096, 64, seed)).collect()
        finally:
            session.conf.set(SHARDS, "1")

    assert_rows_equal(rows(spark, RF, 7), rows(tspark, TF, 7),
                      ordered=False)
    entries, before = _mesh_entries(), TSC.stage_cache().stats()
    got = rows(tspark, TF, 23)
    after = TSC.stage_cache().stats()
    assert_rows_equal(rows(spark, RF, 23), got, ordered=False)
    assert _mesh_entries().keys() == entries.keys()
    assert after["dispatches"] == before["dispatches"] + 1
    assert (after["builds"], after["variants"]) == \
        (before["builds"], before["variants"])


def test_overflow_retry_makes_a_new_entry(spark, tspark):
    """An exchange that overflows its static capacity replans with a grown
    skew factor: a new plan, so a new entry, and the reference's rows."""
    query, conf, _o, _r = CASES["overflow_retry"]
    fresh = tspark.newSession()          # no learned factors yet
    TSC.stage_cache().clear()
    got = _run(fresh, TF, TT, query, conf, 4)
    assert len(_mesh_entries()) == 2
    assert TSC.stage_cache().stats()["dispatches"] == 2
    assert_rows_equal(_run(spark, RF, RT, query, conf, 4), got,
                      ordered=False)


def test_diverged_mesh_replay_raises(tspark):
    """No fallback: a replay that asks a shard record for more than it
    holds raises instead of running the statement eagerly."""
    query, conf, _o, _r = CASES["q3_skew_join"]
    fresh = tspark.newSession()
    _run(fresh, TF, TT, query, conf, 4)
    entry = max(_mesh_entries().values(), key=lambda e: e.last_used)
    shard = entry.variants[-1].record.shards[0]
    shard.decisions.append(True)
    try:
        with pytest.raises(capture.StageDivergence):
            _run(fresh, TF, TT, query, conf, 4)
    finally:
        shard.decisions.pop()
    assert len(_run(fresh, TF, TT, query, conf, 4)) > 0


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5, 8, 9, 16, 32, 33])
def test_lpt_assign_plain_matches_reference(n_shards, ties):
    """``lpt_assign``'s plain version against the reference's
    ``balanced_assignment`` (its ``lax.fori_loop``), inside a replay run
    so the CPU trap holds it to reading nothing to the host."""
    import jax.numpy as jnp
    from spark_tpu.parallel import collective as rcol
    rng = np.random.default_rng(n_shards + 10 * ties)
    n_fine = 32 * n_shards
    if ties:
        counts = np.full(n_fine, 5, np.int64)
        counts[rng.integers(0, n_fine, 4)] = 9
    else:
        counts = rng.integers(0, 1000, n_fine).astype(np.int64)
    ra, rl = rcol.balanced_assignment(jnp.asarray(counts), n_shards)
    tcounts = torch.from_numpy(counts)
    with pytest.MonkeyPatch.context() as mp:
        _trap_host_syncs(mp)
        with capture.stage_run(capture.StageRecord(), replay=True):
            ta, tl = cuda_lpt.lpt_assign(tcounts, n_shards)
    assert ta.dtype == torch.int32
    assert np.array_equal(np.asarray(ra), ta.numpy())
    assert np.array_equal(np.asarray(rl), tl.numpy())


@pytest.mark.parametrize("ties", ["none", "some", "all"])
@pytest.mark.parametrize("n_fine", [1, 7, 128, 512, 513])
def test_lpt_rank_plain_matches_reference_argsort(n_fine, ties):
    """The kernel's in-block ranking (each bucket counts the buckets
    heavier than it, or as heavy with a lower index), in its plain
    PyTorch twin, is the reference's ``jnp.argsort(-counts)``: the stable
    heaviest-first order."""
    import jax.numpy as jnp
    rng = np.random.default_rng(n_fine + {"none": 0, "some": 1, "all": 2}[ties])
    if ties == "all":
        counts = np.full(n_fine, 3, np.int64)
    elif ties == "some":
        counts = rng.integers(0, 4, n_fine).astype(np.int64)
    else:
        counts = rng.permutation(n_fine).astype(np.int64) * 7
    want = np.asarray(jnp.argsort(-jnp.asarray(counts)))
    got = cuda_lpt.lpt_rank_plain(torch.from_numpy(counts))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


def test_shard_records_replay_per_shard_under_thread_switch_stress():
    """More shards than cores and a tiny switch interval: each shard
    thread records its own decisions and constants, and a replay serves
    every shard exactly its own, in order, with the guards of all shards
    on the caller's run in shard order."""
    import sys
    import threading
    from spark_tpu_torch.parallel import spmd
    n, rounds = 24, 20

    def fn(shard, comm):
        got = []
        for r in range(rounds):
            pred = torch.tensor((shard + r) % 3 == 0)
            got.append((capture.decide(pred),
                        int(capture.constant(shard * 100 + r, "cpu"))))
            comm.psum(shard, torch.tensor(1))
        return got

    record = capture.StageRecord()
    out = {}

    def go():
        with capture.stage_run(record, replay=False):
            out["record"] = spmd.run_shards(n, "cpu", fn)
        with capture.stage_run(record, replay=True) as run:
            out["replay"] = spmd.run_shards(n, "cpu", fn)
            run.check_consumed()
        out["guards"] = [bool(g) for g in run.guards]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=go, daemon=True)
        t.start()
        t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive(), "run_shards did not finish in 120 s"
    want = [[((s + r) % 3 == 0, s * 100 + r) for r in range(rounds)]
            for s in range(n)]
    assert out["record"] == want and out["replay"] == want
    assert len(record.shards) == n
    assert [len(rec.decisions) for rec in record.shards] == [rounds] * n
    assert out["guards"] == [True] * (n * rounds)
