"""Shards on several cards: the mesh's placement, K2's per-card plan, its
cross-device plain version, the device tier's domains over published
card facts, the workers' ``cuda:N`` and ``shards = 0``.

The reference places shard s on ``jax.devices()[s]`` (``get_mesh``); its
all-to-all is ``lax.all_to_all`` / ``lax.all_gather`` under ``shard_map``
on the conftest's eight virtual CPU devices.  There is no card here: the
CPU tests hold the pure functions the cards run by (the placement, the
per-card tables and their decoding as the kernel decodes them) and the
whole mesh lane over several LOGICAL cards, all ``cpu``
(``mesh.visible_cards`` patched), against the one-card lane bit for bit.
Integer results are bit for bit; float aggregates too (one program, one
order of operations).  The kernels themselves, the barrier and peer
access run on the cards in ``chip_smoke.py``'s ``[cards]`` phase.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
from jax.sharding import Mesh as JMesh, PartitionSpec

from spark_tpu import types as RT
from spark_tpu.parallel import ici as rici
from spark_tpu.parallel import mesh as rmesh
from spark_tpu.sql import functions as RF
from spark_tpu_torch import config as TC
from spark_tpu_torch import cuda_a2a
from spark_tpu_torch import testing as TTesting
from spark_tpu_torch import types as TT
from spark_tpu_torch.parallel import ici as tici
from spark_tpu_torch.parallel import mesh as tmesh
from spark_tpu_torch.parallel import spmd
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql import planner as TP
from spark_tpu_torch.sql import stagecompile as TSC
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import assert_rows_equal
from test_torch_dist import CASES, SHARDS, _run as _reference_rows
from test_torch_multibatch import bigfile  # noqa: F401 — a fixture

WHOLE_STAGE = "spark.sql.codegen.wholeStage"


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


# ---------------------------------------------------------------------------
# (a) placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,cards,want", [
    (4, 1, [0, 0, 0, 0]), (4, 4, [0, 1, 2, 3]), (8, 4, [0, 0, 1, 1, 2, 2, 3, 3]),
    (4, 2, [0, 0, 1, 1]), (2, 4, [0, 1])])
def test_placement_is_the_reference_rule(n, cards, want):
    assert tmesh.shard_cards(n, cards) == want
    m = tmesh.Mesh(n, "cpu", ["cpu"] * cards)
    assert m.card_of == want
    assert m.n_cards == min(n, cards)
    for c in range(m.n_cards):
        assert list(m.shards_on(c)) == [s for s in range(n) if want[s] == c]
    if n == cards:
        # one shard per card: the reference's devs[:n], device s for shard s
        ref = [d.id for d in rmesh.get_mesh(n).devices.reshape(-1)]
        first = jax.devices()[0].id
        assert [d - first for d in ref] == want


@pytest.mark.parametrize("cards", [["cuda:0", "cuda:0"],
                                   ["cuda:1", "cuda:2", "cuda:1"]])
def test_a_card_is_never_placed_twice(cards):
    """A mesh's cards and a barrier's are distinct CUDA devices: a repeated
    one raises before anything is allocated."""
    with pytest.raises(ValueError, match="distinct"):
        tmesh.Mesh(len(cards), cards[0], cards)
    with pytest.raises(ValueError, match="distinct"):
        cuda_a2a.BarrierSet([torch.device(c).index for c in cards])


def test_cpu_session_keeps_every_shard_on_the_cpu():
    m = tmesh.get_mesh(4, "cpu")
    assert m.n_cards == 1 and m.devices == [torch.device("cpu")] * 4
    assert tmesh.visible_cards("cpu") == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# (b) K2's per-card plan
# ---------------------------------------------------------------------------

def _plan_blocks(plan, P, n, interleave=False):
    """Every (plane, sender, receiver) block the per-card tables copy,
    with the card that copies it and the bytes it covers (``interleave``:
    the fused launch's order of items)."""
    got = {}
    for c, (d0, n_dst, table, total) in enumerate(plan):
        assert len(table) * 8 <= 32764 - 8     # the kernel's parameter room
        blocks = cuda_a2a.a2a_table_blocks(
            table, P, n, d0, n_dst, cuda_a2a.first_sender(n, d0, n_dst),
            interleave) if total else []
        assert len(blocks) == total
        for k, s, d, src, dst, nb in blocks:
            got.setdefault((k, s, d), []).append((c, src, dst, nb))
    return got


@pytest.mark.parametrize("interleave", [False, True])
@pytest.mark.parametrize("n,cards", [(4, 4), (8, 4), (4, 2)])
def test_cards_start_from_different_senders(n, cards, interleave):
    """Each card's first blocks come from a sender no other card starts
    with, and from its own card: the fused launch's first items wait for
    no other card's arrival.  Block by block (``all_to_all_kernel``) a
    card takes its senders one after another from there; chunk by chunk
    (``exchange_kernel``, ``interleave``) every round of n items holds
    every sender once, in that order."""
    card_of = tmesh.shard_cards(n, cards)
    C = max(card_of) + 1
    src = [[s << 40 for s in range(n)]]
    big = 3 * cuda_a2a.CHUNK_BYTES
    plan = cuda_a2a.a2a_card_plan(src, [[1 << 60]] * C, [big], [big],
                                  card_of)
    firsts = []
    for d0, n_dst, table, total in plan:
        rot = cuda_a2a.first_sender(n, d0, n_dst)
        blocks = cuda_a2a.a2a_table_blocks(table, 1, n, d0, n_dst, rot,
                                           interleave)
        firsts.append(blocks[0][1])
        want = [(rot + i) % n for i in range(n)]
        if interleave:
            rounds = [blocks[j:j + n] for j in range(0, len(blocks), n)]
            assert all([b[1] for b in rnd] == want for rnd in rounds)
        else:
            per = -(-big // cuda_a2a.CHUNK_BYTES)
            assert [b[1] for b in blocks[::n_dst * per]] == want
    assert len(set(firsts)) == C
    assert all(card_of[f] == c for c, f in enumerate(firsts))


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 8), cards=st.integers(1, 8),
       sizes=st.lists(st.integers(0, 3 * cuda_a2a.CHUNK_BYTES + 17),
                      min_size=1, max_size=6),
       gather=st.booleans(), root=st.booleans(), cross=st.booleans())
def test_card_plan_covers_every_block_once_on_its_receivers_card(
        n, cards, sizes, gather, root, cross):
    """With the order across cards in the tables (``cross``, the fused
    launch's) or without, every block is copied once, on its receiver's
    card."""
    card_of = tmesh.shard_cards(n, cards)
    C = max(card_of) + 1
    P = len(sizes)
    # distinct fake addresses: sender s's plane k at (k*n+s) << 40, card
    # c's output of plane k at (1 << 60) + ((c * P + k) << 40)
    src = [[((k * n + s) << 40) for s in range(n)] for k in range(P)]
    dst = [[(1 << 60) + ((c * P + k) << 40) for k in range(P)]
           for c in range(C)]
    stride = [0 if gather else nb for nb in sizes]
    receivers = range(1) if root else None
    plan = cuda_a2a.a2a_card_plan(src, dst, sizes, stride, card_of,
                                  receivers,
                                  _fake_cross(C) if cross else None)
    got = _plan_blocks(plan, P, n, interleave=cross)
    want_d = list(receivers) if root else list(range(n))
    for k, nb in enumerate(sizes):
        for s in range(n):
            for d in range(n):
                pieces = got.get((k, s, d), [])
                if nb == 0 or d not in want_d:
                    assert pieces == []
                    continue
                c = card_of[d]
                d0 = plan[c][0]
                assert {p[0] for p in pieces} == {c}
                assert sum(p[3] for p in pieces) == nb
                offs = sorted(p[1] - src[k][s] - d * stride[k]
                              for p in pieces)
                assert offs == list(range(0, nb, cuda_a2a.CHUNK_BYTES))
                for _c, a, b, _nb in pieces:
                    off = a - src[k][s] - d * stride[k]
                    assert b == dst[c][k] + ((d - d0) * n + s) * nb + off


def _fake_cross(C, timeout_ns=7_000_000):
    """A barrier set's ``cross`` with distinct fake addresses: card c's
    state at (3 << 56) + (c << 20), its error word at (5 << 56) + 4c."""
    return ([(3 << 56) + (c << 20) for c in range(C)],
            [(5 << 56) + 4 * c for c in range(C)], timeout_ns)


@pytest.mark.parametrize("P,cross,fits", [(400, False, False),
                                          (400, True, False),
                                          (340, False, True),
                                          (340, True, False)])
def test_card_plan_holds_the_table_limit(P, cross, fits):
    """One launch's table holds 4,088 entries, the order across cards
    included: 340 planes of 8 senders fit alone (4,081) and not with it
    (4,098)."""
    n = 8
    card_of = tmesh.shard_cards(n, 4)
    src = [[0] * n for _ in range(P)]

    def plan():
        return cuda_a2a.a2a_card_plan(src, [[0] * P] * 4, [16] * P,
                                      [16] * P, card_of,
                                      cross=_fake_cross(4) if cross
                                      else None)
    if fits:
        assert all(len(t) <= cuda_a2a.MAX_TABLE_ENTRIES
                   for _d0, _n, t, _tot in plan())
    else:
        with pytest.raises(ValueError, match="table entries"):
            plan()


@pytest.mark.parametrize("n,cards,root", [(4, 4, True), (4, 4, False),
                                          (8, 4, True), (4, 2, True),
                                          (2, 2, False), (3, 3, True)])
def test_card_plan_order_entries_per_card(n, cards, root):
    """The fused launch's table on every card, a card with no receivers
    included (its copy part holds no item): after the copy part, the
    number of cards, the card's rank, its error word, the readers (the
    cards with receivers), the time limit, each sender's card and every
    card's state — the flag slots and epoch the kernel signals and
    waits on."""
    card_of = tmesh.shard_cards(n, cards)
    C = max(card_of) + 1
    P = 2
    src = [[((k * n + s) << 40) for s in range(n)] for k in range(P)]
    dst = [[(1 << 60) + ((c * P + k) << 40) for k in range(P)]
           for c in range(C)]
    sizes = [96, 70_001]
    receivers = range(1) if root else None
    cross = _fake_cross(C)
    states, errors, timeout_ns = cross
    plain = cuda_a2a.a2a_card_plan(src, dst, sizes, sizes, card_of,
                                   receivers)
    fused = cuda_a2a.a2a_card_plan(src, dst, sizes, sizes, card_of,
                                   receivers, cross)
    assert len(fused) == C
    readers = [c for c in range(C)
               if cuda_a2a.card_receivers(card_of, c, receivers)[1]]
    assert readers == ([0] if root else list(range(C)))
    mask = sum(1 << c for c in readers)
    head = P * n + 4 * P + 1
    for c, ((d0, n_dst, table, total), (pd0, pn, ptable, ptotal)) in \
            enumerate(zip(fused, plain)):
        assert (d0, n_dst, total) == (pd0, pn, ptotal)
        assert table[:head] == ptable
        assert table[head - 1] == total
        assert (total == 0) == (c not in readers)
        assert table[head:head + cuda_a2a.CROSS_HEAD] == \
            [C, c, errors[c], mask, timeout_ns]
        rest = table[head + cuda_a2a.CROSS_HEAD:]
        assert rest == list(card_of) + states
        assert len(table) == head + cuda_a2a.CROSS_HEAD + n + C


@pytest.mark.parametrize("lifetime,entry,ok", [
    (True, False, True), (False, True, True), (False, False, False)])
def test_captured_table_pointers_must_outlive_the_graph(monkeypatch,
                                                        lifetime, entry,
                                                        ok):
    """A captured launch's table freezes its pointers, the flag states
    and error words of the order across cards included: each must be the
    entry's memory or an allocation kept for the process's life (a
    barrier set's), or the capture raises."""
    addr = 0x7f00_0000_1000
    monkeypatch.setattr(cuda_a2a, "_PROCESS_LIFETIME",
                        {addr} if lifetime else set())
    monkeypatch.setattr(cuda_a2a, "CAPTURE_SOURCES", lambda p: entry)
    if ok:
        cuda_a2a._check_captured_pointers([addr])
    else:
        with pytest.raises(RuntimeError, match="outside the entry"):
            cuda_a2a._check_captured_pointers([addr])


# ---------------------------------------------------------------------------
# (c) K2's cross-device plain version against lax under shard_map
# ---------------------------------------------------------------------------

def _ref_exchange(per_shard, gather):
    n = len(per_shard)
    mesh = JMesh(np.asarray(jax.devices()[:n]), (rici.ICI_AXIS,))
    spec = PartitionSpec(rici.ICI_AXIS)
    if gather:
        def body(*xs):
            return tuple(jax.lax.all_gather(x[0], rici.ICI_AXIS)[None]
                         for x in xs)
        stacked = [np.stack([per_shard[s][k] for s in range(n)])
                   for k in range(len(per_shard[0]))]
    else:
        body = rici._a2a_arrays_traceable(n, False)
        stacked = [np.concatenate([per_shard[s][k] for s in range(n)])
                   for k in range(len(per_shard[0]))]
    fn = rici._shard_map()(body, mesh=mesh, in_specs=spec, out_specs=spec,
                           check_vma=False)
    out = fn(*stacked)
    return [np.asarray(o).reshape((n, n) + per_shard[0][k].shape[
        0 if gather else 1:]) for k, o in enumerate(out)]


@pytest.mark.parametrize("n,cards", [(4, 4), (4, 2), (8, 4), (2, 2)])
@pytest.mark.parametrize("gather", [False, True])
def test_cross_device_plain_matches_lax(n, cards, gather):
    rng = np.random.default_rng(n * 10 + cards)
    cap = 6
    lead = () if gather else (n,)
    per_shard = [[rng.integers(-2**62, 2**62, lead + (cap,)).astype(np.int64),
                  rng.random(lead + (cap,)) < 0.5,
                  rng.integers(0, 99, lead + (3,)).astype(np.int32)]
                 for _ in range(n)]
    ref = _ref_exchange(per_shard, gather)
    card_of = tmesh.shard_cards(n, cards)
    devices = [torch.device("cpu")] * (max(card_of) + 1)
    planes = [[torch.from_numpy(per_shard[s][k]) for s in range(n)]
              for k in range(3)]
    launches = cuda_a2a.LAUNCHES
    got = cuda_a2a.all_to_all_cards(planes, card_of, devices, gather=gather)
    assert cuda_a2a.LAUNCHES == launches       # CPU: the plain version
    for c, outs in enumerate(got):
        d0, n_dst = cuda_a2a.card_receivers(card_of, c)
        for r, g in zip(ref, outs):
            assert np.array_equal(r[d0:d0 + n_dst], g.numpy())
    # one receiver: only shard 0's card gets anything
    root = cuda_a2a.all_to_all_plain(planes, True, card_of, devices,
                                     range(1))
    assert all(r is None for r in root[1:])
    for k in range(3):
        want = np.stack([per_shard[s][k] for s in range(n)])
        assert np.array_equal(root[0][k][0].numpy(), want)


def test_communicator_collectives_on_logical_cards():
    """psum / pmax / once / gather_root over 4 shards on 2 logical cards:
    every shard gets the one-card answer."""
    mesh = tmesh.Mesh(4, "cpu", ["cpu", "cpu"])
    calls = []

    def fn(shard, comm):
        x = torch.tensor([shard + 1, 10 * shard], dtype=torch.int64)
        s = comm.psum(shard, x)
        m = comm.pmax(shard, x)
        o = comm.once(shard, lambda v: calls.append(1) or v * 2, s)
        r = comm.gather_root(shard, [x])
        return s, m, o, r

    out = spmd.run_shards(4, "cpu", fn, mesh)
    assert len(calls) == 2                     # once per card
    for shard, (s, m, o, r) in enumerate(out):
        assert s.tolist() == [10, 60] and m.tolist() == [4, 30]
        assert o.tolist() == [20, 120]
        assert (r is None) == (shard != 0)
    assert out[0][3][0].tolist() == [[s + 1, 10 * s] for s in range(4)]


# ---------------------------------------------------------------------------
# the mesh lane over logical cards against the one-card lane
# ---------------------------------------------------------------------------

def _rows(session, case, shards, lane):
    query, conf, _o, _r = CASES[case]
    session.conf.set(SHARDS, str(shards))
    if lane == "eager":
        session.conf.set(WHOLE_STAGE, "false")
    for k, v in conf.items():
        session.conf.set(k, v)
    try:
        return [tuple(r) for r in query(session, TF, TT).collect()]
    finally:
        session.conf.set(SHARDS, "1")
        session.conf.unset(WHOLE_STAGE)
        for k in conf:
            session.conf.unset(k)


@pytest.mark.parametrize("case,cards", [
    ("hash_agg", 4), ("q3_broadcast", 4), ("q3_skew_join", 4),
    ("q3_skew_join", 2), ("global_sort", 4), ("keyless_aggregate", 4),
    ("distinct", 2), ("overflow_retry", 4)])
def test_mesh_lane_on_logical_cards_equals_one_card(spark, tspark,
                                                    monkeypatch, case, cards):
    """4 shards placed on ``cards`` logical cards: the stage entry's first
    run (record) and second (replay) and the eager lane give the
    reference's rows at 4 shards (``shard_map`` over four CPU devices,
    within the case's tolerance in ``test_torch_dist.CASES``: 0.0 but for
    the keyless aggregate's float sum, 1e-9) and the one-card mesh lane's
    rows bit for bit, through one entry whose step spans the cards."""
    query, conf, ordered, rtol = CASES[case]
    ref = _reference_rows(spark, RF, RT, query, conf, 4)
    one = _rows(tspark, case, 4, "graph")
    TSC.stage_cache().clear()
    monkeypatch.setattr(tmesh, "visible_cards",
                        lambda device: [torch.device("cpu")] * cards)
    first = _rows(tspark, case, 4, "graph")
    before = TSC.stage_cache().stats()
    second = _rows(tspark, case, 4, "graph")
    after = TSC.stage_cache().stats()
    eager = _rows(tspark, case, 4, "eager")
    entries = [e for e in TSC.stage_cache().entries()
               if e.key.startswith("dist4|")]
    monkeypatch.undo()
    tmesh.set_mesh(None)
    assert len(ref) > 0
    for got in (first, second, eager):
        assert_rows_equal(ref, got, rtol=rtol, ordered=ordered)
    assert first == one and second == one and eager == one
    assert entries and all(len(e.cards) == cards for e in entries)
    assert after["dispatches"] == before["dispatches"] + 1
    assert after["variants"] == before["variants"]


# ---------------------------------------------------------------------------
# (d) the device tier's domains over published card facts
# ---------------------------------------------------------------------------

def _fact(uuid, machine="m0", peers=()):
    return {"uuid": uuid, "machine": machine, "peers": list(peers)}


@pytest.mark.parametrize("facts,live,want", [
    # one host, four cards that all reach each other: one domain
    ({p: _fact(f"cuda:G{p}", peers=[f"cuda:G{q}" for q in range(4) if q != p])
      for p in range(4)}, [0, 1, 2, 3], ((0, 1, 2, 3),)),
    # no peer access: a domain per card
    ({p: _fact(f"cuda:G{p}") for p in range(3)}, [0, 1, 2],
     ((0,), (1,), (2,))),
    # two processes on each card, the cards apart: a domain per card
    ({0: _fact("cuda:A"), 1: _fact("cuda:B"), 2: _fact("cuda:A"),
      3: _fact("cuda:B")}, [0, 1, 2, 3], ((0, 2), (1, 3))),
    # two machines, each with two cards that reach each other
    ({0: _fact("cuda:A", "m0", ["cuda:B"]), 1: _fact("cuda:B", "m0", ["cuda:A"]),
      2: _fact("cuda:C", "m1", ["cuda:D"]), 3: _fact("cuda:D", "m1", ["cuda:C"])},
     [0, 1, 2, 3], ((0, 1), (2, 3))),
    # a CPU pid is its own domain; a pid that is not live is dropped
    ({0: _fact("cuda:A", peers=["cuda:B"]), 1: _fact("cpu:1"),
      2: _fact("cuda:B", peers=["cuda:A"]), 3: _fact("cuda:A")},
     [0, 1, 2], ((0, 2), (1,))),
    # one pair without access in one direction: a domain per card
    ({0: _fact("cuda:A", peers=["cuda:B"]), 1: _fact("cuda:B")}, [0, 1],
     ((0,), (1,))),
])
def test_card_domains_from_published_facts(facts, live, want):
    assert tici._card_domains(live, facts) == want
    got = tici.probe_topology("", 0, 4, live, facts)
    assert got.domains == want


@pytest.mark.parametrize("override", ["0,1|2,3", "0,1,2,3", "3,1", "",
                                      "0,9|x"])
def test_override_path_equals_reference(override):
    live = [0, 1, 2, 3]
    facts = {p: _fact(f"cuda:G{p}") for p in live}
    got = tici.probe_topology(override, 1, 4, live, facts)
    if override:
        want = rici.probe_topology(override, 1, 4, live)
        assert got.domains == want.domains
        assert got.fingerprint() == want.fingerprint()
    else:
        assert got.domains == ((0,), (1,), (2,), (3,))


def test_published_facts_round_trip(tmp_path):
    from spark_tpu_torch.parallel.hostshuffle import HostShuffleService
    svcs = [HostShuffleService(str(tmp_path), p, 2) for p in range(2)]
    for s in svcs:
        tici.publish_device(s, "cpu")
    facts = tici.card_facts(svcs[0], [0, 1])
    assert [facts[p]["uuid"] for p in (0, 1)] == ["cpu:0", "cpu:1"]
    assert all(facts[p]["peers"] == [] for p in (0, 1))
    assert tici.card_uuids(svcs[1], [0, 1]) == {0: "cpu:0", 1: "cpu:1"}


# ---------------------------------------------------------------------------
# (e) the workers' device argument
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,ok", [("cuda", True), ("cpu", True),
                                       ("cuda:1", True), ("cuda:12", True),
                                       ("cuda:x", False), ("gpu", False),
                                       ("cuda:", False), ("cpu:0", False)])
def test_workers_take_cuda_n(device, ok):
    argv = ["0", "2", "/nonexistent", "mode", "5", device]
    assert TTesting.worker_device(device) is ok
    if ok:
        assert TTesting._worker_argv("crossproc worker", argv)[5] == device
    else:
        for fn in (TTesting.crossproc_worker, TTesting.recovery_worker,
                   TTesting.pool_worker):
            with pytest.raises(ValueError, match="cuda:N"):
                fn(argv)
        with pytest.raises(ValueError, match="cuda:N"):
            TTesting.run_scenario({"n": 1, "plans": {}}, "/nonexistent",
                                  device)


def test_worker_on_a_card_it_cannot_see_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    taken = []
    monkeypatch.setattr(torch.cuda, "set_device", taken.append)
    TTesting.check_worker_card("cuda:1", "w")
    assert taken == [1]
    with pytest.raises(RuntimeError, match="sees 2 card"):
        TTesting.check_worker_card("cuda:2", "w")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTesting.check_worker_card("cuda:0", "w")


# ---------------------------------------------------------------------------
# (f) shards = 0
# ---------------------------------------------------------------------------

def test_zero_shards_is_the_visible_cards(monkeypatch):
    assert TP.resolve_shards(0, "cpu") == 1
    assert TP.resolve_shards(3, "cpu") == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert TP.resolve_shards(0, "cuda") == 4
    assert TP.resolve_shards(0, "cuda:2") == 4
    assert tmesh.visible_cards("cuda:2") == [
        torch.device("cuda:2"), torch.device("cuda:3"),
        torch.device("cuda:0"), torch.device("cuda:1")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert TP.resolve_shards(0, "cuda") == 1


# ---------------------------------------------------------------------------
# the streamed mesh step over logical cards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["groupby_agg", "sort_topk", "filtered_avg",
                                  "global_agg"])
def test_streamed_mesh_step_on_logical_cards(spark, tspark, bigfile,
                                             monkeypatch, name):
    """The 2-shard streamed step with its shards on 2 logical cards: one
    entry whose step spans the cards, equal to the reference's 2-shard
    streamed step (``rtol=1e-12``, as ``test_sharded_multibatch_parity``:
    both fold in the reference's order) and to the one-card step's rows
    bit for bit, and its second run a replay with every host read but the
    packed read-back of each batch trapped — in the shard threads too."""
    from test_torch_multibatch import (DIST_CASES, _batch_conf,
                                       _trap_host_reads)
    from spark_tpu_torch.sql import multibatch as TMB
    build = DIST_CASES[name]
    with _batch_conf(spark, tspark, spark_tpu_mesh_shards=2):
        ref = build(spark.read.parquet(bigfile["plain"]), RF).collect()
        one = [tuple(r) for r in build(
            tspark.read.parquet(bigfile["plain"]), TF).collect()]
        TSC.stage_cache().clear()
        monkeypatch.setattr(tmesh, "visible_cards",
                            lambda device: [torch.device("cpu")] * 2)
        q = build(tspark.read.parquet(bigfile["plain"]), TF)
        first = [tuple(r) for r in q.collect()]
        TMB.reset_stream_stats()
        before = TSC.stage_cache().stats()
        _trap_host_reads(monkeypatch)
        second = [tuple(r) for r in q.collect()]
        monkeypatch.undo()
        after = TSC.stage_cache().stats()
        tmesh.set_mesh(None)
    assert len(ref) > 0
    for got in (first, second):
        assert_rows_equal(ref, got, rtol=1e-12)
    assert first == one and second == one
    assert after["dispatches"] - before["dispatches"] \
        == TMB.STREAM_STATS["batches"] > 1
    assert after["variants"] == before["variants"]
    entries = [e for e in TSC.stage_cache().entries()
               if e.key.startswith("mbdist2|")]
    assert entries and all(len(e.cards) == 2 for e in entries)
