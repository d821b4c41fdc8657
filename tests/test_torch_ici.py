"""The all-to-all kernel (K2) and the device exchange tier of the port
against ``spark_tpu.parallel.ici``.

* ``cuda_a2a.all_to_all`` on CPU tensors runs its plain version; it is
  held against the reference's own all-to-all traceable
  (``ici._a2a_arrays_traceable``, ``lax.all_to_all`` under ``shard_map``)
  on the conftest's eight virtual CPU devices, bit for bit, for the
  plane types an exchange carries (int64, float64, int32 run tables,
  bool masks) and at cap = 1;
* ``local_device_exchange`` against the reference's, on random outboxes
  with runs, masks and empty senders, at 2, 4 and 8 participants;
* ``_pack_outbox`` / ``_unpack_inbox``, ``probe_topology``, ``plan_side``
  and ``schema_eligible`` against the reference's on the same inputs.

The CUDA kernel itself is held against the same plain version on the
card by ``chip_smoke.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, PartitionSpec

from spark_tpu import types as RT
from spark_tpu.columnar import ColumnBatch as RBatch, ColumnVector as RVector
from spark_tpu.parallel import ici as rici
from spark_tpu_torch import cuda_a2a
from spark_tpu_torch import types as TT
from spark_tpu_torch.columnar import ColumnBatch as TBatch, \
    ColumnVector as TVector
from spark_tpu_torch.parallel import ici as tici
from spark_tpu_torch.testing import to_numpy


# ---------------------------------------------------------------------------
# K2's plain version against the reference's all-to-all traceable
# ---------------------------------------------------------------------------

def _reference_a2a(per_shard):
    """``per_shard[s][k]``: shard s's (n, ...) plane k → per plane the
    (n, n, ...) stack of what every shard received."""
    n = len(per_shard)
    mesh = Mesh(np.asarray(jax.devices()[:n]), (rici.ICI_AXIS,))
    spec = PartitionSpec(rici.ICI_AXIS)
    fn = rici._shard_map()(rici._a2a_arrays_traceable(n, False), mesh=mesh,
                           in_specs=spec, out_specs=spec, check_vma=False)
    stacked = [np.concatenate([per_shard[s][k] for s in range(n)])
               for k in range(len(per_shard[0]))]
    out = fn(*stacked)
    return [np.asarray(o).reshape((n,) + per_shard[0][k].shape)
            for k, o in enumerate(out)]


def _planes(rng, n, cap, max_runs):
    return [rng.integers(-2**62, 2**62, (n, cap)).astype(np.int64),
            rng.normal(size=(n, cap)),
            rng.random((n, cap)) < 0.5,
            rng.integers(0, 99, (n, max_runs)).astype(np.int32)]


@pytest.mark.parametrize("n,cap,max_runs", [(2, 8, 3), (4, 1, 1),
                                            (4, 24, 5), (8, 16, 2)])
def test_all_to_all_plain_matches_lax_all_to_all(n, cap, max_runs):
    rng = np.random.default_rng(n * 100 + cap)
    per_shard = [_planes(rng, n, cap, max_runs) for _ in range(n)]
    ref = _reference_a2a(per_shard)
    launches = cuda_a2a.LAUNCHES
    got = cuda_a2a.all_to_all(
        [[torch.from_numpy(per_shard[s][k]) for s in range(n)]
         for k in range(len(per_shard[0]))])
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert cuda_a2a.LAUNCHES == launches
    for r, g in zip(ref, got):
        assert g.numpy().dtype == r.dtype
        assert np.array_equal(r, g.numpy())


def test_all_to_all_gather_form():
    n = 4
    rng = np.random.default_rng(3)
    xs = [rng.integers(0, 1000, 5) for _ in range(n)]
    out, = cuda_a2a.all_to_all([[torch.from_numpy(x) for x in xs]],
                               gather=True)
    assert tuple(out.shape) == (n, n, 5)
    for d in range(n):
        assert np.array_equal(out[d].numpy(), np.stack(xs))


@pytest.mark.parametrize("bad", ["shape", "dtype", "device", "participants",
                                 "leading", "strided"])
def test_all_to_all_refuses_what_the_kernel_does_not_take(bad):
    n = 3
    planes = [[torch.zeros((n, 4), dtype=torch.int64) for _ in range(n)]]
    if bad == "shape":
        planes[0][1] = torch.zeros((n, 5), dtype=torch.int64)
    elif bad == "dtype":
        planes[0][2] = torch.zeros((n, 4), dtype=torch.int32)
    elif bad == "device":
        planes[0][1] = torch.zeros((n, 4), dtype=torch.int64, device="meta")
    elif bad == "participants":
        planes.append(planes[0][:2])
    elif bad == "leading":
        planes = [[torch.zeros((n + 1, 4), dtype=torch.int64)] * n]
    else:
        planes[0][0] = torch.zeros((4, n), dtype=torch.int64).t()
    with pytest.raises((ValueError, TypeError)):
        cuda_a2a.all_to_all(planes)


# ---------------------------------------------------------------------------
# the exchange harness against the reference's
# ---------------------------------------------------------------------------

def _both_batches(vals, valid=None, row_valid=None):
    data = np.asarray(vals, np.int64)
    rb = RBatch(["k"], [RVector(data, RT.LongType(), valid, None)],
                row_valid, len(data))
    tb = TBatch(["k"], [TVector(torch.from_numpy(data.copy()), TT.LongType(),
                                None if valid is None
                                else torch.from_numpy(np.array(valid)),
                                None)],
                None if row_valid is None
                else torch.from_numpy(np.array(row_valid)), len(data))
    return rb, tb


def _random_outboxes(n, seed):
    """The random outboxes of tests/test_ici.py: 0-2 runs per receiver,
    1-8 rows each, masks on odd-length runs, empty senders."""
    rng = np.random.default_rng(seed)
    ref, port = [], []
    for _s in range(n):
        rob, tob = {}, {}
        for r in range(n):
            rruns, truns = [], []
            for _ in range(int(rng.integers(0, 3))):
                m = int(rng.integers(1, 9))
                vals = rng.integers(-99, 99, m)
                valid = (rng.random(m) < 0.8) if m % 2 else None
                rowv = (rng.random(m) < 0.9) if m % 3 == 0 else None
                rb, tb = _both_batches(vals, valid, rowv)
                rruns.append(rb)
                truns.append(tb)
            rob[r], tob[r] = rruns, truns
        ref.append(rob)
        port.append(tob)
    return ref, port


def _assert_runs_equal(ref_runs, got_runs):
    assert len(ref_runs) == len(got_runs)
    for rb, gb in zip(ref_runs, got_runs):
        assert rb.capacity == gb.capacity
        rv, gv = rb.vectors[0], gb.vectors[0]
        assert np.array_equal(np.asarray(rv.data), to_numpy(gv.data))
        assert (rv.valid is None) == (gv.valid is None)
        if rv.valid is not None:
            assert np.array_equal(np.asarray(rv.valid), to_numpy(gv.valid))
        assert (rb.row_valid is None) == (gb.row_valid is None)
        if rb.row_valid is not None:
            assert np.array_equal(np.asarray(rb.row_valid),
                                  to_numpy(gb.row_valid))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_local_device_exchange_matches_reference(n):
    ref_ob, port_ob = _random_outboxes(n, seed=11 + n)
    rtpl, ttpl = _both_batches([0])
    want = rici.local_device_exchange(ref_ob, rtpl, max_runs=2)
    got = tici.local_device_exchange(port_ob, ttpl, max_runs=2,
                                     device="cpu")
    assert len(got) == n
    for r in range(n):
        assert sorted(want[r]) == sorted(got[r])
        for s in want[r]:
            _assert_runs_equal(want[r][s], got[r][s])


def test_local_device_exchange_needs_two_participants():
    _rtpl, ttpl = _both_batches([0])
    for outboxes in ([], [{}]):
        with pytest.raises(tici.IciUnavailable):
            tici.local_device_exchange(outboxes, ttpl, device="cpu")


def test_pack_unpack_match_reference():
    members = [0, 1, 2]
    specs = [
        {1: [([10, 11], None, None), ([12], None, None)],
         2: [([13], None, None)]},
        {0: [([20], [False], None)], 2: [([21, 22, 23], None, None)]},
        {0: [], 1: [([30, 31], None, [True, False])]},
    ]
    ref_obs, port_obs = [], []
    for spec in specs:
        rob, tob = {}, {}
        for peer, runs in spec.items():
            pairs = [_both_batches(v, None if m is None else np.array(m),
                                   None if rv is None else np.array(rv))
                     for v, m, rv in runs]
            rob[peer] = [p[0] for p in pairs]
            tob[peer] = [p[1] for p in pairs]
        ref_obs.append(rob)
        port_obs.append(tob)
    rtpl, ttpl = _both_batches([0])
    rp = [rici._pack_outbox(ob, members, rtpl, cap=4, max_runs=2)
          for ob in ref_obs]
    tp = [tici._pack_outbox(ob, members, ttpl, cap=4, max_runs=2)
          for ob in port_obs]
    for a, b in zip(rp, tp):
        assert a[0] == b[0]
        for x, y in zip(a[1] + a[2] + [a[3], a[4]],
                        b[1] + b[2] + [b[3], b[4]]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for r in members:
        def slot_planes(packs):
            return ([np.stack([packs[s][1][0][r] for s in members])],
                    [np.stack([packs[s][2][0][r] for s in members])],
                    np.stack([packs[s][3][r] for s in members]),
                    np.stack([packs[s][4][r] for s in members]))
        want = rici._unpack_inbox(rp[0][0], rtpl, *slot_planes(rp), members,
                                  self_pid=r)
        got = tici._unpack_inbox(tp[0][0], ttpl, *slot_planes(tp), members,
                                 self_pid=r)
        assert sorted(want) == sorted(got)
        for s in want:
            _assert_runs_equal(want[s], got[s])


@pytest.mark.parametrize("outbox,cap,max_runs", [
    ({1: [[1, 2, 3]]}, 2, 2),            # over capacity
    ({1: [[1], [2]]}, 8, 1),             # over max_runs
])
def test_pack_raises_match_reference(outbox, cap, max_runs):
    rtpl, ttpl = _both_batches([0])
    for mod, which in ((rici, 0), (tici, 1)):
        ob = {p: [_both_batches(v)[which] for v in runs]
              for p, runs in outbox.items()}
        tpl = (rtpl, ttpl)[which]
        with pytest.raises(mod.IciUnavailable):
            mod._pack_outbox(ob, [0, 1], tpl, cap=cap, max_runs=max_runs)


# ---------------------------------------------------------------------------
# tier split, activation and the schema gate (tests/test_ici.py cases)
# ---------------------------------------------------------------------------

PROBES = [("", 0, 3, [0, 1, 2]), ("0,1|2,3", 1, 5, [0, 1, 2, 3, 4]),
          ("0,1,9|2", 0, 4, [0, 1, 3]), ("0,1|1,2", 2, 3, [0, 1, 2]),
          ("0,banana|2", 0, 3, [0, 1, 2]), ("1,0|3,2", 0, 4, [0, 1, 2, 3]),
          ("1,0|3,2", 3, 4, [0, 1, 2, 3]), ("0,1", 0, 2, [0, 1])]


def _mans(l_bytes, l_rows, r_bytes=0, r_rows=0):
    return {0: {"sides": {"l": [l_bytes // 2, l_rows],
                          "r": [r_bytes // 2, r_rows]}},
            1: {"sides": {"l": [l_bytes - l_bytes // 2, l_rows // 2],
                          "r": [r_bytes - r_bytes // 2, r_rows]}}}


def _plan(mod, case):
    kind, args = case
    if kind == "probe":
        t = mod.probe_topology(*args)
        return (t.domains, t.peers(), t.fingerprint(),
                [t.same_domain(p) for p in range(args[2])])
    if kind == "plan":
        override, mans, skey, min_bytes, max_runs = args
        tier = None if override is None else \
            mod.probe_topology(override, 0, 2, [0, 1])
        p = mod.plan_side(tier, mans, skey, min_bytes, max_runs)
        return None if p is None else (p.active, p.cap_rows, p.max_runs,
                                       p.agreed_bytes, p.tier.domains)
    vals, dictionary = args
    if vals is None:
        return mod.schema_eligible(None)
    rb, tb = _both_batches(vals)
    b = rb if mod is rici else tb
    b.vectors[0].dictionary = dictionary
    return mod.schema_eligible(b)


CONTROL = ([("probe", a) for a in PROBES]
           + [("plan", a) for a in [
               (None, _mans(1 << 20, 100), "l", 0, 1),
               ("", _mans(1 << 20, 100), "l", 0, 1),
               ("0,1", _mans(4096, 100), "l", 65536, 1),
               ("0,1", _mans(70000, 100), "l", 65536, 7),
               ("0,1", _mans(1 << 20, 0), "l", 0, 1),
               ("0,1", _mans(0, 0, 5000, 33), "r", 1000, 2)]]
           + [("schema", a) for a in [([1, 2], None), ([0, 1], ("a", "b")),
                                      (None, None)]])


@pytest.mark.parametrize("case", CONTROL,
                         ids=[f"{k}-{i}" for i, (k, _a) in enumerate(CONTROL)])
def test_control_plane_matches_reference(case):
    assert _plan(tici, case) == _plan(rici, case)


# ---------------------------------------------------------------------------
# across processes: the auto probe, the tier split, the arena and its
# sidecar, the one-sided fold-back, the fault kinds (the exchange itself
# runs in real processes in tests/test_torch_ici_procs.py)
# ---------------------------------------------------------------------------

from spark_tpu import config as RC  # noqa: E402
from spark_tpu.parallel import crossproc as rxp  # noqa: E402
from spark_tpu.parallel import faults as rfaults  # noqa: E402
from spark_tpu.parallel.hostshuffle import \
    HostShuffleService as RService  # noqa: E402
from spark_tpu_torch import config as TC  # noqa: E402
from spark_tpu_torch.parallel import crossproc as txp  # noqa: E402
from spark_tpu_torch.parallel import faults as tfaults  # noqa: E402
from spark_tpu_torch.parallel.hostshuffle import (  # noqa: E402
    FetchSink, HostShuffleService as TService)


class _Session:
    """What ``_ici_tier`` and the tier read of a session: its conf (and,
    for the port, its device and memory manager)."""

    def __init__(self, conf, device="cpu"):
        self.conf = conf
        self.device = torch.device(device)
        self._memory = None


def _tier_confs(**kw):
    return {"spark.tpu.shuffle.ici.enabled": "true",
            "spark.tpu.shuffle.ici.minBytes": "0", **kw}


def test_auto_probe_cpu_processes_are_singletons(tmp_path):
    """On a CPU session every process publishes ``cpu:<pid>``: the auto
    probe gives singleton domains, as the JAX package's one-process CPU
    world does; processes that publish one card form one domain."""
    svcs = [TService(str(tmp_path), p, 3) for p in range(3)]
    for s in svcs:
        tici.publish_device(s, "cpu")
    uuids = tici.card_uuids(svcs[0], [0, 1, 2])
    assert uuids == {0: "cpu:0", 1: "cpu:1", 2: "cpu:2"}
    got = tici.probe_topology("", 1, 3, [0, 1, 2], uuids)
    want = rici.probe_topology("", 1, 3, [0, 1, 2])
    assert got.domains == want.domains == ((0,), (1,), (2,))
    assert got.fingerprint() == want.fingerprint()
    cards = {0: "cuda:GPU-a", 1: "cuda:GPU-b", 2: "cuda:GPU-a"}
    assert tici.probe_topology("", 0, 3, [0, 1, 2], cards).domains == \
        ((0, 2), (1,))
    # a pid that is not live is dropped from its card's domain
    assert tici.probe_topology("", 0, 3, [0, 1], cards).domains == \
        ((0,), (1,))


@pytest.mark.parametrize("override,peers", [("", 0), ("0,1", 1),
                                            ("0|1", 0)])
def test_ici_tier_and_fingerprint_match_reference(tmp_path, override,
                                                  peers):
    confs = _tier_confs(**{"spark.tpu.shuffle.ici.tierOverride": override})
    tsvc = TService(str(tmp_path / "t"), 0, 2)
    for p in (0, 1):
        tici.publish_device(TService(str(tmp_path / "t"), p, 2), "cpu")
    rsvc = RService(str(tmp_path / "r"), 0, 2)
    ttier, tmin = txp._ici_tier(_Session(TC.Conf(confs)), tsvc)
    rtier, rmin = rxp._ici_tier(_Session(RC.Conf(confs)), rsvc)
    assert tmin == rmin == 0
    assert (ttier is None) == (rtier is None) == (peers == 0)
    assert tsvc.counters["tier_split_peers"] == \
        rsvc.counters["tier_split_peers"] == peers
    td = txp.decision_inputs(tsvc, "hash", tier=ttier)
    rd = rxp.decision_inputs(rsvc, "hash", tier=rtier)
    assert td == rd
    if peers:
        assert td["tier"] == ["0,1"]
    # the tier off: no split at all
    off = {"spark.tpu.shuffle.ici.enabled": "false"}
    assert txp._ici_tier(_Session(TC.Conf(off)), tsvc) == \
        rxp._ici_tier(_Session(RC.Conf(off)), rsvc) == (None, 0)


def _pair(tmp_path):
    """Two services on one root and each one's agreed side plan."""
    svcs = [TService(str(tmp_path), p, 2, timeout_s=10.0) for p in (0, 1)]
    for s in svcs:
        s.poll_s = 0.002
    mans = {0: {"sides": {"l": [4096, 40]}}, 1: {"sides": {"l": [4096, 40]}}}
    return svcs, [tici.plan_side(tici.probe_topology("0,1", p, 2, [0, 1]),
                                 mans, "l", 0, max_runs=3) for p in (0, 1)]


def _outbox(seed, receiver, runs=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(runs):
        m = int(rng.integers(1, 9))
        _rb, tb = _both_batches(rng.integers(-99, 99, m),
                                (rng.random(m) < 0.7) if m % 2 else None)
        out.append(tb)
    return {receiver: out}


def test_sidecar_round_trip_and_double_buffer(tmp_path):
    """Process 1 packs its spans for process 0 into its shared-memory
    arena and publishes the sidecar; process 0's pull, after process 1's
    commit, lands the same runs in its sink (values, masks, run
    boundaries).  Three publishes use the arena's two slots in turn."""
    (s0, s1), (plan0, plan1) = _pair(tmp_path)
    _rtpl, tpl = _both_batches([0])
    slots = []
    for i in range(3):
        xid = f"x{i}"
        ob = _outbox(i, 0)
        extra = tici.device_publish(s1, _Session(None), plan1, xid, ob, tpl)
        slots.append(json.load(open(tici._sidecar_path(s1, xid, 1)))["slot"])
        s1.commit(xid, extra=extra)
        sink = FetchSink(s0, f"o{i}", xid, str(tmp_path))
        tici.device_pull(s0, _Session(None), plan0, xid, tpl, sink)
        got = sink.drain()
        sink.close()
        want = ob[0]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g.vectors[0].data, w.vectors[0].data)
            assert (g.vectors[0].valid is None) == \
                (w.vectors[0].valid is None or bool(w.vectors[0].valid.all()))
            if g.vectors[0].valid is not None:
                assert torch.equal(g.vectors[0].valid, w.vectors[0].valid)
    assert slots == [0, 1, 0]
    assert s1.counters["ici_exchanges"] == 3 and s0.counters["ici_pulls"] == 3
    # a peer's own slot is never pulled, and a commit without a sidecar
    # (the host tier) leaves nothing to pull
    s1.commit("y")
    sink = FetchSink(s0, "o", "y", str(tmp_path))
    tici.device_pull(s0, _Session(None), plan0, "y", tpl, sink)
    assert sink.drain() == []


def test_pack_overflow_folds_back_one_sided(tmp_path):
    """Both processes run ``_tiered_exchange_with_refetch`` at once;
    process 1's spans overflow the agreed pack capacity, so it folds them
    back onto the host tier (counted there alone) while process 0 ships
    through its arena.  Each receives exactly what the host tier would
    deliver."""
    import threading
    (s0, s1), plans = _pair(tmp_path)
    _rtpl, tpl = _both_batches([0])
    big = {0: [_both_batches(np.arange(100))[1]]}      # > cap_rows (64)
    small = {1: [_both_batches(np.arange(5))[1]]}
    out = {}

    def run(svc, routed):
        sink = FetchSink(svc, "owner", "xq-jL", str(tmp_path))
        out[svc.pid] = txp._tiered_exchange_with_refetch(
            svc, _Session(None), plans[svc.pid], "xq-jL", routed, sink, tpl)
    ts = [threading.Thread(target=run, args=a)
          for a in ((s0, small), (s1, big))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert [b.vectors[0].data.tolist() for b in out[0]] == \
        [list(range(100))]
    assert [b.vectors[0].data.tolist() for b in out[1]] == [list(range(5))]
    assert s1.counters["dcn_fallback_exchanges"] == 1
    assert s0.counters["dcn_fallback_exchanges"] == 0
    assert s0.counters["ici_exchanges"] == 1 and s1.counters["ici_pulls"] == 1


def test_device_tier_fault_kinds_parse_in_both_packages():
    """``ici_unavailable`` and ``die_mid_device_copy`` are armed kinds
    now: a plan either package writes parses in the other, and the port
    no longer lists them as waiting."""
    assert "ici_unavailable" not in tfaults.WAITING_KINDS
    assert "die_mid_device_copy" not in tfaults.WAITING_KINDS
    tplan = tfaults.FaultPlan().ici_unavailable("xq000001-jL") \
        .die_mid_device_copy("xq000002-jR")
    rplan = rfaults.FaultPlan().ici_unavailable("xq000001-jL") \
        .die_mid_device_copy("xq000002-jR")
    env = {tfaults.FAULT_PLAN_ENV: rplan.to_env()}
    got = tfaults.FaultPlan.from_env(env)
    back = rfaults.FaultPlan.from_env({rfaults.FAULT_PLAN_ENV:
                                       tplan.to_env()})
    assert [r.to_dict() for r in got.rules] == \
        [r.to_dict() for r in tplan.rules]
    assert [(r.kind, r.exchange, r.once) for r in back.rules] == \
        [(r.kind, r.exchange, r.once) for r in rplan.rules]


def test_injected_unavailable_and_death_fire_at_their_points(tmp_path):
    """The injector's hooks: ``ici_unavailable`` raises at the attempt
    point, ``die_mid_device_copy`` dies at the copy point (after the
    pack, before any arena or sidecar)."""
    (s0, _s1), (plan, _p1) = _pair(tmp_path)
    _rtpl, tpl = _both_batches([0])
    inj = tfaults.FaultInjector(tfaults.FaultPlan().ici_unavailable("a"))
    inj.attach(s0)
    with pytest.raises(tici.IciUnavailable):
        tici.device_publish(s0, _Session(None), plan, "a", _outbox(1, 1),
                            tpl)
    died = []
    inj = tfaults.FaultInjector(tfaults.FaultPlan().die_mid_device_copy("b"))

    def die(code):
        died.append(code)
        raise SystemExit(code)
    inj.die = die
    inj.attach(s0)
    with pytest.raises(SystemExit):
        tici.device_publish(s0, _Session(None), plan, "b", _outbox(2, 1),
                            tpl)
    assert died == [43]
    assert not os.path.exists(tici._sidecar_path(s0, "b", 0))
    assert inj.injected == ["die_mid_device_copy:b"]


def test_repartition_and_coalesce_answer_like_reference(spark):
    """``repartition`` and ``coalesce`` are logical no-ops in both
    packages: the grouped answers over them equal the reference's."""
    from spark_tpu.sql import functions as RF
    from spark_tpu_torch.sql import functions as TF
    from spark_tpu_torch.sql.session import SparkSession as TSession
    rng = np.random.default_rng(21)
    data = {"k": rng.integers(0, 9, 500).astype(np.int64),
            "v": rng.integers(0, 1000, 500).astype(np.int64)}
    ts = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    try:
        answers = []
        for sess, F in ((spark, RF), (ts, TF)):
            df = sess.createDataFrame(data)
            rows = []
            for part in (df.repartition(4), df.repartition(3, "k"),
                         df.coalesce(1)):
                rows.append(sorted(tuple(int(x) for x in r) for r in
                                   part.groupBy("k").agg(
                                       F.sum("v").alias("s"),
                                       F.count("*").alias("c")).collect()))
            answers.append(rows)
        assert answers[0] == answers[1]
    finally:
        ts.stop()


# ---------------------------------------------------------------------------
# the cross-process pull's division of work (cuda_a2a.pull_plan), which
# pull_kernel follows, and device_pull's padded rows
# ---------------------------------------------------------------------------

from hypothesis import given, settings, strategies as st  # noqa: E402


def _plan_copies(table, total, P, n, stage_bytes, sms, blocks_per_sm):
    """Every copy of the launch, block by block as the kernel walks its
    items: ``{segment: [(route, offset, bytes), ...]}``, and the items
    each block took."""
    grid = cuda_a2a.pull_grid(total, sms, blocks_per_sm)
    copies, taken = {}, []
    for b in range(grid):
        for item in range(b, total, grid):
            taken.append(item)
            for seg, route, off, nb in cuda_a2a.pull_item_copies(
                    table, P, n, stage_bytes, item):
                copies.setdefault(seg, []).append((route, off, nb))
    return copies, sorted(taken)


@st.composite
def _pull_launch(draw):
    """Planes of 1, 4 or 8-byte elements, rows of 0 to 4,099 elements,
    output rows padded to 16 bytes or not, sources whose ends agree with
    their destination's mod 16 or not, senders' slots at the row's
    stride or wider, and ring stages of 16 B to 32 KiB."""
    P = draw(st.integers(1, 5))
    n = draw(st.integers(1, 4))
    stage = 16 * draw(st.sampled_from([1, 3, 4, 64, 2048]))
    sources, dst, nbytes, stride = [], [], [], []
    for _k in range(P):
        isz = draw(st.sampled_from([1, 4, 8]))
        width = draw(st.sampled_from([0, 1, 15, 17, 100, 1001, 4099]))
        row = (tici._padded_rows(width, isz) if draw(st.booleans())
               else width + draw(st.integers(0, 3))) * isz
        d = (1 << 41) + 256 * draw(st.integers(0, 4)) \
            + draw(st.integers(0, 15))
        src = (1 << 40) + 4096 * draw(st.integers(0, 4)) + (
            d % 16 if draw(st.booleans()) else draw(st.integers(0, 15)))
        slot = row if draw(st.booleans()) \
            else row + draw(st.integers(1, 40))
        sources.append([src + s * slot for s in range(n)])
        dst.append(d)
        nbytes.append(width * isz)
        stride.append(row)
    return P, n, stage, sources, dst, nbytes, stride


@settings(max_examples=300, deadline=None)
@given(_pull_launch(), st.sampled_from([(3, 1), (2, 2), (132, 1)]))
def test_pull_plan_covers_every_byte_once(launch, grid):
    P, n, stage, sources, dst, nbytes, stride = launch
    table, total = cuda_a2a.pull_plan(sources, dst, nbytes, stride, stage)
    assert len(table) == 2 * P * n + 3 * P + 1
    assert table[-1] == total
    copies, taken = _plan_copies(table, total, P, n, stage, *grid)
    assert taken == list(range(total))          # each item in one block
    for k in range(P):
        for s in range(n):
            g = k * n + s
            src, d = sources[k][s], dst[k] + s * stride[k]
            spans = sorted((off, nb, route) for route, off, nb
                           in copies.get(g, []))
            at = 0
            for off, nb, route in spans:
                assert off == at and nb > 0, (g, spans)
                at += nb
                if route == "ring":
                    assert (src + off) % 16 == 0 and (d + off) % 16 == 0
                    assert nb % 16 == 0 and nb <= stage
                elif route == "peel":
                    assert nb <= 15 and (src - d) % 16 == 0
                else:
                    assert (src - d) % 16 and nb <= stage
            assert at == nbytes[k], (g, spans, nbytes[k])


def test_pull_plan_of_padded_rows_has_no_plain_copy():
    """device_pull's layout: senders' slots at a power-of-two capacity,
    output rows rounded up to 16 bytes.  Three senders of 1,000,003 int64
    rows and a bool plane move every byte but heads and tails through the
    ring; only a run table whose slot stride is max_runs * 4 B may need
    plain threads."""
    n, rows, cap, max_runs = 3, 1_000_003, 1 << 20, 3
    planes = [(8, rows, cap), (1, rows, cap), (4, max_runs, max_runs)]
    base, at, sources, dst, nbytes, stride = 1 << 40, 0, [], [], [], []
    for isz, width, slot in planes:
        sources.append([base + at + s * slot * isz for s in range(n)])
        at += -(-n * slot * isz // 256) * 256
        padded = tici._padded_rows(width, isz) * isz
        dst.append((1 << 41) + len(dst) * (1 << 26))
        nbytes.append(width * isz)
        stride.append(padded)
        assert padded % 16 == 0 and padded - width * isz < 16
    stage = cuda_a2a.PULL_STAGE_BYTES
    table, total = cuda_a2a.pull_plan(sources, dst, nbytes, stride, stage)
    copies, _ = _plan_copies(table, total, len(planes), n, stage, 132, 1)
    for g, cs in copies.items():
        routes = {r for r, _o, _b in cs}
        if g < 2 * n:
            assert routes <= {"ring", "peel"}, (g, routes)
            assert sum(b for r, _o, b in cs if r == "peel") <= 15
        assert sum(b for _r, _o, b in cs) == nbytes[g // n]


def test_padded_pull_rows_unpack_to_the_same_runs():
    """A pull's output rows rounded up to 16 bytes (garbage past each
    block) unpack to the same runs as the unpadded planes, and as the JAX
    package's ``_unpack_inbox`` on the same input."""
    rng = np.random.default_rng(16)
    members = [0, 1, 2, 3]
    rtpl, ttpl = _both_batches([0])
    cap, max_runs = 8, 3
    rpacks, tpacks = [], []
    for s in members:
        rob, tob = {}, {}
        if s:
            runs = [_both_batches(rng.integers(-99, 99, m),
                                  (rng.random(m) < 0.6) if m % 2 else None,
                                  (rng.random(m) < 0.8) if m == 3 else None)
                    for m in rng.integers(1, 4, int(rng.integers(1, 3)))]
            rob[0], tob[0] = [r for r, _t in runs], [t for _r, t in runs]
        rpacks.append(rici._pack_outbox(rob, members, rtpl, cap, max_runs))
        tpacks.append(tici._pack_outbox(tob, members, ttpl, cap, max_runs))
    senders = [1, 2, 3]
    width = max(int(tpacks[s][4][0].sum()) for s in senders)

    def received(packs):
        """Per plane, each sender's slot for receiver 0, ``width`` rows
        (the run table ``max_runs``): what a pull copies."""
        per_sender = [packs[s][1] + packs[s][2] + [packs[s][3], packs[s][4]]
                      for s in senders]
        n_planes = len(per_sender[0])
        return [np.stack([planes[k][0][:max_runs if k == n_planes - 1
                                       else width]
                          for planes in per_sender])
                for k in range(n_planes)]

    tplanes, rplanes = received(tpacks), received(rpacks)
    widths = [p.shape[1] for p in tplanes]
    padded = []
    for p in tplanes:
        full = np.frombuffer(rng.bytes(p.shape[0] * tici._padded_rows(
            p.shape[1], p.itemsize) * p.itemsize), p.dtype).reshape(
            p.shape[0], -1).copy()
        full[:, :p.shape[1]] = p
        assert full.shape[1] * p.itemsize % 16 == 0
        padded.append(full)
    names = tpacks[0][0]
    want = rici._unpack_inbox(rpacks[0][0], rtpl, rplanes[:1], rplanes[1:2],
                              rplanes[2], rplanes[3], senders, self_pid=0)
    for i, s in enumerate(senders):
        got = tici._pulled_runs(ttpl, names, padded, widths, i)
        plain = tici._runs_of(ttpl, names, tplanes[:1], tplanes[1:2],
                              tplanes[2], tplanes[3], i)
        _assert_runs_equal(want[s], got)
        assert len(plain) == len(got)
        for a, b in zip(plain, got):
            assert a.capacity == b.capacity
            assert torch.equal(a.vectors[0].data, b.vectors[0].data)
            assert (a.vectors[0].valid is None) == (b.vectors[0].valid is None)
            assert (a.row_valid is None) == (b.row_valid is None)


def test_pull_plain_pads_rows_with_zeros():
    blocks = [[torch.arange(3, dtype=torch.int64),
               torch.arange(3, 6, dtype=torch.int64)],
              [torch.tensor([True]), torch.tensor([False])]]
    a, b = cuda_a2a.pull_plain(blocks, [4, 16])
    assert a.tolist() == [[0, 1, 2, 0], [3, 4, 5, 0]]
    assert b.shape == (2, 16) and b[:, 0].tolist() == [True, False] \
        and not b[:, 1:].any()
    assert [t.shape for t in cuda_a2a.pull_plain(blocks)] == [(2, 3), (2, 1)]


def test_pull_refuses_cpu_outputs_and_short_rows():
    with pytest.raises(ValueError, match="pull_plain"):
        cuda_a2a.pull([[0]], [torch.zeros((1, 4))])
    with pytest.raises(ValueError, match="source planes"):
        cuda_a2a.pull([[0], [0]], [torch.zeros((1, 4))])
