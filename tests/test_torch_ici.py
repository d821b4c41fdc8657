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
