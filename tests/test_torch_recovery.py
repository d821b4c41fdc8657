"""Lineage recovery in the port (``HostShuffleService.recover_round``,
``crossproc``'s epochs), held against the JAX package in one process.

The ``{xid}-recover<epoch>`` agreement round runs its services as
threads over one root: the port's agreed lost set, epoch, live set,
``recovery_adopt`` and ``group_owner`` must equal the JAX package's on
the same observations, and a round in which one service is the JAX
package's and the other the port's must agree on one lost set (the
manifests are the same bytes).  A diverged round and a process its
peers declared lost abort structured and non-recoverable in both.  An
aborted epoch's ledger reservations go with it.  The real kills, in
processes, are ``test_torch_recovery_procs.py``.
"""

import json
import threading
import types

import pytest

import spark_tpu.parallel.hostshuffle as RH
import spark_tpu_torch.parallel.hostshuffle as TH
from spark_tpu_torch import config as C
from spark_tpu_torch.memory import HostMemoryLedger
from spark_tpu_torch.parallel import crossproc as X

IMPLS = {"jax": RH, "torch": TH}


def _svc(H, root, pid, n, **kw):
    kw.setdefault("timeout_s", 3.0)
    kw.setdefault("poll_s", 0.02)
    return H.HostShuffleService(str(root), pid, n, **kw)


def _round(services, xid, epoch, lost):
    """Every service's ``recover_round`` at once (threads); returns the
    exception each raised, or None.  The dead (the pids none of
    ``services`` holds) are blacklisted first, as their stale heartbeats
    would have them; ``lost`` is what each survivor names."""
    errs = [None] * len(services)
    n = services[0].n
    for svc in services:
        for p in set(range(n)) - {s.pid for s in services}:
            svc.blacklist[p] = "heartbeat-dead"

    def run(i, svc):
        try:
            svc.recover_round(xid, epoch, set(lost[i]))
        except Exception as e:          # noqa: BLE001 — compared below
            errs[i] = e

    ts = [threading.Thread(target=run, args=(i, s))
          for i, s in enumerate(services)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in ts)
    return errs


def _state(svc):
    live = svc.live_pids()
    return {"recovered": sorted(svc.recovered_pids), "epoch": svc.epoch,
            "live": live, "adopt": dict(sorted(svc.recovery_adopt.items())),
            "owners": [svc.group_owner(g) for g in range(len(live))],
            "rounds": svc.counters["recovery_rounds"],
            "blacklisted": sorted(svc.blacklist)}


#: (n processes, survivors, each survivor's observed loss, epoch)
CASES = [
    (3, [0, 1], [{2}, {2}], 1),
    (3, [0, 1], [{2}, set()], 1),          # one observer suffices
    (4, [0, 2], [{1}, {3}], 1),            # the union of the observations
    (5, [1, 3, 4], [{0, 2}, {2}, {0}], 2),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_recover_round_matches_reference(tmp_path, case):
    n, survivors, lost, epoch = CASES[case]
    states = {}
    for key, H in IMPLS.items():
        svcs = [_svc(H, tmp_path / key, p, n) for p in survivors]
        assert _round(svcs, "xq000009", epoch, lost) == [None] * len(svcs)
        got = [_state(s) for s in svcs]
        assert all(g == dict(got[0], blacklisted=g["blacklisted"])
                   for g in got)
        states[key] = got
    assert states["jax"] == states["torch"]
    dead = sorted(set(range(n)) - set(survivors))
    assert states["torch"][0]["recovered"] == dead
    assert states["torch"][0]["epoch"] == epoch


def test_round_manifests_are_the_reference_bytes(tmp_path):
    """The round's marker is the same JSON keys and values in both
    packages (only the wall-clock ``ts`` differs)."""
    docs = {}
    for key, H in IMPLS.items():
        svc = _svc(H, tmp_path / key, 0, 1)
        svc.recover_round("xq000003", 1, set())
        with open(svc._done("xq000003-recover1", 0)) as f:
            docs[key] = json.load(f)
        docs[key].pop("ts")
    assert docs["jax"] == docs["torch"] == {
        "host": "host-0", "blocks": {}, "epoch": 1, "lost": []}


@pytest.mark.parametrize("torch_pid", [0, 1])
def test_mixed_world_round_agrees(tmp_path, torch_pid):
    """A 3-process world whose two survivors are one service of each
    package: the round agrees on the same lost set, epoch and adopter."""
    svcs = [_svc(TH if p == torch_pid else RH, tmp_path, p, 3)
            for p in (0, 1)]
    assert _round(svcs, "xq000011", 1, [{2}, set()]) == [None, None]
    a, b = (_state(s) for s in svcs)
    assert a == b
    assert a["recovered"] == [2] and a["live"] == [0, 1]
    assert a["adopt"] == {2: 0} and a["epoch"] == 1


@pytest.mark.parametrize("key", sorted(IMPLS))
def test_recover_round_divergence_aborts_structured(tmp_path, key):
    """A peer that neither takes part nor is named lost: no consistent
    live set exists, so the round aborts non-recoverable."""
    svc0 = _svc(IMPLS[key], tmp_path, 0, 2, timeout_s=0.5)
    svc0.blacklist[1] = "test: excluded but never agreed"
    with pytest.raises(IMPLS[key].ExchangeFetchFailed,
                       match="diverged") as ei:
        svc0.recover_round("xq000008", 1, set())
    assert ei.value.recoverable is False
    assert "host-1" in ei.value.lost_hosts
    assert svc0.recovered_pids == set() and svc0.epoch == 0


@pytest.mark.parametrize("key", sorted(IMPLS))
def test_recover_round_ghost_self_abort(tmp_path, key):
    """A process its peers declared lost aborts instead of re-executing
    as a ghost."""
    svc0 = _svc(IMPLS[key], tmp_path, 0, 2)
    svc1 = _svc(IMPLS[key], tmp_path, 1, 2)
    svc1.publish_manifest("xq000007-recover1", {"epoch": 1, "lost": [0]})
    with pytest.raises(IMPLS[key].ExchangeFetchFailed,
                       match="declared lost") as ei:
        svc0.recover_round("xq000007", 1, set())
    assert ei.value.recoverable is False
    assert svc0.host_name(0) in ei.value.lost_hosts


def test_agreed_lost_sender_is_skipped_at_fetch(tmp_path):
    """After the round, an agreed-lost sender is neither waited for nor
    counted as a loss: its partitions belong to the survivors now."""
    svc0, svc1 = (_svc(TH, tmp_path, p, 3) for p in (0, 1))
    assert _round([svc0, svc1], "xq000001", 1, [{2}, {2}]) == [None, None]
    from spark_tpu_torch.columnar import ColumnBatch
    import numpy as np

    def b(v):
        return ColumnBatch.from_arrays({"v": np.array(v, np.int64)})
    out = {}

    def run(svc, vals):
        out[svc.pid] = svc.exchange("xq000001e1-x", {0: [b(vals)],
                                                     1: [b(vals)],
                                                     2: [b(vals)]})
    ts = [threading.Thread(target=run, args=(s, [s.pid]))
          for s in (svc0, svc1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=20)
    for pid in (0, 1):
        got = sorted(int(x) for bb in out[pid]
                     for x in np.asarray(bb.column("v").data))
        assert got == [0, 1]
        assert [svc0, svc1][pid].counters["blocks_lost"] == 0


def test_epoch_abort_releases_ledger_prefix():
    ledger = HostMemoryLedger(budget=1 << 20)
    ledger.reserve("shuffle:xq5:jL-map", 1000, exchange="xq5-jL")
    ledger.reserve("shuffle:xq5e1:jL-fetch", 500, exchange="xq5e1-jL")
    ledger.reserve("shuffle:xq6:jL-map", 300, exchange="xq6-jL")
    assert ledger.release_prefix("shuffle:xq5") == 1500
    assert ledger.used == 300
    assert ledger.release_prefix("shuffle:xq5") == 0


def test_recover_epoch_expires_leases_and_counts(tmp_path):
    """``_recover_epoch`` on the one survivor of two: the lost host is
    agreed, the dead epoch's reservations are released, the dead peer's
    block-service lease is expired (never its blocks), and the counters
    move as the JAX package's do."""
    conf = C.Conf().set("spark.tpu.blockserver.enabled", "true")
    svc = _svc(TH, tmp_path, 0, 2, conf=conf)
    store = svc.blockclient.store
    store.touch_lease("host-1")
    svc.ledger.reserve("shuffle:xq000004:jL", 4096)
    err = TH.ExchangeFetchFailed("xq000004-jL", ["host-1"],
                                 ["s0001-r0000.part"])
    X._recover_epoch(svc, "xq000004", 1, err)
    assert svc.recovered_pids == {1} and svc.epoch == 1
    assert svc.ledger.used == 0
    assert not store.lease_fresh("host-1", __import__("time").time())
    assert svc.counters["stage_retries"] == 1
    assert svc.counters["recovered_partitions"] == 1
    assert X.decision_inputs(svc, "hash")["epoch"] == 1
    assert svc.live_pids() == [0] and svc.group_owner(0) == 0


def test_adopt_lost_leaves_refuses_without_lineage(tmp_path):
    """No recipes (the peer died before the digest round), or a lost
    partition held in memory: a non-recoverable failure naming the lost
    host, never a silently partial result."""
    svc = _svc(TH, tmp_path, 0, 2)
    svc.recovered_pids = {1}
    with pytest.raises(TH.ExchangeFetchFailed, match="recipes") as ei:
        X._adopt_lost_leaves(None, types.SimpleNamespace(children=()), svc)
    assert ei.value.recoverable is False and ei.value.lost_hosts == ["host-1"]
    svc.last_leaf_flags = [True]
    svc.leaf_recipes = {0: [{"kind": "local"}], 1: [{"kind": "local"}]}
    with pytest.raises(TH.ExchangeFetchFailed, match="no file recipe"):
        X._adopt_lost_leaves(None, types.SimpleNamespace(children=()), svc)


def test_max_stage_retries_default_matches_reference():
    from spark_tpu import config as RC
    assert C.RECOVERY_MAX_STAGE_RETRIES.default \
        == RC.RECOVERY_MAX_STAGE_RETRIES.default == 1
