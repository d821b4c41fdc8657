"""The port's fault injector (``spark_tpu_torch/parallel/faults.py``) and
the fault paths of its host shuffle, case by case beside the JAX
package's ``tests/test_faults.py``.

Every case runs twice, once on each package (``impl``), with the same
inputs and the same assertions: transient drops, truncations,
corruptions and delays heal through the retrying reader; a permanent
drop fails structured and bounded; a dead peer is excluded and stays
blacklisted while a dead but committed one loses nothing; a skipped
commit keeps the barrier loud; a full spill disk fails bounded, never
with a torn append.  Then what is the port's own: a plan written by
either package parses in the other, and a kind whose module is not
ported raises naming its slice instead of arming nothing.
"""

import os
import time
import types

import numpy as np
import pytest

import spark_tpu.columnar as RCol
import spark_tpu.config as RC
import spark_tpu.parallel.cluster as RCl
import spark_tpu.parallel.faults as RF
import spark_tpu.parallel.hostshuffle as RH
import spark_tpu_torch.columnar as TCol
import spark_tpu_torch.config as TC
import spark_tpu_torch.parallel.cluster as TCl
import spark_tpu_torch.parallel.faults as TF
import spark_tpu_torch.parallel.hostshuffle as TH

IMPLS = {
    "jax": types.SimpleNamespace(Col=RCol, C=RC, Cl=RCl, F=RF, H=RH),
    "torch": types.SimpleNamespace(Col=TCol, C=TC, Cl=TCl, F=TF, H=TH),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _batch(impl, vals):
    return impl.Col.ColumnBatch.from_arrays(
        {"v": np.asarray(vals, np.int64)})


def _sbatch(impl, words):
    return impl.Col.ColumnBatch.from_arrays({"s": list(words)})


def _values(batches):
    return sorted(int(x) for b in batches
                  for x, ok in zip(np.asarray(b.column("v").data),
                                   np.asarray(b.row_valid_or_true()))
                  if ok)


def _swords(batches):
    return sorted(w for b in batches for (w,) in b.to_pylist()
                  if w is not None)


def _pair(impl, root, **kw):
    """Two services on one root (pids 0 and 1), test-speed retries."""
    args = dict(timeout_s=5.0, poll_s=0.02, max_retries=8,
                retry_wait_s=0.05, attempt_timeout_s=1.0)
    args.update(kw)
    return (impl.H.HostShuffleService(str(root), 0, 2, **args),
            impl.H.HostShuffleService(str(root), 1, 2, **args))


# ---------------------------------------------------------------------------
# transient faults heal, permanent loss is structured
# ---------------------------------------------------------------------------

def test_delayed_block_retried_to_success(impl, tmp_path):
    svc0, svc1 = _pair(impl, tmp_path)
    impl.F.FaultInjector(impl.F.FaultPlan().delay(0.25, exchange="e")) \
        .attach(svc1)
    svc1.put("e", 0, [_batch(impl, [7, 8])])
    svc1.commit("e")
    got = svc0.exchange("e", {0: [_batch(impl, [1])],
                              1: [_batch(impl, [2])]})
    assert _values(got) == [1, 7, 8]
    assert svc0.counters["block_retries"] > 0
    assert svc0.counters["blocks_lost"] == 0


@pytest.mark.parametrize("kind", ["truncate", "corrupt", "drop"])
def test_perturbed_block_heals(impl, tmp_path, kind):
    """A truncated, corrupted (same size: only the wire checksum sees
    it) or dropped block that heals later is retried to success."""
    svc0, svc1 = _pair(impl, tmp_path)
    plan = getattr(impl.F.FaultPlan(), kind)(exchange="e",
                                             heal_after_s=0.25)
    inj = impl.F.FaultInjector(plan).attach(svc1)
    svc1.put("e", 0, [_batch(impl, [51, 52])])
    svc1.commit("e")
    got = svc0.exchange("e", {0: [_batch(impl, [1])],
                              1: [_batch(impl, [2])]})
    assert _values(got) == [1, 51, 52]
    assert svc0.counters["block_retries"] > 0
    assert svc0.counters["blocks_lost"] == 0
    assert inj.injected == [f"{kind}:e/s1-r0"]


def test_permanent_drop_fails_structured_and_bounded(impl, tmp_path):
    svc0, svc1 = _pair(impl, tmp_path, timeout_s=3.0, max_retries=2)
    impl.F.FaultInjector(impl.F.FaultPlan().drop(exchange="e")).attach(svc1)
    svc1.put("e", 0, [_batch(impl, [9])])
    svc1.commit("e")
    t0 = time.monotonic()
    with pytest.raises(impl.H.ExchangeFetchFailed) as ei:
        svc0.exchange("e", {0: [], 1: []})
    assert time.monotonic() - t0 < 2 * 3.0
    assert ei.value.lost_hosts == ["host-1"]
    assert ei.value.lost_blocks == ["s0001-r0000.part"]
    assert svc0.counters["blocks_lost"] == 1
    assert svc0.counters["fetch_failures"] == 1


def test_dict_sidecar_dropped_then_heals(impl, tmp_path):
    svc1 = impl.H.HostShuffleService(str(tmp_path), 1, 2, timeout_s=5.0,
                                     poll_s=0.02, max_retries=8,
                                     retry_wait_s=0.05)
    svc1.put("e", 0, [_sbatch(impl, ["ash", "oak", "ash"])])
    svc1.commit("e")
    dpath = svc1._dict_path("e", 1)
    good = open(dpath, "rb").read()
    os.remove(dpath)

    def heal(_wait):
        with open(dpath, "wb") as f:
            f.write(good)

    svc0 = impl.H.HostShuffleService(str(tmp_path), 0, 2, timeout_s=5.0,
                                     poll_s=0.02, max_retries=8,
                                     retry_wait_s=0.05, sleep=heal)
    got = svc0.exchange("e", {0: [_sbatch(impl, ["fir"])], 1: []})
    assert _swords(got) == ["ash", "ash", "fir", "oak"]
    assert svc0.counters["block_retries"] > 0


def test_dict_sidecar_permanently_lost_fails_bounded(impl, tmp_path):
    svc0, svc1 = _pair(impl, tmp_path, timeout_s=3.0, max_retries=2)
    svc1.put("e", 0, [_sbatch(impl, ["lost", "words"])])
    svc1.commit("e")
    os.remove(svc1._dict_path("e", 1))
    t0 = time.monotonic()
    with pytest.raises(impl.H.ExchangeFetchFailed) as ei:
        svc0.exchange("e", {0: [], 1: []})
    assert time.monotonic() - t0 < 2 * 3.0
    assert ei.value.lost_hosts == ["host-1"]


# ---------------------------------------------------------------------------
# dead peers: exclusion, blacklist, committed output survives
# ---------------------------------------------------------------------------

def _stale_peer_heartbeat(impl, tmp_path):
    """A monitor for host-0 that sees host-1's only beat as stale."""
    conf = (impl.C.Conf()
            .set("spark.tpu.cluster.heartbeatIntervalMs", "50")
            .set("spark.tpu.cluster.heartbeatTimeoutMs", "100"))
    beats = str(tmp_path / "beats")
    impl.Cl.HeartbeatMonitor(beats, host_id="host-1", conf=conf,
                             clock=time.time).beat()
    hb0 = impl.Cl.HeartbeatMonitor(beats, host_id="host-0", conf=conf,
                                   clock=time.time)
    time.sleep(0.15)
    return hb0


def test_dead_peer_excluded_and_blacklist_persists(impl, tmp_path):
    hb0 = _stale_peer_heartbeat(impl, tmp_path)
    svc0 = impl.H.HostShuffleService(
        str(tmp_path / "shuf"), 0, 2, timeout_s=5.0, poll_s=0.02,
        heartbeat=hb0, max_retries=1, retry_wait_s=0.02)
    t0 = time.monotonic()
    with pytest.raises(impl.H.ExchangeFetchFailed) as ei:
        svc0.exchange("e1", {0: [_batch(impl, [1])],
                             1: [_batch(impl, [2])]})
    assert time.monotonic() - t0 < 2.5
    assert ei.value.lost_hosts == ["host-1"]
    assert svc0.blacklist == {1: "heartbeat-dead during 'e1'"}
    t0 = time.monotonic()
    with pytest.raises(impl.H.ExchangeFetchFailed):
        svc0.exchange("e2", {0: [_batch(impl, [3])],
                             1: [_batch(impl, [4])]})
    assert time.monotonic() - t0 < 1.0
    assert svc0.counters["fetch_failures"] == 2


def test_dead_but_committed_peer_is_recovered(impl, tmp_path):
    """A peer that COMMITTED before dying loses nothing."""
    hb0 = _stale_peer_heartbeat(impl, tmp_path)
    root = str(tmp_path / "shuf")
    svc1 = impl.H.HostShuffleService(root, 1, 2, timeout_s=5.0)
    svc1.put("e", 0, [_batch(impl, [41, 42])])
    svc1.commit("e")
    svc0 = impl.H.HostShuffleService(root, 0, 2, timeout_s=5.0,
                                     poll_s=0.02, heartbeat=hb0)
    got = svc0.exchange("e", {0: [_batch(impl, [1])],
                              1: [_batch(impl, [2])]})
    assert _values(got) == [1, 41, 42]
    assert svc0.counters["blocks_lost"] == 0


def test_refetch_recovers_republished_blocks(impl, tmp_path):
    svc0, svc1 = _pair(impl, tmp_path, timeout_s=2.0, max_retries=1,
                       retry_wait_s=0.02)
    impl.F.FaultInjector(impl.F.FaultPlan().drop(exchange="e")).attach(svc1)
    svc1.put("e", 0, [_batch(impl, [11, 12])])
    svc1.commit("e")
    per = {0: [_batch(impl, [1])], 1: [_batch(impl, [2])]}
    with pytest.raises(impl.H.ExchangeFetchFailed):
        svc0.exchange("e", per)
    svc1.put("e", 0, [_batch(impl, [11, 12])])
    got = svc0.refetch("e", per)
    assert _values(got) == [1, 11, 12]
    assert svc0.counters["refetches"] == 1


# ---------------------------------------------------------------------------
# injector plumbing
# ---------------------------------------------------------------------------

def test_skip_commit_keeps_barrier_loud(impl, tmp_path):
    svc0, svc1 = _pair(impl, tmp_path, timeout_s=0.3)
    impl.F.FaultInjector(impl.F.FaultPlan().skip_commit(exchange="e")) \
        .attach(svc1)
    svc1.put("e", 0, [_batch(impl, [1])])
    svc1.commit("e")                     # suppressed by the fault
    svc0.commit("e")
    with pytest.raises(TimeoutError, match=r"senders \[1\]"):
        svc0.barrier("e")


def test_disk_full_fails_spill_writes_after_budget(impl, tmp_path):
    svc = impl.H.HostShuffleService(str(tmp_path), 0, 1, timeout_s=5.0)
    inj = impl.F.FaultInjector(
        impl.F.FaultPlan().disk_full(after_bytes=150)).attach(svc)
    path = str(tmp_path / "run.spill")
    svc.spill_write(path, b"x" * 100)
    assert svc.counters["spill_bytes"] == 100
    with pytest.raises(OSError) as ei:
        svc.spill_write(path, b"x" * 100, append=True)
    assert ei.value.errno == 28
    with pytest.raises(OSError):           # a full disk stays full
        svc.spill_write(path, b"x" * 10, append=True)
    assert svc.counters["spill_bytes"] == 100
    assert any(f.startswith("disk_full:") for f in inj.injected)
    assert os.path.getsize(path) == 100    # no torn partial append


def test_disk_full_during_map_side_spill(impl, tmp_path):
    """``disk_full`` during an exchange side's spill: the spill of its
    partition frames raises ENOSPC, structured, and nothing is
    published."""
    svc = impl.H.HostShuffleService(str(tmp_path / "shuf"), 0, 1,
                                    timeout_s=5.0)
    impl.F.FaultInjector(impl.F.FaultPlan().disk_full(
        after_bytes=0, exchange="x")).attach(svc)
    slices = [_batch(impl, [1, 2, 3]), _batch(impl, [4, 5])]
    with pytest.raises(OSError) as ei:
        svc.spill_map_partitions("x", slices, str(tmp_path / "side.spill"))
    assert ei.value.errno == 28
    assert svc.counters["spill_events"] == 0
    assert not os.path.exists(svc._done("x", 0))


def test_die_after_put_and_manifest_go_through_die(tmp_path):
    """The planned deaths in-process, on the port: ``die_after_manifest``
    and ``die_after_put`` (with the commit-first flag) call the
    injector's kill primitive at the planned point, so a test can put a
    raiser there (the JAX package calls ``os._exit`` directly for these
    two kinds; its subprocess workers cover them)."""
    impl = IMPLS["torch"]
    svc0, svc1 = _pair(impl, tmp_path)
    died = []
    inj = TF.FaultInjector(TF.FaultPlan().die_after_manifest("m"))
    inj.die = died.append
    inj.attach(svc1)
    svc1.publish_manifest("m", {"k": 1})
    assert died == [43] and inj.injected == ["die_after_manifest:m"]
    assert svc1.read_manifest("m", 1)["k"] == 1
    inj2 = TF.FaultInjector(
        TF.FaultPlan().die_after_put("e", commit_first=True))
    inj2.die = died.append
    inj2.attach(svc0)
    svc0.put("e", 1, [_batch(impl, [3])])
    assert died == [43, 43] and inj2.injected == ["die_after_put:e"]
    assert os.path.exists(svc0._done("e", 0))       # committed first


# ---------------------------------------------------------------------------
# plans across the process boundary, and across the two packages
# ---------------------------------------------------------------------------

def _ported_plan(F):
    return (F.FaultPlan().drop(exchange="a", receiver=1)
            .truncate(heal_after_s=0.5, keep_bytes=3)
            .corrupt(exchange="d", heal_after_s=0.1)
            .delay(0.2, exchange="b")
            .skip_commit(exchange="s")
            .die_after_put(exchange="c", commit_first=True)
            .die_after_manifest("xq000001-gather")
            .disk_full(after_bytes=4096, exchange="e")
            .die_during_register("xq000001-jR", after_seal=True)
            .blockserver_unavailable(heal_after_s=1.5)
            .spawn_exec_error(after_spawns=1)
            .skew_decision("xq000001-plan", side="l"))


@pytest.mark.parametrize("writer,reader", [(RF, TF), (TF, RF), (TF, TF)])
def test_fault_plan_env_roundtrip_both_packages(writer, reader):
    """A plan of every ported kind, written by one package, parses in the
    other rule for rule (the same JSON form)."""
    plan = _ported_plan(writer)
    env = {writer.FAULT_PLAN_ENV: plan.to_env()}
    assert RF.FAULT_PLAN_ENV == TF.FAULT_PLAN_ENV == "SPARK_TPU_FAULT_PLAN"
    back = reader.FaultPlan.from_env(env)
    assert [r.to_dict() for r in back.rules] \
        == [r.to_dict() for r in plan.rules]
    assert reader.FaultPlan.from_env({}).rules == []


@pytest.mark.parametrize("kind", ["skew_decision"])
def test_waiting_kinds_raise_naming_their_slice(kind):
    """The last kind that waited for its module (``skew_decision``, whose
    fault point came with the analysis package) now parses rule for rule
    from the JAX package's plan, and no kind waits any more: the port's
    kinds are the JAX package's."""
    rplan = RF.FaultPlan()
    rplan.rules.append(RF._Rule(kind, "xq000001-plan", side="l"))
    back = TF.FaultPlan.from_env({TF.FAULT_PLAN_ENV: rplan.to_env()})
    assert [r.to_dict() for r in back.rules] \
        == [r.to_dict() for r in rplan.rules]
    assert kind in TF._KINDS
    assert TF.WAITING_KINDS == {}
    assert set(TF._KINDS) == set(RF._KINDS)


def test_counters_visible_via_session_metrics(tmp_path):
    """The port's shuffle source carries the recovery and block-service
    gauges beside the exchange counters."""
    from spark_tpu_torch.sql.session import SparkSession
    s = SparkSession(TC.Conf({"spark.torch.device": "cpu"}))
    svc = s.enableHostShuffle(str(tmp_path), process_id=0, n_processes=1,
                              timeout_s=5.0)
    svc.exchange("e", {0: [_batch(IMPLS["torch"], [1])]})
    svc.blacklist[7] = "test"
    snap = s.metricsSystem.snapshots()["shuffle"]
    assert snap["exchanges"] == 1 and snap["blacklist"] == "host-7"
    assert snap["epoch"] == 0 and snap["recovery_ms"] == 0.0
    assert snap["recovered_peers"] == "" and snap["stage_retries"] == 0
    assert snap["blockserver_enabled"] == 0
