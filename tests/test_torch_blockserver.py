"""The port's block service (``spark_tpu_torch/parallel/blockserver.py``)
beside the JAX package's ``tests/test_blockserver.py``.

The store's mechanics run on both packages with the same inputs and the
same assertions (``impl``): stage, seal and adopt round trips, size-
checked restores, the degrading client, the register-gap deaths and the
down service, and the TTL reaper.  Then the two packages together: the
reaper reclaims the SAME files from two copies of one tree with set file
times, ``lease_fresh`` answers alike through heir chains, a registration
sealed by either package's service is adopted by the other's, and the
copy fallback of ``_place`` (no hard link across file systems) is byte
for byte.  Last the port's wiring: a service with the block service on
stages and seals at commit, and an ``SQLServer`` runs the reaper while
it is started.
"""

import json
import os
import shutil
import time
import types

import numpy as np
import pytest

import spark_tpu.columnar as RCol
import spark_tpu.config as RC
import spark_tpu.parallel.blockserver as RB
import spark_tpu.parallel.faults as RF
import spark_tpu.parallel.hostshuffle as RH
import spark_tpu_torch.columnar as TCol
import spark_tpu_torch.config as TC
import spark_tpu_torch.parallel.blockserver as TB
import spark_tpu_torch.parallel.faults as TF
import spark_tpu_torch.parallel.hostshuffle as TH

TTL = 120.0
IMPLS = {
    "jax": types.SimpleNamespace(B=RB, C=RC, F=RF, H=RH, Col=RCol),
    "torch": types.SimpleNamespace(B=TB, C=TC, F=TF, H=TH, Col=TCol),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _store(impl, root, ttl=TTL, now=None):
    """A store over ``root`` with a settable clock (file times stay real
    wall-clock, so the base is ``time.time()``)."""
    conf = impl.C.Conf()
    conf.set("spark.tpu.blockserver.orphanTtlSeconds", str(int(ttl)))
    now = now if now is not None else [time.time()]
    return impl.B.BlockStore(str(root), conf=conf,
                             clock=lambda: now[0]), now


def _publish(tmp_path, store, exchange="xq000042-jL", sender=0,
             owner="host-0", dict_bytes=0, seal=True):
    """A live sender's publish: block files, staged, then sealed."""
    src = tmp_path / "live" / exchange
    os.makedirs(src, exist_ok=True)
    blocks = {}
    for r, payload in enumerate((b"alpha-rows", b"beta-rows!!")):
        name = f"s{sender:04d}-r{r:04d}.part"
        (src / name).write_bytes(payload)
        store.stage_block(exchange, name, str(src / name))
        blocks[str(r)] = len(payload)
    man = {"ts": 1.0, "host": owner, "blocks": blocks}
    if dict_bytes:
        name = f"s{sender:04d}.dict"
        (src / name).write_bytes(b"d" * dict_bytes)
        store.stage_block(exchange, name, str(src / name))
        man["dict_bytes"] = dict_bytes
    if seal:
        store.seal(exchange, sender, man, owner)
    return man


# ---------------------------------------------------------------------------
# registration mechanics, both packages
# ---------------------------------------------------------------------------

def test_stage_seal_adopt_roundtrip(impl, tmp_path):
    store, _now = _store(impl, tmp_path / "shuf")
    man = _publish(tmp_path, store, dict_bytes=7)
    dest = str(tmp_path / "adopted")
    got = store.adopt("xq000042-jL", 0, dest)
    assert got is not None and got["restored"] == 3
    assert open(os.path.join(dest, "s0000-r0000.part"), "rb").read() \
        == b"alpha-rows"
    with open(os.path.join(dest, "s0000.done")) as f:
        marker = json.load(f)
    assert marker["blocks"] == man["blocks"] and "owner" not in marker
    again = store.adopt("xq000042-jL", 0, dest)
    assert again is not None and again["restored"] == 0


def test_adopt_refuses_unsealed_and_incomplete(impl, tmp_path):
    store, _now = _store(impl, tmp_path / "shuf")
    _publish(tmp_path, store, exchange="xq000001-jL", seal=False)
    assert store.adopt("xq000001-jL", 0, str(tmp_path / "d1")) is None
    store.seal("xq000002-jL", 0, {"blocks": {"0": 10, "1": 999}}, "host-0")
    assert store.adopt("xq000002-jL", 0, str(tmp_path / "d2")) is None
    assert not os.path.exists(str(tmp_path / "d2" / "s0000.done"))


def test_restore_block_verifies_size(impl, tmp_path):
    store, _now = _store(impl, tmp_path / "shuf")
    _publish(tmp_path, store)
    dest = str(tmp_path / "r0000.part")
    assert store.restore_block("xq000042-jL", "s0000-r0000.part", dest,
                               expect_size=len(b"alpha-rows"))
    assert open(dest, "rb").read() == b"alpha-rows"
    assert not store.restore_block("xq000042-jL", "s0000-r0000.part",
                                   str(tmp_path / "x"), expect_size=5)
    assert not store.restore_block("xq000042-jL", "s0099-r0000.part",
                                   str(tmp_path / "y"))
    assert not os.path.exists(str(tmp_path / "x"))


def test_release_exchange_drops_custody(impl, tmp_path):
    store, _now = _store(impl, tmp_path / "shuf")
    _publish(tmp_path, store)
    assert store.stats()["exchangesHeld"] == 1
    store.release_exchange("xq000042-jL")
    assert store.stats()["exchangesHeld"] == 0
    assert store.adopt("xq000042-jL", 0, str(tmp_path / "d")) is None


def test_unavailable_store_raises_and_client_degrades(impl, tmp_path):
    store, _now = _store(impl, tmp_path / "shuf")
    _publish(tmp_path, store)
    events = []
    client = impl.B.BlockServiceClient(
        store, owner="host-0", on_event=lambda name, n=1: events.append(name))
    store.available = False
    with pytest.raises(impl.B.BlockServerUnavailable):
        store.seal("xq000042-jL", 1, {"blocks": {}}, "host-1")
    assert client.stage_block("xq000042-jL", "s0001-r0000.part",
                              str(tmp_path / "nope")) is False
    assert client.seal("xq000042-jL", 1, {"blocks": {}}) is False
    assert client.adopt("xq000042-jL", 0, str(tmp_path / "d")) is None
    assert client.restore_block("xq000042-jL", "s0000-r0000.part",
                                str(tmp_path / "r")) is False
    assert client.handoff("host-0") is False
    assert events == ["blockserver_unavailable"] * 5
    store.available = True
    assert client.adopt("xq000042-jL", 0, str(tmp_path / "d")) is not None


class _Kill(BaseException):
    """In-process stand-in for the injector's hard exit."""


def _armed_store(impl, tmp_path, plan):
    store, _now = _store(impl, tmp_path / "shuf")
    client = impl.B.BlockServiceClient(store, owner="host-1")
    svc = types.SimpleNamespace(put=lambda *a: None, commit=lambda *a: None,
                                blockclient=client)
    inj = impl.F.FaultInjector(plan)
    inj.die = lambda code: (_ for _ in ()).throw(_Kill(code))
    inj.attach(svc)
    return store, inj


def test_die_during_register_before_seal(impl, tmp_path):
    store, inj = _armed_store(
        impl, tmp_path, impl.F.FaultPlan().die_during_register("xq000001-jL"))
    with pytest.raises(_Kill):
        store.seal("xq000001-jL", 1, {"blocks": {}}, "host-1")
    assert store.sealed_manifest("xq000001-jL", 1) is None
    assert inj.injected == ["die_during_register:xq000001-jL:pre"]


def test_die_during_register_after_seal_is_adoptable(impl, tmp_path):
    store, inj = _armed_store(
        impl, tmp_path, impl.F.FaultPlan().die_during_register(
            "xq000001-jL", after_seal=True))
    src = tmp_path / "blk.part"
    src.write_bytes(b"payload")
    store.stage_block("xq000001-jL", "s0001-r0000.part", str(src))
    with pytest.raises(_Kill):
        store.seal("xq000001-jL", 1, {"blocks": {"0": 7}}, "host-1")
    got = store.adopt("xq000001-jL", 1, str(tmp_path / "dest"))
    assert got is not None and got["restored"] == 1
    assert inj.injected == ["die_during_register:xq000001-jL:post"]
    store.seal("xq000002-jL", 1, {"blocks": {}}, "host-1")   # once only


def test_blockserver_unavailable_fault_heals_on_timer(impl, tmp_path):
    store, inj = _armed_store(
        impl, tmp_path,
        impl.F.FaultPlan().blockserver_unavailable(heal_after_s=0.15))
    assert store.available is False
    assert inj.injected == ["blockserver_unavailable"]
    deadline = time.time() + 5.0
    while not store.available and time.time() < deadline:
        time.sleep(0.02)
    assert store.available is True
    store.seal("xq000001-jL", 1, {"blocks": {}}, "host-1")


# ---------------------------------------------------------------------------
# the TTL reaper, both packages
# ---------------------------------------------------------------------------

def test_gc_reclaims_exchange_only_after_owner_silence(impl, tmp_path):
    store, now = _store(impl, tmp_path / "shuf")
    _publish(tmp_path, store, owner="host-0")
    assert store.gc(roots=()) == 0
    now[0] += TTL + 1
    assert store.gc(roots=()) == 3                  # 2 parts + the seal
    assert store.stats()["exchangesHeld"] == 0
    assert store.reclaimed_total() == 3


def test_gc_spares_stale_exchange_while_owner_lease_fresh(impl, tmp_path):
    store, now = _store(impl, tmp_path / "shuf")
    _publish(tmp_path, store, owner="host-0")
    now[0] += TTL + 1
    os.utime(store._lease_path("host-0"), (now[0], now[0]))
    assert store.gc(roots=()) == 0


def test_gc_state_needs_explicit_release_plus_ttl(impl, tmp_path):
    store, now = _store(impl, tmp_path / "shuf")
    ckpt = tmp_path / "ckpt"
    os.makedirs(ckpt)
    (ckpt / "0.delta").write_bytes(b"state")
    store.register_state("stream-abc", str(ckpt), "stream-abc")
    now[0] += 100 * TTL                  # a crashed owner: never reaped
    assert store.gc(roots=()) == 0 and os.path.isdir(str(ckpt))
    store.release_state("stream-abc", "stream-abc")
    rec = store._state_rec("stream-abc")
    os.utime(rec, (now[0] - TTL - 1, now[0] - TTL - 1))
    assert store.gc(roots=()) == 1
    assert not os.path.exists(str(ckpt))


def test_gc_raw_root_sweep_only_touches_block_dirs(impl, tmp_path):
    store, now = _store(impl, tmp_path / "shuf")
    root = str(tmp_path / "shuf")
    dead = os.path.join(root, "xq000001-jL")
    os.makedirs(dead)
    open(os.path.join(dead, "s0000-r0000.part"), "wb").write(b"x")
    open(os.path.join(dead, "s0000.done"), "w").write("{}")
    mixed = os.path.join(root, "leaves")
    os.makedirs(mixed)
    open(os.path.join(mixed, "notes.txt"), "w").write("keep me")
    now[0] += TTL + 1
    assert store.gc(roots=(root,)) == 2
    assert not os.path.exists(dead)
    assert os.path.exists(os.path.join(mixed, "notes.txt"))
    assert os.path.isdir(store.dir)


def test_blockserver_reaper_lifecycle(impl, tmp_path):
    store, now = _store(impl, tmp_path / "shuf")
    _publish(tmp_path, store)
    now[0] += TTL + 1
    server = impl.B.BlockServer(store, interval_s=3600.0, roots=())
    assert server.run_gc() == 3
    assert server.stats()["gcRuns"] == 1
    store.available = False
    assert server.run_gc() == 0
    server.stop()


# ---------------------------------------------------------------------------
# the two packages on one tree
# ---------------------------------------------------------------------------

def _tree(tmp_path, base):
    """A store tree with every case the reaper decides: stale exchanges of
    silent owners, of an owner with a fresh lease, of an owner whose
    heir is fresh, an unsealed stale staging, a fresh exchange, state
    records released or not, a raw exchange dir, a foreign dir, and a
    cold heir sidecar.  File times are SET relative to ``base``."""
    root = tmp_path / "tree" / "shuf"
    store, _now = _store(IMPLS["torch"], root, now=[base])
    old = base - 2 * TTL
    for i, owner in enumerate(["host-0", "host-1", "host-2", "host-3"]):
        _publish(tmp_path / f"src{i}", store, exchange=f"xq00000{i}-jL",
                 sender=i, owner=owner)
    _publish(tmp_path / "src9", store, exchange="xq000009-jR", sender=9,
             owner="host-9", seal=False)
    store.handoff_lease("host-2", "pool-supervisor")
    store.handoff_lease("host-3", "pool-cold")
    ckpt_a, ckpt_b = tmp_path / "tree" / "ck_a", tmp_path / "tree" / "ck_b"
    for ck in (ckpt_a, ckpt_b):
        os.makedirs(ck)
        (ck / "0.delta").write_bytes(b"s")
    store.register_state("a", str(ckpt_a), "sa")
    store.register_state("b", str(ckpt_b), "sb")
    store.release_state("b", "sb")
    raw = root / "xq000077-gather"
    os.makedirs(raw)
    (raw / "s0000-r0000.part").write_bytes(b"x")
    (raw / "s0000.done").write_text("{}")
    foreign = root / "leaves"
    os.makedirs(foreign)
    (foreign / "a.parquet").write_bytes(b"p")
    # every file old, then the fresh ones fresh
    for d, _dirs, files in os.walk(tmp_path / "tree"):
        for f in files:
            os.utime(os.path.join(d, f), (old, old))
    leases = os.path.join(store.dir, "leases")
    for fresh in ("host-1", "pool-supervisor"):
        os.utime(os.path.join(leases, fresh), (base, base))
    os.makedirs(store._xdir("xq000008-jL"))
    p = os.path.join(store._xdir("xq000008-jL"), "s0008-r0000.part")
    open(p, "wb").write(b"new")
    os.utime(p, (base, base))
    return tmp_path / "tree"


def _files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _dirs, fs in os.walk(top) for f in fs)


def test_gc_reclaims_the_same_files_as_the_reference(tmp_path):
    base = time.time()
    tree = _tree(tmp_path, base)
    twin = tmp_path / "twin"
    shutil.copytree(tree, twin)             # copy2 keeps the file times
    # a state record names its directory by absolute path: the twin's
    # name the twin's (file times kept)
    sdir = twin / "shuf" / "_blockstore" / "state"
    for name in os.listdir(sdir):
        p = sdir / name
        st = os.stat(p)
        rec = json.loads(p.read_text())
        rec["path"] = rec["path"].replace(str(tree), str(twin))
        p.write_text(json.dumps(rec))
        os.utime(p, (st.st_atime, st.st_mtime))
    assert _files(tree) == _files(twin)
    out = {}
    for key, top in (("jax", twin), ("torch", tree)):
        store, _now = _store(IMPLS[key], top / "shuf", now=[base])
        n = store.gc(roots=(str(top / "shuf"),))
        out[key] = (n, _files(top), store.reclaimed_total())
    assert out["jax"] == out["torch"]
    n, left, _total = out["torch"]
    assert n > 0
    assert any("xq000001-jL" in f for f in left)   # fresh lease
    assert any("xq000002-jL" in f for f in left)   # fresh heir
    assert not any("xq000000-jL" in f for f in left)
    assert not any("xq000003-jL" in f for f in left)   # heir cold
    assert any("xq000077-gather" in f for f in left)   # leases live
    assert any("a.parquet" in f for f in left)


@pytest.mark.parametrize("age", [0.0, TTL - 1, TTL + 1, 10 * TTL])
def test_lease_fresh_through_heirs_matches_reference(tmp_path, age):
    """A chain a → b → c → d → e → f (deeper than ``MAX_HEIR_DEPTH``)
    and a cycle x ↔ y: each owner's freshness, with only the chain's
    end or a middle lease touched, is the same in both packages."""
    now = time.time()
    answers = {}
    for key in ("jax", "torch"):
        root = tmp_path / key
        store, _n = _store(IMPLS[key], root, now=[now])
        chain = ["a", "b", "c", "d", "e", "f"]
        for owner, heir in zip(chain, chain[1:]):
            store.handoff_lease(owner, heir)
        store.handoff_lease("x", "y")
        store.handoff_lease("y", "x")
        leases = os.path.join(store.dir, "leases")
        for name in os.listdir(leases):
            if not name.endswith(".heir"):
                t = now - 2 * TTL
                os.utime(os.path.join(leases, name), (t, t))
        for fresh in ("f", "c"):
            t = now - age
            os.utime(os.path.join(leases, fresh), (t, t))
        for owner in ("a", "b", "d"):
            store.release_lease(owner)
        answers[key] = {o: store.lease_fresh(o, now)
                        for o in chain + ["x", "y", "nobody"]}
    assert answers["jax"] == answers["torch"]
    if age <= TTL:
        assert answers["torch"]["a"] and answers["torch"]["d"]
    else:
        assert not answers["torch"]["a"]
    assert answers["torch"]["nobody"] is False


def _svc(impl, root, pid, **kw):
    conf = impl.C.Conf().set("spark.tpu.blockserver.enabled", "true")
    return impl.H.HostShuffleService(str(root), pid, 2, conf=conf,
                                     timeout_s=3.0, poll_s=0.02,
                                     max_retries=1, retry_wait_s=0.02, **kw)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_registration_adopted_across_packages(tmp_path, writer, reader):
    """Sender 1 (one package) registers its output and dies after
    sealing, before its marker lands; sender 0 (the other package)
    excludes it at the barrier and ADOPTS the sealed output: the rows
    arrive with no re-execution."""
    w, r = IMPLS[writer], IMPLS[reader]
    svc1 = _svc(w, tmp_path, 1)
    words = w.Col.ColumnBatch.from_arrays(
        {"v": np.arange(5, dtype=np.int64),
         "s": ["ash", "oak", "ash", "fir", "elm"]})
    svc1.put("e", 0, [words])
    svc1.commit("e")
    assert svc1.blockclient.store.sealed_manifest("e", 1) is not None
    os.remove(svc1._done("e", 1))                   # the marker never landed
    os.remove(svc1._part("e", 1, 0))
    svc0 = _svc(r, tmp_path, 0)
    svc0.blacklist[1] = "test: dead"
    got = svc0.exchange("e", {0: []})
    rows = sorted(t for b in got for t in b.to_pylist())
    assert rows == sorted(zip(range(5), ["ash", "oak", "ash", "fir", "elm"]))
    assert svc0.counters["manifests_adopted"] == 1
    assert svc0.counters["blocks_adopted"] >= 1


def test_lost_block_restored_from_the_store(tmp_path):
    """A committed peer's block vanishes after its retries are spent:
    the port restores it from the block service and reads it once more
    (``blockserver_fallback_reads``), as the JAX package does."""
    out = {}
    for key in ("jax", "torch"):
        impl = IMPLS[key]
        root = tmp_path / key
        svc1 = _svc(impl, root, 1)
        impl.F.FaultInjector(impl.F.FaultPlan().drop(
            exchange="e", receiver=0)).attach(svc1)
        svc1.put("e", 0, [impl.Col.ColumnBatch.from_arrays(
            {"v": np.array([3, 4], np.int64)})])
        svc1.commit("e")
        svc0 = _svc(impl, root, 0)
        got = svc0.exchange("e", {0: []})
        out[key] = (sorted(int(x) for b in got
                           for x in np.asarray(b.column("v").data)),
                    svc0.counters["blockserver_fallback_reads"],
                    svc0.counters["blocks_adopted"])
    assert out["jax"] == out["torch"] == ([3, 4], 1, 1)


def test_place_copy_fallback_is_byte_exact(tmp_path, monkeypatch):
    """Across file systems ``os.link`` fails and the store copies: the
    copy is the same bytes, through tmp and rename."""
    src = tmp_path / "blk.part"
    payload = bytes(range(256)) * 1000
    src.write_bytes(payload)

    def no_link(a, b):
        raise OSError(18, "Invalid cross-device link")
    monkeypatch.setattr(os, "link", no_link)
    dest = tmp_path / "copy.part"
    TB.BlockStore._place(str(src), str(dest))
    assert dest.read_bytes() == payload
    assert os.stat(src).st_ino != os.stat(dest).st_ino
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


# ---------------------------------------------------------------------------
# the port's wiring
# ---------------------------------------------------------------------------

def test_service_stages_seals_and_releases(tmp_path):
    svc = _svc(IMPLS["torch"], tmp_path, 0)
    store = svc.blockclient.store
    svc.put("e", 1, [TCol.ColumnBatch.from_arrays(
        {"s": ["a", "b"], "v": np.array([1, 2], np.int64)})])
    svc.commit("e")
    man = store.sealed_manifest("e", 0)
    assert man["owner"] == "host-0" and set(man["blocks"]) == {"1"}
    assert sorted(os.listdir(store._xdir("e"))) == [
        "s0000-r0001.part", "s0000.dict", "s0000.reg"]
    assert svc.counters["manifests_registered"] == 1
    assert svc.counters["blocks_registered"] == 1
    assert svc.metrics_source().snapshot()["blockserver_enabled"] == 1
    svc.cleanup("e")
    assert not os.path.exists(store._xdir("e"))


def test_server_runs_the_reaper_while_started(tmp_path):
    from spark_tpu_torch.server import SQLServer
    from spark_tpu_torch.sql.session import SparkSession
    s = SparkSession(TC.Conf({"spark.torch.device": "cpu",
                              "spark.tpu.blockserver.enabled": "true",
                              "spark.tpu.blockserver.gcIntervalSeconds":
                                  "3600"}))
    s.enableHostShuffle(str(tmp_path / "shuf"), process_id=0,
                        n_processes=1, timeout_s=5.0)
    srv = SQLServer(s, port=0).start()
    try:
        assert srv._blockserver is not None
        st = srv._status()
        assert st["blockStore"]["available"] == 1
        assert st["admission"]["blockStore"]["leases"] >= 0
        assert srv._blockserver.run_gc() == 0
    finally:
        srv.stop()
    assert srv._blockserver is None
