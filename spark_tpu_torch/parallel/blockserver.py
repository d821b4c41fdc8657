"""The block service: committed shuffle and spill files survive the
process that wrote them.

The port of ``spark_tpu/parallel/blockserver.py`` (the external shuffle
service's role, ``ExternalShuffleBlockResolver``).  Every exchange block
lives in a directory a worker process writes, so a worker's death loses
the bytes and lineage recovery re-executes the lost map work.  On a
shared filesystem the service needs no RPC plane, only an OWNERSHIP
boundary:

``BlockStore``
    The durable area ``<root>/_blockstore/`` and its rules.  Workers
    hard-link (byte-copy across file systems) every block they publish
    into the store at write time and SEAL a per-sender registration
    record, an fsynced JSON manifest, at commit.  A sealed sender's
    output can be ADOPTED (re-registered into the live exchange dir,
    commit marker last) by any survivor; an unsealed one degrades to
    plain lineage recovery.  The store alone deletes: owners renew
    per-owner leases at every seal, and a TTL reaper (``gc``) reclaims
    exchanges whose owners all went silent, plus orphaned raw exchange
    dirs under swept shuffle roots.  Registered state dirs are reclaimed
    only after an EXPLICIT release plus the TTL.

``BlockServiceClient``
    The degrading access path workers use: every call traps
    ``BlockServerUnavailable`` and ``OSError`` and reports a structured
    no-op (None/False), so a down service costs a fallback to
    peer-direct reads and lineage recovery, never a hang.

``BlockServer``
    The serving tier's lifecycle wrapper: the reaper thread ``SQLServer``
    runs while started.

The layout is the JAX package's (``.reg`` records, lease files, heir
sidecars), so a store either package wrote is read and adopted by the
other.  Block BYTES inherit the publisher's tmp+rename atomicity (a
hard link shares the inode); the store fsyncs only its own registration
records, and a torn seal reads as "never registered".
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .. import config as C

__all__ = [
    "BlockServerUnavailable", "BlockStore", "BlockServiceClient",
    "BlockServer",
]


class BlockServerUnavailable(OSError):
    """The block service cannot be reached (down, or fault-injected
    down).  Raised by ``BlockStore`` when ``available`` is cleared;
    ``BlockServiceClient`` converts it into a structured degraded
    no-op — callers fall back to peer-direct reads."""

    def __init__(self, op: str):
        super().__init__(f"block service unavailable during {op!r}")
        self.op = op


#: filenames the store recognizes as wire-format exchange artifacts —
#: the sweep patterns of the raw-root orphan reaper (a directory holding
#: anything else is NOT an exchange dir and is never touched)
_EXCHANGE_FILE_RE = re.compile(
    r"^s\d{4}(-r\d{4})?\.(part|done|dict|reg)(\.tmp\..+)?$")

#: subdirectories of the shuffle root the raw sweep must never enter
#: even when their contents look block-like
_SWEEP_SKIP = ("_blockstore",)


class BlockStore:
    """The durable block area under one shuffle root, plus its
    ownership/lease/GC rules.  Pure filesystem state — every process
    sharing the root constructs its own ``BlockStore`` over the same
    directories, exactly like the exchange dirs themselves."""

    def __init__(self, root: str, conf: Optional[C.Conf] = None,
                 clock: Callable[[], float] = time.time):
        conf = conf or C.Conf()
        self.root = root
        self.dir = os.path.join(root, "_blockstore")
        self.ttl_s = float(conf.get(C.BLOCKSERVER_ORPHAN_TTL))
        self._clock = clock
        self._lock = threading.Lock()
        #: cleared by fault injection (``blockserver_unavailable``) or a
        #: dead service mount: every entry point raises
        #: ``BlockServerUnavailable`` so clients degrade structured
        self.available = True
        #: fault seam: called as ``hook(exchange, sender, phase)`` with
        #: phase "pre" right before the registration record is written
        #: and "post" right after — ``faults.die_during_register`` lands
        #: a worker death on either side of the seal
        self._register_hook: Optional[Callable[[str, int, str], None]] = None
        for sub in ("exchanges", "leases", "state"):
            os.makedirs(os.path.join(self.dir, sub), exist_ok=True)

    # -- availability ----------------------------------------------------
    def _check(self, op: str) -> None:
        if not self.available:
            raise BlockServerUnavailable(op)

    # -- layout ----------------------------------------------------------
    def _xdir(self, exchange: str) -> str:
        return os.path.join(self.dir, "exchanges", exchange)

    def _reg_path(self, exchange: str, sender: int) -> str:
        return os.path.join(self._xdir(exchange), f"s{sender:04d}.reg")

    def _lease_path(self, owner: str) -> str:
        return os.path.join(self.dir, "leases", owner)

    def _state_rec(self, key: str) -> str:
        return os.path.join(self.dir, "state", f"{key}.reg")

    def _counter_path(self) -> str:
        return os.path.join(self.dir, "reclaimed.count")

    @staticmethod
    def _place(src: str, dest: str) -> None:
        """Materialize ``src`` under ``dest`` atomically: hard-link when
        the filesystem allows (same inode, no byte copied), byte copy
        otherwise; tmp + rename either way so readers never observe a
        partial file."""
        tmp = f"{dest}.tmp.{os.getpid()}"
        try:
            os.link(src, tmp)
        except OSError:
            shutil.copyfile(src, tmp)
        os.replace(tmp, dest)

    def _write_json(self, path: str, doc: dict, fsync: bool = True) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- registration (exchange side) ------------------------------------
    def stage_block(self, exchange: str, name: str, src: str) -> None:
        """Take custody of one published block file (data block, spilled
        frame, or dict sidecar) under its exchange.  Staging is cheap
        (a hard link) and UNSEALED — until ``seal`` lands, staged bytes
        are invisible to adoption and reclaimable as orphans."""
        self._check("stage")
        d = self._xdir(exchange)
        os.makedirs(d, exist_ok=True)
        self._place(src, os.path.join(d, name))

    def seal(self, exchange: str, sender: int, manifest: dict,
             owner: str) -> None:
        """The registration commit point: fsync the sender's manifest as
        a ``.reg`` record.  Everything the manifest names must already be
        staged — ``adopt`` verifies sizes against it and refuses a seal
        whose bytes are incomplete (a crash between stage and seal)."""
        self._check("seal")
        os.makedirs(self._xdir(exchange), exist_ok=True)
        if self._register_hook is not None:
            self._register_hook(exchange, sender, "pre")
        doc = dict(manifest)
        doc["owner"] = owner
        self._write_json(self._reg_path(exchange, sender), doc)
        if self._register_hook is not None:
            self._register_hook(exchange, sender, "post")
        self.touch_lease(owner)

    def sealed_manifest(self, exchange: str, sender: int) -> Optional[dict]:
        """The sender's sealed registration record, or None (unsealed,
        torn, or reclaimed — all read as "never registered")."""
        try:
            with open(self._reg_path(exchange, sender)) as f:
                man = json.load(f)
            return man if isinstance(man, dict) else None
        except (OSError, ValueError):
            return None

    def restore_block(self, exchange: str, name: str, dest: str,
                      expect_size: Optional[int] = None) -> bool:
        """Re-materialize one held block at ``dest``.  False when the
        store never took custody of it or holds the wrong size (the
        store protects against LOSS of the exchange-dir name, not
        against in-place bit rot of a shared inode)."""
        self._check("restore")
        src = os.path.join(self._xdir(exchange), name)
        try:
            size = os.path.getsize(src)
        except OSError:
            return False
        if expect_size is not None and size != int(expect_size):
            return False
        self._place(src, dest)
        return True

    def adopt(self, exchange: str, sender: int,
              dest_dir: str) -> Optional[dict]:
        """Re-register a SEALED sender's whole exchange output into the
        live exchange dir: every manifested block, the dict sidecar if
        one was sealed, and the commit marker LAST — the same publish
        ordering readers rely on from a live sender.  Idempotent and
        race-safe across adopting survivors (atomic per-file renames,
        identical content).  Returns ``{"manifest", "restored"}`` or
        None when the seal is absent or its bytes incomplete."""
        self._check("adopt")
        man = self.sealed_manifest(exchange, sender)
        if man is None:
            return None
        src_dir = self._xdir(exchange)
        blocks: List[Tuple[str, int]] = []
        for r, sz in (man.get("blocks") or {}).items():
            blocks.append((f"s{sender:04d}-r{int(r):04d}.part", int(sz)))
        if man.get("dict_bytes"):
            blocks.append((f"s{sender:04d}.dict", int(man["dict_bytes"])))
        for name, sz in blocks:
            try:
                if os.path.getsize(os.path.join(src_dir, name)) != sz:
                    return None
            except OSError:
                return None
        os.makedirs(dest_dir, exist_ok=True)
        restored = 0
        for name, _sz in blocks:
            dest = os.path.join(dest_dir, name)
            if not os.path.exists(dest):
                self._place(os.path.join(src_dir, name), dest)
                restored += 1
        marker = os.path.join(dest_dir, f"s{sender:04d}.done")
        if not os.path.exists(marker):
            pub = {k: v for k, v in man.items() if k != "owner"}
            self._write_json(marker, pub, fsync=False)
        return {"manifest": man, "restored": restored}

    def release_exchange(self, exchange: str) -> None:
        """Owner-side eager release (statement cleanup): the store drops
        its copies without waiting for the TTL reaper."""
        shutil.rmtree(self._xdir(exchange), ignore_errors=True)

    # -- leases ----------------------------------------------------------
    def touch_lease(self, owner: str) -> None:
        self._check("lease")
        p = self._lease_path(owner)
        with open(p, "a"):
            pass
        os.utime(p, None)

    def release_lease(self, owner: str) -> None:
        try:
            os.remove(self._lease_path(owner))
        except OSError:
            pass

    #: heir chains longer than this read as cold — a bound, not a
    #: design point; real chains are one hop (reaped worker -> pool
    #: supervisor) and the bound only guards a cyclic sidecar from
    #: looping the freshness check
    MAX_HEIR_DEPTH = 4

    def handoff_lease(self, owner: str, heir: str) -> None:
        """The scale-down-safety seam: BEFORE a reaped worker's lease
        may be released, its ownership is handed to ``heir`` (the pool
        supervisor) via an fsynced sidecar, so every sealed block the
        owner registered stays adoptable — ``lease_fresh(owner)`` keeps
        answering True for as long as the heir's own lease is fresh.
        Crash ordering: the sidecar lands (rename-atomic) before the
        caller releases the owner lease; a crash between the two leaves
        BOTH records, which is merely conservative."""
        self._check("lease")
        self.touch_lease(heir)
        p = self._lease_path(owner) + ".heir"
        tmp = p + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"heir": heir, "ts": self._clock()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def _heir_of(self, owner: str) -> Optional[str]:
        try:
            with open(self._lease_path(owner) + ".heir") as f:
                rec = json.load(f)
            heir = rec.get("heir") if isinstance(rec, dict) else None
            return heir if isinstance(heir, str) and heir else None
        except (OSError, ValueError):
            return None

    def lease_fresh(self, owner: str, now: float,
                    _depth: int = 0) -> bool:
        try:
            if now - os.path.getmtime(self._lease_path(owner)) \
                    <= self.ttl_s:
                return True
        except OSError:
            pass
        if _depth >= self.MAX_HEIR_DEPTH:
            return False
        heir = self._heir_of(owner)
        if heir is not None and heir != owner:
            return self.lease_fresh(heir, now, _depth + 1)
        return False

    # -- state-dir ownership (streaming checkpoints) ---------------------
    def register_state(self, key: str, path: str, owner: str) -> None:
        """Register ownership of a state/checkpoint directory.  ``key``
        must be stable across worker restarts (the caller derives it
        from the checkpoint PATH, not from any per-process id) so a
        rolling restart re-registers the same record."""
        self._check("register_state")
        self._write_json(self._state_rec(key),
                         {"path": os.path.abspath(path), "owner": owner,
                          "ts": self._clock()})
        self.touch_lease(owner)

    def state_record(self, key: str) -> Optional[dict]:
        try:
            with open(self._state_rec(key)) as f:
                rec = json.load(f)
            return rec if isinstance(rec, dict) else None
        except (OSError, ValueError):
            return None

    def release_state(self, key: str, owner: str) -> None:
        """EXPLICIT ownership release (query stop): drop the lease and
        restamp the record so the reaper's release+TTL clock starts
        now.  The state dir itself is only ever deleted by ``gc``."""
        self.release_lease(owner)
        try:
            os.utime(self._state_rec(key), None)
        except OSError:
            pass

    # -- orphan reaper ---------------------------------------------------
    def _owners_of(self, xdir: str) -> List[str]:
        owners = []
        try:
            names = os.listdir(xdir)
        except OSError:
            return owners
        for name in names:
            if not name.endswith(".reg"):
                continue
            try:
                with open(os.path.join(xdir, name)) as f:
                    rec = json.load(f)
                if isinstance(rec, dict) and rec.get("owner"):
                    owners.append(str(rec["owner"]))
            except (OSError, ValueError):
                pass
        return owners

    @staticmethod
    def _dir_stats(d: str) -> Tuple[int, float]:
        """(file count, newest mtime) of a directory tree."""
        count, newest = 0, 0.0
        for base, _dirs, files in os.walk(d):
            for name in files:
                count += 1
                try:
                    newest = max(newest,
                                 os.path.getmtime(os.path.join(base, name)))
                except OSError:
                    pass
        return count, newest

    def _reap_dir(self, d: str) -> int:
        n, _newest = self._dir_stats(d)
        shutil.rmtree(d, ignore_errors=True)
        return n

    def gc(self, now: Optional[float] = None,
           roots: Tuple[str, ...] = ()) -> int:
        """One reaper pass; returns files reclaimed (and accumulates the
        persistent ``orphaned_blocks_reclaimed`` total).

        Reclaims, in order: store-held exchanges whose every sealing
        owner's lease went stale past the TTL (or unsealed staging
        equally stale); registered state dirs whose ownership was
        EXPLICITLY released at least a TTL ago; and raw exchange dirs
        under ``roots`` — directories holding nothing but wire-format
        block files, all older than the TTL, with no live lease anywhere
        (a dead session's exchange dirs, which previously leaked disk
        forever)."""
        if not self.available:
            return 0
        if now is None:
            now = self._clock()
        reclaimed = 0
        xroot = os.path.join(self.dir, "exchanges")
        try:
            held = sorted(os.listdir(xroot))
        except OSError:
            held = []
        for x in held:
            d = os.path.join(xroot, x)
            if not os.path.isdir(d):
                continue
            count, newest = self._dir_stats(d)
            if count and now - newest <= self.ttl_s:
                continue
            owners = self._owners_of(d)
            if any(self.lease_fresh(o, now) for o in owners):
                continue
            reclaimed += self._reap_dir(d)
        sroot = os.path.join(self.dir, "state")
        try:
            recs = sorted(os.listdir(sroot))
        except OSError:
            recs = []
        for name in recs:
            if not name.endswith(".reg"):
                continue
            rec_path = os.path.join(sroot, name)
            try:
                with open(rec_path) as f:
                    rec = json.load(f)
                released_ts = os.path.getmtime(rec_path)
            except (OSError, ValueError):
                continue
            owner = str(rec.get("owner", ""))
            if os.path.exists(self._lease_path(owner)) \
                    or self._heir_of(owner) is not None:
                # lease present — live, or crashed-with-stale-lease —
                # or ownership handed off to a live heir.  Either way
                # the checkpoint survives: only an explicit release
                # (which removes the lease) starts the clock.
                continue
            if now - released_ts <= self.ttl_s:
                continue
            path = str(rec.get("path", ""))
            if path and os.path.isdir(path):
                reclaimed += self._reap_dir(path)
            try:
                os.remove(rec_path)
            except OSError:
                pass
        for root in roots:
            try:
                names = sorted(os.listdir(root))
            except OSError:
                continue
            for name in names:
                if name in _SWEEP_SKIP:
                    continue
                d = os.path.join(root, name)
                if not os.path.isdir(d):
                    continue
                try:
                    entries = os.listdir(d)
                except OSError:
                    continue
                if not entries or not all(
                        _EXCHANGE_FILE_RE.match(e) for e in entries):
                    continue
                _count, newest = self._dir_stats(d)
                if now - newest <= self.ttl_s:
                    continue
                if any(self.lease_fresh(o, now)
                       for o in self._owners_of(d) + self._live_owners()):
                    continue
                reclaimed += self._reap_dir(d)
        # heir sidecars whose whole succession chain has gone cold
        # protect nothing — drop them so a reaped worker's record does
        # not outlive the supervisor that inherited it
        try:
            names = sorted(
                os.listdir(os.path.join(self.dir, "leases")))
        except OSError:
            names = []
        for name in names:
            if not name.endswith(".heir"):
                continue
            owner = name[:-len(".heir")]
            if not self.lease_fresh(owner, now):
                try:
                    os.remove(os.path.join(self.dir, "leases", name))
                except OSError:
                    pass
        if reclaimed:
            self._bump_reclaimed(reclaimed)
        return reclaimed

    def _live_owners(self) -> List[str]:
        # heir sidecars live in the leases dir but are NOT owners —
        # ``<owner>.heir`` names a succession record, not a tenant
        try:
            return [n for n in
                    os.listdir(os.path.join(self.dir, "leases"))
                    if not n.endswith(".heir")]
        except OSError:
            return []

    # -- persistent reclaim counter --------------------------------------
    def reclaimed_total(self) -> int:
        """Lifetime files reclaimed by the reaper over this store — kept
        in the store itself so the gauge survives worker restarts and is
        visible from every process sharing the root."""
        try:
            with open(self._counter_path()) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _bump_reclaimed(self, n: int) -> None:
        """Add ``n`` to the store's counter file.  The read-modify-write
        holds an exclusive ``flock`` on the store directory — one bump at
        a time across threads AND the processes sharing the root (the
        in-process lock serialized threads only), and no file I/O under
        ``self._lock``; the layout is unchanged."""
        import fcntl
        fd = os.open(self.dir, os.O_RDONLY)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            total = self.reclaimed_total() + int(n)
            tmp = f"{self._counter_path()}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(str(total))
            os.replace(tmp, self._counter_path())
        finally:
            os.close(fd)                # closing releases the flock

    # -- observability ---------------------------------------------------
    def stats(self) -> Dict[str, int]:
        def _count(sub: str) -> int:
            try:
                return len(os.listdir(os.path.join(self.dir, sub)))
            except OSError:
                return 0
        return {
            "available": int(self.available),
            "exchangesHeld": _count("exchanges"),
            "leases": len(self._live_owners()),
            "stateRegistrations": _count("state"),
            "orphanedBlocksReclaimed": self.reclaimed_total(),
        }


class BlockServiceClient:
    """Degrading client: the worker-side access path to a ``BlockStore``.

    Every method traps ``BlockServerUnavailable`` and filesystem errors
    and reports a structured no-op (None/False) after invoking
    ``on_event("blockserver_unavailable")`` — the contract the
    ``blockserver_unavailable`` fault kind tests: a down service costs
    peer-direct fallback and lineage recovery, never a hang."""

    def __init__(self, store: BlockStore, owner: str,
                 on_event: Optional[Callable[..., None]] = None):
        self.store = store
        self.owner = owner
        self._on_event = on_event or (lambda name, n=1: None)

    def _guard(self, op: str, fn, default=None):
        try:
            return fn()
        except (BlockServerUnavailable, OSError):
            self._on_event("blockserver_unavailable")
            return default

    def stage_block(self, exchange: str, name: str, src: str) -> bool:
        return self._guard(
            "stage",
            lambda: (self.store.stage_block(exchange, name, src), True)[1],
            default=False)

    def seal(self, exchange: str, sender: int, manifest: dict) -> bool:
        return self._guard(
            "seal",
            lambda: (self.store.seal(exchange, sender, manifest,
                                     self.owner), True)[1],
            default=False)

    def adopt(self, exchange: str, sender: int,
              dest_dir: str) -> Optional[dict]:
        return self._guard(
            "adopt", lambda: self.store.adopt(exchange, sender, dest_dir))

    def restore_block(self, exchange: str, name: str, dest: str,
                      expect_size: Optional[int] = None) -> bool:
        return self._guard(
            "restore",
            lambda: self.store.restore_block(exchange, name, dest,
                                             expect_size),
            default=False)

    def release_exchange(self, exchange: str) -> None:
        self._guard("release",
                    lambda: self.store.release_exchange(exchange))

    def register_state(self, key: str, path: str,
                       owner: Optional[str] = None) -> bool:
        return self._guard(
            "register_state",
            lambda: (self.store.register_state(key, path,
                                               owner or self.owner),
                     True)[1],
            default=False)

    def release_state(self, key: str, owner: Optional[str] = None) -> None:
        self._guard(
            "release_state",
            lambda: self.store.release_state(key, owner or self.owner))

    def touch_owner(self, owner: Optional[str] = None) -> None:
        self._guard("lease",
                    lambda: self.store.touch_lease(owner or self.owner))

    def expire_owner(self, owner: str) -> None:
        """Drop a (confirmed-dead) owner's lease so the reaper may
        reclaim its unreleased registrations after the TTL.  Called from
        the recovery round AFTER peers agreed the owner is lost — a
        survivor never deletes blocks directly, it only expires the
        lease and lets the service's clock run."""
        self._guard("expire", lambda: self.store.release_lease(owner))

    def handoff(self, owner: str, heir: Optional[str] = None) -> bool:
        """Scale-down succession: hand ``owner``'s lease to ``heir``
        (default: this client's own identity) BEFORE expiring it, so a
        reaped worker's sealed output stays adoptable — the invariant
        the pool supervisor's reap path rides.  Returns False (after
        the structured degrade event) when the service is down; the
        caller then must NOT expire the lease, since nothing inherited
        it."""
        return self._guard(
            "handoff",
            lambda: (self.store.handoff_lease(owner,
                                              heir or self.owner),
                     True)[1],
            default=False)


class BlockServer:
    """Service lifecycle for the serving tier: a ``BlockStore`` plus the
    periodic orphan reaper.  ``SQLServer`` starts one while it serves
    (elastic worker reap/spawn leaves orphans only the service may
    delete) and stops it with the server."""

    def __init__(self, store: BlockStore, interval_s: float = 60.0,
                 roots: Tuple[str, ...] = ()):
        self.store = store
        self.interval_s = float(interval_s)
        self.roots = tuple(roots)
        self.gc_runs = 0
        self.last_reclaimed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None or self.interval_s <= 0:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="blockserver-reaper")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.run_gc()

    def run_gc(self) -> int:
        try:
            n = self.store.gc(roots=self.roots)
        except (BlockServerUnavailable, OSError):
            return 0
        self.gc_runs += 1
        self.last_reclaimed = n
        return n

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def stats(self) -> Dict[str, int]:
        out = dict(self.store.stats())
        out["gcRuns"] = self.gc_runs
        out["lastReclaimed"] = self.last_reclaimed
        return out
