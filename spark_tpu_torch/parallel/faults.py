"""Deterministic fault injection for the host shuffle's data plane.

The port of ``spark_tpu/parallel/faults.py``.  The exchange protocol is
plain files (``hostshuffle.py``), so every distributed failure mode
reduces to a file-level perturbation a test can inject exactly.

``FaultInjector.attach(svc)`` wraps a ``HostShuffleService``'s write
side; rules fire when a matching block or marker is published:

- ``drop``      the published block vanishes; with ``heal_after_s`` it
                reappears later (list-after-write eventual consistency,
                the case the retrying reader exists for).
- ``truncate``  the block is cut short (a torn write); may heal later.
- ``corrupt``   the last payload byte is flipped in place: the size is
                unchanged, so only the wire checksum can tell; may heal.
- ``delay``     the block stays invisible for a window, then appears.
- ``skip_commit``  the sender publishes blocks but never its commit
                marker (killed between put and commit).
- ``die_after_put``  the PROCESS exits hard right after publishing a
                block (a peer killed mid-exchange).
- ``die_after_manifest``  the PROCESS exits hard right after its commit
                marker or manifest for the addressed exchange lands.
- ``disk_full``  spill writes (``svc.spill_write``) raise
                ``OSError(ENOSPC)`` once this process has spilled
                ``after_bytes`` bytes; the paths must fail BOUNDED.
- ``die_during_register``  the PROCESS exits hard mid-registration with
                the block service (``blockserver.py``): before the
                ``.reg`` record is sealed (``after_seal=False``: plain
                lineage recovery), or after it with the exchange marker
                unwritten (``after_seal=True``: the adoption window).
- ``blockserver_unavailable``  the block service is DOWN for this
                process: every client call degrades to a structured
                no-op; ``heal_after_s`` brings it back on a timer.
- ``spawn_exec_error``  the pool supervisor's exec seam raises
                ``OSError(ENOEXEC)`` after ``after_spawns`` good spawns
                (``attach_pool``).
- ``ici_unavailable``  the device tier (``ici.device_publish``) raises
                ``IciUnavailable`` at its attempt point for the addressed
                exchange: this sender's spans fold back onto the host
                tier (``dcn_fallback_exchanges``), byte-identical, and
                its receivers read them there.
- ``die_mid_device_copy``  the PROCESS exits hard at the device tier's
                copy point: spans packed, arena and sidecar not yet
                written.  Peers see the death at the host commit barrier
                and take the refetch → recovery ladder.
- ``torn_checkpoint``  a streaming commit entry is cut to ``keep_bytes``
                right after its rename (``attach_stream``); with ``die``
                the process then exits hard.  The checksum makes the
                entry read as uncommitted and the batch replays.
- ``die_after_state_commit``  the PROCESS exits hard between a
                micro-batch's state commit and its sink write.
- ``skew_decision``  THIS process's gathered view of a stats round
                (``gather_sizes_ex``) has one side's observed totals
                replaced by ``[1, 1]`` per sender; the manifests on disk
                stay byte-identical for every peer, so the armed process
                alone re-derives its adaptive decision from divergent
                inputs (the replica-determinism fault the decision-trace
                check of ``analysis.runtime`` exists for).

Every kind of the JAX package is ported: ``WAITING_KINDS`` (kinds whose
fault point is in a module still to port, which raise when a plan names
them rather than silently arming nothing) is empty.

Rules are matched by (exchange, receiver) for this service's own writes;
healing runs on daemon timers.  ``FaultPlan`` carries rules across a
process boundary through ``SPARK_TPU_FAULT_PLAN`` (a JSON list, the JAX
package's form: a plan either package writes parses in the other).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence

__all__ = ["FaultInjector", "FaultPlan", "FAULT_PLAN_ENV", "WAITING_KINDS"]

FAULT_PLAN_ENV = "SPARK_TPU_FAULT_PLAN"

_KINDS = ("drop", "truncate", "corrupt", "delay", "skip_commit",
          "die_after_put", "die_after_manifest", "disk_full",
          "die_during_register", "blockserver_unavailable",
          "spawn_exec_error", "ici_unavailable", "die_mid_device_copy",
          "torn_checkpoint", "die_after_state_commit", "skew_decision")

#: the JAX package's kinds whose fault points are in modules still to
#: port, by the ROADMAP item that brings them (none are left)
WAITING_KINDS: Dict[str, str] = {}

_BLOCK_KINDS = ("drop", "truncate", "corrupt", "delay")


class _Rule:
    def __init__(self, kind: str, exchange: Optional[str] = None,
                 receiver: Optional[int] = None, once: bool = True,
                 heal_after_s: Optional[float] = None,
                 keep_bytes: int = 16, after_bytes: int = 0,
                 side: str = "r"):
        if kind in WAITING_KINDS:
            raise NotImplementedError(
                f"fault kind {kind!r} fires in a module that is not ported "
                f"yet: it comes with {WAITING_KINDS[kind]}")
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; one of {_KINDS}")
        self.kind = kind
        self.exchange = exchange          # None = any exchange
        self.receiver = receiver          # None = any receiver
        self.once = once
        self.heal_after_s = heal_after_s
        self.keep_bytes = keep_bytes
        self.after_bytes = after_bytes    # disk_full: bytes before ENOSPC
        # die_during_register: pre/post; skew_decision: the side "l"/"r"
        self.side = side
        self.fired = 0

    def matches(self, exchange: str, receiver: Optional[int]) -> bool:
        if self.once and self.fired:
            return False
        if self.exchange is not None and self.exchange != exchange:
            return False
        if self.receiver is not None and receiver is not None \
                and self.receiver != receiver:
            return False
        return True

    def to_dict(self) -> dict:
        return {"kind": self.kind, "exchange": self.exchange,
                "receiver": self.receiver, "once": self.once,
                "heal_after_s": self.heal_after_s,
                "keep_bytes": self.keep_bytes,
                "after_bytes": self.after_bytes, "side": self.side}


class FaultPlan:
    """A serializable bag of fault rules (env-portable for subprocesses)."""

    def __init__(self, rules: Optional[Sequence[_Rule]] = None):
        self.rules: List[_Rule] = list(rules or [])

    def _add(self, *args, **kw) -> "FaultPlan":
        self.rules.append(_Rule(*args, **kw))
        return self

    # -- construction ----------------------------------------------------
    def drop(self, exchange: Optional[str] = None,
             receiver: Optional[int] = None, once: bool = True,
             heal_after_s: Optional[float] = None) -> "FaultPlan":
        return self._add("drop", exchange, receiver, once, heal_after_s)

    def truncate(self, exchange: Optional[str] = None,
                 receiver: Optional[int] = None, once: bool = True,
                 heal_after_s: Optional[float] = None,
                 keep_bytes: int = 16) -> "FaultPlan":
        return self._add("truncate", exchange, receiver, once,
                         heal_after_s, keep_bytes)

    def corrupt(self, exchange: Optional[str] = None,
                receiver: Optional[int] = None, once: bool = True,
                heal_after_s: Optional[float] = None) -> "FaultPlan":
        return self._add("corrupt", exchange, receiver, once, heal_after_s)

    def delay(self, seconds: float, exchange: Optional[str] = None,
              receiver: Optional[int] = None,
              once: bool = True) -> "FaultPlan":
        return self._add("delay", exchange, receiver, once,
                         heal_after_s=seconds)

    def skip_commit(self, exchange: Optional[str] = None,
                    once: bool = True) -> "FaultPlan":
        return self._add("skip_commit", exchange, None, once)

    def die_after_put(self, exchange: Optional[str] = None,
                      commit_first: bool = False) -> "FaultPlan":
        # keep_bytes doubles as the commit-first flag (the JAX package's
        # serialized form)
        return self._add("die_after_put", exchange, None, True,
                         keep_bytes=1 if commit_first else 0)

    def die_after_manifest(self, exchange: Optional[str] = None
                           ) -> "FaultPlan":
        """Exit hard right AFTER the commit marker or manifest for the
        addressed exchange lands: peers see this process as a round
        participant, then it is gone."""
        return self._add("die_after_manifest", exchange, None, True)

    def disk_full(self, after_bytes: int = 0,
                  exchange: Optional[str] = None,
                  once: bool = False) -> "FaultPlan":
        """Spill writes fail with ENOSPC once this process has written
        ``after_bytes`` spill bytes (0 = the first spill write fails).
        ``once=False``: a full disk stays full."""
        return self._add("disk_full", exchange, None, once,
                         after_bytes=after_bytes)

    def die_during_register(self, exchange: Optional[str] = None,
                            after_seal: bool = False) -> "FaultPlan":
        """Exit hard mid-registration with the block service for the
        addressed exchange, before (``after_seal=False``) or after the
        ``.reg`` record is sealed."""
        return self._add("die_during_register", exchange, None, True,
                         side="post" if after_seal else "pre")

    def blockserver_unavailable(self, heal_after_s: Optional[float] = None
                                ) -> "FaultPlan":
        """Take the block service DOWN for this process at attach time;
        ``heal_after_s`` restores it on a daemon timer."""
        return self._add("blockserver_unavailable", None, None, False,
                         heal_after_s=heal_after_s)

    def ici_unavailable(self, exchange: Optional[str] = None,
                        once: bool = True) -> "FaultPlan":
        """The device tier raises ``IciUnavailable`` at its attempt point
        for the addressed exchange (None = every attempt)."""
        return self._add("ici_unavailable", exchange, None, once)

    def die_mid_device_copy(self, exchange: Optional[str] = None
                            ) -> "FaultPlan":
        """Exit hard at the device tier's copy point: spans packed, the
        arena and its sidecar not written."""
        return self._add("die_mid_device_copy", exchange, None, True)

    def torn_checkpoint(self, keep_bytes: int = 16, after_entries: int = 0,
                        once: bool = True, die: bool = False) -> "FaultPlan":
        """Tear a streaming checkpoint COMMIT entry: after the micro-batch
        engine writes commit entry number ``after_entries`` (0 = the very
        first), the just-renamed file is cut to ``keep_bytes`` bytes.
        ``die=True`` also exits the process hard right after tearing (the
        mid-commit kill point); the entry's checksum must make the tear
        read as UNCOMMITTED either way."""
        return self._add("torn_checkpoint", None, None, once,
                         keep_bytes=keep_bytes, after_bytes=after_entries,
                         side="die" if die else "r")

    def die_after_state_commit(self, after_entries: int = 0
                               ) -> "FaultPlan":
        """Exit hard BETWEEN the state-version commit and the sink write
        of streaming micro-batch number ``after_entries``: recovery must
        replay the batch and the idempotent sink must swallow the
        re-emission."""
        return self._add("die_after_state_commit", None, None, once=True,
                         after_bytes=after_entries)

    def skew_decision(self, exchange: Optional[str] = None,
                      side: str = "r", once: bool = True) -> "FaultPlan":
        """Perturb one side's observed totals in THIS process's gathered
        stats round — an in-memory, asymmetric fault: the manifests on
        disk stay byte-identical for every peer, so the armed process
        alone re-derives its adaptive decision from divergent inputs."""
        return self._add("skew_decision", exchange, None, once, side=side)

    def spawn_exec_error(self, after_spawns: int = 0,
                         once: bool = False) -> "FaultPlan":
        """The pool supervisor's exec seam fails with ``OSError`` once
        ``after_spawns`` workers have started.  ``once=False``: a broken
        worker binary stays broken."""
        return self._add("spawn_exec_error", None, None, once,
                         after_bytes=after_spawns)

    # -- env transport ---------------------------------------------------
    def to_env(self) -> str:
        return json.dumps([r.to_dict() for r in self.rules])

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "FaultPlan":
        """The plan in ``SPARK_TPU_FAULT_PLAN``; a rule of a kind whose
        module is not ported raises ``NotImplementedError``."""
        raw = (env if env is not None else os.environ).get(FAULT_PLAN_ENV,
                                                           "")
        if not raw:
            return cls()
        return cls([_Rule(**d) for d in json.loads(raw)])


class FaultInjector:
    """Arms a ``HostShuffleService`` (``attach``) or a pool supervisor
    (``attach_pool``) with a ``FaultPlan``.

    After each real write, matching rules perturb the just-published
    file; healing rules keep the original bytes and restore them on a
    daemon timer.  A planned death calls ``self.die`` (``os._exit``);
    in-process tests put a raiser there."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan if plan is not None else FaultPlan.from_env()
        self.injected: List[str] = []        # what fired, in order
        self._timers: List[threading.Timer] = []
        self.die = lambda code: os._exit(code)

    # -- file perturbations ---------------------------------------------
    def _later(self, delay: float, fn) -> None:
        t = threading.Timer(delay, fn)
        t.daemon = True
        t.start()
        self._timers.append(t)

    def _heal_later(self, path: str, payload: bytes, delay: float) -> None:
        def heal():
            tmp = f"{path}.heal.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
        self._later(delay, heal)

    def _apply(self, rule: _Rule, path: str, label: str) -> None:
        rule.fired += 1
        with open(path, "rb") as f:
            payload = f.read()
        if rule.kind in ("drop", "delay"):
            os.remove(path)
        elif rule.kind == "truncate":
            with open(path, "wb") as f:
                f.write(payload[: rule.keep_bytes])
        elif rule.kind == "corrupt":
            # the LAST byte: size unchanged, frame intact, only the crc32
            # over header and payload notices
            with open(path, "wb") as f:
                f.write(payload[:-1] + bytes([payload[-1] ^ 0xFF]))
        if rule.heal_after_s is not None:
            self._heal_later(path, payload, rule.heal_after_s)
        self.injected.append(f"{rule.kind}:{label}")

    def _die(self, label: str, message: str) -> None:
        self.injected.append(label)
        print(f"[faults] {message}", flush=True)
        self.die(43)

    # -- service wrapping ------------------------------------------------
    def attach(self, svc) -> "FaultInjector":
        orig_put, orig_commit = svc.put, svc.commit
        orig_publish = getattr(svc, "publish_manifest", None)
        orig_spill = getattr(svc, "spill_write", None)
        orig_gather_ex = getattr(svc, "gather_sizes_ex", None)
        rules = self.plan.rules
        spilled_total = [0]

        def put(exchange, receiver, batches):
            orig_put(exchange, receiver, batches)
            flush = getattr(svc, "flush", None)
            if flush is not None:  # async writer: the file must exist first
                flush(exchange)
            path = svc._part(exchange, svc.pid, receiver)
            for rule in rules:
                if rule.kind in _BLOCK_KINDS \
                        and rule.matches(exchange, receiver):
                    self._apply(rule, path,
                                f"{exchange}/s{svc.pid}-r{receiver}")
            for rule in rules:
                if rule.kind == "die_after_put" \
                        and rule.matches(exchange, None):
                    rule.fired += 1
                    if rule.keep_bytes:          # the commit-first flag
                        orig_commit(exchange)
                    self._die(f"die_after_put:{exchange}",
                              f"dying after put in {exchange!r}")

        def die_after_manifest(exchange):
            for rule in rules:
                if rule.kind == "die_after_manifest" \
                        and rule.matches(exchange, None):
                    rule.fired += 1
                    self._die(f"die_after_manifest:{exchange}",
                              f"dying after manifest in {exchange!r}")

        def commit(exchange, extra=None):
            for rule in rules:
                if rule.kind == "skip_commit" \
                        and rule.matches(exchange, None):
                    rule.fired += 1
                    self.injected.append(f"skip_commit:{exchange}")
                    return                        # marker never written
            orig_commit(exchange, extra=extra)
            die_after_manifest(exchange)

        def spill_write(path, data, append=False, exchange=""):
            for rule in rules:
                if rule.kind == "disk_full" \
                        and rule.matches(exchange, None) \
                        and (rule.fired           # a full disk STAYS full
                             or spilled_total[0] + len(data)
                             > rule.after_bytes):
                    rule.fired += 1
                    self.injected.append(f"disk_full:{exchange or path}")
                    raise OSError(28, "No space left on device (injected)")
            spilled_total[0] += len(data)
            orig_spill(path, data, append=append, exchange=exchange)

        def publish_manifest(exchange, payload=None):
            n = orig_publish(exchange, payload)
            # manifest-only rounds bypass put/commit: only rules that
            # ADDRESS this exchange perturb its marker (an any-exchange
            # block rule must not retarget the coordination plane)
            path = svc._done(exchange, svc.pid)
            for rule in rules:
                if rule.kind in _BLOCK_KINDS and rule.exchange is not None \
                        and rule.matches(exchange, None):
                    self._apply(rule, path,
                                f"{exchange}/{os.path.basename(path)}")
            die_after_manifest(exchange)
            return n

        def gather_sizes_ex(exchange, n_partitions):
            totals, mans = orig_gather_ex(exchange, n_partitions)
            # the RETURNED view only: the round's files are untouched, so
            # every peer (and any re-read of the disk bytes) still sees
            # the true totals
            for rule in rules:
                if rule.kind == "skew_decision" \
                        and rule.matches(exchange, None):
                    rule.fired += 1
                    self.injected.append(
                        f"skew_decision:{exchange}:{rule.side}")
                    for man in mans.values():
                        sides = man.get("sides") \
                            if isinstance(man, dict) else None
                        if isinstance(sides, dict) and rule.side in sides:
                            sides[rule.side] = [1, 1]
            return totals, mans

        def ici_fault(exchange, point):
            # consulted by ici.device_publish at its fault points:
            # "attempt" (before any device work) and "copy" (spans
            # packed, arena and sidecar not written)
            for rule in rules:
                if rule.kind == "ici_unavailable" and point == "attempt" \
                        and rule.matches(exchange, None):
                    rule.fired += 1
                    self.injected.append(f"ici_unavailable:{exchange}")
                    from .ici import IciUnavailable
                    raise IciUnavailable(
                        f"injected: device tier unavailable for "
                        f"{exchange!r}")
                if rule.kind == "die_mid_device_copy" and point == "copy" \
                        and rule.matches(exchange, None):
                    rule.fired += 1
                    self._die(f"die_mid_device_copy:{exchange}",
                              f"dying mid device copy in {exchange!r}")

        svc._ici_fault = ici_fault
        svc.put = put
        svc.commit = commit
        if orig_publish is not None:
            svc.publish_manifest = publish_manifest
        if orig_spill is not None:
            svc.spill_write = spill_write
        if orig_gather_ex is not None:
            svc.gather_sizes_ex = gather_sizes_ex

        # -- block-service faults (blockserver.py) ----------------------
        client = getattr(svc, "blockclient", None)
        store = getattr(client, "store", None)
        if store is not None:
            def register_hook(exchange, sender, phase):
                for rule in rules:
                    if rule.kind == "die_during_register" \
                            and rule.side == phase \
                            and rule.matches(exchange, None):
                        rule.fired += 1
                        when = "after" if phase == "post" else "before"
                        self._die(f"die_during_register:{exchange}:{phase}",
                                  f"dying {when} register seal in "
                                  f"{exchange!r}")

            if any(r.kind == "die_during_register" for r in rules):
                store._register_hook = register_hook
            for rule in rules:
                if rule.kind == "blockserver_unavailable":
                    rule.fired += 1
                    self.injected.append("blockserver_unavailable")
                    store.available = False
                    if rule.heal_after_s is not None:
                        self._later(rule.heal_after_s,
                                    lambda s=store: setattr(s, "available",
                                                            True))
        return self

    def attach_pool(self, supervisor) -> "FaultInjector":
        """Arms a ``WorkerPoolSupervisor``'s exec seam: once
        ``after_spawns`` workers have started, a matching
        ``spawn_exec_error`` rule makes every further spawn raise
        ``OSError(ENOEXEC)``; the supervisor must count it and converge
        below target."""
        orig_popen = supervisor._popen
        spawned_ok = [0]

        def popen(*a, **kw):
            for rule in self.plan.rules:
                if rule.kind == "spawn_exec_error" \
                        and rule.matches("", None) \
                        and spawned_ok[0] >= rule.after_bytes:
                    rule.fired += 1
                    self.injected.append(
                        f"spawn_exec_error:after{spawned_ok[0]}")
                    raise OSError(8, "Exec format error (injected)")
            pr = orig_popen(*a, **kw)
            spawned_ok[0] += 1
            return pr

        supervisor._popen = popen
        return self

    def attach_stream(self, execution) -> "FaultInjector":
        """Arms a ``StreamExecution``'s exactly-once commit protocol.

        - ``torn_checkpoint``: after commit entry number ``after_entries``
          lands atomically, the entry file is cut to ``keep_bytes`` in
          place; with ``die=True`` the process then exits hard.
        - ``die_after_state_commit``: the process exits between the
          durable state commit and the sink write of batch number
          ``after_entries`` (``execution._post_state_commit_hook``).

        Kills go through ``self.die``."""
        log = execution.commit_log
        orig_add = log.add
        commits_seen = [0]

        def add(batch_id, payload):
            orig_add(batch_id, payload)
            n = commits_seen[0]
            commits_seen[0] += 1
            path = os.path.join(log.path, str(batch_id))
            for rule in self.plan.rules:
                if rule.kind == "torn_checkpoint" \
                        and rule.matches("", None) \
                        and n >= rule.after_bytes:
                    rule.fired += 1
                    with open(path, "rb") as f:
                        body = f.read()
                    with open(path, "wb") as f:
                        f.write(body[: rule.keep_bytes])
                    self.injected.append(f"torn_checkpoint:{batch_id}")
                    if rule.side == "die":
                        print(f"[faults] dying mid-commit at batch "
                              f"{batch_id}", flush=True)
                        self.die(43)

        log.add = add

        hooks_seen = [0]
        prev_hook = execution._post_state_commit_hook

        def hook(batch_id):
            if prev_hook is not None:
                prev_hook(batch_id)
            n = hooks_seen[0]
            hooks_seen[0] += 1
            for rule in self.plan.rules:
                if rule.kind == "die_after_state_commit" \
                        and rule.matches("", None) \
                        and n >= rule.after_bytes:
                    rule.fired += 1
                    self._die(f"die_after_state_commit:{batch_id}",
                              f"dying after state commit at batch "
                              f"{batch_id}")

        if any(r.kind == "die_after_state_commit" for r in self.plan.rules):
            execution._post_state_commit_hook = hook
        return self
