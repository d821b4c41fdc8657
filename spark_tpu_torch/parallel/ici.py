"""The device exchange tier: bucketed spans moved device-memory to
device-memory among the participants of one exchange domain.

The port of ``spark_tpu/parallel/ici.py``:

* ``probe_topology`` — the replica-deterministic tier split: which
  process ids share a device domain.  A pure function of the conf
  override string, the process count, the live set and, on the auto
  path, the card every process published at ``enableHostShuffle``
  (``publish_device`` / ``card_facts``: its UUID, its host and the cards
  it reaches by peer access): the processes on the cards of one host
  that all reach each other form one domain (the reference's slice and
  ICI domain), those on a host whose cards do not all reach each other
  one domain per card, and every CPU process is its own;
* ``plan_side`` — per-exchange activation from AGREED inputs only (the
  gathered plan-round manifests' side totals), so every replica derives
  the same verdict;
* ``schema_eligible`` — dictionary-coded columns stay on the host tier;
* ``_pack_outbox`` / ``_unpack_inbox`` — per-receiver spans <-> fixed-
  capacity per-peer planes, run boundaries intact;
* ``local_device_exchange`` — every participant's packed planes on one
  device and ONE all-to-all (kernel K2) over all of them, run-length
  table included: the TPU kernel's data planes and the ``lax.all_to_all``
  of its run table become one launch;
* ``device_publish`` / ``device_pull`` — the cross-process form
  (``device_exchange`` of the JAX package).  A sender packs its spans for
  domain peers into its device ARENA (one ``cudaMalloc`` allocation,
  ``cuda_a2a.Arena``; a shared-memory file under the shuffle root on a
  CPU session), synchronizes, and publishes an arena SIDECAR (IPC handle
  or file, plane layout, rows per receiver, generation) before its
  commit marker.  After the host exchange's commit barrier each receiver
  maps its peers' arenas and pulls its slots with ONE launch of K2
  (``cuda_a2a.pull``, on its own card, reading a peer card's arena over
  NVLink; its plain version on the CPU), then unpacks them
  into the exchange's ``FetchSink`` by sender.  The TPU kernel is a
  symmetric collective; here each sender's choice rides its own sidecar
  and commit, so a one-sided fold-back (an injected fault, a pack
  overflow) moves that sender's spans to the host tier and nothing
  hangs.  Arenas are double-buffered by exchange: a sender reuses one
  only after a later barrier, which every puller reaches after its pull.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cuda_a2a
from .. import wire
from ..columnar import ColumnBatch, ColumnVector

__all__ = ["IciUnavailable", "TierSplit", "probe_topology", "plan_side",
           "schema_eligible", "local_device_exchange", "device_publish",
           "device_pull", "publish_device", "card_uuids", "card_facts",
           "ICI_AXIS",
           "STATS", "CHECK", "CHECK_ENV"]

#: name of the exchange axis (one participant per exchange peer),
#: distinct from the compute mesh's DATA_AXIS
ICI_AXIS = "ici"


class IciUnavailable(RuntimeError):
    """Structured signal: the device tier cannot serve this exchange.
    The caller folds the affected spans back onto the host tier —
    degradation, not an error."""


# ---------------------------------------------------------------------------
# tier split: which pids share a device domain (replica-deterministic)
# ---------------------------------------------------------------------------

class TierSplit:
    """The agreed partition of live process ids into device domains.

    ``domains`` is a tuple of sorted pid tuples covering every live pid
    exactly once; singleton domains are host-tier-only."""

    __slots__ = ("pid", "domains", "_of")

    def __init__(self, pid: int, domains: Tuple[Tuple[int, ...], ...]):
        self.pid = int(pid)
        self.domains = domains
        self._of = {p: i for i, d in enumerate(domains) for p in d}

    def domain(self, pid: Optional[int] = None) -> Tuple[int, ...]:
        return self.domains[self._of[self.pid if pid is None else pid]]

    def same_domain(self, other: int) -> bool:
        mine = self._of.get(self.pid)
        return mine is not None and self._of.get(other) == mine

    def peers(self) -> List[int]:
        """My intra-domain exchange peers (self excluded), sorted."""
        return [p for p in self.domain() if p != self.pid]

    def fingerprint(self) -> List[str]:
        """Canonical component for the decision-trace hash: one
        'a,b,c' string per domain, in domain order."""
        return [",".join(str(p) for p in d) for d in self.domains]


def _facts(f) -> Optional[dict]:
    """One pid's published card facts as a dict (a bare UUID string: a
    card on an unnamed host that reaches no other card)."""
    if f is None or isinstance(f, dict):
        return f
    return {"uuid": str(f), "machine": "", "peers": []}


def _card_domains(live: Sequence[int], facts: Optional[Dict[int, Any]]
                  ) -> Tuple[Tuple[int, ...], ...]:
    """Live pids grouped into device domains from their published card
    facts (``card_facts``), the counterpart of the JAX package's
    ``_world_slice_domains``, which groups the chips of a slice: the pids
    on the cards of one machine form one domain when every card among them
    reaches every other by peer access, else the pids of each card form
    one; a pid on the CPU or with no published card is its own domain.
    Every process derives the same domains from the same facts."""
    hosts: Dict[str, Dict[str, List[int]]] = {}
    reach: Dict[str, set] = {}
    domains: List[Tuple[int, ...]] = []
    for p in sorted(int(p) for p in live):
        f = _facts((facts or {}).get(p))
        u = f.get("uuid") if f else None
        if not u or u.startswith("cpu"):
            domains.append((p,))
            continue
        hosts.setdefault(str(f.get("machine", "")), {}).setdefault(
            u, []).append(p)
        reach.setdefault(u, set()).update(f.get("peers") or ())
    for cards in hosts.values():
        uuids = sorted(cards)
        if all(b in reach[a] for a in uuids for b in uuids if a != b):
            domains.append(tuple(sorted(p for u in uuids
                                        for p in cards[u])))
        else:
            domains += [tuple(cards[u]) for u in uuids]
    return tuple(sorted(domains))


def probe_topology(override: str, pid: int, n: int, live: Sequence[int],
                   uuids: Optional[Dict[int, Any]] = None) -> TierSplit:
    """The tier-split decision: partition the LIVE pids into device
    domains.

    Override format: pipe-separated comma groups of pids ('0,1|2,3').
    Pids outside [0, n) or not live are dropped; a pid named twice keeps
    its first group; unmentioned live pids become singleton (host-tier-
    only) domains.  A malformed override falls back to singleton domains.
    Without an override the domains come from the cards: ``uuids`` maps
    each pid to the card facts it published (``card_facts``; or a bare
    card UUID), the same facts in every process (``_card_domains``);
    without them every pid is a singleton."""
    live_sorted = sorted(int(p) for p in live)
    live_set = frozenset(live_sorted)
    if not override:
        return TierSplit(pid, _card_domains(live_sorted, uuids))
    domains: List[Tuple[int, ...]] = []
    placed: List[int] = []
    try:
        for group in override.split("|"):
            members: List[int] = []
            for tok in group.split(","):
                tok = tok.strip()
                if not tok:
                    continue
                p = int(tok)
                if 0 <= p < n and p in live_set and p not in placed:
                    members.append(p)
                    placed.append(p)
            if members:
                domains.append(tuple(sorted(members)))
    except ValueError:
        domains, placed = [], []
    for p in live_sorted:
        if p not in placed:
            domains.append((p,))
    return TierSplit(pid, tuple(sorted(domains)))


# ---------------------------------------------------------------------------
# per-exchange activation (agreed inputs only)
# ---------------------------------------------------------------------------

class SidePlan:
    """One lane side's device-tier plan, derived from AGREED inputs: the
    tier split, the side's summed manifest bytes, and the max rows any
    single process observed (the pack capacity).  ``active`` False means
    the side rides the host tier with no device attempt at all."""

    __slots__ = ("tier", "active", "cap_rows", "max_runs", "agreed_bytes")

    def __init__(self, tier: TierSplit, active: bool, cap_rows: int,
                 max_runs: int, agreed_bytes: int):
        self.tier = tier
        self.active = active
        self.cap_rows = cap_rows
        self.max_runs = max_runs
        self.agreed_bytes = agreed_bytes


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def plan_side(tier: Optional[TierSplit], mans: Dict[int, dict], skey: str,
              min_bytes: int, max_runs: int = 1) -> Optional[SidePlan]:
    """Activate the device tier for one lane side from replica-shared
    inputs only (the gathered plan manifests): the byte gate and the pack
    capacity come out identical on every replica."""
    if tier is None or not tier.peers():
        return None
    total_bytes = 0
    max_rows = 0
    for s in sorted(mans):
        obs = (mans[s] or {}).get("sides", {}).get(skey)
        if obs:
            total_bytes += int(obs[0])
            max_rows = max(max_rows, int(obs[1]))
    active = total_bytes >= int(min_bytes) and max_rows > 0
    return SidePlan(tier, active, _pow2(max_rows), int(max_runs),
                    total_bytes)


def schema_eligible(batch: Optional[ColumnBatch]) -> bool:
    """Dictionary-coded columns are pinned to the host tier: code-space
    unification is host logic, and shipping codes without their words
    would be silent corruption.  So are array columns (a ``(capacity,
    L)`` plane does not pack into one row slot).  Both are properties of
    the side's schema, the same in every process."""
    if batch is None:
        return False
    return all(v.dictionary is None and v.data.dim() == 1
               for v in batch.vectors)


# ---------------------------------------------------------------------------
# pack / unpack: per-receiver spans <-> fixed-capacity per-peer buffers
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pack_outbox(outbox: Dict[int, List[ColumnBatch]],
                 members: Sequence[int], template: ColumnBatch,
                 cap: int, max_runs: int):
    """Pack one participant's per-receiver batches into dense host arrays:
    per column a ``(n_m, cap)`` data buffer and a ``(n_m, cap)`` mask, one
    ``(n_m, cap)`` row-validity plane, and a ``(n_m, max_runs)`` int32
    run-length table.  Peer slot order is the sorted member list."""
    n_m = len(members)
    names = list(template.names)
    cols = [np.zeros((n_m, cap), dtype=_host(v.data).dtype)
            for v in template.vectors]
    masks = [np.zeros((n_m, cap), dtype=bool) for _ in template.vectors]
    rowv = np.zeros((n_m, cap), dtype=bool)
    runlens = np.zeros((n_m, max_runs), dtype=np.int32)
    for slot, peer in enumerate(members):
        at = 0
        for run, b in enumerate(outbox.get(peer) or []):
            if run >= max_runs:
                raise IciUnavailable(
                    f"outbox run count exceeds the agreed pack shape "
                    f"({run + 1} > {max_runs})")
            rows = int(b.capacity)
            if at + rows > cap:
                raise IciUnavailable(
                    f"outbox rows exceed the agreed pack capacity "
                    f"({at + rows} > {cap})")
            for j, v in enumerate(b.vectors):
                cols[j][slot, at:at + rows] = _host(v.data)[:rows]
                masks[j][slot, at:at + rows] = (
                    True if v.valid is None else _host(v.valid)[:rows])
            rowv[slot, at:at + rows] = (
                True if b.row_valid is None
                else _host(b.row_valid)[:rows])
            runlens[slot, run] = rows
            at += rows
    return names, cols, masks, rowv, runlens


def _runs_of(template, names, cols, masks, rowv, runlens, slot
             ) -> List[ColumnBatch]:
    """Slot ``slot``'s rows split back into their runs; all-true masks
    collapse back to None."""
    lens = [int(r) for r in np.asarray(runlens[slot]) if int(r) > 0]
    runs: List[ColumnBatch] = []
    at = 0
    for rows in lens:
        vectors = []
        for j, tv in enumerate(template.vectors):
            data = np.ascontiguousarray(cols[j][slot, at:at + rows])
            mask = np.ascontiguousarray(masks[j][slot, at:at + rows])
            vectors.append(ColumnVector(
                torch.from_numpy(data), tv.dtype,
                None if bool(mask.all()) else torch.from_numpy(mask), None))
        rv = np.ascontiguousarray(rowv[slot, at:at + rows])
        runs.append(ColumnBatch(list(names), vectors,
                                None if bool(rv.all())
                                else torch.from_numpy(rv), rows))
        at += rows
    return runs


def _unpack_inbox(names, template: ColumnBatch, cols, masks, rowv,
                  runlens, members: Sequence[int], self_pid: int
                  ) -> Dict[int, List[ColumnBatch]]:
    """Invert ``_pack_outbox`` on the received planes: slot ``s`` holds
    sender ``members[s]``'s rows for me, split back into its runs.
    Senders with zero rows, and the receiver itself, are omitted."""
    out: Dict[int, List[ColumnBatch]] = {}
    for slot, sender in enumerate(members):
        if sender == self_pid:
            continue
        runs = _runs_of(template, names, cols, masks, rowv, runlens, slot)
        if runs:
            out[sender] = runs
    return out


_self_runs = _runs_of


# ---------------------------------------------------------------------------
# the exchange: one all-to-all over every participant's planes
# ---------------------------------------------------------------------------

def local_device_exchange(outboxes: Sequence[Dict[int, List[ColumnBatch]]],
                          template: ColumnBatch, max_runs: int = 1,
                          cap: Optional[int] = None, session=None,
                          device=None) -> List[Dict[int, List[ColumnBatch]]]:
    """The device data plane for participants on ONE device: participant
    i's outbox packs into planes on the device, one all-to-all moves every
    span (K2: columns, masks, row validity and the run table in one
    launch), and each participant's inbox unpacks per sender, self slot
    included.

    The device is the session's, else ``device`` (default ``cuda``);
    ``cpu`` runs the kernel's plain version.  Every participant lives on
    that one device, so there is no "too few devices" case: only fewer
    than two participants raise ``IciUnavailable``."""
    n_m = len(outboxes)
    if n_m < 2:
        raise IciUnavailable(
            f"an exchange needs at least 2 participants, got {n_m}")
    dev = session.device if session is not None \
        else torch.device(device or "cuda")
    members = list(range(n_m))
    if cap is None:
        cap = _pow2(max(
            (sum(int(b.capacity) for b in bs)
             for ob in outboxes for bs in ob.values()), default=1))
    packs = [_pack_outbox(ob, members, template, cap, max_runs)
             for ob in outboxes]
    names = packs[0][0]
    n_cols = len(packs[0][1])
    # plane k of participant s: columns, masks, row validity, run table
    table = [[torch.from_numpy(plane).to(dev) for plane in
              (list(p[1]) + list(p[2]) + [p[3], p[4]])] for p in packs]
    received = [r.cpu().numpy() for r in cuda_a2a.all_to_all(
        [[table[s][k] for s in members] for k in range(len(table[0]))])]
    out: List[Dict[int, List[ColumnBatch]]] = []
    for i in members:
        cols = [received[j][i] for j in range(n_cols)]
        masks = [received[n_cols + j][i] for j in range(n_cols)]
        rowv = received[2 * n_cols][i]
        runlens = received[2 * n_cols + 1][i]
        inbox = _unpack_inbox(names, template, cols, masks, rowv, runlens,
                              members, self_pid=i)
        # the local harness keeps the self slot too: parity checks want the
        # full routed view back
        inbox[i] = _self_runs(template, names, cols, masks, rowv, runlens, i)
        out.append(inbox)
    return out


# ---------------------------------------------------------------------------
# across processes: card facts, arenas, sidecars, the pull
# ---------------------------------------------------------------------------

#: check mode: senders also write the bytes of each receiver's slot, and
#: receivers hold every pull against the plain version over them
CHECK_ENV = "SPARK_TPU_ICI_CHECK"

#: this process's device-tier time split (host ms, the pull's device ms
#: from CUDA events on a card) and the bytes pulled
STATS: Dict[str, float] = {}

#: pulls held against their plain version in check mode
CHECK: Dict[str, Any] = {}

#: bytes an arena plane starts on (each slot of a plane follows the last)
_ALIGN = 256


def reset_stats() -> None:
    STATS.clear()
    STATS.update(pack_ms=0.0, sidecar_ms=0.0, pull_ms=0.0, unpack_ms=0.0,
                 bytes_pulled=0, pulls=0, publishes=0)
    CHECK.clear()
    CHECK.update(checked=0, equal=True, max_abs_err=0)


reset_stats()


def _fault_point(svc, exchange: str, point: str) -> None:
    """Fault-injection seam (``faults.FaultInjector.attach`` installs
    ``svc._ici_fault``): 'attempt' fires before any device work, 'copy'
    once the spans are packed, before the arena and its sidecar."""
    hook = getattr(svc, "_ici_fault", None)
    if hook is not None:
        hook(exchange, point)


def _tier_dir(svc) -> str:
    return os.path.join(svc.root, "_ici")


def _publish_json(path: str, doc: dict) -> int:
    buf = json.dumps(doc, separators=(",", ":"))
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(buf)
    os.replace(tmp, path)
    return len(buf)


def publish_device(svc, device) -> None:
    """Publish the card this process runs on where every process reads the
    same facts: its UUID (``cpu:<pid>`` on a CPU session), its machine (the
    OS host name: the processes' logical ``host-<pid>`` names say nothing
    of which share one) and the UUIDs of the visible cards it reaches by
    peer access — the auto probe's input, written at
    ``enableHostShuffle``, before any query."""
    device = torch.device(device)
    peers: List[str] = []
    if device.type == "cuda":
        uuid = _card_uuid(device)
        me = cuda_a2a._index(device)
        peers = [_card_uuid(torch.device("cuda", j))
                 for j in range(torch.cuda.device_count())
                 if j != me and torch.cuda.can_device_access_peer(me, j)]
    else:
        uuid = f"cpu:{svc.pid}"
    os.makedirs(_tier_dir(svc), exist_ok=True)
    _publish_json(os.path.join(_tier_dir(svc), f"p{svc.pid:04d}.device"),
                  {"pid": svc.pid, "uuid": uuid,
                   "host": svc.host_name(svc.pid),
                   "machine": socket.gethostname(), "peers": peers})


def _card_uuid(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return f"cuda:{getattr(props, 'uuid', props.name)}"


def card_facts(svc, live: Sequence[int],
               wait_s: Optional[float] = None) -> Dict[int, dict]:
    """Every live pid's published card facts (``publish_device``: uuid,
    machine, peers).  Each process published its own at
    ``enableHostShuffle``, before its first statement, and every
    statement starts with a round all of them pass, so the files are
    there; a missing one is waited for up to ``wait_s`` (the exchange
    timeout), then that pid counts as its own domain."""
    deadline = time.monotonic() + (svc.timeout_s if wait_s is None
                                   else wait_s)
    out: Dict[int, dict] = {}
    pending = sorted(int(p) for p in live)
    while pending:
        still = []
        for p in pending:
            try:
                with open(os.path.join(_tier_dir(svc),
                                       f"p{p:04d}.device")) as f:
                    got = json.load(f)
                out[p] = {"uuid": str(got["uuid"]),
                          "machine": str(got.get("machine", "")),
                          "peers": [str(u) for u in got.get("peers", ())]}
            except (OSError, ValueError, KeyError):
                still.append(p)
        if not still or time.monotonic() >= deadline:
            break
        time.sleep(svc.poll_s)
        pending = still
    return out


def card_uuids(svc, live: Sequence[int],
               wait_s: Optional[float] = None) -> Dict[int, str]:
    """Every live pid's published card UUID (``card_facts``'s uuids)."""
    return {p: f["uuid"] for p, f in card_facts(svc, live, wait_s).items()}


class _Arena:
    """One slot of a process's double-buffered arena: a ``cuda_a2a.Arena``
    on a card, a shared-memory file under the shuffle root on the CPU."""

    def __init__(self, svc, session, slot: int, nbytes: int, gen: int):
        self.device = session.device
        self.nbytes = int(nbytes)
        self.gen = f"p{svc.pid}-a{slot}-g{gen}"
        self.owner = f"ici-arena:{slot}"
        self.memory = getattr(session, "_memory", None)
        if self.device.type == "cuda":
            if self.memory is not None:
                # the memory pre-flight: the arena is device memory the
                # session's budget must cover
                self.memory.acquire_execution(self.owner, self.nbytes)
            try:
                self.cuda = cuda_a2a.Arena(self.device, self.nbytes)
            except Exception:
                if self.memory is not None:
                    self.memory.release_execution(self.owner)
                raise
            self.path = None
            self.ref = {"kind": "cuda", "handle": self.cuda.handle}
        else:
            self.cuda = None
            self.path = os.path.join(_tier_dir(svc), f"{self.gen}.arena")
            os.makedirs(_tier_dir(svc), exist_ok=True)
            with open(self.path, "wb") as f:
                f.truncate(self.nbytes)
            self.ref = {"kind": "shm",
                        "path": os.path.relpath(self.path, svc.root)}

    def write_all(self, writes: List[Tuple[int, np.ndarray]]) -> None:
        """Every ``(offset, host array)`` into the arena, then the
        stream synchronized (the sender's half of the ordering)."""
        if self.cuda is not None:
            for off, arr in writes:
                self.cuda.write(off, arr)
            torch.cuda.current_stream(self.device).synchronize()
            return
        with open(self.path, "r+b") as f:
            for off, arr in writes:
                f.seek(off)
                f.write(np.ascontiguousarray(arr).tobytes())

    def free(self) -> None:
        if self.cuda is not None:
            self.cuda.free()
            if self.memory is not None:
                self.memory.release_execution(self.owner)
        elif self.path is not None:
            try:
                os.remove(self.path)
            except OSError:
                pass


class _TierState:
    """One service's device-tier state: its two arena slots, the next
    slot, and the peers' arenas it mapped (``(peer, slot) → (generation,
    base address)``)."""

    def __init__(self):
        self.slots: List[Optional[_Arena]] = [None, None]
        self.next_slot = 0
        self.gens = 0
        self.opened: Dict[Tuple[int, int], Tuple[str, int]] = {}

    def arena_for(self, svc, session, nbytes: int) -> Tuple[_Arena, int]:
        slot = self.next_slot
        self.next_slot = 1 - slot
        cur = self.slots[slot]
        if cur is None or cur.nbytes < nbytes \
                or cur.device != session.device:
            if cur is not None:
                # last used two publishes ago: every puller of it has
                # passed a later barrier since
                cur.free()
                self.slots[slot] = None
            self.gens += 1
            # grown by half again, so a side that creeps up does not
            # reallocate at every exchange
            cur = _Arena(svc, session, slot, max(nbytes, 1) * 3 // 2,
                         self.gens)
            self.slots[slot] = cur
        return cur, slot


def _state(svc) -> _TierState:
    st = getattr(svc, "_ici_state", None)
    if st is None:
        st = svc._ici_state = _TierState()
    return st


def _layout(planes: Sequence[np.ndarray]) -> Tuple[List[dict], int]:
    """Each packed plane's place in the arena: its offset, dtype, and
    row count per slot and slot stride in elements; and the arena's
    bytes."""
    out, at = [], 0
    for p in planes:
        at = -(-at // _ALIGN) * _ALIGN
        out.append({"off": at, "dtype": p.dtype.str,
                    "width": int(p.shape[1])})
        at += p.nbytes
    return out, at


def _sidecar_path(svc, exchange: str, sender: int) -> str:
    return os.path.join(svc._dir(exchange), f"s{sender:04d}.ici")


def _check_path(svc, exchange: str, sender: int, receiver: int) -> str:
    return os.path.join(svc._dir(exchange),
                        f"s{sender:04d}-r{receiver:04d}.icicheck")


def device_publish(svc, session, plan: SidePlan, exchange: str,
                   outbound: Dict[int, List[ColumnBatch]],
                   template: ColumnBatch) -> dict:
    """A sender's half of the device tier: ``outbound``'s spans (bound for
    domain peers) packed into this process's arena, the stream
    synchronized, and the arena sidecar published.  Returns the commit
    manifest's extra (``{"ici": sidecar bytes}``), which tells receivers
    to pull.  Raises ``IciUnavailable`` for the structured fold-backs (an
    injected fault, a pack that overflows the agreed shape); a card's
    allocation or copy failure raises as itself."""
    _fault_point(svc, exchange, "attempt")
    t0 = time.perf_counter()
    members = sorted(plan.tier.domain(svc.pid))
    host = {r: [wire.trim_host(b.to_host()) for b in bs]
            for r, bs in outbound.items()}
    names, cols, masks, rowv, runlens = _pack_outbox(
        host, members, template, plan.cap_rows, plan.max_runs)
    rows = {str(r): int(runlens[i].sum()) for i, r in enumerate(members)
            if r != svc.pid and int(runlens[i].sum())}
    _fault_point(svc, exchange, "copy")
    planes = list(cols) + list(masks) + [rowv, runlens]
    layout, total = _layout(planes)
    side: Dict[str, Any] = {"members": members, "cap": plan.cap_rows,
                            "max_runs": plan.max_runs, "layout": layout,
                            "rows": rows, "names": names}
    if rows:
        st = _state(svc)
        arena, slot = st.arena_for(svc, session, total)
        writes = []
        for i, r in enumerate(members):
            n_rows = int(runlens[i].sum())
            if r == svc.pid or not n_rows:
                continue
            for p, lay in zip(planes, layout):
                n = p.shape[1] if p is runlens else n_rows
                writes.append((lay["off"] + i * p.strides[0], p[i, :n]))
        arena.write_all(writes)
        side.update(arena=arena.ref, gen=arena.gen, slot=slot)
        os.makedirs(svc._dir(exchange), exist_ok=True)
        if os.environ.get(CHECK_ENV) == "1":
            for i, r in enumerate(members):
                if str(r) in rows:
                    n = rows[str(r)]
                    with open(_check_path(svc, exchange, svc.pid, r),
                              "wb") as f:
                        for p in planes:
                            f.write(np.ascontiguousarray(
                                p[i, :p.shape[1] if p is runlens
                                  else n]).tobytes())
    t1 = time.perf_counter()
    os.makedirs(svc._dir(exchange), exist_ok=True)
    nbytes = _publish_json(_sidecar_path(svc, exchange, svc.pid), side)
    moved = sum(wire.raw_nbytes(bs) for bs in host.values())
    STATS["pack_ms"] += (t1 - t0) * 1e3
    STATS["sidecar_ms"] += (time.perf_counter() - t1) * 1e3
    STATS["publishes"] += 1
    with svc._lock:
        svc.counters["ici_exchanges"] += 1
        svc.counters["ici_bytes_moved"] += int(moved)
    return {"ici": nbytes}


def _lost(svc, exchange: str, sender: int, detail: str):
    from .hostshuffle import ExchangeFetchFailed
    svc.bump("blocks_lost")
    svc.bump("fetch_failures")
    return ExchangeFetchFailed(
        exchange, [svc.host_name(sender)],
        [os.path.basename(_sidecar_path(svc, exchange, sender))],
        detail=detail)


def _peer_base(svc, session, exchange: str, sender: int, side: dict) -> int:
    """The base address of ``sender``'s arena in this process: mapped once
    per (peer, slot, generation); a slot's older mapping is closed when
    its generation changes.  A peer whose arena cannot be mapped is the
    structured loss of that sender."""
    if svc.heartbeat is not None \
            and svc.host_name(sender) in set(svc.heartbeat.dead_hosts()):
        raise _lost(svc, exchange, sender, "peer dead before its arena "
                    "was read")
    st = _state(svc)
    key = (sender, int(side["slot"]))
    got = st.opened.get(key)
    if got is not None and got[0] == side["gen"]:
        return got[1]
    if got is not None:
        cuda_a2a.close_handle(session.device, got[1])
        del st.opened[key]
    try:
        base = cuda_a2a.open_handle(session.device, side["arena"]["handle"])
    except RuntimeError as e:
        raise _lost(svc, exchange, sender, f"arena cannot be mapped: {e}")
    st.opened[key] = (side["gen"], base)
    return base


def device_pull(svc, session, plan: Optional[SidePlan], exchange: str,
                template: ColumnBatch, sink) -> None:
    """A receiver's half, after the host exchange's commit barrier: every
    domain peer whose commit names a sidecar gets its slot for this
    process pulled with ONE launch of K2 (``cuda_a2a.pull``; on a CPU
    session the plain version over the peers' shared-memory arenas), and
    the rows land in ``sink`` keyed by sender, split back into their
    runs.  Senders that took the host tier have no sidecar; their blocks
    came through the host fetch."""
    if plan is None or not plan.active:
        return
    senders = []
    for s in sorted(p for p in plan.tier.domain(svc.pid) if p != svc.pid):
        if s in svc.recovered_pids:
            continue
        man = svc.read_manifest(exchange, s)
        if not man or not man.get("ici"):
            continue
        try:
            with open(_sidecar_path(svc, exchange, s)) as f:
                side = json.load(f)
        except (OSError, ValueError) as e:
            raise _lost(svc, exchange, s, f"arena sidecar unreadable: {e}")
        n = int(side["rows"].get(str(svc.pid), 0))
        if n:
            senders.append((s, side, n))
    if not senders:
        return
    t0 = time.perf_counter()
    my_slot = senders[0][1]["members"].index(svc.pid)
    layout = senders[0][1]["layout"]
    max_runs = int(senders[0][1]["max_runs"])
    n_planes = len(layout)
    widths = [max(n for _s, _sd, n in senders)] * (n_planes - 1) \
        + [max_runs]
    dtypes = [np.dtype(lay["dtype"]) for lay in layout]
    # each output row rounded up to 16 bytes, so every sender's block
    # starts 16-byte aligned: the pull's bulk copies need both ends so
    rows = [_padded_rows(w, dt.itemsize) for w, dt in zip(widths, dtypes)]
    dev = session.device
    pulled_bytes = sum(w * dt.itemsize * len(senders)
                       for w, dt in zip(widths, dtypes))
    pull_ms = 0.0
    if dev.type == "cuda":
        sources = [[] for _ in range(n_planes)]
        for s, side, _n in senders:
            base = _peer_base(svc, session, exchange, s, side)
            cap = int(side["cap"])
            for k, lay in enumerate(side["layout"]):
                isz = np.dtype(lay["dtype"]).itemsize
                stride = (max_runs if k == n_planes - 1 else cap) * isz
                sources[k].append(base + lay["off"] + my_slot * stride)
        outs = [torch.empty((len(senders), r),
                            dtype=torch.from_numpy(np.zeros(0, dt)).dtype,
                            device=dev) for r, dt in zip(rows, dtypes)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cuda_a2a.pull(sources, outs, [w * dt.itemsize
                                      for w, dt in zip(widths, dtypes)])
        end.record()
        end.synchronize()
        pull_ms = start.elapsed_time(end)
        from ..columnar import pack_to_host
        got = [t.numpy() for t in pack_to_host(outs)]
    else:
        blocks = [[] for _ in range(n_planes)]
        for s, side, _n in senders:
            path = os.path.join(svc.root, side["arena"]["path"])
            raw = np.memmap(path, dtype=np.uint8, mode="r")
            cap = int(side["cap"])
            for k, lay in enumerate(side["layout"]):
                dt = np.dtype(lay["dtype"])
                stride = (max_runs if k == n_planes - 1 else cap) \
                    * dt.itemsize
                at = lay["off"] + my_slot * stride
                blocks[k].append(torch.from_numpy(np.array(
                    raw[at:at + widths[k] * dt.itemsize]).view(dt)))
            del raw
        got = [t.numpy() for t in cuda_a2a.pull_plain(blocks, rows)]
    t1 = time.perf_counter()
    if os.environ.get(CHECK_ENV) == "1":
        _check_pull(svc, exchange, senders, got, n_planes)
    names = senders[0][1]["names"]
    for i, (s, _side, _n) in enumerate(senders):
        runs = _pulled_runs(template, names, got, widths, i)
        if runs:
            sink.add(s, runs)
    STATS["pull_ms"] += pull_ms if dev.type == "cuda" \
        else (t1 - t0) * 1e3
    STATS["unpack_ms"] += (time.perf_counter() - t1) * 1e3 \
        + ((t1 - t0) * 1e3 - pull_ms if dev.type == "cuda" else 0.0)
    STATS["bytes_pulled"] += pulled_bytes
    STATS["pulls"] += 1
    with svc._lock:
        svc.counters["ici_pulls"] += 1
        svc.counters["ici_bytes_pulled"] += int(pulled_bytes)


def _padded_rows(width: int, itemsize: int) -> int:
    """``width`` elements of ``itemsize`` bytes rounded up to a multiple
    of 16 bytes: a pulled output's row length."""
    return -(-width * itemsize // 16) * 16 // itemsize


def _pulled_runs(template: ColumnBatch, names, planes, widths, slot
                 ) -> List[ColumnBatch]:
    """Sender ``slot``'s runs from a pull's planes (columns, masks, the
    row-validity plane, the run table), whose rows may be padded past
    ``widths``: only each row's first ``widths[k]`` elements are read."""
    planes = [p[:, :w] for p, w in zip(planes, widths)]
    n_cols = (len(planes) - 2) // 2
    return _runs_of(template, names, planes[:n_cols],
                    planes[n_cols:2 * n_cols], planes[2 * n_cols],
                    planes[2 * n_cols + 1], slot)


def _check_pull(svc, exchange: str, senders, got, n_planes: int) -> None:
    """Check mode: the pulled planes against the plain version over the
    bytes each sender wrote for this receiver (only its rows: the rest
    of a pulled block is arena padding)."""
    blocks = [[] for _ in range(n_planes)]
    for s, side, n in senders:
        try:
            with open(_check_path(svc, exchange, s, svc.pid), "rb") as f:
                data = f.read()
        except OSError:
            CHECK["missing"] = CHECK.get("missing", 0) + 1
            return
        at = 0
        for k, lay in enumerate(side["layout"]):
            dt = np.dtype(lay["dtype"])
            w = int(side["max_runs"]) if k == n_planes - 1 else n
            blocks[k].append(torch.from_numpy(
                np.frombuffer(data, dt, w, at).copy()))
            at += w * dt.itemsize
    for k in range(n_planes):
        for i, b in enumerate(blocks[k]):
            want = cuda_a2a.pull_plain([[b]])[0][0].numpy()
            have = got[k][i, :len(want)]
            equal = have.tobytes() == want.tobytes()
            CHECK["equal"] = CHECK["equal"] and equal
            if len(want) and want.dtype.kind in "iuf":
                err = np.abs(have.astype(np.float64)
                             - want.astype(np.float64))
                err = err[np.isfinite(err)]
                if len(err):
                    CHECK["max_abs_err"] = max(CHECK["max_abs_err"],
                                               float(err.max()))
    CHECK["checked"] += 1
