"""The device exchange tier: bucketed spans moved device-memory to
device-memory among the participants of one exchange domain.

The port of the local face of ``spark_tpu/parallel/ici.py``:

* ``probe_topology`` — the replica-deterministic tier split: which
  process ids share a device domain.  A pure function of the conf
  override string, the process count and the live set;
* ``plan_side`` — per-exchange activation from AGREED inputs only (the
  gathered plan-round manifests' side totals), so every replica derives
  the same verdict;
* ``schema_eligible`` — dictionary-coded columns stay on the host tier;
* ``_pack_outbox`` / ``_unpack_inbox`` — per-receiver spans <-> fixed-
  capacity per-peer planes, run boundaries intact;
* ``local_device_exchange`` — every participant's packed planes on one
  device and ONE all-to-all (kernel K2) over all of them, run-length
  table included: the TPU kernel's data planes and the ``lax.all_to_all``
  of its run table become one launch.

The cross-process lanes (``crossproc.py`` over ``hostshuffle.py``) run
every exchange between processes on the host tier: blocks written to a
shared directory.  The cross-process ``device_exchange`` (``_ici_tier``
and the tiered exchanges of the JAX package's ``crossproc.py``) comes
with the device-tier slice (ROADMAP item 10.2); until then the auto path of
``probe_topology`` yields singleton domains, as the JAX package does in
one process, and a tier override that puts peers in one domain makes a
cross-process exchange raise (``crossproc._check_device_tier``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cuda_a2a
from ..columnar import ColumnBatch, ColumnVector

__all__ = ["IciUnavailable", "TierSplit", "probe_topology", "plan_side",
           "schema_eligible", "local_device_exchange", "ICI_AXIS"]

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


def probe_topology(override: str, pid: int, n: int,
                   live: Sequence[int]) -> TierSplit:
    """The tier-split decision: partition the LIVE pids into device
    domains.

    Override format: pipe-separated comma groups of pids ('0,1|2,3').
    Pids outside [0, n) or not live are dropped; a pid named twice keeps
    its first group; unmentioned live pids become singleton (host-tier-
    only) domains.  A malformed override falls back to singleton domains.
    Without an override every pid is a singleton: one process spans no
    multi-process device world."""
    live_sorted = sorted(int(p) for p in live)
    live_set = frozenset(live_sorted)
    if not override:
        return TierSplit(pid, tuple((p,) for p in live_sorted))
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
    would be silent corruption."""
    if batch is None:
        return False
    return all(v.dictionary is None for v in batch.vectors)


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
