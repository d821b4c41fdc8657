"""Execution-time exchange invariants for the cross-process join lanes
(the port of ``spark_tpu/analysis/runtime.py``).

These checks need values that only exist while a distributed query
runs — the statistics a strategy decision consumed, the reducer bounds
both sides must share, the received shards themselves — so they live
here rather than in the static ``verifier`` walk.  The lanes of
``parallel/crossproc.py`` call them at their decision points when
``runtime_checks_enabled`` (the gate of ``verify_plan``); every
violation is a structured ``PlanInvariantError``.

What each check pins down (``INVARIANTS.md`` has the catalogue):

* ``verify_join_strategy`` — the chosen strategy is legal for the join
  type and the statistics (broadcasting a preserved outer side would
  null-extend once per process; range needs an orderable key; range and
  hash need equi keys).  At the adaptive stats barrier the same check
  recomputes ``adaptive_join_decision`` from the gathered manifests — a
  mismatch means this process diverged from its peers — and rejects any
  adaptive strategy change that is not a demotion to broadcast.
* ``verify_hash_copartition`` — after the hash exchange, every live row
  of BOTH local shards hashes into this process's fine-partition range
  under the shared reducer bounds.
* ``verify_range_cutpoints`` / ``verify_span_owners`` /
  ``verify_skew_split`` — strictly increasing cut points, valid and
  duplicate-free span owners, and a split span only where replicating
  the build side is legal.
* ``verify_presorted_build`` — the range lane's sorted-run claim on the
  merged build shard, which lets ``PMergeJoin`` skip its sort.
* ``verify_run_plane`` — a run table entering a stage as a plane decodes
  to exactly the dense batch it stands for.
* ``verify_unified_dictionaries`` — after an exchange every dictionary
  column's code space is one sorted dictionary holding every live code.
* ``verify_recovery_agreement`` / ``verify_epoch_released`` /
  ``verify_ledger_scope`` — recovery rounds agree, a dead epoch's
  reservations are gone before the re-run, and every exchange
  reservation is scoped under ``shuffle:<xid>``.
* ``verify_elastic_reducer_plan`` / ``verify_grace_bucket_partition`` —
  the elastic width every process derives, and grace buckets that
  partition the key space exactly.
* ``decision_trace`` / ``verify_decision_trace`` — the replica-
  determinism backstop on the ``{xid}-plan`` round.

The checks read host tensors (a shard is copied to the host once for a
check); nothing here runs on the card.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .errors import PlanInvariantError
from .verifier import runtime_checks_enabled

__all__ = [
    "runtime_checks_enabled", "verify_join_strategy",
    "verify_hash_copartition", "verify_range_cutpoints",
    "verify_span_owners", "verify_skew_split", "verify_presorted_build",
    "verify_run_plane", "verify_unified_dictionaries", "verify_ledger_scope",
    "verify_recovery_agreement", "verify_epoch_released",
    "verify_elastic_reducer_plan", "verify_grace_bucket_partition",
    "decision_trace", "verify_decision_trace",
]

_STRATEGIES = ("broadcast_left", "broadcast_right", "range", "hash",
               "gather")


def _np(x) -> np.ndarray:
    """A host numpy view of a tensor (or array-like)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def verify_join_strategy(join, strategy: str, range_eligible: bool,
                         key_pairs: Sequence[Tuple], frozen=None,
                         observed=None, broadcast_threshold: int = 0,
                         n_procs: int = 1) -> None:
    """Strategy legality, plan-time AND adaptive.  With ``frozen``/
    ``observed`` supplied (the stats-barrier call), two extra checks
    run: the decision must equal ``adaptive_join_decision`` recomputed
    from the same inputs, and an adaptive change of strategy may only
    DEMOTE to a broadcast (re-bucketing lanes mid-flight is never
    legal)."""
    from ..parallel import crossproc as X

    if strategy not in _STRATEGIES:
        raise PlanInvariantError(
            join, "join-strategy", f"unknown strategy {strategy!r}")
    if strategy == "broadcast_right" and join.how not in X._BCAST_RIGHT_OK:
        raise PlanInvariantError(
            join, "broadcast-legality",
            f"broadcasting the right side of a {join.how!r} join would "
            "null-extend its preserved rows once per process")
    if strategy == "broadcast_left" and join.how not in X._BCAST_LEFT_OK:
        raise PlanInvariantError(
            join, "broadcast-legality",
            f"broadcasting the left side of a {join.how!r} join would "
            "null-extend its preserved rows once per process")
    if strategy == "range" and not range_eligible:
        raise PlanInvariantError(
            join, "range-eligibility",
            "range lane chosen but the join key has no orderable "
            "single-key encoding")
    if strategy in ("range", "hash") and not key_pairs:
        raise PlanInvariantError(
            join, "equi-keys",
            f"{strategy} exchange chosen for a join with no equi keys")
    if frozen is not None:
        expect = X.adaptive_join_decision(
            frozen, join.how, broadcast_threshold, n_procs, observed)
        if strategy != expect:
            raise PlanInvariantError(
                join, "adaptive-decision-agreement",
                f"adaptive decision {strategy!r} differs from the "
                f"recomputed {expect!r} (frozen {frozen!r}, observed "
                f"{observed!r}) — this process diverged from its peers "
                "and matching keys would land on different processes")
        if strategy != frozen and strategy not in ("broadcast_left",
                                                   "broadcast_right"):
            raise PlanInvariantError(
                join, "adaptive-demotion-legality",
                f"adaptive re-decision moved {frozen!r} to {strategy!r}: "
                "only a demotion to broadcast is legal once the map "
                "sides are materialized for the frozen lane")


def _live_mask(host) -> np.ndarray:
    rv = host.row_valid
    return np.ones(host.capacity, bool) if rv is None \
        else _np(rv).astype(bool)


def _run_heads(host, expr):
    """``host`` cut to its run HEADS when ``expr`` is a bare column that
    is run-coded, fully valid and covers the batch: every row of a run
    shares its head's value, so a per-row key property holds iff it
    holds over the heads — the check keeps the shard compressed.  Else
    None."""
    from ..columnar import ColumnBatch, ColumnVector, unmaterialized_runs
    from ..expressions import Col

    if not (isinstance(expr, Col) and expr._name in host.names):
        return None
    src = host.column(expr._name)
    rv = unmaterialized_runs(src)
    if rv is None or src.valid is not None or rv.capacity != host.capacity:
        return None
    return ColumnBatch([expr._name],
                       [ColumnVector(rv.run_values, src.dtype,
                                     dictionary=src.dictionary)],
                       None, len(rv.run_values))


def verify_hash_copartition(join, key_pairs, bounds, n_fine: int,
                            pid: int, left_shard, right_shard) -> None:
    from ..parallel.crossproc import _hash_ids

    b = np.asarray(bounds, np.int64)
    if b.size < 2 or int(b[0]) != 0 or int(b[-1]) != n_fine \
            or np.any(np.diff(b) < 0):
        raise PlanInvariantError(
            join, "reducer-bounds",
            f"shared reducer bounds {[int(x) for x in b]} do not cover "
            f"[0, {n_fine}) monotonically")
    if pid + 1 < b.size:
        lo, hi = int(b[pid]), int(b[pid + 1])
    else:
        # an ELASTIC plan narrower than the live set leaves trailing
        # processes with no reducer group: they own the empty fine
        # range, so ANY live row here is a co-partitioning violation
        lo = hi = n_fine
    for side, shard, exprs in (
            ("left", left_shard, [l for l, _ in key_pairs]),
            ("right", right_shard, [r for _, r in key_pairs])):
        host = shard.to_host()
        mask = _live_mask(host)
        if not mask.any():
            continue
        if len(exprs) == 1 and bool(mask.all()):
            heads = _run_heads(host, exprs[0])
            if heads is not None:
                host = heads
                mask = np.ones(host.capacity, bool)
        fine = _np(_hash_ids(exprs, n_fine)(host)).astype(np.int64)[mask]
        bad = fine[(fine < lo) | (fine >= hi)]
        if bad.size:
            raise PlanInvariantError(
                join, "hash-co-partitioning",
                f"{side} shard holds {bad.size} live row(s) outside "
                f"process {pid}'s fine range [{lo}, {hi}) — e.g. fine "
                f"partition {int(bad[0])}; the sides did not share one "
                "reducer assignment")


def verify_range_cutpoints(join, cuts, is_str: bool) -> None:
    vals = list(cuts)
    for a, b in zip(vals, vals[1:]):
        if not a < b:
            raise PlanInvariantError(
                join, "range-cutpoints",
                f"cut points not strictly increasing: {a!r} !< {b!r} "
                f"(of {len(vals)} cuts)")


def verify_span_owners(join, owners: Sequence[Sequence[int]],
                       n_spans: int, n_procs: int) -> None:
    if len(owners) != n_spans:
        raise PlanInvariantError(
            join, "span-ownership",
            f"{len(owners)} owner sets for {n_spans} key spans")
    for p, ps in enumerate(owners):
        ps = list(ps)
        if not ps:
            raise PlanInvariantError(
                join, "span-ownership", f"key span {p} has no owner — "
                "its rows would be dropped by routing")
        if len(set(ps)) != len(ps):
            raise PlanInvariantError(
                join, "span-ownership",
                f"key span {p} lists duplicate owners {ps} — the build "
                "span would replicate twice to one process")
        if any(r < 0 or r >= n_procs for r in ps):
            raise PlanInvariantError(
                join, "span-ownership",
                f"key span {p} owned by {ps}, outside [0, {n_procs})")


def verify_skew_split(join, owners: Sequence[Sequence[int]]) -> None:
    """Skew-split legality: splitting a span replicates its BUILD slice
    to every owner, which is only sound when the build side is the
    non-preserved one (right/full joins would null-extend per owner)."""
    if any(len(ps) > 1 for ps in owners) and join.how in ("right", "full"):
        raise PlanInvariantError(
            join, "skew-split-legality",
            f"skew-split with build replication under a {join.how!r} "
            "join: each owner would null-extend the preserved build rows")


def verify_presorted_build(join, build_shard, r_expr,
                           as_float: bool) -> None:
    from ..expressions import EvalContext
    from ..sql.joins import range_encode_key

    host = build_shard.to_host()
    heads = _run_heads(host, r_expr)
    if heads is not None:
        # run-coded build key, fully live: the encoded key is constant
        # within a run, so the null-prefix and sortedness hold iff they
        # hold over the run HEADS (expanding the shard to check it would
        # defeat the compressed lane the check guards)
        host = heads
    encoded = range_encode_key(EvalContext(host), r_expr, as_float)
    if encoded is None:
        raise PlanInvariantError(
            join, "presorted-build",
            "the build key lost its orderable encoding at the receiver")
    enc, ok = (_np(a) for a in encoded)
    ok = ok.astype(bool)
    if ok.size and np.any(np.diff(ok.astype(np.int8)) > 0):
        i = int(np.argmax(np.diff(ok.astype(np.int8)) > 0)) + 1
        raise PlanInvariantError(
            join, "presorted-build",
            f"keyed rows are not a prefix: row {i} is keyed after a "
            "null/dead row — PMergeJoin's null-tail contract is broken")
    keys = enc[ok]
    if keys.size > 1:
        drops = np.diff(keys) < 0
        if np.any(drops):
            i = int(np.argmax(drops))
            raise PlanInvariantError(
                join, "presorted-build",
                f"build shard is not key-sorted: row {i} has key "
                f"{int(keys[i])} > row {i + 1}'s {int(keys[i + 1])} — "
                "the _presorted_build claim would make PMergeJoin "
                "silently drop matches")


def verify_run_plane(rv, capacity: int) -> None:
    """Stage-boundary contract of a run plane (``run-plane`` in
    INVARIANTS.md): the run table about to be padded onto a plane must
    decode to EXACTLY the dense batch it stands for — every run strictly
    positive (zero-length runs would alias the padding and corrupt the
    row-id expansion) and the lengths summing to the batch capacity."""
    lengths = _np(rv.run_lengths)
    n_values = _np(rv.run_values).shape[0]
    if lengths.shape[0] != n_values:
        raise PlanInvariantError(
            "stage-leaf", "run-plane",
            f"run table is ragged: {n_values} values vs "
            f"{lengths.shape[0]} lengths")
    if lengths.size and int(lengths.min()) <= 0:
        i = int(np.argmin(lengths))
        raise PlanInvariantError(
            "stage-leaf", "run-plane",
            f"run {i} has non-positive length {int(lengths[i])} — "
            "zero-length runs alias the plane's padding and corrupt "
            "the row-id expansion")
    total = int(lengths.sum())
    if total != int(capacity):
        raise PlanInvariantError(
            "stage-leaf", "run-plane",
            f"run lengths sum to {total} but the stage leaf holds "
            f"{int(capacity)} rows — the plane would decode to the "
            "wrong dense batch inside the stage")


def verify_unified_dictionaries(node, batches: Sequence) -> None:
    from ..columnar import unmaterialized_runs

    for b in batches:
        host = b.to_host()
        rv = _live_mask(host)
        for name, v in zip(host.names, host.vectors):
            d = v.dictionary
            if not d:
                continue
            words = list(d)
            for a, w in zip(words, words[1:]):
                if not a < w:
                    raise PlanInvariantError(
                        node, "dictionary-order",
                        f"column {name!r}: post-exchange dictionary is "
                        f"not strictly sorted ({a!r} !< {w!r}) — code "
                        "order no longer equals word order")
            runs = unmaterialized_runs(v)
            if runs is not None and v.valid is None and bool(rv.all()):
                # run-coded column, fully live: every row's code is one
                # of the run VALUES — check the run table, don't expand
                live = _np(runs.run_values)
                if live.ndim != 1:
                    continue
            else:
                codes = _np(v.data)
                if codes.ndim != 1:
                    continue          # array-of-string planes: 2-D codes
                mask = rv if v.valid is None \
                    else rv & _np(v.valid).astype(bool)
                live = codes[mask[:codes.shape[0]]] if codes.size \
                    else codes
            if live.size and (int(live.min()) < 0
                              or int(live.max()) >= len(words)):
                off = int(live.min()) if int(live.min()) < 0 \
                    else int(live.max())
                raise PlanInvariantError(
                    node, "dictionary-code-space",
                    f"column {name!r}: live code {off} outside the "
                    f"unified dictionary of {len(words)} words — the "
                    "code spaces were not unified across the exchange")


def verify_recovery_agreement(svc, xid: str, epoch: int) -> None:
    """After a ``{xid}-recover`` round: every survivor must have derived
    the SAME epoch and the same agreed-lost set, or the re-planned
    ownership maps diverge.  Re-reads the round's manifests (identical
    bytes on every process) and recomputes the agreement this process
    should hold; also pins EPOCH MONOTONICITY — the service epoch never
    moves backward past an agreed round."""
    rid = f"{xid}-recover{epoch}"
    agreed = set()
    seen_epochs = set()
    for s in range(svc.n):
        man = svc.read_manifest(rid, s)
        if man is None:
            continue
        agreed.update(int(p) for p in man.get("lost", []))
        seen_epochs.add(int(man.get("epoch", epoch)))
    if seen_epochs and seen_epochs != {epoch}:
        raise PlanInvariantError(
            rid, "recovery-agreement",
            f"recover-round manifests carry epochs {sorted(seen_epochs)} "
            f"!= the agreed epoch {epoch} — survivors are fencing "
            "different dead epochs")
    if not agreed <= set(svc.recovered_pids):
        raise PlanInvariantError(
            rid, "recovery-agreement",
            f"agreed-lost pids {sorted(agreed)} not all absorbed into "
            f"the service's recovered set {sorted(svc.recovered_pids)} — "
            "this process's live-set view diverged from the round")
    if int(svc.epoch) < epoch:
        raise PlanInvariantError(
            rid, "epoch-monotonicity",
            f"service epoch {svc.epoch} is behind the agreed epoch "
            f"{epoch} — a re-executed exchange would reuse dead-epoch "
            "ids and read stale blocks")


def verify_epoch_released(ledger, xid: str) -> None:
    """Before an epoch re-executes: every ``shuffle:<xid>``-scoped
    reservation of the aborted epoch must be gone, or the dead epoch's
    holders silently shrink the re-execution's host budget."""
    scope = f"shuffle:{xid}"
    stale = sorted(o for o in ledger.owners() if o.startswith(scope))
    if stale:
        raise PlanInvariantError(
            "HostMemoryLedger", "dead-epoch-ledger",
            f"reservation(s) {stale} from the aborted epoch survive "
            f"into the re-execution of {xid!r} — release_prefix on "
            "epoch abort did not pair with them")


def verify_ledger_scope(ledger, pre_owners, xid: str) -> None:
    scope = f"shuffle:{xid}"
    pre = set(pre_owners)
    stray = sorted(o for o in ledger.owners()
                   if o not in pre and not o.startswith(scope))
    if stray:
        raise PlanInvariantError(
            "HostMemoryLedger", "ledger-scope-pairing",
            f"exchange reservation(s) {stray} survive the query outside "
            f"the release scope {scope!r} — release_prefix cannot pair "
            "them and the bytes leak into the next statement's budget")


def verify_elastic_reducer_plan(join, width: int, mans, n_live: int,
                                target_bytes: int) -> None:
    """Every process must re-derive the SAME elastic reducer width from
    the shared plan-round manifests, or the sender/receiver reducer
    sets diverge and routed rows vanish."""
    from ..parallel.crossproc import elastic_reducer_width, \
        observed_side_stats
    obs = observed_side_stats(mans, n_live)
    expect = n_live
    if obs is not None:
        expect = elastic_reducer_width(obs[0] + obs[2], target_bytes,
                                       n_live)
    if int(width) != int(expect):
        raise PlanInvariantError(
            join, "elastic-plan-agreement",
            f"this process derived elastic width {width} but the shared "
            f"manifests imply {expect} (observed={obs}, n_live={n_live}, "
            f"target={target_bytes}) — elastic plans must agree "
            "byte-for-byte across processes")


def _trace_default(o) -> str:
    """``json.dumps``' fallback for values JSON has no form for: a
    tensor is rendered as numpy renders the same values, so a component
    the port holds as a tensor hashes as the JAX package's numpy one
    does; anything else is ``str``, as there."""
    if isinstance(o, torch.Tensor):
        return str(o.detach().cpu().numpy())
    return str(o)


def decision_trace(components: Dict) -> str:
    """Canonical hash of one exchange's replicated-decision inputs.

    The components dict holds every pre-round value a process derived
    INDEPENDENTLY that its peers must have derived bit-identically (the
    frozen strategy, the epoch, the live set, the adopted-lost set, the
    range cut points, the estimated skew splits, the device tier).
    Canonical JSON — sorted keys, no whitespace — so two processes hash
    equal iff the decisions are equal; blake2b-128 keeps the digest
    small enough to ride the ``{xid}-plan`` manifests (no added
    barrier).  The JAX package's hash of the same components is the
    same string."""
    blob = json.dumps(components, sort_keys=True, separators=(",", ":"),
                      default=_trace_default)
    return hashlib.blake2b(blob.encode("utf-8"),
                           digest_size=16).hexdigest()


def _trace_stats(session, diverged: bool) -> None:
    if session is None:
        return
    st = session.__dict__.setdefault("_analysis_stats", {})
    st["decision_trace_checks"] = st.get("decision_trace_checks", 0) + 1
    if diverged:
        st["decision_trace_divergence"] = \
            st.get("decision_trace_divergence", 0) + 1


def verify_decision_trace(session, join, svc, exchange: str,
                          mans: Dict[int, dict], inputs: Dict,
                          local: Optional[Dict] = None) -> None:
    """The decision-trace agreement check, in two phases.

    **Peer agreement** — every ``{xid}-plan`` manifest carries its
    sender's ``decision_trace`` hash and raw components (``dtrace =
    {"h": ..., "c": {...}}``).  A peer hash that differs from this
    process's own means the replicated pre-round decisions diverged; the
    raw components name WHICH.  Senders without a ``dtrace`` payload
    are skipped (a lost stats round degrades lenient).

    **Local recompute** — with ``local`` supplied (after the gather),
    the round's manifests are re-read FROM DISK and the adaptive
    decision and elastic width recomputed from those shared bytes.  A
    mismatch against what this process decided means its in-memory
    gathered view diverged from what its peers read; the error names
    the component (``decision`` or ``width``).  Recomputation uses only
    the pure functions (``observed_side_stats``,
    ``adaptive_join_decision``, ``elastic_reducer_width``)."""
    from ..parallel import crossproc as X

    mine = decision_trace(inputs)
    for s in sorted(mans):
        man = mans[s]
        dt = man.get("dtrace") if isinstance(man, dict) else None
        if not isinstance(dt, dict) or "h" not in dt:
            continue
        if dt["h"] == mine:
            continue
        theirs = dt.get("c") if isinstance(dt.get("c"), dict) else {}
        diff = sorted(k for k in set(inputs) | set(theirs)
                      if inputs.get(k) != theirs.get(k)) or ["<hash>"]
        _trace_stats(session, diverged=True)
        raise PlanInvariantError(
            join, "decision-trace-agreement",
            f"decision trace for round {exchange!r} diverged from "
            f"process {s}: component(s) {diff} differ (mine {mine}, "
            f"theirs {dt['h']!r}) — the replicated decision pipeline is "
            "no longer bit-identical and matching keys would land on "
            "different processes")
    if local is not None:
        fresh: Dict[int, dict] = {}
        for s in mans:
            man = svc.read_manifest(exchange, s)
            if man is not None:
                fresh[s] = man
        n_live = int(local["n_live"])
        obs = X.observed_side_stats(fresh, n_live)
        if "decision" in local:
            expect = local["frozen"]
            if local.get("adaptive"):
                expect = X.adaptive_join_decision(
                    local["frozen"], local["how"],
                    int(local.get("broadcast_threshold", 0)), n_live,
                    obs)
            if local["decision"] != expect:
                _trace_stats(session, diverged=True)
                raise PlanInvariantError(
                    join, "decision-trace-agreement",
                    f"round {exchange!r}: component(s) ['decision'] "
                    f"differ: this process decided "
                    f"{local['decision']!r} but the round's on-disk "
                    f"manifests imply {expect!r} (observed={obs}, "
                    f"frozen={local['frozen']!r}) — the gathered view "
                    "this process acted on diverged from the shared "
                    "bytes its peers read")
        if "width" in local:
            expect_w = X.elastic_reducer_width(
                (int(obs[0]) + int(obs[2])) if obs is not None else None,
                int(local.get("target", 0)), n_live)
            if int(local["width"]) != int(expect_w):
                _trace_stats(session, diverged=True)
                raise PlanInvariantError(
                    join, "decision-trace-agreement",
                    f"round {exchange!r}: component(s) ['width'] "
                    f"differ: this process sized the elastic reducer "
                    f"set at {local['width']} but the round's on-disk "
                    f"manifests imply {expect_w} (observed={obs}, "
                    f"n_live={n_live}) — reducer sets would diverge and "
                    "routed rows vanish")
    _trace_stats(session, diverged=False)


def verify_grace_bucket_partition(join, exprs_l, exprs_r, n_buckets: int,
                                  salt: int, bucket: int, left,
                                  right) -> None:
    """Grace buckets must partition the join-key space EXACTLY: every
    live row assembled for bucket ``bucket`` must hash back into that
    bucket under the same (salt, n_buckets) split, or a key's matches
    were torn across buckets and the bucket-wise join silently drops or
    duplicates pairs."""
    from ..parallel.crossproc import _grace_bucket_ids
    for side, (exprs, batch) in enumerate(
            ((exprs_l, left), (exprs_r, right))):
        if batch is None:
            continue
        host = batch.to_host()
        if int(host.num_rows()) == 0:
            continue
        ids = _np(_grace_bucket_ids(host, exprs, n_buckets, salt))
        live = _live_mask(host)
        bad = ids[live] != np.int32(bucket)
        if bool(np.any(bad)):
            raise PlanInvariantError(
                join, "grace-bucket-partition",
                f"{int(np.count_nonzero(bad))} live row(s) on side "
                f"{side} of grace bucket {bucket} (salt={salt}, "
                f"n_buckets={n_buckets}) hash to other buckets — the "
                "grace split tore a join key across buckets")
