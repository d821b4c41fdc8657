"""Head 1: the plan-invariant verifier (``verify_plan``), the port of
``spark_tpu/analysis/verifier.py``.

A post-optimizer pass over logical and physical plans.  It re-derives
what every node CLAIMS about its output — schema shape, expression
dtypes, join-key comparability — and fails with a structured
``PlanInvariantError`` naming the node and broken property when a claim
does not hold.  The optimizer and analyzer normally guarantee these
properties; the verifier exists so a future rewrite rule (or a
hand-mutated plan reaching the executor) cannot silently ship a plan
the kernels would misexecute.

Enablement is ``spark.tpu.analysis.verifyPlans``:

* ``auto`` (default) — on when running under pytest (the port's tests
  and the worker processes they start, which inherit
  ``PYTEST_CURRENT_TEST``), off in production;
* ``on`` / ``off`` — explicit.

The dtype checks read torch tensors: a vector's dtype is its tensor's
(``types.torch_to_np_dtype``), compared with the numpy dtype its engine
type declares (``DataType.np_dtype``: booleans ``bool``, string and
date codes ``int32``, decimals and timestamps ``int64``), and taken from
the run table or the plane of a run-coded column so the check never
expands one.

Execution-time exchange invariants (co-partitioning, sorted runs, span
ownership, ledger scoping) live in ``analysis.runtime`` — they need
values only the cross-process lanes hold.  The catalogue is
``INVARIANTS.md`` beside this module.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from .. import config as C
from .. import types as T
from .errors import PlanInvariantError

__all__ = ["verify_plan", "verify_physical", "verify_stage_contract",
           "maybe_verify_plan", "maybe_verify_physical",
           "maybe_verify_stage_contract", "runtime_checks_enabled"]


# ---------------------------------------------------------------------------
# enablement + session accounting
# ---------------------------------------------------------------------------

def runtime_checks_enabled(session) -> bool:
    """Whether this session runs plan verification (and the
    cross-process runtime invariant checks that share the gate)."""
    try:
        mode = str(session.conf.get(C.ANALYSIS_VERIFY_PLANS)).strip().lower()
    except Exception:
        return False
    if mode in ("on", "true", "1", "always", "yes"):
        return True
    if mode in ("off", "false", "0", "never", "no"):
        return False
    return "PYTEST_CURRENT_TEST" in os.environ


def _bump(session, elapsed_ms: float) -> None:
    st = session.__dict__.setdefault(
        "_analysis_stats", {"plans_verified": 0, "plan_verify_ms": 0.0})
    st["plans_verified"] = st.get("plans_verified", 0) + 1
    st["plan_verify_ms"] = st.get("plan_verify_ms", 0.0) + elapsed_ms


def maybe_verify_plan(session, plan) -> None:
    """Session-gated ``verify_plan`` with the ``plans_verified`` /
    ``plan_verify_ms`` accounting of the ``analysis`` metrics source."""
    if not runtime_checks_enabled(session):
        return
    t0 = time.perf_counter()
    verify_plan(plan)
    _bump(session, (time.perf_counter() - t0) * 1e3)


def maybe_verify_physical(session, pq) -> None:
    """Session-gated physical-plan verification of one ``PlannedQuery``
    (called per execution attempt, where the plan already exists — no
    extra planning or file reads)."""
    if not runtime_checks_enabled(session):
        return
    t0 = time.perf_counter()
    verify_physical(pq.physical, pq.leaves)
    _bump(session, (time.perf_counter() - t0) * 1e3)


def maybe_verify_stage_contract(session, stage) -> None:
    """Session-gated ``verify_stage_contract``, called once per stage
    BUILD (not per replay) by the stage cache — a bad boundary is caught
    before the first batch runs or a graph is captured."""
    if not runtime_checks_enabled(session):
        return
    t0 = time.perf_counter()
    verify_stage_contract(stage)
    _bump(session, (time.perf_counter() - t0) * 1e3)


# ---------------------------------------------------------------------------
# logical-plan walk
# ---------------------------------------------------------------------------

def verify_plan(plan) -> None:
    """Walk a LOGICAL plan bottom-up checking schema/dtype propagation
    node-by-node.  Raises ``PlanInvariantError``; returns None when
    every node's claims hold."""
    for c in plan.children:
        verify_plan(c)
    _check_logical(plan)


def _schema_of(node):
    try:
        return node.schema()
    except PlanInvariantError:
        raise
    except Exception as e:
        raise PlanInvariantError(
            node, "schema-propagation", f"{type(e).__name__}: {e}")


def _expr_dtype(node, prop: str, expr, schema):
    try:
        return expr.data_type(schema)
    except Exception as e:
        names = [f.name for f in schema.fields]
        raise PlanInvariantError(
            node, prop,
            f"{expr!r} does not type against columns {names}: "
            f"{type(e).__name__}: {e}")


def _check_logical(node) -> None:
    from ..sql import logical as L

    schema = _schema_of(node)

    if isinstance(node, L.LocalRelation):
        _check_leaf_batch(node, schema)
        return
    if isinstance(node, L.Project):
        cs = _schema_of(node.children[0])
        for e in node.exprs:
            _expr_dtype(node, "expr-dtype", e, cs)
        return
    if isinstance(node, L.Filter):
        cs = _schema_of(node.children[0])
        dt = _expr_dtype(node, "filter-condition-dtype", node.condition, cs)
        if not isinstance(dt, (T.BooleanType, T.NullType)):
            raise PlanInvariantError(
                node, "filter-condition-dtype",
                f"condition {node.condition!r} has dtype {dt}, not boolean")
        return
    if isinstance(node, L.Aggregate):
        cs = _schema_of(node.children[0])
        for k in node.keys:
            _expr_dtype(node, "grouping-key-dtype", k, cs)
        for func, _name in node.aggs:
            _expr_dtype(node, "aggregate-dtype", func, cs)
        return
    if isinstance(node, L.Sort):
        cs = _schema_of(node.children[0])
        for o in node.orders:
            _expr_dtype(node, "sort-key-dtype", o.child, cs)
        return
    if isinstance(node, L.Join):
        _check_join(node)
        return
    # Union / Intersect / Except / Distinct / … : their own schema()
    # performs the arity/coercion validation — covered by _schema_of.


def _vec_np_dtype(v) -> np.dtype:
    """A vector's physical numpy dtype WITHOUT touching ``.data`` — that
    would expand a lazy run-coded column (or a stage's run plane) just
    to learn its dtype (run and plane values share the dense tensor's
    dtype by construction)."""
    from ..columnar import unexpanded_plane, unmaterialized_runs
    p = unexpanded_plane(v)
    if p is not None:
        return T.torch_to_np_dtype(p.plane_values.dtype)
    r = unmaterialized_runs(v)
    return T.torch_to_np_dtype(
        (r.run_values if r is not None else v.data).dtype)


def _check_leaf_batch(node, schema) -> None:
    """A leaf's claimed field dtypes must match the physical tensors
    that will back the PScan — the dtype-propagation ground truth."""
    batch = node.batch
    for f, v in zip(schema.fields, batch.vectors):
        if isinstance(f.dataType, T.ArrayType):
            continue                       # 2-D element planes: elementwise
        want = np.dtype(f.dataType.np_dtype)
        got = _vec_np_dtype(v)
        if got != want:
            raise PlanInvariantError(
                node, "leaf-dtype",
                f"column {f.name!r} claims {f.dataType} "
                f"(np {want}) but its vector holds {got}")


def _check_join(node) -> None:
    from ..sql import logical as L
    from ..sql.joins import equi_join_keys

    if node.how not in L.Join.JOIN_TYPES:
        raise PlanInvariantError(
            node, "join-type", f"unknown join type {node.how!r}")
    ls = _schema_of(node.children[0])
    rs = _schema_of(node.children[1])
    try:
        pairs = equi_join_keys(node)
    except Exception as e:
        raise PlanInvariantError(
            node, "join-keys", f"equi-key extraction failed: "
            f"{type(e).__name__}: {e}")
    for le, re_ in pairs:
        lt = _expr_dtype(node, "join-key-dtype", le, ls)
        rt = _expr_dtype(node, "join-key-dtype", re_, rs)
        if T.common_type(lt, rt) is None:
            raise PlanInvariantError(
                node, "join-key-dtype",
                f"key pair ({le!r}: {lt}) vs ({re_!r}: {rt}) has no "
                "common comparison type")


# ---------------------------------------------------------------------------
# physical-plan walk
# ---------------------------------------------------------------------------

def verify_physical(physical, leaves: Optional[List] = None) -> None:
    """Walk a PHYSICAL plan checking that every operator can state its
    output schema and that each PScan's leaf exists and matches the
    schema the scan claims (name by name, dtype by dtype — the contract
    ``ExecContext.leaves`` delivery relies on)."""
    from ..sql import physical as P

    for c in physical.children:
        verify_physical(c, leaves)
    _schema_of(physical)
    if isinstance(physical, P.PScan) and leaves is not None:
        if not (0 <= physical.index < len(leaves)):
            raise PlanInvariantError(
                physical, "scan-leaf-index",
                f"PScan reads leaf {physical.index} of {len(leaves)}")
        _check_scan_leaf(physical, leaves[physical.index])


# ---------------------------------------------------------------------------
# fused-stage contract
# ---------------------------------------------------------------------------

def _same_np_dtype(a, b) -> bool:
    return np.dtype(a.np_dtype) == np.dtype(b.np_dtype)


def verify_stage_contract(stage) -> None:
    """One stage's boundary contract: the input/output schemas and
    dtypes the stage builder RECORDED at every cut point must equal what
    the physical tree derives bottom-up.  Capture may change dispatch
    structure, never the data contract at a cut — a mismatch means the
    next stage (a merger, an exchange, another stage's scan) would be fed
    rows it cannot interpret.

    ``stage`` is a ``sql.stagecompile.Stage``: ``physical`` (the stage's
    tree), ``in_schemas`` (leaf StructTypes in planner order), and
    ``out_schema`` (the StructType at the output cut)."""
    from ..sql import physical as P

    phys = stage.physical
    derived = _schema_of(phys)
    want = stage.out_schema
    if [f.name for f in derived.fields] != [f.name for f in want.fields]:
        raise PlanInvariantError(
            phys, "stage-cut-schema",
            f"stage output cut claims columns "
            f"{[f.name for f in want.fields]} but the unfused tree "
            f"derives {[f.name for f in derived.fields]}")
    for df, wf in zip(derived.fields, want.fields):
        if isinstance(df.dataType, T.ArrayType) \
                or isinstance(wf.dataType, T.ArrayType):
            continue
        if not _same_np_dtype(df.dataType, wf.dataType):
            raise PlanInvariantError(
                phys, "stage-cut-dtype",
                f"stage output column {wf.name!r} claims {wf.dataType} "
                f"but the unfused tree derives {df.dataType}")

    def scans(node):
        if isinstance(node, P.PScan):
            yield node
        for c in node.children:
            yield from scans(c)

    for scan in scans(phys):
        if not (0 <= scan.index < len(stage.in_schemas)):
            raise PlanInvariantError(
                scan, "stage-scan-leaf",
                f"stage input cut {scan.index} has no recorded schema "
                f"({len(stage.in_schemas)} inputs)")
        cut = stage.in_schemas[scan.index]
        claimed = scan.schema()
        if [f.name for f in claimed.fields] != [f.name for f in cut.fields]:
            raise PlanInvariantError(
                scan, "stage-cut-schema",
                f"stage input cut {scan.index} recorded columns "
                f"{[f.name for f in cut.fields]} but the scan claims "
                f"{[f.name for f in claimed.fields]}")
        for cf, sf in zip(cut.fields, claimed.fields):
            if isinstance(cf.dataType, T.ArrayType) \
                    or isinstance(sf.dataType, T.ArrayType):
                continue
            if not _same_np_dtype(cf.dataType, sf.dataType):
                raise PlanInvariantError(
                    scan, "stage-cut-dtype",
                    f"stage input cut {scan.index} column {cf.name!r}: "
                    f"recorded {cf.dataType}, scan claims {sf.dataType}")


def _check_scan_leaf(scan, batch) -> None:
    claimed = scan.schema()
    names = [f.name for f in claimed.fields]
    if list(batch.names) != names:
        raise PlanInvariantError(
            scan, "scan-leaf-schema",
            f"PScan {scan.index} claims columns {names} but the leaf "
            f"batch holds {list(batch.names)}")
    for f, v in zip(claimed.fields, batch.vectors):
        if isinstance(f.dataType, T.ArrayType):
            continue
        want = np.dtype(f.dataType.np_dtype)
        got = _vec_np_dtype(v)
        if got != want:
            raise PlanInvariantError(
                scan, "scan-leaf-dtype",
                f"leaf {scan.index} column {f.name!r}: claimed "
                f"{f.dataType} (np {want}), vector holds {got}")
