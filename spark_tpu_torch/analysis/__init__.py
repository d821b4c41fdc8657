"""Static analysis for the port — three heads, one package (the port of
``spark_tpu/analysis/``).

Head 1 (``verifier`` + ``runtime``): ``verify_plan``, a post-optimizer
pass over logical and physical plans checking schema/dtype propagation
node by node, plus execution-time invariant checks the cross-process
join lanes call at their decision points (join-strategy legality, hash
co-partitioning, range cut points / span ownership / presorted-run
claims, dictionary code-space unification, host-ledger release
scoping, the decision trace).  All failures are a structured
``PlanInvariantError`` naming the node and the broken property.  Gated
by ``spark.tpu.analysis.verifyPlans`` (default ``auto``: on under
pytest, off in production).

Head 2 (``lint`` + ``confcheck``): an AST hazard linter over the port's
own source (``python -m spark_tpu_torch.analysis.lint``): host syncs in
code a stage capture runs, ledger ``reserve`` without a ``release`` in
a ``finally``, unlocked shared state in threaded classes, blocking I/O
under a lock, planning conf reads missing from the plan cache
fingerprint, dead imports, builtin shadowing, CUDA graphs built outside
the stage cache.  Justified exceptions live in
``tools/lint_waivers_torch.toml``; a waiver matching no finding fails
the default lint.

Head 3 (``determinism`` + ``protocol``): replica determinism and
exchange-protocol conformance.  ``determinism.DECISION_ROOTS`` is the
registry of the decision functions every process re-executes and must
replicate bit-identically (HZ109 nondeterministic sources, HZ110 set
order escaping into a decision); ``protocol`` extracts the manifest
round ids of the ``crossproc``/``hostshuffle`` pair and checks
publish/gather pairing, single use and epoch fencing (HZ111).  The
runtime backstop (``runtime.verify_decision_trace``) rides the
``{xid}-plan`` round.

The checked invariants are catalogued in ``INVARIANTS.md`` beside this
package's modules.
"""

from .errors import PlanInvariantError
from .verifier import (
    maybe_verify_physical, maybe_verify_plan, maybe_verify_stage_contract,
    runtime_checks_enabled, verify_physical, verify_plan,
    verify_stage_contract,
)

__all__ = [
    "PlanInvariantError", "verify_plan", "verify_physical",
    "verify_stage_contract", "maybe_verify_plan", "maybe_verify_physical",
    "maybe_verify_stage_contract", "runtime_checks_enabled",
]
