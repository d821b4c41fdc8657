"""Structured failure type for the plan-invariant verifier
(``spark_tpu/analysis/errors.py``)."""

from __future__ import annotations


class PlanInvariantError(RuntimeError):
    """A plan — or one of its execution-time exchange artifacts —
    violates an invariant the engine relies on.

    Structured like ``memory.HostMemoryError``: the offending node and
    the broken property are attributes, so harnesses and operators can
    assert on WHAT broke rather than parsing a message.

    Attributes:
      node       the offending logical/physical node (or a string label
                 for non-node scopes like the host ledger)
      node_name  the node's class name (or the string label verbatim)
      property   short slug of the broken invariant, e.g.
                 ``hash-co-partitioning`` / ``presorted-build`` /
                 ``ledger-scope-pairing`` (see ``INVARIANTS.md`` here)
      detail     human-readable specifics (values, rows, owners)
    """

    def __init__(self, node, prop: str, detail: str = ""):
        self.node = node
        self.property = prop
        self.detail = detail
        self.node_name = node if isinstance(node, str) \
            else type(node).__name__
        msg = f"plan invariant violated at {self.node_name}: {prop}"
        if detail:
            msg += f" — {detail}"
        super().__init__(msg)
