"""Replica-determinism static analysis (lint rules HZ109 / HZ110), the
port of ``spark_tpu/analysis/determinism.py``.

The driverless exchange protocol rests on one invariant nothing else
states: every REPLICATED DECISION — adaptive replan, reducer
assignment, elastic width, range cut points, skew re-split, recovery
adoption — is re-executed independently on every process and must
produce bit-identical results.  Divergence is not a crash; it is
matching keys landing on different processes, i.e. silent row loss.

This pass makes that obligation machine-checked.  ``DECISION_ROOTS``
is the registry of replica-deterministic entry points (by bare
function name, so the rule also fires on test snippets); the pass
builds the same-module call closure of the registry and flags, inside
it:

* **HZ109** (nondet-source-in-replica-decision) — nondeterministic
  sources whose value can reach a decision: unseeded RNG
  (``random.*`` / ``np.random.*`` / argless ``default_rng()``),
  ``id()`` / ``hash()`` (object identity and ``PYTHONHASHSEED`` vary
  per process), ``os.urandom`` / ``os.environ`` / ``os.getenv`` /
  ``os.getpid`` / ``uuid.uuid1/uuid4`` / ``secrets.*`` /
  ``threading.get_ident`` — flagged at the call site; plus wall-clock
  and thread-timing reads (``time.*`` clocks, ``datetime.now``, the
  service's ``._clock``) — flagged only when the value TAINTS a
  ``return`` (a clock used purely for deadlines/timers is the
  protocol's business and stays clean).
* **HZ110** (unordered-iteration-escapes-decision) — ``set`` iteration
  whose element order escapes into a decision value: ``for`` loops and
  list/generator/dict comprehensions over set-valued expressions, and
  order-sensitive consumers (``list``/``tuple``/``enumerate``/
  ``iter``/``reversed``/``str.join``) applied to a set.
  Order-insensitive folds are clean by construction: ``sorted(...)``,
  ``min``/``max``/``sum``/``len``/``any``/``all``, membership tests,
  set algebra, and set comprehensions over sets (a set in → a set
  out never exposes an order).

Both rules surface through ``python -m spark_tpu_torch.analysis.lint``
and the ``tools/lint_waivers_torch.toml`` waiver machinery; intentional
cases (e.g. the informational ``ts`` stamp in manifest bytes) carry
one-line reasons there.  The catalogue of registry functions and what
each decides lives in ``INVARIANTS.md`` beside this module.  Every name
of the registry is the JAX package's, and each names a function of the
port (``parallel/crossproc.py``, ``parallel/hostshuffle.py``,
``parallel/ici.py``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["DECISION_ROOTS", "decision_closure", "rule_nondet_sources",
           "rule_unordered_iteration"]

# Bare names of the replica-deterministic entry points.  A function
# whose name appears here — wherever it is defined — is a decision
# ROOT: it and everything it (transitively, same module) calls must be
# a pure function of shared inputs.
DECISION_ROOTS = frozenset({
    # crossproc: the adaptive / elastic decision pipeline
    "adaptive_join_decision", "choose_join_strategy",
    "observed_side_stats", "elastic_reducer_width",
    "_adaptive_redecide", "_elastic_width", "decision_inputs",
    "_estimated_span_weights",
    # hostshuffle: reducer assignment, ownership, recovery adoption
    "plan_reducers", "plan_range_reducers", "skew_spans",
    "group_owner", "live_pids", "recover_round",
    # ici: the tier split every replica must agree on before any
    # device collective (its fingerprint rides decision_inputs)
    "probe_topology",
})


def _L():
    # lazy: lint.py imports this module's rules into _FILE_RULES, so a
    # module-level import back into lint would be cyclic
    from . import lint as L
    return L


def _chain(node) -> Optional[str]:
    """Dotted name of a Name/Attribute chain (``np.random.shuffle``),
    or None for anything dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# -- the call closure of the registry ---------------------------------

def decision_closure(tree) -> Dict[ast.AST, Tuple[str, str]]:
    """Map every function node reachable from a ``DECISION_ROOTS``
    entry (same-module calls, matched by bare callee name) to its
    ``(qualname, root)``."""
    L = _L()
    funcs: Dict[str, List[Tuple[ast.AST, str]]] = {}
    for fn, qn in L._functions(tree):
        funcs.setdefault(fn.name, []).append((fn, qn))
    reached: Dict[ast.AST, Tuple[str, str]] = {}
    work: List[ast.AST] = []
    for fn, qn in L._functions(tree):
        if fn.name in DECISION_ROOTS and fn not in reached:
            reached[fn] = (qn, fn.name)
            work.append(fn)
    while work:
        fn = work.pop()
        root = reached[fn][1]
        for node in L._shallow_walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = node.func.id if isinstance(node.func, ast.Name) \
                else node.func.attr if isinstance(node.func, ast.Attribute) \
                else None
            for cn, cq in funcs.get(name, ()):
                if cn not in reached:
                    reached[cn] = (cq, root)
                    work.append(cn)
    return reached


# -- HZ109: nondeterministic sources ----------------------------------

_CLOCKS = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "time.process_time_ns", "time.thread_time", "time.thread_time_ns",
})

_DIRECT = frozenset({
    "os.urandom", "os.getenv", "os.getpid", "os.environ.get",
    "uuid.uuid1", "uuid.uuid4", "threading.get_ident",
})


def _is_clock_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    c = _chain(node.func)
    return bool(c) and (c in _CLOCKS or c.endswith("._clock")
                        or c.endswith("datetime.now")
                        or c.endswith("datetime.utcnow"))


def _direct_desc(node) -> Optional[str]:
    """Describe a source that is nondeterministic WHEREVER it appears
    in a decision (identity ordering, per-process seeds, environment),
    or None."""
    if isinstance(node, ast.Subscript) and _chain(node.value) == "os.environ":
        return "os.environ read"
    if not isinstance(node, ast.Call):
        return None
    c = _chain(node.func)
    if not c:
        return None
    if c == "id" and node.args:
        return "id() — object identity varies per process"
    if c == "hash" and node.args:
        return "hash() — PYTHONHASHSEED varies per process"
    if c in _DIRECT:
        return f"{c}()"
    if c.startswith("secrets."):
        return f"{c}()"
    if c == "random" or c.startswith("random.") or ".random." in c:
        return f"unseeded RNG {c}()"
    if c.endswith("default_rng") and not node.args and not node.keywords:
        return "unseeded default_rng()"
    return None


def _clock_taint_findings(fn, qname: str, root: str, path: str) -> List:
    """Clock reads are legitimate for deadlines/timers; they become a
    hazard only when the value reaches the function's RETURN (one-level
    local-name taint, iterated to a fixpoint)."""
    L = _L()
    nodes = list(L._shallow_walk(fn))
    if not any(_is_clock_call(n) for n in nodes):
        return []
    tainted: Set[str] = set()

    def expr_tainted(e) -> bool:
        for x in ast.walk(e):
            if _is_clock_call(x):
                return True
            if isinstance(x, ast.Name) and isinstance(x.ctx, ast.Load) \
                    and x.id in tainted:
                return True
        return False

    for _ in range(6):                      # bounded fixpoint
        changed = False
        for n in nodes:
            if isinstance(n, ast.Assign):
                tgts, val = n.targets, n.value
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)) \
                    and n.value is not None:
                tgts, val = [n.target], n.value
            else:
                continue
            if expr_tainted(val):
                for t in tgts:
                    for x in ast.walk(t):
                        if isinstance(x, ast.Name) and x.id not in tainted:
                            tainted.add(x.id)
                            changed = True
        if not changed:
            break
    out = []
    for n in nodes:
        if isinstance(n, ast.Return) and n.value is not None \
                and expr_tainted(n.value):
            out.append(L.Finding(
                "HZ109", path, n.lineno, n.col_offset, qname,
                "wall-clock/thread-timing value reaches the return "
                f"value of a replica-decision path (via {root!r}): "
                "replicated decisions must be bit-identical across "
                "processes — deadline-only clock uses are fine, "
                "decision values are not"))
    return out


def rule_nondet_sources(tree, path: str, qnames) -> List:
    """HZ109: nondeterministic source inside the decision closure."""
    L = _L()
    findings = []
    for fn, (qname, root) in sorted(decision_closure(tree).items(),
                                    key=lambda kv: kv[0].lineno):
        for n in L._shallow_walk(fn):
            desc = _direct_desc(n)
            if desc:
                findings.append(L.Finding(
                    "HZ109", path, n.lineno, n.col_offset, qname,
                    f"nondeterministic source {desc} in a "
                    f"replica-decision path (via {root!r}): replicated "
                    "decisions must be bit-identical across processes"))
        findings.extend(_clock_taint_findings(fn, qname, root, path))
    return findings


# -- HZ110: unordered iteration escaping into decisions ---------------

_ORDER_FREE = frozenset({"sorted", "min", "max", "sum", "len", "any",
                         "all", "set", "frozenset", "bool"})
_ORDER_SENSITIVE = frozenset({"list", "tuple", "enumerate", "iter",
                              "reversed"})
_SET_ANNOTATIONS = frozenset({"set", "frozenset", "Set", "FrozenSet",
                              "AbstractSet", "MutableSet"})
_SET_OPS = (ast.BitOr, ast.BitAnd, ast.BitXor, ast.Sub)


def _syntactic_set(e) -> bool:
    if isinstance(e, (ast.Set, ast.SetComp)):
        return True
    if isinstance(e, ast.Call):
        name = e.func.id if isinstance(e.func, ast.Name) \
            else e.func.attr if isinstance(e.func, ast.Attribute) else None
        return name in ("set", "frozenset")
    return False


def _set_returning(tree) -> Set[str]:
    """Bare names of module functions that syntactically return a set
    (``skew_spans``-shaped helpers)."""
    L = _L()
    out: Set[str] = set()
    for fn, _qn in L._functions(tree):
        for n in L._shallow_walk(fn):
            if isinstance(n, ast.Return) and n.value is not None \
                    and _syntactic_set(n.value):
                out.add(fn.name)
    return out


def _annotation_is_set(a) -> bool:
    if a is None:
        return False
    if isinstance(a, ast.Subscript):
        a = a.value
    c = _chain(a)
    return bool(c) and c.split(".")[-1] in _SET_ANNOTATIONS


def _scan_unordered(fn, qname: str, root: str, path: str,
                    set_fns: Set[str]) -> List:
    L = _L()
    nodes = list(L._shallow_walk(fn))
    set_names: Set[str] = set()
    args = fn.args
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)):
        if _annotation_is_set(a.annotation):
            set_names.add(a.arg)

    def setval(e) -> bool:
        if _syntactic_set(e):
            return True
        if isinstance(e, ast.Name):
            return e.id in set_names
        if isinstance(e, ast.Call):
            name = e.func.id if isinstance(e.func, ast.Name) \
                else e.func.attr if isinstance(e.func, ast.Attribute) \
                else None
            return name in set_fns
        if isinstance(e, ast.BinOp) and isinstance(e.op, _SET_OPS):
            return setval(e.left) or setval(e.right)
        if isinstance(e, ast.IfExp):
            return setval(e.body) or setval(e.orelse)
        return False

    for _ in range(4):                      # name-taint fixpoint
        changed = False
        for n in nodes:
            tgt = None
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                tgt, val = n.targets[0], n.value
            elif isinstance(n, (ast.AnnAssign, ast.AugAssign)) \
                    and n.value is not None:
                tgt, val = n.target, n.value
            if isinstance(tgt, ast.Name) and setval(val) \
                    and tgt.id not in set_names:
                set_names.add(tgt.id)
                changed = True
        if not changed:
            break

    sanitized: Set[int] = set()
    for n in nodes:
        if isinstance(n, ast.Call):
            name = n.func.id if isinstance(n.func, ast.Name) \
                else n.func.attr if isinstance(n.func, ast.Attribute) \
                else None
            if name in _ORDER_FREE:
                for a in n.args:
                    sanitized.add(id(a))
                    if isinstance(a, (ast.GeneratorExp, ast.ListComp,
                                      ast.SetComp, ast.DictComp)):
                        for g in a.generators:
                            sanitized.add(id(g.iter))
        if isinstance(n, ast.Compare) \
                and any(isinstance(op, (ast.In, ast.NotIn)) for op in n.ops):
            for c in n.comparators:
                sanitized.add(id(c))

    def flag(node, what):
        return L.Finding(
            "HZ110", path, node.lineno, node.col_offset, qname,
            f"set iteration order escapes into a replica decision "
            f"({what} over {L._src(node)[:60]!r}, via {root!r}): "
            "iterate sorted(...) instead — element order is "
            "process-dependent")

    out = []
    for n in nodes:
        if isinstance(n, ast.For) and id(n.iter) not in sanitized \
                and setval(n.iter):
            out.append(flag(n.iter, "for-loop"))
        elif isinstance(n, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
            # a SetComp over a set is clean: set in, set out, no order
            for g in n.generators:
                if id(g.iter) not in sanitized and setval(g.iter):
                    out.append(flag(g.iter, "comprehension"))
        elif isinstance(n, ast.Call):
            name = n.func.id if isinstance(n.func, ast.Name) else None
            if name in _ORDER_SENSITIVE and n.args \
                    and id(n.args[0]) not in sanitized \
                    and setval(n.args[0]):
                out.append(flag(n.args[0], f"{name}()"))
            elif isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "join" and n.args \
                    and setval(n.args[0]):
                out.append(flag(n.args[0], "str.join()"))
    return out


def rule_unordered_iteration(tree, path: str, qnames) -> List:
    """HZ110: set-iteration order escaping into the decision closure."""
    set_fns = _set_returning(tree)
    findings = []
    for fn, (qname, root) in sorted(decision_closure(tree).items(),
                                    key=lambda kv: kv[0].lineno):
        findings.extend(_scan_unordered(fn, qname, root, path, set_fns))
    return findings
