"""Head 2: the port's hazard linter (the port of
``spark_tpu/analysis/lint.py``).

``python -m spark_tpu_torch.analysis.lint [paths...]`` parses the port's
own source and flags the hazard patterns that have bitten this codebase
or its JAX lineage, rather than generic style.  HZ102–HZ107 and
HZ109–HZ113 keep the JAX package's meaning (and give its findings on
the same source); HZ101 and HZ108 named ``jax.jit`` there and name their
CUDA counterparts here:

  HZ101 host-sync-in-capture   a host sync inside a function a stage
        capture runs — the step a stage builder returns beside its
        ``Stage`` record (``sql/planner.py`` ``stage_maker``,
        ``sql/multibatch.py`` ``step_maker``) and what it calls in the
        same module: ``.item()``, ``.cpu()``, ``.tolist()``,
        ``.numpy()``, ``np.asarray``/``np.array``/``np.frombuffer``, or
        a pageable copy (``torch.tensor``/``torch.as_tensor`` onto a
        ``device=``).  A sync fails a CUDA-graph capture, and a host
        value read during one is frozen into every replay; such sites go
        through ``capture.decide`` / ``capture.constant``.
  HZ102 reserve-without-release   a ``HostMemoryLedger`` ``reserve``/
        ``try_reserve`` in a function with no ``release*`` call in any
        ``finally`` block of that function: an error path leaks budget
        (callers that own the release get a waiver naming the scope).
  HZ103 unlocked-shared-state     a method of a lock-owning class
        (``self._lock = threading.Lock()``) mutates shared ``self``
        state (``+=`` or subscript store) without ever taking a lock.
  HZ104 blocking-io-under-lock    sleeping or filesystem/subprocess I/O
        inside a ``with <lock>:`` body — every other thread queues
        behind the I/O.
  HZ105 planning-conf-coverage    a conf entry read by the planning
        files but missing from the serving plan cache's
        ``PLANNING_CONF_KEYS`` fingerprint (``serving/plancache.py``; the
        stale-cache detector, see ``confcheck``).
  HZ106 unused-import             a module-level import never referenced.
  HZ107 shadow-builtin            a binding that shadows a risky builtin
        (``id``/``type``/``open``/...).
  HZ108 graph-outside-stage-cache   a ``torch.cuda.CUDAGraph(`` or
        ``torch.cuda.graph(`` built outside ``sql/stagecompile.py``: a
        graph captured per call re-captures the identical program every
        query and holds its memory pool outside the stage cache's
        accounting and eviction.  Captures go through
        ``sql.stagecompile.StageCache``.
  HZ109 nondet-source-in-replica-decision   a nondeterministic source
        (wall clock, unseeded RNG, ``id()``, ``os.environ``/``urandom``,
        thread identity) reachable from a replica-deterministic decision
        function — the registry in ``determinism.DECISION_ROOTS``.
  HZ110 unordered-iteration-escapes-decision   ``set`` iteration whose
        element order escapes into a decision value inside the same call
        graph (``sorted(set(...))`` is clean).
  HZ111 exchange-protocol-conformance   manifest-round misuse in the
        ``crossproc``/``hostshuffle`` protocol pair (``protocol.py``).
  HZ112 nonatomic-durable-write   a bare ``open(path, "w"/"wb")`` in a
        commit-flavored method of a checkpoint/log/sink/state class with
        no ``os.replace``/``os.rename`` in that method.
  HZ113 block-path-outside-resolver   a string literal (or f-string)
        that builds a block wire-format file name outside the resolver
        seam (``hostshuffle`` / ``blockserver`` / ``streaming.state``).

Justified exceptions live in ``tools/lint_waivers_torch.toml`` (every
waiver carries a reason); a waiver matching NO finding fails the
default lint with a "remove dead waiver" message.  Exit status: 0 when
every finding is waived, 1 otherwise.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from .determinism import rule_nondet_sources, rule_unordered_iteration
from .protocol import repo_pairing_findings, rule_protocol
from .waivers import dead_waivers, is_waived, load_waivers

__all__ = ["Finding", "lint_source", "lint_files", "lint_paths", "main"]


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    symbol: str
    message: str

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.symbol}] {self.message}")


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------

_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _qualnames(tree: ast.Module) -> Dict[ast.AST, str]:
    """node -> dotted qualname for every function/class definition,
    computed once per parsed tree (every rule asks for it)."""
    cached = getattr(tree, "_lint_qualnames", None)
    if cached is not None:
        return cached
    out: Dict[ast.AST, str] = {}

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _SCOPES):
                q = f"{prefix}.{child.name}" if prefix else child.name
                out[child] = q
                walk(child, q)
            else:
                walk(child, prefix)

    walk(tree, "")
    tree._lint_qualnames = out
    return out


def _functions(tree: ast.Module):
    q = _qualnames(tree)
    for node, name in q.items():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, name


def _shallow_walk(node):
    """Walk a subtree WITHOUT descending into nested function/class
    definitions (their bodies run in another dynamic scope)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, _SCOPES + (ast.Lambda,)):
            stack.extend(ast.iter_child_nodes(n))


def _src(node) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return "<expr>"


# ---------------------------------------------------------------------------
# HZ101: host syncs inside code a stage capture runs
# ---------------------------------------------------------------------------

#: methods whose call on a tensor waits for the device and copies to the
#: host
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
_HOST_NP_CALLS = ("asarray", "array", "frombuffer")


def _returns_stage_record(fn) -> bool:
    """Whether ``fn`` returns a tuple holding a ``Stage(...)`` call —
    the shape of a stage builder's ``make`` (``return step, Stage(...)``
    or ``SC.Stage(...)``)."""
    for n in _shallow_walk(fn):
        if isinstance(n, ast.Return) and isinstance(n.value, ast.Tuple):
            for e in n.value.elts:
                if isinstance(e, ast.Call):
                    f = e.func
                    name = f.id if isinstance(f, ast.Name) else \
                        f.attr if isinstance(f, ast.Attribute) else None
                    if name == "Stage":
                        return True
    return False


def _captured_functions(tree, qnames) -> Dict[ast.AST, str]:
    """Functions a stage capture runs: the functions nested in a stage
    builder's ``make`` (the step it returns), closed over same-module
    calls by bare name (as ``determinism.decision_closure``)."""
    funcs: Dict[str, List[ast.AST]] = {}
    for fn, _q in _functions(tree):
        funcs.setdefault(fn.name, []).append(fn)
    reached: Dict[ast.AST, str] = {}
    work: List[ast.AST] = []
    for fn, q in _functions(tree):
        if not _returns_stage_record(fn):
            continue
        for n in ast.walk(fn):
            if n is not fn and isinstance(n, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)) \
                    and n not in reached:
                reached[n] = qnames[n]
                work.append(n)
    while work:
        fn = work.pop()
        for n in _shallow_walk(fn):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            name = f.id if isinstance(f, ast.Name) else None
            for cn in funcs.get(name, ()):
                if cn not in reached:
                    reached[cn] = qnames[cn]
                    work.append(cn)
    return reached


def _host_sync_desc(n) -> Optional[str]:
    if not isinstance(n, ast.Call):
        return None
    f = n.func
    if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
            and not n.args and not n.keywords:
        return f"`{_src(n)}` waits for the device and copies to the host"
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id in ("np", "numpy") and f.attr in _HOST_NP_CALLS:
        return (f"host materialization `{_src(f)}(...)`: a device tensor "
                "cannot leave the card inside a capture")
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "torch" and f.attr in ("tensor", "as_tensor") \
            and any(k.arg == "device" for k in n.keywords):
        return (f"pageable copy `{_src(f)}(..., device=...)`: a tensor "
                "built from host values inside a capture (use "
                "capture.constant)")
    return None


def _rule_host_sync_in_capture(tree, path, qnames) -> List[Finding]:
    out = []
    for fn, qual in sorted(_captured_functions(tree, qnames).items(),
                           key=lambda kv: kv[0].lineno):
        for n in _shallow_walk(fn):
            desc = _host_sync_desc(n)
            if desc:
                out.append(Finding(
                    "HZ101", path, n.lineno, n.col_offset, qual,
                    f"{desc} inside a function a stage capture runs: it "
                    "fails the CUDA-graph capture or freezes a host value "
                    "into every replay (route it through capture.decide "
                    "or capture.constant)"))
    return out


# ---------------------------------------------------------------------------
# HZ102: ledger reserve without a release in a finally
# ---------------------------------------------------------------------------

def _rule_reserve_release(tree, path, qnames) -> List[Finding]:
    out = []
    for fn, qual in _functions(tree):
        reserves = []
        for n in ast.walk(fn):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("reserve", "try_reserve") \
                    and "ledger" in _src(n.func.value).lower():
                reserves.append(n)
        if not reserves:
            continue
        released = False
        for n in ast.walk(fn):
            if not isinstance(n, ast.Try) or not n.finalbody:
                continue
            for fin_stmt in n.finalbody:
                for m in ast.walk(fin_stmt):
                    if isinstance(m, ast.Call) \
                            and isinstance(m.func, ast.Attribute) \
                            and m.func.attr.startswith("release"):
                        released = True
        if not released:
            r = reserves[0]
            out.append(Finding(
                "HZ102", path, r.lineno, r.col_offset, qual,
                f"`{_src(r.func)}(...)` with no release/release_prefix "
                "in a finally block of this function: an error path "
                "leaks the host-memory reservation"))
    return out


# ---------------------------------------------------------------------------
# HZ103: unlocked shared state in lock-owning classes
# ---------------------------------------------------------------------------

_LOCK_CTORS = ("Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore")
_LOCKISH = ("lock", "cond", "_cv", "mutex", "_mu")


def _lockish(expr) -> bool:
    s = _src(expr).lower()
    return any(t in s for t in _LOCKISH)


def _rule_unlocked_state(tree, path, qnames) -> List[Finding]:
    out = []
    for cls, cqual in _qualnames(tree).items():
        if not isinstance(cls, ast.ClassDef):
            continue
        lock_attrs = set()
        for n in ast.walk(cls):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                    and isinstance(n.value.func, ast.Attribute) \
                    and n.value.func.attr in _LOCK_CTORS:
                for t in n.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        lock_attrs.add(t.attr)
        if not lock_attrs:
            continue
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                    or meth.name == "__init__":
                continue
            def guards(expr) -> bool:
                # any name that smells like a lock, or precisely one of
                # this class's own Lock/Condition attributes
                return _lockish(expr) or (
                    isinstance(expr, ast.Attribute)
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"
                    and expr.attr in lock_attrs)

            locked = False
            for n in ast.walk(meth):
                if isinstance(n, ast.With) \
                        and any(guards(i.context_expr) for i in n.items):
                    locked = True
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr == "acquire":
                    locked = True
            if locked:
                continue
            for n in _shallow_walk(meth):
                tgt = None
                if isinstance(n, ast.AugAssign):
                    tgt = n.target
                elif isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Subscript):
                    tgt = n.targets[0]
                if tgt is None:
                    continue
                base = tgt.value if isinstance(tgt, ast.Subscript) else tgt
                while isinstance(base, (ast.Subscript, ast.Attribute)):
                    base = base.value
                root = tgt.value if isinstance(tgt, ast.Subscript) else tgt
                if isinstance(base, ast.Name) and base.id == "self" \
                        and isinstance(root, (ast.Attribute,
                                              ast.Subscript)):
                    out.append(Finding(
                        "HZ103", path, n.lineno, n.col_offset,
                        f"{cqual}.{meth.name}",
                        f"`{_src(n).splitlines()[0]}` mutates shared "
                        f"state of lock-owning class {cls.name} without "
                        "taking its lock"))
                    break                  # one finding per method
    return out


# ---------------------------------------------------------------------------
# HZ104: blocking I/O while holding a lock
# ---------------------------------------------------------------------------

_IO_PREFIXES = ("time.sleep", "os.", "shutil.", "subprocess.", "socket.",
                "requests.", "urllib.")
_IO_SAFE_PREFIXES = ("os.path.", "os.environ", "os.getpid", "os.urandom",
                     "os.cpu_count", "os.sysconf")


def _rule_io_under_lock(tree, path, qnames) -> List[Finding]:
    out = []
    funcs = {n: q for n, q in _functions(tree)}

    def enclosing(with_node):
        best = "<module>"
        for fn, q in funcs.items():
            for n in ast.walk(fn):
                if n is with_node:
                    best = q
        return best

    for node in ast.walk(tree):
        if not isinstance(node, ast.With) \
                or not any(_lockish(i.context_expr) for i in node.items):
            continue
        sym = None
        for stmt in node.body:
            for n in _shallow_walk(stmt):
                if not isinstance(n, ast.Call):
                    continue
                fu = _src(n.func)
                blocking = fu == "open" or (
                    fu.startswith(_IO_PREFIXES)
                    and not fu.startswith(_IO_SAFE_PREFIXES))
                if blocking:
                    if sym is None:
                        sym = enclosing(node)
                    out.append(Finding(
                        "HZ104", path, n.lineno, n.col_offset, sym,
                        f"blocking call `{fu}(...)` while holding "
                        f"`{_src(node.items[0].context_expr)}`"))
    return out


# ---------------------------------------------------------------------------
# HZ106: unused module imports
# ---------------------------------------------------------------------------

def _rule_unused_imports(tree, path, qnames) -> List[Finding]:
    if path.endswith("__init__.py"):
        return []                         # re-export surfaces
    imported = []                         # (binding, display, node)
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                binding = a.asname or a.name.split(".")[0]
                imported.append((binding, a.name, n))
        elif isinstance(n, ast.ImportFrom):
            if n.module == "__future__":
                continue
            for a in n.names:
                if a.name == "*":
                    continue
                binding = a.asname or a.name
                imported.append((binding, a.name, n))
    if not imported:
        return []
    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    for n in ast.walk(tree):              # __all__ re-exports count
        if isinstance(n, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in n.targets):
            for c in ast.walk(n.value):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    used.add(c.value)
    out = []
    for binding, display, node in imported:
        if binding not in used:
            out.append(Finding(
                "HZ106", path, node.lineno, node.col_offset, "<module>",
                f"import `{display}` (as `{binding}`) is never used"))
    return out


# ---------------------------------------------------------------------------
# HZ107: bindings shadowing risky builtins
# ---------------------------------------------------------------------------

_RISKY_BUILTINS = frozenset((
    "id", "type", "input", "vars", "dir", "next", "hash", "bytes",
    "open", "eval", "exec", "compile", "super", "object", "property",
    "breakpoint",
))


def _rule_shadow_builtins(tree, path, qnames) -> List[Finding]:
    out = []
    seen = set()

    def flag(name, node, sym):
        key = (name, sym)
        if name in _RISKY_BUILTINS and key not in seen:
            seen.add(key)
            out.append(Finding(
                "HZ107", path, node.lineno, node.col_offset, sym,
                f"binding `{name}` shadows the builtin of the same name"))

    funcs = dict(_functions(tree))
    for fn, qual in funcs.items():
        a = fn.args
        for arg in (a.posonlyargs + a.args + a.kwonlyargs
                    + ([a.vararg] if a.vararg else [])
                    + ([a.kwarg] if a.kwarg else [])):
            flag(arg.arg, arg, qual)
    q = _qualnames(tree)

    def scope_of(node, default="<module>"):
        return default

    for n in ast.walk(tree):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            flag(n.id, n, "<module>" if n.col_offset == 0 else "<local>")
        elif isinstance(n, ast.ExceptHandler) and n.name:
            flag(n.name, n, "<local>")
    return out


# ---------------------------------------------------------------------------
# HZ108: CUDA graphs built outside the stage cache
# ---------------------------------------------------------------------------

#: the one module allowed to build CUDA graphs (``StageCache``)
_GRAPH_OWNER = "sql/stagecompile.py"


def _is_graph_build(n) -> bool:
    if not isinstance(n, ast.Call):
        return False
    c = _src(n.func)
    return c.endswith("CUDAGraph") or c.endswith("cuda.graph")


def _rule_graph_outside_stage_cache(tree, path, qnames) -> List[Finding]:
    """A ``torch.cuda.CUDAGraph(`` / ``torch.cuda.graph(`` outside
    ``sql/stagecompile.py``: a graph captured there per call re-captures
    the identical program every query and keeps its memory pool out of
    the stage cache's accounting and eviction (``memory.evict_lru``).
    Captures go through ``sql.stagecompile.StageCache.get_or_build``."""
    if path.replace(os.sep, "/").endswith(_GRAPH_OWNER):
        return []
    out = []
    for n in ast.walk(tree):
        if _is_graph_build(n):
            sym = "<module>"
            for fn, q in _functions(tree):
                if any(m is n for m in ast.walk(fn)):
                    sym = q
            out.append(Finding(
                "HZ108", path, n.lineno, n.col_offset, sym,
                f"`{_src(n.func)}(` outside the stage cache: a graph "
                "captured per call re-captures the identical program and "
                "holds a memory pool the stage cache cannot evict — "
                "capture through sql.stagecompile.StageCache"))
    return out


# ---------------------------------------------------------------------------
# HZ112: non-atomic writes in durable commit paths
# ---------------------------------------------------------------------------

_DURABLE_CLASS_HINTS = ("Log", "Sink", "Checkpoint", "State")
_COMMIT_METHOD_HINTS = ("commit", "add", "snapshot", "save")


def _is_write_open(n) -> bool:
    if not isinstance(n, ast.Call):
        return False
    f = n.func
    name = f.id if isinstance(f, ast.Name) else \
        f.attr if isinstance(f, ast.Attribute) else ""
    if name != "open" or len(n.args) < 2:
        return False
    mode = n.args[1]
    return isinstance(mode, ast.Constant) and isinstance(mode.value, str) \
        and "w" in mode.value


def _rule_nonatomic_durable_write(tree, path, qnames) -> List[Finding]:
    """A checkpoint/log/sink/state class's commit-flavored method that
    writes a file in place (``open(..., "w")`` with no ``os.replace`` /
    ``os.rename`` in the same method) can be torn by a crash mid-write —
    and unlike a torn TEMP file, a torn final file is what recovery will
    read.  The exactly-once contract (INVARIANTS.md
    checkpoint-atomicity) requires tmp + fsync + rename."""
    out = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef) \
                or not any(h in cls.name for h in _DURABLE_CLASS_HINTS):
            continue
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                    or not any(h in meth.name
                               for h in _COMMIT_METHOD_HINTS):
                continue
            atomic = any(
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("replace", "rename")
                for n in ast.walk(meth))
            if atomic:
                continue
            for n in ast.walk(meth):
                if _is_write_open(n):
                    out.append(Finding(
                        "HZ112", path, n.lineno, n.col_offset,
                        f"{cls.name}.{meth.name}",
                        "bare `open(..., \"w\")` in a durable commit "
                        "method with no rename: a crash mid-write "
                        "leaves a torn entry — stage to a temp file "
                        "and `os.replace`"))
    return out


# ---------------------------------------------------------------------------
# HZ113: block wire-format paths built outside the resolver seam
# ---------------------------------------------------------------------------

#: the block-service wire-format suffix set, assembled from bare stems
#: so the tuple's own literals don't trip the rule on this file
_BLOCK_FILE_SUFFIXES = tuple(
    "." + stem for stem in ("part", "done", "dict", "reg",
                            "delta", "snapshot"))

#: the resolver seam: the only modules allowed to spell block file
#: names — everything else must go through their path helpers so the
#: block service sees (and can adopt / reap) every file
_BLOCK_PATH_OWNERS = ("parallel/hostshuffle.py",
                      "parallel/blockserver.py",
                      "streaming/state.py")


def _block_suffix_of(node) -> Optional[str]:
    """The block-file suffix a string literal ends with, else None.
    For f-strings the TAIL constant decides — ``f"{x}.part"`` names a
    block file, ``f".part of {x}"`` does not."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        s = node.value
    elif isinstance(node, ast.JoinedStr) and node.values \
            and isinstance(node.values[-1], ast.Constant) \
            and isinstance(node.values[-1].value, str):
        s = node.values[-1].value
    else:
        return None
    for suf in _BLOCK_FILE_SUFFIXES:
        if s.endswith(suf):
            return suf
    return None


def _rule_block_path_outside_resolver(tree, path, qnames) -> List[Finding]:
    """A literal spelling a block wire-format file name outside the
    resolver modules: the block service owns those files (custody,
    adoption, TTL reclamation), so a hand-built path is a file the
    service cannot see — it dodges registration on the write side and
    races the orphan reaper on the read side.  Construct block paths
    through the owning module's helpers instead."""
    norm = path.replace(os.sep, "/")
    if any(norm.endswith(owner) for owner in _BLOCK_PATH_OWNERS):
        return []
    # docstrings and other bare-expression strings are prose, not paths
    prose = set()
    for n in ast.walk(tree):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(n, field, None)
            if isinstance(stmts, list):
                prose.update(id(s.value) for s in stmts
                             if isinstance(s, ast.Expr))
    out = []

    def visit(node, symbol):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _SCOPES):
                visit(child, qnames.get(child, child.name))
                continue
            suf = _block_suffix_of(child)
            if suf is not None and id(child) not in prose:
                out.append(Finding(
                    "HZ113", path, child.lineno, child.col_offset,
                    symbol,
                    f"block file name built outside the resolver seam "
                    f"(literal ends with `{suf}`): the block service "
                    "cannot register/adopt/reap a path it never sees — "
                    "use the owning module's path helpers"))
            if not isinstance(child, ast.JoinedStr):
                # a flagged f-string's tail constant would re-flag
                visit(child, symbol)

    visit(tree, "<module>")
    return out


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

_FILE_RULES = (_rule_host_sync_in_capture, _rule_reserve_release,
               _rule_unlocked_state, _rule_io_under_lock,
               _rule_unused_imports, _rule_shadow_builtins,
               _rule_graph_outside_stage_cache,
               _rule_nonatomic_durable_write,
               _rule_block_path_outside_resolver,
               rule_nondet_sources, rule_unordered_iteration,
               rule_protocol)


def lint_source(src: str, path: str = "<snippet>") -> List[Finding]:
    """Lint one source string (the unit-test surface)."""
    tree = ast.parse(src, filename=path)
    qnames = _qualnames(tree)
    findings: List[Finding] = []
    for rule in _FILE_RULES:
        findings.extend(rule(tree, path, qnames))
    return findings


def lint_files(files: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        try:
            findings.extend(lint_source(src, path))
        except SyntaxError as e:
            findings.append(Finding(
                "HZ000", path, e.lineno or 0, 0, "<module>",
                f"file does not parse: {e.msg}"))
    return findings


def _conf_coverage_findings() -> List[Finding]:
    from .confcheck import missing_planning_confs

    return [
        Finding("HZ105", rel, line, 0, "<module>",
                f"planning conf read `C.{name}` ({key}) is missing from "
                "serving/plancache.py PLANNING_CONF_KEYS: cached plans "
                "built under a different value would be served stale")
        for rel, line, name, key in missing_planning_confs()
    ]


def _collect_py(paths: Sequence[str]) -> List[str]:
    files = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            files.extend(os.path.join(root, n) for n in sorted(names)
                         if n.endswith(".py"))
    return files


def lint_paths(paths: Sequence[str], waiver_file: Optional[str] = None,
               conf_coverage: bool = True):
    """Lint files/directories; returns ``(unwaived, waived)`` finding
    lists, sorted by location."""
    files = _collect_py(paths)
    findings = lint_files(files)
    if conf_coverage:
        findings.extend(_conf_coverage_findings())
    findings.extend(repo_pairing_findings(files))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    waivers = load_waivers(waiver_file) if waiver_file else []
    unwaived = [f for f in findings if not is_waived(f, waivers)]
    waived = [f for f in findings if is_waived(f, waivers)]
    return unwaived, waived


def _default_waiver_file() -> Optional[str]:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cand = os.path.join(os.path.dirname(pkg), "tools",
                        "lint_waivers_torch.toml")
    return cand if os.path.exists(cand) else None


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_tpu_torch.analysis.lint",
        description="The port's hazard linter (see "
                    "spark_tpu_torch/analysis/INVARIANTS.md)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the "
                         "spark_tpu_torch package)")
    ap.add_argument("--waivers", default=None,
                    help="waiver TOML (default: "
                         "tools/lint_waivers_torch.toml)")
    ap.add_argument("--no-waivers", action="store_true",
                    help="report every finding, ignoring the waiver file")
    ap.add_argument("--determinism", action="store_true",
                    help="only the replica-determinism rules "
                         "(HZ109/HZ110)")
    ap.add_argument("--protocol", action="store_true",
                    help="only the exchange-protocol rules (HZ111)")
    args = ap.parse_args(argv)

    only = set()
    if args.determinism:
        only |= {"HZ109", "HZ110"}
    if args.protocol:
        only |= {"HZ111"}
    paths = args.paths or \
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    waiver_file = None if args.no_waivers else \
        (args.waivers or _default_waiver_file())
    unwaived, waived = lint_paths(paths, waiver_file)
    if only:
        unwaived = [f for f in unwaived if f.rule in only]
        waived = [f for f in waived if f.rule in only]
    for f in unwaived:
        print(f)
    rc = 1 if unwaived else 0
    # stale-waiver detection: only the default full-package lint can
    # prove a waiver dead (a path or rule subset simply never produces
    # the findings the waiver exists for)
    if not args.paths and not only and waiver_file:
        for w in dead_waivers(unwaived + waived,
                              load_waivers(waiver_file)):
            print(f"lint: remove dead waiver {w['rule']} "
                  f"path={w.get('path', '*')!r} "
                  f"symbol={w.get('symbol', '*')!r} — it matches no "
                  "finding; the code it excused has moved on")
            rc = 1
    print(f"lint: {len(unwaived)} finding(s), {len(waived)} waived",
          file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
