"""Exchange-protocol conformance checking (lint rule HZ111), the port of
``spark_tpu/analysis/protocol.py``: the port's ``parallel/crossproc.py``
and ``parallel/hostshuffle.py`` keep the JAX package's manifest-round
protocol, byte for byte, so the same extraction and the same three
checks hold them to it.

The manifest-round protocol between ``crossproc.py`` and
``hostshuffle.py`` is a file-level contract: every coordination round
is named by an exchange-id template rooted at the statement's ``xid``
(``{xid}-digest``, ``{xid}-plan``, ``{xid}-sample``, ``{xid}-bcast``,
``{xid}-leaf{i}``, ``{xid}-gather``, ``{xid}-fin``,
``{xid}-recover{N}``, the data lanes ``{xid}-jL/-jR/-rL/-rR`` with
their ``.dict`` word sidecars), published once per sender
(``publish_manifest`` raises on reuse), gathered by every reader, and
— after a recovery — re-derived from the EPOCH-FENCED alias
``f"{xid}e{epoch}"`` so a re-execution can never read a dead epoch's
bytes.

This pass extracts every round-id template statically (f-strings whose
head is the xid variable, including one level of local aliasing like
``rid = f"{xid}-recover{epoch}"``) from the publish/gather call sites
and checks three properties, each a **HZ111** finding:

* **publish/gather pairing** — a statically-named round that some
  function publishes must be gathered somewhere (and vice versa),
  counting self-paired ops (``exchange``, ``_gather_all``, the refetch
  wrappers) as both sides: a one-sided round either deadlocks its
  readers at the barrier or leaks manifests nobody consumes.
* **single-use discipline** — no function publishes the same static
  round template twice: exchange ids are single-use by contract (the
  runtime guard in ``publish_manifest`` would raise mid-query; the
  lint catches it before it ships).
* **epoch fencing** — inside a loop that derives an epoch-fenced alias
  (``f"{xid}e{epoch}"``), no round id may be built from the UN-fenced
  base name: it would alias a consumed epoch-0 round and read stale
  blocks after recovery.

Pairing is a cross-file property (a round can publish in
``crossproc.py`` and gather in ``hostshuffle.py``), so it runs as a
repo-level pass over exactly those two files (``repo_pairing_findings``,
wired into ``lint_paths``); the per-file checks run on every linted
file through ``_FILE_RULES``, snippets included.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

__all__ = ["extract_rounds", "rule_protocol", "pairing_findings",
           "repo_pairing_findings", "lint_protocol_sources",
           "PROTOCOL_FILES"]

# the two files that implement the manifest-round protocol
PROTOCOL_FILES = ("parallel/crossproc.py", "parallel/hostshuffle.py")

# op name -> which side of a round the call represents.  "both" ops
# publish AND read the round internally (no one-sided partner needed).
_OP_SIDE = {
    "publish_manifest": "pub", "publish_sizes": "pub",
    "put": "pub", "put_frames": "pub", "commit": "pub",
    "_stage_map_side": "pub",
    "gather_manifests": "gath", "gather_sizes": "gath",
    "gather_sizes_ex": "gath", "collect": "gath", "barrier": "gath",
    "FetchSink": "gath",
    "exchange": "both", "exchange_spilled": "both",
    "refetch": "both", "refetch_spilled": "both",
    "_gather_all": "both", "_leaf_partition_flags": "both",
    "_exchange_with_refetch": "both",
    "_exchange_spilled_with_refetch": "both",
    "_route_exchange_merge": "both",
}
# round-CREATING publish ops (the single-use discipline applies to
# these; `put` is per-receiver-block and legitimately repeats)
_CREATING = ("publish_manifest", "publish_sizes")


class _Round:
    __slots__ = ("suffix", "side", "op", "qname", "path", "line", "col")

    def __init__(self, suffix, side, op, qname, path, line, col):
        self.suffix = suffix
        self.side = side
        self.op = op
        self.qname = qname
        self.path = path
        self.line = line
        self.col = col


def _L():
    from . import lint as L
    return L


def _template(e) -> Optional[str]:
    """Normalize an f-string to a template (`{}` per placeholder):
    ``f"{xid}-plan"`` -> ``"{}-plan"``.  Only templates HEADED by a
    placeholder are round ids (everything else — spill paths, ledger
    owners — has a literal head)."""
    if not isinstance(e, ast.JoinedStr):
        return None
    parts = []
    for v in e.values:
        if isinstance(v, ast.FormattedValue):
            parts.append("{}")
        elif isinstance(v, ast.Constant):
            parts.append(str(v.value))
    t = "".join(parts)
    return t if t.startswith("{}") and len(t) > 2 else None


def _callee(call) -> Optional[str]:
    f = call.func
    return f.id if isinstance(f, ast.Name) \
        else f.attr if isinstance(f, ast.Attribute) else None


def _fn_aliases(fn) -> Dict[str, str]:
    """One level of local template aliasing:
    ``rid = f"{xid}-recover{epoch}"`` makes ``rid`` resolve to the
    template at later op calls."""
    L = _L()
    out: Dict[str, str] = {}
    for n in L._shallow_walk(fn):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            t = _template(n.value)
            if t is not None:
                out[n.targets[0].id] = t
    return out


def extract_rounds(tree, path: str) -> List[_Round]:
    L = _L()
    out: List[_Round] = []
    for fn, qn in L._functions(tree):
        aliases = _fn_aliases(fn)
        for n in L._shallow_walk(fn):
            if not isinstance(n, ast.Call):
                continue
            op = _callee(n)
            side = _OP_SIDE.get(op)
            if side is None:
                continue
            t = None
            for a in n.args[:4]:
                t = _template(a)
                if t is None and isinstance(a, ast.Name):
                    t = aliases.get(a.id)
                if t is not None:
                    break
            if t is None:
                continue
            out.append(_Round(t[2:], side, op, qn, path,
                              n.lineno, n.col_offset))
    return out


def _static(suffix: str) -> bool:
    """A suffix we can reason about statically: a literal lane name,
    optionally with a trailing index placeholder (``-recover{}``,
    ``-leaf{}``).  A dynamic tag (``-{}``) names a data lane chosen at
    runtime — out of scope for pairing."""
    body = suffix[:-2] if suffix.endswith("{}") else suffix
    return body.startswith("-") and len(body) > 1 and "{}" not in body


def pairing_findings(rounds: List[_Round]) -> List:
    """Publish/gather pairing over an extracted round set."""
    L = _L()
    by: Dict[str, List[_Round]] = {}
    for r in rounds:
        if _static(r.suffix):
            by.setdefault(r.suffix, []).append(r)
    findings = []
    for suffix, rs in sorted(by.items()):
        sides = {r.side for r in rs}
        if "both" in sides or ("pub" in sides and "gath" in sides):
            continue
        r0 = min(rs, key=lambda r: (r.path, r.line))
        present, missing = ("published", "gathered") if "pub" in sides \
            else ("gathered", "published")
        findings.append(L.Finding(
            "HZ111", r0.path, r0.line, r0.col, r0.qname,
            f"manifest round '{{xid}}{suffix}' is {present} but never "
            f"{missing}: a one-sided round deadlocks its readers at "
            "the barrier or leaks manifests nobody consumes"))
    return findings


def _fencing_findings(tree, path: str) -> List:
    """Un-fenced round ids inside an epoch loop."""
    L = _L()
    findings = []
    for fn, qn in L._functions(tree):
        loops = [n for n in L._shallow_walk(fn)
                 if isinstance(n, (ast.While, ast.For))]
        for loop in loops:
            # the fencing site: f"{base}e{...}" somewhere in this loop
            fences: Dict[int, str] = {}
            for n in ast.walk(loop):
                if isinstance(n, ast.JoinedStr) and len(n.values) == 3 \
                        and isinstance(n.values[0], ast.FormattedValue) \
                        and isinstance(n.values[0].value, ast.Name) \
                        and isinstance(n.values[1], ast.Constant) \
                        and n.values[1].value == "e" \
                        and isinstance(n.values[2], ast.FormattedValue):
                    fences[id(n)] = n.values[0].value.id
            if not fences:
                continue
            bases = set(fences.values())
            for n in ast.walk(loop):
                if id(n) in fences or not isinstance(n, ast.JoinedStr):
                    continue
                if len(n.values) < 2 \
                        or not isinstance(n.values[0], ast.FormattedValue) \
                        or not isinstance(n.values[0].value, ast.Name) \
                        or n.values[0].value.id not in bases \
                        or not isinstance(n.values[1], ast.Constant) \
                        or not str(n.values[1].value).startswith("-"):
                    continue
                base = n.values[0].value.id
                findings.append(L.Finding(
                    "HZ111", path, n.lineno, n.col_offset, qn,
                    f"un-fenced round id {L._src(n)[:60]!r} inside the "
                    f"epoch loop: after a recovery it aliases the "
                    f"consumed epoch-0 round — derive it from the "
                    f"fenced alias of {base!r} instead"))
    return findings


def rule_protocol(tree, path: str, qnames) -> List:
    """HZ111 per-file checks: single-use discipline + epoch fencing.
    (Pairing is cross-file; see ``repo_pairing_findings``.)"""
    L = _L()
    findings = []
    per_fn: Dict[Tuple[str, str], List[_Round]] = {}
    for r in extract_rounds(tree, path):
        if r.side == "pub" and r.op in _CREATING and _static(r.suffix) \
                and not r.suffix.endswith("{}"):
            per_fn.setdefault((r.qname, r.suffix), []).append(r)
    for (qn, suffix), rs in sorted(per_fn.items()):
        for r in sorted(rs, key=lambda r: r.line)[1:]:
            findings.append(L.Finding(
                "HZ111", path, r.line, r.col, qn,
                f"round '{{xid}}{suffix}' is published more than once "
                "in this function: exchange-round ids are single-use "
                "(the publish_manifest reuse guard would raise "
                "mid-query)"))
    findings.extend(_fencing_findings(tree, path))
    return findings


def lint_protocol_sources(sources: Dict[str, str]) -> List:
    """Full HZ111 over in-memory sources (per-file checks + pairing
    across the given set) — the test harness entry point."""
    findings = []
    rounds: List[_Round] = []
    for path, src in sorted(sources.items()):
        tree = ast.parse(src)
        findings.extend(rule_protocol(tree, path, None))
        rounds.extend(extract_rounds(tree, path))
    findings.extend(pairing_findings(rounds))
    return findings


def repo_pairing_findings(files) -> List:
    """Cross-file pairing over the protocol pair.  Runs only when BOTH
    protocol files are in the linted set (pairing over a subset would
    flag every round whose partner lives in the other file)."""
    targets = [f for f in files
               if any(os.path.normpath(f).endswith(os.path.normpath(t))
                      for t in PROTOCOL_FILES)]
    if len({os.path.basename(t) for t in targets}) < len(PROTOCOL_FILES):
        return []
    rounds: List[_Round] = []
    for f in sorted(targets):
        try:
            with open(f, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
        except (OSError, SyntaxError):
            continue
        rounds.extend(extract_rounds(tree, f))
    return pairing_findings(rounds)
