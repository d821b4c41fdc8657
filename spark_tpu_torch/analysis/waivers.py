"""Waiver file for the port's hazard linter
(``tools/lint_waivers_torch.toml``; the JAX package's parser, the same
format).

A minimal parser for exactly the subset the waiver file uses:
``[[waiver]]`` array-of-table headers followed by ``key = "string"``
pairs (the package takes no dependency for TOML).  Anything else is a
loud error — the waiver file is part of the lint contract and must not
half-parse.

Every waiver MUST carry a ``reason`` (the one-line justification the
checked-in file promises) and a ``rule``; ``path`` / ``symbol`` /
``contains`` narrow the match.
"""

from __future__ import annotations

import re
from typing import Dict, List

__all__ = ["load_waivers", "is_waived", "dead_waivers"]

_KV = re.compile(r'^([A-Za-z_][A-Za-z0-9_-]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*$')


def _unescape(s: str) -> str:
    return s.replace('\\"', '"').replace("\\\\", "\\")


def load_waivers(path: str) -> List[Dict[str, str]]:
    waivers: List[Dict[str, str]] = []
    cur: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for i, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line == "[[waiver]]":
                cur = {}
                waivers.append(cur)
                continue
            m = _KV.match(line)
            if m is None or not waivers:
                raise ValueError(
                    f"{path}:{i}: unsupported waiver syntax {line!r} "
                    "(expected [[waiver]] tables of key = \"value\")")
            cur[m.group(1)] = _unescape(m.group(2))
    for i, w in enumerate(waivers):
        if not w.get("rule"):
            raise ValueError(f"{path}: waiver #{i + 1} has no rule")
        if not w.get("reason"):
            raise ValueError(
                f"{path}: waiver #{i + 1} ({w.get('rule')}) has no "
                "reason — every waiver needs a one-line justification")
    return waivers


def _matches(finding, w: Dict[str, str]) -> bool:
    if w["rule"] != finding.rule:
        return False
    if w.get("path") and not finding.path.endswith(w["path"]):
        return False
    if w.get("symbol") and w["symbol"] != finding.symbol:
        return False
    if w.get("contains") and w["contains"] not in finding.message:
        return False
    return True


def is_waived(finding, waivers: List[Dict[str, str]]) -> bool:
    return any(_matches(finding, w) for w in waivers)


def dead_waivers(findings, waivers: List[Dict[str, str]]
                 ) -> List[Dict[str, str]]:
    """Waivers matching NO finding in a full-repo lint: the code they
    excused has moved or been fixed, and a stale waiver would silently
    swallow the next REAL finding that happens to match it.  The lint
    CLI fails on these with a "remove dead waiver" message."""
    return [w for w in waivers
            if not any(_matches(f, w) for f in findings)]
