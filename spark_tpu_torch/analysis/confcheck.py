"""The stale-cache detector: PLANNING_CONF_KEYS completeness (the port
of ``spark_tpu/analysis/confcheck.py``).

The serving plan cache fingerprints optimized plans together with the
values of every planning-relevant conf (``serving/plancache.py``'s
``PLANNING_CONF_ENTRIES``), and a ``SET`` of one of those keys evicts
entries built under the old value.  That list is hand-maintained — a
new conf read added to the planner without a matching fingerprint entry
is the silently-stale-cache bug class: two sessions with different
values would share one captured plan.

This rule closes the loop statically: parse the planning-decision files
(``sql/planner.py``, ``sql/physical.py``, ``parallel/crossproc.py``)
for attribute reads off the config module (``C.<ENTRY>``), resolve each
to its registered ``ConfigEntry``, and flag any whose key is missing
from ``PLANNING_CONF_KEYS``.
"""

from __future__ import annotations

import ast
import os
from typing import List, Tuple

__all__ = ["PLANNING_FILES", "planning_conf_reads",
           "missing_planning_confs"]

#: files whose conf reads steer what the planner/executor builds,
#: relative to the spark_tpu_torch package root
PLANNING_FILES = ("sql/planner.py", "sql/physical.py",
                  "parallel/crossproc.py")


def _config_aliases(tree: ast.Module) -> set:
    """Local names bound to the config module in this file
    (``from .. import config as C`` / ``import spark_tpu_torch.config as
    X``)."""
    aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "config":
                    aliases.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith(".config") and a.asname:
                    aliases.add(a.asname)
    return aliases


def planning_conf_reads(pkg_root: str = None
                        ) -> List[Tuple[str, int, str, str]]:
    """Every conf-entry read in the planning files, as
    ``(relpath, line, entry_name, conf_key)``.  Reads that do not
    resolve to a registered ``ConfigEntry`` are skipped (plain module
    attributes like ``C.conf``)."""
    from .. import config as config_mod

    if pkg_root is None:
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    reads: List[Tuple[str, int, str, str]] = []
    for rel in PLANNING_FILES:
        path = os.path.join(pkg_root, rel)
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        aliases = _config_aliases(tree)
        # conf reads inside function bodies import the module locally
        # (`from .. import config as C`), so aliases are file-wide
        if not aliases:
            continue
        seen = set()
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in aliases
                    and node.attr.isupper()):
                continue
            entry = getattr(config_mod, node.attr, None)
            key = getattr(entry, "key", None)
            if not isinstance(key, str):
                continue
            if node.attr in seen:
                continue
            seen.add(node.attr)
            reads.append((rel, node.lineno, node.attr, key))
    return reads


def missing_planning_confs(pkg_root: str = None
                           ) -> List[Tuple[str, int, str, str]]:
    """The completeness violations: planning-file conf reads whose key
    is NOT covered by the plan-cache fingerprint."""
    from ..serving.plancache import PLANNING_CONF_KEYS

    return [(rel, line, name, key)
            for rel, line, name, key in planning_conf_reads(pkg_root)
            if key not in PLANNING_CONF_KEYS]
