"""Everything a cell is made of, found by name.

``BENCHMARK.json`` names a cell's configuration and traffic mix; each
of those, every query text, reference, generator and per-layer reader
is a file of its own under the benchmark's folder, found here by its
name.  A later cell, mix, configuration or metric is a new file and a
new entry: nothing in this module changes.
"""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

#: the benchmark's folder (``configs/``, ``traffic/``, ``queries/``, ...)
BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the checkout: ``BENCHMARK.json`` and the program's package
CHECKOUT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    bound: Optional[float] = None
    moves: Optional[str] = None
    layer: Optional[str] = None
    workloads: Optional[List[str]] = None


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and mix read."""
    name: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    texts: Dict[str, str]                 # text name -> SQL
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)

    @property
    def conf(self) -> Dict[str, str]:
        """The session conf: the configuration's, then the mix's."""
        return {**self.config.get("conf", {}), **self.mix.get("conf", {})}


def _applies(metric: Metric, cell: str) -> bool:
    return metric.workloads is None or cell in metric.workloads


def load_cell(name: str) -> Cell:
    """The cell ``name`` of the checkout's ``BENCHMARK.json``, with its
    configuration, mix and texts read."""
    spec = _json(os.path.join(CHECKOUT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(os.path.join(CHECKOUT, configs[w["config"]]["file"]))
    mix = _json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    texts = {}
    for text in mix["texts"]:
        with open(os.path.join(BENCH_DIR, "queries", f"{text}.sql")) as f:
            texts[text] = f.read()
    e2e = [Metric(**m) for m in spec["end_to_end"]]
    layers = [Metric(**m) for m in spec["per_layer"]]
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                texts=texts,
                end_to_end=[m for m in e2e if _applies(m, name)],
                per_layer=[m for m in layers if _applies(m, name)])


def generator(cell: Cell):
    """The configuration's table generator (``datagen/<name>.py``)."""
    return importlib.import_module(f"datagen.{cell.config['generator']}")


def reference(text: str) -> Callable:
    """The plain answer of ``text`` (``reference/<text>.py`` ``answer``)."""
    return importlib.import_module(f"reference.{text}").answer


def reader(metric: str) -> Callable:
    """The per-layer metric's reader (``layers/<metric>.py`` ``read``)."""
    return importlib.import_module(f"layers.{metric}").read
