"""Adaptive query execution across REAL processes of the port on the
CPU, held against the JAX package.

Two (and, marked slow as in the JAX package, three) workers of
``python -m spark_tpu_torch.testing adaptive-worker <pid> <n> <dir>
adaptive`` run the battery of the JAX package's
``tests/adaptive_worker.py`` over the same seeded tables (each process a
strided slice): a hash join demoted to a broadcast at the stats barrier,
the same text answered from the recorded feedback at plan time, the
range lane's demotion, the frozen control (``adaptiveReplan`` false),
the post-sample skew re-split and partial-aggregate pushdown.  The JAX
package's single-process session answers every text over the whole
tables, here in the test process; every scenario's rows must equal it
(integers and strings, exact), its counter deltas must be those the JAX
package's worker asserts, and each process's ``ADAPT-OK`` totals those
the JAX package's worker prints at the same process count.
"""

import json
import os

import pytest
import torch

from spark_tpu_torch.testing import (
    ADAPTIVE_SCENARIOS, ADAPTIVE_TEXTS, adaptive_tables, adaptive_worker,
    check_scenario, run_scenario)

#: each scenario's counter deltas as ``tests/adaptive_worker.py`` asserts
#: them: (counter, "==" or ">=", value)
JAX_ASSERTS = {
    "DEMOTE": [("adaptive_replans", "==", 1), ("strategy_demotions", "==", 1),
               ("broadcast_joins", "==", 1), ("shuffled_joins", "==", 0)],
    "FEEDBACK": [("stats_feedback_hits", ">=", 1),
                 ("broadcast_joins", "==", 1),
                 ("shuffled_joins", "==", 0), ("adaptive_replans", "==", 0)],
    "RANGE-DEMOTE": [("adaptive_replans", "==", 1),
                     ("strategy_demotions", "==", 1),
                     ("broadcast_joins", "==", 1),
                     ("range_merge_joins", "==", 0)],
    "FROZEN": [("shuffled_joins", "==", 1), ("broadcast_joins", "==", 0),
               ("adaptive_replans", "==", 0), ("strategy_demotions", "==", 0)],
    "SKEW": [("range_merge_joins", "==", 1), ("spans_split", ">=", 1),
             ("post_sample_skew_splits", ">=", 1)],
    "AGGPUSH": [("shuffled_joins", "==", 1), ("strategy_demotions", "==", 0)],
}

#: the text each scenario runs (keys of ``ADAPTIVE_TEXTS``)
TEXT_OF = {name: text for name, text, _a in ADAPTIVE_SCENARIOS}

#: the JAX package worker's last line, the same at both process counts:
#:   JAX_PLATFORMS=cpu python tests/adaptive_worker.py <pid> <n> <dir> \
#:       adaptive 90        (one process per pid, n = 2 and n = 3)
JAX_TOTALS = {
    2: "replans=2 demotions=2 fbhits=3 postskew=1 bcast=3 shuffled=1 "
       "range=1",
    3: "replans=2 demotions=2 fbhits=3 postskew=1 bcast=3 shuffled=1 "
       "range=1",
}

_JAX = {}


def _jax_answers(spark):
    """The JAX package's single-process answer to each text over the
    whole tables."""
    if not _JAX:
        s = spark.newSession()
        s.conf.set("spark.tpu.mesh.shards", "1")
        for name, cols in adaptive_tables().items():
            s.createDataFrame(cols).createOrReplaceTempView(name)
        for key, sql in ADAPTIVE_TEXTS.items():
            _JAX[key] = [[v.item() if hasattr(v, "item") else v for v in r]
                         for r in s.sql(sql).collect()]
    return _JAX


def _holds(got, op, value):
    return got == value if op == "==" else got >= value


def _run_battery(spark, tmp_path, n):
    assert set(TEXT_OF) == set(JAX_ASSERTS)
    sc = {"name": f"adaptive-{n}", "worker": "adaptive-worker",
          "mode": "adaptive", "n": n, "timeout_s": 90.0, "plans": {},
          "expect": {pid: "ADAPT-OK" for pid in range(n)}}
    root = str(tmp_path / "run")
    results, elapsed = run_scenario(sc, root, "cpu")
    bad = check_scenario(sc, results, elapsed)
    assert not bad, (bad, {p: out[-2000:] for p, (_rc, out)
                           in results.items()})
    want = _jax_answers(spark)
    for pid in range(n):
        out = results[pid][1]
        for name in JAX_ASSERTS:
            assert f"[p{pid}] {name}-OK ({len(want[TEXT_OF[name]])} rows)" \
                in out, (name, out)
        assert f"[p{pid}] ADAPT-OK {JAX_TOTALS[n]}" in out, out
        with open(os.path.join(root, f"result-p{pid}.json")) as f:
            r = json.load(f)
        for name, asserts in JAX_ASSERTS.items():
            run = r["scenarios"][name]
            assert run["rows"] == want[TEXT_OF[name]], (name, pid)
            for counter, op, value in asserts:
                got = run["delta"].get(counter, 0)
                assert _holds(got, op, value), (name, pid, counter,
                                                run["delta"])
        assert r["scenarios"]["AGGPUSH"]["unpushed"]["rows"] == want["agg"]


def test_adaptive_parity_two_processes(spark, tmp_path):
    _run_battery(spark, tmp_path, 2)


@pytest.mark.slow
def test_adaptive_parity_three_processes(spark, tmp_path):
    _run_battery(spark, tmp_path, 3)


@pytest.mark.parametrize("argv", [["0", "2", "ROOT", "adaptive", "5"],
                                  ["0", "2", "ROOT", "adaptive", "5", "gpu"]])
def test_adaptive_worker_requires_a_device(tmp_path, argv):
    """Without ``cuda`` or ``cpu`` the worker raises, naming its argv,
    before it starts a session."""
    argv = [str(tmp_path) if a == "ROOT" else a for a in argv]
    with pytest.raises(ValueError, match=r"<device>.*got \["):
        adaptive_worker(argv)
    assert os.listdir(tmp_path) == []


def test_adaptive_worker_on_cuda_needs_a_card(tmp_path):
    """Given ``cuda`` with no card the worker raises; it never runs on
    the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        adaptive_worker(["0", "2", str(tmp_path), "card", "5", "cuda"])
    assert os.listdir(tmp_path) == []
