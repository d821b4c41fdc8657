"""The port's listener bus, event log, history page, metric sinks and the
shuffle source's ``late_materialized_rows`` gauge against the JAX
package's (``tests/test_observability.py``): the same queries post the
same events in the same order, the history page of one log renders the
same in both packages, the sinks write the same layout, and the gauge
counts the same decoded rows."""

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest

import spark_tpu.config as RC
import spark_tpu_torch.config as TC
from spark_tpu.sql import functions as RF
from spark_tpu_torch.sql import functions as TF
from spark_tpu_torch.sql.session import SparkSession as TSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def tspark(tmp_path):
    s = TSession(TC.Conf({"spark.torch.device": "cpu",
                          "spark.sql.warehouse.dir": str(tmp_path / "wh")}))
    yield s
    s.stop()


def _frame():
    return pd.DataFrame({"k": np.arange(100, dtype=np.int64) % 7,
                         "v": np.arange(100, dtype=np.float64)})


def _mdf(session):
    return session.createDataFrame(_frame())


def _queries(session, F):
    """Three executions: a count, a grouped sum, a filtered collect."""
    df = _mdf(session)
    df.count()
    df.groupBy("k").agg(F.sum("v").alias("s")).collect()
    df.filter(F.col("v") > 90).collect()


def test_listener_bus_posts_one_pair_per_execution(spark, tspark):
    kinds = []
    for s, F in ((spark, RF), (tspark, TF)):
        events = []
        s.listenerManager.register(events.append)
        try:
            _queries(s, F)
        finally:
            s.listenerManager.unregister(events.append)
        kinds.append([e["event"] for e in events])
        ends = [e for e in events if e["event"] == "SQLExecutionEnd"]
        assert all(e["durationMs"] >= 0 and "error" not in e for e in ends)
        assert all(isinstance(e["metrics"], dict) for e in ends)
    assert kinds[1] == kinds[0]
    assert kinds[1] == ["SQLExecutionStart", "SQLExecutionEnd"] * 3


def test_listener_failure_does_not_break_query(tspark):
    def bad(_e):
        raise RuntimeError("boom")
    seen = []
    tspark.listenerManager.register(bad)
    tspark.listenerManager.register(seen.append)
    try:
        assert _mdf(tspark).count() == 100
    finally:
        tspark.listenerManager.unregister(bad)
        tspark.listenerManager.unregister(seen.append)
    tspark.listenerManager.unregister(bad)          # a second time: no-op
    assert [e["event"] for e in seen] == ["SQLExecutionStart",
                                          "SQLExecutionEnd"]


def test_failed_execution_posts_its_error(tspark):
    """A query that raises still closes its pair, the end with the error
    and no metrics."""
    events = []
    tspark.listenerManager.register(events.append)
    df = _mdf(tspark)
    tspark.cancelAllQueries()
    try:
        with pytest.raises(Exception) as info:
            df.count()
    finally:
        tspark.clear_cancel()
        tspark.listenerManager.unregister(events.append)
    assert [e["event"] for e in events] == ["SQLExecutionStart",
                                            "SQLExecutionEnd"]
    assert events[1]["error"].startswith(type(info.value).__name__)
    assert "metrics" not in events[1]


def _read_log(d):
    return [json.loads(x) for x in open(os.path.join(d, "eventlog.jsonl"))]


def test_event_log(spark, tspark, tmp_path):
    logs = []
    for tag, s, F, key in (("ref", spark, RF, RC.EVENT_LOG_DIR.key),
                           ("port", tspark, TF, TC.EVENT_LOG_DIR.key)):
        d = str(tmp_path / tag)
        s.conf.set(key, d)
        try:
            _queries(s, F)
        finally:
            s.conf.set(key, "")
        logs.append(_read_log(d))
    assert TC.EVENT_LOG_DIR.key == RC.EVENT_LOG_DIR.key == "spark.eventLog.dir"
    assert [e["event"] for e in logs[1]] == [e["event"] for e in logs[0]]
    assert [sorted(e) for e in logs[1]] == [sorted(e) for e in logs[0]]


def test_event_log_operator_metrics(tspark, tmp_path):
    """With ``spark.sql.metrics.enabled`` the end event carries the
    operator row counts the query execution recorded."""
    d = str(tmp_path / "evlog")
    tspark.conf.set(TC.EVENT_LOG_DIR.key, d)
    tspark.conf.set(TC.METRICS_ENABLED.key, "true")
    try:
        _mdf(tspark).filter(TF.col("v") < 50).groupBy("k").agg(
            TF.sum("v").alias("s")).collect()
        qe_metrics = tspark._last_qe.metrics
    finally:
        tspark.conf.set(TC.EVENT_LOG_DIR.key, "")
        tspark.conf.set(TC.METRICS_ENABLED.key, "false")
    end = _read_log(d)[-1]
    assert end["event"] == "SQLExecutionEnd"
    assert end["metrics"] == {f"{o}:{lbl}": v
                              for (o, lbl), v in qe_metrics.items()}
    assert end["metrics"]


def _synthetic_failure(d):
    with open(os.path.join(d, "eventlog.jsonl"), "a") as f:
        f.write(json.dumps({"event": "SQLExecutionStart", "time": 1.0,
                            "plan": "Project [boom]"}) + "\n")
        f.write(json.dumps({"event": "SQLExecutionEnd", "time": 2.0,
                            "durationMs": 1000.0,
                            "error": "RuntimeError: boom"}) + "\n")
        f.write(json.dumps({"event": "Custom", "x": 1}) + "\n")
        f.write('{"event": "SQLExecutionStart", "pla')   # a torn tail


def test_history_html_renderer(tspark, tmp_path):
    """The port's event log replays into one static HTML page; the JAX
    package's renderer gives the same page for the same log."""
    from spark_tpu.ui import render_history as r_render
    from spark_tpu.ui import load_events as r_load
    from spark_tpu_torch.ui import load_events, render_history, write_history
    d = str(tmp_path / "evlog2")
    tspark.conf.set(TC.EVENT_LOG_DIR.key, d)
    tspark.conf.set(TC.METRICS_ENABLED.key, "true")
    try:
        _mdf(tspark).filter(TF.col("v") > 50).count()
    finally:
        tspark.conf.set(TC.EVENT_LOG_DIR.key, "")
        tspark.conf.set(TC.METRICS_ENABLED.key, "false")
    _synthetic_failure(d)
    assert load_events(d) == r_load(d)
    html_text = render_history(d, title="history")
    assert html_text == r_render(d, title="history")
    for word in ("FINISHED", "FAILED", "metrics", "Other events"):
        assert word in html_text
    out = write_history(d)
    assert out == os.path.join(d, "history.html")
    assert open(out).read().startswith("<!doctype html>")


def test_history_cli_main(tspark, tmp_path, capsys):
    from spark_tpu_torch import ui
    d = str(tmp_path / "evlog3")
    tspark.conf.set(TC.EVENT_LOG_DIR.key, d)
    try:
        _mdf(tspark).count()
    finally:
        tspark.conf.set(TC.EVENT_LOG_DIR.key, "")
    assert ui.main([d]) == 0
    printed = capsys.readouterr().out.strip()
    assert printed.endswith("history.html") and os.path.exists(printed)
    out = str(tmp_path / "page.html")
    proc = subprocess.run(
        [sys.executable, "-m", "spark_tpu_torch.ui", d, out],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == out and os.path.exists(out)
    assert ui.main(["--help"]) == 0


def test_metrics_system_sources_and_sinks(tspark, tmp_path):
    """Process gauges snapshot on demand; console and CSV sinks record
    them, one CSV per source with a row per report."""
    from spark_tpu_torch.metrics import ConsoleSink, CsvSink, Source
    ms = tspark.metricsSystem
    before = ms.report().get("queries", {}).get("executed", 0)
    _mdf(tspark).count()
    snaps = ms.report()
    assert snaps["queries"]["executed"] >= before + 1
    assert snaps["memory"]["hbm_budget_bytes"] > 0
    buf = io.StringIO()
    ms.register_sink(ConsoleSink(buf))
    csv_dir = str(tmp_path / "metrics_csv")
    ms.register_sink(CsvSink(csv_dir))
    ms.report()
    ms.report()
    assert "memory" in buf.getvalue()
    rows = open(os.path.join(csv_dir, "queries.csv")).read().splitlines()
    assert rows[0].startswith("timestamp") and len(rows) == 3
    assert sorted(os.listdir(csv_dir)) == sorted(
        f"{name}.csv" for name in snaps)
    # a new gauge set rotates the old file rather than misalign columns
    ms.register_source(Source("custom", {"answer": lambda: 42}))
    assert ms.report()["custom"]["answer"] == 42
    ms._sources[-1] = Source("custom", {"answer": lambda: 1,
                                        "other": lambda: 2})
    ms.report()
    assert any(f.startswith("custom.csv.") for f in os.listdir(csv_dir))


def test_failing_sink_never_fails_report(tspark):
    class Broken:
        def report(self, _snaps):
            raise OSError("disk gone")
    tspark.metricsSystem.register_sink(Broken())
    assert "queries" in tspark.metricsSystem.report()


def test_sinks_from_conf_match_reference_layout(spark, tmp_path):
    """``spark.tpu.metrics.csv.dir`` / ``console.enabled`` attach the
    sinks at session start; each package writes one CSV per source with
    the header ``timestamp`` + the sorted gauge names."""
    from spark_tpu.metrics import MetricsSystem as RMetrics
    from spark_tpu_torch.metrics import (METRICS_CONSOLE, METRICS_CSV_DIR,
                                         METRICS_PERIOD, ConsoleSink,
                                         CsvSink)
    assert (METRICS_CONSOLE.key, METRICS_CSV_DIR.key, METRICS_PERIOD.key) \
        == ("spark.tpu.metrics.console.enabled", "spark.tpu.metrics.csv.dir",
            "spark.tpu.metrics.pollPeriodSeconds")
    d = str(tmp_path / "port_csv")
    s = TSession(TC.Conf({"spark.torch.device": "cpu",
                          "spark.tpu.metrics.csv.dir": d,
                          "spark.tpu.metrics.console.enabled": "true"}))
    try:
        kinds = sorted(type(k).__name__ for k in s.metricsSystem._sinks)
        assert kinds == ["ConsoleSink", "CsvSink"]
        assert isinstance(s.metricsSystem._sinks[0], (ConsoleSink, CsvSink))
        snaps = s.metricsSystem.report()
        assert sorted(os.listdir(d)) == sorted(f"{n}.csv" for n in snaps)
        header = open(os.path.join(d, "queries.csv")).readline().strip()
        assert header == "timestamp,executed"
    finally:
        s.stop()
    rd = str(tmp_path / "ref_csv")
    ref = RMetrics(RC.Conf({"spark.tpu.metrics.csv.dir": rd}))
    from spark_tpu.metrics import Source as RSource
    ref.register_source(RSource("queries", {"executed": lambda: 0}))
    ref.report()
    assert open(os.path.join(rd, "queries.csv")).readline().strip() == header


def test_metrics_start_polls_until_stop(tmp_path):
    d = str(tmp_path / "polled")
    s = TSession(TC.Conf({"spark.torch.device": "cpu",
                          "spark.tpu.metrics.csv.dir": d,
                          "spark.tpu.metrics.pollPeriodSeconds": "1"}))
    ms = s.metricsSystem
    try:
        ms.start()
        ms.start()                                   # a second start: no-op
        path = os.path.join(d, "queries.csv")
        deadline = time.time() + 10
        while time.time() < deadline and not (
                os.path.exists(path) and len(open(path).readlines()) >= 3):
            time.sleep(0.1)
        assert len(open(path).readlines()) >= 3      # header + 2 reports
    finally:
        s.stop()                                     # stops the poller
    assert ms._thread is None
    n = len(open(path).readlines())
    time.sleep(1.5)
    assert len(open(path).readlines()) == n


def test_late_materialized_rows_gauge(spark, tspark, tmp_path):
    """Decoding dictionary codes back into words at the output boundary
    is counted by the shuffle source's gauge, from 0 at the service's
    birth, alike in both packages."""
    from spark_tpu.columnar import ColumnBatch as RBatch
    from spark_tpu_torch.columnar import ColumnBatch as TBatch
    got = []
    for tag, s, B in (("ref", spark, RBatch), ("port", tspark, TBatch)):
        prev = getattr(s, "_crossproc_svc", None)
        ms = s.metricsSystem
        try:
            svc = s.enableHostShuffle(str(tmp_path / tag), process_id=0,
                                      n_processes=1, timeout_s=5.0)
            first = ms.snapshots()["shuffle"]["late_materialized_rows"]
            out = svc.exchange("dg2", {0: [
                B.from_arrays({"s": ["ash", "oak"], "n": [1, 2]}),
                B.from_arrays({"s": ["fir", "oak", None], "n": [3, 4, 5]})]})
            rows = [r for b in out for r in b.to_pylist()]
            after_exchange = ms.snapshots()["shuffle"][
                "late_materialized_rows"]
            got.append((first, after_exchange, sorted(
                rows, key=lambda r: (r[0] is None, r))))
        finally:
            s._crossproc_svc = prev
            ms._sources = [x for x in ms._sources if x.name != "shuffle"]
    assert got[1] == got[0]
    assert got[1][0] == 0 and got[1][1] == 5
