"""History viewer: static HTML over the JSON event log.

The compressed analog of the reference's web UI + history server
(`core/src/main/scala/org/apache/spark/ui/SparkUI.scala`,
`deploy/history/FsHistoryProvider.scala:74`,
`sql/core/.../execution/ui/`): the engine already writes a
self-describing JSONL event log (`session._post_event` when
``spark.eventLog.dir`` is set); this module replays it into one
dependency-free HTML page — query timeline, durations, errors, plans,
and per-operator row-count metrics.  No server: the page is a file,
which is also how the reference's history server treats finished
applications (read-only replay of the log).

    python -m spark_tpu_torch.ui <event-log-dir-or-file> [out.html]
"""

from __future__ import annotations

import html
import json
import os
import sys
from typing import Any, Dict, List, Optional

__all__ = ["load_events", "render_history", "write_history"]

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 2em; color: #1a1a2e; background: #fafafc; }
h1 { font-size: 1.4em; } h2 { font-size: 1.1em; margin-top: 1.6em; }
table { border-collapse: collapse; width: 100%; background: white; }
th, td { border: 1px solid #ddd; padding: 6px 10px; font-size: 0.9em;
         text-align: left; vertical-align: top; }
th { background: #eef0f6; }
tr.err td { background: #fdecec; }
pre { margin: 0; font-size: 0.85em; white-space: pre-wrap; }
.bar { background: #4c6ef5; height: 10px; display: inline-block; }
.dim { color: #777; font-size: 0.85em; }
details > summary { cursor: pointer; color: #4c6ef5; }
"""


def load_events(path: str) -> List[Dict[str, Any]]:
    """Events from an eventlog.jsonl file or a directory holding one."""
    if os.path.isdir(path):
        path = os.path.join(path, "eventlog.jsonl")
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue              # torn tail line of a live log
    return out


def _pair_queries(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Start/End event pairs in order (unterminated starts kept as
    running)."""
    queries: List[Dict[str, Any]] = []
    open_q: List[Dict[str, Any]] = []
    for e in events:
        kind = e.get("event")
        if kind == "SQLExecutionStart":
            q = {"start": e, "end": None}
            open_q.append(q)
            queries.append(q)
        elif kind == "SQLExecutionEnd" and open_q:
            open_q.pop()["end"] = e
    return queries


def _fmt_ms(ms: Optional[float]) -> str:
    if ms is None:
        return "—"
    if ms >= 60_000:
        return f"{ms / 60_000:.1f} min"
    if ms >= 1_000:
        return f"{ms / 1_000:.2f} s"
    return f"{ms:.0f} ms"


def _metrics_rows(metrics: Dict[str, Any]) -> str:
    rows = []
    for key in sorted(metrics, key=lambda k: int(k.split(":", 1)[0])):
        op_id, label = key.split(":", 1)
        rows.append(f"<tr><td>{html.escape(op_id)}</td>"
                    f"<td>{html.escape(label)}</td>"
                    f"<td style='text-align:right'>{metrics[key]:,}</td></tr>")
    return ("<table><tr><th>op</th><th>operator</th>"
            "<th>output rows</th></tr>" + "".join(rows) + "</table>")


def render_history(path: str, title: str = "spark_tpu_torch history") -> str:
    events = load_events(path)
    queries = _pair_queries(events)
    other = [e for e in events
             if e.get("event") not in ("SQLExecutionStart",
                                       "SQLExecutionEnd")]
    durations = [q["end"].get("durationMs", 0.0)
                 for q in queries if q["end"]]
    max_ms = max(durations, default=1.0) or 1.0

    rows = []
    for i, q in enumerate(queries):
        start, end = q["start"], q["end"]
        dur = end.get("durationMs") if end else None
        err = end.get("error") if end else None
        status = ("FAILED" if err else
                  "FINISHED" if end else "RUNNING")
        width = int(160 * (dur or 0) / max_ms)
        plan = start.get("plan", "")
        metrics = (end or {}).get("metrics") or {}
        detail = ""
        if plan:
            detail += (f"<details><summary>plan</summary>"
                       f"<pre>{html.escape(plan)}</pre></details>")
        if metrics:
            detail += (f"<details><summary>metrics "
                       f"({len(metrics)} ops)</summary>"
                       f"{_metrics_rows(metrics)}</details>")
        if err:
            detail += f"<pre>{html.escape(str(err))}</pre>"
        rows.append(
            f"<tr{' class=err' if err else ''}>"
            f"<td>{i}</td><td>{status}</td>"
            f"<td>{_fmt_ms(dur)} <span class=bar "
            f"style='width:{width}px'></span></td>"
            f"<td>{detail}</td></tr>")

    other_rows = "".join(
        f"<tr><td>{html.escape(str(e.get('event')))}</td>"
        f"<td><pre>{html.escape(json.dumps(e, default=str)[:500])}</pre>"
        f"</td></tr>" for e in other)

    n_done = sum(1 for q in queries if q["end"])
    n_err = sum(1 for q in queries
                if q["end"] and q["end"].get("error"))
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(title)}</title><style>{_CSS}</style></head><body>
<h1>{html.escape(title)}</h1>
<p class=dim>{len(queries)} queries ({n_done} finished, {n_err} failed),
{len(events)} events replayed from the log.</p>
<h2>Queries</h2>
<table><tr><th>#</th><th>status</th><th>duration</th><th>details</th></tr>
{''.join(rows)}</table>
{f'<h2>Other events</h2><table><tr><th>event</th><th>payload</th></tr>{other_rows}</table>' if other_rows else ''}
</body></html>"""


def write_history(path: str, out: Optional[str] = None) -> str:
    """Render the log at `path` to HTML next to it (or at `out`)."""
    if out is None:
        base = path if os.path.isdir(path) else os.path.dirname(path) or "."
        out = os.path.join(base, "history.html")
    html_text = render_history(path)
    with open(out, "w", encoding="utf-8") as f:
        f.write(html_text)
    return out


def main(argv: List[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    out = write_history(argv[0], argv[1] if len(argv) > 1 else None)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
