"""One run of one cell, through the port's SQL server.

Set-up makes the cell's tables from the seed and loads them into the
engine on the card, starts ``spark_tpu_torch.server.SQLServer`` in this
process on 127.0.0.1 (port 0) with one server session per client, and
warms every text of the mix: once to build and capture its stage-cache
entry, then once in every client's session.  The window is a closed
loop: each client POSTs its next text to ``/sql`` as soon as the reply
to its last one is read, until ``seconds`` have passed; requests in
flight at the close are waited for.  Then every reply is held against
the plain reference's answer of its text, computed from the same
generated tables after the window.
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from . import spec
from .trace import Tracer

#: modules no run may load, compared by whole top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "spark_tpu")

#: how long past the window's close a request in flight is waited for
LATE_S = 60.0

#: the session's warehouse: a fixed directory inside the checkout
WAREHOUSE = os.path.join(spec.CHECKOUT, "build", "benchmark", "warehouse")


class NoCard(RuntimeError):
    """The cell's cards are not there."""


@dataclass
class Reply:
    text: str
    client: int
    t0: float                        # issued (perf_counter seconds)
    t1: float                        # last byte of the reply read
    status: int                      # HTTP status; 0 if it never came
    body: bytes = b""
    rows: Any = None
    duration_ms: Optional[float] = None
    cache_hit: Optional[bool] = None

    @property
    def latency_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


@dataclass
class Context:
    """What the per-layer readers read (``layers/<metric>.py``)."""
    cell: spec.Cell
    tables: Dict[str, Dict[str, np.ndarray]]   # the generated host tables
    replies: List[Reply]             # the window's, outside the profile
    before: Dict[str, float]         # program counters at the window's open
    after: Dict[str, float]          # ... and at its close
    captured: Dict[str, Dict[str, int]]   # per text: launches captured
    trace: Any = None                # trace.TraceInfo of a --trace 1 run


@dataclass
class Outcome:
    result: Dict[str, Any]
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)


def _post(port: int, path: str, payload: dict, timeout: float):
    """(status, body bytes) of one POST to the server on 127.0.0.1."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = json.dumps(payload).encode()
        conn.request("POST", path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _counters() -> Dict[str, float]:
    """The program's own counters that the readers compare over the
    window: the stage cache's gauges."""
    from spark_tpu_torch.sql import stagecompile
    gauges = stagecompile.metrics_source()
    return {name: float(gauges[name]())
            for name in ("stage_cache_misses", "stage_cache_hits")}


def _captured_launches() -> Dict[str, int]:
    from spark_tpu_torch import cuda_a2a, cuda_agg
    return {"k1": sum(cuda_agg.CAPTURED_LAUNCHES.values()),
            "k2": int(cuda_a2a.CAPTURED_LAUNCHES)}


def text_order(texts: Dict[str, int], seed: int, client: int):
    """The client's texts: cycles of the weights (each text ``weight``
    times), each cycle in an order drawn from the seed and the client, so
    every seed sends the same mix."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 1000 + client])
    cycle = [t for t, w in texts.items() for _ in range(int(w))]
    while True:
        for i in rng.permutation(len(cycle)).tolist():
            yield cycle[i]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _engine_tables(gen, tables):
    """The generated columns as the engine ingests them: cents as
    ``decimal(7,2)`` integers and strings as codes into their sorted
    dictionary, each handed over as the ``PrebuiltColumn`` that the
    program's file readers hand it (so no column goes through floats or
    Python objects on the way); the rest as they are."""
    from spark_tpu_torch import types as T
    from spark_tpu_torch.columnar import PrebuiltColumn
    out = {}
    for name, cols in tables.items():
        types = {c: T.type_for_name(gen.SCHEMA[name][c]) for c in cols}
        arrays = {}
        for c, v in cols.items():
            if c in gen.CENTS:
                v = PrebuiltColumn(v, types[c], None)
            elif v.dtype.kind == "U":
                words, codes = np.unique(v, return_inverse=True)
                v = PrebuiltColumn(codes.reshape(-1).astype(np.int32),
                                   types[c], None, tuple(words.tolist()))
            arrays[c] = v
        schema = T.StructType([T.StructField(c, t) for c, t in types.items()])
        out[name] = (arrays, schema)
    return out


def held_columns(cell: spec.Cell, gen) -> Dict[str, List[str]]:
    """Every column of the configuration's tables: the deployment holds
    them all, whatever a mix reads.  A mix's ``tables`` names the columns
    its texts read, which must be among them."""
    held = {t: list(gen.SCHEMA[t]) for t in cell.config["tables"]}
    for t, cols in cell.mix["tables"].items():
        missing = set(cols) - set(held.get(t, ()))
        if missing:
            raise ValueError(f"{cell.name}: the mix reads {t}."
                             f"{sorted(missing)}, which the configuration "
                             "does not hold")
    return held


def _devices(device: str, chips: int):
    import torch
    if device != "cuda":
        return []
    return [torch.device("cuda", i) for i in range(chips)]


def _sync(devices) -> None:
    import torch
    for d in devices:
        torch.cuda.synchronize(d)


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is one the runs may not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", rows: Optional[Dict[str, int]] = None,
        started: Optional[float] = None) -> Outcome:
    """One run of the cell.  ``started`` is the process's start on the
    ``perf_counter`` clock (set-up is measured from it); ``rows`` replaces
    the configuration's row counts (the CPU tests' tiny scale)."""
    import torch
    t_start = time.perf_counter() if started is None else started
    cell = spec.load_cell(cell_name)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{torch.cuda.device_count()} cards visible, the "
                         f"cell needs {cell.chips}")
    devices = _devices(device, cell.chips)
    if trace:
        Tracer.prime(devices)
    mix = cell.mix
    clients = int(mix["clients"])
    parts: Dict[str, float] = {}

    # -- the tables, from the seed -------------------------------------
    t = time.perf_counter()
    gen = spec.generator(cell)
    tables = gen.generate(rows or cell.config["rows"], seed,
                          held_columns(cell, gen))
    parts["generate_s"] = time.perf_counter() - t

    from spark_tpu_torch import config as C
    from spark_tpu_torch.server import SQLServer
    from spark_tpu_torch.sql.session import SparkSession
    t = time.perf_counter()
    conf = {"spark.torch.device": device, "spark.sql.warehouse.dir": WAREHOUSE,
            **cell.conf}
    session = SparkSession(C.Conf(conf))
    for name, (arrays, schema) in _engine_tables(gen, tables).items():
        session.createDataFrame(arrays, schema=schema) \
            .createOrReplaceTempView(name)
    _sync(devices)
    parts["load_s"] = time.perf_counter() - t

    # -- the server, one session per client ------------------------------
    srv = SQLServer(session, host="127.0.0.1", port=0,
                    workers=max(clients, 1)).start()
    try:
        return _serve(cell, srv, session, tables, seed, seconds, trace,
                      devices, parts, t_start)
    finally:
        srv.stop()


def _serve(cell, srv, session, tables, seed, seconds, trace, devices,
           parts, t_start) -> Outcome:
    import torch
    port = srv.port
    mix = cell.mix
    clients = int(mix["clients"])
    sids = []
    for _ in range(clients):
        status, body = _post(port, "/session", {}, 60.0)
        if status != 200:
            raise RuntimeError(f"POST /session: {status} {body[:300]!r}")
        sid = json.loads(body)["sessionId"]
        # every server session sees the root session's tables: the same
        # plans, so the plan cache's fingerprints agree across sessions
        sess = srv._sessions[sid].session
        for name in tables:
            sess.catalog.register(name, session.catalog.lookup(name))
        sids.append(sid)

    # -- warm-up: build and capture each text, then each session's path -
    captured: Dict[str, Dict[str, int]] = {}
    for text, sql in cell.texts.items():
        c0 = _captured_launches()
        t = time.perf_counter()
        status, body = _post(port, "/sql", {"query": sql,
                                            "session": sids[0]}, 900.0)
        parts[f"build_{text}_s"] = time.perf_counter() - t
        if status != 200:
            raise RuntimeError(f"warm-up of {text}: HTTP {status} "
                               f"{body[:2000]!r}")
        c1 = _captured_launches()
        captured[text] = {k: c1[k] - c0[k] for k in c1}
    t = time.perf_counter()
    for sid in sids:
        for text, sql in cell.texts.items():
            status, body = _post(port, "/sql", {"query": sql,
                                                "session": sid}, 900.0)
            if status != 200:
                raise RuntimeError(f"second warm-up of {text}: HTTP "
                                   f"{status} {body[:2000]!r}")
    parts["warm_sessions_s"] = time.perf_counter() - t
    _sync(devices)
    if devices:
        parts["warm_memory_peak_gb"] = max(
            torch.cuda.max_memory_allocated(d) for d in devices) / 1e9

    # -- the window ----------------------------------------------------
    before = _counters()
    tracer = Tracer(devices, seconds) if trace else None
    replies: List[Reply] = []
    lock = threading.Lock()
    open_t = time.perf_counter()
    close_t = open_t + seconds
    setup_s = time.perf_counter() - t_start

    def client(c: int) -> None:
        order = text_order(mix["texts"], seed, c)
        while True:
            text = next(order)
            t0 = time.perf_counter()
            if t0 >= close_t:
                return
            payload = {"query": cell.texts[text], "session": sids[c]}
            try:
                with (tracer.span(text) if tracer else nullcontext()):
                    status, body = _post(port, "/sql", payload,
                                         seconds + LATE_S)
            except OSError as e:
                status, body = 0, repr(e).encode()
            t1 = time.perf_counter()
            with lock:
                replies.append(Reply(text, c, t0, t1, status, body))

    threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"bench-client-{c}")
               for c in range(clients)]
    for th in threads:
        th.start()
    if tracer is not None:
        tracer.run(open_t)
    for th in threads:
        th.join(timeout=max(close_t - time.perf_counter(), 0) + LATE_S + 30)
    hung = sum(th.is_alive() for th in threads)
    after = _counters()
    _sync(devices)
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
               default=0)
    srv.stop()

    # -- every reply against the reference -------------------------------
    for r in replies:
        if r.status == 200:
            doc = json.loads(r.body)
            r.rows = doc["rows"]
            r.duration_ms = float(doc["durationMs"])
            r.cache_hit = bool(doc["cacheHit"])
    t = time.perf_counter()
    want = {text: spec.reference(text)(tables) for text in cell.texts}
    ref_s = time.perf_counter() - t
    wrong = [r for r in replies if r.status == 200 and r.rows != want[r.text]]
    failed = [r for r in replies if r.status != 200]
    attempted = len(replies) + hung

    _log(f"[setup] {cell.name} seed {seed}: " + " ".join(
        f"{k}={v:.3f}" for k, v in parts.items())
        + f" setup_s={setup_s:.3f}; launches captured per text {captured}")
    _log(f"[window] {len(replies)} replies, {len(failed)} failed, "
         f"{len(wrong)} wrong, {hung} clients still waiting; reference "
         f"{ref_s:.3f} s")
    half = open_t + seconds / 2
    for text in cell.texts:
        lat = sorted(r.latency_ms for r in replies if r.text == text)
        if lat:
            _log(f"[latency] {text}: {len(lat)} replies, p50 "
                 f"{np.percentile(lat, 50):.2f} ms, p95 "
                 f"{np.percentile(lat, 95):.2f} ms")
    for name, part in (("first half", [r for r in replies if r.t0 < half]),
                       ("second half", [r for r in replies
                                        if r.t0 >= half])):
        if part:
            _log(f"[latency] {name}: {len(part)} replies, p95 "
                 f"{np.percentile([r.latency_ms for r in part], 95):.2f} ms")
    for r in (wrong + failed)[:3]:
        _log(f"[wrong] {r.text} client {r.client} HTTP {r.status}: "
             f"{(r.body or b'')[:600]!r} want {str(want.get(r.text))[:600]}")

    # -- metrics -------------------------------------------------------
    if tracer is not None:
        during = sum(tracer.overlaps(r.t0, r.t1) for r in replies)
        _log(f"[trace] profiler on {tracer.started - open_t:.3f}-"
             f"{tracer.stopped - open_t:.3f} s into the window; {during} "
             "replies overlap it and are left out of the replies' metrics")
    if tracer is None:
        done = [r for r in replies if r.t1 <= close_t and r.status == 200
                and r.rows == want[r.text]]
        lat = [r.latency_ms for r in replies]
        metrics = {
            "queries_per_s": (len(done) / seconds, "queries/s"),
            "latency_p95_ms": (float(np.percentile(lat, 95))
                               if lat else None, "ms"),
            "setup_s": (setup_s, "s"),
        }
        wanted = cell.end_to_end
    else:
        info = tracer.analyze()
        outside = [r for r in replies if r.status == 200
                   and not tracer.overlaps(r.t0, r.t1)]
        ctx = Context(cell=cell, tables=tables, replies=outside,
                      before=before, after=after, captured=captured,
                      trace=info)
        metrics = {}
        for m in cell.per_layer:
            metrics[m.name] = (spec.reader(m.name)(ctx), m.unit)
        wanted = cell.per_layer
    out_metrics = {}
    for m in wanted:
        value, unit = metrics.get(m.name, (None, m.unit))
        if value is not None:
            out_metrics[m.name] = {"value": value, "unit": unit}
    device_info = _device_info(devices, peak)
    result = {"correct": None, "attempted": attempted,
              "failed": len(failed) + hung, "metrics": out_metrics,
              "device": device_info}
    if tracer is not None:
        device_info.update(tracer.device_fields(info))
        result["breakdown"] = tracer.breakdown(info)
    checks = {
        "wrong_replies": {"value": len(wrong), "limit": 0},
        "failed_requests": {"value": len(failed) + hung, "limit": 0},
        "replies_at_least": {"value": len(replies), "limit": 1},
    }
    ok = (checks["wrong_replies"]["value"] <= 0
          and checks["failed_requests"]["value"] <= 0
          and checks["replies_at_least"]["value"] >= 1)
    result["correct"] = ok
    return Outcome(result=result, checks=checks)


def _device_info(devices, peak: int) -> Dict[str, Any]:
    import torch
    if not devices:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": len(devices), "memory_peak_bytes": int(peak)}
