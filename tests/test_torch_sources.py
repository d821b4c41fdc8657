"""The socket source, the kafka gate and the DStream shim of the port
against ``spark_tpu``'s on the CPU (``tests/test_sources.py``).

The socket test waits until the first micro-batch has registered the
memory sink's view before it queries the view: the JAX package's test
queries right after ``start()`` and fails now and then when the trigger
thread has not run yet (the view does not exist).  A rate source with a
fixed start and a file source decoding through each package's readers
are compared too."""

import socket
import threading
import time
import types

import numpy as np
import pytest

from spark_tpu_torch import config as TC
from spark_tpu_torch.sql.session import SparkSession as TSession
from torch_stream_common import Pkg, both


@pytest.fixture(scope="module")
def tspark(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sources")
    s = TSession(TC.Conf({"spark.torch.device": "cpu",
                          "spark.sql.warehouse.dir": str(root / "wh")}))
    yield s
    s.stop()


@pytest.fixture
def pkgs(spark, tspark):
    return [Pkg("spark_tpu", spark), Pkg("spark_tpu_torch", tspark)]


def _serve_lines(lines, port_holder, stop_evt):
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port_holder.append(srv.getsockname()[1])
    conn, _ = srv.accept()
    for line in lines:
        conn.sendall(line.encode() + b"\n")
    stop_evt.wait(5)
    conn.close()
    srv.close()


def _server(lines):
    port_holder, stop_evt = [], threading.Event()
    th = threading.Thread(target=_serve_lines,
                          args=(lines, port_holder, stop_evt), daemon=True)
    th.start()
    for _ in range(200):
        if port_holder:
            break
        time.sleep(0.01)
    return port_holder[0], stop_evt


def _socket(p):
    port, stop_evt = _server(["hello", "world"])
    df = (p.session.readStream.format("socket")
          .option("host", "127.0.0.1").option("port", port).load())
    q = (df.writeStream.format("memory").queryName("sock")
         .outputMode("append").start())
    try:
        deadline = time.time() + 10
        rows = []
        while time.time() < deadline:
            q.processAllAvailable()
            # the view exists once a batch reached the sink
            if q.lastProgress is not None:
                rows = p.session.sql("SELECT * FROM sock").collect()
                if len(rows) >= 2:
                    break
            time.sleep(0.05)
        return [sorted(r["value"] for r in rows)]
    finally:
        stop_evt.set()
        q.stop()


def test_socket_source_reads_lines(pkgs):
    assert both(pkgs, _socket) == [["hello", "world"]]


def test_kafka_source_gated_with_clear_error(pkgs):
    for p in pkgs:
        p.kafka.set_client_factory(None)
        with pytest.raises(p.AnalysisException, match="kafka"):
            p.session.readStream.format("kafka").load()


def _dstream(p):
    import importlib
    dstream = importlib.import_module(f"{p.root}.streaming.dstream")
    port, stop_evt = _server(["a", "b", "c"])
    ssc = dstream.StreamingContext(
        types.SimpleNamespace(_session=p.session), batchDuration=0.05)
    seen = []
    stream = ssc.socketTextStream("127.0.0.1", port)
    stream.foreachRDD(lambda bdf: seen.extend(
        r["value"] for r in bdf.collect()))
    ssc.start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and len(seen) < 3:
            for q in ssc._queries:
                q.processAllAvailable()
            time.sleep(0.05)
        return [sorted(seen)]
    finally:
        stop_evt.set()
        ssc.stop()


def test_dstream_shim_socket_foreach(pkgs):
    assert both(pkgs, _dstream) == [["a", "b", "c"]]


def _rate(p):
    """The rate source with a fixed start: the same offsets give the same
    (timestamp, value) rows in both packages."""
    src = p.core.RateStreamSource(10)
    src.t0 = 1_000.0
    b = src.get_batch(3, 9)
    return [[tuple(r) for r in b.to_pylist()]]


def test_rate_source_rows_with_a_fixed_start(pkgs):
    ref = both(pkgs, _rate)
    assert [v for _t, v in ref[0]] == list(range(3, 9))


def _files(p, tmp):
    import os
    d = os.path.join(tmp, p.root)
    os.makedirs(d)
    for i in range(3):
        p.session.createDataFrame({
            "x": np.arange(i * 5, i * 5 + 5, dtype=np.int64),
            "s": [f"w{j % 3}" for j in range(5)]}).write.parquet(
                os.path.join(d, f"f{i}"))
    src = p.core.FileStreamSource("parquet", d, None,
                                  {"maxfilespertrigger": "2"})
    end = src.get_offset()
    out = [end, sorted(tuple(r) for r in src.get_batch(None, 2).to_pylist()),
           sorted(tuple(r) for r in src.get_batch(2, 3).to_pylist()),
           [os.path.basename(f) for f in src.offset_metadata(None, 2)
            ["files"]]]
    return out


def test_file_source_batches_and_offset_metadata(pkgs, tmp_path):
    ref = both(pkgs, _files, str(tmp_path))
    assert ref[0] == 3 and len(ref[1]) == 10 and ref[3] == ["f0", "f1"]
