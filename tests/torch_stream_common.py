"""Shared helpers of the streaming parity tests (``tests/test_torch_*``
for streaming): one package's streaming surface as an object, so that a
scenario written once runs through the JAX package and through the port
on the same inputs, and the per-trigger outputs are compared."""

import importlib
import os

import numpy as np

from spark_tpu_torch.testing import assert_rows_equal

RTOL = 1e-9
SEC = 1_000_000


def sec(n) -> int:
    return int(n * SEC)


class Pkg:
    """One package (``spark_tpu`` or ``spark_tpu_torch``) and a session."""

    def __init__(self, root: str, session):
        self.root = root
        self.session = session
        self.T = importlib.import_module(f"{root}.types")
        self.F = importlib.import_module(f"{root}.sql.functions")
        self.core = importlib.import_module(f"{root}.streaming.core")
        self.state = importlib.import_module(f"{root}.streaming.state")
        self.kafka = importlib.import_module(f"{root}.streaming.kafka")
        self.faults = importlib.import_module(f"{root}.parallel.faults")
        self.AnalysisException = importlib.import_module(
            f"{root}.expressions").AnalysisException
        self.DataFrame = importlib.import_module(
            f"{root}.sql.dataframe").DataFrame

    @property
    def is_port(self) -> bool:
        return self.root == "spark_tpu_torch"

    def schema(self, *fields):
        """StructType of (name, type attribute of ``types``) pairs."""
        T = self.T
        return T.StructType([T.StructField(n, getattr(T, t))
                             for n, t in fields])

    def memory_stream(self, *fields):
        return self.core.MemoryStream(self.schema(*fields), self.session)

    def rows(self, name: str):
        """A memory sink's rows (its temp view), sorted."""
        return sorted((tuple(r) for r in self.session.sql(
            f"SELECT * FROM {name}").collect()), key=_key)

    def conf(self, key, value):
        self.session.conf.set(key, str(value))


def _key(row):
    return tuple((x is None, "" if x is None else repr(x)) for x in row)


def same(outs, rtol: float = RTOL) -> None:
    """The JAX package's output (first) and the port's (second), per
    trigger: equal rows, floats within ``rtol``, any order."""
    ref, port = outs
    assert len(ref) == len(port), (len(ref), len(port))
    for r, p in zip(ref, port):
        if isinstance(r, (list, tuple)) and r and isinstance(r[0], tuple):
            assert_rows_equal(r, p, rtol=rtol, ordered=False)
        else:
            assert r == p, (r, p)


def both(pkgs, scenario, *args, **kw):
    """Run ``scenario(pkg, *args)`` for each package; compare; return the
    reference's output."""
    outs = [scenario(p, *args, **kw) for p in pkgs]
    same(outs)
    return outs[0]


def state_rows(batch) -> int:
    """Live rows of a state batch of either package."""
    return int(np.asarray(batch.num_rows()))


def sink_files(out: str):
    import glob
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(out, "part-*")))}


def json_sink_rows(out: str):
    """A json file sink's rows by part file (value-level comparison of
    both packages' sinks)."""
    import glob
    import json
    res = {}
    for p in sorted(glob.glob(os.path.join(out, "part-*"))):
        with open(p) as f:
            res[os.path.basename(p)] = sorted(
                json.dumps(json.loads(line), sort_keys=True)
                for line in f if line.strip())
    return res
