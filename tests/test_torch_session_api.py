"""The session API and the conf against ``spark_tpu``: the same calls
through both packages give the same answers.

``SparkSession.getActiveSession`` (the session executing on this thread,
else the last one built), ``Builder.enableHiveSupport``, the conf entries
the reference registers with defaults, ``SET`` of a planning conf, and
``DistributedExecution.live_view`` over one set of heartbeat verdicts.
"""

import threading

import pytest

from spark_tpu.parallel import executor as RX
from spark_tpu.serving import plancache as RPC
from spark_tpu.sql import planner as RP
from spark_tpu.sql.session import SparkSession as RSession
from spark_tpu_torch import config as TC
from spark_tpu_torch.parallel import executor as TX
from spark_tpu_torch.serving import plancache as TPC
from spark_tpu_torch.sql import planner as TP
from spark_tpu_torch.sql.session import SparkSession as TSession

#: conf keys the reference registers with defaults (spark_tpu/config.py)
REFERENCE_DEFAULTS = (
    "spark.master", "spark.default.parallelism",
    "spark.sql.shuffle.partitions", "spark.sql.execution.batch.capacity",
    "spark.sql.session.timeZone", "spark.speculation",
    "spark.driver.maxResultRows", "spark.sql.repl.eagerEval.enabled",
    "spark.sql.crossJoin.enabled")


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


@pytest.fixture
def keep_active(spark):
    """Both packages' process-wide active session, restored after the
    test (a new session makes itself the active one)."""
    saved = RSession._active, TSession._active
    yield
    RSession._active, TSession._active = saved


def _active_per_thread(session_cls, planner, sessions):
    """Each session runs one query on a thread of its own, both at once;
    inside each query ``getActiveSession`` is read on that thread.
    Returns, per thread, the index of the session it saw (None: another
    object), and the index the main thread sees after both ended."""
    inner = planner.QueryExecution._execute_inner
    meet = threading.Barrier(len(sessions))
    seen = {}

    def spy(self):
        name = threading.current_thread().name
        if name not in seen:
            meet.wait(timeout=60)      # every thread inside its query
            seen[name] = session_cls.getActiveSession()
            meet.wait(timeout=60)
        return inner(self)

    errors = []

    def run(s):
        try:
            s.range(3).collect()
        except BaseException as e:     # noqa: BLE001 — re-raised below
            errors.append(e)

    planner.QueryExecution._execute_inner = spy
    try:
        threads = [threading.Thread(target=run, args=(s,), name=f"t{i}")
                   for i, s in enumerate(sessions)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        planner.QueryExecution._execute_inner = inner
    assert not errors, errors

    def index(s):
        return next((i for i, x in enumerate(sessions) if x is s), None)

    return ([index(seen.get(f"t{i}")) for i in range(len(sessions))],
            index(session_cls.getActiveSession()))


def test_get_active_session_is_the_executing_one_per_thread(
        spark, tspark, keep_active):
    """Two sessions querying at once on two threads: each thread's query
    sees its own session; afterwards the last session built is active."""
    r = [spark.newSession(), spark.newSession()]
    t = [tspark.newSession(), tspark.newSession()]
    ref = _active_per_thread(RSession, RP, r)
    got = _active_per_thread(TSession, TP, t)
    assert ref == ([0, 1], 1)
    assert got == ref
    for s in t:
        s.stop()


def test_get_active_session_outside_a_query(spark, tspark, keep_active):
    """No query running: both packages answer the last session built."""
    r = spark.newSession()
    t = tspark.newSession()
    assert RSession.getActiveSession() is r
    assert TSession.getActiveSession() is t
    t.stop()


def test_builder_enable_hive_support_get_or_create(keep_active):
    """``SparkSession.builder.enableHiveSupport().getOrCreate()``, the
    first line of many PySpark programs: the builder is returned, and
    the session made answers a query as the reference's does."""
    RSession._active = TSession._active = None
    rb = RSession.builder
    tb = TSession.builder.config("spark.torch.device", "cpu")
    assert rb.enableHiveSupport() is rb
    assert tb.enableHiveSupport() is tb
    r = rb.enableHiveSupport().getOrCreate()
    t = tb.enableHiveSupport().getOrCreate()
    assert isinstance(t, TSession) and TSession._active is t
    assert TSession.builder.enableHiveSupport().getOrCreate() is t
    q = "SELECT id * 2 AS x FROM range(4)"
    assert [tuple(x) for x in t.sql(q).collect()] \
        == [tuple(x) for x in r.sql(q).collect()]
    t.stop()


@pytest.mark.parametrize("key", REFERENCE_DEFAULTS)
def test_conf_default_matches_reference(spark, tspark, key):
    """``spark.conf.get(key)`` gives the reference's default."""
    want = spark.conf.get(key)
    assert want is not None
    assert tspark.conf.get(key) == want
    assert type(tspark.conf.get(key)) is type(want)


@pytest.mark.parametrize("key,value", [
    ("spark.sql.shuffle.partitions", "16"), ("spark.master", "local[*]"),
    ("spark.sql.crossJoin.enabled", "false")])
def test_set_command_answers_as_reference(spark, tspark, key, value,
                                          keep_active):
    """``SET key`` answers the default, ``SET key=value`` the value, in
    both packages."""
    r, t = spark.newSession(), tspark.newSession()

    def rows(s, text):
        return [tuple(x) for x in s.sql(text).collect()]

    assert rows(t, f"SET {key}") == rows(r, f"SET {key}")
    assert rows(t, f"SET {key}") != [(key, "<undefined>")]
    assert rows(t, f"SET {key}={value}") == rows(r, f"SET {key}={value}")
    assert rows(t, f"SET {key}") == rows(r, f"SET {key}")
    t.stop()


def test_planning_conf_keys_cover_reference():
    """Every conf the reference's plan cache fingerprints is in the
    port's, so a ``SET`` of it evicts plans in both."""
    missing = sorted(RPC.PLANNING_CONF_KEYS - TPC.PLANNING_CONF_KEYS)
    assert missing == []


class _Heartbeat:
    def __init__(self, dead):
        self._dead = list(dead)

    def dead_hosts(self):
        return list(self._dead)


class _Service:
    def __init__(self, dead, recovered):
        self.heartbeat = _Heartbeat(dead) if dead is not None else None
        self.recovered_pids = set(recovered)


class _Session:
    def __init__(self, svc):
        self._crossproc_svc = svc


@pytest.mark.parametrize("verdicts", [
    None, ((), ()), (("host-1",), ()), ((), (2,)),
    (("host-0", "host-3"), (1,)), (("pool-7", "host-9"), ()),
    (None, (0, 3))], ids=lambda v: repr(v))
@pytest.mark.parametrize("n", [1, 4])
def test_live_view_matches_reference(n, verdicts):
    """``DistributedExecution.live_view`` over the same heartbeat verdicts
    and agreed-lost set gives the reference's process list."""
    svc = None if verdicts is None else _Service(*verdicts)
    got = []
    for cls in (RX.DistributedExecution, TX.DistributedExecution):
        ex = cls.__new__(cls)           # no mesh needed: only n is read
        ex.session, ex.n = _Session(svc), n
        got.append(ex.live_view())
    assert got[1] == got[0]
