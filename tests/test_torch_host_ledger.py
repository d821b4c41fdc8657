"""The port's host memory ledger and spill-aware exchange staging, held
against the JAX package's.

- ``HostMemoryLedger``: the same reserve / release / try_reserve /
  release_prefix sequences drive both packages' ledgers, step by step:
  equal verdicts, ``used`` / ``free`` / ``held`` / ``peak``, and equal
  structured ``HostMemoryError``s (owner, request, budget, holders,
  exchange, message).
- ``FetchSink`` (the cases of the JAX package's
  ``tests/test_host_ledger.py``): fetched blocks land in RAM under the
  ledger or spill to wire run files, ``drain`` keeps own-first then
  sender order and batch boundaries, a re-add replaces, a drain over
  budget raises ``HostMemoryPressure`` (a ``HostMemoryError``), a failed
  spill is structured.
- Map-side spill: per-partition frames shipped as byte spans give the
  in-memory exchange's answer.
"""

import os

import numpy as np
import pytest

from spark_tpu import memory as RM
from spark_tpu_torch import config as C
from spark_tpu_torch import memory as TM
from spark_tpu_torch import wire
from spark_tpu_torch.columnar import ColumnBatch
from spark_tpu_torch.memory import (
    HOST_BUDGET, HostMemoryError, HostMemoryLedger, HostMemoryPressure,
    discover_host_budget)
from spark_tpu_torch.parallel.hostshuffle import FetchSink, HostShuffleService


def _batch(vals):
    return ColumnBatch.from_arrays({"v": np.asarray(vals, np.int64)})


def _values(batches):
    return [int(x) for b in batches
            for x, ok in zip(b.column("v").data.tolist(),
                             b.row_valid_or_true().tolist()) if ok]


# ---------------------------------------------------------------------------
# the ledger, step for step against the JAX package's
# ---------------------------------------------------------------------------

def _state(led, owners):
    return (led.used, led.free, led.peak, led.budget,
            tuple(led.held(o) for o in owners), sorted(led.owners()))


def _apply(led, op):
    kind = op[0]
    try:
        if kind == "try":
            return led.try_reserve(op[1], op[2])
        if kind == "reserve":
            return led.reserve(op[1], op[2], exchange=op[3])
        if kind == "release":
            return led.release(op[1], op[2])
        return led.release_prefix(op[1])
    except MemoryError as e:
        return (type(e).__name__, e.owner, e.requested, e.budget,
                e.holders, e.exchange, str(e))


_OWNERS = ["shuffle:xq000001:jL-map", "shuffle:xq000001:jL-fetch",
           "shuffle:xq000002:jR-map", "shuffle:xq000002:grace"]


def _sequence(seed, n_ops=200):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        owner = _OWNERS[int(rng.integers(0, len(_OWNERS)))]
        kind = rng.choice(["try", "reserve", "release", "release_all",
                           "prefix"])
        nb = int(rng.integers(0, 400))
        if kind == "try":
            ops.append(("try", owner, nb))
        elif kind == "reserve":
            ops.append(("reserve", owner, nb, "xq-ex"))
        elif kind == "release":
            ops.append(("release", owner, nb))
        elif kind == "release_all":
            ops.append(("release", owner, None))
        else:
            ops.append(("prefix", owner[:len("shuffle:xq00000") + 1]))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_ledger_sequences_match_reference(seed):
    t, r = TM.HostMemoryLedger(budget=1000), RM.HostMemoryLedger(budget=1000)
    for op in _sequence(seed):
        assert _apply(t, op) == _apply(r, op), op
        assert _state(t, _OWNERS) == _state(r, _OWNERS), op


def test_ledger_budget_from_conf_and_discovery():
    conf = C.Conf()
    conf.set(HOST_BUDGET.key, "12345")
    assert HostMemoryLedger(conf).budget == 12345
    assert HostMemoryLedger(C.Conf()).budget == discover_host_budget() \
        == RM.discover_host_budget()
    assert HostMemoryLedger(budget=77).budget == 77


@pytest.mark.parametrize("key", ["spark.tpu.memory.hostBudget",
                                 "spark.tpu.shuffle.spillThresholdBytes",
                                 "spark.tpu.recovery.maxStageRetries"])
def test_conf_set_after_enable_reference_fault(tmp_path, key):
    """A session's host budget, spill threshold or recovery budget SET
    after ``enableHostShuffle``: the JAX package read each once, when its
    service and ledger were built, so the SET is silently ignored (the
    service's ``grace_buckets`` reads its conf live); the port reads
    them live.  ROADMAP §3."""
    from spark_tpu import config as RC
    from spark_tpu.parallel.hostshuffle import HostShuffleService as RSvc

    def read(svc):
        if key.endswith("hostBudget"):
            return svc.ledger.budget
        if key.endswith("maxStageRetries"):
            return svc.max_stage_retries
        return svc.spill_threshold

    tconf, rconf = C.Conf().set(key, "4096"), RC.Conf().set(key, "4096")
    t = HostShuffleService(str(tmp_path / "t"), 0, 1, conf=tconf)
    r = RSvc(str(tmp_path / "r"), 0, 1, conf=rconf,
             ledger=RM.HostMemoryLedger(rconf))
    assert read(t) == read(r) == 4096
    tconf.set(key, "65536")
    rconf.set(key, "65536")
    assert read(r) == 4096                     # the reference's fault
    assert read(t) == 65536                    # the port follows the SET
    tconf.unset(key)
    if key.endswith("hostBudget"):
        assert read(t) == discover_host_budget()
    elif key.endswith("maxStageRetries"):
        assert read(t) == 1
    else:
        assert read(t) == 0


def test_hard_reserve_error_matches_reference():
    got = []
    for mod in (TM, RM):
        led = mod.HostMemoryLedger(budget=1000)
        led.reserve("shuffle:q:jL-map", 800)
        with pytest.raises(mod.HostMemoryError) as ei:
            led.reserve("shuffle:q:jR-map", 400, exchange="q-jR")
        e = ei.value
        assert isinstance(e, MemoryError) and led.used == 800
        got.append((e.owner, e.requested, e.budget, e.holders, e.exchange,
                    str(e)))
    assert got[0] == got[1]
    assert issubclass(HostMemoryPressure, HostMemoryError)


# ---------------------------------------------------------------------------
# FetchSink: the ledger-gated landing zone for fetched blocks
# ---------------------------------------------------------------------------

def _svc(tmp_path, budget, pid=0, n=1):
    return HostShuffleService(str(tmp_path / "root"), pid, n,
                              timeout_s=5.0, poll_s=0.02,
                              ledger=HostMemoryLedger(budget=budget))


def test_fetch_sink_in_memory_order_and_release(tmp_path):
    svc = _svc(tmp_path, budget=1 << 20)
    sink = FetchSink(svc, "shuffle:q:fetch", "q", str(tmp_path))
    sink.add(2, [_batch([20, 21])])
    sink.add(0, [_batch([0])])
    sink.add(-1, [_batch([9, 9])])             # own batches
    assert svc.ledger.used > 0
    assert _values(sink.drain()) == [9, 9, 0, 20, 21]
    sink.close()
    assert svc.ledger.used == 0
    assert svc.counters["spill_events"] == 0


def test_fetch_sink_spills_and_drains_identically(tmp_path):
    b_own, b1, b2 = _batch([1, 2, 3]), _batch([10] * 64), _batch([7] * 64)
    raw = wire.raw_nbytes([b1])
    svc = _svc(tmp_path, budget=1 << 20)
    sink = FetchSink(svc, "shuffle:q:fetch", "q", str(tmp_path),
                     spill_threshold=raw)
    sink.add(1, [b1])                          # forced to disk
    sink.add(2, [b2])                          # forced to disk
    sink.add(-1, [b_own])                      # small: stays in RAM
    assert svc.counters["spill_events"] >= 2
    assert svc.counters["spill_bytes"] > 0
    assert any(f.endswith(".fetch") for f in os.listdir(str(tmp_path)))
    out = sink.drain()
    assert svc.ledger.peak >= 2 * raw
    assert _values(out) == [1, 2, 3] + [10] * 64 + [7] * 64
    assert [b.capacity for b in out] \
        == [b_own.capacity, b1.capacity, b2.capacity]
    sink.close()
    assert svc.ledger.used == 2 * raw          # until the query's release
    svc.ledger.release_prefix("shuffle:q")
    assert svc.ledger.used == 0


def test_fetch_sink_drain_over_budget_fails_bounded(tmp_path):
    b1, b2 = _batch([10] * 64), _batch([7] * 64)
    raw = wire.raw_nbytes([b1])
    svc = _svc(tmp_path, budget=raw + raw // 2)   # fits ONE big batch
    sink = FetchSink(svc, "shuffle:q:fetch", "q", str(tmp_path))
    sink.add(1, [b1])
    sink.add(2, [b2])                          # over budget: a run file
    assert svc.counters["spill_events"] >= 1
    with pytest.raises(HostMemoryPressure) as ei:
        sink.drain()
    assert ei.value.owner == "shuffle:q:fetch"
    # the entries stay intact for a grace pass: they stream out whole
    assert _values(list(sink.pop_entries())) == [10] * 64 + [7] * 64
    sink.close()
    assert svc.ledger.used == 0


def test_fetch_sink_readd_is_idempotent(tmp_path):
    svc = _svc(tmp_path, budget=1 << 20)
    sink = FetchSink(svc, "shuffle:q:fetch", "q", str(tmp_path))
    sink.add(1, [_batch([5, 6])])
    held = svc.ledger.used
    sink.add(1, [_batch([5, 6])])
    assert svc.ledger.used == held
    assert _values(sink.drain()) == [5, 6]
    sink.close()


def test_fetch_sink_spill_failure_is_structured(tmp_path):
    svc = _svc(tmp_path, budget=64)            # nothing fits in RAM

    def broken(path, data, append=False, exchange=""):
        raise OSError(28, "No space left on device")
    svc.spill_write = broken
    sink = FetchSink(svc, "shuffle:q:fetch", "q", str(tmp_path))
    with pytest.raises(HostMemoryError) as ei:
        sink.add(1, [_batch([1] * 64)])
    assert "spill failed" in str(ei.value)
    assert ei.value.owner == "shuffle:q:fetch"
    sink.close()
    assert svc.ledger.used == 0


# ---------------------------------------------------------------------------
# map-side spill: per-partition frames, shipped as byte spans
# ---------------------------------------------------------------------------

def test_spill_map_partitions_offsets_and_spans(tmp_path):
    svc = _svc(tmp_path, budget=1 << 20)
    path = str(tmp_path / "q.map")
    offs = svc.spill_map_partitions(
        "q-x", [_batch([0, 1]), None, _batch([7, 8, 9])], path)
    assert len(offs) == 4 and offs[0] == 0
    assert offs[1] == offs[2]
    assert offs[3] == os.path.getsize(path)
    got = svc.decode_spilled("q-x", path, [(offs[2], offs[3] - offs[2])])
    assert _values(got) == [7, 8, 9]
    assert _values(svc.decode_spilled("q-x", path, [(0, offs[3])])) \
        == [0, 1, 7, 8, 9]


def test_exchange_spilled_matches_in_memory_exchange(tmp_path):
    b0, b1 = _batch([1, 2, 3]), _batch([40, 50])
    want = _svc(tmp_path / "m", budget=1 << 20).exchange("q", {0: [b0, b1]})
    svc = _svc(tmp_path / "s", budget=1 << 20)
    path = str(tmp_path / "s" / "q.map")
    offs = svc.spill_map_partitions("q", [b0, b1], path)
    routed = {0: [(offs[0], offs[2] - offs[0])]}
    got = svc.exchange_spilled("q", path, routed, {})
    assert _values(got) == _values(want) == [1, 2, 3, 40, 50]
    with pytest.raises(ValueError):
        svc.exchange_spilled("q", path, routed, {})


def test_exchange_spilled_dictionary_codes_roundtrip(tmp_path):
    b = ColumnBatch.from_arrays({"s": ["ash", "oak", "ash", "fir"]})
    svc = _svc(tmp_path, budget=1 << 20)
    path = str(tmp_path / "q.map")
    offs = svc.spill_map_partitions("qd", [b], path)
    got = svc.exchange_spilled("qd", path, {0: [(0, offs[1])]}, {})
    assert got[0].column("s").dictionary == ("ash", "fir", "oak")
    assert got[0].to_pylist() == b.to_pylist()


def test_drain_pressure_matches_reference(tmp_path):
    """The same deliveries under the same budget: both packages' sinks
    spill the same batches, and the drain that cannot reserve raises the
    same structured ``HostMemoryPressure``; both then stream the same
    entries for a grace pass."""
    from spark_tpu import columnar as RCol
    from spark_tpu.parallel import hostshuffle as RH
    vals = ([10] * 64, [7] * 64, [3] * 8)
    raw = wire.raw_nbytes([_batch(vals[0])])
    got = []
    for mod_mem, mod_hs, Batch, root in (
            (TM, None, ColumnBatch, tmp_path / "t"),
            (RM, RH, RCol.ColumnBatch, tmp_path / "r")):
        ledger = mod_mem.HostMemoryLedger(budget=raw + raw // 2)
        svc = (mod_hs.HostShuffleService if mod_hs else HostShuffleService)(
            str(root), 0, 1, timeout_s=5.0, ledger=ledger)
        sink = (mod_hs.FetchSink if mod_hs else FetchSink)(
            svc, "shuffle:q:fetch", "q", str(tmp_path))
        for s, v in enumerate(vals):
            sink.add(s, [Batch.from_arrays({"v": np.asarray(v, np.int64)})])
        with pytest.raises(mod_mem.HostMemoryPressure) as ei:
            sink.drain()
        e = ei.value
        streamed = [int(x) for b in sink.pop_entries()
                    for x, ok in zip(np.asarray(b.column("v").data),
                                     np.asarray(b.row_valid_or_true()))
                    if ok]
        got.append((e.owner, e.requested, e.budget, e.holders, e.exchange,
                    svc.counters["spill_events"], streamed, ledger.used))
        sink.close()
    assert got[0] == got[1]
