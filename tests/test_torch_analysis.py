"""The port's analysis package against the JAX package's
(``tests/test_analysis.py``, case by case): the broken plans the verifier
rejects, the runtime checks of the cross-process lanes on the same
synthetic exchange state, the decision-trace hash, the hazard linter on
the same snippets (HZ101/HZ108 on snippets of their CUDA meaning), the
waiver machinery, the port's own source lint-clean, the plan cache's
planning confs, the verifier on under pytest, and the ``skew_decision``
fault ending every worker structured."""

import os
import tempfile
import textwrap

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spark_tpu import types as RT
from spark_tpu.analysis import runtime as raz
from spark_tpu.analysis import verify_plan as r_verify_plan
from spark_tpu.analysis.errors import PlanInvariantError as RError
from spark_tpu.analysis.lint import lint_source as r_lint_source
from spark_tpu.analysis.protocol import \
    lint_protocol_sources as r_protocol
from spark_tpu.columnar import ColumnBatch as RBatch
from spark_tpu.columnar import ColumnVector as RVector
from spark_tpu.expressions import Col as RCol
from spark_tpu.sql import logical as RL
from spark_tpu_torch import types as TT
from spark_tpu_torch.analysis import runtime as taz
from spark_tpu_torch.analysis import verify_plan as t_verify_plan
from spark_tpu_torch.analysis.confcheck import (missing_planning_confs,
                                                planning_conf_reads)
from spark_tpu_torch.analysis.errors import PlanInvariantError as TError
from spark_tpu_torch.analysis.lint import lint_paths, lint_source, main
from spark_tpu_torch.analysis.protocol import \
    lint_protocol_sources as t_protocol
from spark_tpu_torch.analysis.waivers import (dead_waivers, is_waived,
                                              load_waivers)
from spark_tpu_torch.columnar import ColumnBatch as TBatch
from spark_tpu_torch.columnar import ColumnVector as TVector
from spark_tpu_torch.expressions import Col as TCol
from spark_tpu_torch.sql import logical as TL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "spark_tpu_torch")
WAIVERS = os.path.join(REPO, "tools", "lint_waivers_torch.toml")


class _Pkg:
    """One package's side of a comparison: its types, batches, columns,
    logical plans, runtime checks and error type."""

    def __init__(self, name, T, L, Col, az, err, verify_plan):
        self.name, self.T, self.L, self.Col = name, T, L, Col
        self.az, self.err, self.verify_plan = az, err, verify_plan

    def batch(self, values, name="k", dtype=None, dictionary=None,
              valid=None):
        arr = np.asarray(values)
        if self.name == "ref":
            v = RVector(arr, dtype or RT.LongType(), valid, dictionary)
            return RBatch([name], [v], np.ones(len(arr), bool), len(arr))
        v = TVector(torch.from_numpy(arr.copy()), dtype or TT.int64,
                    None if valid is None else torch.from_numpy(valid),
                    dictionary)
        return TBatch([name], [v], torch.ones(len(arr), dtype=torch.bool),
                      len(arr))

    def rel(self, values, **kw):
        return self.L.LocalRelation(self.batch(values, **kw))

    def join(self, how="inner"):
        return self.L.Join(self.rel([1]), self.rel([1]), how,
                           on=self.Col("k") == self.Col("k"))

    def string(self):
        return RT.StringType() if self.name == "ref" else TT.string


REF = _Pkg("ref", RT, RL, RCol, raz, RError, r_verify_plan)
PORT = _Pkg("port", TT, TL, TCol, taz, TError, t_verify_plan)


def _outcome(pkg, fn):
    """None when ``fn(pkg)`` passes, else (property, node_name)."""
    try:
        fn(pkg)
    except pkg.err as e:
        return e.property, e.node_name
    return None


def _both(fn):
    ref, port = _outcome(REF, fn), _outcome(PORT, fn)
    assert port == ref, (port, ref)
    return port


# ---------------------------------------------------------------------------
# broken plans → both verifiers reject each, naming the same property
# ---------------------------------------------------------------------------

def _leaf_dtype(p):
    rel = p.rel([1, 2, 3])
    vec = rel.batch.vectors[0]
    vec.data = vec.data.astype(np.int32) if p.name == "ref" \
        else vec.data.to(torch.int32)
    p.verify_plan(rel)


def _unknown_join(p):
    j = p.join()
    j.how = "sideways"                   # post-construction mutation
    p.verify_plan(j)


BROKEN_PLANS = {
    "leaf-dtype": (_leaf_dtype, ("leaf-dtype", "LocalRelation")),
    "filter-not-boolean": (
        lambda p: p.verify_plan(p.L.Filter(p.Col("k"), p.rel([1, 2, 3]))),
        ("filter-condition-dtype", "Filter")),
    "project-unresolvable": (
        lambda p: p.verify_plan(p.L.Project([p.Col("nope")],
                                            p.rel([1, 2]))),
        None),
    "unknown-join-type": (_unknown_join, ("join-type", "Join")),
    "valid-join": (lambda p: p.verify_plan(p.join()), "pass"),
}


@pytest.mark.parametrize("case", sorted(BROKEN_PLANS))
def test_broken_plans_match_reference(case):
    fn, want = BROKEN_PLANS[case]
    got = _both(fn)
    if want == "pass":
        assert got is None
    elif want is None:                  # either slug, as the JAX test says
        assert got[0] in ("expr-dtype", "schema-propagation")
    else:
        assert got == want


def test_port_dtypes_map_to_their_engine_types():
    """A dtype the port holds on purpose (bool validity-free booleans,
    int32 string codes and dates, int64 decimals) is the one its engine
    type declares: a leaf of each passes; the same leaf claiming another
    type fails naming the column."""
    dec = TT.DecimalType(12, 2)
    for arr, dt in ((np.array([True, False]), TT.boolean),
                    (np.array([0, 1], np.int32), TT.string),
                    (np.array([10957, 10958], np.int32), TT.date),
                    (np.array([1234, -5], np.int64), dec),
                    (np.array([1.5, 2.5]), TT.float64)):
        b = TBatch(["c"], [TVector(torch.from_numpy(arr), dt, None,
                                   ("a", "b") if dt is TT.string
                                   else None)], None, len(arr))
        t_verify_plan(TL.LocalRelation(b))
        b.vectors[0].data = b.vectors[0].data.to(torch.int16)
        with pytest.raises(TError) as e:
            t_verify_plan(TL.LocalRelation(b))
        assert e.value.property == "leaf-dtype" and "'c'" in str(e.value)


def test_run_coded_leaf_checked_without_expanding():
    from spark_tpu_torch import columnar as col
    rv = col.RunColumnVector(torch.tensor([3, 7]), torch.tensor([2, 3]),
                             TT.int64)
    before = col.run_counters()["runs_materialized"]
    t_verify_plan(TL.LocalRelation(TBatch(["k"], [rv], None, 5)))
    assert col.run_counters()["runs_materialized"] == before
    assert not rv.is_materialized


def test_stage_contract_matches_reference():
    """A stage record whose output cut names other columns than its tree
    derives is rejected by both packages with ``stage-cut-schema``."""
    from spark_tpu.analysis import verify_stage_contract as rv
    from spark_tpu.sql import physical as RP
    from spark_tpu.sql.stagecompile import Stage as RStage
    from spark_tpu_torch.analysis import verify_stage_contract as tv
    from spark_tpu_torch.sql import physical as TP
    from spark_tpu_torch.sql.stagecompile import Stage as TStage

    for P, S, T, verify, err, long_t in (
            (RP, RStage, RT, rv, RError, RT.LongType()),
            (TP, TStage, TT, tv, TError, TT.int64)):
        schema = T.StructType([T.StructField("k", long_t)])
        scan = P.PScan(0, schema)
        verify(S(scan, [schema], schema, "k"))
        other = T.StructType([T.StructField("x", long_t)])
        with pytest.raises(err) as e:
            verify(S(scan, [schema], other, "k"))
        assert e.value.property == "stage-cut-schema"
        with pytest.raises(err) as e:
            verify(S(scan, [], schema, "k"))
        assert e.value.property == "stage-scan-leaf"


def test_port_queries_raise_plans_verified(tmp_path):
    """ZERO false positives on real plans of the port: the verifier is on
    under pytest (``verifyPlans=auto``) for a session that sets nothing,
    these queries must not trip it, and the ``analysis`` metrics source
    shows that it ran."""
    from spark_tpu_torch import config as TC
    from spark_tpu_torch.sql.session import SparkSession
    s = SparkSession(TC.Conf({"spark.torch.device": "cpu",
                              "spark.sql.warehouse.dir": str(tmp_path)}))
    assert s.conf.get(TC.ANALYSIS_VERIFY_PLANS) == "auto"
    before = dict(s._analysis_stats)
    df = s.createDataFrame({"k": [1, 2, 3], "w": ["a", "b", "a"],
                            "x": [1.5, -0.5, 2.25]})
    df.createOrReplaceTempView("az_t")
    s.sql("SELECT w, count(*) c, sum(x) sx FROM az_t "
          "GROUP BY w ORDER BY w").collect()
    s.sql("SELECT a.k, b.w FROM az_t a JOIN az_t b ON a.k = b.k "
          "WHERE a.x > 0").collect()
    st_ = s._analysis_stats
    assert st_["plans_verified"] > before["plans_verified"]
    assert st_["plan_verify_ms"] > before["plan_verify_ms"]
    snap = s.metricsSystem.snapshots()["analysis"]
    assert snap["plans_verified"] == st_["plans_verified"]
    assert snap["decision_trace_divergence"] == 0
    s.stop()


def test_verify_plans_conf_modes(monkeypatch):
    from spark_tpu_torch import config as TC
    from spark_tpu_torch.analysis import runtime_checks_enabled

    class _S:
        def __init__(self, v):
            self.conf = TC.Conf({"spark.tpu.analysis.verifyPlans": v})

    assert runtime_checks_enabled(_S("auto"))      # under pytest
    monkeypatch.delenv("PYTEST_CURRENT_TEST")
    assert not runtime_checks_enabled(_S("auto"))  # production
    assert runtime_checks_enabled(_S("on"))
    assert not runtime_checks_enabled(_S("off"))


# ---------------------------------------------------------------------------
# runtime checks on the same synthetic exchange state
# ---------------------------------------------------------------------------

class _Ledgers:
    @staticmethod
    def make(p):
        if p.name == "ref":
            from spark_tpu.memory import HostMemoryLedger
        else:
            from spark_tpu_torch.memory import HostMemoryLedger
        return HostMemoryLedger(budget=1 << 20)


def _ledger_case(owners, pre):
    def run(p):
        ledger = _Ledgers.make(p)
        for o in owners:
            ledger.reserve(o, 10)
        p.az.verify_ledger_scope(ledger, set(pre), "xq000001")
    return run


def _epoch_case(owners):
    def run(p):
        ledger = _Ledgers.make(p)
        for o in owners:
            ledger.reserve(o, 10)
        p.az.verify_epoch_released(ledger, "xq000001")
    return run


class _FakeSvc:
    """A service whose manifests are fixed: the shared bytes every peer
    read (both packages' reader names)."""

    def __init__(self, mans, n=2, recovered=(), epoch=0):
        self._m = mans
        self.n = n
        self.recovered_pids = set(recovered)
        self.epoch = epoch

    def read_manifest(self, exchange, sender):
        return self._m.get(sender)

    _read_manifest = read_manifest


def _recovery_case(mans, recovered, epoch_now, epoch):
    def run(p):
        p.az.verify_recovery_agreement(
            _FakeSvc(mans, 2, recovered, epoch_now), "xq000001", epoch)
    return run


def _run_plane_case(values, lengths, capacity):
    class RV:
        pass

    def run(p):
        rv = RV()
        if p.name == "ref":
            rv.run_values, rv.run_lengths = (np.asarray(values),
                                             np.asarray(lengths))
        else:
            rv.run_values, rv.run_lengths = (torch.tensor(values),
                                             torch.tensor(lengths))
        p.az.verify_run_plane(rv, capacity)
    return run


def _grace_rows(bucket):
    """Keys 0..63 whose grace bucket under (salt 1, 4 buckets) is
    ``bucket``, by the JAX package's hash."""
    from spark_tpu.parallel.crossproc import _grace_bucket_ids
    keys = np.arange(64, dtype=np.int64)
    ids = np.asarray(_grace_bucket_ids(REF.batch(keys), [RCol("k")], 4, 1))
    return keys[ids == bucket], keys[ids != bucket]


def _grace_case(mine: bool):
    def run(p):
        own, other = _grace_rows(2)
        side = p.batch(own if mine else np.concatenate([own, other[:1]]))
        p.az.verify_grace_bucket_partition(
            p.join(), [p.Col("k")], [p.Col("k")], 4, 1, 2, side, side)
    return run


def _elastic_case(width, target):
    mans = {0: {"sides": {"l": [9000, 90], "r": [9000, 90]}},
            1: {"sides": {"l": [9000, 90], "r": [9000, 90]}}}

    def run(p):
        p.az.verify_elastic_reducer_plan(p.join(), width, mans, 2, target)
    return run


def _strategy_case(how, strategy, range_ok=True, keys=True, frozen=None,
                   observed=None, bt=0):
    def run(p):
        pairs = [(p.Col("k"), p.Col("k"))] if keys else []
        p.az.verify_join_strategy(p.join(how), strategy, range_ok, pairs,
                                  frozen=frozen, observed=observed,
                                  broadcast_threshold=bt, n_procs=2)
    return run


def _copartition_case(bounds, pid, values=(1, 2, 3, 4, 5)):
    def run(p):
        shard = p.batch(list(values))
        p.az.verify_hash_copartition(p.join(), [(p.Col("k"), p.Col("k"))],
                                     bounds, 4, pid, shard, shard)
    return run


def _dict_case(codes, words):
    def run(p):
        b = p.batch(codes, dtype=p.string(), dictionary=words)
        p.az.verify_unified_dictionaries(p.join(), [b])
    return run


RUNTIME_CASES = {
    "copartition-foreign-rows": _copartition_case([0, 0, 4], 0),
    "copartition-owner": _copartition_case([0, 0, 4], 1),
    "copartition-elastic-trailing": _copartition_case([0, 4], 1),
    "reducer-bounds-malformed": _copartition_case([0, 3], 0, (1,)),
    "cutpoints-increasing": lambda p: p.az.verify_range_cutpoints(
        p.join(), [1, 5, 9], False),
    "cutpoints-repeat": lambda p: p.az.verify_range_cutpoints(
        p.join(), [1, 5, 5], False),
    "cutpoints-words": lambda p: p.az.verify_range_cutpoints(
        p.join(), ["b", "a"], True),
    "span-owners-ok": lambda p: p.az.verify_span_owners(
        p.join(), [[0], [1], [0, 1]], 3, 2),
    "span-owners-count": lambda p: p.az.verify_span_owners(
        p.join(), [[0], [1]], 3, 2),
    "span-owners-empty": lambda p: p.az.verify_span_owners(
        p.join(), [[0], [], [1]], 3, 2),
    "span-owners-dup": lambda p: p.az.verify_span_owners(
        p.join(), [[0], [1, 1], [0]], 3, 2),
    "span-owners-range": lambda p: p.az.verify_span_owners(
        p.join(), [[0], [5], [1]], 3, 2),
    "skew-split-left": lambda p: p.az.verify_skew_split(
        p.join("left"), [[0], [0, 1]]),
    "skew-split-full": lambda p: p.az.verify_skew_split(
        p.join("full"), [[0], [0, 1]]),
    "presorted-sorted": lambda p: p.az.verify_presorted_build(
        p.join(), p.batch([1, 2, 9]), p.Col("k"), False),
    "presorted-unsorted": lambda p: p.az.verify_presorted_build(
        p.join(), p.batch([3, 1, 2]), p.Col("k"), False),
    "presorted-null-gap": lambda p: p.az.verify_presorted_build(
        p.join(), p.batch([1, 2, 3], valid=np.array([True, False, True])),
        p.Col("k"), False),
    "dictionary-good": _dict_case([0, 1, 0], ("apple", "pear")),
    "dictionary-unsorted": _dict_case([0, 1], ("pear", "apple")),
    "dictionary-oob": _dict_case([0, 7], ("a", "b")),
    "ledger-scoped": _ledger_case(["shuffle:xq000001:jL-map"], []),
    "ledger-stray": _ledger_case(["shuffle:xq000001:jL-map",
                                  "stray-owner"], []),
    "ledger-pre-existing": _ledger_case(["stray-owner"], ["stray-owner"]),
    "epoch-released": _epoch_case(["cache:x"]),
    "epoch-stale": _epoch_case(["shuffle:xq000001e1:jL-map"]),
    "run-plane-ok": _run_plane_case([3, 7], [2, 3], 5),
    "run-plane-zero-run": _run_plane_case([3, 7], [5, 0], 5),
    "run-plane-ragged": _run_plane_case([3, 7, 9], [2, 3], 5),
    "run-plane-short": _run_plane_case([3, 7], [2, 2], 5),
    "recovery-agreed": _recovery_case(
        {0: {"epoch": 1, "lost": [1]}}, [1], 1, 1),
    "recovery-epochs-differ": _recovery_case(
        {0: {"epoch": 1, "lost": [1]}, 1: {"epoch": 2, "lost": []}},
        [1], 2, 1),
    "recovery-not-absorbed": _recovery_case(
        {0: {"epoch": 1, "lost": [1]}}, [], 1, 1),
    "recovery-epoch-behind": _recovery_case(
        {0: {"epoch": 1, "lost": [1]}}, [1], 0, 1),
    "elastic-agrees": _elastic_case(1, 1 << 20),
    "elastic-differs": _elastic_case(2, 1 << 20),
    "grace-bucket-own": _grace_case(True),
    "grace-bucket-torn": _grace_case(False),
    "strategy-legal": _strategy_case("inner", "hash"),
    "strategy-unknown": _strategy_case("inner", "sideways"),
    "strategy-broadcast-preserved": _strategy_case("full",
                                                   "broadcast_right"),
    "strategy-broadcast-left-of-left": _strategy_case("left",
                                                      "broadcast_left"),
    "strategy-range-ineligible": _strategy_case("inner", "range",
                                                range_ok=False),
    "strategy-no-keys": _strategy_case("inner", "hash", keys=False),
    "strategy-adaptive-agrees": _strategy_case(
        "inner", "broadcast_right", frozen="hash",
        observed=(9000, 90, 10, 1), bt=2048),
    "strategy-adaptive-diverged": _strategy_case(
        "inner", "hash", frozen="hash", observed=(9000, 90, 10, 1),
        bt=2048),
    "strategy-adaptive-promotion": _strategy_case(
        "inner", "hash", frozen="gather", observed=None, bt=2048),
}


#: the cases whose state is legal: both packages let them pass
PASSING = {"copartition-owner", "cutpoints-increasing", "span-owners-ok",
           "skew-split-left", "presorted-sorted", "dictionary-good",
           "ledger-scoped", "ledger-pre-existing", "epoch-released",
           "run-plane-ok", "recovery-agreed", "elastic-agrees",
           "grace-bucket-own", "strategy-legal",
           "strategy-adaptive-agrees"}


@pytest.mark.parametrize("case", sorted(RUNTIME_CASES))
def test_runtime_checks_match_reference(case):
    """Each runtime check, fed the same exchange state in both packages,
    passes in both or raises in both with the same property."""
    got = _both(RUNTIME_CASES[case])
    assert (got is None) == (case in PASSING), (case, got)


def test_runtime_hash_copartition_keeps_run_shards_compressed():
    """A run-coded key checks over its run heads: the shard is not
    expanded to verify its routing."""
    from spark_tpu_torch import columnar as col
    rv = col.RunColumnVector(torch.tensor([1, 2, 3]),
                             torch.tensor([4, 4, 4]), TT.int64)
    shard = TBatch(["k"], [rv], None, 12)
    before = col.run_counters()["runs_materialized"]
    with pytest.raises(TError) as e:
        taz.verify_hash_copartition(PORT.join(), [(TCol("k"), TCol("k"))],
                                    [0, 0, 4], 4, 0, shard, shard)
    assert e.value.property == "hash-co-partitioning"
    taz.verify_hash_copartition(PORT.join(), [(TCol("k"), TCol("k"))],
                                [0, 0, 4], 4, 1, shard, shard)
    assert col.run_counters()["runs_materialized"] == before


# ---------------------------------------------------------------------------
# the decision trace
# ---------------------------------------------------------------------------

_leaf = st.one_of(st.integers(-(1 << 62), 1 << 62), st.text(max_size=8),
                  st.booleans(), st.none())
_value = st.recursive(
    _leaf, lambda inner: st.one_of(
        st.lists(inner, max_size=4),
        st.dictionaries(st.text(max_size=6), inner, max_size=4)),
    max_leaves=12)


@settings(max_examples=150, deadline=None)
@given(st.dictionaries(st.text(max_size=8), _value, max_size=6))
def test_decision_trace_hash_equals_reference(components):
    assert taz.decision_trace(components) == raz.decision_trace(components)


def test_decision_trace_scalars_and_sequences():
    """numpy scalars hash as the JAX package hashes them; a tensor as the
    numpy values it holds; tuples as lists."""
    d = {"frozen": "hash", "epoch": np.int64(3), "cuts": (1, 5),
         "live": [0, 1], "f": np.float32(0.1)}
    assert taz.decision_trace(d) == raz.decision_trace(d)
    t = dict(d, epoch=torch.tensor(3), f=torch.tensor(0.1,
                                                      dtype=torch.float32))
    assert taz.decision_trace(t) == raz.decision_trace(d)
    assert taz.decision_trace({"a": 1, "b": 2}) \
        == taz.decision_trace({"b": 2, "a": 1})


class _Sess:
    pass


def _trace_inputs(**over):
    d = {"frozen": "hash", "epoch": 0, "live": [0, 1], "adopt": []}
    d.update(over)
    return d


def _peer_trace_case(pkg):
    inputs = _trace_inputs()
    theirs = _trace_inputs(epoch=1)
    mans = {0: {"dtrace": {"h": pkg.az.decision_trace(inputs),
                           "c": inputs}},
            1: {"dtrace": {"h": pkg.az.decision_trace(theirs),
                           "c": theirs}}}
    sess = _Sess()
    with pytest.raises(pkg.err) as e:
        pkg.az.verify_decision_trace(sess, pkg.join(), None,
                                     "xq000001-plan", mans, inputs)
    ok = {0: mans[0], 1: {"partitions": {}}}
    pkg.az.verify_decision_trace(sess, pkg.join(), None, "xq000001-plan",
                                 ok, inputs)
    return e.value.property, str(e.value), sess._analysis_stats


def test_decision_trace_peer_divergence_names_component():
    (rp, rmsg, rst), (tp, tmsg, tst) = (_peer_trace_case(REF),
                                        _peer_trace_case(PORT))
    assert tp == rp == "decision-trace-agreement"
    assert "xq000001-plan" in tmsg and "['epoch']" in tmsg
    assert tst == rst == {"decision_trace_checks": 2,
                          "decision_trace_divergence": 1}


DISK = {0: {"sides": {"l": [9000, 90], "r": [9000, 90]}},
        1: {"sides": {"l": [9000, 90], "r": [9000, 90]}}}
_BASE = {"frozen": "hash", "how": "inner", "adaptive": True,
         "broadcast_threshold": 2048, "n_live": 2}


@pytest.mark.parametrize("local,raises", [
    (dict(_BASE, decision="broadcast_right"), True),
    (dict(_BASE, decision="hash"), False),
    ({"frozen": "hash", "n_live": 2, "width": 2, "target": 0}, False),
    ({"frozen": "hash", "n_live": 2, "width": 1, "target": 0}, True),
])
def test_decision_trace_local_recompute_matches_reference(local, raises):
    """The decision (or elastic width) this process acted on, held to a
    recompute from the round's on-disk manifests: the same verdict in
    both packages, and the port names the diverged component."""
    def run(p):
        p.az.verify_decision_trace(None, p.join(), _FakeSvc(DISK),
                                   "xq000001-plan", DISK, _trace_inputs(),
                                   local=local)
    got = _both(run)
    assert (got is not None) == raises
    if raises:
        assert got[0] == "decision-trace-agreement"
        with pytest.raises(TError) as e:
            run(PORT)
        comp = "decision" if "decision" in local else "width"
        assert f"component(s) ['{comp}']" in str(e.value)


def test_adaptive_redecide_checks_frozen_on_lost_stats_round():
    """The lenient-gather fallback still holds the frozen strategy's
    legality, in both packages."""
    from spark_tpu.parallel import crossproc as RX
    from spark_tpu_torch.parallel import crossproc as TX

    class _Svc:
        def live_pids(self):
            return [0, 1]

    mans = {0: {"partitions": {}}, 1: {"partitions": {}}}
    for X, p in ((RX, REF), (TX, PORT)):
        ctx = X._AdaptiveCtx(1024, None, None, None,
                             [(p.Col("k"), p.Col("k"))], True)
        assert X._adaptive_redecide(p.join(), _Svc(), "xq000001", ctx,
                                    "hash", mans) == "hash"
        with pytest.raises(p.err) as e:
            X._adaptive_redecide(p.join(), _Svc(), "xq000001", ctx,
                                 "sideways", mans)
        assert e.value.property == "join-strategy"


# ---------------------------------------------------------------------------
# the hazard linter on the JAX package's snippets
# ---------------------------------------------------------------------------

SNIPPETS = {
    "reserve-bad": """
        def stage(svc):
            svc.ledger.reserve("owner", 100)
            return 1
    """,
    "reserve-ok": """
        def stage(svc):
            svc.ledger.reserve("owner", 100)
            try:
                return 1
            finally:
                svc.ledger.release("owner")
    """,
    "unlocked-bad": """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def bump(self):
                self.count += 1
    """,
    "unlocked-ok": """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def bump(self):
                with self._lock:
                    self.count += 1
    """,
    "condition-lock": """
        import threading

        class S:
            def __init__(self):
                self._drained = threading.Condition()
                self.pending = 0

            def bump(self):
                with self._drained:
                    self.pending += 1
    """,
    "io-under-lock-bad": """
        import time

        def f(lock):
            with lock:
                time.sleep(1)
    """,
    "io-under-lock-ok": """
        import time

        def f(lock):
            with lock:
                pass
            time.sleep(1)
    """,
    "io-under-lock-open": "def f(lock):\n    with lock:\n        open('x')\n",
    "unused-import": "import os\n\nx = 1\n",
    "used-import": "import os\n\nx = os.getpid()\n",
    "all-reexport": ("from collections import OrderedDict\n"
                     "__all__ = ['OrderedDict']\n"),
    "shadow-arg": "def f(id):\n    return id\n",
    "shadow-module": "type = 'x'\n",
    "no-shadow": "def f(uid):\n    return uid\n",
    "durable-bad": """
        class MetadataLog:
            def add(self, batch_id, payload):
                with open(self.path(batch_id), "w") as f:
                    f.write(payload)
    """,
    "durable-atomic": """
        import os

        class MetadataLog:
            def add(self, batch_id, payload):
                tmp = self.path(batch_id) + ".tmp"
                with open(tmp, "w") as f:
                    f.write(payload)
                    os.fsync(f.fileno())
                os.replace(tmp, self.path(batch_id))
    """,
    "durable-other-class": ("class Report:\n"
                            "    def render(self):\n"
                            "        with open('r.html', 'w') as f:\n"
                            "            f.write('x')\n"),
    "durable-other-method": ("class FileSink:\n"
                             "    def describe(self):\n"
                             "        with open('d.txt', 'w') as f:\n"
                             "            f.write('x')\n"),
    "durable-read": ("class FileSink:\n"
                     "    def add_batch(self, b):\n"
                     "        with open('d.txt') as f:\n"
                     "            return f.read()\n"),
    "block-path-bad": """
        import os

        def peek(root, pid):
            return os.path.join(root, f"s{pid:04d}.done")
    """,
    "block-path-fstring": "def f(b):\n    return f'{b}.snapshot'\n",
    "block-path-prose": "def f(x):\n    return f'.part of {x}'\n",
    "block-path-docstring": ('def f():\n    "reads the s0000.part"\n'
                             '    return 1\n'),
    "nondet-bad": """
        import os

        def plan_reducers(sizes, n):
            seed = os.getpid()
            return [seed % n]
    """,
    "nondet-outside-registry": """
        import os

        def temp_file_name(n):
            return f"part-{os.getpid()}-{n}"
    """,
    "nondet-closure": """
        import random

        def _pick(xs):
            return xs[random.randrange(len(xs))]

        def adaptive_join_decision(frozen, options):
            return _pick(options)
    """,
    "nondet-closure-unreached": """
        import random

        def _pick(xs):
            return xs[random.randrange(len(xs))]
    """,
    "clock-decision": """
        import time

        def elastic_reducer_width(total, target, n):
            w = time.time()
            return int(w) % n
    """,
    "clock-deadline": """
        import time

        def recover_round(svc, timeout):
            deadline = time.time() + timeout
            while time.time() < deadline:
                svc.poll()
            return []
    """,
    "unordered-for": """
        def group_owner(pids):
            owners = set(pids)
            out = []
            for p in owners:
                out.append(p)
            return out
    """,
    "unordered-sorted": """
        def group_owner(pids):
            owners = set(pids)
            out = []
            for p in sorted(owners):
                out.append(p)
            return out
    """,
    "unordered-list": """
        def live_pids(procs):
            alive = {p for p in procs}
            return list(alive)
    """,
    "unordered-fold": """
        def live_pids(procs):
            alive = {p for p in procs}
            return max(alive) if alive else 0
    """,
    "unordered-helper": """
        def _candidates(xs):
            return {x for x in xs}

        def plan_range_reducers(xs):
            out = []
            for c in _candidates(xs):
                out.append(c)
            return out
    """,
}

#: the JAX-only rules, which the port's HZ101/HZ108 replace
_JAX_RULES = ("HZ101", "HZ108")


def _findings(lint, src, path="<snippet>"):
    return sorted((f.rule, f.line, f.col, f.symbol)
                  for f in lint(textwrap.dedent(src), path)
                  if f.rule not in _JAX_RULES)


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_lint_snippets_match_reference(name):
    """Every rule but HZ101/HZ108 gives the JAX package's findings (rule,
    line, column, symbol) on its own snippets."""
    src = SNIPPETS[name]
    assert _findings(lint_source, src) == _findings(r_lint_source, src)
    bad = name.endswith(("-bad", "-open", "-fstring", "-closure",
                         "-decision", "-for", "-list", "-helper",
                         "-arg", "-module")) \
        or name in ("unused-import",)
    assert bool(_findings(lint_source, src)) == bad, name


def test_lint_resolver_modules_are_exempt():
    src = textwrap.dedent(SNIPPETS["block-path-bad"])
    for path in ("spark_tpu_torch/parallel/hostshuffle.py",
                 "spark_tpu_torch/streaming/state.py"):
        assert not [f for f in lint_source(src, path=path)
                    if f.rule == "HZ113"]


PROTOCOL_CASES = {
    "one-sided-pub": {"a.py": """
        def stage(svc, xid):
            svc.publish_manifest(f"{xid}-plan", {})
    """},
    "paired-across-files": {"a.py": """
        def stage(svc, xid):
            svc.publish_manifest(f"{xid}-plan", {})
    """, "b.py": """
        def read(svc, xid, n):
            return svc.gather_manifests(f"{xid}-plan", n)
    """},
    "one-sided-gather": {"b.py": """
        def read(svc, xid, n):
            return svc.gather_manifests(f"{xid}-plan", n)
    """},
    "published-twice": {"a.py": """
        def stage(svc, xid, n):
            svc.publish_manifest(f"{xid}-plan", {})
            svc.publish_manifest(f"{xid}-plan", {})
            svc.gather_manifests(f"{xid}-plan", n)
    """},
    "unfenced": {"a.py": """
        def run(svc, xid, n):
            epoch = 0
            while True:
                run_id = f"{xid}e{epoch}"
                svc.publish_manifest(f"{xid}-fin", {})
                svc.gather_manifests(f"{xid}-fin", n)
                epoch += 1
    """},
    "fenced": {"a.py": """
        def run(svc, xid, n):
            epoch = 0
            while True:
                run_id = f"{xid}e{epoch}"
                svc.publish_manifest(f"{run_id}-fin", {})
                svc.gather_manifests(f"{run_id}-fin", n)
                epoch += 1
    """},
}


@pytest.mark.parametrize("name", sorted(PROTOCOL_CASES))
def test_protocol_cases_match_reference(name):
    sources = {p: textwrap.dedent(s) for p, s in PROTOCOL_CASES[name].items()}

    def key(fs):
        return sorted((f.rule, f.path, f.line, f.col, f.symbol, f.message)
                      for f in fs)
    got, want = key(t_protocol(sources)), key(r_protocol(sources))
    assert got == want
    assert bool(got) == (name not in ("paired-across-files", "fenced"))


# -- HZ101 / HZ108 in their CUDA meaning ------------------------------------

CAPTURE_BAD = """
    import numpy as np
    import torch

    def stage_maker(pq, device):
        def make():
            def run(leaves, params):
                n = leaves[0].sum().item()
                host = np.asarray(leaves[1])
                t = torch.tensor([n], device=device)
                return _finish(t, host)
            return run, Stage(pq.physical, [], None, "k")
        return make

    def _finish(t, host):
        return t.cpu(), host.tolist()
"""

CAPTURE_OK = """
    import numpy as np
    from capture import constant, decide

    def stage_maker(pq, device):
        def make():
            def run(leaves, params):
                if decide(leaves[0].sum() > 0):
                    return constant(3, device, None)
                return leaves[0]
            return run, Stage(pq.physical, [], None, "k")
        return make

    def report(batch):
        return batch.sum().item(), np.asarray(batch)
"""


def test_lint_host_sync_in_capture():
    """HZ101: a host sync inside the step a stage builder returns, and in
    what it calls in the same module; none outside it, none through
    ``capture.decide`` / ``capture.constant``."""
    fs = [f for f in lint_source(textwrap.dedent(CAPTURE_BAD))
          if f.rule == "HZ101"]
    assert sorted((f.symbol, f.line) for f in fs) == [
        ("_finish", 16), ("_finish", 16),
        ("stage_maker.make.run", 8), ("stage_maker.make.run", 9),
        ("stage_maker.make.run", 10)]
    assert "pageable copy" in " ".join(f.message for f in fs)
    assert not [f for f in lint_source(textwrap.dedent(CAPTURE_OK))
                if f.rule == "HZ101"]


def test_lint_graph_outside_stage_cache():
    """HZ108: a CUDA graph built anywhere but the stage cache's module."""
    bad = textwrap.dedent("""
        import torch

        def run(step, leaves):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                step(leaves)
            return g
    """)
    fs = [f for f in lint_source(bad) if f.rule == "HZ108"]
    assert [(f.symbol, f.line) for f in fs] == [("run", 5), ("run", 6)]
    owner = lint_source(bad, path="spark_tpu_torch/sql/stagecompile.py")
    assert not [f for f in owner if f.rule == "HZ108"]
    assert "HZ108" not in {f.rule for f in lint_source(
        "def run(cache, key, make):\n"
        "    return cache.get_or_build(key, make)\n")}


# ---------------------------------------------------------------------------
# waivers, the CLI and the port's own source
# ---------------------------------------------------------------------------

def test_waiver_file_parses_and_every_waiver_has_a_reason():
    waivers = load_waivers(WAIVERS)
    assert waivers and all(w.get("reason") for w in waivers)
    f = lint_source("def f(lock):\n    with lock:\n        open('x')\n")[0]
    assert not is_waived(f, waivers)      # synthetic path never waived


@pytest.mark.parametrize("body,match", [
    ('[[waiver]]\nrule = "HZ104"\n', "reason"),
    ("[[waiver]]\nrule = [1, 2]\n", "unsupported"),
    ('[[waiver]]\nreason = "x"\n', "no rule"),
])
def test_waiver_parse_errors(tmp_path, body, match):
    p = tmp_path / "w.toml"
    p.write_text(body)
    with pytest.raises(ValueError, match=match):
        load_waivers(str(p))


def test_dead_waiver_detection():
    findings = lint_source("import os\n\nx = 1\n")
    live = {"rule": "HZ106", "reason": "kept"}
    dead = {"rule": "HZ104", "path": "never/matches.py",
            "reason": "the code this excused is long gone"}
    assert dead_waivers(findings, [live, dead]) == [dead]


@pytest.fixture(scope="module")
def package_findings():
    """The port's files linted once for this module: file → findings."""
    from spark_tpu_torch.analysis import lint as tlint
    return {path: tlint.lint_files([path])
            for path in tlint._collect_py([PKG])}


@pytest.fixture
def linted(package_findings, monkeypatch):
    """``lint_files`` serving the package's files from the module's one
    lint (the package is not edited while these tests run), so each
    full-package ``main`` below costs no fresh parse."""
    from spark_tpu_torch.analysis import lint as tlint
    real = tlint.lint_files

    def lint_files(files):
        out = []
        for path in files:
            out.extend(package_findings[path] if path in package_findings
                       else real([path]))
        return out
    monkeypatch.setattr(tlint, "lint_files", lint_files)


def test_stale_waiver_fails_default_lint(tmp_path, capsys, linted):
    """A waiver matching no finding fails the default lint of the port
    (the checked-in file carries none)."""
    with open(WAIVERS, encoding="utf-8") as f:
        body = f.read()
    stale = tmp_path / "w.toml"
    stale.write_text(body + '\n[[waiver]]\nrule = "HZ104"\n'
                     'path = "parallel/never_written.py"\n'
                     'reason = "left behind after a refactor"\n')
    assert main(["--waivers", str(stale)]) == 1
    out = capsys.readouterr().out
    assert "remove dead waiver" in out and "never_written.py" in out
    assert main([]) == 0


@pytest.mark.parametrize("flags", [["--determinism"], ["--protocol"],
                                   ["--determinism", "--protocol"]])
def test_rule_filters_lint_clean_and_skip_stale_check(tmp_path, capsys,
                                                      flags, linted):
    """``--determinism`` / ``--protocol`` lint the port's replica
    decisions and its exchange protocol: clean with the waiver file, and
    a subset never proves a waiver dead."""
    assert main(flags) == 0
    stale = tmp_path / "w.toml"
    stale.write_text(open(WAIVERS, encoding="utf-8").read()
                     + '\n[[waiver]]\nrule = "HZ109"\n'
                     'path = "parallel/never_written.py"\n'
                     'reason = "left behind"\n')
    assert main(flags + ["--waivers", str(stale)]) == 0
    assert "remove dead waiver" not in capsys.readouterr().out


def test_port_is_lint_clean(linted):
    unwaived, waived = lint_paths([PKG], WAIVERS)
    assert unwaived == [], "\n".join(str(f) for f in unwaived)
    # waivers stay justified, not a dumping ground: the manifest's
    # informational pid/ts, two reservations handed to their owner, and
    # methods whose callers hold the lock
    assert len(waived) <= 16
    assert dead_waivers(unwaived + waived, load_waivers(WAIVERS)) == []


def test_lint_cli_main_exit_codes(tmp_path, capsys, linted):
    assert main([PKG, "--waivers", WAIVERS]) == 0
    bad = tmp_path / "bad.py"
    bad.write_text("import os\n\nx = 1\n")
    assert main([str(bad), "--no-waivers"]) == 1
    assert "HZ106" in capsys.readouterr().out


def test_planning_conf_coverage_complete():
    """Every conf the port's planning files read is in its plan cache's
    fingerprint."""
    reads = planning_conf_reads()
    assert reads, "conf-read scan found nothing: scanner broken?"
    assert missing_planning_confs() == []


@pytest.mark.parametrize("key,val", [
    ("spark.tpu.shuffle.finePartitionsPerProc", "9"),
    ("spark.tpu.crossproc.dedupReplicated", "false"),
])
def test_set_planning_conf_invalidates_plan_cache(key, val, tmp_path):
    """A SET of a cross-process planning conf evicts the port's plan
    cache entries built under the old value (they were not in its
    fingerprint before), and the answer is unchanged."""
    from spark_tpu_torch import config as TC
    from spark_tpu_torch.serving.plancache import PlanCache
    from spark_tpu_torch.sql.session import SparkSession
    s = SparkSession(TC.Conf({"spark.torch.device": "cpu",
                              "spark.sql.warehouse.dir": str(tmp_path)}))
    cache = PlanCache(s.conf_obj)
    s._plan_cache = cache
    q = ("SELECT id % 7 AS g, count(*) AS c FROM range(64) "
         "GROUP BY id % 7 ORDER BY g")
    r1 = [tuple(r) for r in s.sql(q).collect()]
    assert cache.stats()["entries"] >= 1
    before = cache.stats()["invalidations"]
    s.sql(f"SET {key}={val}")
    assert cache.stats()["invalidations"] > before, \
        f"SET {key} must evict entries built under the old value"
    assert [tuple(r) for r in s.sql(q).collect()] == r1
    s.stop()


# ---------------------------------------------------------------------------
# the decision-trace backstop across real processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["trace-parity", "trace-parity-ici",
                                  "skew-decision", "skew-decision-ici"])
def test_decision_trace_scenarios(name):
    """Two CPU workers (``analysis-worker``): without a fault both match
    the single-process answer with trace checks run and no divergence;
    with ``skew_decision`` armed in process 1, BOTH end in a
    ``PlanInvariantError`` naming the diverged component — the armed one
    at its trace check, its peer at its next barrier through the
    divergence notice — well inside the bound, never a partial result."""
    from spark_tpu_torch import testing as TTest
    sc = TTest.chaos_scenario(name)
    with tempfile.TemporaryDirectory() as root:
        results, elapsed = TTest.run_scenario(sc, root, "cpu")
    assert TTest.check_scenario(sc, results, elapsed) == []
    for pid, (_rc, out) in results.items():
        line = [ln for ln in out.splitlines()
                if ln.startswith(f"[p{pid}]")][-1]
        if name.startswith("skew"):
            assert "prop=decision-trace-agreement" in line, line
            assert "component(s) ['decision']" in line, line
            assert "xq000001-plan" in line, line
            # the armed process counts the divergence; its peer none
            assert f"div={1 if pid == 1 else 0}" in line, line
            assert float(line.split()[2]) < sc["timeout_s"], line
        else:
            assert " div=0" in line and " checks=0" not in line, line


def test_clean_run_after_a_divergence_on_the_same_root():
    """A ``skew_decision`` run leaves its divergence notice under the
    shuffle root.  A later gang on that root reuses the statement ids
    (``xq000001``), so the notice must not end its barriers: with the
    diverged run's exchange directories gone (the ids are single-use, and
    their markers would refuse the reuse on their own), the clean run
    answers on both processes with no divergence."""
    import shutil

    from spark_tpu_torch import testing as TTest
    with tempfile.TemporaryDirectory() as root:
        sc = TTest.chaos_scenario("skew-decision")
        results, elapsed = TTest.run_scenario(sc, root, "cpu")
        assert TTest.check_scenario(sc, results, elapsed) == []
        shuffle = os.path.join(root, "shuffle")
        assert os.listdir(os.path.join(shuffle, "_diverged"))
        for name in os.listdir(shuffle):
            if name.startswith("xq"):
                shutil.rmtree(os.path.join(shuffle, name))
        sc = TTest.chaos_scenario("trace-parity")
        results, elapsed = TTest.run_scenario(sc, root, "cpu")
        assert TTest.check_scenario(sc, results, elapsed) == []
        for pid, (_rc, out) in results.items():
            line = [ln for ln in out.splitlines()
                    if ln.startswith(f"[p{pid}]")][-1]
            assert "TRACE-OK" in line and " div=0" in line, line


def _notice_svc(root, pid, stamps):
    from spark_tpu_torch.memory import HostMemoryLedger
    from spark_tpu_torch.parallel.hostshuffle import HostShuffleService
    svc = HostShuffleService(root, pid, 2, timeout_s=5.0,
                             ledger=HostMemoryLedger(budget=1 << 20))
    svc.begin_statement("xq000001")
    svc.note_round("xq000001-plan", {s: {"ts": t}
                                     for s, t in enumerate(stamps)})
    return svc


def test_divergence_notice_counts_only_for_its_own_round(tmp_path):
    """A peer's notice ends a barrier wait only when it carries the
    stamp of the plan-round marker this process gathered from that peer
    in the running statement: an earlier run's notice under the same
    statement id is ignored, the current one raises; and a statement
    begun without the runtime checks neither publishes nor reads one."""
    root = str(tmp_path)
    old = _notice_svc(root, 1, [1.0, 2.0])
    old.publish_divergence("xq000001-plan", "decision-trace-agreement",
                           "component(s) ['decision'] differ")
    # a later run under the same id: its markers carry new stamps
    peer = _notice_svc(root, 0, [3.0, 4.0])
    peer._raise_if_diverged("xq000001-jL", [1])
    # the diverged process of THIS run: its notice carries stamp 4.0
    cur = _notice_svc(root, 1, [3.0, 4.0])
    cur.publish_divergence("xq000001-plan", "decision-trace-agreement",
                           "component(s) ['decision'] differ")
    with pytest.raises(TError, match=r"process 1 aborted at "
                                     r"'xq000001-plan'") as e:
        peer._raise_if_diverged("xq000001-jL", [1])
    assert e.value.property == "decision-trace-agreement"
    # a peer that has not gathered the round yet waits on
    early = _notice_svc(root, 0, [])
    early._raise_if_diverged("xq000001-digest", [1])
    # off: no statement id, so nothing is looked up or written
    peer.begin_statement(None)
    peer._raise_if_diverged("xq000001-jL", [1])
    peer.publish_divergence("xq000001-plan", "decision-trace-agreement",
                            "x")
    assert sorted(os.listdir(os.path.join(root, "_diverged"))) == \
        ["xq000001-p1.json"]


# ---------------------------------------------------------------------------
# the hazards the linter found in the port, repaired
# ---------------------------------------------------------------------------

def _sink(tmp_path, spill_threshold):
    from spark_tpu_torch.memory import HostMemoryLedger
    from spark_tpu_torch.parallel.hostshuffle import (FetchSink,
                                                      HostShuffleService)
    svc = HostShuffleService(str(tmp_path / "root"), 0, 1, timeout_s=5.0,
                             ledger=HostMemoryLedger(budget=1 << 20))
    return svc, FetchSink(svc, "shuffle:q:fetch", "q", str(tmp_path),
                          spill_threshold=spill_threshold)


def _ints(n, v):
    return TBatch(["k"], [TVector(torch.full((n,), v, dtype=torch.int64),
                                  TT.int64)], None, n)


def test_failed_fetch_sink_add_keeps_nothing(tmp_path):
    """HZ102 at ``FetchSink.add``: a batch reserved in RAM, then a spill
    write that fails — the add raises and its reservation and run file go
    with it (they used to stay reserved until the statement's exit)."""
    from spark_tpu_torch import wire
    from spark_tpu_torch.memory import HostMemoryError
    small, big = _ints(4, 1), _ints(64, 2)
    svc, sink = _sink(tmp_path, spill_threshold=wire.raw_nbytes([big]))

    def full(path, data, append=False, exchange=""):
        open(path, "ab").close()           # a part-written run file
        raise OSError(28, "No space left on device")
    svc.spill_write = full
    with pytest.raises(HostMemoryError, match="spill failed"):
        sink.add(1, [small, big])
    assert svc.ledger.held("shuffle:q:fetch") == 0
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".fetch")]
    assert sink.drain() == []


def test_failed_fetch_sink_drain_gives_back_its_reservations(tmp_path):
    """HZ102 at ``FetchSink.drain``: a run file cut short makes the drain
    fail after it reserved the first spilled batch; the failure gives
    that reservation back (only the over-budget case did before)."""
    from spark_tpu_torch import wire
    a, b = _ints(64, 1), _ints(64, 2)
    svc, sink = _sink(tmp_path, spill_threshold=wire.raw_nbytes([a]))
    sink.add(1, [a])
    sink.add(2, [b])
    run = [f for f in os.listdir(tmp_path) if f.endswith("s0002.fetch")][0]
    with open(tmp_path / run, "r+b") as f:
        f.truncate(8)
    held = svc.ledger.held("shuffle:q:fetch")
    with pytest.raises(Exception):
        sink.drain()
    assert svc.ledger.held("shuffle:q:fetch") == held


def test_reclaimed_counter_serializes_processes(tmp_path):
    """HZ104 at ``BlockStore._bump_reclaimed``: the counter's
    read-modify-write holds an flock on the store directory, not the
    in-process lock around file I/O, so concurrent bumps from two
    processes sharing the root all land."""
    import subprocess
    import sys
    from spark_tpu_torch.parallel.blockserver import BlockStore
    root = str(tmp_path / "shuf")
    store = BlockStore(root)
    code = ("import sys\n"
            "from spark_tpu_torch.parallel.blockserver import BlockStore\n"
            f"s = BlockStore({root!r})\n"
            "for _ in range(300):\n"
            "    s._bump_reclaimed(1)\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(PKG))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env)
             for _ in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    assert store.reclaimed_total() == 600


def test_state_store_accounting_holds_the_resident_bytes(tmp_path):
    """The waived HZ102 at ``StateStoreProvider._account`` is a tenancy:
    after each commit the owner holds exactly the cache's resident
    bytes."""
    from spark_tpu_torch.memory import HostMemoryLedger
    from spark_tpu_torch.streaming.state import StateStoreProvider
    ledger = HostMemoryLedger(budget=1 << 20)
    prov = StateStoreProvider(str(tmp_path / "state"),
                              ledger_supplier=lambda: ledger)
    for v in range(1, 4):
        st = prov.get_store(v - 1)
        st.put(("k", v), v)
        st.commit()
        resident = sum(prov._bytes.get(x, 0) for x in prov._cache)
        assert ledger.held(prov._ledger_owner) == resident > 0
