"""The port's kernels and expressions against ``spark_tpu`` on both of its
lanes: the interpreted numpy lane and the jax lane (jnp on the CPU, where
conftest forces the MXU-form aggregation on).

Inputs are made with numpy from a seed and go into both packages as the
same bits (``spark_tpu_torch.testing``).  Integer, code, sort and hash
results must match bit for bit; float64 sums and averages within
rtol 1e-12, because the summation order differs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spark_tpu import aggregates as RA
from spark_tpu import expressions as RE
from spark_tpu import kernels as RK
from spark_tpu import types as RT
from spark_tpu.columnar import ColumnBatch as RBatch
from spark_tpu.columnar import ColumnVector as RVector
from spark_tpu_torch import aggregates as TA
from spark_tpu_torch import expressions as TE
from spark_tpu_torch import kernels as TK
from spark_tpu_torch.testing import (assert_parts_equal, assert_values_equal,
                                     batch_parts, from_parts)

FLOAT_RTOL = 1e-12
LANES = ["np", "jnp"]


def _ref_batch(cols, row_valid, cap):
    vecs = [RVector(d, RT.type_for_name(t), v, dic)
            for _n, t, d, v, dic in cols]
    return RBatch([c[0] for c in cols], vecs, row_valid, cap)


def _pair(seed=0, n=200, cap=256):
    """A reference batch and the port's batch holding the same bits:
    NULLs in every column, NaN and -0.0 in the floats, bool, strings,
    decimals and dead rows."""
    rng = np.random.default_rng(seed)

    def nulls(p=0.15):
        v = rng.random(cap) > p
        return v

    i = rng.integers(-50, 50, cap).astype(np.int64)
    j = rng.integers(-5, 6, cap).astype(np.int32)
    f = rng.normal(0, 10, cap)
    f[rng.random(cap) < 0.1] = np.nan
    f[rng.random(cap) < 0.1] = -0.0
    f[rng.random(cap) < 0.1] = 0.0
    b = rng.random(cap) < 0.5
    words = ("apple", "kiwi", "lime", "pear", "plum")
    s = rng.integers(0, len(words), cap).astype(np.int32)
    d = rng.integers(-10 ** 6, 10 ** 6, cap).astype(np.int64)
    rv = np.zeros(cap, bool)
    rv[:n] = True
    rv[rng.random(cap) < 0.05] = False
    cols = [("i", "bigint", i, nulls(), None),
            ("j", "int", j, None, None),
            ("f", "double", f, nulls(), None),
            ("b", "boolean", b, nulls(), None),
            ("s", "string", s, nulls(), words),
            ("d", "decimal(12,2)", d, nulls(), None)]
    ref = _ref_batch(cols, rv, cap)
    return ref, from_parts(batch_parts(ref))


def _lane(lane, batch):
    return (np, batch) if lane == "np" else (jnp, batch.to_device())


def _parts(batch):
    return batch_parts(batch.to_host() if hasattr(batch, "to_host") else batch)


# ---------------------------------------------------------------------------
# filter / project / compact / limit
# ---------------------------------------------------------------------------

def _predicate(E):
    return E.Or(E.And(E.GT(E.Col("i"), E.Literal(0)),
                      E.In(E.Col("s"), ["kiwi", "plum", "fig"])),
                E.And(E.IsNull(E.Col("f")),
                      E.Between(E.Col("j"), E.Literal(-2), E.Literal(3))))


@pytest.mark.parametrize("lane", LANES)
def test_filter(lane):
    ref, got = _pair(1)
    xp, rb = _lane(lane, ref)
    r = RK.apply_filter(xp, rb, _predicate(RE))
    g = TK.apply_filter(got, _predicate(TE))
    assert_parts_equal(_parts(r), _parts(g))


def _projection(E, T):
    return [
        E.Alias(E.Add(E.Col("i"), E.Col("j")), "add"),
        E.Alias(E.Mul(E.Col("j"), E.Literal(3)), "mul"),
        E.Alias(E.Sub(E.Col("i"), E.Literal(1.5)), "sub_float"),
        E.Alias(E.Div(E.Col("i"), E.Col("j")), "div"),
        E.Alias(E.IntDiv(E.Col("i"), E.Col("j")), "intdiv"),
        E.Alias(E.Mod(E.Col("i"), E.Col("j")), "mod"),
        E.Alias(E.Mod(E.Col("f"), E.Literal(3.0)), "fmod"),
        E.Alias(E.Cast(E.Col("f"), T.int64), "f_long"),
        E.Alias(E.Cast(E.Col("f"), T.int32), "f_int"),
        E.Alias(E.Cast(E.Col("d"), T.float64), "d_double"),
        E.Alias(E.Cast(E.Col("i"), T.DecimalType(10, 1)), "i_dec"),
        E.Alias(E.Cast(E.Col("j"), T.boolean), "j_bool"),
        E.Alias(E.Cast(E.Col("b"), T.int32), "b_int"),
        E.Alias(E.Coalesce(E.Col("i"), E.Col("j")), "coalesce"),
        E.Alias(E.CaseWhen([(E.GT(E.Col("j"), E.Literal(2)), E.Col("s")),
                            (E.LT(E.Col("j"), E.Literal(-2)),
                             E.Literal("zzz"))], E.Literal("mid")), "case"),
        E.Alias(E.EqNullSafe(E.Col("i"), E.Col("j")), "eqns"),
        E.Alias(E.Not(E.Or(E.Col("b"), E.IsNotNull(E.Col("f")))), "logic"),
        E.Alias(E.LE(E.Col("f"), E.Col("i")), "cmp_mixed"),
        E.Alias(E.GE(E.Col("s"), E.Literal("lime")), "cmp_str"),
        E.Alias(E.Neg(E.Col("d")), "neg"),
        E.Alias(E.Literal(7), "const"),
    ]


@pytest.mark.parametrize("lane", LANES)
def test_project(lane):
    ref, got = _pair(2)
    xp, rb = _lane(lane, ref)
    r = RK.apply_project(xp, rb, _projection(RE, RT))
    g = TK.apply_project(got, _projection(TE, TE.T))
    assert_parts_equal(_parts(r), _parts(g), rtol=FLOAT_RTOL)


def _decimal_arithmetic(E):
    """The decimal columns ``_projection`` held against the reference
    until the port rescaled decimal operands (ROADMAP §3)."""
    return [E.Alias(E.Div(E.Col("d"), E.Col("d")), "ddiv"),
            E.Alias(E.Add(E.Col("d"), E.Col("i")), "dadd")]


@pytest.mark.parametrize("lane", LANES)
def test_decimal_arithmetic_oracle(lane):
    """``d + i`` (a decimal(12,2) plus a bigint) and ``d / d`` against
    Python's ``decimal`` on every live row.  The reference adds the held
    integer (value × 100) to ``i`` as it is and divides the held
    integers into a column still typed decimal, so it differs."""
    import decimal
    ref, got = _pair(2)
    xp, rb = _lane(lane, ref)
    g = _parts(TK.apply_project(got, _decimal_arithmetic(TE)))
    r = _parts(RK.apply_project(xp, rb, _decimal_arithmetic(RE)))
    assert g.type_strings == ["double", "decimal(12,2)"]
    src = _parts(got)
    d_raw, d_ok = src.datas[5], src.valids[5]
    i_raw, i_ok = src.datas[0], src.valids[0]
    live = np.asarray(src.row_valid)
    div_ok = live & d_ok & (d_raw != 0)
    add_ok = live & d_ok & i_ok
    assert div_ok.sum() > 100 and add_ok.sum() > 100
    for k in np.flatnonzero(live):
        dk = decimal.Decimal(int(d_raw[k])).scaleb(-2)
        assert bool(g.valids[0][k]) == bool(div_ok[k])
        assert bool(g.valids[1][k]) == bool(add_ok[k])
        if div_ok[k]:
            assert g.datas[0][k] == float(dk / dk) == 1.0
        if add_ok[k]:
            want = dk + int(i_raw[k])
            assert g.datas[1][k] == int(want.scaleb(2))
    # the reference still keeps d / d in a decimal column and adds i to
    # the held integer
    assert r.type_strings == ["decimal(12,2)", "decimal(12,2)"]
    k = int(np.flatnonzero(add_ok & (i_raw != 0))[0])
    assert int(r.datas[1][k]) == int(d_raw[k]) + int(i_raw[k]) \
        != int(g.datas[1][k])


@pytest.mark.parametrize("lane", LANES)
def test_compact_and_limit(lane):
    ref, got = _pair(3)
    xp, rb = _lane(lane, ref)
    rf = RK.apply_filter(xp, rb, RE.GT(RE.Col("j"), RE.Literal(0)))
    gf = TK.apply_filter(got, TE.GT(TE.Col("j"), TE.Literal(0)))
    assert_parts_equal(_parts(RK.compact(xp, rf)), _parts(TK.compact(gf)))
    assert_parts_equal(_parts(RK.apply_limit(xp, rf, 17)),
                       _parts(TK.apply_limit(gf, 17)))


# ---------------------------------------------------------------------------
# sorting and search
# ---------------------------------------------------------------------------

def _sort_specs(batch, orders):
    out = []
    for name, asc, nf in orders:
        v = batch.column(name)
        out.append((v.data, v.valid, v.dtype, asc, nf))
    return out


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("orders", [
    [("f", True, True)],
    [("f", False, False)],
    [("b", True, False), ("i", False, True)],
    [("s", False, True), ("f", True, False), ("j", True, True)],
    [("d", True, True), ("b", False, True)],
])
def test_sort_batch(lane, orders):
    """NULL ranks, NaN after +inf, -0.0 equal to 0.0 (stable), bool keys,
    descending flips — the full row order must match."""
    ref, got = _pair(4)
    xp, rb = _lane(lane, ref)
    r = RK.sort_batch(xp, rb, _sort_specs(rb, orders))
    g = TK.sort_batch(got, _sort_specs(got, orders))
    assert_parts_equal(_parts(r), _parts(g), live_only=False)


@pytest.mark.parametrize("lane", LANES)
def test_multi_key_argsort(lane):
    rng = np.random.default_rng(9)
    n = 500
    k0 = rng.integers(0, 3, n).astype(np.int8)
    k1 = rng.normal(size=n)
    k1[rng.random(n) < 0.2] = np.nan
    k1[rng.random(n) < 0.2] = 0.0
    k1[rng.random(n) < 0.2] = -0.0
    k1[rng.random(n) < 0.05] = -np.nan
    k1[rng.random(n) < 0.05] = np.inf
    k2 = rng.random(n) < 0.5
    k3 = rng.integers(-2 ** 62, 2 ** 62, n).astype(np.int64)
    k3[rng.random(n) < 0.5] = 5
    keys = [k0, k1, k2.astype(np.int8), k3]
    xp = np if lane == "np" else jnp
    ref = np.asarray(RK.multi_key_argsort(
        xp, [xp.asarray(k) for k in keys], n))
    got = TK.multi_key_argsort([torch.from_numpy(k0), torch.from_numpy(k1),
                                torch.from_numpy(k2), torch.from_numpy(k3)], n)
    assert np.array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
def test_searchsorted(side, dtype):
    rng = np.random.default_rng(10)
    a = np.sort(rng.integers(-100, 100, 300)).astype(dtype)
    v = rng.integers(-120, 120, 500).astype(dtype)
    ref = RK.searchsorted(np, a, v, side=side)
    got = TK.searchsorted(torch.from_numpy(a), torch.from_numpy(v), side=side)
    assert np.array_equal(got.numpy(), ref)
    ref_j = np.asarray(RK.searchsorted(jnp, jnp.asarray(a), jnp.asarray(v),
                                       side=side))
    assert np.array_equal(got.numpy(), ref_j)


# ---------------------------------------------------------------------------
# grouped aggregation: both branches
# ---------------------------------------------------------------------------

def _agg_slots(A, E, with_minmax):
    slots = [(A.Sum(E.Col("i")), "sum_i"), (A.Sum(E.Col("j")), "sum_j"),
             (A.Sum(E.Col("b")), "sum_b"), (A.Sum(E.Col("d")), "sum_d"),
             (A.Count(E.Col("f")), "cnt_f"), (A.CountStar(), "cnt"),
             (A.Avg(E.Col("j")), "avg_j"), (A.Avg(E.Col("d")), "avg_d")]
    if with_minmax:
        slots += [(A.Min(E.Col("f")), "min_f"), (A.Max(E.Col("s")), "max_s"),
                  (A.Sum(E.Col("f")), "sum_f"), (A.Avg(E.Col("f")), "avg_f"),
                  (A.First(E.Col("i")), "first_i"),
                  (A.Last(E.Col("s"), False), "last_s"),
                  (A.Min(E.Col("b")), "min_b")]
    return slots


_KEY_SETS = [["j"], ["s", "b"], ["i", "j"], ["d"]]


@pytest.fixture
def mxu(monkeypatch):
    def set_(on):
        monkeypatch.setattr(TK, "MXU_AGG_ENABLED", on)
    return set_


@pytest.mark.parametrize("keys", _KEY_SETS)
def test_grouped_aggregate_mxu_form(keys, mxu):
    """The port's MXU form (bucket codes, uint8 limb planes, K1's plain
    version, decode) against the reference's MXU form on the jax lane and
    its sort-based form on the numpy lane.  Groups come out in bucket
    order in both MXU forms, so row order matches too."""
    mxu(True)
    ref, got = _pair(5)
    r_keys = [RE.Col(k) for k in keys]
    t_keys = [TE.Col(k) for k in keys]
    r = RK.grouped_aggregate(jnp, ref.to_device(), r_keys,
                             _agg_slots(RA, RE, False))
    g = TK.grouped_aggregate(got, t_keys, _agg_slots(TA, TE, False))
    assert_parts_equal(_parts(RK.compact(jnp, r)), _parts(TK.compact(g)),
                       rtol=FLOAT_RTOL)
    # and the numpy oracle (sort-based, unordered against bucket order)
    rn = RK.compact(np, RK.grouped_aggregate(np, ref, r_keys,
                                             _agg_slots(RA, RE, False)))
    _assert_same_groups(batch_parts(rn), _parts(TK.compact(g)))


def test_grouped_aggregate_mxu_form_falls_back_when_keys_do_not_fit(mxu):
    """A key range past the bucket table takes the sort-based branch inside
    the MXU form (the reference's lax.cond slow branch)."""
    mxu(True)
    ref, got = _pair(6)
    r = RK.grouped_aggregate(jnp, ref.to_device(), [RE.Col("d")],
                             _agg_slots(RA, RE, False), bucket_cap=64)
    g = TK.grouped_aggregate(got, [TE.Col("d")], _agg_slots(TA, TE, False),
                             bucket_cap=64)
    assert_parts_equal(_parts(RK.compact(jnp, r)), _parts(TK.compact(g)),
                       rtol=FLOAT_RTOL)


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("keys", _KEY_SETS + [["f"], []])
def test_grouped_aggregate_sort_based(keys, lane, mxu, monkeypatch):
    mxu(False)
    monkeypatch.setattr(RK, "MXU_AGG_ENABLED", False)
    ref, got = _pair(7)
    xp, rb = _lane(lane, ref)
    r = RK.grouped_aggregate(xp, rb, [RE.Col(k) for k in keys],
                             _agg_slots(RA, RE, True))
    g = TK.grouped_aggregate(got, [TE.Col(k) for k in keys],
                             _agg_slots(TA, TE, True))
    assert_parts_equal(_parts(RK.compact(xp, r)), _parts(TK.compact(g)),
                       rtol=FLOAT_RTOL)


def test_distinct(mxu):
    mxu(False)
    ref, got = _pair(8)
    ref = RK.apply_project(np, ref, [RE.Col("j"), RE.Col("s")])
    got = TK.apply_project(got, [TE.Col("j"), TE.Col("s")])
    assert_parts_equal(batch_parts(RK.compact(np, RK.distinct(np, ref))),
                       _parts(TK.compact(TK.distinct(got))))


def _assert_same_groups(ref, got):
    """Same groups and values, in any row order (keys first)."""
    def rows(p):
        n = p.capacity if p.row_valid is None else int(p.row_valid.sum())
        out = []
        for r in range(n):
            row = []
            for d, v, dic in zip(p.datas, p.valids, p.dictionaries):
                if v is not None and not v[r]:
                    row.append(None)
                elif dic is not None:
                    row.append(dic[int(d[r])])
                else:
                    x = d[r].item()
                    row.append(round(x, 9) if isinstance(x, float) else x)
            out.append(tuple(row))
        return sorted(out, key=repr)
    assert rows(ref) == rows(got)


# ---------------------------------------------------------------------------
# hashing and the arithmetic edge cases of the port
# ---------------------------------------------------------------------------

def _eval_both(make, seed=11):
    ref, got = _pair(seed)
    r = make(RE).eval(RE.EvalContext(ref, np))
    g = make(TE).eval(TE.EvalContext(got))
    return r, g


def test_hash64_bit_exact():
    def make(E):
        return E.Hash64(E.Col("i"), E.Col("f"), E.Col("s"), E.Col("b"),
                        E.Col("j"), E.Col("d"))
    for lane in LANES:
        ref, got = _pair(12)
        xp, rb = _lane(lane, ref)
        r = make(RE).eval(RE.EvalContext(rb, xp))
        g = make(TE).eval(TE.EvalContext(got))
        assert np.array_equal(g.data.numpy(), np.asarray(r.data))


def test_join_hash_b_bit_exact():
    from spark_tpu.sql.joins import _Hash64B as RH
    from spark_tpu_torch.sql.joins import _Hash64B as TH
    ref, got = _pair(13)
    r = RH(RE.Col("f"), RE.Col("s"), RE.Col("i")).eval(RE.EvalContext(ref, np))
    g = TH(TE.Col("f"), TE.Col("s"), TE.Col("i")).eval(TE.EvalContext(got))
    assert np.array_equal(g.data.numpy(), np.asarray(r.data))


def _edge_batch():
    i64 = np.array([7, -7, 7, -7, 0, 2 ** 62, -(2 ** 62), 5], np.int64)
    i32 = np.array([2, 2, -2, -2, 3, 3, 0, 0], np.int32)
    f = np.array([1.5, -2.5, 0.0, -0.0, np.nan, 1e300, -1e-300, 3.0])
    cols = [("a", "bigint", i64, None, None), ("b", "int", i32, None, None),
            ("f", "double", f, None, None)]
    ref = _ref_batch(cols, None, 8)
    return ref, from_parts(batch_parts(ref))


@pytest.mark.parametrize("expr", [
    "intdiv", "mod", "div", "int_plus_float", "int32_plus_int64_lit",
    "float_to_int", "float_to_long", "int_times_lit_wraps",
])
def test_arithmetic_edge_cases(expr):
    """Floor division, sign-of-dividend modulo, x/0 → NULL, and the
    promotions torch would get wrong without the declared result type."""
    def make(E):
        a, b, f = E.Col("a"), E.Col("b"), E.Col("f")
        return {
            "intdiv": E.IntDiv(a, b), "mod": E.Mod(a, b), "div": E.Div(a, b),
            "int_plus_float": E.Add(a, E.Literal(0.1)),
            "int32_plus_int64_lit": E.Add(b, E.Literal(2 ** 40)),
            "float_to_int": E.Cast(f, E.T.int32),
            "float_to_long": E.Cast(f, E.T.int64),
            "int_times_lit_wraps": E.Mul(a, E.Literal(4)),
        }[expr]
    ref, got = _edge_batch()
    r = make(RE).eval(RE.EvalContext(ref, np))
    g = make(TE).eval(TE.EvalContext(got))
    rv = np.ones(8, bool) if r.valid is None else np.asarray(r.valid)
    gv = np.ones(8, bool) if g.valid is None else g.valid.numpy()
    assert np.array_equal(np.broadcast_to(rv, (8,)), np.broadcast_to(gv, (8,)))
    rd, gd = np.asarray(r.data), g.data.numpy()
    assert rd.dtype == gd.dtype, (rd.dtype, gd.dtype)
    assert_values_equal(np.broadcast_to(rd, (8,))[rv],
                        np.broadcast_to(gd, (8,))[rv], rtol=0.0, what=expr)
