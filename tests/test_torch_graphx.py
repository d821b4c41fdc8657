"""The port's GraphX layer against the JAX package's
(``tests/test_graphx.py``, case by case, plus random graphs of <= 64
vertices): the same edges through both packages.  Integer results —
degrees, connected-component labels, shortest-path hops, triangle counts,
Pregel's integer attributes — must be equal bit for bit; float results
(PageRank, float messages) within 1e-10 relative.  The port's graph lives
on a CPU session's device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_tpu import graphx as RG
from spark_tpu.graphx.lib import UNREACHABLE as R_UNREACHABLE
from spark_tpu_torch import config as TC
from spark_tpu_torch import graphx as TG
from spark_tpu_torch.graphx.graph import segment_reduce
from spark_tpu_torch.graphx.lib import UNREACHABLE as T_UNREACHABLE
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import graph_from_reference

RTOL = 1e-10


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _edge_list(seed, n=40, m=160, offset=100):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    return list(zip((src[keep] + offset).tolist(),
                    (dst[keep] + offset).tolist()))


@pytest.fixture(scope="module")
def gs(tspark):
    edges = _edge_list(3)
    return RG.Graph.from_edge_tuples(edges), TG.Graph.from_edge_tuples(edges)


def test_construction_and_degrees(gs):
    r, t = gs
    assert t.device.type == "cpu"
    assert (t.num_vertices, t.num_edges) == (r.num_vertices, r.num_edges)
    assert t.vertex_ids.dtype == torch.int64 and t.src.dtype == torch.int32
    for name in ("vertex_ids", "src", "dst"):
        np.testing.assert_array_equal(_np(getattr(t, name)),
                                      _np(getattr(r, name)))
    for name in ("out_degrees", "in_degrees", "degrees"):
        got, want = _np(getattr(t, name)), _np(getattr(r, name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_from_edges_api(tspark):
    edges = [(1, 2, 0.5), (2, 3, 1.5)]
    r = RG.Graph.from_edges([RG.Edge(*e) for e in edges],
                            default_vertex_attr=2.0)
    t = TG.Graph.from_edges([TG.Edge(*e) for e in edges],
                            default_vertex_attr=2.0)
    assert (t.num_vertices, t.num_edges) == (3, 2)
    for k in ("attr",):
        np.testing.assert_array_equal(_np(t.edge_attrs[k]),
                                      _np(r.edge_attrs[k]))
        np.testing.assert_array_equal(_np(t.vertex_attrs[k]),
                                      _np(r.vertex_attrs[k]))


@pytest.mark.parametrize("merge", ["sum", "min", "max"])
@pytest.mark.parametrize("to", ["dst", "src"])
def test_aggregate_messages(gs, merge, to):
    """Source out-degrees (int64 and float64) into each destination (or
    source), by each merge; a vertex with no message holds the identity
    in both packages."""
    r, t = gs
    r2 = RG.Graph(r.vertex_ids, {"deg": r.out_degrees,
                                 "f": r.out_degrees.astype(jnp.float64)},
                  r.src, r.dst, r.edge_attrs)
    t2 = TG.Graph(t.vertex_ids, {"deg": t.out_degrees,
                                 "f": t.out_degrees.to(torch.float64)},
                  t.src, t.dst, t.edge_attrs)
    for key in ("deg", "f"):
        want = _np(r2.aggregate_messages(lambda s, d, e: s[key] * 3 - d[key],
                                         merge=merge, to=to))
        got = _np(t2.aggregate_messages(lambda s, d, e: s[key] * 3 - d[key],
                                        merge=merge, to=to))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_segment_reduce_identities_match_jax():
    """Empty segments: 0, the dtype's max (min) and min (max), for every
    numeric dtype, and 2-D messages."""
    from jax import ops as jops
    ids = np.array([0, 2, 2, 5], np.int32)
    for dt in (np.int32, np.int64, np.float32, np.float64):
        data = np.array([[3, -1], [7, 2], [-4, 9], [1, 1]], dt)
        for kind, fn in (("sum", jops.segment_sum),
                         ("min", jops.segment_min),
                         ("max", jops.segment_max)):
            want = np.asarray(fn(jnp.asarray(data), jnp.asarray(ids),
                                 num_segments=7))
            got = segment_reduce(torch.from_numpy(data),
                                 torch.from_numpy(ids), 7, kind).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [3, 11])
def test_page_rank_matches_reference(tspark, seed):
    edges = _edge_list(seed)
    r, t = RG.Graph.from_edge_tuples(edges), TG.Graph.from_edge_tuples(edges)
    for kw in ({"num_iter": 30}, {"num_iter": 50, "tol": 1e-6},
               {"num_iter": 10, "reset_prob": 0.3}):
        want = _np(RG.page_rank(r, **kw))
        got = _np(TG.page_rank(t, **kw))
        np.testing.assert_allclose(got, want, rtol=RTOL)
    # the reference's numpy power iteration (tests/test_graphx.py oracle)
    vids, src, dst = _np(t.vertex_ids), _np(t.src), _np(t.dst)
    out_deg = np.maximum(np.bincount(src, minlength=len(vids)), 1)
    ranks = np.ones(len(vids))
    for _ in range(30):
        sums = np.zeros(len(vids))
        np.add.at(sums, dst, ranks[src] / out_deg[src])
        ranks = 0.15 + 0.85 * sums
    np.testing.assert_allclose(_np(TG.page_rank(t, num_iter=30)), ranks,
                               rtol=RTOL)


def test_connected_components(tspark):
    # two components + an isolated vertex
    edges = [(1, 2), (2, 3), (10, 11), (11, 12), (12, 10)]
    r, t = RG.Graph.from_edge_tuples(edges), TG.Graph.from_edge_tuples(edges)
    got = _np(TG.connected_components(t))
    np.testing.assert_array_equal(got, _np(RG.connected_components(r)))
    cc = dict(zip(_np(t.vertex_ids).tolist(), got.tolist()))
    assert cc[1] == cc[2] == cc[3] == 1 and cc[10] == cc[11] == cc[12] == 10


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_connected_components_random_vs_scipy(seed):
    """Sparse random graphs of 64 vertices, isolated vertices kept (a
    graph built from its arrays): labels equal the reference's and the
    per-component minimum vertex id of scipy's weak components."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as scc
    rng = np.random.default_rng(seed)
    n, m = 64, 40
    vids = np.sort(rng.choice(1000, n, replace=False)).astype(np.int64)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    r = RG.Graph(vids, {}, src, dst)
    t = TG.Graph(torch.from_numpy(vids), {}, torch.from_numpy(src),
                 torch.from_numpy(dst))
    got = _np(TG.connected_components(t))
    np.testing.assert_array_equal(got, _np(RG.connected_components(r)))
    _k, lab = scc(coo_matrix((np.ones(m), (src, dst)), shape=(n, n)),
                  directed=True, connection="weak")
    want = np.zeros(n, np.int64)
    for c in np.unique(lab):
        want[lab == c] = vids[lab == c].min()
    np.testing.assert_array_equal(got, want)


def test_shortest_paths(tspark):
    edges = [(1, 2), (2, 3), (3, 4), (1, 5)]
    r, t = RG.Graph.from_edge_tuples(edges), TG.Graph.from_edge_tuples(edges)
    sr, st = RG.shortest_paths(r, [1, 4]), TG.shortest_paths(t, [1, 4])
    for lm in (1, 4):
        np.testing.assert_array_equal(_np(st[lm]), _np(sr[lm]))
    d = dict(zip(_np(t.vertex_ids).tolist(), _np(st[1]).tolist()))
    assert (d[1], d[2], d[3], d[4], d[5]) == (0, 1, 2, 3, 1)
    with pytest.raises(ValueError):
        TG.shortest_paths(t, [99])


def test_triangle_count(gs):
    edges = [(1, 2), (2, 3), (3, 1), (3, 4), (4, 5), (5, 3)]
    r, t = RG.Graph.from_edge_tuples(edges), TG.Graph.from_edge_tuples(edges)
    got = _np(TG.triangle_count(t))
    np.testing.assert_array_equal(got, _np(RG.triangle_count(r)))
    assert dict(zip(_np(t.vertex_ids).tolist(), got.tolist())) == \
        {1: 1, 2: 1, 3: 2, 4: 1, 5: 1}
    rg, tg = gs
    np.testing.assert_array_equal(_np(TG.triangle_count(tg)),
                                  _np(RG.triangle_count(rg)))


def test_shortest_paths_isolated_vertex_unreachable(tspark):
    assert T_UNREACHABLE == R_UNREACHABLE
    t = TG.Graph([1, 2, 3], {}, [0], [1])   # vertex 3 isolated
    r = RG.Graph([1, 2, 3], {}, [0], [1])
    got = _np(TG.shortest_paths(t, [1])[1]).tolist()
    assert got == _np(RG.shortest_paths(r, [1])[1]).tolist() == \
        [0, 1, T_UNREACHABLE]


def test_pregel_initial_msg(tspark):
    """initial_msg runs vprog once for every vertex before superstep 1."""
    r = RG.pregel(
        RG.Graph.from_edge_tuples([(1, 2)]), {"x": jnp.zeros(2, jnp.int64)},
        vprog=lambda a, m, h: {"x": jnp.where(h, a["x"] + m, a["x"])},
        send=lambda s, d, e: (s["x"], jnp.zeros_like(s["x"], bool)),
        merge="sum", max_iterations=3, initial_msg=7)
    t = TG.pregel(
        TG.Graph.from_edge_tuples([(1, 2)]),
        {"x": torch.zeros(2, dtype=torch.int64)},
        vprog=lambda a, m, h: {"x": torch.where(h, a["x"] + m, a["x"])},
        send=lambda s, d, e: (s["x"], torch.zeros_like(s["x"],
                                                        dtype=torch.bool)),
        merge="sum", max_iterations=3, initial_msg=7)
    assert _np(t["x"]).tolist() == _np(r["x"]).tolist() == [7, 7]


@pytest.mark.parametrize("edges", [
    [(1, 2), (2, 3), (3, 4), (1, 5), (5, 4)],
    _edge_list(9, n=30, m=70, offset=1),
])
def test_pregel_sssp(tspark, edges):
    """Classic Pregel SSSP with explicit vprog/send/merge: int64 hop
    counts equal, superstep by superstep's halting included."""
    results = []
    for G, xp, where, minimum in (
            (RG, jnp, jnp.where, jnp.minimum),
            (TG, torch, torch.where, torch.minimum)):
        gr = G.Graph.from_edge_tuples(edges)
        vids = _np(gr.vertex_ids)
        init = np.full(len(vids), np.iinfo(np.int64).max - 1, np.int64)
        init[np.searchsorted(vids, 1)] = 0

        def vprog(attrs, msgs, has_msg, where=where, minimum=minimum):
            return {"d": where(has_msg, minimum(attrs["d"], msgs),
                               attrs["d"])}

        def send(srcs, dsts, eattrs):
            cand = srcs["d"] + 1
            return cand, cand < dsts["d"]

        out = G.pregel(gr, {"d": init}, vprog, send, merge="min",
                       max_iterations=10)
        results.append(_np(out["d"]))
    np.testing.assert_array_equal(results[1], results[0])


def test_pregel_max_merge_float(tspark):
    """A float max-merge Pregel (largest incoming value propagates):
    within 1e-10 of the reference."""
    edges = _edge_list(4, n=20, m=60, offset=1)
    outs = []
    for G, where, maximum in ((RG, jnp.where, jnp.maximum),
                              (TG, torch.where, torch.maximum)):
        gr = G.Graph.from_edge_tuples(edges)
        init = np.linspace(0.0, 1.0, gr.num_vertices)

        def vprog(a, m, h, where=where, maximum=maximum):
            return {"v": where(h, maximum(a["v"], m * 0.5), a["v"])}

        def send(s, d, e):
            return s["v"], s["v"] * 0.5 > d["v"]
        outs.append(_np(G.pregel(gr, {"v": init}, vprog, send, merge="max",
                                 max_iterations=8)["v"]))
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL)


def test_to_dataframes(spark, tspark, gs):
    r, t = gs
    (rv, re), (tv, te) = r.to_dataframes(spark), t.to_dataframes(tspark)
    assert tv.count() == t.num_vertices and te.count() == t.num_edges
    for a, b in ((rv, tv), (re, te)):
        assert [tuple(x) for x in b.collect()] == \
            [tuple(x) for x in a.collect()]


def test_graph_from_reference(gs):
    """A reference graph carried over runs the port's algorithms to the
    same integer answers and the same ranks."""
    r, _t = gs
    t = graph_from_reference(r, device="cpu")
    np.testing.assert_array_equal(_np(TG.connected_components(t)),
                                  _np(RG.connected_components(r)))
    np.testing.assert_allclose(_np(TG.page_rank(t, 20)),
                               _np(RG.page_rank(r, 20)), rtol=RTOL)
    np.testing.assert_array_equal(_np(t.degrees), _np(r.degrees))
