"""Graph algorithms (`graphx/lib/`): PageRank, connected components,
shortest paths, triangle count — each a handful of segment-op supersteps.

The port of ``spark_tpu/graphx/lib.py``: each ``jax.jit`` step is a few
torch ops on the graph's device, and the loop reads the device only where
the reference does (the ``changed`` count of a label propagation, and
PageRank's ``delta`` only when ``tol > 0``).  Triangle count is host code
in both packages."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .graph import Graph, segment_reduce

#: distance reported for unreachable vertices (overflow-safe sentinel)
UNREACHABLE = int(np.iinfo(np.int64).max // 4)


def _vertex_index(vids: np.ndarray, vid: int):
    """Index of an external vertex id; handles unsorted id arrays (the
    public Graph constructor does not require sorted ids)."""
    hits = np.nonzero(vids == vid)[0]
    return int(hits[0]) if len(hits) else None


def page_rank(graph: Graph, num_iter: int = 20, reset_prob: float = 0.15,
              tol: float = 0.0) -> torch.Tensor:
    """Reference-convention PageRank (`lib/PageRank.scala`): ranks start at
    1.0 and update as resetProb + (1-resetProb) * sum(incoming rank/outDeg)
    — unnormalized, matching GraphX's output values."""
    n = graph.num_vertices
    safe_deg = graph.out_degrees.to(torch.float64).clamp_min(1)
    src, dst = graph.src, graph.dst
    ranks = torch.ones(n, dtype=torch.float64, device=graph.device)
    for _ in range(num_iter):
        contrib = (ranks / safe_deg)[src]
        sums = segment_reduce(contrib, dst, n, "sum")
        new = reset_prob + (1.0 - reset_prob) * sums
        delta = (new - ranks).abs().max() if tol > 0.0 else None
        ranks = new
        if delta is not None and float(delta) < tol:
            break
    return ranks


pageRank = page_rank


def connected_components(graph: Graph, max_iterations: int = 64
                         ) -> torch.Tensor:
    """Min-label propagation (`lib/ConnectedComponents.scala`): every
    vertex converges to the smallest vertex ID in its component."""
    n = graph.num_vertices
    src, dst = graph.src, graph.dst
    cc = graph.vertex_ids
    for _ in range(max_iterations):
        # isolated vertices get the identity (int64 max) from empty
        # segments; minimum() with the own label already handles it
        to_dst = segment_reduce(cc[src], dst, n, "min")
        to_src = segment_reduce(cc[dst], src, n, "min")
        new = torch.minimum(cc, torch.minimum(to_dst, to_src))
        changed = int((new != cc).sum())
        cc = new
        if changed == 0:
            break
    return cc


connectedComponents = connected_components


def shortest_paths(graph: Graph, landmarks: Sequence[int],
                   max_iterations: int = 64) -> Dict[int, torch.Tensor]:
    """Unweighted BFS distances to each landmark
    (`lib/ShortestPaths.scala`); unreachable = UNREACHABLE (int64 max/4,
    far above any real distance and overflow-safe under the +1 relax)."""
    n = graph.num_vertices
    src, dst = graph.src, graph.dst
    vids = graph.vertex_ids.cpu().numpy()
    out: Dict[int, torch.Tensor] = {}
    for lm in landmarks:
        idx = _vertex_index(vids, lm)
        if idx is None:
            raise ValueError(f"landmark {lm} is not a vertex")
        dist = torch.full((n,), UNREACHABLE, dtype=torch.int64,
                          device=graph.device)
        dist[idx] = 0
        for _ in range(max_iterations):
            # relax over both directions; empty segments yield int64
            # max, capped before +1 so isolated vertices cannot wrap
            d_dst = segment_reduce(dist[src], dst, n, "min")
            d_src = segment_reduce(dist[dst], src, n, "min")
            best = torch.minimum(d_dst, d_src).clamp_max(UNREACHABLE)
            relaxed = torch.minimum(dist, best + 1)
            changed = int((relaxed != dist).sum())
            dist = relaxed
            if changed == 0:
                break
        out[lm] = dist
    return out


shortestPaths = shortest_paths


def triangle_count(graph: Graph) -> torch.Tensor:
    """Per-vertex triangle counts (`lib/TriangleCount.scala`): canonical
    undirected edges, neighbor-set intersection per edge, summed to both
    endpoints.  Host adjacency build, as in the reference."""
    src = graph.src.cpu().numpy()
    dst = graph.dst.cpu().numpy()
    n = graph.num_vertices
    # canonicalize: undirected unique edges, no self loops
    a, b = np.minimum(src, dst), np.maximum(src, dst)
    keep = a != b
    edges = np.unique(np.stack([a[keep], b[keep]], 1), axis=0)
    adj = [set() for _ in range(n)]
    for u, v in edges:
        adj[u].add(v)
        adj[v].add(u)
    counts = np.zeros(n, np.int64)
    for u, v in edges:
        common = len(adj[u] & adj[v])
        counts[u] += common
        counts[v] += common
    # each triangle contributes twice per vertex (once per incident edge
    # of the triangle at that vertex) -> halve
    return torch.from_numpy(counts // 2).to(graph.device)


triangleCount = triangle_count
