"""Graph + aggregateMessages + Pregel.

The port of ``spark_tpu/graphx/graph.py``.  Design mapping from the
reference:
- `Graph[VD, ED]` (`graphx/.../Graph.scala`)           -> dense vertex
  tensors + edge endpoint INDEX tensors on one device (vertex ids
  remapped once at construction; int64 ``vertex_ids``, int32 ``src`` /
  ``dst`` as in the JAX package).
- `aggregateMessages(sendMsg, mergeMsg)` (`GraphOps`)  -> a vectorized
  message function over (src attrs, dst attrs, edge attrs) tensors + a
  sum/min/max segment reduction by destination (``segment_reduce``); no
  triplet iterator.
- `Pregel.scala:59`                                    -> host loop over
  one superstep of torch ops; active-vertex semantics via a has-message
  mask.

The device is the one of a tensor handed to the constructor, else the
active session's (``SparkSession.builder.getOrCreate()``: the card unless
the session was made with ``spark.torch.device=cpu``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..columnar import device_tensor

Tensor = torch.Tensor


def default_device() -> torch.device:
    """The device of the active session (made under the session's device
    policy when there is none)."""
    from ..sql.session import SparkSession
    return SparkSession.builder.getOrCreate().device


def _identity(dtype: torch.dtype, kind: str):
    """The value ``jax.ops.segment_min`` / ``segment_max`` give an empty
    segment: the dtype's largest (min) or smallest (max) value."""
    if dtype == torch.bool:
        return kind == "min"
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def segment_reduce(data: Tensor, ids: Tensor, n: int, kind: str) -> Tensor:
    """``jax.ops.segment_{sum,min,max}(data, ids, num_segments=n)``: row
    ``i`` of ``data`` goes into segment ``ids[i]``; a segment no row
    reaches holds the identity (0, the dtype's max, or its min).  Integer
    results are exact; float sums change their last bits with the order
    of the atomic adds."""
    shape = (n,) + tuple(data.shape[1:])
    if kind == "sum":
        out = torch.zeros(shape, dtype=data.dtype, device=data.device)
        return out.index_add_(0, ids, data)
    out = torch.full(shape, _identity(data.dtype, kind), dtype=data.dtype,
                     device=data.device)
    idx = ids.to(torch.int64)
    if data.dim() > 1:
        idx = idx.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data,
                               reduce="amin" if kind == "min" else "amax",
                               include_self=True)


class Edge(NamedTuple):
    """srcId, dstId, attr — constructor-compat with the reference Edge."""

    srcId: int
    dstId: int
    attr: Any = 1.0


class Graph:
    """Immutable graph over device tensors.

    vertex_ids: (n,) int64 external ids (unique); vertex/edge attrs are
    name -> (n,)/(m,) tensors; src/dst hold DENSE int32 indices into
    vertex_ids.
    """

    def __init__(self, vertex_ids, vertex_attrs: Dict[str, Any], src, dst,
                 edge_attrs: Optional[Dict[str, Any]] = None):
        given = [x for x in (vertex_ids, src, dst)
                 if isinstance(x, torch.Tensor)]
        device = given[0].device if given else default_device()
        self.vertex_ids = device_tensor(vertex_ids, device, torch.int64)
        self.vertex_attrs = {k: device_tensor(v, device)
                             for k, v in (vertex_attrs or {}).items()}
        self.src = device_tensor(src, device, torch.int32)
        self.dst = device_tensor(dst, device, torch.int32)
        self.edge_attrs = {k: device_tensor(v, device)
                           for k, v in (edge_attrs or {}).items()}

    @property
    def device(self) -> torch.device:
        return self.vertex_ids.device

    # -- construction -----------------------------------------------------
    @staticmethod
    def from_edge_tuples(edges, default_attr=1.0,
                         vertex_attrs: Optional[Dict[str, Any]] = None
                         ) -> "Graph":
        """Build from (srcId, dstId[, attr]) tuples / arrays; vertex set =
        union of endpoint ids (`Graph.fromEdgeTuples`)."""
        es = list(edges)
        srcs = np.array([e[0] for e in es], np.int64)
        dsts = np.array([e[1] for e in es], np.int64)
        attr = np.array([e[2] if len(e) > 2 else default_attr for e in es])
        vids = np.unique(np.concatenate([srcs, dsts]))
        src_idx = np.searchsorted(vids, srcs)
        dst_idx = np.searchsorted(vids, dsts)
        return Graph(vids, vertex_attrs or {}, src_idx, dst_idx,
                     {"attr": attr})

    fromEdgeTuples = from_edge_tuples

    @staticmethod
    def from_edges(edges, default_vertex_attr=None) -> "Graph":
        g = Graph.from_edge_tuples(
            [(e.srcId, e.dstId, e.attr) for e in edges])
        if default_vertex_attr is not None:
            g.vertex_attrs["attr"] = device_tensor(
                np.full((g.num_vertices,), default_vertex_attr), g.device)
        return g

    fromEdges = from_edges

    # -- basics -----------------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return int(self.vertex_ids.shape[0])

    numVertices = num_vertices

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    numEdges = num_edges

    def _degrees(self, ends: Tensor) -> Tensor:
        return segment_reduce(torch.ones_like(ends, dtype=torch.int64),
                              ends, self.num_vertices, "sum")

    @property
    def out_degrees(self) -> Tensor:
        return self._degrees(self.src)

    outDegrees = out_degrees

    @property
    def in_degrees(self) -> Tensor:
        return self._degrees(self.dst)

    inDegrees = in_degrees

    @property
    def degrees(self) -> Tensor:
        return self.out_degrees + self.in_degrees

    def reverse(self) -> "Graph":
        return Graph(self.vertex_ids, self.vertex_attrs, self.dst, self.src,
                     self.edge_attrs)

    def map_vertices(self, fn: Callable[[Dict[str, Tensor]],
                                        Dict[str, Tensor]]) -> "Graph":
        return Graph(self.vertex_ids, fn(dict(self.vertex_attrs)),
                     self.src, self.dst, self.edge_attrs)

    mapVertices = map_vertices

    def map_edges(self, fn) -> "Graph":
        return Graph(self.vertex_ids, self.vertex_attrs, self.src, self.dst,
                     fn(dict(self.edge_attrs)))

    mapEdges = map_edges

    def subgraph(self, edge_mask) -> "Graph":
        """Edges where mask holds (vertex set unchanged, like the
        reference's epred-only subgraph)."""
        mask = device_tensor(edge_mask, self.device, torch.bool)
        return Graph(self.vertex_ids, self.vertex_attrs, self.src[mask],
                     self.dst[mask],
                     {k: v[mask] for k, v in self.edge_attrs.items()})

    # -- the message primitive -------------------------------------------
    def aggregate_messages(self, send: Callable, merge: str = "sum",
                           to: str = "dst") -> Tensor:
        """`aggregateMessages`: `send(src_attrs, dst_attrs, edge_attrs)`
        returns one message TENSOR of shape (num_edges, ...); messages
        reduce per `to`-vertex with the named kind.  Vertices receiving no
        message get the reduction identity (mask with degrees if needed).
        """
        srcs = {k: v[self.src] for k, v in self.vertex_attrs.items()}
        dsts = {k: v[self.dst] for k, v in self.vertex_attrs.items()}
        msg = send(srcs, dsts, self.edge_attrs)
        seg = self.dst if to == "dst" else self.src
        return segment_reduce(msg, seg, self.num_vertices, merge)

    aggregateMessages = aggregate_messages

    # -- interop ----------------------------------------------------------
    def to_dataframes(self, session) -> Tuple:
        """(vertices df, edges df) for SQL-side analysis."""
        vids = self.vertex_ids.cpu().numpy()
        v = {"id": vids}
        v.update({k: a.cpu().numpy() for k, a in self.vertex_attrs.items()})
        e = {"src": vids[self.src.cpu().numpy()],
             "dst": vids[self.dst.cpu().numpy()]}
        e.update({k: a.cpu().numpy() for k, a in self.edge_attrs.items()})
        return session.createDataFrame(v), session.createDataFrame(e)


def pregel(graph: Graph, initial_attrs: Dict[str, Any],
           vprog: Callable, send: Callable, merge: str = "sum",
           max_iterations: int = 20, initial_msg=None):
    """BSP iteration (`Pregel.scala:59`), vectorized.

    - `vprog(attrs, msgs, has_msg)` -> new vertex attr dict (applied every
      superstep; use `has_msg` to keep inactive vertices unchanged)
    - `send(src_attrs, dst_attrs, edge_attrs)` -> (msg_tensor, send_mask)
      per edge; masked edges send the reduction identity
    - `initial_msg`: delivered to EVERY vertex before the first superstep
      (vprog runs once with all has_msg true), per the reference contract
    - halts when no edge sends (all masks false) or after max_iterations;
      the one host read per superstep is that count, as in the reference

    Returns the final vertex attrs dict.
    """
    n = graph.num_vertices
    dev = graph.device
    attrs = {k: device_tensor(v, dev) for k, v in initial_attrs.items()}
    if initial_msg is not None:
        first = device_tensor(initial_msg, dev).expand(n)
        attrs = vprog(dict(attrs), first,
                      torch.ones(n, dtype=torch.bool, device=dev))

    def superstep(attrs):
        srcs = {k: v[graph.src] for k, v in attrs.items()}
        dsts = {k: v[graph.dst] for k, v in attrs.items()}
        msg, send_mask = send(srcs, dsts, graph.edge_attrs)
        send_mask = device_tensor(send_mask, dev, torch.bool)
        fill = 0 if merge == "sum" else _identity(msg.dtype, merge)
        masked = torch.where(send_mask, msg,
                             torch.tensor(fill, dtype=msg.dtype, device=dev))
        msgs = segment_reduce(masked, graph.dst, n, merge)
        has_msg = segment_reduce(send_mask.to(torch.int32), graph.dst, n,
                                 "max") > 0
        new_attrs = vprog(dict(attrs), msgs, has_msg)
        active = send_mask.to(torch.int64).sum()
        return new_attrs, active

    for _ in range(max_iterations):
        attrs, active = superstep(attrs)
        if int(active) == 0:
            break
    return attrs
