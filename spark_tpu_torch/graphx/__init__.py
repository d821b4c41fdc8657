"""Graph processing on torch segment reductions (the GraphX analog).

The port of ``spark_tpu/graphx/``.  The reference
(`graphx/.../Graph.scala`, `Pregel.scala:59`) builds graphs on RDDs with
per-superstep joins; here a graph IS a set of tensors on the session's
device (dense-indexed vertices, edge endpoint indices),
`aggregateMessages` is a vectorized edge computation + a segment
reduction (`index_add_` / `scatter_reduce_` seeded with the reduction's
identity), and Pregel supersteps are host-driven iterations of torch ops.
"""

from .graph import Edge, Graph, pregel                       # noqa: F401
from .lib import (                                           # noqa: F401
    connected_components, page_rank, shortest_paths, triangle_count,
)
