"""Physical operators.

The analog of ``sql/core/.../execution/SparkPlan.scala`` operators, as in
``spark_tpu/sql/physical.py``: each node's ``run`` is a function from
ColumnBatches to a ColumnBatch.  Here the tree runs eagerly, one torch
call after another, on the device the leaves live on; string dictionaries
stay host metadata and dictionary remaps are small host tables moved to
the device where they are gathered.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from .. import types as T
from ..capture import constant
from ..aggregates import AggregateFunction
from ..columnar import (ColumnBatch, ColumnVector, merge_dictionaries,
                        pad_capacity)
from ..expressions import EvalContext, Expression
from ..kernels import (
    apply_filter, apply_limit, apply_project, distinct as k_distinct,
    grouped_aggregate, sort_batch,
)

Array = Any


class ExecContext:
    def __init__(self, device, leaves: List[ColumnBatch]):
        self.device = torch.device(device)
        self.leaves = leaves
        # device scalars read on the host after execution (join/agg-shrink
        # overflow accounting — the dynamic-shape escape hatch); kinds and
        # static capacities let the executor adapt the right factor and
        # size the retry from the measured overflow
        self.flags: List[Array] = []
        self.flag_kinds: List[str] = []
        self.flag_caps: List[int] = []
        # per-operator metrics (SQLMetrics.scala:34 analog): row counts
        # keyed by (op_id, label), fetched with the result
        self.metrics: List[Tuple[int, str, Array]] = []

    def add_flag(self, value: Array, kind: str, cap: int) -> None:
        self.flags.append(value)
        self.flag_kinds.append(kind)
        self.flag_caps.append(cap)

    def add_metric(self, op_id: int, label: str, value: Array) -> None:
        self.metrics.append((op_id, label, value))


class PhysicalPlan:
    children: Tuple["PhysicalPlan", ...] = ()
    #: stable preorder position, assigned by the planner
    op_id: int = 0

    def schema(self) -> T.StructType:
        raise NotImplementedError

    def run(self, ctx: ExecContext) -> ColumnBatch:
        raise NotImplementedError

    def key(self) -> str:
        """Structural fingerprint (data-independent parts)."""
        inner = ",".join(c.key() for c in self.children)
        return f"{self!r}({inner})"

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + "*- " + repr(self) + "\n"
        for c in self.children:
            s += c.tree_string(indent + 1)
        return s

    def __repr__(self):  # pragma: no cover
        return type(self).__name__


class PMetric(PhysicalPlan):
    """Transparent wrapper recording the child's output row count
    (`SQLMetrics` numOutputRows); inserted by the planner when
    spark.sql.metrics.enabled is on."""

    def __init__(self, child: PhysicalPlan):
        self.children = (child,)

    @property
    def label(self) -> str:
        return repr(self.children[0]).split("(")[0].split(" ")[0]

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx: ExecContext) -> ColumnBatch:
        out = self.children[0].run(ctx)
        ctx.add_metric(self.children[0].op_id, self.label, out.num_rows())
        return out

    def key(self):
        return f"M({self.children[0].key()})"

    def __repr__(self):
        return "Metric"


class PScan(PhysicalPlan):
    """Leaf: reads the i-th prepared input batch (resident on the device)."""

    def __init__(self, index: int, schema: T.StructType):
        self.index = index
        self._schema = schema

    def schema(self):
        return self._schema

    def run(self, ctx: ExecContext) -> ColumnBatch:
        return ctx.leaves[self.index]

    def __repr__(self):
        return f"Scan[{self.index}] {self._schema.simpleString()}"


class PRange(PhysicalPlan):
    """range() generated directly on the device (``RangeExec``)."""

    def __init__(self, start: int, end: int, step: int, name: str, num_rows: int):
        self.start, self.end, self.step = start, end, step
        self.name = name
        self.num_rows = num_rows
        self.capacity = pad_capacity(num_rows)

    def schema(self):
        return T.StructType([T.StructField(self.name, T.int64, False)])

    def run(self, ctx: ExecContext) -> ColumnBatch:
        idx = torch.arange(self.capacity, dtype=torch.int64, device=ctx.device)
        data = idx * self.step + self.start
        rv = idx < self.num_rows
        return ColumnBatch([self.name], [ColumnVector(data, T.int64)], rv,
                           self.capacity)

    def __repr__(self):
        return f"Range({self.start},{self.end},{self.step})"


class PProject(PhysicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: PhysicalPlan):
        self.exprs = list(exprs)
        self.children = (child,)

    def schema(self):
        cs = self.children[0].schema()
        return T.StructType([T.StructField(e.name, e.data_type(cs)) for e in self.exprs])

    def run(self, ctx):
        batch = self.children[0].run(ctx)
        out = apply_project(batch, self.exprs)
        out.names = [e.name for e in self.exprs]
        return out

    def __repr__(self):
        return f"Project [{', '.join(repr(e) for e in self.exprs)}]"


class PFilter(PhysicalPlan):
    def __init__(self, cond: Expression, child: PhysicalPlan):
        self.cond = cond
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx):
        return apply_filter(self.children[0].run(ctx), self.cond)

    def __repr__(self):
        return f"Filter ({self.cond!r})"


class PAggregate(PhysicalPlan):
    """Grouped aggregation (HashAggregateExec replacement, see kernels)."""

    def __init__(self, keys: Sequence[Expression],
                 slots: Sequence[Tuple[AggregateFunction, str]],
                 child: PhysicalPlan):
        self.keys = list(keys)
        self.slots = list(slots)
        self.children = (child,)

    def schema(self):
        cs = self.children[0].schema()
        fields = [T.StructField(k.name, k.data_type(cs)) for k in self.keys]
        fields += [T.StructField(n, f.data_type(cs)) for f, n in self.slots]
        return T.StructType(fields)

    def run(self, ctx):
        batch = self.children[0].run(ctx)
        return grouped_aggregate(batch, self.keys, self.slots)

    def __repr__(self):
        return (f"Aggregate keys=[{', '.join(repr(k) for k in self.keys)}] "
                f"aggs=[{', '.join(f'{f!r} AS {n}' for f, n in self.slots)}]")


class PAggShrink(PhysicalPlan):
    """Slice a keyed aggregate/distinct output to a bounded static
    capacity (``spark.sql.agg.outputCapacity``).

    Keyed aggregation keeps the INPUT capacity, so a downstream sort/join
    would pay full-capacity work for a handful of live groups.  The slice
    is lossless whenever the true group count fits: the sorted form emits
    groups at slots 0..k-1 and the MXU form confines live buckets to the
    first bucket_cap slots.  A flag reports any groups lost past the
    bound; the executor's adaptive retry then grows the capacity."""

    def __init__(self, out_rows: int, child: PhysicalPlan):
        self.out_rows = int(out_rows)
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx):
        b = self.children[0].run(ctx)
        S = self.out_rows
        if S >= b.capacity:
            return b
        live = b.row_valid_or_true()
        total = live.sum(dtype=torch.int64)
        kept = live[:S].sum(dtype=torch.int64)
        ctx.add_flag(total - kept, "shrink", S)
        vecs = [ColumnVector(v.data[:S], v.dtype,
                             None if v.valid is None else v.valid[:S],
                             v.dictionary) for v in b.vectors]
        return ColumnBatch(b.names, vecs, live[:S], S)

    def __repr__(self):
        return f"AggShrink({self.out_rows})"


class PSort(PhysicalPlan):
    def __init__(self, orders: Sequence[Tuple[Expression, bool, bool]],
                 child: PhysicalPlan):
        self.orders = list(orders)
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx):
        batch = self.children[0].run(ctx)
        ectx = EvalContext(batch)
        schema = batch.schema
        keys = []
        for e, asc, nf in self.orders:
            v = ectx.broadcast(e.eval(ectx))
            keys.append((v.data, v.valid, e.data_type(schema), asc, nf))
        return sort_batch(batch, keys)

    def __repr__(self):
        parts = [f"{e!r} {'ASC' if a else 'DESC'} {'NF' if n else 'NL'}"
                 for e, a, n in self.orders]
        return f"Sort [{', '.join(parts)}]"


class PLimit(PhysicalPlan):
    def __init__(self, n: int, child: PhysicalPlan):
        self.n = n
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx):
        return apply_limit(self.children[0].run(ctx), self.n)

    def __repr__(self):
        return f"Limit {self.n}"


class PDistinct(PhysicalPlan):
    def __init__(self, child: PhysicalPlan):
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx):
        return k_distinct(self.children[0].run(ctx))

    def __repr__(self):
        return "Distinct"


class PUnion(PhysicalPlan):
    """Concatenate children on the device, each at its full capacity with
    its own row mask (so the output keeps every branch's rows in branch
    order); string columns re-encode onto merged dictionaries: the host
    merges the dictionaries into small remap tables, the device gathers."""

    def __init__(self, children: Sequence[PhysicalPlan], schema: T.StructType):
        self.children = tuple(children)
        self._schema = schema

    def schema(self):
        return self._schema

    def run(self, ctx):
        batches = [c.run(ctx) for c in self.children]
        capacity = sum(b.capacity for b in batches)
        vectors: List[ColumnVector] = []
        for i, f in enumerate(self._schema.fields):
            vecs = [b.vectors[i] for b in batches]
            dt = f.dataType
            dictionary = None
            if dt.is_string or isinstance(dt, T.BinaryType):
                merged: tuple = ()
                remaps: List[Any] = [None] * len(vecs)
                for j, v in enumerate(vecs):
                    merged, r_old, r_new = merge_dictionaries(
                        merged, v.dictionary or ())
                    for k in range(j):
                        if remaps[k] is not None:
                            remaps[k] = r_old[remaps[k]]
                        elif len(r_old):
                            remaps[k] = r_old
                    remaps[j] = r_new
                datas = []
                for v, rm in zip(vecs, remaps):
                    d = v.data
                    if rm is not None and len(rm):
                        table = constant(rm, ctx.device)
                        d = table[d.long().clamp(0, len(rm) - 1)]
                    datas.append(d.to(torch.int32))
                data = torch.cat(datas)
                dictionary = merged
            else:
                data = torch.cat([v.data.to(dt.torch_dtype) for v in vecs])
            valid = None
            if any(v.valid is not None for v in vecs):
                valid = torch.cat([
                    v.valid if v.valid is not None else
                    torch.ones(b.capacity, dtype=torch.bool, device=ctx.device)
                    for v, b in zip(vecs, batches)])
            vectors.append(ColumnVector(data, dt, valid, dictionary))
        rv = torch.cat([b.row_valid_or_true() for b in batches])
        return ColumnBatch(list(self._schema.names), vectors, rv, capacity)

    def __repr__(self):
        return f"Union({len(self.children)})"


class _NotYetPorted(PhysicalPlan):
    """An operator of the JAX package that a later slice of the port
    brings; planning it is fine, running it raises."""

    slice_name = "a later slice"

    def __init__(self, *children: PhysicalPlan):
        self.children = tuple(children)

    def run(self, ctx):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet: it comes with "
            f"{self.slice_name}")


class PSample(_NotYetPorted):
    slice_name = "the TPC-DS breadth slice (rand/sample)"


class PWindow(_NotYetPorted):
    slice_name = "the window-function slice"


class PExplode(_NotYetPorted):
    slice_name = "the TPC-DS breadth slice (array columns)"
