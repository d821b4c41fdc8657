"""Physical operators.

The analog of ``sql/core/.../execution/SparkPlan.scala`` operators, as in
``spark_tpu/sql/physical.py``: each node's ``run`` is a function from
ColumnBatches to a ColumnBatch.  Here the tree runs eagerly, one torch
call after another, on the device the leaves live on; string dictionaries
stay host metadata and dictionary remaps are small host tables moved to
the device where they are gathered.
"""

from __future__ import annotations

import functools

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
        #: called after each operator's run (the eager lane's statement
        #: cancellation checkpoint); None inside a captured stage
        self.checkpoint = None
        #: high bits of first/last row ranks (``dist.DPartialAggregate``):
        #: 0 on one device, ``shard << 48`` in a mesh shard
        self.shard_offset = 0

    def add_flag(self, value: Array, kind: str, cap: int) -> None:
        self.flags.append(value)
        self.flag_kinds.append(kind)
        self.flag_caps.append(cap)

    def add_metric(self, op_id: int, label: str, value: Array) -> None:
        self.metrics.append((op_id, label, value))


def _checkpointed(run):
    @functools.wraps(run)
    def wrapped(self, ctx):
        out = run(self, ctx)
        checkpoint = getattr(ctx, "checkpoint", None)
        if checkpoint is not None:
            checkpoint()
        return out
    return wrapped


class PhysicalPlan:
    children: Tuple["PhysicalPlan", ...] = ()
    #: stable preorder position, assigned by the planner; shifted into the
    #: upper bits of RowIndex/Rand offsets so the positional expressions
    #: of two operators draw apart (MonotonicallyIncreasingID's
    #: partition-id trick, applied to operator identity)
    op_id: int = 0

    @property
    def row_offset(self) -> int:
        return self.op_id << 33

    def offset_in(self, ctx: "ExecContext") -> int:
        """The operator's offset plus the shard's (``shard << 48`` on the
        mesh lane): a host int, a constant of the plan."""
        return self.row_offset + getattr(ctx, "shard_offset", 0)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "run" in cls.__dict__:
            cls.run = _checkpointed(cls.__dict__["run"])

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
        out = apply_project(batch, self.exprs, self.offset_in(ctx))
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
        return apply_filter(self.children[0].run(ctx), self.cond,
                            self.offset_in(ctx))

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


class PSample(PhysicalPlan):
    """sample(fraction, seed): keep the rows whose ``rand(seed)`` draw is
    below ``fraction`` (a filter: the row mask only)."""

    def __init__(self, fraction: float, seed: int, child: PhysicalPlan):
        self.fraction = fraction
        self.seed = seed
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def run(self, ctx):
        from ..expressions import LT, Literal, Rand
        cond = LT(Rand(self.seed), Literal(float(self.fraction)))
        return apply_filter(self.children[0].run(ctx), cond,
                            self.offset_in(ctx))

    def __repr__(self):
        return f"Sample({self.fraction}, seed={self.seed})"


class PWindow(PhysicalPlan):
    """Window operator: one sort per spec and vectorized prefix scans
    (``execution/window/WindowExec.scala`` analog, without per-group
    loops)."""

    def __init__(self, wexprs, child: PhysicalPlan):
        self.wexprs = list(wexprs)     # [(WindowExpression, out_name)]
        self.children = (child,)

    def schema(self):
        cs = self.children[0].schema()
        fields = list(cs.fields)
        for we, name in self.wexprs:
            fields.append(T.StructField(name, we.data_type(cs), True))
        return T.StructType(fields)

    def run(self, ctx):
        from .window import compute_windows
        batch = self.children[0].run(ctx)
        spec = self.wexprs[0][0].spec
        funcs = [(we.func, name) for we, name in self.wexprs]
        return compute_windows(batch, spec, funcs)

    def __repr__(self):
        return f"Window [{', '.join(n for _, n in self.wexprs)}]"


class PExplode(PhysicalPlan):
    """Static row generation: a ``(capacity, L)`` array flattens to
    ``capacity * L`` rows, the other select expressions repeat each row L
    times, and the dead element slots join the row mask."""

    def __init__(self, pre_exprs, array_expr, out_name, with_pos, pos_name,
                 child, insert_at=None):
        self.pre_exprs = list(pre_exprs)
        self.array_expr = array_expr
        self.out_name = out_name
        self.with_pos = with_pos
        self.pos_name = pos_name
        self.insert_at = len(self.pre_exprs) if insert_at is None \
            else int(insert_at)
        self.children = (child,)

    def schema(self):
        cs = self.children[0].schema()
        gen = []
        if self.with_pos:
            gen.append(T.StructField(self.pos_name, T.int32, False))
        at = self.array_expr.data_type(cs)
        gen.append(T.StructField(self.out_name, at.element_type))
        fields = [T.StructField(e.name, e.data_type(cs))
                  for e in self.pre_exprs]
        i = min(self.insert_at, len(fields))
        return T.StructType(fields[:i] + gen + fields[i:])

    def run(self, ctx):
        from ..expressions import _array_elem_mask
        batch = self.children[0].run(ctx)
        ectx = EvalContext(batch, self.offset_in(ctx))
        cap = batch.capacity
        at = self.array_expr.data_type(batch.schema)
        av = self.array_expr.eval(ectx)
        data = av.data
        if data.dim() == 1:
            # an array literal: one row's elements, the same for every row
            data = data.expand(cap, data.shape[0])
        width = int(data.shape[-1])
        emask = _array_elem_mask(at, data)                # (cap, L)
        pre_cols = []
        for e in self.pre_exprs:
            v = ectx.broadcast(e.eval(ectx))
            dt = e.data_type(batch.schema)
            d = torch.repeat_interleave(v.data.to(dt.torch_dtype), width,
                                        dim=0)
            valid = None if v.valid is None \
                else torch.repeat_interleave(v.valid, width)
            pre_cols.append((e.name, ColumnVector(d, dt, valid,
                                                  v.dictionary)))
        gen_cols = []
        if self.with_pos:
            pos = torch.arange(width, dtype=torch.int32,
                               device=ctx.device).repeat(cap)
            gen_cols.append((self.pos_name,
                             ColumnVector(pos, T.int32, None, None)))
        gen_cols.append((self.out_name,
                         ColumnVector(data.reshape(cap * width),
                                      at.element_type, None,
                                      av.dictionary)))
        i = min(self.insert_at, len(pre_cols))
        ordered = pre_cols[:i] + gen_cols + pre_cols[i:]
        rv = batch.row_valid_or_true()
        if av.valid is not None:
            rv = rv & av.valid
        out_rv = torch.repeat_interleave(rv, width) & emask.reshape(-1)
        return ColumnBatch([n for n, _v in ordered],
                           [v for _n, v in ordered], out_rv, cap * width)

    def __repr__(self):
        pos = f" POS {self.pos_name}" if self.with_pos else ""
        pre = ", ".join(repr(e) for e in self.pre_exprs)
        return (f"Explode[{pre} | {self.array_expr!r} AS "
                f"{self.out_name}{pos} @{self.insert_at}]")
