"""Python UDFs (a port of ``spark_tpu/sql/udf.py``).

The analog of `execution/python/BatchEvalPythonExec.scala` +
`api/python/PythonRDD.scala:44`: the driver IS Python, so there is no
pickle pipe to pay for, and a UDF runs in one of two lanes:

- **row lane** (default): a per-row Python function.  The argument
  columns, their validity masks and the row mask come to the host in ONE
  device→host copy, the rows loop runs in Python over live rows, and the
  (values, validity) pair goes back in ONE host→device copy — the JAX
  package's ``jax.pure_callback`` bridge, done eagerly.  ``HOST_COPIES``
  counts both directions and their bytes.
- **vectorized lane** (``vectorized=True``): the function receives the
  argument columns as torch tensors on the session's device and returns
  one; it runs like any built-in expression.

Limitations (loud, not silent), as in the JAX package: string/binary
RETURN types need a dictionary built from the results — unsupported;
UDFs are assumed deterministic (they replay per shard on the mesh lane).
"""

from __future__ import annotations

import datetime
import itertools
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..expressions import (
    AnalysisException, EvalContext, Expression, ExprValue, and_valid,
)

__all__ = ["PythonUDF", "UnresolvedFunction", "UDFRegistration", "make_udf",
           "HOST_COPIES", "plan_has_slow_udf"]

_EPOCH_DATE = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1)

#: the row lane's transfers: copies each way and the bytes they moved
HOST_COPIES = {"to_host": 0, "to_host_bytes": 0,
               "to_device": 0, "to_device_bytes": 0}


def _decode_value(raw, dt: T.DataType, dictionary):
    if dictionary is not None:
        i = int(raw)
        return dictionary[i] if 0 <= i < len(dictionary) else None
    if isinstance(dt, T.DateType):
        return _EPOCH_DATE + datetime.timedelta(days=int(raw))
    if isinstance(dt, T.TimestampType):
        return _EPOCH_TS + datetime.timedelta(microseconds=int(raw))
    if isinstance(dt, T.BooleanType):
        return bool(raw)
    if dt.is_integral:
        return int(raw)
    return float(raw) if np.issubdtype(np.asarray(raw).dtype, np.floating) \
        else raw.item() if hasattr(raw, "item") else raw


def _encode_value(v, dt: T.DataType):
    if isinstance(dt, T.DateType):
        return (v - _EPOCH_DATE).days if isinstance(v, datetime.date) else v
    if isinstance(dt, T.TimestampType) and isinstance(v, datetime.datetime):
        delta = v - _EPOCH_TS
        return delta.days * 86_400_000_000 + delta.seconds * 1_000_000 \
            + delta.microseconds
    return v


def to_host_once(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of same-length 1-D tensors of any dtypes in ONE
    device→host transfer: their bytes are packed on the device, copied,
    and split again on the host."""
    parts = [t.contiguous().view(torch.uint8) for t in tensors]
    packed = torch.cat(parts).cpu().numpy()
    HOST_COPIES["to_host"] += 1
    HOST_COPIES["to_host_bytes"] += packed.nbytes
    out, at = [], 0
    for t, p in zip(tensors, parts):
        n = p.numel()
        out.append(packed[at:at + n].view(T.torch_to_np_dtype(t.dtype)))
        at += n
    return out


def to_device_once(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Device copies of host arrays in ONE host→device transfer."""
    raw = [np.ascontiguousarray(a).view(np.uint8) for a in arrays]
    packed = torch.from_numpy(np.concatenate(raw)).to(device)
    HOST_COPIES["to_device"] += 1
    HOST_COPIES["to_device_bytes"] += sum(r.nbytes for r in raw)
    out, at = [], 0
    for a, r in zip(arrays, raw):
        out.append(packed[at:at + r.nbytes].view(
            T.np_to_torch_dtype(a.dtype)))
        at += r.nbytes
    return out


_udf_uid = itertools.count()


def plan_has_slow_udf(plan) -> bool:
    """Any row-lane (non-vectorized) PythonUDF anywhere in a logical
    plan's expressions?  Its lane copies to the host in the middle of the
    plan, so such a plan runs on the eager lane, never captured (the
    BatchEvalPythonExec stage-break analog, paid per query)."""
    from .window import WindowExpression

    def expr_has(e: Expression) -> bool:
        if isinstance(e, PythonUDF) and not e.vectorized:
            return True
        if isinstance(e, WindowExpression):
            return any(expr_has(s) for s in e.sub_expressions())
        return any(expr_has(c) for c in e.children)

    def walk(node) -> bool:
        if any(expr_has(e) for e in node.expressions()):
            return True
        return any(walk(c) for c in node.children)
    return walk(plan)


def _check_ret_type(ret_type: T.DataType) -> None:
    if ret_type.is_string or isinstance(ret_type, T.BinaryType):
        raise AnalysisException(
            "UDF string/binary return types are not supported: the "
            "output dictionary cannot be built from the results "
            "(dictionary-encode in a source column or return codes)")


class PythonUDF(Expression):
    def __init__(self, name: str, fn: Callable, ret_type: T.DataType,
                 children: Sequence[Expression], vectorized: bool = False,
                 uid: Optional[int] = None):
        _check_ret_type(ret_type)
        self.fn_name = name
        self.fn = fn
        self.ret_type = ret_type
        self.vectorized = vectorized
        self.children = tuple(children)
        # a never-reused identity: two different lambdas share the repr
        # "<lambda>(...)" and must not share a plan key
        self.uid = next(_udf_uid) if uid is None else uid

    def map_children(self, fn):
        return PythonUDF(self.fn_name, self.fn, self.ret_type,
                         [fn(c) for c in self.children], self.vectorized,
                         self.uid)

    def data_type(self, schema):
        return self.ret_type

    def eval(self, ctx: EvalContext) -> ExprValue:
        args = [ctx.broadcast(c.eval(ctx)) for c in self.children]
        out_tdt = self.ret_type.torch_dtype
        if self.vectorized:
            out = self.fn(*[a.data for a in args])
            valid = None
            for a in args:
                valid = and_valid(valid, a.valid)
            return ExprValue(
                torch.as_tensor(out, device=ctx.device).to(out_tdt), valid)
        capacity = ctx.capacity
        out_dt = self.ret_type.np_dtype
        arg_types = [c.data_type(ctx.batch.schema) for c in self.children]
        dicts = [a.dictionary for a in args]
        ones = torch.ones(capacity, dtype=torch.bool, device=ctx.device)
        live = ctx.batch.row_valid_or_true()
        if live.dim() == 0:
            live = live.expand(capacity)
        host = to_host_once(
            [live] + [a.data for a in args]
            + [a.valid if a.valid is not None else ones for a in args])
        live_h, datas, valids = host[0], host[1:1 + len(args)], \
            host[1 + len(args):]
        out = np.zeros(capacity, out_dt)
        ov = np.zeros(capacity, bool)
        for i in np.nonzero(live_h.astype(bool))[0]:
            row = []
            for d, v, dt, dic in zip(datas, valids, arg_types, dicts):
                row.append(_decode_value(d[i], dt, dic) if v[i] else None)
            r = self.fn(*row)
            if r is not None:
                out[i] = _encode_value(r, self.ret_type)
                ov[i] = True
        data, valid = to_device_once([out, ov], ctx.device)
        return ExprValue(data, valid)

    def __repr__(self):
        inner = ", ".join(repr(c) for c in self.children)
        return f"{self.fn_name}#{self.uid}({inner})"


class UnresolvedFunction(Expression):
    """A function name the parser does not know — resolved against the
    session's UDF registry during analysis (FunctionRegistry lookup)."""

    def __init__(self, name: str, args: Sequence[Expression]):
        self.fn_name = name
        self.children = tuple(args)

    def map_children(self, fn):
        return UnresolvedFunction(self.fn_name,
                                  [fn(c) for c in self.children])

    def data_type(self, schema):
        raise AnalysisException(f"unresolved function: {self.fn_name}")

    def eval(self, ctx):
        raise AnalysisException(f"unresolved function: {self.fn_name}")

    def __repr__(self):
        inner = ", ".join(repr(c) for c in self.children)
        return f"'{self.fn_name}({inner})"


def make_udf(fn: Callable, returnType, vectorized: bool = False,
             name: Optional[str] = None):
    """F.udf / pandas_udf-style factory: returns a callable that builds
    PythonUDF expressions over Columns."""
    from .column import Column, _expr
    rt = T.type_for_name(returnType) if isinstance(returnType, str) \
        else returnType
    _check_ret_type(rt)
    label = name or getattr(fn, "__name__", "udf") or "udf"
    uid = next(_udf_uid)

    def wrapper(*cols) -> Column:
        return Column(PythonUDF(label, fn, rt,
                                [_expr(c) for c in cols], vectorized, uid))

    wrapper.fn = fn
    wrapper.returnType = rt
    wrapper._vectorized = vectorized
    wrapper.uid = uid
    return wrapper


class UDFRegistration:
    """`spark.udf` (UDFRegistration.scala): register Python functions for
    SQL by name; also callable from the DataFrame API via the returned
    wrapper."""

    def __init__(self, session):
        self._session = session

    def register(self, name: str, fn: Callable, returnType="double",
                 vectorized: bool = False):
        wrapper = fn if hasattr(fn, "fn") and hasattr(fn, "returnType") \
            else make_udf(fn, returnType, vectorized, name=name)
        self._session.catalog.register_function(name, wrapper)
        return wrapper
