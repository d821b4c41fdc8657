"""Plan fingerprints with literal slotting: the fingerprint half of
``spark_tpu/serving/plancache.py``.

The stage cache (``sql/stagecompile.py``) keys a captured program by a
structural serialization of the physical plan.  Literals in
arithmetic/comparison positions are SLOTTED OUT — replaced by typed
``?i`` markers — so ``WHERE v < 10`` and ``WHERE v < 20`` share one
entry; their values reach the program as the entry's device scalars
(``expressions._slot_bindings``), never baked constants.  A field the
serializer cannot prove stable makes the plan fall back to its unslotted
key rather than be wrongly shared.

The serving tier's ``PlanCache`` itself (plan → executable across
sessions, with its invalidation hooks) comes with the serving slice.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Any, List

from .. import config as C
from .. import expressions as E
from .. import types as T

__all__ = ["PLANNING_CONF_ENTRIES", "PLANNING_CONF_KEYS"]


class _Unfingerprintable(Exception):
    """Plan contains a field the serializer cannot key soundly."""


# Literal parents whose eval() consumes the literal ONLY through
# Literal.eval (vectorized, dtype-stable): safe positions to replace the
# value with a runtime parameter.  Everything else (In/Between bounds,
# string ops, function args that read .value host-side) keeps the value
# in the fingerprint.
_SLOT_PARENTS = (E.Add, E.Sub, E.Mul, E.Div, E.IntDiv, E.Mod,
                 E.EQ, E.NE, E.LT, E.LE, E.GT, E.GE)

# dtypes whose Literal.eval is a plain scalar (no host-side string /
# decimal / datetime conversion): eligible for slotting
_SLOT_DTYPES = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
                T.LongType, T.FloatType, T.DoubleType)

#: conf entries that change what the planner/optimizer would build; their
#: values are part of every stage key.  The reference's list, restricted
#: to the entries this package has.
PLANNING_CONF_ENTRIES = (
    C.CODEGEN_ENABLED, C.MESH_SHARDS, C.AUTO_BROADCAST_JOIN_THRESHOLD,
    C.JOIN_OUTPUT_FACTOR, C.AGG_OUTPUT_ROWS, C.JOIN_OUTPUT_MAX_ROWS,
    C.CASE_SENSITIVE, C.ADAPTIVE_ENABLED, C.METRICS_ENABLED,
    C.EXCHANGE_SKEW_FACTOR,
    # whole-stage fusion toggles the fused-vs-per-op execution shape
    C.STAGE_FUSION,
)

PLANNING_CONF_KEYS = frozenset(e.key for e in PLANNING_CONF_ENTRIES)

# identity of callables in plan fields (UDF bodies): a never-reused
# number per function object, so address recycling cannot alias two
_fn_uids: "weakref.WeakKeyDictionary[Any, int]" = weakref.WeakKeyDictionary()
_fn_counter = itertools.count()


def _fn_uid(fn) -> int:
    try:
        uid = _fn_uids.get(fn)
        if uid is None:
            uid = _fn_uids[fn] = next(_fn_counter)
    except TypeError:               # not weakly referenceable
        raise _Unfingerprintable(f"{type(fn).__name__} callable") from None
    return uid


def _ser_expr(e: E.Expression, slots: List[E.Literal],
              slot_ok: bool) -> str:
    if type(e) is E.Literal:
        if slot_ok and e.value is not None \
                and isinstance(e.dtype, _SLOT_DTYPES):
            slots.append(e)
            return f"?{len(slots) - 1}:{e.dtype.simpleString()}"
        return f"lit[{e.value!r}:{e.dtype.simpleString()}]"
    child_ok = isinstance(e, _SLOT_PARENTS)
    fields = []
    if isinstance(e, (E.Col, E.Alias)):
        # the identity of these nodes lives in a PRIVATE field the vars()
        # walk below skips — without it `sum(a)` and `sum(b)` serialize
        # identically and two different plans share one stage entry
        fields.append(f"name={e.name!r}")
    for name in sorted(vars(e)):
        if name == "children" or name.startswith("_"):
            continue
        fields.append(f"{name}={_ser_val(vars(e)[name], slots)}")
    inner = ",".join(_ser_expr(c, slots, child_ok) for c in e.children)
    return f"{type(e).__name__}[{';'.join(fields)}]({inner})"


def _ser_val(v: Any, slots: List[E.Literal]) -> str:
    if isinstance(v, E.Expression):
        return _ser_expr(v, slots, False)
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return repr(v)
    if isinstance(v, T.DataType):
        return v.simpleString()
    from ..sql.logical import SortOrder
    if isinstance(v, SortOrder):
        return (f"SortOrder[{int(v.ascending)}{int(v.nulls_first)}]"
                f"({_ser_expr(v.child, slots, False)})")
    if isinstance(v, (list, tuple)):
        inner = ",".join(_ser_val(x, slots) for x in v)
        return ("L(" if isinstance(v, list) else "T(") + inner + ")"
    if isinstance(v, dict):
        items = sorted(((repr(k), _ser_val(x, slots))
                        for k, x in v.items()))
        return "{" + ",".join(f"{k}:{x}" for k, x in items) + "}"
    if callable(v) and not isinstance(v, type):
        # identity-keyed: same function object = same behavior; a
        # re-created lambda keys fresh
        return f"fn#{_fn_uid(v)}"
    raise _Unfingerprintable(f"{type(v).__name__} in plan fields")
