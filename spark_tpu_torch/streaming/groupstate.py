"""Arbitrary stateful processing: flatMapGroupsWithState.

The reference's ``FlatMapGroupsWithStateExec.scala`` runs a user function
per key group with a persisted ``GroupState`` (get/update/remove plus an
event-time timeout) between micro-batches.  The user function is host
Python by definition, so this operator lives outside the device
pipeline: the engine runs the sub-plan below it on the session's device,
brings the group rows to the host in one packed copy, runs the function,
and re-enters columnar execution with the returned rows.  Its time is
host time, and the engine records it (``StreamExecution.metrics``
``fmgws_host_ms``).

State persistence rides the versioned StateStore (state.py): one
(key → (value, timeout_us)) map per query, committed at the batch's
version, replayable on recovery.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple


from .. import types as T
from ..columnar import ColumnBatch
from ..expressions import AnalysisException

NO_TIMEOUT = "NoTimeout"
EVENT_TIME_TIMEOUT = "EventTimeTimeout"


class GroupState:
    """Mutable per-key state handle passed to the user function
    (``GroupState.scala`` surface, minus processing-time timeouts —
    wall-clock timers don't replay deterministically; event-time ones do)."""

    def __init__(self, value: Any = None, exists: bool = False,
                 timed_out: bool = False, watermark_us: Optional[int] = None,
                 timeout_conf: str = NO_TIMEOUT):
        self._value = value
        self._exists = exists
        self._timed_out = timed_out
        self._watermark_us = watermark_us
        self._timeout_conf = timeout_conf
        self._removed = False
        self._updated = False
        self._timeout_us: Optional[int] = None

    # -- reads ------------------------------------------------------------
    @property
    def exists(self) -> bool:
        return self._exists and not self._removed

    def get(self) -> Any:
        if not self.exists:
            raise ValueError("state does not exist; check state.exists")
        return self._value

    def getOption(self) -> Any:
        return self._value if self.exists else None

    @property
    def hasTimedOut(self) -> bool:
        return self._timed_out

    def getCurrentWatermarkMs(self) -> int:
        return (self._watermark_us or 0) // 1000

    # -- writes -----------------------------------------------------------
    def update(self, value: Any) -> None:
        if value is None:
            raise ValueError("state value cannot be None; use remove()")
        self._value = value
        self._exists = True
        self._removed = False
        self._updated = True

    def remove(self) -> None:
        self._removed = True
        self._updated = True

    def setTimeoutTimestamp(self, timestamp_us: int) -> None:
        """Event-time timeout: once the watermark passes this, the function
        is invoked with hasTimedOut=True and no rows.

        Rejected unless the query enabled EventTimeTimeout — the reference
        throws UnsupportedOperationException here rather than persisting a
        timeout that can never fire (`GroupStateImpl.scala`)."""
        if self._timeout_conf != EVENT_TIME_TIMEOUT:
            raise AnalysisException(
                "setTimeoutTimestamp requires "
                "timeoutConf=GroupStateTimeout.EventTimeTimeout on "
                "flatMapGroupsWithState; this query was started with "
                f"{self._timeout_conf}")
        if self._watermark_us is not None and timestamp_us <= self._watermark_us:
            raise ValueError(
                f"timeout timestamp {timestamp_us} must be later than the "
                f"current watermark {self._watermark_us}")
        self._timeout_us = timestamp_us


def _group_rows(batch: ColumnBatch, key_names: List[str]):
    """Host-side grouping: key tuple → list of Row, in row order."""
    from ..sql.row import Row
    rows = batch.to_pylist()
    names = batch.names
    key_idx = [names.index(k) for k in key_names]
    groups: Dict[tuple, list] = {}
    for r in rows:
        key = tuple(r[i] for i in key_idx)
        groups.setdefault(key, []).append(Row(list(r), names))
    return groups


def run_flat_map_groups(
    func: Callable[[tuple, List[Any], GroupState], Iterable[tuple]],
    key_names: List[str],
    child_batch: ColumnBatch,
    out_schema: T.StructType,
    states: Dict[tuple, Tuple[Any, Optional[int]]],
    watermark_us: Optional[int] = None,
    timeout_conf: str = NO_TIMEOUT,
) -> Tuple[ColumnBatch, Dict[tuple, Tuple[Any, Optional[int]]], set, set]:
    """One batch of FlatMapGroupsWithStateExec.

    ``states`` maps key → (value, timeout_us); returns (output batch, new
    states map, changed keys, removed keys) — the change sets feed the
    state store's delta commit.  Keys present in the batch run with their
    rows; with EventTimeTimeout, absent keys whose timeout fell below the
    watermark run once with hasTimedOut=True and no rows."""
    groups = _group_rows(child_batch, key_names)
    new_states = dict(states)
    out_rows: List[tuple] = []
    changed: set = set()
    removed: set = set()

    def invoke(key, rows, timed_out):
        value, _old_to = states.get(key, (None, None))
        st = GroupState(value=value, exists=key in states,
                        timed_out=timed_out, watermark_us=watermark_us,
                        timeout_conf=timeout_conf)
        result = func(key, rows, st)
        for row in (result or []):
            row = tuple(row)
            if len(row) != len(out_schema.fields):
                raise AnalysisException(
                    f"flatMapGroupsWithState function returned a row of "
                    f"{len(row)} fields; output schema has "
                    f"{len(out_schema.fields)}")
            out_rows.append(row)
        if st._removed:
            if new_states.pop(key, None) is not None or key in states:
                removed.add(key)
                changed.discard(key)
        elif st._updated or st._timeout_us is not None:
            base = new_states.get(key, (None, None))
            value_out = st._value if st._updated or st._exists else base[0]
            to = st._timeout_us if st._timeout_us is not None else base[1]
            new_states[key] = (value_out, to)
            changed.add(key)
            removed.discard(key)

    for key, rows in groups.items():
        invoke(key, rows, timed_out=False)

    if timeout_conf == EVENT_TIME_TIMEOUT and watermark_us is not None:
        for key, (_v, to) in list(states.items()):
            if key in groups:
                continue
            if to is not None and to < watermark_us:
                invoke(key, [], timed_out=True)
                # a timed-out state the function neither updated nor
                # removed keeps its value but stops timing out
                if key in new_states and new_states[key][1] == to:
                    new_states[key] = (new_states[key][0], None)
                    changed.add(key)

    if out_rows:
        names = out_schema.names
        cols = {n: [r[i] for r in out_rows] for i, n in enumerate(names)}
        out = ColumnBatch.from_arrays(cols, schema=out_schema)
    else:
        out = ColumnBatch.empty(out_schema)
    return out, new_states, changed, removed
