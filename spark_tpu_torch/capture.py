"""Host decisions and host-built constants of one stage run, recorded once
and served again: what makes the single-device path safe to capture as a
CUDA graph (``sql/stagecompile.py``).

A captured graph replays device work only.  Nothing that runs while it
is being captured may wait for the device or copy from pageable host
memory, and whatever the host decided during the capture is frozen into
it.  Two hooks carry every such site of the plan:

* ``decide(pred)`` — a data-dependent host decision.  Outside a stage run
  it syncs and returns ``bool(pred)`` (the eager lane).  In a RECORD run
  it does the same and records the answer.  In a REPLAY run (a capture,
  or an eager re-run on the CPU) it returns the recorded answer and
  appends ``pred == answer`` to the run's guard flags; the stage cache
  reads them back with the result's own flags and throws the result away
  when one is false.  This is the counterpart of the reference's runtime
  ``lax.cond``, which evaluates both branches' condition on the device.
* ``constant(value, device, dtype)`` — a tensor built from host values (a
  scalar, a dictionary remap table).  Outside a run it is built; in a
  record run it is built and kept; in a replay run the kept tensor is
  served, so a capture holds its address and copies nothing.

Replay serves decisions and constants by position: the stage entry keys
each record by everything the sequence depends on (the plan, the leaf
shapes and dictionaries, the recorded decisions), so a replay that asks
for something else than the record holds is a fault and raises.

A mesh entry's run spans threads: ``spmd.run_shards`` runs each shard in
a thread of its own.  ``shard_scope(parent, shard)`` gives shard
``shard``'s thread a run of its own over the parent record's
``shard(shard)`` record, in the parent's mode; the shards take turns in
a fixed order, so each shard record is deterministic.  At the end of the
shard's program its record must be used whole, and its guard flags go
to the parent run (``add_shard_guards``, in shard order).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, List, Optional

import numpy as np
import torch


class StageDivergence(RuntimeError):
    """A replay asked for another decision or constant than its record
    holds."""


class StageRecord:
    """What one record run decided and built, in order; on the mesh lane
    also each shard's own record (``shard``)."""

    __slots__ = ("decisions", "constants", "shards")

    def __init__(self):
        self.decisions: List[bool] = []
        self.constants: List[torch.Tensor] = []
        self.shards: List["StageRecord"] = []

    def shard(self, index: int) -> "StageRecord":
        """Shard ``index``'s record (made on first use, by a record run:
        the threads ask in turn, so the list grows in shard order)."""
        while len(self.shards) <= index:
            self.shards.append(StageRecord())
        return self.shards[index]


class StageRun:
    """One run of a stage over a record: recording it, or replaying it."""

    def __init__(self, record: StageRecord, replay: bool):
        self.record = record
        self.replay = replay
        #: device bool scalars, one per replayed decision: ``pred == answer``
        self.guards: List[torch.Tensor] = []
        self._decision = 0
        self._constant = 0

    def decide(self, pred: torch.Tensor) -> bool:
        if not self.replay:
            answer = bool(pred)
            self.record.decisions.append(answer)
            return answer
        if self._decision >= len(self.record.decisions):
            raise StageDivergence(
                f"replay asked for decision {self._decision}, the record "
                f"holds {len(self.record.decisions)}")
        answer = self.record.decisions[self._decision]
        self._decision += 1
        self.guards.append(pred == answer)
        return answer

    def constant(self, value: Any, device, dtype: Optional[torch.dtype]
                 ) -> torch.Tensor:
        if not self.replay:
            t = torch.as_tensor(value, dtype=dtype, device=device)
            self.record.constants.append(t)
            return t
        if self._constant >= len(self.record.constants):
            raise StageDivergence(
                f"replay asked for constant {self._constant}, the record "
                f"holds {len(self.record.constants)}")
        t = self.record.constants[self._constant]
        if tuple(t.shape) != np.shape(value) \
                or (dtype is not None and t.dtype != dtype):
            raise StageDivergence(
                f"constant {self._constant}: recorded {t.dtype}"
                f"{tuple(t.shape)}, asked for {dtype}{np.shape(value)}")
        self._constant += 1
        return t

    def check_consumed(self) -> None:
        """A replay must use the whole record, as the record run did."""
        if self.replay and (self._decision, self._constant) != (
                len(self.record.decisions), len(self.record.constants)):
            raise StageDivergence(
                f"replay used {self._decision} decisions and "
                f"{self._constant} constants of a record holding "
                f"{len(self.record.decisions)} and "
                f"{len(self.record.constants)}")


class _Active(threading.local):
    run: Optional[StageRun] = None


_active = _Active()


def active_run() -> Optional[StageRun]:
    """This thread's active stage run, or None."""
    return _active.run


@contextlib.contextmanager
def shard_scope(parent: Optional[StageRun], shard: int,
                guards: List[List[torch.Tensor]]) -> Iterator[None]:
    """Inside a shard thread of a run over ``parent`` (None: no stage run,
    the eager lane): this shard's run over ``parent.record.shard(shard)``,
    in the parent's mode.  When the shard's program ends its record must
    be used whole; its guard flags are put in ``guards[shard]``.  A replay
    of a record that holds no such shard diverges."""
    if parent is None:
        yield
        return
    if parent.replay and shard >= len(parent.record.shards):
        raise StageDivergence(
            f"replay asked for shard {shard}, the record holds "
            f"{len(parent.record.shards)}")
    with stage_run(parent.record.shard(shard), parent.replay) as run:
        yield
        run.check_consumed()
    guards[shard] = run.guards


def add_shard_guards(parent: Optional[StageRun],
                     guards: List[List[torch.Tensor]]) -> None:
    """Every shard's guard flags, in shard order, onto the parent run's."""
    if parent is not None:
        for g in guards:
            parent.guards.extend(g)


@contextlib.contextmanager
def stage_run(record: StageRecord, replay: bool) -> Iterator[StageRun]:
    """Make a run over ``record`` this thread's active one."""
    prev = _active.run
    run = StageRun(record, replay)
    _active.run = run
    try:
        yield run
    finally:
        _active.run = prev


def decide(pred: torch.Tensor) -> bool:
    """A data-dependent host decision (see the module docstring)."""
    run = _active.run
    if run is None:
        return bool(pred)
    return run.decide(pred)


def constant(value: Any, device, dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
    """``torch.as_tensor(value, dtype, device)`` for host-built values, kept
    by the active stage run (see the module docstring)."""
    run = _active.run
    if run is None:
        return torch.as_tensor(value, dtype=dtype, device=device)
    return run.constant(value, device, dtype)
