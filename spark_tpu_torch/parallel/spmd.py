"""SPMD execution of one per-shard program over the mesh: the port's
counterpart of ``jax.shard_map`` and the ``lax`` collectives.

``run_shards(n, device, fn)`` runs ``fn(shard, comm)`` once per shard, one
Python thread each, all on one torch device.  ``comm`` is the shards'
shared ``Communicator``; its collectives — ``all_to_all``, ``all_gather``,
``psum``, ``pmin``, ``pmax``, ``once`` — are where the shards meet, as the
``lax`` collectives are where the shards of a ``shard_map`` program meet:

* every shard calls the same collectives in the same order (SPMD);
* ONE shard runs at a time, in turn: shard s runs until its next
  collective, deposits its operand and hands the turn to shard s+1; the
  last shard runs the collective once over all operands, in shard order,
  and hands the turn back to shard 0; each shard then picks up its own
  share.  One ``all_to_all`` is one launch of kernel K2 over every
  shard's planes;
* so the order of every host and device operation is fixed: results
  never depend on thread timing.  Taking turns also keeps the threads
  from contending for the GIL at every eager op;
* a shard that raises aborts the program, so every other shard raises
  ``ShardAborted`` where it waits instead of waiting forever, and
  ``run_shards`` re-raises the first error in shard order that was not
  such an abort.

On the card all shards enqueue onto the caller's stream, so stream order
fences every collective after the ops that produced its operands.  Under
a CUDA graph capture that stream is the capture stream: every shard's
work goes into the one graph, and the caching allocator sends each
shard thread's allocations to the graph's private pool (it routes by the
stream an allocation is made on).  While the caller has a stage run
(``capture.py``: a stage-cache entry recording or replaying), each shard
thread gets a run of its own over its shard's record, and the shards'
guard flags join the caller's run.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Optional, Sequence

import torch

from .. import capture, cuda_a2a
from ..sql import physical as P


class ShardAborted(RuntimeError):
    """Another shard of the same program failed: this shard stops at its
    next collective."""


class Communicator:
    """The collectives of one SPMD program over ``n`` shards, and the
    turn that lets one shard run at a time."""

    def __init__(self, n: int):
        self.n = n
        self._slots: List[Any] = [None] * n
        self._out: List[Any] = []
        self._cv = threading.Condition()
        self._turn = 0
        self._aborted = False

    def _wait_turn(self, shard: int) -> None:
        # the caller holds self._cv
        self._cv.wait_for(lambda: self._turn == shard or self._aborted)
        if self._aborted:
            raise ShardAborted("another shard of this program failed")

    def _pass_turn(self, to: int) -> None:
        self._turn = to
        self._cv.notify_all()

    def enter(self, shard: int) -> None:
        """Block until it is this shard's turn to start."""
        with self._cv:
            self._wait_turn(shard)

    def leave(self, shard: int) -> None:
        """This shard's program ended: hand the turn on."""
        with self._cv:
            self._pass_turn(shard + 1)

    def abort(self) -> None:
        with self._cv:
            self._aborted = True
            self._cv.notify_all()

    def _meet(self, shard: int, value: Any,
              fn: Callable[[List[Any]], List[Any]]) -> Any:
        self._slots[shard] = value
        with self._cv:
            if shard == self.n - 1:
                # every shard has deposited: run the collective once
                self._out = fn(list(self._slots))
                self._pass_turn(0)
            else:
                self._pass_turn(shard + 1)
            self._wait_turn(shard)
            return self._out[shard]

    # -- the collectives -------------------------------------------------
    def all_to_all(self, shard: int, planes: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """``lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)``
        for every plane at once: ``planes[k]`` is this shard's ``(n, cap,
        ...)`` send buffer; returns per plane the ``(n, cap, ...)`` buffer
        whose row s came from shard s.  One K2 launch."""
        def fn(all_planes):
            table = [[all_planes[s][k] for s in range(self.n)]
                     for k in range(len(all_planes[0]))]
            outs = cuda_a2a.all_to_all(table)
            return [[o[d] for o in outs] for d in range(self.n)]
        return self._meet(shard, list(planes), fn)

    def all_gather(self, shard: int, planes: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """``lax.all_gather`` (untiled) of every plane at once: returns per
        plane an ``(n, ...)`` tensor whose row s is shard s's operand.  One
        K2 launch (the gather form)."""
        def fn(all_planes):
            table = [[all_planes[s][k] for s in range(self.n)]
                     for k in range(len(all_planes[0]))]
            outs = cuda_a2a.all_to_all(table, gather=True)
            return [[o[d] for o in outs] for d in range(self.n)]
        return self._meet(shard, [p.contiguous() for p in planes], fn)

    def _reduce(self, shard: int, x: torch.Tensor, op) -> torch.Tensor:
        def fn(xs):
            out = op(torch.stack(xs))
            return [out] * self.n
        return self._meet(shard, x, fn)

    def psum(self, shard: int, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(shard, x, lambda t: t.sum(0, dtype=t.dtype))

    def pmin(self, shard: int, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(shard, x, lambda t: t.amin(0))

    def pmax(self, shard: int, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(shard, x, lambda t: t.amax(0))

    def once(self, shard: int, fn: Callable[..., Any], *args) -> Any:
        """``fn(*args)`` computed once, from shard 0's arguments, and the
        same result handed to every shard — for a pure function of values
        every shard already agrees on (psum'd counts)."""
        return self._meet(shard, args,
                          lambda all_args: [fn(*all_args[0])] * self.n)


class ShardContext(P.ExecContext):
    """The ``ExecContext`` of one shard: its leaves, its index (the
    ``lax.axis_index`` counterpart) and the shared communicator."""

    def __init__(self, device, leaves, shard: int, comm: Communicator):
        super().__init__(device, leaves)
        self.shard = shard
        self.comm = comm
        self.n_shards = comm.n
        #: high bits of row ranks, unique per shard (the first/last ranks
        #: of dist.DPartialAggregate)
        self.shard_offset = shard << 48


def run_shards(n: int, device, fn: Callable[[int, Communicator], Any]
               ) -> List[Any]:
    """Run ``fn(shard, comm)`` for shards 0..n-1 in parallel threads;
    returns the results in shard order or raises the first shard error."""
    device = torch.device(device)
    comm = Communicator(n)
    results: List[Any] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    stream = torch.cuda.current_stream(device) \
        if device.type == "cuda" else None
    parent = capture.active_run()
    guards: List[List[torch.Tensor]] = [[] for _ in range(n)]

    def body(shard: int) -> None:
        try:
            with contextlib.ExitStack() as scope:
                if stream is not None:
                    # a new thread starts on card 0 and the default stream
                    scope.enter_context(torch.cuda.device(device))
                    scope.enter_context(torch.cuda.stream(stream))
                comm.enter(shard)
                with capture.shard_scope(parent, shard, guards):
                    results[shard] = fn(shard, comm)
                comm.leave(shard)
        except BaseException as e:       # noqa: BLE001 — re-raised below
            errors[shard] = e
            comm.abort()

    threads = [threading.Thread(target=body, args=(s,), daemon=True,
                                name=f"shard-{s}") for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    root = [e for e in errors if e is not None
            and not isinstance(e, ShardAborted)]
    if root:
        raise root[0]
    for e in errors:
        if e is not None:
            raise e
    capture.add_shard_guards(parent, guards)
    return results
