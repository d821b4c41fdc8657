"""SPMD execution of one per-shard program over the mesh: the port's
counterpart of ``jax.shard_map`` and the ``lax`` collectives.

``run_shards(n, device, fn, mesh)`` runs ``fn(shard, comm)`` once per
shard, one Python thread each, each on its shard's card (``mesh``; without
one every shard is on ``device``).  ``comm`` is the shards' shared
``Communicator``; its collectives — ``all_to_all``, ``all_gather``,
``psum``, ``pmin``, ``pmax``, ``once``, ``gather_root`` — are where the
shards meet, as the ``lax`` collectives are where the shards of a
``shard_map`` program meet:

* every shard calls the same collectives in the same order (SPMD);
* ONE shard runs at a time, in turn: shard s runs until its next
  collective, deposits its operand and hands the turn to shard s+1; the
  last shard runs the collective once over all operands, in shard order,
  and hands the turn back to shard 0; each shard then picks up its own
  share.  One ``all_to_all`` is one launch of kernel K2 over every
  shard's planes on one card, and one launch on each receiving card,
  between two barriers on every card, on several;
* so the order of every host and device operation is fixed: results
  never depend on thread timing.  Taking turns also keeps the threads
  from contending for the GIL at every eager op;
* a shard that raises aborts the program, so every other shard raises
  ``ShardAborted`` where it waits instead of waiting forever, and
  ``run_shards`` re-raises the first error in shard order that was not
  such an abort.

On one card all shards enqueue onto the caller's stream, so stream order
fences every collective after the ops that produced its operands.  On
several cards each shard enqueues onto its card's stream (the caller's
current stream of that card, or the stream ``card_streams`` names), and
a collective's cross-card order is K2's device-side barrier.  The rule
that keeps those barriers from deadlocking: each collective is launched
WHOLE by the last shard in ``_meet`` — its barriers, copies and
reductions on every card — before any shard thread takes the turn again.
So every card's barrier of one collective is enqueued before any thread
can wait for a card (a host read of a recorded decision in a warm-up, a
read-back), and a card's barrier never waits for work that sits behind a
host wait.  A shard that raises before a collective aborts the program
before the last shard launches it, so no card is left spinning.

The reductions run on every card over the operands K2's gather form
brings it, and ``once`` computes its pure function on every card from
the first shard there: every shard gets its result on its own card, and
nothing crosses to the host, so both stay capturable.

Under a CUDA graph capture each card's stream is its capture stream:
every shard's work on a card goes into that card's graph, and the
caching allocator sends each shard thread's allocations to that graph's
private pool (it routes by the stream an allocation is made on).  While
the caller has a stage run (``capture.py``: a stage-cache entry recording
or replaying), each shard thread gets a run of its own over its shard's
record, and the shards' guard flags join the caller's run — on several
cards through one last collective that brings each shard's verdict to
shard 0's card.
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
    turn that lets one shard run at a time.  ``card_of`` / ``devices`` /
    ``streams`` place the shards on several cards (see the module
    docstring); without them every shard shares one."""

    def __init__(self, n: int, card_of: Optional[Sequence[int]] = None,
                 devices: Optional[Sequence[torch.device]] = None,
                 streams: Optional[Sequence[Any]] = None):
        self.n = n
        self.card_of = list(card_of) if card_of is not None else [0] * n
        self.devices = list(devices) if devices is not None else None
        self.streams = list(streams) if streams is not None else None
        #: the shards span several cards
        self.multi = self.devices is not None and len(self.devices) > 1
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

    # -- the cards ------------------------------------------------------
    def on_card(self, card: int):
        """Make card ``card`` and its stream current (a CPU card: no-op)."""
        if self.devices is None or self.devices[card].type != "cuda":
            return contextlib.nullcontext()
        scope = contextlib.ExitStack()
        scope.enter_context(torch.cuda.device(self.devices[card]))
        scope.enter_context(torch.cuda.stream(self.streams[card]))
        return scope

    def _exchange(self, all_planes, gather: bool,
                  receivers: Optional[range] = None):
        """K2 over every shard's planes; per receiving shard d its blocks
        ``[o[d] for o in outs]`` (None for a shard outside ``receivers``)."""
        table = [[all_planes[s][k] for s in range(self.n)]
                 for k in range(len(all_planes[0]))]
        if not self.multi:
            outs = cuda_a2a.all_to_all(table, gather=gather)
            return [[o[d] for o in outs] for d in range(self.n)]
        per_card = cuda_a2a.all_to_all_cards(
            table, self.card_of, self.devices, self.streams, gather=gather,
            receivers=receivers)
        got = []
        for d, c in enumerate(self.card_of):
            outs = per_card[c]
            if outs is None or (receivers is not None
                                and d not in receivers):
                got.append(None)
                continue
            d0, _n = cuda_a2a.card_receivers(self.card_of, c, receivers)
            got.append([o[d - d0] for o in outs])
        return got

    # -- the collectives -------------------------------------------------
    def all_to_all(self, shard: int, planes: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """``lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)``
        for every plane at once: ``planes[k]`` is this shard's ``(n, cap,
        ...)`` send buffer; returns per plane the ``(n, cap, ...)`` buffer
        whose row s came from shard s.  One K2 launch (per receiving
        card)."""
        return self._meet(shard, list(planes),
                          lambda all_planes: self._exchange(all_planes,
                                                            False))

    def all_gather(self, shard: int, planes: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """``lax.all_gather`` (untiled) of every plane at once: returns per
        plane an ``(n, ...)`` tensor whose row s is shard s's operand.  One
        K2 launch (the gather form; per receiving card)."""
        return self._meet(shard, [p.contiguous() for p in planes],
                          lambda all_planes: self._exchange(all_planes,
                                                            True))

    def gather_root(self, shard: int, planes: Sequence[torch.Tensor]
                    ) -> Optional[List[torch.Tensor]]:
        """Every shard's planes to shard 0 alone: shard 0 gets per plane an
        ``(n, ...)`` tensor on its card whose row s is shard s's operand,
        every other shard None.  K2's gather form with one receiver; on
        several cards only shard 0's card copies, between the barriers of
        every card."""
        return self._meet(shard, [p.contiguous() for p in planes],
                          lambda all_planes: self._exchange(
                              all_planes, True, range(1)))

    def _reduce(self, shard: int, x: torch.Tensor, op) -> torch.Tensor:
        if not self.multi:
            def fn(xs):
                out = op(torch.stack(xs))
                return [out] * self.n
            return self._meet(shard, x, fn)

        def fn_cards(xs):
            got = self._exchange([[x] for x in xs], True)
            outs = {}
            for c in range(len(self.devices)):
                first = self.card_of.index(c)
                with self.on_card(c):
                    outs[c] = op(got[first][0])
            return [outs[c] for c in self.card_of]
        return self._meet(shard, x.contiguous(), fn_cards)

    def psum(self, shard: int, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(shard, x, lambda t: t.sum(0, dtype=t.dtype))

    def pmin(self, shard: int, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(shard, x, lambda t: t.amin(0))

    def pmax(self, shard: int, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(shard, x, lambda t: t.amax(0))

    def once(self, shard: int, fn: Callable[..., Any], *args) -> Any:
        """``fn(*args)`` computed once, from shard 0's arguments, and the
        same result handed to every shard — for a pure function of values
        every shard already agrees on (psum'd counts).  On several cards it
        is computed once on each card, from the first shard there."""
        if not self.multi:
            return self._meet(shard, args,
                              lambda all_args: [fn(*all_args[0])] * self.n)

        def per_card(all_args):
            outs = {}
            for c in range(len(self.devices)):
                with self.on_card(c):
                    outs[c] = fn(*all_args[self.card_of.index(c)])
            return [outs[c] for c in self.card_of]
        return self._meet(shard, args, per_card)


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


class _CardStreams(threading.local):
    streams: Optional[List[Any]] = None


_card_streams = _CardStreams()


@contextlib.contextmanager
def card_streams(streams: Optional[Sequence[Any]]):
    """Inside: a mesh program on several cards run by this thread enqueues
    card c's work on ``streams[c]`` (a stage entry's capture or replay
    streams)."""
    prev = _card_streams.streams
    _card_streams.streams = None if streams is None else list(streams)
    try:
        yield
    finally:
        _card_streams.streams = prev


def run_shards(n: int, device, fn: Callable[[int, Communicator], Any],
               mesh=None) -> List[Any]:
    """Run ``fn(shard, comm)`` for shards 0..n-1 in parallel threads;
    returns the results in shard order or raises the first shard error.
    With ``mesh`` each shard runs on its card (``mesh.devices``)."""
    device = torch.device(device)
    multi = mesh is not None and mesh.n_cards > 1
    streams = None
    if multi:
        cards = list(mesh.cards)
        cuda = cards[0].type == "cuda"
        if cuda:
            streams = _card_streams.streams
            if streams is None:
                streams = [torch.cuda.current_stream(c) for c in cards]
        comm = Communicator(n, mesh.card_of, cards, streams)
        shard_devices = list(mesh.devices)
        shard_streams = [streams[c] for c in mesh.card_of] if cuda \
            else [None] * n
    else:
        comm = Communicator(n)
        shard_devices = [device] * n
        shard_streams = [torch.cuda.current_stream(device)
                         if device.type == "cuda" else None] * n
    results: List[Any] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    parent = capture.active_run()
    guards: List[List[torch.Tensor]] = [[] for _ in range(n)]

    def body(shard: int) -> None:
        try:
            with contextlib.ExitStack() as scope:
                if shard_streams[shard] is not None:
                    # a new thread starts on card 0 and the default stream
                    scope.enter_context(torch.cuda.device(
                        shard_devices[shard]))
                    scope.enter_context(torch.cuda.stream(
                        shard_streams[shard]))
                comm.enter(shard)
                with capture.shard_scope(parent, shard, guards):
                    results[shard] = fn(shard, comm)
                if multi and parent is not None:
                    # every shard's guards, as one verdict, to shard 0's
                    # card, where the caller reads its result back
                    g = guards[shard]
                    ok = torch.stack([x.reshape(()) for x in g]).all() \
                        if g else torch.ones((), dtype=torch.bool,
                                             device=shard_devices[shard])
                    got = comm.gather_root(shard, [ok])
                    guards[shard] = [got[0].all()] if got is not None \
                        else []
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
