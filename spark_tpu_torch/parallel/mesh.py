"""The data mesh: n logical shards of row-partitioned data, placed on cards.

``spark_tpu/parallel/mesh.py`` builds a 1-D ``jax.sharding.Mesh`` over
``devs[:n]``: shard s lives on device s.  Here the same rule places the
shards on the visible cards: with C = min(n, visible cards), taken in
index order from the session's card, shard s lives on card ``s * C //
n``.  So 4 shards on 4 cards are one shard per card, 8 shards on 4 cards
two per card, and on one card every shard shares it.  A CPU session keeps
every shard on the CPU.

``Mesh.device`` is the session's card: shard 0 lives there and the
program's result is read back from it.  ``Mesh.cards`` are the distinct
cards in shard order and ``Mesh.card_of[s]`` the index into it of shard
s's card; every exchange between shards on several cards is K2 reading
its peers' buffers over NVLink behind a device-side barrier
(``cuda_a2a``), and on one card it is one all-to-all launch on it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

#: name of the one mesh axis (row partitioning, Spark's partition axis)
DATA_AXIS = "data"


def shard_cards(n_shards: int, n_cards: int) -> List[int]:
    """Card index of each shard: shard s on card ``s * C // n`` with C =
    min(n, n_cards); shard s on card s when there are enough cards (the
    reference's ``devs[:n]``)."""
    if n_shards < 1 or n_cards < 1:
        raise ValueError(f"a mesh needs a shard and a card, got "
                         f"{n_shards} shard(s) on {n_cards} card(s)")
    c = min(n_shards, n_cards)
    return [s * c // n_shards for s in range(n_shards)]


def visible_cards(device) -> List[torch.device]:
    """The cards a mesh of the session on ``device`` may span: every
    visible card in index order from the session's (wrapping round), each
    named by its index (the shard threads run on other cards, where
    ``cuda`` would name another); ``[device]`` for a CPU session."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    count = torch.cuda.device_count()
    first = device.index if device.index is not None \
        else torch.cuda.current_device()
    return [torch.device("cuda", (first + i) % count) for i in range(count)]


class Mesh:
    """n logical shards placed on ``cards`` (see the module docstring)."""

    __slots__ = ("n_shards", "device", "cards", "card_of", "devices")

    def __init__(self, n_shards: int, device,
                 cards: Optional[Sequence] = None):
        if n_shards < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
        self.n_shards = int(n_shards)
        self.device = torch.device(device)
        pool = [self.device] if cards is None \
            else [torch.device(c) for c in cards]
        self.card_of = shard_cards(self.n_shards, len(pool))
        #: the cards that hold a shard, in shard order (cards[0] is the
        #: session's card; on one card, the session's device as named)
        self.cards = pool[:self.card_of[-1] + 1] if self.card_of[-1] \
            else [self.device]
        # the CPU tests' logical cards all name the CPU; a card is one
        # CUDA device, each with its own barrier state and stream
        named = [c for c in self.cards if c.type == "cuda"]
        if len(set(named)) != len(named):
            raise ValueError(f"a mesh's cards are distinct devices, got "
                             f"{[str(c) for c in self.cards]}")
        #: shard s's device
        self.devices = [self.cards[c] for c in self.card_of]

    @property
    def n_cards(self) -> int:
        return len(self.cards)

    def shards_on(self, card: int) -> range:
        """The shards on card ``card``: a contiguous range."""
        first = self.card_of.index(card)
        return range(first, first + self.card_of.count(card))

    def __repr__(self):
        if self.n_cards == 1:
            return f"Mesh({self.n_shards} x {self.device})"
        return (f"Mesh({self.n_shards} shards on "
                f"{', '.join(str(c) for c in self.cards)})")


_current: Optional[Mesh] = None


def get_mesh(n_shards: int, device) -> Mesh:
    """The engine's data mesh of ``n_shards`` shards of the session on
    ``device``, placed on ``visible_cards(device)``."""
    global _current
    device = torch.device(device)
    cards = visible_cards(device)
    if _current is not None and _current.n_shards == n_shards \
            and _current.device == device \
            and _current.cards == cards[:_current.n_cards] \
            and _current.n_cards == min(n_shards, len(cards)):
        return _current
    _current = Mesh(n_shards, device, cards)
    return _current


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current
    _current = mesh


def mesh_shards(mesh: Mesh) -> int:
    return mesh.n_shards
