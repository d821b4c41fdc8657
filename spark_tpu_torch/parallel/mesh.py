"""The data mesh: n logical shards of row-partitioned data.

``spark_tpu/parallel/mesh.py`` builds a 1-D ``jax.sharding.Mesh`` over
devices.  Here a mesh is n logical shards on ONE torch device: every
shard's batches live on the session's device and every exchange between
shards is one all-to-all kernel launch on it.  Placing shards on several
cards (peer access and a cross-card barrier) is a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

#: name of the one mesh axis (row partitioning, Spark's partition axis)
DATA_AXIS = "data"


class Mesh:
    """n logical shards on one device."""

    __slots__ = ("n_shards", "device")

    def __init__(self, n_shards: int, device):
        if n_shards < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
        self.n_shards = int(n_shards)
        self.device = torch.device(device)

    def __repr__(self):
        return f"Mesh({self.n_shards} x {self.device})"


_current: Optional[Mesh] = None


def get_mesh(n_shards: int, device) -> Mesh:
    """The engine's data mesh of ``n_shards`` shards on ``device``."""
    global _current
    device = torch.device(device)
    if _current is not None and _current.n_shards == n_shards \
            and _current.device == device:
        return _current
    _current = Mesh(n_shards, device)
    return _current


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current
    _current = mesh


def mesh_shards(mesh: Mesh) -> int:
    return mesh.n_shards
