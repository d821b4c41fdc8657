"""Distributed execution: the mesh lane (``spark.tpu.mesh.shards`` > 1).

The port of ``spark_tpu/parallel``'s in-process mesh lane — ``mesh``,
``collective``, ``dist``, ``executor`` and the local face of ``ici`` —
plus ``spmd``, which stands in for ``shard_map`` and the ``lax``
collectives.  Every exchange between shards is one launch of the
all-to-all kernel K2 (``spark_tpu_torch.cuda_a2a``).
"""
