"""Host partitioner of the grace join's partition phase.

``spark_tpu/native/partition.py``'s numpy lane: a stable counting sort
of row indices by bucket id."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def partition_permutation(bucket_ids: np.ndarray, n_buckets: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, bounds): ``perm`` orders row indices by bucket (stable);
    bucket b's rows are ``perm[bounds[b]:bounds[b+1]]``."""
    ids = np.ascontiguousarray(np.asarray(bucket_ids, np.int64))
    # a stable sort of ids narrowed to 16 bits is numpy's radix sort
    narrow = ids.astype(np.int16) if n_buckets <= np.iinfo(np.int16).max \
        else ids
    order = np.argsort(narrow, kind="stable").astype(np.int64)
    bounds = np.searchsorted(ids[order],
                             np.arange(n_buckets + 1)).astype(np.int64)
    return order, bounds
