"""k-way merge of sorted runs (the external sort's merge step).

``spark_tpu/native/merge.py``'s numpy lane: spilled sorted runs merge on
the host by an int64 sort key.  The port also takes a key of several
int64 columns per row, compared lexicographically (an ORDER BY of
several keys, ``multibatch._SortMerger._merge``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def merge_sorted_runs(run_keys: Sequence[np.ndarray]) -> np.ndarray:
    """Global ascending-order permutation over concatenated runs.

    Each entry of ``run_keys`` — a 1-D int64 key per row, or a 2-D
    ``(rows, keys)`` array compared column by column — must already be
    sorted ascending; the result indexes into their concatenation, ties
    broken by run order (a stable sort over positions that are already
    grouped by run)."""
    runs = [np.ascontiguousarray(np.asarray(r, np.int64)) for r in run_keys]
    if not runs:
        return np.zeros(0, np.int64)
    keys = np.concatenate(runs)
    if keys.ndim == 1:
        return np.argsort(keys, kind="stable").astype(np.int64)
    # np.lexsort is stable and sorts by its LAST key first
    return np.lexsort(keys.T[::-1]).astype(np.int64)
