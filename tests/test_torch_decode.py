"""The port's row decode by column (``columnar.decode_column``, one host
copy per batch) against ``spark_tpu``'s per-element ``to_pylist``: the
same values AND the same Python types for every supported dtype, with
NULLs, a ``row_valid`` mask, dates before 1970, NaN and -0.0, string
codes outside the dictionary, and decimals of several scales (bit-equal
floats: the reference's two roundings).  Also the packed read-back's
shapes (``ColumnBatch.packed_host``) on CPU batches.
"""

import math

import numpy as np
import pytest

from spark_tpu import types as RT
from spark_tpu.columnar import ColumnBatch as RBatch
from spark_tpu.columnar import ColumnVector as RVector
from spark_tpu_torch.columnar import ColumnBatch as TBatch
from spark_tpu_torch.columnar import decode_column
from spark_tpu_torch.testing import batch_parts, from_parts

CAP = 64


def _column(kind, rng):
    """(type name, data, dictionary) of one column of CAP rows."""
    if kind == "boolean":
        return rng.random(CAP) < 0.5, None
    if kind in ("tinyint", "smallint", "int", "bigint"):
        dt = {"tinyint": np.int8, "smallint": np.int16, "int": np.int32,
              "bigint": np.int64}[kind]
        info = np.iinfo(dt)
        d = rng.integers(info.min, info.max, CAP, dtype=dt, endpoint=True)
        d[:2] = (info.min, info.max)
        return d, None
    if kind in ("float", "double"):
        d = rng.normal(0, 1e3, CAP).astype(
            np.float32 if kind == "float" else np.float64)
        d[:5] = (np.nan, -0.0, 0.0, np.inf, -np.inf)
        return d, None
    if kind.startswith("decimal"):
        return rng.integers(-10 ** 12, 10 ** 12, CAP).astype(np.int64), None
    if kind == "date":
        # days around the epoch: before 1970, the epoch, and year 9999
        d = rng.integers(-30000, 30000, CAP).astype(np.int32)
        d[:3] = (-1, 0, 2932896)
        return d, None
    if kind == "timestamp":
        d = rng.integers(-2 * 10 ** 15, 2 * 10 ** 15, CAP).astype(np.int64)
        d[:2] = (-1, 0)
        return d, None
    if kind in ("string", "binary"):
        words = ("", "apple", "kiwi", "zürich") if kind == "string" \
            else (b"", b"\x00a", b"zz")
        # codes past the dictionary and below zero decode to None
        d = rng.integers(-1, len(words) + 2, CAP).astype(np.int32)
        return d, words
    raise ValueError(kind)


KINDS = ["boolean", "tinyint", "smallint", "int", "bigint", "float",
         "double", "decimal(12,2)", "decimal(18,0)", "decimal(9,6)",
         "date", "timestamp", "string", "binary"]


def _pair(kind, seed, nulls, row_mask):
    rng = np.random.default_rng(seed)
    data, words = _column(kind, rng)
    valid = (rng.random(CAP) > 0.3) if nulls else None
    rv = (rng.random(CAP) > 0.2) if row_mask else None
    ref = RBatch(["c"], [RVector(data, RT.type_for_name(kind), valid, words)],
                 rv, CAP)
    return ref, from_parts(batch_parts(ref))


def _same(a, b):
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or \
            (a == b and math.copysign(1, a) == math.copysign(1, b))
    return a == b


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nulls,row_mask", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_decode_equals_reference(kind, nulls, row_mask):
    ref, got = _pair(kind, KINDS.index(kind), nulls, row_mask)
    want = ref.to_pylist()
    have = got.to_pylist()
    assert len(have) == len(want) > 0
    for i, (w, h) in enumerate(zip(want, have)):
        assert len(w) == len(h) == 1
        assert _same(w[0], h[0]), (kind, i, w[0], h[0])


def test_decode_several_columns_and_no_columns():
    """A batch of several columns decodes row by row as the reference's;
    a batch without columns gives one empty tuple per live row."""
    rng = np.random.default_rng(7)
    vecs, names = [], []
    for k in KINDS:
        data, words = _column(k, rng)
        vecs.append(RVector(data, RT.type_for_name(k),
                            rng.random(CAP) > 0.25, words))
        names.append(k)
    rv = rng.random(CAP) > 0.1
    ref = RBatch(names, vecs, rv, CAP)
    got = from_parts(batch_parts(ref))
    want, have = ref.to_pylist(), got.to_pylist()
    assert len(want) == len(have) == int(rv.sum())
    for w, h in zip(want, have):
        assert all(_same(a, b) for a, b in zip(w, h)), (w, h)
    empty = TBatch([], [], got.row_valid, CAP)
    assert empty.to_pylist() == [()] * int(rv.sum())


def test_decode_column_without_dictionary():
    """A string column without a dictionary decodes to None, as the
    reference's lookup does."""
    out = decode_column(np.array([0, 1, -1], np.int32), None, None,
                        RT.string, None)
    assert out == [None, None, None]


def test_packed_host_prefix_on_cpu():
    """``packed_host(rows)`` keeps the first rows of every column, mask
    and ``row_valid`` (on the CPU the same tensors, sliced)."""
    ref, got = _pair("bigint", 3, True, True)
    head = got.packed_host(16)
    assert head.capacity == 16
    assert np.array_equal(head.vectors[0].data.numpy(),
                          got.vectors[0].data.numpy()[:16])
    assert np.array_equal(head.vectors[0].valid.numpy(),
                          got.vectors[0].valid.numpy()[:16])
    assert np.array_equal(head.row_valid.numpy(),
                          got.row_valid.numpy()[:16])
