"""The port's C++ sketch library (``spark_tpu_torch/native/``: Murmur3,
``BloomFilter``, ``CountMinSketch``) against ``spark_tpu``'s numpy lane
on the same seeded items: hashes, the Bloom filter's bits and the
count-min table bit for bit, merges alike, no false negatives.  The
library is built with g++ at first use, and a failed build raises.
"""

import os

import numpy as np
import pytest

from spark_tpu.native import sketch as RS
from spark_tpu_torch import native as TN
from spark_tpu_torch.native import build as TB
from spark_tpu_torch.native import sketch as TS


@pytest.fixture
def numpy_lane(monkeypatch):
    """The reference's sketches on their numpy lane."""
    monkeypatch.setattr(RS, "load_library", lambda: None)


@pytest.fixture(scope="module")
def items():
    rng = np.random.default_rng(8)
    edge = np.array([0, 1, -1, 2**63 - 1, -2**63, 2**31, -2**31 - 1],
                    np.int64)
    return np.concatenate([edge, rng.integers(-2**62, 2**62, 20000),
                           rng.integers(0, 500, 5000)]).astype(np.int64)


def test_library_is_built_from_the_repo_source():
    lib = TB.load_library()
    assert os.path.exists(TB.library_path(TB.SOURCE))
    assert TB.library_path(TB.SOURCE).startswith(TB.BUILD_DIR)
    assert lib is TB.load_library()
    assert TN.BloomFilter is TS.BloomFilter


def test_murmur3_matches_reference(items):
    for seed in (0, 42, -7):
        want = RS.murmur3_hash_long(items, seed)
        assert np.array_equal(TS.murmur3_hash_long(items, seed), want)
        assert np.array_equal(TS.murmur3_hash_long_plain(items, seed), want)
    seeds = RS.murmur3_hash_long(items, 0)          # per-item seeds
    want = RS.murmur3_hash_long(items, seeds)
    assert np.array_equal(TS.murmur3_hash_long(items, seeds), want)


def test_bloom_filter_matches_reference(items, numpy_lane):
    ref = RS.BloomFilter.create(10000, 0.03)
    got = TS.BloomFilter.create(10000, 0.03)
    assert (got.num_bits, got.num_hashes) == (ref.num_bits, ref.num_hashes)
    ref.put_long(items[:10000])
    got.put_long(items[:10000])
    assert np.array_equal(got.bits, ref.bits)
    plain = TS.BloomFilter.create(10000, 0.03)
    TS.bloom_put_plain(plain, items[:10000])
    assert np.array_equal(plain.bits, got.bits)
    hits = got.might_contain_long(items)
    assert hits[:10000].all()                       # no false negatives
    assert np.array_equal(hits, ref.might_contain_long(items))
    assert np.array_equal(hits, TS.bloom_might_contain_plain(got, items))
    # merge: the union of two halves' filters is the whole's
    a, b = TS.BloomFilter.create(10000), TS.BloomFilter.create(10000)
    ra, rb = RS.BloomFilter.create(10000), RS.BloomFilter.create(10000)
    for f, part in ((a, items[:5000]), (b, items[5000:10000]),
                    (ra, items[:5000]), (rb, items[5000:10000])):
        f.put_long(part)
    assert np.array_equal(a.merge(b).bits, got.bits)
    assert np.array_equal(ra.merge(rb).bits, a.bits)
    with pytest.raises(ValueError):
        a.merge(TS.BloomFilter.create(10))


def test_count_min_sketch_matches_reference(items, numpy_lane):
    ref, got = RS.CountMinSketch.create(0.01, 0.99), \
        TS.CountMinSketch.create(0.01, 0.99)
    assert (got.depth, got.width) == (ref.depth, ref.width)
    ref.add_long(items, 3)
    got.add_long(items, 3)
    assert np.array_equal(got.table, ref.table) and got.total == ref.total
    plain = TS.CountMinSketch.create(0.01, 0.99)
    TS.cms_add_plain(plain, items, 3)
    assert np.array_equal(plain.table, got.table)
    est = got.estimate_count(items)
    assert np.array_equal(est, ref.estimate_count(items))
    assert np.array_equal(est, TS.cms_estimate_plain(got, items))
    true = 3 * np.unique(items, return_counts=True)[1].min()
    assert (est >= true).all()                      # never under-counts
    a, b = TS.CountMinSketch.create(0.01), TS.CountMinSketch.create(0.01)
    ra, rb = RS.CountMinSketch.create(0.01), RS.CountMinSketch.create(0.01)
    for s, part in ((a, items[:9000]), (b, items[9000:]),
                    (ra, items[:9000]), (rb, items[9000:])):
        s.add_long(part, 3)
    assert np.array_equal(a.merge(b).table, got.table)
    assert np.array_equal(ra.merge(rb).table, a.table)
    assert a.total == ra.total == got.total


def test_failed_build_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp"):
        TB.load_library(str(bad), str(tmp_path / "build"))
    assert not os.listdir(tmp_path / "build")
