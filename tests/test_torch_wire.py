"""The port's wire format (``spark_tpu_torch/wire.py``) against
``spark_tpu/wire.py``: frames written by either package decode in the
other, raw, compressed (every registered codec) and run-coded (``rle``
and ``delta`` tags), with dictionaries inline or by fingerprint; and the
port's own guards (truncation, checksum, run tables)."""

import numpy as np
import pytest
import torch

from spark_tpu import types as RT
from spark_tpu import wire as rwire
from spark_tpu.columnar import ColumnBatch as RBatch
from spark_tpu.columnar import ColumnVector as RVector
from spark_tpu_torch import codec as tcodec
from spark_tpu_torch import wire as twire
from spark_tpu_torch.testing import (assert_parts_equal, batch_parts,
                                     from_parts)


def _ref_batch(seed=0, n=300):
    """A reference host batch: sorted int64 (run and delta fodder), a
    random float64 with NULLs, a string column, a bool column, int32."""
    rng = np.random.default_rng(seed)
    words = ("ash", "elm", "oak", "yew")
    sorted_k = np.sort(rng.integers(0, 6, n)).astype(np.int64)
    x = rng.normal(0.0, 3.0, n)
    xv = rng.random(n) > 0.1
    codes = rng.integers(0, len(words), n).astype(np.int32)
    flags = rng.random(n) > 0.5
    small = (np.arange(n) * 3 + 1000).astype(np.int32)
    rv = np.ones(n, bool)
    rv[-7:] = False
    return RBatch(
        ["k", "x", "s", "f", "i"],
        [RVector(sorted_k, RT.int64),
         RVector(x, RT.float64, xv),
         RVector(codes, RT.string, None, words),
         RVector(flags, RT.boolean),
         RVector(small, RT.int32)], rv, n)


@pytest.mark.parametrize("codec", ["none", "zlib", "lzma", "bz2"])
@pytest.mark.parametrize("run_codes", [False, True])
def test_reference_frame_decodes_in_the_port(codec, run_codes):
    ref = _ref_batch()
    frame = rwire.encode_batches([ref], codec=codec, compress_threshold=0,
                                 run_codes=run_codes)
    got = twire.decode_batches(frame)
    assert len(got) == 1
    assert_parts_equal(batch_parts(ref), batch_parts(got[0]),
                       live_only=False)
    if run_codes:
        tags = {c["enc_tag"] for c in twire.frame_info(frame)
                ["batches"][0]["columns"]}
        assert {"rle", "delta"} <= tags


@pytest.mark.parametrize("codec", ["none", "zlib", "lzma", "bz2"])
@pytest.mark.parametrize("run_codes", [False, True])
def test_port_frame_decodes_in_the_reference(codec, run_codes):
    ref = _ref_batch(seed=1)
    port = from_parts(batch_parts(ref))
    frame = twire.encode_batches([port, port], codec=codec,
                                 compress_threshold=0, run_codes=run_codes)
    back = rwire.decode_batches(frame, keep_runs=False)
    assert len(back) == 2
    for b in back:
        assert_parts_equal(batch_parts(ref), batch_parts(b),
                           live_only=False)
    if run_codes:
        assert frame == rwire.encode_batches(
            [ref, ref], codec=codec, compress_threshold=0,
            run_codes=True)


def test_frames_are_byte_identical():
    """Same batch, same options: the two encoders write the same bytes."""
    ref = _ref_batch(seed=2)
    port = from_parts(batch_parts(ref))
    for kw in ({}, {"codec": "zlib", "compress_threshold": 0},
               {"run_codes": True}):
        assert twire.encode_batches([port], **kw) == \
            rwire.encode_batches([ref], **kw)


def test_dictionary_references_round_trip():
    """Deduplicated dictionaries: a fingerprint in the header, the words
    in a sidecar table; an unknown fingerprint is a typed error."""
    ref = _ref_batch(seed=3)
    port = from_parts(batch_parts(ref))
    refs = {}
    stats = {}
    frame = twire.encode_batches([port, port], dict_refs=refs, stats=stats)
    assert stats["dict_columns_encoded"] == 2
    assert stats["dict_bytes_saved"] > 0
    sidecar = twire.encode_dict_table(refs)
    table = rwire.decode_dict_table(sidecar)
    assert table == twire.decode_dict_table(sidecar)
    for b in rwire.decode_batches(frame, dict_table=table):
        assert_parts_equal(batch_parts(ref), batch_parts(b),
                           live_only=False)
    with pytest.raises(twire.DictFingerprintError):
        twire.decode_batches(frame)
    assert twire.dict_fingerprint(("a", "bc")) == \
        rwire.dict_fingerprint(("a", "bc"))


def test_frames_back_to_back_and_trim():
    ref = _ref_batch(seed=4)
    port = from_parts(batch_parts(ref))
    two = twire.encode_batches([port]) + rwire.encode_batches([ref])
    got = twire.decode_frames(two)
    assert len(got) == 2
    for b in got:
        assert_parts_equal(batch_parts(ref), batch_parts(b),
                           live_only=False)
    trimmed = twire.trim_host(got[0])
    assert trimmed.row_valid is None and trimmed.capacity == 293
    assert_parts_equal(batch_parts(rwire.trim_host(ref)),
                       batch_parts(trimmed), live_only=False)
    assert twire.raw_nbytes([port]) == rwire.raw_nbytes([ref])
    assert twire.payload_nbytes([port]) == rwire.payload_nbytes([ref])


def test_torn_and_corrupt_frames_raise():
    port = from_parts(batch_parts(_ref_batch(seed=5)))
    frame = twire.encode_batches([port])
    with pytest.raises(twire.TruncatedBlockError):
        twire.decode_batches(frame[:10])
    with pytest.raises(twire.TruncatedBlockError):
        twire.decode_batches(frame[:-3])
    bad = bytearray(frame)
    bad[-1] ^= 0xFF
    with pytest.raises(twire.ChecksumError):
        twire.decode_batches(bytes(bad))
    with pytest.raises(twire.WireFormatError):
        twire.decode_batches(b"XXXX" + frame[4:])


def test_run_and_delta_codecs_match_the_reference():
    from spark_tpu import kernels as rk
    rng = np.random.default_rng(6)
    for data in (np.repeat(np.arange(9, dtype=np.int64), 40),
                 np.cumsum(rng.integers(-3, 4, 500)).astype(np.int64),
                 np.zeros(0, np.int32)):
        rv, rl = twire.rle_encode(data)
        ev, el = rk.rle_encode(data)
        assert np.array_equal(rv, ev) and np.array_equal(rl, el)
        assert twire.delta_encode(data) is None and \
            rk.delta_encode(data) is None or \
            all(np.array_equal(a, b) for a, b in zip(
                twire.delta_encode(data), rk.delta_encode(data)))


def test_codecs_match_the_reference():
    from spark_tpu import codec as rcodec
    data = bytes(range(256)) * 40
    for name in ("none", "zlib", "lzma", "bz2"):
        packed = tcodec.compress(data, name)
        assert rcodec.decompress(packed, name) == data
        assert tcodec.decompress(rcodec.compress(data, name), name) == data
    assert set(rcodec.CODECS) == set(tcodec.CODECS)


def test_spilled_runs_round_trip(tmp_path):
    """``SpilledRuns`` spills run batches as wire frames and reads them
    back exactly, run-coded or not."""
    from spark_tpu_torch.sql.multibatch import SpilledRuns
    port = from_parts(batch_parts(_ref_batch(seed=7)))
    for run_codes in (False, True):
        spill = SpilledRuns(100, str(tmp_path), run_codes=run_codes)
        spill.add(port)
        spill.add(port)
        assert spill._disk and not spill._mem
        runs = spill.drain()
        assert len(runs) == 2
        for r in runs:
            assert_parts_equal(batch_parts(port), batch_parts(r),
                               live_only=False)
        spill.close()
    assert isinstance(runs[0].vectors[0].data, torch.Tensor)


@pytest.mark.parametrize("codec", ["none", "lzma"])
def test_spilled_runs_honour_the_wire_conf(tmp_path, codec):
    """A spill file is framed with the codec and threshold of the conf the
    runs were made under, not the defaults."""
    from spark_tpu_torch import config as C
    from spark_tpu_torch.sql.multibatch import SpilledRuns
    port = from_parts(batch_parts(_ref_batch(seed=7)))
    conf = C.Conf()
    conf.set("spark.tpu.shuffle.wire.codec", codec)
    conf.set("spark.tpu.shuffle.wire.compressThreshold", "0")
    spill = SpilledRuns(1, str(tmp_path), conf=conf)
    spill.add(port)
    with open(spill._disk[0], "rb") as f:
        data = f.read()
    assert data == twire.encode_batches([port], codec=codec,
                                        compress_threshold=0)
    other = "bz2"                        # neither of the cases' codecs
    assert data != twire.encode_batches([port], codec=other,
                                        compress_threshold=0)
    assert_parts_equal(batch_parts(port), batch_parts(spill.drain()[0]),
                       live_only=False)
    spill.close()
