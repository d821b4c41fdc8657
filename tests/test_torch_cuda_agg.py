"""The port's grouped accumulate (kernel K1) against the Pallas kernel.

``spark_tpu_torch.cuda_agg.grouped_accumulate`` on CPU tensors runs its
plain PyTorch version; the reference is ``spark_tpu.pallas_agg`` in
interpret mode (the same program as on the TPU, no Mosaic).  Exact.
The CUDA kernel itself is held against the same plain version on the
card by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spark_tpu import pallas_agg
from spark_tpu_torch import cuda_agg


def _both(bucket, planes, n_active, B):
    ref = np.asarray(pallas_agg.grouped_accumulate(
        jnp.asarray(bucket), jnp.asarray(planes.astype(np.float32)),
        jnp.int32(n_active), B, interpret=True))
    launches = cuda_agg.LAUNCHES
    got = cuda_agg.grouped_accumulate(
        torch.from_numpy(bucket), torch.from_numpy(planes.astype(np.uint8)),
        torch.tensor([n_active], dtype=torch.int32), B)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert cuda_agg.LAUNCHES == launches
    assert got.dtype == torch.int64 and tuple(got.shape) == (B, planes.shape[1])
    return ref, got.numpy()


def _oracle(bucket, planes, B):
    out = np.zeros((B, planes.shape[1]), np.int64)
    np.add.at(out, bucket, planes.astype(np.int64))
    return out


@pytest.mark.parametrize("n,B,P", [(1000, 512, 3), (4096, 4096, 11),
                                   (70, 100, 1), (2048, 1024, 24),
                                   (3000, 1000, 4)])
def test_matches_pallas_kernel(n, B, P):
    rng = np.random.default_rng(n + B + P)
    bucket = rng.integers(0, min(B, 200), n).astype(np.int32)
    planes = rng.integers(0, 256, (n, P)).astype(np.uint8)
    n_active = -(-B // cuda_agg.CHUNK)
    ref, got = _both(bucket, planes, n_active, B)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _oracle(bucket, planes, B))


def test_dead_chunk_rows_do_not_count():
    """Rows whose bucket lies in a chunk at or past n_active never count —
    the padding rows parked at B-1 with zero planes, and rows with
    nonzero planes there too."""
    rng = np.random.default_rng(0)
    n, B = 3000, 4096
    bucket = rng.integers(0, 300, n).astype(np.int32)
    planes = rng.integers(0, 256, (n, 5)).astype(np.uint8)
    bucket[-10:] = B - 1
    planes[-10:] = 0
    bucket[:7] = 2000                  # chunk 3, nonzero planes
    n_active = -(-300 // cuda_agg.CHUNK)
    ref, got = _both(bucket, planes, n_active, B)
    assert np.array_equal(got, ref)
    live = bucket < n_active * cuda_agg.CHUNK
    assert np.array_equal(got, _oracle(bucket[live], planes[live], B))
    assert np.all(got[n_active * cuda_agg.CHUNK:] == 0)


def test_b_not_a_multiple_of_the_chunk_width():
    rng = np.random.default_rng(5)
    n, B = 2500, 700                   # the last chunk is 188 buckets wide
    bucket = rng.integers(0, B, n).astype(np.int32)
    planes = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    ref, got = _both(bucket, planes, 2, B)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _oracle(bucket, planes, B))


def test_multi_chunk_rows_path(monkeypatch):
    """The reference accumulates row chunks above _MAX_CHUNK_ROWS across
    kernel calls in int64; the port takes every row in one call."""
    monkeypatch.setattr(pallas_agg, "_MAX_CHUNK_ROWS", 1 << 11)
    rng = np.random.default_rng(1)
    n, B = 5000, 512
    bucket = rng.integers(0, B, n).astype(np.int32)
    planes = rng.integers(0, 256, (n, 2)).astype(np.uint8)
    ref, got = _both(bucket, planes, B // 512, B)
    assert np.array_equal(got, ref)


def test_empty_input():
    out = cuda_agg.grouped_accumulate(
        torch.zeros(0, dtype=torch.int32), torch.zeros((0, 3), dtype=torch.uint8),
        torch.tensor([1], dtype=torch.int32), 10)
    assert tuple(out.shape) == (10, 3) and int(out.abs().sum()) == 0


@pytest.mark.parametrize("prod,B", [(1.0, 4096), (300.0, 4096),
                                    (1024.0, 4096), (1025.0, 4096),
                                    (5000.0, 100), (0.0, 8)])
def test_n_active_chunks_matches_reference(prod, B):
    ref = int(np.asarray(pallas_agg.n_active_chunks(jnp, jnp.float64(prod), B)))
    got = cuda_agg.n_active_chunks(torch.tensor(prod, dtype=torch.float64), B)
    assert got.dtype == torch.int32 and int(got) == ref


@pytest.mark.parametrize("bad", ["bucket_dtype", "planes_dtype", "rows",
                                 "n_active", "B", "device"])
def test_wrapper_validates_inputs(bad):
    """Device, type and shape checks run before either version, so a call
    the kernel would refuse fails the same way on the host."""
    b = torch.zeros(4, dtype=torch.int32)
    p = torch.zeros((4, 2), dtype=torch.uint8)
    na = torch.ones(1, dtype=torch.int32)
    B = 4
    if bad == "bucket_dtype":
        b = b.long()
    elif bad == "planes_dtype":
        p = p.to(torch.bfloat16)
    elif bad == "rows":
        p = p[:3]
    elif bad == "n_active":
        na = torch.ones(2, dtype=torch.int32)
    elif bad == "B":
        B = 0
    else:
        meta = torch.device("meta")
        b, p, na = b.to(meta), p.to(meta), na.to(meta)
    with pytest.raises(ValueError):
        cuda_agg.grouped_accumulate(b, p, na, B)
