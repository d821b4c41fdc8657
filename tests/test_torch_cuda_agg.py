"""The port's grouped accumulate (kernel K1) against the Pallas kernel.

``spark_tpu_torch.cuda_agg.grouped_accumulate`` on CPU tensors runs its
plain PyTorch version; the reference is ``spark_tpu.pallas_agg`` in
interpret mode (the same program as on the TPU, no Mosaic).  Exact.
The fused front ``grouped_accumulate_columns`` (planes described by
columns) is held against the same Pallas kernel fed the reference's own
plane build.  The CUDA kernel itself is held against the plain versions
on the card by ``chip_smoke.py``.
"""

import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spark_tpu import kernels as RK
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


# ---- the fused front: planes described by columns ----------------------

_U32 = np.uint32


def _ref_planes(live, data, valid, mix):
    """Planes in numpy as the reference's MXU form builds them
    (``spark_tpu/kernels.py`` fast_branch: 32-bit halves, the sign flip
    for 8-byte values, a mod-2^32 offset add for narrower ones)."""
    m = live if valid is None else live & valid
    planes = [live]
    if mix == "count+sum":
        planes.append(m)
    if data.dtype == np.bool_:
        data = data.astype(np.int8)
    n_limbs, offset = RK._limb_plan(data.dtype)
    w64 = data.astype(np.int64).view(np.uint64)
    lo = (w64 & np.uint64(0xFFFFFFFF)).astype(_U32)
    hi = (w64 >> np.uint64(32)).astype(_U32)
    words = (lo, hi ^ _U32(0x80000000)) if n_limbs == 8 else \
        (lo + _U32(offset),)
    for i in range(n_limbs):
        limb = (words[i // 4] >> _U32(8 * (i % 4))) & _U32(0xFF)
        planes.append(np.where(m, limb, _U32(0)))
    planes.append(m)
    return np.stack([p.astype(np.uint8) for p in planes], axis=1), \
        n_limbs, offset


def _port_planes(live, data, valid, mix):
    """The same planes as ``kernels._mxu_grouped_aggregate`` describes
    them to the fused front."""
    live_t = torch.from_numpy(live)
    value = torch.from_numpy(data)
    m = live_t if valid is None else live_t & torch.from_numpy(valid)
    planes = [cuda_agg.Plane(live_t)]
    if mix == "count+sum":
        planes.append(cuda_agg.Plane(m))
    n_limbs = 1 if data.dtype == np.bool_ else data.dtype.itemsize
    offset = -(1 << 63) if n_limbs == 8 else 1 << (8 * n_limbs - 1)
    planes += [cuda_agg.Plane(m, value, i, offset) for i in range(n_limbs)]
    planes.append(cuda_agg.Plane(m))
    return planes


def _values(kind, n, rng):
    if kind == "bool":
        return rng.random(n) < 0.5
    dt = np.dtype("int64" if kind == "decimal" else kind)
    info = np.iinfo(dt)
    if kind == "decimal":                       # decimal(18, 2) as int64 cents
        x = rng.integers(-10 ** 17, 10 ** 17, n).astype(np.int64)
    else:
        x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    x[:5] = [info.min, info.max, info.max, -1, 0]   # extremes: sums wrap
    return x


@pytest.mark.parametrize("mix", ["sum", "count+sum", "countstar+avg"])
@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("kind", ["int8", "int16", "int32", "int64", "bool",
                                  "decimal"])
def test_columns_match_pallas_kernel(kind, nullable, mix):
    """The fused front's plain version against the Pallas kernel fed the
    reference's own plane build, at each value width, with and without
    NULLs, across the Count/CountStar/Avg plane mixes, with dead-chunk
    rows carrying nonzero planes.  Equal limb sums recombine to the
    wrapping int64 sum of the live values."""
    rng = np.random.default_rng(zlib.crc32(f"{kind} {nullable} {mix}".encode()))
    n, B = 2000, 2048
    n_active = 1                               # buckets >= 512 are dead
    bucket = rng.integers(0, 400, n).astype(np.int32)
    bucket[-50:] = rng.integers(512, B, 50)    # dead rows, nonzero planes
    live = rng.random(n) < 0.9
    data = _values(kind, n, rng)
    valid = rng.random(n) < 0.7 if nullable else None
    ref_planes, n_limbs, offset = _ref_planes(live, data, valid, mix)
    ref = np.asarray(pallas_agg.grouped_accumulate(
        jnp.asarray(bucket), jnp.asarray(ref_planes.astype(np.float32)),
        jnp.int32(n_active), B, interpret=True))
    launches = cuda_agg.LAUNCHES
    got = cuda_agg.grouped_accumulate_columns(
        torch.from_numpy(bucket), _port_planes(live, data, valid, mix),
        torch.tensor([n_active], dtype=torch.int32), B).numpy()
    assert cuda_agg.LAUNCHES == launches      # the CPU takes the plain version
    assert got.dtype == np.int64 and got.shape == (B, ref_planes.shape[1])
    assert np.array_equal(got, ref)

    # recombined per bucket: the wrapping int64 sum of the live values
    first = 2 if mix == "count+sum" else 1
    acc = np.zeros(B, np.uint64)
    for i in range(n_limbs):
        acc += got[:, first + i].astype(np.uint64) << np.uint64(8 * i)
    cnt = got[:, first + n_limbs].astype(np.uint64)
    total = (acc - cnt * np.uint64(offset % 2 ** 64)).view(np.int64)
    m = live & (valid if nullable else True) & (bucket < 512)
    want = np.zeros(B, np.int64)
    with np.errstate(over="ignore"):
        np.add.at(want, bucket[m], data[m].astype(np.int64))
    assert np.array_equal(total, want)


def test_columns_equal_the_planes_entry():
    """Both entries give the same table for the same planes, masks absent
    (every row) included."""
    rng = np.random.default_rng(3)
    n, B = 3000, 700
    bucket = torch.from_numpy(rng.integers(0, B, n).astype(np.int32))
    v = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32))
    m = torch.from_numpy(rng.random(n) < 0.5)
    planes = [cuda_agg.Plane(), cuda_agg.Plane(m),
              *[cuda_agg.Plane(None, v, i, 1 << 31) for i in range(4)],
              cuda_agg.Plane(m, v, 3, 1 << 31)]
    na = torch.tensor([2], dtype=torch.int32)
    mat = torch.stack([cuda_agg.plane_values(p, n, "cpu") for p in planes], 1)
    assert torch.equal(cuda_agg.grouped_accumulate_columns(bucket, planes,
                                                           na, B),
                       cuda_agg.grouped_accumulate(bucket, mat, na, B))


def test_plane_groups_respect_launch_limits():
    """Wide calls split into consecutive launches of at most MAX_PLANES
    planes and MAX_COLUMNS distinct columns, in plane order."""
    n = 10
    cols = [torch.zeros(n, dtype=torch.int64) for _ in range(20)]
    masks = [torch.ones(n, dtype=torch.bool) for _ in range(20)]
    planes = [cuda_agg.Plane(masks[c], cols[c], i, 0)
              for c in range(20) for i in range(4)]
    groups = cuda_agg.plane_groups(planes)
    assert [p for g in groups for p in g] == planes
    for g in groups:
        assert len(g) <= cuda_agg.MAX_PLANES
        keys = {(t.data_ptr(), t.dtype) for p in g for t in (p.mask, p.value)}
        assert len(keys) <= cuda_agg.MAX_COLUMNS
    assert len(groups) == 3                    # 8 columns (4 values + 4 masks) each
    wide = [cuda_agg.Plane()] * 150
    assert [len(g) for g in cuda_agg.plane_groups(wide)] == [64, 64, 22]


@pytest.mark.parametrize("bad", ["non_contiguous", "value_dtype", "mask_dtype",
                                 "value_rows", "mask_rows", "mask_device",
                                 "limb", "mask_plane_limb", "no_planes",
                                 "bucket_dtype"])
def test_columns_wrapper_validates_inputs(bad):
    """What the kernel does not take is refused before either version
    runs, so a call the kernel would refuse fails the same way on the
    host."""
    n = 8
    b = torch.zeros(n, dtype=torch.int32)
    v = torch.zeros(n, dtype=torch.int64)
    m = torch.ones(n, dtype=torch.bool)
    na = torch.ones(1, dtype=torch.int32)
    planes = [cuda_agg.Plane(m), cuda_agg.Plane(m, v, 0, 0)]
    if bad == "non_contiguous":
        planes[1] = cuda_agg.Plane(m, torch.zeros(2 * n, dtype=torch.int64)[::2])
    elif bad == "value_dtype":
        planes[1] = cuda_agg.Plane(m, v.double())
    elif bad == "mask_dtype":
        planes[0] = cuda_agg.Plane(m.to(torch.int32))
    elif bad == "value_rows":
        planes[1] = cuda_agg.Plane(m, v[:n - 1])
    elif bad == "mask_rows":
        planes[0] = cuda_agg.Plane(m[:n - 1])
    elif bad == "mask_device":
        planes[0] = cuda_agg.Plane(m.to("meta"))
    elif bad == "limb":
        planes[1] = cuda_agg.Plane(m, v, 8, 0)
    elif bad == "mask_plane_limb":
        planes[0] = cuda_agg.Plane(m, None, 1, 0)
    elif bad == "no_planes":
        planes = []
    else:
        b = b.long()
    with pytest.raises(ValueError):
        cuda_agg.grouped_accumulate_columns(b, planes, na, 4)
