"""Columnar batches of torch tensors: the engine's data representation.

The layout of ``spark_tpu/columnar.py`` (the replacement of the
reference's ``ColumnarBatch.java:46`` / ``ColumnVector.java:60`` stack),
held in torch tensors on one device:

* every column is ONE flat tensor of a fixed-width dtype, padded to a
  static ``capacity`` (power of two);
* row existence (``row_valid``) and per-column NULLs (``ColumnVector.valid``)
  are separate boolean masks (Arrow-style validity);
* strings/binary are int32 dictionary codes into a host-side,
  lexicographically sorted dictionary (a tuple of words), so every device
  op on strings is an integer op;
* an array column is ONE ``(capacity, max_len)`` tensor of the element
  dtype, each row's elements first and trailing slots holding the
  element sentinel (``types.ArrayType``); it pads by rows only.

Filtering does NOT compact (it ANDs ``row_valid``); ``compact`` is an
explicit operator.  ``ColumnBatch.from_numpy_parts`` builds a batch from
plain numpy parts, which is how batches of the JAX package cross over.
"""

from __future__ import annotations

import gc
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import types as T
from .capture import constant

MIN_CAPACITY = 8


def pad_capacity(n: int) -> int:
    """Round row count up to the static batch capacity (next power of two)."""
    c = MIN_CAPACITY
    while c < n:
        c <<= 1
    return c


# ---------------------------------------------------------------------------
# run vectors: process-wide counters (gauge consumers diff against a base)
# ---------------------------------------------------------------------------

#: run-coded values expanded to dense host tensors (``RunColumnVector``'s
#: first ``.data``); columns that stay run-coded through the taught
#: operators never show up here
_RUNS_MATERIALIZED = 0
#: rows whose operator work was done once per run instead of per row
_RUN_AWARE_OP_ROWS = 0
#: run planes at the stage boundary (``PlaneColumnVector``): stage
#: dispatches with at least one plane leaf, the dense rows those planes
#: stood for, run vectors whose run table was too large for a plane
#: (materialized dense at the boundary instead), and expansions of a plane
#: inside a stage by an operator that reads ``.data``
_RUN_PLANE_STAGES = 0
_RUN_PLANE_ROWS = 0
_RUN_PLANE_OVERFLOWS = 0
_RUN_PLANE_EXPANSIONS = 0


#: dictionary codes decoded back into Python words (``decode_column``):
#: the "late materialization" boundary.  Codes that stay codes through
#: exchange, join and group never show up here; only collect()-style
#: output does
_LATE_MATERIALIZED_ROWS = 0


def late_materialized_rows() -> int:
    """Dictionary-encoded values decoded to Python objects so far
    (process-wide; gauge consumers diff against a base)."""
    return _LATE_MATERIALIZED_ROWS


def runs_materialized() -> int:
    return _RUNS_MATERIALIZED


def run_aware_op_rows() -> int:
    return _RUN_AWARE_OP_ROWS


def bump_run_aware(n: int) -> None:
    """Credit ``n`` rows to the run-aware operator counter."""
    global _RUN_AWARE_OP_ROWS
    _RUN_AWARE_OP_ROWS += int(n)


def run_plane_stages() -> int:
    return _RUN_PLANE_STAGES


def run_plane_rows() -> int:
    return _RUN_PLANE_ROWS


def run_plane_overflows() -> int:
    return _RUN_PLANE_OVERFLOWS


def run_plane_expansions() -> int:
    return _RUN_PLANE_EXPANSIONS


def bump_plane_stage() -> None:
    global _RUN_PLANE_STAGES
    _RUN_PLANE_STAGES += 1


def bump_plane_rows(n: int) -> None:
    global _RUN_PLANE_ROWS
    _RUN_PLANE_ROWS += int(n)


def bump_plane_overflow() -> None:
    global _RUN_PLANE_OVERFLOWS
    _RUN_PLANE_OVERFLOWS += 1


def run_counters() -> Dict[str, int]:
    """Every run counter by its gauge name."""
    return {"runs_materialized": _RUNS_MATERIALIZED,
            "run_aware_op_rows": _RUN_AWARE_OP_ROWS,
            "run_plane_stages": _RUN_PLANE_STAGES,
            "run_plane_rows": _RUN_PLANE_ROWS,
            "run_plane_overflows": _RUN_PLANE_OVERFLOWS,
            "run_plane_expansions": _RUN_PLANE_EXPANSIONS}


def encode_strings(values: Sequence[Optional[str]]) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """Dictionary-encode strings: codes into a SORTED dictionary.

    Sorted dictionaries make code order == lexicographic order, so device
    sorts/compares on codes are string-correct.  Returns (int32 codes with
    -1 for None, dictionary tuple).
    """
    present = sorted({v for v in values if v is not None})
    lookup = {v: i for i, v in enumerate(present)}
    codes = np.fromiter(
        (lookup[v] if v is not None else -1 for v in values),
        dtype=np.int32, count=len(values),
    )
    return codes, tuple(present)


def merge_dictionaries(
    a: Tuple[str, ...], b: Tuple[str, ...]
) -> Tuple[Tuple[str, ...], np.ndarray, np.ndarray]:
    """Merge two sorted dictionaries; return (merged, remap_a, remap_b)
    with ``remap_x[old_code] -> new_code`` (host numpy tables)."""
    merged = tuple(sorted(set(a) | set(b)))
    lookup = {v: i for i, v in enumerate(merged)}
    remap_a = np.fromiter((lookup[v] for v in a), dtype=np.int32, count=len(a))
    remap_b = np.fromiter((lookup[v] for v in b), dtype=np.int32, count=len(b))
    return merged, remap_a, remap_b


def _move(t: Optional[torch.Tensor], device,
          non_blocking: bool = False) -> Optional[torch.Tensor]:
    return None if t is None else t.to(device, non_blocking=non_blocking)


class ColumnVector:
    """One column: data tensor + optional validity mask (+ string dictionary).

    ``valid is None`` means "no NULLs".  The dictionary is host metadata.
    """

    __slots__ = ("data", "valid", "dtype", "dictionary")

    def __init__(self, data: torch.Tensor, dtype: T.DataType,
                 valid: Optional[torch.Tensor] = None,
                 dictionary: Optional[Tuple[str, ...]] = None):
        self.data = data
        self.dtype = dtype
        self.valid = valid
        self.dictionary = dictionary

    def __repr__(self) -> str:  # pragma: no cover
        return f"ColumnVector({self.dtype!r}, shape={tuple(self.data.shape)})"

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def is_pinned(self) -> bool:
        return self.data.is_pinned()

    def with_data(self, data: torch.Tensor,
                  valid: Union[torch.Tensor, None, type(...)] = ...) -> "ColumnVector":
        """New vector with replaced data; ``valid=...`` keeps the old mask."""
        v = self.valid if valid is ... else valid
        return ColumnVector(data, self.dtype, v, self.dictionary)

    def valid_or_true(self) -> torch.Tensor:
        if self.valid is not None:
            return self.valid
        return torch.ones(self.data.shape[0], dtype=torch.bool,
                          device=self.data.device)

    # ---- movement ------------------------------------------------------
    def to_device(self, device, non_blocking: bool = False) -> "ColumnVector":
        return ColumnVector(self.data.to(device, non_blocking=non_blocking),
                            self.dtype,
                            _move(self.valid, device, non_blocking),
                            self.dictionary)

    def to_host(self) -> "ColumnVector":
        return self.to_device("cpu")

    def to_pylist(self, row_valid: Optional[torch.Tensor] = None) -> List[Any]:
        """Decode to Python objects (None for NULL); for collect()."""
        data = self.data.cpu().numpy()
        valid = None if self.valid is None else self.valid.cpu().numpy()
        sel = None if row_valid is None else row_valid.cpu().numpy()
        return decode_column(data, valid, sel, self.dtype, self.dictionary)


def decode_column(data: np.ndarray, valid: Optional[np.ndarray],
                  row_valid: Optional[np.ndarray], dt: T.DataType,
                  dictionary: Optional[Tuple[str, ...]]) -> List[Any]:
    """One host column as Python objects, by column with numpy: the
    values and Python types ``spark_tpu/columnar.py``'s per-element loop
    gives (``int``, ``float``, ``bool``, ``str``, ``datetime.date``,
    ``datetime.datetime``; None for NULL), in one pass per column.  A
    decimal keeps that loop's two roundings, ``float(unscaled) /
    10**scale``, so it is bit-equal."""
    if row_valid is not None:
        data = data[row_valid]
        valid = None if valid is None else valid[row_valid]
    if dictionary is not None and len(data):
        global _LATE_MATERIALIZED_ROWS
        _LATE_MATERIALIZED_ROWS += len(data)
    if isinstance(dt, T.ArrayType):
        out = _decode_arrays(data, dt, dictionary)
    else:
        out = _decode_flat(data, dt, dictionary)
    if valid is not None:
        for i in np.flatnonzero(~valid).tolist():
            out[i] = None
    return out


def _decode_arrays(data: np.ndarray, dt: "T.ArrayType",
                   dictionary: Optional[Tuple[str, ...]]) -> List[Any]:
    """Rows of a ``(rows, max_len)`` array plane as Python lists of their
    live elements (those that are not the element sentinel), with the
    element values ``decode_column`` gives a flat column."""
    et = dt.element_type
    if data.ndim == 1:                         # a 0-wide plane
        return [[] for _ in range(len(data))]
    if et.is_fractional:
        live = ~np.isnan(data.astype(np.float64))
    elif et.is_string:
        live = data >= 0
    else:
        live = data != dt.element_sentinel()
    flat = _decode_flat(data[live], et, dictionary)
    ends = np.cumsum(live.sum(axis=1)).tolist()
    starts = [0] + ends[:-1]
    # a list per row and nothing that can form a cycle: the cyclic
    # collector, which a run of new lists sets off again and again, would
    # take most of the time
    enabled = gc.isenabled()
    gc.disable()
    try:
        return [flat[a:b] for a, b in zip(starts, ends)]
    finally:
        if enabled:
            gc.enable()


def _decode_flat(data: np.ndarray, dt: T.DataType,
                 dictionary: Optional[Tuple[str, ...]]) -> List[Any]:
    if dt.is_string or isinstance(dt, T.BinaryType):
        words = np.empty(len(dictionary or ()) + 1, dtype=object)
        words[:-1] = dictionary or ()          # last slot: None
        codes = data.astype(np.int64)
        codes = np.where((codes >= 0) & (codes < len(words) - 1), codes,
                         len(words) - 1)
        values = words[codes]
    elif isinstance(dt, T.BooleanType):
        values = data.astype(bool)
    elif isinstance(dt, T.DecimalType):
        values = data.astype(np.float64) / np.float64(10 ** dt.scale)
    elif isinstance(dt, T.DateType):
        values = data.astype(np.int64).astype("datetime64[D]")
    elif isinstance(dt, T.TimestampType):
        values = data.astype(np.int64).astype("datetime64[us]")
    else:
        values = data               # ints and floats: tolist() gives Python's
    return values.tolist()


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` as one 1-D uint8 tensor (an array plane's too)."""
    return t.contiguous().view(torch.uint8).reshape(-1)


def pack_to_host(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Host copies of device ``tensors`` (1-D) in ONE device → host
    transfer: their bytes gathered into one staging buffer on the device
    (one concatenation, each part padded to 8 bytes so every host view
    stays aligned), one ``non_blocking`` copy into pinned host memory,
    one stream synchronize, then typed views sliced back out.

    Each call owns its pinned buffer (from PyTorch's caching host
    allocator) and the views keep it alive, so concurrent calls never
    share one; the buffer goes back to the allocator with the last view.
    Call it where the device tensors still hold what is wanted (a stage
    entry's static outputs: under the entry's lock).  CPU tensors come
    back as they are."""
    if not tensors or tensors[0].device.type == "cpu":
        return list(tensors)
    parts, spans = [], []
    offset = 0
    for t in tensors:
        b = _byte_view(t)
        parts.append(b)
        n = b.numel()
        spans.append((offset, n, t.dtype, t.shape))
        pad = -n % 8
        if pad:
            parts.append(torch.empty(pad, dtype=torch.uint8,
                                     device=b.device))
        offset += n + pad
    staging = torch.cat(parts) if len(parts) > 1 else parts[0]
    host = torch.empty(staging.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(staging, non_blocking=True)
    torch.cuda.current_stream(staging.device).synchronize()
    return [host[o:o + n].view(dt).view(shape) for o, n, dt, shape in spans]


def _host_tensor(x, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.array(x, copy=True))
    return t if dtype is None else t.to(dtype)


def device_tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` — a tensor, a numpy array or a list — as a tensor on
    ``device``; a host value takes numpy's dtype (a Python float is
    float64, an int int64)."""
    return _host_tensor(x, dtype).to(device)


class RunColumnVector(ColumnVector):
    """A run-length coded column: ``(run_values, run_lengths)`` standing
    for a dense tensor of ``sum(run_lengths)`` rows (``spark_tpu/
    columnar.py`` ``RunColumnVector``).

    The dense form is built on the first ``.data`` access (counted in
    ``runs_materialized``); run-aware operators read ``run_values`` /
    ``run_lengths`` and never pay for it.  Validity, dtype and dictionary
    behave as a dense vector's, so an operator that was not taught about
    runs simply materializes.  The run table lives on the host; moving the
    vector to a card expands it there (one ``repeat_interleave`` of a
    known length, not counted: it is no host inflation)."""

    __slots__ = ("run_values", "run_lengths", "_n", "_dense")

    def __init__(self, run_values, run_lengths, dtype: T.DataType,
                 valid: Optional[torch.Tensor] = None,
                 dictionary: Optional[Tuple[str, ...]] = None):
        self.run_values = _host_tensor(run_values)
        self.run_lengths = _host_tensor(run_lengths, torch.int64)
        self._n = int(self.run_lengths.sum())
        self._dense = None
        self.dtype = dtype
        self.valid = valid
        self.dictionary = dictionary

    def __repr__(self) -> str:  # pragma: no cover
        return (f"RunColumnVector({self.dtype!r}, n={self._n}, "
                f"runs={len(self.run_values)}, "
                f"materialized={self._dense is not None})")

    @property
    def is_materialized(self) -> bool:
        return self._dense is not None

    @property
    def data(self) -> torch.Tensor:
        # shadows the parent's ``data`` slot: the expansion happens once
        if self._dense is None:
            global _RUNS_MATERIALIZED
            _RUNS_MATERIALIZED += self._n
            self._dense = torch.repeat_interleave(
                self.run_values, self.run_lengths, output_size=self._n)
        return self._dense

    @property
    def capacity(self) -> int:
        return self._n

    @property
    def device(self) -> torch.device:
        return self.run_values.device

    def is_pinned(self) -> bool:
        return False

    def valid_or_true(self) -> torch.Tensor:
        if self.valid is not None:
            return self.valid
        return torch.ones(self._n, dtype=torch.bool)

    def to_host(self) -> ColumnVector:
        return self

    def to_device(self, device, non_blocking: bool = False) -> ColumnVector:
        if torch.device(device).type == "cpu":
            return self
        return self.dense_on(device)

    def dense_on(self, device) -> ColumnVector:
        """This column dense on ``device``, the host counter untouched:
        the boundary of a stage, as the JAX package's ``to_device``."""
        if self._dense is not None:
            data = self._dense.to(device)
        else:
            data = torch.repeat_interleave(
                self.run_values.to(device), self.run_lengths.to(device),
                output_size=self._n)
        return ColumnVector(data, self.dtype, _move(self.valid, device),
                            self.dictionary)

    def with_run_values(self, run_values,
                        dictionary: Union[Tuple[str, ...], None,
                                          type(...)] = ...
                        ) -> "RunColumnVector":
        """The same runs over new values (a dictionary-code remap stays
        run-coded)."""
        d = self.dictionary if dictionary is ... else dictionary
        return RunColumnVector(run_values, self.run_lengths, self.dtype,
                               self.valid, d)


def unmaterialized_runs(v: ColumnVector) -> Optional[RunColumnVector]:
    """``v`` if it is a run vector whose dense form was never built, else
    None."""
    if isinstance(v, RunColumnVector) and not v.is_materialized:
        return v
    return None


class PlaneColumnVector(ColumnVector):
    """The fixed-capacity stage form of a run table (``spark_tpu/
    columnar.py`` ``PlaneColumnVector``).

    ``plane_values`` (run values zero-padded to ``plane_capacity``, a
    ``pad_capacity`` bucket of the run count) and ``plane_lengths`` (int64
    run lengths, zero-padded) are its tensors; ``capacity`` is the dense
    row count they stand for.  Real runs are exactly the ``lengths > 0``
    prefix.  The taught kernels (segmented filter, keyless count/sum/min/
    max, bare-column project) read the plane; any other operator that asks
    for ``.data`` gets one memoized expansion by ``kernels.run_expand``
    (counted in ``run_plane_expansions``), whose shapes are fixed, so a
    captured graph can hold it."""

    __slots__ = ("plane_values", "plane_lengths", "n_runs", "_capacity",
                 "_dense")

    def __init__(self, plane_values: torch.Tensor,
                 plane_lengths: torch.Tensor, dtype: T.DataType,
                 capacity: int, valid: Optional[torch.Tensor] = None,
                 dictionary: Optional[Tuple[str, ...]] = None,
                 n_runs: Optional[int] = None):
        self.plane_values = plane_values
        self.plane_lengths = plane_lengths
        self.n_runs = None if n_runs is None else int(n_runs)
        self._capacity = int(capacity)
        self._dense = None
        self.dtype = dtype
        self.valid = valid
        self.dictionary = dictionary

    @classmethod
    def from_runs(cls, rv: RunColumnVector,
                  plane_cap: int) -> "PlaneColumnVector":
        """A host run table padded into a plane of ``plane_cap`` slots."""
        nr = len(rv.run_values)
        values = torch.zeros(plane_cap, dtype=rv.run_values.dtype)
        values[:nr] = rv.run_values
        lengths = torch.zeros(plane_cap, dtype=torch.int64)
        lengths[:nr] = rv.run_lengths
        return cls(values, lengths, rv.dtype, rv.capacity, rv.valid,
                   rv.dictionary, n_runs=nr)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"PlaneColumnVector({self.dtype!r}, capacity="
                f"{self._capacity}, plane={self.plane_capacity}, runs="
                f"{self.n_runs}, expanded={self._dense is not None})")

    @property
    def plane_capacity(self) -> int:
        return int(self.plane_values.shape[0])

    @property
    def is_expanded(self) -> bool:
        return self._dense is not None

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def device(self) -> torch.device:
        return self.plane_values.device

    def is_pinned(self) -> bool:
        return self.plane_values.is_pinned()

    @property
    def data(self) -> torch.Tensor:
        # shadows the parent's ``data`` slot: an operator that was not
        # taught about planes gets one memoized expansion
        if self._dense is None:
            global _RUN_PLANE_EXPANSIONS
            _RUN_PLANE_EXPANSIONS += 1
            from .kernels import run_expand
            self._dense = run_expand(self.plane_values, self.plane_lengths,
                                     self._capacity)
        return self._dense

    def valid_or_true(self) -> torch.Tensor:
        if self.valid is not None:
            return self.valid
        return torch.ones(self._capacity, dtype=torch.bool,
                          device=self.plane_values.device)

    def to_device(self, device, non_blocking: bool = False) -> ColumnVector:
        return PlaneColumnVector(
            self.plane_values.to(device, non_blocking=non_blocking),
            self.plane_lengths.to(device, non_blocking=non_blocking),
            self.dtype, self._capacity,
            _move(self.valid, device, non_blocking), self.dictionary,
            n_runs=self.n_runs)

    def to_host(self) -> ColumnVector:
        # leaving the stage: a dense host vector (the memoized expansion)
        return ColumnVector(self.data.cpu(), self.dtype,
                            _move(self.valid, "cpu"), self.dictionary)

    def clone(self) -> "PlaneColumnVector":
        return PlaneColumnVector(
            self.plane_values.clone(), self.plane_lengths.clone(),
            self.dtype, self._capacity,
            None if self.valid is None else self.valid.clone(),
            self.dictionary, n_runs=self.n_runs)


def unexpanded_plane(v: ColumnVector) -> Optional[PlaneColumnVector]:
    """``v`` if it is a run plane whose dense form was never asked for,
    else None."""
    if isinstance(v, PlaneColumnVector) and v._dense is None:
        return v
    return None


def dense_runs(batch: "ColumnBatch", device) -> "ColumnBatch":
    """``batch`` with every run vector dense on ``device`` (uncounted, as
    at a stage boundary) and every other vector moved there."""
    return ColumnBatch(
        batch.names,
        [v.dense_on(device) if isinstance(v, RunColumnVector)
         else v.to_device(device) for v in batch.vectors],
        _move(batch.row_valid, device), batch.capacity, batch.source)


class ColumnBatch:
    """A fixed-capacity batch of columns plus a row-existence mask."""

    # _cache_uid: identity for plan cache keys (``sql/logical._batch_uid``),
    # assigned on first use — ``id()`` could be recycled after GC.
    # source: None for an in-memory batch; for a batch decoded from files
    # (``io._load_batch``) the token of its files and their stat, which the
    # stage key carries (``stagecompile.leaf_signature``)
    __slots__ = ("names", "vectors", "row_valid", "capacity", "_cache_uid",
                 "source")

    def __init__(self, names: Sequence[str], vectors: Sequence[ColumnVector],
                 row_valid: Optional[torch.Tensor], capacity: int,
                 source: Optional[str] = None):
        if len(names) != len(vectors):
            raise ValueError(f"{len(names)} names for {len(vectors)} columns")
        self.names = list(names)
        self.vectors = list(vectors)
        self.row_valid = row_valid
        self.capacity = capacity
        self.source = source

    # -- constructors -----------------------------------------------------
    @staticmethod
    def from_arrays(data: Dict[str, Any], num_rows: Optional[int] = None,
                    capacity: Optional[int] = None,
                    schema: Optional[T.StructType] = None,
                    device="cpu") -> "ColumnBatch":
        """Build from host arrays / lists; pads to a static capacity."""
        names = list(data.keys())
        if num_rows is None:
            num_rows = len(next(iter(data.values()))) if names else 0
        cap = capacity or pad_capacity(num_rows)
        if cap < num_rows:
            raise ValueError(f"capacity {cap} < num_rows {num_rows}")
        vectors: List[ColumnVector] = []
        for name in names:
            dt = schema[name].dataType if schema is not None else None
            arr, dt, valid, dictionary = _ingest_column(data[name], cap, dt)
            vectors.append(ColumnVector(
                torch.from_numpy(arr).to(device), dt,
                None if valid is None else torch.from_numpy(valid).to(device),
                dictionary))
        row_valid = None
        if cap != num_rows:
            rv = np.zeros(cap, dtype=bool)
            rv[:num_rows] = True
            row_valid = torch.from_numpy(rv).to(device)
        return ColumnBatch(names, vectors, row_valid, cap)

    @staticmethod
    def from_numpy_parts(names: Sequence[str], type_strings: Sequence[str],
                         datas: Sequence[np.ndarray],
                         valids: Sequence[Optional[np.ndarray]],
                         row_valid: Optional[np.ndarray],
                         dictionaries: Sequence[Optional[Tuple[str, ...]]],
                         capacity: int, device="cpu") -> "ColumnBatch":
        """Build a batch from plain numpy parts and ``simpleString()`` type
        names — the state carry-over from a batch of the JAX package
        (``to_host()`` there, then these parts here), bit for bit."""
        vectors = []
        for dstr, d, v, dic in zip(type_strings, datas, valids, dictionaries):
            dt = T.type_for_name(dstr)
            arr = np.ascontiguousarray(np.asarray(d, dt.np_dtype))
            if arr.shape[0] != capacity:
                raise ValueError(
                    f"column of {arr.shape[0]} rows in a batch of capacity "
                    f"{capacity}")
            valid = None if v is None else torch.from_numpy(
                np.ascontiguousarray(np.asarray(v, bool))).to(device)
            vectors.append(ColumnVector(
                torch.from_numpy(arr).to(device), dt, valid,
                None if dic is None else tuple(dic)))
        rv = None if row_valid is None else torch.from_numpy(
            np.ascontiguousarray(np.asarray(row_valid, bool))).to(device)
        return ColumnBatch(list(names), vectors, rv, int(capacity))

    @staticmethod
    def empty(schema: T.StructType, capacity: int = MIN_CAPACITY,
              device="cpu") -> "ColumnBatch":
        vectors = []
        for f in schema.fields:
            if isinstance(f.dataType, T.ArrayType):
                arr = torch.full((capacity, 1),
                                 f.dataType.element_sentinel().item(),
                                 dtype=f.dataType.torch_dtype, device=device)
                vectors.append(ColumnVector(arr, f.dataType, None, None))
                continue
            arr = torch.zeros(capacity, dtype=f.dataType.torch_dtype,
                              device=device)
            d = () if (f.dataType.is_string or isinstance(f.dataType, T.BinaryType)) else None
            vectors.append(ColumnVector(arr, f.dataType, None, d))
        return ColumnBatch(schema.names, vectors,
                           torch.zeros(capacity, dtype=torch.bool,
                                       device=device), capacity)

    # -- schema & access --------------------------------------------------
    @property
    def schema(self) -> T.StructType:
        return T.StructType([
            T.StructField(n, v.dtype, v.valid is not None)
            for n, v in zip(self.names, self.vectors)
        ])

    @property
    def device(self) -> torch.device:
        if self.row_valid is not None:
            return self.row_valid.device
        if self.vectors:
            return self.vectors[0].device
        return torch.device("cpu")

    def column(self, name: str) -> ColumnVector:
        return self.vectors[self.names.index(name)]

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def with_columns(self, names: Sequence[str], vectors: Sequence[ColumnVector]) -> "ColumnBatch":
        return ColumnBatch(list(names), list(vectors), self.row_valid, self.capacity)

    def row_valid_or_true(self) -> torch.Tensor:
        if self.row_valid is not None:
            return self.row_valid
        return torch.ones(self.capacity, dtype=torch.bool, device=self.device)

    def num_rows(self) -> torch.Tensor:
        """Number of live rows, as an int64 tensor on the batch's device."""
        if self.row_valid is None:
            return constant(self.capacity, self.device, torch.int64)
        return self.row_valid.sum(dtype=torch.int64)

    # -- movement ---------------------------------------------------------
    def to_device(self, device, non_blocking: bool = False) -> "ColumnBatch":
        """This batch on ``device``; from pinned host memory with
        ``non_blocking`` the copies are queued on the current stream."""
        return ColumnBatch(
            self.names,
            [v.to_device(device, non_blocking) for v in self.vectors],
            _move(self.row_valid, device, non_blocking), self.capacity)

    def to_host(self) -> "ColumnBatch":
        return self.to_device("cpu")

    def pinned(self) -> "ColumnBatch":
        """This host batch in page-locked memory, so that its copy to the
        card is one ``non_blocking`` copy per tensor (a file batch on a
        ``cuda`` session).  A lazy run vector stays as it is: pinning it
        would expand it, and it enters a stage as a plane or dense
        (``stagecompile.plan_leaves``)."""
        def pin(t):
            return None if t is None else t.pin_memory()
        return ColumnBatch(
            self.names,
            [v if isinstance(v, RunColumnVector)
             else ColumnVector(pin(v.data), v.dtype, pin(v.valid),
                               v.dictionary)
             for v in self.vectors],
            pin(self.row_valid), self.capacity, self.source)

    def is_pinned(self) -> bool:
        return bool(self.vectors) and self.vectors[0].is_pinned()

    # -- output -----------------------------------------------------------
    def decoded_columns(self) -> Tuple[List[List[Any]], int]:
        """Every column's live values as Python objects, and the number of
        live rows: the batch comes to the host in one transfer
        (``packed_host``), then each column is decoded by column
        (``decode_column``)."""
        host = self.packed_host()
        rv = None if host.row_valid is None else host.row_valid.numpy()
        cols = [decode_column(v.data.numpy(),
                              None if v.valid is None else v.valid.numpy(),
                              rv, v.dtype, v.dictionary)
                for v in host.vectors]
        return cols, (host.capacity if rv is None else int(rv.sum()))

    def to_pylist(self) -> List[tuple]:
        """Rows as tuples (collect() decode path)."""
        cols, n = self.decoded_columns()
        return list(zip(*cols)) if cols else [() for _ in range(n)]

    def packed_host(self, rows: Optional[int] = None) -> "ColumnBatch":
        """The first ``rows`` rows (all, by default) of this batch on the
        host, every column, mask and ``row_valid`` in one transfer."""
        cap = self.capacity if rows is None else rows
        tensors = []
        for v in self.vectors:
            tensors.append(v.data[:cap])
            if v.valid is not None:
                tensors.append(v.valid[:cap])
        if self.row_valid is not None:
            tensors.append(self.row_valid[:cap])
        it = iter(pack_to_host(tensors))
        vectors = [ColumnVector(next(it), v.dtype,
                                None if v.valid is None else next(it),
                                v.dictionary) for v in self.vectors]
        rv = None if self.row_valid is None else next(it)
        return ColumnBatch(self.names, vectors, rv, cap)

    def __repr__(self) -> str:  # pragma: no cover
        return f"ColumnBatch({self.schema.simpleString()}, capacity={self.capacity})"


# ---------------------------------------------------------------------------
# host batch reshaping of the out-of-core runners
# ---------------------------------------------------------------------------

def pad_to_capacity(batch: ColumnBatch, cap: int) -> ColumnBatch:
    """Grow a batch to a larger static capacity, on the device it lies
    on: streamed scans and micro-batches pad every batch to ONE capacity
    so the per-batch step is one stage entry (``spark_tpu/columnar.py``
    ``pad_to_capacity``).  Padding rows hold zeros, are dead and carry no
    validity."""
    if cap < batch.capacity:
        raise ValueError(f"cannot shrink batch {batch.capacity} -> {cap}")
    if cap == batch.capacity:
        return batch
    pad = cap - batch.capacity

    def grow(t: torch.Tensor, fill=0) -> torch.Tensor:
        tail = torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                          device=t.device)
        return torch.cat([t, tail])

    vectors = []
    for v in batch.vectors:
        fill = v.dtype.element_sentinel().item() \
            if isinstance(v.dtype, T.ArrayType) else 0
        vectors.append(ColumnVector(
            grow(v.data, fill), v.dtype,
            None if v.valid is None else grow(v.valid, False),
            v.dictionary))
    rv = torch.zeros(cap, dtype=torch.bool, device=batch.device)
    rv[:batch.capacity] = batch.row_valid_or_true()
    return ColumnBatch(list(batch.names), vectors, rv, cap)


def normalize_valids(batch: ColumnBatch) -> ColumnBatch:
    """Every implicit (None) validity mask and the row mask made explicit
    (``spark_tpu/columnar.py`` ``normalize_valids``): which masks a batch
    carries is part of a stage variant's ``leaf_aux``, so two scan
    batches that differ only in "this column held a null" must not be
    two variants of the per-batch step."""
    ones = None

    def true():
        nonlocal ones
        if ones is None:
            ones = torch.ones(batch.capacity, dtype=torch.bool,
                              device=batch.device)
        return ones

    vectors = [v if v.valid is not None else
               ColumnVector(v.data, v.dtype, true(), v.dictionary)
               for v in batch.vectors]
    rv = batch.row_valid if batch.row_valid is not None else true()
    return ColumnBatch(list(batch.names), vectors, rv, batch.capacity,
                       batch.source)


def slice_rows(batch: ColumnBatch, start: int, stop: int) -> ColumnBatch:
    """Rows ``[start, stop)`` of a host batch, padded to their capacity
    (``spark_tpu/io.py`` ``_slice_rows``)."""
    vectors = [ColumnVector(v.data[start:stop], v.dtype,
                            None if v.valid is None else v.valid[start:stop],
                            v.dictionary) for v in batch.vectors]
    rv = None if batch.row_valid is None else batch.row_valid[start:stop]
    out = ColumnBatch(list(batch.names), vectors, rv, stop - start)
    return pad_to_capacity(out, pad_capacity(stop - start))


def live_prefix(batch: ColumnBatch) -> ColumnBatch:
    """Exactly the live rows of a COMPACTED host batch (capacity = row
    count, no row mask)."""
    n = int(batch.num_rows())
    if n == batch.capacity and batch.row_valid is None:
        return batch
    vectors = [ColumnVector(v.data[:n], v.dtype,
                            None if v.valid is None else v.valid[:n],
                            v.dictionary) for v in batch.vectors]
    return ColumnBatch(list(batch.names), vectors, None, n)


def remap_codes(codes: torch.Tensor, table) -> torch.Tensor:
    """Dictionary codes gathered into a merged code space through a
    monotone ``table[old] -> new``; sentinel-preserving as in the
    reference (``kernels.remap_codes``): codes at or above ``len(table)``
    (a min buffer's INT32_MAX identity) become INT32_MAX and negative
    codes (NULL, a max buffer's identity) pass through."""
    n = len(table)
    if not n:
        return codes
    t = torch.as_tensor(np.asarray(table), dtype=codes.dtype,
                        device=codes.device)
    gathered = t[codes.clamp(0, n - 1).long()]
    hi = torch.tensor(np.iinfo(np.int32).max, dtype=codes.dtype,
                      device=codes.device)
    out = torch.where(codes >= n, hi, gathered)
    return torch.where(codes < 0, codes, out)


def _rle(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run values and int64 lengths of a 1-D host tensor."""
    n = int(data.shape[0])
    if n == 0:
        return data[:0], torch.zeros(0, dtype=torch.int64)
    change = torch.nonzero(data[1:] != data[:-1]).reshape(-1) + 1
    starts = torch.cat([torch.zeros(1, dtype=torch.int64), change])
    ends = torch.cat([change, torch.tensor([n], dtype=torch.int64)])
    return data[starts], ends - starts


def _union_runs(vecs, batches, dtype, dicts) -> Optional[RunColumnVector]:
    """One column of ``union_all`` kept run-coded (``spark_tpu/
    kernels.py`` ``union_all``): when a piece is still an unmaterialized
    run vector, none has NULLs and all share one code space, the run
    tables are concatenated (equal values across a seam are two runs,
    still a valid table).  A dense sibling (the reducer's own share, which
    never crossed the wire) is run-coded here if that halves it at least;
    otherwise None: the dense concatenation."""
    runs = [unmaterialized_runs(v) for v in vecs]
    if not any(r is not None for r in runs) \
            or len({d or () for d in dicts}) != 1:
        return None
    for r, v, b in zip(runs, vecs, batches):
        if (r is None and v.valid is not None) or (
                r is not None and (r.valid is not None
                                   or r.capacity != b.capacity)):
            return None
    tables = []
    for r, v, b in zip(runs, vecs, batches):
        if r is not None:
            tables.append((r.run_values.to(dtype.torch_dtype),
                           r.run_lengths))
            continue
        vals, lens = _rle(v.data.to(dtype.torch_dtype))
        if len(vals) * 2 > b.capacity:
            return None
        tables.append((vals, lens))
    return RunColumnVector(torch.cat([t[0] for t in tables]),
                           torch.cat([t[1] for t in tables]), dtype, None,
                           dicts[0])


def union_all(batches: Sequence[ColumnBatch]) -> ColumnBatch:
    """Concatenate batches of one device (capacity = sum), string columns
    re-encoded onto a merged dictionary (``spark_tpu/kernels.py``
    ``union_all``; identical dictionaries skip the remap)."""
    assert batches
    names = batches[0].names
    capacity = sum(b.capacity for b in batches)
    vectors: List[ColumnVector] = []
    for ci in range(len(names)):
        vecs = [b.vectors[ci] for b in batches]
        dtype = vecs[0].dtype
        dicts = [v.dictionary for v in vecs]
        runs = _union_runs(vecs, batches, dtype, dicts)
        if runs is not None:
            vectors.append(runs)
            continue
        if dtype.is_string or isinstance(dtype, T.BinaryType):
            if len({d or () for d in dicts}) == 1:
                data = torch.cat([v.data for v in vecs])
                dictionary = dicts[0] or ()
            else:
                merged = dicts[0] or ()
                remaps: List[Any] = [None] * len(vecs)
                for i in range(1, len(vecs)):
                    merged, ra, rb = merge_dictionaries(merged,
                                                        dicts[i] or ())
                    for j in range(i):
                        remaps[j] = ra if remaps[j] is None else ra[remaps[j]]
                    remaps[i] = rb
                data = torch.cat([remap_codes(v.data, rm) if rm is not None
                                  else v.data for v, rm in zip(vecs, remaps)])
                dictionary = merged
        else:
            data = torch.cat([v.data.to(vecs[0].data.dtype) for v in vecs])
            dictionary = None
        valid = None
        if any(v.valid is not None for v in vecs):
            valid = torch.cat([
                v.valid if v.valid is not None
                else torch.ones(b.capacity, dtype=torch.bool,
                                device=v.data.device)
                for v, b in zip(vecs, batches)])
        vectors.append(ColumnVector(data, dtype, valid, dictionary))
    rv = torch.cat([b.row_valid_or_true() for b in batches])
    return ColumnBatch(names, vectors, rv, capacity)


class PrebuiltColumn:
    """An already-decoded column (data array + engine type + validity, and
    the sorted dictionary of a string column's codes): the file readers
    hand these to ``from_arrays`` so that no column round-trips through
    Python objects (``spark_tpu/columnar.py`` ``PrebuiltColumn``)."""

    __slots__ = ("data", "dtype", "valid", "dictionary")

    def __init__(self, data: np.ndarray, dtype: T.DataType,
                 valid: Optional[np.ndarray],
                 dictionary: Optional[Tuple[str, ...]] = None):
        self.data = data
        self.dtype = dtype
        self.valid = valid
        self.dictionary = dictionary

    def __len__(self):
        return len(self.data)


def _ingest_column(raw: Any, cap: int, dtype: Optional[T.DataType]
                   ) -> Tuple[np.ndarray, T.DataType, Optional[np.ndarray],
                              Optional[Tuple[str, ...]]]:
    """One host column (list/ndarray) → (padded numpy data, engine type,
    validity or None, dictionary or None), as the JAX package ingests it."""
    dictionary: Optional[Tuple[str, ...]] = None
    valid: Optional[np.ndarray] = None

    if isinstance(raw, PrebuiltColumn):
        data, valid = raw.data, raw.valid
        if not data.flags.writeable:        # a view of arrow's buffers
            data = data.copy()
        if len(data) < cap:
            data = np.concatenate([data, np.zeros(cap - len(data),
                                                  data.dtype)])
            if valid is not None:
                valid = np.concatenate([valid, np.zeros(cap - len(raw),
                                                        bool)])
        return np.ascontiguousarray(data), raw.dtype, valid, raw.dictionary

    if isinstance(raw, np.ndarray) and raw.ndim == 2:
        # a fixed-width array column (ML feature vectors): every slot live
        dt = dtype if isinstance(dtype, T.ArrayType) \
            else T.ArrayType(T.float64)
        data = raw.astype(dt.element_type.np_dtype)
        if len(data) < cap:
            pad = np.full((cap - len(data),) + data.shape[1:],
                          dt.element_sentinel(), data.dtype)
            data = np.concatenate([data, pad])
        return np.ascontiguousarray(data), dt, None, None
    if not isinstance(raw, np.ndarray) and len(raw) and isinstance(
            next((v for v in raw if v is not None), None),
            (list, tuple, np.ndarray)):
        return _ingest_lists(raw, cap, dtype)
    if isinstance(raw, np.ndarray) and raw.dtype.kind not in ("O", "U", "S"):
        if raw.dtype.kind == "M":  # datetime64
            if isinstance(dtype, T.DateType):
                data = raw.astype("datetime64[D]").astype(np.int32)
                dt = dtype
            else:
                data = raw.astype("datetime64[us]").astype(np.int64)
                dt = dtype or T.timestamp
        elif isinstance(dtype, T.DecimalType):
            dt = dtype
            fl = raw.astype(np.float64)
            nan = np.isnan(fl)
            data = np.round(np.where(nan, 0.0, fl) * 10 ** dt.scale).astype(np.int64)
            if nan.any():
                valid = ~nan
        elif raw.dtype.kind == "f":
            dt = dtype or T.np_dtype_to_engine(raw.dtype)
            nan = np.isnan(raw)
            data = np.where(nan, 0.0, raw).astype(dt.np_dtype)
            if nan.any():
                valid = ~nan
        else:
            dt = dtype or T.np_dtype_to_engine(raw.dtype)
            data = raw.astype(dt.np_dtype)
    else:
        values = list(raw)
        nulls = np.fromiter((v is None or (isinstance(v, float) and np.isnan(v)) for v in values),
                            dtype=bool, count=len(values))
        sample = next((v for v in values if v is not None), None)
        dt = dtype or (T.infer_type(sample) if sample is not None else T.null_type)
        if dt.is_string or isinstance(dt, T.BinaryType):
            # binary keeps bytes in the dictionary; strings coerce via str()
            conv = (lambda v: v) if isinstance(dt, T.BinaryType) else str
            codes, dictionary = encode_strings(
                [None if nulls[i] else conv(values[i]) for i in range(len(values))])
            data = np.where(codes < 0, 0, codes).astype(np.int32)
            if (codes < 0).any():
                valid = codes >= 0
        elif isinstance(dt, T.DecimalType):
            scale = 10 ** dt.scale
            data = np.fromiter(
                (0 if nulls[i] else int(round(float(values[i]) * scale)) for i in range(len(values))),
                dtype=np.int64, count=len(values))
            if nulls.any():
                valid = ~nulls
        elif isinstance(dt, T.DateType):
            data = np.fromiter(
                (0 if nulls[i] else np.datetime64(values[i], "D").astype(np.int32) for i in range(len(values))),
                dtype=np.int32, count=len(values))
            if nulls.any():
                valid = ~nulls
        elif isinstance(dt, T.TimestampType):
            data = np.fromiter(
                (0 if nulls[i] else np.datetime64(values[i], "us").astype(np.int64) for i in range(len(values))),
                dtype=np.int64, count=len(values))
            if nulls.any():
                valid = ~nulls
        else:
            data = np.fromiter(
                (dt.null_sentinel() if nulls[i] else values[i] for i in range(len(values))),
                dtype=dt.np_dtype, count=len(values))
            if nulls.any():
                valid = ~nulls

    if len(data) < cap:
        pad = np.zeros(cap - len(data), dtype=data.dtype)
        data = np.concatenate([data, pad])
        if valid is not None:
            valid = np.concatenate([valid, np.zeros(cap - len(valid), bool)])
    return np.ascontiguousarray(data), dt, valid, dictionary


def _ingest_lists(raw: Sequence[Any], cap: int, dtype: Optional[T.DataType]
                  ) -> Tuple[np.ndarray, T.DataType, Optional[np.ndarray],
                             None]:
    """A column of Python lists (None = a NULL array) as a
    ``(cap, max_len)`` plane: ragged tails, None elements and padding rows
    hold the element sentinel, as ``spark_tpu/columnar.py`` ingests them.
    Elements are int64 when every one is an integer, else float64."""
    values = [[] if v is None else list(v) for v in raw]
    width = max((len(v) for v in values), default=1) or 1
    nulls = np.fromiter((v is None for v in raw), bool, count=len(values))
    if isinstance(dtype, T.ArrayType):
        dt = dtype
    else:
        all_int = all(isinstance(x, (int, np.integer))
                      and not isinstance(x, bool)
                      for v in values for x in v if x is not None)
        dt = T.ArrayType(T.int64 if all_int and any(len(v) for v in values)
                         else T.float64)
    et = dt.element_type
    sent = np.nan if et.is_fractional else dt.element_sentinel()
    mat = np.full((cap, width), sent, et.np_dtype)
    for i, v in enumerate(values):
        for j, x in enumerate(v):
            if x is not None and not (isinstance(x, float) and np.isnan(x)):
                mat[i, j] = x
    valid = None
    if nulls.any():
        valid = np.zeros(cap, bool)
        valid[:len(values)] = ~nulls
    return mat, dt, valid, None
