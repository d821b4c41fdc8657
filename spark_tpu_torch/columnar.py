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
  op on strings is an integer op.

Filtering does NOT compact (it ANDs ``row_valid``); ``compact`` is an
explicit operator.  ``ColumnBatch.from_numpy_parts`` builds a batch from
plain numpy parts, which is how batches of the JAX package cross over.
"""

from __future__ import annotations

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


def _move(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    return None if t is None else t.to(device)


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
    def to_device(self, device) -> "ColumnVector":
        return ColumnVector(self.data.to(device), self.dtype,
                            _move(self.valid, device), self.dictionary)

    def to_host(self) -> "ColumnVector":
        return self.to_device("cpu")

    def to_pylist(self, row_valid: Optional[torch.Tensor] = None) -> List[Any]:
        """Decode to Python objects (None for NULL); for collect()."""
        data = self.data.cpu().numpy()
        valid = np.ones(len(data), bool) if self.valid is None \
            else self.valid.cpu().numpy()
        if row_valid is not None:
            sel = row_valid.cpu().numpy()
            data, valid = data[sel], valid[sel]
        out: List[Any] = []
        dt = self.dtype
        for i in range(len(data)):
            if not valid[i]:
                out.append(None)
            elif dt.is_string or isinstance(dt, T.BinaryType):
                code = int(data[i])
                out.append(self.dictionary[code] if (self.dictionary is not None and 0 <= code < len(self.dictionary)) else None)
            elif isinstance(dt, T.BooleanType):
                out.append(bool(data[i]))
            elif isinstance(dt, T.DecimalType):
                out.append(float(data[i]) / (10 ** dt.scale))
            elif isinstance(dt, T.DateType):
                out.append(np.datetime64(int(data[i]), "D").astype("datetime64[D]").item())
            elif isinstance(dt, T.TimestampType):
                out.append(np.datetime64(int(data[i]), "us").item())
            elif dt.is_fractional:
                out.append(float(data[i]))
            else:
                out.append(int(data[i]))
        return out


class ColumnBatch:
    """A fixed-capacity batch of columns plus a row-existence mask."""

    __slots__ = ("names", "vectors", "row_valid", "capacity")

    def __init__(self, names: Sequence[str], vectors: Sequence[ColumnVector],
                 row_valid: Optional[torch.Tensor], capacity: int):
        if len(names) != len(vectors):
            raise ValueError(f"{len(names)} names for {len(vectors)} columns")
        self.names = list(names)
        self.vectors = list(vectors)
        self.row_valid = row_valid
        self.capacity = capacity

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
            return self.vectors[0].data.device
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
    def to_device(self, device) -> "ColumnBatch":
        return ColumnBatch(self.names, [v.to_device(device) for v in self.vectors],
                           _move(self.row_valid, device), self.capacity)

    def to_host(self) -> "ColumnBatch":
        return self.to_device("cpu")

    # -- output -----------------------------------------------------------
    def to_pylist(self) -> List[tuple]:
        """Rows as tuples (collect() decode path)."""
        rv = self.row_valid
        cols = [v.to_pylist(rv) for v in self.vectors]
        if not cols:
            n = int(rv.sum()) if rv is not None else self.capacity
            return [() for _ in range(n)]
        return list(zip(*cols))

    def __repr__(self) -> str:  # pragma: no cover
        return f"ColumnBatch({self.schema.simpleString()}, capacity={self.capacity})"


def _ingest_column(raw: Any, cap: int, dtype: Optional[T.DataType]
                   ) -> Tuple[np.ndarray, T.DataType, Optional[np.ndarray],
                              Optional[Tuple[str, ...]]]:
    """One host column (list/ndarray) → (padded numpy data, engine type,
    validity or None, dictionary or None), as the JAX package ingests it."""
    dictionary: Optional[Tuple[str, ...]] = None
    valid: Optional[np.ndarray] = None

    if isinstance(raw, np.ndarray) and raw.ndim != 1:
        raise NotImplementedError(
            "array (2-D) columns come with the TPC-DS breadth slice")
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
        if any(isinstance(v, (list, tuple, np.ndarray)) for v in values):
            raise NotImplementedError(
                "array columns come with the TPC-DS breadth slice")
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
