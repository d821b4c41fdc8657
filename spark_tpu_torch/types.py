"""Data type system of the PyTorch engine.

A copy of ``spark_tpu/types.py`` (the Catalyst type hierarchy, reference
``sql/catalyst/src/main/scala/org/apache/spark/sql/types/``) with one
addition: every type carries a ``torch_dtype`` beside its ``np_dtype``.
Decimals are unscaled int64, strings/binary and dates are int32 codes,
timestamps int64 microseconds, exactly as in the JAX package, so batches
cross between the two packages as plain numpy parts
(see ``spark_tpu_torch/columnar.py``).

Nullability is NOT encoded in the data arrays; validity bitmasks travel next
to every column vector (Arrow-style), unlike the reference's UnsafeRow null
bitset (``catalyst/.../expressions/UnsafeRow.java:62``) which is row-oriented.
"""

from __future__ import annotations

import datetime
import decimal
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "DataType", "NumericType", "IntegralType", "FractionalType",
    "NullType", "BooleanType", "ByteType", "ShortType", "IntegerType",
    "LongType", "FloatType", "DoubleType", "StringType", "BinaryType",
    "DateType", "TimestampType", "DecimalType", "ArrayType", "StructField",
    "StructType",
    "null_type", "boolean", "int8", "int16", "int32", "int64",
    "float32", "float64", "string", "binary", "date", "timestamp",
]


class DataType:
    """Base of the type hierarchy (reference ``types/DataType.scala``)."""

    #: numpy dtype of the device/host representation of this type.
    np_dtype: np.dtype = np.dtype(np.int32)
    #: name used in schema strings and SQL (``typeName`` in the reference).
    name: str = "data"

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return self.name

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self).__name__)

    # -- classification helpers -------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return isinstance(self, NumericType)

    @property
    def is_integral(self) -> bool:
        return isinstance(self, IntegralType)

    @property
    def is_fractional(self) -> bool:
        return isinstance(self, FractionalType)

    @property
    def is_string(self) -> bool:
        return isinstance(self, StringType)

    @property
    def is_orderable(self) -> bool:
        return True

    def simpleString(self) -> str:
        return self.name

    @property
    def torch_dtype(self) -> torch.dtype:
        """torch dtype of the device representation (from ``np_dtype``)."""
        return np_to_torch_dtype(self.np_dtype)

    # sentinel stored in data slots whose validity bit is off; value is
    # irrelevant for semantics but picking min/0 keeps sorts deterministic.
    def null_sentinel(self) -> Any:
        return np.zeros((), self.np_dtype).item()


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class FractionalType(NumericType):
    pass


class NullType(DataType):
    name = "void"
    np_dtype = np.dtype(np.int8)


class BooleanType(DataType):
    name = "boolean"
    np_dtype = np.dtype(np.bool_)


class ByteType(IntegralType):
    name = "tinyint"
    np_dtype = np.dtype(np.int8)


class ShortType(IntegralType):
    name = "smallint"
    np_dtype = np.dtype(np.int16)


class IntegerType(IntegralType):
    name = "int"
    np_dtype = np.dtype(np.int32)


class LongType(IntegralType):
    name = "bigint"
    np_dtype = np.dtype(np.int64)


class FloatType(FractionalType):
    name = "float"
    np_dtype = np.dtype(np.float32)


class DoubleType(FractionalType):
    name = "double"
    np_dtype = np.dtype(np.float64)


class StringType(DataType):
    """Strings are dictionary codes on device (int32 into a host-side,
    lexicographically sorted dictionary) — the TPU answer to
    ``unsafe/types/UTF8String.java``: code order == string order, so
    comparisons/sorts/joins are integer ops on the MXU-friendly path."""

    name = "string"
    np_dtype = np.dtype(np.int32)


class BinaryType(DataType):
    name = "binary"
    np_dtype = np.dtype(np.int32)  # dictionary codes, like strings


class DateType(DataType):
    """Days since epoch, int32 (reference ``types/DateType.scala``).

    Deliberately NOT a NumericType: date arithmetic has its own coercion
    rules (date ± interval, date vs timestamp comparison)."""

    name = "date"
    np_dtype = np.dtype(np.int32)


class TimestampType(DataType):
    """Microseconds since epoch, int64 (reference ``types/TimestampType.scala``)."""

    name = "timestamp"
    np_dtype = np.dtype(np.int64)


class DecimalType(FractionalType):
    """Fixed-precision decimal, stored as scaled int64 (precision<=18).

    Reference ``types/DecimalType.scala``; arithmetic precision propagation
    follows ``analysis/DecimalPrecision.scala`` in spirit.
    """

    name = "decimal"
    np_dtype = np.dtype(np.int64)
    MAX_PRECISION = 18

    def __init__(self, precision: int = 10, scale: int = 0):
        if precision > self.MAX_PRECISION:
            # int64-backed; wider decimals degrade to float64 at ingest.
            precision = self.MAX_PRECISION
        self.precision = precision
        self.scale = scale

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, DecimalType)
            and other.precision == self.precision
            and other.scale == self.scale
        )

    def __hash__(self) -> int:
        return hash(("decimal", self.precision, self.scale))

    def simpleString(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    __repr__ = simpleString


class ArrayType(DataType):
    """Array column: fixed-width device layout ``(capacity, max_len)`` in
    the ELEMENT dtype, trailing slots padded with a per-dtype sentinel
    (string code -1, float NaN, int64 min).  Deviations from the
    reference, documented: NULL elements inside arrays and arrays
    containing the sentinel value itself are not representable; a NULL
    array and an empty array are both "no elements" (size() returns 0)
    unless the row mask marks the row NULL."""

    name = "array"

    def __init__(self, element_type: DataType, contains_null: bool = True):
        self.element_type = element_type
        self.contains_null = contains_null

    @property
    def np_dtype(self):
        return self.element_type.np_dtype

    @property
    def is_string(self):
        return False

    def element_sentinel(self):
        ed = self.element_type
        if ed.is_string:
            return np.int32(-1)
        if ed.is_fractional:
            return np.asarray(np.nan, ed.np_dtype)
        if np.dtype(ed.np_dtype) == np.bool_:
            raise ValueError(
                "arrays of boolean have no spare sentinel value; cast the "
                "elements to int first")
        return np.asarray(np.iinfo(ed.np_dtype).min, ed.np_dtype)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ArrayType) and other.element_type == self.element_type

    def __hash__(self) -> int:
        return hash(("array", self.element_type))

    def simpleString(self) -> str:
        return f"array<{self.element_type.simpleString()}>"

    __repr__ = simpleString


class StructField:
    def __init__(self, name: str, dataType: DataType, nullable: bool = True,
                 metadata: Optional[dict] = None):
        self.name = name
        self.dataType = dataType
        self.nullable = nullable
        self.metadata = metadata or {}

    def __repr__(self) -> str:
        return f"StructField({self.name},{self.dataType!r},{self.nullable})"

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, StructField)
            and other.name == self.name
            and other.dataType == self.dataType
            and other.nullable == self.nullable
        )

    def __hash__(self) -> int:
        return hash((self.name, self.dataType, self.nullable))


class MapType(DataType):
    """Map column type (``types/MapType.scala``).

    Device layout is the PAIR-OF-PLANES design from docs/DECISIONS.md:
    a map value is its (keys, values) ArrayType planes.  Map columns are
    object-layer values (exactly the reference, where maps never got a
    Tungsten-vectorized layout): the optimizer rewrites every consumer
    (map_keys/map_values/element_at/size) into flat array/scalar
    expressions, and only a COLLECTED map column materializes — as the
    two planes, zipped into Python dicts host-side."""

    name = "map"

    def __init__(self, key_type: DataType, value_type: DataType,
                 value_contains_null: bool = True):
        self.key_type = key_type
        self.value_type = value_type
        self.value_contains_null = value_contains_null

    @property
    def np_dtype(self):
        raise TypeError(
            "map columns have no single device dtype; consume them with "
            "map_keys/map_values/element_at or collect()")

    @property
    def is_string(self):
        return False

    def simpleString(self) -> str:
        return (f"map<{self.key_type.simpleString()},"
                f"{self.value_type.simpleString()}>")

    def __repr__(self):
        return f"MapType({self.key_type!r}, {self.value_type!r})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, MapType) \
            and other.key_type == self.key_type \
            and other.value_type == self.value_type

    def __hash__(self) -> int:
        return hash(("map", self.key_type, self.value_type))


class StructType(DataType):
    """Schema: ordered fields (reference ``types/StructType.scala``)."""

    name = "struct"

    def __init__(self, fields: Optional[Sequence[StructField]] = None):
        self.fields: List[StructField] = list(fields or [])

    def add(self, name: str, dataType: DataType, nullable: bool = True) -> "StructType":
        self.fields.append(StructField(name, dataType, nullable))
        return self

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    fieldNames = names

    def __iter__(self) -> Iterator[StructField]:
        return iter(self.fields)

    def __len__(self) -> int:
        return len(self.fields)

    def __getitem__(self, key):
        if isinstance(key, str):
            for f in self.fields:
                if f.name == key:
                    return f
            raise KeyError(key)
        return self.fields[key]

    def field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, StructType) and other.fields == self.fields

    def __hash__(self) -> int:
        return hash(tuple(self.fields))

    def simpleString(self) -> str:
        inner = ",".join(f"{f.name}:{f.dataType.simpleString()}" for f in self.fields)
        return f"struct<{inner}>"

    __repr__ = simpleString


# ---------------------------------------------------------------------------
# Singletons
# ---------------------------------------------------------------------------
null_type = NullType()
boolean = BooleanType()
int8 = ByteType()
int16 = ShortType()
int32 = IntegerType()
int64 = LongType()
float32 = FloatType()
float64 = DoubleType()
string = StringType()
binary = BinaryType()
date = DateType()
timestamp = TimestampType()

_BY_NAME = {
    "void": null_type, "null": null_type,
    "boolean": boolean, "bool": boolean,
    "tinyint": int8, "byte": int8,
    "smallint": int16, "short": int16,
    "int": int32, "integer": int32,
    "bigint": int64, "long": int64,
    "float": float32, "real": float32,
    "double": float64,
    "string": string, "varchar": string, "char": string, "text": string,
    "binary": binary,
    "date": date,
    "timestamp": timestamp,
    "decimal": DecimalType(10, 0),
}


def type_for_name(name: str) -> DataType:
    """Parse a simple type name (``CatalystSqlParser.parseDataType`` analog)."""
    key = name.strip().lower()
    if key.startswith("decimal(") and key.endswith(")"):
        p, s = key[len("decimal("):-1].split(",")
        return DecimalType(int(p), int(s))
    if key in _BY_NAME:
        return _BY_NAME[key]
    raise ValueError(f"unknown data type: {name}")


_NUMERIC_WIDENING: List[DataType] = [int8, int16, int32, int64, float32, float64]


def numeric_promote(a: DataType, b: DataType) -> DataType:
    """Tightest common numeric type (``TypeCoercion.findTightestCommonType``)."""
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        # decimal op decimal → widened decimal; decimal op fractional → double
        if isinstance(a, DecimalType) and isinstance(b, DecimalType):
            scale = max(a.scale, b.scale)
            intd = max(a.precision - a.scale, b.precision - b.scale)
            return DecimalType(min(intd + scale, DecimalType.MAX_PRECISION), scale)
        other = b if isinstance(a, DecimalType) else a
        if other.is_integral:
            return a if isinstance(a, DecimalType) else b
        return float64
    ia = _NUMERIC_WIDENING.index(a) if a in _NUMERIC_WIDENING else None
    ib = _NUMERIC_WIDENING.index(b) if b in _NUMERIC_WIDENING else None
    if ia is None or ib is None:
        raise TypeError(f"cannot promote {a} and {b}")
    out = _NUMERIC_WIDENING[max(ia, ib)]
    # int64 + float32 → float64 to avoid precision loss (Spark: DoubleType)
    if {a, b} == {int64, float32}:
        return float64
    return out


def common_type(a: DataType, b: DataType) -> Optional[DataType]:
    """Common type for comparisons/UNION/CASE branches (TypeCoercion)."""
    if a == b:
        return a
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    if {type(a), type(b)} == {DateType, TimestampType}:
        return timestamp
    if a.is_numeric and b.is_numeric:
        return numeric_promote(a, b)
    if a.is_string and b.is_numeric:
        return float64
    if b.is_string and a.is_numeric:
        return float64
    if a.is_string and isinstance(b, (DateType, TimestampType)):
        return b
    if b.is_string and isinstance(a, (DateType, TimestampType)):
        return a
    return None


def infer_type(value: Any) -> DataType:
    """Infer the engine type of a Python scalar (``ScalaReflection`` analog)."""
    if value is None:
        return null_type
    if isinstance(value, bool) or isinstance(value, np.bool_):
        return boolean
    if isinstance(value, (int, np.integer)):
        if isinstance(value, np.integer) and np.dtype(type(value)).itemsize <= 4:
            return int32
        return int64 if abs(int(value)) > 2**31 - 1 else int32
    if isinstance(value, (float, np.floating)):
        return float64
    if isinstance(value, (str, np.str_)):
        return string
    if isinstance(value, (bytes, np.bytes_)):
        return binary
    if isinstance(value, decimal.Decimal):
        sign, digits, exponent = value.as_tuple()
        scale = max(-exponent, 0)
        return DecimalType(min(len(digits), DecimalType.MAX_PRECISION), scale)
    if isinstance(value, datetime.datetime):
        return timestamp
    if isinstance(value, datetime.date):
        return date
    if isinstance(value, (list, tuple, np.ndarray)):
        elem = infer_type(value[0]) if len(value) else null_type
        return ArrayType(elem)
    raise TypeError(f"cannot infer type for {value!r} ({type(value)})")


_TORCH_BY_NP = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def np_to_torch_dtype(dt) -> torch.dtype:
    """torch counterpart of a numpy dtype (the engine's fixed-width set)."""
    try:
        return _TORCH_BY_NP[np.dtype(dt)]
    except KeyError:
        raise TypeError(f"no torch dtype for numpy dtype {dt}") from None


def torch_to_np_dtype(dt: torch.dtype) -> np.dtype:
    for k, v in _TORCH_BY_NP.items():
        if v == dt:
            return k
    raise TypeError(f"no numpy dtype for torch dtype {dt}")


def np_dtype_to_engine(dt: np.dtype) -> DataType:
    """Map a numpy dtype to an engine DataType (ingest path)."""
    dt = np.dtype(dt)
    if dt == np.bool_:
        return boolean
    if dt.kind == "i":
        return {1: int8, 2: int16, 4: int32, 8: int64}[dt.itemsize]
    if dt.kind == "u":
        return {1: int16, 2: int32, 4: int64, 8: int64}[dt.itemsize]
    if dt.kind == "f":
        return float32 if dt.itemsize <= 4 else float64
    if dt.kind in ("U", "S", "O"):
        return string
    if dt.kind == "M":  # datetime64
        return timestamp
    raise TypeError(f"unsupported numpy dtype {dt}")
