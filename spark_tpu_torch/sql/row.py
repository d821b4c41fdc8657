"""Row: collect() result type (pyspark ``Row`` analog — tuple with names)."""

from __future__ import annotations

import functools
from typing import Any, Iterable, List, Sequence


class Row(tuple):
    def __new__(cls, values: Sequence[Any], fields: Sequence[str]):
        return super().__new__(cls, values)

    def __init__(self, values: Sequence[Any], fields: Sequence[str]):
        object.__setattr__(self, "_fields_", list(fields))

    @staticmethod
    def _many(rows: Iterable[Sequence[Any]], fields: Sequence[str]
              ) -> List["Row"]:
        """Rows of one result (``collect()``): instances of a ``Row``
        subclass that holds the field names once, made without a field
        list or an ``__init__`` per row (which were most of a large
        result's decode time).  They compare, print, index and pickle
        as ``Row``s."""
        make = functools.partial(tuple.__new__, _row_class(tuple(fields)))
        return list(map(make, rows))

    def __reduce__(self):
        return (Row, (tuple(self), self.__fields__))

    @property
    def __fields__(self) -> List[str]:
        return list(object.__getattribute__(self, "_fields_"))

    def __getattr__(self, name: str) -> Any:
        fields = object.__getattribute__(self, "_fields_")
        try:
            return self[fields.index(name)]
        except ValueError:
            raise AttributeError(name)

    def __getitem__(self, key):
        if isinstance(key, str):
            fields = object.__getattribute__(self, "_fields_")
            return tuple.__getitem__(self, fields.index(key))
        return tuple.__getitem__(self, key)

    def asDict(self) -> dict:
        return dict(zip(object.__getattribute__(self, "_fields_"), self))

    def __repr__(self):
        fields = object.__getattribute__(self, "_fields_")
        inner = ", ".join(f"{n}={v!r}" for n, v in zip(fields, self))
        return f"Row({inner})"


@functools.lru_cache(maxsize=256)
def _row_class(fields: tuple) -> type:
    """The ``Row`` subclass of one field tuple: its names live on the
    class, its instances hold only their values."""
    return type("Row", (Row,), {"__slots__": (), "_fields_": list(fields),
                                "__module__": __name__})
