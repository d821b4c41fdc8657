"""Row: collect() result type (pyspark ``Row`` analog — tuple with names)."""

from __future__ import annotations

from typing import Any, List, Sequence


class Row(tuple):
    def __new__(cls, values: Sequence[Any], fields: Sequence[str]):
        return super().__new__(cls, values)

    def __init__(self, values: Sequence[Any], fields: Sequence[str]):
        object.__setattr__(self, "_fields_", list(fields))

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
