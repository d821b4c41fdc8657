"""Tiny shared helpers between the Column API and logical plans (avoids an
import cycle between sql.column and sql.logical)."""

from __future__ import annotations

from typing import Optional

from .expressions import Expression


class _SortOrderHandle:
    """Carried by Column.asc()/desc() until the Sort node is built."""

    def __init__(self, expr: Expression, ascending: bool, nulls_first: Optional[bool]):
        self.expr = expr
        self.ascending = ascending
        self.nulls_first = nulls_first


def sort_order(expr: Expression, ascending: bool, nulls_first: Optional[bool]):
    return _SortOrderHandle(expr, ascending, nulls_first)
