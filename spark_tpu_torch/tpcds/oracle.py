"""Oracle-comparison helpers for the TPC-DS harness (the port's copy of
``spark_tpu/tpcds/oracle.py``): the sqlite dialect rewrite, value
normalization, the fact-table list, and ``load_sqlite``, which loads the
generator's tables into sqlite without pandas."""

from __future__ import annotations

import math
import re

import numpy as np

__all__ = ["FACT_TABLES", "sqlite_text", "norm_value", "row_key",
           "load_sqlite"]

FACT_TABLES = {"store_sales", "catalog_sales", "web_sales",
               "store_returns", "catalog_returns", "web_returns",
               "inventory"}


def sqlite_text(sql: str) -> str:
    """Adapt engine SQL to sqlite: expand STDDEV_SAMP via moments."""
    return re.sub(
        r"STDDEV_SAMP\((\w+)\)",
        r"(CASE WHEN count(\1) > 1 THEN "
        r"sqrt(max(sum(\1*\1*1.0) - count(\1)*avg(\1)*avg(\1), 0)"
        r" / (count(\1) - 1)) ELSE NULL END)",
        sql, flags=re.IGNORECASE)


def norm_value(v):
    """Engine/sqlite value → comparable canonical form."""
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        f = float(v)
        return None if math.isnan(f) else round(f, 6)
    return str(v)


def row_key(row):
    """NULL-stable sort key for order-insensitive row comparison."""
    return tuple("\0" if x is None else str(x) for x in row)


def _sql_type(col: np.ndarray) -> str:
    """The column type pandas' ``to_sql`` declares for a column in sqlite
    (its affinity decides how sqlite compares the column with
    literals)."""
    if col.dtype.kind in "iub":
        return "INTEGER"
    if col.dtype.kind == "f":
        return "REAL"
    kinds = {type(v) for v in col if v is not None and v == v}
    if kinds and all(issubclass(k, (int, np.integer)) for k in kinds):
        return "INTEGER"
    if kinds and all(issubclass(k, (float, np.floating)) for k in kinds):
        return "REAL"
    return "TEXT"


def _py(v):
    """A value sqlite can bind: numpy scalars as Python's, NaN as NULL."""
    if v is None:
        return None
    if isinstance(v, (np.integer, np.bool_)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        f = float(v)
        return None if math.isnan(f) else f
    return v


def load_sqlite(con, tables) -> None:
    """Load ``{table: {column: ndarray}}`` (``datagen.generate``) into a
    sqlite connection, one ``executemany`` per table, with the column
    types pandas' ``to_sql`` would declare."""
    for name, cols in tables.items():
        names = list(cols)
        decl = ", ".join(f'"{c}" {_sql_type(cols[c])}' for c in names)
        con.execute(f'CREATE TABLE "{name}" ({decl})')
        data = [[_py(v) for v in cols[c].tolist()] for c in names]
        marks = ", ".join("?" for _ in names)
        con.executemany(f'INSERT INTO "{name}" VALUES ({marks})',
                        zip(*data))
    con.commit()
