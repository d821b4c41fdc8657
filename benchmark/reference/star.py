"""The star join of the store channel's reporting texts, in NumPy.

store_sales joined to date_dim and item by their surrogate keys (each
key a lookup by ``searchsorted``, so the dimension tables may come in
any key order), filtered, grouped and summed.  Sums are exact integer
cents; ``precision="float64"`` (or ``"float32"``) sums the prices as
doubles (or floats) instead, the lower precisions that the benchmark's
control puts in the program's place.  The answer is the server's JSON
form: rows of lists, a decimal sum as ``cents / 100.0``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

PRECISIONS = ("exact", "float64", "float32")


def _lookup(keys: np.ndarray, table_keys: np.ndarray):
    """Row of ``table_keys`` for each of ``keys`` (-1 where absent)."""
    n = len(table_keys)
    first = table_keys[0] if n else 0
    if n and (table_keys == first + np.arange(n)).all():
        rows = keys - first                # dense keys: an offset
        return np.where((rows >= 0) & (rows < n), rows, -1)
    order = np.argsort(table_keys, kind="stable")
    pos = np.searchsorted(table_keys, keys, sorter=order)
    pos = np.minimum(pos, len(table_keys) - 1)
    rows = order[pos]
    return np.where(table_keys[rows] == keys, rows, -1)


def star_rows(tables, date_filter: Dict[str, int],
              item_filter: Dict[str, int]):
    """(date_dim row, item row, store_sales row) of every store_sales row
    whose date and item pass the equality filters."""
    ss, dd, it = tables["store_sales"], tables["date_dim"], tables["item"]
    d_ok = np.ones(len(dd["d_date_sk"]), bool)
    for col, v in date_filter.items():
        d_ok &= dd[col] == v
    i_ok = np.ones(len(it["i_item_sk"]), bool)
    for col, v in item_filter.items():
        i_ok &= it[col] == v
    d = _lookup(ss["ss_sold_date_sk"], dd["d_date_sk"])
    i = _lookup(ss["ss_item_sk"], it["i_item_sk"])
    keep = (d >= 0) & (i >= 0)
    keep[keep] &= d_ok[d[keep]] & i_ok[i[keep]]
    s = np.flatnonzero(keep)
    return d[s], i[s], s


def grouped_sums(keys: Sequence[np.ndarray], cents: np.ndarray,
                 precision: str) -> List[tuple]:
    """[(key values..., sum)] per distinct key tuple; the sum is exact
    cents as a float of dollars, or a float64 or float32 sum of dollars."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if len(cents) == 0:
        return []
    codes, uniques = [], []
    for k in keys:
        u, inv = np.unique(k, return_inverse=True)
        uniques.append(u)
        codes.append(inv.astype(np.int64))
    groups, inv = np.unique(np.stack(codes, axis=1), axis=0,
                            return_inverse=True)
    inv = inv.reshape(-1)
    if precision == "exact":
        total = np.zeros(len(groups), np.int64)
        np.add.at(total, inv, cents.astype(np.int64))
        sums = [int(c) / 100.0 for c in total.tolist()]
    elif precision == "float64":
        dollars = cents.astype(np.float64) / 100.0
        sums = np.bincount(inv, weights=dollars,
                           minlength=len(groups)).tolist()
    else:
        dollars = (cents.astype(np.float64) / 100.0).astype(np.float32)
        total32 = np.zeros(len(groups), np.float32)
        np.add.at(total32, inv, dollars)
        sums = total32.astype(np.float64).tolist()
    out = []
    for g, s in zip(groups.tolist(), sums):
        out.append(tuple(u[c].item() for u, c in zip(uniques, g)) + (s,))
    return out


def report(tables, *, date_filter, item_filter, date_keys, item_keys,
           order: Callable[[tuple], tuple], precision: str,
           limit: int = 100) -> List[list]:
    """GROUP BY the date_dim keys then the item keys, SUM of
    ss_ext_sales_price, ORDER BY ``order`` (a sort key of the row
    (keys..., sum)), LIMIT ``limit``."""
    dd, it = tables["date_dim"], tables["item"]
    d, i, s = star_rows(tables, date_filter, item_filter)
    keys = [dd[c][d] for c in date_keys] + [it[c][i] for c in item_keys]
    cents = tables["store_sales"]["ss_ext_sales_price"][s]
    rows = sorted(grouped_sums(keys, cents, precision), key=order)
    return [list(r) for r in rows[:limit]]
