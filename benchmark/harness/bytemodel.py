"""Bytes of the work a star text asks of an aggregate or a shuffle,
counted from the generated tables: each live row's columns at their SQL
widths (a string at its UTF-8 length), read once, and each result row
written once.  What a kernel reads beyond that (masked capacity, padded
planes) is not the work, so a roofline share built on these counts
shows it as lost time."""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

FIXED_WIDTH = {"int": 4, "bigint": 8, "double": 8, "decimal(7,2)": 8}
#: SUM of a decimal(7,2) is a decimal(17,2): one int64
SUM_WIDTH = 8


def column_bytes(values: np.ndarray, sql_type: str) -> int:
    if sql_type == "string":
        return int(np.char.str_len(np.char.encode(values.astype(str)))
                   .sum())
    return FIXED_WIDTH[sql_type] * len(values)


def rows_bytes(table: Dict[str, np.ndarray], rows: np.ndarray,
               columns: Iterable[str], schema: Dict[str, str]) -> int:
    """Bytes of ``columns`` over the rows ``rows`` of ``table``."""
    return sum(column_bytes(table[c][rows], schema[c]) for c in columns)


def star_aggregate_bytes(tables, schema, params):
    """(read, written) of the grouped SUM of a star text: its live input
    rows' keys and ``ss_ext_sales_price``, read once, and its groups,
    written once."""
    from reference.star import grouped_sums, star_rows
    dd, it, ss = tables["date_dim"], tables["item"], tables["store_sales"]
    d, i, s = star_rows(tables, params["date_filter"], params["item_filter"])
    read = (rows_bytes(dd, d, params["date_keys"], schema["date_dim"])
            + rows_bytes(it, i, params["item_keys"], schema["item"])
            + rows_bytes(ss, s, ["ss_ext_sales_price"], schema["store_sales"]))
    keys = [dd[c][d] for c in params["date_keys"]] + \
        [it[c][i] for c in params["item_keys"]]
    groups = grouped_sums(keys, ss["ss_ext_sales_price"][s], "exact")
    written = 0
    for g in groups:
        for v, t in zip(g[:-1], [schema["date_dim"][c]
                                 for c in params["date_keys"]]
                        + [schema["item"][c] for c in params["item_keys"]]):
            written += len(str(v).encode()) if t == "string" \
                else FIXED_WIDTH[t]
        written += SUM_WIDTH
    return read, written


def star_shuffle_bytes(tables, schema, params) -> int:
    """The rows a star text's shuffled joins repartition, as the port
    plans them (date_dim joined to store_sales, then item): the date
    side after its filter, every store_sales row, the first join's rows
    whose date passes, the item side after its filter, and one partial
    row per group to the aggregate."""
    from reference.star import star_rows
    dd, it, ss = tables["date_dim"], tables["item"], tables["store_sales"]
    sd, si, sss = schema["date_dim"], schema["item"], schema["store_sales"]
    d_ok = np.ones(len(dd["d_date_sk"]), bool)
    for c, v in params["date_filter"].items():
        d_ok &= dd[c] == v
    i_ok = np.ones(len(it["i_item_sk"]), bool)
    for c, v in params["item_filter"].items():
        i_ok &= it[c] == v
    d_rows, i_rows = np.flatnonzero(d_ok), np.flatnonzero(i_ok)
    all_ss = np.arange(len(ss["ss_item_sk"]))
    d_side = rows_bytes(dd, d_rows, ["d_date_sk"] + params["date_keys"], sd)
    fact = rows_bytes(ss, all_ss, ["ss_sold_date_sk", "ss_item_sk",
                                   "ss_ext_sales_price"], sss)
    joined1, _i, _s = star_rows(tables, params["date_filter"], {})
    first = rows_bytes(ss, _s, ["ss_item_sk", "ss_ext_sales_price"], sss) \
        + rows_bytes(dd, joined1, params["date_keys"], sd)
    i_side = rows_bytes(it, i_rows, ["i_item_sk"] + params["item_keys"], si)
    _read, groups = star_aggregate_bytes(tables, schema, params)
    return d_side + fact + first + i_side + groups
