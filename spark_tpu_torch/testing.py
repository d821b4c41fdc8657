"""Comparison helpers for holding the port against a reference engine.

Everything here works on PLAIN NUMPY PARTS of a batch — names,
``simpleString()`` type names, data arrays, validity masks, the row mask,
dictionaries and the capacity — so the same helpers read a batch of this
package (torch tensors) and a batch of any engine with the same columnar
layout, without importing that engine.  ``from_parts`` carries such
parts over into a batch of this package (``ColumnBatch.from_numpy_parts``).

The main path's two queries live here too, as numpy tables made from a
seed and as DataFrame programs written against an engine's
``functions``/``types`` modules, so tests run them on both engines and
``chip_smoke.py`` runs them on the card; so do the SQL texts of the
queries ``chip_smoke.py`` runs through ``spark.sql`` (q3's is TPC-DS
q3's text as the JAX package's ``tpcds/queries.py`` writes it), each
with a numpy oracle.

Under pytest-xdist (several worker processes on one host) importing this
module gives each worker one intra-op torch thread: with a thread per
core in every worker, the workers' OpenMP regions wait on each other's
descheduled threads, and the CPU tests' many small ops run up to ~100x
slower (TPC-DS q4 at 20,000 rows: 142 s under 6 workers on 8 cores, 1.3 s
alone).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .columnar import ColumnBatch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


class BatchParts(NamedTuple):
    names: List[str]
    type_strings: List[str]
    datas: List[np.ndarray]
    valids: List[Optional[np.ndarray]]
    row_valid: Optional[np.ndarray]
    dictionaries: List[Optional[Tuple[Any, ...]]]
    capacity: int


def to_numpy(x) -> Optional[np.ndarray]:
    """A torch tensor, a numpy array or any array exposing ``__array__``
    (host copy); None stays None."""
    if x is None:
        return None
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def batch_parts(batch) -> BatchParts:
    """The numpy parts of a columnar batch (``names``, ``vectors`` with
    ``data``/``valid``/``dtype``/``dictionary``, ``row_valid``,
    ``capacity``)."""
    return BatchParts(
        list(batch.names),
        [v.dtype.simpleString() for v in batch.vectors],
        [to_numpy(v.data) for v in batch.vectors],
        [to_numpy(v.valid) for v in batch.vectors],
        to_numpy(batch.row_valid),
        [None if v.dictionary is None else tuple(v.dictionary)
         for v in batch.vectors],
        int(batch.capacity))


def from_parts(parts: BatchParts, device="cpu") -> ColumnBatch:
    """A batch of this package holding the same bits as ``parts``."""
    return ColumnBatch.from_numpy_parts(
        parts.names, parts.type_strings, parts.datas, parts.valids,
        parts.row_valid, parts.dictionaries, parts.capacity, device)


def _full(mask: Optional[np.ndarray], n: int) -> np.ndarray:
    return np.ones(n, bool) if mask is None else np.broadcast_to(
        np.asarray(mask, bool), (n,))


def _decoded(data: np.ndarray, dictionary) -> np.ndarray:
    if dictionary is None:
        return data
    words = np.array(list(dictionary) + [None], dtype=object)
    codes = np.where((data >= 0) & (data < len(dictionary)), data,
                     len(dictionary))
    return words[codes]


def assert_parts_equal(ref: BatchParts, got: BatchParts, *,
                       rtol: float = 0.0, live_only: bool = True) -> None:
    """Same names, types, row mask, validity masks, and data under the
    masks.  Integer (and code) data must match bit for bit; float data
    within ``rtol`` (NaN matches NaN).  String columns compare decoded
    words, so two dictionaries with the same words in another code space
    still match.  ``live_only`` compares column masks and data on live
    rows only (dead rows carry no defined value)."""
    assert ref.names == got.names, (ref.names, got.names)
    assert ref.type_strings == got.type_strings, \
        (ref.type_strings, got.type_strings)
    assert ref.capacity == got.capacity, (ref.capacity, got.capacity)
    n = ref.capacity
    rv_ref, rv_got = _full(ref.row_valid, n), _full(got.row_valid, n)
    assert np.array_equal(rv_ref, rv_got), "row_valid differs"
    live = rv_ref if live_only else np.ones(n, bool)
    for i, name in enumerate(ref.names):
        vr = _full(ref.valids[i], n) & live
        vg = _full(got.valids[i], n) & live
        assert np.array_equal(vr, vg), f"validity of {name!r} differs"
        a = _decoded(np.asarray(ref.datas[i]), ref.dictionaries[i])[vr]
        b = _decoded(np.asarray(got.datas[i]), got.dictionaries[i])[vr]
        assert_values_equal(a, b, rtol=rtol, what=name)


def assert_values_equal(a: np.ndarray, b: np.ndarray, *, rtol: float = 0.0,
                        what: str = "values") -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        af, bf = a.astype(np.float64), b.astype(np.float64)
        ok = np.isclose(af, bf, rtol=rtol, atol=0.0, equal_nan=True)
        assert ok.all(), (what, af[~ok][:5], bf[~ok][:5])
    else:
        assert a.dtype == b.dtype or a.dtype.kind == "O", (what, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, a[a != b][:5], b[a != b][:5])


# ---------------------------------------------------------------------------
# the two queries of the main path, as data (numpy, from a seed) and as
# DataFrame programs over either engine's modules
# ---------------------------------------------------------------------------

def hash_agg_table(n: int, groups: int, seed: int = 7):
    """``groupBy(k).agg(sum(v), count(*))`` input: int64 keys in
    [0, groups) and int64 values in [0, 100), drawn in that order."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, groups, n).astype(np.int64)
    vals = rng.integers(0, 100, n).astype(np.int64)
    return {"k": keys, "v": vals}


def hash_agg_query(session, F, table):
    df = session.createDataFrame(table)
    return df.groupBy("k").agg(F.sum("v").alias("s"), F.count("*").alias("c"))


#: TPC-DS q3's three tables, reduced to the columns q3 reads
Q3_SCHEMAS = {
    "store_sales": [("ss_sold_date_sk", "bigint"), ("ss_item_sk", "bigint"),
                    ("ss_ext_sales_price", "decimal(7,2)")],
    "date_dim": [("d_date_sk", "bigint"), ("d_year", "int"), ("d_moy", "int")],
    "item": [("i_item_sk", "bigint"), ("i_brand_id", "int"),
             ("i_brand", "string"), ("i_manufact_id", "int")],
}

_DATE_SK0 = 2415022                       # 1900-01-02, date_dim's first row
_SALES_SK = (2450816, 2452642)            # 1998-01-02 .. 2002-12-31


def q3_tables(n_sales: int, n_items: int, n_dates: int = 73049,
              seed: int = 11):
    """q3's tables at the given row counts: date_dim from 1900-01-02 (at
    SF1 its 73,049 rows reach 2100-01-01), sales dated 1998-2002 as in
    TPC-DS (or over all of date_dim when it is shorter), brand ids shaped
    as ``spark_tpu/tpcds/datagen.py`` shapes them (category * 10^6 +
    class * 10^4 + 1..99 — a key range far wider than a bucket table),
    and prices in cents (decimal(7,2)) as floats."""
    rng = np.random.default_rng(seed)
    days = np.datetime64("1900-01-02") + np.arange(n_dates)
    years = days.astype("datetime64[Y]").astype(np.int64) + 1970
    months = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    date_sk = _DATE_SK0 + np.arange(n_dates, dtype=np.int64)
    lo, hi = _SALES_SK
    if date_sk[-1] < hi:
        lo, hi = int(date_sk[0]), int(date_sk[-1])
    cat = rng.integers(1, 11, n_items)
    cls = rng.integers(1, 11, n_items)
    brand_id = cat * 1000000 + cls * 10000 + rng.integers(1, 100, n_items)
    return {
        "store_sales": {
            "ss_sold_date_sk": rng.integers(lo, hi + 1, n_sales).astype(np.int64),
            "ss_item_sk": rng.integers(1, n_items + 1, n_sales).astype(np.int64),
            "ss_ext_sales_price":
                rng.integers(0, 2_000_000, n_sales).astype(np.int64) / 100.0,
        },
        "date_dim": {"d_date_sk": date_sk, "d_year": years.astype(np.int32),
                     "d_moy": months.astype(np.int32)},
        "item": {
            "i_item_sk": np.arange(1, n_items + 1, dtype=np.int64),
            "i_brand_id": brand_id.astype(np.int32),
            "i_brand": np.array([f"brand#{b}" for b in brand_id]),
            "i_manufact_id":
                rng.integers(1, 101, n_items).astype(np.int32),
        },
    }


def q3_query(session, F, T, tables):
    """TPC-DS q3 through the DataFrame API (``tpcds/queries.py`` q3)."""
    def frame(name):
        schema = T.StructType([T.StructField(c, T.type_for_name(t))
                               for c, t in Q3_SCHEMAS[name]])
        return session.createDataFrame(tables[name], schema=schema)

    ss, dd, it = frame("store_sales"), frame("date_dim"), frame("item")
    return (ss.join(dd, ss["ss_sold_date_sk"] == dd["d_date_sk"])
              .join(it, ss["ss_item_sk"] == it["i_item_sk"])
              .filter((F.col("i_manufact_id") == 28) & (F.col("d_moy") == 11))
              .groupBy("d_year", "i_brand_id", "i_brand")
              .agg(F.sum("ss_ext_sales_price").alias("sum_agg"))
              .orderBy("d_year", F.col("sum_agg").desc(), "i_brand_id",
                       "i_brand")
              .limit(100))


def assert_rows_equal(ref_rows: Sequence[Sequence[Any]],
                      got_rows: Sequence[Sequence[Any]], *,
                      rtol: float = 0.0, ordered: bool = True) -> None:
    """collect() results: equal row count and values; floats within
    ``rtol``; unordered comparison sorts both sides by their repr."""
    ref_rows = [tuple(r) for r in ref_rows]
    got_rows = [tuple(r) for r in got_rows]
    assert len(ref_rows) == len(got_rows), (len(ref_rows), len(got_rows))
    if not ordered:
        ref_rows = sorted(ref_rows, key=repr)
        got_rows = sorted(got_rows, key=repr)
    for i, (r, g) in enumerate(zip(ref_rows, got_rows)):
        assert len(r) == len(g), (i, r, g)
        for x, y in zip(r, g):
            if isinstance(x, float) and isinstance(y, float):
                same = (np.isnan(x) and np.isnan(y)) or (
                    x == y and np.signbit(x) == np.signbit(y))
                assert same or abs(x - y) <= rtol * max(abs(x), abs(y)), \
                    (i, r, g)
            else:
                assert x == y and type(x) is type(y), (i, r, g)


# ---------------------------------------------------------------------------
# numpy oracles of the main path's queries
# ---------------------------------------------------------------------------

def hash_agg_oracle(table):
    k, v = table["k"], table["v"]
    groups = int(k.max()) + 1
    counts = np.bincount(k, minlength=groups)
    total = np.zeros(groups, np.int64)
    np.add.at(total, k, v)
    return sorted((int(g), int(total[g]), int(counts[g]))
                  for g in range(groups) if counts[g] > 0)


def _cents(prices: np.ndarray) -> np.ndarray:
    return np.round(prices * 100).astype(np.int64)


def _q3_groups(tables):
    """q3's join and filter in numpy (the joins as lookups by surrogate
    key), grouped: {(d_year, i_brand_id, i_brand): exact cents}."""
    ss, dd, it = tables["store_sales"], tables["date_dim"], tables["item"]
    d_idx = ss["ss_sold_date_sk"] - dd["d_date_sk"][0]
    i_idx = ss["ss_item_sk"] - 1
    keep = (dd["d_moy"][d_idx] == 11) & (it["i_manufact_id"][i_idx] == 28)
    cents = _cents(ss["ss_ext_sales_price"][keep])
    year = dd["d_year"][d_idx[keep]]
    brand_id = it["i_brand_id"][i_idx[keep]]
    brand = it["i_brand"][i_idx[keep]]
    groups = {}
    for y, bi, bn, c in zip(year.tolist(), brand_id.tolist(), brand.tolist(),
                            cents.tolist()):
        groups[(y, bi, bn)] = groups.get((y, bi, bn), 0) + c
    return groups


def q3_oracle(tables):
    """q3 in numpy, exact cents."""
    groups = _q3_groups(tables)
    rows = sorted(groups.items(),
                  key=lambda kv: (kv[0][0], -kv[1], kv[0][1], kv[0][2]))
    return [(y, bi, bn, c / 100.0) for (y, bi, bn), c in rows[:100]]


# ---------------------------------------------------------------------------
# the same queries, and those over q3's tables, as SQL text
# ---------------------------------------------------------------------------

#: TPC-DS q3, character for character as ``spark_tpu/tpcds/queries.py``
#: writes it
Q3_SQL = """
SELECT d_year, i_brand_id, i_brand, SUM(ss_ext_sales_price) AS sum_agg
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manufact_id = 28 AND d_moy = 11
GROUP BY d_year, i_brand_id, i_brand
ORDER BY d_year, sum_agg DESC, i_brand_id, i_brand
LIMIT 100
"""

HASH_AGG_SQL = "SELECT k, SUM(v) AS s, COUNT(*) AS c FROM hash_t GROUP BY k"

#: 2000-01-01, where the UNION ALL query splits store_sales
SPLIT_DATE_SK = 2451545


def register_sql_tables(session, hash_table, tables, T):
    """The hash-agg table and q3's three tables as temp views of
    ``session`` (``T``: the engine's types module)."""
    session.createDataFrame(hash_table).createOrReplaceTempView("hash_t")
    for name, cols in Q3_SCHEMAS.items():
        schema = T.StructType([T.StructField(c, T.type_for_name(t))
                               for c, t in cols])
        session.createDataFrame(tables[name], schema=schema) \
            .createOrReplaceTempView(name)


#: the file layout of the scan tables (``write_scan_tables``)
SCAN_ROW_GROUP_ROWS = 1 << 18


def write_scan_tables(session, hash_table, tables, T, root: str,
                      row_group_rows: int = SCAN_ROW_GROUP_ROWS) -> dict:
    """Write the hash-agg table and q3's three tables through the port's
    own writers, as a warehouse keeps them: ``hash_t`` and
    ``store_sales`` as parquet (store_sales sorted by ``ss_sold_date_sk``,
    a date-clustered fact table, in row groups of ``row_group_rows``),
    ``date_dim`` as CSV with a header, and ``item`` as a catalog table
    (``saveAsTable``, under ``session``'s warehouse).  Returns each
    write's milliseconds."""
    import os
    import time
    schemas = {name: T.StructType([T.StructField(c, T.type_for_name(t))
                                   for c, t in cols])
               for name, cols in Q3_SCHEMAS.items()}
    order = np.argsort(tables["store_sales"]["ss_sold_date_sk"],
                       kind="stable")
    sales = {c: v[order] for c, v in tables["store_sales"].items()}
    ms = {}

    def timed(name, write):
        t0 = time.perf_counter()
        write()
        ms[name] = (time.perf_counter() - t0) * 1e3

    timed("hash_t", lambda: session.createDataFrame(hash_table).write
          .option("rowGroupSize", row_group_rows)
          .parquet(os.path.join(root, "hash_t")))
    timed("store_sales", lambda: session.createDataFrame(
        sales, schema=schemas["store_sales"]).write
        .option("rowGroupSize", row_group_rows)
        .parquet(os.path.join(root, "store_sales")))
    timed("date_dim", lambda: session.createDataFrame(
        tables["date_dim"], schema=schemas["date_dim"]).write
        .option("header", True).csv(os.path.join(root, "date_dim")))
    timed("item", lambda: session.createDataFrame(
        tables["item"], schema=schemas["item"]).write.saveAsTable("item"))
    return ms


def read_scan_tables(session, root: str) -> None:
    """``write_scan_tables``' files as ``session``'s tables: ``hash_t``,
    ``store_sales`` and ``date_dim`` as temp views over the files;
    ``item`` resolves through the catalog (the session's warehouse)."""
    import os
    session.read.parquet(os.path.join(root, "hash_t")) \
        .createOrReplaceTempView("hash_t")
    session.read.parquet(os.path.join(root, "store_sales")) \
        .createOrReplaceTempView("store_sales")
    session.read.csv(os.path.join(root, "date_dim"), header=True,
                     inferSchema=True).createOrReplaceTempView("date_dim")


def register_sql_udfs(session, vector_ops):
    """The UDFs the SQL queries call, one per lane: ``brand_class`` is
    vectorized over the engine's tensors (``vector_ops``: the array module
    whose ``floor_divide`` and ``remainder`` it uses), ``manufact_band``
    runs per row."""
    session.udf.register(
        "brand_class",
        lambda b: vector_ops.remainder(vector_ops.floor_divide(b, 10000),
                                       100),
        "int", vectorized=True)
    session.udf.register("manufact_band", lambda m: m // 10, "int")


def _union_all_oracle(tables):
    ss = tables["store_sales"]
    n = len(tables["item"]["i_item_sk"]) + 1
    counts = np.bincount(ss["ss_item_sk"], minlength=n)
    cents = np.bincount(ss["ss_item_sk"],
                        weights=_cents(ss["ss_ext_sales_price"]),
                        minlength=n).astype(np.int64)
    return [(int(i), int(cents[i]) / 100.0, int(counts[i]))
            for i in np.nonzero(counts)[0]]


def _brands(tables, low: bool):
    """The brands of items made by manufacturers 1-50 (``low``) or
    51-100."""
    it = tables["item"]
    pick = (it["i_manufact_id"] <= 50) == low
    return set(it["i_brand"][pick].tolist())


def _scalar_oracle(tables):
    cents = _cents(tables["store_sales"]["ss_ext_sales_price"])
    # price > avg(price)  <=>  cents * n > sum(cents), exactly
    return [(int(np.count_nonzero(cents * len(cents) > cents.sum())),)]


def _exists_oracle(tables):
    ss, dd = tables["store_sales"], tables["date_dim"]
    d_idx = ss["ss_sold_date_sk"] - dd["d_date_sk"][0]
    nov = (dd["d_moy"][d_idx] == 11) & (dd["d_year"][d_idx] == 2000)
    return [(int(i),) for i in np.unique(ss["ss_item_sk"][nov])]


def _like_oracle(tables):
    it = tables["item"]
    out = {}
    for b, m in zip(it["i_brand"].tolist(), it["i_manufact_id"].tolist()):
        if b.startswith("brand#2") and b.endswith("5"):
            c, s = out.get(b, (0, 0))
            out[b] = (c + 1, s + m)
    return [(b, c, s) for b, (c, s) in out.items()]


def _grouped_count(values):
    keys, counts = np.unique(values, return_counts=True)
    return [(int(k), int(c)) for k, c in zip(keys, counts)]


#: the SQL queries over q3's tables: name -> (text, numpy oracle of its
#: rows, whether the rows come in a defined order)
SQL_QUERIES = {
    "union all": (
        "SELECT ss_item_sk, SUM(ss_ext_sales_price) AS s, COUNT(*) AS c "
        "FROM (SELECT ss_item_sk, ss_ext_sales_price FROM store_sales "
        f"WHERE ss_sold_date_sk < {SPLIT_DATE_SK} UNION ALL "
        "SELECT ss_item_sk, ss_ext_sales_price FROM store_sales "
        f"WHERE ss_sold_date_sk >= {SPLIT_DATE_SK}) x GROUP BY ss_item_sk",
        _union_all_oracle, False),
    "intersect": (
        "SELECT i_brand FROM item WHERE i_manufact_id <= 50 INTERSECT "
        "SELECT i_brand FROM item WHERE i_manufact_id > 50",
        lambda t: [(b,) for b in _brands(t, True) & _brands(t, False)],
        False),
    "except": (
        "SELECT i_brand FROM item WHERE i_manufact_id <= 50 EXCEPT "
        "SELECT i_brand FROM item WHERE i_manufact_id > 50",
        lambda t: [(b,) for b in _brands(t, True) - _brands(t, False)],
        False),
    "q3 IN subquery": (
        Q3_SQL.replace("AND i_manufact_id = 28",
                       "AND ss_item_sk IN (SELECT i_item_sk FROM item "
                       "WHERE i_manufact_id = 28)"),
        q3_oracle, True),
    "scalar subquery": (
        "SELECT COUNT(*) AS n FROM store_sales WHERE ss_ext_sales_price > "
        "(SELECT AVG(ss_ext_sales_price) FROM store_sales)",
        _scalar_oracle, True),
    "correlated EXISTS": (
        "SELECT i_item_sk FROM item WHERE EXISTS (SELECT * FROM "
        "store_sales, date_dim WHERE ss_sold_date_sk = d_date_sk "
        "AND d_year = 2000 AND d_moy = 11 AND ss_item_sk = i_item_sk)",
        _exists_oracle, False),
    "LIKE": (
        "SELECT i_brand, COUNT(*) AS c, SUM(i_manufact_id) AS m FROM item "
        "WHERE i_brand LIKE 'brand#2%5' GROUP BY i_brand",
        _like_oracle, False),
    "UDF vectorized": (
        "SELECT cls, COUNT(*) AS c FROM (SELECT brand_class(i_brand_id) "
        "AS cls FROM item) x GROUP BY cls",
        lambda t: _grouped_count(t["item"]["i_brand_id"] // 10000 % 100),
        False),
    "UDF row": (
        "SELECT band, COUNT(*) AS c FROM (SELECT "
        "manufact_band(i_manufact_id) AS band FROM item) x GROUP BY band",
        lambda t: _grouped_count(t["item"]["i_manufact_id"] // 10), False),
}


# ---------------------------------------------------------------------------
# expression and aggregate breadth, grouping sets and windows over the main
# path's tables, as SQL text, each with a numpy oracle
# ---------------------------------------------------------------------------

_Q3_FROM = """
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manufact_id = 28 AND d_moy = 11
"""


def _sum_by(groups, key):
    out = {}
    for k, c in groups.items():
        out[key(k)] = out.get(key(k), 0) + c
    return out


def _rollup_oracle(tables):
    """ROLLUP(d_year, i_brand_id): the (year, brand) sums, the year
    subtotals and the grand total, ordered by grouping id, year, brand."""
    groups = _q3_groups(tables)
    rows = [(y, b, c, 0) for (y, b), c in
            _sum_by(groups, lambda k: (k[0], k[1])).items()]
    rows += [(y, None, c, 1) for y, c in
             _sum_by(groups, lambda k: k[0]).items()]
    rows.append((None, None, sum(groups.values()), 3))
    rows.sort(key=lambda r: (r[3], r[0] or 0, r[1] or 0))
    return [(y, b, c / 100.0, g) for y, b, c, g in rows]


def _window_oracle(tables):
    """Revenue per (brand, year) with the brand's total, the rank of the
    revenue within its year (ties share the lowest rank) and the brand's
    revenue of its previous year present, ordered by year, rank, brand."""
    rev = _sum_by(_q3_groups(tables), lambda k: (k[1], k[0]))
    brand_total = _sum_by(rev, lambda k: k[0])
    by_year = {}
    for (b, y), c in rev.items():
        by_year.setdefault(y, []).append(c)
    prev, last = {}, {}
    for b, y in sorted(rev):
        prev[(b, y)] = last.get(b)
        last[b] = rev[(b, y)]
    rows = []
    for (b, y), c in rev.items():
        rank = 1 + sum(1 for other in by_year[y] if other > c)
        p = prev[(b, y)]
        rows.append((b, y, c / 100.0, brand_total[b] / 100.0, rank,
                     None if p is None else p / 100.0))
    rows.sort(key=lambda r: (r[1], r[4], r[0]))
    return rows


def _string_keys_oracle(tables):
    """q3 grouped by (year, upper(brand), substr(brand, 1, 7)), its order
    and limit."""
    groups = _sum_by(_q3_groups(tables),
                     lambda k: (k[0], k[2].upper(), k[2][:7]))
    rows = sorted(groups.items(),
                  key=lambda kv: (kv[0][0], -kv[1], kv[0][1], kv[0][2]))
    return [(y, u, s7, c / 100.0) for (y, u, s7), c in rows[:100]]


def _round_half_up(x: np.ndarray, digits: int) -> np.ndarray:
    """The engines' HALF_UP rounding of doubles, formula for formula."""
    f = 10.0 ** digits
    return np.floor(np.abs(x) * f + 0.5) / f * np.sign(x)


def _stats_oracle(table):
    """Per key of the hash-agg table: stddev_samp(v), var_pop(v) and
    round(avg(v), 2), ordered by key."""
    k, v = table["k"], table["v"].astype(np.float64)
    keys, inv = np.unique(k, return_inverse=True)
    n = np.bincount(inv).astype(np.float64)
    s = np.bincount(inv, weights=v)
    mean = s / n
    dev2 = np.bincount(inv, weights=(v - mean[inv]) ** 2)
    sd = np.sqrt(dev2 / (n - 1))
    vp = dev2 / n
    av = _round_half_up(mean, 2)
    return [(int(a), float(b), float(c), float(d))
            for a, b, c, d in zip(keys, sd, vp, av)]


#: the breadth queries: name -> (text, numpy oracle of its rows (over q3's
#: tables and the hash-agg table), the columns compared within a relative
#: tolerance (the others exactly), that tolerance)
BREADTH_QUERIES = {
    "rollup": (
        "SELECT d_year, i_brand_id, SUM(ss_ext_sales_price) AS sum_agg, "
        "grouping_id() AS gid" + _Q3_FROM +
        "GROUP BY ROLLUP(d_year, i_brand_id) ORDER BY gid, d_year, "
        "i_brand_id",
        lambda tables, hash_table: _rollup_oracle(tables), (), 0.0),
    "window": (
        "SELECT i_brand_id, d_year, SUM(ss_ext_sales_price) AS rev, "
        "SUM(SUM(ss_ext_sales_price)) OVER (PARTITION BY i_brand_id) "
        "AS brand_rev, RANK() OVER (PARTITION BY d_year ORDER BY "
        "SUM(ss_ext_sales_price) DESC) AS rnk, LAG(SUM(ss_ext_sales_price)) "
        "OVER (PARTITION BY i_brand_id ORDER BY d_year) AS prev_rev"
        + _Q3_FROM + "GROUP BY i_brand_id, d_year ORDER BY d_year, rnk, "
        "i_brand_id",
        lambda tables, hash_table: _window_oracle(tables), (), 0.0),
    "string keys": (
        "SELECT d_year, UPPER(i_brand) AS ubrand, SUBSTR(i_brand, 1, 7) "
        "AS brand7, SUM(ss_ext_sales_price) AS sum_agg" + _Q3_FROM +
        "GROUP BY d_year, UPPER(i_brand), SUBSTR(i_brand, 1, 7) "
        "ORDER BY d_year, sum_agg DESC, ubrand, brand7 LIMIT 100",
        lambda tables, hash_table: _string_keys_oracle(tables), (), 0.0),
    "statistics": (
        "SELECT k, STDDEV_SAMP(v) AS sd, VAR_POP(v) AS vp, "
        "ROUND(AVG(v), 2) AS av FROM hash_t GROUP BY k ORDER BY k",
        lambda tables, hash_table: _stats_oracle(hash_table), (1, 2), 1e-9),
}


def breadth_rows_match(got, want, approx_cols=(), rtol=0.0) -> bool:
    """``got`` equals ``want`` row for row: the columns in ``approx_cols``
    within ``rtol`` (relative), every other value exactly."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for j, (a, b) in enumerate(zip(g, w)):
            if j in approx_cols:
                if not (a is not None and b is not None
                        and abs(a - b) <= rtol * max(abs(a), abs(b))):
                    return False
            elif a != b or type(a) is not type(b):
                return False
    return True


# ---------------------------------------------------------------------------
# arrays over market baskets: store_sales tickets of 8-16 line items (as
# dsdgen's store_sales makes them), collected per ticket, exploded back to
# rows, and the sampling expressions
# ---------------------------------------------------------------------------

#: SF1 store_sales rows and item rows (TPC-DS)
BASKET_SALES_ROWS = 2_880_404
BASKET_ITEMS = 18_000
#: line items per ticket, uniform (dsdgen's store_sales)
BASKET_SIZES = (8, 16)

BASKET_SCHEMAS = {
    "store_sales": [("ss_ticket_number", "bigint"), ("ss_item_sk", "bigint"),
                    ("ss_quantity", "int"),
                    ("ss_sales_price", "decimal(7,2)")],
    "item": [("i_item_sk", "bigint"), ("i_manufact_id", "int")],
}


def basket_tables(n_sales: int = BASKET_SALES_ROWS,
                  n_items: int = BASKET_ITEMS, seed: int = 11):
    """store_sales as tickets of 8-16 line items (uniform; the last
    ticket takes what remains of ``n_sales``), the items of a ticket
    distinct, drawn from ``n_items``; quantities 1-100, prices in cents
    (decimal(7,2)) as floats; the rows shuffled, so a ticket's rows lie
    apart and ``collect_list`` keeps their row order.  ``item`` with
    ``i_manufact_id`` in 1-100 (q3's)."""
    rng = np.random.default_rng(seed)
    lo, hi = BASKET_SIZES
    sizes = rng.integers(lo, hi + 1, n_sales // lo + 1)
    ends = np.cumsum(sizes)
    n_tickets = int(np.searchsorted(ends, n_sales)) + 1
    sizes = sizes[:n_tickets].copy()
    sizes[-1] -= int(ends[n_tickets - 1]) - n_sales
    ticket = np.repeat(np.arange(1, n_tickets + 1, dtype=np.int64), sizes)
    line = np.arange(n_sales) - np.repeat(ends[:n_tickets] - sizes, sizes)
    # distinct within a ticket: a random start and a random stride with
    # stride * 15 < n_items
    start = rng.integers(0, n_items, n_tickets)
    stride = rng.integers(1, max(n_items // hi, 2), n_tickets)
    item = (np.repeat(start, sizes) + line * np.repeat(stride, sizes)) \
        % n_items + 1
    perm = rng.permutation(n_sales)
    return {
        "store_sales": {
            "ss_ticket_number": ticket[perm],
            "ss_item_sk": item[perm].astype(np.int64),
            "ss_quantity": rng.integers(1, 101, n_sales).astype(np.int32),
            "ss_sales_price":
                rng.integers(0, 20_000, n_sales).astype(np.int64) / 100.0,
        },
        "item": {
            "i_item_sk": np.arange(1, n_items + 1, dtype=np.int64),
            "i_manufact_id":
                rng.integers(1, 101, n_items).astype(np.int32),
        },
    }


def register_basket_tables(session, tables, T):
    for name, cols in BASKET_SCHEMAS.items():
        schema = T.StructType([T.StructField(c, T.type_for_name(t))
                               for c, t in cols])
        session.createDataFrame(tables[name], schema=schema) \
            .createOrReplaceTempView(name)


_I64_SENT = np.iinfo(np.int64).min
_I32_SENT = np.iinfo(np.int32).min

_BASKETS = ("(SELECT ss_ticket_number, collect_list(ss_item_sk) AS items, "
            "collect_list(ss_quantity) AS qtys, "
            "collect_set(ss_quantity) AS qty_set, COUNT(*) AS n "
            "FROM store_sales GROUP BY ss_ticket_number) b")


def _planes(tables, width):
    """Per ticket (ascending), its items and quantities in row order as
    ``(tickets, width)`` planes with trailing sentinels, its ticket
    numbers and line counts."""
    ss = tables["store_sales"]
    order = np.argsort(ss["ss_ticket_number"], kind="stable")
    t = ss["ss_ticket_number"][order]
    tickets, first, counts = np.unique(t, return_index=True,
                                       return_counts=True)
    pos = np.arange(len(t)) - np.repeat(first, counts)
    keep = pos < width
    rows = np.repeat(np.arange(len(tickets)), counts)[keep]
    items = np.full((len(tickets), width), _I64_SENT, np.int64)
    qtys = np.full((len(tickets), width), _I32_SENT, np.int32)
    items[rows, pos[keep]] = ss["ss_item_sk"][order][keep]
    qtys[rows, pos[keep]] = ss["ss_quantity"][order][keep]
    return tickets, counts, items, qtys


def _live(plane, sent):
    return plane != sent


def _pack(plane, keep, sent):
    """Each row's kept elements first, in order; sentinels after."""
    order = np.argsort(~keep, axis=1, kind="stable")
    out = np.take_along_axis(plane, order, axis=1)
    return np.where(np.take_along_axis(keep, order, axis=1), out, sent)


def _first_of_equal(plane, live):
    """Element j is the first live element of its row with its value."""
    eq = plane[:, :, None] == plane[:, None, :]
    earlier = np.tril(np.ones(eq.shape[1:], bool), k=-1)
    return live & ~(eq & earlier & live[:, None, :]
                    & live[:, :, None]).any(axis=2)


def _baskets_oracle(tables, width):
    tickets, counts, items, qtys = _planes(tables, width)
    il, ql = _live(items, _I64_SENT), _live(qtys, _I32_SENT)
    n_items = il.sum(axis=1)
    sorted_items = np.sort(np.where(il, items, np.iinfo(np.int64).max),
                           axis=1)
    last = np.take_along_axis(items, (n_items - 1)[:, None], axis=1)[:, 0]
    qty_set = np.sort(np.where(_first_of_equal(qtys, ql), qtys,
                               np.iinfo(np.int32).max), axis=1)
    qty_set = np.where(qty_set == np.iinfo(np.int32).max, _I32_SENT, qty_set)
    cols = np.arange(width)
    in_slice = (cols >= 1) & (cols < 4)
    items_2_4 = _pack(items, il & in_slice[None, :], _I64_SENT)
    return {
        "ss_ticket_number": tickets,
        "n_items": n_items.astype(np.int32),
        "min_item": sorted_items[:, 0],
        "last_item": last,
        "has_42": (items == 42).any(axis=1),
        "qty_distinct": _pack(qtys, _first_of_equal(qtys, ql), _I32_SENT),
        "items_2_4": items_2_4,
        "max_qty": np.where(ql, qtys, np.iinfo(np.int32).min).max(axis=1),
        "qty_set": qty_set,
        "n": counts.astype(np.int64),
    }


def _explode_oracle(tables, width):
    """count(*) and sum(quantity) per i_manufact_id over store_sales ⋈
    item: exploding each ticket's items (with their quantities) gives back
    the rows of store_sales while no ticket is longer than ``width``."""
    ss, it = tables["store_sales"], tables["item"]
    tickets, counts, items, qtys = _planes(tables, width)
    live = _live(items, _I64_SENT)
    manufact = np.zeros(int(it["i_item_sk"].max()) + 1, np.int64)
    manufact[it["i_item_sk"]] = it["i_manufact_id"]
    m = manufact[items[live]]
    ids = np.unique(m)
    n = np.bincount(m, minlength=ids.max() + 1)[ids]
    q = np.bincount(m, weights=qtys[live].astype(np.int64),
                    minlength=ids.max() + 1)[ids].astype(np.int64)
    return {"i_manufact_id": ids.astype(np.int32), "n": n.astype(np.int64),
            "qty": q}


def _hof_oracle(tables, width):
    tickets, counts, items, qtys = _planes(tables, width)
    il, ql = _live(items, _I64_SENT), _live(qtys, _I32_SENT)
    pos42 = np.where(il & (items == 42), np.arange(width)[None, :],
                     width).min(axis=1)
    found = pos42 < width
    return {
        "ss_ticket_number": tickets,
        "items_mod": np.where(il, items % 100, _I64_SENT),
        "big_items": _pack(items, il & (items > 9000), _I64_SENT),
        "has_big_qty": (ql & (qtys > 90)).any(axis=1),
        "qty_sum": np.where(ql, qtys, 0).sum(axis=1).astype(np.int32),
        "qty_of_42": (np.take_along_axis(
            qtys, np.minimum(pos42, width - 1)[:, None], axis=1)[:, 0],
            found),
        "n_items": il.sum(axis=1).astype(np.int32),
    }


#: the complex-type texts: name -> (SQL text over ``store_sales`` and
#: ``item`` of ``basket_tables``, numpy oracle of its columns given the
#: tables and ``spark.tpu.collect.maxArrayLen``).  An oracle column is an
#: array of the live rows' values (2-D for an array column, its trailing
#: slots the element sentinel), or (values, validity).
COMPLEX_QUERIES = {
    "baskets": (
        "SELECT ss_ticket_number, size(items) AS n_items, "
        "sort_array(items)[0] AS min_item, element_at(items, -1) AS "
        "last_item, array_contains(items, 42) AS has_42, "
        "array_distinct(qtys) AS qty_distinct, slice(items, 2, 3) AS "
        "items_2_4, array_max(qtys) AS max_qty, qty_set, n FROM "
        + _BASKETS + " ORDER BY ss_ticket_number",
        _baskets_oracle),
    "explode": (
        "SELECT i_manufact_id, COUNT(*) AS n, SUM(qty) AS qty FROM "
        "(SELECT item, element_at(qtys, pos + 1) AS qty FROM "
        "(SELECT qtys, posexplode(items) AS item FROM " + _BASKETS +
        ") e) x JOIN item ON item = i_item_sk GROUP BY i_manufact_id "
        "ORDER BY i_manufact_id",
        _explode_oracle),
    "higher-order": (
        "SELECT ss_ticket_number, transform(items, x -> x % 100) AS "
        "items_mod, filter(items, x -> x > 9000) AS big_items, "
        "exists(qtys, x -> x > 90) AS has_big_qty, "
        "aggregate(qtys, 0L, (acc, x) -> acc + x) AS qty_sum, "
        "element_at(map_from_arrays(items, qtys), 42) AS qty_of_42, "
        "named_struct('n', size(items), 'first', items[0]).n AS n_items "
        "FROM " + _BASKETS + " ORDER BY ss_ticket_number",
        _hof_oracle),
}

def unordered(sql: str) -> str:
    """A complex-type text without its final ORDER BY: the form the mesh
    lane runs sharded (a sort of array columns would exchange 2-D planes,
    which it leaves to one device)."""
    return sql[:sql.rindex(" ORDER BY ")]


#: ``DataFrame.sample``'s fraction and seed, and the seed of the rand /
#: randn columns, in the sampling text
SAMPLE_FRACTION, SAMPLE_SEED = 0.01, 7


def rand_oracle(n: int, seed: int, offset: int) -> np.ndarray:
    """``rand(seed)`` of rows 0..n-1 at row offset ``offset``: the uint64
    formula of ``spark_tpu.expressions.Rand`` in numpy."""
    idx = np.arange(n, dtype=np.int64).astype(np.uint64) + np.uint64(offset)
    x = idx * np.uint64(0x9E3779B97F4A7C15) \
        + np.uint64((seed * 2654435761 + 1) & 0xFFFFFFFFFFFFFFFF)
    for c in (0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53, None):
        x = x ^ (x >> np.uint64(33))
        if c is not None:
            x = x * np.uint64(c)
    return (x >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def randn_oracle(n: int, seed: int, offset: int) -> np.ndarray:
    u1 = np.maximum(rand_oracle(n, seed, offset), 1e-12)
    u2 = rand_oracle(n, seed + 0x5DEECE66D, offset)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


def sample_oracle(tables, offset: int):
    """(rows, sum of ticket numbers) that ``sample(SAMPLE_FRACTION,
    SAMPLE_SEED)`` keeps of store_sales at row offset ``offset``."""
    t = tables["store_sales"]["ss_ticket_number"]
    keep = rand_oracle(len(t), SAMPLE_SEED, offset) < SAMPLE_FRACTION
    return int(keep.sum()), int(t[keep].sum())


def result_columns(parts: BatchParts) -> dict:
    """The live rows of a result batch, by column: values (with the
    validity beside them where a column has one)."""
    live = _full(parts.row_valid, parts.capacity)
    out = {}
    for name, d, v in zip(parts.names, parts.datas, parts.valids):
        d = np.asarray(d)[live]
        out[name] = d if v is None else (d, np.asarray(v)[live])
    return out


def complex_mismatch(parts: BatchParts, want: dict, rtol: float = 0.0):
    """None when the result holds exactly ``want``'s columns (floats
    within ``rtol``; a NULL slot's value is not compared), else the first
    difference."""
    got = result_columns(parts)
    if list(got) != list(want):
        return f"columns {list(got)} != {list(want)}"
    for name, w in want.items():
        g = got[name]
        gd, gv = g if isinstance(g, tuple) else (g, None)
        wd, wv = w if isinstance(w, tuple) else (w, None)
        wv = np.ones(len(wd), bool) if wv is None else wv
        gv = np.ones(len(gd), bool) if gv is None else gv
        if gd.shape != wd.shape:
            return f"{name}: shape {gd.shape} != {wd.shape}"
        if not np.array_equal(gv, wv):
            return f"{name}: validity differs at rows " \
                f"{np.flatnonzero(gv != wv)[:5].tolist()}"
        a, b = gd[gv], wd[wv]
        same = np.isclose(a, b, rtol=rtol, atol=0.0, equal_nan=True) \
            if a.dtype.kind == "f" else a == b
        if not np.all(same):
            bad = np.flatnonzero(~same.reshape(len(a), -1).all(axis=1))[:3]
            return f"{name}: rows {bad.tolist()} got {a[bad].tolist()} " \
                f"want {b[bad].tolist()}"
    return None


# ---------------------------------------------------------------------------
# out-of-core: TPC-DS row counts, as files (chip_smoke.py's [ooc] phase)
# ---------------------------------------------------------------------------

#: TPC-DS row counts at scale factors 10 and 1 (dsdgen): the tables of
#: the out-of-core texts, and the customers and items they draw from
OOC_SF10 = {"store_sales": 28_800_991, "store_returns": 2_875_432,
            "date_dim": 73_049, "item": 102_000, "reason": 45,
            "customer": 500_000}
OOC_SF1 = {"store_sales": 2_880_404, "store_returns": 287_514,
           "date_dim": 73_049, "item": 18_000, "reason": 35,
           "customer": 100_000}

OOC_SCHEMAS = {
    "store_sales": [("ss_sold_date_sk", "bigint"), ("ss_item_sk", "bigint"),
                    ("ss_customer_sk", "bigint"),
                    ("ss_ticket_number", "bigint"), ("ss_quantity", "int"),
                    ("ss_sales_price", "double"),
                    ("ss_ext_sales_price", "decimal(7,2)")],
    "store_returns": [("sr_item_sk", "bigint"), ("sr_ticket_number", "bigint"),
                      ("sr_reason_sk", "bigint"),
                      ("sr_return_quantity", "int")],
    "reason": [("r_reason_sk", "bigint"), ("r_reason_id", "string"),
               ("r_reason_desc", "string")],
    "date_dim": Q3_SCHEMAS["date_dim"],
    "item": Q3_SCHEMAS["item"],
}

#: the reason TPC-DS q93 selects (``tpcds/queries.py`` q93)
Q93_REASON = 2

#: (d): the top-k text over store_sales, and the same without its LIMIT
OOC_TOPK_SQL = ("SELECT ss_ticket_number, ss_item_sk, ss_ext_sales_price "
                "FROM store_sales ORDER BY ss_ext_sales_price DESC, "
                "ss_ticket_number, ss_item_sk LIMIT 1000")
OOC_SORT_SQL = OOC_TOPK_SQL.rsplit(" LIMIT", 1)[0]


def ooc_tables(rows: dict, seed: int = 17):
    """store_sales, store_returns, date_dim, item and reason at the row
    counts ``rows`` (``OOC_SF10``, ``OOC_SF1``): store_sales as tickets of
    8-16 distinct line items (as ``basket_tables`` shapes them), each
    ticket one customer and one day of 1998-2002, in ticket order as
    dsdgen writes them; quantities 1-100, prices 0.00-200.00 in cents
    (``ss_sales_price`` a double, ``ss_ext_sales_price`` = quantity x
    price as decimal(7,2)); store_returns drawn without replacement from
    store_sales' rows (its ``(item, ticket)`` pairs), the reason from
    ``rows["reason"]``, the returned quantity at most the sale's; q3's
    date_dim and item (``q3_tables``).  Returns ``(tables, sale_rows)``:
    ``sale_rows[i]`` is the store_sales row return ``i`` came from."""
    rng = np.random.default_rng(seed)
    n, n_items = rows["store_sales"], rows["item"]
    lo, hi = BASKET_SIZES
    sizes = rng.integers(lo, hi + 1, n // lo + 1)
    ends = np.cumsum(sizes)
    n_tickets = int(np.searchsorted(ends, n)) + 1
    sizes = sizes[:n_tickets].copy()
    sizes[-1] -= int(ends[n_tickets - 1]) - n
    ticket = np.repeat(np.arange(1, n_tickets + 1, dtype=np.int64), sizes)
    line = np.arange(n) - np.repeat(ends[:n_tickets] - sizes, sizes)
    start = rng.integers(0, n_items, n_tickets)
    stride = rng.integers(1, max(n_items // hi, 2), n_tickets)
    item = (np.repeat(start, sizes) + line * np.repeat(stride, sizes)) \
        % n_items + 1
    lo_sk, hi_sk = _SALES_SK
    date = np.repeat(rng.integers(lo_sk, hi_sk + 1, n_tickets), sizes)
    cust = np.repeat(rng.integers(1, rows["customer"] + 1, n_tickets), sizes)
    qty = rng.integers(1, 101, n).astype(np.int32)
    price_c = rng.integers(0, 20_001, n).astype(np.int64)
    ext_c = qty.astype(np.int64) * price_c
    n_ret = rows["store_returns"]
    sale_rows = np.sort(rng.choice(n, n_ret, replace=False))
    q3 = q3_tables(0, n_items, rows["date_dim"], seed=seed)
    n_reason = rows["reason"]
    tables = {
        "store_sales": {
            "ss_sold_date_sk": date.astype(np.int64),
            "ss_item_sk": item.astype(np.int64),
            "ss_customer_sk": cust.astype(np.int64),
            "ss_ticket_number": ticket,
            "ss_quantity": qty,
            "ss_sales_price": price_c / 100.0,
            "ss_ext_sales_price": ext_c / 100.0,
        },
        "store_returns": {
            "sr_item_sk": item[sale_rows].astype(np.int64),
            "sr_ticket_number": ticket[sale_rows],
            "sr_reason_sk": rng.integers(1, n_reason + 1,
                                         n_ret).astype(np.int64),
            "sr_return_quantity":
                rng.integers(1, qty[sale_rows].astype(np.int64) + 1)
                .astype(np.int32),
        },
        "reason": {
            "r_reason_sk": np.arange(1, n_reason + 1, dtype=np.int64),
            "r_reason_id": np.array([f"AAAAAAAA{i:08d}"
                                     for i in range(1, n_reason + 1)]),
            "r_reason_desc": np.array([f"reason {i}"
                                       for i in range(1, n_reason + 1)]),
        },
        "date_dim": q3["date_dim"],
        "item": q3["item"],
    }
    return tables, sale_rows


def write_ooc_tables(session, tables, T, root: str,
                     row_group_rows: int = 1 << 20) -> dict:
    """The out-of-core tables through the port's own writers: store_sales,
    store_returns and reason as parquet (row groups of
    ``row_group_rows``), date_dim as CSV with a header, item as a catalog
    table under ``session``'s warehouse.  Returns each write's ms."""
    import os
    import time
    ms = {}
    for name in ("store_sales", "store_returns", "reason", "date_dim",
                 "item"):
        schema = T.StructType([T.StructField(c, T.type_for_name(t))
                               for c, t in OOC_SCHEMAS[name]])
        t0 = time.perf_counter()
        w = session.createDataFrame(tables[name], schema=schema).write
        if name == "date_dim":
            w.option("header", True).csv(os.path.join(root, name))
        elif name == "item":
            w.saveAsTable("item")
        else:
            w.option("rowGroupSize", row_group_rows) \
                .parquet(os.path.join(root, name))
        ms[name] = (time.perf_counter() - t0) * 1e3
    return ms


def read_ooc_tables(session, root: str) -> None:
    """``write_ooc_tables``' files as ``session``'s tables (item through
    the catalog)."""
    import os
    for name in ("store_sales", "store_returns", "reason"):
        session.read.parquet(os.path.join(root, name)) \
            .createOrReplaceTempView(name)
    session.read.csv(os.path.join(root, "date_dim"), header=True,
                     inferSchema=True).createOrReplaceTempView("date_dim")


def q93_oracle(tables, sale_rows, reason: int = Q93_REASON):
    """TPC-DS q93 in numpy over ``ooc_tables``: the returns of
    ``reason`` (its WHERE makes the left join an inner one), each with the
    sale it came from; per customer the exact cents of (quantity -
    returned) x price; the 100 smallest sums, ties by customer.  Rows
    ``(customer, cents)``."""
    ss, sr = tables["store_sales"], tables["store_returns"]
    keep = sr["sr_reason_sk"] == reason
    rows = sale_rows[keep]
    price_c = np.round(ss["ss_sales_price"][rows] * 100).astype(np.int64)
    act = (ss["ss_quantity"][rows].astype(np.int64)
           - sr["sr_return_quantity"][keep].astype(np.int64)) * price_c
    cust, inv = np.unique(ss["ss_customer_sk"][rows], return_inverse=True)
    sums = np.zeros(len(cust), np.int64)
    np.add.at(sums, inv, act)
    order = np.lexsort((cust, sums))[:100]
    return [(int(cust[i]), int(sums[i])) for i in order]


def topk_oracle(tables, k: int = 1000):
    """``OOC_TOPK_SQL`` in numpy: (ticket, item, ext cents) of the ``k``
    rows with the largest ext price, ties by ticket then item."""
    ss = tables["store_sales"]
    ext = np.round(ss["ss_ext_sales_price"] * 100).astype(np.int64)
    thr = np.partition(ext, len(ext) - k)[len(ext) - k]
    cand = np.flatnonzero(ext >= thr)
    order = cand[np.lexsort((ss["ss_item_sk"][cand],
                             ss["ss_ticket_number"][cand], -ext[cand]))][:k]
    return np.stack([ss["ss_ticket_number"][order], ss["ss_item_sk"][order],
                     ext[order]], axis=1)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def sorted_run_mismatch(tables, ticket, item, ext_c):
    """Why a full ``OOC_SORT_SQL`` result is not the sort of store_sales
    (None when it is): every row once — the (ticket, item) pairs are
    unique, so their count and two sums of a 64-bit mix of the pair, one
    wrapping and one xor'ed, must match the table's — and each row at or
    after its predecessor in (ext DESC, ticket, item) order."""
    ss = tables["store_sales"]
    if len(ticket) != len(ss["ss_ticket_number"]):
        return f"{len(ticket)} rows, the table has " \
               f"{len(ss['ss_ticket_number'])}"
    with np.errstate(over="ignore"):
        want = _mix64(ss["ss_ticket_number"] * (1 << 20) + ss["ss_item_sk"])
        got = _mix64(np.asarray(ticket) * (1 << 20) + np.asarray(item))
    if want.sum() != got.sum() or np.bitwise_xor.reduce(want) \
            != np.bitwise_xor.reduce(got):
        return "the rows are not the table's rows"
    e, t, i = -np.asarray(ext_c), np.asarray(ticket), np.asarray(item)
    later = (e[1:] > e[:-1]) | ((e[1:] == e[:-1]) & (
        (t[1:] > t[:-1]) | ((t[1:] == t[:-1]) & (i[1:] > i[:-1]))))
    bad = np.flatnonzero(~later)
    if len(bad):
        return f"row {int(bad[0]) + 1} sorts before row {int(bad[0])}"
    ext = np.round(ss["ss_ext_sales_price"] * 100).astype(np.int64)
    if int(np.asarray(ext_c).sum()) != int(ext.sum()):
        return "the ext prices are not the table's"
    return None


# ---------------------------------------------------------------------------
# the cross-process worker (``python -m spark_tpu_torch.testing
# crossproc-worker <pid> <n> <root> <mode> <timeout_s> <device>``)
# ---------------------------------------------------------------------------

def worker_device(name: str) -> bool:
    """Whether ``name`` is a worker's device argument: ``cuda``,
    ``cuda:N`` (card N, so that each process can take its own) or
    ``cpu``."""
    if name in ("cuda", "cpu"):
        return True
    head, _, index = name.partition(":")
    return head == "cuda" and index.isdigit()


def check_worker_card(device: str, what: str) -> None:
    """A worker given ``cuda`` without a card, or ``cuda:N`` for a card it
    cannot see, raises; given ``cuda:N`` it makes card N this process's
    current card (one card per process)."""
    d = torch.device(device)
    if d.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device")
    if d.index is not None:
        if d.index >= torch.cuda.device_count():
            raise RuntimeError(f"{what}: device {device}, but this process "
                               f"sees {torch.cuda.device_count()} card(s)")
        torch.cuda.set_device(d.index)


def _worker_argv(what: str, argv: Sequence[str]):
    """``<pid> <n> <root> <mode> <timeout_s> <device>`` of a worker; the
    device is required (``cuda``, ``cuda:N`` or ``cpu``): a worker never
    picks the CPU by default."""
    if len(argv) < 6 or not worker_device(argv[5]):
        raise ValueError(f"{what}: argv is <pid> <n> <root> <mode> "
                         f"<timeout_s> <device>, the device cuda or cpu (or "
                         f"cuda:N, card N); got {list(argv)}")
    return (int(argv[0]), int(argv[1]), argv[2], argv[3], float(argv[4]),
            argv[5])


#: (name, SQL text, the execution-shape counter each join mode bumps) —
#: the JAX package's ``tests/shuffled_join_worker.py`` battery: inner /
#: left / semi joins of two partitioned leaves, with and without a keyed
#: aggregate above, a hot key (~40% of fact rows) the range planner must
#: split, string keys, and string min/max over disjoint dictionaries
CROSSPROC_QUERIES = [
    ("inner-agg",
     "SELECT sk, count(*) AS c, sum(bonus) AS sb FROM fact "
     "JOIN fact2 ON sk = k2 GROUP BY sk ORDER BY sk",
     {"range": "range_merge_joins", "hash": "shuffled_joins"}),
    ("inner-rows",
     "SELECT sk, price, bonus FROM fact JOIN fact2 ON sk = k2 "
     "WHERE bonus > 40 ORDER BY sk, price, bonus",
     {"range": "range_merge_joins", "hash": "shuffled_joins"}),
    ("left-agg",
     "SELECT sk, count(bonus) AS cb, count(*) AS c FROM fact "
     "LEFT JOIN fact2 ON sk = k2 GROUP BY sk ORDER BY sk",
     {"range": "range_merge_joins", "hash": "shuffled_joins"}),
    ("string-key-agg",
     "SELECT g, count(*) AS c, sum(bonus) AS sb FROM fact "
     "JOIN fact2 ON g = g2 GROUP BY g ORDER BY g",
     {"range": "range_merge_joins", "hash": "shuffled_joins"}),
    ("string-minmax-fast",
     "SELECT sk2, min(t) AS tlo, max(t) AS thi, count(*) AS c FROM tags "
     "GROUP BY sk2 ORDER BY sk2",
     {"range": "fast_path_aggs", "hash": "fast_path_aggs",
      "gather": "fast_path_aggs"}),
    ("semi-rows",
     "SELECT sk, price FROM fact LEFT SEMI JOIN fact2 ON sk = k2 "
     "ORDER BY sk, price",
     {"range": "range_merge_joins", "hash": "shuffled_joins"}),
    ("semi-replicated-fast",
     "SELECT sk, count(*) AS c FROM fact LEFT SEMI JOIN dim ON sk = d_sk "
     "GROUP BY sk ORDER BY sk",
     {"range": "fast_path_aggs", "hash": "fast_path_aggs",
      "gather": "fast_path_aggs"}),
]

#: join mode → (sortMergeJoin, shuffledJoin)
CROSSPROC_MODES = [("range", "true", "true"),
                   ("hash", "false", "true"),
                   ("gather", "false", "false")]

#: the execution-shape counters no other join mode may bump
CROSSPROC_JOIN_COUNTERS = ("range_merge_joins", "shuffled_joins",
                           "broadcast_joins")

#: keyed aggregates ABOVE a join of plain sides: raw rows ride the join
#: exchange, so the capped ledger's pressure lands on the reducer's drain
CROSSPROC_GRACE_QUERIES = [
    ("grace-inner",
     "SELECT sk, count(*) AS c, sum(bonus) AS sb "
     "FROM (SELECT sk FROM fact) f "
     "JOIN (SELECT k2, bonus FROM fact2) f2 ON sk = k2 "
     "GROUP BY sk ORDER BY sk"),
    ("grace-left",
     "SELECT sk, count(bonus) AS cb, count(*) AS c "
     "FROM (SELECT sk FROM fact) f "
     "LEFT JOIN (SELECT k2, bonus FROM fact2) f2 ON sk = k2 "
     "GROUP BY sk ORDER BY sk"),
    ("grace-semi",
     "SELECT sk, count(*) AS c FROM (SELECT sk FROM fact) f "
     "LEFT SEMI JOIN (SELECT k2 FROM fact2) f2 ON sk = k2 "
     "GROUP BY sk ORDER BY sk"),
    ("grace-string",
     "SELECT g, count(*) AS c, sum(bonus) AS sb "
     "FROM (SELECT g FROM fact) f "
     "JOIN (SELECT g2, bonus FROM fact2) f2 ON g = g2 "
     "GROUP BY g ORDER BY g"),
]


#: dictionary-free sides (projected to integer columns): the shape the
#: device tier takes (the JAX package worker's ``ICI_QUERIES``); the
#: unprojected battery keeps its string sides on the host tier
ICI_QUERIES = [
    ("ici-inner-agg",
     "SELECT sk, count(*) AS c, sum(bonus) AS sb "
     "FROM (SELECT sk FROM fact) f "
     "JOIN (SELECT k2, bonus FROM fact2) f2 ON sk = k2 "
     "GROUP BY sk ORDER BY sk"),
    ("ici-inner-rows",
     "SELECT sk, price, bonus FROM (SELECT sk, price FROM fact) f "
     "JOIN (SELECT k2, bonus FROM fact2) f2 ON sk = k2 "
     "WHERE bonus > 40 ORDER BY sk, price, bonus"),
    ("ici-left-agg",
     "SELECT sk, count(bonus) AS cb, count(*) AS c "
     "FROM (SELECT sk FROM fact) f "
     "LEFT JOIN (SELECT k2, bonus FROM fact2) f2 ON sk = k2 "
     "GROUP BY sk ORDER BY sk"),
]


def ici_confs(n: int) -> Dict[str, str]:
    """The device tier armed with every pid in one domain and no byte
    floor (the JAX package worker's ``ici`` mode)."""
    return {"spark.tpu.shuffle.ici.enabled": "true",
            "spark.tpu.shuffle.ici.minBytes": "0",
            "spark.tpu.shuffle.ici.tierOverride":
                ",".join(str(p) for p in range(n))}


def crossproc_tables(pid: Optional[int] = None, n: int = 1) -> dict:
    """The battery's tables (the JAX package worker's, from seed 7):
    process ``pid`` of ``n`` keeps a strided 1/n slice of the three fact
    tables, so every process sees every key range; ``dim`` is whole in
    every process (replicated).  ``pid`` None: the whole tables."""
    rng = np.random.default_rng(7)
    N, M = 900, 600
    f_sk = rng.integers(0, 40, N).astype(np.int64)
    f_sk[rng.random(N) < 0.4] = 8
    f_price = rng.integers(1, 200, N).astype(np.int64)
    f_g = np.array(["ash", "oak", "fir", "elm"])[f_sk % 4]
    k2 = (rng.integers(0, 20, M) * 2).astype(np.int64)
    b2 = rng.integers(1, 100, M).astype(np.int64)
    g2 = np.array(["ash", "oak", "fir", "pine"])[k2 % 4]
    d_sk = np.arange(0, 40, 3, dtype=np.int64)
    d_year = (1998 + d_sk % 5).astype(np.int64)
    t_words = np.array([f"row{i:04d}" for i in range(N)])
    mine = slice(None) if pid is None else slice(pid, None, n)
    return {
        "fact": {"sk": f_sk[mine], "price": f_price[mine], "g": f_g[mine]},
        "fact2": {"k2": k2[mine], "bonus": b2[mine], "g2": g2[mine]},
        "tags": {"sk2": f_sk[mine], "t": t_words[mine]},
        "dim": {"d_sk": d_sk, "year": d_year},
    }


def _json_rows(rows) -> list:
    return [[v.item() if hasattr(v, "item") else v for v in r] for r in rows]


def _crossproc_battery(xs, svc, mode: str) -> dict:
    """The worker's run of one battery; returns what the parent holds
    against the JAX package: rows per (query, join mode) and the counter
    deltas of each run."""
    from . import config as C

    def set_mode(m):
        for name, smj, sh in CROSSPROC_MODES:
            if name == m:
                xs.conf.set(C.CROSSPROC_SORT_MERGE_JOIN.key, smj)
                xs.conf.set(C.CROSSPROC_SHUFFLED_JOIN.key, sh)
                return
        raise ValueError(m)

    def run(sql, m):
        set_mode(m)
        before = dict(svc.counters)
        rows = _json_rows(tuple(r) for r in xs.sql(sql).collect())
        delta = {k: svc.counters[k] - before[k] for k in svc.counters
                 if svc.counters[k] != before[k]}
        return {"rows": rows, "delta": delta}

    out: Dict[str, Any] = {}
    if mode in ("parity", "spill", "ici"):
        for name, sql, _want in CROSSPROC_QUERIES:
            out[name] = {m: run(sql, m) for m, _s, _h in CROSSPROC_MODES}
        if mode == "ici":
            # dictionary-free sides: the device tier on both join lanes
            for name, sql in ICI_QUERIES:
                out[name] = {m: run(sql, m) for m in ("range", "hash")}
        return out
    # grace: both distributed lanes, then the elastic narrowing (a huge
    # target), then the salted re-split (one grace bucket) at both targets
    for name, sql in CROSSPROC_GRACE_QUERIES:
        out[name] = {m: run(sql, m) for m in ("range", "hash")}
    name, sql = CROSSPROC_GRACE_QUERIES[0]
    xs.conf.set(C.SHUFFLE_TARGET_PARTITION_BYTES.key, str(1 << 20))
    out["elastic"] = {m: run(sql, m) for m in ("range", "hash")}
    xs.conf.set(C.CROSSPROC_GRACE_BUCKETS.key, "1")
    out["resplit"] = {}
    for tgt in ("2048", str(1 << 20)):
        xs.conf.set(C.SHUFFLE_TARGET_PARTITION_BYTES.key, tgt)
        out["resplit"][tgt] = run(sql, "hash")
    xs.conf.unset(C.CROSSPROC_GRACE_BUCKETS.key)
    return out


def crossproc_worker(argv: Sequence[str]) -> int:
    """One process of a cross-process run over ``crossproc_tables``.

    argv: ``<pid> <n> <root> <mode> <timeout_s> <device>``.  Modes:
    ``parity`` (the battery in every join mode), ``spill`` (the same
    with a 1 KiB spill threshold and a 32 MiB host budget), ``ici`` (the
    battery with the device tier armed, every pid in one domain, then
    ``ICI_QUERIES`` on the range and hash lanes), ``grace``
    (a 7 KiB budget: the reducers' drains grace-degrade), ``kill``
    (one hash join; process 1 stops before committing its first join
    exchange and waits to be killed, the others must fail structured)
    ``card`` (``CARD_TEXTS`` over the tables of ``<root>/spec.json``,
    with K1 held against its plain version), ``ici-card`` (the device
    tier's texts over the same tables, ``_ici_card_battery``) and
    ``ici-cards`` (q93's hash lane alone on the device tier, a worker per
    card: ``<device>`` ``cuda:<pid>``), and the fault modes
    ``CROSSPROC_FAULT_MODES`` (``_crossproc_fault``).
    The answers, counters and gauges go to ``<root>/result-p<pid>.json``;
    the worker prints one line."""
    from . import config as C
    from .memory import HOST_BUDGET
    from .parallel.cluster import HeartbeatMonitor, default_host_name
    from .parallel.hostshuffle import ExchangeFetchFailed
    from .sql.session import SparkSession

    pid, n, root, mode, timeout_s, device = _worker_argv(
        "crossproc worker", argv)
    check_worker_card(device, "crossproc worker")
    if device == "cpu":
        # several workers share the host's cores: one intra-op thread each
        torch.set_num_threads(1)
    xs = SparkSession.builder.config("spark.torch.device", device) \
        .getOrCreate()
    xs.conf.set(C.MESH_SHARDS.key, "1")
    spec = None
    if mode in ("card", "ici-card", "ici-cards"):
        with open(os.path.join(root, "spec.json")) as f:
            spec = json.load(f)
        for k, v in spec.get("conf", {}).items():
            xs.conf.set(k, v)
    if mode in ("spill", "spill-fault"):
        xs.conf.set(C.SHUFFLE_SPILL_THRESHOLD.key, "1024")
        xs.conf.set(HOST_BUDGET.key, str(32 << 20))
    elif mode in ("ici", "ici-fault"):
        for k, v in ici_confs(n).items():
            xs.conf.set(k, v)
    elif mode in ("grace", "grace-fault"):
        xs.conf.set(C.SHUFFLE_SPILL_THRESHOLD.key, "1024")
        xs.conf.set(HOST_BUDGET.key, str(7 << 10))
    heartbeat = None
    if mode == "kill":
        hconf = C.Conf()
        hconf.set("spark.tpu.cluster.heartbeatIntervalMs", "100")
        hconf.set("spark.tpu.cluster.heartbeatTimeoutMs", "1500")
        heartbeat = HeartbeatMonitor(os.path.join(root, "beats"),
                                     host_id=default_host_name(pid),
                                     conf=hconf)
        heartbeat.start()
    svc = xs.enableHostShuffle(os.path.join(root, "shuffle"), pid, n,
                               timeout_s=timeout_s, heartbeat=heartbeat)
    svc.poll_s = 0.005          # one host: poll the markers often
    result: Dict[str, Any] = {"pid": pid, "mode": mode}
    if mode in ("card", "ici-card", "ici-cards"):
        from . import types as T
        t0 = time.perf_counter()
        register_card_tables(xs, T, spec, pid, n)
        result["setup_ms"] = (time.perf_counter() - t0) * 1e3
        if mode == "card":
            result["queries"] = _card_battery(xs, svc)
        elif mode == "ici-card":
            result["queries"] = _ici_card_battery(xs, svc, pid)
        else:
            result["queries"] = _ici_card_battery(xs, svc, pid,
                                                  ("c_hash",), False)
        return _finish_worker(result, svc, root, pid, mode, heartbeat)
    # a small advisory target keeps every process reducing on these tiny
    # tables; the broadcast threshold off pins each join mode's lane; 32
    # fine partitions sharpen the hot key's skew detection
    xs.conf.set(C.SHUFFLE_TARGET_PARTITION_BYTES.key, "2048")
    xs.conf.set(C.CROSSPROC_AUTO_BROADCAST.key, "0")
    xs.conf.set(C.SHUFFLE_FINE_PARTITIONS.key, "32")
    for name, cols in crossproc_tables(pid, n).items():
        xs.createDataFrame(cols).createOrReplaceTempView(name)
    if mode in CROSSPROC_FAULT_MODES:
        one = xs.newSession()           # the single-process answer
        for name, cols in crossproc_tables(None).items():
            one.createDataFrame(cols).createOrReplaceTempView(name)
        return _crossproc_fault(xs, one, svc, root, pid, mode)
    if mode == "kill":
        xs.conf.set(C.CROSSPROC_SORT_MERGE_JOIN.key, "false")
        if pid == 1:
            commit = svc.commit

            def stall(exchange, extra=None):
                if exchange.endswith("-jL"):
                    with open(os.path.join(root, "p1-at-barrier"), "w"):
                        pass
                    time.sleep(3600)
                commit(exchange, extra)
            svc.commit = stall
        t0 = time.monotonic()
        try:
            xs.sql(CROSSPROC_QUERIES[0][1]).collect()
            result["outcome"] = "finished"
        except (ExchangeFetchFailed, TimeoutError) as e:
            result.update(outcome=type(e).__name__,
                          elapsed_s=time.monotonic() - t0,
                          lost_hosts=list(getattr(e, "lost_hosts", [])))
    else:
        result["queries"] = _crossproc_battery(xs, svc, mode)
    return _finish_worker(result, svc, root, pid, mode, heartbeat)


#: the JAX package worker's fault modes: ``fault`` (the hash lane),
#: ``fault-sample`` (the range lane, whose sample round a plan can
#: address), ``spill-fault`` (the ``spill`` conf), ``grace-fault`` (the
#: ``grace`` conf, the grace text) and ``ici-fault`` (the device tier
#: armed, a dictionary-free text)
CROSSPROC_FAULT_MODES = ("fault", "fault-sample", "spill-fault",
                         "grace-fault", "ici-fault")


def _crossproc_fault(xs, one, svc, root: str, pid: int, mode: str) -> int:
    """ONE join with a ``FaultInjector`` armed from
    ``SPARK_TPU_FAULT_PLAN``; prints ``[p<pid>] OK <rows>`` (equal to
    ``one``'s single-process answer), ``[p<pid>] FAILED <s> <lost>`` (a
    structured, bounded failure), ``[p<pid>] FAILED-HOSTMEM <s> <owner>``
    (in the spill modes, a ``HostMemoryError`` naming its owner and the
    failed spill) or ``[p<pid>] PARTIAL`` (exit 1)."""
    from . import config as C
    from .memory import HostMemoryError
    from .parallel.faults import FaultInjector
    from .parallel.hostshuffle import ExchangeFetchFailed
    FaultInjector().attach(svc)
    lane = "range" if mode == "fault-sample" else "hash"
    for name, smj, sh in CROSSPROC_MODES:
        if name == lane:
            xs.conf.set(C.CROSSPROC_SORT_MERGE_JOIN.key, smj)
            xs.conf.set(C.CROSSPROC_SHUFFLED_JOIN.key, sh)
    sql = {"ici-fault": ICI_QUERIES[0][1],
           "grace-fault": CROSSPROC_GRACE_QUERIES[0][1]}.get(
               mode, CROSSPROC_QUERIES[0][1])
    spill = {"spill-fault": "spill failed",
             "grace-fault": "grace spill failed"}.get(mode)
    exp = _json_rows(tuple(r) for r in one.sql(sql).collect())
    result: Dict[str, Any] = {"pid": pid, "mode": mode, "expected": exp}
    t0 = time.time()
    try:
        got = _json_rows(tuple(r) for r in xs.sql(sql).collect())
    except HostMemoryError as e:
        if spill is None or not e.owner or spill not in str(e):
            raise
        result.update(outcome="HostMemoryError", owner=e.owner,
                      error=str(e), counters=dict(svc.counters))
        _write_result(root, pid, result)
        print(f"[p{pid}] FAILED-HOSTMEM {time.time() - t0:.2f} {e.owner}",
              flush=True)
        return 0
    except (ExchangeFetchFailed, TimeoutError) as e:
        lost = sorted(getattr(e, "lost_hosts", []) or [])
        result.update(outcome=type(e).__name__, lost_hosts=lost,
                      elapsed_s=time.time() - t0, error=str(e),
                      counters=dict(svc.counters))
        _write_result(root, pid, result)
        print(f"[p{pid}] FAILED {time.time() - t0:.2f} {lost}", flush=True)
        return 0
    result.update(outcome="ok", rows=got, counters=dict(svc.counters))
    _write_result(root, pid, result)
    counter = "range_merge_joins" if lane == "range" else "shuffled_joins"
    if spill is None and not svc.counters[counter]:
        raise AssertionError(f"expected the {counter} path: "
                             f"{dict(svc.counters)}")
    if spill is not None or got != exp:
        print(f"[p{pid}] PARTIAL got={len(got)} exp={len(exp)}", flush=True)
        return 1
    print(f"[p{pid}] OK {len(got)}", flush=True)
    return 0


def _finish_worker(result, svc, root: str, pid: int, mode: str,
                   heartbeat) -> int:
    result["counters"] = dict(svc.counters)
    result["gauges"] = svc.metrics_source().snapshot()
    path = os.path.join(root, f"result-p{pid}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(path + ".tmp", path)
    if heartbeat is not None:
        heartbeat.stop()
    print(f"[p{pid}] {mode} done", flush=True)
    return 0


# ---------------------------------------------------------------------------
# the card battery (``chip_smoke.py``'s [crossproc] phase): the worker's
# ``card`` mode over SF1 tables made from ``<root>/spec.json``
# ---------------------------------------------------------------------------

#: q93 with its reason join folded into ``sr_reason_sk = 2`` (reason's
#: keys are unique, so the rows are q93's), over [ooc]'s tables as
#: ``ss93`` / ``sr93``: store_sales LEFT JOIN store_returns on (item,
#: ticket) is the join the exchange lanes co-partition
Q93_JOIN_SQL = """
SELECT ss_customer_sk, SUM(act_sales) AS sumsales
FROM (SELECT ss_customer_sk,
             CASE WHEN sr_return_quantity IS NOT NULL
                  THEN (ss_quantity - sr_return_quantity) * ss_sales_price
                  ELSE ss_quantity * ss_sales_price END AS act_sales
      FROM ss93 LEFT OUTER JOIN sr93
           ON (sr_item_sk = ss_item_sk AND sr_ticket_number = ss_ticket_number)
      WHERE sr_reason_sk = 2) t
GROUP BY ss_customer_sk
ORDER BY sumsales, ss_customer_sk
LIMIT 100
"""

#: the same join on ONE int64 key, (ticket, item) packed as ticket *
#: 10^6 + item (items < 10^6): the range lane takes a single orderable key
Q93_PACKED_SQL = Q93_JOIN_SQL.replace(
    "ON (sr_item_sk = ss_item_sk AND sr_ticket_number = ss_ticket_number)",
    "ON (sr_ticket_number * 1000000 + sr_item_sk "
    "= ss_ticket_number * 1000000 + ss_item_sk)")

#: a generic-path text: DISTINCT over a window of q3's join
GENERIC_SQL = """
SELECT DISTINCT d_year, i_brand_id,
       dense_rank() OVER (PARTITION BY d_year ORDER BY i_brand_id) AS r
FROM store_sales JOIN date_dim ON ss_sold_date_sk = d_date_sk
     JOIN item ON ss_item_sk = i_item_sk
WHERE d_moy = 11 AND i_manufact_id = 28
ORDER BY d_year, i_brand_id
"""

#: the grace text's host ledger cap and fan-out: the cap is below each
#: process's drained reducer share (process 0 holds ~10 MB of q93's
#: sides, process 1 ~150 MB: ``plan_reducers``' skew, ROADMAP §3), so
#: both reducers grace; 64 buckets keep process 1's buckets under the cap
CARD_GRACE_CONF = {"spark.tpu.memory.hostBudget": str(4 << 20),
                   "spark.tpu.crossproc.graceBuckets": "64"}

#: (key, what it shows, text, lane counter, conf overrides) of the card
#: battery; ``hash_t`` / ``store_sales`` / ``item_p`` / ``ss93`` / ``sr93``
#: are each process's contiguous share, ``hash_r`` / ``date_dim`` /
#: ``item`` whole in every process.
CARD_TEXTS = [
    ("a", "hash-agg, fast path", HASH_AGG_SQL, "fast_path_aggs", {}),
    ("b", "q3, dimensions replicated (fast path)", Q3_SQL,
     "fast_path_aggs", {}),
    ("b2", "q3, item partitioned (broadcast lane)",
     Q3_SQL.replace("FROM date_dim, store_sales, item",
                    "FROM date_dim, store_sales, item_p item"),
     "broadcast_joins", {}),
    ("c_hash", "q93's join, hash lane", Q93_JOIN_SQL, "shuffled_joins",
     {"spark.tpu.crossproc.sortMergeJoin": "false",
      "spark.tpu.crossproc.autoBroadcastThreshold": "0"}),
    ("c_range", "q93's join on its packed key, range lane", Q93_PACKED_SQL,
     "range_merge_joins",
     {"spark.tpu.crossproc.autoBroadcastThreshold": "0"}),
    ("c_spill", "q93's join, hash lane, sides spilled", Q93_JOIN_SQL,
     "shuffled_joins",
     {"spark.tpu.crossproc.sortMergeJoin": "false",
      "spark.tpu.crossproc.autoBroadcastThreshold": "0",
      "spark.tpu.shuffle.spillThresholdBytes": str(1 << 20)}),
    ("c_grace", "q93's join, hash lane, spilled, ledger capped (grace)",
     Q93_JOIN_SQL, "grace_buckets_used",
     {"spark.tpu.crossproc.sortMergeJoin": "false",
      "spark.tpu.crossproc.autoBroadcastThreshold": "0",
      "spark.tpu.shuffle.spillThresholdBytes": str(1 << 20),
      **CARD_GRACE_CONF}),
    ("d", "DISTINCT over a window, generic path", GENERIC_SQL,
     "generic_gathers", {}),
    ("e", "hash-agg over replicated hash_r, generic path (K1)",
     HASH_AGG_SQL.replace("hash_t", "hash_r"), "generic_gathers", {}),
]


def card_tables(spec: dict):
    """The card battery's whole tables from ``spec``'s row counts and
    seeds: hash-agg's table, q3's three tables, and [ooc]'s store_sales
    and store_returns (``ooc_tables``)."""
    hash_table = hash_agg_table(spec["hash_rows"], spec["hash_groups"])
    q3 = q3_tables(spec["q3"]["store_sales"], spec["q3"]["item"],
                   spec["q3"]["date_dim"])
    ooc, _sale_rows = ooc_tables(spec["ooc"], seed=spec["ooc_seed"])
    return hash_table, q3, ooc


def register_card_tables(session, T, spec: dict, pid: Optional[int] = None,
                         n: int = 1) -> None:
    """The card battery's views on ``session``: process ``pid`` of ``n``
    holds the contiguous ``pid``-th share of the partitioned tables;
    ``pid`` None registers every table whole (the single-process
    answer)."""
    hash_table, q3, ooc = card_tables(spec)

    def share(cols):
        if pid is None:
            return cols
        rows = len(next(iter(cols.values())))
        lo, hi = pid * rows // n, (pid + 1) * rows // n
        return {k: v[lo:hi] for k, v in cols.items()}

    def view(name, cols, schema_cols):
        st = T.StructType([T.StructField(c, T.type_for_name(t))
                           for c, t in schema_cols])
        session.createDataFrame(cols, schema=st) \
            .createOrReplaceTempView(name)

    session.createDataFrame(share(hash_table)) \
        .createOrReplaceTempView("hash_t")
    session.createDataFrame(hash_table).createOrReplaceTempView("hash_r")
    view("store_sales", share(q3["store_sales"]), Q3_SCHEMAS["store_sales"])
    view("date_dim", q3["date_dim"], Q3_SCHEMAS["date_dim"])
    view("item", q3["item"], Q3_SCHEMAS["item"])
    view("item_p", share(q3["item"]), Q3_SCHEMAS["item"])
    view("ss93", share(ooc["store_sales"]), OOC_SCHEMAS["store_sales"])
    view("sr93", share(ooc["store_returns"]), OOC_SCHEMAS["store_returns"])


def jsonable_rows(rows) -> list:
    """Result rows as JSON values: decimals as strings, dates ISO."""
    import datetime
    import decimal

    def conv(v):
        if hasattr(v, "item"):
            v = v.item()
        if isinstance(v, decimal.Decimal):
            return str(v)
        if isinstance(v, (datetime.date, datetime.datetime)):
            return v.isoformat()
        return v
    return [[conv(v) for v in r] for r in rows]


class _K1Compare:
    """A spy on ``cuda_agg.grouped_accumulate_columns`` that holds each
    call made outside a graph capture against its plain version on the
    same inputs (a captured launch's output exists only at replay; its
    warm-up twin ran just before it, on the same data).  It counts no
    launch: ``cuda_agg.ENTRY_LAUNCHES`` does, where the kernel starts."""

    def __init__(self):
        from . import cuda_agg
        self.mod = cuda_agg
        self.launch = cuda_agg.grouped_accumulate_columns
        self.checked = 0
        self.max_abs_err = 0
        self.equal = True

    def __call__(self, bucket32, planes, n_active, B):
        out = self.launch(bucket32, planes, n_active, B)
        if bucket32.is_cuda and torch.cuda.is_current_stream_capturing():
            return out
        want = self.mod.grouped_accumulate_columns_plain(bucket32, planes,
                                                         n_active, B)
        err = int((out - want).abs().max()) if out.numel() else 0
        self.max_abs_err = max(self.max_abs_err, err)
        self.equal = self.equal and bool(torch.equal(out, want))
        self.checked += 1
        return out

    def __enter__(self):
        self.mod.grouped_accumulate_columns = self
        return self

    def __exit__(self, *exc):
        self.mod.grouped_accumulate_columns = self.launch


#: the hand-written kernels by the name of their ``__global__`` function
_OWN_KERNELS = {"k1": "grouped_accumulate_kernel", "k2": "all_to_all_kernel"}


def _timed_run(fn, profiled: bool
               ) -> Tuple[Any, float, Optional[float], Dict[str, int]]:
    """(result, wall ms, device-busy ms, {k1, k2: kernels the card ran})
    of one run; with ``profiled`` the run is under ``torch.profiler``
    recording the card alone (kernels and copies, graph replays
    included), else, or when it saw no device activity, the busy ms is
    None and the kernel counts are empty."""
    if not profiled:
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3, None, {}
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) for e in events)
    ran = {kid: sum(e.count for e in events if name in e.key)
           for kid, name in _OWN_KERNELS.items()}
    return out, wall, (us / 1e3 if us > 0 else None), ran


def _card_battery(xs, svc) -> dict:
    """Each card text: a cold run, then one warm run — on a card under
    the profiler — whose wall, split and busy share are reported.  K1's
    and K2's wrapper launches are counted from 0 just before the
    battery (``cuda_agg.ENTRY_LAUNCHES``, ``cuda_a2a.LAUNCHES``); the
    warm run's kernels, graph replays included, come from its
    profile."""
    from . import cuda_a2a, cuda_agg
    from .parallel import crossproc as X
    out: Dict[str, Any] = {}
    timer_keys = ("encode_s", "write_s", "decode_s", "fetch_s",
                  "commit_wait_s", "barrier_s")
    for entry in cuda_agg.ENTRY_LAUNCHES:
        cuda_agg.ENTRY_LAUNCHES[entry] = 0
        cuda_agg.CAPTURED_LAUNCHES[entry] = 0
    cuda_a2a.LAUNCHES = 0
    with _K1Compare() as k1:
        for key, _what, sql, lane, confs in CARD_TEXTS:
            for k, v in confs.items():
                xs.conf.set(k, v)
            try:
                before = dict(svc.counters)
                k1_before = dict(cuda_agg.ENTRY_LAUNCHES)
                a2a_before = cuda_a2a.LAUNCHES
                t0 = time.perf_counter()
                xs.sql(sql).collect()
                cold_ms = (time.perf_counter() - t0) * 1e3
                X.reset_stats()
                timers0 = dict(svc.timers)
                warm_before = dict(svc.counters)
                k1_warm = sum(cuda_agg.ENTRY_LAUNCHES.values())
                a2a_warm = cuda_a2a.LAUNCHES
                svc.ledger.peak = svc.ledger.used
                rows, wall_ms, busy_ms, ran = _timed_run(
                    lambda: xs.sql(sql).collect(), xs.device.type == "cuda")
                split = {k: float(v) for k, v in X.STATS.items()}
                split.update({k[:-2] + "_ms":
                              (svc.timers[k] - timers0[k]) * 1e3
                              for k in timer_keys})
                warm = {k: svc.counters[k] - warm_before[k]
                        for k in svc.counters
                        if svc.counters[k] != warm_before[k]}
                peak = svc.ledger.peak
            finally:
                for k in confs:
                    xs.conf.unset(k)
            warm_eager = {
                "k1": sum(cuda_agg.ENTRY_LAUNCHES.values()) - k1_warm,
                "k2": cuda_a2a.LAUNCHES - a2a_warm}
            out[key] = {
                "rows": jsonable_rows(tuple(r) for r in rows),
                "lane": lane,
                "delta": {k: svc.counters[k] - before[k]
                          for k in svc.counters
                          if svc.counters[k] != before[k]},
                "warm_delta": warm, "cold_ms": cold_ms,
                "wall_ms": wall_ms, "split": split, "peak_host_bytes": peak,
                "busy_ms": busy_ms,
                "k1_launches": {e: cuda_agg.ENTRY_LAUNCHES[e] - k1_before[e]
                                for e in k1_before},
                "k2_launches": cuda_a2a.LAUNCHES - a2a_before,
                # kernels the warm run's profile saw, and those beyond
                # the wrapper launches it made: the graph replays
                "profiled": ran,
                "replayed": {kid: ran[kid] - warm_eager[kid] for kid in ran},
            }
    out["_k1"] = {"launches": dict(cuda_agg.ENTRY_LAUNCHES),
                  "captured": dict(cuda_agg.CAPTURED_LAUNCHES),
                  "checked": k1.checked, "max_abs_err": k1.max_abs_err,
                  "equal": k1.equal}
    return out


# ---------------------------------------------------------------------------
# the device tier on the card (``chip_smoke.py``'s [ici] phase): the
# worker's ``ici-card`` mode over the tables of ``<root>/spec.json``
# ---------------------------------------------------------------------------

#: the [ici] texts (keys of ``CARD_TEXTS``): q93's join on the hash, range
#: and spilled faces take the device tier; q3's fast path (string sides)
#: keeps the host tier
ICI_CARD_KEYS = ("c_hash", "c_range", "c_spill", "b")

#: the run counters the JAX package moves on q93's join over run-coded
#: shards (``tests/test_torch_runs.py`` holds the port to the same set):
#: the shards enter the receiving stage as run planes, which the join
#: expands inside the stage
ICI_RUN_COUNTERS = ("run_plane_stages", "run_plane_rows",
                    "run_plane_expansions")


def _ici_card_battery(xs, svc, pid: int, keys=ICI_CARD_KEYS,
                      whole: bool = True) -> dict:
    """[ici]'s runs in one worker (see ``chip_smoke.py``): each text of
    ``keys`` cold on the device tier with every pull held against its
    plain version (``ici.CHECK_ENV``), then warm in turns (device, host,
    host, device); with ``whole``, c_hash once with ``tierOverride`` 0,1;
    c_hash and c_range on the host tier with run codes; last, in process
    1 only, ``ici_unavailable`` on c_hash's first device attempt.  K2's
    pull launches count from 0 just before the battery
    (``cuda_a2a.PULL_LAUNCHES``).  ``[cards]`` runs q93's hash lane alone
    (``ici-cards``: ``keys`` ("c_hash",), not ``whole``), one worker on
    each of two cards."""
    from . import columnar as _col
    from . import cuda_a2a
    from .parallel import ici
    from .parallel.faults import FaultInjector, FaultPlan
    texts = {k: (sql, lane, confs) for k, _w, sql, lane, confs in CARD_TEXTS
             if k in ICI_CARD_KEYS}
    tier_key = "spark.tpu.shuffle.ici.enabled"

    def run(key, tier: bool, extra=None, check=False):
        sql, lane, confs = texts[key]
        confs = dict(confs, **(extra or {}))
        confs[tier_key] = "true" if tier else "false"
        for k, v in confs.items():
            xs.conf.set(k, v)
        if check:
            os.environ[ici.CHECK_ENV] = "1"
        try:
            before = dict(svc.counters)
            stats0 = dict(ici.STATS)
            runs0 = _col.run_counters()
            pulls0 = cuda_a2a.PULL_LAUNCHES
            t0 = time.perf_counter()
            rows = xs.sql(sql).collect()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            os.environ.pop(ici.CHECK_ENV, None)
            for k in confs:
                xs.conf.unset(k)
        runs1 = _col.run_counters()
        return {"rows": jsonable_rows(tuple(r) for r in rows),
                "lane": lane, "tier": tier, "wall_ms": wall_ms,
                "delta": {k: svc.counters[k] - before[k]
                          for k in svc.counters
                          if svc.counters[k] != before[k]},
                "split": {k: ici.STATS[k] - stats0[k] for k in ici.STATS},
                "runs": {k: runs1[k] - runs0[k] for k in runs1},
                "pull_launches": cuda_a2a.PULL_LAUNCHES - pulls0}

    cuda_a2a.PULL_LAUNCHES = 0
    ici.reset_stats()
    out: Dict[str, Any] = {}
    for key in keys:
        out[key] = {"cold": run(key, True, check=True)}
    for key in keys:
        out[key]["warm"] = [run(key, t) for t in (True, False, False, True)]
    if not whole:
        out["_check"] = dict(ici.CHECK)
        out["_pull_launches"] = cuda_a2a.PULL_LAUNCHES
        return out
    out["override"] = run("c_hash", True, extra={
        "spark.tpu.shuffle.ici.tierOverride": "0,1"})
    out["runcodes"] = {key: run(key, False, extra={
        "spark.tpu.shuffle.wire.runCodes": "true"})
        for key in ("c_hash", "c_range")}
    out["_check"] = dict(ici.CHECK)
    out["_pull_launches"] = cuda_a2a.PULL_LAUNCHES
    if pid == 1:
        FaultInjector(FaultPlan().ici_unavailable()).attach(svc)
    out["unavailable"] = run("c_hash", True)
    return out


# ---------------------------------------------------------------------------
# recovery: the JAX package's ``tests/recovery_worker.py`` modes, and the
# card scenarios of ``chip_smoke.py``'s [recovery] phase
# ---------------------------------------------------------------------------

#: the recovery battery's text (the JAX package worker's)
RECOVERY_SQL = ("SELECT sk, count(*) AS c, sum(bonus) AS sb FROM fact "
                "JOIN fact2 ON sk = k2 GROUP BY sk ORDER BY sk")

#: the generic-lane keyed aggregate of scenario (d): a UNION ALL of two
#: partitioned file sets (the fast path needs exactly one partitioned
#: leaf), so every process gathers both and runs the aggregate, K1,
#: locally
RECOVERY_UNION_SQL = ("SELECT k, SUM(v) AS s, COUNT(*) AS c FROM "
                      "(SELECT k, v FROM hash_a UNION ALL "
                      "SELECT k, v FROM hash_b) u GROUP BY k ORDER BY k")

#: the hash lane of the join modes: no broadcast, no range lane
_HASH_LANE = {"spark.tpu.shuffle.targetPartitionBytes": "2048",
              "spark.tpu.crossproc.autoBroadcastThreshold": "0",
              "spark.tpu.crossproc.sortMergeJoin": "false",
              "spark.tpu.crossproc.shuffledJoin": "true"}

#: mode → conf pairs of the recovery worker's session (the JAX package
#: worker's settings).  ``card-*`` are the card scenarios: (a) recover,
#: (b) no retry budget, (c) the block service with no retry budget, (d)
#: the generic lane.
RECOVERY_MODES = {
    "recover": dict(_HASH_LANE),
    "norecover": dict(_HASH_LANE, **{
        "spark.tpu.recovery.maxStageRetries": "0"}),
    # a host budget below every reducer's drained share: the survivor is
    # mid-grace when the loss surfaces, and grace-degrades again on the
    # re-execution over the whole data
    "grace-recover": dict(_HASH_LANE, **{
        "spark.tpu.shuffle.targetPartitionBytes": "14336",
        "spark.tpu.shuffle.spillThresholdBytes": "1024",
        "spark.tpu.memory.hostBudget": str(4 << 10)}),
    "bs-zero": dict(_HASH_LANE, **{
        "spark.tpu.blockserver.enabled": "true",
        "spark.tpu.recovery.maxStageRetries": "0"}),
    "bs-adopt": dict(_HASH_LANE, **{"spark.tpu.blockserver.enabled": "true"}),
    "bs-recover": dict(_HASH_LANE, **{
        "spark.tpu.blockserver.enabled": "true"}),
    "bs-unavail": dict(_HASH_LANE, **{
        "spark.tpu.blockserver.enabled": "true"}),
    "card-a": {"spark.tpu.crossproc.sortMergeJoin": "false",
               "spark.tpu.crossproc.autoBroadcastThreshold": "0"},
    "card-b": {"spark.tpu.crossproc.sortMergeJoin": "false",
               "spark.tpu.crossproc.autoBroadcastThreshold": "0",
               "spark.tpu.recovery.maxStageRetries": "0"},
    "card-c": {"spark.tpu.crossproc.sortMergeJoin": "false",
               "spark.tpu.crossproc.autoBroadcastThreshold": "0",
               "spark.tpu.blockserver.enabled": "true",
               "spark.tpu.recovery.maxStageRetries": "0"},
    "card-d": {},
    # the device tier on (ici-recover: every pid of two in one domain;
    # card-ici: the auto probe, both on one card): a peer that dies at
    # its copy point, or is refused the tier, is survived
    "ici-recover": dict(_HASH_LANE, **ici_confs(2)),
    "ici-unavail": dict(_HASH_LANE, **ici_confs(2)),
    "card-ici": {"spark.tpu.crossproc.sortMergeJoin": "false",
                 "spark.tpu.crossproc.autoBroadcastThreshold": "0",
                 "spark.tpu.shuffle.ici.enabled": "true"},
}


def recovery_tables(mode: str, pid: Optional[int] = None,
                    n: int = 1) -> dict:
    """The recovery battery's tables (the JAX package worker's, seed 7):
    process ``pid`` of ``n`` holds a strided 1/n slice; ``pid`` None the
    whole tables.  ``grace-recover`` widens keys and rows so every
    reducer's drained share of each side overflows its budget."""
    rng = np.random.default_rng(7)
    N, M = 900, 600
    f_sk = rng.integers(0, 40, N).astype(np.int64)
    f_price = rng.integers(1, 200, N).astype(np.int64)
    k2 = (rng.integers(0, 20, M) * 2).astype(np.int64)
    b2 = rng.integers(1, 100, M).astype(np.int64)
    if mode == "grace-recover":
        N, M = 1500, 1000
        f_sk = rng.integers(0, 200, N).astype(np.int64)
        f_price = rng.integers(1, 200, N).astype(np.int64)
        k2 = (rng.integers(0, 100, M) * 2).astype(np.int64)
        b2 = rng.integers(1, 100, M).astype(np.int64)
    mine = slice(None) if pid is None else slice(pid, None, n)
    return {"fact": {"sk": f_sk[mine], "price": f_price[mine]},
            "fact2": {"k2": k2[mine], "bonus": b2[mine]}}


def recovery_oracle(mode: str) -> list:
    """numpy's answer to ``RECOVERY_SQL`` over the whole tables."""
    t = recovery_tables(mode)
    sk, k2, bonus = t["fact"]["sk"], t["fact2"]["k2"], t["fact2"]["bonus"]
    out = []
    for key in np.unique(sk):
        m = int((k2 == key).sum())
        if m:
            c = int((sk == key).sum())
            out.append([int(key), c * m,
                        c * int(bonus[k2 == key].sum())])
    return out


def _card_recovery_views(session, T, spec: dict, mode: str, root: str,
                         pid: Optional[int], n: int) -> Tuple[str, float]:
    """Scenario ``mode``'s tables on ``session`` and its text: process
    ``pid`` writes its contiguous share to parquet under ``root`` and
    reads it back (every leaf a file with a recipe); ``pid`` None
    registers the whole tables in memory (the single-process answer).
    Returns (text, ms spent writing)."""
    def share(cols, lo_frac=0.0, hi_frac=1.0):
        rows = len(next(iter(cols.values())))
        if pid is not None:
            lo_frac, hi_frac = ((pid + lo_frac) / n, (pid + hi_frac) / n)
        lo, hi = int(lo_frac * rows), int(hi_frac * rows)
        return {k: v[lo:hi] for k, v in cols.items()}

    if mode == "card-d":
        hash_table = hash_agg_table(spec["hash_rows"], spec["hash_groups"])
        # each process's share split in two file sets: a UNION ALL of two
        # partitioned leaves
        views = {"hash_a": (share(hash_table, 0.0, 0.5), None),
                 "hash_b": (share(hash_table, 0.5, 1.0), None)}
        text = RECOVERY_UNION_SQL
    else:
        ooc, _sale_rows = ooc_tables(spec["ooc"], seed=spec["ooc_seed"])
        views = {"ss93": (share(ooc["store_sales"]),
                          OOC_SCHEMAS["store_sales"]),
                 "sr93": (share(ooc["store_returns"]),
                          OOC_SCHEMAS["store_returns"])}
        text = Q93_JOIN_SQL
    t0 = time.perf_counter()
    for name, (cols, schema_cols) in views.items():
        st = None if schema_cols is None else T.StructType(
            [T.StructField(c, T.type_for_name(t)) for c, t in schema_cols])
        df = session.createDataFrame(cols, schema=st)
        if pid is None:
            df.createOrReplaceTempView(name)
            continue
        path = os.path.join(root, "leaves", f"{name}-p{pid}")
        df.write.parquet(path)
        session.read.parquet(path).createOrReplaceTempView(name)
    return text, (time.perf_counter() - t0) * 1e3


def recovery_worker(argv: Sequence[str]) -> int:
    """One process of a recovery scenario.

    argv: ``<pid> <n> <root> <mode> <timeout_s> <device>``, modes as in
    ``RECOVERY_MODES``.  Each process writes its share of the tables to
    parquet under ``<root>/leaves`` and reads it back, so every leaf is a
    file whose recipe the digest round publishes.  A ``FaultInjector``
    armed from ``SPARK_TPU_FAULT_PLAN`` kills the victim (exit 43); a
    heartbeat turns its silence into a blacklist exclusion.  The
    ``card-*`` modes read ``<root>/spec.json`` (``card_tables``' sizes),
    run the text twice without a fault first (cold, then warm: the
    no-fault wall), so their plans name ``xq000003``.

    Prints ``[p<pid>] OK <rows> retries=.. recovered=.. epoch=..
    grace=.. adopted=..`` after the mode's counter checks, ``[p<pid>]
    FAILED <elapsed> <lost hosts>`` on a structured failure, or
    ``[p<pid>] PARTIAL`` (exit 1) when the rows differ from this
    package's single-process answer; writes ``<root>/result-p<pid>.json``."""
    from . import config as C
    from . import types as T
    from .parallel import crossproc as X
    from .parallel.cluster import HeartbeatMonitor, default_host_name
    from .parallel.faults import FaultInjector
    from .parallel.hostshuffle import ExchangeFetchFailed
    from .sql.session import SparkSession
    from .sql.stagecompile import stage_cache

    pid, n, root, mode, timeout_s, device = _worker_argv(
        "recovery worker", argv)
    check_worker_card(device, "recovery worker")
    if device == "cpu":
        torch.set_num_threads(1)    # the workers share the host's cores
    card = mode.startswith("card-")
    base = SparkSession.builder.config("spark.torch.device", device) \
        .getOrCreate()
    base.conf.set(C.MESH_SHARDS.key, "1")
    result: Dict[str, Any] = {"pid": pid, "mode": mode}
    one = base.newSession()
    xs = base.newSession()
    if card:
        with open(os.path.join(root, "spec.json")) as f:
            spec = json.load(f)
        text, _ms = _card_recovery_views(one, T, spec, mode, root, None, n)
        text, result["write_ms"] = _card_recovery_views(
            xs, T, spec, mode, root, pid, n)
        hb_conf = spec.get("heartbeat", {})
        for k, v in spec.get("conf", {}).items():
            xs.conf.set(k, v)
    else:
        text = RECOVERY_SQL
        for name, cols in recovery_tables(mode).items():
            one.createDataFrame(cols).createOrReplaceTempView(name)
        for name, cols in recovery_tables(mode, pid, n).items():
            path = os.path.join(root, "leaves", f"{name}-p{pid}")
            xs.createDataFrame(cols).write.parquet(path)
            xs.read.parquet(path).createOrReplaceTempView(name)
        # fast detection: the victim's silence becomes a blacklist
        # exclusion well inside one exchange deadline
        hb_conf = {"spark.tpu.cluster.heartbeatIntervalMs": "100",
                   "spark.tpu.cluster.heartbeatTimeoutMs": "1500"}
    exp = jsonable_rows(tuple(r) for r in one.sql(text).collect())
    for k, v in dict(RECOVERY_MODES[mode], **hb_conf).items():
        xs.conf.set(k, v)
    hb = HeartbeatMonitor(os.path.join(root, "beats"),
                          host_id=default_host_name(pid), conf=xs.conf_obj)
    hb.start()
    svc = xs.enableHostShuffle(os.path.join(root, "shuffle"), pid, n,
                               timeout_s=timeout_s, heartbeat=hb)
    svc.poll_s = 0.005          # one host: poll the markers often
    injector = FaultInjector()
    died_at = os.path.join(root, f"died-p{pid}")

    def die(code):
        with open(died_at, "w") as f:
            f.write(repr(time.time()))
        os._exit(code)
    injector.die = die
    injector.attach(svc)
    if card:
        from . import cuda_a2a, cuda_agg
        for run in ("cold_ms", "warm_ms"):
            t0 = time.perf_counter()
            xs.sql(text).collect()
            result[run] = (time.perf_counter() - t0) * 1e3
        for entry in cuda_agg.ENTRY_LAUNCHES:
            cuda_agg.ENTRY_LAUNCHES[entry] = 0
            cuda_agg.CAPTURED_LAUNCHES[entry] = 0
        cuda_a2a.LAUNCHES = 0
    X.reset_recovery_stats()
    stage0 = stage_cache().stats()
    before = dict(svc.counters)
    t0 = time.perf_counter()
    wall0 = time.time()
    try:
        with _K1Compare() as k1:
            got = jsonable_rows(tuple(r) for r in xs.sql(text).collect())
    except (ExchangeFetchFailed, TimeoutError) as e:
        lost = sorted(getattr(e, "lost_hosts", []) or [])
        elapsed = time.perf_counter() - t0
        result.update(outcome=type(e).__name__, elapsed_s=elapsed,
                      lost_hosts=lost, counters=dict(svc.counters),
                      recovery=dict(X.RECOVERY_STATS),
                      ledger_used=int(svc.ledger.used))
        _write_result(root, pid, result)
        print(f"[p{pid}] FAILED {elapsed:.2f} {lost}", flush=True)
        hb.stop()
        return 0
    wall_ms = (time.perf_counter() - t0) * 1e3
    c = svc.counters
    gauges = svc.metrics_source().snapshot()
    result.update(
        outcome="ok", rows=got, expected=exp, wall_ms=wall_ms,
        wall_start=wall0, counters=dict(c), gauges=gauges,
        delta={k: c[k] - before[k] for k in c if c[k] != before[k]},
        recovery=dict(X.RECOVERY_STATS),
        # graphs captured (a new stage entry's first, or a variant's)
        # and new stage entries, in the faulted statement
        graph_builds=stage_cache().stats()["variants"] - stage0["variants"],
        stage_builds=stage_cache().stats()["builds"] - stage0["builds"],
        ledger_used=int(svc.ledger.used))
    if card:
        from . import cuda_a2a, cuda_agg
        result["k1"] = {"launches": dict(cuda_agg.ENTRY_LAUNCHES),
                        "captured": dict(cuda_agg.CAPTURED_LAUNCHES),
                        "checked": k1.checked, "equal": k1.equal,
                        "max_abs_err": k1.max_abs_err}
        result["k2_launches"] = cuda_a2a.LAUNCHES
    _write_result(root, pid, result)
    hb.stop()
    if not _rows_equal(got, exp):
        print(f"[p{pid}] PARTIAL got={len(got)} exp={len(exp)}", flush=True)
        return 1
    problem = _recovery_mode_problem(mode, c, gauges)
    if problem:
        print(f"[p{pid}] CHECK {problem}: {dict(c)}", flush=True)
        return 1
    print(f"[p{pid}] OK {len(got)} retries={c['stage_retries']} "
          f"recovered={c['recovered_partitions']} epoch={gauges['epoch']} "
          f"grace={c['grace_buckets_used']} "
          f"adopted={c['manifests_adopted']}m/{c['blocks_adopted']}b "
          f"fallback={c['blockserver_fallback_reads']} "
          f"unavail={c['blockserver_unavailable']}", flush=True)
    return 0


def _rows_equal(got, exp, rtol: float = 1e-9) -> bool:
    """Rows equal: floats within ``rtol``, everything else exactly."""
    if len(got) != len(exp):
        return False
    for g, w in zip(got, exp):
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                if a is None or b is None \
                        or abs(a - b) > rtol * max(abs(a), abs(b)) + 1e-12:
                    return False
            elif a != b:
                return False
    return True


def _recovery_mode_problem(mode: str, c: dict, g: dict) -> str:
    """What a finished survivor's counters break of its mode's contract
    (the JAX package worker's assertions), or ''."""
    want = {
        "recover": c["stage_retries"] >= 1 and c["recovered_partitions"] > 0
        and g["epoch"] >= 1,
        "grace-recover": c["stage_retries"] >= 1 and g["epoch"] >= 1
        and c["grace_buckets_used"] > 0 and c["grace_spill_bytes"] > 0
        and 0 < g["peak_host_bytes"] <= g["host_budget_bytes"],
        "bs-zero": c["stage_retries"] == 0 and g["epoch"] == 0
        and c["blocks_adopted"] >= 1
        and c["blockserver_fallback_reads"] >= 1,
        "bs-adopt": c["manifests_adopted"] >= 1 and c["stage_retries"] >= 1,
        "bs-recover": c["manifests_adopted"] == 0
        and c["stage_retries"] >= 1,
        "bs-unavail": c["blockserver_unavailable"] >= 1
        and c["blocks_adopted"] == 0 and c["stage_retries"] >= 1,
        "norecover": c["stage_retries"] == 0,
        "card-a": c["stage_retries"] >= 1 and g["epoch"] >= 1,
        "card-b": c["stage_retries"] == 0,
        "card-c": c["stage_retries"] == 0 and g["epoch"] == 0
        and c["blocks_adopted"] >= 1,
        "card-d": c["stage_retries"] >= 1 and g["epoch"] >= 1,
        "ici-recover": c["stage_retries"] >= 1 and g["epoch"] >= 1,
        "ici-unavail": c["stage_retries"] == 0 and g["epoch"] == 0,
        "card-ici": c["stage_retries"] >= 1 and g["epoch"] >= 1,
    }
    return "" if want[mode] else f"mode {mode} contract"


def _write_result(root: str, pid: int, result: dict) -> None:
    path = os.path.join(root, f"result-p{pid}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(path + ".tmp", path)


# ---------------------------------------------------------------------------
# the elastic pool: the JAX package's ``tests/pool_worker.py`` modes
# ---------------------------------------------------------------------------

POOL_TABLE_ROWS = [[1, "a", 10], [2, "b", 20], [3, "c", 30]]
POOL_SQL = "SELECT id, name, v FROM pool_t ORDER BY id"


def _pool_reap(pid: int, n: int, root: str, timeout_s: float,
               device: str) -> int:
    """Mode ``reap``: the ``bs-zero`` join where process 1 is
    cooperatively REAPED the moment its last manifest (``-gather``)
    lands: it stops beating (its beat goes stale, as a dead one would),
    hands its block-service lease to the pool supervisor's identity and
    releases its own, prints OK and leaves.  Process 0 must land the
    single-process answer from block-service custody alone (retry budget
    0), with the reaped worker's lease still fresh through the heir."""
    from . import config as C
    from .parallel.cluster import HeartbeatMonitor, default_host_name
    from .parallel.faults import FaultInjector
    from .parallel.hostshuffle import ExchangeFetchFailed
    from .serving.pool import SUPERVISOR_OWNER
    from .sql.session import SparkSession

    base = SparkSession.builder.config("spark.torch.device", device) \
        .getOrCreate()
    base.conf.set(C.MESH_SHARDS.key, "1")
    one, xs = base.newSession(), base.newSession()
    for name, cols in recovery_tables("bs-zero").items():
        one.createDataFrame(cols).createOrReplaceTempView(name)
    for name, cols in recovery_tables("bs-zero", pid, n).items():
        path = os.path.join(root, "leaves", f"{name}-p{pid}")
        xs.createDataFrame(cols).write.parquet(path)
        xs.read.parquet(path).createOrReplaceTempView(name)
    exp = _json_rows(tuple(r) for r in one.sql(RECOVERY_SQL).collect())
    for k, v in RECOVERY_MODES["bs-zero"].items():
        xs.conf.set(k, v)
    xs.conf.set("spark.tpu.cluster.heartbeatIntervalMs", "100")
    xs.conf.set("spark.tpu.cluster.heartbeatTimeoutMs", "1500")
    hb = HeartbeatMonitor(os.path.join(root, "beats"),
                          host_id=default_host_name(pid), conf=xs.conf_obj)
    hb.start()
    svc = xs.enableHostShuffle(os.path.join(root, "shuffle"), pid, n,
                               timeout_s=timeout_s, heartbeat=hb)
    svc.poll_s = 0.005
    FaultInjector().attach(svc)      # the drop rule, from the environment
    store = svc.blockclient.store
    if pid == 1:
        orig_commit, orig_publish = svc.commit, svc.publish_manifest

        def maybe_reap(exchange):
            if not exchange.endswith("-gather"):
                return
            hb.stop()                    # the beat file stays: it goes stale
            store.handoff_lease(default_host_name(pid), SUPERVISOR_OWNER)
            store.release_lease(default_host_name(pid))
            print(f"[p{pid}] OK reaped at {exchange} "
                  f"lease->{SUPERVISOR_OWNER}", flush=True)
            os._exit(0)

        def commit(exchange, extra=None):
            orig_commit(exchange, extra=extra)
            maybe_reap(exchange)

        def publish_manifest(exchange, payload=None):
            out = orig_publish(exchange, payload)
            maybe_reap(exchange)
            return out
        svc.commit, svc.publish_manifest = commit, publish_manifest
    t0 = time.perf_counter()
    try:
        got = _json_rows(tuple(r) for r in xs.sql(RECOVERY_SQL).collect())
    except (ExchangeFetchFailed, TimeoutError) as e:
        print(f"[p{pid}] FAILED {time.perf_counter() - t0:.2f} "
              f"{sorted(getattr(e, 'lost_hosts', []) or [])}", flush=True)
        return 1
    hb.stop()
    c = svc.counters
    _write_result(root, pid, {"pid": pid, "rows": got, "counters": dict(c)})
    if not _rows_equal(got, exp):
        print(f"[p{pid}] PARTIAL got={len(got)} exp={len(exp)}", flush=True)
        return 1
    fresh = store.lease_fresh(default_host_name(1), time.time())
    if c["stage_retries"] or svc.epoch or not c["blocks_adopted"] \
            or not c["blockserver_fallback_reads"] or not fresh:
        print(f"[p{pid}] CHECK reap contract (heir lease fresh: {fresh}): "
              f"{dict(c)}", flush=True)
        return 1
    print(f"[p{pid}] OK {len(got)} retries=0 "
          f"adopted={c['blocks_adopted']}b "
          f"fallback={c['blockserver_fallback_reads']} heir-lease=fresh",
          flush=True)
    return 0


def _pool_supervisor(session, root: str, wh: str, demand):
    from . import config as C
    from .serving.pool import WorkerPoolSupervisor
    conf = session.conf_obj
    for k, v in ((C.SERVER_POOL_MAX_WORKERS, "4"),
                 (C.SERVER_POOL_STATEMENTS_PER_WORKER, "2"),
                 (C.SERVER_POOL_SCALE_DOWN_ROUNDS, "2"),
                 (C.SERVER_POOL_COOLDOWN, "0.0"),
                 (C.SERVER_POOL_POLL, "0.1")):
        conf.set(k.key, v)
    sup = WorkerPoolSupervisor(os.path.join(root, "_pool"), conf,
                               lambda: demand[0], warehouse=wh)
    sup.start(reconcile=False)
    return sup


#: the JAX package's chaos feeds: one parquet file each, one micro-batch
#: each (maxFilesPerTrigger 1), in the same order in every lifetime
STREAM_FEEDS = [
    [(1, "a", 1), (9, "b", 2)],
    [(20, "a", 4), (21, "b", 1)],
    [(35, "c", 8), (35, "c", 8)],
    [(50, "a", 3), (51, "d", 9)],
]


def write_stream_feed(session, in_dir: str, i: int) -> None:
    """Feed ``i`` of ``STREAM_FEEDS`` as the parquet file ``in_dir/f<i>``
    (timestamps in seconds)."""
    rows = STREAM_FEEDS[i]
    session.createDataFrame({
        "ts": np.array([r[0] * 1_000_000 for r in rows], "datetime64[us]"),
        "k": [r[1] for r in rows],
        "v": np.array([r[2] for r in rows], np.int64),
    }).write.parquet(os.path.join(in_dir, f"f{i}"))


def _sink_files(out: str) -> Dict[str, bytes]:
    """A file sink's part files by name, as bytes."""
    import glob
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(out, "part-*")))}


def _pool_scaleup(pid: int, root: str, timeout_s: float,
                  device: str) -> int:
    """Mode ``scaleup``: the pool grows while a windowed aggregate
    stands, and the stream does not see it.  Two micro-batches with the
    pool empty; a burst makes the supervisor spawn a real worker, which
    proves itself by serving a statement; two more micro-batches; the
    sink must equal an uninterrupted no-pool lifetime's byte for byte,
    and idle demand then reaps the worker."""
    from .serving.admission import DemandSignal
    from .sql.session import SparkSession

    deadline = time.monotonic() + 3 * timeout_s
    wh = os.path.join(root, "warehouse")
    session = SparkSession.builder.config("spark.torch.device", device) \
        .config("spark.sql.warehouse.dir", wh).getOrCreate()
    session.conf.set("spark.sql.warehouse.dir", wh)
    session.createDataFrame(
        [tuple(r) for r in POOL_TABLE_ROWS], ["id", "name", "v"]) \
        .write.saveAsTable("pool_t")
    in_dir = os.path.join(root, "in")
    os.makedirs(in_dir, exist_ok=True)

    ckpt, out = os.path.join(root, "ckpt"), os.path.join(root, "out")
    write_stream_feed(session, in_dir, 0)
    write_stream_feed(session, in_dir, 1)
    stream_lifetime(session, "wagg", in_dir, ckpt, out)
    demand = [DemandSignal(queued=2)]
    sup = _pool_supervisor(session, root, wh, demand)
    try:
        d = sup.tick()
        served = None
        while served is None and time.monotonic() < deadline:
            served = sup.execute(POOL_SQL, timeout_s=timeout_s)
        if d.action != "up" or served is None \
                or served["rows"] != POOL_TABLE_ROWS \
                or served.get("pooled") is not True:
            print(f"[p{pid}] FAILED the pool did not grow and serve "
                  f"({d}, {served})", flush=True)
            return 1
        write_stream_feed(session, in_dir, 2)
        write_stream_feed(session, in_dir, 3)
        ex = stream_lifetime(session, "wagg", in_dir, ckpt, out)
        got = _sink_files(out)
        stream_lifetime(session, "wagg", in_dir,
                        os.path.join(root, "oracle_ckpt"),
                        os.path.join(root, "oracle_out"))
        exp = _sink_files(os.path.join(root, "oracle_out"))
        if got != exp or not exp:
            print(f"[p{pid}] PARTIAL got={sorted(got)} exp={sorted(exp)}",
                  flush=True)
            return 1
        demand[0] = DemandSignal()
        while sup.live > 0 and time.monotonic() < deadline:
            sup.tick()
            time.sleep(0.05)
        c = dict(sup.counters)
    finally:
        sup.stop()
    if sup.live or not c["workers_reaped"]:
        print(f"[p{pid}] CHECK scaleup contract: {c}", flush=True)
        return 1
    print(f"[p{pid}] OK {len(got)} spawned={c['workers_spawned']} "
          f"reaped={c['workers_reaped']} "
          f"served={c['pool_statements_served']} "
          f"rebuilds={ex.progress[-1]['stageRebuilds']}", flush=True)
    return 0


def _pool_spawn_fail(pid: int, root: str, timeout_s: float,
                     device: str) -> int:
    """Mode ``spawn-fail``: a real ``WorkerPoolSupervisor`` whose exec
    seam is armed from ``SPARK_TPU_FAULT_PLAN``
    (``spawn_exec_error(after_spawns=1)``).  Demand wants 2 workers; the
    second exec raises; the pool settles at 1, counts ``spawn_failures``
    on every retry tick, the one worker serves a spooled statement, and
    idle demand then reaps it through hysteresis."""
    from .parallel.faults import FaultInjector
    from .serving.admission import DemandSignal
    from .sql.session import SparkSession

    deadline = time.monotonic() + 3 * timeout_s
    wh = os.path.join(root, "warehouse")
    session = SparkSession.builder.config("spark.torch.device", device) \
        .config("spark.sql.warehouse.dir", wh).getOrCreate()
    session.conf.set("spark.sql.warehouse.dir", wh)
    session.createDataFrame(
        [tuple(r) for r in POOL_TABLE_ROWS], ["id", "name", "v"]) \
        .write.saveAsTable("pool_t")
    demand = [DemandSignal(queued=4)]       # wants ceil(4 / 2) = 2
    sup = _pool_supervisor(session, root, wh, demand)
    FaultInjector().attach_pool(sup)
    try:
        d = sup.tick()
        ok = (d.action == "up" and d.target == 2
              and sup.counters["spawn_failures"] >= 1 and sup.live == 1)
        sup.tick()
        ok = ok and sup.counters["spawn_failures"] >= 2 and sup.live == 1
        served = None
        while served is None and time.monotonic() < deadline:
            served = sup.execute(POOL_SQL, timeout_s=timeout_s)
        if served is None or served["rows"] != POOL_TABLE_ROWS \
                or served.get("pooled") is not True:
            print(f"[p{pid}] FAILED the pool never served ({served})",
                  flush=True)
            return 1
        demand[0] = DemandSignal()           # idle: hysteresis, then reap
        while sup.live > 0 and time.monotonic() < deadline:
            sup.tick()
            time.sleep(0.05)
        c = dict(sup.counters)
        ok = ok and sup.live == 0 and c["workers_reaped"] >= 1
    finally:
        sup.stop()
    if not ok:
        print(f"[p{pid}] CHECK spawn-fail contract: {c}", flush=True)
        return 1
    print(f"[p{pid}] OK spawn_failures={c['spawn_failures']} "
          f"spawned={c['workers_spawned']} reaped={c['workers_reaped']} "
          f"served={c['pool_statements_served']}", flush=True)
    return 0


def pool_worker(argv: Sequence[str]) -> int:
    """argv: ``<pid> <n> <root> <mode> <timeout_s> <device>``; modes
    ``reap`` (2 processes), ``spawn-fail`` and ``scaleup`` (1)."""
    pid, n, root, mode, timeout_s, device = _worker_argv("pool worker",
                                                         argv)
    check_worker_card(device, "pool worker")
    if device == "cpu":
        torch.set_num_threads(1)
    if mode == "reap":
        return _pool_reap(pid, n, root, timeout_s, device)
    if mode == "spawn-fail":
        return _pool_spawn_fail(pid, root, timeout_s, device)
    if mode == "scaleup":
        return _pool_scaleup(pid, root, timeout_s, device)
    raise ValueError(f"pool worker mode {mode!r}")


# ---------------------------------------------------------------------------
# the chaos matrix (the JAX package's ``tests/chaos_matrix.py``): every
# fault scenario against real processes, with the exchange phase it lands
# in, its tier and its verdict per process
# ---------------------------------------------------------------------------

#: the exchange phases the matrix covers
CHAOS_PHASES = ("map-staging", "post-publish-sizes", "mid-fetch",
                "mid-demotion", "during-recovery", "during-grace",
                "post-register", "mid-device-copy")
#: the streaming commit phases its ``--streaming`` group kills at
STREAM_PHASES = ("post-state-commit", "mid-commit")


def _scenario(name, phase, worker, mode, n, timeout_s, plans, expect,
              tier="slow"):
    return {"name": name, "phase": phase, "worker": worker, "mode": mode,
            "n": n, "timeout_s": timeout_s, "plans": plans,
            "expect": expect, "tier": tier}


def chaos_scenarios() -> List[dict]:
    """name, exchange phase, worker entry, mode, process count, exchange
    timeout, victim pid → FaultPlan builder, the verdict per pid and the
    tier (``tier1`` or ``slow``).  Verdicts: ``OK`` (the single-process
    answer), ``FAILED`` (structured and bounded), ``HOSTMEM`` (the
    structured spill abort, ``FAILED-HOSTMEM``) or ``DIED`` (exit 43, the
    planned kill)."""
    from .parallel.faults import FaultPlan as P
    return [
        _scenario("mid-fetch-kill", "mid-fetch", "recovery-worker",
                  "recover", 2, 20.0,
                  {1: lambda: P().die_after_put("xq000001-jL")},
                  {0: "OK", 1: "DIED"}, tier="tier1"),
        _scenario("mid-fetch-kill-noretry", "mid-fetch", "recovery-worker",
                  "norecover", 2, 8.0,
                  {1: lambda: P().die_after_put("xq000001-jL")},
                  {0: "FAILED", 1: "DIED"}, tier="tier1"),
        _scenario("grace-kill", "during-grace", "recovery-worker",
                  "grace-recover", 2, 20.0,
                  {1: lambda: P().die_after_manifest("xq000001-jR")},
                  {0: "OK", 1: "DIED"}, tier="tier1"),
        _scenario("blockserver-adopt-zero-rerun", "post-register",
                  "recovery-worker", "bs-zero", 2, 20.0,
                  {1: lambda: P().drop(exchange="xq000001-jR", receiver=0)
                   .die_after_manifest("xq000001-gather")},
                  {0: "OK", 1: "DIED"}, tier="tier1"),
        _scenario("grace-kill-3proc", "during-grace", "recovery-worker",
                  "grace-recover", 3, 20.0,
                  {2: lambda: P().die_after_manifest("xq000001-jR")},
                  {0: "OK", 1: "OK", 2: "DIED"}),
        # p2 dies mid-fetch, p1 publishes its recovery manifest and dies:
        # the round agrees, but epoch 1 loses p1 past the budget
        _scenario("recovery-round-kill", "during-recovery",
                  "recovery-worker", "recover", 3, 12.0,
                  {2: lambda: P().die_after_put("xq000001-jL"),
                   1: lambda: P().die_after_manifest("xq000001-recover1")},
                  {0: "FAILED", 1: "DIED", 2: "DIED"}),
        _scenario("map-staging-kill", "map-staging", "recovery-worker",
                  "recover", 2, 12.0,
                  {1: lambda: P().die_after_manifest("xq000001-digest")},
                  {0: "OK", 1: "DIED"}),
        _scenario("post-publish-sizes-kill", "post-publish-sizes",
                  "recovery-worker", "recover", 2, 12.0,
                  {1: lambda: P().die_after_manifest("xq000001-plan")},
                  {0: "OK", 1: "DIED"}),
        # the adaptive broadcast gather loses its peer; in-memory leaves
        # mean no lineage: a structured abort
        _scenario("mid-demotion-kill", "mid-demotion", "adaptive-worker",
                  "fault-adapt", 2, 6.0,
                  {1: lambda: P().die_after_put("xq000001-bcast")},
                  {0: "FAILED", 1: "DIED"}),
        # live but faulty peers: declared lost, the survivor recovers
        # from their file lineage while they abort bounded
        _scenario("block-dropped-alive-peer", "mid-fetch",
                  "recovery-worker", "recover", 2, 6.0,
                  {1: lambda: P().drop(exchange="xq000001-jL", receiver=0)},
                  {0: "OK", 1: "FAILED"}),
        _scenario("block-corrupted-alive-peer", "mid-fetch",
                  "recovery-worker", "recover", 2, 6.0,
                  {1: lambda: P().corrupt(exchange="xq000001-jL",
                                          receiver=0)},
                  {0: "OK", 1: "FAILED"}),
        _scenario("block-truncated-noretry", "mid-fetch", "recovery-worker",
                  "norecover", 2, 6.0,
                  {1: lambda: P().truncate(exchange="xq000001-jL",
                                           keep_bytes=3)},
                  {0: "FAILED", 1: "FAILED"}),
        _scenario("slow-peer-heals", "mid-fetch", "recovery-worker",
                  "norecover", 2, 8.0,
                  {1: lambda: P().delay(0.3, exchange="xq000001-jL")},
                  {0: "OK", 1: "OK"}),
        _scenario("commit-skipped", "map-staging", "recovery-worker",
                  "norecover", 2, 5.0,
                  {1: lambda: P().skip_commit(exchange="xq000001-jL")},
                  {0: "FAILED", 1: "FAILED"}),
        # disk pressure: the forced spill hits an injected ENOSPC
        _scenario("spill-disk-full", "map-staging", "crossproc-worker",
                  "spill-fault", 2, 8.0,
                  {1: lambda: P().disk_full(after_bytes=0)},
                  {0: "FAILED", 1: "HOSTMEM"}),
        # ENOSPC during the grace pass itself: the one unspillable shape
        _scenario("grace-disk-full", "during-grace", "crossproc-worker",
                  "grace-fault", 2, 8.0,
                  {1: lambda: P().disk_full(after_bytes=0,
                                            exchange="xq000001-grace")},
                  {0: "FAILED", 1: "HOSTMEM"}),
        _scenario("blockserver-adopt-sealed-manifest", "post-register",
                  "recovery-worker", "bs-adopt", 2, 20.0,
                  {1: lambda: P().die_during_register("xq000001-jR",
                                                      after_seal=True)},
                  {0: "OK", 1: "DIED"}),
        _scenario("blockserver-die-mid-register", "post-register",
                  "recovery-worker", "bs-recover", 2, 20.0,
                  {1: lambda: P().die_during_register("xq000001-jR")},
                  {0: "OK", 1: "DIED"}),
        _scenario("blockserver-unavailable-fallback", "mid-fetch",
                  "recovery-worker", "bs-unavail", 2, 20.0,
                  {0: lambda: P().blockserver_unavailable(),
                   1: lambda: P().drop(exchange="xq000001-jR", receiver=0)
                   .die_after_manifest("xq000001-jR")},
                  {0: "OK", 1: "DIED"}),
        # the device tier refused in process 0 at every exchange: its
        # spans fold back onto the host tier, both processes answer
        _scenario("ici-unavailable-fallback", "mid-device-copy",
                  "crossproc-worker", "ici-fault", 2, 8.0,
                  {0: lambda: P().ici_unavailable()},
                  {0: "OK", 1: "OK"}),
        # process 0 exits at the copy point; in-memory leaves give no
        # lineage, so process 1 fails bounded at the host commit barrier
        _scenario("ici-die-mid-device-copy-noretry", "mid-device-copy",
                  "crossproc-worker", "ici-fault", 2, 8.0,
                  {0: lambda: P().die_mid_device_copy()},
                  {0: "DIED", 1: "FAILED"}),
        _scenario("pool-reap-mid-fetch", "post-register", "pool-worker",
                  "reap", 2, 20.0,
                  {1: lambda: P().drop(exchange="xq000001-jR",
                                       receiver=0)},
                  {0: "OK", 1: "OK"}, tier="tier1"),
        _scenario("pool-spawn-exec-error", "worker-spawn", "pool-worker",
                  "spawn-fail", 1, 20.0,
                  {0: lambda: P().spawn_exec_error(after_spawns=1)},
                  {0: "OK"}),
        # the pool grows while a windowed aggregate stands; the stream's
        # sink stays byte-identical to a no-pool lifetime's
        _scenario("pool-scaleup-midstream", "mid-standing-query",
                  "pool-worker", "scaleup", 1, 60.0, {}, {0: "OK"}),
    ]


def ici_scenarios() -> List[dict]:
    """The device tier's recovery scenarios (two processes, one domain by
    override): process 1 refused the tier on its first join exchange
    (its spans fold back onto the host tier, both answer), and process 1
    dying at the device tier's copy point (recovered in an epoch)."""
    from .parallel.faults import FaultPlan as P
    return [
        _scenario("ici-unavailable-one-sided", "mid-device-copy",
                  "recovery-worker", "ici-unavail", 2, 20.0,
                  {1: lambda: P().ici_unavailable("xq000001-jL")},
                  {0: "OK", 1: "OK"}),
        _scenario("ici-die-mid-device-copy", "mid-device-copy",
                  "recovery-worker", "ici-recover", 2, 20.0,
                  {1: lambda: P().die_mid_device_copy("xq000001-jL")},
                  {0: "OK", 1: "DIED"}),
    ]


def stream_scenarios() -> List[dict]:
    """Kill-at-phase against a real standing query (``stream-chaos``
    worker): process 1 runs the stream and dies at the planned commit
    phase; process 0 restarts it over the same checkpoint and holds the
    sink byte for byte against an uninterrupted lifetime's."""
    from .parallel.faults import FaultPlan as P
    torn = {1: lambda: P().torn_checkpoint(keep_bytes=11, after_entries=1,
                                           die=True)}
    after = {1: lambda: P().die_after_state_commit(after_entries=1)}
    return [
        _scenario("stream-die-post-state-commit", "post-state-commit",
                  "stream-chaos", "wagg", 2, 60.0, after,
                  {0: "OK", 1: "DIED"}),
        _scenario("stream-die-post-state-commit-dedup", "post-state-commit",
                  "stream-chaos", "dedup", 2, 60.0, after,
                  {0: "OK", 1: "DIED"}),
        _scenario("stream-torn-commit-kill", "mid-commit", "stream-chaos",
                  "wagg", 2, 60.0, torn, {0: "OK", 1: "DIED"}),
        _scenario("stream-torn-commit-kill-dedup", "mid-commit",
                  "stream-chaos", "dedup", 2, 60.0, torn,
                  {0: "OK", 1: "DIED"}),
    ]


def matrix_scenarios() -> List[dict]:
    """The whole exchange matrix: ``chaos_scenarios``, ``ici_scenarios``
    and ``analysis_scenarios``, in that order."""
    return chaos_scenarios() + ici_scenarios() + analysis_scenarios()


def kinds_covered() -> set:
    """Every fault kind some scenario of any list injects."""
    kinds = set()
    for sc in matrix_scenarios() + stream_scenarios():
        for build in sc["plans"].values():
            kinds.update(r.kind for r in build().rules)
    return kinds


def all_kinds() -> set:
    """Every fault kind ``parallel.faults`` can inject."""
    from .parallel.faults import _KINDS
    return set(_KINDS)


def chaos_scenario(name: str) -> dict:
    for sc in matrix_scenarios() + stream_scenarios():
        if sc["name"] == name:
            return sc
    raise KeyError(name)


def run_scenario(sc: dict, root: str, device: str,
                 deadline_s: Optional[float] = None):
    """Start the scenario's processes on ``root`` on ``device`` (``cuda``,
    ``cuda:N`` or ``cpu``, required; output to files: an unread pipe blocks a
    worker at its next barrier), wait for them, kill any left over, and
    return ``({pid: (exit code, output)}, elapsed s)``."""
    if not worker_device(device):
        raise ValueError(f"run_scenario: device is cuda or cpu (or cuda:N, "
                         f"card N); got {device!r}")
    import subprocess
    from .parallel.faults import FAULT_PLAN_ENV
    os.makedirs(root, exist_ok=True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base_env = dict(os.environ)
    base_env["PYTHONPATH"] = repo + os.pathsep + base_env.get("PYTHONPATH",
                                                              "")
    base_env.pop(FAULT_PLAN_ENV, None)
    procs = {}
    t0 = time.monotonic()
    for pid in range(sc["n"]):
        env = dict(base_env)
        build = sc["plans"].get(pid)
        if build is not None:
            env[FAULT_PLAN_ENV] = build().to_env()
        log = open(os.path.join(root, f"log-p{pid}.txt"), "w")
        procs[pid] = (subprocess.Popen(
            [sys.executable, "-m", "spark_tpu_torch.testing", sc["worker"],
             str(pid), str(sc["n"]), root, sc["mode"],
             str(sc["timeout_s"]), device],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=repo), log)
    if deadline_s is None:
        deadline_s = 60 + 6 * sc["timeout_s"]
    t_end = time.monotonic() + deadline_s
    results = {}
    try:
        for pid, (p, _log) in procs.items():
            try:
                p.wait(timeout=max(1.0, t_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for pid, (p, log) in procs.items():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
            with open(os.path.join(root, f"log-p{pid}.txt")) as f:
                results[pid] = (p.returncode, f.read())
    return results, time.monotonic() - t0


def check_scenario(sc: dict, results, elapsed: float) -> List[str]:
    """The verdict: what broke the scenario's contract (empty = pass).
    Every faulted run recovers to the single-process answer or aborts
    structured within ``3 x timeout + slack``; ``PARTIAL`` never
    appears.  ``DIED`` wants exit 43; every other verdict exit 0 and
    ``[p<i>] <verdict>`` in the process's last line, ``HOSTMEM`` as
    ``[p<i>] FAILED-HOSTMEM``."""
    bad = []
    bound = 3 * sc["timeout_s"] + 30
    if elapsed >= bound:
        bad.append(f"elapsed {elapsed:.1f}s >= bound {bound:.1f}s")
    for pid, want in sc["expect"].items():
        rc, out = results[pid]
        lines = [ln for ln in out.splitlines() if f"[p{pid}]" in ln]
        last = lines[-1] if lines else ""
        token = f"[p{pid}] " + ("FAILED-HOSTMEM" if want == "HOSTMEM"
                                else want)
        if "PARTIAL" in out:
            bad.append(f"p{pid}: PARTIAL result surfaced")
        if want == "DIED":
            if rc != 43:
                bad.append(f"p{pid}: rc {rc} != 43 (planned kill)")
        elif rc != 0:
            bad.append(f"p{pid}: rc {rc} != 0 ({last!r})")
        elif token not in last:
            bad.append(f"p{pid}: expected {want}, got {last!r}")
    return bad


# ---------------------------------------------------------------------------
# streaming: the Yahoo Streaming Benchmark's shape, its oracles, the worker
# ---------------------------------------------------------------------------

#: the public ``yahoo/streaming-benchmarks`` configuration: 100 campaigns
#: of 10 ads, three event types, event-time windows of 10 s per campaign
YAHOO_CAMPAIGNS = 100
YAHOO_ADS_PER_CAMPAIGN = 10
YAHOO_EVENT_TYPES = ("view", "click", "purchase")
YAHOO_AD_TYPES = ("banner", "modal", "sponsored-search", "mail", "mobile")
YAHOO_WINDOW_S = 10
YAHOO_WATERMARK_S = 10
#: event time a trigger's file covers, and how late its events may be
YAHOO_TRIGGER_S = 10
YAHOO_LATE_S = 2
_US = 1_000_000


def yahoo_ads(seed: int = 0) -> Dict[str, np.ndarray]:
    """The static ad → campaign table (1,000 ads)."""
    n = YAHOO_CAMPAIGNS * YAHOO_ADS_PER_CAMPAIGN
    rng = np.random.default_rng(seed)
    return {"ad_id": np.arange(n, dtype=np.int64),
            "campaign_id": (rng.permutation(n) // YAHOO_ADS_PER_CAMPAIGN)
            .astype(np.int64)}


def _yahoo_base(n: int, trigger: int, seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed * 1000 + trigger)
    lo = (trigger * YAHOO_TRIGGER_S - YAHOO_LATE_S) * _US
    span = (YAHOO_TRIGGER_S + YAHOO_LATE_S) * _US
    ad = rng.integers(0, YAHOO_CAMPAIGNS * YAHOO_ADS_PER_CAMPAIGN, n)
    return {
        "user_id": rng.integers(0, 1 << 20, n).astype(np.int64),
        "page_id": rng.integers(0, 1 << 20, n).astype(np.int64),
        "ad_id": ad.astype(np.int64),
        "ad_type": np.asarray(YAHOO_AD_TYPES)[ad % len(YAHOO_AD_TYPES)],
        "event_type": np.asarray(YAHOO_EVENT_TYPES)[
            rng.integers(0, len(YAHOO_EVENT_TYPES), n)],
        # millisecond event times, so keys repeat as a real feed's do
        "event_time": (lo + rng.integers(0, span // 1000, n) * 1000)
        .astype(np.int64),
        "ip_address": rng.integers(0, 1 << 32, n).astype(np.int64),
    }


def yahoo_events(n: int, trigger: int, seed: int = 0
                 ) -> Dict[str, np.ndarray]:
    """One trigger's ad events (``event_time`` in int64 microseconds):
    10 s of event time from ``trigger * 10 s`` with up to 2 s of
    lateness; 1/32 of the rows repeat an earlier row's (user_id,
    event_time) of the same trigger and 1/64 one of the previous
    trigger's (duplicates for the dedup scenario)."""
    ev = _yahoo_base(n, trigger, seed)
    rng = np.random.default_rng(seed * 1000 + trigger + 500)
    dup = rng.choice(n, n // 32, replace=False)
    src = rng.integers(0, n, n // 32)
    for col in ("user_id", "event_time"):
        ev[col][dup] = ev[col][src]
    if trigger > 0:
        prev = _yahoo_base(n, trigger - 1, seed)
        rows = rng.choice(n, n // 64, replace=False)
        take = rng.integers(0, n, n // 64)
        for col in ("user_id", "event_time"):
            ev[col][rows] = prev[col][take]
    return ev


def yahoo_write(session, root: str, n: int, triggers: int,
                seed: int = 0, feeds: Optional[list] = None) -> List[str]:
    """Each trigger's events written by the port's writer as one parquet
    directory ``root/f<t>``; returns them in trigger order (and appends
    each trigger's numpy events to ``feeds``)."""
    from . import types as T
    from .columnar import PrebuiltColumn
    out = []
    for t in range(triggers):
        ev = yahoo_events(n, t, seed)
        if feeds is not None:
            feeds.append(ev)
        cols = {}
        for name, data in ev.items():
            if data.dtype.kind == "U":
                # dictionary-coded as the engine holds strings: the sorted
                # values and each row's code (no Python object per row)
                dic = np.unique(data)
                cols[name] = PrebuiltColumn(
                    np.searchsorted(dic, data).astype(np.int32), T.string,
                    None, tuple(dic.tolist()))
            else:
                cols[name] = PrebuiltColumn(
                    data, T.timestamp if name == "event_time" else T.int64,
                    None)
        path = os.path.join(root, f"f{t}")
        session.createDataFrame(cols).write.parquet(path)
        out.append(path)
    return out


YAHOO_STREAM_SCHEMA = (
    "user_id long, page_id long, ad_id long, ad_type string, "
    "event_type string, event_time timestamp, ip_address long")


def yahoo_stream(session, in_dir: str):
    """The events directory as a stream, one file per trigger."""
    return (session.readStream.format("parquet")
            .schema(YAHOO_STREAM_SCHEMA)
            .option("maxFilesPerTrigger", 1).load(in_dir))


def yahoo_campaign_counts(session, F, events, ads_df):
    """Scenario (a)/(b): views joined to the ad table, counted per
    campaign per 10 s tumbling window under a 10 s watermark."""
    return (events.withWatermark("event_time", f"{YAHOO_WATERMARK_S} seconds")
            .filter(F.col("event_type") == "view")
            .join(ads_df, "ad_id")
            .groupBy(F.window("event_time", f"{YAHOO_WINDOW_S} seconds")
                     .alias("w"), "campaign_id")
            .agg(F.count("*").alias("n")))


def _yahoo_window_keys(feed, campaign_of):
    views = feed["event_type"] == "view"
    w = (feed["event_time"] // (YAHOO_WINDOW_S * _US)) * YAHOO_WINDOW_S * _US
    return views, w, campaign_of[feed["ad_id"]]


def yahoo_counts_oracle(feeds, ads, mode: str) -> List[dict]:
    """Per trigger, the rows scenario (a) (``update``: every group this
    trigger touched, with its count so far) or (b) (``append``: the
    windows the advanced watermark finalized) must emit, as
    {(window start us, campaign): count}; and the groups the state
    holds after the trigger."""
    campaign_of = np.empty(len(ads["ad_id"]), np.int64)
    campaign_of[ads["ad_id"]] = ads["campaign_id"]
    wm = None
    state: Dict[tuple, int] = {}
    out = []
    dur = YAHOO_WINDOW_S * _US
    for feed in feeds:
        views, w, camp = _yahoo_window_keys(feed, campaign_of)
        keep = views.copy()
        if wm is not None:
            keep &= (w + dur) > wm           # not late: its window is open
        keys, counts = np.unique(np.stack([w[keep], camp[keep]]), axis=1,
                                 return_counts=True) \
            if keep.any() else (np.zeros((2, 0), np.int64), [])
        touched = []
        for (ws, c), k in zip(keys.T.tolist(), list(counts)):
            state[(ws, c)] = state.get((ws, c), 0) + int(k)
            touched.append((ws, c))
        mx = int(feed["event_time"].max())
        cand = mx - YAHOO_WATERMARK_S * _US
        if wm is None or cand > wm:
            wm = cand
        final = {k: v for k, v in state.items() if k[0] + dur <= wm}
        if mode == "update":
            emit = {k: state[k] for k in touched}
        else:
            emit = final
        for k in final:
            del state[k]
        out.append({"emit": emit, "state_groups": len(state),
                    "evicted": len(final), "watermark": wm})
    return out


def yahoo_dedup_keys(user_id: np.ndarray, event_time_us: np.ndarray
                     ) -> np.ndarray:
    """One int64 per (user_id, event_time) key of scenario (c)."""
    return user_id.astype(np.int64) * (1 << 32) \
        + (event_time_us // 1000 + (1 << 20))


def yahoo_dedup_oracle(feeds, delay_s: int) -> List[dict]:
    """Per trigger, scenario (c)'s dropDuplicates(["user_id",
    "event_time"]) under a ``delay_s`` watermark: the (user_id,
    event_time) keys emitted (sorted, packed as user * 2^32 + the event
    time in ms + 2^20), the keys the state holds and those evicted."""
    wm = None
    state = np.zeros(0, np.int64)
    state_t = np.zeros(0, np.int64)
    out = []
    for feed in feeds:
        t = feed["event_time"]
        key = yahoo_dedup_keys(feed["user_id"], t)
        keep = np.ones(len(t), bool) if wm is None else t >= wm
        k = key[keep]
        tk = t[keep]
        uniq, first = np.unique(k, return_index=True)
        new = ~np.isin(uniq, state)
        emitted = uniq[new]
        state = np.concatenate([state, emitted])
        state_t = np.concatenate([state_t, tk[first[new]]])
        cand = int(t.max()) - delay_s * _US
        if wm is None or cand > wm:
            wm = cand
        live = state_t >= wm
        evicted = int((~live).sum())
        state, state_t = state[live], state_t[live]
        out.append({"emit": np.sort(emitted), "state_rows": len(state),
                    "evicted": evicted, "watermark": wm})
    return out


def stream_join_sides(n: int, trigger: int, seed: int = 0
                      ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """One trigger's views and clicks for scenario (d): ``n`` of each
    over 2^14 users and 1,000 ads; half of the clicks follow a view of
    the same (user, ad) of this trigger or the last one, 0–5 s later."""
    def views_of(t):
        rng = np.random.default_rng(seed * 1000 + 700 + t)
        lo = (t * YAHOO_TRIGGER_S - YAHOO_LATE_S) * _US
        return {"user_id": rng.integers(0, 1 << 14, n).astype(np.int64),
                "ad_id": rng.integers(0, 1000, n).astype(np.int64),
                "view_time": (lo + rng.integers(
                    0, (YAHOO_TRIGGER_S + YAHOO_LATE_S) * 1000, n) * 1000)
                .astype(np.int64)}
    views = views_of(trigger)
    pool = views if trigger == 0 else {
        k: np.concatenate([v, views_of(trigger - 1)[k]])
        for k, v in views.items()}
    rng = np.random.default_rng(seed * 1000 + 900 + trigger)
    half = n // 2
    pick = rng.integers(0, len(pool["user_id"]), half)
    lo = trigger * YAHOO_TRIGGER_S * _US
    clicks = {
        "c_user_id": np.concatenate([
            pool["user_id"][pick],
            rng.integers(0, 1 << 14, n - half)]).astype(np.int64),
        "c_ad_id": np.concatenate([
            pool["ad_id"][pick],
            rng.integers(0, 1000, n - half)]).astype(np.int64),
        "click_time": np.concatenate([
            pool["view_time"][pick] + rng.integers(0, 5000, half) * 1000,
            lo + rng.integers(0, YAHOO_TRIGGER_S * 1000, n - half) * 1000])
        .astype(np.int64)}
    return views, clicks


def _pairs(a_key, b_key):
    """Index pairs (i, j) with a_key[i] == b_key[j]."""
    order = np.argsort(b_key, kind="stable")
    sb = b_key[order]
    lo = np.searchsorted(sb, a_key, "left")
    hi = np.searchsorted(sb, a_key, "right")
    cnt = hi - lo
    ai = np.repeat(np.arange(len(a_key)), cnt)
    starts = np.repeat(lo, cnt)
    offs = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return ai, order[starts + offs]


def stream_join_oracle(sides, delay_s: int) -> List[dict]:
    """Per trigger, scenario (d)'s inner join of views and clicks on
    (ad_id, user_id) with the watermark on the views: the joined rows as
    sorted (view_time, click_time, user, ad) tuples packed in an int64
    array of shape (m, 4), and the views the buffer keeps.  Each trigger
    emits ΔV ⋈ (C ∪ ΔC) ∪ V ⋈ ΔC against the buffered past rows; views
    older than the advanced watermark leave their buffer after the join;
    clicks never leave (the watermark is on the views)."""
    def key(u, a):
        return u * 1000 + a
    vbuf = {k: np.zeros(0, np.int64) for k in ("user_id", "ad_id",
                                               "view_time")}
    cbuf = {k: np.zeros(0, np.int64) for k in ("c_user_id", "c_ad_id",
                                               "click_time")}
    wm = None
    mx = None
    out = []
    for views, clicks in sides:
        call = {k: np.concatenate([cbuf[k], clicks[k]]) for k in cbuf}
        rows = []
        for v, c in ((views, call), (vbuf, clicks)):
            i, j = _pairs(key(v["user_id"], v["ad_id"]),
                          key(c["c_user_id"], c["c_ad_id"]))
            rows.append(np.stack([v["view_time"][i], c["click_time"][j],
                                  v["user_id"][i], v["ad_id"][i]], 1))
        joined = np.concatenate(rows)
        joined = joined[np.lexsort(joined.T[::-1])]
        m = int(views["view_time"].max())
        mx = m if mx is None else max(mx, m)
        cand = mx - delay_s * _US
        if wm is None or cand > wm:
            wm = cand
        vall = {k: np.concatenate([vbuf[k], views[k]]) for k in vbuf}
        keep = vall["view_time"] >= wm
        vbuf = {k: x[keep] for k, x in vall.items()}
        cbuf = call
        out.append({"rows": joined, "view_buffer": int(keep.sum()),
                    "click_buffer": len(cbuf["c_user_id"]),
                    "watermark": wm})
    return out


#: scenario (e): per-user session counts over 2^14 events of 1,000 users
#: in four triggers, a session closing 12 s of event time after its last
#: event, under a 2 s watermark
SESSION_GAP_S = 12
SESSION_WATERMARK_S = 2


def session_events(n: int, triggers: int, users: int, seed: int = 0):
    """Per trigger, (user, event time us) rows: the users of trigger t
    are a sliding window of ``users`` * 2/5 ids, so earlier users go
    quiet and their sessions time out."""
    width = users * 2 // 5
    step = (users - width) // max(triggers - 1, 1)
    rng = np.random.default_rng(seed + 31)
    out = []
    for t in range(triggers):
        u = rng.integers(t * step, t * step + width, n // triggers)
        et = (t * YAHOO_TRIGGER_S * 1000
              + rng.integers(0, YAHOO_TRIGGER_S * 1000, len(u))) * 1000
        out.append(list(zip(u.tolist(), et.tolist())))
    return out


def session_fn(key, rows, state):
    """The user function of scenario (e): the running event count of a
    user's session, closed (and emitted with ``closed``) once the
    watermark passes ``SESSION_GAP_S`` after its last event."""
    if state.hasTimedOut:
        n = state.get()
        state.remove()
        return [(key[0], n, True)]
    n = (state.getOption() or 0) + len(rows)
    state.update(n)
    state.setTimeoutTimestamp(max(r["et"] for r in rows)
                              + SESSION_GAP_S * _US)
    return [(key[0], n, False)]


def session_oracle(feeds) -> List[list]:
    """Per trigger, the sorted (user, count, closed) rows of scenario
    (e), by plain dictionaries: each user seen in the trigger emits its
    running count; a user absent from it whose last event is more than
    the gap behind the advanced watermark emits its closed count and
    leaves."""
    state: Dict[int, Tuple[int, int]] = {}      # user -> (count, timeout)
    mx = None
    wm = None
    out = []
    for rows in feeds:
        m = max(e for _u, e in rows)
        mx = m if mx is None else max(mx, m)
        cand = mx - SESSION_WATERMARK_S * _US
        wm = cand if wm is None or cand > wm else wm
        seen: Dict[int, List[int]] = {}
        for u, e in rows:
            seen.setdefault(u, []).append(e)
        emit = []
        before = dict(state)
        for u, es in seen.items():
            n = before.get(u, (0, None))[0] + len(es)
            state[u] = (n, max(es) + SESSION_GAP_S * _US)
            emit.append((u, n, False))
        for u, (n, to) in before.items():
            if u not in seen and to < wm:
                emit.append((u, n, True))
                del state[u]
        out.append(sorted(emit))
    return out


def _host_columns(batch) -> Dict[str, np.ndarray]:
    """A host result batch's live rows as numpy columns (codes decoded
    for strings)."""
    host = batch.packed_host()
    rv = None if host.row_valid is None else host.row_valid.numpy()
    out = {}
    for name, v in zip(host.names, host.vectors):
        data = v.data.numpy()
        if v.dictionary is not None:
            data = np.asarray(v.dictionary, object)[
                np.clip(data, 0, max(len(v.dictionary) - 1, 0))] \
                if len(v.dictionary) else data.astype(object)
        out[name] = data if rv is None else data[rv]
    return out


def _drive(q, files, in_dir, captured, step):
    """One trigger per file: the file's directory appears in ``in_dir``
    (a symlink), ``q.processAllAvailable()`` runs it (through ``step``,
    which may time or profile it and returns a dict of what it
    measured); returns per trigger the captured sink output, the
    engine's time split, its progress entry and metrics."""
    out = []
    for f in files:
        os.symlink(f, os.path.join(in_dir, os.path.basename(f)))
        n0 = len(captured)
        measured = (step or (lambda fn: (fn(), {})[1]))(q.processAllAvailable)
        ex = q._ex
        out.append({"emit": captured[n0] if len(captured) > n0 else None,
                    "timings": dict(ex.timings),
                    "progress": dict(ex.progress[-1]),
                    "metrics": dict(ex.metrics), **measured})
    return out


def stream_counts(session, F, in_dir: str, files: Sequence[str], ads_df,
                  mode: str, step=None) -> List[dict]:
    """Scenario (a) (``update``) or (b) (``append``) through readStream
    and a foreachBatch sink, one trigger per file; each trigger's
    ``emit`` is {(window start us, campaign): count}."""
    captured: List[dict] = []

    def sink(bdf, _bid):
        c = _host_columns(bdf._plan.batch)
        captured.append({(int(w), int(k)): int(n) for w, k, n in
                         zip(c["w"], c["campaign_id"], c["n"])})

    os.makedirs(in_dir, exist_ok=True)
    q = (yahoo_campaign_counts(session, F, yahoo_stream(session, in_dir),
                               ads_df)
         .writeStream.foreachBatch(sink).outputMode(mode)
         .trigger(once=True).start())
    try:
        return _drive(q, files, in_dir, captured, step)
    finally:
        q.stop()


def stream_dedup(session, in_dir: str, files: Sequence[str], delay_s: int,
                 step=None) -> List[dict]:
    """Scenario (c): dropDuplicates(["user_id", "event_time"]) under a
    ``delay_s`` watermark; each trigger's ``emit`` is the sorted key
    array of the rows it let through (``yahoo_dedup_keys``)."""
    captured: List[np.ndarray] = []

    def sink(bdf, _bid):
        c = _host_columns(bdf._plan.batch)
        captured.append(np.sort(yahoo_dedup_keys(
            c["user_id"].astype(np.int64),
            c["event_time"].astype(np.int64))))

    os.makedirs(in_dir, exist_ok=True)
    q = (yahoo_stream(session, in_dir)
         .withWatermark("event_time", f"{delay_s} seconds")
         .dropDuplicates(["user_id", "event_time"])
         .writeStream.foreachBatch(sink).outputMode("append")
         .trigger(once=True).start())
    try:
        out = _drive(q, files, in_dir, captured, step)
        for rec in out:
            rec["evicted"] = rec["metrics"]["evicted_rows"]
        return out
    finally:
        q.stop()


def write_join_sides(session, root: str, n: int, triggers: int,
                     seed: int = 0):
    """Scenario (d)'s views and clicks, one parquet directory per side
    per trigger (``root/views/v<t>``, ``root/clicks/c<t>``); returns
    (view dirs, click dirs, the numpy sides)."""
    vdirs, cdirs, sides = [], [], []
    for t in range(triggers):
        views, clicks = stream_join_sides(n, t, seed)
        sides.append((views, clicks))
        v = dict(views)
        v["view_time"] = views["view_time"].astype("datetime64[us]")
        c = dict(clicks)
        c["click_time"] = clicks["click_time"].astype("datetime64[us]")
        vdirs.append(os.path.join(root, "views", f"v{t}"))
        cdirs.append(os.path.join(root, "clicks", f"c{t}"))
        session.createDataFrame(v).write.parquet(vdirs[-1])
        session.createDataFrame(c).write.parquet(cdirs[-1])
    return vdirs, cdirs, sides


def stream_join(session, F, watch: str, vdirs, cdirs, delay_s: int,
                step=None) -> List[dict]:
    """Scenario (d): views ⋈ clicks on (ad_id, user_id), the watermark
    on the views, one trigger per pair of files; each trigger's
    ``emit`` is the sorted (view_time, click_time, user, ad) rows."""
    captured: List[np.ndarray] = []

    def sink(bdf, _bid):
        c = _host_columns(bdf._plan.batch)
        rows = np.stack([c["view_time"].astype(np.int64),
                         c["click_time"].astype(np.int64),
                         c["user_id"].astype(np.int64),
                         c["ad_id"].astype(np.int64)], 1) \
            if len(c["user_id"]) else np.zeros((0, 4), np.int64)
        captured.append(rows[np.lexsort(rows.T[::-1])])

    vin, cin = os.path.join(watch, "v"), os.path.join(watch, "c")
    os.makedirs(vin, exist_ok=True)
    os.makedirs(cin, exist_ok=True)

    def side(path, schema):
        return (session.readStream.format("parquet").schema(schema)
                .option("maxFilesPerTrigger", 1).load(path))
    views = side(vin, "user_id long, ad_id long, view_time timestamp") \
        .withWatermark("view_time", f"{delay_s} seconds")
    clicks = side(cin, "c_user_id long, c_ad_id long, click_time timestamp")
    q = (views.join(clicks, (F.col("ad_id") == F.col("c_ad_id"))
                    & (F.col("user_id") == F.col("c_user_id")))
         .writeStream.foreachBatch(sink).outputMode("append")
         .trigger(once=True).start())
    out = []
    try:
        for vd, cd in zip(vdirs, cdirs):
            os.symlink(cd, os.path.join(cin, os.path.basename(cd)))
            out += _drive(q, [vd], vin, captured, step)
            bufs = q._ex._ss_buf
            out[-1]["view_buffer"] = int(bufs[0].num_rows())
            out[-1]["click_buffer"] = int(bufs[1].num_rows())
        return out
    finally:
        q.stop()


def stream_sessions(session, feeds, step=None) -> List[dict]:
    """Scenario (e): ``session_fn`` by flatMapGroupsWithState with an
    event-time timeout over a MemoryStream of (user, et) rows, one
    trigger per feed; each trigger's ``emit`` is its sorted rows, and
    ``fmgws_host_ms`` the user function's host time."""
    from . import types as T
    from .streaming.core import MemoryStream
    captured: List[list] = []

    def sink(bdf, _bid):
        captured.append(sorted(tuple(r) for r in bdf._plan.batch
                               .to_pylist()))

    src = MemoryStream(T.StructType([T.StructField("user", T.int64),
                                     T.StructField("et", T.int64)]),
                       session)
    out_schema = T.StructType([T.StructField("user", T.int64),
                               T.StructField("events", T.int64),
                               T.StructField("closed", T.boolean)])
    q = (src.toDF(session).withWatermark("et",
                                         f"{SESSION_WATERMARK_S} seconds")
         .groupBy("user").flatMapGroupsWithState(
             session_fn, out_schema, timeoutConf="EventTimeTimeout")
         .writeStream.foreachBatch(sink).outputMode("append")
         .trigger(once=True).start())
    out = []
    try:
        for rows in feeds:
            src.addData(rows)
            n0 = len(captured)
            measured = (step or (lambda fn: (fn(), {})[1]))(
                q.processAllAvailable)
            ex = q._ex
            out.append({"emit": captured[n0], "timings": dict(ex.timings),
                        "progress": dict(ex.progress[-1]),
                        "states": len(ex._fmgws_states), **measured})
        return out
    finally:
        q.stop()


def stream_shape(session, shape: str, in_dir: str):
    """(plan, output mode) of a worker's standing query: ``wagg`` and
    ``dedup`` the JAX package's chaos battery shapes (a windowed sum, or
    ``dropDuplicates`` over (k, ts), under a 5 s watermark over (ts, k,
    v) parquet files), ``yahoo`` scenario (a) over ``in_dir`` with the ad
    table at ``in_dir``/../ads."""
    from . import types as T
    from .sql import functions as F
    if shape in ("wagg", "dedup"):
        schema = T.StructType([T.StructField("ts", T.timestamp),
                               T.StructField("k", T.string),
                               T.StructField("v", T.int64)])
        df = (session.readStream.format("parquet").schema(schema)
              .option("maxFilesPerTrigger", 1).load(in_dir)
              .withWatermark("ts", "5 seconds"))
        if shape == "dedup":
            return df.dropDuplicates(["k", "ts"])._plan, "append"
        df = (df.groupBy(F.window("ts", "10 seconds").alias("w"))
              .agg(F.sum("v").alias("s")))
        return df._plan, "append"
    if shape == "yahoo":
        ads = session.read.parquet(
            os.path.join(os.path.dirname(in_dir), "ads"))
        df = yahoo_campaign_counts(session, F, yahoo_stream(session, in_dir),
                                   ads)
        return df._plan, "update"
    raise ValueError(f"stream shape {shape!r}")


def stream_lifetime(session, shape: str, in_dir: str, ckpt: str, out: str,
                    arm=None):
    """One process lifetime of a standing query: a fresh execution over
    the checkpoint ``ckpt`` writing a json file sink at ``out``, drained
    of every available file; ``arm(execution)`` first (a fault plan)."""
    from .streaming.core import FileSink, StreamExecution
    plan, mode = stream_shape(session, shape, in_dir)
    ex = StreamExecution(session, plan, FileSink("json", out, {}), mode,
                         ckpt, 0.1, None)
    first = []
    orig = ex.commit_log.add

    def add(batch_id, payload):
        orig(batch_id, payload)
        if not first:
            first.append(time.time())
    ex.commit_log.add = add
    if arm is not None:
        arm(ex)
    ex.first_commit = first
    try:
        ex.process_all_available()
    finally:
        regs = getattr(session, "_stream_execs", [])
        if ex in regs:
            regs.remove(ex)
    return ex


def stream_worker(argv: Sequence[str]) -> int:
    """argv: ``<root> <shape> <ckpt> <out> <device> [restart]``.  One
    lifetime of the standing query ``stream_shape(shape)`` over
    ``<root>/in`` with the fault plan of ``SPARK_TPU_FAULT_PLAN`` armed
    (``FaultInjector.attach_stream``; a planned death exits 43).  With
    ``restart`` a second lifetime follows in the same process over the
    same checkpoint (a torn commit entry replays there).  Writes
    ``<out>.result.json``: each lifetime's progress, metrics, replayed
    batches and the wall-clock time of its first commit."""
    t_start = time.time()
    if len(argv) < 5 or not worker_device(argv[4]):
        raise ValueError("stream worker: argv is <root> <shape> <ckpt> "
                         "<out> <device> [restart], the device cuda or cpu "
                         f"(or cuda:N, card N); got {list(argv)}")
    root, shape, ckpt, out, device = argv[:5]
    restart = len(argv) > 5 and argv[5] == "restart"
    check_worker_card(device, "stream worker")
    if device == "cpu":
        torch.set_num_threads(1)
    from .parallel.faults import FaultInjector
    from .sql.session import SparkSession
    session = SparkSession.builder.config("spark.torch.device", device) \
        .config("spark.sql.warehouse.dir", os.path.join(root, "wh")) \
        .getOrCreate()
    injector = FaultInjector()
    lives = []
    for life in range(2 if restart else 1):
        ex = stream_lifetime(
            session, shape, os.path.join(root, "in"), ckpt, out,
            arm=injector.attach_stream if life == 0 else None)
        lives.append({
            "progress": ex.progress, "metrics": dict(ex.metrics),
            "first_commit_unix": ex.first_commit[0] if ex.first_commit
            else None, "timings": dict(ex.timings)})
    res = {"start_unix": t_start, "lifetimes": lives,
           "injected": list(injector.injected)}
    with open(out + ".result.json.tmp", "w") as f:
        json.dump(res, f, default=str)
    os.replace(out + ".result.json.tmp", out + ".result.json")
    print(f"[stream] OK {shape} lifetimes={len(lives)} "
          f"injected={injector.injected}", flush=True)
    return 0


def stream_chaos_worker(argv: Sequence[str]) -> int:
    """One process of a ``stream_scenarios`` row (the JAX package's
    ``tests/streaming_worker.py``): ``<pid> <n> <root> <mode> <timeout_s>
    <device>``, mode a ``stream_shape`` (``wagg``, ``dedup``).  Process 1
    runs the standing query over ``<root>/in`` with the plan of
    ``SPARK_TPU_FAULT_PLAN`` armed and dies at its commit phase (exit 43,
    ``<root>/died-p1`` first); process 0 writes ``STREAM_FEEDS``, waits
    for that death, runs an uninterrupted lifetime on its own checkpoint,
    then a recovering one over process 1's, and prints ``[p0] OK <files>
    replayed=<n>`` if the two sinks are the same bytes and a batch was
    replayed (``[p0] PARTIAL``, exit 1, if they differ)."""
    from .parallel.faults import FaultInjector
    from .sql.session import SparkSession
    pid, _n, root, mode, timeout_s, device = _worker_argv("stream chaos",
                                                          argv)
    if mode not in ("wagg", "dedup"):
        raise ValueError(f"stream chaos mode {mode!r}")
    check_worker_card(device, "stream chaos")
    if device == "cpu":
        torch.set_num_threads(1)
    session = SparkSession.builder.config("spark.torch.device", device) \
        .config("spark.sql.warehouse.dir", os.path.join(root, f"wh{pid}")) \
        .getOrCreate()
    in_dir, ready = os.path.join(root, "in"), os.path.join(root, "ready")
    died = os.path.join(root, "died-p1")
    deadline = time.monotonic() + timeout_s
    if pid == 1:
        while not os.path.exists(ready):
            if time.monotonic() > deadline:
                print("[p1] FAILED inputs never appeared", flush=True)
                return 1
            time.sleep(0.05)
        injector = FaultInjector()

        def die(code):
            with open(died, "w") as f:
                f.write(repr(time.time()))
            os._exit(code)
        injector.die = die
        stream_lifetime(session, mode, in_dir, os.path.join(root, "ckpt"),
                        os.path.join(root, "out"),
                        arm=injector.attach_stream)
        print("[p1] FAILED the planned kill never fired", flush=True)
        return 1
    os.makedirs(in_dir, exist_ok=True)
    for i in range(len(STREAM_FEEDS)):
        write_stream_feed(session, in_dir, i)
    open(ready, "w").close()
    while not os.path.exists(died):
        if time.monotonic() > deadline:
            print("[p0] FAILED the victim never died", flush=True)
            return 1
        time.sleep(0.05)

    stream_lifetime(session, mode, in_dir, os.path.join(root, "oracle_ckpt"),
                    os.path.join(root, "oracle_out"))
    ex = stream_lifetime(session, mode, in_dir, os.path.join(root, "ckpt"),
                         os.path.join(root, "out"))
    got = _sink_files(os.path.join(root, "out"))
    exp = _sink_files(os.path.join(root, "oracle_out"))
    if got != exp or not exp:
        print(f"[p0] PARTIAL got={sorted(got)} exp={sorted(exp)}",
              flush=True)
        return 1
    if ex.metrics["replayed_batches"] < 1:
        print(f"[p0] FAILED nothing replayed: {ex.metrics}", flush=True)
        return 1
    print(f"[p0] OK {len(got)} replayed={ex.metrics['replayed_batches']}",
          flush=True)
    return 0


def arena_pattern(nbytes: int) -> np.ndarray:
    """The bytes an idle peer's arena holds: byte ``i`` is ``i *
    2654435761 mod 251``, which repeats every 251 bytes."""
    period = (np.arange(251, dtype=np.int64) * 2654435761 % 251) \
        .astype(np.uint8)
    return np.resize(period, int(nbytes))


def arena_peer(argv: Sequence[str]) -> int:
    """argv: ``<root> <nbytes>``.  A process that allocates one arena of
    ``nbytes`` on the card (``cuda_a2a.Arena``), fills it with
    ``arena_pattern``, publishes its IPC handle as ``<root>/arena.json``
    and then stays idle (no kernel of its own) until ``<root>/done``
    appears: the peer of an idle-peer pull measurement."""
    from . import cuda_a2a
    root, nbytes = argv[0], int(argv[1])
    arena = cuda_a2a.Arena(torch.device("cuda"), nbytes)
    arena.write(0, arena_pattern(nbytes))
    torch.cuda.synchronize()
    tmp = os.path.join(root, "arena.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"handle": arena.handle, "nbytes": nbytes}, f)
    os.replace(tmp, os.path.join(root, "arena.json"))
    deadline = time.monotonic() + 300
    while not os.path.exists(os.path.join(root, "done")) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    arena.free()
    return 0


# ---------------------------------------------------------------------------
# the decision-trace battery: the JAX package's ``tests/adaptive_worker.py``
# "trace" and "skew-decision" modes, and the card runs of ``chip_smoke.py``'s
# [analysis] phase
# ---------------------------------------------------------------------------

#: the hash-lane join of the battery: no filter, so both observed sides
#: stay far above the broadcast threshold and the adaptive re-decision
#: keeps the frozen hash lane — the only way a process can diverge is an
#: injected perturbation of its gathered stats view (``skew_decision``)
TRACE_HASH_SQL = ("SELECT sk, price, bonus FROM fact JOIN fact2 ON sk = k2 "
                  "ORDER BY sk, price, bonus")
#: the range lane's join (its trace carries the cut points and the
#: sample-estimated skew splits)
TRACE_RANGE_SQL = ("SELECT sk, count(*) AS c, sum(bonus) AS sb FROM fact "
                   "JOIN fact2 ON sk = k2 GROUP BY sk ORDER BY sk")

#: [analysis]'s card join: q93's join on the hash lane, adaptive with a
#: broadcast bar far below either real side (no demotion) but above the
#: ``[1, 1]`` per sender a ``skew_decision`` leaves of a side
ANALYSIS_CARD_CONF = {"spark.tpu.crossproc.sortMergeJoin": "false",
                      "spark.tpu.crossproc.autoBroadcastThreshold": "1024",
                      "spark.tpu.crossproc.adaptiveReplan": "true",
                      "spark.tpu.analysis.verifyPlans": "on",
                      "spark.tpu.shuffle.ici.enabled": "true"}


def _analysis_outcome(xs, fn) -> dict:
    """Run ``fn`` and classify the ending as the JAX package's adaptive
    worker does: ``ok`` with the rows, ``diverged`` (a
    ``PlanInvariantError``: its property and message), or ``failed`` (a
    bounded ``ExchangeFetchFailed`` / ``TimeoutError``); with the
    seconds to that ending and the session's trace counts."""
    from .analysis import PlanInvariantError
    from .parallel.hostshuffle import ExchangeFetchFailed
    t0 = time.monotonic()
    out: Dict[str, Any] = {}
    try:
        out.update(outcome="ok", rows=fn())
    except PlanInvariantError as e:
        out.update(outcome="diverged", property=e.property,
                   node=e.node_name, message=str(e))
    except (ExchangeFetchFailed, TimeoutError) as e:
        out.update(outcome="failed", error=f"{type(e).__name__}: {e}",
                   lost=sorted(getattr(e, "lost_hosts", []) or []))
    out["elapsed_s"] = time.monotonic() - t0
    st = xs._analysis_stats
    out["checks"] = st.get("decision_trace_checks", 0)
    out["div"] = st.get("decision_trace_divergence", 0)
    return out


def analysis_worker(argv: Sequence[str]) -> int:
    """One process of a decision-trace run.

    argv: ``<pid> <n> <root> <mode> <timeout_s> <device>``.  Modes:
    ``trace`` / ``trace-ici`` (the battery's hash join, then its range
    join, with the runtime checks on, on the host tier or with the
    device tier armed: every process must match the single-process
    answer with checks > 0 and no divergence), ``skew-decision`` /
    ``skew-ici`` (the hash join with a ``FaultInjector`` armed from
    ``SPARK_TPU_FAULT_PLAN``: the armed process's gathered view of
    ``xq000001-plan`` is perturbed, and EVERY process must end in a
    ``PlanInvariantError`` naming the diverged component — the armed one
    at its trace check, its peers at their next barrier through its
    divergence notice) and ``card`` ([analysis] of ``chip_smoke.py``:
    q93's join over ``<root>/spec.json``'s tables on the device tier,
    ``ANALYSIS_CARD_CONF``: cold with every pull held against its plain
    version, warm, then once more with the plan of
    ``SPARK_TPU_FAULT_PLAN`` armed).

    Prints ``[p<pid>] TRACE-OK rows=.. checks=.. div=..``,
    ``[p<pid>] FAILED-DIVERGED <s> prop=.. div=.. detail=..``,
    ``[p<pid>] FAILED <s> <lost>`` or ``[p<pid>] PARTIAL`` (exit 1);
    writes ``<root>/result-p<pid>.json``."""
    from . import config as C
    from . import types as T
    from .parallel.faults import FaultInjector
    from .sql.session import SparkSession

    pid, n, root, mode, timeout_s, device = _worker_argv(
        "analysis worker", argv)
    check_worker_card(device, "analysis worker")
    if device == "cpu":
        torch.set_num_threads(1)    # the workers share the host's cores
    base = SparkSession.builder.config("spark.torch.device", device) \
        .getOrCreate()
    base.conf.set(C.MESH_SHARDS.key, "1")
    one = base.newSession()
    xs = base.newSession()
    card = mode.startswith("card")
    result: Dict[str, Any] = {"pid": pid, "mode": mode}
    if card:
        with open(os.path.join(root, "spec.json")) as f:
            spec = json.load(f)
        register_card_tables(one, T, spec)
        register_card_tables(xs, T, spec, pid, n)
        for k, v in spec.get("conf", {}).items():
            xs.conf.set(k, v)
        confs = dict(ANALYSIS_CARD_CONF)
        sqls = [Q93_JOIN_SQL]
    else:
        for name, cols in crossproc_tables(None).items():
            one.createDataFrame(cols).createOrReplaceTempView(name)
        for name, cols in crossproc_tables(pid, n).items():
            xs.createDataFrame(cols).createOrReplaceTempView(name)
        confs = {C.SHUFFLE_TARGET_PARTITION_BYTES.key: "2048",
                 C.SHUFFLE_FINE_PARTITIONS.key: "32",
                 C.CROSSPROC_AUTO_BROADCAST.key: "2048",
                 C.CROSSPROC_SHUFFLED_JOIN.key: "true",
                 C.CROSSPROC_SORT_MERGE_JOIN.key: "false",
                 C.CROSSPROC_ADAPTIVE_REPLAN.key: "true",
                 C.ANALYSIS_VERIFY_PLANS.key: "on"}
        if mode.endswith("ici"):
            confs.update(ici_confs(n))
        sqls = [TRACE_HASH_SQL] + (
            [TRACE_RANGE_SQL] if mode.startswith("trace") else [])
    for k, v in confs.items():
        xs.conf.set(k, v)
    svc = xs.enableHostShuffle(os.path.join(root, "shuffle"), pid, n,
                               timeout_s=timeout_s)
    svc.poll_s = 0.005          # one host: poll the markers often
    want = [jsonable_rows(tuple(r) for r in one.sql(q).collect())
            for q in sqls]

    def collect(sql):
        return jsonable_rows(tuple(r) for r in xs.sql(sql).collect())

    runs: List[dict] = []
    if mode == "card":
        from . import cuda_a2a
        from .parallel import ici
        cuda_a2a.PULL_LAUNCHES = 0
        cuda_a2a.LAUNCHES = 0
        for i in range(3):
            if i == 0:
                os.environ[ici.CHECK_ENV] = "1"
            elif i == 2:
                # the plan from SPARK_TPU_FAULT_PLAN: a rule naming no
                # exchange fires at this run's stats round
                FaultInjector().attach(svc)
            try:
                pulls0 = cuda_a2a.PULL_LAUNCHES
                a2a0 = cuda_a2a.LAUNCHES
                t0 = time.perf_counter()
                r = _analysis_outcome(xs, lambda: collect(sqls[0]))
                r["wall_ms"] = (time.perf_counter() - t0) * 1e3
                r["pull_launches"] = cuda_a2a.PULL_LAUNCHES - pulls0
                r["a2a_launches"] = cuda_a2a.LAUNCHES - a2a0
            finally:
                os.environ.pop(ici.CHECK_ENV, None)
            runs.append(r)
            if r["outcome"] != "ok":
                break
        result["check"] = dict(ici.CHECK)
    else:
        if mode.startswith("skew"):
            FaultInjector().attach(svc)   # plan from SPARK_TPU_FAULT_PLAN
        for sql in sqls:
            r = _analysis_outcome(xs, lambda sql=sql: collect(sql))
            runs.append(r)
            if r["outcome"] != "ok":
                break
    result["runs"] = runs
    result["want"] = want
    result["counters"] = dict(svc.counters)
    result["analysis"] = dict(xs._analysis_stats)
    _write_result(root, pid, result)
    last = runs[-1]
    st = xs._analysis_stats
    if last["outcome"] == "diverged":
        print(f"[p{pid}] FAILED-DIVERGED {last['elapsed_s']:.2f} "
              f"prop={last['property']} "
              f"div={st.get('decision_trace_divergence', 0)} "
              f"detail={last['message']}", flush=True)
        return 0
    if last["outcome"] == "failed":
        print(f"[p{pid}] FAILED {last['elapsed_s']:.2f} {last['lost']}",
              flush=True)
        return 0
    pairs = [(r, want[0]) for r in runs if r["outcome"] == "ok"] if card \
        else zip(runs, want)
    for r, w in pairs:
        if not _rows_equal(r["rows"], w):
            print(f"[p{pid}] PARTIAL got={len(r['rows'])} exp={len(w)}",
                  flush=True)
            return 1
    print(f"[p{pid}] TRACE-OK rows={len(runs[0]['rows'])} "
          f"checks={st.get('decision_trace_checks', 0)} "
          f"div={st.get('decision_trace_divergence', 0)}", flush=True)
    return 0


def analysis_scenarios() -> List[dict]:
    """The decision-trace scenarios (two processes; ``analysis-worker``):
    a clean run on each tier, and ``skew_decision`` armed in process 1
    on each tier, which must end BOTH processes in
    ``FAILED-DIVERGED``."""
    from .parallel.faults import FaultPlan as P
    skew = {1: lambda: P().skew_decision("xq000001-plan")}
    return [
        _scenario("trace-parity", "post-publish-sizes", "analysis-worker",
                  "trace", 2, 20.0, {}, {0: "TRACE-OK", 1: "TRACE-OK"}),
        _scenario("trace-parity-ici", "post-publish-sizes",
                  "analysis-worker", "trace-ici", 2, 20.0, {},
                  {0: "TRACE-OK", 1: "TRACE-OK"}),
        _scenario("skew-decision", "post-publish-sizes", "analysis-worker",
                  "skew-decision", 2, 20.0, skew,
                  {0: "FAILED-DIVERGED", 1: "FAILED-DIVERGED"}),
        _scenario("skew-decision-ici", "post-publish-sizes",
                  "analysis-worker", "skew-ici", 2, 20.0, skew,
                  {0: "FAILED-DIVERGED", 1: "FAILED-DIVERGED"}),
    ]


# ---------------------------------------------------------------------------
# adaptive execution across processes: the JAX package's
# ``tests/adaptive_worker.py`` "adaptive" and "fault-adapt" modes, and the
# card runs of ``chip_smoke.py``'s [adaptive] phase
# ---------------------------------------------------------------------------

#: a misestimated right side: the optimizer pushes the bonus filter below
#: the join, so its observed map output is tiny while the plan-time leaf
#: probe sees all of fact2
ADAPTIVE_DEMOTE_SQL = ("SELECT sk, price, bonus FROM fact JOIN fact2 "
                       "ON sk = k2 WHERE bonus < 2 "
                       "ORDER BY sk, price, bonus")
#: another constant, another plan signature: no feedback shortcut, so the
#: range lane freezes from the probe and demotes at the stats barrier
ADAPTIVE_DEMOTE_R_SQL = ADAPTIVE_DEMOTE_SQL.replace("bonus < 2",
                                                    "bonus < 3")
#: rows uniform per key, bytes concentrated in key 3's fat strings: only
#: the post-sample size round can see the skew
ADAPTIVE_SKEW_SQL = ("SELECT rk, count(*) AS c, min(t) AS tlo, "
                     "sum(w2) AS sw FROM skl JOIN skr ON rk = rk2 "
                     "GROUP BY rk ORDER BY rk")
#: a keyed aggregate below the join: partial state rides the exchange
ADAPTIVE_AGG_SQL = ("SELECT sk, price, sb FROM fact JOIN "
                    "(SELECT k2, sum(bonus) AS sb FROM fact2 GROUP BY k2) a "
                    "ON sk = k2 ORDER BY sk, price, sb")

#: the battery's scenarios in order: name, the text it runs (a key of
#: ``ADAPTIVE_TEXTS``) and its counter deltas as the JAX package's worker
#: asserts them, (counter, "==" or ">=", value)
ADAPTIVE_SCENARIOS = (
    ("DEMOTE", "demote", (("adaptive_replans", "==", 1),
                          ("strategy_demotions", "==", 1),
                          ("broadcast_joins", "==", 1),
                          ("shuffled_joins", "==", 0))),
    ("FEEDBACK", "demote", (("stats_feedback_hits", ">=", 1),
                            ("broadcast_joins", "==", 1),
                            ("shuffled_joins", "==", 0),
                            ("adaptive_replans", "==", 0))),
    ("RANGE-DEMOTE", "demote_r", (("adaptive_replans", "==", 1),
                                  ("strategy_demotions", "==", 1),
                                  ("broadcast_joins", "==", 1),
                                  ("range_merge_joins", "==", 0))),
    ("FROZEN", "demote", (("shuffled_joins", "==", 1),
                          ("broadcast_joins", "==", 0),
                          ("adaptive_replans", "==", 0),
                          ("strategy_demotions", "==", 0))),
    ("SKEW", "skew", (("range_merge_joins", "==", 1),
                      ("spans_split", ">=", 1),
                      ("post_sample_skew_splits", ">=", 1))),
    ("AGGPUSH", "agg", (("shuffled_joins", "==", 1),
                        ("strategy_demotions", "==", 0))),
)

#: the counters of the battery's last line (``ADAPT-OK``), by its names
ADAPTIVE_TOTALS = (("replans", "adaptive_replans"),
                   ("demotions", "strategy_demotions"),
                   ("fbhits", "stats_feedback_hits"),
                   ("postskew", "post_sample_skew_splits"),
                   ("bcast", "broadcast_joins"),
                   ("shuffled", "shuffled_joins"),
                   ("range", "range_merge_joins"))


def adaptive_counter_problems(scenario: str, delta: dict) -> List[str]:
    """What ``delta`` (a run's counter deltas) breaks of ``scenario``'s
    row of ``ADAPTIVE_SCENARIOS``."""
    want = {name: asserts for name, _text, asserts
            in ADAPTIVE_SCENARIOS}[scenario]
    bad = []
    for counter, op, value in want:
        got = delta.get(counter, 0)
        if not (got == value if op == "==" else got >= value):
            bad.append(f"{counter} {got} (want {op} {value})")
    return bad


def adaptive_tables(pid: Optional[int] = None, n: int = 1) -> dict:
    """The battery's tables (the JAX package worker's, rng 11): ``fact``
    1,200 and ``fact2`` 900 rows over 48 keys; ``skl`` 600 rows, 16 keys
    in turn, key 3's strings 280 characters; ``skr`` 150 rows.  Process
    ``pid`` of ``n`` keeps a strided 1/n slice; ``pid`` None: whole."""
    rng = np.random.default_rng(11)
    NF, NB = 1200, 900
    f_sk = rng.integers(0, 48, NF).astype(np.int64)
    f_price = rng.integers(1, 500, NF).astype(np.int64)
    k2 = rng.integers(0, 48, NB).astype(np.int64)
    bonus = rng.integers(0, 100, NB).astype(np.int64)
    NS, NR = 600, 150
    s_rk = (np.arange(NS) % 16).astype(np.int64)
    s_t = np.array([(f"r{i:04d}" * 56) if s_rk[i] == 3 else f"s{i:04d}"
                    for i in range(NS)], dtype=object)
    r_rk2 = (np.arange(NR) % 16).astype(np.int64)
    r_w2 = rng.integers(1, 50, NR).astype(np.int64)
    mine = slice(None) if pid is None else slice(pid, None, n)
    return {"fact": {"sk": f_sk[mine], "price": f_price[mine]},
            "fact2": {"k2": k2[mine], "bonus": bonus[mine]},
            "skl": {"rk": s_rk[mine], "t": s_t[mine]},
            "skr": {"rk2": r_rk2[mine], "w2": r_w2[mine]}}


def _adaptive_confs(adaptive: bool) -> Dict[str, str]:
    """The battery's session confs (the JAX package worker's)."""
    from . import config as C
    return {C.SHUFFLE_TARGET_PARTITION_BYTES.key: "2048",
            C.SHUFFLE_FINE_PARTITIONS.key: "32",
            C.CROSSPROC_AUTO_BROADCAST.key: "2048",
            C.CROSSPROC_SHUFFLED_JOIN.key: "true",
            C.CROSSPROC_SORT_MERGE_JOIN.key: "false",
            C.CROSSPROC_ADAPTIVE_REPLAN.key:
                "true" if adaptive else "false"}


class _StatsRound:
    """A spy on a service's stats round (``<xid>-plan``): the ms from its
    ``publish_sizes`` to the end of its ``gather_sizes_ex``, summed."""

    def __init__(self, svc):
        self.ms = 0.0
        self.rounds = 0
        self._t0: Dict[str, float] = {}
        publish, gather = svc.publish_sizes, svc.gather_sizes_ex

        def publish_sizes(exchange, *a, **kw):
            if exchange.endswith("-plan"):
                self._t0[exchange] = time.perf_counter()
            return publish(exchange, *a, **kw)

        def gather_sizes_ex(exchange, *a, **kw):
            out = gather(exchange, *a, **kw)
            t0 = self._t0.pop(exchange, None)
            if t0 is not None:
                self.ms += (time.perf_counter() - t0) * 1e3
                self.rounds += 1
            return out
        svc.publish_sizes, svc.gather_sizes_ex = publish_sizes, \
            gather_sizes_ex


def adaptive_skew_pins() -> Dict[str, str]:
    """The skew scenario's confs: the range lane pinned (no broadcast),
    and the battery's advisory target and fine partitions, with which
    the row-weighted sample round sees uniform spans."""
    from . import config as C
    return {C.CROSSPROC_AUTO_BROADCAST.key: "0",
            C.CROSSPROC_SORT_MERGE_JOIN.key: "true",
            C.SHUFFLE_TARGET_PARTITION_BYTES.key: "2048",
            C.SHUFFLE_FINE_PARTITIONS.key: "32"}


def _adaptive_run(xs, svc, spy: Optional[_StatsRound], sql: str,
                  confs: Optional[Dict[str, str]] = None) -> dict:
    """One run of ``sql`` under ``confs`` (the session's own values back
    after): rows, counter deltas, wall ms, the stats round's ms and the
    wall's split (``crossproc.STATS`` and the service's timers, ms)."""
    from .parallel import crossproc as X
    confs = confs or {}
    own = dict(xs.conf_obj.items())
    for k, v in confs.items():
        xs.conf.set(k, v)
    try:
        before = dict(svc.counters)
        stats0, timers0 = dict(X.STATS), dict(svc.timers)
        ms0 = spy.ms if spy is not None else 0.0
        t0 = time.perf_counter()
        rows = jsonable_rows(tuple(r) for r in xs.sql(sql).collect())
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for k in confs:
            if k in own:
                xs.conf.set(k, own[k])
            else:
                xs.conf.unset(k)
    split = {k: X.STATS[k] - stats0[k] for k in X.STATS
             if k.endswith("_ms")}
    split.update({k[:-2] + "_ms": (svc.timers[k] - timers0[k]) * 1e3
                  for k in svc.timers})
    return {"rows": rows, "wall_ms": wall, "split": split,
            "stats_ms": spy.ms - ms0 if spy is not None else None,
            "delta": {k: svc.counters[k] - before[k] for k in svc.counters
                      if svc.counters[k] != before[k]}}


def _adaptive_battery(xs, svc, frozen, fsvc, frozen_confs,
                      want: Dict[str, list], pid: int,
                      texts: Dict[str, str],
                      spy: Optional[_StatsRound] = None) -> dict:
    """The six scenarios in order on ``xs`` (adaptive) and, for the
    control, ``frozen`` under ``frozen_confs`` (``adaptiveReplan``
    false): each one's rows must equal ``want`` and its counter deltas
    ``ADAPTIVE_SCENARIOS``; prints ``[p<pid>] <SCENARIO>-OK (<rows>
    rows)`` for each, raises ``AssertionError`` on the first that breaks.
    ``texts`` maps demote, demote_r, skew and agg to their SQL."""
    from . import config as C
    smj = C.CROSSPROC_SORT_MERGE_JOIN.key
    # each scenario's session, service and confs
    plan = {"DEMOTE": (xs, svc, None), "FEEDBACK": (xs, svc, None),
            "RANGE-DEMOTE": (xs, svc, {smj: "true"}),
            "FROZEN": (frozen, fsvc, frozen_confs),
            "SKEW": (xs, svc, adaptive_skew_pins()),
            "AGGPUSH": (xs, svc, None)}
    out: Dict[str, Any] = {}
    for name, text, _asserts in ADAPTIVE_SCENARIOS:
        sess, service, confs = plan[name]
        run = _adaptive_run(sess, service, spy if sess is xs else None,
                            texts[text], confs)
        bad = adaptive_counter_problems(name, run["delta"])
        if run["rows"] != want[text]:
            bad.append(f"{len(run['rows'])} rows differ from the "
                       f"single-process answer ({len(want[text])})")
        if name == "DEMOTE" and len(xs.statsFeedback) < 2:
            bad.append(f"statsFeedback {xs.statsFeedback.snapshot()}")
        if name == "AGGPUSH":
            # the generic gather, same session: the same rows
            run["unpushed"] = _adaptive_run(
                xs, svc, None, texts[text],
                {C.CROSSPROC_SHUFFLED_JOIN.key: "false"})
            if run["unpushed"]["rows"] != want[text]:
                bad.append("the unpushed gather's rows differ")
        out[name] = run
        if bad:
            raise AssertionError(f"[p{pid}] {name}: {'; '.join(bad)}: "
                                 f"{run['delta']}")
        print(f"[p{pid}] {name}-OK ({len(run['rows'])} rows)", flush=True)
    return out


def _adaptive_totals_line(pid: int, c: dict) -> str:
    return f"[p{pid}] ADAPT-OK " + " ".join(
        f"{name}={c[key]}" for name, key in ADAPTIVE_TOTALS)


#: the [adaptive] card texts over q3's SF1 tables with date_dim
#: partitioned: date_dim's plan-time leaf (73,049 rows of 16 B) is above
#: the default 1 MiB bar, its ``d_moy = 11`` rows far below it
ADAPTIVE_CARD_DEMOTE_SQL = (
    "SELECT d_year, count(*) AS n, sum(ss_item_sk) AS s FROM store_sales "
    "JOIN date_dim ON ss_sold_date_sk = d_date_sk WHERE d_moy = 11 "
    "GROUP BY d_year ORDER BY d_year")
ADAPTIVE_CARD_DEMOTE_R_SQL = ADAPTIVE_CARD_DEMOTE_SQL.replace(
    "d_moy = 11", "d_moy = 12")
#: a keyed aggregate of store_sales below its join with item (partitioned)
ADAPTIVE_CARD_AGG_SQL = (
    "SELECT i_item_sk, i_brand_id, n FROM item JOIN "
    "(SELECT ss_item_sk, count(*) AS n FROM store_sales "
    "GROUP BY ss_item_sk) a ON i_item_sk = ss_item_sk ORDER BY i_item_sk")
ADAPTIVE_CARD_TEXTS = {"demote": ADAPTIVE_CARD_DEMOTE_SQL,
                       "demote_r": ADAPTIVE_CARD_DEMOTE_R_SQL,
                       "skew": ADAPTIVE_SKEW_SQL,
                       "agg": ADAPTIVE_CARD_AGG_SQL}
#: [adaptive]'s one pin, the battery's: the hash lane where a join is
#: range-eligible (the broadcast bar and ``adaptiveReplan`` stay at their
#: defaults, 1 MiB and true)
ADAPTIVE_CARD_CONF = {"spark.tpu.crossproc.sortMergeJoin": "false"}
ADAPTIVE_TEXTS = {"demote": ADAPTIVE_DEMOTE_SQL,
                  "demote_r": ADAPTIVE_DEMOTE_R_SQL,
                  "skew": ADAPTIVE_SKEW_SQL, "agg": ADAPTIVE_AGG_SQL}


def adaptive_skew_tables(probe: int, build: int, keys: int = 16,
                         fat_key: int = 3, seed: int = 11) -> dict:
    """The battery's skew shape at card size: ``probe`` rows of ``skl``
    over ``keys`` keys in turn, key ``fat_key``'s strings 280 characters
    and unique, the others 8; ``build`` rows of ``skr`` over the same
    keys in turn."""
    rng = np.random.default_rng(seed)
    rk = (np.arange(probe) % keys).astype(np.int64)
    t = np.array([f"s{i:07d}" for i in range(probe)], dtype=object)
    fat = np.flatnonzero(rk == fat_key)
    t[fat] = [f"r{i:07d}" * 35 for i in fat]
    return {"skl": {"rk": rk, "t": t},
            "skr": {"rk2": (np.arange(build) % keys).astype(np.int64),
                    "w2": rng.integers(1, 50, build).astype(np.int64)}}


def register_adaptive_card_tables(session, T, spec: dict,
                                  pid: Optional[int] = None,
                                  n: int = 1) -> None:
    """[adaptive]'s views: q3's tables at ``spec["q3"]``'s row counts,
    every one partitioned (process ``pid`` of ``n`` holds its contiguous
    share), and the skew tables at ``spec["skew"]``'s; ``pid`` None
    registers every table whole."""
    q3 = q3_tables(spec["q3"]["store_sales"], spec["q3"]["item"],
                   spec["q3"]["date_dim"])
    skew = adaptive_skew_tables(**spec["skew"])

    def share(cols):
        if pid is None:
            return cols
        rows = len(next(iter(cols.values())))
        lo, hi = pid * rows // n, (pid + 1) * rows // n
        return {k: v[lo:hi] for k, v in cols.items()}

    for name, cols in q3.items():
        st = T.StructType([T.StructField(c, T.type_for_name(t))
                           for c, t in Q3_SCHEMAS[name]])
        session.createDataFrame(share(cols), schema=st) \
            .createOrReplaceTempView(name)
    for name, cols in skew.items():
        session.createDataFrame(share(cols)).createOrReplaceTempView(name)


#: the warm runs of a card text, frozen or not, in turns; the skew text
#: (seconds a run, its broadcast pinned off either way) runs once each
ADAPTIVE_TURNS = {"skew": (False, True)}


def _adaptive_card(xs, svc, pid: int, want: Dict[str, list]) -> dict:
    """[adaptive]'s runs in one worker (see ``chip_smoke.py``): the six
    scenarios under the default cross-process conf but
    ``ADAPTIVE_CARD_CONF`` (the frozen control
    with ``adaptiveReplan`` false on the same session), each text's warm
    walls adaptive and frozen in turns (on, off, off, on), then the
    frozen and pushdown texts with the device tier on, cold with every
    pull held against its plain version, then warm.  K1's launches and
    K2's pulls count from 0 just before; every K1 launch outside a
    capture is held against its plain version."""
    from . import config as C
    from . import cuda_a2a, cuda_agg
    from .parallel import ici
    frozen_conf = {C.CROSSPROC_ADAPTIVE_REPLAN.key: "false"}
    spy = _StatsRound(svc)
    for entry in cuda_agg.ENTRY_LAUNCHES:
        cuda_agg.ENTRY_LAUNCHES[entry] = 0
        cuda_agg.CAPTURED_LAUNCHES[entry] = 0
    cuda_a2a.PULL_LAUNCHES = 0
    ici.reset_stats()
    out: Dict[str, Any] = {}
    with _K1Compare() as k1:
        out["scenarios"] = _adaptive_battery(
            xs, svc, xs, svc, frozen_conf, want, pid, ADAPTIVE_CARD_TEXTS,
            spy)
        pins = {"demote": {}, "demote_r": {C.CROSSPROC_SORT_MERGE_JOIN.key:
                                           "true"},
                "skew": adaptive_skew_pins(), "agg": {}}
        turns = {}
        for text, sql in ADAPTIVE_CARD_TEXTS.items():
            turns[text] = [
                dict(_adaptive_run(xs, svc, spy, sql,
                                   dict(pins[text], **(frozen_conf if off
                                                       else {}))),
                     frozen=off)
                for off in ADAPTIVE_TURNS.get(text, (False, True, True,
                                                     False))]
        out["turns"] = turns
        tier = {"spark.tpu.shuffle.ici.enabled": "true"}
        ici_runs = {}
        for text in ("demote", "agg"):
            confs = dict(tier, **frozen_conf)
            os.environ[ici.CHECK_ENV] = "1"
            try:
                pulls0 = cuda_a2a.PULL_LAUNCHES
                cold = _adaptive_run(xs, svc, spy, ADAPTIVE_CARD_TEXTS[text],
                                     confs)
                cold["pull_launches"] = cuda_a2a.PULL_LAUNCHES - pulls0
            finally:
                os.environ.pop(ici.CHECK_ENV, None)
            pulls0 = cuda_a2a.PULL_LAUNCHES
            warm = _adaptive_run(xs, svc, spy, ADAPTIVE_CARD_TEXTS[text],
                                 confs)
            warm["pull_launches"] = cuda_a2a.PULL_LAUNCHES - pulls0
            ici_runs[text] = {"cold": cold, "warm": warm}
        out["ici"] = ici_runs
    out["ici_check"] = dict(ici.CHECK)
    out["pull_launches"] = cuda_a2a.PULL_LAUNCHES
    out["k1"] = {"launches": dict(cuda_agg.ENTRY_LAUNCHES),
                 "captured": dict(cuda_agg.CAPTURED_LAUNCHES),
                 "checked": k1.checked, "equal": k1.equal,
                 "max_abs_err": k1.max_abs_err}
    out["stats_rounds"] = spy.rounds
    return out


def adaptive_worker(argv: Sequence[str]) -> int:
    """One process of the adaptive battery.

    argv: ``<pid> <n> <root> <mode> <timeout_s> <device>``.  Modes:
    ``adaptive`` (the six scenarios over ``adaptive_tables``, the frozen
    control on a second session under ``<root>/shuffle-frozen``; last
    line ``[p<pid>] ADAPT-OK replans=.. demotions=.. fbhits=..
    postskew=.. bcast=.. shuffled=.. range=..``), ``fault-adapt`` (the
    demotion text once with a ``FaultInjector`` armed from
    ``SPARK_TPU_FAULT_PLAN``: its stats round is ``xq000001-plan``, its
    demotion gather ``xq000001-bcast``; prints ``[p<pid>] OK rows=..
    replans=.. demotions=.. bcast=.. shuffled=..``, ``[p<pid>] FAILED <s>
    <lost>`` or ``[p<pid>] PARTIAL`` (exit 1)) and ``card`` ([adaptive]
    of ``chip_smoke.py``: ``register_adaptive_card_tables`` over
    ``<root>/spec.json``, the single-process answers from
    ``<root>/want.json``, ``_adaptive_card``).  Writes
    ``<root>/result-p<pid>.json``."""
    from . import config as C
    from . import types as T
    from .parallel.faults import FaultInjector
    from .parallel.hostshuffle import ExchangeFetchFailed
    from .sql.session import SparkSession

    pid, n, root, mode, timeout_s, device = _worker_argv(
        "adaptive worker", argv)
    if mode not in ("adaptive", "fault-adapt", "card"):
        raise ValueError(f"adaptive worker mode {mode!r}")
    check_worker_card(device, "adaptive worker")
    if device == "cpu":
        torch.set_num_threads(1)    # the workers share the host's cores
    base = SparkSession.builder.config("spark.torch.device", device) \
        .getOrCreate()
    base.conf.set(C.MESH_SHARDS.key, "1")
    result: Dict[str, Any] = {"pid": pid, "mode": mode}

    def session(sub: str, confs: Dict[str, str]):
        xs = base.newSession()
        for k, v in confs.items():
            xs.conf.set(k, v)
        svc = xs.enableHostShuffle(os.path.join(root, sub), pid, n,
                                   timeout_s=timeout_s)
        svc.poll_s = 0.005          # one host: poll the markers often
        return xs, svc

    if mode == "card":
        with open(os.path.join(root, "spec.json")) as f:
            spec = json.load(f)
        xs, svc = session("shuffle", dict(ADAPTIVE_CARD_CONF,
                                          **spec.get("conf", {})))
        t0 = time.perf_counter()
        register_adaptive_card_tables(xs, T, spec, pid, n)
        result["setup_ms"] = (time.perf_counter() - t0) * 1e3
        # the single-process answers, written by the parent beside us
        want_path = os.path.join(root, "want.json")
        deadline = time.monotonic() + 10 * timeout_s
        while not os.path.exists(want_path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{want_path} never appeared")
            time.sleep(0.05)
        with open(want_path) as f:
            want = json.load(f)
        result.update(_adaptive_card(xs, svc, pid, want))
        result["counters"] = dict(svc.counters)
        _write_result(root, pid, result)
        print(_adaptive_totals_line(pid, svc.counters), flush=True)
        return 0

    one = base.newSession()
    for name, cols in adaptive_tables().items():
        one.createDataFrame(cols).createOrReplaceTempView(name)

    def views(xs):
        for name, cols in adaptive_tables(pid, n).items():
            xs.createDataFrame(cols).createOrReplaceTempView(name)

    xs, svc = session("shuffle", _adaptive_confs(True))
    views(xs)
    if mode == "fault-adapt":
        FaultInjector().attach(svc)      # the plan: SPARK_TPU_FAULT_PLAN
        exp = jsonable_rows(tuple(r) for r in
                            one.sql(ADAPTIVE_DEMOTE_SQL).collect())
        t0 = time.time()
        try:
            got = jsonable_rows(tuple(r) for r in
                                xs.sql(ADAPTIVE_DEMOTE_SQL).collect())
        except (ExchangeFetchFailed, TimeoutError) as e:
            lost = sorted(getattr(e, "lost_hosts", []) or [])
            result.update(outcome=type(e).__name__, lost_hosts=lost,
                          elapsed_s=time.time() - t0,
                          counters=dict(svc.counters))
            _write_result(root, pid, result)
            print(f"[p{pid}] FAILED {time.time() - t0:.2f} {lost}",
                  flush=True)
            return 0
        c = svc.counters
        result.update(outcome="ok", rows=got, expected=exp,
                      counters=dict(c))
        _write_result(root, pid, result)
        if got != exp:
            print(f"[p{pid}] PARTIAL got={len(got)} exp={len(exp)}",
                  flush=True)
            return 1
        print(f"[p{pid}] OK rows={len(got)} "
              f"replans={c['adaptive_replans']} "
              f"demotions={c['strategy_demotions']} "
              f"bcast={c['broadcast_joins']} "
              f"shuffled={c['shuffled_joins']}", flush=True)
        return 0
    frozen, fsvc = session("shuffle-frozen", _adaptive_confs(False))
    views(frozen)
    want = {k: jsonable_rows(tuple(r) for r in one.sql(sql).collect())
            for k, sql in ADAPTIVE_TEXTS.items()}
    result["scenarios"] = _adaptive_battery(xs, svc, frozen, fsvc, None,
                                            want, pid, ADAPTIVE_TEXTS)
    result["counters"] = dict(svc.counters)
    _write_result(root, pid, result)
    print(_adaptive_totals_line(pid, svc.counters), flush=True)
    return 0


# ---------------------------------------------------------------------------
# state carried over from a fitted model or a graph of another engine
# ---------------------------------------------------------------------------

def _carried(value):
    """A parameter value of another engine's model as plain Python and
    numpy: arrays (numpy or any ``__array__``) as numpy, nested models
    carried over, lists, tuples and dicts element by element."""
    if isinstance(value, (str, bytes, bool, int, float)) or value is None:
        return value
    if isinstance(value, dict):
        return {k: _carried(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_carried(v) for v in value)
    if hasattr(value, "_values") and hasattr(value, "_params"):
        return ml_model_from_reference(value)
    if hasattr(value, "__array__"):
        return np.asarray(value)
    return value


def ml_model_from_reference(model):
    """A fitted ML model (or any params holder) of an engine laid out as
    this package — ``<pkg>.ml.<module>.<Class>`` with a ``_values`` map
    of params — as this package's model of the same module and class,
    every param carried over as numpy (coefficients, centres, tree dicts,
    factor matrices, layer weights; nested stages and encoders too).  The
    model's ``transform`` then runs here on the same state."""
    import importlib
    mod = type(model).__module__
    parts = mod.split(".")
    if "ml" not in parts:
        raise ValueError(f"{type(model).__name__} ({mod}) is not an ML "
                         "params holder")
    ours = importlib.import_module(
        ".".join([__package__] + parts[parts.index("ml"):]))
    cls = getattr(ours, type(model).__name__)
    out = cls()
    for name, value in model._values.items():
        out.set(name, _carried(value))
    return out


def graph_from_reference(graph, device=None):
    """A graph of an engine laid out as this package's ``graphx.Graph``
    (``vertex_ids``, ``vertex_attrs``, ``src``, ``dst``, ``edge_attrs``
    arrays) as this package's ``Graph`` on ``device`` (default: the
    active session's)."""
    from .graphx.graph import Graph, default_device
    dev = torch.device(device) if device is not None else default_device()

    def t(x):
        return torch.from_numpy(np.array(x)).to(dev)
    return Graph(t(graph.vertex_ids),
                 {k: t(v) for k, v in graph.vertex_attrs.items()},
                 t(graph.src), t(graph.dst),
                 {k: t(v) for k, v in graph.edge_attrs.items()})


def chaos_todo(table: List[dict], tier: str = "all",
               only: Sequence[str] = (), blockserver: bool = False,
               pool: bool = False, seed: int = 0) -> List[dict]:
    """The runner's scenarios: those of ``table`` in ``tier`` (``tier1``,
    ``slow`` or ``all``) whose name holds one of ``only`` (all when
    empty), only the ``blockserver-`` or ``pool-`` rows if asked, in
    table order for seed 0, else shuffled by ``random.Random(seed)``."""
    import random
    todo = [sc for sc in table if tier in ("all", sc["tier"])
            and (not only or any(pat in sc["name"] for pat in only))]
    if blockserver:
        todo = [sc for sc in todo if sc["name"].startswith("blockserver-")]
    if pool:
        todo = [sc for sc in todo if sc["name"].startswith("pool-")]
    if seed:
        random.Random(seed).shuffle(todo)
    return todo


def chaos_main(argv: Sequence[str]) -> int:
    """``python -m spark_tpu_torch.testing chaos``: run the matrix
    (``matrix_scenarios``, or ``stream_scenarios`` with ``--streaming``)
    or a filtered part of it on ``--device`` (``cuda`` by default: without
    a card it exits 2 and never falls back to the CPU), in a seeded
    order, and print a verdict table.  Exit 0 only if every scenario
    passes."""
    import argparse
    import shutil
    import tempfile

    ap = argparse.ArgumentParser(
        prog="python -m spark_tpu_torch.testing chaos",
        description="kill-at-phase fault-injection matrix over real "
        "multi-process exchanges")
    ap.add_argument("--seed", type=int, default=0,
                    help="schedule seed: shuffles the scenario order "
                    "deterministically (default 0 = table order)")
    ap.add_argument("--only", action="append", default=[],
                    help="run only scenarios whose name contains this "
                    "substring (repeatable)")
    ap.add_argument("--tier", choices=("tier1", "slow", "all"),
                    default="all", help="restrict to one tier")
    ap.add_argument("--root", default=None,
                    help="parent directory of the scenarios' roots "
                    "(default: a fresh temporary directory per scenario, "
                    "removed when it passes)")
    ap.add_argument("--streaming", action="store_true",
                    help="run the standing-query kill/restart group "
                    "instead of the exchange matrix")
    ap.add_argument("--blockserver", action="store_true",
                    help="run only the block-service rows")
    ap.add_argument("--pool", action="store_true",
                    help="run only the worker-pool rows")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the workers' device (default cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chaos: --device cuda, but no CUDA card is visible "
              "(torch.cuda.is_available() is False); the matrix does not "
              "fall back to the CPU: pass --device cpu to run it there",
              file=sys.stderr)
        return 2

    todo = chaos_todo(
        stream_scenarios() if args.streaming else matrix_scenarios(),
        args.tier, args.only, args.blockserver, args.pool, args.seed)
    if not todo:
        print("no scenarios matched")
        return 2

    rows, failed = [], 0
    for i, sc in enumerate(todo):
        parent = args.root or tempfile.mkdtemp(prefix="chaos-")
        root = os.path.join(parent, f"{i:02d}-{sc['name']}")
        print(f"[chaos] {i + 1}/{len(todo)} {sc['name']} (phase "
              f"{sc['phase']}, n={sc['n']}, {args.device}) ...", flush=True)
        try:
            results, elapsed = run_scenario(sc, root, args.device)
            bad = check_scenario(sc, results, elapsed)
        except Exception as e:               # runner plumbing, not verdict
            results, elapsed, bad = {}, 0.0, [f"runner error: {e!r}"]
        rows.append((sc, elapsed, bad))
        failed += bool(bad)
        for b in bad:
            print(f"  !! {b}", flush=True)
        if bad:
            for pid, (rc, out) in results.items():
                print(f"  -- p{pid} rc={rc} tail: {out.splitlines()[-3:]}",
                      flush=True)
        elif args.root is None:
            shutil.rmtree(parent, ignore_errors=True)

    name_w = max(len(sc["name"]) for sc, _e, _b in rows)
    phase_w = max(len(sc["phase"]) for sc, _e, _b in rows)
    print(f"\n{'scenario':<{name_w}}  {'phase':<{phase_w}}  "
          f"{'tier':<5}  {'s':>6}  verdict")
    for sc, elapsed, bad in rows:
        verdict = "PASS" if not bad else f"FAIL ({'; '.join(bad)})"
        print(f"{sc['name']:<{name_w}}  {sc['phase']:<{phase_w}}  "
              f"{sc['tier']:<5}  {elapsed:>6.1f}  {verdict}")
    print(f"\n{len(rows) - failed}/{len(rows)} scenarios passed "
          f"(seed {args.seed})", flush=True)
    return 1 if failed else 0


#: the entries of ``python -m spark_tpu_torch.testing <entry> ...``
WORKERS = {"crossproc-worker": crossproc_worker,
           "recovery-worker": recovery_worker,
           "analysis-worker": analysis_worker,
           "adaptive-worker": adaptive_worker,
           "stream-chaos": stream_chaos_worker,
           "pool-worker": pool_worker,
           "stream-worker": stream_worker,
           "arena-peer": arena_peer}


def _main(argv: Sequence[str]) -> int:
    if argv and argv[0] in WORKERS:
        return WORKERS[argv[0]](argv[1:])
    if argv and argv[0] == "chaos":
        return chaos_main(argv[1:])
    print("usage: python -m spark_tpu_torch.testing "
          "{crossproc-worker|recovery-worker|analysis-worker|"
          "adaptive-worker|pool-worker|stream-chaos} "
          "<pid> <n> <root> <mode> <timeout_s> {cpu|cuda}\n"
          "       python -m spark_tpu_torch.testing chaos [--seed S] "
          "[--only NAME]... [--tier {tier1,slow,all}] [--root DIR] "
          "[--streaming] [--blockserver] [--pool] [--device {cuda,cpu}]\n"
          "       python -m spark_tpu_torch.testing stream-worker "
          "<root> <shape> <ckpt> <out> <device> [restart]\n"
          "       python -m spark_tpu_torch.testing arena-peer "
          "<root> <nbytes>",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
