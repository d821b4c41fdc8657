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

import os
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

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
