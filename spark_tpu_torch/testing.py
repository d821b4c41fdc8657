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
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .columnar import ColumnBatch


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


def q3_oracle(tables):
    """q3 in numpy: the joins as lookups by surrogate key, exact cents."""
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
