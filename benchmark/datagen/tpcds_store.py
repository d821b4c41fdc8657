"""TPC-DS's store channel (store_sales, date_dim, item) from a seed.

A frozen copy of the port's ``testing.q3_tables`` / ``ooc_tables``
generators, widened to every column of the three tables at its TPC-DS
type (store_sales' 23, date_dim's 28, item's 22), in TPC-DS's value
domains: store_sales as tickets of 8-16 distinct line items, each ticket
one customer, store, household, address, time of day and day of
1998-2002, in ticket order as dsdgen writes them; quantities 1-100,
prices in cents (``decimal(7,2)``) with the pricing identities of the
specification (extended amounts are the quantity times the unit amount,
net paid is the extended sales price less the coupon, and so on);
date_dim from 1900-01-02 (73,049 rows reach 2100-01-01), each column
worked out from the date; items in ten categories with three classes
each, brand ids shaped ``category * 10^6 + class * 10^4 + 1..99``,
managers 1-100 and manufacturers 1-1000, each category, class, manager
and manufacturer held by the same number of items (to one) whatever the
seed.  No value is NULL.

Each column family draws from its own stream, ``[seed, stream]``, so a
column added or asked for changes none of the others: the columns the
texts read are the same whatever else is made.  Prices come back as
integer cents (``CENTS`` names those columns), dates as
``datetime64[D]`` and strings as NumPy unicode arrays.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np

_DEC = "decimal(7,2)"

#: every column of the three tables, in the specification's order, with
#: its SQL type (identifiers as bigint, as the port's generators hold
#: them)
SCHEMA = {
    "store_sales": {
        "ss_sold_date_sk": "bigint", "ss_sold_time_sk": "bigint",
        "ss_item_sk": "bigint", "ss_customer_sk": "bigint",
        "ss_cdemo_sk": "bigint", "ss_hdemo_sk": "bigint",
        "ss_addr_sk": "bigint", "ss_store_sk": "bigint",
        "ss_promo_sk": "bigint", "ss_ticket_number": "bigint",
        "ss_quantity": "int", "ss_wholesale_cost": _DEC,
        "ss_list_price": _DEC, "ss_sales_price": _DEC,
        "ss_ext_discount_amt": _DEC, "ss_ext_sales_price": _DEC,
        "ss_ext_wholesale_cost": _DEC, "ss_ext_list_price": _DEC,
        "ss_ext_tax": _DEC, "ss_coupon_amt": _DEC, "ss_net_paid": _DEC,
        "ss_net_paid_inc_tax": _DEC, "ss_net_profit": _DEC,
    },
    "date_dim": {
        "d_date_sk": "bigint", "d_date_id": "string", "d_date": "date",
        "d_month_seq": "int", "d_week_seq": "int", "d_quarter_seq": "int",
        "d_year": "int", "d_dow": "int", "d_moy": "int", "d_dom": "int",
        "d_qoy": "int", "d_fy_year": "int", "d_fy_quarter_seq": "int",
        "d_fy_week_seq": "int", "d_day_name": "string",
        "d_quarter_name": "string", "d_holiday": "string",
        "d_weekend": "string", "d_following_holiday": "string",
        "d_first_dom": "int", "d_last_dom": "int", "d_same_day_ly": "int",
        "d_same_day_lq": "int", "d_current_day": "string",
        "d_current_week": "string", "d_current_month": "string",
        "d_current_quarter": "string", "d_current_year": "string",
    },
    "item": {
        "i_item_sk": "bigint", "i_item_id": "string",
        "i_rec_start_date": "date", "i_rec_end_date": "date",
        "i_item_desc": "string", "i_current_price": _DEC,
        "i_wholesale_cost": _DEC, "i_brand_id": "int", "i_brand": "string",
        "i_class_id": "int", "i_class": "string", "i_category_id": "int",
        "i_category": "string", "i_manufact_id": "int",
        "i_manufact": "string", "i_size": "string",
        "i_formulation": "string", "i_color": "string",
        "i_units": "string", "i_container": "string",
        "i_manager_id": "int", "i_product_name": "string",
    },
}

#: columns held as integer cents (``decimal(7,2)``)
CENTS = {c for cols in SCHEMA.values() for c, t in cols.items() if t == _DEC}

CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry", "Men",
              "Music", "Shoes", "Sports", "Women"]
CLASSES = ["accent", "bedding", "classical", "dresses", "estate", "fiction",
           "fitness", "pants", "portable", "romance"]
#: dsdgen's syllables, one per digit, of which a number's word is made
SYLLABLES = ["bar", "ought", "able", "pri", "ese", "anti", "cally", "ation",
             "eing", "n st"]
SIZES = ["petite", "small", "medium", "large", "extra large", "economy",
         "N/A"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "burnished", "chartreuse", "chiffon", "chocolate", "coral",
          "cornflower", "cornsilk", "cream", "cyan", "dark", "deep", "dim",
          "dodger", "drab", "firebrick", "floral", "forest", "frosted",
          "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
          "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
          "lemon", "light", "lime", "linen", "magenta", "maroon", "medium",
          "metallic", "midnight", "mint", "misty", "moccasin", "navajo",
          "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
          "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose",
          "rosy", "royal", "saddle", "salmon", "sandy", "seashell", "sienna",
          "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
          "thistle", "tomato", "turquoise", "violet", "wheat", "white",
          "yellow"]
UNITS = ["Each", "Dozen", "Case", "Pallet", "Gross", "Carton", "Box",
         "Bunch", "Bundle", "Oz", "Lb", "Tsp", "Tbl", "Cup", "Dram", "Gram",
         "Ton", "Unknown"]
#: the words of an item's description
WORDS = ["able", "about", "above", "across", "actual", "agents", "always",
         "areas", "based", "become", "better", "blue", "bright", "carefully",
         "central", "certain", "changes", "clear", "close", "common",
         "complete", "current", "deep", "different", "direct", "early",
         "easy", "effective", "english", "entire", "even", "final", "fine",
         "free", "full", "general", "good", "great", "high", "important",
         "large", "late", "likely", "little", "local", "long", "main",
         "major", "modern", "national", "natural", "new", "normal", "old",
         "only", "open", "other", "particular", "political", "poor",
         "possible", "present", "private", "public", "quick", "real",
         "recent", "right", "safe", "serious", "short", "similar", "simple",
         "single", "small", "social", "special", "strong", "sure", "total",
         "true", "usual", "various", "whole", "wide", "young"]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
#: (month, day) of the holidays marked in date_dim
HOLIDAYS = ((1, 1), (7, 4), (12, 25))
#: the start dates of an item's record (dsdgen's revision dates)
REC_STARTS = ("1997-10-27", "1999-10-28", "2000-10-27", "2001-10-27")

DATE0 = np.datetime64("1900-01-02")   # date_dim's first row
DATE_SK0 = 2415022                    # ... and its surrogate key
SALES_SK = (2450816, 2452642)         # 1998-01-02 .. 2002-12-31
TICKET_LINES = (8, 16)
#: a sale's time of day, seconds (store hours 8:00-20:59)
STORE_HOURS_S = (8 * 3600, 21 * 3600 - 1)

# one stream per column family; a new family takes the next number
(_TICKETS, _QUANTITY, _PRICE, _ITEM_CAT, _ITEM_CLASS, _ITEM_BRAND,
 _ITEM_MANUFACT, _ITEM_MANAGER, _TICKET_DIMS, _PROMO, _WHOLESALE, _MARKUP,
 _COUPON, _TAX, _ITEM_PRICE, _ITEM_DESC, _ITEM_LOOKS, _ITEM_REC) = range(18)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def _ticket_sizes(n: int, rng: np.random.Generator):
    """(lines of each ticket, the first line of each): the last ticket is
    cut to ``n`` rows, its first line placed as if it were not."""
    lo, hi = TICKET_LINES
    sizes = rng.integers(lo, hi + 1, n // lo + 1)
    ends = np.cumsum(sizes)
    n_tickets = int(np.searchsorted(ends, n)) + 1
    sizes = sizes[:n_tickets].copy()
    sizes[-1] -= int(ends[n_tickets - 1]) - n
    return sizes, ends[:n_tickets] - sizes


def _tickets(n: int, rows: Mapping[str, int], seed: int) -> dict:
    rng = _rng(seed, _TICKETS)
    n_items = rows["item"]
    sizes, firsts = _ticket_sizes(n, rng)
    n_tickets = len(sizes)
    starts = np.repeat(firsts, sizes)
    line = np.arange(n) - starts
    first = rng.integers(0, n_items, n_tickets)
    stride = rng.integers(1, max(n_items // TICKET_LINES[1], 2), n_tickets)
    item = (np.repeat(first, sizes) + line * np.repeat(stride, sizes)) \
        % n_items + 1
    day = rng.integers(SALES_SK[0], SALES_SK[1] + 1, n_tickets)
    cust = rng.integers(1, int(rows.get("customer", 1)) + 1, n_tickets)
    out = {
        "ss_sold_date_sk": np.repeat(day, sizes),
        "ss_item_sk": item,
        "ss_customer_sk": np.repeat(cust, sizes),
        "ss_ticket_number": np.repeat(
            np.arange(1, n_tickets + 1, dtype=np.int64), sizes),
    }
    # the rest of a ticket's keys: one time, household, address and store
    dims = _rng(seed, _TICKET_DIMS)
    for col, lo, hi in (
            ("ss_sold_time_sk", *STORE_HOURS_S),
            ("ss_cdemo_sk", 1, rows["customer_demographics"]),
            ("ss_hdemo_sk", 1, rows["household_demographics"]),
            ("ss_addr_sk", 1, rows["customer_address"]),
            ("ss_store_sk", 1, rows["store"])):
        out[col] = np.repeat(dims.integers(lo, hi + 1, n_tickets), sizes)
    out["ss_promo_sk"] = _rng(seed, _PROMO).integers(
        1, rows["promotion"] + 1, n)
    return out


def _store_sales(n: int, rows: Mapping[str, int], seed: int,
                 columns: Iterable[str]) -> dict:
    want = set(columns)
    out = {}
    if want & {"ss_sold_date_sk", "ss_sold_time_sk", "ss_item_sk",
               "ss_customer_sk", "ss_cdemo_sk", "ss_hdemo_sk", "ss_addr_sk",
               "ss_store_sk", "ss_promo_sk", "ss_ticket_number"}:
        out.update(_tickets(n, rows, seed))
    prices = want & CENTS
    if prices or "ss_quantity" in want:
        out["ss_quantity"] = _rng(seed, _QUANTITY).integers(
            1, 101, n).astype(np.int32)
    if prices:
        qty = out["ss_quantity"].astype(np.int64)
        sales = _rng(seed, _PRICE).integers(0, 20_001, n)
        out["ss_sales_price"] = sales
        out["ss_ext_sales_price"] = qty * sales
    if prices - {"ss_sales_price", "ss_ext_sales_price"}:
        ext_sales = out["ss_ext_sales_price"]
        whole = _rng(seed, _WHOLESALE).integers(100, 10_001, n)
        # the list price lies 0-100% above the sales price
        markup = _rng(seed, _MARKUP).integers(0, 101, n)
        listp = sales + sales * markup // 100
        coupon_rng = _rng(seed, _COUPON)
        used = coupon_rng.random(n) < 0.2
        coupon = np.where(used, ext_sales * coupon_rng.integers(
            0, 101, n) // 100, 0)
        net = ext_sales - coupon
        tax = net * _rng(seed, _TAX).integers(0, 10, n) // 100
        out.update({
            "ss_wholesale_cost": whole,
            "ss_list_price": listp,
            "ss_ext_discount_amt": (listp - sales) * qty,
            "ss_ext_wholesale_cost": whole * qty,
            "ss_ext_list_price": listp * qty,
            "ss_ext_tax": tax,
            "ss_coupon_amt": coupon,
            "ss_net_paid": net,
            "ss_net_paid_inc_tax": net + tax,
            "ss_net_profit": net - whole * qty,
        })
    return {c: out[c] for c in columns}


def _bkey(keys: np.ndarray) -> np.ndarray:
    """16-letter business ids: eight A's, then the key's eight hex digits
    as the letters A-P."""
    keys = keys.astype(np.int64)
    letters = np.full((len(keys), 16), ord("A"), np.uint8)
    for k in range(8):
        letters[:, 15 - k] += ((keys >> (4 * k)) & 15).astype(np.uint8)
    return letters.view("S16").reshape(-1).astype("U16")


def _word(numbers: np.ndarray) -> np.ndarray:
    """A number as dsdgen's word: one syllable per decimal digit."""
    numbers = numbers.astype(np.int64)
    syl = np.asarray(SYLLABLES)
    out = syl[numbers % 10]
    rest = numbers // 10
    while (rest > 0).any():
        out = np.where(rest > 0, np.char.add(syl[rest % 10], out), out)
        rest //= 10
    return out


def _yn(mask: np.ndarray) -> np.ndarray:
    return np.where(mask, "Y", "N")


def _date_dim(n: int, columns: Iterable[str]) -> dict:
    want = set(columns)
    days = DATE0 + np.arange(n)
    sk = DATE_SK0 + np.arange(n, dtype=np.int64)
    month = days.astype("datetime64[M]")
    year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    moy = month.astype(np.int64) % 12 + 1
    dom = (days - month).astype(np.int64) + 1
    qoy = (moy - 1) // 3 + 1
    dow = (days.astype(np.int64) + 4) % 7          # 1970-01-01: a Thursday
    week_seq = (sk - DATE_SK0 + 2) // 7 + 1        # weeks from 1899-12-31
    quarter_seq = (year - 1900) * 4 + qoy
    first_dom = sk - (dom - 1)
    next_month = (month + 1).astype("datetime64[D]")
    last_dom = sk + (next_month - days).astype(np.int64) - 1
    holiday = np.zeros(n, bool)
    for m, d in HOLIDAYS:
        holiday |= (moy == m) & (dom == d)
    out = {
        "d_date_sk": sk,
        "d_date": days,
        "d_month_seq": (year - 1900) * 12 + moy - 1,
        "d_week_seq": week_seq,
        "d_quarter_seq": quarter_seq,
        "d_year": year,
        "d_dow": dow,
        "d_moy": moy,
        "d_dom": dom,
        "d_qoy": qoy,
        "d_fy_year": year,
        "d_fy_quarter_seq": quarter_seq,
        "d_fy_week_seq": week_seq,
        "d_first_dom": first_dom,
        "d_last_dom": last_dom,
        "d_same_day_ly": sk - 365,
        "d_same_day_lq": sk - 91,
    }
    out = {c: (v.astype(np.int32) if SCHEMA["date_dim"][c] == "int" else v)
           for c, v in out.items()}
    if "d_date_id" in want:
        out["d_date_id"] = _bkey(sk)
    if "d_day_name" in want:
        out["d_day_name"] = np.asarray(DAY_NAMES)[dow]
    if "d_quarter_name" in want:
        out["d_quarter_name"] = np.char.add(np.char.add(
            year.astype("U4"), "Q"), qoy.astype("U1"))
    out["d_holiday"] = _yn(holiday)
    out["d_weekend"] = _yn((dow == 0) | (dow == 6))
    out["d_following_holiday"] = _yn(np.concatenate([[False],
                                                     holiday[:-1]]))
    for c in ("d_current_day", "d_current_week", "d_current_month",
              "d_current_quarter", "d_current_year"):
        out[c] = _yn(np.zeros(n, bool))
    return {c: out[c] for c in columns}


def _balanced(seed: int, stream: int, n: int, k: int) -> np.ndarray:
    """Values 1..k over n rows, each held by n // k or n // k + 1 rows, in
    an order drawn from the seed: every seed filters the same number of
    items, so a text's work does not move with the seed."""
    return _rng(seed, stream).permutation(np.arange(n) % k) + 1


def _item(n: int, seed: int, columns: Iterable[str]) -> dict:
    want = set(columns)
    sk = np.arange(1, n + 1, dtype=np.int64)
    cat = _balanced(seed, _ITEM_CAT, n, 10)
    # classes nest within categories, three to a category, as dsdgen's do
    cls = ((cat - 1) * 3 + _balanced(seed, _ITEM_CLASS, n, 3) - 1) % 10 + 1
    brand = cat * 1_000_000 + cls * 10_000 + \
        _rng(seed, _ITEM_BRAND).integers(1, 100, n)
    manufact = _balanced(seed, _ITEM_MANUFACT, n, 1000)
    out = {
        "i_item_sk": sk,
        "i_brand_id": brand.astype(np.int32),
        "i_class_id": cls.astype(np.int32),
        "i_category_id": cat.astype(np.int32),
        "i_manufact_id": manufact.astype(np.int32),
    }
    if "i_item_id" in want:
        out["i_item_id"] = _bkey(sk)
    if want & {"i_rec_start_date", "i_rec_end_date"}:
        starts = np.asarray(REC_STARTS, "datetime64[D]")
        ends = np.concatenate([starts[1:] - 1,
                               [DATE0 + 73_048]])      # open: date_dim's end
        rev = _rng(seed, _ITEM_REC).integers(0, len(starts), n)
        out["i_rec_start_date"] = starts[rev]
        out["i_rec_end_date"] = ends[rev]
    if "i_item_desc" in want:
        rng = _rng(seed, _ITEM_DESC)
        words = rng.integers(0, len(WORDS), (n, 24)).tolist()
        count = rng.integers(6, 25, n).tolist()
        out["i_item_desc"] = np.asarray(
            [" ".join(WORDS[w] for w in ws[:k])[:200]
             for ws, k in zip(words, count)])
    if want & {"i_current_price", "i_wholesale_cost"}:
        rng = _rng(seed, _ITEM_PRICE)
        price = rng.integers(9, 10_000, n)
        out["i_current_price"] = price
        out["i_wholesale_cost"] = price * rng.integers(30, 101, n) // 100
    if "i_brand" in want:
        out["i_brand"] = np.char.add("brand#", brand.astype("U8"))
    if "i_class" in want:
        out["i_class"] = np.asarray(CLASSES)[cls - 1]
    if "i_category" in want:
        out["i_category"] = np.asarray(CATEGORIES)[cat - 1]
    if "i_manufact" in want:
        out["i_manufact"] = _word(manufact)
    if want & {"i_size", "i_formulation", "i_color", "i_units",
               "i_container"}:
        rng = _rng(seed, _ITEM_LOOKS)
        out["i_size"] = np.asarray(SIZES)[rng.integers(0, len(SIZES), n)]
        digits = rng.integers(0, 10, (n, 20)).astype(np.uint8) + ord("0")
        out["i_formulation"] = digits.view("S20").reshape(-1).astype("U20")
        out["i_color"] = np.asarray(COLORS)[rng.integers(0, len(COLORS), n)]
        out["i_units"] = np.asarray(UNITS)[rng.integers(0, len(UNITS), n)]
        out["i_container"] = np.full(n, "Unknown")
    if "i_manager_id" in want:
        out["i_manager_id"] = _balanced(seed, _ITEM_MANAGER, n,
                                        100).astype(np.int32)
    if "i_product_name" in want:
        out["i_product_name"] = _word(sk)
    return {c: out[c] for c in columns}


def generate(rows: Mapping[str, int], seed: int,
             columns: Mapping[str, Iterable[str]]
             ) -> Dict[str, Dict[str, np.ndarray]]:
    """The tables of ``columns`` (table -> column names) at the row counts
    ``rows`` (the three tables', and the key ranges of the dimensions
    store_sales refers to), as host arrays; prices in integer cents."""
    out = {}
    for table, cols in columns.items():
        cols = list(cols)
        unknown = set(cols) - set(SCHEMA[table])
        if unknown:
            raise ValueError(f"{table}: no generator for {sorted(unknown)}")
        if table == "store_sales":
            out[table] = _store_sales(rows["store_sales"], rows, seed, cols)
        elif table == "date_dim":
            out[table] = _date_dim(rows["date_dim"], cols)
        else:
            out[table] = _item(rows["item"], seed, cols)
    return out
