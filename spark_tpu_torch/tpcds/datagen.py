"""Deterministic scaled-down TPC-DS data generator: the port's copy of
``spark_tpu/tpcds/datagen.py`` without pandas.

Each table is a dict of 1-D numpy arrays, ``{column: ndarray}``, which
``SparkSession.createDataFrame`` takes as it is.  The tables come from
the same ``np.random.default_rng(seed)`` draws in the same order as the
JAX package's, and hold what its pandas frames hold: numeric columns in
their numpy dtypes, strings as object arrays, NULLs as ``None`` in
object columns (the fact tables' nullable keys) and as NaN in float
columns (``measure_null_frac``).

Not dsdgen: a seeded numpy generator producing referentially-consistent
tables with the official columns and value domains the query set filters
on (categories, demographics bands, calendar).  Correctness testing needs
an oracle on the SAME data (sqlite / pandas), so official distributions
are unnecessary; sizes scale linearly with ``sf_rows``.

Returns sampled from sales keep the (item, ticket/order, customer) join
identity the 3-channel queries (q17/q25/q29...) rely on.
"""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np

from .schema import TABLES

Table = Dict[str, np.ndarray]


def _column(v, n: int) -> np.ndarray:
    """One column of ``n`` rows as a pandas frame would hold it: a
    scalar broadcast, strings as objects, a fresh array (frames copy the
    arrays they are built from)."""
    if isinstance(v, np.ndarray):
        return v.astype(object) if v.dtype.kind == "U" else v.copy()
    if isinstance(v, list):
        out = np.empty(len(v), dtype=object)
        out[:] = v
        return out
    if v is None or isinstance(v, str):
        return np.full(n, v, dtype=object)
    return np.full(n, v)


def _frame(cols: dict) -> Table:
    """A table from columns and scalars (the ``pd.DataFrame(dict)`` the
    JAX package builds)."""
    n = max(len(v) for v in cols.values()
            if isinstance(v, (np.ndarray, list)))
    return {k: _column(v, n) for k, v in cols.items()}


def _take(table: Table, idx: np.ndarray) -> Table:
    """Rows ``idx`` of every column (``DataFrame.iloc``)."""
    return {k: v[idx] for k, v in table.items()}


def _filled(arr: np.ndarray, fill: int) -> np.ndarray:
    """A nullable key column with NULL read as ``fill``, as int64 (the
    JAX package goes through float: exact for these keys)."""
    return np.array([fill if v is None else v for v in arr],
                    dtype=np.float64).astype(np.int64)

CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
              "Men", "Music", "Shoes", "Sports", "Women"]
CLASSES = ["accent", "bedding", "classical", "dresses", "estate",
           "fiction", "fitness", "pants", "portable", "romance"]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                 "0-500", "Unknown"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"]
CREDIT_RATING = ["Low Risk", "Good", "High Risk", "Unknown"]
STATES = ["TN", "CA", "TX", "NY", "OH", "GA", "IL", "WA", "MI", "NC"]
COUNTIES = ["Williamson County", "Walker County", "Ziebach County",
            "Bronx County", "Franklin Parish"]
SM_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "LIBRARY"]
SM_CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL"]

DATE0_SK = 2450815            # 1998-01-01, official julian-style origin
DATE0 = datetime.date(1998, 1, 1)
N_DAYS = 5 * 365 + 1          # 1998-01-01 .. 2002-12-30


def _date_dim() -> Table:
    days = np.arange(N_DAYS)
    dates = [DATE0 + datetime.timedelta(days=int(i)) for i in days]
    yy = np.array([d.year for d in dates], np.int32)
    mm = np.array([d.month for d in dates], np.int32)
    dd = np.array([d.day for d in dates], np.int32)
    dow = np.array([(d.weekday() + 1) % 7 for d in dates], np.int32)  # 0=Sun
    qoy = (mm - 1) // 3 + 1
    month_seq = (yy - 1900) * 12 + (mm - 1)
    week_seq = (days + (DATE0.weekday() + 1) % 7) // 7 + 5112
    return _frame({
        "d_date_sk": DATE0_SK + days,
        "d_date_id": [f"AAAAAAAA{sk:08d}" for sk in DATE0_SK + days],
        "d_date": [d.isoformat() for d in dates],
        "d_month_seq": month_seq,
        "d_week_seq": week_seq.astype(np.int32),
        "d_quarter_seq": (yy - 1900) * 4 + qoy - 1,
        "d_year": yy, "d_dow": dow, "d_moy": mm, "d_dom": dd, "d_qoy": qoy,
        "d_fy_year": yy, "d_fy_quarter_seq": (yy - 1900) * 4 + qoy - 1,
        "d_fy_week_seq": week_seq.astype(np.int32),
        "d_day_name": [DAY_NAMES[x] for x in dow],
        "d_quarter_name": [f"{y}Q{q}" for y, q in zip(yy, qoy)],
        "d_holiday": np.where((mm == 12) & (dd == 25), "Y", "N"),
        "d_weekend": np.where((dow == 0) | (dow == 6), "Y", "N"),
        "d_following_holiday": "N",
        "d_first_dom": (DATE0_SK + days - dd + 1).astype(np.int64),
        "d_last_dom": (DATE0_SK + days - dd + 28).astype(np.int64),
        "d_same_day_ly": DATE0_SK + days - 365,
        "d_same_day_lq": DATE0_SK + days - 91,
        "d_current_day": "N", "d_current_week": "N", "d_current_month": "N",
        "d_current_quarter": "N", "d_current_year": "N",
    })


def _time_dim() -> Table:
    t = np.arange(86400)
    hh, rem = t // 3600, t % 3600
    return _frame({
        "t_time_sk": t.astype(np.int64),
        "t_time_id": [f"AAAAAAAA{x:08d}" for x in t],
        "t_time": t.astype(np.int32),
        "t_hour": hh.astype(np.int32),
        "t_minute": (rem // 60).astype(np.int32),
        "t_second": (rem % 60).astype(np.int32),
        "t_am_pm": np.where(hh < 12, "AM", "PM"),
        "t_shift": np.where(hh < 8, "third",
                            np.where(hh < 16, "first", "second")),
        "t_sub_shift": np.where(hh < 6, "night",
                                np.where(hh < 12, "morning",
                                         np.where(hh < 18, "afternoon",
                                                  "evening"))),
        "t_meal_time": np.where((hh >= 6) & (hh < 9), "breakfast",
                                np.where((hh >= 11) & (hh < 14), "lunch",
                                         np.where((hh >= 17) & (hh < 20),
                                                  "dinner", None))),
    })


def _items(rng, n) -> Table:
    sk = np.arange(1, n + 1)
    cat_id = rng.integers(1, 11, n)
    # classes NEST within categories (3 per category), as in dsdgen's
    # hierarchy — category and class are correlated, so conjunctive
    # filters like q54's (i_category AND i_class) select real item sets.
    # The raw draw keeps the SAME rng stream shape as the historical
    # independent draw, so every downstream column (manufact, manager,
    # colors...) and the fixed query parameters keyed to them survive.
    class_raw = rng.integers(1, 11, n)
    class_id = ((cat_id - 1) * 3 + class_raw % 3) % 10 + 1
    manufact = rng.integers(1, 101, n)
    brand_id = cat_id * 1000000 + class_id * 10000 + rng.integers(1, 100, n)
    manager = rng.integers(1, 101, n)
    return _frame({
        "i_item_sk": sk.astype(np.int64),
        "i_item_id": [f"AAAAAAAA{x:08d}" for x in sk],
        "i_rec_start_date": "1997-10-27", "i_rec_end_date": None,
        "i_item_desc": [f"item description {x}" for x in sk],
        "i_current_price": np.round(rng.uniform(0.5, 100.0, n), 2),
        "i_wholesale_cost": np.round(rng.uniform(0.3, 80.0, n), 2),
        "i_brand_id": brand_id.astype(np.int32),
        "i_brand": [f"brand#{b}" for b in brand_id],
        "i_class_id": class_id.astype(np.int32),
        "i_class": [CLASSES[c - 1] for c in class_id],
        "i_category_id": cat_id.astype(np.int32),
        "i_category": [CATEGORIES[c - 1] for c in cat_id],
        "i_manufact_id": manufact.astype(np.int32),
        "i_manufact": [f"manufact#{m}" for m in manufact],
        "i_size": rng.choice(["small", "medium", "large", "extra large",
                              "economy", "N/A", "petite"], n),
        "i_formulation": [f"formulation {x}" for x in rng.integers(0, 100, n)],
        "i_color": rng.choice(["red", "blue", "green", "white", "black",
                               "navy", "peru", "saddle", "powder"], n),
        "i_units": rng.choice(["Each", "Dozen", "Case", "Pallet", "Oz",
                               "Lb", "Ton", "Gram"], n),
        "i_container": "Unknown",
        "i_manager_id": manager.astype(np.int32),
        "i_product_name": [f"product {x}" for x in sk],
    })


def _customers(rng, n, n_addr, n_cdemo, n_hdemo) -> Table:
    sk = np.arange(1, n + 1)
    by = rng.integers(1924, 1993, n)
    return _frame({
        "c_customer_sk": sk.astype(np.int64),
        "c_customer_id": [f"AAAAAAAA{x:08d}" for x in sk],
        "c_current_cdemo_sk": rng.integers(1, n_cdemo + 1, n).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(1, n_hdemo + 1, n).astype(np.int64),
        "c_current_addr_sk": rng.integers(1, n_addr + 1, n).astype(np.int64),
        "c_first_shipto_date_sk": DATE0_SK + rng.integers(0, N_DAYS, n),
        "c_first_sales_date_sk": DATE0_SK + rng.integers(0, N_DAYS, n),
        "c_salutation": rng.choice(["Mr.", "Mrs.", "Ms.", "Dr.", "Miss",
                                    "Sir"], n),
        "c_first_name": rng.choice(["James", "Mary", "John", "Linda",
                                    "Robert", "Ann", "Jose", "Lily"], n),
        "c_last_name": rng.choice(["Smith", "Jones", "Brown", "Lee",
                                   "Wilson", "Garcia", "Miller"], n),
        "c_preferred_cust_flag": rng.choice(["Y", "N"], n),
        "c_birth_day": rng.integers(1, 29, n).astype(np.int32),
        "c_birth_month": rng.integers(1, 13, n).astype(np.int32),
        "c_birth_year": by.astype(np.int32),
        "c_birth_country": rng.choice(["UNITED STATES", "CANADA", "MEXICO",
                                       "FRANCE", "JAPAN"], n),
        "c_login": None,
        "c_email_address": [f"c{x}@example.com" for x in sk],
        "c_last_review_date": None,
    })


def _addresses(rng, n) -> Table:
    sk = np.arange(1, n + 1)
    return _frame({
        "ca_address_sk": sk.astype(np.int64),
        "ca_address_id": [f"AAAAAAAA{x:08d}" for x in sk],
        "ca_street_number": [str(x) for x in rng.integers(1, 1000, n)],
        "ca_street_name": rng.choice(["Main", "Oak", "First", "Park",
                                      "Cedar", "Elm"], n),
        "ca_street_type": rng.choice(["St", "Ave", "Blvd", "Way", "Dr"], n),
        "ca_suite_number": [f"Suite {x}" for x in rng.integers(0, 100, n)],
        "ca_city": rng.choice(["Fairview", "Midway", "Oak Grove",
                               "Centerville", "Riverside", "Salem"], n),
        "ca_county": rng.choice(COUNTIES, n),
        "ca_state": rng.choice(STATES, n),
        "ca_zip": [f"{x:05d}" for x in
           rng.choice(rng.integers(10000, 99999, 200), n)],
        "ca_country": "United States",
        "ca_gmt_offset": rng.choice([-5.0, -6.0, -7.0, -8.0], n),
        "ca_location_type": rng.choice(["apartment", "condo",
                                        "single family"], n),
    })


def _cdemo(n) -> Table:
    sk = np.arange(1, n + 1)
    return _frame({
        "cd_demo_sk": sk.astype(np.int64),
        "cd_gender": np.where(sk % 2 == 0, "F", "M"),
        "cd_marital_status": np.array(["M", "S", "D", "W", "U"])[sk % 5],
        "cd_education_status": np.array(EDUCATION)[sk % 7],
        "cd_purchase_estimate": ((sk % 20) * 500 + 500).astype(np.int32),
        "cd_credit_rating": np.array(CREDIT_RATING)[sk % 4],
        "cd_dep_count": (sk % 7).astype(np.int32),
        "cd_dep_employed_count": (sk % 7).astype(np.int32),
        "cd_dep_college_count": (sk % 7).astype(np.int32),
    })


def _hdemo(n) -> Table:
    sk = np.arange(1, n + 1)
    return _frame({
        "hd_demo_sk": sk.astype(np.int64),
        "hd_income_band_sk": (sk % 20 + 1).astype(np.int64),
        "hd_buy_potential": np.array(BUY_POTENTIAL)[sk % 6],
        "hd_dep_count": (sk % 10).astype(np.int32),
        "hd_vehicle_count": (sk % 6 - 1).astype(np.int32),
    })


def _stores(rng, n, zips=None) -> Table:
    sk = np.arange(1, n + 1)
    return _frame({
        "s_store_sk": sk.astype(np.int64),
        "s_store_id": [f"AAAAAAAA{x:08d}" for x in sk],
        "s_rec_start_date": "1997-03-13", "s_rec_end_date": None,
        "s_closed_date_sk": None,
        "s_store_name": rng.choice(["ought", "able", "pri", "ese", "anti",
                                    "cally", "ation", "eing"], n),
        "s_number_employees": rng.integers(200, 300, n).astype(np.int32),
        "s_floor_space": rng.integers(5000000, 10000000, n).astype(np.int32),
        "s_hours": rng.choice(["8AM-8AM", "8AM-4PM", "8AM-12AM"], n),
        "s_manager": [f"Manager {x}" for x in rng.integers(1, 50, n)],
        "s_market_id": rng.integers(1, 11, n).astype(np.int32),
        "s_geography_class": "Unknown",
        "s_market_desc": [f"market {x}" for x in rng.integers(0, 50, n)],
        "s_market_manager": [f"Mkt Manager {x}"
                             for x in rng.integers(1, 50, n)],
        "s_division_id": np.ones(n, np.int32),
        "s_division_name": "Unknown",
        "s_company_id": np.ones(n, np.int32),
        "s_company_name": "Unknown",
        "s_street_number": [str(x) for x in rng.integers(1, 1000, n)],
        "s_street_name": rng.choice(["Main", "Oak", "First"], n),
        "s_street_type": rng.choice(["St", "Ave", "Blvd"], n),
        "s_suite_number": [f"Suite {x}" for x in rng.integers(0, 100, n)],
        "s_city": rng.choice(["Fairview", "Midway"], n),
        "s_county": rng.choice(COUNTIES, n),
        "s_state": rng.choice(STATES[:5], n),
        # store zips come from the address zip pool when provided: spec
        # queries (q24) join stores to customer addresses on zip equality
        "s_zip": (list(rng.choice(zips, n)) if zips is not None
                  else [f"{x:05d}" for x in rng.integers(10000, 99999, n)]),
        "s_country": "United States",
        "s_gmt_offset": rng.choice([-5.0, -6.0], n),
        "s_tax_precentage": np.round(rng.uniform(0.0, 0.11, n), 2),
    })


def _promotions(rng, n, n_items) -> Table:
    sk = np.arange(1, n + 1)
    flags = lambda: rng.choice(["Y", "N"], n)  # noqa: E731
    return _frame({
        "p_promo_sk": sk.astype(np.int64),
        "p_promo_id": [f"AAAAAAAA{x:08d}" for x in sk],
        "p_start_date_sk": DATE0_SK + rng.integers(0, N_DAYS, n),
        "p_end_date_sk": DATE0_SK + rng.integers(0, N_DAYS, n),
        "p_item_sk": rng.integers(1, n_items + 1, n).astype(np.int64),
        "p_cost": 1000.0,
        "p_response_target": np.ones(n, np.int32),
        "p_promo_name": rng.choice(["ought", "able", "pri", "ese"], n),
        "p_channel_dmail": flags(), "p_channel_email": flags(),
        "p_channel_catalog": flags(), "p_channel_tv": flags(),
        "p_channel_radio": flags(), "p_channel_press": flags(),
        "p_channel_event": flags(), "p_channel_demo": flags(),
        "p_channel_details": [f"promo details {x}" for x in sk],
        "p_purpose": "Unknown",
        "p_discount_active": flags(),
    })


class SkewDists:
    """dsdgen-like marginals for the sales facts (VERDICT r3 item 7):

    * Zipf(alpha) item/customer popularity over PERMUTED domains (hot
      ids scattered, not clustered at low sks),
    * a few hot stores,
    * seasonal dates (holiday-quarter ramp + weekend lift),
    * item-category price levels (price correlates with category).

    Uniform generation remains the default (``skew=None``)."""

    def __init__(self, rng, alpha, n_items, n_cust, n_store, date_n,
                 item_cat_ids, date_moy, date_dow):
        self.rng = rng
        self._items = self._zipf(n_items, alpha)
        self._custs = self._zipf(n_cust, alpha)
        self._stores = self._zipf(n_store, max(alpha * 0.75, 0.5))
        dow = date_dow[:date_n]
        w = (1.0 + 1.5 * (date_moy[:date_n] >= 11)
             + 0.3 * ((dow == 0) | (dow == 6)))   # 0=Sun, 6=Sat

        self._date_w = w / w.sum()
        self.date_n = date_n
        # category price level: Books cheap → Jewelry dear, 0.6x..1.5x
        self.price_mult = 0.6 + 0.1 * item_cat_ids.astype(np.float64)

    def _zipf(self, domain_n, alpha):
        ranks = np.arange(1, domain_n + 1, dtype=np.float64)
        w = ranks ** -alpha
        w /= w.sum()
        perm = self.rng.permutation(domain_n)
        return (w, perm)

    def _draw(self, spec, n):
        w, perm = spec
        return (perm[self.rng.choice(len(w), size=n, p=w)] + 1
                ).astype(np.int64)

    def items(self, n):
        return self._draw(self._items, n)

    def customers(self, n):
        return self._draw(self._custs, n)

    def stores(self, n):
        return self._draw(self._stores, n)

    def dates(self, n):
        return self.rng.choice(self.date_n, size=n, p=self._date_w)


def _sales(rng, n, pre, date_n, n_items, n_cust, n_addr, n_cdemo, n_hdemo,
           n_store, n_promo, with_ship=False, extra=None,
           dists: "SkewDists | None" = None) -> Table:
    """Generic sales fact; `pre` is the column prefix data ('ss'...)."""
    qty = rng.integers(1, 101, n)
    # skewed draws happen up front; the UNIFORM path must draw item_sk at
    # its historical position inside the dict below — the rng stream
    # shape is load-bearing (fixed query parameters key to it)
    item_sk = dists.items(n) if dists is not None else None
    wholesale = np.round(rng.uniform(1.0, 100.0, n), 2)
    if dists is not None:
        wholesale = np.round(wholesale * dists.price_mult[item_sk - 1], 2)
    list_price = np.round(wholesale * rng.uniform(1.0, 2.0, n), 2)
    sales_price = np.round(list_price * rng.uniform(0.2, 1.0, n), 2)
    ext_discount = np.round((list_price - sales_price) * qty, 2)
    ext_sales = np.round(sales_price * qty, 2)
    ext_wholesale = np.round(wholesale * qty, 2)
    ext_list = np.round(list_price * qty, 2)
    ext_tax = np.round(ext_sales * 0.08, 2)
    coupon = np.round(ext_sales * rng.choice([0.0, 0.0, 0.0, 0.1], n), 2)
    net_paid = np.round(ext_sales - coupon, 2)
    net_paid_tax = np.round(net_paid + ext_tax, 2)
    profit = np.round(net_paid - ext_wholesale, 2)
    sold_date = DATE0_SK + (dists.dates(n) if dists is not None
                            else rng.integers(0, date_n, n))

    def null_some(arr, frac=0.04):
        a = arr.astype(object)
        mask = rng.random(n) < frac
        a[mask] = None
        return a

    base = {
        "sold_date_sk": null_some(sold_date),
        "sold_time_sk": rng.integers(0, 86400, n).astype(np.int64),
        "item_sk": (item_sk if item_sk is not None
                    else rng.integers(1, n_items + 1, n).astype(np.int64)),
        "customer_sk": null_some(
            dists.customers(n) if dists is not None
            else rng.integers(1, n_cust + 1, n)),
        "cdemo_sk": rng.integers(1, n_cdemo + 1, n).astype(np.int64),
        "hdemo_sk": rng.integers(1, n_hdemo + 1, n).astype(np.int64),
        "addr_sk": rng.integers(1, n_addr + 1, n).astype(np.int64),
        "store_sk": null_some(
            dists.stores(n) if dists is not None
            else rng.integers(1, n_store + 1, n)),
        "promo_sk": rng.integers(1, n_promo + 1, n).astype(np.int64),
        "ticket_number": np.arange(1, n + 1, dtype=np.int64),
        "quantity": qty.astype(np.int32),
        "wholesale_cost": wholesale, "list_price": list_price,
        "sales_price": sales_price, "ext_discount_amt": ext_discount,
        "ext_sales_price": ext_sales, "ext_wholesale_cost": ext_wholesale,
        "ext_list_price": ext_list, "ext_tax": ext_tax, "coupon_amt": coupon,
        "net_paid": net_paid, "net_paid_inc_tax": net_paid_tax,
        "net_profit": profit,
    }
    if extra:
        base.update(extra(rng, n, sold_date))
    return base


def generate(sf_rows: int = 40_000, seed: int = 20260729,
             skew: "float | None" = None,
             measure_null_frac: float = 0.0) -> Dict[str, Table]:
    """All 24 tables; `sf_rows` sizes store_sales, other facts scale off it.

    ``skew`` switches the fact marginals from uniform to dsdgen-like
    (Zipf item/customer/store popularity, seasonal dates, category price
    levels — see SkewDists); ``measure_null_frac`` additionally NULLs a
    fraction of the price/quantity measures on the sales facts."""
    rng = np.random.default_rng(seed)
    n_items, n_cust, n_addr = 1000, 2000, 1000
    n_cdemo, n_hdemo, n_store, n_promo = 1920, 720, 12, 300
    n_wh, n_cc, n_web, n_wp, n_cp = 5, 6, 12, 60, 120

    out: Dict[str, Table] = {}
    out["date_dim"] = _date_dim()
    out["time_dim"] = _time_dim()
    out["item"] = _items(rng, n_items)
    out["customer"] = _customers(rng, n_cust, n_addr, n_cdemo, n_hdemo)
    out["customer_address"] = _addresses(rng, n_addr)
    out["customer_demographics"] = _cdemo(n_cdemo)
    out["household_demographics"] = _hdemo(n_hdemo)
    ib = np.arange(1, 21)
    out["income_band"] = _frame({
        "ib_income_band_sk": ib.astype(np.int64),
        "ib_lower_bound": ((ib - 1) * 10000).astype(np.int32),
        "ib_upper_bound": (ib * 10000).astype(np.int32)})
    out["store"] = _stores(
        rng, n_store, zips=out["customer_address"]["ca_zip"])
    out["promotion"] = _promotions(rng, n_promo, n_items)
    sm = np.arange(1, 21)
    out["ship_mode"] = _frame({
        "sm_ship_mode_sk": sm.astype(np.int64),
        "sm_ship_mode_id": [f"AAAAAAAA{x:08d}" for x in sm],
        "sm_type": np.array(SM_TYPES)[sm % 5],
        "sm_code": np.array(["AIR", "SURFACE", "SEA"])[sm % 3],
        "sm_carrier": np.array(SM_CARRIERS)[sm % 5],
        "sm_contract": [f"contract {x}" for x in sm]})
    rr = np.arange(1, 36)
    out["reason"] = _frame({
        "r_reason_sk": rr.astype(np.int64),
        "r_reason_id": [f"AAAAAAAA{x:08d}" for x in rr],
        "r_reason_desc": [f"reason {x}" for x in rr]})
    wh = np.arange(1, n_wh + 1)
    out["warehouse"] = _frame({
        "w_warehouse_sk": wh.astype(np.int64),
        "w_warehouse_id": [f"AAAAAAAA{x:08d}" for x in wh],
        "w_warehouse_name": [f"Warehouse number {x}" for x in wh],
        "w_warehouse_sq_ft": (wh * 100000).astype(np.int32),
        "w_street_number": "501", "w_street_name": "Main",
        "w_street_type": "St", "w_suite_number": "Suite 0",
        "w_city": "Fairview", "w_county": COUNTIES[0], "w_state": "TN",
        "w_zip": "35709", "w_country": "United States",
        "w_gmt_offset": -5.0})
    cc = np.arange(1, n_cc + 1)
    out["call_center"] = _frame({
        "cc_call_center_sk": cc.astype(np.int64),
        "cc_call_center_id": [f"AAAAAAAA{x:08d}" for x in cc],
        "cc_rec_start_date": "1998-01-01", "cc_rec_end_date": None,
        "cc_closed_date_sk": None, "cc_open_date_sk": DATE0_SK,
        "cc_name": [f"call center {x}" for x in cc],
        "cc_class": "medium", "cc_employees": (cc * 100).astype(np.int32),
        "cc_sq_ft": (cc * 1000).astype(np.int32), "cc_hours": "8AM-8AM",
        "cc_manager": [f"Manager {x}" for x in cc],
        "cc_mkt_id": (cc % 6 + 1).astype(np.int32), "cc_mkt_class": "Unknown",
        "cc_mkt_desc": "Unknown", "cc_market_manager": "Unknown",
        "cc_division": np.ones(n_cc, np.int32), "cc_division_name": "Unknown",
        "cc_company": np.ones(n_cc, np.int32), "cc_company_name": "Unknown",
        "cc_street_number": "501", "cc_street_name": "Main",
        "cc_street_type": "St", "cc_suite_number": "Suite 0",
        "cc_city": "Fairview", "cc_county": COUNTIES[0], "cc_state": "TN",
        "cc_zip": "35709", "cc_country": "United States",
        "cc_gmt_offset": -5.0, "cc_tax_percentage": 0.1})
    wsk = np.arange(1, n_web + 1)
    out["web_site"] = _frame({
        "web_site_sk": wsk.astype(np.int64),
        "web_site_id": [f"AAAAAAAA{x:08d}" for x in wsk],
        "web_rec_start_date": "1998-01-01", "web_rec_end_date": None,
        "web_name": [f"site_{x % 4}" for x in wsk],
        "web_open_date_sk": DATE0_SK, "web_close_date_sk": None,
        "web_class": "Unknown", "web_manager": [f"Manager {x}" for x in wsk],
        "web_mkt_id": (wsk % 6 + 1).astype(np.int32),
        "web_mkt_class": "Unknown", "web_mkt_desc": "Unknown",
        "web_market_manager": "Unknown",
        "web_company_id": (wsk % 6 + 1).astype(np.int32),
        "web_company_name": np.array(["pri", "able", "ought", "ese", "anti",
                                      "cally"])[wsk % 6],
        "web_street_number": "501", "web_street_name": "Main",
        "web_street_type": "St", "web_suite_number": "Suite 0",
        "web_city": "Fairview", "web_county": COUNTIES[0], "web_state": "TN",
        "web_zip": "35709", "web_country": "United States",
        "web_gmt_offset": -5.0, "web_tax_percentage": 0.02})
    wp = np.arange(1, n_wp + 1)
    out["web_page"] = _frame({
        "wp_web_page_sk": wp.astype(np.int64),
        "wp_web_page_id": [f"AAAAAAAA{x:08d}" for x in wp],
        "wp_rec_start_date": "1997-09-03", "wp_rec_end_date": None,
        "wp_creation_date_sk": DATE0_SK, "wp_access_date_sk": DATE0_SK,
        "wp_autogen_flag": np.array(["Y", "N"])[wp % 2],
        "wp_customer_sk": None,
        "wp_url": "http://www.foo.com", "wp_type": np.array(
            ["ad", "dynamic", "feedback", "general", "order",
             "protected", "welcome"])[wp % 7],
        "wp_char_count": (wp * 100).astype(np.int32),
        "wp_link_count": (wp % 25).astype(np.int32),
        "wp_image_count": (wp % 7).astype(np.int32),
        "wp_max_ad_count": (wp % 4).astype(np.int32)})
    cp = np.arange(1, n_cp + 1)
    out["catalog_page"] = _frame({
        "cp_catalog_page_sk": cp.astype(np.int64),
        "cp_catalog_page_id": [f"AAAAAAAA{x:08d}" for x in cp],
        "cp_start_date_sk": DATE0_SK, "cp_end_date_sk": DATE0_SK + 100,
        "cp_department": "DEPARTMENT",
        "cp_catalog_number": (cp % 20 + 1).astype(np.int32),
        "cp_catalog_page_number": cp.astype(np.int32),
        "cp_description": [f"catalog page {x}" for x in cp],
        "cp_type": np.array(["bi-annual", "quarterly", "monthly"])[cp % 3]})

    # skewed fact marginals share one distribution set so cross-channel
    # identities (hot items are hot EVERYWHERE) hold like dsdgen's
    dists = None
    if skew is not None:
        dd = out["date_dim"]
        dists = SkewDists(
            rng, float(skew), n_items, n_cust, n_store, N_DAYS,
            out["item"]["i_category_id"], dd["d_moy"], dd["d_dow"])

    # ---- store_sales + store_returns -----------------------------------
    n_ss = sf_rows
    ss = _sales(rng, n_ss, "ss", N_DAYS, n_items, n_cust, n_addr, n_cdemo,
                n_hdemo, n_store, n_promo, dists=dists)
    out["store_sales"] = _frame({
        "ss_sold_date_sk": ss["sold_date_sk"],
        "ss_sold_time_sk": ss["sold_time_sk"],
        "ss_item_sk": ss["item_sk"], "ss_customer_sk": ss["customer_sk"],
        "ss_cdemo_sk": ss["cdemo_sk"], "ss_hdemo_sk": ss["hdemo_sk"],
        "ss_addr_sk": ss["addr_sk"], "ss_store_sk": ss["store_sk"],
        "ss_promo_sk": ss["promo_sk"],
        "ss_ticket_number": ss["ticket_number"],
        "ss_quantity": ss["quantity"],
        "ss_wholesale_cost": ss["wholesale_cost"],
        "ss_list_price": ss["list_price"],
        "ss_sales_price": ss["sales_price"],
        "ss_ext_discount_amt": ss["ext_discount_amt"],
        "ss_ext_sales_price": ss["ext_sales_price"],
        "ss_ext_wholesale_cost": ss["ext_wholesale_cost"],
        "ss_ext_list_price": ss["ext_list_price"],
        "ss_ext_tax": ss["ext_tax"], "ss_coupon_amt": ss["coupon_amt"],
        "ss_net_paid": ss["net_paid"],
        "ss_net_paid_inc_tax": ss["net_paid_inc_tax"],
        "ss_net_profit": ss["net_profit"],
    })
    # returns reference ~25% of sales rows by (item, ticket, customer)
    # (raised from 10% so cross-channel return overlap — q83 — exists
    # at harness scale)
    ridx = rng.choice(n_ss, n_ss // 4, replace=False)
    ssr = _take(out["store_sales"], ridx)
    n_sr = len(ridx)
    ret_qty = np.minimum(rng.integers(1, 101, n_sr), ssr["ss_quantity"])
    ret_amt = np.round(ssr["ss_sales_price"] * ret_qty, 2)
    out["store_returns"] = _frame({
        "sr_returned_date_sk": (np.array(
            [DATE0_SK if v is None else int(v)
             for v in ssr["ss_sold_date_sk"]], np.int64)
            + rng.integers(1, 90, n_sr)),
        "sr_return_time_sk": rng.integers(0, 86400, n_sr).astype(np.int64),
        "sr_item_sk": ssr["ss_item_sk"],
        "sr_customer_sk": ssr["ss_customer_sk"],
        "sr_cdemo_sk": ssr["ss_cdemo_sk"],
        "sr_hdemo_sk": ssr["ss_hdemo_sk"],
        "sr_addr_sk": ssr["ss_addr_sk"],
        "sr_store_sk": ssr["ss_store_sk"],
        "sr_reason_sk": rng.integers(1, 36, n_sr).astype(np.int64),
        "sr_ticket_number": ssr["ss_ticket_number"],
        "sr_return_quantity": ret_qty.astype(np.int32),
        "sr_return_amt": ret_amt,
        "sr_return_tax": np.round(ret_amt * 0.08, 2),
        "sr_return_amt_inc_tax": np.round(ret_amt * 1.08, 2),
        "sr_fee": np.round(rng.uniform(0.5, 100.0, n_sr), 2),
        "sr_return_ship_cost": np.round(rng.uniform(0, 10, n_sr), 2),
        "sr_refunded_cash": np.round(ret_amt * 0.5, 2),
        "sr_reversed_charge": np.round(ret_amt * 0.3, 2),
        "sr_store_credit": np.round(ret_amt * 0.2, 2),
        "sr_net_loss": np.round(rng.uniform(0.5, 500.0, n_sr), 2),
    })

    # ---- catalog_sales + catalog_returns -------------------------------
    n_cs = sf_rows // 2
    cs = _sales(rng, n_cs, "cs", N_DAYS, n_items, n_cust, n_addr, n_cdemo,
                n_hdemo, n_store, n_promo, dists=dists)
    ship_cost = np.round(np.asarray(cs["ext_sales_price"]) * 0.05, 2)
    out["catalog_sales"] = _frame({
        "cs_sold_date_sk": cs["sold_date_sk"],
        "cs_sold_time_sk": cs["sold_time_sk"],
        "cs_ship_date_sk": (_filled(cs["sold_date_sk"], DATE0_SK)
                            + rng.integers(1, 120, n_cs)),
        "cs_bill_customer_sk": cs["customer_sk"],
        "cs_bill_cdemo_sk": cs["cdemo_sk"],
        "cs_bill_hdemo_sk": cs["hdemo_sk"],
        "cs_bill_addr_sk": cs["addr_sk"],
        "cs_ship_customer_sk": cs["customer_sk"],
        "cs_ship_cdemo_sk": cs["cdemo_sk"],
        "cs_ship_hdemo_sk": cs["hdemo_sk"],
        "cs_ship_addr_sk": cs["addr_sk"],
        "cs_call_center_sk": rng.integers(1, n_cc + 1, n_cs).astype(np.int64),
        "cs_catalog_page_sk": rng.integers(1, n_cp + 1,
                                           n_cs).astype(np.int64),
        "cs_ship_mode_sk": rng.integers(1, 21, n_cs).astype(np.int64),
        "cs_warehouse_sk": rng.integers(1, n_wh + 1, n_cs).astype(np.int64),
        "cs_item_sk": cs["item_sk"],
        "cs_promo_sk": cs["promo_sk"],
        "cs_order_number": np.arange(1, n_cs + 1, dtype=np.int64),
        "cs_quantity": cs["quantity"],
        "cs_wholesale_cost": cs["wholesale_cost"],
        "cs_list_price": cs["list_price"],
        "cs_sales_price": cs["sales_price"],
        "cs_ext_discount_amt": cs["ext_discount_amt"],
        "cs_ext_sales_price": cs["ext_sales_price"],
        "cs_ext_wholesale_cost": cs["ext_wholesale_cost"],
        "cs_ext_list_price": cs["ext_list_price"],
        "cs_ext_tax": cs["ext_tax"], "cs_coupon_amt": cs["coupon_amt"],
        "cs_ext_ship_cost": ship_cost,
        "cs_net_paid": cs["net_paid"],
        "cs_net_paid_inc_tax": cs["net_paid_inc_tax"],
        "cs_net_paid_inc_ship": np.round(
            np.asarray(cs["net_paid"]) + ship_cost, 2),
        "cs_net_paid_inc_ship_tax": np.round(
            np.asarray(cs["net_paid_inc_tax"]) + ship_cost, 2),
        "cs_net_profit": cs["net_profit"],
    })
    # link a third of catalog sales to store-return (customer, item) pairs —
    # the cross-channel join identity q17/q25/q29 aggregate over
    sr_t = out["store_returns"]
    n_sr_t = len(sr_t["sr_item_sk"])
    n_link = min(n_cs // 3, 10 * n_sr_t)
    pick = rng.integers(0, n_sr_t, n_link)
    cs_t = out["catalog_sales"]
    cs_t["cs_bill_customer_sk"][:n_link] = sr_t["sr_customer_sk"][pick]
    cs_t["cs_item_sk"][:n_link] = sr_t["sr_item_sk"][pick]
    cs_t["cs_sold_date_sk"][:n_link] = \
        sr_t["sr_returned_date_sk"][pick] + rng.integers(0, 60, n_link)

    cidx = rng.choice(n_cs, n_cs // 4, replace=False)
    csr = _take(out["catalog_sales"], cidx)
    n_cr = len(cidx)
    cret_qty = np.minimum(rng.integers(1, 101, n_cr),
                          csr["cs_quantity"])
    cret_amt = np.round(csr["cs_sales_price"] * cret_qty, 2)
    out["catalog_returns"] = _frame({
        "cr_returned_date_sk": (_filled(csr["cs_sold_date_sk"], DATE0_SK)
                                + rng.integers(1, 90, n_cr)),
        "cr_returned_time_sk": rng.integers(0, 86400, n_cr).astype(np.int64),
        "cr_item_sk": csr["cs_item_sk"],
        "cr_refunded_customer_sk": csr["cs_bill_customer_sk"],
        "cr_refunded_cdemo_sk": csr["cs_bill_cdemo_sk"],
        "cr_refunded_hdemo_sk": csr["cs_bill_hdemo_sk"],
        "cr_refunded_addr_sk": csr["cs_bill_addr_sk"],
        "cr_returning_customer_sk": csr["cs_bill_customer_sk"],
        "cr_returning_cdemo_sk": csr["cs_bill_cdemo_sk"],
        "cr_returning_hdemo_sk": csr["cs_bill_hdemo_sk"],
        "cr_returning_addr_sk": csr["cs_bill_addr_sk"],
        "cr_call_center_sk": csr["cs_call_center_sk"],
        "cr_catalog_page_sk": csr["cs_catalog_page_sk"],
        "cr_ship_mode_sk": csr["cs_ship_mode_sk"],
        "cr_warehouse_sk": csr["cs_warehouse_sk"],
        "cr_reason_sk": rng.integers(1, 36, n_cr).astype(np.int64),
        "cr_order_number": csr["cs_order_number"],
        "cr_return_quantity": cret_qty.astype(np.int32),
        "cr_return_amount": cret_amt,
        "cr_return_tax": np.round(cret_amt * 0.08, 2),
        "cr_return_amt_inc_tax": np.round(cret_amt * 1.08, 2),
        "cr_fee": np.round(rng.uniform(0.5, 100.0, n_cr), 2),
        "cr_return_ship_cost": np.round(rng.uniform(0, 10, n_cr), 2),
        "cr_refunded_cash": np.round(cret_amt * 0.5, 2),
        "cr_reversed_charge": np.round(cret_amt * 0.3, 2),
        "cr_store_credit": np.round(cret_amt * 0.2, 2),
        "cr_net_loss": np.round(rng.uniform(0.5, 500.0, n_cr), 2),
    })

    # ---- web_sales + web_returns ---------------------------------------
    n_ws = sf_rows // 4
    ws = _sales(rng, n_ws, "ws", N_DAYS, n_items, n_cust, n_addr, n_cdemo,
                n_hdemo, n_store, n_promo, dists=dists)
    wship_cost = np.round(np.asarray(ws["ext_sales_price"]) * 0.05, 2)
    out["web_sales"] = _frame({
        "ws_sold_date_sk": ws["sold_date_sk"],
        "ws_sold_time_sk": ws["sold_time_sk"],
        "ws_ship_date_sk": (_filled(ws["sold_date_sk"], DATE0_SK)
                            + rng.integers(1, 120, n_ws)),
        "ws_item_sk": ws["item_sk"],
        "ws_bill_customer_sk": ws["customer_sk"],
        "ws_bill_cdemo_sk": ws["cdemo_sk"],
        "ws_bill_hdemo_sk": ws["hdemo_sk"],
        "ws_bill_addr_sk": ws["addr_sk"],
        "ws_ship_customer_sk": ws["customer_sk"],
        "ws_ship_cdemo_sk": ws["cdemo_sk"],
        "ws_ship_hdemo_sk": ws["hdemo_sk"],
        "ws_ship_addr_sk": ws["addr_sk"],
        "ws_web_page_sk": rng.integers(1, n_wp + 1, n_ws).astype(np.int64),
        "ws_web_site_sk": rng.integers(1, n_web + 1, n_ws).astype(np.int64),
        "ws_ship_mode_sk": rng.integers(1, 21, n_ws).astype(np.int64),
        "ws_warehouse_sk": rng.integers(1, n_wh + 1, n_ws).astype(np.int64),
        "ws_promo_sk": ws["promo_sk"],
        "ws_order_number": np.arange(1, n_ws + 1, dtype=np.int64),
        "ws_quantity": ws["quantity"],
        "ws_wholesale_cost": ws["wholesale_cost"],
        "ws_list_price": ws["list_price"],
        "ws_sales_price": ws["sales_price"],
        "ws_ext_discount_amt": ws["ext_discount_amt"],
        "ws_ext_sales_price": ws["ext_sales_price"],
        "ws_ext_wholesale_cost": ws["ext_wholesale_cost"],
        "ws_ext_list_price": ws["ext_list_price"],
        "ws_ext_tax": ws["ext_tax"], "ws_coupon_amt": ws["coupon_amt"],
        "ws_ext_ship_cost": wship_cost,
        "ws_net_paid": ws["net_paid"],
        "ws_net_paid_inc_tax": ws["net_paid_inc_tax"],
        "ws_net_paid_inc_ship": np.round(
            np.asarray(ws["net_paid"]) + wship_cost, 2),
        "ws_net_paid_inc_ship_tax": np.round(
            np.asarray(ws["net_paid_inc_tax"]) + wship_cost, 2),
        "ws_net_profit": ws["net_profit"],
    })
    widx = rng.choice(n_ws, n_ws // 4, replace=False)
    wsr = _take(out["web_sales"], widx)
    n_wr = len(widx)
    wret_qty = np.minimum(rng.integers(1, 101, n_wr),
                          wsr["ws_quantity"])
    wret_amt = np.round(wsr["ws_sales_price"] * wret_qty, 2)
    out["web_returns"] = _frame({
        "wr_returned_date_sk": (_filled(wsr["ws_sold_date_sk"], DATE0_SK)
                                + rng.integers(1, 90, n_wr)),
        "wr_returned_time_sk": rng.integers(0, 86400, n_wr).astype(np.int64),
        "wr_item_sk": wsr["ws_item_sk"],
        "wr_refunded_customer_sk": wsr["ws_bill_customer_sk"],
        "wr_refunded_cdemo_sk": wsr["ws_bill_cdemo_sk"],
        "wr_refunded_hdemo_sk": wsr["ws_bill_hdemo_sk"],
        "wr_refunded_addr_sk": wsr["ws_bill_addr_sk"],
        "wr_returning_customer_sk": wsr["ws_bill_customer_sk"],
        "wr_returning_cdemo_sk": wsr["ws_bill_cdemo_sk"],
        "wr_returning_hdemo_sk": wsr["ws_bill_hdemo_sk"],
        "wr_returning_addr_sk": wsr["ws_bill_addr_sk"],
        "wr_web_page_sk": wsr["ws_web_page_sk"],
        "wr_reason_sk": rng.integers(1, 36, n_wr).astype(np.int64),
        "wr_order_number": wsr["ws_order_number"],
        "wr_return_quantity": wret_qty.astype(np.int32),
        "wr_return_amt": wret_amt,
        "wr_return_tax": np.round(wret_amt * 0.08, 2),
        "wr_return_amt_inc_tax": np.round(wret_amt * 1.08, 2),
        "wr_fee": np.round(rng.uniform(0.5, 100.0, n_wr), 2),
        "wr_return_ship_cost": np.round(rng.uniform(0, 10, n_wr), 2),
        "wr_refunded_cash": np.round(wret_amt * 0.5, 2),
        "wr_reversed_charge": np.round(wret_amt * 0.3, 2),
        "wr_account_credit": np.round(wret_amt * 0.2, 2),
        "wr_net_loss": np.round(rng.uniform(0.5, 500.0, n_wr), 2),
    })

    # ---- inventory ------------------------------------------------------
    inv_dates = DATE0_SK + np.arange(0, N_DAYS, 7)
    dsk, isk, wsk_ = np.meshgrid(inv_dates,
                                 np.arange(1, n_items + 1, 4),
                                 np.arange(1, n_wh + 1), indexing="ij")
    n_inv = dsk.size
    out["inventory"] = _frame({
        "inv_date_sk": dsk.ravel().astype(np.int64),
        "inv_item_sk": isk.ravel().astype(np.int64),
        "inv_warehouse_sk": wsk_.ravel().astype(np.int64),
        "inv_quantity_on_hand": rng.integers(0, 1000,
                                             n_inv).astype(np.int32),
    })

    if measure_null_frac > 0.0:
        # NULL densities on the price/quantity measures (dsdgen leaves
        # sparse measures; aggregates must honor NULL-skipping at scale)
        measures = {
            "store_sales": ["ss_sales_price", "ss_ext_sales_price",
                            "ss_quantity", "ss_net_profit"],
            "catalog_sales": ["cs_quantity", "cs_sales_price"],
            "web_sales": ["ws_sales_price", "ws_quantity"],
        }
        for tname, cols in measures.items():
            table = out[tname]
            n = len(table[cols[0]])
            for c in cols:
                mask = rng.random(n) < measure_null_frac
                col = table[c].astype(np.float64)
                col[mask] = np.nan
                table[c] = col

    # column order exactly per schema
    return {name: {c: table[c] for c, _t in TABLES[name]}
            for name, table in out.items()}
