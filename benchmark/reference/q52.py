"""TPC-DS q52 (``queries/q52.sql``): manager 1's brands in November
2000."""

from .star import report

#: the star join's filters and grouping keys (``layers/`` reads them too)
PARAMS = dict(date_filter={"d_moy": 11, "d_year": 2000},
              item_filter={"i_manager_id": 1}, date_keys=["d_year"],
              item_keys=["i_brand_id", "i_brand"])


def answer(tables, precision: str = "exact"):
    # ORDER BY d_year, ext_price DESC, i_brand_id, i_brand
    return report(tables, **PARAMS, precision=precision,
                  order=lambda r: (r[0], -r[3], r[1], r[2]))
