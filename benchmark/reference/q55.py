"""TPC-DS q55 (``queries/q55.sql``): manager 28's brands in November
1999."""

from .star import report

#: the star join's filters and grouping keys (``layers/`` reads them too)
PARAMS = dict(date_filter={"d_moy": 11, "d_year": 1999},
              item_filter={"i_manager_id": 28}, date_keys=[],
              item_keys=["i_brand_id", "i_brand"])


def answer(tables, precision: str = "exact"):
    # ORDER BY ext_price DESC, i_brand_id, i_brand
    return report(tables, **PARAMS, precision=precision,
                  order=lambda r: (-r[2], r[0], r[1]))
