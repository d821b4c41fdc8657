"""TPC-DS q3 (``queries/q3.sql``): brands of manufacturer 28 in
November, by year."""

from .star import report

#: the star join's filters and grouping keys (``layers/`` reads them too)
PARAMS = dict(date_filter={"d_moy": 11}, item_filter={"i_manufact_id": 28},
              date_keys=["d_year"], item_keys=["i_brand_id", "i_brand"])


def answer(tables, precision: str = "exact"):
    # ORDER BY d_year, sum_agg DESC, i_brand_id, i_brand
    return report(tables, **PARAMS, precision=precision,
                  order=lambda r: (r[0], -r[3], r[1], r[2]))
