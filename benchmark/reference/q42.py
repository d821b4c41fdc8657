"""TPC-DS q42 (``queries/q42.sql``): manager 1's categories in November
2000."""

from .star import report

#: the star join's filters and grouping keys (``layers/`` reads them too)
PARAMS = dict(date_filter={"d_moy": 11, "d_year": 2000},
              item_filter={"i_manager_id": 1}, date_keys=["d_year"],
              item_keys=["i_category_id", "i_category"])


def answer(tables, precision: str = "exact"):
    # ORDER BY total DESC, d_year, i_category_id, i_category
    return report(tables, **PARAMS, precision=precision,
                  order=lambda r: (-r[3], r[0], r[1], r[2]))
