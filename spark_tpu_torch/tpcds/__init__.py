"""TPC-DS harness of the port: schema, scaled-down data generator, query
set and the sqlite oracle's helpers — the port's own copy of
``spark_tpu/tpcds/`` (numpy and the standard library only, no pandas),
so the port can run TPC-DS without importing the JAX package.

Queries are re-derived from the public TPC-DS specification, adapted to
this engine's SQL dialect (parameters fixed, multi-instance dimension
tables expressed as renamed FROM-subqueries, fully-determining ORDER BYs
so oracle comparison is exact).
"""

from .schema import TABLES                        # noqa: F401
from .datagen import generate                     # noqa: F401
from .queries import (QUERIES, ORACLE_OVERRIDES, RUNNABLE,  # noqa: F401
                      PENDING)
