"""The port's TPC-DS sweep, first half: 66 TPC-DS queries (those without
windows, grouping sets or the expression and aggregate breadth) run from
their SQL text through ``spark_tpu_torch``'s ``spark.sql`` on the CPU,
each held against the sqlite oracle by the rule of ``tests/test_tpcds.py``
(floats ``rel_tol = abs_tol = 1e-6``), over the JAX harness's own data
(``generate(SF_ROWS)``).  q3 is also held exactly against ``spark_tpu``'s
``spark.sql``.  The other 33 run in ``tests/test_torch_tpcds_breadth.py``.
"""

import math
import sqlite3

import pytest

from spark_tpu.tpcds import QUERIES, generate
from spark_tpu.tpcds.oracle import norm_value as _norm, row_key as _key, \
    sqlite_text as _sqlite_text
from spark_tpu_torch import config as TC
from spark_tpu_torch.sql import logical as TL
from spark_tpu_torch.sql.dataframe import DataFrame as TDataFrame
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import (Q3_SQL, assert_rows_equal, batch_parts,
                                     from_parts)

from test_torch_parser import BASE_QUERIES

SF_ROWS = 20_000


@pytest.fixture(scope="module")
def tpcds(spark):
    """Both packages' views over the same generated tables (the port's
    batches carried over from the reference's, so dictionary codes
    match), and the sqlite oracle."""
    tables = generate(SF_ROWS)
    tspark = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    con = sqlite3.connect(":memory:")
    for name, pdf in tables.items():
        rdf = spark.createDataFrame(pdf)
        rdf.createOrReplaceTempView(name)
        parts = batch_parts(rdf._plan.batch.to_host())
        TDataFrame(tspark, TL.LocalRelation(from_parts(parts))) \
            .createOrReplaceTempView(name)
        pdf.to_sql(name, con, index=False)
    yield spark, tspark, con
    con.close()
    tspark.stop()
    for name in tables:
        spark.catalog.dropTempView(name)


def _compare(got, exp, qname):
    got = sorted((tuple(_norm(v) for v in r) for r in got), key=_key)
    exp = sorted((tuple(_norm(v) for v in r) for r in exp), key=_key)
    assert len(got) == len(exp), \
        f"{qname}: {len(got)} rows != oracle {len(exp)}"
    for i, (g, e) in enumerate(zip(got, exp)):
        assert len(g) == len(e), f"{qname} row {i}: arity {len(g)}!={len(e)}"
        for j, (a, b) in enumerate(zip(g, e)):
            if isinstance(a, float) and isinstance(b, float):
                assert math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-6), \
                    f"{qname} row {i} col {j}: {a} != {b}"
            else:
                assert a == b, f"{qname} row {i} col {j}: {a!r} != {b!r}"


@pytest.mark.parametrize("qname", sorted(BASE_QUERIES,
                                         key=lambda q: int(q[1:])))
def test_query(tpcds, qname):
    _spark, tspark, con = tpcds
    sql = QUERIES[qname]
    got = [tuple(r) for r in tspark.sql(sql).collect()]
    exp = con.execute(_sqlite_text(sql)).fetchall()
    assert exp, f"{qname}: oracle returned no rows — weak test, fix params"
    _compare(got, exp, qname)


def test_q3_equals_reference_exactly(tpcds):
    spark, tspark, _con = tpcds
    assert Q3_SQL == QUERIES["q3"]
    ref = spark.sql(Q3_SQL).collect()
    got = tspark.sql(Q3_SQL).collect()
    assert len(got) > 0
    assert_rows_equal(ref, got)
