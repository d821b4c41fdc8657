"""The port's TPC-DS sweep, second half: the 33 TPC-DS texts that need
expression and aggregate breadth, grouping sets or window functions, run
from their SQL text through ``spark_tpu_torch``'s ``spark.sql`` on the
CPU and held against the sqlite oracle by the rule of
``tests/test_tpcds.py`` (``ORACLE_OVERRIDES`` for the texts sqlite cannot
run as written; floats ``rel_tol = abs_tol = 1e-6``), over the JAX
harness's own data (``generate(SF_ROWS)``).  A file of its own, so that
``--dist loadfile`` gives these texts another worker than
``tests/test_torch_tpcds.py``'s.
"""

import sqlite3

import pytest

from spark_tpu.tpcds import ORACLE_OVERRIDES, QUERIES, generate
from spark_tpu.tpcds.oracle import sqlite_text as _sqlite_text
from spark_tpu_torch import config as TC
from spark_tpu_torch.sql import logical as TL
from spark_tpu_torch.sql.dataframe import DataFrame as TDataFrame
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import batch_parts, from_parts

from test_torch_parser import BREADTH_QUERIES
from test_torch_tpcds import SF_ROWS, _compare


@pytest.fixture(scope="module")
def tpcds(spark):
    """The port's views over the JAX harness's generated tables (carried
    over from the reference's batches, so dictionary codes match), and the
    sqlite oracle."""
    tables = generate(SF_ROWS)
    tspark = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    con = sqlite3.connect(":memory:")
    for name, pdf in tables.items():
        parts = batch_parts(spark.createDataFrame(pdf)._plan.batch.to_host())
        TDataFrame(tspark, TL.LocalRelation(from_parts(parts))) \
            .createOrReplaceTempView(name)
        pdf.to_sql(name, con, index=False)
    yield tspark, con
    con.close()
    tspark.stop()


@pytest.mark.parametrize("qname", sorted(BREADTH_QUERIES,
                                         key=lambda q: int(q[1:])))
def test_query(tpcds, qname):
    tspark, con = tpcds
    sql = QUERIES[qname]
    got = [tuple(r) for r in tspark.sql(sql).collect()]
    exp = con.execute(_sqlite_text(ORACLE_OVERRIDES.get(qname, sql))) \
        .fetchall()
    assert exp, f"{qname}: oracle returned no rows — weak test, fix params"
    _compare(got, exp, qname)
