"""The port's own TPC-DS package (``spark_tpu_torch/tpcds/``, no pandas)
against ``spark_tpu/tpcds/``: ``generate(20_000)`` gives the same
tables column by column from the same seed — uniform, under ``skew``
and under ``measure_null_frac`` — with NULLs where the reference's
pandas frames hold them; ``createDataFrame`` of the port's dicts holds
the same bits as the reference's ``createDataFrame`` of its frames;
``load_sqlite`` loads the same rows with the same declared column types
as pandas' ``to_sql``; and the copied schema, query texts and oracle
helpers are the reference's.
"""

import re
import sqlite3

import numpy as np
import pandas as pd
import pytest

from spark_tpu import tpcds as R
from spark_tpu.tpcds import oracle as RO
from spark_tpu_torch import config as TC
from spark_tpu_torch import tpcds as P
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import assert_parts_equal, batch_parts
from spark_tpu_torch.tpcds import oracle as PO

SF_ROWS = 20_000


def _same_column(ref: np.ndarray, got: np.ndarray) -> bool:
    if got.dtype == object or ref.dtype == object:
        if got.dtype != object:
            return False
        na_r, na_g = pd.isna(ref), pd.isna(got)
        return np.array_equal(na_r, na_g) and all(
            a == b for a, b in zip(ref[~na_r], got[~na_g]))
    return ref.dtype == got.dtype and np.array_equal(
        ref, got, equal_nan=ref.dtype.kind == "f")


@pytest.mark.parametrize("kwargs", [{}, {"skew": 1.1},
                                    {"measure_null_frac": 0.05}],
                         ids=["uniform", "skew", "measure_nulls"])
def test_generate_equals_reference(kwargs):
    ref = R.generate(SF_ROWS, **kwargs)
    got = P.generate(SF_ROWS, **kwargs)
    assert list(got) == list(ref)
    for name, frame in ref.items():
        assert list(got[name]) == list(frame.columns), name
        for col in frame.columns:
            assert _same_column(frame[col].to_numpy(), got[name][col]), \
                (name, col)
    # the measures' NULLs are NaN in float columns, the keys' None
    if kwargs.get("measure_null_frac"):
        q = got["store_sales"]["ss_quantity"]
        assert q.dtype == np.float64 and np.isnan(q).any()
    assert any(v is None for v in got["store_sales"]["ss_customer_sk"])


def test_create_dataframe_holds_the_reference_bits(spark):
    """The port's ``createDataFrame`` of each table dict holds the bits
    the reference's ``createDataFrame`` of its pandas frame holds."""
    ref = R.generate(SF_ROWS)
    got = P.generate(SF_ROWS)
    tspark = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    try:
        for name, frame in ref.items():
            rb = spark.createDataFrame(frame)._plan.batch.to_host()
            tb = tspark.createDataFrame(got[name])._plan.batch
            assert_parts_equal(batch_parts(rb), batch_parts(tb),
                               live_only=False)
    finally:
        tspark.stop()


def _declared(con, name):
    sql = con.execute("SELECT sql FROM sqlite_master WHERE name = ?",
                      (name,)).fetchone()[0]
    return re.findall(r'"(\w+)" (\w+)', sql)


def test_load_sqlite_equals_to_sql():
    ref = R.generate(SF_ROWS)
    got = P.generate(SF_ROWS)
    mine, theirs = sqlite3.connect(":memory:"), sqlite3.connect(":memory:")
    try:
        PO.load_sqlite(mine, got)
        for name, frame in ref.items():
            frame.to_sql(name, theirs, index=False)
        for name in ref:
            assert _declared(mine, name) == _declared(theirs, name), name
            q = f'SELECT * FROM "{name}"'
            assert mine.execute(q).fetchall() == \
                theirs.execute(q).fetchall(), name
    finally:
        mine.close()
        theirs.close()


def test_copied_texts_and_helpers_equal_the_reference():
    assert P.TABLES == R.TABLES
    assert P.QUERIES == R.QUERIES
    assert P.ORACLE_OVERRIDES == R.ORACLE_OVERRIDES
    assert P.RUNNABLE == R.RUNNABLE and P.PENDING == R.PENDING
    text = R.QUERIES["q17"]
    assert PO.sqlite_text(text) == RO.sqlite_text(text)
    for v in (None, True, 3, np.int32(4), 2.5, float("nan"), "x"):
        assert PO.norm_value(v) == RO.norm_value(v) or \
            (v != v and PO.norm_value(v) is None)
    assert PO.row_key((None, 1, "a")) == RO.row_key((None, 1, "a"))
