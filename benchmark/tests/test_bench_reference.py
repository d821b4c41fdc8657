"""The plain references, the generator and the correctness control.

Each reference (``reference/<text>.py``) must give the port's own CPU
answer on the same generated tables; the generator must repeat by seed;
and the control, the reference summed in float64 in place of exact
cents, must read as not correct.  ``test_control_at_cell_size`` reads the
control at the cells' own sizes on three seeds, on the chip's machine
(``-m card``; it reads the host's memory, not the card).
"""

import numpy as np
import pytest

from harness import driver, spec

#: a size at which every text's filters keep rows on the CPU
TINY = {"store_sales": 200_000, "date_dim": 73_049, "item": 5_000,
        "customer": 1_000, "customer_address": 500,
        "customer_demographics": 1_920_800, "household_demographics": 7_200,
        "store": 12, "promotion": 300}
TEXTS = ("q3", "q42", "q52", "q55")
SEEDS = (2 ** 33 + 11, 7, 2 ** 31 + 3)


def _tables(seed, rows=TINY, cell="sf10-star"):
    c = spec.load_cell(cell)
    return spec.generator(c).generate(rows, seed, c.mix["tables"])


def test_generator_repeats_by_seed():
    a, b = _tables(SEEDS[0]), _tables(SEEDS[0])
    other = _tables(SEEDS[0] + 1)
    for table, cols in a.items():
        for col, v in cols.items():
            assert np.array_equal(v, b[table][col]), (table, col)
    assert not np.array_equal(a["store_sales"]["ss_ext_sales_price"],
                              other["store_sales"]["ss_ext_sales_price"])
    assert not np.array_equal(a["item"]["i_manager_id"],
                              other["item"]["i_manager_id"])


def test_generator_columns_do_not_move_each_other():
    """A column added for a later mix leaves the others as they were."""
    gen = spec.generator(spec.load_cell("sf10-star"))
    few = gen.generate(TINY, 5, {"store_sales": ["ss_ext_sales_price"],
                                 "item": ["i_brand"]})
    many = gen.generate(TINY, 5, {table: list(cols)
                                  for table, cols in gen.SCHEMA.items()})
    assert np.array_equal(few["store_sales"]["ss_ext_sales_price"],
                          many["store_sales"]["ss_ext_sales_price"])
    assert np.array_equal(few["item"]["i_brand"], many["item"]["i_brand"])
    ss = many["store_sales"]
    assert ss["ss_quantity"].min() >= 1 and ss["ss_quantity"].max() <= 100
    assert np.array_equal(ss["ss_ext_sales_price"],
                          ss["ss_quantity"] * ss["ss_sales_price"])
    assert many["item"]["i_manager_id"].max() <= 100


#: the columns of each table in TPC-DS's specification
SPEC_WIDTHS = {"store_sales": 23, "date_dim": 28, "item": 22}


@pytest.mark.parametrize("cell", ["sf10-star", "mesh4-q3-shuffled"])
def test_every_column_is_held(cell):
    """The deployment holds each of its tables at full width, whatever
    its mix reads; the mix's columns are among them."""
    c = spec.load_cell(cell)
    gen = spec.generator(c)
    held = driver.held_columns(c, gen)
    assert {t: len(cols) for t, cols in held.items()} == SPEC_WIDTHS
    tables = gen.generate(TINY, SEEDS[1], held)
    for t, cols in tables.items():
        assert list(cols) == list(gen.SCHEMA[t])
        assert all(len(v) == TINY[t] for v in cols.values()), t
    for t, cols in c.mix["tables"].items():
        assert set(cols) <= set(held[t])


def test_pricing_identities():
    gen = spec.generator(spec.load_cell("sf10-star"))
    ss = gen.generate(TINY, SEEDS[2], {"store_sales": list(
        gen.SCHEMA["store_sales"])})["store_sales"]
    q = ss["ss_quantity"].astype(np.int64)
    assert np.array_equal(ss["ss_ext_list_price"], q * ss["ss_list_price"])
    assert np.array_equal(ss["ss_ext_wholesale_cost"],
                          q * ss["ss_wholesale_cost"])
    assert np.array_equal(ss["ss_ext_discount_amt"],
                          ss["ss_ext_list_price"] - ss["ss_ext_sales_price"])
    assert np.array_equal(ss["ss_net_paid"],
                          ss["ss_ext_sales_price"] - ss["ss_coupon_amt"])
    assert np.array_equal(ss["ss_net_paid_inc_tax"],
                          ss["ss_net_paid"] + ss["ss_ext_tax"])
    assert np.array_equal(ss["ss_net_profit"], ss["ss_net_paid"]
                          - ss["ss_ext_wholesale_cost"])
    assert (ss["ss_list_price"] >= ss["ss_sales_price"]).all()
    for c in gen.CENTS & set(ss):
        assert np.abs(ss[c]).max() <= 9_999_999, c     # decimal(7,2)


def test_engine_tables_ingest_as_the_port_would():
    """The prebuilt columns the harness hands the engine (cents as
    integers, strings as sorted-dictionary codes) are the batch the
    port's own ingest makes of the plain arrays (dollars as floats,
    strings and dates as they are)."""
    import torch

    from spark_tpu_torch import types as T
    from spark_tpu_torch.columnar import ColumnBatch
    gen = spec.generator(spec.load_cell("sf10-star"))
    rows = dict(TINY, store_sales=5_000, item=2_000)
    tables = gen.generate(rows, SEEDS[0], {t: list(cols) for t, cols
                                           in gen.SCHEMA.items()})
    for name, (arrays, schema) in driver._engine_tables(gen,
                                                        tables).items():
        ours = ColumnBatch.from_arrays(arrays, schema=schema)
        plain = ColumnBatch.from_arrays(
            {c: (v / 100.0 if c in gen.CENTS else v)
             for c, v in tables[name].items()}, schema=T.StructType(
                [T.StructField(c, T.type_for_name(gen.SCHEMA[name][c]))
                 for c in tables[name]]))
        assert ours.names == plain.names
        for c, a, b in zip(ours.names, ours.vectors, plain.vectors):
            assert a.dtype == b.dtype, (name, c)
            assert a.dictionary == b.dictionary, (name, c)
            assert (a.valid is None) == (b.valid is None), (name, c)
            assert torch.equal(a.data, b.data), (name, c)


@pytest.fixture(scope="module")
def port_answers():
    """Each text's answer from the port on the CPU, over TINY's tables."""
    import tempfile

    from spark_tpu_torch import config as C
    from spark_tpu_torch.sql.session import SparkSession
    cell = spec.load_cell("sf10-star")
    gen = spec.generator(cell)
    tables = _tables(SEEDS[0])
    with tempfile.TemporaryDirectory() as d:
        session = SparkSession(C.Conf({"spark.torch.device": "cpu",
                                       "spark.sql.warehouse.dir": d}))
        for name, (arrays, schema) in driver._engine_tables(
                gen, tables).items():
            session.createDataFrame(arrays, schema=schema) \
                .createOrReplaceTempView(name)
        got = {t: [list(r) for r in session.sql(cell.texts[t]).collect()]
               for t in TEXTS}
        session.stop()
    return tables, got


@pytest.mark.parametrize("text", TEXTS)
def test_reference_equals_the_port_on_the_cpu(port_answers, text):
    tables, got = port_answers
    want = spec.reference(text)(tables)
    assert want, f"{text}: the tiny tables leave no rows"
    assert got[text] == want


def control_readings(cell_name, seeds, rows=None, precision="float64"):
    """Per seed: (texts whose answer in ``precision`` differs from the
    exact one, rows that differ) -- the control put in the program's
    place."""
    cell = spec.load_cell(cell_name)
    gen = spec.generator(cell)
    out = []
    for seed in seeds:
        tables = gen.generate(rows or cell.config["rows"], seed,
                              cell.mix["tables"])
        texts, rows_wrong = 0, 0
        for text in cell.texts:
            ref = spec.reference(text)
            exact, low = ref(tables), ref(tables, precision=precision)
            rows_wrong += sum(a != b for a, b in zip(exact, low)) + \
                abs(len(exact) - len(low))
            texts += exact != low
        out.append((texts, rows_wrong))
    return out


#: sizes a test holds at which q3's groups sum several rows each (its
#: manufacturer keeps 1 item in 1,000)
CONTROL_ROWS = {"sf10-star": TINY,
                "mesh4-q3-shuffled": dict(TINY, store_sales=600_000,
                                          item=1_000)}


@pytest.mark.parametrize("cell", ["sf10-star", "mesh4-q3-shuffled"])
def test_control_is_not_correct(cell):
    """Every seed's float64 answers differ from the exact ones in some
    text, so every reply of that text would count as wrong."""
    readings = control_readings(cell, SEEDS, rows=CONTROL_ROWS[cell])
    assert all(texts >= 1 for texts, _rows in readings), readings


@pytest.mark.card
@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("cell", ["sf10-star", "mesh4-q3-shuffled"])
def test_control_at_cell_size(cards, cell, precision):
    readings = control_readings(cell, (2 ** 33 + 101, 2 ** 33 + 202,
                                       2 ** 33 + 303), precision=precision)
    print(f"control {cell} {precision}: (texts differing, rows differing) "
          f"per seed {readings}")
    assert all(texts >= 1 for texts, _rows in readings), readings
