"""TPC-DS texts on the mesh lane: twelve texts from their SQL through the
port's ``spark.sql`` at ``spark.tpu.mesh.shards`` 4 and 3 on the CPU, each
held against the sqlite oracle by the rule of ``tests/test_torch_tpcds.py``
(``ORACLE_OVERRIDES`` where sqlite needs another text), over the JAX
harness's own data (``generate(SF_ROWS)``).  Each text must take the mesh
lane: one ``DistributedExecution.execute`` per text.  The shards sit one
per LOGICAL card, as on a host of several cards (``mesh.visible_cards``
patched to that many ``cpu`` devices), so on the CPU the lane's exchanges
run ``all_to_all_cards``'s plain version in its cross-device form and its
balanced assignment ``lpt_assign_plain``.

The texts are those that took under 0.4 s each in a probe of all 99 at 4
shards; every one of them answers at 3 shards too."""

import pytest
import torch

from spark_tpu.tpcds import ORACLE_OVERRIDES, QUERIES, generate
from spark_tpu.tpcds.oracle import sqlite_text as _sqlite_text
from spark_tpu_torch import config as TC
from spark_tpu_torch import cuda_a2a
from spark_tpu_torch.parallel import executor as TX
from spark_tpu_torch.parallel import mesh as TM
from spark_tpu_torch.sql import logical as TL
from spark_tpu_torch.sql.dataframe import DataFrame as TDataFrame
from spark_tpu_torch.sql.session import SparkSession as TSession
from spark_tpu_torch.testing import batch_parts, from_parts

from test_torch_tpcds import SF_ROWS, _compare

MESH_TEXTS = ("q9", "q41", "q91", "q96", "q15", "q62", "q92", "q55", "q93",
              "q28", "q13", "q85")


@pytest.fixture(scope="module")
def tpcds(spark):
    """The port's views over the generated tables (batches carried over
    from the reference's, so dictionary codes match) and the sqlite
    oracle."""
    import sqlite3
    tables = generate(SF_ROWS)
    tspark = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    con = sqlite3.connect(":memory:")
    for name, pdf in tables.items():
        rdf = spark.createDataFrame(pdf)
        parts = batch_parts(rdf._plan.batch.to_host())
        TDataFrame(tspark, TL.LocalRelation(from_parts(parts))) \
            .createOrReplaceTempView(name)
        pdf.to_sql(name, con, index=False)
    yield tspark, con
    con.close()
    tspark.stop()


@pytest.mark.parametrize("shards", [4, 3])
@pytest.mark.parametrize("qname", MESH_TEXTS)
def test_text_on_the_mesh_lane(tpcds, qname, shards, monkeypatch):
    tspark, con = tpcds
    runs, exchanges = [], []
    execute = TX.DistributedExecution.execute
    cards = cuda_a2a.all_to_all_cards

    def counted(self, optimized):
        runs.append(self.n)
        return execute(self, optimized)

    def across(planes, card_of, *args, **kw):
        exchanges.append(max(card_of) + 1)
        return cards(planes, card_of, *args, **kw)

    monkeypatch.setattr(TX.DistributedExecution, "execute", counted)
    monkeypatch.setattr(cuda_a2a, "all_to_all_cards", across)
    monkeypatch.setattr(TM, "visible_cards",
                        lambda device: [torch.device("cpu")] * shards)
    tspark.conf.set("spark.tpu.mesh.shards", str(shards))
    try:
        sql = QUERIES[qname]
        got = [tuple(r) for r in tspark.sql(sql).collect()]
    finally:
        tspark.conf.set("spark.tpu.mesh.shards", "1")
        monkeypatch.undo()
        TM.set_mesh(None)
    assert runs == [shards], f"{qname}: mesh executions {runs}"
    assert exchanges and set(exchanges) == {shards}, \
        f"{qname}: exchanges across {sorted(set(exchanges))} cards"
    exp = con.execute(_sqlite_text(ORACLE_OVERRIDES.get(qname, sql))) \
        .fetchall()
    assert exp, f"{qname}: oracle returned no rows — weak test, fix params"
    _compare(got, exp, qname)
