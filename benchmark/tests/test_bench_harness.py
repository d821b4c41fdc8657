"""The harness: its last line, its refusals, discovery by name, and the
check that decides ``correct`` seeing the faults a cell can have.

The CPU path is ``run.main(argv, device="cpu", rows=...)``: the whole
run as the command runs it, at a tiny scale, with the port's plain
kernels.  Cells on their cards: ``python -m pytest benchmark/tests -m
card`` on the chip's machine.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import driver, spec

BENCH_DIR = spec.BENCH_DIR
CHECKOUT = spec.CHECKOUT
TINY = {"store_sales": 60_000, "date_dim": 73_049, "item": 3_000,
        "customer": 1_000, "customer_address": 500,
        "customer_demographics": 1_920_800, "household_demographics": 7_200,
        "store": 12, "promotion": 300}
SEED = 2 ** 33 + 7
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _cpu_run(cell, trace, seconds=2.0, checkout=CHECKOUT, rows=TINY):
    """The CPU path of one run in a subprocess: (returncode, last stdout
    line as JSON or None, stderr lines, top-level modules loaded)."""
    bench = os.path.join(checkout, "benchmark")
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{bench!r}, {checkout!r}]\n"
        "import run\n"
        f"rc = run.main(['--workload', {cell!r}, '--seed', '{SEED}', "
        f"'--seconds', '{seconds}', '--trace', '{trace}'], device='cpu', "
        f"rows={rows!r})\n"
        "mods = sorted({m.split('.')[0] for m in list(sys.modules)})\n"
        "print('MODULES ' + json.dumps(mods), file=sys.stderr)\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=checkout, env=env)
    lines = p.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    err = p.stderr.strip().splitlines()
    mods = next((json.loads(x[len("MODULES "):]) for x in err
                 if x.startswith("MODULES ")), [])
    return p.returncode, last, [x for x in err if not
                                x.startswith("MODULES ")], mods


@pytest.fixture(scope="module")
def star_runs():
    return {trace: _cpu_run("sf10-star", trace, seconds=3.0)
            for trace in (0, 1)}


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contract_keys(star_runs, trace):
    rc, last, err, _mods = star_runs[trace]
    assert rc == 0, err[-20:]
    keys = CONTRACT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(last) == keys
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    cell = spec.load_cell("sf10-star")
    wanted = cell.per_layer if trace else cell.end_to_end
    for name, m in last["metrics"].items():
        assert m["unit"] == next(x.unit for x in wanted if x.name == name)
    if trace:
        # the CPU has no device trace: only the host's and program's
        # readings are there
        assert {"http_overhead_ms", "statement_ms", "plan_cache_hit_pct",
                "stage_builds"} <= set(last["metrics"])
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(last["metrics"]) == {m.name for m in cell.end_to_end}
    # every number compared, beside its limit: in the line and as the
    # last lines of standard error
    checks = last["checks"]
    assert set(checks) == {"wrong_replies", "failed_requests",
                           "replies_at_least"}
    tail = [x for x in err if x.startswith("check ")]
    assert err[-len(checks):] == tail
    assert all("limit" in c and "value" in c for c in checks.values())


@pytest.mark.parametrize("trace", [0, 1])
def test_no_jax_module_is_loaded(star_runs, trace):
    _rc, _last, _err, mods = star_runs[trace]
    assert "spark_tpu_torch" in mods
    assert not set(mods) & set(driver.FORBIDDEN_MODULES), mods


def test_the_references_import_nothing_of_the_port():
    code = ("import sys\n"
            f"sys.path[:0] = [{BENCH_DIR!r}]\n"
            "import reference.q3, reference.q42, reference.q52, "
            "reference.q55, datagen.tpcds_store\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=BENCH_DIR)
    mods = set(eval(p.stdout))            # noqa: S307 — our own print
    assert not mods & {"spark_tpu_torch", "torch",
                       *driver.FORBIDDEN_MODULES}, mods


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sf10-star",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=CHECKOUT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert not p.stdout.strip()


def _copy_benchmark(dest, with_program=True):
    os.makedirs(dest)
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), dest)
    shutil.copytree(BENCH_DIR, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    if with_program:
        os.symlink(os.path.join(CHECKOUT, "spark_tpu_torch"),
                   os.path.join(dest, "spark_tpu_torch"))


def test_only_the_benchmark_files_no_result(tmp_path):
    dest = str(tmp_path / "bare")
    _copy_benchmark(dest, with_program=False)
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sf10-star",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=dest)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_files_added_are_found_by_name(tmp_path):
    """A configuration, a mix, a text with its reference and a per-layer
    metric, each a new file plus an entry in BENCHMARK.json: the new
    cell runs and reports the new metric with no other file edited."""
    dest = str(tmp_path / "checkout")
    _copy_benchmark(dest)
    b = os.path.join(dest, "benchmark")
    cfg = json.load(open(os.path.join(b, "configs",
                                      "tpcds-sf10-1card.json")))
    cfg["source"] = "TPC-DS, a second deployment"
    json.dump(cfg, open(os.path.join(b, "configs", "tiny-added.json"), "w"))
    json.dump({"texts": {"q55b": 1}, "clients": 2, "loop": "closed",
               "conf": {},
               "tables": {"store_sales": ["ss_sold_date_sk", "ss_item_sk",
                                          "ss_ext_sales_price"],
                          "date_dim": ["d_date_sk", "d_year", "d_moy"],
                          "item": ["i_item_sk", "i_brand_id", "i_brand",
                                   "i_manager_id"]}},
              open(os.path.join(b, "traffic", "q55b-2clients.json"), "w"))
    shutil.copy(os.path.join(b, "queries", "q55.sql"),
                os.path.join(b, "queries", "q55b.sql"))
    with open(os.path.join(b, "reference", "q55b.py"), "w") as f:
        f.write("from .q55 import PARAMS, answer  # noqa: F401\n")
    with open(os.path.join(b, "layers", "replies_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.replies))\n")
    spec_path = os.path.join(dest, "BENCHMARK.json")
    doc = json.load(open(spec_path))
    doc["configs"].append({"name": "tiny-added", "source": cfg["source"],
                           "file": "benchmark/configs/tiny-added.json",
                           "reduced": [],
                           "why": "a deployment added as a file"})
    doc["workloads"].append({"name": "added-q55b", "config": "tiny-added",
                             "traffic": "q55b-2clients", "chips": 1,
                             "why": "a cell added as files"})
    doc["per_layer"].append({"name": "replies_seen", "unit": "replies",
                             "better": "higher", "source": "host_clock",
                             "layer": "SQL server and admission",
                             "moves": "queries_per_s",
                             "workloads": ["added-q55b"]})
    json.dump(doc, open(spec_path, "w"))
    rc, last, err, _mods = _cpu_run("added-q55b", 1, seconds=3.0,
                                    checkout=dest)
    assert rc == 0, err[-20:]
    assert last["correct"] is True
    assert last["metrics"]["replies_seen"]["value"] > 0


def test_text_order_sends_the_same_mix_every_seed():
    texts = {"q3": 1, "q42": 1, "q52": 2}
    for seed in (1, 2 ** 33 + 5):
        order = driver.text_order(texts, seed, 0)
        first = [next(order) for _ in range(40)]
        assert sorted(first) == sorted(["q3"] * 10 + ["q42"] * 10
                                       + ["q52"] * 20)
    a = driver.text_order(texts, 1, 0)
    b = driver.text_order(texts, 2, 0)
    assert [next(a) for _ in range(40)] != [next(b) for _ in range(40)]


# -- the check sees the faults a cell can have ----------------------------

def _fault_run(monkeypatch, cell, patch):
    patch(monkeypatch)
    return driver.run(cell, SEED, 2.0, False, device="cpu", rows=TINY)


def _answer_altered(monkeypatch):
    from spark_tpu_torch import server
    real = server._json_rows

    def altered(batch, spec_=None):
        rows = real(batch, spec_)
        if rows and isinstance(rows[0][-1], float):
            rows[0][-1] += 0.01
        return rows
    monkeypatch.setattr(server, "_json_rows", altered)


def _half_the_rows(monkeypatch):
    from spark_tpu_torch.columnar import PrebuiltColumn
    from spark_tpu_torch.sql.session import SparkSession
    real = SparkSession.createDataFrame

    def half(v):
        if isinstance(v, PrebuiltColumn):
            return PrebuiltColumn(v.data[: len(v) // 2], v.dtype, None,
                                  v.dictionary)
        return v[: len(v) // 2]

    def halved(self, data, schema=None):
        if isinstance(data, dict) and len(next(iter(data.values()))) > 50_000:
            data = {k: half(v) for k, v in data.items()}
        return real(self, data, schema)
    monkeypatch.setattr(SparkSession, "createDataFrame", halved)


def _exchange_left_out(monkeypatch):
    from spark_tpu_torch import cuda_a2a
    real = cuda_a2a.all_to_all

    def own_rows_only(planes, gather=False):
        outs = real(planes, gather=gather)
        if not gather:
            n = len(planes[0])
            for o in outs:
                for d in range(n):
                    for s in range(n):
                        if s != d:
                            o[d, s].zero_()
        return outs
    monkeypatch.setattr(cuda_a2a, "all_to_all", own_rows_only)


@pytest.mark.parametrize("cell,fault", [
    ("sf10-star", _answer_altered),
    ("sf10-star", _half_the_rows),
    ("mesh4-q3-shuffled", _answer_altered),
    ("mesh4-q3-shuffled", _exchange_left_out),
], ids=["star-answer", "star-half-rows", "mesh-answer", "mesh-exchange"])
def test_a_fault_is_not_correct(monkeypatch, cell, fault):
    out = _fault_run(monkeypatch, cell, fault)
    assert out.result["correct"] is False
    assert out.checks["wrong_replies"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", ["sf10-star", "mesh4-q3-shuffled"])
def test_cell_on_its_cards(cards, cell):
    need = spec.load_cell(cell).chips
    if cards < need:
        pytest.skip(f"{cell} needs {need} cards, {cards} visible")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=CHECKOUT)
    assert p.returncode == 0, p.stderr[-3000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, last
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["count"] == need
