"""The port's RDD layer against the JAX package's (``tests/test_rdd.py``,
case by case): each case runs the same program on a ``SparkContext`` of
each package and the results must be equal, exactly (the RDD layer is host
Python in both; ``sample`` draws from the same ``random.Random``).  The
bridges to the DataFrame path (``toDF``, ``DataFrame.rdd``) run on a CPU
session of the port."""

import os
import random
import re
from collections import Counter

import pytest

from spark_tpu.rdd import HashPartitioner as RHashPartitioner
from spark_tpu.rdd import SparkContext as RSparkContext
from spark_tpu_torch import config as TC
from spark_tpu_torch.rdd import HashPartitioner as THashPartitioner
from spark_tpu_torch.rdd import SparkContext as TSparkContext
from spark_tpu_torch.sql.session import SparkSession as TSession


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


@pytest.fixture(scope="module")
def scs(tspark):
    ref = RSparkContext.getOrCreate(master="local[4]", appName="rdd-tests")
    port = TSparkContext(master="local[4]", appName="rdd-tests",
                         session=tspark)
    return ref, port


def both(scs, fn):
    """``fn(sc)`` on each package's context; the two results, equal."""
    ref, port = (fn(sc) for sc in scs)
    assert port == ref
    return port


def test_parallelize_partitions(scs):
    def case(sc):
        r = sc.parallelize(range(10), 3)
        return (r.getNumPartitions(), r.collect(),
                [len(p) for p in r.glom().collect()])
    assert both(scs, case) == (3, list(range(10)), [3, 3, 4])


def test_map_filter_flatmap(scs):
    def case(sc):
        r = sc.parallelize(range(8), 2)
        return (r.map(lambda x: x * 2).collect(),
                r.filter(lambda x: x % 2 == 0).collect(),
                r.flatMap(lambda x: [x, x]).count())
    assert both(scs, case)[2] == 16


def test_reduce_fold_aggregate(scs):
    def case(sc):
        r = sc.parallelize(range(1, 101), 7)
        return (r.reduce(lambda a, b: a + b), r.fold(0, lambda a, b: a + b),
                r.aggregate((0, 0), lambda acc, v: (acc[0] + v, acc[1] + 1),
                            lambda a, b: (a[0] + b[0], a[1] + b[1])))
    assert both(scs, case) == (5050, 5050, (5050, 100))


def test_tree_aggregate(scs):
    assert both(scs, lambda sc: sc.parallelize(range(1000), 16)
                .treeAggregate(0, lambda a, v: a + v, lambda a, b: a + b,
                               depth=3)) == 499500


def test_reduce_by_key(scs):
    def case(sc):
        r = sc.parallelize([("a", 1), ("b", 2), ("a", 3), ("c", 4),
                            ("b", 5)], 3)
        return r.reduceByKey(lambda a, b: a + b).collect()
    assert sorted(both(scs, case)) == [("a", 4), ("b", 7), ("c", 4)]


def test_group_by_key_and_combine(scs):
    def case(sc):
        r = sc.parallelize([(1, "x"), (2, "y"), (1, "z")], 2)
        c = r.combineByKey(lambda v: [v], lambda acc, v: acc + [v],
                           lambda a, b: a + b)
        return r.groupByKey().collect(), c.collect()
    grouped, combined = both(scs, case)
    assert {k: sorted(v) for k, v in grouped} == {1: ["x", "z"], 2: ["y"]}
    assert {k: sorted(v) for k, v in combined} == {1: ["x", "z"], 2: ["y"]}


def test_joins(scs):
    def case(sc):
        a = sc.parallelize([("k1", 1), ("k2", 2)], 2)
        b = sc.parallelize([("k1", "x"), ("k3", "y")], 2)
        return (a.join(b).collect(), a.leftOuterJoin(b).collect(),
                b.rightOuterJoin(a).collect(), a.fullOuterJoin(b).collect())
    inner, left, _right, full = both(scs, case)
    assert inner == [("k1", (1, "x"))] and len(full) == 3
    assert sorted(left) == [("k1", (1, "x")), ("k2", (2, None))]


def test_cogroup(scs):
    def case(sc):
        a = sc.parallelize([("k", 1), ("k", 2)], 2)
        b = sc.parallelize([("k", "x")], 1)
        return [(k, (sorted(left), list(right)))
                for k, (left, right) in a.cogroup(b).collect()]
    assert both(scs, case) == [("k", ([1, 2], ["x"]))]


def test_sort_by_key_global_order(scs):
    rng = random.Random(3)
    data = [(rng.randrange(1000), i) for i in range(500)]

    def case(sc):
        return (sc.parallelize(data, 8).sortByKey().collect(),
                sc.parallelize(data, 8).sortByKey(ascending=False).collect())
    asc, desc = both(scs, case)
    assert [k for k, _ in asc] == sorted(k for k, _ in data)
    assert [k for k, _ in desc] == sorted((k for k, _ in data), reverse=True)


def test_sort_by(scs):
    assert both(scs, lambda sc: sc.parallelize([5, 3, 8, 1], 2)
                .sortBy(lambda x: -x).collect()) == [8, 5, 3, 1]


def test_distinct_union_intersection_subtract(scs):
    def case(sc):
        a = sc.parallelize([1, 2, 2, 3, 3, 3], 3)
        b = sc.parallelize([3, 4], 2)
        return (a.distinct().collect(), a.union(b).collect(),
                a.intersection(b).collect(), a.subtract(b).collect())
    distinct, union, inter, sub = both(scs, case)
    assert sorted(distinct) == [1, 2, 3] and sorted(inter) == [3]
    assert sorted(union) == [1, 2, 2, 3, 3, 3, 3, 4]
    assert sorted(sub) == [1, 2, 2]


def test_cartesian_zip(scs):
    def case(sc):
        a = sc.parallelize([1, 2], 2)
        b = sc.parallelize(["x", "y"], 2)
        return (a.cartesian(b).collect(), a.zip(b).collect(),
                a.zipWithIndex().collect())
    cart, zipped, indexed = both(scs, case)
    assert sorted(cart) == [(1, "x"), (1, "y"), (2, "x"), (2, "y")]
    assert zipped == [(1, "x"), (2, "y")] and indexed == [(1, 0), (2, 1)]


def test_take_top_first(scs):
    def case(sc):
        r = sc.parallelize([7, 2, 9, 1, 5], 3)
        return (r.first(), r.take(3), r.top(2), r.takeOrdered(2),
                r.isEmpty(), sc.emptyRDD().isEmpty())
    assert both(scs, case) == (7, [7, 2, 9], [9, 7], [1, 2], False, True)


def test_stats(scs):
    def case(sc):
        r = sc.parallelize([1.0, 2.0, 3.0, 4.0], 2)
        s = r.stats()
        return (s.count(), s.mean(), s.min(), s.max(), s.variance(),
                r.sum(), r.mean(), r.stdev())
    assert both(scs, case)[:4] == (4, 2.5, 1.0, 4.0)


def test_partition_by_preserves(scs):
    def case(sc):
        p = sc.parallelize([(i, i) for i in range(20)], 4).partitionBy(5)
        return (p.getNumPartitions(), p.partitioner.numPartitions,
                p.mapValues(lambda v: v + 1).partitioner.numPartitions,
                p.map(lambda kv: kv).partitioner, p.glom().collect())
    assert both(scs, case)[:4] == (5, 5, 5, None)
    ref, port = scs
    assert port.parallelize([(1, 1)], 1).partitionBy(5).partitioner == \
        THashPartitioner(5)
    assert ref.parallelize([(1, 1)], 1).partitionBy(5).partitioner == \
        RHashPartitioner(5)


def test_coalesce_repartition(scs):
    def case(sc):
        r = sc.parallelize(range(12), 6)
        return (r.coalesce(2).getNumPartitions(), r.coalesce(2).collect(),
                r.repartition(3).getNumPartitions(),
                r.repartition(3).glom().collect())
    n2, coalesced, n3, _parts = both(scs, case)
    assert (n2, n3) == (2, 3) and sorted(coalesced) == list(range(12))


def test_accumulator_broadcast(scs):
    def case(sc):
        acc = sc.accumulator(0)
        b = sc.broadcast({"offset": 100})

        def f(x):
            acc.add(1)
            return x + b.value["offset"]
        return sc.parallelize(range(10), 4).map(f).collect(), acc.value
    out, count = both(scs, case)
    assert out[0] == 100 and len(out) == 10 and count == 10


def test_count_by_key_value(scs):
    def case(sc):
        return (dict(sc.parallelize([("a", 1), ("a", 2), ("b", 1)], 2)
                     .countByKey()),
                dict(sc.parallelize([1, 1, 2], 2).countByValue()))
    assert both(scs, case) == ({"a": 2, "b": 1}, {1: 2, 2: 1})


def test_sample_deterministic(scs):
    def case(sc):
        r = sc.parallelize(range(1000), 4)
        return (r.sample(False, 0.1, seed=42).collect(),
                r.sample(True, 0.2, seed=7).collect())
    without, _with = both(scs, case)
    assert 40 < len(without) < 200


def test_text_file_roundtrip(scs, tmp_path):
    def case(sc, tag):
        p = str(tmp_path / tag)
        sc.parallelize(["alpha", "beta", "gamma"], 2).saveAsTextFile(p)
        return (os.path.exists(os.path.join(p, "_SUCCESS")),
                sorted(os.listdir(p)), sc.textFile(p).collect(),
                sorted(sc.wholeTextFiles(p).map(
                    lambda kv: kv[1]).collect()))
    ref, port = scs
    got = case(port, "port")
    assert got == case(ref, "ref")
    assert got[0] and sorted(got[2]) == ["alpha", "beta", "gamma"]


def test_cache_and_debug_string(scs):
    def case(sc):
        r = sc.parallelize(range(4), 2).map(lambda x: x + 1)
        r.cache()
        return r.collect(), re.sub(r"\[\d+\]", "[<id>]", r.toDebugString())
    values, debug = both(scs, case)
    assert values == [1, 2, 3, 4] and "MapRDD" in debug


def test_to_df_bridge(scs, spark):
    def case(sc):
        df = sc.parallelize([(1, "a"), (2, "b")], 2).toDF(["id", "s"])
        return [tuple(x) for x in df.collect()]
    assert both(scs, case) == [(1, "a"), (2, "b")]
    ref, port = scs
    assert port._session().device.type == "cpu"


def test_df_to_rdd_bridge(spark, tspark):
    got = [sorted(r[0] for r in s.createDataFrame({"x": [1, 2, 3]})
                  .rdd.collect()) for s in (spark, tspark)]
    assert got[0] == got[1] == [1, 2, 3]
    assert tspark.sparkContext is tspark.sparkContext
    assert tspark.sparkContext._session() is tspark


def test_pipe(scs):
    assert both(scs, lambda sc: sc.parallelize(["a", "b"], 1)
                .pipe("cat").collect()) == ["a", "b"]


def test_histogram(scs):
    def case(sc):
        r = sc.parallelize([1.0, 2.0, 2.5, 3.0, 9.9], 2)
        return r.histogram([0, 5, 10]), r.histogram(4)
    assert both(scs, case)[0] == ([0, 5, 10], [4, 1])


@pytest.mark.parametrize("parts", [1, 3, 8])
def test_word_count_matches_counter(scs, parts):
    """The chip phase's word count at a small size: flatMap → map →
    reduceByKey → collect equals a Counter over the words, in both
    packages."""
    rng = random.Random(parts)
    vocab = [f"w{i}" for i in range(64)]
    lines = [" ".join(rng.choice(vocab) for _ in range(8))
             for _ in range(300)]

    def case(sc):
        return sorted(sc.parallelize(lines, parts)
                      .flatMap(lambda line: line.split(" "))
                      .map(lambda w: (w, 1))
                      .reduceByKey(lambda a, b: a + b).collect())
    assert dict(both(scs, case)) == Counter(
        w for line in lines for w in line.split(" "))
