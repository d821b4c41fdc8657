"""The port's ML pipeline API against the JAX package's
(``tests/test_ml.py``, case by case): every case fits and transforms the
same seeded numpy data through both packages and compares the fitted
parameters and the transformed columns — float64 within 1e-10, labels,
indices, codes and tree structures exactly — and keeps the JAX test's
own quality bar on the port's answer.  Also: the chip phase's pipeline
(VectorAssembler → StandardScaler → binomial IRLS → AUC) and its KMeans
against numpy oracles of the same steps, a NaN feature that must not
shorten a vector, and fitted reference models carried over with
``ml_model_from_reference``."""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from spark_tpu_torch.sql import multibatch as TMB
from spark_tpu_torch.sql.planner import QueryExecution as TQE
from spark_tpu_torch.testing import ml_model_from_reference
from torch_ml_common import (F64_TOL, PORT, REF, arr, close, col,  # noqa: F401
                             run_both, tspark)


def blob(n=200, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(0, 1, (n // 2, 2)) + np.array([2.0, 2.0])
    x1 = rng.normal(0, 1, (n // 2, 2)) + np.array([-2.0, -2.0])
    return {"features": np.vstack([x0, x1]),
            "label": np.array([1.0] * (n // 2) + [0.0] * (n // 2))}


def test_vector_assembler(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({"a": [1.0, 2.0], "b": [3.0, 4.0],
                                "v": np.array([[5.0, 6.0], [7.0, 8.0]])})
        out = M.feat.VectorAssembler(inputCols=["a", "v", "b"],
                                     outputCol="f").transform(df)
        return [list(r["f"]) for r in out.collect()], out.columns
    r, t = run_both(spark, tspark, case)
    assert t == r and t[0][0] == [1.0, 5.0, 6.0, 3.0]


@pytest.mark.parametrize("with_mean", [True, False])
def test_standard_scaler(spark, tspark, with_mean):
    X = np.random.default_rng(1).normal(3, 2, (50, 3))

    def case(s, M):
        df = s.createDataFrame({"features": X})
        m = M.feat.StandardScaler(inputCol="features", outputCol="s",
                                  withMean=with_mean).fit(df)
        return (arr(m.getOrDefault("mean")), arr(m.getOrDefault("std")),
                col(m.transform(df), "s"))
    r, t = run_both(spark, tspark, case)
    for a, b in zip(t, r):
        close(a, b)
    if with_mean:
        assert abs(t[2].mean()) < 1e-9


def test_minmax_scaler(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({"features": np.array([[0.0, 1.0],
                                                      [5.0, 1.0],
                                                      [10.0, 1.0]])})
        m = M.feat.MinMaxScaler(inputCol="features", outputCol="s").fit(df)
        return col(m.transform(df), "s")
    r, t = run_both(spark, tspark, case)
    np.testing.assert_array_equal(t, r)
    assert list(t[:, 0]) == [0.0, 0.5, 1.0]


def test_string_indexer_roundtrip(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({"cat": ["b", "a", "b", "c", "b", "a"]})
        model = M.feat.StringIndexer(inputCol="cat", outputCol="idx").fit(df)
        out = model.transform(df)
        back = M.feat.IndexToString(
            inputCol="idx", outputCol="orig",
            labels=model.getOrDefault("labels")).transform(out)
        unseen = M.feat.StringIndexer(inputCol="cat", outputCol="i",
                                      handleInvalid="keep").fit(df)
        other = s.createDataFrame({"cat": ["z", "a"]})
        return (model.getOrDefault("labels"),
                [tuple(x) for x in back.collect()],
                list(col(unseen.transform(other), "i")))
    r, t = run_both(spark, tspark, case)
    assert t == r and t[0] == ["b", "a", "c"]
    assert all(row[0] == row[2] for row in t[1])


def test_one_hot(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({"idx": [0.0, 1.0, 2.0, 1.0]})
        out = [M.feat.OneHotEncoder(inputCol="idx", outputCol="v",
                                    dropLast=d).transform(df)
               for d in (True, False)]
        return [[list(x["v"]) for x in o.collect()] for o in out]
    r, t = run_both(spark, tspark, case)
    assert t == r and t[0][0] == [1.0, 0.0] and t[0][2] == [0.0, 0.0]


def test_binarizer_bucketizer(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({"x": [0.1, 0.6, 2.5, 0.5, -3.0, 12.0]})
        b = M.feat.Binarizer(inputCol="x", outputCol="b",
                             threshold=0.5).transform(df)
        bk = M.feat.Bucketizer(inputCol="x", outputCol="bk",
                               splits=[0.0, 0.5, 1.0, 10.0]).transform(df)
        return list(col(b, "b")), list(col(bk, "bk"))
    r, t = run_both(spark, tspark, case)
    assert t == r and t[1][:3] == [0.0, 1.0, 2.0]


def test_pca(spark, tspark):
    rng = np.random.default_rng(0)
    base = rng.normal(0, 1, (50, 1))
    X = np.hstack([base, base * 2.0 + rng.normal(0, 0.01, (50, 1)),
                   rng.normal(0, 0.5, (50, 1))])

    def case(s, M):
        df = s.createDataFrame({"features": X})
        m = M.feat.PCA(inputCol="features", outputCol="p", k=2).fit(df)
        return (arr(m.getOrDefault("components")), arr(m.getOrDefault("mean")),
                col(m.transform(df), "p"))
    r, t = run_both(spark, tspark, case)
    # each singular vector's sign is its solver's choice: align, then
    # compare the components and the projections within 1e-10
    signs = np.sign((t[0] * r[0]).sum(axis=1))
    close(t[0] * signs[:, None], r[0])
    close(t[1], r[1])
    close(t[2] * signs[None, :], r[2])
    assert t[2][:, 0].std() > 1.0


@pytest.mark.parametrize("kw", [{"maxIter": 15}, {"regParam": 0.1},
                                {"fitIntercept": False}])
def test_logistic_regression(spark, tspark, kw):
    data = blob()

    def case(s, M):
        df = s.createDataFrame(data)
        model = M.cls.LogisticRegression(**kw).fit(df)
        out = model.transform(df)
        return (arr(model.getOrDefault("coefficients")),
                model.getOrDefault("intercept"), col(out, "prediction"),
                col(out, "probability"),
                M.ev.MulticlassClassificationEvaluator(
                    metricName="accuracy").evaluate(out),
                M.ev.BinaryClassificationEvaluator().evaluate(out))
    r, t = run_both(spark, tspark, case)
    close(t[0], r[0])
    close(t[1], r[1])
    np.testing.assert_array_equal(t[2], r[2])
    close(t[3], r[3])
    assert t[4] == r[4] > 0.95 and t[5] == r[5] > 0.95


def test_logistic_regression_multinomial(spark, tspark):
    rng = np.random.default_rng(5)
    X = np.vstack([rng.normal(c, 0.7, (40, 2))
                   for c in ([2, 2], [-2, 2], [0, -2])])
    y = np.repeat([0.0, 1.0, 2.0], 40)

    def case(s, M):
        df = s.createDataFrame({"features": X, "label": y})
        model = M.cls.LogisticRegression(maxIter=10).fit(df)
        out = model.transform(df)
        return (arr(model.getOrDefault("coefficients")),
                arr(model.getOrDefault("intercept")),
                col(out, "prediction"), col(out, "probability"))
    r, t = run_both(spark, tspark, case)
    for a, b in zip(t, r):
        close(a, b)
    assert (t[2] == y).mean() > 0.9


def test_linear_svc(spark, tspark):
    data = blob(seed=3)

    def case(s, M):
        df = s.createDataFrame(data)
        model = M.cls.LinearSVC(maxIter=200).fit(df)
        out = model.transform(df)
        return (arr(model.getOrDefault("coefficients")),
                model.getOrDefault("intercept"), col(out, "prediction"))
    r, t = run_both(spark, tspark, case)
    close(t[0], r[0])
    close(t[1], r[1])
    np.testing.assert_array_equal(t[2], r[2])
    assert (t[2] == data["label"]).mean() > 0.9


def test_naive_bayes(spark, tspark):
    rng = np.random.default_rng(1)
    x0 = rng.poisson([5.0, 1.0, 1.0], (60, 3)).astype(float)
    x1 = rng.poisson([1.0, 1.0, 5.0], (60, 3)).astype(float)
    data = {"features": np.vstack([x0, x1]),
            "label": np.array([0.0] * 60 + [1.0] * 60)}

    def case(s, M):
        df = s.createDataFrame(data)
        model = M.cls.NaiveBayes().fit(df)
        return (arr(model.getOrDefault("logPrior")),
                arr(model.getOrDefault("logLikelihood")),
                col(model.transform(df), "prediction"))
    r, t = run_both(spark, tspark, case)
    close(t[0], r[0])
    close(t[1], r[1])
    np.testing.assert_array_equal(t[2], r[2])
    assert (t[2] == data["label"]).mean() > 0.85


def test_linear_regression(spark, tspark):
    rng = np.random.default_rng(2)
    X = rng.normal(0, 1, (100, 3))
    y = X @ np.array([2.0, -1.0, 0.5]) + 3.0 + rng.normal(0, 0.01, 100)

    def case(s, M):
        df = s.createDataFrame({"features": X, "label": y})
        model = M.reg.LinearRegression(regParam=0.01).fit(df)
        plain = M.reg.LinearRegression().fit(df)
        out = plain.transform(df)
        return (arr(model.getOrDefault("coefficients")),
                arr(plain.getOrDefault("coefficients")),
                plain.getOrDefault("intercept"),
                plain.getOrDefault("summary"), col(out, "prediction"),
                [M.ev.RegressionEvaluator(metricName=m).evaluate(out)
                 for m in ("rmse", "mse", "mae", "r2")])
    r, t = run_both(spark, tspark, case)
    for i in (0, 1, 2, 4, 5):
        close(t[i], r[i])
    close([t[3]["rmse"], t[3]["r2"]], [r[3]["rmse"], r[3]["r2"]])
    assert np.allclose(t[1], [2.0, -1.0, 0.5], atol=0.05)


def test_decision_tree(spark, tspark):
    rng = np.random.default_rng(4)
    X = rng.uniform(0, 1, (200, 2))
    y = np.where(X[:, 0] > 0.5, 10.0, 0.0) + X[:, 1]

    def case(s, M):
        df = s.createDataFrame({"features": X, "label": y})
        model = M.reg.DecisionTreeRegressor(maxDepth=3).fit(df)
        return model.getOrDefault("tree"), col(model.transform(df),
                                               "prediction")
    r, t = run_both(spark, tspark, case)
    assert t[0] == r[0]                          # the same tree, exactly
    np.testing.assert_array_equal(t[1], r[1])
    assert np.sqrt(((t[1] - y) ** 2).mean()) < 1.0


def test_kmeans(spark, tspark):
    data = blob(seed=5)

    def case(s, M):
        df = s.createDataFrame(data)
        model = M.clu.KMeans(k=3, maxIter=10, seed=1).fit(df)
        return (arr(model.getOrDefault("clusterCenters")),
                col(model.transform(df), "prediction"),
                model.computeCost(df))
    r, t = run_both(spark, tspark, case)
    close(t[0], r[0])
    np.testing.assert_array_equal(t[1], r[1])
    close(t[2], r[2])


def test_bisecting_kmeans(spark, tspark):
    data = blob(seed=6)

    def case(s, M):
        df = s.createDataFrame(data)
        model = M.clu.BisectingKMeans(k=4, maxIter=5, seed=3).fit(df)
        return (arr(model.getOrDefault("clusterCenters")),
                col(model.transform(df), "prediction"))
    r, t = run_both(spark, tspark, case)
    close(t[0], r[0])
    np.testing.assert_array_equal(t[1], r[1])


def test_als(spark, tspark):
    rng = np.random.default_rng(6)
    n_u, n_i, k = 20, 15, 3
    U = rng.normal(0, 1, (n_u, k))
    V = rng.normal(0, 1, (n_i, k))
    users, items = np.meshgrid(np.arange(n_u), np.arange(n_i), indexing="ij")
    data = {"user": users.ravel().astype(np.int64),
            "item": items.ravel().astype(np.int64),
            "rating": (U @ V.T).ravel()}

    def case(s, M):
        df = s.createDataFrame(data)
        model = M.rec.ALS(rank=3, maxIter=12, regParam=0.01).fit(df)
        out = model.transform(df)
        test = s.createDataFrame({"user": np.array([0, 99], np.int64),
                                  "item": np.array([1, 2], np.int64)})
        recs = model.recommendForAllUsers(3).collect()
        return (arr(model.getOrDefault("userFactors")),
                arr(model.getOrDefault("itemFactors")),
                col(out, "prediction"), col(model.transform(test),
                                            "prediction"),
                [tuple(r[0:1]) + (list(r[1]),) for r in recs],
                M.ev.RegressionEvaluator(labelCol="rating").evaluate(out))
    r, t = run_both(spark, tspark, case)
    for i in (0, 1, 2, 5):
        close(t[i], r[i], tol=1e-9)
    assert np.isnan(t[3][1]) and np.isnan(r[3][1])
    close(t[3][:1], r[3][:1])
    assert t[4] == r[4] and t[5] < 0.1


def test_pipeline(spark, tspark):
    data = {"cat": ["x", "y", "x", "y"] * 10,
            "num": np.linspace(0, 1, 40),
            "label": np.array([0.0, 1.0] * 20)}

    def case(s, M):
        df = s.createDataFrame(data)
        pipe = M.base.Pipeline(stages=[
            M.feat.StringIndexer(inputCol="cat", outputCol="ci"),
            M.feat.VectorAssembler(inputCols=["ci", "num"],
                                   outputCol="features"),
            M.cls.LogisticRegression(maxIter=10),
        ])
        out = pipe.fit(df).transform(df)
        return out.columns, col(out, "prediction"), col(out, "probability")
    r, t = run_both(spark, tspark, case)
    assert t[0] == r[0] and "prediction" in t[0]
    np.testing.assert_array_equal(t[1], r[1])
    close(t[2], r[2], tol=1e-8)


def test_sql_transformer(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({"v": [1.0, 2.0]})
        out = M.feat.SQLTransformer(
            statement="SELECT v, v * 2 AS v2 FROM __THIS__").transform(df)
        return [tuple(x) for x in out.collect()]
    r, t = run_both(spark, tspark, case)
    assert t == r == [(1.0, 2.0), (2.0, 4.0)]


def test_cross_validator(spark, tspark):
    data = blob(seed=7)

    def case(s, M):
        df = s.createDataFrame(data)
        lr = M.cls.LogisticRegression()
        grid = M.tun.ParamGridBuilder().addGrid(
            lr._params()["regParam"], [0.0, 0.1]).build()
        cv = M.tun.CrossValidator(
            estimator=lr, estimatorParamMaps=grid,
            evaluator=M.ev.BinaryClassificationEvaluator(), numFolds=3)
        model = cv.fit(df)
        tvs = M.tun.TrainValidationSplit(
            estimator=lr, estimatorParamMaps=grid,
            evaluator=M.ev.MulticlassClassificationEvaluator(
                metricName="f1")).fit(df)
        return (model.getOrDefault("avgMetrics"),
                M.ev.MulticlassClassificationEvaluator(
                    metricName="accuracy").evaluate(model.transform(df)),
                tvs.getOrDefault("validationMetrics"),
                arr(tvs.getOrDefault("bestModel")
                    .getOrDefault("coefficients")))
    r, t = run_both(spark, tspark, case)
    close(t[0], r[0])
    assert t[1] == r[1] > 0.9
    close(t[2], r[2])
    close(t[3], r[3])


def test_params_api(tspark):
    from spark_tpu_torch.expressions import AnalysisException
    from spark_tpu_torch.ml.classification import LogisticRegression
    lr = LogisticRegression()
    lr.setMaxIter(7)
    assert lr.getMaxIter() == 7
    assert "maxIter" in lr.explainParams()
    c = lr.copy({"maxIter": 9})
    assert c.getMaxIter() == 9 and lr.getMaxIter() == 7
    with pytest.raises(AnalysisException):
        lr.set("nope", 1)
    with pytest.raises(AttributeError):
        lr.frobnicate


def test_model_save(spark, tspark, tmp_path):
    def case(s, M):
        model = M.cls.LogisticRegression(maxIter=5).fit(
            s.createDataFrame(blob()))
        p = str(tmp_path / f"lrm_{M is not None and id(M)}")
        model.write().overwrite().save(p)
        with pytest.raises(Exception, match="exists"):
            model.write().save(p)
        meta = json.load(open(os.path.join(p, "metadata.json")))
        back = type(model).load(p)
        return meta, arr(back.getOrDefault("coefficients"))
    r, t = run_both(spark, tspark, case)
    assert t[0]["class"] == r[0]["class"] == "LogisticRegressionModel"
    assert sorted(t[0]["params"]) == sorted(r[0]["params"])
    close(t[0]["params"]["coefficients"], r[0]["params"]["coefficients"])
    close(t[1], r[1])


def _nonlinear_reg(n=300, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 3))
    y = np.where(X[:, 0] > 0, 5.0, -5.0) + X[:, 1] ** 2 \
        + rng.normal(0, 0.3, n)
    return pd.DataFrame({"f0": X[:, 0], "f1": X[:, 1], "f2": X[:, 2],
                         "label": y})


def _assembled(s, M, pdf, cols):
    return M.feat.VectorAssembler(inputCols=cols, outputCol="features") \
        .transform(s.createDataFrame(pdf))


def test_random_forest_regressor_generalizes(spark, tspark):
    train, test = _nonlinear_reg(seed=3), _nonlinear_reg(seed=44)

    def case(s, M):
        tr = _assembled(s, M, train, ["f0", "f1", "f2"])
        te = _assembled(s, M, test, ["f0", "f1", "f2"])
        tree = M.reg.DecisionTreeRegressor(maxDepth=4).fit(tr)
        rf = M.reg.RandomForestRegressor(
            numTrees=30, maxDepth=4, subsamplingRate=0.7,
            featureSubsetStrategy="all").fit(tr)
        return (rf.getOrDefault("trees"), col(tree.transform(te),
                                              "prediction"),
                col(rf.transform(te), "prediction"))
    r, t = run_both(spark, tspark, case)
    assert t[0] == r[0]                       # same bootstrap, same trees
    np.testing.assert_array_equal(t[1], r[1])
    close(t[2], r[2])
    y = test["label"].to_numpy()
    assert ((t[2] - y) ** 2).mean() < ((t[1] - y) ** 2).mean() * 1.02


def test_gbt_regressor_improves_with_rounds(spark, tspark):
    pdf = _nonlinear_reg(n=400)

    def case(s, M):
        df = _assembled(s, M, pdf, ["f0", "f1", "f2"])
        return [col(M.reg.GBTRegressor(maxIter=k).fit(df).transform(df),
                    "prediction") for k in (2, 40)]
    r, t = run_both(spark, tspark, case)
    close(t[0], r[0])
    close(t[1], r[1])
    y = pdf["label"].to_numpy()
    assert ((t[1] - y) ** 2).mean() < ((t[0] - y) ** 2).mean() * 0.5


def test_tree_classifiers_solve_xor(spark, tspark):
    rng = np.random.default_rng(9)
    X = rng.uniform(-2, 2, (400, 2))
    pdf = pd.DataFrame({"f0": X[:, 0], "f1": X[:, 1],
                        "label": ((X[:, 0] * X[:, 1]) > 0).astype(float)})

    def case(s, M):
        df = _assembled(s, M, pdf, ["f0", "f1"])
        models = [M.cls.DecisionTreeClassifier(maxDepth=4),
                  M.cls.RandomForestClassifier(numTrees=15, maxDepth=4),
                  M.cls.GBTClassifier(maxIter=25, maxDepth=3)]
        return [col(m.fit(df).transform(df), "prediction") for m in models]
    r, t = run_both(spark, tspark, case)
    for a, b in zip(t, r):
        np.testing.assert_array_equal(a, b)
        assert (a == pdf["label"].to_numpy()).mean() > 0.9


def test_forest_model_persistence(tspark, tmp_path):
    from spark_tpu_torch.ml.regression import (RandomForestRegressionModel,
                                               RandomForestRegressor)
    from spark_tpu_torch.ml import feature as F
    df = F.VectorAssembler(inputCols=["f0", "f1", "f2"],
                           outputCol="features").transform(
        tspark.createDataFrame(_nonlinear_reg(n=120)))
    model = RandomForestRegressor(numTrees=5, maxDepth=3).fit(df)
    path = str(tmp_path / "rf_model")
    model.save(path)
    loaded = RandomForestRegressionModel.load(path)
    np.testing.assert_array_equal(col(model.transform(df), "prediction"),
                                  col(loaded.transform(df), "prediction"))


# ---------------------------------------------------------------------------
# the chip phase's shapes at a small size, against numpy oracles
# ---------------------------------------------------------------------------

def _np_irls(X, y, iters):
    """numpy float64 IRLS of LogisticRegression's steps (intercept
    last)."""
    Xb = np.hstack([X, np.ones((len(X), 1))])
    w = np.zeros(Xb.shape[1])
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-(Xb @ w)))
        wgt = np.maximum(p * (1 - p), 1e-10)
        w = w - np.linalg.solve((Xb * wgt[:, None]).T @ Xb,
                                Xb.T @ (p - y))
    return w


def test_higgs_shaped_pipeline_vs_numpy_irls(spark, tspark):
    """VectorAssembler over 28 float64 columns → StandardScaler →
    binomial IRLS → areaUnderROC, as the card's ``[ml]`` phase runs it at
    2^22 rows: equal to the reference and to numpy's IRLS within 1e-8,
    the AUC within 1e-9."""
    rng = np.random.default_rng(21)
    n, d = 512, 28
    X = rng.normal(0, 1, (n, d)) * rng.uniform(0.5, 3, d) + rng.normal(0, 2,
                                                                      d)
    beta = rng.normal(0, 0.5, d)
    z = ((X - X.mean(0)) / X.std(0)) @ beta
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(float)
    names = [f"x{j}" for j in range(d)]
    data = {nm: X[:, j] for j, nm in enumerate(names)}
    data["label"] = y

    def case(s, M):
        pipe = M.base.Pipeline(stages=[
            M.feat.VectorAssembler(inputCols=names, outputCol="raw"),
            M.feat.StandardScaler(inputCol="raw", outputCol="features",
                                  withMean=True),
            M.cls.LogisticRegression(family="binomial", maxIter=25)])
        model = pipe.fit(s.createDataFrame(data))
        out = model.transform(s.createDataFrame(data))
        lrm = model.getOrDefault("stages")[-1]
        return (arr(lrm.getOrDefault("coefficients")),
                lrm.getOrDefault("intercept"),
                M.ev.BinaryClassificationEvaluator().evaluate(out),
                col(out, "probability")[:, 1])
    r, t = run_both(spark, tspark, case)
    Z = (X - X.mean(0)) / X.std(0, ddof=1)
    w = _np_irls(Z, y, 25)
    np.testing.assert_allclose(t[0], w[:-1], atol=1e-8)
    assert abs(t[1] - w[-1]) < 1e-8
    close(t[0], r[0])
    close(t[1], r[1])
    assert abs(t[2] - r[2]) < 1e-9
    close(t[3], r[3])


def test_evaluator_average_ranks_match_reference_loop():
    """The port's tie-averaged ranks (runs of the stable sort) give the
    same bits as the JAX package's per-value loop."""
    from spark_tpu_torch.ml.evaluation import _average_ranks
    rng = np.random.default_rng(2)
    for s in (rng.integers(0, 5, 300).astype(float), rng.normal(0, 1, 50),
              np.array([1.0, np.nan, 1.0, np.nan, 0.5])):
        order = np.argsort(s, kind="stable")
        want = np.empty(len(s))
        want[order] = np.arange(1, len(s) + 1)
        for v in np.unique(s):
            m = s == v
            if m.sum() > 1:
                want[m] = want[m].mean()
        np.testing.assert_array_equal(_average_ranks(s), want)


def test_kmeans_vs_numpy_lloyd(spark, tspark):
    """KMeans over 10 Gaussian blobs from the same ``default_rng`` starts
    as numpy's Lloyd steps: centres within rtol 1e-9, assignments equal
    (the card's ``[ml]`` (c) at a small size)."""
    rng = np.random.default_rng(31)
    centres = rng.normal(0, 10, (10, 20))
    X = centres[rng.integers(0, 10, 2000)] + rng.normal(0, 1, (2000, 20))
    C = X[np.random.default_rng(4).choice(len(X), 10, replace=False)]
    for _ in range(20):
        a = ((X[:, None, :] - C[None]) ** 2).sum(-1).argmin(1)
        C = np.stack([X[a == j].mean(0) if (a == j).any() else C[j]
                      for j in range(10)])

    def case(s, M):
        df = s.createDataFrame({"features": X})
        m = M.clu.KMeans(k=10, maxIter=20, seed=4).fit(df)
        return arr(m.getOrDefault("clusterCenters")), \
            col(m.transform(df), "prediction")
    r, t = run_both(spark, tspark, case)
    np.testing.assert_allclose(t[0], C, rtol=1e-9)
    close(t[0], r[0])
    np.testing.assert_array_equal(t[1], a)
    np.testing.assert_array_equal(t[1], r[1])


# ---------------------------------------------------------------------------
# NaN features, carried-over models, mllib
# ---------------------------------------------------------------------------

def test_nan_feature_does_not_shorten_a_vector(spark, tspark):
    """A NaN feature made in SQL (where it stays NaN) keeps its slot in
    the middle of a vector: VectorAssembler, extract_matrix and the
    fitted statistics read all d slots, in both packages (the port's
    array planes use NaN as their element sentinel).  A numpy NaN given
    to createDataFrame is NULL in both (ROADMAP §3), which the Imputer
    fills."""
    a = np.array([1.0, 2.0, 3.0, 4.0])
    b = np.array([0.5, np.nan, 1.5, 2.5])

    def case(s, M):
        df = s.createDataFrame({"a": a, "b": b})
        df = df.selectExpr("a", "b", "CASE WHEN a < 2.5 THEN "
                           "CAST('NaN' AS DOUBLE) ELSE a * 2.0 END AS c")
        v = M.feat.VectorAssembler(inputCols=["a", "c", "b"],
                                   outputCol="f").transform(df)
        X, _batch, n = M.base.extract_matrix(v, "f")
        imp = M.feat.Imputer(inputCols=["b"], outputCols=["bi"]).fit(df)
        filled = M.feat.VectorAssembler(
            inputCols=["a", "bi"], outputCol="g").transform(imp.transform(df))
        sc = M.feat.StandardScaler(inputCol="f", outputCol="s").fit(v)
        return (arr(X), n, arr(sc.getOrDefault("mean")),
                col(filled, "g"), imp.getOrDefault("surrogates"))
    r, t = run_both(spark, tspark, case)
    assert t[0].shape == r[0].shape == (4, 3) and t[1] == r[1] == 4
    np.testing.assert_array_equal(np.isnan(t[0]), np.isnan(r[0]))
    np.testing.assert_array_equal(np.isnan(t[0]), [[False, True, False]] * 2
                                  + [[False, False, False]] * 2)
    close(np.nan_to_num(t[0]), np.nan_to_num(r[0]))
    np.testing.assert_array_equal(np.isnan(t[2]), [False, True, False])
    close(t[2][[0, 2]], r[2][[0, 2]])
    close(t[3], r[3])
    assert t[3].shape == (4, 2) and t[4] == r[4]


def test_models_carried_over_from_reference(spark, tspark):
    """Fitted reference models run the port's ``transform`` on the same
    state: linear, multinomial, NaiveBayes, KMeans, trees, GBT, a
    pipeline with a string indexer, ALS factors."""
    data = blob(seed=11)
    rdf = spark.createDataFrame(data)
    models = [
        REF.cls.LogisticRegression(maxIter=8).fit(rdf),
        REF.cls.LinearSVC(maxIter=30).fit(rdf),
        REF.reg.LinearRegression().fit(rdf),
        REF.clu.KMeans(k=3, seed=2).fit(rdf),
        REF.cls.DecisionTreeClassifier(maxDepth=3).fit(rdf),
        REF.cls.RandomForestClassifier(numTrees=4, maxDepth=3).fit(rdf),
        REF.cls.GBTClassifier(maxIter=5).fit(rdf),
        REF.feat.StandardScaler(inputCol="features", outputCol="s",
                                withMean=True).fit(rdf),
    ]
    tdf = tspark.createDataFrame(data)
    for m in models:
        tm = ml_model_from_reference(m)
        assert type(tm).__module__.startswith("spark_tpu_torch.ml.")
        assert type(tm).__name__ == type(m).__name__
        out_r, out_t = m.transform(rdf), tm.transform(tdf)
        assert out_t.columns == out_r.columns
        for c in out_r.columns[len(rdf.columns):]:
            close(col(out_t, c), col(out_r, c))
    pipe = REF.base.Pipeline(stages=[
        REF.feat.StringIndexer(inputCol="cat", outputCol="ci"),
        REF.feat.VectorAssembler(inputCols=["ci", "num"],
                                 outputCol="features"),
        REF.cls.LogisticRegression(maxIter=10)])
    pdata = {"cat": ["x", "y", "z", "y"] * 10, "num": np.linspace(0, 1, 40),
             "label": np.array([0.0, 1.0] * 20)}
    pm = pipe.fit(spark.createDataFrame(pdata))
    tpm = ml_model_from_reference(pm)
    assert isinstance(tpm, PORT.base.PipelineModel)
    close(col(tpm.transform(tspark.createDataFrame(pdata)), "probability"),
          col(pm.transform(spark.createDataFrame(pdata)), "probability"))


@pytest.mark.parametrize("which", ["kmeans", "logistic", "linear", "nb"])
def test_mllib_train(spark, tspark, sc_pair, which):
    rng = np.random.default_rng(13)
    X = rng.normal(0, 1, (60, 2)) + np.repeat([[2, 2], [-2, -2]], 30, 0)
    y = np.repeat([1.0, 0.0], 30)

    def case(s, M):
        sc = sc_pair[0] if M is not None and M.mllib.__name__.startswith(
            "spark_tpu.") else sc_pair[1]
        lp = [M.mllib.LabeledPoint(yy, xx) for xx, yy in zip(X, y)]
        if which == "kmeans":
            m = M.mllib.KMeans.train(sc.parallelize(X.tolist()), 2, seed=3)
            return arr(m.getOrDefault("clusterCenters"))
        if which == "logistic":
            m = M.mllib.LogisticRegressionWithLBFGS.train(
                sc.parallelize(lp), iterations=10)
        elif which == "linear":
            m = M.mllib.LinearRegressionWithSGD.train(
                [(yy, xx) for xx, yy in zip(X, y)])
        else:
            m = M.mllib.NaiveBayes.train(sc.parallelize(
                [M.mllib.LabeledPoint(yy, np.abs(xx)) for xx, yy in
                 zip(X, y)]))
            return arr(m.getOrDefault("logLikelihood"))
        return arr(m.getOrDefault("coefficients"))
    r, t = run_both(spark, tspark, case)
    close(t, r)


@pytest.fixture(scope="module")
def sc_pair(spark, tspark):
    from spark_tpu.rdd import SparkContext as RSC
    return RSC.getOrCreate(), tspark.sparkContext


def test_estimators_over_a_cached_dataframe(spark, tspark):
    """A cached projection (the cache manager's batch, not a plan run)
    feeds extract_matrix alike in both packages."""
    X = np.random.default_rng(17).normal(size=(100, 3))

    def case(s, M):
        df = s.createDataFrame({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2]}) \
            .select("a", "b", "c").filter("a > -1.0")
        df.cache()
        df.count()
        v = M.feat.VectorAssembler(inputCols=["a", "b", "c"],
                                   outputCol="f").transform(df)
        m = M.feat.StandardScaler(inputCol="f", outputCol="s",
                                  withMean=True).fit(v)
        out = col(m.transform(v), "s")
        df.unpersist()
        return arr(m.getOrDefault("mean")), out
    r, t = run_both(spark, tspark, case)
    close(t[0], r[0])
    close(t[1], r[1])
    assert len(t[1]) == int((X[:, 0] > -1.0).sum())


class _Elsewhere:
    """A plan run's result that lies on another device than the
    session's, as the mesh lane's and the out-of-core runners' host
    batches do on a card session."""
    device = torch.device("meta")

    def __init__(self, batch, moves):
        self.batch, self.moves = batch, moves

    def to_device(self, device, non_blocking=False):
        self.moves.append(torch.device(device))
        return self.batch


@pytest.mark.parametrize("lane", ["mesh", "out_of_core"])
def test_lane_results_reach_the_session_device(spark, tspark, tmp_path,
                                               monkeypatch, lane):
    """The mesh lane (4 shards) and the out-of-core runners hand back a
    host batch whatever ``keep_on_device`` says: ``execute_batch`` copies
    it to the session's device, so the matrices an estimator fits on
    lie there, and the fit over either lane equals the reference's within
    1e-10."""
    rng = np.random.default_rng(23)
    n, d = 600, 4
    X = rng.normal(size=(n, d))
    y = (X @ rng.normal(size=d) + rng.normal(0, 0.5, n) > 0).astype(float)
    names = [f"x{j}" for j in range(d)]
    data = {nm: X[:, j] for j, nm in enumerate(names)}
    data["label"] = y

    def fit(M, df):
        v = M.feat.VectorAssembler(inputCols=names,
                                   outputCol="features").transform(df)
        return M.cls.LogisticRegression(maxIter=10).fit(v)
    ref = fit(REF, spark.createDataFrame(data))
    if lane == "out_of_core":
        path = str(tmp_path / "t")
        tspark.createDataFrame(data).write.parquet(path)
        key, value = "spark.tpu.scan.maxBatchRows", "128"
    else:
        key, value = "spark.tpu.mesh.shards", "4"
    moves = []
    run = TQE.execute
    monkeypatch.setattr(TQE, "execute",
                        lambda self: _Elsewhere(run(self), moves))
    tspark.conf.set(key, value)
    try:
        TMB.reset_stream_stats()
        df = (tspark.read.parquet(path) if lane == "out_of_core"
              else tspark.createDataFrame(data))
        model = fit(PORT, df)
        if lane == "out_of_core":
            assert TMB.STREAM_STATS["batches"] > 0
    finally:
        tspark.conf.unset(key)
    # one plan run for the assembler, one for the fit: each moved
    assert moves == [tspark.device, tspark.device]
    coef = model.getOrDefault("coefficients")
    assert coef.device == tspark.device
    close(coef, ref.getOrDefault("coefficients"))
    close(model.getOrDefault("intercept"), ref.getOrDefault("intercept"))
