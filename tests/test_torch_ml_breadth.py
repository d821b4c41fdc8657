"""The port's ML breadth against the JAX package's
(``tests/test_ml_breadth.py``, case by case): MLP, CountVectorizer,
Word2Vec, Correlation / ChiSquareTest, FPGrowth, GaussianMixture,
isotonic and AFT regression, LDA and the feature-stage wave — the same
seeded numpy inputs through both packages.  Host-numpy paths and float64
device paths agree within 1e-10 (codes, vocabularies, itemsets and rules
exactly); the float32 ones (MLP, Word2Vec) within 1e-4.

The estimators that draw their initial state from ``jax.random`` (MLP,
Word2Vec, GaussianMixture, LDA) draw it in the port from a
``torch.Generator``: each has a test that computes the JAX package's
initial state with the same ``jax.random`` calls and trains the port
from it (``_initial_state`` / ``_train``), and a test that the port's
own seeded fit meets the JAX test's bar."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ml_common import (F32_TOL, PORT, REF, arr, close, col,  # noqa: F401
                             run_both, tspark)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _xor(n=400, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 2))
    return X, ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float64)


def test_mlp_learns_xor(tspark):
    X, y = _xor()
    df = tspark.createDataFrame({"features": X, "label": y})
    model = PORT.ann.MultilayerPerceptronClassifier(
        layers=[2, 8, 2], maxIter=400, stepSize=0.05, seed=7).fit(df)
    got = col(model.transform(df), "prediction")
    assert (got == y).mean() >= 0.95
    assert model.getOrDefault("objectiveHistory")[-1] < \
        model.getOrDefault("objectiveHistory")[0]


def _ref_mlp_state(sizes, seed):
    """``spark_tpu/ml/ann.py``'s Glorot draws, call for call."""
    key = jax.random.PRNGKey(seed)
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        key, k1 = jax.random.split(key)
        scale = np.sqrt(6.0 / (din + dout))
        params.append((np.asarray(jax.random.uniform(
            k1, (din, dout), jnp.float32, -scale, scale)),
            np.zeros((dout,), np.float32)))
    return params


@pytest.mark.parametrize("sizes,n_classes", [([2, 8, 2], 2),
                                             ([2, 16, 3], 3)])
def test_mlp_from_reference_initial_state(spark, tspark, sizes, n_classes):
    """The port trained from the JAX package's initial weights: weights,
    loss curve and probabilities within 1e-4 (float32), predictions
    equal."""
    rng = np.random.default_rng(0)
    X = np.vstack([rng.normal(0, 0.6, (40, 2)) + c
                   for c in ([2, 2], [-2, 2], [0, -2])[:n_classes]])
    y = np.repeat(np.arange(n_classes, dtype=np.float64), 40)
    kw = dict(layers=sizes, maxIter=60, seed=1)
    rm = REF.ann.MultilayerPerceptronClassifier(**kw).fit(
        spark.createDataFrame({"features": X, "label": y}))
    tdf = tspark.createDataFrame({"features": X, "label": y})
    est = PORT.ann.MultilayerPerceptronClassifier(**kw)
    Xt, batch, n = PORT.base.extract_matrix(tdf, "features")
    yt = PORT.base.extract_column(batch, "label", n)
    tm = est._train(Xt, yt, torch.unique(yt), _ref_mlp_state(sizes, 1))
    for (tw, tb), (rw, rb) in zip(tm.getOrDefault("weights"),
                                  rm.getOrDefault("weights")):
        close(tw, rw, F32_TOL)
        close(tb, rb, F32_TOL)
    close(tm.getOrDefault("objectiveHistory"),
          rm.getOrDefault("objectiveHistory"), F32_TOL)
    rout = rm.transform(spark.createDataFrame({"features": X, "label": y}))
    tout = tm.transform(tdf)
    np.testing.assert_array_equal(col(tout, "prediction"),
                                  col(rout, "prediction"))
    close(col(tout, "probability"), col(rout, "probability"), F32_TOL)


def test_mlp_matches_sklearn_on_blobs(tspark):
    from sklearn.neural_network import MLPClassifier
    rng = np.random.default_rng(0)
    n = 300
    X = np.vstack([rng.normal(0, 0.6, (n // 3, 2)) + c
                   for c in ([2, 2], [-2, 2], [0, -2])])
    y = np.repeat([0.0, 1.0, 2.0], n // 3)
    df = tspark.createDataFrame({"features": X, "label": y})
    model = PORT.ann.MultilayerPerceptronClassifier(
        layers=[2, 16, 3], maxIter=300, seed=1).fit(df)
    out = model.transform(df)
    sk = MLPClassifier(hidden_layer_sizes=(16,), max_iter=2000,
                       random_state=1).fit(X, y).predict(X)
    assert (col(out, "prediction") == y).mean() >= 0.95
    assert (sk == y).mean() >= 0.95
    np.testing.assert_allclose(col(out, "probability").sum(axis=1), 1.0,
                               atol=1e-6)


def test_mlp_in_pipeline_and_validation_errors(spark, tspark):
    X, y = _xor(n=120)

    def case(s, M):
        df = s.createDataFrame({"features": X, "label": y})
        out = M.base.Pipeline(stages=[M.ann.MultilayerPerceptronClassifier(
            layers=[2, 6, 2], maxIter=150, seed=5)]).fit(df).transform(df)
        errors = []
        for layers in ([2], [3, 4, 2], [2, 4, 3]):
            with pytest.raises(ValueError) as info:
                M.ann.MultilayerPerceptronClassifier(layers=layers).fit(df)
            errors.append(str(info.value))
        return out.columns, errors
    r, t = run_both(spark, tspark, case)
    assert t == r and "prediction" in t[0]


# ---------------------------------------------------------------------------
# CountVectorizer, Word2Vec
# ---------------------------------------------------------------------------

DOCS = ["the cat sat on the mat", "the dog sat on the log",
        "cats and dogs and cats"]


def test_count_vectorizer_vs_sklearn(spark, tspark):
    from sklearn.feature_extraction.text import CountVectorizer as SkCV

    def case(s, M):
        df = s.createDataFrame({"text": DOCS})
        toks = M.feat.Tokenizer(inputCol="text", outputCol="toks") \
            .transform(df)
        model = M.feat.CountVectorizer(inputCol="toks",
                                       outputCol="counts").fit(toks)
        return model.getOrDefault("vocabulary"), col(model.transform(toks),
                                                     "counts")
    r, t = run_both(spark, tspark, case)
    assert t[0] == r[0] and t[0][0] == "the"
    np.testing.assert_array_equal(t[1], r[1])
    sk = SkCV(token_pattern=r"\S+").fit(DOCS)
    mat = sk.transform(DOCS).toarray()
    for j, w in enumerate(t[0]):
        np.testing.assert_array_equal(t[1][:, j], mat[:, sk.vocabulary_[w]])


def test_count_vectorizer_mindf_binary(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({"text": ["a a b", "a c", "a d", "b b c"]})
        toks = M.feat.Tokenizer(inputCol="text", outputCol="t").transform(df)
        out = []
        for kw in ({"minDF": 2, "binary": True}, {"minTF": 2.0},
                   {"minDF": 0.5, "vocabSize": 2}):
            m = M.feat.CountVectorizer(inputCol="t", outputCol="v",
                                       **kw).fit(toks)
            out.append((m.getOrDefault("vocabulary"),
                        col(m.transform(toks), "v").tolist()))
        return out
    r, t = run_both(spark, tspark, case)
    assert t == r and t[0][0] == ["a", "b", "c"]


def _w2v_corpus(seed=5, n=150):
    rng = np.random.default_rng(seed)
    animals, tools = ["cat", "dog", "cow"], ["hammer", "wrench", "drill"]
    docs = []
    for _ in range(n):
        a = rng.choice(animals, 3, replace=True)
        docs.append(" ".join(["the", a[0], "chased", "the", a[1], "and",
                              a[2]]))
        t = rng.choice(tools, 3, replace=True)
        docs.append(" ".join(["use", "the", t[0], "with", "the", t[1],
                              "and", t[2]]))
    return docs, animals, tools


def test_word2vec_clusters_contexts(tspark):
    docs, animals, tools = _w2v_corpus()
    toks = PORT.feat.Tokenizer(inputCol="text", outputCol="toks").transform(
        tspark.createDataFrame({"text": docs}))
    model = PORT.feat.Word2Vec(inputCol="toks", outputCol="vec",
                               vectorSize=16, minCount=2, maxIter=3,
                               seed=2).fit(toks)
    syn = model.findSynonyms("cat", 2)
    assert {w for w, _ in syn} <= set(animals) | {"chased"}, syn
    assert len(model.transform(toks).collect()[0]["vec"]) == 16
    words = {r["word"] for r in model.getVectors(tspark).collect()}
    assert set(animals) | set(tools) <= words


def test_word2vec_deterministic_under_seed(tspark):
    toks = PORT.feat.Tokenizer(inputCol="text", outputCol="t").transform(
        tspark.createDataFrame({"text": ["a b c d e"] * 30}))
    m1, m2, m3 = (PORT.feat.Word2Vec(inputCol="t", outputCol="v",
                                     vectorSize=8, minCount=1,
                                     seed=s).fit(toks) for s in (9, 9, 10))
    np.testing.assert_array_equal(arr(m1.getOrDefault("vectors")),
                                  arr(m2.getOrDefault("vectors")))
    assert not np.array_equal(arr(m1.getOrDefault("vectors")),
                              arr(m3.getOrDefault("vectors")))


def test_word2vec_from_reference_initial_state(spark, tspark):
    """The port trained from the JAX package's W_in and its per-epoch
    negative draws (``jax.random.categorical`` on the same keys): the
    embeddings within 1e-4 (float32), the vocabulary and the document
    vectors' synonyms equal."""
    docs, _a, _t = _w2v_corpus(seed=8, n=30)
    kw = dict(inputCol="toks", outputCol="vec", vectorSize=8, minCount=2,
              maxIter=1, seed=4, negative=3, stepSize=0.025)
    rtoks = REF.feat.Tokenizer(inputCol="text", outputCol="toks").transform(
        spark.createDataFrame({"text": docs}))
    rm = REF.feat.Word2Vec(**kw).fit(rtoks)
    ttoks = PORT.feat.Tokenizer(inputCol="text", outputCol="toks").transform(
        tspark.createDataFrame({"text": docs}))
    est = PORT.feat.Word2Vec(**kw)
    prep = est._prepare(ttoks)
    assert prep["vocab"] == rm.getOrDefault("vocabulary")
    V, P = len(prep["vocab"]), int(prep["centers"].shape[0])
    key = jax.random.PRNGKey(4)
    key, k1 = jax.random.split(key)
    w_in = np.asarray(jax.random.uniform(k1, (V, 8), jnp.float32,
                                         -0.5 / 8, 0.5 / 8))
    keys = jax.random.split(key, prep["epochs"])
    logits = jnp.asarray(np.log(arr(prep["neg_probs"])))

    def negatives(e):
        return np.asarray(jax.random.categorical(keys[e], logits,
                                                 shape=(P, 3)))
    tm = est._train(prep, {"w_in": w_in, "negatives": negatives})
    close(tm.getOrDefault("vectors"), rm.getOrDefault("vectors"), F32_TOL)
    assert [w for w, _ in tm.findSynonyms("cat", 3)] == \
        [w for w, _ in rm.findSynonyms("cat", 3)]
    close(col(tm.transform(ttoks), "vec"), col(rm.transform(rtoks), "vec"),
          F32_TOL)


# ---------------------------------------------------------------------------
# stat
# ---------------------------------------------------------------------------

def test_correlation_pearson_vs_numpy(spark, tspark):
    rng = np.random.default_rng(7)
    X = rng.normal(0, 1, (200, 4))
    X[:, 1] = 2 * X[:, 0] + rng.normal(0, 0.1, 200)

    def case(s, M):
        rows = M.stat.Correlation.corr(s.createDataFrame({"features": X}),
                                       "features").collect()
        return np.array([r[0] for r in rows]), rows[0].__fields__
    r, t = run_both(spark, tspark, case)
    close(t[0], r[0])
    assert list(t[1]) == list(r[1]) == ["pearson(features)"]
    np.testing.assert_allclose(t[0], np.corrcoef(X, rowvar=False),
                               atol=1e-12)


def test_correlation_spearman_vs_scipy(spark, tspark):
    from scipy.stats import spearmanr
    rng = np.random.default_rng(8)
    X = rng.normal(0, 1, (150, 3))
    X[:, 2] = np.exp(X[:, 0])
    X[:10, 1] = 0.5                                  # ties

    def case(s, M):
        rows = M.stat.Correlation.corr(s.createDataFrame({"features": X}),
                                       "features", "spearman").collect()
        return np.array([r[0] for r in rows])
    r, t = run_both(spark, tspark, case)
    close(t, r)
    np.testing.assert_allclose(t, spearmanr(X).statistic, atol=1e-12)
    with pytest.raises(ValueError):
        PORT.stat.Correlation.corr(tspark.createDataFrame({"features": X}),
                                   "features", "kendall")


def test_chisquare_vs_scipy(spark, tspark):
    from scipy.stats import chi2_contingency
    rng = np.random.default_rng(9)
    n = 500
    y = rng.integers(0, 2, n).astype(np.float64)
    f0 = np.where(rng.uniform(size=n) < 0.3 + 0.4 * y, 1.0, 0.0)
    f1 = rng.integers(0, 3, n).astype(np.float64)
    X = np.stack([f0, f1], axis=1)

    def case(s, M):
        row, = M.stat.ChiSquareTest.test(
            s.createDataFrame({"features": X, "label": y}), "features",
            "label").collect()
        return (np.array(row["pValues"]), list(row["degreesOfFreedom"]),
                np.array(row["statistics"]))
    r, t = run_both(spark, tspark, case)
    close(t[0], r[0])
    assert t[1] == r[1] == [1, 2]
    close(t[2], r[2])
    for j in range(2):
        vals = np.unique(X[:, j])
        obs = np.zeros((len(vals), 2))
        np.add.at(obs, (np.searchsorted(vals, X[:, j]), y.astype(int)), 1)
        ref = chi2_contingency(obs, correction=False)
        assert t[2][j] == pytest.approx(ref.statistic, rel=1e-10)
        assert t[0][j] == pytest.approx(ref.pvalue, abs=1e-10)


# ---------------------------------------------------------------------------
# FPGrowth
# ---------------------------------------------------------------------------

TRANSACTIONS = [["bread", "milk"], ["bread", "diapers", "beer", "eggs"],
                ["milk", "diapers", "beer", "cola"],
                ["bread", "milk", "diapers", "beer"],
                ["bread", "milk", "diapers", "cola"]]


def _brute_itemsets(transactions, min_count, max_len=4):
    items = sorted({i for t in transactions for i in t})
    out = {}
    for k in range(1, max_len + 1):
        for combo in itertools.combinations(items, k):
            sup = sum(1 for t in transactions if set(combo) <= set(t))
            if sup >= min_count:
                out[combo] = sup
    return out


def test_fpgrowth_vs_bruteforce(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({"items": ["\x00".join(t)
                                          for t in TRANSACTIONS]})
        model = M.fpm.FPGrowth(itemsCol="items", minSupport=0.6,
                               minConfidence=0.7).fit(df)
        return ([tuple(r) for r in model.freqItemsets(s).collect()],
                [tuple(r) for r in model.associationRules(s).collect()])
    r, t = run_both(spark, tspark, case)
    assert t == r
    got = {tuple(items.split("\x00")): f for items, f in t[0]}
    assert got == _brute_itemsets(TRANSACTIONS, min_count=3)
    assert all(rule[2] >= 0.7 for rule in t[1])


def test_fpgrowth_transform_predicts_consequents(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({"items": [
            "a\x00b", "a\x00b", "a\x00b", "a\x00b\x00c", "a\x00c"]})
        model = M.fpm.FPGrowth(itemsCol="items", minSupport=0.4,
                               minConfidence=0.6).fit(df)
        return [r["prediction"] for r in model.transform(
            s.createDataFrame({"items": ["a", "b", "a\x00b"]})).collect()]
    r, t = run_both(spark, tspark, case)
    assert t == r
    assert "b" in (t[0] or "").split("\x00")
    assert "b" not in (t[2] or "").split("\x00")


def test_fpgrowth_association_rules_confidence_filter(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({"items": ["x\x00y"] * 8 + ["x"] * 2})
        m = M.fpm.FPGrowth(itemsCol="items", minSupport=0.1,
                           minConfidence=0.9).fit(df)
        return {(r["antecedent"], r["consequent"]): r["confidence"]
                for r in m.associationRules(s).collect()}
    r, t = run_both(spark, tspark, case)
    assert t == r and ("y", "x") in t and ("x", "y") not in t


# ---------------------------------------------------------------------------
# GaussianMixture, isotonic, AFT, LDA
# ---------------------------------------------------------------------------

def _gmm_data():
    rng = np.random.default_rng(4)
    return np.vstack([rng.normal([-3, 0], [0.5, 0.5], (150, 2)),
                      rng.normal([3, 1], [0.7, 0.3], (150, 2))])


def test_gaussian_mixture_vs_sklearn(tspark):
    from sklearn.mixture import GaussianMixture as SkGMM
    X = _gmm_data()
    df = tspark.createDataFrame({"features": X})
    model = PORT.clu.GaussianMixture(k=2, maxIter=80, seed=3).fit(df)
    out = model.transform(df)
    ours = col(out, "prediction")
    skp = SkGMM(2, random_state=0).fit(X).predict(X)
    assert max((ours == skp).mean(), (ours == 1 - skp).mean()) >= 0.98
    mu = arr(model.getOrDefault("means"))
    mu = mu[np.argsort(mu[:, 0])]
    np.testing.assert_allclose(mu[0], [-3, 0], atol=0.2)
    np.testing.assert_allclose(mu[1], [3, 1], atol=0.2)
    np.testing.assert_allclose(col(out, "probability").sum(axis=1), 1.0,
                               atol=1e-9)


def test_gaussian_mixture_from_reference_initial_state(spark, tspark):
    """The port's EM from the JAX package's initial state (rows chosen by
    ``jax.random.choice``): weights, means, covariances, the final
    log-likelihood and the probabilities within 1e-10."""
    X = _gmm_data()
    rm = REF.clu.GaussianMixture(k=2, maxIter=30, seed=3).fit(
        spark.createDataFrame({"features": X}))
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(3), len(X), (2,),
                                       replace=False))
    var0 = X.var(axis=0).mean() + 1e-6
    state = {"w": np.full(2, 0.5), "mu": X[idx],
             "cov": np.tile((var0 * np.eye(2))[None], (2, 1, 1))}
    tdf = tspark.createDataFrame({"features": X})
    est = PORT.clu.GaussianMixture(k=2, maxIter=30, seed=3)
    Xt, _b, _n = PORT.base.extract_matrix(tdf, "features")
    tm = est._train(Xt, state)
    for key in ("weights", "means", "covs"):
        close(tm.getOrDefault(key), rm.getOrDefault(key))
    close(tm.getOrDefault("logLikelihood"), rm.getOrDefault("logLikelihood"))
    rout = rm.transform(spark.createDataFrame({"features": X}))
    tout = tm.transform(tdf)
    close(col(tout, "probability"), col(rout, "probability"))
    np.testing.assert_array_equal(col(tout, "prediction"),
                                  col(rout, "prediction"))
    assert len(tm.gaussians) == 2


def test_isotonic_vs_sklearn(spark, tspark):
    from sklearn.isotonic import IsotonicRegression as SkIso
    rng = np.random.default_rng(6)
    x = np.sort(rng.uniform(0, 10, 120))
    y = np.log1p(x) + rng.normal(0, 0.15, 120)
    w = rng.uniform(0.5, 2.0, 120)

    def case(s, M):
        df = s.createDataFrame({"features": x[:, None], "label": y, "w": w})
        m = M.reg.IsotonicRegression().fit(df)
        mw = M.reg.IsotonicRegression(weightCol="w").fit(df)
        return (arr(m.getOrDefault("boundaries")),
                arr(m.getOrDefault("predictions")),
                col(m.transform(df), "prediction"),
                col(mw.transform(df), "prediction"))
    r, t = run_both(spark, tspark, case)
    for a, b in zip(t, r):
        close(a, b)
    np.testing.assert_allclose(
        t[2], SkIso(out_of_bounds="clip").fit(x, y).predict(x), atol=1e-9)


def test_isotonic_decreasing(spark, tspark):
    x = np.arange(10, dtype=np.float64)
    y = -x + np.array([0.5, -0.5] * 5)

    def case(s, M):
        df = s.createDataFrame({"features": x[:, None], "label": y})
        return col(M.reg.IsotonicRegression(isotonic=False).fit(df)
                   .transform(df), "prediction")
    r, t = run_both(spark, tspark, case)
    close(t, r)
    assert np.all(np.diff(t) <= 1e-12)


def _aft_data(n=600):
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (n, 1))
    t = np.exp(1.0 + 0.8 * x[:, 0] + 0.5 * np.log(rng.exponential(1.0, n)))
    cens = rng.exponential(np.e ** 2.2, n)
    return {"features": x, "label": np.minimum(t, cens),
            "censor": (t <= cens).astype(np.float64)}


def test_aft_survival_recovers_scale(spark, tspark):
    data = _aft_data()

    def case(s, M):
        df = s.createDataFrame(data)
        m = M.reg.AFTSurvivalRegression(maxIter=800).fit(df)
        return (arr(m.getOrDefault("coefficients")),
                m.getOrDefault("intercept"), m.getOrDefault("scale"),
                col(m.transform(df), "prediction"))
    r, t = run_both(spark, tspark, case)
    for a, b in zip(t, r):
        close(a, b, tol=1e-9)
    assert t[0][0] == pytest.approx(0.8, abs=0.15)
    assert t[1] == pytest.approx(1.0, abs=0.2)
    assert t[2] == pytest.approx(0.5, abs=0.15)


def test_isotonic_ties_pool_like_sklearn(spark, tspark):
    from sklearn.isotonic import IsotonicRegression as SkIso
    x = np.array([1.0, 1.0, 2.0, 2.0, 3.0])
    y = np.array([0.0, 1.0, 2.0, 0.0, 3.0])

    def case(s, M):
        df = s.createDataFrame({"features": x[:, None], "label": y})
        return col(M.reg.IsotonicRegression().fit(df).transform(df),
                   "prediction")
    r, t = run_both(spark, tspark, case)
    close(t, r)
    np.testing.assert_allclose(
        t, SkIso(out_of_bounds="clip").fit(x, y).predict(x), atol=1e-9)


def test_aft_rejects_nonpositive_labels(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({
            "features": np.ones((3, 1)), "label": np.array([1.0, 0.0, 2.0]),
            "censor": np.ones(3)})
        with pytest.raises(ValueError, match="positive") as info:
            M.reg.AFTSurvivalRegression().fit(df)
        return str(info.value)
    r, t = run_both(spark, tspark, case)
    assert t == r


def _lda_corpus(n=120, V=20, seed=12):
    rng = np.random.default_rng(seed)
    C = np.zeros((n, V))
    for i in range(n):
        np.add.at(C[i], rng.integers(0, 10, 30) + 10 * (i % 2), 1.0)
    return C, np.arange(n) % 2


def test_lda_recovers_topics(tspark):
    C, truth = _lda_corpus()
    df = tspark.createDataFrame({"features": C})
    model = PORT.clu.LDA(k=2, maxIter=40, seed=5).fit(df)
    mass_low = model.topicsMatrix()[:10].sum(axis=0)
    assert mass_low.max() > 0.9 and mass_low.min() < 0.1, mass_low
    low = int(np.argmax(mass_low))
    assert set(model.describeTopics(5)[low][1]) <= set(range(10))
    dist = col(model.transform(df), "topicDistribution")
    np.testing.assert_allclose(dist.sum(axis=1), 1.0, atol=1e-9)
    assert ((dist[:, low] > 0.5) == (truth == 0)).mean() >= 0.95


def test_lda_from_reference_initial_state(spark, tspark):
    """The port's variational EM from the JAX package's
    ``jax.random.gamma`` draw of lambda: topics and document
    distributions within 1e-10."""
    C, _truth = _lda_corpus(n=40)
    kw = dict(k=2, maxIter=10, seed=5)
    rm = REF.clu.LDA(**kw).fit(spark.createDataFrame({"features": C}))
    lam0 = np.asarray(jax.random.gamma(jax.random.PRNGKey(5), 100.0,
                                       (2, C.shape[1]))) / 100.0 \
        * (C.sum() / (2 * C.shape[1]) + 1.0)
    tdf = tspark.createDataFrame({"features": C})
    Ct, _b, _n = PORT.base.extract_matrix(tdf, "features")
    tm = PORT.clu.LDA(**kw)._train(Ct, {"lam": lam0})
    close(tm.getOrDefault("topics"), rm.getOrDefault("topics"))
    close(tm.topicsMatrix(), rm.topicsMatrix())
    for (tj, ti, tw), (rj, ri, rw) in zip(tm.describeTopics(4),
                                          rm.describeTopics(4)):
        assert (tj, ti) == (rj, ri)
        close(tw, rw)
    close(col(tm.transform(tdf), "topicDistribution"),
          col(rm.transform(spark.createDataFrame({"features": C})),
              "topicDistribution"))


def test_standard_gamma_draws_have_gamma_moments():
    """The LDA initializer's Marsaglia–Tsang draws: mean and variance of
    Gamma(100, 1) within 1% on 200,000 draws, reproducible per seed."""
    from spark_tpu_torch.ml.clustering import _standard_gamma
    g = torch.Generator().manual_seed(1)
    a = _standard_gamma(100.0, (400, 500), g, "cpu")
    assert abs(float(a.mean()) - 100.0) < 1.0
    assert abs(float(a.var()) - 100.0) < 3.0
    b = _standard_gamma(100.0, (400, 500), torch.Generator().manual_seed(1),
                        "cpu")
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the feature-stage wave
# ---------------------------------------------------------------------------

def test_idf_vs_sklearn(spark, tspark):
    from sklearn.feature_extraction.text import TfidfTransformer
    C = np.array([[3.0, 0, 1], [2, 0, 0], [3, 0, 2], [4, 0, 3]])

    def case(s, M):
        df = s.createDataFrame({"tf": C})
        m = M.feat.IDF(inputCol="tf", outputCol="tfidf").fit(df)
        m2 = M.feat.IDF(inputCol="tf", outputCol="x", minDocFreq=4).fit(df)
        return (arr(m.getOrDefault("idf")), col(m.transform(df), "tfidf"),
                arr(m2.getOrDefault("idf")))
    r, t = run_both(spark, tspark, case)
    for a, b in zip(t, r):
        close(a, b)
    exp = TfidfTransformer(norm=None, smooth_idf=True, sublinear_tf=False) \
        .fit_transform(C).toarray() - C
    np.testing.assert_allclose(t[1], exp, atol=1e-12)


def test_normalizer_and_maxabs(spark, tspark):
    from sklearn.preprocessing import MaxAbsScaler as SkMA, normalize
    X = np.random.default_rng(3).normal(0, 3, (40, 4))

    def case(s, M):
        df = s.createDataFrame({"features": X})
        out = [col(M.feat.Normalizer(inputCol="features", outputCol="n",
                                     p=p).transform(df), "n")
               for p in (2.0, 1.0, float("inf"), 3.0)]
        m = M.feat.MaxAbsScaler(inputCol="features", outputCol="s").fit(df)
        return out + [col(m.transform(df), "s")]
    r, t = run_both(spark, tspark, case)
    for a, b in zip(t, r):
        close(a, b)
    np.testing.assert_allclose(t[0], normalize(X, "l2"), atol=1e-12)
    np.testing.assert_allclose(t[1], normalize(X, "l1"), atol=1e-12)
    np.testing.assert_allclose(t[4], SkMA().fit_transform(X), atol=1e-12)


def test_stopwords_and_ngram(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({"text": ["the quick brown fox",
                                         "I saw the saw", None]})
        toks = M.feat.Tokenizer(inputCol="text", outputCol="t").transform(df)
        outs = [M.feat.StopWordsRemover(inputCol="t", outputCol="f"),
                M.feat.StopWordsRemover(inputCol="t", outputCol="f",
                                        stopWords=["fox", "The"],
                                        caseSensitive=True),
                M.feat.NGram(inputCol="t", outputCol="f", n=2),
                M.feat.NGram(inputCol="t", outputCol="f", n=3)]
        return [[r["f"] for r in o.transform(toks).collect()] for o in outs]
    r, t = run_both(spark, tspark, case)
    assert t == r
    assert t[0][0].split("\x00") == ["quick", "brown", "fox"]
    assert t[2][0] == "the quick\x00quick brown\x00brown fox"


def test_quantile_discretizer(spark, tspark):
    x = np.random.default_rng(2).normal(0, 5, 100)

    def case(s, M):
        df = s.createDataFrame({"v": x})
        buck = M.feat.QuantileDiscretizer(inputCol="v", outputCol="b",
                                          numBuckets=4).fit(df)
        return buck.getOrDefault("splits"), col(buck.transform(df), "b")
    r, t = run_both(spark, tspark, case)
    assert t[0] == r[0]
    np.testing.assert_array_equal(t[1], r[1])
    assert np.bincount(t[1].astype(int)).min() >= 20


def test_imputer_mean_median(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({
            "a": np.array([1.0, np.nan, 3.0, np.nan, 8.0]),
            "b": np.array([10.0, 20.0, np.nan, 40.0, 5.0]),
            "c": np.array([1.0, -1.0, 2.0, 5.0, -1.0])})
        out = []
        for kw in ({"strategy": "mean"}, {"strategy": "median"}):
            m = M.feat.Imputer(inputCols=["a", "b"],
                               outputCols=["ai", "bi"], **kw).fit(df)
            o = m.transform(df)
            out.append((m.getOrDefault("surrogates"), col(o, "ai"),
                        col(o, "bi")))
        sentinel = M.feat.Imputer(inputCols=["c"], outputCols=["ci"],
                                  missingValue=-1.0, strategy="median") \
            .fit(df)
        out.append(col(sentinel.transform(df), "ci"))
        return out
    r, t = run_both(spark, tspark, case)
    for (ts, ta, tb), (rs, ra, rb) in zip(t[:2], r[:2]):
        assert ts.keys() == rs.keys()
        close(list(ts.values()), list(rs.values()))
        close(ta, ra)
        close(tb, rb)
    close(t[2], r[2])
    assert list(t[0][1]) == [1.0, 4.0, 3.0, 4.0, 8.0]


def test_polynomial_expansion_vs_sklearn(spark, tspark):
    from sklearn.preprocessing import PolynomialFeatures
    X = np.random.default_rng(5).normal(0, 1, (20, 3))

    def case(s, M):
        return col(M.feat.PolynomialExpansion(
            inputCol="features", outputCol="p", degree=3).transform(
            s.createDataFrame({"features": X})), "p")
    r, t = run_both(spark, tspark, case)
    close(t, r)
    exp = PolynomialFeatures(3, include_bias=False).fit_transform(X)
    np.testing.assert_allclose(np.sort(t, axis=1), np.sort(exp, axis=1),
                               atol=1e-12)


def test_elementwise_product_and_slicer(spark, tspark):
    X = np.arange(12, dtype=np.float64).reshape(4, 3)

    def case(s, M):
        df = s.createDataFrame({"features": X})
        e = M.feat.ElementwiseProduct(inputCol="features", outputCol="e",
                                      scalingVec=[2.0, 0.0, -1.0])
        sl = M.feat.VectorSlicer(inputCol="features", outputCol="s",
                                 indices=[2, 0])
        return col(e.transform(df), "e"), col(sl.transform(df), "s")
    r, t = run_both(spark, tspark, case)
    np.testing.assert_array_equal(t[0], r[0])
    np.testing.assert_array_equal(t[1], X[:, [2, 0]])
    np.testing.assert_array_equal(t[1], r[1])


def test_chisq_selector_keeps_dependent_features(spark, tspark):
    rng = np.random.default_rng(11)
    n = 400
    y = rng.integers(0, 2, n).astype(np.float64)
    dep = np.where(rng.uniform(size=n) < 0.2 + 0.6 * y, 1.0, 0.0)
    X = np.stack([rng.integers(0, 2, n).astype(np.float64), dep,
                  rng.integers(0, 3, n).astype(np.float64)], axis=1)

    def case(s, M):
        df = s.createDataFrame({"features": X, "label": y})
        m = M.feat.ChiSqSelector(numTopFeatures=2, outputCol="sel").fit(df)
        return m.getOrDefault("selectedFeatures"), col(m.transform(df),
                                                       "sel")
    r, t = run_both(spark, tspark, case)
    assert t[0] == r[0] and 1 in t[0]
    np.testing.assert_array_equal(t[1], r[1])


def test_rformula_numeric_string_interaction(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({
            "y": np.array([1.0, 2.0, 3.0, 4.0]),
            "a": np.array([10.0, 20.0, 30.0, 40.0]),
            "b": np.array([2.0, 3.0, 4.0, 5.0]),
            "g": ["x", "y", "x", "z"]})
        rows = M.feat.RFormula(formula="y ~ a + g + a:b").fit(df) \
            .transform(df).collect()
        return (np.array([r["features"] for r in rows]),
                [r["label"] for r in rows])
    r, t = run_both(spark, tspark, case)
    np.testing.assert_array_equal(t[0], r[0])
    assert t[1] == r[1] == [1.0, 2.0, 3.0, 4.0]
    np.testing.assert_array_equal(t[0][:, -1], [20, 60, 120, 200])


def test_rformula_dot_minus_and_string_label(spark, tspark):
    def case(s, M):
        df = s.createDataFrame({
            "cls": ["p", "q", "p", "p"],
            "u": np.array([1.0, 2.0, 3.0, 4.0]),
            "v": np.array([5.0, 6.0, 7.0, 8.0]),
            "w": np.array([9.0, 9.0, 9.0, 9.0])})
        model = M.feat.RFormula(formula="cls ~ . - w - 1").fit(df)
        rows = model.transform(df).collect()
        return (np.array([r["features"] for r in rows]),
                [r["label"] for r in rows],
                model.getOrDefault("hasIntercept"))
    r, t = run_both(spark, tspark, case)
    np.testing.assert_array_equal(t[0], r[0])
    assert t[0].shape == (4, 2)
    assert t[1] == r[1] == [0.0, 1.0, 0.0, 0.0] and t[2] is r[2] is False


def test_rformula_transform_without_label_and_rejections(spark, tspark):
    def case(s, M):
        train = s.createDataFrame({
            "y": np.array([1.0, 2.0]), "a": np.array([3.0, 4.0]),
            "g": ["u", "v"]})
        model = M.feat.RFormula(formula="y ~ a + g").fit(train)
        test = s.createDataFrame({"a": np.array([5.0]), "g": ["u"]})
        out = model.transform(test)
        with pytest.raises(Exception, match="interaction") as info:
            M.feat.RFormula(formula="y ~ g:a").fit(train)
        with pytest.raises(Exception, match="label ~"):
            M.feat.RFormula(formula="y").fit(train)
        m2 = M.feat.RFormula(formula="y ~ a + a").fit(train)
        return (out.columns, [list(r["features"]) for r in out.collect()],
                type(info.value).__name__,
                len(m2.transform(train).collect()[0]["features"]))
    r, t = run_both(spark, tspark, case)
    assert t == r and "label" not in t[0] and len(t[1][0]) == 2
    assert t[3] == 1
