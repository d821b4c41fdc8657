"""Classification (`ml/classification/` analog).

The port of ``spark_tpu/ml/classification.py``.  Training runs as
full-batch torch computations on the session's device: the reference's
`RDD.treeAggregate` gradient reductions become one reduction per
iteration.  LogisticRegression uses IRLS (Newton) for binary problems —
the same optimizer family Spark's LBFGS approximates — and softmax GD for
multinomial; each ``jax.lax.scan`` step is a Python loop of torch ops
with no host read inside.  The tree ensembles grow on the host
(``tree.py``), as in the reference."""

from __future__ import annotations

import numpy as np
import torch

from .. import types as T
from ..columnar import device_tensor
from .base import (
    Estimator, Model, Param, append_prediction, extract_column,
    extract_matrix, host_features, host_xy, with_ones,
)

__all__ = ["LogisticRegression", "LogisticRegressionModel", "LinearSVC",
           "LinearSVCModel", "NaiveBayes", "NaiveBayesModel",
           "DecisionTreeClassifier", "DecisionTreeClassificationModel",
           "RandomForestClassifier", "RandomForestClassificationModel",
           "GBTClassifier", "GBTClassificationModel"]



def _classes(y: torch.Tensor) -> np.ndarray:
    """The sorted distinct labels (a handful, read to the host)."""
    return torch.unique(y).cpu().numpy()


def irls(X: torch.Tensor, yb: torch.Tensor, lam: float, n: int,
         iters: int) -> torch.Tensor:
    """``iters`` Newton steps of L2-regularized logistic regression from
    w = 0: ``w -= solve(X' diag(p(1-p)) X + λnI, X'(p - y) + λnw)``, the
    weights clipped below at 1e-10."""
    d = X.shape[1]
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    w = torch.zeros(d, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        p = torch.sigmoid(X @ w)
        wgt = (p * (1 - p)).clamp_min(1e-10)
        g = X.T @ (p - yb) + lam * n * w
        h = (X * wgt[:, None]).T @ X + lam * n * eye
        w = w - torch.linalg.solve(h, g)
    return w


class LogisticRegression(Estimator):
    maxIter = Param("maxIter", "max iterations", 25)
    regParam = Param("regParam", "L2 regularization", 0.0)
    tol = Param("tol", "convergence tolerance", 1e-8)
    fitIntercept = Param("fitIntercept", "fit intercept", True)
    family = Param("family", "auto|binomial|multinomial", "auto")

    def _fit(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        y = extract_column(batch, self.getOrDefault("labelCol"), n)
        classes = _classes(y)
        k = len(classes)
        lam = self.getOrDefault("regParam")
        fit_b = self.getOrDefault("fitIntercept")
        if fit_b:
            X = with_ones(X)

        family = self.getOrDefault("family")
        binary = (family == "binomial") or (family == "auto" and k <= 2)
        common = dict(featuresCol=self.getOrDefault("featuresCol"),
                      predictionCol=self.getOrDefault("predictionCol"),
                      classes=classes.tolist())

        if binary:
            yb = (y == float(classes[-1])).to(torch.float64) if k == 2 \
                else torch.zeros_like(y)
            w = irls(X, yb, lam, n, self.getOrDefault("maxIter"))
            return LogisticRegressionModel(
                coefficients=w[:-1] if fit_b else w,
                intercept=float(w[-1]) if fit_b else 0.0,
                binary=True, **common)

        # multinomial: softmax full-batch gradient descent
        y_idx = torch.searchsorted(
            torch.from_numpy(classes).to(y.device).to(y.dtype), y)
        onehot = torch.nn.functional.one_hot(y_idx, k).to(torch.float64)
        lr = 1.0 / max(float(X.abs().max()) ** 2, 1.0)
        W = torch.zeros((X.shape[1], k), dtype=torch.float64,
                        device=X.device)
        for _ in range(self.getOrDefault("maxIter") * 10):
            p = torch.softmax(X @ W, dim=1)
            g = X.T @ (p - onehot) / n + lam * W
            W = W - lr * n * 0.1 * g
        if fit_b:
            weights, intercept = W[:-1], W[-1]
        else:
            weights = W
            intercept = torch.zeros(k, dtype=torch.float64, device=X.device)
        return LogisticRegressionModel(coefficients=weights,
                                       intercept=intercept, binary=False,
                                       **common)


class LogisticRegressionModel(Model):
    coefficients = Param("coefficients", "", None)
    intercept = Param("intercept", "", None)
    classes = Param("classes", "", None)
    binary = Param("binary", "", True)
    probabilityCol = Param("probabilityCol", "", "probability")

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        w = device_tensor(self.getOrDefault("coefficients"), X.device,
                          torch.float64)
        classes = np.asarray(self.getOrDefault("classes"), np.float64)
        if self.getOrDefault("binary"):
            p = torch.sigmoid(X @ w + self.getOrDefault("intercept"))
            hi = float(classes[-1]) if len(classes) == 2 else 1.0
            lo = float(classes[0]) if len(classes) else 0.0
            pred = torch.where(
                p > 0.5, torch.tensor(hi, dtype=torch.float64,
                                      device=X.device),
                torch.tensor(lo, dtype=torch.float64, device=X.device))
            prob = torch.stack([1 - p, p], dim=1)
        else:
            b = device_tensor(self.getOrDefault("intercept"), X.device,
                              torch.float64)
            prob = torch.softmax(X @ w + b, dim=1)
            pred = torch.from_numpy(classes).to(X.device)[
                prob.argmax(dim=1)]
        out = append_prediction(df, batch, n, pred,
                                self.getOrDefault("predictionCol"), T.float64)
        return append_prediction(out, out._plan.batch, n, prob,
                                 self.getOrDefault("probabilityCol"),
                                 T.ArrayType(T.float64))


class LinearSVC(Estimator):
    maxIter = Param("maxIter", "max iterations", 100)
    regParam = Param("regParam", "L2 reg", 0.01)

    def _fit(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        y = extract_column(batch, self.getOrDefault("labelCol"), n)
        ypm = (y > 0).to(torch.float64) * 2.0 - 1.0
        Xb = with_ones(X)
        lam = self.getOrDefault("regParam")
        w = torch.zeros(Xb.shape[1], dtype=torch.float64, device=X.device)
        for i in range(self.getOrDefault("maxIter")):
            margin = ypm * (Xb @ w)
            active = (margin < 1).to(torch.float64)
            g = -(Xb * (ypm * active)[:, None]).sum(dim=0) / n + lam * w
            w = w - (1.0 / (lam * (i + 1) + 1.0)) * g
        return LinearSVCModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"),
            coefficients=w[:-1], intercept=float(w[-1]))


class LinearSVCModel(Model):
    coefficients = Param("coefficients", "", None)
    intercept = Param("intercept", "", None)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        w = device_tensor(self.getOrDefault("coefficients"), X.device,
                          torch.float64)
        raw = X @ w + self.getOrDefault("intercept")
        return append_prediction(df, batch, n, (raw > 0).to(torch.float64),
                                 self.getOrDefault("predictionCol"), T.float64)


class NaiveBayes(Estimator):
    smoothing = Param("smoothing", "laplace smoothing", 1.0)

    def _fit(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        y = extract_column(batch, self.getOrDefault("labelCol"), n)
        classes = _classes(y)
        a = self.getOrDefault("smoothing")
        pri, like = [], []
        for c in classes.tolist():
            rows = X[y == c]
            pri.append(np.log(len(rows) / n))
            tot = rows.sum(dim=0) + a
            like.append(torch.log(tot / tot.sum()))
        return NaiveBayesModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"),
            classes=classes.tolist(),
            logPrior=torch.tensor(pri, dtype=torch.float64, device=X.device),
            logLikelihood=torch.stack(like))


class NaiveBayesModel(Model):
    classes = Param("classes", "", None)
    logPrior = Param("logPrior", "", None)
    logLikelihood = Param("logLikelihood", "", None)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        like = device_tensor(self.getOrDefault("logLikelihood"),
                             X.device, torch.float64)
        prior = device_tensor(self.getOrDefault("logPrior"), X.device,
                              torch.float64)
        scores = X @ like.T + prior
        classes = torch.tensor(self.getOrDefault("classes"),
                               dtype=torch.float64, device=X.device)
        return append_prediction(df, batch, n, classes[scores.argmax(dim=1)],
                                 self.getOrDefault("predictionCol"), T.float64)


class DecisionTreeClassifier(Estimator):
    """Gini-impurity tree (`ml/classification/DecisionTreeClassifier.scala`
    over the shared `tree.py` grower)."""

    maxDepth = Param("maxDepth", "max depth", 5)
    minInstancesPerNode = Param("minInstancesPerNode", "", 1)

    def _fit(self, df):
        from .tree import grow_tree
        X, y = host_xy(df, self)
        tree = grow_tree(X, y, self.getOrDefault("maxDepth"),
                         self.getOrDefault("minInstancesPerNode"),
                         impurity="gini")
        return DecisionTreeClassificationModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"), tree=tree)


class DecisionTreeClassificationModel(Model):
    tree = Param("tree", "", None)

    def transform(self, df):
        from .tree import cached_flat, predict_flat
        X, batch, n = host_features(self, df)
        pred = predict_flat(cached_flat(self), X)
        return append_prediction(df, batch, n, pred.astype(np.float64),
                                 self.getOrDefault("predictionCol"),
                                 T.float64)


class RandomForestClassifier(Estimator):
    """Majority-vote forest of gini trees (`RandomForest.scala:82`)."""

    maxDepth = Param("maxDepth", "max depth", 5)
    minInstancesPerNode = Param("minInstancesPerNode", "", 1)
    numTrees = Param("numTrees", "ensemble size", 20)
    subsamplingRate = Param("subsamplingRate", "bootstrap fraction", 1.0)
    featureSubsetStrategy = Param(
        "featureSubsetStrategy", "all|sqrt|onethird", "sqrt")
    seed = Param("seed", "", 42)

    def _fit(self, df):
        from .tree import fit_forest
        X, y = host_xy(df, self)
        trees = fit_forest(
            X, y, "gini", self.getOrDefault("numTrees"),
            self.getOrDefault("maxDepth"),
            self.getOrDefault("minInstancesPerNode"),
            self.getOrDefault("subsamplingRate"),
            self.getOrDefault("featureSubsetStrategy"),
            self.getOrDefault("seed"))
        return RandomForestClassificationModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"), trees=trees)


class RandomForestClassificationModel(Model):
    trees = Param("trees", "", None)

    def transform(self, df):
        from .tree import cached_flats, predict_forest
        X, batch, n = host_features(self, df)
        votes = predict_forest(cached_flats(self), X)
        # vectorized per-row majority over the tree axis (no per-row
        # Python loop, exact for ANY label values)
        vals, inv = np.unique(votes, return_inverse=True)
        inv = inv.reshape(votes.shape)
        n_rows, k = votes.shape[1], len(vals)
        flat = inv + np.arange(n_rows)[None, :] * k
        counts = np.bincount(flat.ravel(), minlength=n_rows * k)
        pred = vals[counts.reshape(n_rows, k).argmax(axis=1)]
        return append_prediction(df, batch, n, pred.astype(np.float64),
                                 self.getOrDefault("predictionCol"),
                                 T.float64)


class GBTClassifier(Estimator):
    """Binary gradient-boosted trees with logistic loss
    (`GBTClassifier.scala`): trees fit the gradient residual
    y - sigmoid(F), prediction thresholds sigmoid(F) at 0.5."""

    maxDepth = Param("maxDepth", "max depth", 3)
    maxIter = Param("maxIter", "boosting rounds", 20)
    stepSize = Param("stepSize", "shrinkage", 0.1)
    minInstancesPerNode = Param("minInstancesPerNode", "", 1)

    def _fit(self, df):
        from .tree import flatten_tree, grow_tree, predict_flat
        X, y = host_xy(df, self)
        bad = set(np.unique(y)) - {0.0, 1.0}
        if bad:
            from ..expressions import AnalysisException
            raise AnalysisException(
                f"GBTClassifier requires binary labels in {{0, 1}}; "
                f"found {sorted(bad)}")
        step = self.getOrDefault("stepSize")
        p0 = float(np.clip(y.mean(), 1e-6, 1 - 1e-6))
        f0 = float(np.log(p0 / (1 - p0)))
        F = np.full(len(y), f0)
        trees = []
        for _ in range(self.getOrDefault("maxIter")):
            resid = y - 1.0 / (1.0 + np.exp(-F))
            tree = grow_tree(X, resid, self.getOrDefault("maxDepth"),
                             self.getOrDefault("minInstancesPerNode"),
                             impurity="variance")
            trees.append(tree)
            F = F + step * predict_flat(flatten_tree(tree), X)
        return GBTClassificationModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"),
            trees=trees, init=f0, stepSize=step)


class GBTClassificationModel(Model):
    trees = Param("trees", "", None)
    init = Param("init", "", 0.0)
    stepSize = Param("stepSize", "", 0.1)

    def transform(self, df):
        from .tree import cached_flats, predict_forest
        X, batch, n = host_features(self, df)
        F = self.getOrDefault("init") + self.getOrDefault("stepSize") \
            * predict_forest(cached_flats(self), X).sum(axis=0)
        pred = (1.0 / (1.0 + np.exp(-F)) > 0.5).astype(np.float64)
        return append_prediction(df, batch, n, pred,
                                 self.getOrDefault("predictionCol"),
                                 T.float64)
