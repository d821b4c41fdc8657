"""Regression (`ml/regression/` analog): normal equations on the device.

The port of ``spark_tpu/ml/regression.py``: linear regression is one
Gram matmul and a solve on the session's device, AFT an Adam loop under
``torch.autograd``; the trees grow on the host (``tree.py``) and the
isotonic pool-adjacent-violators merge is host code, as in the
reference."""

from __future__ import annotations

import numpy as np
import torch

from .. import types as T
from ..columnar import device_tensor
from .base import (
    Adam, Estimator, Model, Param, append_prediction, extract_column,
    extract_matrix, host_features, host_xy, to_numpy, with_ones,
)

__all__ = ["LinearRegression", "LinearRegressionModel",
           "DecisionTreeRegressor", "DecisionTreeRegressionModel",
           "RandomForestRegressor", "RandomForestRegressionModel",
           "GBTRegressor", "GBTRegressionModel",
           "IsotonicRegression", "IsotonicRegressionModel",
           "AFTSurvivalRegression", "AFTSurvivalRegressionModel"]



class LinearRegression(Estimator):
    regParam = Param("regParam", "L2 regularization", 0.0)
    elasticNetParam = Param("elasticNetParam", "L1 ratio (0 = ridge)", 0.0)
    fitIntercept = Param("fitIntercept", "fit intercept", True)
    maxIter = Param("maxIter", "iterations (L1 path)", 100)

    def _fit(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        y = extract_column(batch, self.getOrDefault("labelCol"), n)
        fit_b = self.getOrDefault("fitIntercept")
        if fit_b:
            X = with_ones(X)
        d = X.shape[1]
        lam = self.getOrDefault("regParam")
        # ridge normal equations: one X'X matmul + a tiny solve
        gram = X.T @ X + lam * n * torch.eye(d, dtype=X.dtype,
                                             device=X.device)
        w = torch.linalg.solve(gram, X.T @ y)
        resid = y - X @ w
        summary = {
            "rmse": float(torch.sqrt((resid ** 2).mean())),
            "r2": 1.0 - float((resid ** 2).sum()) / max(
                float(((y - y.mean()) ** 2).sum()), 1e-30),
        }
        return LinearRegressionModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"),
            coefficients=w[:-1] if fit_b else w,
            intercept=float(w[-1]) if fit_b else 0.0, summary=summary)


class LinearRegressionModel(Model):
    coefficients = Param("coefficients", "", None)
    intercept = Param("intercept", "", 0.0)
    summary = Param("summary", "training summary", None)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        w = device_tensor(self.getOrDefault("coefficients"), X.device,
                          torch.float64)
        return append_prediction(df, batch, n,
                                 X @ w + self.getOrDefault("intercept"),
                                 self.getOrDefault("predictionCol"), T.float64)


class DecisionTreeRegressor(Estimator):
    maxDepth = Param("maxDepth", "max depth", 5)
    minInstancesPerNode = Param("minInstancesPerNode", "", 1)

    def _fit(self, df):
        from .tree import grow_tree
        X, y = host_xy(df, self)
        tree = grow_tree(X, y, self.getOrDefault("maxDepth"),
                         self.getOrDefault("minInstancesPerNode"),
                         impurity="variance")
        return DecisionTreeRegressionModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"), tree=tree)


class DecisionTreeRegressionModel(Model):
    tree = Param("tree", "", None)

    def transform(self, df):
        from .tree import cached_flat, predict_flat
        X, batch, n = host_features(self, df)
        return append_prediction(df, batch, n,
                                 predict_flat(cached_flat(self), X),
                                 self.getOrDefault("predictionCol"), T.float64)


class RandomForestRegressor(Estimator):
    """Bootstrap-aggregated variance trees (`ml/tree/RandomForest.scala:82`
    re-based on the shared host tree grower)."""

    maxDepth = Param("maxDepth", "max depth", 5)
    minInstancesPerNode = Param("minInstancesPerNode", "", 1)
    numTrees = Param("numTrees", "ensemble size", 20)
    subsamplingRate = Param("subsamplingRate", "bootstrap fraction", 1.0)
    featureSubsetStrategy = Param(
        "featureSubsetStrategy", "all|sqrt|onethird", "onethird")
    seed = Param("seed", "", 42)

    def _fit(self, df):
        from .tree import fit_forest
        X, y = host_xy(df, self)
        trees = fit_forest(
            X, y, "variance", self.getOrDefault("numTrees"),
            self.getOrDefault("maxDepth"),
            self.getOrDefault("minInstancesPerNode"),
            self.getOrDefault("subsamplingRate"),
            self.getOrDefault("featureSubsetStrategy"),
            self.getOrDefault("seed"))
        return RandomForestRegressionModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"), trees=trees)


class RandomForestRegressionModel(Model):
    trees = Param("trees", "", None)

    def transform(self, df):
        from .tree import cached_flats, predict_forest
        X, batch, n = host_features(self, df)
        pred = predict_forest(cached_flats(self), X).mean(axis=0)
        return append_prediction(df, batch, n, pred,
                                 self.getOrDefault("predictionCol"), T.float64)


class GBTRegressor(Estimator):
    """Gradient-boosted variance trees on residuals
    (`ml/tree/GradientBoostedTrees.scala`, squared-error loss)."""

    maxDepth = Param("maxDepth", "max depth", 3)
    maxIter = Param("maxIter", "boosting rounds", 20)
    stepSize = Param("stepSize", "shrinkage", 0.1)
    minInstancesPerNode = Param("minInstancesPerNode", "", 1)

    def _fit(self, df):
        from .tree import flatten_tree, grow_tree, predict_flat
        X, y = host_xy(df, self)
        step = self.getOrDefault("stepSize")
        f0 = float(y.mean())
        pred = np.full(len(y), f0)
        trees = []
        for _ in range(self.getOrDefault("maxIter")):
            tree = grow_tree(X, y - pred, self.getOrDefault("maxDepth"),
                             self.getOrDefault("minInstancesPerNode"),
                             impurity="variance")
            trees.append(tree)
            pred = pred + step * predict_flat(flatten_tree(tree), X)
        return GBTRegressionModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"),
            trees=trees, init=f0, stepSize=step)


class GBTRegressionModel(Model):
    trees = Param("trees", "", None)
    init = Param("init", "", 0.0)
    stepSize = Param("stepSize", "", 0.1)

    def transform(self, df):
        from .tree import cached_flats, predict_forest
        X, batch, n = host_features(self, df)
        pred = self.getOrDefault("init") + self.getOrDefault("stepSize") \
            * predict_forest(cached_flats(self), X).sum(axis=0)
        return append_prediction(df, batch, n, pred,
                                 self.getOrDefault("predictionCol"), T.float64)


class IsotonicRegression(Estimator):
    """Pool-adjacent-violators isotonic fit
    (`ml/regression/IsotonicRegression.scala:163` analog).

    PAV is an inherently sequential merge of adjacent pools — like the
    reference (which runs parallel PAV per partition and a final host
    pass), the merge itself is host-side; prediction is a vectorized
    interpolation."""
    isotonic = Param("isotonic", "increasing (True) or decreasing", True)
    weightCol = Param("weightCol", "optional weight column", None)

    def _fit(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        x = to_numpy(X[:, 0])
        y = to_numpy(extract_column(batch, self.getOrDefault("labelCol"), n))
        wc = self.getOrDefault("weightCol")
        w = to_numpy(extract_column(batch, wc, n)) if wc else np.ones(n)
        inc = self.getOrDefault("isotonic")
        order = np.argsort(x, kind="stable")
        xs, ys, ws = x[order], y[order], w[order]
        # pool tied feature values first (weighted label mean, summed
        # weight) — Spark/sklearn semantics: predict(x) at a duplicated x
        # is the pooled average, not an interpolation between duplicates
        starts = np.flatnonzero(np.r_[True, xs[1:] != xs[:-1]])
        ends = np.r_[starts[1:], len(xs)]
        if len(starts) != len(xs):
            wsum = np.add.reduceat(ws, starts)
            safe = np.maximum(wsum, 1e-300)
            ysum = np.add.reduceat(ys * ws, starts)
            cnt = ends - starts
            ys = np.where(wsum > 0, ysum / safe,
                          np.add.reduceat(ys, starts) / cnt)
            xs = xs[starts]
            ws = wsum
        if not inc:
            ys = -ys
        # pool-adjacent-violators over the sorted sequence; each pool
        # keeps its x extent so prediction holds constant INSIDE a pool
        # and interpolates only BETWEEN pools (sklearn/reference
        # thresholds semantics)
        vals: list = []
        wts: list = []
        xmin: list = []
        xmax: list = []
        for xi, yi, wi in zip(xs, ys, ws):
            vals.append(yi)
            wts.append(wi)
            xmin.append(xi)
            xmax.append(xi)
            while len(vals) > 1 and vals[-2] > vals[-1]:
                wtot = wts[-1] + wts[-2]
                if wtot > 0:
                    vals[-2] = (vals[-1] * wts[-1]
                                + vals[-2] * wts[-2]) / wtot
                else:        # two zero-weight pools: plain average
                    vals[-2] = 0.5 * (vals[-1] + vals[-2])
                wts[-2] = wtot
                xmax[-2] = xmax[-1]
                vals.pop(); wts.pop(); xmin.pop(); xmax.pop()
        bx: list = []
        by: list = []
        for v, lo, hi in zip(vals, xmin, xmax):
            fv = v if inc else -v
            bx.append(lo)
            by.append(fv)
            if hi > lo:
                bx.append(hi)
                by.append(fv)
        return IsotonicRegressionModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"),
            boundaries=np.asarray(bx), predictions=np.asarray(by),
            isotonic=inc)


class IsotonicRegressionModel(Model):
    boundaries = Param("boundaries", "pool left boundaries (sorted x)",
                       None)
    predictions = Param("predictions", "pool fitted values", None)
    isotonic = Param("isotonic", "", True)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        x = to_numpy(X[:, 0])
        bx = np.asarray(self.getOrDefault("boundaries"), np.float64)
        by = np.asarray(self.getOrDefault("predictions"), np.float64)
        # piecewise-linear interpolation between pool boundaries, clamped
        # at the ends (reference predict() contract)
        pred = np.interp(x, bx, by) if len(bx) else np.zeros_like(x)
        return append_prediction(df, batch, n, pred,
                                 self.getOrDefault("predictionCol"),
                                 T.float64)


class AFTSurvivalRegression(Estimator):
    """Accelerated-failure-time survival regression with Weibull
    (log-extreme-value) noise (`ml/regression/AFTSurvivalRegression.scala:88`
    analog): censored log-likelihood maximized by one Adam loop over the
    full device batch, its gradient from ``torch.autograd`` (the
    reference uses per-partition gradient aggregation under LBFGS)."""
    censorCol = Param("censorCol", "1.0 = event occurred, 0.0 = censored",
                      "censor")
    maxIter = Param("maxIter", "Adam iterations", 500)
    stepSize = Param("stepSize", "Adam learning rate", 0.05)
    fitIntercept = Param("fitIntercept", "", True)

    def _fit(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        y = extract_column(batch, self.getOrDefault("labelCol"), n)
        c = extract_column(batch, self.getOrDefault("censorCol"), n)
        if bool((y <= 0).any()):
            # one log(0) residual would silently dominate the likelihood
            raise ValueError(
                "AFTSurvivalRegression requires strictly positive labels "
                "(survival times); found label <= 0")
        logy = torch.log(y)
        fit_b = self.getOrDefault("fitIntercept")
        if fit_b:
            X = with_ones(X)
        d = X.shape[1]
        event = c > 0.5

        def nll(params):
            beta, log_sigma = params[:d], params[d]
            eps = (logy - X @ beta) / torch.exp(log_sigma)
            # Weibull AFT: event → log pdf of extreme value, censored →
            # log survival  S(eps) = exp(-e^eps)
            log_pdf = eps - torch.exp(eps) - log_sigma
            log_surv = -torch.exp(eps)
            return -torch.where(event, log_pdf, log_surv).sum() / n

        params = [torch.zeros(d + 1, dtype=torch.float64, device=X.device,
                              requires_grad=True)]
        opt = Adam(params, self.getOrDefault("stepSize"))
        for _ in range(self.getOrDefault("maxIter")):
            grads = torch.autograd.grad(nll(params[0]), params)
            params = opt.step(params, grads)
        p = params[0].detach()
        return AFTSurvivalRegressionModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"),
            coefficients=p[:d - 1] if fit_b else p[:d],
            intercept=float(p[d - 1]) if fit_b else 0.0,
            scale=float(torch.exp(p[-1])))


class AFTSurvivalRegressionModel(Model):
    coefficients = Param("coefficients", "", None)
    intercept = Param("intercept", "", 0.0)
    scale = Param("scale", "Weibull scale sigma", 1.0)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        w = device_tensor(self.getOrDefault("coefficients"), X.device,
                          torch.float64)
        pred = torch.exp(X @ w + self.getOrDefault("intercept"))
        return append_prediction(df, batch, n, pred,
                                 self.getOrDefault("predictionCol"),
                                 T.float64)
