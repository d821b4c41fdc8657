"""Clustering (`ml/clustering/` analog).

The port of ``spark_tpu/ml/clustering.py``.  KMeans runs Lloyd steps as
torch ops on the session's device (the distance matrix and the centre
sums are matmuls), from the reference's numpy starts, so one seed gives
the same starts in both packages.  GaussianMixture and LDA train on the
device from an initial state drawn with a ``torch.Generator`` seeded by
``seed`` (``_initial_state``, then ``_train`` from a given state);
``jax.scipy``'s digamma, logsumexp and triangular solve are
``torch.special`` / ``torch.linalg``'s.  BisectingKMeans is host numpy,
as in the reference."""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from .. import types as T
from ..columnar import device_tensor
from .base import (
    Estimator, Model, Param, append_prediction,
    extract_matrix, to_numpy,
)

__all__ = ["KMeans", "KMeansModel", "BisectingKMeans",
           "GaussianMixture", "GaussianMixtureModel",
           "LDA", "LDAModel"]


def _sq_dists(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """||x - c||^2 = |x|^2 - 2 x.c + |c|^2 for every (row, centre)."""
    return ((X * X).sum(dim=1)[:, None] - 2.0 * (X @ C.T)
            + (C * C).sum(dim=1)[None, :])


def lloyd(X: torch.Tensor, centers: torch.Tensor, iters: int
          ) -> torch.Tensor:
    """``iters`` Lloyd steps: assign each row to its nearest centre (the
    first on a tie), move each centre to its rows' mean (an empty cluster
    keeps its centre).  The sums are the reference's ``segment_sum`` as a
    one-hot matmul (n x k)' (n x d): ``index_add_`` would serialise n x d
    float64 atomics on k x d addresses, 4.2 times the fit's time on an
    H100 at 2^22 x 20, k = 10 (PERF.md, ``chip_smoke.py`` ``[ml]`` (c))."""
    k = centers.shape[0]
    for _ in range(iters):
        assign = _sq_dists(X, centers).argmin(dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype)
        sums = onehot.T @ X
        counts = onehot.sum(dim=0)
        centers = torch.where(counts[:, None] > 0,
                              sums / counts.clamp_min(1.0)[:, None],
                              centers)
    return centers


class KMeans(Estimator):
    k = Param("k", "clusters", 2)
    maxIter = Param("maxIter", "iterations", 20)
    seed = Param("seed", "rng seed", 42)
    tol = Param("tol", "center-shift tolerance", 1e-6)

    def _fit(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        k = self.getOrDefault("k")
        rng = np.random.default_rng(self.getOrDefault("seed"))
        init_idx = rng.choice(n, size=k, replace=False)
        centers0 = X[torch.from_numpy(init_idx).to(X.device)]
        centers = lloyd(X, centers0, self.getOrDefault("maxIter"))
        return KMeansModel(featuresCol=self.getOrDefault("featuresCol"),
                           predictionCol=self.getOrDefault("predictionCol"),
                           clusterCenters=centers)


class KMeansModel(Model):
    clusterCenters = Param("clusterCenters", "", None)

    def _centers(self, X):
        return device_tensor(self.getOrDefault("clusterCenters"),
                             X.device, torch.float64)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        assign = _sq_dists(X, self._centers(X)).argmin(dim=1)
        return append_prediction(df, batch, n, assign.to(torch.float64),
                                 self.getOrDefault("predictionCol"), T.float64)

    def computeCost(self, df):
        X, _, _ = extract_matrix(df, self.getOrDefault("featuresCol"))
        return float(_sq_dists(X, self._centers(X)).amin(dim=1).sum())


class BisectingKMeans(KMeans):
    """Bisecting variant: repeatedly split the largest cluster (host
    numpy, as in the reference)."""

    def _fit(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        k = self.getOrDefault("k")
        X_np = to_numpy(X)
        assign = np.zeros(n, np.int64)
        centers = [X_np.mean(axis=0)]
        rng = np.random.default_rng(self.getOrDefault("seed"))
        while len(centers) < k:
            sizes = np.bincount(assign, minlength=len(centers))
            target = int(sizes.argmax())
            rows = np.where(assign == target)[0]
            if len(rows) < 2:
                break
            sub = X_np[rows]
            # the reference draws a seed for a KMeans it never fits: the
            # draw is kept so the generator's stream stays the same
            int(rng.integers(1 << 30))
            c0 = sub[rng.choice(len(sub), 2, replace=False)]
            for _ in range(self.getOrDefault("maxIter")):
                d2 = ((sub[:, None, :] - c0[None, :, :]) ** 2).sum(-1)
                a = d2.argmin(1)
                for j in (0, 1):
                    if (a == j).any():
                        c0[j] = sub[a == j].mean(axis=0)
            new_id = len(centers)
            centers[target] = c0[0]
            centers.append(c0[1])
            assign[rows[a == 1]] = new_id
        return KMeansModel(featuresCol=self.getOrDefault("featuresCol"),
                           predictionCol=self.getOrDefault("predictionCol"),
                           clusterCenters=np.stack(centers))


def _gmm_log_density(X, mu_j, cov_j, reg):
    """log N(X | mu_j, cov_j) per row, via Cholesky — shared by fit and
    transform so the two can never compute different densities."""
    d = X.shape[1]
    L = torch.linalg.cholesky(cov_j + reg)
    sol = torch.linalg.solve_triangular(L, (X - mu_j).T, upper=False)
    maha = (sol ** 2).sum(dim=0)
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    return -0.5 * (d * math.log(2 * math.pi) + logdet + maha)


def _gmm_log_probs(X, w, mu, cov, reg):
    k = mu.shape[0]
    return torch.stack([_gmm_log_density(X, mu[j], cov[j], reg)
                        for j in range(k)], dim=1) + torch.log(w)


class GaussianMixture(Estimator):
    """Full-covariance Gaussian mixture via EM
    (`ml/clustering/GaussianMixture.scala:96` analog).

    The reference runs per-partition sufficient-statistics aggregation
    under an RDD treeAggregate per EM step; here each step is one batched
    E+M over the full device matrix (responsibility softmax → weighted
    moments), with no host read inside the loop."""
    k = Param("k", "number of components", 2)
    maxIter = Param("maxIter", "EM iterations", 100)
    tol = Param("tol", "reserved (fixed-iteration loop)", 1e-6)
    seed = Param("seed", "init seed", 13)
    probabilityCol = Param("probabilityCol", "", "probability")

    def _fit(self, df):
        X, _batch, _n = extract_matrix(df, self.getOrDefault("featuresCol"))
        return self._train(X, self._initial_state(X))

    def _initial_state(self, X) -> Dict[str, Any]:
        """Means on k distinct rows drawn by a generator seeded by
        ``seed``; a shared spherical covariance (the columns' mean
        population variance + 1e-6); equal weights."""
        n, d = X.shape
        k = self.getOrDefault("k")
        gen = torch.Generator(device=X.device)
        gen.manual_seed(int(self.getOrDefault("seed")))
        idx = torch.randperm(n, generator=gen, device=X.device)[:k]
        var0 = X.var(dim=0, correction=0).mean() + 1e-6
        eye = torch.eye(d, dtype=X.dtype, device=X.device)
        return {"w": torch.full((k,), 1.0 / k, dtype=X.dtype,
                                device=X.device),
                "mu": X[idx], "cov": (var0 * eye)[None].repeat(k, 1, 1)}

    def _train(self, X, state) -> "GaussianMixtureModel":
        n, d = X.shape
        dev = X.device
        w, mu, cov = (device_tensor(state[key], dev, torch.float64)
                      for key in ("w", "mu", "cov"))
        reg = 1e-6 * torch.eye(d, dtype=torch.float64, device=dev)
        ll = None
        for _ in range(self.getOrDefault("maxIter")):
            logp = _gmm_log_probs(X, w, mu, cov, reg)
            ll = torch.logsumexp(logp, dim=1)
            r = torch.exp(logp - ll[:, None])                  # (n, k)
            nk = r.sum(dim=0) + 1e-12
            mu = (r.T @ X) / nk[:, None]
            diff = X[:, None, :] - mu[None]                    # (n, k, d)
            cov = torch.einsum("nk,nki,nkj->kij", r, diff, diff) \
                / nk[:, None, None] + reg
            w = nk / n
        return GaussianMixtureModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"),
            probabilityCol=self.getOrDefault("probabilityCol"),
            weights=w, means=mu, covs=cov,
            logLikelihood=float(ll.sum()) if ll is not None else None)


class GaussianMixtureModel(Model):
    weights = Param("weights", "(k,) mixing weights", None)
    means = Param("means", "(k, d) component means", None)
    covs = Param("covs", "(k, d, d) covariances", None)
    probabilityCol = Param("probabilityCol", "", "probability")
    logLikelihood = Param("logLikelihood", "final training LL", None)

    @property
    def gaussians(self):
        means = to_numpy(self.getOrDefault("means"))
        covs = to_numpy(self.getOrDefault("covs"))
        return [(means[j], covs[j]) for j in range(len(means))]

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        w, mu, cov = (device_tensor(self.getOrDefault(key), X.device,
                                    torch.float64)
                      for key in ("weights", "means", "covs"))
        reg = 1e-6 * torch.eye(mu.shape[1], dtype=torch.float64,
                               device=X.device)
        prob = torch.softmax(_gmm_log_probs(X, w, mu, cov, reg), dim=1)
        out = append_prediction(df, batch, n,
                                prob.argmax(dim=1).to(torch.float64),
                                self.getOrDefault("predictionCol"),
                                T.float64)
        return append_prediction(out, out._plan.batch, n, prob,
                                 self.getOrDefault("probabilityCol"),
                                 T.ArrayType(T.float64))


def _lda_e_step(C, lam, alpha, inner, with_stats: bool = True):
    """Batch variational E-step (Hoffman online-LDA update, vectorized
    over all docs).

    Returns ``(gamma, expElogtheta, expElogbeta, phinorm)``; with
    ``with_stats=False`` the trailing sufficient-statistics recompute
    (the (n,V) phinorm matmul only the M-step needs) is skipped and the
    last three slots are None — the transform path's cheap form."""
    dg = torch.special.digamma
    expElogbeta = torch.exp(dg(lam) - dg(lam.sum(1, keepdim=True)))
    gamma = torch.ones((C.shape[0], lam.shape[0]), dtype=C.dtype,
                       device=C.device)
    for _ in range(inner):
        expElogtheta = torch.exp(dg(gamma) - dg(gamma.sum(1, keepdim=True)))
        phinorm = expElogtheta @ expElogbeta + 1e-100    # (n, V)
        gamma = alpha + expElogtheta * ((C / phinorm) @ expElogbeta.T)
    if not with_stats:
        return gamma, None, None, None
    expElogtheta = torch.exp(dg(gamma) - dg(gamma.sum(1, keepdim=True)))
    phinorm = expElogtheta @ expElogbeta + 1e-100
    return gamma, expElogtheta, expElogbeta, phinorm


def _standard_gamma(shape: float, size, gen: torch.Generator,
                    device) -> torch.Tensor:
    """Gamma(shape, 1) draws for ``shape >= 1`` by Marsaglia and Tsang's
    squeeze-rejection method, every draw from ``gen``."""
    d = shape - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    n = int(np.prod(size))
    out = torch.empty(n, dtype=torch.float64, device=device)
    todo = torch.arange(n, device=device)
    while len(todo):
        m = len(todo)
        x = torch.randn(m, generator=gen, dtype=torch.float64,
                        device=device)
        u = torch.rand(m, generator=gen, dtype=torch.float64,
                       device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        out[todo[ok]] = (d * v)[ok]
        todo = todo[~ok]
    return out.view(size)


class LDA(Estimator):
    """Latent Dirichlet Allocation by batch variational Bayes
    (`ml/clustering/LDA.scala:328` / mllib OnlineLDAOptimizer analog).

    The reference's online optimizer processes mini-batches of docs with
    per-batch digamma updates; the device form runs the SAME variational
    update over the full dense doc-term matrix per iteration — every step
    is a pair of (n,V)x(V,k) matmuls.  Input: a count-vector column
    (CountVectorizer output)."""
    k = Param("k", "number of topics", 10)
    maxIter = Param("maxIter", "variational EM iterations", 60)
    seed = Param("seed", "", 17)
    docConcentration = Param("docConcentration", "alpha (None = 1/k)",
                             None)
    topicConcentration = Param("topicConcentration", "eta (None = 1/k)",
                               None)
    subsamplingRate = Param("subsamplingRate", "ignored: full batch", 1.0)
    topicDistributionCol = Param("topicDistributionCol", "",
                                 "topicDistribution")

    def _fit(self, df):
        C, _batch, _n = extract_matrix(df, self.getOrDefault("featuresCol"))
        return self._train(C, self._initial_state(C))

    def _concentrations(self):
        k = self.getOrDefault("k")
        alpha_p = self.getOrDefault("docConcentration")
        eta_p = self.getOrDefault("topicConcentration")
        return (alpha_p if alpha_p is not None else 1.0 / k,
                eta_p if eta_p is not None else 1.0 / k)

    def _initial_state(self, C) -> Dict[str, Any]:
        """lambda ~ Gamma(100, 1/100) * (mean count per topic-term + 1),
        drawn by a generator seeded by ``seed``."""
        k, V = self.getOrDefault("k"), C.shape[1]
        gen = torch.Generator(device=C.device)
        gen.manual_seed(int(self.getOrDefault("seed")))
        g = _standard_gamma(100.0, (k, V), gen, C.device)
        return {"lam": g / 100.0 * (C.sum() / (k * V) + 1.0)}

    def _train(self, C, state) -> "LDAModel":
        alpha, eta = self._concentrations()
        lam = device_tensor(state["lam"], C.device, torch.float64)
        for _ in range(self.getOrDefault("maxIter")):
            _g, expElogtheta, expElogbeta, phinorm = _lda_e_step(
                C, lam, alpha, 20)
            lam = eta + expElogbeta * (expElogtheta.T @ (C / phinorm))
        return LDAModel(
            featuresCol=self.getOrDefault("featuresCol"),
            topicDistributionCol=self.getOrDefault("topicDistributionCol"),
            topics=lam, docConcentration=alpha)


class LDAModel(Model):
    topics = Param("topics", "(k, V) variational topic-word posterior",
                   None)
    docConcentration = Param("docConcentration", "", 0.1)
    topicDistributionCol = Param("topicDistributionCol", "",
                                 "topicDistribution")

    def topicsMatrix(self) -> np.ndarray:
        """(V, k) column-normalized topic-word matrix (reference shape)."""
        lam = to_numpy(self.getOrDefault("topics")).astype(np.float64)
        return (lam / lam.sum(axis=1, keepdims=True)).T

    def describeTopics(self, maxTermsPerTopic: int = 10):
        """[(topic, [term indices], [weights])] — `LDAModel.describeTopics`."""
        lam = to_numpy(self.getOrDefault("topics")).astype(np.float64)
        probs = lam / lam.sum(axis=1, keepdims=True)
        out = []
        for j in range(lam.shape[0]):
            idx = np.argsort(-probs[j])[:maxTermsPerTopic]
            out.append((j, idx.tolist(), probs[j][idx].tolist()))
        return out

    def transform(self, df):
        C, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        lam = device_tensor(self.getOrDefault("topics"), C.device,
                            torch.float64)
        gamma, _t, _b, _p = _lda_e_step(
            C, lam, self.getOrDefault("docConcentration"), 30,
            with_stats=False)
        dist = gamma / gamma.sum(dim=1, keepdim=True)
        return append_prediction(df, batch, n, dist,
                                 self.getOrDefault("topicDistributionCol"),
                                 T.ArrayType(T.float64))
