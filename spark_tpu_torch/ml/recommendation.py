"""ALS collaborative filtering (`ml/recommendation/ALS.scala` analog).

The port of ``spark_tpu/ml/recommendation.py``: alternating least squares
with per-entity normal equations, vectorized on the session's device —
outer products of the fixed side's factors are segment-summed per entity
(``index_add_``) and the k×k systems solved with one batched
``torch.linalg.solve``; no per-user Python loops.  The initial factors
come from numpy's ``default_rng(seed)``, as in the reference."""

from __future__ import annotations

import numpy as np
import torch

from .. import types as T
from ..columnar import device_tensor
from .base import (
    Estimator, Model, Param, append_prediction,
    execute_batch,
)

__all__ = ["ALS", "ALSModel"]


def _ids(batch, col: str, n: int) -> torch.Tensor:
    return batch.column(col).data[:n].to(torch.int64)


class ALS(Estimator):
    userCol = Param("userCol", "user id column", "user")
    itemCol = Param("itemCol", "item id column", "item")
    ratingCol = Param("ratingCol", "rating column", "rating")
    rank = Param("rank", "factor dimension", 10)
    maxIter = Param("maxIter", "alternations", 10)
    regParam = Param("regParam", "lambda", 0.1)
    seed = Param("seed", "rng seed", 0)

    def _fit(self, df):
        batch, n = execute_batch(df)
        u = _ids(batch, self.getOrDefault("userCol"), n)
        i = _ids(batch, self.getOrDefault("itemCol"), n)
        r = batch.column(self.getOrDefault("ratingCol")).data[:n] \
            .to(torch.float64)
        n_users = int(u.max()) + 1
        n_items = int(i.max()) + 1
        k = self.getOrDefault("rank")
        lam = self.getOrDefault("regParam")
        rng = np.random.default_rng(self.getOrDefault("seed"))
        dev = batch.device
        U = torch.from_numpy(rng.normal(0, 0.1, (n_users, k))).to(dev)
        V = torch.from_numpy(rng.normal(0, 0.1, (n_items, k))).to(dev)
        reg = lam * torch.eye(k, dtype=torch.float64, device=dev)[None]

        def solve_side(f, ids, n_ent):
            # A_e = seg_sum(f f') + λI ; b_e = seg_sum(r f)
            A = torch.zeros((n_ent, k, k), dtype=torch.float64, device=dev)
            A.index_add_(0, ids, f[:, :, None] * f[:, None, :])
            b = torch.zeros((n_ent, k), dtype=torch.float64, device=dev)
            b.index_add_(0, ids, f * r[:, None])
            return torch.linalg.solve(A + reg, b[:, :, None])[:, :, 0]

        for _ in range(self.getOrDefault("maxIter")):
            U = solve_side(V[i], u, n_users)
            V = solve_side(U[u], i, n_items)
        return ALSModel(userCol=self.getOrDefault("userCol"),
                        itemCol=self.getOrDefault("itemCol"),
                        predictionCol=self.getOrDefault("predictionCol"),
                        userFactors=U, itemFactors=V)


class ALSModel(Model):
    userCol = Param("userCol", "", "user")
    itemCol = Param("itemCol", "", "item")
    userFactors = Param("userFactors", "", None)
    itemFactors = Param("itemFactors", "", None)

    def transform(self, df):
        batch, n = execute_batch(df)
        u = _ids(batch, self.getOrDefault("userCol"), n)
        i = _ids(batch, self.getOrDefault("itemCol"), n)
        U = device_tensor(self.getOrDefault("userFactors"), batch.device,
                          torch.float64)
        V = device_tensor(self.getOrDefault("itemFactors"), batch.device,
                          torch.float64)
        pred = (U[u.clamp(0, len(U) - 1)] * V[i.clamp(0, len(V) - 1)]) \
            .sum(dim=1)
        pred = torch.where((u < len(U)) & (i < len(V)), pred,
                           torch.full_like(pred, float("nan")))
        return append_prediction(df, batch, n, pred,
                                 self.getOrDefault("predictionCol"), T.float64)

    def recommendForAllUsers(self, num: int):
        from ..sql.session import SparkSession
        U = device_tensor(self.getOrDefault("userFactors"), "cpu",
                          torch.float64).numpy()
        V = device_tensor(self.getOrDefault("itemFactors"), "cpu",
                          torch.float64).numpy()
        top = np.argsort(-(U @ V.T), axis=1)[:, :num]
        session = SparkSession.builder.getOrCreate()
        return session.createDataFrame(
            [(u, [float(x) for x in top[u].tolist()]) for u in range(len(U))],
            ["user", "recommendations"])
