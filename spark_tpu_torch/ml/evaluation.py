"""Evaluators (`ml/evaluation/` analog).

The port of ``spark_tpu/ml/evaluation.py``: host numpy over the label and
prediction columns, copied from the device once per evaluation."""

from __future__ import annotations

import numpy as np

from .base import Params, Param
from ..expressions import AnalysisException

__all__ = ["RegressionEvaluator", "BinaryClassificationEvaluator",
           "MulticlassClassificationEvaluator"]


def _cols(df, *names):
    from .base import execute_batch
    batch, n = execute_batch(df)
    return [batch.column(c).data[:n].cpu().numpy().astype(np.float64)
            for c in names]


def _average_ranks(s: np.ndarray) -> np.ndarray:
    """1-based ranks of ``s`` with ties given their run's mean rank: the
    reference's per-value loop (``ranks[s == v].mean()`` for each value
    held more than once), by runs of the stable sort.  A run's mean of
    consecutive integers is exact in float64, so the ranks are the same
    bits."""
    order = np.argsort(s, kind="stable")
    ranks = np.empty(len(s), np.float64)
    ranks[order] = np.arange(1, len(s) + 1)
    sv = s[order]
    starts = np.flatnonzero(np.r_[True, sv[1:] != sv[:-1]])
    ends = np.r_[starts[1:], len(s)]
    tied = ends - starts > 1
    for a, b in zip(starts[tied].tolist(), ends[tied].tolist()):
        ranks[order[a:b]] = (a + 1 + b) / 2.0
    return ranks


class RegressionEvaluator(Params):
    labelCol = Param("labelCol", "", "label")
    predictionCol = Param("predictionCol", "", "prediction")
    metricName = Param("metricName", "rmse|mse|mae|r2", "rmse")

    def evaluate(self, df) -> float:
        y, p = _cols(df, self.getOrDefault("labelCol"),
                     self.getOrDefault("predictionCol"))
        m = self.getOrDefault("metricName")
        if m == "rmse":
            return float(np.sqrt(np.mean((y - p) ** 2)))
        if m == "mse":
            return float(np.mean((y - p) ** 2))
        if m == "mae":
            return float(np.mean(np.abs(y - p)))
        if m == "r2":
            ss = np.sum((y - y.mean()) ** 2)
            return 1.0 - float(np.sum((y - p) ** 2) / max(ss, 1e-30))
        raise AnalysisException(f"unknown metric {m}")

    def isLargerBetter(self) -> bool:
        return self.getOrDefault("metricName") == "r2"


class BinaryClassificationEvaluator(Params):
    labelCol = Param("labelCol", "", "label")
    rawPredictionCol = Param("rawPredictionCol", "", "prediction")
    metricName = Param("metricName", "areaUnderROC|areaUnderPR", "areaUnderROC")

    def evaluate(self, df) -> float:
        y, s = _cols(df, self.getOrDefault("labelCol"),
                     self.getOrDefault("rawPredictionCol"))
        pos = y > 0
        npos, nneg = int(pos.sum()), int((~pos).sum())
        if npos == 0 or nneg == 0:
            return 0.5
        ranks = _average_ranks(s)
        auc = (ranks[pos].sum() - npos * (npos + 1) / 2) / (npos * nneg)
        if self.getOrDefault("metricName") == "areaUnderROC":
            return float(auc)
        # areaUnderPR via interpolated PR curve
        desc = np.argsort(-s, kind="stable")
        tp = np.cumsum(pos[desc])
        prec = tp / np.arange(1, len(s) + 1)
        rec = tp / npos
        return float(np.trapezoid(prec, rec))

    def isLargerBetter(self) -> bool:
        return True


class MulticlassClassificationEvaluator(Params):
    labelCol = Param("labelCol", "", "label")
    predictionCol = Param("predictionCol", "", "prediction")
    metricName = Param("metricName", "accuracy|f1|weightedPrecision|weightedRecall", "f1")

    def evaluate(self, df) -> float:
        y, p = _cols(df, self.getOrDefault("labelCol"),
                     self.getOrDefault("predictionCol"))
        m = self.getOrDefault("metricName")
        if m == "accuracy":
            return float(np.mean(y == p))
        classes = np.unique(y)
        f1s, precs, recs, weights = [], [], [], []
        for c in classes:
            tp = float(np.sum((p == c) & (y == c)))
            fp = float(np.sum((p == c) & (y != c)))
            fn = float(np.sum((p != c) & (y == c)))
            prec = tp / (tp + fp) if tp + fp else 0.0
            rec = tp / (tp + fn) if tp + fn else 0.0
            f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
            w = float(np.mean(y == c))
            f1s.append(f1 * w)
            precs.append(prec * w)
            recs.append(rec * w)
        if m == "f1":
            return float(sum(f1s))
        if m == "weightedPrecision":
            return float(sum(precs))
        if m == "weightedRecall":
            return float(sum(recs))
        raise AnalysisException(f"unknown metric {m}")

    def isLargerBetter(self) -> bool:
        return True
