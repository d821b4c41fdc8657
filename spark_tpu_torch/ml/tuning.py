"""Model selection (`ml/tuning/` analog): grids, cross-validation.

The port of ``spark_tpu/ml/tuning.py``, host code as there: the folds
and splits come from numpy's ``default_rng(seed)``, so one seed gives the
same folds in both packages."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .base import Estimator, Model, Param

__all__ = ["ParamGridBuilder", "CrossValidator", "CrossValidatorModel",
           "TrainValidationSplit", "TrainValidationSplitModel"]


class ParamGridBuilder:
    def __init__(self):
        self._grid: Dict[str, List] = {}

    def addGrid(self, param, values) -> "ParamGridBuilder":
        name = param.name if isinstance(param, Param) else str(param)
        self._grid[name] = list(values)
        return self

    def build(self) -> List[Dict[str, object]]:
        import itertools
        keys = list(self._grid)
        out = []
        for combo in itertools.product(*[self._grid[k] for k in keys]):
            out.append(dict(zip(keys, combo)))
        return out or [{}]


def _rows(df):
    """The executed rows (tuples) and column names."""
    batch = df._execute()
    return batch.to_pylist(), list(batch.names)


def _split_df(df, fraction: float, seed: int):
    """Deterministic row split via a hash of the row index."""
    rows, names = _rows(df)
    n = len(rows)
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < fraction
    a = [r for r, m in zip(rows, mask) if m]
    b = [r for r, m in zip(rows, mask) if not m]
    sa = df.session.createDataFrame(a or rows[:1], names)
    sb = df.session.createDataFrame(b or rows[:1], names)
    return sa, sb


class CrossValidator(Estimator):
    estimator = Param("estimator", "", None)
    estimatorParamMaps = Param("estimatorParamMaps", "", None)
    evaluator = Param("evaluator", "", None)
    numFolds = Param("numFolds", "", 3)
    seed = Param("seed", "", 42)

    def _fit(self, df):
        est = self.getOrDefault("estimator")
        grid = self.getOrDefault("estimatorParamMaps")
        ev = self.getOrDefault("evaluator")
        k = self.getOrDefault("numFolds")

        rows, names = _rows(df)
        n = len(rows)
        rng = np.random.default_rng(self.getOrDefault("seed"))
        fold = rng.integers(0, k, n)

        metrics = np.zeros(len(grid))
        for f in range(k):
            train = [r for r, ff in zip(rows, fold) if ff != f]
            test = [r for r, ff in zip(rows, fold) if ff == f]
            if not train or not test:
                continue
            tr = df.session.createDataFrame(train, names)
            te = df.session.createDataFrame(test, names)
            for gi, params in enumerate(grid):
                model = est.fit(tr, params)
                metrics[gi] += ev.evaluate(model.transform(te))
        metrics /= k
        best_i = int(np.argmax(metrics) if ev.isLargerBetter()
                     else np.argmin(metrics))
        best = est.fit(df, grid[best_i])
        return CrossValidatorModel(bestModel=best,
                                   avgMetrics=metrics.tolist())


class CrossValidatorModel(Model):
    bestModel = Param("bestModel", "", None)
    avgMetrics = Param("avgMetrics", "", None)

    def transform(self, df):
        return self.getOrDefault("bestModel").transform(df)


class TrainValidationSplit(Estimator):
    estimator = Param("estimator", "", None)
    estimatorParamMaps = Param("estimatorParamMaps", "", None)
    evaluator = Param("evaluator", "", None)
    trainRatio = Param("trainRatio", "", 0.75)
    seed = Param("seed", "", 42)

    def _fit(self, df):
        est = self.getOrDefault("estimator")
        grid = self.getOrDefault("estimatorParamMaps")
        ev = self.getOrDefault("evaluator")
        train, test = _split_df(df, self.getOrDefault("trainRatio"),
                                self.getOrDefault("seed"))
        metrics = []
        for params in grid:
            model = est.fit(train, params)
            metrics.append(ev.evaluate(model.transform(test)))
        arr = np.asarray(metrics)
        best_i = int(np.argmax(arr) if ev.isLargerBetter()
                     else np.argmin(arr))
        best = est.fit(df, grid[best_i])
        return TrainValidationSplitModel(bestModel=best,
                                         validationMetrics=metrics)


class TrainValidationSplitModel(Model):
    bestModel = Param("bestModel", "", None)
    validationMetrics = Param("validationMetrics", "", None)

    def transform(self, df):
        return self.getOrDefault("bestModel").transform(df)
