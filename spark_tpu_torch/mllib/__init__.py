"""Legacy RDD-based MLlib compat layer (``mllib/`` in the reference).

The port of ``spark_tpu/mllib/``.  The reference freezes this API
(RDD-based, `mllib/.../clustering/KMeans.scala` `train()` entry points) in
favor of DataFrame `ml/` pipelines; here the classic surface delegates to
the ``spark_tpu_torch.ml`` implementations.  Inputs are RDDs of feature
rows (lists/tuples/numpy) or LabeledPoint; outputs are the corresponding
ml models, trained on the active session's device (a session made here
follows the session's device policy: the card unless
``spark.torch.device`` says ``cpu``).
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np


class LabeledPoint:
    """(label, features) pair (`mllib/regression/LabeledPoint.scala`)."""

    __slots__ = ("label", "features")

    def __init__(self, label: float, features: Sequence[float]):
        self.label = float(label)
        self.features = np.asarray(features, dtype=np.float64)

    def __repr__(self):
        return f"LabeledPoint({self.label}, {self.features.tolist()})"


def _session():
    from ..sql.session import SparkSession
    return SparkSession.builder.getOrCreate()


def _features_df(rdd_or_rows, with_label: bool):
    rows = rdd_or_rows.collect() if hasattr(rdd_or_rows, "collect") \
        else list(rdd_or_rows)
    if not rows:
        raise ValueError("empty training data")
    feats: List[np.ndarray] = []
    labels: List[float] = []
    for r in rows:
        if isinstance(r, LabeledPoint):
            labels.append(r.label)
            feats.append(r.features)
        elif with_label:
            labels.append(float(r[0]))
            feats.append(np.asarray(r[1], dtype=np.float64))
        else:
            feats.append(np.asarray(r, dtype=np.float64))
    data = {"features": [list(map(float, f)) for f in feats]}
    if with_label:
        data["label"] = labels
    return _session().createDataFrame(data)


class KMeans:
    @staticmethod
    def train(rdd, k: int, maxIterations: int = 20, seed: int = 0):
        from ..ml.clustering import KMeans as MLKMeans
        df = _features_df(rdd, with_label=False)
        return MLKMeans(k=k, maxIter=maxIterations, seed=seed,
                        featuresCol="features").fit(df)


class LogisticRegressionWithLBFGS:
    @staticmethod
    def train(rdd, iterations: int = 100, regParam: float = 0.0):
        from ..ml.classification import LogisticRegression
        df = _features_df(rdd, with_label=True)
        return LogisticRegression(maxIter=iterations, regParam=regParam
                                  ).fit(df)


class LinearRegressionWithSGD:
    @staticmethod
    def train(rdd, iterations: int = 100, regParam: float = 0.0):
        from ..ml.regression import LinearRegression
        df = _features_df(rdd, with_label=True)
        return LinearRegression(maxIter=iterations, regParam=regParam
                                ).fit(df)


class NaiveBayes:
    @staticmethod
    def train(rdd, lambda_: float = 1.0):
        from ..ml.classification import NaiveBayes as MLNB
        df = _features_df(rdd, with_label=True)
        return MLNB(smoothing=lambda_).fit(df)
