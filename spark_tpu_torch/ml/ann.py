"""Multilayer perceptron classifier (`ml/ann/Layer.scala`,
`ml/classification/MultilayerPerceptronClassifier.scala:132` analog).

The port of ``spark_tpu/ml/ann.py``: the same sigmoid-hidden /
softmax-output network trained as one full-batch Adam loop on the
session's device, float32 as in the reference, the gradient from
``torch.autograd``.  The Glorot-uniform initial weights are drawn from a
``torch.Generator`` seeded by ``seed`` (``_initial_state``); ``_train``
trains from a given state.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import types as T
from ..columnar import device_tensor
from .base import (
    Adam, Estimator, Model, Param, append_prediction,
    extract_column, extract_matrix,
)

__all__ = ["MultilayerPerceptronClassifier",
           "MultilayerPerceptronClassificationModel"]


def _forward(params, X):
    """Sigmoid hidden layers + linear output logits (the reference's
    FunctionalLayer(sigmoid) stack with a SoftmaxLayerWithCrossEntropyLoss
    head — softmax itself folds into the loss)."""
    h = X
    for i, (W, b) in enumerate(params):
        z = h @ W + b
        h = torch.sigmoid(z) if i < len(params) - 1 else z
    return h


class MultilayerPerceptronClassifier(Estimator):
    layers = Param("layers", "sizes incl. input and output", None)
    maxIter = Param("maxIter", "max iterations", 200)
    stepSize = Param("stepSize", "Adam learning rate", 0.03)
    seed = Param("seed", "init seed", 11)
    tol = Param("tol", "convergence tolerance (reserved)", 1e-6)
    blockSize = Param("blockSize", "ignored: full-batch on device", 128)

    def _fit(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        y = extract_column(batch, self.getOrDefault("labelCol"), n)
        classes = torch.unique(y)
        sizes: List[int] = list(self.getOrDefault("layers") or [])
        if len(sizes) < 2:
            raise ValueError("layers must list >=2 sizes (input..output)")
        if sizes[0] != X.shape[1]:
            raise ValueError(
                f"layers[0]={sizes[0]} != feature dim {X.shape[1]}")
        if sizes[-1] != len(classes):
            # width mismatch would leak softmax mass onto phantom output
            # units (reference requires layers.last == numClasses too)
            raise ValueError(
                f"layers[-1]={sizes[-1]} != {len(classes)} label classes")
        return self._train(X, y, classes, self._initial_state(X.device))

    def _initial_state(self, device) -> List:
        """Per layer (W, b): W ~ U(-s, s), s = sqrt(6 / (din + dout)),
        float32, from one generator seeded by ``seed``; b = 0."""
        sizes = list(self.getOrDefault("layers"))
        gen = torch.Generator(device=device)
        gen.manual_seed(int(self.getOrDefault("seed")))
        params = []
        for din, dout in zip(sizes[:-1], sizes[1:]):
            scale = float(np.sqrt(6.0 / (din + dout)))
            W = torch.rand((din, dout), generator=gen, dtype=torch.float32,
                           device=device) * (2 * scale) - scale
            params.append((W, torch.zeros(dout, dtype=torch.float32,
                                          device=device)))
        return params

    def _train(self, X, y, classes, state
               ) -> "MultilayerPerceptronClassificationModel":
        sizes = list(self.getOrDefault("layers"))
        y_idx = torch.searchsorted(classes, y)
        of = torch.nn.functional.one_hot(y_idx, sizes[-1]) \
            .to(torch.float32)
        Xf = X.to(torch.float32)
        flat = [device_tensor(t, X.device, torch.float32)
                .clone().requires_grad_(True) for pair in state
                for t in pair]
        opt = Adam(flat, self.getOrDefault("stepSize"))
        losses = []
        for _ in range(self.getOrDefault("maxIter")):
            pairs = list(zip(flat[0::2], flat[1::2]))
            logits = _forward(pairs, Xf)
            loss = -(of * torch.log_softmax(logits, dim=1)).sum(dim=1).mean()
            grads = torch.autograd.grad(loss, flat)
            losses.append(loss.detach())
            flat = opt.step(flat, grads)
        history = torch.stack(losses).cpu().tolist() if losses else []
        return MultilayerPerceptronClassificationModel(
            featuresCol=self.getOrDefault("featuresCol"),
            predictionCol=self.getOrDefault("predictionCol"),
            weights=[(W.detach(), b.detach())
                     for W, b in zip(flat[0::2], flat[1::2])],
            classes=classes.cpu().tolist(), objectiveHistory=history)


class MultilayerPerceptronClassificationModel(Model):
    weights = Param("weights", "list of (W, b) per layer", None)
    classes = Param("classes", "sorted label values", None)
    probabilityCol = Param("probabilityCol", "", "probability")
    objectiveHistory = Param("objectiveHistory", "training loss curve", None)

    def transform(self, df):
        X, batch, n = extract_matrix(df, self.getOrDefault("featuresCol"))
        params = [(device_tensor(W, X.device, torch.float32),
                   device_tensor(b, X.device, torch.float32))
                  for W, b in self.getOrDefault("weights")]
        prob = torch.softmax(_forward(params, X.to(torch.float32)), dim=1) \
            .to(torch.float64)
        classes = torch.tensor(self.getOrDefault("classes"),
                               dtype=torch.float64, device=X.device)
        pred = classes[prob[:, :len(classes)].argmax(dim=1)]
        out = append_prediction(df, batch, n, pred,
                                self.getOrDefault("predictionCol"), T.float64)
        return append_prediction(out, out._plan.batch, n, prob,
                                 self.getOrDefault("probabilityCol"),
                                 T.ArrayType(T.float64))
