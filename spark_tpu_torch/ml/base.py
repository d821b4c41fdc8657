"""ML Pipeline API (`mllib/src/main/scala/org/apache/spark/ml/Pipeline.scala:96`,
`Estimator.scala:31`, `Transformer.scala:35`, `param/params.scala` analogs).

The port of ``spark_tpu/ml/base.py``.  Estimators fit DataFrames into
Models (Transformers); Pipelines chain them.  Training math runs as torch
ops on the session's device: the executed batch stays there
(``execute_batch``), ``extract_matrix`` compacts it there and hands back
a float64 tensor, and the fitted parameters of the device estimators are
tensors on that device too.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar import device_tensor
from ..expressions import AnalysisException

__all__ = ["Param", "Params", "Estimator", "Transformer", "Model",
           "Pipeline", "PipelineModel", "execute_batch", "column_matrix",
           "extract_matrix", "extract_column", "append_prediction",
           "with_ones", "host_features", "host_xy", "to_numpy", "Adam"]


class Param:
    def __init__(self, name: str, doc: str = "", default: Any = None):
        self.name = name
        self.doc = doc
        self.default = default


class Params:
    """Typed param plumbing: each subclass declares class-level Param
    objects; instances carry a value map.  getOrDefault/set/copy mirror the
    reference's `params.scala`."""

    def __init__(self, **kwargs):
        self._values: Dict[str, Any] = {}
        self.uid = f"{type(self).__name__}_{id(self):x}"
        for k, v in kwargs.items():
            self.set(k, v)

    @classmethod
    def _params(cls) -> Dict[str, Param]:
        out = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    out[k] = v
        return out

    def set(self, name: str, value: Any) -> "Params":
        if name not in self._params():
            raise AnalysisException(
                f"{type(self).__name__} has no param {name!r}; "
                f"available: {sorted(self._params())}")
        self._values[name] = value
        return self

    def getOrDefault(self, name: str) -> Any:
        if name in self._values:
            return self._values[name]
        return self._params()[name].default

    g = getOrDefault

    def copy(self, extra: Optional[Dict[str, Any]] = None) -> "Params":
        import copy as _c
        out = _c.copy(self)
        out._values = dict(self._values)
        for k, v in (extra or {}).items():
            out.set(k, v)
        return out

    def explainParams(self) -> str:
        lines = []
        for name, p in sorted(self._params().items()):
            cur = self.getOrDefault(name)
            lines.append(f"{name}: {p.doc} (default: {p.default}, "
                         f"current: {cur})")
        return "\n".join(lines)

    # Spark-style setX/getX sugar
    def __getattr__(self, item: str):
        if item.startswith("set") and len(item) > 3:
            pname = item[3].lower() + item[4:]
            if pname in self._params():
                def setter(value):
                    self.set(pname, value)
                    return self
                return setter
        if item.startswith("get") and len(item) > 3:
            pname = item[3].lower() + item[4:]
            if pname in self._params():
                return lambda: self.getOrDefault(pname)
        raise AttributeError(item)

    # -- persistence ------------------------------------------------------
    def _save_params(self, path: str, extra: Optional[dict] = None) -> None:
        os.makedirs(path, exist_ok=True)
        ok = {k: v for k, v in self._values.items() if _json_ok(v)}
        payload = {"class": type(self).__name__, "params": ok,
                   "dropped": sorted(set(self._values) - set(ok))}
        if extra:
            payload.update(extra)
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(payload, f, default=_np_default)

    def save(self, path: str) -> None:
        self._save_params(path)

    @classmethod
    def load(cls, path: str):
        """Rebuild from a saved metadata.json (MLReader analog).  Array
        params round-trip as lists; transform paths make tensors of them
        again."""
        with open(os.path.join(path, "metadata.json")) as f:
            payload = json.load(f)
        saved = payload.get("class")
        if saved and saved != cls.__name__:
            raise AnalysisException(
                f"{path} holds a {saved}, not a {cls.__name__}")
        dropped = payload.get("dropped") or []
        if dropped:
            raise AnalysisException(
                f"{saved or cls.__name__} at {path} was saved WITHOUT "
                f"non-JSON params {dropped}; it cannot be reconstructed "
                "by load() (save such models via pickle or refit)")
        return cls(**payload.get("params", {}))

    def write(self):
        return _Writer(self)


def _json_ok(v) -> bool:
    try:
        json.dumps(v, default=_np_default)
        return True
    except TypeError:
        return False


def _np_default(o):
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    raise TypeError(o)


class _Writer:
    def __init__(self, target):
        self._t = target
        self._overwrite = False

    def overwrite(self):
        self._overwrite = True
        return self

    def save(self, path: str):
        if os.path.exists(path) and not self._overwrite:
            raise AnalysisException(f"path {path} exists; use .overwrite()")
        self._t.save(path)


class Transformer(Params):
    def transform(self, df):
        raise NotImplementedError


class Estimator(Params):
    featuresCol = Param("featuresCol", "features column", "features")
    labelCol = Param("labelCol", "label column", "label")
    predictionCol = Param("predictionCol", "prediction column", "prediction")

    def fit(self, df, params: Optional[Dict[str, Any]] = None):
        est = self.copy(params) if params else self
        return est._fit(df)

    def _fit(self, df):
        raise NotImplementedError


class Model(Transformer):
    featuresCol = Param("featuresCol", "features column", "features")
    labelCol = Param("labelCol", "label column", "label")
    predictionCol = Param("predictionCol", "prediction column", "prediction")


class Pipeline(Estimator):
    stages = Param("stages", "pipeline stages", None)

    def _fit(self, df):
        stages = self.getOrDefault("stages") or []
        fitted: List[Transformer] = []
        cur = df
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
                fitted.append(model)
                if i < len(stages) - 1:
                    cur = model.transform(cur)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < len(stages) - 1:
                    cur = stage.transform(cur)
            else:
                raise AnalysisException(f"not a pipeline stage: {stage!r}")
        return PipelineModel(stages=fitted)


class PipelineModel(Model):
    stages = Param("stages", "fitted stages", None)

    def transform(self, df):
        cur = df
        for stage in self.getOrDefault("stages") or []:
            cur = stage.transform(cur)
        return cur


# ---------------------------------------------------------------------------
# matrix extraction helpers (DataFrame <-> device tensors)
# ---------------------------------------------------------------------------

def to_numpy(x) -> np.ndarray:
    """A parameter as a host numpy array (one copy from the device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def execute_batch(df) -> Tuple[Any, int]:
    """Execute ``df``; return (the compacted batch on the session's
    device, its live row count).  The rows stay where they were computed
    (``QueryExecution.keep_on_device``); a lane that hands back a host
    batch whatever that flag says (the mesh lane, the out-of-core runners)
    has its result copied to the session's device.  The one host read is
    the count."""
    from ..kernels import compact
    from ..sql.planner import QueryExecution
    hit = df._cache_hit()
    if hit is not None:
        batch = compact(hit.to_device(df.session.device))
    else:
        qe = QueryExecution(df.session, df._plan)
        qe.keep_on_device = True
        batch = qe.execute()
        if batch.device.type != df.session.device.type:
            batch = batch.to_device(df.session.device)
    return batch, int(batch.num_rows())


def column_matrix(batch, name: str, n: int) -> torch.Tensor:
    """A column's first n rows as a float64 (n, d) tensor: a vector column
    read whole, every one of its ``d`` slots, a NaN value included (an
    array plane's NaN is only its element sentinel to ``collect``); a
    scalar column one slot wide."""
    data = batch.column(name).data[:n].to(torch.float64)
    return data[:, None] if data.dim() == 1 else data


def extract_matrix(df, features_col: str):
    """Execute df; return (float64 (n, d) tensor on the session's device,
    the executed batch, n)."""
    batch, n = execute_batch(df)
    return column_matrix(batch, features_col, n), batch, n


def extract_column(batch, name: str, n: int) -> torch.Tensor:
    return batch.column(name).data[:n].to(torch.float64)


def with_ones(X: torch.Tensor) -> torch.Tensor:
    """X with a column of ones appended (the intercept's)."""
    return torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                    device=X.device)], dim=1)


def host_features(model, df):
    """(features as host numpy, the executed batch, n): the tree
    ensembles grow and predict on the host."""
    X, batch, n = extract_matrix(df, model.getOrDefault("featuresCol"))
    return to_numpy(X), batch, n


def host_xy(df, est):
    """(features, labels) of an estimator's columns as host numpy."""
    X, batch, n = host_features(est, df)
    return X, to_numpy(extract_column(batch, est.getOrDefault("labelCol"),
                                      n))


def append_prediction(df, batch, n, values, pred_col: str, dtype=None):
    """Executed batch + prediction values (a tensor or a host array) → new
    DataFrame over the batch's device."""
    from .. import types as T
    from ..columnar import ColumnBatch, ColumnVector
    from ..sql import logical as L
    from ..sql.dataframe import DataFrame
    vals = device_tensor(values, batch.device)
    cap = batch.capacity
    if vals.dim() == 1:
        dt = dtype or (T.float64 if vals.is_floating_point() else T.int64)
        full = torch.zeros(cap, dtype=dt.torch_dtype, device=batch.device)
    else:
        dt = dtype or T.ArrayType(T.float64)
        # padding rows hold the element sentinel, as ingested planes do
        full = torch.full((cap,) + tuple(vals.shape[1:]),
                          dt.element_sentinel().item(),
                          dtype=dt.torch_dtype, device=batch.device)
    full[:n] = vals.to(full.dtype)
    names = list(batch.names) + [pred_col]
    vectors = list(batch.vectors) + [ColumnVector(full, dt, None, None)]
    out = ColumnBatch(names, vectors, batch.row_valid, cap)
    return DataFrame(df.session, L.LocalRelation(out))


class Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) over a
    list of tensors, in their dtype, with optax's order of operations:
    ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g² + b2 nu``, the bias
    corrections ``1 - b**t`` in float64 then the tensor's dtype, and the
    update ``p + (-lr) * mu_hat / (sqrt(nu_hat) + eps)``."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, lr: float):
        self.lr = lr
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def step(self, params, grads) -> List[torch.Tensor]:
        """The parameters after one update, as new leaf tensors that
        require grad."""
        self.count += 1
        bc1 = 1.0 - self.B1 ** self.count
        bc2 = 1.0 - self.B2 ** self.count
        out = []
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                self.mu[i] = (1.0 - self.B1) * g + self.B1 * self.mu[i]
                self.nu[i] = (1.0 - self.B2) * (g * g) + self.B2 * self.nu[i]
                upd = (self.mu[i] / bc1) / (
                    torch.sqrt(self.nu[i] / bc2) + self.EPS)
                out.append((p + upd * (-self.lr)).requires_grad_(True))
        return out
