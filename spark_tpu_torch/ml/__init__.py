"""ML pipeline API on the session's device (`mllib` / `ml` analog): the
port of ``spark_tpu/ml/``."""

from .base import Estimator, Model, Param, Params, Pipeline, PipelineModel, Transformer

__all__ = ["Estimator", "Model", "Param", "Params", "Pipeline",
           "PipelineModel", "Transformer"]
