"""spark_tpu_torch — the PyTorch/CUDA port of the spark_tpu data engine.

The single-device DataFrame path of ``spark_tpu`` (scan → filter → join →
grouped aggregate → sort → limit) on torch tensors, with the grouped
accumulate written by hand in CUDA for Hopper (``spark_tpu_torch.cuda_agg``).

* columnar batches of torch tensors on one device (``columnar``)
* torch operators (``kernels``, ``sql.physical``, ``sql.joins``), each
  planned query captured once as a CUDA graph and replayed from the
  stage cache where the JAX package runs one jitted XLA program
  (``sql.stagecompile``)
* the same SQL front half (analyzer → optimizer → planner) as the JAX
  package, in ``spark_tpu_torch.sql``

The session runs on the device named by ``spark.torch.device`` (default
``"cuda"``); it raises when that card is missing and never falls back to
the CPU.  The package imports neither JAX nor ``spark_tpu``.
"""

__version__ = "0.1.0"

from . import types  # noqa: F401,E402
from .config import Conf  # noqa: F401,E402
from .columnar import ColumnBatch, ColumnVector  # noqa: F401,E402


def __getattr__(name):
    # lazy, as in the JAX package: `import spark_tpu_torch` stays light
    if name == "SparkSession":
        from .sql.session import SparkSession
        return SparkSession
    if name == "functions":
        from .sql import functions
        return functions
    raise AttributeError(name)
