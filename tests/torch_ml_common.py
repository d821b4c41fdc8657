"""Shared helpers of the port's ML parity tests (``test_torch_ml.py``,
``test_torch_ml_breadth.py``): each case is written once against a
namespace of ML modules and run on both packages — the JAX package on
the conftest ``spark`` session, the port on a CPU session — from the
same seeded numpy inputs."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import spark_tpu.ml.ann as r_ann
import spark_tpu.ml.base as r_base
import spark_tpu.ml.classification as r_cls
import spark_tpu.ml.clustering as r_clu
import spark_tpu.ml.evaluation as r_ev
import spark_tpu.ml.feature as r_feat
import spark_tpu.ml.fpm as r_fpm
import spark_tpu.ml.recommendation as r_rec
import spark_tpu.ml.regression as r_reg
import spark_tpu.ml.stat as r_stat
import spark_tpu.ml.tuning as r_tun
import spark_tpu.mllib as r_mllib
import spark_tpu_torch.ml.ann as t_ann
import spark_tpu_torch.ml.base as t_base
import spark_tpu_torch.ml.classification as t_cls
import spark_tpu_torch.ml.clustering as t_clu
import spark_tpu_torch.ml.evaluation as t_ev
import spark_tpu_torch.ml.feature as t_feat
import spark_tpu_torch.ml.fpm as t_fpm
import spark_tpu_torch.ml.recommendation as t_rec
import spark_tpu_torch.ml.regression as t_reg
import spark_tpu_torch.ml.stat as t_stat
import spark_tpu_torch.ml.tuning as t_tun
import spark_tpu_torch.mllib as t_mllib
from spark_tpu_torch import config as TC
from spark_tpu_torch.sql.session import SparkSession as TSession

#: float64 results of the two packages agree within this (relative, or
#: absolute near zero); float32 ones (MLP, Word2Vec) within F32_TOL
F64_TOL = 1e-10
F32_TOL = 1e-4

REF = SimpleNamespace(ann=r_ann, base=r_base, cls=r_cls, clu=r_clu,
                      ev=r_ev, feat=r_feat, fpm=r_fpm, rec=r_rec, reg=r_reg,
                      stat=r_stat, tun=r_tun, mllib=r_mllib)
PORT = SimpleNamespace(ann=t_ann, base=t_base, cls=t_cls, clu=t_clu,
                       ev=t_ev, feat=t_feat, fpm=t_fpm, rec=t_rec, reg=t_reg,
                       stat=t_stat, tun=t_tun, mllib=t_mllib)


@pytest.fixture(scope="module")
def tspark():
    s = TSession(TC.Conf({"spark.torch.device": "cpu"}))
    yield s
    s.stop()


def run_both(spark, tspark, case):
    """``case(session, M)`` on the JAX package and on the port: (ref,
    port)."""
    return case(spark, REF), case(tspark, PORT)


def arr(x) -> np.ndarray:
    """A parameter or result of either package as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def col(df, name) -> np.ndarray:
    return np.array([r[name] for r in df.collect()])


def close(got, want, tol=F64_TOL):
    np.testing.assert_allclose(arr(got), arr(want), rtol=tol, atol=tol)
