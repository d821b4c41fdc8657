"""Multi-tenant serving core of the port: admission control, the
cross-session plan cache and the elastic worker pool.

``plancache`` lets every server session reuse the plans (and with them
the captured CUDA graphs) that any session built; ``admission`` bounds
what a shared server accepts and snapshots its demand; ``pool``
(imported on its own: it is also the pool workers' entry,
``python -m spark_tpu_torch.serving.pool --worker``) grows and shrinks
worker processes with that demand.  ``server.py`` wires them into the
HTTP statement path."""

from .admission import AdmissionController, AdmissionRejected, DemandSignal
from .plancache import PLANNING_CONF_KEYS, PlanCache, fingerprint

__all__ = ["AdmissionController", "AdmissionRejected", "DemandSignal",
           "PlanCache", "PLANNING_CONF_KEYS", "fingerprint"]
