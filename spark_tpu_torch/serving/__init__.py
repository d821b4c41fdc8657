"""Multi-tenant serving core of the port: admission control + the
cross-session plan cache.

``plancache`` lets every server session reuse the plans (and with them
the captured CUDA graphs) that any session built; ``admission`` bounds
what a shared server accepts.  ``server.py`` wires both into the HTTP
statement path.  The elastic worker pool (``serving/pool.py`` in the JAX
package) comes with the serving slice's second part."""

from .admission import AdmissionController, AdmissionRejected
from .plancache import PLANNING_CONF_KEYS, PlanCache, fingerprint

__all__ = ["AdmissionController", "AdmissionRejected", "PlanCache",
           "PLANNING_CONF_KEYS", "fingerprint"]
