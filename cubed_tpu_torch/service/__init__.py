"""Multi-tenant compute service: the persistent front door over one fleet.
Counterpart of ``cubed_tpu/service/``: weighted fair-share admission
(``admission.py``), the overload ladder and tenant breakers
(``overload.py``), the plan and result caches (``cache.py``), durable
requests (``durability.py``) and the service itself (``service.py``).
"""

from .admission import FairShareArbiter, ServiceAdmission  # noqa: F401
from .cache import (  # noqa: F401
    PlanCache,
    ResultCache,
    input_state_digest,
    structural_fingerprint,
)
from .overload import (  # noqa: F401
    CostEstimator,
    DeadlineInfeasibleError,
    OverloadController,
    OverloadPolicy,
    ServiceOverloadedError,
    TenantBreaker,
)
from .service import (  # noqa: F401
    ComputeService,
    RequestCancelledError,
    RequestHandle,
    ServiceConfig,
    TenantThrottledError,
)

__all__ = [
    "ComputeService",
    "ServiceConfig",
    "RequestHandle",
    "RequestCancelledError",
    "TenantThrottledError",
    "ServiceOverloadedError",
    "DeadlineInfeasibleError",
    "OverloadController",
    "OverloadPolicy",
    "TenantBreaker",
    "CostEstimator",
    "FairShareArbiter",
    "ServiceAdmission",
    "PlanCache",
    "ResultCache",
    "structural_fingerprint",
    "input_state_digest",
]
