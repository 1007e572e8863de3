"""The compute service's parts ported so far: the structural plan
fingerprint (``cache.py``). The multi-tenant service over the fleet (its
admission, overload ladder, plan and result caches and durability) is not
ported yet (ROADMAP Queue 1 item 11c): asking this package for one of its
names raises ``NotImplementedError`` naming that item."""

#: the JAX package's service names that wait for the service's port
_NOT_PORTED = frozenset({
    "ComputeService", "ServiceConfig", "RequestHandle", "RequestCancelledError", "TenantThrottledError",
    "ServiceOverloadedError", "DeadlineInfeasibleError", "OverloadController", "OverloadPolicy", "TenantBreaker",
    "CostEstimator", "FairShareArbiter", "ServiceAdmission", "PlanCache", "ResultCache", "input_state_digest",
})


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"cubed_tpu_torch.service.{name}: the compute service is not ported yet (ROADMAP Queue 1 item 11c)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
