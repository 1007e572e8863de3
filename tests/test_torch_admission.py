"""Fair-share arbiter units: weighted interleaving, the starvation bound,
credit reset on drain, and the AIMD slot wrapper; admission orders and slot
limits held against the JAX package's, pick for pick. Counterpart of
tests/service/test_admission.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import math
from collections import Counter

import pytest

from cubed_tpu_torch.service.admission import FairShareArbiter, ServiceAdmission
from ._torch_chaos import clean_process  # noqa: E402,F401


def _simulate(arbiter, backlog, picks):
    """Run ``picks`` admissions against a live backlog dict, decrementing
    the winner's queue each time; returns the admission order."""
    order = []
    for _ in range(picks):
        t = arbiter.pick(backlog)
        if t is None:
            break
        order.append(t)
        backlog[t] -= 1
    return order


def test_equal_weights_interleave_evenly():
    arb = FairShareArbiter()
    order = _simulate(arb, {"a": 50, "b": 50}, 20)
    counts = Counter(order)
    assert counts["a"] == counts["b"] == 10
    # strict alternation under equal weights and equal backlog
    assert all(order[i] != order[i + 1] for i in range(len(order) - 1))


def test_weighted_share_matches_quota():
    arb = FairShareArbiter({"gold": 3.0, "free": 1.0})
    order = _simulate(arb, {"gold": 100, "free": 100}, 40)
    counts = Counter(order)
    assert counts["gold"] == 30
    assert counts["free"] == 10


def test_starvation_bound_holds_under_flood():
    """A flooding tenant cannot push a light tenant's wait beyond
    ceil(W / w) admissions — the documented fairness contract."""
    arb = FairShareArbiter({"flood": 4.0, "light": 1.0})
    backlog = {"flood": 1000, "light": 5}
    order = _simulate(arb, dict(backlog), 30)
    bound = arb.starvation_bound("light", backlog)
    assert bound == math.ceil(5.0 / 1.0)
    gaps = [i for i, t in enumerate(order) if t == "light"]
    assert gaps, "light tenant never admitted"
    last = -1
    for i in gaps:
        assert i - last <= bound, (order, bound)
        last = i


def test_unknown_tenant_gets_default_weight():
    arb = FairShareArbiter({"vip": 2.0}, default_weight=1.0)
    assert arb.weight("anonymous") == 1.0
    order = _simulate(arb, {"vip": 30, "anonymous": 30}, 30)
    counts = Counter(order)
    assert counts["vip"] == 20
    assert counts["anonymous"] == 10


def test_credit_resets_when_backlog_drains():
    """An idle tenant must not bank credit into an admission burst."""
    arb = FairShareArbiter({"a": 1.0, "b": 1.0})
    # a alone for a while: no credit accrues against b
    _simulate(arb, {"a": 10}, 10)
    order = _simulate(arb, {"a": 20, "b": 20}, 10)
    counts = Counter(order)
    assert counts["a"] == 5 and counts["b"] == 5


def test_pick_none_without_backlog():
    arb = FairShareArbiter()
    assert arb.pick({}) is None
    assert arb.pick({"a": 0}) is None


def test_invalid_weights_rejected():
    with pytest.raises(ValueError):
        FairShareArbiter({"a": 0.0})
    with pytest.raises(ValueError):
        FairShareArbiter(default_weight=-1)
    arb = FairShareArbiter()
    with pytest.raises(ValueError):
        arb.set_weight("a", 0)


def test_service_admission_aimd_stepdown_and_restore():
    adm = ServiceAdmission(max_concurrent=4)
    assert adm.effective_limit == 4
    assert adm.has_slot(3)
    assert not adm.has_slot(4)  # the static ceiling
    adm.on_resource_failure(running=4)
    assert adm.throttling
    assert adm.effective_limit == 2  # halved
    assert not adm.has_slot(2)
    # a full pressure-free window of successes doubles back
    for _ in range(16):
        adm.on_success()
    assert adm.effective_limit == 4
    with pytest.raises(ValueError):
        ServiceAdmission(0)


@pytest.fixture(scope="module", autouse=True)
def _clean_process(clean_process):
    yield


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------


@pytest.mark.parametrize("weights,backlog,picks", [
    ({}, {"a": 9, "b": 9}, 14),
    ({"gold": 3.0, "free": 1.0}, {"gold": 40, "free": 40}, 30),
    ({"flood": 4.0, "light": 1.0, "mid": 2.5}, {"flood": 100, "light": 4, "mid": 7}, 40),
])
def test_admission_order_matches_the_jax_package(weights, backlog, picks):
    """The same weights and backlog give the JAX package's arbiter's
    admission order pick for pick, credit resets on drain included, and
    the same starvation bounds."""
    from cubed_tpu.service.admission import FairShareArbiter as RefArbiter

    ours, theirs = FairShareArbiter(weights), RefArbiter(weights)
    assert _simulate(ours, dict(backlog), picks) == _simulate(theirs, dict(backlog), picks)
    for t in backlog:
        assert ours.starvation_bound(t, backlog) == theirs.starvation_bound(t, backlog)


def test_slot_control_steps_match_the_jax_package():
    """The AIMD slot wrapper's limits after the same failures and successes
    equal the JAX package's."""
    from cubed_tpu.service.admission import ServiceAdmission as RefAdmission

    ours, theirs = ServiceAdmission(8), RefAdmission(8)
    steps = [("fail", 6), ("ok", 0), ("ok", 0), ("fail", 2)] + [("ok", 0)] * 12
    for kind, running in steps:
        for adm in (ours, theirs):
            adm.on_resource_failure(running) if kind == "fail" else adm.on_success()
        assert (ours.effective_limit, ours.throttling) == (theirs.effective_limit, theirs.throttling)
        assert [ours.has_slot(n) for n in range(10)] == [theirs.has_slot(n) for n in range(10)]
