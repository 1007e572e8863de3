"""The order-statistics parity harness shared by ``tests/test_torch_quantile.py``,
``test_torch_histogram.py`` and ``test_torch_nan_functions.py``: one plan
built in both packages from the same numpy inputs, the plans compared
(tasks, ops, projected memory), the port's values on its sequential and
device executors against the reference's, and ``CudaExecutor``'s path
counters against ``JaxExecutor``'s with every failed check 0."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402

PATH_COUNTERS = ("whole_array_hits", "whole_concat_hits", "batched_ops", "chunked_ops", "eager_ops",
                 "rechunk_alias", "rechunk_virtual")
FAILED_CHECKS = ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors")
PACKAGES = ((rxp, cubed_tpu), (pxp, cubed_tpu_torch))


def specs(tmp_path, allowed_mem="500MB", reserved_mem=0):
    return (cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem=allowed_mem, reserved_mem=reserved_mem),
            cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem=allowed_mem, reserved_mem=reserved_mem))


def plan_of(arr):
    plan = arr.plan._finalize(array_names=(arr.name,))
    return plan.num_tasks(), plan.num_ops(), plan.max_projected_mem()


def assert_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    if rtol == 0 or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


def parity(tmp_path, build, *data, chunks, rtol=1e-12, allowed_mem="500MB", executors=True, pick=None):
    """Build ``build(xp, pkg, *arrays)`` in both packages; compare plans,
    values (rtol, NaN equal to NaN) and, with *executors*, the device
    executor's counters against JaxExecutor's. *pick* selects the array of a
    tuple result (histogram's counts). Returns (port value, reference
    value)."""
    rs, ps = specs(tmp_path, allowed_mem)
    chunks = chunks if isinstance(chunks, list) else [chunks] * len(data)
    pick = pick or (lambda out: out)
    r = pick(build(rxp, cubed_tpu, *[cubed_tpu.from_array(d, chunks=c, spec=rs) for d, c in zip(data, chunks)]))
    p = pick(build(pxp, cubed_tpu_torch,
                   *[cubed_tpu_torch.from_array(d, chunks=c, spec=ps) for d, c in zip(data, chunks)]))
    assert plan_of(p) == plan_of(r)
    if not executors:
        ref = np.asarray(r.compute())
        got = np.asarray(p.compute())
        assert_close(got, ref, rtol)
        return got, ref
    jax_executor_module._STRUCT_CACHE.clear()
    rex, pex = JaxExecutor(), CudaExecutor()
    ref = np.asarray(r.compute(executor=rex))
    got = np.asarray(p.compute())
    assert_close(got, ref, rtol)
    assert_close(np.asarray(p.compute(executor=pex)), ref, rtol)
    assert {c: pex.stats[c] for c in PATH_COUNTERS} == {c: rex.stats.get(c, 0) for c in PATH_COUNTERS}
    assert {c: pex.stats[c] for c in FAILED_CHECKS} == dict.fromkeys(FAILED_CHECKS, 0)
    return got, ref
