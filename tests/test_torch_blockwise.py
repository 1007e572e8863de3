"""The blockwise primitive of the port, held against the JAX package's: each
case of ``tests/primitive/test_blockwise.py`` built by both packages'
``primitive.blockwise`` on the same Zarr inputs, into explicit target
stores, comparing task counts, projected memory, block functions and the
values written (exact: the kernels are the same elementwise functions).
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cubed_tpu.backend_array_api import nxp as ref_nxp  # noqa: E402
from cubed_tpu.chunks import normalize_chunks  # noqa: E402
from cubed_tpu.primitive import blockwise as ref_blockwise_module  # noqa: E402
from cubed_tpu.storage.store import open_zarr_array as ref_open  # noqa: E402
from cubed_tpu_torch.backend_array_api import nxp as port_nxp  # noqa: E402
from cubed_tpu_torch.primitive import blockwise as port_blockwise_module  # noqa: E402
from cubed_tpu_torch.storage.store import open_zarr_array as port_open  # noqa: E402


class _Package:
    def __init__(self, label, module, nxp, opener):
        self.label, self.module, self.nxp, self.opener = label, module, nxp, opener

    def zarr(self, tmp_path, name, arr, chunks):
        store = str(tmp_path / self.label / name)
        z = self.opener(store, mode="w", shape=arr.shape, dtype=arr.dtype, chunks=chunks)
        z[...] = arr
        return z

    def blockwise(self, tmp_path, *args, target, **kwargs):
        return self.module.blockwise(*args, target_store=str(tmp_path / self.label / target), **kwargs)

    @staticmethod
    def execute(op):
        op.target_array.create()
        for m in op.pipeline.mappable:
            op.pipeline.function(m, config=op.pipeline.config)
        return op.target_array.open()[...]


PACKAGES = (_Package("ref", ref_blockwise_module, ref_nxp, ref_open),
            _Package("port", port_blockwise_module, port_nxp, port_open))


def _both(build):
    """(reference result, port result) of ``build(package)``."""
    return [build(pkg) for pkg in PACKAGES]


def test_blockwise_add(tmp_path):
    an = np.arange(20.0).reshape(4, 5)

    def build(pkg):
        a, b = pkg.zarr(tmp_path, "a.zarr", an, (2, 3)), pkg.zarr(tmp_path, "b.zarr", an, (2, 3))
        op = pkg.blockwise(tmp_path, pkg.nxp.add, ("i", "j"), a, ("i", "j"), b, ("i", "j"), allowed_mem=10**7,
                           reserved_mem=0, target="out.zarr", shape=(4, 5), dtype=np.float64,
                           chunks=normalize_chunks((2, 3), (4, 5), dtype=np.float64), in_names=["a", "b"],
                           out_name="out")
        return op.num_tasks, op.projected_mem, pkg.execute(op)

    ref, port = _both(build)
    assert port[:2] == ref[:2] and port[0] == 4
    np.testing.assert_array_equal(port[2], ref[2])
    np.testing.assert_array_equal(port[2], an + an)


def test_projected_mem_formula(tmp_path):
    def build(pkg):
        a = pkg.zarr(tmp_path, "a.zarr", np.zeros((4, 6)), (2, 3))
        return pkg.blockwise(tmp_path, pkg.nxp.negative, ("i", "j"), a, ("i", "j"), allowed_mem=10**7,
                             reserved_mem=1000, target="out.zarr", shape=(4, 6), dtype=np.float64,
                             chunks=normalize_chunks((2, 3), (4, 6), dtype=np.float64), in_names=["a"],
                             out_name="out", extra_projected_mem=50).projected_mem

    ref, port = _both(build)
    chunk_bytes = 2 * 3 * 8
    assert port == ref == 1000 + 50 + 2 * chunk_bytes + 2 * chunk_bytes


def test_allowed_mem_exceeded(tmp_path):
    for pkg in PACKAGES:
        a = pkg.zarr(tmp_path, "a.zarr", np.zeros((100, 100)), (100, 100))
        with pytest.raises(ValueError, match="exceeds allowed_mem"):
            pkg.blockwise(tmp_path, pkg.nxp.negative, ("i", "j"), a, ("i", "j"), allowed_mem=1000, reserved_mem=0,
                          target="out.zarr", shape=(100, 100), dtype=np.float64,
                          chunks=normalize_chunks((100, 100), (100, 100), dtype=np.float64), in_names=["a"],
                          out_name="out")


@pytest.mark.parametrize("argpairs, numblocks, key, want", [
    ([("a", ("i", "j")), ("b", ("i", "j"))], {"a": (2, 3), "b": (2, 3)}, ("out", 1, 2), (("a", 1, 2), ("b", 1, 2))),
    ([("a", ("i", "j")), ("b", ("j",))], {"a": (2, 3), "b": (3,)}, ("out", 1, 2), (("a", 1, 2), ("b", 2))),
    ([("a", ("i", "j")), ("b", ("i", "j"))], {"a": (2, 3), "b": (1, 3)}, ("out", 1, 2), (("a", 1, 2), ("b", 0, 2))),
], ids=["matching", "broadcast", "broadcast_single_block"])
def test_make_blockwise_function(argpairs, numblocks, key, want):
    ref, port = _both(lambda pkg: pkg.module.make_blockwise_function("out", ("i", "j"), argpairs, numblocks)(key))
    assert port == ref == want


def test_make_blockwise_function_contraction():
    ref, port = _both(lambda pkg: pkg.module.make_blockwise_function("out", ("i",), [("a", ("i", "k"))],
                                                                     {"a": (2, 3)})(("out", 1)))
    assert port == ref == ([("a", 1, 0), ("a", 1, 1), ("a", 1, 2)],)


def test_fuse_unary_chain(tmp_path):
    an = np.arange(12.0).reshape(3, 4)
    chunks = normalize_chunks((1, 2), (3, 4), dtype=np.float64)

    def build(pkg):
        a = pkg.zarr(tmp_path, "a.zarr", an, (1, 2))
        op1 = pkg.blockwise(tmp_path, pkg.nxp.negative, ("i", "j"), a, ("i", "j"), allowed_mem=10**7,
                            reserved_mem=0, target="t1.zarr", shape=(3, 4), dtype=np.float64, chunks=chunks,
                            in_names=["a"], out_name="t1")
        op2 = pkg.blockwise(tmp_path, pkg.nxp.abs, ("i", "j"), op1.target_array, ("i", "j"), allowed_mem=10**7,
                            reserved_mem=0, target="out.zarr", shape=(3, 4), dtype=np.float64, chunks=chunks,
                            in_names=["t1"], out_name="out")
        assert pkg.module.can_fuse_pipelines(op1, op2)
        fused = pkg.module.fuse_multiple(op2, op1)
        return fused.num_tasks, fused.projected_mem, pkg.execute(fused)

    ref, port = _both(build)
    assert port[:2] == ref[:2] and port[0] == 6
    np.testing.assert_array_equal(port[2], np.abs(-an))
    assert not os.path.exists(tmp_path / "port" / "t1.zarr")  # the intermediate is never written


def test_fuse_multiple_binary(tmp_path):
    an = np.arange(12.0).reshape(3, 4)
    chunks = normalize_chunks((1, 2), (3, 4), dtype=np.float64)

    def build(pkg):
        a, b = pkg.zarr(tmp_path, "a.zarr", an, (1, 2)), pkg.zarr(tmp_path, "b.zarr", an * 2, (1, 2))

        def mk(f, arr, name, store):
            return pkg.blockwise(tmp_path, f, ("i", "j"), arr, ("i", "j"), allowed_mem=10**7, reserved_mem=0,
                                 target=store, shape=(3, 4), dtype=np.float64, chunks=chunks, in_names=[name],
                                 out_name=f"{name}-neg")

        op_a, op_b = mk(pkg.nxp.negative, a, "a", "ta.zarr"), mk(pkg.nxp.negative, b, "b", "tb.zarr")
        op_add = pkg.blockwise(tmp_path, pkg.nxp.add, ("i", "j"), op_a.target_array, ("i", "j"),
                               op_b.target_array, ("i", "j"), allowed_mem=10**7, reserved_mem=0,
                               target="out.zarr", shape=(3, 4), dtype=np.float64, chunks=chunks,
                               in_names=["a-neg", "b-neg"], out_name="out")
        fused = pkg.module.fuse_multiple(op_add, op_a, op_b)
        assert fused.projected_mem >= op_add.projected_mem
        return fused.num_tasks, fused.projected_mem, pkg.execute(fused)

    ref, port = _both(build)
    assert port[:2] == ref[:2]
    np.testing.assert_array_equal(port[2], -an + -an * 2)


def test_dict_output_structured_write(tmp_path):
    an = np.arange(12.0).reshape(3, 4)
    dtype = np.dtype([("n", np.int64), ("total", np.float64)])

    def build(pkg):
        a = pkg.zarr(tmp_path, "a.zarr", an, (3, 2))

        def mean_chunk(x):
            return {"n": pkg.nxp.full((1, x.shape[1]), x.shape[0], dtype=np.int64),
                    "total": pkg.nxp.sum(x, axis=0, keepdims=True)}

        op = pkg.blockwise(tmp_path, mean_chunk, ("i", "j"), a, ("i", "j"), allowed_mem=10**7, reserved_mem=0,
                           target="out.zarr", shape=(1, 4), dtype=dtype, chunks=((1,), (2, 2)), in_names=["a"],
                           out_name="out")
        return op.num_tasks, op.projected_mem, pkg.execute(op)

    ref, port = _both(build)
    assert port[:2] == ref[:2]
    np.testing.assert_array_equal(port[2]["n"], np.full((1, 4), 3))
    np.testing.assert_array_equal(port[2]["total"], an.sum(axis=0, keepdims=True))
    np.testing.assert_array_equal(port[2], ref[2])


def test_general_blockwise_multiple_outputs_into_target_stores(tmp_path):
    an = np.arange(12.0).reshape(3, 4)

    def build(pkg):
        a = pkg.zarr(tmp_path, "a.zarr", an, (3, 2))

        def two(x):
            return pkg.nxp.negative(x), pkg.nxp.multiply(x, 2.0)

        op = pkg.module.general_blockwise(
            two, lambda key: (("a", *key[1:]),), a, allowed_mem=10**7, reserved_mem=0,
            target_store=[str(tmp_path / pkg.label / "o1.zarr"), str(tmp_path / pkg.label / "o2.zarr")],
            shape=[(3, 4), (3, 4)], dtype=[np.float64, np.float64], chunks=((3,), (2, 2)), in_names=["a"],
            out_name=["o1", "o2"])
        for t in op.target_arrays:
            t.create()
        for m in op.pipeline.mappable:
            op.pipeline.function(m, config=op.pipeline.config)
        return op.num_tasks, op.projected_mem, [t.open()[...] for t in op.target_arrays]

    ref, port = _both(build)
    assert port[:2] == ref[:2]
    np.testing.assert_array_equal(port[2][0], -an)
    np.testing.assert_array_equal(port[2][1], an * 2)
