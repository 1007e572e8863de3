"""Structural plan fingerprints. Counterpart of the fingerprint half of
``cubed_tpu/service/cache.py``; the compute service's plan and result caches
that key on it are not ported yet (ROADMAP Queue 1 item 11c), and the run
archive (``observability/runhistory.py``) is its user here.

:func:`structural_fingerprint` hashes an un-finalized plan DAG so that two
builds of the same query fingerprint equal, though every gensym name and
intermediate store path differs, and two different queries differ. The
canonical payload masks what does not affect the computed values (store
paths of this process's intermediates -> order-of-first-use tokens, the
Spec, provenance) and keeps what does: shapes, dtypes, chunking, in-memory
input bytes by digest, RNG bases, and the block functions.

The JAX package pickles the payload with cloudpickle; the port describes it
with the device executor's segment describer (``runtime/executors/cuda.py:
_Describer``: a function by its module, qualified name, code, defaults,
closure values and the globals it reads, each described the same way), with
the fingerprint's masking: a stored input's or a user-named target's path
is kept, host arrays of any size are hashed, and a tensor is hashed by
shape, dtype and the sha256 of its bytes; a tensor on the card is copied to
the host for that, counted in ``fingerprint_device_bytes`` (this runs only
when a caller fingerprints, as an armed run archive does). Generated plan
names are canonicalized by order of first appearance. Fingerprinting is
best-effort: any failure returns ``(None, None)``.
"""

from __future__ import annotations

import hashlib
import logging
from typing import List, Optional, Tuple

import numpy as np

from ..observability.metrics import get_registry

logger = logging.getLogger(__name__)


def _node_counter(name: str) -> Tuple[int, str]:
    """Sort key recovering creation order from a gensym'd node name.

    Every plan identifier is ``{prefix}-{counter:09d}`` with one shared
    process-global counter, so sorting by the numeric suffix reproduces
    build order, which is the same across two builds of the same code even
    though the absolute counter values differ."""
    tail = name.rsplit("-", 1)[-1]
    if tail.isdigit():
        return (int(tail), "")
    return (-1, name)  # non-gensym nodes (create-arrays) sort first, by name


def canonical_node_order(dag) -> List[str]:
    """The dag's node names in build order (stable across rebuilds)."""
    return sorted((str(n) for n in dag.nodes), key=_node_counter)


def _is_temp_store(store: str) -> bool:
    """True when a store path is one of this process's build-local
    intermediates (under the ``work_dir/CONTEXT_ID`` temp directory), the
    only paths the fingerprint may mask as noise."""
    from ..core.plan import CONTEXT_ID

    return CONTEXT_ID in store


def _tensor_token(t) -> str:
    """``tensor:<shape>:<dtype>:<sha256>`` of a tensor's values; a tensor on
    the card is copied to the host for it, and counted."""
    import torch

    t = t.detach()
    if t.device.type != "cpu":
        get_registry().counter("fingerprint_device_bytes").inc(t.element_size() * t.numel())
        t = t.cpu()
    data = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
    return f"tensor:{tuple(t.shape)}:{t.dtype}:{hashlib.sha256(data).hexdigest()}"


def structural_fingerprint(dag) -> Tuple[Optional[str], Optional[List[str]]]:
    """``(sha256 hexdigest, canonical node order)`` of a plan dag, or
    ``(None, None)`` when fingerprinting fails.

    Two dags of structurally identical queries (same ops, same block
    functions and closures, same shapes, dtypes and chunking, same in-memory
    input bytes) fingerprint equal; the canonical order maps this build's
    node names to another build's at the same position."""
    import torch

    from ..runtime.executors.cuda import _Describer, _tokenize

    class _FingerprintDescriber(_Describer):
        """The segment describer with the fingerprint's masking: only this
        process's intermediates become store tokens, seeds are kept (a
        different seed is a different result), and host arrays and tensors
        of any size are hashed by value."""

        def store(self, path) -> str:
            path = str(path)
            return super().store(path) if _is_temp_store(path) else path

        def _describe(self, obj):
            if isinstance(obj, torch.Tensor):
                return ("tensor", _tensor_token(obj))
            if isinstance(obj, np.ndarray) and not obj.dtype.hasobject:
                return ("ndarray", obj.shape, str(obj.dtype),
                        hashlib.sha256(np.ascontiguousarray(obj).tobytes()).hexdigest())
            return super()._describe(obj)

    canonical = canonical_node_order(dag)
    index = {n: i for i, n in enumerate(canonical)}
    describe = _FingerprintDescriber(masked=set())
    try:
        payload = []
        for name in canonical:
            node = dag.nodes[name]
            if node.get("type") == "op":
                pop = node.get("primitive_op")
                payload.append(("op", node.get("op_name"), pop.num_tasks if pop is not None else None,
                                describe(pop.pipeline.config) if pop is not None and pop.pipeline is not None
                                else None))
            else:
                payload.append(("array", describe(node.get("target"))))
        payload.append(("edges", tuple(sorted((index[str(u)], index[str(v)]) for u, v in dag.edges()))))
        desc = _tokenize(tuple(payload), set(canonical) | describe.names, {})
    except Exception:
        logger.debug("plan fingerprinting failed", exc_info=True)
        return None, None
    return hashlib.sha256(repr(desc).encode()).hexdigest(), canonical
