"""Plan traversal. Counterpart of ``cubed_tpu/runtime/pipeline.py``, trimmed
to :func:`visit_nodes` in topological order (chunk-granular resume and
``ResumeState`` are not ported)."""

from __future__ import annotations

from typing import Iterator, Optional


def visit_nodes(dag, resume: Optional[bool] = None) -> Iterator[tuple[str, dict]]:
    """Yield (name, node data) for every op node with work, in topological order."""
    if resume:
        raise NotImplementedError("resume is not ported to cubed_tpu_torch yet")
    for name in dag.topological_sort():
        node = dag.nodes[name]
        if node.get("primitive_op") is not None:
            yield name, node
