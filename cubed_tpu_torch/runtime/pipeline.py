"""Plan traversal with trustworthy chunk-granular resume, and the resolver
that re-runs the producer of a corrupt chunk.

Counterpart of ``cubed_tpu/runtime/pipeline.py``, less the compute
journal's narrowing of the skip frontier (the journal comes with ROADMAP
Queue 1 item 11). With ``resume=True`` an op is skipped when every chunk of
its outputs is present and verifies against the checksum manifest
(``storage/integrity.py``); bare existence is not proof, so a corrupt or
torn output re-runs instead of poisoning the ops downstream. A partly
complete blockwise or rechunk op re-runs only the tasks whose output chunks
are missing or invalid (:func:`pending_mappable`). Under ``integrity="off"``
the scan is existence-only.

The dotted chunk-key helpers are the reference's (``runtime/shuffle.py``):
the shuffle itself is not ported, but resume needs the keys a rechunk task
writes.
"""

from __future__ import annotations

import itertools
import logging
from typing import Iterator, List, Optional, Tuple

from ..observability.metrics import get_registry

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# dotted chunk keys (the reference's runtime/shuffle.py helpers)
# ----------------------------------------------------------------------


def chunk_key_str(idx: Tuple[int, ...]) -> str:
    """The store's dotted chunk file name for a chunk index tuple."""
    return ".".join(str(int(i)) for i in idx) if idx else "0"


def is_rechunk_pipeline(pipeline) -> bool:
    """True for a rechunk copy stage (``primitive/rechunk.copy_read_to_write``)."""
    from ..primitive.rechunk import copy_read_to_write

    return getattr(pipeline, "function", None) is copy_read_to_write


def chunks_overlapping_region(region: Tuple[slice, ...], chunks: Tuple[int, ...]) -> Iterator[Tuple[int, ...]]:
    """Chunk index tuples of a ``chunks``-gridded array that a slice-region
    overlaps."""
    if not region:
        yield ()
        return
    ranges = []
    for s, c in zip(region, chunks):
        c = max(1, int(c))
        start = int(s.start or 0)
        stop = int(s.stop if s.stop is not None else start)
        first = start // c
        last = max(first, (max(stop - 1, start)) // c)
        ranges.append(range(first, last + 1))
    yield from itertools.product(*ranges)


def rechunk_task_writes(m, config) -> List[str]:
    """Dotted target chunk keys a rechunk task's region covers (write regions
    are whole multiples of the target's chunks, so each target chunk is
    covered by exactly one task)."""
    return [chunk_key_str(i) for i in chunks_overlapping_region(m, tuple(config.write.chunks))]


# ----------------------------------------------------------------------
# resume
# ----------------------------------------------------------------------


class ResumeState:
    """One resume scan's cache of per-store chunk validity.

    Each target store is scanned (and checksum-verified) at most once per
    traversal, shared by the op-level skip (:func:`already_computed`) and
    the task-level skip (:func:`pending_mappable`). With ``quarantine=True``
    (executors) corrupt chunks are renamed to ``*.quarantine.*`` as they are
    found; introspection (``FinalizedPlan.num_tasks``) scans read-only with
    ``count=False``. Under integrity ``"off"`` the scan is existence-only.
    """

    def __init__(self, quarantine: bool = False, count: bool = True):
        from ..storage import integrity

        self.quarantine = quarantine
        self.count = count
        #: resolved once per scan: "off" disables verification even when
        #: manifest shards exist on disk
        self.verify = integrity.current_mode() != "off"
        #: store -> set of valid chunk keys, or None when the target is
        #: unreadable or not created (nothing trustworthy: run everything)
        self._valid: dict = {}

    def valid_chunks(self, target) -> Optional[set]:
        """The verified-valid chunk keys of *target*'s store, or None when
        chunk-level accounting is impossible."""
        store = str(getattr(target, "store", target))
        if store in self._valid:
            return self._valid[store]
        valid: Optional[set]
        try:
            arr = target.open() if hasattr(target, "open") else target
            if hasattr(arr, "verify_chunks"):
                valid, corrupt, _verified = arr.verify_chunks(
                    quarantine=self.quarantine and self.verify, verify=self.verify, count=self.count,
                )
                if corrupt:
                    logger.warning("resume scan: %d corrupt/untrusted chunk(s) in %s will recompute",
                                   len(corrupt), store)
                    if self.count:
                        from ..observability.collect import record_decision

                        record_decision("quarantine", store=store, chunks=len(corrupt), source="resume_scan")
            else:
                valid = None
        except FileNotFoundError:
            valid = None
        except (ValueError, KeyError, TypeError, OSError, UnicodeDecodeError):
            # undecodable metadata: not computed (create-arrays writes it
            # anew and the op re-runs), never a crashed scan
            logger.warning("resume scan: unreadable metadata at %s; treating as not computed", store)
            valid = None
        self._valid[store] = valid
        return valid

    def target_complete(self, target) -> bool:
        """True when every chunk of *target* is present and trustworthy."""
        valid = self.valid_chunks(target)
        if valid is not None:
            return len(valid) >= _target_nchunks(target)
        return False


def _target_nchunks(target) -> int:
    """Total chunk count of a (lazy or concrete) Zarr target."""
    nchunks = getattr(target, "nchunks", None)
    if nchunks is not None:
        return nchunks
    shape = getattr(target, "shape", None)
    chunks = getattr(target, "chunks", None)
    if not shape:
        return 1
    total = 1
    for s, c in zip(shape, chunks):
        total *= max(1, -(-s // max(1, c)))
    return total


def _task_chunk_key(m) -> str:
    """The output chunk key a blockwise task writes: its mappable item is
    ``(out_name, i, j, ...)``."""
    return chunk_key_str(tuple(m[1:]))


def _targets(primitive_op) -> list:
    return primitive_op.target_arrays or (
        [primitive_op.target_array] if primitive_op.target_array is not None else []
    )


def already_computed(name, dag, nodes: dict, resume: Optional[bool], state: Optional[ResumeState] = None) -> bool:
    """True if this node's computation can be skipped: a node without a
    pipeline always; under ``resume`` an op whose every successor array has
    all its chunks present and verified."""
    pipeline = nodes[name].get("primitive_op", None)
    if pipeline is None:
        return True
    if resume:
        if state is None:
            state = ResumeState()
        for succ in dag.successors(name):
            target = nodes[succ].get("target", None)
            if target is None:
                return False
            if not state.target_complete(target):
                return False
        return True
    return False


def pending_mappable(name, node, resume: Optional[bool], state: Optional[ResumeState] = None, record: bool = True):
    """An op's still-to-run tasks under chunk-granular resume:
    ``(mappable, n_skipped)``. A blockwise task is done when every output
    array has its chunk verified; a rechunk region when every target chunk
    it covers is. Ops without an output-chunk mapping (create-arrays) run
    in full. Skips count ``tasks_skipped_resume`` unless ``record=False``
    (plan introspection)."""
    primitive_op = node["primitive_op"]
    pipeline = primitive_op.pipeline
    if not resume or state is None:
        return pipeline.mappable, 0
    from ..primitive.blockwise import apply_blockwise

    rechunk = is_rechunk_pipeline(pipeline)
    if pipeline.function is not apply_blockwise and not rechunk:
        return pipeline.mappable, 0
    targets = _targets(primitive_op)
    if not targets:
        return pipeline.mappable, 0
    valid_sets = []
    for t in targets:
        valid = state.valid_chunks(t)
        if valid is None:
            return pipeline.mappable, 0
        valid_sets.append(valid)
    pending = []
    skipped = 0
    for m in pipeline.mappable:
        keys = rechunk_task_writes(m, pipeline.config) if rechunk else [_task_chunk_key(m)]
        if all(key in valid for valid in valid_sets for key in keys):
            skipped += 1
        else:
            pending.append(m)
    if skipped and record:
        get_registry().counter("tasks_skipped_resume").inc(skipped)
        logger.info("resume: skipping %d/%d already-valid task(s) of %s", skipped, primitive_op.num_tasks, name)
    return pending, skipped


class RecomputeResolver:
    """Maps a corrupt chunk back to the task that produces it (a blockwise
    out-key task, or the rechunk region covering it), and returns a thunk
    re-running that task in a task scope, against the shared store. None
    when the store is not an output of this plan's blockwise or rechunk
    ops (the failure then retries plainly)."""

    def __init__(self, dag):
        self._by_store: dict = {}
        for _name, d in iter_op_nodes(dag):
            for t in _targets(d["primitive_op"]):
                store = str(getattr(t, "store", "") or "")
                if store:
                    self._by_store[store] = d

    def resolve(self, payload: Optional[dict]):
        if not payload:
            return None
        node = self._by_store.get(str(payload.get("store", "")))
        if node is None:
            return None
        pipeline = node["primitive_op"].pipeline
        from ..primitive.blockwise import apply_blockwise

        rechunk = is_rechunk_pipeline(pipeline)
        if pipeline.function is not apply_blockwise and not rechunk:
            return None
        key = payload.get("chunk_key")
        task_input = None
        for m in pipeline.mappable:
            if rechunk:
                if key in rechunk_task_writes(m, pipeline.config):
                    task_input = m
                    break
            elif _task_chunk_key(m) == key:
                task_input = m
                break
        if task_input is None:
            return None

        def recompute():
            from ..observability.accounting import scope_span, task_scope

            logger.warning("recomputing corrupt chunk %s of %s (upstream task re-run)", key, payload.get("store"))
            # a task scope: fault injection and read verification apply to
            # the repair exactly as to the task it stands for
            with task_scope() as scope:
                with scope_span("recompute_repair", cat="repair", chunk=key, store=str(payload.get("store", ""))):
                    pipeline.function(task_input, config=pipeline.config)
            reg = get_registry()
            stats = scope.stats()
            for sname, n in stats.items():
                if sname == "counters":
                    for cname, cn in n.items():
                        if cn:
                            reg.counter(cname).inc(cn)
                elif sname == "spans":
                    continue
                elif n:
                    reg.counter(sname).inc(n)
            reg.counter("chunks_recomputed").inc()
            from ..observability.collect import record_repair_spans

            record_repair_spans(key, str(payload.get("store", "")), stats)

        return recompute


def iter_op_nodes(dag) -> Iterator[tuple[str, dict]]:
    """(name, node data) of every op node that carries real work."""
    for name, d in dag.nodes.items():
        if d.get("type") == "op" and d.get("primitive_op") is not None:
            yield name, d


def visit_nodes(dag, resume: Optional[bool] = None, state: Optional[ResumeState] = None) -> Iterator[tuple[str, dict]]:
    """Yield (name, node data) for every op node with work, in topological
    order; under ``resume`` the ops whose outputs all verify are skipped."""
    nodes = dag.nodes
    if resume and state is None:
        state = ResumeState()
    for name in dag.topological_sort():
        if already_computed(name, dag, nodes, resume, state):
            continue
        yield name, nodes[name]
