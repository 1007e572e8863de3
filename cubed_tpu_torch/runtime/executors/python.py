"""Sequential in-process executor: the correctness oracle.

Counterpart of ``cubed_tpu/runtime/executors/python.py``: each op's tasks
run one by one, ops in topological order, each task through
``execute_with_stats`` (its time, peak host memory, storage bytes, spans
and the memory guard's reading) and its stats out through
``handle_callbacks``. With ``resume=True`` a task whose output chunks all
verify is skipped (``pipeline.pending_mappable``). Classified retries are
opt in (``retries=0`` by default: the oracle surfaces a task's first failure
undisturbed unless asked otherwise); each failure is recorded (a
``task_failed`` decision, and its spans on the merged trace) and handled by
its classification:

- ``CANCELLED`` aborts the compute (no retry, no budget);
- ``FAIL_FAST`` raises at once (a card error that poisons the context
  among them);
- ``RECOMPUTE`` (a corrupt input chunk) re-runs its producer through
  ``RecomputeResolver``, then retries;
- ``RESOURCE`` (the guard, ``MemoryError``, a CUDA out-of-memory) counts,
  and at exhaustion raises ``resource_abort_error``'s actionable error: this
  executor is concurrency 1 already;
- the rest back off (``RetryPolicy.backoff_delay``) and retry, each retry
  drawing on the compute-wide budget.

A failed task on the card is retried on the card: nothing falls back to
the CPU. A loaded compute journal (``journal=``, from
``compute(resume_from_journal=...)``) narrows resume's skips to journal ∩
integrity. This executor keeps op order whatever ``Spec(scheduler=...)``
asks: it is the bitwise reference of the threaded one, and an explicit
``dataflow`` request is logged, as in the reference.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from ...observability.collect import record_decision, record_failed_task
from ...observability.metrics import get_registry
from ..cancellation import abort as cancel_abort
from ..memory import count_resource_failure, resource_abort_error
from ..pipeline import RecomputeResolver, ResumeState, pending_mappable, visit_nodes
from ..resilience import (
    Classification,
    RetryPolicy,
    budget_exhausted_error,
    compute_retry_budget,
    integrity_payload,
    resolve_policy,
)
from ..types import DagExecutor, OperationEndEvent, OperationStartEvent, callbacks_on
from ..utils import chunk_key, execute_with_stats, fire_task_start, handle_callbacks

logger = logging.getLogger(__name__)


def _count_integrity_failure(metrics, exc) -> None:
    """Count a surfaced chunk-integrity failure: the detecting task's scope
    (where the read counted it) is discarded when the task fails. A
    ``checksum`` failure quarantined its file; a ``missing`` one found it
    gone already."""
    metrics.counter("chunks_corrupt_detected").inc()
    payload = integrity_payload(exc)
    if payload and payload.get("kind") == "checksum":
        metrics.counter("chunks_quarantined").inc()
        record_decision("quarantine", store=str(payload.get("store", "")), chunk=payload.get("chunk_key"))


class PythonDagExecutor(DagExecutor):
    """For each op in topological order, run its tasks one by one in-process."""

    def __init__(self, retries: int = 0, retry_policy: Optional[RetryPolicy] = None, **kwargs):
        self.retries = retries
        self.retry_policy = retry_policy
        self.kwargs = kwargs

    @property
    def name(self) -> str:
        return "single-threaded"

    def execute_dag(self, dag, callbacks=None, array_names=None, resume=None, spec=None,
                    retries: Optional[int] = None, retry_policy: Optional[RetryPolicy] = None,
                    journal=None, cancellation=None, **kwargs) -> None:
        from ..dataflow import requested_scheduler

        retries = self.retries if retries is None else retries
        policy = resolve_policy(retry_policy or self.retry_policy, retries)
        budget = compute_retry_budget(policy, dag)
        if requested_scheduler(spec) == "dataflow":
            # only an explicit request is worth a note: dataflow is the
            # threaded executor's default
            logger.debug("scheduler=dataflow requested; the sequential oracle keeps op-level ordering by design")
        metrics = get_registry()
        state = ResumeState(quarantine=True, journal=journal) if resume else None
        resolver = RecomputeResolver(dag)
        for name, node in visit_nodes(dag, resume=resume, state=state):
            primitive_op = node["primitive_op"]
            pipeline = primitive_op.pipeline
            callbacks_on(callbacks, "on_operation_start", OperationStartEvent(name, primitive_op.num_tasks))
            mappable, _ = pending_mappable(name, node, resume, state)
            for m in mappable:
                if cancellation is not None and cancellation.cancelled:
                    raise cancel_abort(cancellation)
                created = time.time()
                key = chunk_key(m)
                failures = 0
                while True:
                    fire_task_start(callbacks, name, chunk_key_str=key, attempt=failures)
                    try:
                        _, stats = execute_with_stats(pipeline.function, m, config=pipeline.config)
                        break
                    except Exception as exc:
                        cls = policy.classify(exc)
                        record_decision("task_failed", op=name, chunk=key, attempt=failures,
                                        error_type=type(exc).__name__, error=str(exc)[:200],
                                        classification=cls.name.lower())
                        record_failed_task(name, key, failures, exc)
                        if cls is Classification.RECOMPUTE:
                            _count_integrity_failure(metrics, exc)
                        if cls is Classification.RESOURCE:
                            count_resource_failure(metrics, exc)
                        failures += 1
                        if cls is Classification.CANCELLED:
                            if cancellation is not None:
                                raise cancel_abort(cancellation) from exc
                            raise
                        # REQUEUE cannot arise in-process: it retries as RETRY
                        if cls is Classification.FAIL_FAST:
                            metrics.counter("task_failfast").inc()
                            raise
                        if failures > policy.retries:
                            if cls is Classification.RESOURCE:
                                raise resource_abort_error(name, exc) from exc
                            raise
                        if not budget.consume():
                            raise budget_exhausted_error(exc, budget) from exc
                        if cls is Classification.RECOMPUTE:
                            # re-run the corrupt chunk's producer, then retry
                            # this task with no backoff
                            repair = resolver.resolve(integrity_payload(exc))
                            if repair is not None:
                                try:
                                    repair()
                                    continue
                                except Exception:
                                    logger.exception("upstream recompute for task %s failed; "
                                                     "falling back to a backoff retry", key)
                        delay = policy.backoff_delay(failures)
                        logger.info("retrying task %s (attempt %d) in %.3fs", key, failures + 1, delay)
                        metrics.counter("task_retries").inc()
                        metrics.histogram("retry_backoff_s").observe(delay)
                        record_decision("retry", op=name, chunk=key, attempt=failures, delay_s=round(delay, 4))
                        if delay > 0:
                            time.sleep(delay)
                handle_callbacks(callbacks, dict(
                    stats, array_name=name, task_create_tstamp=created, chunk_key=key,
                    attempt=failures, executor=self.name,
                ))
            callbacks_on(callbacks, "on_operation_end", OperationEndEvent(name, primitive_op.num_tasks))
