"""Sequential in-process executor. Counterpart of
``cubed_tpu/runtime/executors/python.py``, without retries and resume
(ROADMAP Queue 1 item 9): each op's tasks run one by one, ops in
topological order, each task through ``execute_with_stats`` (its time, peak
host memory, storage bytes and spans) and its stats out through
``handle_callbacks``. A failed task is recorded (a ``task_failed``
decision, and its spans on the merged trace) and fails the compute."""

from __future__ import annotations

import time

from ...observability.collect import record_decision, record_failed_task
from ..pipeline import visit_nodes
from ..types import DagExecutor, OperationEndEvent, OperationStartEvent, callbacks_on
from ..utils import chunk_key, execute_with_stats, fire_task_start, handle_callbacks


class PythonDagExecutor(DagExecutor):
    """For each op in topological order, run its tasks one by one in-process."""

    @property
    def name(self) -> str:
        return "single-threaded"

    def execute_dag(self, dag, callbacks=None, array_names=None, resume=None, spec=None, **kwargs) -> None:
        for name, node in visit_nodes(dag, resume=resume):
            primitive_op = node["primitive_op"]
            pipeline = primitive_op.pipeline
            callbacks_on(callbacks, "on_operation_start",
                         OperationStartEvent(name, primitive_op.num_tasks))
            for m in pipeline.mappable:
                created = time.time()
                key = chunk_key(m)
                fire_task_start(callbacks, name, chunk_key_str=key)
                try:
                    _, stats = execute_with_stats(pipeline.function, m, config=pipeline.config)
                except Exception as exc:
                    record_decision("task_failed", op=name, chunk=key, attempt=0,
                                    error_type=type(exc).__name__, error=str(exc)[:200])
                    record_failed_task(name, key, 0, exc)
                    raise
                handle_callbacks(callbacks, dict(
                    stats, array_name=name, task_create_tstamp=created, chunk_key=key,
                    attempt=0, executor=self.name,
                ))
            callbacks_on(callbacks, "on_operation_end",
                         OperationEndEvent(name, primitive_op.num_tasks))
