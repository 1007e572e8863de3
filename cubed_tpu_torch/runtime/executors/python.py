"""Sequential in-process executor. Counterpart of
``cubed_tpu/runtime/executors/python.py``, without retries, resume or the
metrics registry: each op's tasks run one by one, ops in topological order,
each task writing its output chunk to storage."""

from __future__ import annotations

import time

from ..pipeline import visit_nodes
from ..types import (
    DagExecutor,
    OperationEndEvent,
    OperationStartEvent,
    TaskEndEvent,
    callbacks_on,
)
from ..utils import fire_task_start


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
                fire_task_start(callbacks, name)
                t0 = time.time()
                pipeline.function(m, config=pipeline.config)
                t1 = time.time()
                callbacks_on(callbacks, "on_task_end", TaskEndEvent(
                    array_name=name, task_create_tstamp=t0, function_start_tstamp=t0,
                    function_end_tstamp=t1, task_result_tstamp=t1, executor=self.name,
                ))
            callbacks_on(callbacks, "on_operation_end",
                         OperationEndEvent(name, primitive_op.num_tasks))
