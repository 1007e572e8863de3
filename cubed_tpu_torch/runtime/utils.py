"""Task execution instrumentation: wall time, peak host memory and storage
bytes per task.

Counterpart of ``cubed_tpu/runtime/utils.py``: the stats dict a task
returns carries the bytes it moved and the spans it recorded, measured in
whichever process ran it (``observability/accounting.py``).
"""

from __future__ import annotations

import hashlib
import itertools
import os
import time
from functools import partial
from typing import Iterable, Iterator, Optional, Sequence

from ..observability import clock, logs
from ..observability.accounting import get_process_label, spans_enabled, task_scope
from ..observability.metrics import get_registry
from ..utils import peak_measured_mem
from .types import Callback, OperationEndEvent, OperationStartEvent, TaskEndEvent, TaskStartEvent, callbacks_on


def execute_with_stats(function, *args, **kwargs):
    """Run a task function, returning (result, stats-dict).

    The body runs inside a task scope (its storage bytes and spans) and a
    log context (its op and chunk). This is the one chokepoint where the
    reliability layers wrap every task, as in the reference
    (``cubed_tpu/runtime/utils.py:52-80``): the compute's cancellation check
    before the body; the fault injector's task sites (a straggler delay or
    an injected failure, and a synthetic memory spike handed to the guard);
    and the memory guard (``runtime/memory.task_guard``) around the body,
    whose reading (``guard_mem_peak``: on a CUDA device the allocator's peak
    over the task's start, else RSS growth) joins the stats dict and, under
    ``memory_guard="enforce"``, fails a task over ``allowed_mem``.
    """
    from .cancellation import check_current
    from .faults import get_injector
    from .memory import task_guard

    peak_before = peak_measured_mem()
    start = None
    try:
        with task_scope() as scope:
            # a tripped token aborts before the body runs; the storage layer
            # checks again between chunk reads and writes
            check_current()
            injector = get_injector()
            key = chunk_key(args[0]) if args else ""
            # blockwise mappable items are (out_name, i, j, ...) tuples: the
            # first element names the op's output array
            op = None
            if args and isinstance(args[0], tuple) and args[0]:
                op = str(args[0][0])
            spike = injector.task_mem_spike(key) if injector is not None else 0
            with logs.task_context(op=op, chunk=key):
                with task_guard(key, injected_bytes=spike) as guard:
                    start = clock.now()
                    # an injected straggler delay is part of the task's time
                    if injector is not None:
                        injector.task_fault(key)
                    result = function(*args, **kwargs)
                    end = clock.now()
    except Exception as e:
        # a raising task produces no stats dict, so its span buffer would
        # vanish: attach it to the exception (the attribute survives
        # pickling), for collect.record_failed_task. Only when spans are
        # armed: an unobserved compute adds nothing to its exceptions.
        if spans_enabled():
            try:
                now_ts = clock.now()
                e.cubed_tpu_torch_task_stats = dict(
                    function_start_tstamp=start if start is not None else now_ts,
                    function_end_tstamp=now_ts,
                    pid=os.getpid(),
                    worker=get_process_label(),
                    error_type=type(e).__name__,
                    **scope.stats(),
                )
            except Exception:
                pass  # salvage must never mask the task's own failure
        raise
    peak_after = peak_measured_mem()
    return result, dict(
        function_start_tstamp=start,
        function_end_tstamp=end,
        peak_measured_mem_start=peak_before,
        peak_measured_mem_end=peak_after,
        pid=os.getpid(),
        worker=get_process_label(),
        **guard.stats(),
        **scope.stats(),
    )


#: the stats key under which a worker process reports its chunk device and
#: the kernel launches of the task (popped before the task's end event)
WORKER_REPORT_KEY = "worker_report"


def execute_in_worker(function, *args, **kwargs):
    """:func:`execute_with_stats` in a pool or fleet worker process, whose
    kernel launches the client's counts do not see: the stats also carry
    the worker's chunk device and the launches the task made, by wrapper."""
    from ..backend_array_api import get_device
    from ..kernels._build import launch_counts

    before = launch_counts()
    result, stats = execute_with_stats(function, *args, **kwargs)
    after = launch_counts()
    launches = {name: n - before.get((name, path), 0) for (name, path), n in after.items() if path is None}
    stats[WORKER_REPORT_KEY] = {"device": str(get_device()),
                                "launches": {k: v for k, v in launches.items() if v}}
    return result, stats


def prepare_worker_device(device: Optional[str]) -> str:
    """Pin a pool or fleet worker's chunk device (``None`` keeps the
    environment's) and ready it before the first task: on the card, the
    CUDA context, the kernel libraries and torch's common elementwise,
    copy and reduction kernels (which CUDA loads at their first use), so
    that a task's guarded reading does not hold the process's one-time
    loads. Raises where the device is absent; returns its name."""
    from ..backend_array_api import get_device, set_device

    if device is not None:
        set_device(device)
    dev = get_device()
    if dev.type == "cuda":
        import torch

        from ..kernels import _build

        for name in _build.SOURCES:
            _build.load(name)
        for dtype in (torch.float64, torch.float32, torch.int64):
            t = torch.ones((4, 4), dtype=dtype, device=dev)
            u = torch.cat([t[1:], t[:1]]).contiguous() * 2 + t - t / 2
            (u.sum(), u.sum(dim=0), u.mean(dim=(0,)) if dtype.is_floating_point else u.max(), u.amax(0),
             torch.where(u > 1, u, t), u.to(torch.float64).cpu())
        torch.cuda.synchronize(dev)
    return str(dev)


def build_before_spawn(device: str) -> None:
    """Build every kernel library here before worker processes start on
    *device*, so that they only load them and never race each other's nvcc
    runs. Nothing is built without a card in this process: a worker asked
    for ``cuda`` then fails its own device check."""
    if device.startswith("cuda"):
        import torch

        if torch.cuda.is_available():
            from ..kernels._build import build_all

            build_all()


class WorkerTally:
    """What an executor's worker processes reported: each worker's chunk
    device, tasks and kernel launches, and the launches summed."""

    def __init__(self):
        self.workers: dict = {}
        self.launches: dict = {}

    def add(self, worker, pid, report: dict) -> None:
        row = self.workers.setdefault(str(worker or pid), {"device": None, "tasks": 0, "launches": {}})
        row["device"] = report.get("device")
        row["tasks"] += 1
        for name, n in (report.get("launches") or {}).items():
            row["launches"][name] = row["launches"].get(name, 0) + n
            self.launches[name] = self.launches.get(name, 0) + n

    def snapshot(self) -> dict:
        return {"workers": {k: dict(v, launches=dict(v["launches"])) for k, v in self.workers.items()},
                "launches": dict(self.launches)}


def execution_stats(function):
    """Decorator adding timing/memory stats to a task function's return value."""
    return partial(execute_with_stats, function)


def handle_callbacks(callbacks: Optional[Sequence[Callback]], stats: dict) -> None:
    if not callbacks:
        return
    if "task_result_tstamp" not in stats:
        stats = dict(stats, task_result_tstamp=time.time())
    callbacks_on(callbacks, "on_task_end", TaskEndEvent(**stats))


def chunk_key(task_input) -> str:
    """A short, human-readable key for a task's mappable item. A long key is
    shortened to a prefix and a digest of the whole, so distinct keys stay
    distinct."""
    try:
        s = str(task_input)
    except Exception:
        s = object.__repr__(task_input)
    if len(s) <= 120:
        return s
    digest = hashlib.sha1(s.encode("utf-8", "replace")).hexdigest()[:8]
    return f"{s[:108]}...#{digest}"


def _wants_task_start(callbacks) -> bool:
    """True if any callback overrides ``on_task_start`` (beyond the base
    no-op): hot loops skip building the event otherwise."""
    for cb in callbacks:
        fn = getattr(cb, "on_task_start", None)
        if fn is None:
            continue
        if getattr(fn, "__func__", None) is not Callback.on_task_start:
            return True
    return False


def fire_task_start(
    callbacks,
    array_name: str,
    task_input=None,
    attempt: int = 0,
    backup: bool = False,
    chunk_key_str: Optional[str] = None,
    key_fn=None,
    num_tasks: int = 1,
) -> None:
    """Count a submitted task attempt (``tasks_started``) and fire
    ``on_task_start``. The event, with its chunk key (``chunk_key_str``, a
    lazy ``key_fn`` or ``task_input``), is built only when some callback
    observes task starts."""
    get_registry().counter("tasks_started").inc(num_tasks)
    if not callbacks or not _wants_task_start(callbacks):
        return
    if chunk_key_str is None:
        if key_fn is not None:
            chunk_key_str = key_fn()
        elif task_input is not None:
            chunk_key_str = chunk_key(task_input)
    callbacks_on(
        callbacks,
        "on_task_start",
        TaskStartEvent(
            array_name=array_name,
            num_tasks=num_tasks,
            chunk_key=chunk_key_str,
            attempt=attempt,
            backup=backup,
        ),
    )


def merge_generation(generation, callbacks, resume=None, resume_state=None) -> tuple[list, dict]:
    """Interleave one topological generation's tasks for a single map.

    Fires ``on_operation_start`` for every op of the generation and returns
    ``(items, pipelines)``: the merged ``(op_name, task_input)`` list, and op
    name -> its pipeline. Under ``resume`` the tasks whose output chunks all
    verify are left out (``pipeline.pending_mappable``)."""
    from .pipeline import pending_mappable

    items: list = []
    pipelines: dict = {}
    for name, node in generation:
        primitive_op = node["primitive_op"]
        callbacks_on(callbacks, "on_operation_start", OperationStartEvent(name, primitive_op.num_tasks))
        pipelines[name] = primitive_op.pipeline
        mappable, _skipped = pending_mappable(name, node, resume, resume_state)
        items.extend((name, m) for m in mappable)
    return items, pipelines


def end_generation(generation, callbacks) -> None:
    """Fire ``on_operation_end`` for every op of a completed generation."""
    for name, node in generation:
        callbacks_on(callbacks, "on_operation_end", OperationEndEvent(name, node["primitive_op"].num_tasks))


def batched(iterable: Iterable, n: int) -> Iterator[list]:
    """Yield successive lists of up to *n* items."""
    it = iter(iterable)
    while True:
        batch = list(itertools.islice(it, n))
        if not batch:
            return
        yield batch
