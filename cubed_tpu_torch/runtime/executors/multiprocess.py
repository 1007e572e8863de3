"""Process-pool executor: tasks run in spawned worker processes.

Counterpart of ``cubed_tpu/runtime/executors/multiprocess.py``. What
crosses the process boundary is the reference's ``(function, input,
config)`` triple; the port ships it with ``runtime/payload.py`` on the
stdlib's ``pickle`` (closures and lambdas by value), where the JAX package
uses ``cloudpickle``. All data between tasks moves through the shared Zarr
store. Retries, backups and the dataflow scheduler are the threaded
executor's ``map_unordered``.

What in-process executors cannot exercise:

- the payload's serializability (what a fleet ships to a worker);
- idempotent whole-chunk writes surviving duplicate and backup tasks;
- a worker process dying: it breaks the whole ``ProcessPoolExecutor``
  (stdlib semantics), so the executor rebuilds the pool and re-runs what
  had not completed (the op's tasks, or under the dataflow scheduler the
  graph's pending ones), with half the workers after an OOM-shaped death.

The chunk device. Workers are started with ``spawn`` (a forked child must
not inherit a CUDA context) and set the parent's chunk device (or
``device=``) in the pool's initializer, before any task: a worker asked for
``cuda`` without a card fails every task with that error, and never runs on
the CPU. With ``cuda`` the parent builds every kernel library before it
spawns, so workers only load them. A worker's kernel launches are not in
the parent's counts: each task's stats carry its worker's launches and
device, summed in ``stats["worker_launches"]`` and per worker in
``stats["workers"]``.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import logging
import os
from collections import OrderedDict
from typing import Optional

from ...observability.metrics import get_registry
from ..dataflow import DataflowScheduler, effective_scheduler, record_scheduler_mode
from ..memory import AdmissionController
from ..pipeline import RecomputeResolver, ResumeState, pending_mappable, visit_node_generations, visit_nodes
from ..resilience import DEFAULT_RETRIES, RetryPolicy, budget_exhausted_error, resolve_policy
from ..types import DagExecutor, OperationEndEvent, OperationStartEvent, callbacks_on
from ..utils import WorkerTally, build_before_spawn, end_generation, execute_in_worker, merge_generation
from .python_async import compute_retry_budget, map_unordered

logger = logging.getLogger(__name__)


#: worker exit codes that read as the kernel OOM killer's work: -9 is a
#: SIGKILL-terminated multiprocessing child (negative signal convention),
#: 137 is the 128+SIGKILL form a worker that re-execs (or an injected
#: ``os._exit(137)`` chaos crash) reports
_OOM_EXITCODES = (-9, 137)


def _dead_worker_exitcodes(pool) -> list:
    """Nonzero exit codes of a broken pool's worker processes.

    A pool crash is reported cause-less ("worker process died"); the
    exit code distinguishes an OOM-kill (SIGKILL, -9) from a segfault or a
    plain exit, which decides whether the rebuild should also step
    concurrency down. Reaches into ``pool._processes`` (stdlib-private but
    stable since 3.7); best-effort — an empty list just means no
    diagnosis, never an error. Polls briefly: BrokenProcessPool can escape
    to the caller before the dead child is reaped (exitcode still None),
    and a definite code is worth a short wait."""
    import time

    try:
        procs = list((pool._processes or {}).values())
    except Exception:
        return []
    for _ in range(10):
        codes = []
        unreaped = False
        for p in procs:
            try:
                code = p.exitcode
            except Exception:
                continue
            if code is None:
                unreaped = True
            elif code not in (0, -15):
                # -15 (SIGTERM) is the pool's own terminate_broken cleanup
                # tearing down SURVIVORS — reporting it would misattribute
                # the crash to a worker that died of the cleanup
                codes.append(code)
        if codes or not unreaped:
            return codes
        time.sleep(0.05)
    return codes


def exitcode_hint(codes) -> str:
    """Human-readable rendering of dead-worker exit codes, with the
    "likely OOM-killed" hint for SIGKILL shapes."""
    if not codes:
        return "unknown exit code"
    parts = []
    for c in codes:
        if c in _OOM_EXITCODES:
            parts.append(f"{c} — likely OOM-killed (SIGKILL)")
        else:
            parts.append(str(c))
    return "exitcode " + ", ".join(parts)


#: this worker process's chunk device setting, and the error setting it
#: raised (every task then fails with it)
_WORKER_DEVICE_ERROR: Optional[BaseException] = None
#: decoded (function, config) pairs of this worker process, by blob digest
_DECODED: "OrderedDict[str, tuple]" = OrderedDict()
_DECODED_CAP = 64


def _init_worker(device: Optional[str]) -> None:
    """The pool's initializer: pin and ready the parent's chunk device
    before any task runs. An error (``cuda`` with no card) is kept, and
    every task of this worker raises it: the compute fails, nothing runs
    elsewhere."""
    global _WORKER_DEVICE_ERROR
    from ..utils import prepare_worker_device

    try:
        prepare_worker_device(device)
    except Exception as e:
        _WORKER_DEVICE_ERROR = e


class _ProcessTaskRunner:
    """Picklable callable handed to the process pool: carries the op's
    ``(function, config)`` payload and decodes it in the worker (once per
    worker process)."""

    def __init__(self, function, config):
        from ..payload import dumps

        self.blob = dumps((function, config))
        self.digest = hashlib.sha1(self.blob).hexdigest()

    def prepare(self, _item=None) -> tuple:
        """The decoded ``(function, config)``, decoded once per worker."""
        pair = _DECODED.get(self.digest)
        if pair is None:
            from ..payload import loads

            pair = _DECODED[self.digest] = loads(self.blob)
            while len(_DECODED) > _DECODED_CAP:
                _DECODED.popitem(last=False)
        return pair

    def __call__(self, m):
        if _WORKER_DEVICE_ERROR is not None:
            raise _WORKER_DEVICE_ERROR
        function, config = self.prepare()
        if config is not None:
            return function(m, config=config)
        return function(m)


class _GenerationTask:
    """Dispatcher for interleaved items ``(op name, m)``: a task ships only
    its own op's runner (:meth:`for_item`), not every op's payload."""

    def __init__(self, runners):
        self.runners = runners

    def for_item(self, item) -> "_ItemTask":
        return _ItemTask(self.runners[item[0]])


class _ItemTask:
    """One op's runner called with an ``(op name, m)`` item."""

    def __init__(self, runner: _ProcessTaskRunner):
        self.runner = runner

    def prepare(self, _item=None) -> tuple:
        return self.runner.prepare()

    def __call__(self, item):
        return self.runner(item[1])


def _run_pool_task(runner, item, **kwargs):
    """A pool worker's task: the op's payload decoded first (outside the
    task's scope and guard, as a fleet worker decodes its blob), then the
    task through ``utils.execute_in_worker``, whose stats carry the
    worker's device and kernel launches."""
    prepare = getattr(runner, "prepare", None)
    if prepare is not None:
        prepare(item)
    return execute_in_worker(runner, item, **kwargs)


class _WorkerPool:
    """The process pool as ``map_unordered`` drives it (each task through
    :func:`_run_pool_task`)."""

    def __init__(self, pool: concurrent.futures.ProcessPoolExecutor):
        self.pool = pool

    def submit(self, _stats_wrapper, function, item, **kwargs):
        if isinstance(function, _GenerationTask):
            function = function.for_item(item)
        return self.pool.submit(_run_pool_task, function, item, **kwargs)


class MultiprocessDagExecutor(DagExecutor):
    """Process-pool executor: process isolation with retries and backups.

    Parameters are the threaded executor's; ``max_workers`` defaults to the
    CPU count, ``device`` to the caller's chunk device.
    ``compute_arrays_in_parallel=True`` interleaves the tasks of the ops of
    one topological generation (under the ``oplevel`` scheduler).
    """

    def __init__(
        self,
        max_workers: Optional[int] = None,
        retries: int = DEFAULT_RETRIES,
        use_backups: bool = False,
        batch_size: Optional[int] = None,
        compute_arrays_in_parallel: bool = False,
        retry_policy: Optional[RetryPolicy] = None,
        device: Optional[str] = None,
        **kwargs,
    ):
        self.max_workers = max_workers or os.cpu_count() or 1
        self.retries = retries
        self.use_backups = use_backups
        self.batch_size = batch_size
        self.compute_arrays_in_parallel = compute_arrays_in_parallel
        self.retry_policy = retry_policy
        self.device = device
        self.kwargs = kwargs
        self._tally = WorkerTally()

    @property
    def name(self) -> str:
        return "processes"

    @property
    def stats(self) -> dict:
        """The last compute's worker reports: ``workers`` (per worker pid:
        device, tasks, kernel launches) and ``worker_launches`` (summed)."""
        snap = self._tally.snapshot()
        return {"workers": snap["workers"], "worker_launches": snap["launches"]}

    def _worker_device(self) -> str:
        if self.device is not None:
            return str(self.device)
        from ...backend_array_api import get_device

        return str(get_device())

    def execute_dag(self, dag, callbacks=None, array_names=None, resume=None, spec=None,
                    retries: Optional[int] = None, use_backups: Optional[bool] = None,
                    batch_size: Optional[int] = None, compute_arrays_in_parallel: Optional[bool] = None,
                    retry_policy: Optional[RetryPolicy] = None, journal=None, cancellation=None,
                    **kwargs) -> None:
        retries = self.retries if retries is None else retries
        use_backups = self.use_backups if use_backups is None else use_backups
        batch_size = self.batch_size if batch_size is None else batch_size
        if compute_arrays_in_parallel is None:
            compute_arrays_in_parallel = self.compute_arrays_in_parallel
        policy = resolve_policy(retry_policy or self.retry_policy, retries)
        budget = compute_retry_budget(policy, dag)
        # one per compute: an OOM-killed worker steps admission down for
        # every later op, not just the one that crashed
        admission = AdmissionController()
        state = ResumeState(quarantine=True, journal=journal) if resume else None
        # an integrity failure found in a worker arrives pickled; its repair
        # re-runs the producer here, against the shared store
        resolver = RecomputeResolver(dag)
        self._tally = WorkerTally()
        device = self._worker_device()
        build_before_spawn(device)

        # spawn, not fork: a worker must not inherit a CUDA context
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        pool = self._new_pool(ctx, self.max_workers, device)
        scheduler = effective_scheduler(spec, batch_size)
        record_scheduler_mode(scheduler, executor=self.name)
        common = dict(policy=policy, budget=budget, use_backups=use_backups, callbacks=callbacks,
                      executor_name=self.name, recompute_resolver=resolver, admission=admission,
                      cancellation=cancellation, worker_tally=self._tally, device=device)
        try:
            if scheduler == "dataflow":
                # one dependency-gated map over the whole DAG; a re-run after
                # a pool crash resumes from the scheduler's done set
                if batch_size:
                    logger.warning('batch_size=%s is ignored under scheduler="dataflow" (the whole DAG is one '
                                   "dependency-gated map)", batch_size)
                sched = DataflowScheduler(dag, resume=resume, state=state, callbacks=callbacks)
                sched.start()
                try:
                    runners = {name: _ProcessTaskRunner(p.function, p.config) for name, p in sched.pipelines.items()}
                    pool = self._map_surviving_pool_crash(
                        pool, ctx, _GenerationTask(runners), sched.items, batch_size=None,
                        array_names=sched.array_names, dependencies=sched.dependencies,
                        on_input_submit=sched.on_submit, on_input_done=sched.on_done,
                        completed_inputs=sched.completed, **common)
                finally:
                    sched.finish()
            elif compute_arrays_in_parallel:
                for generation in visit_node_generations(dag, resume=resume, state=state):
                    merged, pipelines = merge_generation(generation, callbacks, resume=resume, resume_state=state)
                    runners = {name: _ProcessTaskRunner(p.function, p.config) for name, p in pipelines.items()}
                    pool = self._map_surviving_pool_crash(
                        pool, ctx, _GenerationTask(runners), merged, batch_size=batch_size,
                        array_names=[m[0] for m in merged], **common)
                    end_generation(generation, callbacks)
            else:
                for name, node in visit_nodes(dag, resume=resume, state=state):
                    primitive_op = node["primitive_op"]
                    pipeline = primitive_op.pipeline
                    callbacks_on(callbacks, "on_operation_start", OperationStartEvent(name, primitive_op.num_tasks))
                    mappable, _ = pending_mappable(name, node, resume, state)
                    pool = self._map_surviving_pool_crash(
                        pool, ctx, _ProcessTaskRunner(pipeline.function, pipeline.config), list(mappable),
                        batch_size=batch_size, array_name=name, **common)
                    callbacks_on(callbacks, "on_operation_end", OperationEndEvent(name, primitive_op.num_tasks))
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    @staticmethod
    def _new_pool(ctx, workers: int, device: str) -> concurrent.futures.ProcessPoolExecutor:
        return concurrent.futures.ProcessPoolExecutor(max_workers=workers, mp_context=ctx,
                                                      initializer=_init_worker, initargs=(device,))

    def _map_surviving_pool_crash(
        self, pool, ctx, fn, inputs, *, policy=None, budget=None,
        retries=None, device=None, **map_kwargs,
    ):
        """map_unordered, rebuilding the pool when a worker death breaks it.

        A dead worker (OOM-kill, segfault) permanently breaks a stdlib
        ProcessPoolExecutor; every op task is an idempotent whole-chunk
        write, so the whole op is safely re-run on a fresh pool. Returns the
        (possibly new) pool for subsequent ops. Pool rebuilds follow the
        retry policy: they are infrastructure failures, so each rebuild
        waits out a backoff delay (a crashing-on-load input would otherwise
        respawn the pool in a tight loop) and draws on the compute's retry
        budget so systemic crash loops abort promptly.

        The dead workers' exit codes are captured before the broken pool is
        discarded: a SIGKILL shape (-9/137) reads as the kernel OOM killer
        (``worker_oom_kills``), so the rebuilt pool comes back with HALF
        the workers — re-running the same op at full process parallelism
        would feed the same pressure that killed it — and the compute's
        admission controller steps down with it. Other codes rebuild at
        full size with the code in the log line instead of today's
        cause-less generic rebuild.

        Under the dataflow scheduler the re-run skips the tasks that
        completed before the crash (``completed_inputs``). Op by op, a re-run
        fires ``on_task_end`` again for tasks that completed before the crash,
        so progress counters can exceed num_tasks across pool-crash retries:
        the at-least-once event semantics of speculative backups.
        """
        import time

        from concurrent.futures.process import BrokenProcessPool

        policy = resolve_policy(policy, retries)
        if budget is None:
            budget = policy.new_budget(len(inputs))
        retries = policy.retries
        admission = map_kwargs.get("admission")
        workers = getattr(pool, "_max_workers", self.max_workers)
        for attempt in range(retries + 1):
            try:
                map_unordered(
                    _WorkerPool(pool), fn, inputs, retry_policy=policy,
                    retry_budget=budget, **map_kwargs,
                )
                return pool
            except BrokenProcessPool as exc:
                codes = _dead_worker_exitcodes(pool)
                pool.shutdown(wait=False, cancel_futures=True)
                if attempt == retries:
                    raise  # caller's finally shuts down this (dead) pool
                if not budget.consume():
                    raise budget_exhausted_error(exc, budget) from exc
                oom = any(c in _OOM_EXITCODES for c in codes)
                if oom:
                    get_registry().counter("worker_oom_kills").inc()
                    workers = max(1, workers // 2)
                    if admission is not None:
                        admission.step_down(workers * 2)
                delay = policy.backoff_delay(attempt + 1)
                get_registry().counter("pool_rebuilds").inc()
                get_registry().histogram("retry_backoff_s").observe(delay)
                from ...observability.collect import record_decision

                record_decision(
                    "pool_rebuild", exitcodes=codes, workers=workers,
                    oom=oom, delay_s=round(delay, 4),
                )
                logger.warning(
                    "worker process died (%s); rebuilding pool with %d "
                    "worker(s) in %.3fs, re-running op (attempt %d/%d)",
                    exitcode_hint(codes), workers, delay,
                    attempt + 2, retries + 1,
                )
                if delay > 0:
                    time.sleep(delay)
                pool = self._new_pool(ctx, workers, device)
        return pool


