"""Threaded executor: a completion-ordered map over a thread pool, with
classified retries, backoff off the completion loop, a compute-wide retry
budget, speculative backups, the dataflow scheduler and admission control.

Counterpart of ``cubed_tpu/runtime/executors/python_async.py``. Each task
runs through ``execute_with_stats`` in a pool thread: its stats, the memory
guard's reading and the fault injector's task sites are the sequential
executor's. Failures are classified (``runtime/resilience.py``):

- ``FAIL_FAST`` fails at once, with one attempt;
- ``RETRY`` and ``THROTTLE`` resubmit after an exponential-backoff delay,
  scheduled on a heap the loop drains, so a sleeping retry never blocks
  the completions of the others; each retry draws on the compute's budget;
- ``RECOMPUTE`` (a corrupt input chunk) re-runs the chunk's producer on a
  small side pool (``pipeline.RecomputeResolver``), then resubmits;
- ``RESOURCE`` halves the admission limit (``memory.AdmissionController``)
  and retries; a task that fails it twice while admitted alone, with
  nothing completing in between, aborts with the actionable error;
- ``REQUEUE`` (a broken pool, a lost fleet worker) reroutes without
  spending a retry, up to the policy's ``max_requeues``; a task whose
  worker died abruptly under it ``max_requeues + 1`` times in a row is
  quarantined with ``PoisonTaskError`` (clean drains, and tasks only queued
  on the dead worker, never count);
- ``CANCELLED``, and a tripped token seen by the dispatch loop, abort the
  compute with the typed error and draw no budget.

Two schedulers (``runtime/dataflow.py``): ``dataflow`` runs the whole DAG as
one map whose ``dependencies`` hold each task until its own input chunks
are written; ``oplevel`` runs op after op (or, with
``compute_arrays_in_parallel``, one topological generation after another).

Threads and the card: pool threads launch on the device's current stream,
which they share, so their kernels run in the order they were queued; each
thread's current CUDA device is its own, and ``get_device()`` names none,
which is the one card of a one-card process. A task that fails on the card
is retried on the card. The compute id's contextvar is not copied into the
pool threads, as in the reference: the dispatch loop, which runs in the
compute's context, is where cancellation is enforced.
"""

from __future__ import annotations

import concurrent.futures
import heapq
import itertools
import logging
import time
from collections import deque
from typing import Callable, Dict, Iterable, Optional

from ...observability.collect import record_decision, record_failed_task
from ...observability.metrics import get_registry
from ..backup import should_launch_backup
from ..cancellation import abort as cancel_abort
from ..dataflow import DataflowScheduler, effective_scheduler, record_scheduler_mode
from ..memory import AdmissionController, count_resource_failure, pressure_level, resource_abort_error
from ..pipeline import RecomputeResolver, ResumeState, pending_mappable, visit_node_generations, visit_nodes
from ..resilience import (
    DEFAULT_RETRIES,
    Classification,
    PoisonTaskError,
    RetryBudget,
    RetryPolicy,
    budget_exhausted_error,
    compute_retry_budget,
    integrity_payload,
    resolve_policy,
)
from ..types import DagExecutor, OperationEndEvent, OperationStartEvent, callbacks_on
from ..utils import (
    WORKER_REPORT_KEY,
    chunk_key,
    end_generation,
    execute_with_stats,
    fire_task_start,
    handle_callbacks,
    merge_generation,
)
from .python import _count_integrity_failure

logger = logging.getLogger(__name__)


def _clean_worker_loss(exc: BaseException) -> bool:
    """True for a worker that left cleanly (a drain or a preemption notice,
    ``WorkerDrainedError``): evidence about the fleet, never the task.
    Matched by class name, so this module needs no fleet import."""
    return any(c.__name__ == "WorkerDrainedError" for c in type(exc).__mro__)


def _overload_sheds_optional() -> bool:
    """True while any live service ``OverloadController`` is at L1 or above:
    speculative backups are pure extra load, shed first. Late import: the
    ladder lives in the service layer, and executors work without it."""
    try:
        from ...service.overload import sheds_optional_work

        return sheds_optional_work()
    except Exception:
        return False


def map_unordered(
    executor: concurrent.futures.Executor,
    function: Callable,
    inputs: Iterable,
    retries: int = DEFAULT_RETRIES,
    use_backups: bool = False,
    batch_size: Optional[int] = None,
    callbacks=None,
    array_name: Optional[str] = None,
    array_names: Optional[list] = None,
    executor_name: Optional[str] = None,
    retry_policy: Optional[RetryPolicy] = None,
    retry_budget: Optional[RetryBudget] = None,
    recompute_resolver=None,
    admission: Optional[AdmissionController] = None,
    dependencies: Optional[Dict[int, set]] = None,
    on_input_submit: Optional[Callable[[int], None]] = None,
    on_input_done: Optional[Callable[[int], None]] = None,
    completed_inputs: Optional[set] = None,
    cancellation=None,
    worker_tally=None,
    **kwargs,
) -> None:
    """Run *function* over *inputs* on *executor*, in completion order, with
    retries and backups.

    ``array_names`` (parallel to *inputs*) names each task's op when tasks of
    several ops share one map. With ``batch_size`` and no ``array_names``,
    inputs are consumed lazily, a batch at a time. ``retry_policy`` governs
    classification and backoff (else one is built around ``retries``);
    ``retry_budget`` shares one allowance across maps (else each batch gets
    its own). ``recompute_resolver`` repairs RECOMPUTE failures;
    ``admission`` bounds tasks in flight under memory pressure (unbounded
    until a RESOURCE failure or hard host pressure halves it).

    ``dependencies`` (the dataflow scheduler) maps an input index to the
    indices that must complete before it is submitted; ``on_input_submit``
    and ``on_input_done`` are per-index hooks; ``completed_inputs`` marks
    inputs done before anything dispatches (their dependents' edges count
    as met). ``cancellation`` is checked on every turn of the loop: a tripped
    token stops submissions, cancels pending futures and raises the typed
    error. ``worker_tally`` (``utils.WorkerTally``) takes the device and
    kernel launches a worker process reports with each task's stats.
    """
    policy = resolve_policy(retry_policy, retries)
    if admission is None:
        admission = AdmissionController()
    if dependencies and batch_size is not None:
        raise ValueError("dependencies (dataflow scheduling) and batch_size are mutually exclusive: "
                         "batching would split the dependency index space")
    common = dict(use_backups=use_backups, callbacks=callbacks, array_name=array_name,
                  executor_name=executor_name, recompute_resolver=recompute_resolver, admission=admission,
                  cancellation=cancellation, worker_tally=worker_tally, **kwargs)
    if array_names is not None:
        inputs = list(inputs)
        if len(array_names) != len(inputs):
            raise ValueError(f"array_names has {len(array_names)} entries for {len(inputs)} inputs")
    if batch_size is None:
        _map_unordered_batch(executor, function, list(inputs), policy, retry_budget, array_names=array_names,
                             dependencies=dependencies, on_input_submit=on_input_submit,
                             on_input_done=on_input_done, completed_inputs=completed_inputs, **common)
    elif array_names is None:
        it = iter(inputs)
        while True:
            batch = list(itertools.islice(it, batch_size))
            if not batch:
                break
            _map_unordered_batch(executor, function, batch, policy, retry_budget, **common)
    else:
        for start in range(0, len(inputs), batch_size):
            _map_unordered_batch(executor, function, inputs[start:start + batch_size], policy, retry_budget,
                                 array_names=array_names[start:start + batch_size], **common)


def _map_unordered_batch(
    executor,
    function,
    inputs: list,
    policy: RetryPolicy,
    budget: Optional[RetryBudget],
    use_backups: bool = False,
    callbacks=None,
    array_name=None,
    array_names: Optional[list] = None,
    executor_name: Optional[str] = None,
    recompute_resolver=None,
    admission: Optional[AdmissionController] = None,
    dependencies: Optional[Dict[int, set]] = None,
    on_input_submit: Optional[Callable[[int], None]] = None,
    on_input_done: Optional[Callable[[int], None]] = None,
    completed_inputs: Optional[set] = None,
    cancellation=None,
    worker_tally=None,
    **kwargs,
) -> None:
    metrics = get_registry()
    retries = policy.retries
    if budget is None:
        budget = policy.new_budget(len(inputs))
    if admission is None:
        admission = AdmissionController()
    attempts: Dict[int, int] = {i: 0 for i in range(len(inputs))}
    #: free reroutes after a broken pool or a lost worker, per input
    requeues: Dict[int, int] = {}
    #: abrupt worker deaths under each input (never clean drains): one
    #: input taking out max_requeues + 1 workers in a row is poison
    fatal_strikes: Dict[int, int] = {}
    #: min-heap of (due time, input) retries waiting out their backoff
    delayed: list = []
    #: inputs ready to run, waiting for an admission slot
    admit_queue: deque = deque()
    #: input -> (RESOURCE failures while admitted alone, completed inputs at
    #: the last one): fatal only on repetition with no progress in between
    floor_strikes: Dict[int, tuple] = {}
    start_times: Dict[object, float] = {}
    end_times: Dict[object, float] = {}
    create_times: Dict[int, float] = {}
    #: the dispatch ledger: when each input became dispatchable, and each
    #: future's submit stamps
    ready_times: Dict[int, float] = {}
    submit_meta: Dict[concurrent.futures.Future, dict] = {}
    #: the last submits' cost: the dispatch_capacity_estimate gauge
    dispatch_costs: deque = deque(maxlen=64)
    #: future -> (input, is backup, attempt submitted as, admission limit at
    #: submit: None is unbounded)
    pending: Dict[concurrent.futures.Future, tuple] = {}
    backups: Dict[int, list] = {}
    done_inputs: set = set()
    #: input -> its producer's repair (RECOMPUTE), on a side pool so a
    #: re-run never stalls the completion loop
    repairing: Dict[int, concurrent.futures.Future] = {}
    repair_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None

    if completed_inputs:
        done_inputs.update(i for i in completed_inputs if 0 <= i < len(inputs))

    #: dataflow gating: input -> its unmet dependencies, and the reverse map
    #: that releases dependents when an input completes
    blocked: Dict[int, set] = {}
    dependents: Dict[int, list] = {}
    if dependencies:
        for i, deps in dependencies.items():
            if i in done_inputs:
                continue
            rem = {d for d in deps if d != i and 0 <= d < len(inputs) and d not in done_inputs}
            if rem:
                blocked[i] = rem
                for d in rem:
                    dependents.setdefault(d, []).append(i)

    key_cache: Dict[int, str] = {}

    def op_of(i: int) -> str:
        return array_names[i] if array_names is not None else array_name

    def key_of(i: int) -> str:
        key = key_cache.get(i)
        if key is None:
            # interleaved items are (op_name, task_input) pairs
            m = inputs[i][1] if array_names is not None else inputs[i]
            key = key_cache[i] = chunk_key(m)
        return key

    def submit(i: int, is_backup: bool = False):
        # everything from here to executor.submit runs on the dispatch loop:
        # its duration is per-task dispatch cost
        t_dispatch = time.perf_counter()
        if on_input_submit is not None:
            on_input_submit(i)
        submitted_ts = time.time()
        create_times.setdefault(i, submitted_ts)
        ready_times.setdefault(i, submitted_ts)
        fire_task_start(callbacks, op_of(i), key_fn=lambda: key_of(i), attempt=attempts[i], backup=is_backup)
        fut = executor.submit(execute_with_stats, function, inputs[i], **kwargs)
        cost = time.perf_counter() - t_dispatch
        submit_meta[fut] = {"ready_tstamp": ready_times.get(i, submitted_ts), "submitted_tstamp": submitted_ts,
                            "submit_cost_s": cost}
        dispatch_costs.append(cost)
        metrics.counter("dispatch_submit_s").inc(cost)
        start_times[fut] = time.time()
        # the attempt rides with the future: a backup submitted as attempt
        # 0 can win after the original failed and bumped attempts[i]
        pending[fut] = (i, is_backup, attempts[i], admission.limit)
        if is_backup:
            backups.setdefault(i, []).append(fut)
        return fut

    def cancel_pending() -> None:
        for f in pending:
            f.cancel()

    def resubmit(i: int) -> None:
        try:
            submit(i)
        except Exception:
            cancel_pending()
            raise

    def admit(i: int) -> None:
        """Submit *i* now, or queue it while the admission limit is reached."""
        now_ts = time.time()
        create_times.setdefault(i, now_ts)
        ready_times.setdefault(i, now_ts)
        if not admit_queue and admission.has_slot(len(pending)):
            resubmit(i)
            return
        metrics.counter("tasks_throttled").inc()
        admit_queue.append(i)

    def drain_admit_queue() -> None:
        while admit_queue and admission.has_slot(len(pending)):
            i = admit_queue.popleft()
            if i not in done_inputs:
                resubmit(i)

    def release_dependents(i_done: int) -> None:
        """Admit the tasks whose last dependency just completed."""
        for j in dependents.get(i_done, ()):
            rem = blocked.get(j)
            if rem is None:
                continue
            rem.discard(i_done)
            if not rem:
                del blocked[j]
                if j not in done_inputs:
                    admit(j)

    for i in range(len(inputs)):
        if i not in blocked and i not in done_inputs:
            admit(i)

    #: the loop's busy share (dispatch_utilization): time blocked in the
    #: completion waits and backoff sleeps is idle
    util_t0 = time.time()
    util_idle_s = 0.0

    try:
        while pending or delayed or repairing or admit_queue or blocked:
            now = time.time()
            if cancellation is not None and cancellation.cancelled:
                cancel_pending()
                raise cancel_abort(cancellation)
            while delayed and delayed[0][0] <= now:
                _, i = heapq.heappop(delayed)
                if i not in done_inputs:
                    admit(i)
            # hard host pressure steps concurrency down before a task dies
            if pressure_level() == "hard":
                admission.on_pressure(len(pending))
            drain_admit_queue()
            # readers whose repair finished resubmit; a failed repair falls
            # back to a backoff retry
            for ri, rfut in [(k, f) for k, f in repairing.items() if f.done()]:
                del repairing[ri]
                if ri in done_inputs:
                    continue
                rexc = rfut.exception()
                if rexc is None:
                    admit(ri)
                else:
                    rdelay = policy.backoff_delay(attempts[ri])
                    logger.warning("upstream recompute for input %s failed (%r); retrying the reader in %.3fs",
                                   ri, rexc, rdelay)
                    heapq.heappush(delayed, (now + rdelay, ri))
            metrics.gauge("queue_depth").set(len(pending))
            now_util = time.time()
            if now_util - util_t0 >= 0.5:
                elapsed = now_util - util_t0
                metrics.gauge("dispatch_utilization").set(max(0.0, min(1.0, 1.0 - util_idle_s / elapsed)))
                if dispatch_costs:
                    mean_cost = sum(dispatch_costs) / len(dispatch_costs)
                    if mean_cost > 0:
                        metrics.gauge("dispatch_capacity_estimate").set(1.0 / mean_cost)
                util_t0 = now_util
                util_idle_s = 0.0
            if not pending:
                # nothing in flight: sleep until a retry is due or a repair
                # lands
                if delayed:
                    t_idle = time.perf_counter()
                    time.sleep(max(0.0, min(delayed[0][0] - time.time(), 0.25)))
                    util_idle_s += time.perf_counter() - t_idle
                elif repairing:
                    t_idle = time.perf_counter()
                    concurrent.futures.wait(list(repairing.values()), timeout=0.25)
                    util_idle_s += time.perf_counter() - t_idle
                elif admit_queue:
                    continue
                elif blocked:
                    # nothing runs or is due, yet tasks wait on dependencies:
                    # a cyclic or miswired chunk graph
                    raise RuntimeError(f"dataflow deadlock: {len(blocked)} task(s) blocked on dependencies that can "
                                       f"no longer complete (first blocked inputs: {sorted(blocked)[:5]})")
                continue
            timeout = 2.0
            if cancellation is not None:
                # notice a cancel or a deadline within a fraction of a second
                timeout = 0.25
                rem = cancellation.remaining()
                if rem is not None:
                    timeout = max(0.01, min(timeout, rem))
            if delayed:
                timeout = max(0.01, min(timeout, delayed[0][0] - now))
            if repairing:
                timeout = min(timeout, 0.05)
            t_idle = time.perf_counter()
            done, _ = concurrent.futures.wait(list(pending), timeout=timeout,
                                              return_when=concurrent.futures.FIRST_COMPLETED)
            util_idle_s += time.perf_counter() - t_idle
            now = time.time()
            for fut in done:
                entry = pending.pop(fut, None)
                meta = submit_meta.pop(fut, None)
                if entry is None:
                    continue  # a twin the winner's cancel loop removed
                i, is_backup, attempt, limit_at_submit = entry
                end_times[fut] = now
                if i in done_inputs:
                    continue  # a twin already won
                exc = fut.exception()
                if exc is not None:
                    twins = [f for f in pending if pending[f][0] == i]
                    cls = policy.classify(exc)
                    record_decision("task_failed", op=op_of(i), chunk=key_of(i), attempt=attempt,
                                    error_type=type(exc).__name__, error=str(exc)[:200],
                                    classification=cls.name.lower())
                    record_failed_task(op_of(i), key_of(i), attempt, exc)
                    if (cls is Classification.REQUEUE and not _clean_worker_loss(exc)
                            and getattr(exc, "was_executing", True)):
                        # an abrupt death with this task executing (a task
                        # only queued on the dead worker is innocent): one
                        # strike toward the poison verdict
                        fatal_strikes[i] = fatal_strikes.get(i, 0) + 1
                        if fatal_strikes[i] > policy.max_requeues:
                            metrics.counter("poison_quarantined").inc()
                            record_decision("poison_quarantine", op=op_of(i), chunk=key_of(i),
                                            attempts=fatal_strikes[i])
                            cancel_pending()
                            raise PoisonTaskError(op_of(i), key_of(i), fatal_strikes[i]) from exc
                    if cls is Classification.REQUEUE and requeues.get(i, 0) < policy.max_requeues:
                        # the worker died, not the task: no retry spent
                        requeues[i] = requeues.get(i, 0) + 1
                        metrics.counter("worker_loss_requeues").inc()
                        record_decision("requeue", op=op_of(i), chunk=key_of(i), requeue=requeues[i])
                        if not twins:
                            admit(i)
                        continue
                    if cls is Classification.CANCELLED:
                        # the compute was cancelled: no retry, no budget
                        cancel_pending()
                        if cancellation is not None:
                            raise cancel_abort(cancellation) from exc
                        from ..cancellation import ComputeDeadlineExceededError

                        metrics.counter("deadline_aborts" if isinstance(exc, ComputeDeadlineExceededError)
                                        else "cancellations").inc()
                        raise exc
                    attempts[i] += 1
                    if cls is Classification.RESOURCE:
                        # before twin suppression: the pressure is real
                        # whether or not a twin still runs. Halve the limit;
                        # a task admitted alone that fails again with no
                        # progress in between aborts with the actionable error
                        count_resource_failure(metrics, exc)
                        if limit_at_submit == 1:
                            strikes, done_at = floor_strikes.get(i, (0, -1))
                            if strikes >= 1 and done_at == len(done_inputs):
                                cancel_pending()
                                raise resource_abort_error(op_of(i), exc) from exc
                            floor_strikes[i] = (strikes + 1, len(done_inputs))
                        admission.step_down(len(pending) + 1)
                    if twins:
                        continue  # a backup twin still runs
                    if cls is Classification.RECOMPUTE:
                        # after twin suppression: a pair failing on one
                        # corrupt chunk is one defect
                        _count_integrity_failure(metrics, exc)
                    if cls is Classification.FAIL_FAST:
                        metrics.counter("task_failfast").inc()
                        cancel_pending()
                        raise exc
                    if attempts[i] > retries:
                        cancel_pending()
                        if cls is Classification.RESOURCE:
                            raise resource_abort_error(op_of(i), exc, at_floor=False) from exc
                        raise exc
                    if not budget.consume():
                        cancel_pending()
                        raise budget_exhausted_error(exc, budget) from exc
                    if cls is Classification.RECOMPUTE:
                        repair = recompute_resolver.resolve(integrity_payload(exc)) \
                            if recompute_resolver is not None else None
                        if repair is not None:
                            # re-run the corrupt chunk's producer on the side
                            # pool; the reader resubmits when it lands
                            payload = integrity_payload(exc) or {}
                            record_decision("recompute", op=op_of(i), chunk=key_of(i),
                                            store=str(payload.get("store", "")),
                                            corrupt_chunk=payload.get("chunk_key"))
                            if repair_pool is None:
                                repair_pool = concurrent.futures.ThreadPoolExecutor(
                                    max_workers=2, thread_name_prefix="chunk-repair")
                            repairing[i] = repair_pool.submit(repair)
                            continue
                        logger.warning("corrupt chunk with no recompute path (input %s): retrying blind", i)
                    delay = policy.backoff_delay(attempts[i])
                    if cls is Classification.THROTTLE:
                        # a store throttle that escaped the breaker: count it
                        # (the attempt's scope counters went with it) and
                        # floor the backoff
                        metrics.counter("store_throttled").inc()
                        delay = max(delay, 0.2)
                    logger.info("retrying input %s (attempt %d) in %.3fs", i, attempts[i] + 1, delay)
                    metrics.counter("task_retries").inc()
                    metrics.histogram("retry_backoff_s").observe(delay)
                    record_decision("retry", op=op_of(i), chunk=key_of(i), attempt=attempts[i],
                                    delay_s=round(delay, 4))
                    if delay <= 0:
                        admit(i)
                    else:
                        heapq.heappush(delayed, (now + delay, i))
                    continue
                _, stats = fut.result()
                done_inputs.add(i)
                admission.on_success(pressure_level() == "ok")
                for f in list(pending):  # cancel the losing twins
                    if pending[f][0] == i:
                        f.cancel()
                        del pending[f]
                        submit_meta.pop(f, None)
                stats = dict(stats)
                disp = stats.pop("dispatch", None) or {}
                report = stats.pop(WORKER_REPORT_KEY, None)
                if report is not None and worker_tally is not None:
                    worker_tally.add(stats.get("worker"), stats.get("pid"), report)
                if meta:
                    disp = dict(disp, **meta)
                handle_callbacks(callbacks, dict(
                    stats, array_name=op_of(i), task_create_tstamp=create_times[i], chunk_key=key_of(i),
                    attempt=attempt, executor=executor_name, dispatch=disp or None,
                ))
                # the dataflow hooks and the release fire after the task's
                # end event: observers see a completion before its
                # consequences, and a callback that touches storage cannot
                # race the released reader
                t_release = time.perf_counter()
                if on_input_done is not None:
                    on_input_done(i)
                release_dependents(i)
                metrics.counter("dispatch_release_s").inc(time.perf_counter() - t_release)
            if use_backups and not admission.throttling and not _overload_sheds_optional():
                # no speculative twins while degraded for memory, or while
                # the service's overload ladder sheds optional work (L1+):
                # a twin is pure extra footprint
                for fut, (i, is_backup, _attempt, _lim) in list(pending.items()):
                    if is_backup or i in done_inputs or i in backups:
                        continue
                    if should_launch_backup(fut, now, start_times, end_times):
                        logger.info("launching backup for input %s", i)
                        metrics.counter("speculative_backups").inc()
                        record_decision("backup", op=op_of(i), chunk=key_of(i))
                        submit(i, is_backup=True)
    finally:
        # a stale queue depth would read as phantom in-flight tasks
        metrics.gauge("queue_depth").set(0)
        metrics.gauge("dispatch_utilization").set(0.0)
        if repair_pool is not None:
            repair_pool.shutdown(wait=False, cancel_futures=True)


class AsyncPythonDagExecutor(DagExecutor):
    """A thread pool running each task through ``execute_with_stats``, with
    classified retries, backups, the dataflow scheduler and generation
    parallelism."""

    def __init__(self, max_workers: Optional[int] = None, retries: int = DEFAULT_RETRIES,
                 use_backups: bool = False, batch_size: Optional[int] = None,
                 compute_arrays_in_parallel: bool = False, retry_policy: Optional[RetryPolicy] = None, **kwargs):
        self.max_workers = max_workers
        self.retries = retries
        self.use_backups = use_backups
        self.batch_size = batch_size
        self.compute_arrays_in_parallel = compute_arrays_in_parallel
        self.retry_policy = retry_policy
        self.kwargs = kwargs

    @property
    def name(self) -> str:
        return "threads"

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
        # one admission controller per compute, like the budget: a step-down
        # found in one op carries into the next
        admission = AdmissionController()
        # one verified scan per store; a loaded journal narrows the skips to
        # journal ∩ integrity
        state = ResumeState(quarantine=True, journal=journal) if resume else None
        resolver = RecomputeResolver(dag)
        scheduler = effective_scheduler(spec, batch_size)
        record_scheduler_mode(scheduler, executor=self.name)
        common = dict(retry_policy=policy, retry_budget=budget, use_backups=use_backups, callbacks=callbacks,
                      executor_name=self.name, recompute_resolver=resolver, admission=admission,
                      cancellation=cancellation)

        with concurrent.futures.ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            if scheduler == "dataflow":
                # the whole DAG is one map, each task gated on its own input
                # chunks (batch_size cannot apply: one index space)
                if batch_size:
                    logger.warning('batch_size=%s is ignored under scheduler="dataflow" (the whole DAG is one '
                                   "dependency-gated map); use max_workers to bound in-flight tasks", batch_size)
                sched = DataflowScheduler(dag, resume=resume, state=state, callbacks=callbacks)
                sched.start()
                try:
                    self._run_tasks(pool, sched.items, sched.pipelines, dependencies=sched.dependencies,
                                    on_input_submit=sched.on_submit, on_input_done=sched.on_done, **common)
                finally:
                    sched.finish()
            elif compute_arrays_in_parallel:
                # the ops of one topological generation interleave their tasks
                for generation in visit_node_generations(dag, resume=resume, state=state):
                    merged, pipelines = merge_generation(generation, callbacks, resume=resume, resume_state=state)
                    self._run_tasks(pool, merged, pipelines, batch_size=batch_size, **common)
                    end_generation(generation, callbacks)
            else:
                for name, node in visit_nodes(dag, resume=resume, state=state):
                    primitive_op = node["primitive_op"]
                    pipeline = primitive_op.pipeline
                    callbacks_on(callbacks, "on_operation_start", OperationStartEvent(name, primitive_op.num_tasks))
                    mappable, _ = pending_mappable(name, node, resume, state)
                    map_unordered(pool, pipeline.function, mappable, batch_size=batch_size, array_name=name,
                                  config=pipeline.config, **common)
                    callbacks_on(callbacks, "on_operation_end", OperationEndEvent(name, primitive_op.num_tasks))

    @staticmethod
    def _run_tasks(pool, merged, pipelines, **kwargs) -> None:
        def fn(item):
            name, m = item
            pipeline = pipelines[name]
            return pipeline.function(m, config=pipeline.config)

        map_unordered(pool, fn, merged, array_names=[name for name, _ in merged], **kwargs)
