"""Distributed executor: the TCP fleet.

Counterpart of ``cubed_tpu/runtime/executors/distributed.py``. A
coordinator in the client process fans chunk tasks out to worker processes
over TCP (``runtime/distributed.py``), with the reliability contract of the
other executors (idempotent whole-chunk Zarr writes, retries, backups, all
through ``map_unordered``), and the peer data plane on by default
(``runtime/transfer.py``).

Two ways to get workers:

- ``DistributedDagExecutor(n_local_workers=4)`` spawns that many local
  worker processes;
- ``DistributedDagExecutor(listen="0.0.0.0:8765", min_workers=4)`` binds a
  fixed address and waits for workers started out of band
  (``python -m cubed_tpu_torch.runtime.worker host:8765 --device cuda``).

Local workers run their chunks on the client's chunk device (or
``device=``), passed as ``--device``; with ``cuda`` the client builds every
kernel library before it spawns them. A local worker that exits before it
joins (``cuda`` asked for, no card) fails the fleet's start with its exit
code at once. The fleet persists across computes; ``close()``, or use as a
context manager, tears it down. Each task's stats carry its worker's device
and kernel launches, kept in ``stats["workers"]``/``["worker_launches"]``.

``max_workers=`` (or ``autoscale=True``, or an ``autoscale_policy``) starts
the autoscaler (``runtime/autoscale.py``) over the fleet: it spawns local
workers on the same device through the same path (kernels built first,
``--device``) and retires idle ones after a graceful drain. ``control_dir=``
arms live coordinator failover: the coordinator keeps its control log
there, local workers chase its ``rendezvous.json`` (``--rendezvous``), and a
new executor on the same directory adopts a fleet whose coordinator died.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
from typing import Optional

from ...observability import accounting
from ...observability import logs as obs_logs
from .. import transfer
from ..dataflow import (
    DataflowScheduler,
    effective_scheduler,
    record_scheduler_mode,
    task_hint_key,
    task_tag,
)
from ..distributed import Coordinator, NoWorkersError
from ..memory import AdmissionController
from ..pipeline import (
    RecomputeResolver,
    ResumeState,
    pending_mappable,
    visit_node_generations,
    visit_nodes,
)
from ..resilience import DEFAULT_RETRIES, RetryPolicy, resolve_policy
from ..types import (
    DagExecutor,
    OperationEndEvent,
    OperationStartEvent,
    callbacks_on,
)
from ..utils import WorkerTally, build_before_spawn, end_generation, merge_generation
from .python_async import compute_retry_budget, map_unordered

logger = logging.getLogger(__name__)


#: per-compute client state that must not leak into persistent fleet
#: workers: a fleet outlives the compute that spawned it and gets the live
#: values on every task message, which an inherited copy would outrank
_PER_COMPUTE_ENV_VARS = (
    accounting.SPANS_ENV_VAR,
    obs_logs.COMPUTE_ID_ENV_VAR,
)


def _worker_env() -> dict:
    """The environment of a locally spawned worker: the client's, less the
    per-compute variables, with the client's import path (the package's
    root first), so a function shipped by reference imports there too."""
    import sys

    env = {k: v for k, v in os.environ.items() if k not in _PER_COMPUTE_ENV_VARS}
    package_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    paths = [package_root] + [p for p in sys.path if p and p != package_root and os.path.isdir(p)]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    return env


class DistributedDagExecutor(DagExecutor):
    """Coordinator/worker fleet executor (multi-host control plane)."""

    def __init__(
        self,
        n_local_workers: Optional[int] = None,
        listen: Optional[str] = None,
        min_workers: Optional[int] = None,
        max_workers: Optional[int] = None,
        autoscale: Optional[bool] = None,
        autoscale_policy=None,
        drain_grace_s: float = 30.0,
        worker_threads: int = 1,
        worker_start_timeout: float = 60.0,
        task_timeout: Optional[float] = None,
        timeout_strikes: int = 2,
        lease_s: float = 15.0,
        peer_transfer: Optional[bool] = None,
        retries: int = DEFAULT_RETRIES,
        use_backups: bool = True,
        batch_size: Optional[int] = None,
        compute_arrays_in_parallel: bool = False,
        retry_policy: Optional[RetryPolicy] = None,
        control_dir: Optional[str] = None,
        takeover_grace_s: Optional[float] = None,
        device: Optional[str] = None,
        **kwargs,
    ):
        if n_local_workers is None and listen is None:
            n_local_workers = 2
        self.n_local_workers = n_local_workers
        self.listen = listen
        self.min_workers = min_workers if min_workers is not None else (
            n_local_workers or 1
        )
        self.max_workers = max_workers
        if max_workers is not None:
            floor = max(self.min_workers, n_local_workers or 0)
            if max_workers < floor:
                raise ValueError(
                    f"max_workers={max_workers} is below the fleet floor "
                    f"(min_workers={self.min_workers}, n_local_workers="
                    f"{n_local_workers}): the ceiling could never be "
                    "honored — lower the initial fleet or raise max_workers"
                )
        # the autoscaler is on when asked for explicitly, or implied by a
        # max_workers ceiling / a full policy object; a plain fixed-size
        # fleet keeps its exact behavior
        self.autoscale = (
            autoscale
            if autoscale is not None
            else (max_workers is not None or autoscale_policy is not None)
        )
        self.autoscale_policy = autoscale_policy
        self.drain_grace_s = drain_grace_s
        self.worker_threads = worker_threads
        self.worker_start_timeout = worker_start_timeout
        self.task_timeout = task_timeout
        self.timeout_strikes = timeout_strikes
        #: how long a disconnected worker keeps its in-flight tasks before
        #: they requeue as worker loss (runtime/distributed.py leases)
        self.lease_s = lease_s
        #: peer-to-peer chunk transfer (runtime/transfer.py): None defers
        #: to CUBED_TPU_TORCH_P2P / Spec(peer_transfer=...), the effective
        #: default being on; False (or CUBED_TPU_TORCH_P2P=off) is
        #: store-only
        self.peer_transfer = peer_transfer
        self.retries = retries
        self.use_backups = use_backups
        self.batch_size = batch_size
        self.compute_arrays_in_parallel = compute_arrays_in_parallel
        self.retry_policy = retry_policy
        #: control-plane durability directory (runtime/journal.py
        #: ControlLog): the coordinator persists its epoch, worker roster,
        #: and dispatch frontier there and advertises its address in
        #: ``rendezvous.json``. A fresh executor pointed at the same dir
        #: after a coordinator crash comes up as the next epoch and adopts
        #: the still-running fleet instead of cold-starting.
        self.control_dir = control_dir
        self.takeover_grace_s = takeover_grace_s
        #: the workers' chunk device; None is the client's at the fleet's start
        self.device = device
        self.kwargs = kwargs
        self._coordinator: Optional[Coordinator] = None
        #: append-only spawn log: worker ``local-<i>`` is ``_procs[i]``
        #: forever (replacements append with fresh indices), which keeps
        #: the exit probe correct across the autoscaler's churn; retired/
        #: dead entries stay (a reaped Popen costs nothing to re-wait)
        self._procs: list[subprocess.Popen] = []
        self._procs_lock = threading.Lock()
        self._autoscaler = None
        self._tally = WorkerTally()
        self._device: Optional[str] = None

    @property
    def name(self) -> str:
        return "distributed"

    # -- fleet lifecycle -----------------------------------------------

    @property
    def stats(self) -> dict:
        """Coordinator counters (blobs_sent, tasks_sent, task_timeouts,
        workers_lost, drains_completed, workers_preempted,
        tasks_abandoned_on_drain), a per-worker load snapshot, and what the
        workers reported with their tasks since the fleet started
        (``worker_reports``: device, tasks and kernel launches per worker;
        ``worker_launches``: summed) and, when the autoscaler runs, its
        scale counters; empty before the fleet starts."""
        if self._coordinator is None:
            return {}
        out = self._coordinator.stats_snapshot()
        tally = self._tally.snapshot()
        out["worker_reports"] = tally["workers"]
        out["worker_launches"] = tally["launches"]
        if self._autoscaler is not None:
            out["autoscale"] = dict(self._autoscaler.stats)
        return out

    @property
    def coordinator_address(self) -> Optional[str]:
        if self._coordinator is None:
            return None
        host, port = self._coordinator.address
        return f"{host}:{port}"

    def _ensure_fleet(self) -> Coordinator:
        if self._coordinator is not None:
            return self._coordinator
        if self.listen is not None:
            host, _, port = self.listen.rpartition(":")
            coord = Coordinator(host or "0.0.0.0", int(port or 0),
                                task_timeout=self.task_timeout,
                                timeout_strikes=self.timeout_strikes,
                                lease_s=self.lease_s,
                                control_dir=self.control_dir,
                                takeover_grace_s=self.takeover_grace_s)
            logger.info(
                "coordinator listening on %s:%s; waiting for %d workers",
                coord.address[0], coord.address[1], self.min_workers,
            )
        else:
            coord = Coordinator("127.0.0.1", 0, task_timeout=self.task_timeout,
                                timeout_strikes=self.timeout_strikes,
                                lease_s=self.lease_s,
                                control_dir=self.control_dir,
                                takeover_grace_s=self.takeover_grace_s)
        self._coordinator = coord
        initial_names: list = []
        if self.n_local_workers:
            build_before_spawn(self._worker_device())
            for _ in range(self.n_local_workers):
                initial_names.append(self._spawn_local_worker())
            # locally spawned workers have inspectable exit codes: a
            # dropped connection plus -9/137 reads as OOM-killed, and the
            # WorkerLostError message says so instead of a bare reset
            coord.exit_probe = self._local_worker_exitcode
        if self.autoscale:
            from ..autoscale import Autoscaler, AutoscalePolicy

            initial = self.n_local_workers or self.min_workers or 1
            mw = max(1, self.min_workers or 1)
            policy = self.autoscale_policy or AutoscalePolicy(
                min_workers=mw,
                max_workers=self.max_workers or max(8, initial, mw),
                drain_grace_s=self.drain_grace_s,
            )
            factory = (
                _LocalWorkerFactory(self) if self.n_local_workers else None
            )
            self._autoscaler = Autoscaler(
                coord, factory=factory, policy=policy,
                initial_workers=initial, pending_workers=initial_names,
            )
            self._autoscaler.start()
        try:
            self._wait_for_fleet(coord)
        except BaseException:
            self.close()
            raise
        return coord

    def _worker_device(self) -> str:
        """The local workers' chunk device, fixed at the fleet's start."""
        if self._device is None:
            if self.device is not None:
                self._device = str(self.device)
            else:
                from ...backend_array_api import get_device

                self._device = str(get_device())
        return self._device

    def _wait_for_fleet(self, coord: Coordinator) -> None:
        """Wait for ``min_workers`` to join; a local worker that exits
        first (a device it cannot use, an import error) fails the start at
        once, with its exit code, instead of at the timeout."""
        import time

        deadline = time.monotonic() + self.worker_start_timeout
        while True:
            try:
                coord.wait_for_workers(self.min_workers, min(0.5, max(0.0, deadline - time.monotonic())))
                return
            except TimeoutError:
                with self._procs_lock:
                    dead = [(i, p.returncode) for i, p in enumerate(self._procs) if p.poll() is not None]
                if dead:
                    i, code = dead[0]
                    raise RuntimeError(
                        f"local fleet worker local-{i} exited with code {code} before joining the coordinator "
                        f"(device {self._worker_device()!r}); its error is on this process's stderr")
                if time.monotonic() >= deadline:
                    raise

    def _spawn_local_worker(self) -> str:
        """Spawn one local worker subprocess on the fleet's chunk device;
        returns its name. Used for the initial fleet and as the
        autoscaler's ``WorkerFactory``: the single-host stand-in for asking
        a cluster for another instance."""
        coord = self._coordinator
        assert coord is not None
        host, port = coord.address
        cmd = [
            sys.executable,
            "-m",
            "cubed_tpu_torch.runtime.worker",
            f"{host}:{port}",
            "--threads",
            str(self.worker_threads),
            "--device",
            self._worker_device(),
        ]
        # the operator's env knob wins (it feeds the worker CLI's
        # --drain-grace default); only without it does the executor's grace
        # ride the command line
        if "CUBED_TPU_TORCH_DRAIN_GRACE_S" not in os.environ:
            cmd += ["--drain-grace", str(self.drain_grace_s)]
        if self.control_dir is not None:
            # workers chase a successor coordinator through the
            # advertisement file instead of dying with the old socket
            from ..journal import rendezvous_path

            cmd += ["--rendezvous", rendezvous_path(self.control_dir)]
        with self._procs_lock:
            i = len(self._procs)
            name = f"local-{i}"
            self._procs.append(
                subprocess.Popen(
                    cmd + ["--name", name], env=_worker_env()
                )
            )
        return name

    def _proc_for(self, name: str) -> Optional[subprocess.Popen]:
        """Popen for a locally spawned worker name (``local-<i>``), or
        None for out-of-band names / unknown indices."""
        if not name.startswith("local-"):
            return None
        try:
            i = int(name.split("-", 1)[1])
        except ValueError:
            return None
        with self._procs_lock:
            try:
                return self._procs[i]
            except IndexError:
                return None

    def _retire_local_worker(self, name: str) -> None:
        """Reap a worker whose graceful drain was already requested: wait
        for it to exit on its own inside the grace window, escalate to
        SIGTERM/SIGKILL if it lingers. Runs on a daemon thread so the
        autoscaler's policy loop never blocks on a slow exit."""
        proc = self._proc_for(name)
        if proc is None:
            return
        # the reap deadline must cover the grace the DRAIN was granted —
        # the autoscaler's policy grace when it initiated the retirement,
        # which may exceed this executor's own drain_grace_s default
        scaler = self._autoscaler
        grace = (
            scaler.policy.drain_grace_s if scaler is not None
            else self.drain_grace_s
        )

        def reap() -> None:
            try:
                proc.wait(timeout=grace + 10)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5)

        threading.Thread(
            target=reap, name=f"reap-{name}", daemon=True
        ).start()

    def _local_worker_exitcode(self, name: str):
        """Exit code of a locally spawned worker (names ``local-<i>``), or
        None while it still runs / for out-of-band workers. Polls briefly:
        the process usually finishes dying within a few ms of its socket
        resetting, and a definite code is worth a short wait."""
        import time

        proc = self._proc_for(name)
        if proc is None:
            return None
        for _ in range(10):
            code = proc.poll()
            if code is not None:
                return code
            time.sleep(0.05)
        return None

    def close(self) -> None:
        """Tear down the autoscaler, the coordinator, and every locally
        spawned worker — including ones mid-drain or retired earlier (the
        spawn log is append-only, so nothing is ever orphaned)."""
        if self._autoscaler is not None:
            # first, so it cannot backfill workers we are tearing down
            self._autoscaler.stop()
            self._autoscaler = None
        if self._coordinator is not None:
            self._coordinator.close()
            self._coordinator = None
        with self._procs_lock:
            procs = list(self._procs)
            self._procs.clear()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)

    def __enter__(self):
        self._ensure_fleet()
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort; explicit close() is the contract
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        # the executor can ride inside a Spec that gets serialized into task
        # payloads; the fleet (sockets, subprocesses) is process-local state
        # a worker neither needs nor could use
        state = self.__dict__.copy()
        state["_coordinator"] = None
        state["_procs"] = []
        state["_procs_lock"] = None
        state["_tally"] = WorkerTally()
        state["_autoscaler"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._procs_lock = threading.Lock()

    # -- execution -----------------------------------------------------

    def resume_compute(self, array, journal: str, **kwargs):
        """Continue a compute whose client/coordinator process crashed.

        Rebuild the SAME plan (same code ⇒ same deterministic op names),
        then call this with the journal file the crashed run was writing
        (``Spec(journal=...)``): coordinator-side progress is rebuilt from
        the journal's completed-task frontier intersected with the
        chunk-integrity resume scan, and only the remainder re-runs —
        bitwise-identical to an uninterrupted run. Returns the computed
        numpy array. Equivalent to
        ``array.compute(executor=self, resume_from_journal=journal)``."""
        return array.compute(
            executor=self, resume_from_journal=str(journal), **kwargs
        )

    def execute_dag(
        self,
        dag,
        callbacks=None,
        array_names=None,
        resume=None,
        spec=None,
        retries: Optional[int] = None,
        use_backups: Optional[bool] = None,
        batch_size: Optional[int] = None,
        compute_arrays_in_parallel: Optional[bool] = None,
        retry_policy: Optional[RetryPolicy] = None,
        journal=None,
        cancellation=None,
        **kwargs,
    ) -> None:
        retries = self.retries if retries is None else retries
        use_backups = self.use_backups if use_backups is None else use_backups
        batch_size = self.batch_size if batch_size is None else batch_size
        if compute_arrays_in_parallel is None:
            compute_arrays_in_parallel = self.compute_arrays_in_parallel
        policy = resolve_policy(retry_policy or self.retry_policy, retries)
        budget = compute_retry_budget(policy, dag)
        # one controller per compute: a worker-side OOM (RESOURCE off the
        # wire) steps coordinator-side task admission down for all ops
        admission = AdmissionController()

        coord = self._ensure_fleet()
        from ...observability.collect import record_decision

        # the fleet's shape at compute start anchors the decision timeline
        # (a later worker loss reads very differently at 8 workers vs 1)
        record_decision(
            "fleet_compute", n_workers=coord.n_workers,
            coordinator=f"{coord.address[0]}:{coord.address[1]}",
        )
        if coord.n_workers == 0 and (
            self._autoscaler is not None and self.min_workers > 0
        ):
            # the fleet self-heals (autoscaler holds a min_workers floor):
            # a momentarily empty fleet — e.g. a poison task just took out
            # every worker at once — is a backfill in flight, not a
            # configuration error, so ride it out instead of failing the
            # compute in the gap
            try:
                coord.wait_for_workers(1, timeout=self.worker_start_timeout)
            except TimeoutError:
                pass  # fall through to the zero-workers diagnostic
        if coord.n_workers == 0:
            # fail fast with a diagnostic instead of letting the first
            # submit discover it mid-plan (min_workers=0 configurations
            # sail past wait_for_workers without anyone ever joining)
            host, port = coord.address
            raise NoWorkersError(
                f"compute submitted with zero live workers (coordinator "
                f"{host}:{port}, min_workers={self.min_workers}); start "
                "workers with 'python -m cubed_tpu_torch.runtime.worker "
                f"{host}:{port}' or configure n_local_workers/min_workers "
                "so the fleet is populated before computing"
            )

        if cancellation is not None:
            # the moment the token trips — an explicit cancel from any
            # thread, or the dispatch loop observing an expired deadline —
            # broadcast a compute_cancel frame so every fleet worker
            # aborts cooperatively at its next safe boundary instead of
            # waiting for its next task message to carry the tripped state
            cid = obs_logs.current_compute_id()
            cancellation.on_abort(
                lambda: coord.broadcast_cancel(
                    cid, reason=cancellation.reason
                )
            )

        state = (
            ResumeState(quarantine=True, journal=journal) if resume else None
        )
        # integrity failures cross the wire as RemoteTaskError carrying the
        # corrupt chunk's (store, key); the repair task runs client-side
        # against the shared store the whole fleet reads
        resolver = RecomputeResolver(dag)
        # a defaulted dataflow yields to an explicit batch_size (the rule
        # lives in dataflow.effective_scheduler); explicit requests win
        # and warn below
        scheduler = effective_scheduler(spec, batch_size)
        record_scheduler_mode(scheduler, executor=self.name)
        # peer-to-peer chunk transfer: env > Spec > executor arg > off.
        # Armed for this compute's duration — the coordinator attaches the
        # wire config to every task message, so pre-started fleet workers
        # cache/advertise/fetch exactly when this compute asked for it
        peer_on = transfer.resolve_peer_transfer(spec, self.peer_transfer)
        record_decision(
            "peer_transfer", enabled=peer_on, scheduler=scheduler,
        )
        with transfer.client_scoped(peer_on):
            if scheduler == "dataflow":
                # the coordinator already routes per-item (op, task) pairs
                # (_InterleavedPool); dataflow just widens the item set to
                # the whole DAG and gates each on its own input chunks
                if batch_size:
                    logger.warning(
                        "batch_size=%s is ignored under scheduler="
                        "\"dataflow\" (the whole DAG is one dependency-"
                        "gated map)",
                        batch_size,
                    )
                sched = DataflowScheduler(
                    dag, resume=resume, state=state, callbacks=callbacks
                )
                sched.start()
                try:
                    if sched.items:
                        map_unordered(
                            _InterleavedPool(
                                coord, sched.pipelines,
                                # the chunk graph knows each task's input
                                # chunks: dispatch scores workers by input
                                # bytes already cache-resident (only
                                # meaningful with the peer data plane on)
                                locality_hints=(
                                    sched.locality_hints() if peer_on
                                    else None
                                ),
                            ),
                            None,
                            sched.items,
                            retry_policy=policy,
                            retry_budget=budget,
                            use_backups=use_backups,
                            callbacks=callbacks,
                            array_names=sched.array_names,
                            executor_name=self.name,
                            recompute_resolver=resolver,
                            admission=admission,
                            dependencies=sched.dependencies,
                            on_input_submit=sched.on_submit,
                            on_input_done=sched.on_done,
                            cancellation=cancellation,
                            worker_tally=self._tally,
                        )
                finally:
                    sched.finish()
            elif compute_arrays_in_parallel:
                for generation in visit_node_generations(
                    dag, resume=resume, state=state
                ):
                    merged, pipelines = merge_generation(
                        generation, callbacks, resume=resume,
                        resume_state=state,
                    )
                    if not merged:
                        end_generation(generation, callbacks)
                        continue
                    map_unordered(
                        _InterleavedPool(coord, pipelines),
                        None,
                        merged,
                        retry_policy=policy,
                        retry_budget=budget,
                        use_backups=use_backups,
                        batch_size=batch_size,
                        callbacks=callbacks,
                        array_names=[name for name, _ in merged],
                        executor_name=self.name,
                        recompute_resolver=resolver,
                        admission=admission,
                        cancellation=cancellation,
                        worker_tally=self._tally,
                    )
                    end_generation(generation, callbacks)
            else:
                for name, node in visit_nodes(dag, resume=resume, state=state):
                    primitive_op = node["primitive_op"]
                    pipeline = primitive_op.pipeline
                    callbacks_on(
                        callbacks, "on_operation_start",
                        OperationStartEvent(name, primitive_op.num_tasks),
                    )
                    mappable, _ = pending_mappable(name, node, resume, state)
                    map_unordered(
                        _OpPool(coord, pipeline, name),
                        pipeline.function,
                        mappable,
                        retry_policy=policy,
                        retry_budget=budget,
                        use_backups=use_backups,
                        batch_size=batch_size,
                        callbacks=callbacks,
                        array_name=name,
                        executor_name=self.name,
                        recompute_resolver=resolver,
                        admission=admission,
                        cancellation=cancellation,
                        worker_tally=self._tally,
                        config=pipeline.config,
                    )
                    callbacks_on(
                        callbacks, "on_operation_end",
                        OperationEndEvent(name, primitive_op.num_tasks),
                    )


class _OpPool:
    """concurrent.futures-shaped adapter routing one op's tasks to the
    coordinator (map_unordered calls
    ``pool.submit(execute_with_stats, function, input, config=...)``)."""

    def __init__(self, coordinator: Coordinator, pipeline, op_name=None):
        self.coordinator = coordinator
        self.pipeline = pipeline
        self.op_name = op_name

    def submit(self, stats_wrapper, function, task_input, *, config=None):
        tag = (
            task_tag(self.op_name, task_input)
            if self.op_name is not None
            else None
        )
        return self.coordinator.submit(
            stats_wrapper, function, task_input, config=config, tag=tag
        )


class _LocalWorkerFactory:
    """The autoscaler's :class:`~cubed_tpu_torch.runtime.autoscale.WorkerFactory`
    for locally spawned fleets: another worker subprocess on this host, on
    the fleet's chunk device (the single-host stand-in for another
    instance), reaped after its graceful drain."""

    def __init__(self, executor: DistributedDagExecutor):
        self._executor = executor

    def start_worker(self):
        return self._executor._spawn_local_worker()

    def stop_worker(self, name: str) -> None:
        self._executor._retire_local_worker(name)

    def spawn_failed(self, name: str) -> bool:
        proc = self._executor._proc_for(name)
        return proc is not None and proc.poll() is not None


class _InterleavedPool:
    """Adapter for interleaved items ``(op_name, m)``: resolves
    each item's pipeline so every op keeps its own (function, config) blob.

    ``locality_hints`` (dataflow + peer transfer) maps ``(op, chunk key)``
    to the task's input chunks so the coordinator can place it on the
    worker already holding those bytes."""

    def __init__(
        self, coordinator: Coordinator, pipelines: dict,
        locality_hints: Optional[dict] = None,
    ):
        self.coordinator = coordinator
        self.pipelines = pipelines
        self.locality_hints = locality_hints

    def submit(self, stats_wrapper, _fn, item, **kwargs):
        name, m = item
        pipeline = self.pipelines[name]
        locality = None
        if self.locality_hints is not None and isinstance(m, (tuple, list)):
            # blockwise out-key items key by their dotted chunk key,
            # rechunk slice-regions by their region identity (shared
            # contract: dataflow.task_hint_key) — create-arrays items
            # carry other shapes and simply have no hints
            locality = self.locality_hints.get((name, task_hint_key(m)))
        return self.coordinator.submit(
            stats_wrapper, pipeline.function, m, config=pipeline.config,
            locality=locality, tag=task_tag(name, m),
        )
