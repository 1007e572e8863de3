"""Resource specification carried by every array. Counterpart of
``cubed_tpu/spec.py``, trimmed to the work directory, the memory bounds, the
executor, the device executor's residency budget, the reliability settings
(fault injection, chunk integrity, the runtime memory guard), the threaded
executor's scheduler, the compute journal, and the observability knobs (the
run-history archive, live telemetry and the dispatch profiler). The
reference's ``storage_options``, ``mesh_shape``, ``peer_transfer`` and
``service`` wait for the modules that read them (ROADMAP Queue 1 items 11c
and 12)."""

from __future__ import annotations

import tempfile
from typing import Any, Optional, Union

from .utils import convert_to_bytes, memory_repr

#: Defaults when no spec is given (the JAX package's)
DEFAULT_ALLOWED_MEM = 200_000_000
DEFAULT_RESERVED_MEM = 100_000_000


class Spec:
    """Specification of resources available to run a computation."""

    def __init__(
        self,
        work_dir: Optional[str] = None,
        allowed_mem: Union[int, str, None] = None,
        reserved_mem: Union[int, str, None] = 0,
        executor: Optional[Any] = None,
        device_mem: Union[int, str, None] = None,
        executor_name: Optional[str] = None,
        executor_options: Optional[dict] = None,
        fault_injection: Optional[Any] = None,
        integrity: Optional[str] = None,
        memory_guard: Optional[str] = None,
        scheduler: Optional[str] = None,
        journal: Optional[str] = None,
        run_history: Optional[str] = None,
        telemetry_port: Optional[int] = None,
        dispatch_profile: Optional[bool] = None,
    ):
        self._work_dir = work_dir
        self._reserved_mem = convert_to_bytes(reserved_mem or 0)
        if allowed_mem is None:
            self._allowed_mem = self._reserved_mem
        else:
            self._allowed_mem = convert_to_bytes(allowed_mem)
        self._executor = executor
        self._executor_name = executor_name
        self._executor_options = executor_options
        self._device_mem = convert_to_bytes(device_mem) if device_mem is not None else None
        self._fault_injection = fault_injection
        if integrity is not None:
            from .storage.integrity import MODES

            if integrity not in MODES:
                raise ValueError(f"invalid integrity mode {integrity!r}; expected one of {MODES}")
        self._integrity = integrity
        if memory_guard is not None:
            from .runtime.memory import MODES as GUARD_MODES

            if memory_guard not in GUARD_MODES:
                raise ValueError(f"invalid memory_guard mode {memory_guard!r}; expected one of {GUARD_MODES}")
        self._memory_guard = memory_guard
        if scheduler is not None:
            from .runtime.dataflow import MODES as SCHEDULER_MODES

            if scheduler not in SCHEDULER_MODES:
                raise ValueError(f"invalid scheduler mode {scheduler!r}; expected one of {SCHEDULER_MODES}")
        self._scheduler = scheduler
        if journal is not None and not isinstance(journal, str):
            raise ValueError(f"journal must be a file path (str) or None, got {type(journal).__name__}")
        self._journal = journal
        if run_history is not None and not isinstance(run_history, str):
            raise ValueError(f"run_history must be a directory path (str) or None, got {type(run_history).__name__}")
        self._run_history = run_history
        if telemetry_port is not None:
            telemetry_port = int(telemetry_port)
            if telemetry_port < 0 or telemetry_port > 65535:
                raise ValueError(f"telemetry_port must be 0-65535 (0 = ephemeral), got {telemetry_port}")
        self._telemetry_port = telemetry_port
        self._dispatch_profile = None if dispatch_profile is None else bool(dispatch_profile)

    @property
    def work_dir(self) -> Optional[str]:
        """The local directory for intermediate Zarr data."""
        return self._work_dir

    @property
    def allowed_mem(self) -> int:
        """Memory (bytes) one task may use: an op whose projected memory
        exceeds it raises when the op is built."""
        return self._allowed_mem

    @property
    def reserved_mem(self) -> int:
        """Memory (bytes) reserved on a worker before any task runs."""
        return self._reserved_mem

    @property
    def executor(self) -> Optional[Any]:
        """The executor ``compute()`` uses when it is given none: the one
        passed in, else one created from ``executor_name`` (and
        ``executor_options``) at first use, else None (the sequential one)."""
        if self._executor is None and self._executor_name is not None:
            from .runtime.create import create_executor

            self._executor = create_executor(self._executor_name, self._executor_options)
        return self._executor

    @property
    def device_mem(self) -> Optional[int]:
        """Residency budget (bytes) of the device executor, when it is not
        given one itself."""
        return self._device_mem

    @property
    def fault_injection(self) -> Optional[Any]:
        """Fault-injection config (a ``runtime.faults.FaultConfig`` or a plain
        dict), armed by ``Plan.execute`` for the compute; None injects
        nothing."""
        return self._fault_injection

    @property
    def integrity(self) -> Optional[str]:
        """Chunk-integrity mode: ``"off"``, ``"write"`` (checksums recorded on
        every chunk write: the effective default) or ``"verify"`` (every
        task-scope read verified too, a corrupt chunk quarantined and its
        producer re-run). None defers to ``CUBED_TPU_TORCH_INTEGRITY`` or the
        default (``storage/integrity.py``)."""
        return self._integrity

    @property
    def memory_guard(self) -> Optional[str]:
        """Runtime memory-guard mode: ``"off"``, ``"observe"`` (count and warn
        when a task's measured memory exceeds ``allowed_mem``: the effective
        default) or ``"enforce"`` (fail such tasks, classified RESOURCE).
        None defers to ``CUBED_TPU_TORCH_MEMORY_GUARD`` or the default;
        ``Plan.execute`` arms it with this spec's ``allowed_mem``
        (``runtime/memory.py``)."""
        return self._memory_guard

    @property
    def scheduler(self) -> Optional[str]:
        """Task scheduling on the threaded executor: ``"dataflow"`` (the
        effective default: a task dispatches the moment its own input
        chunks are written, across op boundaries) or ``"oplevel"`` (every
        task of an op finishes before any task of the next starts; also
        what a defaulted scheduler falls back to when ``batch_size`` is
        set). None defers to ``CUBED_TPU_TORCH_SCHEDULER`` (the operator's
        override, which wins) or the default. The sequential and the device
        executors keep op order (``runtime/dataflow.py``)."""
        return self._scheduler

    @property
    def journal(self) -> Optional[str]:
        """Path of the durable compute journal (append-only JSONL, fsync'd
        completion records): ``Plan.execute`` attaches a
        ``runtime.journal.JournalCallback`` writing there, and
        ``compute(resume_from_journal=path)`` resumes from it. None (the
        default) journals nothing."""
        return self._journal

    @property
    def run_history(self) -> Optional[str]:
        """Directory of the durable run-history archive (``runs.jsonl``:
        append-only, fsync'd, size-rotated, torn-line tolerant). When set,
        every ``Plan.execute`` appends one compact record at completion:
        compute id, the plan's structural fingerprint, wall clock, the
        ``analyze()`` bucket decomposition, metrics highlights and the error
        outcome, what ``python -m cubed_tpu_torch.regress`` diffs
        (``observability/runhistory.py``). None (the default) archives
        nothing."""
        return self._run_history

    @property
    def telemetry_port(self) -> Optional[int]:
        """Live-telemetry HTTP port: arming it makes ``Plan.execute`` start
        the process-global telemetry pipeline (a ~1s sampler of the metrics
        registry into a bounded time-series store, the alert engine, and a
        Prometheus ``/metrics`` + ``/healthz`` + ``/snapshot.json`` endpoint
        on this port, ``0`` = ephemeral, bound to 127.0.0.1); read it live
        with ``python -m cubed_tpu_torch.top``. None defers to the
        ``CUBED_TPU_TORCH_TELEMETRY_PORT`` env var (the operator's override,
        which wins; ``off`` disables) or the off default
        (``observability/export.py``)."""
        return self._telemetry_port

    @property
    def dispatch_profile(self) -> Optional[bool]:
        """Client self-profiling: ``True`` arms the bounded
        ``sys._current_frames()`` sampling profiler over the client's
        threads for each compute: collapsed stacks land as
        ``profile-<compute_id>.folded`` in the flight-recorder bundle, a
        "dispatch profile" lane joins the merged trace, and ``diagnose``
        names the top stacks. None defers to the
        ``CUBED_TPU_TORCH_DISPATCH_PROFILE`` env var (which wins; ``1``
        enables) or the off default; off is a true no-op
        (``observability/dispatchprofile.py``)."""
        return self._dispatch_profile

    def __repr__(self) -> str:
        return (
            f"Spec(work_dir={self._work_dir!r}, "
            f"allowed_mem={memory_repr(self._allowed_mem)}, "
            f"reserved_mem={memory_repr(self._reserved_mem)}, "
            f"executor={self._executor!r})"
        )

    def __eq__(self, other) -> bool:
        if other is self:
            return True
        if isinstance(other, Spec):
            return (
                self.work_dir == other.work_dir
                and self.allowed_mem == other.allowed_mem
                and self.reserved_mem == other.reserved_mem
                and self.executor == other.executor
            )
        return False


def spec_from_config(spec: Optional[Spec]) -> Spec:
    """Fill in a default spec (temp work_dir, 200MB allowed / 100MB reserved)."""
    if spec is not None:
        return spec
    return Spec(
        work_dir=tempfile.gettempdir(),
        allowed_mem=DEFAULT_ALLOWED_MEM,
        reserved_mem=DEFAULT_RESERVED_MEM,
    )
