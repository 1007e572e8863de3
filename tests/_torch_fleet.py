"""Shared pieces of the port's pool and fleet tests.

Task bodies that worker processes import by name live here, in a module
that imports neither JAX nor the JAX package, so a spawned worker stays as
light as the port. ``leftovers()`` lists the child processes and listening
sockets a test module left behind, and ``reset_process_state()`` puts the
process-wide switches the fleet reads (the armed peer config, the fault
injector, the guard's sampler) back to their defaults.
"""

from __future__ import annotations

import os
import time


class SlowAdd:
    """``x + 1.0`` after a wall-clock delay: slow enough for a drain or a
    kill to catch it in flight."""

    def __init__(self, delay_s: float):
        self.delay_s = delay_s

    def __call__(self, x):
        time.sleep(self.delay_s)
        return x + 1.0


def bump(x):
    return x + 1.0


def inc_one(x):
    return x + 1.0


class DieOnce:
    """Kill the worker process on the first call with input 0 (an OOM-kill
    shape when *code* is 137); later calls, in a rebuilt pool, succeed. The
    marker file survives the dead process."""

    def __init__(self, marker: str, code: int = 1):
        self.marker = marker
        self.code = code

    def __call__(self, i):
        if i == 0 and not os.path.exists(self.marker):
            open(self.marker, "w").close()
            os._exit(self.code)
        return i


class FaultTask:
    """The shared file-counted fault task (``tests/runtime/utils.py``) as a
    picklable object."""

    def __init__(self, path, timing_map):
        self.path = path
        self.timing_map = timing_map

    def __call__(self, i):
        from tests.runtime.utils import deterministic_failure

        return deterministic_failure(self.path, self.timing_map, i)


class CoordPool:
    """A coordinator as the ``concurrent.futures`` pool ``map_unordered``
    drives."""

    def __init__(self, coordinator):
        self.coordinator = coordinator

    def submit(self, stats_wrapper, function, task_input, **kwargs):
        return self.coordinator.submit(stats_wrapper, function, task_input, **kwargs)


def _children() -> list:
    """Live (not zombie) child processes of this process."""
    me = os.getpid()
    out = []
    for tid in os.listdir(f"/proc/{me}/task"):
        try:
            with open(f"/proc/{me}/task/{tid}/children") as f:
                pids = [int(p) for p in f.read().split()]
        except OSError:
            continue
        for pid in pids:
            try:
                with open(f"/proc/{pid}/stat") as f:
                    state = f.read().rsplit(")", 1)[1].split()[0]
            except OSError:
                continue
            if state == "Z" or _is_resource_tracker(pid):
                continue
            out.append(pid)
    return out


def _is_resource_tracker(pid: int) -> bool:
    """multiprocessing's resource tracker: started with the first spawned
    pool, it lives as long as this process does, by design."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return b"resource_tracker" in f.read()
    except OSError:
        return False


def _listening_inodes() -> set:
    inodes = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                next(f)
                for line in f:
                    cols = line.split()
                    if cols[3] == "0A":  # LISTEN
                        inodes.add(cols[9])
        except OSError:
            continue
    return inodes


def _own_listening_sockets() -> list:
    listening = _listening_inodes()
    out = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            target = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        if target.startswith("socket:[") and target[8:-1] in listening:
            out.append(int(fd))
    return out


def snapshot() -> dict:
    """This process's child processes and listening sockets now."""
    return {"children": set(_children()), "listening": set(_own_listening_sockets())}


def leftovers(before: dict, timeout: float = 20.0) -> dict:
    """The child processes and listening sockets this process has beyond
    *before* (a :func:`snapshot`), after waiting up to *timeout* for
    exiting ones to go."""
    deadline = time.monotonic() + timeout
    while True:
        now = snapshot()
        found = {k: sorted(now[k] - before[k]) for k in now}
        if not any(found.values()) or time.monotonic() > deadline:
            return found
        time.sleep(0.1)


def reset_process_state() -> None:
    """Disarm what a fleet test may leave armed in this process."""
    from cubed_tpu_torch.runtime import faults, memory, transfer

    faults.deactivate()
    transfer.arm_from_wire(None)
    transfer.set_worker_runtime(None)
    memory.stop_sampler()


def _raise_on_load():
    raise ModuleNotFoundError("dependency missing on worker host")


class UnloadableOnWorker:
    """Pickles fine and raises when unpickled: a closure's dependency that
    is missing where the worker runs."""

    def __reduce__(self):
        return (_raise_on_load, ())


def loaded_modules(_=None) -> list:
    """The modules this (worker) process has loaded."""
    import sys

    return sorted(sys.modules)


def pid_and_modules(_=None) -> tuple:
    """This (worker) process's pid and loaded modules, after a short sleep
    so that concurrent calls spread over the fleet's workers."""
    import sys

    time.sleep(0.5)
    return os.getpid(), sorted(sys.modules)


class CountingTypeError:
    """Record each call in a file per process, then raise a deterministic
    programming error (a remote ``TypeError``)."""

    def __init__(self, path):
        self.path = path

    def __call__(self, x):
        from tests.runtime.utils import read_int_from_file, write_int_to_file

        f = os.path.join(self.path, str(os.getpid() % 8))
        write_int_to_file(f, read_int_from_file(f) + 1)
        raise TypeError("deterministic remote bug")
