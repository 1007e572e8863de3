"""Worker entry point: ``python -m cubed_tpu_torch.runtime.worker HOST:PORT``.

Start one per host (or per card), pointing at the coordinator a
``DistributedDagExecutor`` created (its ``listen`` address). The shared
``Spec.work_dir`` must be reachable from every worker (a shared
filesystem): all chunk data moves through it, and the socket carries
control messages and peer-fetched chunk bytes.

``--device`` pins the chunk device (``cuda``, ``cuda:1``, ``cpu``; default
``CUBED_TPU_TORCH_DEVICE``, else ``cuda``). A worker asked for ``cuda`` on
a machine with no card exits with the error before it joins the fleet.
``--rendezvous PATH`` names a coordinator's ``rendezvous.json`` (its
``control_dir``): after losing its coordinator the worker dials whatever
successor that file advertises.
Counterpart of ``cubed_tpu/runtime/worker.py``.
"""

from __future__ import annotations

import argparse
import logging
import os

from .distributed import run_worker


def _env_seconds(name: str, default: float) -> float:
    """A float of seconds from the environment; a malformed value warns and
    keeps the default (the fleet must not fail to boot over it)."""
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        logging.getLogger(__name__).warning(
            "ignoring malformed %s=%r (want a float of seconds); using default %s", name, raw, default)
        return default


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("coordinator", help="coordinator address, host:port")
    parser.add_argument("--threads", type=int, default=1,
                        help="concurrent task slots in this worker process (default 1)")
    parser.add_argument("--name", default=None, help="worker display name")
    parser.add_argument("--device", default=None,
                        help="chunk device: cuda, cuda:N or cpu (default CUBED_TPU_TORCH_DEVICE, else cuda)")
    parser.add_argument(
        "--drain-grace", type=float, default=_env_seconds("CUBED_TPU_TORCH_DRAIN_GRACE_S", 10.0),
        help="seconds allowed to finish in-flight tasks when draining (the SIGTERM spot-preemption notice "
             "window); work still running at its end is abandoned and requeued by the coordinator "
             "(default 10, env CUBED_TPU_TORCH_DRAIN_GRACE_S)")
    parser.add_argument(
        "--reconnect-give-up", type=float, default=_env_seconds("CUBED_TPU_TORCH_RECONNECT_GIVE_UP_S", 30.0),
        help="seconds to keep retrying a lost coordinator connection before exiting; in-flight tasks keep "
             "running across a disconnect and unacked results replay on reconnect (default 30, env "
             "CUBED_TPU_TORCH_RECONNECT_GIVE_UP_S)")
    parser.add_argument(
        "--rendezvous", default=None,
        help="path to the coordinator's rendezvous advertisement file (written when the coordinator runs with a "
             "control_dir); the reconnect loop re-reads it to chase a successor coordinator after a "
             "control-plane crash, and the give-up clock is suspended while a takeover window is open")
    parser.add_argument("-v", "--verbose", action="store_true", help="log at INFO level")
    parser.add_argument("--log-json", action="store_true",
                        help="emit structured JSON log lines carrying compute/op/chunk correlation ids")
    args = parser.parse_args(argv)
    level = logging.INFO if args.verbose else logging.WARNING
    if args.log_json:
        from ..observability.logs import basic_structured_config

        basic_structured_config(level)
    else:
        logging.basicConfig(level=level, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    run_worker(args.coordinator, nthreads=args.threads, name=args.name, drain_grace_s=args.drain_grace,
               reconnect_give_up_s=args.reconnect_give_up, rendezvous=args.rendezvous, device=args.device)


if __name__ == "__main__":
    main()
