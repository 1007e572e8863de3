"""Journal-backed request durability for the compute service.
Counterpart of ``cubed_tpu/service/durability.py``, with the request
payload written by ``runtime/payload.py`` (the stdlib's ``pickle`` with
closures by value) where the JAX package uses ``cloudpickle``.

Each tenant owns a **durable request queue** under the service directory:

.. code-block:: text

    <service_dir>/<tenant>/requests.jsonl        accepted/done records
    <service_dir>/<tenant>/<request_id>.pkl      the pickled submission
    <service_dir>/<tenant>/<request_id>.journal.jsonl  per-request compute
                                                 journal (runtime/journal.py)

The request journal reuses the :class:`~cubed_tpu_torch.runtime.journal.
ComputeJournal` writer (append-only JSONL, fsync'd load-bearing records,
torn-line-tolerant fold), so the durability discipline is identical to
the compute journal's: an ``accepted`` record is fsync'd only AFTER the
request payload (the pickled array, whose plan carries its concrete
intermediate store paths; a tensor on the card travels through the host
and is restored onto the recovering process's chunk device) is durably on disk — accepted therefore always
implies recoverable — and a ``done`` record seals the request.

Recovery (:func:`load_requests` + ``ComputeService.recover()``): every
accepted-but-not-done request is re-enqueued in submission order from its
pickled payload; when its per-request compute journal exists, the re-run
resumes from the journal ∩ chunk-integrity frontier exactly like
``resume_from_journal`` — a coordinator SIGKILL mid-stream costs only the
un-journaled tail of each in-flight compute, never an accepted request.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Optional

from ..runtime.journal import ComputeJournal

logger = logging.getLogger(__name__)

REQUESTS_FILE = "requests.jsonl"

_TENANT_SAFE = re.compile(r"[^A-Za-z0-9._-]")


def tenant_dirname(tenant: str) -> str:
    """A filesystem-safe directory name for a tenant id."""
    safe = _TENANT_SAFE.sub("_", str(tenant))
    return safe or "_"


def service_control_dir(service_dir: str) -> str:
    """The service's coordinator control-plane directory.

    Lives beside the tenant queues so one ``service_dir`` is the whole
    durability story: request queues make accepted work survive a crash
    (offline recovery), and the control dir makes the *fleet* survive one
    — a restarted service whose executor points here comes up as the next
    coordinator epoch and re-adopts still-running workers instead of
    cold-starting them (see runtime/journal.py ``ControlLog``)."""
    return os.path.join(str(service_dir), "_control")


class TenantRequestJournal:
    """One tenant's durable request queue (writer side)."""

    def __init__(self, service_dir: str, tenant: str):
        self.tenant = str(tenant)
        self.dir = os.path.join(str(service_dir), tenant_dirname(tenant))
        os.makedirs(self.dir, exist_ok=True)
        self._journal = ComputeJournal(os.path.join(self.dir, REQUESTS_FILE))

    # -- paths ---------------------------------------------------------

    def payload_path(self, request_id: str) -> str:
        return os.path.join(self.dir, f"{request_id}.pkl")

    def compute_journal_path(self, request_id: str) -> str:
        return os.path.join(self.dir, f"{request_id}.journal.jsonl")

    # -- records -------------------------------------------------------

    def record_accepted(
        self, request_id: str, array, fingerprint: Optional[str] = None,
        deadline_epoch: Optional[float] = None,
    ) -> bool:
        """Persist the payload, then the fsync'd ``accepted`` record.

        Returns True when the request is durably recoverable; False when
        the payload could not be pickled — then NO record is written at
        all (the request still RUNS, it just won't survive a crash, and
        says so in the log): an accepted record with no payload would sit
        unsealed forever (`_finish` only seals durable requests) and the
        next restart would mis-seal the already-served request FAILED.
        A class with no importable name raises
        ``payload.UnshippableClassError`` instead, with no record written."""
        try:
            from ..runtime import payload as payload_codec

            blob = payload_codec.dumps(array)
        except payload_codec.UnshippableClassError:
            # a class with no importable name (defined in __main__ or
            # inside a function) is the caller's to fix: raised at submit,
            # with no record written
            raise
        except Exception as e:
            logger.warning(
                "request %s (tenant %s) is not durable: payload pickling "
                "failed (%s) — it will run but cannot be recovered after a "
                "crash", request_id, self.tenant, e,
            )
            return False
        try:
            path = self.payload_path(request_id)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            payload = os.path.basename(path)
        except OSError as e:
            logger.warning(
                "request %s (tenant %s) is not durable: payload write "
                "failed (%s) — it will run but cannot be recovered after a "
                "crash", request_id, self.tenant, e,
            )
            return False
        if not self._journal.append(
            "accepted",
            request_id=request_id,
            tenant=self.tenant,
            fingerprint=fingerprint,
            # the request's end-to-end SLO is part of the durable
            # contract: a recovered request keeps its ABSOLUTE deadline
            # (and fails at admission if it passed during the outage)
            deadline_epoch=deadline_epoch,
            payload=payload,
            journal=os.path.basename(
                self.compute_journal_path(request_id)
            ),
        ):
            # the accepted record IS the durability promise: if it didn't
            # reach disk (full disk, dead mount) the request must run as
            # volatile — and the orphaned payload is reclaimed now, since
            # no record will ever reference it
            try:
                os.unlink(self.payload_path(request_id))
            except OSError:
                pass
            return False
        return True

    def record_done(self, request_id: str, status: str,
                    error: Optional[str] = None,
                    error_type: Optional[str] = None,
                    retry_after_s: Optional[float] = None) -> None:
        """Seal one request (``status`` in completed/failed/cancelled) and
        reclaim its payload — a done request must never be re-run.

        ``error_type``/``retry_after_s`` carry a TYPED failure through
        the journal (e.g. an overload shed's ``ServiceOverloadedError``
        and its retry-after hint), so post-restart inspection sees the
        same rejection the live handle raised."""
        self._journal.append(
            "done", request_id=request_id, status=status, error=error,
            error_type=error_type,
            retry_after_s=(
                None if retry_after_s is None else float(retry_after_s)
            ),
        )
        for path in (
            self.payload_path(request_id),
            self.compute_journal_path(request_id),
        ):
            try:
                os.unlink(path)
            except OSError:
                pass

    def close(self) -> None:
        self._journal.close()


def load_requests(service_dir: str) -> Dict[str, List[dict]]:
    """Fold every tenant's request journal into its recovery work-list.

    Returns ``{tenant: [record, ...]}`` with one record per
    accepted-but-not-done request, in acceptance order. Each record
    carries ``request_id``, ``payload_path`` (absolute, or None when the
    payload is missing — logged, skipped by recovery), and
    ``compute_journal`` (absolute path, or None when the request never
    started executing). Torn/garbage lines cost only their own record,
    same as every other journal in the system."""
    out: Dict[str, List[dict]] = {}
    root = str(service_dir)
    if not os.path.isdir(root):
        return out
    for entry in sorted(os.listdir(root)):
        tdir = os.path.join(root, entry)
        jpath = os.path.join(tdir, REQUESTS_FILE)
        if not os.path.isfile(jpath):
            continue
        records, bad_lines = _parse_lines(jpath)
        accepted: Dict[str, dict] = {}
        done: set = set()
        for rec in records:
            kind = rec.get("kind")
            rid = rec.get("request_id")
            if not isinstance(rid, str):
                continue
            if kind == "accepted":
                accepted.setdefault(rid, rec)
            elif kind == "done":
                done.add(rid)
        if bad_lines:
            logger.warning(
                "request journal %s: %d undecodable line(s) skipped",
                jpath, bad_lines,
            )
        for rid, rec in accepted.items():
            if rid in done:
                continue
            tenant = rec.get("tenant") or entry
            payload = rec.get("payload")
            payload_path = (
                os.path.join(tdir, payload) if payload else None
            )
            if payload_path and not os.path.isfile(payload_path):
                logger.warning(
                    "request %s (tenant %s): accepted but its payload "
                    "%s is gone; cannot recover it", rid, tenant, payload,
                )
                payload_path = None
            cj = os.path.join(tdir, f"{rid}.journal.jsonl")
            # grouped by each record's OWN tenant id: sanitized directory
            # names can collide ("team/a" and "team_a" share a dir), and
            # recovery must re-enqueue every request under the tenant
            # that submitted it, not whoever happens to appear first
            out.setdefault(tenant, []).append({
                "request_id": rid,
                "tenant": tenant,
                "fingerprint": rec.get("fingerprint"),
                "deadline_epoch": rec.get("deadline_epoch"),
                "payload_path": payload_path,
                "compute_journal": cj if os.path.isfile(cj) else None,
            })
    return out


def _parse_lines(path: str) -> tuple:
    """``(records, bad_lines)`` of one journal file, in file order, one
    read (the shared ``load_journal`` folds compute-journal semantics;
    request journals need the raw accepted/done stream). Same tolerance
    discipline as every journal: a torn line costs only itself."""
    import json

    records: List[dict] = []
    bad = 0
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return records, bad
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
            if not isinstance(doc, dict):
                raise ValueError("not an object")
        except (ValueError, UnicodeDecodeError):
            bad += 1
            continue
        records.append(doc)
    return records, bad


def _raw_records(path: str) -> List[dict]:
    """All decodable records of one journal file, in file order."""
    return _parse_lines(path)[0]
