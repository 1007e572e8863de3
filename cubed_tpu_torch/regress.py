"""Cross-run regression attribution: ``python -m cubed_tpu_torch.regress``.

Reads the durable run archive (``runs.jsonl`` written under
``Spec(run_history=...)`` / the service's ``service_dir``), picks the
compute to explain (``--compute``, default: the latest compute record),
finds its baseline (``--baseline``, default: the most recent earlier OK
run with the SAME plan structural fingerprint), and prints the
bucket-by-bucket / per-op diff that names what got slower
(:func:`~cubed_tpu_torch.observability.analytics.regression_diff`).

Exit codes are CI-gate friendly: ``0`` no regression, ``1`` the run
regressed past the 1.10x wall-clock threshold, ``2`` the diff could not
be made (no archive, no matching record, no comparable baseline).
Counterpart of ``cubed_tpu/regress.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from .observability.analytics import regression_diff, render_regression
from .observability.runhistory import find_baseline, load_runs

#: operator convenience: point the CLI at an archive once per shell
HISTORY_ENV_VAR = "CUBED_TPU_TORCH_RUN_HISTORY"


def _pick_current(records: list, compute_id: Optional[str]) -> Optional[dict]:
    computes = [r for r in records if r.get("kind") == "compute"]
    if compute_id is not None:
        for rec in reversed(computes):
            if rec.get("compute_id") == compute_id:
                return rec
        return None
    # latest compute that carries a decomposition (diffable); fall back
    # to the latest compute at all so the error names what is missing
    for rec in reversed(computes):
        if rec.get("buckets"):
            return rec
    return computes[-1] if computes else None


def _pick_baseline(
    records: list, current: dict, baseline_id: Optional[str]
) -> Optional[dict]:
    if baseline_id is not None:
        for rec in reversed(records):
            if (
                rec.get("kind") == "compute"
                and rec.get("compute_id") == baseline_id
            ):
                return rec
        return None
    return find_baseline(
        records,
        current.get("fingerprint"),
        before_ts=current.get("ts"),
        exclude_compute_id=current.get("compute_id"),
    )


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cubed_tpu_torch.regress", description=__doc__
    )
    parser.add_argument(
        "--history",
        default=os.environ.get(HISTORY_ENV_VAR),
        help="run-history directory holding runs.jsonl (default: "
        f"${HISTORY_ENV_VAR})",
    )
    parser.add_argument(
        "--compute", default=None,
        help="compute id to explain (default: latest archived compute)",
    )
    parser.add_argument(
        "--baseline", default=None,
        help="baseline compute id (default: most recent earlier OK run "
        "with the same plan fingerprint)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the regression diff as JSON instead of the report",
    )
    args = parser.parse_args(argv)

    if not args.history:
        print(
            "no run-history directory: pass --history or set "
            f"${HISTORY_ENV_VAR}",
            file=sys.stderr,
        )
        return 2
    records, bad = load_runs(args.history)
    if not records:
        print(
            f"no archive records under {args.history!r} "
            f"({bad} unreadable line(s))",
            file=sys.stderr,
        )
        return 2

    current = _pick_current(records, args.compute)
    if current is None:
        print(
            f"no compute record {args.compute!r} in the archive",
            file=sys.stderr,
        )
        return 2
    if not current.get("buckets"):
        print(
            f"compute {current.get('compute_id')!r} carries no bucket "
            "decomposition (it ran without a trace) — nothing to diff",
            file=sys.stderr,
        )
        return 2
    baseline = _pick_baseline(records, current, args.baseline)
    if baseline is None:
        print(
            "no comparable baseline (same fingerprint, earlier, OK, "
            "with a decomposition) for compute "
            f"{current.get('compute_id')!r}",
            file=sys.stderr,
        )
        return 2

    reg = regression_diff(baseline, current)
    if args.as_json:
        json.dump(reg, sys.stdout, indent=1, default=str)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_regression(reg))
    return 1 if reg.get("regressed") else 0


if __name__ == "__main__":
    sys.exit(main())
