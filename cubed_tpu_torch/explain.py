"""Render a saved EXPLAIN report: ``python -m cubed_tpu_torch.explain <path>``.

``<path>`` is either an ``ExplainReport`` JSON written by
``arr.explain().save("explain.json")`` — rendered exactly like
``print(arr.explain())`` — or a flight-recorder bundle directory, in which
case the plan section of its manifest is rendered as a projected-vs-
measured table (the post-hoc cousin of EXPLAIN). ``--json`` prints the raw
report instead of the table. Counterpart of ``cubed_tpu/explain.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from .observability.analytics import (
    ExplainReport,
    _fmt_mem,
    render_explain,
)


def render_bundle_plan(manifest: dict) -> str:
    """EXPLAIN-style view of a bundle's plan section: the projections the
    plan made, joined against what the compute measured."""
    out = [
        f"compute {manifest.get('compute_id')}  [{manifest.get('status')}]"
        "  plan projections vs measured:"
    ]
    wall = manifest.get("op_wall_clock") or {}
    out.append(
        f"{'OP':<30}{'TASKS':>7}{'PROJ MEM':>11}{'PEAK':>11}"
        f"{'UTIL':>9}{'WALL':>9}"
    )
    for row in manifest.get("plan") or []:
        util = row.get("projected_mem_utilization")
        w = wall.get(row.get("array_name"))
        if not isinstance(util, (int, float)):
            util_s = "-"
        elif util <= 9.995:
            util_s = f"{util:.0%}"
        else:
            # VmHWM peaks carry the whole process footprint: huge ratios
            # over tiny projections are expected noise, render compactly
            util_s = f"{util:.0f}x"
        wall_s = f"{w:.3f}s" if isinstance(w, (int, float)) else "-"
        out.append(
            f"{row.get('array_name', '?'):<30}"
            f"{row.get('num_tasks', '-'):>7}"
            f"{_fmt_mem(row.get('projected_mem')):>11}"
            f"{_fmt_mem(row.get('peak_measured_mem')):>11}"
            f"{util_s:>9}{wall_s:>9}"
        )
    return "\n".join(out) + "\n"


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cubed_tpu_torch.explain", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "path",
        help="an ExplainReport JSON (arr.explain().save(...)) or a "
        "flight-recorder bundle directory",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="print the raw report JSON instead of the rendered table",
    )
    args = parser.parse_args(argv)

    manifest_path = os.path.join(args.path, "manifest.json")
    try:
        if os.path.isdir(args.path) and os.path.exists(manifest_path):
            with open(manifest_path) as f:
                manifest = json.load(f)
            if args.json:
                json.dump(manifest.get("plan") or [], sys.stdout, indent=1)
                sys.stdout.write("\n")
            else:
                sys.stdout.write(render_bundle_plan(manifest))
            return 0
        report = ExplainReport.load(args.path)
    except (OSError, ValueError) as e:
        print(f"cannot read {args.path!r}: {e}", file=sys.stderr)
        return 2
    if args.json:
        json.dump(report.to_dict(), sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_explain(report.to_dict()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
