"""TimelineVisualizationCallback: scatter plot of task lifecycle timestamps.

A thin view over the unified observability event stream
(``observability.EventLogCallback``); this class only adds the plot/CSV
rendering. Degrades to a CSV dump when matplotlib is unavailable.

Counterpart of ``cubed_tpu/extensions/timeline.py``; matplotlib is imported
only when a plot is drawn.
"""

from __future__ import annotations

import os
import time

from ..observability.events import EventLogCallback


class TimelineVisualizationCallback(EventLogCallback):
    def __init__(self, plots_dir: str = "plots", format: str = "png"):
        super().__init__()
        self.plots_dir = plots_dir
        self.format = format

    def on_compute_end(self, event) -> None:
        super().on_compute_end(event)
        os.makedirs(self.plots_dir, exist_ok=True)
        ts = int(self.start_tstamp or self.end_tstamp or time.time())
        try:
            self._plot(ts)
        except ImportError:
            self._dump_csv(ts)

    def _rows(self):
        t0 = self.start_tstamp or 0
        rows = []
        for i, e in enumerate(self.events):
            rows.append(
                dict(
                    index=i,
                    array_name=e.array_name,
                    task_create=(e.task_create_tstamp or t0) - t0,
                    function_start=(e.function_start_tstamp or t0) - t0,
                    function_end=(e.function_end_tstamp or t0) - t0,
                    task_result=(e.task_result_tstamp or t0) - t0,
                )
            )
        return rows

    def _plot(self, ts: int) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        rows = self._rows()
        fig, ax = plt.subplots(figsize=(10, 6))
        idx = [r["index"] for r in rows]
        for stage, color in (
            ("task_create", "tab:blue"),
            ("function_start", "tab:orange"),
            ("function_end", "tab:green"),
            ("task_result", "tab:red"),
        ):
            ax.scatter([r[stage] for r in rows], idx, s=6, label=stage, color=color)
        ax.set_xlabel("seconds since compute start")
        ax.set_ylabel("task")
        ax.legend()
        path = os.path.join(self.plots_dir, f"{ts}_timeline.{self.format}")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)

    def _dump_csv(self, ts: int) -> None:
        import csv

        rows = self._rows()
        if not rows:
            return
        path = os.path.join(self.plots_dir, f"{ts}_timeline.csv")
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
