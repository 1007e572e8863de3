"""HistoryCallback: record plan-time projections and per-task measurements,
write CSVs, and compute projected-memory utilization.

A thin view over the unified observability event stream
(``observability.EventLogCallback`` collects plan rows, task events and op
timings; this class only adds the CSV dump).

Counterpart of ``cubed_tpu/extensions/history.py``.
"""

from __future__ import annotations

import csv
import os
import time
from dataclasses import asdict

from ..observability.events import EventLogCallback, PlanRow  # noqa: F401


class HistoryCallback(EventLogCallback):
    def __init__(self, history_dir: str = "history"):
        super().__init__()
        self.history_dir = history_dir

    def on_compute_end(self, event) -> None:
        super().on_compute_end(event)
        ts = int(time.time())
        os.makedirs(self.history_dir, exist_ok=True)
        self._write_csv(
            os.path.join(self.history_dir, f"plan-{ts}.csv"),
            [asdict(r) for r in self.plan],
        )
        self._write_csv(
            os.path.join(self.history_dir, f"events-{ts}.csv"),
            [asdict(e) for e in self.events],
        )
        stats = self.stats()
        if stats:
            self._write_csv(os.path.join(self.history_dir, f"stats-{ts}.csv"), stats)

    def stats(self) -> list[dict]:
        """Join plan projections against measured peaks per op."""
        return self.projected_vs_measured()

    @staticmethod
    def _write_csv(path: str, rows: list[dict]) -> None:
        if not rows:
            return
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
