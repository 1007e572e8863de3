"""TqdmProgressBar: one progress bar per op, driven by the unified callback
lifecycle — a bar opens on ``on_operation_start``, advances on
``on_task_end``, and closes on ``on_operation_end`` (so ops that never ran,
e.g. under ``resume``, never show a bar).

Counterpart of ``cubed_tpu/extensions/tqdm.py``; tqdm is imported only when
a compute starts. Falls back to a plain
line-printing bar when tqdm is unavailable.
"""

from __future__ import annotations

import sys
from typing import Dict

from ..runtime.types import Callback, TaskEndEvent


class _PlainBar:
    def __init__(self, desc: str, total: int):
        self.desc = desc
        self.total = total
        self.n = 0

    def update(self, n: int = 1):
        self.n += n
        pct = 100.0 * self.n / self.total if self.total else 100.0
        sys.stderr.write(f"\r{self.desc}: {self.n}/{self.total} ({pct:.0f}%)")
        if self.n >= self.total:
            sys.stderr.write("\n")
        sys.stderr.flush()

    def close(self):
        pass


class TqdmProgressBar(Callback):
    def __init__(self, **tqdm_kwargs):
        self.tqdm_kwargs = tqdm_kwargs
        self.bars: Dict[str, object] = {}
        self._position = 0

    def on_compute_start(self, event) -> None:
        self.bars = {}
        self._position = 0
        try:
            from tqdm.auto import tqdm  # noqa: F401

            self._tqdm = tqdm
        except ImportError:
            self._tqdm = None

    def on_operation_start(self, event) -> None:
        if event.name in self.bars:
            return
        if self._tqdm is not None:
            self.bars[event.name] = self._tqdm(
                desc=event.name,
                total=event.num_tasks,
                position=self._position,
                **self.tqdm_kwargs,
            )
        else:
            self.bars[event.name] = _PlainBar(event.name, event.num_tasks)
        self._position += 1

    def on_task_end(self, event: TaskEndEvent) -> None:
        bar = self.bars.get(event.array_name)
        if bar is not None:
            bar.update(event.num_tasks)

    def on_operation_end(self, event) -> None:
        bar = self.bars.get(event.name)
        if bar is not None:
            bar.close()

    def on_compute_end(self, event) -> None:
        for bar in self.bars.values():
            bar.close()
