"""Throttled stderr progress reporting (the reference's tqdm role,
C3POa.py:237, C3POa_postprocessing.py:143): long runs show periodic
read counts and throughput instead of silence until the end.

Enabled when stderr is a TTY or ``C3POA_PROGRESS=1``; silenced with
``C3POA_PROGRESS=0`` (tests and log-captured batch runs stay clean).
"""

from __future__ import annotations

import os
import sys
import time


class Progress:
    def __init__(self, label: str, unit: str = "reads",
                 interval: float = 1.0, stream=None):
        env = os.environ.get("C3POA_PROGRESS")
        if env is not None:
            self.enabled = env != "0"
        else:
            self.enabled = sys.stderr.isatty()
        self.label = label
        self.unit = unit
        self.interval = interval
        self.stream = stream or sys.stderr
        self.n = 0
        self._t0 = time.time()
        self._last = 0.0

    def update(self, n: int) -> None:
        self.n += n
        now = time.time()
        if self.enabled and now - self._last >= self.interval:
            self._last = now
            self._emit(now)

    def _emit(self, now: float) -> None:
        dt = max(now - self._t0, 1e-9)
        print(f"[{self.label}] {self.n} {self.unit} "
              f"({self.n / dt:.1f} {self.unit}/s)",
              file=self.stream, flush=True)

    def close(self) -> None:
        if self.enabled and self.n:
            self._emit(time.time())
