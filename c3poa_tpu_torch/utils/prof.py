"""Lightweight stage profiler and counters.

The reference has no tracing at all (SURVEY.md §5 — tqdm bars only); this
gives every pipeline run per-stage wall times and throughput counters
(reads/s, alignment cell-updates/s) written to ``c3poa_stats.json``.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict


class Profiler:
    def __init__(self):
        self.times: dict = defaultdict(float)
        self.counts: dict = defaultdict(int)
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.times[name] += time.time() - t0

    def count(self, name: str, n: int = 1):
        self.counts[name] += n

    def summary(self) -> dict:
        wall = time.time() - self._t0
        out = {
            "wall_s": round(wall, 3),
            "stages_s": {k: round(v, 3) for k, v in sorted(self.times.items())},
            "counters": dict(sorted(self.counts.items())),
        }
        reads = self.counts.get("reads", 0)
        if reads and wall > 0:
            out["reads_per_sec"] = round(reads / wall, 3)
        cells = self.counts.get("align_cells", 0)
        t_align = self.times.get("align", 0)
        if cells and t_align > 0:
            out["align_cell_updates_per_sec"] = round(cells / t_align, 1)
        return out

    def dump(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=1)


# process-wide default profiler; the pipeline swaps in a fresh one per run
current = Profiler()


def reset() -> Profiler:
    global current
    current = Profiler()
    return current
