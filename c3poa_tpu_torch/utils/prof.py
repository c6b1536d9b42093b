"""Lightweight stage profiler and counters.

The reference has no tracing at all (SURVEY.md §5 — tqdm bars only); this
gives every pipeline run per-stage wall times and throughput counters
(reads/s, alignment cell-updates/s) written to ``c3poa_stats.json``.

Every stage is also summed per thread, with its first start and last end
(``threads`` in ``c3poa_stats.json``, seconds from the run's start), and
``stages_s`` is that sum over threads.  A process-wide span log, off by
default, keeps each stage as a ``Span`` while it is on
(``record_spans(True)``, drained by ``take_spans()``): its parent (the
innermost span open on the same thread), the thread's name, the group it
serves, its start and end on ``time.perf_counter`` (the clock the
benchmark puts device activity on) and the thread's CPU seconds inside
it.  The log outlives ``reset()``, which each pipeline run makes.
``Profiler.gauge`` puts a value on the log while it is on;
``first_spans()`` keeps, always, the process's first span of each stage.
"""
# Differs from c3poa_tpu/utils/prof.py: perf_counter, per-thread sums, spans.

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict
from typing import NamedTuple


class Span(NamedTuple):
    """One closed stage (or, with ``value`` set, one gauge reading:
    ``start == end``, no CPU time)."""
    id: int
    parent: int | None
    name: str
    thread: str
    group: int | None
    start: float
    end: float
    cpu_s: float
    value: float | None = None


_log_on = False
_log: list = []
_log_lock = threading.Lock()
_ids = itertools.count(1)
_open = threading.local()   # .stack: [(span id, group)] while the log is on
# the process's first closed span of each stage name: (start, end)
_first: dict = {}


def record_spans(on: bool) -> None:
    """Turn the process-wide span log on or off."""
    global _log_on
    _log_on = bool(on)


def recording() -> bool:
    """Is the span log on?"""
    return _log_on


def take_spans() -> list:
    """Drain the span log: every ``Span`` recorded since the last call."""
    with _log_lock:
        out = list(_log)
        _log.clear()
    return out


def first_spans() -> dict:
    """{stage: (start, end)} of the first span of each stage that closed
    in this process (a cold process's first locate, its kernel loads)."""
    return dict(_first)


def _stack() -> list:
    st = getattr(_open, "stack", None)
    if st is None:
        st = _open.stack = []
    return st


def current_group() -> int | None:
    """The group of the innermost span open on this thread (None when
    the log is off or no span is open)."""
    if not _log_on:
        return None
    st = _stack()
    return st[-1][1] if st else None


class Profiler:
    def __init__(self):
        self.counts: dict = defaultdict(int)
        # thread name -> stage -> [seconds, first start, last end]; each
        # thread writes only its own entry
        self.threads: dict = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str, group: int | None = None):
        """Time ``name`` on this thread; ``group`` labels the span (the
        enclosing span's group when None)."""
        thread = threading.current_thread().name
        logged = _log_on
        if logged:
            st = _stack()
            parent = st[-1] if st else (None, None)
            if group is None:
                group = parent[1]
            sid = next(_ids)
            st.append((sid, group))
            cpu0 = time.thread_time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            per = self.threads.get(thread)
            if per is None:
                per = self.threads.setdefault(thread, {})
            rec = per.get(name)
            if rec is None:
                per[name] = [t1 - t0, t0, t1]
            else:
                rec[0] += t1 - t0
                rec[2] = t1
            if name not in _first:
                _first.setdefault(name, (t0, t1))
            if logged:
                st.pop()
                span = Span(sid, parent[0], name, thread, group, t0, t1,
                            time.thread_time() - cpu0)
                with _log_lock:
                    _log.append(span)

    def gauge(self, name: str, value: float) -> None:
        """Record ``value`` on the span log (only while it is on), in the
        group of the innermost span open on this thread."""
        if not _log_on:
            return
        st = _stack()
        parent, group = st[-1] if st else (None, None)
        t = time.perf_counter()
        span = Span(next(_ids), parent, name,
                    threading.current_thread().name, group, t, t, 0.0,
                    float(value))
        with _log_lock:
            _log.append(span)

    def count(self, name: str, n: int = 1):
        self.counts[name] += n

    @property
    def times(self) -> dict:
        """Seconds of each stage, summed over threads."""
        out: dict = defaultdict(float)
        for per in list(self.threads.values()):
            for name, rec in list(per.items()):
                out[name] += rec[0]
        return out

    def summary(self) -> dict:
        wall = time.perf_counter() - self._t0
        times = self.times
        out = {
            "wall_s": round(wall, 3),
            "stages_s": {k: round(v, 3) for k, v in sorted(times.items())},
            "counters": dict(sorted(self.counts.items())),
            "threads": {
                th: {k: {"s": round(r[0], 3),
                         "first": round(r[1] - self._t0, 3),
                         "last": round(r[2] - self._t0, 3)}
                     for k, r in sorted(per.items())}
                for th, per in sorted(self.threads.items())},
        }
        reads = self.counts.get("reads", 0)
        if reads and wall > 0:
            out["reads_per_sec"] = round(reads / wall, 3)
        cells = self.counts.get("align_cells", 0)
        t_align = times.get("align", 0)
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
