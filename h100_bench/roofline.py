"""The reduction from a traced window to numbers: device activity from
``torch.profiler`` (CUDA activity only) on the host's clock, the busy
time, the breakdown, and each kernel's roofline share from the frozen
work counts in ``counts/<kernel>.json``.

The profiler's clock is tied to the host's by a marker: right after the
profiler starts, with the card idle, the host notes its clock and
launches one short spin kernel, which is then the trace's first device
activity.
"""

from __future__ import annotations

import json
import os
import re
import time

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s.  Issue: 4 partitions of
# 32 lanes an SM, each lane one 32-bit instruction a clock.
HBM_BYTES_PER_S = 3.35e12
LANES_PER_SM = 4 * 32


class Trace:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t_mark = None

    def start(self):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(20000)
        torch.cuda.synchronize()

    def stop(self):
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def events(self) -> list:
        """[(name, start, end)] of every device activity, seconds on the
        host's ``perf_counter`` clock, the marker left out."""
        torch = self.torch
        evs = sorted(((e.name, e.time_range.start, e.time_range.end)
                      for e in self.prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda x: x[1])
        if not evs:
            return []
        offset = evs[0][1] - self.t_mark * 1e6
        return [(n, (a - offset) / 1e6, (b - offset) / 1e6)
                for n, a, b in evs[1:]]

    def reduce(self, t0: float, t1: float, spans: list) -> dict:
        return reduce_events(self.events(), t0, t1, spans)


def reduce_events(events: list, t0: float, t1: float, spans: list) -> dict:
    """Busy seconds (the union of device activities inside [t0, t1]),
    device time by name, and the idle gaps labelled by the harness spans
    in progress on the host at each gap's middle."""
    inside = [(n, max(a, t0), min(b, t1)) for n, a, b in events
              if b > t0 and a < t1]
    by_name: dict = {}
    for n, a, b in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    busy = 0.0
    gaps = []
    cur_a = cur_b = None
    for _n, a, b in sorted(inside, key=lambda x: x[1]):
        if cur_b is None:
            gaps.append((t0, a))
            cur_a, cur_b = a, b
        elif a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        gaps.append((cur_b, t1))
    idle: dict = {}
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        label = "+".join(sorted({s[0] for s in spans
                                 if s[1] <= mid < s[2]})) or "none"
        idle[label] = idle.get(label, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, window_s=t1 - t0, by_name=by_name,
                breakdown={"device_ops": [[n, s] for n, s in top],
                           "idle_gaps": [[f"idle during {n}", s]
                                         for n, s in gaps_top]})


def load_counts(here: str) -> dict:
    out = {}
    d = os.path.join(here, "counts")
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                c = json.load(fh)
            out[c["kernel"]] = c
    return out


def kernel_time(by_name: dict, kernel: str) -> float:
    """Device seconds of every activity whose name calls ``kernel``."""
    pat = re.compile(r"(^|[^A-Za-z0-9_])" + re.escape(kernel) + r"\b")
    return sum(s for n, s in by_name.items() if pat.search(n))


def bound_s(count: dict, units, peaks: dict) -> float | None:
    """The least time the counted work could take on this card: the
    larger of its instructions over the issue rate (every lane of every
    SM at the card's maximum SM clock) and its bytes over HBM's rate.
    ``units(name)`` gives the window's amount of a unit, None for none."""
    n_ops = units(count["ops"]["unit"])
    n_bytes = units(count["bytes"]["unit"])
    if not n_ops or not n_bytes:
        return None
    issue = peaks["sms"] * LANES_PER_SM * peaks["sm_hz"]
    return max(n_ops * count["ops"]["per_unit"] / issue,
               n_bytes * count["bytes"]["per_unit"] / HBM_BYTES_PER_S)


class RunRecord:
    """What a per-layer metric reads: the window's reads and seconds,
    the calls' summed stages and counters (``c3poa_stats.json``), the
    harness's spans, the reduced trace, the card's peaks, the frozen
    counts and the configuration."""

    def __init__(self, win: dict, spans: list, trace: dict, peaks: dict,
                 config: dict, here: str):
        self.reads = win["reads"]
        self.kreads = win["reads"] / 1000.0
        self.window_s = win["t1"] - win["t0"]
        self.stages = win["stages"]
        self.counters = win["counters"]
        self.spans = spans
        self.trace = trace
        self.peaks = peaks
        self.config = config
        self.counts = load_counts(here)

    def span_s(self, layer: str) -> float:
        return sum(b - a for name, a, b in self.spans if name == layer)

    def units(self, unit: str) -> float | None:
        """The window's amount of a count's unit, from the program's
        counters: real cells or columns, never padded ones."""
        c = self.counters
        combos = 2 * len(self.config["splints"])
        if unit == "profile_cell":
            return c.get("locate_cells_real", 0) * \
                self.config["splints"][0]["length"] or None
        if unit == "read_column":
            return c.get("locate_cells_real", 0) / combos or None
        if unit == "align_cell":
            return c.get("align_cells", 0) or None
        if unit in c:
            return c[unit] or None
        raise ValueError(f"unknown count unit {unit!r}")

    def roofline_pct(self, kernels: list) -> float | None:
        """Share of the kernels' summed bounds in their summed device
        time, in percent; None when a kernel ran no time or a count has
        no work."""
        if not self.peaks or not self.peaks.get("sm_hz"):
            return None
        t_dev = t_bound = 0.0
        for k in kernels:
            b = bound_s(self.counts[k], self.units, self.peaks)
            t = kernel_time(self.trace["by_name"], k)
            if b is None or t <= 0:
                return None
            t_dev += t
            t_bound += b
        return 100.0 * t_bound / t_dev
