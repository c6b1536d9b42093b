#!/usr/bin/env python3
"""The program's spans in one run of a cell: where each pipeline thread
spends the window, and what the host was doing while the device idled.

    python3 h100_bench/spans.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> --out <file.json>

runs the cell as ``run.py`` does, with ``c3poa_tpu_torch.utils.prof``'s
span log turned on before the warm-up, prints ``run.py``'s result line,
and writes to ``--out`` the reductions below: each thread's top-level
spans and each stage's wall, self and CPU seconds in the window, each
call's fill and drain, the per-group series (``vote`` seconds, the
``rss_mb`` gauge at each checkpoint), the cold first locate's split and,
with ``--trace 1``, the device's idle seconds by the innermost program
span open on the threads that launch device work; the span log and the
device events go with them.  A run with the log on is not the
benchmark's run: compare its ``reads_per_s`` with ``run.py``'s on the
same seeds for the log's cost.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

LAUNCHERS = ("c3_locate", "c3_align")


def device_gaps(events: list, t0: float, t1: float) -> list:
    """[(a, b)] stretches of [t0, t1] in which no device activity of
    ``events`` ([(name, start, end)]) ran."""
    inside = sorted((max(a, t0), min(b, t1)) for _n, a, b in events
                    if b > t0 and a < t1)
    gaps, cur = [], t0
    for a, b in inside:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


def timeline(spans: list) -> list:
    """The spans of one thread (properly nested) as [(start, end, name)]
    of the innermost span open in each stretch, in time order."""
    marks = []
    for s in spans:
        marks.append((s.start, 1, -s.end, s))
        marks.append((s.end, 0, -s.start, s))
    marks.sort(key=lambda m: m[:3])
    out, stack, prev = [], [], None
    for t, kind, _k, s in marks:
        if stack and t > prev:
            out.append((prev, t, stack[-1].name))
        if kind:
            stack.append(s)
        elif s in stack:
            stack.remove(s)
        prev = t
    return out


def innermost_at(tl: list, starts: list, t: float) -> str | None:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and tl[i][1] > t:
        return tl[i][2]
    return None


def spans_only(spans: list) -> list:
    return [s for s in spans if s.value is None]


def idle_by_program_span(events: list, t0: float, t1: float, spans: list,
                         threads=LAUNCHERS) -> list:
    """Device-idle seconds of [t0, t1] by the innermost program span open
    at each gap's middle on each thread of ``threads`` (name prefixes,
    one thread each); the ten largest, [[label, seconds]]."""
    lines = []
    for prefix in threads:
        tl = timeline([s for s in spans_only(spans)
                       if s.thread.startswith(prefix)])
        lines.append((prefix, tl, [x[0] for x in tl]))
    idle: dict = {}
    for a, b in device_gaps(events, t0, t1):
        mid = (a + b) / 2
        label = " ".join(f"{p}:{innermost_at(tl, st, mid) or 'none'}"
                         for p, tl, st in lines)
        idle[label] = idle.get(label, 0.0) + (b - a)
    return [[k, v] for k, v in
            sorted(idle.items(), key=lambda kv: -kv[1])[:10]]


def thread_table(spans: list, t0: float, t1: float) -> dict:
    """Per thread, over the spans that start in [t0, t1): each stage's
    wall, self (wall less its children's) and CPU seconds and count, and
    the thread's busy (top-level spans other than ``wait_*``) and wait
    (top-level ``wait_*``) seconds and shares of the window."""
    win = [s for s in spans_only(spans) if t0 <= s.start < t1]
    child_s: dict = {}
    for s in win:
        if s.parent is not None:
            child_s[s.parent] = child_s.get(s.parent, 0.0) + s.end - s.start
    out: dict = {}
    for s in win:
        th = out.setdefault(s.thread, {"stages": {}, "busy_s": 0.0,
                                       "busy_cpu_s": 0.0, "wait_s": 0.0})
        wall = s.end - s.start
        st = th["stages"].setdefault(s.name, {"s": 0.0, "self_s": 0.0,
                                               "cpu_s": 0.0, "n": 0})
        st["s"] += wall
        st["self_s"] += wall - child_s.get(s.id, 0.0)
        st["cpu_s"] += s.cpu_s
        st["n"] += 1
        if s.parent is None:
            if s.name.startswith("wait_"):
                th["wait_s"] += wall
            else:
                th["busy_s"] += wall
                th["busy_cpu_s"] += s.cpu_s
    for th in out.values():
        th["busy_share"] = th["busy_s"] / (t1 - t0)
        th["wait_share"] = th["wait_s"] / (t1 - t0)
        th["cpu_share_of_busy"] = (th["busy_cpu_s"] / th["busy_s"]
                                   if th["busy_s"] else None)
    return out


def call_table(spans: list, calls: list) -> list:
    """Per call ((start, end) of each ``run_pipeline``): its seconds, its
    fill (start to the first ``finalize``), its drain (the last
    ``device_prep`` end to its end) and the gap to the next call."""
    out = []
    sp = spans_only(spans)
    for k, (c0, c1) in enumerate(calls):
        mine = [s for s in sp if c0 <= s.start < c1]
        fin = [s.start for s in mine if s.name == "finalize"]
        dev = [s.end for s in mine if s.name == "device_prep"]
        nxt = calls[k + 1][0] - c1 if k + 1 < len(calls) else None
        out.append(dict(s=c1 - c0, fill_s=min(fin) - c0 if fin else None,
                        drain_s=c1 - max(dev) if dev else None,
                        gap_to_next_s=nxt))
    return out


def group_series(spans: list, calls: list) -> list:
    """Per call and group: the group's ``vote``, ``finalize``,
    ``host_prep`` and ``device_prep`` seconds, and the ``rss_mb`` gauge
    at its checkpoint."""
    out = []
    for k, (c0, c1) in enumerate(calls):
        rows: dict = {}
        for s in spans:
            if not (c0 <= s.start < c1) or s.group is None:
                continue
            row = rows.setdefault(s.group, {"call": k, "group": s.group})
            if s.value is not None:
                row[s.name] = s.value
            elif s.name in ("vote", "finalize", "host_prep", "device_prep"):
                row[s.name + "_s"] = (row.get(s.name + "_s", 0.0)
                                      + s.end - s.start)
        out += [rows[g] for g in sorted(rows) if len(rows[g]) > 2]
    return out


def cold_locate(spans: list) -> dict | None:
    """The first ``locate`` span of the log with its descendants' self
    seconds by name (``kernel_load`` inside ``locate_dispatch`` ...)."""
    sp = spans_only(spans)
    loc = [s for s in sp if s.name == "locate"]
    if not loc:
        return None
    first = min(loc, key=lambda s: s.start)
    kids: dict = {}
    for s in sp:
        kids.setdefault(s.parent, []).append(s)
    split: dict = {}

    def walk(s):
        inner = sum(c.end - c.start for c in kids.get(s.id, []))
        split[s.name] = split.get(s.name, 0.0) + (s.end - s.start) - inner
        for c in kids.get(s.id, []):
            walk(c)

    walk(first)
    return dict(s=first.end - first.start, group=first.group,
                self_s=split)


def spans_run(args, **run_kw) -> tuple:
    """``run.run_cell(args, **run_kw)`` with the span log on from before
    the warm-up; returns its output and the reductions.  The harness's
    files stay as they are: the calls' bounds and the device events are
    taken by wrapping ``run_pipeline`` and ``Trace.reduce`` for the run."""
    import c3poa_tpu_torch.pipeline.run as pipeline_run
    from c3poa_tpu_torch.utils import prof
    from h100_bench import roofline, run

    calls: list = []                        # (start, end) a run_pipeline
    traced: dict = {}
    run_pipeline = pipeline_run.run_pipeline
    reduce = roofline.Trace.reduce

    def timed_run_pipeline(*a, **k):
        t0 = time.perf_counter()
        try:
            return run_pipeline(*a, **k)
        finally:
            calls.append((t0, time.perf_counter()))

    def keep_events(self, t0, t1, spans):
        traced.update(events=self.events(), t0=t0, t1=t1)
        return reduce(self, t0, t1, spans)

    pipeline_run.run_pipeline = timed_run_pipeline
    roofline.Trace.reduce = keep_events
    prof.take_spans()
    prof.record_spans(True)
    try:
        out = run.run_cell(args, **run_kw)
    finally:
        prof.record_spans(False)
        pipeline_run.run_pipeline = run_pipeline
        roofline.Trace.reduce = reduce
    spans = prof.take_spans()

    window = calls[1:]                      # calls[0] is the warm-up
    t0 = traced.get("t0", window[0][0])
    t1 = traced.get("t1", window[-1][1])
    res = dict(workload=args.workload, seed=args.seed, trace=args.trace,
               t0=t0, t1=t1, window_s=t1 - t0, reads=out["info"]["reads"],
               spans=len(spans), threads=thread_table(spans, t0, t1),
               calls=call_table(spans, window),
               warm_up=call_table(spans, calls[:1]),
               groups=group_series(spans, window),
               cold_locate=cold_locate(spans),
               metrics=out["result"]["metrics"],
               device=out["result"]["device"])
    if traced:
        res["idle_by_program_span"] = idle_by_program_span(
            traced["events"], t0, t1, spans)
    res["log"] = [list(s) for s in spans]
    res["device_events"] = traced.get("events", [])
    return out, res


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from h100_bench import run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    try:
        out, res = spans_run(args)
    except run.BenchError as e:
        print(f"h100_bench: {e}", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print("h100_bench: " + json.dumps(out["info"]), file=sys.stderr)
    for th, t in sorted(res["threads"].items()):
        print(f"spans {th}: busy {t['busy_s']:.3f} s, wait "
              f"{t['wait_s']:.3f} s of {res['window_s']:.3f}",
              file=sys.stderr)
    for label, s in res.get("idle_by_program_span", []):
        print(f"idle {s:.3f} s during {label}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
