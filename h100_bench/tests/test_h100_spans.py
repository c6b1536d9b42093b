"""The program-span metrics and reductions on the CPU: the nine readers
against a synthetic ``RunRecord`` (and None where the program has no
such spans, as before it had them), the device idle time reduced by the
innermost program span against synthetic device events, and
``spans.py`` run through the harness on a tiny cell."""

import argparse
import json
import os

import pytest

from c3poa_tpu_torch.utils import prof
from c3poa_tpu_torch.utils.prof import Span
from h100_bench import roofline, run, spans
from h100_bench.reference import check as C

HERE = os.path.join(run.ROOT, "h100_bench")
NEW = ("run.main_busy_s_per_kread", "run.locate_thread_busy_s_per_kread",
       "run.align_thread_busy_s_per_kread", "run.main_wait_s_per_kread",
       "run.align_wait_s_per_kread", "locate.device_wait_ms_per_kread",
       "locate.rerun_ms_per_kread", "align.device_wait_ms_per_kread",
       "setup.first_locate_s")


def reader(name):
    return run.load_module(os.path.join(HERE, "metrics", name + ".py"),
                           "h100_bench.metrics." + name)


def record(stages):
    cfg = json.load(open(os.path.join(HERE, "configs", "r2c2_cdna.json")))
    win = dict(reads=4000, t0=10.0, t1=20.0, stages=stages, counters={})
    return roofline.RunRecord(win, [], {"busy_s": 0.1, "window_s": 10.0,
                                        "by_name": {}}, None, cfg, HERE)


STAGES = {"read_group": 0.5, "finalize": 3.5, "host_prep": 4.0,
          "device_prep": 6.0, "wait_prep": 2.0, "wait_host": 1.0,
          "locate_wait": 0.2, "locate_rerun": 0.4, "align_wait": 0.8,
          "consensus": 9.0, "write": 0.7}


def test_readers_on_a_synthetic_record(monkeypatch):
    monkeypatch.setattr(prof, "first_spans",
                        lambda: {"locate": (100.0, 102.25)})
    got = {n: reader(n).read(record(STAGES)) for n in NEW}
    want = {"run.main_busy_s_per_kread": 1.0,
            "run.locate_thread_busy_s_per_kread": 1.0,
            "run.align_thread_busy_s_per_kread": 1.5,
            "run.main_wait_s_per_kread": 0.5,
            "run.align_wait_s_per_kread": 0.25,
            "locate.device_wait_ms_per_kread": 50.0,
            "locate.rerun_ms_per_kread": 100.0,
            "align.device_wait_ms_per_kread": 200.0,
            "setup.first_locate_s": 2.25}
    assert got == pytest.approx(want)
    no_rerun = dict(STAGES)
    del no_rerun["locate_rerun"]
    assert reader("locate.rerun_ms_per_kread").read(record(no_rerun)) == 0.0


def test_readers_find_nothing_without_the_spans(monkeypatch):
    """The parent's program: stages without the new spans, a profiler
    without first spans: every reader returns None and none raises."""
    monkeypatch.delattr(prof, "first_spans")
    old = {"consensus": 9.0, "write": 0.7, "locate": 2.0, "align": 3.0}
    for n in NEW:
        assert reader(n).read(record(old)) is None, n
    monkeypatch.setattr(prof, "first_spans", lambda: {}, raising=False)
    assert reader("setup.first_locate_s").read(record(old)) is None


def test_benchmark_lists_the_new_metrics():
    bench = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
    by = {m["name"]: m for m in bench["per_layer"]}
    for n in NEW:
        m = by[n]
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["workloads"] == ["cdna.clean"]
        assert m["moves"] == ("setup_s" if n.startswith("setup.")
                              else "reads_per_s")
    assert [m["name"] for m in bench["per_layer"]][-len(NEW):] == list(NEW)


def span(i, name, thread, start, end, parent=None, group=None, cpu=0.0,
         value=None):
    return Span(i, parent, name, thread, group, start, end, cpu, value)


def test_idle_by_program_span():
    # device busy [1, 2) and [5, 6) of the window [0, 10): gaps [0, 1),
    # [2, 5) and [6, 10), middles 0.5, 3.5 and 8
    events = [("k", 1.0, 2.0), ("k", 1.5, 1.8), ("k", 5.0, 6.0),
              ("k", 12.0, 13.0)]
    assert spans.device_gaps(events, 0.0, 10.0) == [(0.0, 1.0), (2.0, 5.0),
                                                    (6.0, 10.0)]
    log = [span(1, "host_prep", "c3_locate_0", 0.0, 9.0, group=1),
           span(2, "locate", "c3_locate_0", 0.2, 4.0, parent=1, group=1),
           span(3, "locate_wait", "c3_locate_0", 3.0, 3.9, parent=2,
                group=1),
           span(4, "device_prep", "c3_align_0", 7.0, 9.0, group=1),
           span(5, "finalize", "MainThread", 0.0, 10.0, group=1),
           span(6, "rss_mb", "c3_locate_0", 3.5, 3.5, parent=3, group=1,
                value=9.0)]
    got = dict(map(tuple, spans.idle_by_program_span(events, 0.0, 10.0,
                                                     log)))
    assert got == pytest.approx({
        "c3_locate:locate c3_align:none": 1.0,
        "c3_locate:locate_wait c3_align:none": 3.0,
        "c3_locate:host_prep c3_align:device_prep": 4.0})
    # nested spans with one start: the child is innermost
    tl = spans.timeline([span(1, "a", "t", 0.0, 2.0),
                         span(2, "b", "t", 0.0, 1.0, parent=1)])
    assert tl == [(0.0, 1.0, "b"), (1.0, 2.0, "a")]


def test_thread_calls_groups_and_cold_locate():
    log = [span(1, "locate", "c3_locate_0", 0.0, 2.0, group=1),
           span(2, "locate_dispatch", "c3_locate_0", 0.0, 1.5, parent=1,
                group=1),
           span(3, "kernel_load", "c3_locate_0", 0.1, 1.1, parent=2,
                group=1),
           span(4, "locate_wait", "c3_locate_0", 1.5, 1.9, parent=1,
                group=1),
           # the window: one call [10, 20)
           span(5, "host_prep", "c3_locate_0", 10.0, 13.0, group=1, cpu=2.0),
           span(6, "wait_host", "c3_align_0", 10.0, 13.0, group=1),
           span(7, "device_prep", "c3_align_0", 13.0, 17.0, group=1),
           span(8, "wait_prep", "MainThread", 10.0, 17.0, group=1),
           span(9, "finalize", "MainThread", 17.0, 19.0, group=1, cpu=1.5),
           span(10, "vote", "MainThread", 17.0, 18.0, parent=9, group=1),
           span(11, "rss_mb", "MainThread", 18.5, 18.5, parent=9, group=1,
                value=700.0)]
    th = spans.thread_table(log, 10.0, 20.0)
    assert th["MainThread"]["busy_s"] == 2.0
    assert th["MainThread"]["wait_s"] == 7.0
    assert th["MainThread"]["cpu_share_of_busy"] == 0.75
    assert th["MainThread"]["stages"]["finalize"]["self_s"] == 1.0
    assert th["c3_align_0"]["busy_share"] == 0.4
    assert "locate" not in th["c3_locate_0"]["stages"]
    calls = spans.call_table(log, [(0.0, 5.0), (10.0, 20.0)])
    assert calls[1] == dict(s=10.0, fill_s=7.0, drain_s=3.0,
                            gap_to_next_s=None)
    assert calls[0]["gap_to_next_s"] == 5.0
    rows = spans.group_series(log, [(10.0, 20.0)])
    assert rows == [{"call": 0, "group": 1, "host_prep_s": 3.0,
                     "device_prep_s": 4.0, "finalize_s": 2.0, "vote_s": 1.0,
                     "rss_mb": 700.0}]
    cold = spans.cold_locate(log)
    assert cold["s"] == 2.0
    assert cold["self_s"] == pytest.approx(
        {"locate": 0.1, "locate_dispatch": 0.5, "kernel_load": 1.0,
         "locate_wait": 0.4})


def test_spans_run_on_a_tiny_cell(tmp_path, monkeypatch):
    """``spans.py``'s run through the harness on the CPU: the warm-up and
    the window's calls timed, the three threads in the table, each group
    of the window with its vote and RSS, the cold locate found."""
    from test_h100_harness import tiny_root
    monkeypatch.setattr(C, "default_procs", lambda: 1)
    root = tiny_root(tmp_path)
    args = argparse.Namespace(workload="tiny.clean", seed=2 ** 31 + 11,
                              seconds=0.5, trace=0)
    out, res = spans.spans_run(args, root=root, device="cpu")
    assert out["result"]["correct"] is True
    assert not prof.recording() and prof.take_spans() == []
    assert {"MainThread", "c3_locate_0", "c3_align_0"} <= set(res["threads"])
    for th in res["threads"].values():
        assert th["busy_s"] + th["wait_s"] <= res["window_s"] + 1e-6
    assert len(res["calls"]) == out["info"]["calls"] >= 1
    assert all(c["fill_s"] is not None for c in res["calls"])
    assert res["warm_up"][0]["fill_s"] is not None
    assert res["groups"] and all("vote_s" in g and "rss_mb" in g
                                 for g in res["groups"])
    assert res["cold_locate"]["s"] > 0
    assert "idle_by_program_span" not in res
