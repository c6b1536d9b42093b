"""The port's profiler (``c3poa_tpu_torch/utils/prof.py``): per-thread
stage sums under ``stages_s``, the span log (off by default; parents,
threads, groups, ``perf_counter`` times, gauges), the deep pipeline's
spans on its three threads with outputs unchanged by the log, and the
POA pool's ``poa_read`` span landing in the submitting run's profiler."""

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from c3poa_tpu_torch.consensus import engine
from c3poa_tpu_torch.pipeline.run import PipelineConfig, run_pipeline
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
from c3poa_tpu_torch.utils import prof

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
OUTPUTS = ("c3poa.log", "Splint1/R2C2_Consensus.fasta",
           "Splint1/R2C2_Subreads.fastq", "Splint2/R2C2_Consensus.fasta",
           "Splint2/R2C2_Subreads.fastq")


@pytest.fixture(autouse=True)
def log_off():
    """Every test starts and ends with the log off and drained."""
    prof.record_spans(False)
    prof.take_spans()
    yield
    prof.record_spans(False)
    prof.take_spans()


def _stages_on_two_threads(p):
    with p.stage("outer"):
        with p.stage("inner"):
            time.sleep(0.002)

    def work():
        with p.stage("outer", group=9):
            p.gauge("g", 1.0)
            time.sleep(0.002)

    t = threading.Thread(target=work, name="worker")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()


def test_log_off_records_nothing_and_stages_sum_threads():
    p = prof.reset()
    _stages_on_two_threads(p)
    assert not prof.recording() and prof.take_spans() == []
    assert prof.current_group() is None
    s = p.summary()
    me = threading.current_thread().name
    assert set(s["threads"]) == {me, "worker"}
    assert set(s["threads"][me]) == {"outer", "inner"}
    for name, total in s["stages_s"].items():
        per = sum(th[name]["s"] for th in s["threads"].values()
                  if name in th)
        assert abs(per - total) <= 0.0015, name
    rec = s["threads"]["worker"]["outer"]
    assert 0 <= rec["first"] <= rec["last"] <= s["wall_s"] + 0.001
    assert rec["s"] >= 0.002 - 1e-6


def test_spans_parents_threads_groups_on_perf_counter():
    p = prof.reset()
    prof.record_spans(True)
    t_before = time.perf_counter()
    with p.stage("top", group=3):
        assert prof.current_group() == 3
        with p.stage("child"):
            p.gauge("rss", 12.5)
    _stages_on_two_threads(p)
    t_after = time.perf_counter()
    prof.record_spans(False)
    with p.stage("unlogged"):
        pass
    spans = prof.take_spans()
    by = {}
    for s in spans:
        by.setdefault((s.thread, s.name), []).append(s)
    me = threading.current_thread().name
    top, = by[(me, "top")]
    child, = by[(me, "child")]
    gauge, = by[(me, "rss")]
    assert top.parent is None and top.group == 3
    assert child.parent == top.id and child.group == 3
    assert gauge.parent == child.id and gauge.group == 3
    assert gauge.value == 12.5 and gauge.start == gauge.end
    assert top.start <= child.start <= gauge.start <= child.end <= top.end
    outer, = by[(me, "outer")]
    inner, = by[(me, "inner")]
    assert inner.parent == outer.id
    assert inner.group is None
    w, = by[("worker", "outer")]
    wg, = by[("worker", "g")]
    assert w.parent is None and w.group == 9 and wg.group == 9
    assert wg.parent == w.id
    assert (me, "unlogged") not in by
    for s in spans:
        assert t_before <= s.start <= s.end <= t_after
        assert s.cpu_s >= 0
        assert s.value is not None or s.cpu_s <= s.end - s.start + 0.01
    assert len({s.id for s in spans}) == len(spans)
    assert prof.take_spans() == []


def test_log_outlives_reset_and_first_spans_stay():
    p = prof.reset()
    prof.record_spans(True)
    with p.stage("only_here_once"):
        pass
    first = prof.first_spans()["only_here_once"]
    prof.reset()
    with prof.current.stage("only_here_once"):
        pass
    spans = prof.take_spans()
    assert [s.name for s in spans] == ["only_here_once"] * 2
    assert prof.first_spans()["only_here_once"] == first
    assert first == (spans[0].start, spans[0].end)


def _golden(out, on):
    prof.record_spans(on)
    try:
        run_pipeline(os.path.join(GOLDEN, "reads.fastq"),
                     os.path.join(GOLDEN, "splint.fasta"), out,
                     PipelineConfig(lencutoff=500, group_size=7),
                     TorchBackend("cpu"))
    finally:
        prof.record_spans(False)
    return prof.take_spans()


def test_deep_pipeline_spans_on_three_threads(tmp_path):
    """The golden set through TorchBackend("cpu") in groups of 7: the
    deep pipeline's spans come from its locate thread, its align thread
    and the calling thread, in order for each group, and the log changes
    no output byte."""
    off = _golden(str(tmp_path / "off"), False)
    spans = _golden(str(tmp_path / "on"), True)
    assert off == []
    for rel in OUTPUTS:
        a = (tmp_path / "off" / rel).read_bytes()
        assert a and a == (tmp_path / "on" / rel).read_bytes(), rel
    me = threading.current_thread().name
    threads = {s.thread for s in spans}
    assert {me, "c3_locate_0", "c3_align_0"} <= threads
    top = {}
    for s in spans:
        if s.parent is None and s.value is None:
            top.setdefault((s.name, s.group), []).append(s)
    groups = sorted(g for (n, g) in top if n == "finalize")
    assert groups == list(range(1, len(groups) + 1)) and len(groups) >= 3
    for gi in groups:
        (hp,), (dp,), (fin,) = (top[("host_prep", gi)],
                                top[("device_prep", gi)],
                                top[("finalize", gi)])
        (wh,), (wp,) = top[("wait_host", gi)], top[("wait_prep", gi)]
        assert hp.thread == "c3_locate_0" and dp.thread == "c3_align_0"
        assert fin.thread == wp.thread == me and wh.thread == "c3_align_0"
        assert hp.end <= wh.end <= dp.start <= dp.end <= wp.end \
            <= fin.start
        assert top[("read_group", gi)][0].thread == me
    ids = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            parent = ids[s.parent]
            assert parent.thread == s.thread and parent.group == s.group
            assert parent.start <= s.start <= s.end <= parent.end
    named = {(s.thread, s.name) for s in spans}
    for stage in ("locate", "locate_dispatch", "locate_wait",
                  "locate_select", "segment", "consensus"):
        assert ("c3_locate_0", stage) in named, stage
    for stage in ("align", "align_dispatch", "align_wait",
                  "align_host_records", "consensus"):
        assert ("c3_align_0", stage) in named, stage
    # records are built in place in the vote layout: no embed stage
    assert not any(name == "embed" for _thread, name in named)
    for stage in ("vote", "vote_native", "write", "consensus"):
        assert (me, stage) in named, stage
    for s in spans:
        if s.name == "vote_native":
            assert ids[s.parent].name == "vote"
    rss = [s for s in spans if s.name == "rss_mb"]
    assert sorted(s.group for s in rss) == groups
    assert all(s.value > 0 for s in rss)

    st = json.load(open(tmp_path / "on" / "c3poa_stats.json"))
    assert set(st["threads"]) == {me, "c3_locate_0", "c3_align_0"}
    for name, total in st["stages_s"].items():
        per = sum(th[name]["s"] for th in st["threads"].values()
                  if name in th)
        assert abs(per - total) <= 0.0015, name
    for th in st["threads"].values():
        for rec in th.values():
            assert 0 <= rec["first"] <= rec["last"] <= st["wall_s"]


def test_poa_read_lands_in_the_submitting_profiler(monkeypatch):
    """A routed read's ``poa_read`` span is timed on the POA pool's thread
    into the profiler of the run that submitted it, with its group, even
    when another thread resets ``prof.current`` before the read starts."""
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="c3_poa")
    gate = threading.Event()
    busy = pool.submit(gate.wait, 30)   # holds the one pool thread
    monkeypatch.setattr(engine, "_poa_pool", lambda: pool)
    monkeypatch.setattr(engine, "_diverged_owner", lambda *a: True)
    monkeypatch.setattr(
        engine, "_poa_consensus_read",
        lambda s, q: (np.zeros(0, np.int8), np.zeros(0, np.int8), False))
    rng = np.random.default_rng(5)
    subs = [rng.integers(0, 4, 300).astype(np.int8) for _ in range(3)]
    quals = [np.full(300, 20, np.int8) for _ in range(3)]
    job = engine.ConsensusJob(subs, quals, [], [])
    state0 = engine.consensus_build_pairs([job], engine.ConsensusParams())
    try:
        run_prof = prof.reset()
        prof.record_spans(True)
        with run_prof.stage("device_prep", group=7):
            state = engine.consensus_align(state0)
        fut, = state["poa_futures"].values()
        other = threading.Thread(target=prof.reset, name="resetter")
        other.start()
        other.join(timeout=10)
        assert not other.is_alive() and prof.current is not run_prof
        gate.set()
        assert busy.result(timeout=30)
        fut.result(timeout=30)
    finally:
        gate.set()
        pool.shutdown(wait=True)
        prof.record_spans(False)

    pool_threads = [th for th, per in run_prof.threads.items()
                    if "poa_read" in per]
    assert pool_threads == ["c3_poa_0"]
    assert prof.current.threads == {}
    span, = [s for s in prof.take_spans() if s.name == "poa_read"]
    assert span.group == 7 and span.thread == "c3_poa_0"
    assert span.parent is None
