"""The harness on the CPU: files found by name, the no-JAX guard, a
traced window with no device activity, the timed path broken underneath
a run (each fault has to make ``correct`` false), the controls run
through the harness's own comparison, and one card-only run (marked
``cuda``).

A tiny cell (its own configuration, traffic mix and limits, written into
a temporary copy of the benchmark) runs the whole harness through the
port's ``TorchBackend("cpu")``.
"""

import argparse
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest

from c3poa_tpu_torch.pipeline.backend import LocateResult
from h100_bench import control, roofline, run
from h100_bench.reference import check as C

ROOT = run.ROOT


def tiny_root(tmp_path, metric: str | None = None) -> str:
    """A checkout copy with a new configuration, traffic mix, cell,
    limits and (optionally) a new per-layer metric, added as files only."""
    root = tmp_path / "checkout"
    here = root / "h100_bench"
    for d in ("configs", "traffic", "limits", "metrics", "counts"):
        shutil.copytree(os.path.join(ROOT, "h100_bench", d), here / d)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cfg = json.loads((here / "configs" / "r2c2_cdna.json").read_text())
    cfg.update(name="tiny_cdna", splints=[{"name": "Splint1", "length": 100}])
    cfg["read_shape"].update(insert_len=[300, 600], copies=[3, 6],
                             splint_len=100)
    cfg["cli"].update(lencutoff=500, mdistcutoff=200)
    (here / "configs" / "tiny_cdna.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "clean.json").read_text())
    mix.update(reads=16, warm_reads=4,
               check={"align_reads": 3, "align_pairs": 6, "cons_reads": 8})
    (here / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (here / "limits" / "tiny.clean.json").write_text(json.dumps(
        {"device_diff": 0, "records_diff": 0, "cons_err_pct": 1.0}))
    bench["workloads"].append({"name": "tiny.clean", "config": "tiny_cdna",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.clean")
    if metric:
        bench["per_layer"].append(
            {"name": metric, "unit": "reads", "better": "higher",
             "source": "host_clock", "layer": "group stream and writers",
             "moves": "reads_per_s", "workloads": ["tiny.clean"]})
        (here / "metrics" / (metric + ".py")).write_text(
            "def read(run):\n    return float(run.reads)\n")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def tiny_run(root, fault=None, seed=2 ** 31 + 7):
    args = argparse.Namespace(workload="tiny.clean", seed=seed,
                              seconds=0.5, trace=0)
    return run.run_cell(args, root=root, device="cpu", fault=fault)


@pytest.fixture(autouse=True)
def one_worker(monkeypatch):
    monkeypatch.setattr(C, "default_procs", lambda: 1)


def test_new_files_are_found_by_name(tmp_path):
    root = tiny_root(tmp_path, metric="test.reads_seen")
    before = {p: open(os.path.join(ROOT, "h100_bench", p), "rb").read()
              for p in ("run.py", "gen.py", "roofline.py")}
    out = tiny_run(root)
    res = out["result"]
    assert res["correct"] is True, res["check"]
    assert set(res["metrics"]) == {"reads_per_s", "peak_rss_gib", "setup_s"}
    assert res["attempted"] >= 16 and res["failed"] == 0
    assert list(res)[-1] == "check"
    cell = run.Cell(json.load(open(os.path.join(root, "BENCHMARK.json"))),
                    "tiny.clean", os.path.join(root, "h100_bench"))
    assert "test.reads_seen" in [m["name"] for m in cell.per_layer]
    record = types.SimpleNamespace(
        reads=32, kreads=0.032, stages={"write": 0.5, "consensus": 1.0},
        counters={"locate_cells_real": 10, "locate_cells_padded": 15,
                  "poa_fallback_reads": 0},
        spans=[], trace={"busy_s": 0.1, "window_s": 1.0, "by_name": {}},
        span_s=lambda layer: 0.25, roofline_pct=lambda k: None)
    vals = run.per_layer_values(cell, os.path.join(root, "h100_bench"),
                                record)
    assert vals["test.reads_seen"]["value"] == 32.0
    assert vals["locate.padded_per_real"]["value"] == 1.5
    assert abs(vals["device.idle_pct"]["value"] - 90.0) < 1e-9
    assert "kernel.locate_roofline_pct" not in vals
    for p, b in before.items():
        assert open(os.path.join(ROOT, "h100_bench", p), "rb").read() == b


def test_traced_window_with_no_activity_fails():
    rec = roofline.reduce_events([], 0.0, 1.0, [("locate", 0.1, 0.2)])
    assert rec["busy_s"] == 0
    with pytest.raises(run.BenchError):
        run.traced_device(rec)
    rec = roofline.reduce_events([("k", 0.2, 0.3), ("k", 0.25, 0.4)],
                                 0.0, 1.0, [("locate", 0.5, 0.9)])
    assert abs(rec["busy_s"] - 0.2) < 1e-12
    assert run.traced_device(rec)["window_s"] == 1.0
    gaps = dict(rec["breakdown"]["idle_gaps"])
    assert abs(gaps["idle during locate"] - 0.6) < 1e-12


def test_guard_names_top_level_modules_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "c3poa_tpu_torch.x", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "c3poa_tpu.kernels",
                        types.ModuleType("k"))
    assert run.forbidden_modules() == ["c3poa_tpu"]


class ImportsJax:
    """A backend that loads a module named ``jax`` under the timed path."""

    def __init__(self, inner, ctx=None):
        self.inner = inner
        self.supports_overlap = True

    def locate_many(self, *a):
        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return self.inner.locate_many(*a)

    def align_many(self, *a, **k):
        return self.inner.align_many(*a, **k)


def test_run_trips_the_guard_when_jax_is_imported(tmp_path, monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        with pytest.raises(run.BenchError, match="jax"):
            tiny_run(tiny_root(tmp_path), fault=ImportsJax)
    finally:
        sys.modules.pop("jax", None)


class Fault:
    supports_overlap = True

    def __init__(self, inner, ctx=None):
        self.inner = inner

    def locate_many(self, reads, combos, min_dist):
        return self.inner.locate_many(reads, combos, min_dist)

    def align_many(self, pairs, params, phase_base=0):
        return self.inner.align_many(pairs, params, phase_base)


class AnswerAltered(Fault):
    """One read's first peak moved by a column where the locate answer
    is produced."""

    def locate_many(self, reads, combos, min_dist):
        out = self.inner.locate_many(reads, combos, min_dist)
        r = out[0]
        out[0] = LocateResult(r.combo, r.score,
                              np.concatenate([r.peaks[:1] + 1, r.peaks[1:]]))
        return out


class HalfLeftOut(Fault):
    """Only the first half of each align batch computed; the rest left
    out (records that cover nothing), the vote taken over the others."""

    def align_many(self, pairs, params, phase_base=0):
        from c3poa_tpu_torch.consensus.vote import SubreadAln
        from c3poa_tpu_torch.ref.banded import AlignRecord
        h = max(1, len(pairs) // 2)
        got = self.inner.align_many(pairs[:h], params, phase_base)
        for q, qual, t, *_ in pairs[h:]:
            nt = len(t)
            rec = AlignRecord(np.zeros(nt, np.int8), np.full(nt, 4, np.int8),
                              np.full(nt, -1, np.int32),
                              np.zeros(nt + 1, np.int32),
                              np.full(nt + 1, -1, np.int32), 0, 0, 0)
            got.append(SubreadAln(rec, np.asarray(q), np.asarray(qual)))
        return got


@pytest.mark.parametrize("fault", [AnswerAltered, HalfLeftOut,
                                   control.DraftControl])
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, fault):
    """An answer altered where it is produced, half of each align batch
    left out, and the align step returning its input unchanged (the
    draft control: the draft as the consensus)."""
    out = tiny_run(tiny_root(tmp_path), fault=fault)
    res = out["result"]
    assert res["correct"] is False, res["check"]


def test_precision_control_comes_out_not_correct(tmp_path):
    """The reference in float32 in the locate step's place, through the
    harness's own run and comparison: on this seed's pool (read 4) the
    float32 smoothing moves a peak by a column, so the locate answer, the
    subread records it cuts and the pairs aligned from them differ, and
    ``correct`` is false from the check itself; the consensus stays
    within its limit."""
    out = tiny_run(tiny_root(tmp_path), fault=control.PrecisionControl,
                   seed=2 ** 31 + 163)
    res, info = out["result"], out["info"]
    assert res["correct"] is False
    assert info["locate_diff"] >= 1
    assert res["check"]["records_diff"]["value"] >= 1
    assert res["check"]["cons_err_pct"]["value"] <= \
        res["check"]["cons_err_pct"]["limit"]


def test_draft_control_reads_far_above_the_consensus_limit(tmp_path):
    out = tiny_run(tiny_root(tmp_path), fault=control.DraftControl)
    c = out["result"]["check"]["cons_err_pct"]
    assert c["value"] > 3 * c["limit"]
    assert out["info"]["ends_diff"] == out["info"]["ends"] > 0


def test_every_pair_of_the_chosen_call_is_compared(tmp_path):
    out = tiny_run(tiny_root(tmp_path))
    info = out["info"]
    assert info["ends"] > info["pairs"] and info["ends_diff"] == 0


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch


@pytest.mark.cuda
def test_tiny_cell_on_the_card(card, tmp_path):
    args = argparse.Namespace(workload="tiny.clean", seed=11, seconds=1.0,
                              trace=1)
    out = run.run_cell(args, root=tiny_root(tmp_path))
    res = out["result"]
    assert res["correct"] is True, res["check"]
    assert res["device"]["busy_s"] > 0
    assert "device.idle_pct" in res["metrics"]
