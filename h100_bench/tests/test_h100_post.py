"""The postprocess cell on the CPU: the whole harness through
``TorchBackend("cpu")`` on a 300-read pool (``correct``), a fault under
the timed path and both controls (each not correct, from the check
itself), the reference's copy held to the program's tool, the new
per-layer readers (present, and silent where the program lacks their
spans and counters), and the adapter kernel's count by hand."""

import argparse
import json
import os
import shutil
import types

import numpy as np
import pytest

from h100_bench import control_post, roofline, run
from h100_bench.reference import check as C

ROOT = run.ROOT
HERE = os.path.join(ROOT, "h100_bench")
CELL = "cdna.postprocess"
NEW = ("post.read_s_per_kread", "post.demux_s_per_kread",
       "post.adapter_ms_per_kread", "post.adapter_padded_per_real",
       "kernel.adapters_roofline_pct")


def small_root(tmp_path) -> str:
    """A checkout copy whose postprocess cell runs 300 reads of 200-600
    base inserts in groups of 100 (files only)."""
    root = tmp_path / "checkout"
    here = root / "h100_bench"
    for d in ("configs", "traffic", "limits", "metrics", "counts"):
        shutil.copytree(os.path.join(HERE, d), here / d)
    cfg_path = here / "configs" / "r2c2_cdna_post.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["read_shape"]["insert_len"] = [200, 600]
    cfg["cli"]["group_size"] = 100
    cfg_path.write_text(json.dumps(cfg))
    mix_path = here / "traffic" / "post.json"
    mix = json.loads(mix_path.read_text())
    mix.update(reads=300, warm_reads=8)
    mix_path.write_text(json.dumps(mix))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return str(root)


def small_run(root, fault=None, seed=2 ** 31 + 29):
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.5, trace=0)
    return run.run_cell(args, root=root, device="cpu", fault=fault)


@pytest.fixture(autouse=True)
def one_worker(monkeypatch):
    monkeypatch.setattr(C, "default_procs", lambda: 1)


def test_the_cell_is_correct_on_the_cpu(tmp_path):
    out = small_run(small_root(tmp_path))
    res, info = out["result"], out["info"]
    assert res["correct"] is True, res["check"]
    assert set(res["metrics"]) == {"reads_per_s", "peak_rss_gib", "setup_s"}
    assert res["attempted"] >= 300 and res["failed"] == 0
    assert info["hits_recorded"] == info["hit_reads"] > 200
    assert info["written"] > 250 and info["no_index_found"] >= 15
    c = info["counters"]
    assert c["post_reads"] == info["reads"]
    assert c["adapter_cells_real"] > 0 and info["stages"]["post_demux"] > 0


class OneScoreUp:
    """The first read of every adapter call gets 1 more on its first
    combo's best score, where the answer is produced."""

    supports_overlap = True

    def __init__(self, inner, ctx=None):
        self.inner = inner

    def adapter_hits(self, reads, combo_codes, combo_lens):
        out = self.inner.adapter_hits(reads, combo_codes, combo_lens)
        out[0] = np.array(out[0])
        out[0][0, 0] += 1
        return out


def test_one_altered_score_is_not_correct(tmp_path):
    out = small_run(small_root(tmp_path), fault=OneScoreUp)
    chk = out["result"]["check"]
    assert out["result"]["correct"] is False
    assert 1 <= chk["hits_diff"]["value"] <= 3     # one a group, if sampled


def test_swapped_index_names_exceed_the_limit(tmp_path):
    out = small_run(small_root(tmp_path), fault=control_post.SwapControl)
    chk = out["result"]["check"]
    assert out["result"]["correct"] is False
    assert chk["wrong_index_pct"]["value"] > 20 * chk["wrong_index_pct"][
        "limit"]
    # the reference reads the same swapped file: records and hits agree
    assert chk["records_diff"]["value"] == chk["hits_diff"]["value"] == 0


def test_precision_control_is_not_correct(tmp_path):
    """The reference in int8 in the adapter step's place: read columns
    wrap, so hits and records differ."""
    out = small_run(small_root(tmp_path),
                    fault=control_post.PrecisionControl)
    chk = out["result"]["check"]
    assert out["result"]["correct"] is False
    assert chk["hits_diff"]["value"] > 100 and chk["records_diff"]["value"] > 0


def body(path: str) -> str:
    src = open(path).read()
    return src[src.index('\n"""\n') + 5:]


def test_the_reference_is_the_tool_below_its_docstring():
    tool = os.path.join(ROOT, "c3poa_tpu_torch", "tools",
                        "plain_postprocess.py")
    assert body(os.path.join(HERE, "reference", "post.py")) == body(tool)
    assert "import torch" in body(tool) and "c3poa_tpu" not in body(tool)


def record(stages, counters, by_name=None, spans=()):
    with open(os.path.join(HERE, "configs", "r2c2_cdna_post.json")) as fh:
        cfg = json.load(fh)
    return roofline.RunRecord(
        dict(reads=2000, t0=0.0, t1=1.0, stages=stages, counters=counters),
        list(spans), {"by_name": by_name or {}, "busy_s": 0.1,
                      "window_s": 1.0},
        {"sms": 132, "sm_hz": 1.98e9}, cfg, HERE)


def test_new_readers_read_and_fall_silent_without_the_program_s_numbers():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        cell = run.Cell(json.load(fh), CELL, HERE)
    assert [m["name"] for m in cell.per_layer] == list(NEW)
    ops = 8 * 10 ** 9
    counters = {"adapter_cells_real": 10 ** 9, "adapter_cells_padded": 15 *
                10 ** 8, "adapter_read_columns": 6 * 10 ** 6}
    issue = 132 * 128 * 1.98e9
    kernel = "void adapter_hits_kernel<true>(signed char const*, int)"
    rec = record({"post_read": 0.5, "post_encode": 0.25, "post_demux": 3.0},
                 counters, by_name={kernel: 4 * ops / issue},
                 spans=[("adapter", 0.0, 0.2), ("adapter", 0.5, 0.6)])
    vals = {k: v["value"] for k, v in
            run.per_layer_values(cell, HERE, rec).items()}
    assert vals == pytest.approx({
        "post.read_s_per_kread": 0.375, "post.demux_s_per_kread": 1.5,
        "post.adapter_ms_per_kread": 150.0,
        "post.adapter_padded_per_real": 1.5,
        "kernel.adapters_roofline_pct": 25.0})
    # the parent's run: the harness's span alone
    parent = record({}, {}, by_name={kernel: 1.0},
                    spans=[("adapter", 0.0, 0.2)])
    vals = run.per_layer_values(cell, HERE, parent)
    assert list(vals) == ["post.adapter_ms_per_kread"]


def test_adapter_count_by_hand():
    rec = record({}, {"adapter_cells_real": 1000, "adapter_read_columns": 7})
    c = rec.counts["adapter_hits_kernel"]
    assert roofline.bound_s(c, rec.units, rec.peaks) == \
        pytest.approx(8000 / (132 * 128 * 1.98e9))
    assert rec.units("adapter_read_columns") == 7


def test_controls_module_names_both():
    assert set(control_post.CONTROLS) == {"precision", "swap"}
    ctx = types.SimpleNamespace()
    control_post.SwapControl(None, ctx)
    assert ctx.swap_index_names == (0, 1)
