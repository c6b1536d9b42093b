"""``BENCHMARK.json`` against the format the benchmark's check reads,
and every file it names present under ``h100_bench/``."""

import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "h100_bench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["h100_bench"]
    assert all(line(w) for w in b["command"]) and len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_configs_and_cells():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert line(c["source"]) and line(c["why"]) and c["name"] in used
        assert c["file"].startswith("h100_bench/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["name"] == c["name"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for d, f in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(HERE, d, f + ".json"))


def test_metrics():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert "setup_s" in e2e
    layers = set()
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and line(m["layer"])
        assert set(m["workloads"]) <= e2e[m["moves"]]
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
        layers.add(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        got = [m for m in b["end_to_end"] if w in m.get("workloads", cells)]
        assert len(got) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])


def test_counts_name_their_kernels():
    for f in os.listdir(os.path.join(HERE, "counts")):
        with open(os.path.join(HERE, "counts", f)) as fh:
            c = json.load(fh)
        assert f == c["kernel"] + ".json"
        assert c["ops"]["per_unit"] > 0 and c["bytes"]["per_unit"] > 0
