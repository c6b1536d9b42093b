#!/usr/bin/env python3
"""The benchmark of ``c3poa_tpu_torch`` on one H100: one cell a run.

    python3 h100_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Everything a cell uses is found by name: the cell in ``BENCHMARK.json``
names its configuration (``h100_bench/configs/<config>.json``) and its
traffic mix (``h100_bench/traffic/<traffic>.json``), the mix names the
entry the window drives (``h100_bench/entries/<entry>.py``), each
per-layer metric of ``BENCHMARK.json`` is read by
``h100_bench/metrics/<metric>.py``, and the limits of the comparison
that decides ``correct`` are ``h100_bench/limits/<cell>.json``.

A run makes the pool from ``--seed`` (``gen.py``), warms up on a small
group of it, measures for ``--seconds`` (``--trace 1``: under
``torch.profiler``, CUDA activity only), frees the program's state, holds
what the window produced to the plain reference (``reference/``), and
prints the numbers compared on standard error and one JSON line on
standard output.  It fails, printing no result, without a CUDA card (or
with fewer than the cell asks for), when a traced run recorded no device
activity, and when ``jax``, ``jaxlib``, ``flax`` or ``c3poa_tpu`` is
among the process's top-level modules once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import resource
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "c3poa_tpu")


class BenchError(Exception):
    """A run that cannot report: printed, exit code 1, no result."""


def process_start_age() -> float:
    """Seconds since this process started (from /proc), else 0."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - process_start_age()


def load_json(*parts) -> dict:
    path = os.path.join(*parts)
    if not os.path.exists(path):
        raise BenchError(f"{os.path.relpath(path, ROOT)} not found")
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    if not os.path.exists(path):
        raise BenchError(f"{os.path.relpath(path, ROOT)} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Top-level module names (before the first dot, compared whole)
    among FORBIDDEN: ``c3poa_tpu_torch`` is not ``c3poa_tpu``."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """A cell of ``BENCHMARK.json`` with everything it names loaded."""

    def __init__(self, bench: dict, name: str, here: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json "
                             f"({', '.join(cells)})")
        self.name = name
        self.spec = cells[name]
        self.chips = int(self.spec["chips"])
        self.config = load_json(here, "configs", self.spec["config"] + ".json")
        self.mix = load_json(here, "traffic", self.spec["traffic"] + ".json")
        self.limits = load_json(here, "limits", name + ".json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in e2e]


class Ctx:
    """What an entry sees: the cell's files, the seed, its pool and its
    working directory (inside the checkout)."""

    def __init__(self, cell: Cell, seed: int, work: str, pool):
        self.cell = cell
        self.config = cell.config
        self.mix = cell.mix
        self.seed = seed
        self.work = work
        self.pool = pool


def require_cards(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is False: the benchmark "
                         "runs only on a CUDA card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} card(s), "
                         f"{torch.cuda.device_count()} visible")


def card_peaks() -> dict:
    """The card's name, SM count, its maximum SM clock and power limit
    (``nvidia-smi``), for the rooflines."""
    import subprocess

    import torch
    props = torch.cuda.get_device_properties(0)
    out = dict(kind=torch.cuda.get_device_name(0),
               sms=props.multi_processor_count, sm_hz=None,
               power_limit_w=None)
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        clk, pw = q.stdout.strip().splitlines()[0].split(",")
        out["sm_hz"] = float(clk) * 1e6
        out["power_limit_w"] = float(pw)
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return out


def traced_device(rec: dict) -> dict:
    """``busy_s`` and ``window_s`` of a reduced trace; a trace with no
    device activity fails the run rather than reading as idle."""
    if rec["busy_s"] <= 0:
        raise BenchError("the traced window recorded no device activity: "
                         "the profiler saw nothing, so no idle share can "
                         "be read")
    return dict(busy_s=rec["busy_s"], window_s=rec["window_s"])


def per_layer_values(cell: Cell, here: str, run) -> dict:
    """Each per-layer metric of the cell, read by
    ``metrics/<name>.py``; a reader that finds nothing returns None and
    the metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(os.path.join(here, "metrics", m["name"] + ".py"),
                             "h100_bench.metrics." + m["name"])
        v = reader.read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(args, root: str = ROOT, device: str = "cuda",
             fault=None) -> dict:
    """One run; returns the result line's object and the check's numbers.
    ``root`` is the checkout (its ``BENCHMARK.json`` and
    ``h100_bench/``); ``device`` "cpu" serves the harness's CPU tests;
    ``fault(backend, ctx)`` puts a wrapper around the program's backend:
    the tests' faults and the controls (``control.py``)."""
    here = os.path.join(root, "h100_bench")
    bench = load_json(root, "BENCHMARK.json")
    cell = Cell(bench, args.workload, here)
    if device == "cuda":
        require_cards(cell.chips)
    # every build and kernel cache inside the checkout, at fixed paths
    # (the port's own nvcc and gcc builds go to build/c3poa_tpu_torch/)
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from h100_bench import gen, roofline

    work = os.path.join(build, "h100_bench", cell.name)
    if os.path.exists(work):
        shutil.rmtree(work)
    os.makedirs(work)
    pool = gen.make_pool(cell.config, cell.mix, args.seed)
    ctx = Ctx(cell, args.seed, work, pool)
    entry = importlib.import_module(
        "h100_bench.entries." + cell.mix["entry"]).Entry(ctx)

    import torch
    from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
    backend = TorchBackend(device)
    if fault is not None:
        backend = fault(backend, ctx)
    entry.setup(backend)
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    trace = None
    if on_card:
        sync()
        torch.cuda.reset_peak_memory_stats()
    if args.trace:
        trace = roofline.Trace(torch)
        trace.start()
    t_window = time.perf_counter()
    setup_s = t_window - T_START
    win = entry.window(args.seconds, sync)
    if trace is not None:
        trace.stop()
    window_s = win["t1"] - win["t0"]
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    bad = forbidden_modules()
    if bad:
        raise BenchError(f"modules loaded in the run's process: {bad}")
    device_info = dict(platform="gpu" if on_card else "cpu",
                       kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                       count=cell.chips, memory_peak_bytes=int(memory_peak))
    peaks = card_peaks() if (on_card and args.trace) else None

    metrics: dict = {}
    breakdown = None
    if not args.trace:
        # the harness's own two, and the entry's by name
        values = dict(win["values"], setup_s=setup_s, peak_rss_gib=rss_gib)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise BenchError(f"the {cell.mix['entry']} entry gives no "
                                 f"{m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        rec = trace.reduce(win["t0"], win["t1"], entry.recorder.spans)
        device_info.update(traced_device(rec))
        breakdown = rec["breakdown"]
        run = roofline.RunRecord(win, entry.recorder.spans, rec, peaks,
                                 cell.config, here)
        metrics = per_layer_values(cell, here, run)

    # the program's state goes before the reference runs
    entry.close()
    del backend
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from h100_bench.reference.check import default_procs
    t_check = time.perf_counter()
    nums = entry.check(default_procs())
    check_s = time.perf_counter() - t_check
    parts = nums.pop("parts", {})
    check = {}
    for k, v in nums.items():
        if k not in cell.limits:
            raise BenchError(f"no limit for {k} in limits/{cell.name}.json")
        check[k] = {"value": v, "limit": cell.limits[k]}
    correct = all(c["value"] <= c["limit"] for c in check.values())
    bad = forbidden_modules()
    if bad:
        raise BenchError(f"modules loaded in the run's process: {bad}")
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check
    info = dict(calls=win["calls"], reads=win["reads"], window_s=window_s,
                setup_s=setup_s, check_s=check_s, **parts,
                stages={k: round(v, 3) for k, v in win["stages"].items()},
                counters=win["counters"])
    if peaks is not None:
        info["card"] = peaks
    return dict(result=result, info=info)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args)
    except BenchError as e:
        print(f"h100_bench: {e}", file=sys.stderr)
        return 1
    print("h100_bench: " + json.dumps(out["info"]), file=sys.stderr)
    for k, c in out["result"]["check"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
