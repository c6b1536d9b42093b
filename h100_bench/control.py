#!/usr/bin/env python3
"""The controls of a consensus cell: wrappers put in place of the
program's backend, each run through the harness's own run
(``run.run_cell``) and its own comparison (``reference/check.py``), so
that ``correct`` comes out of the check itself.  Each has to come out as
not correct; the benchmark's runs never run them.

    python3 h100_bench/control.py --workload <cell> --control <name> \
        --seconds <s> --seed <n> [--seed ...]

- ``precision``: the plain reference put in the locate step's place one
  precision below what the configuration states: the smoothing in
  float32 instead of float64, without the float64 reruns that back the
  card's float32 kernels.  It fails ``device_diff`` (a read's peaks) and
  ``records_diff`` (the subreads those peaks cut).  The align step
  states float32 for the band's placement; one precision below
  (bfloat16) is counted apart, over every core pair of the pool, as
  ``band_bf16_moved``: the alignments whose score or end column it moves.
- ``draft``: the host consensus states no precision, so its control
  breaks the guarantee it states (a consensus of all of a read's full
  subreads): every subread's alignment is replaced by the draft's own,
  so the vote returns the draft, one subread.  It fails
  ``cons_err_pct`` (and ``device_diff``: every alignment differs).

Prints one JSON line per seed.  Runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class PrecisionControl:
    """Locate answers from the reference in float32; the program's
    align."""

    supports_overlap = True

    def __init__(self, inner, ctx):
        from h100_bench.reference import locate as ref_locate
        self.inner = inner
        self.combos = ref_locate.combos_of(ctx.pool.splints)

    def locate_many(self, reads, combos, min_dist):
        from c3poa_tpu_torch.pipeline.backend import LocateResult
        from h100_bench.reference import check as C
        tasks = sorted(((r, np.asarray(codes), self.combos, min_dist,
                         np.float32) for r, codes in enumerate(reads)),
                       key=lambda t: -len(t[1]))
        got = dict(C.run_tasks(C._locate_task, tasks, C.default_procs()))
        return [LocateResult(*got[r]) for r in range(len(reads))]

    def align_many(self, pairs, params, phase_base=0):
        return self.inner.align_many(pairs, params, phase_base)


class DraftControl:
    """The program's locate; in place of every subread's alignment the
    draft's own (the align step returning its input, the draft,
    unchanged).  Each looks whole, so the divergence test routes no read
    to the POA graph, and the vote returns the draft."""

    supports_overlap = True

    def __init__(self, inner, ctx=None):
        self.inner = inner

    def locate_many(self, reads, combos, min_dist):
        return self.inner.locate_many(reads, combos, min_dist)

    def align_many(self, pairs, params, phase_base=0):
        from c3poa_tpu_torch.consensus.vote import record_for_draft
        return [record_for_draft(np.asarray(t), np.full(len(t), 20, np.int8))
                for _q, _qual, t, *_ in pairs]


CONTROLS = {"precision": PrecisionControl, "draft": DraftControl}


def band_bf16_moved(cell, seed: int, procs: int) -> dict:
    """Core pairs of the pool (the reference's cut) whose score or end
    column moves with the band placed in bfloat16."""
    from h100_bench import gen
    from h100_bench.reference import check as C
    from h100_bench.reference import locate as ref_locate
    pool = gen.make_pool(cell.config, cell.mix, seed)
    cli, params = cell.config["cli"], cell.config["align"]
    combos = ref_locate.combos_of(pool.splints)
    loc = C.reference_locate(pool, combos, cli["mdistcutoff"], procs=procs)
    exp = C.expected_records(pool, loc, combos, cli, range(len(pool.seqs)))
    f32 = C.reference_ends(pool, exp, params, procs=procs)
    bf16 = C.reference_ends(pool, exp, params, "bfloat16", procs=procs)
    return dict(band_bf16_moved=sum(f32[k] != bf16[k] for k in f32),
                core_pairs=len(f32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", required=True, choices=sorted(CONTROLS))
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from h100_bench import run
    from h100_bench.reference.check import default_procs
    for seed in args.seed:
        one = argparse.Namespace(workload=args.workload, seed=seed,
                                 seconds=args.seconds, trace=0)
        try:
            out = run.run_cell(one, fault=CONTROLS[args.control])
        except run.BenchError as e:
            print(f"h100_bench control: {e}", file=sys.stderr)
            return 1
        line = dict(seed=seed, control=args.control,
                    correct=out["result"]["correct"],
                    check=out["result"]["check"],
                    calls=out["info"]["calls"], reads=out["info"]["reads"],
                    parts={k: out["info"][k] for k in
                           ("locate_answers", "locate_diff", "ends",
                            "ends_diff", "pairs", "align_diff",
                            "record_reads", "cons_reads", "check_s")})
        if args.control == "precision":
            cell = run.Cell(run.load_json(ROOT, "BENCHMARK.json"),
                            args.workload, HERE)
            line.update(band_bf16_moved(cell, seed, default_procs()))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
