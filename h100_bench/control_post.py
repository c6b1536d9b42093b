#!/usr/bin/env python3
"""The controls of a postprocess cell: wrappers put in place of the
program's backend (or of its inputs), each run through the harness's own
run (``run.run_cell``) and its own comparison (``entries/postprocess.py:
Entry.check``), so that ``correct`` comes out of the check itself.  Each
has to come out as not correct; the benchmark's runs never run them.

    python3 h100_bench/control_post.py --workload <cell> \
        --control <name> --seconds <s> --seed <n> [--seed ...]

- ``precision``: the plain reference (``reference/post.py``) put in the
  adapter step's place one precision below what the configuration
  states: its dynamic programme in int8 instead of int16 (the reference's
  int32 gives the int16 answers at this cell's read lengths).  Read
  columns wrap, so it fails ``hits_diff`` (and ``records_diff``: the
  program trims at the wrong columns).
- ``swap``: two index names swapped in the index file the program reads
  (the reference reads the same file, so ``records_diff`` stays 0): the
  reads of those two indexes are filed under each other's name, and
  ``wrong_index_pct`` rises far above its limit.

Prints one JSON line per seed.  Runs on the card, or with ``--device
cpu`` on the CPU (the plain torch kernels: slow at the cell's size).
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
    """Adapter hits from the reference in int8; the program's rules."""

    supports_overlap = True

    def __init__(self, inner, ctx=None):
        self.inner = inner

    def adapter_hits(self, reads, combo_codes, combo_lens):
        import torch

        from h100_bench.reference import post as ref_post
        got = ref_post.adapter_hits(reads, combo_codes, torch.int8)
        return [np.asarray(g.numpy(), dtype=np.int64) for g in got]


class SwapControl:
    """The program's backend unchanged; the first two index names
    swapped in the index file it is given."""

    supports_overlap = True

    def __init__(self, inner, ctx):
        self.inner = inner
        ctx.swap_index_names = (0, 1)

    def adapter_hits(self, reads, combo_codes, combo_lens):
        return self.inner.adapter_hits(reads, combo_codes, combo_lens)


CONTROLS = {"precision": PrecisionControl, "swap": SwapControl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", required=True, choices=sorted(CONTROLS))
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from h100_bench import run
    for seed in args.seed:
        one = argparse.Namespace(workload=args.workload, seed=seed,
                                 seconds=args.seconds, trace=0)
        try:
            out = run.run_cell(one, device=args.device,
                               fault=CONTROLS[args.control])
        except run.BenchError as e:
            print(f"h100_bench control: {e}", file=sys.stderr)
            return 1
        info = out["info"]
        print(json.dumps(dict(
            seed=seed, control=args.control,
            correct=out["result"]["correct"], check=out["result"]["check"],
            calls=info["calls"], reads=info["reads"],
            parts={k: info[k] for k in ("hit_reads", "hit_pairs",
                                        "hits_recorded", "written",
                                        "wrong_index", "no_index_found",
                                        "check_s")})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
