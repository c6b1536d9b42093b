"""The float32 smoothing's error against the float64 spec, and the peak
guard's margin flags, on bench-shaped reads.

    python -m c3poa_tpu_torch.tools.smooth_error [--reads 24]
        [--splint-len 200] [--seed 0] [--device cuda|cpu]

Reads as ``bench.py`` makes them (inserts of 500-2000 bases, 5-15
copies, 5% errors) around one random splint of ``--splint-len`` bases.
For each read, the chosen combo's exact profile row (the profile kernel
on the card, its plain version on the CPU) is smoothed by
``kernels.smooth.smooth3_batch`` and by ``ref.sg.smooth3`` in float64.
Prints one JSON line: the largest absolute and adjacent-difference
errors, the largest adjacent-difference error over the read's smoothed
maximum (what ``kernels.peaks.STRUCT_REL`` must cover), and the reads
the margin guard flags with the structure margin as it is and with its
absolute floor ``STRUCT_ATOL`` alone.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import sim
from ..device import resolve_device
from ..kernels import peaks
from ..kernels.smooth import smooth3_batch
from ..kernels.sw_profile import start_profile
from ..pipeline.backend import Combo
from ..ref import sg
from ..state import splint_array, to_device
from ..utils import encode, revcomp_encoded

BATCH = 128


def bench_reads(n_reads: int, splint_len: int, seed: int):
    """Encoded bench-shaped reads and the splint's two combos."""
    rng = np.random.default_rng(seed + 100)
    splints = {"Splint1": sim.random_seq(rng, splint_len)}
    reads, splints = sim.make_dataset(
        n_reads=n_reads, seed=seed, splints=splints, insert_len=(500, 2000),
        copies=(5, 15), error=0.05)
    codes = encode(splints["Splint1"])
    combos = [Combo("Splint1", "+", codes, len(codes)),
              Combo("Splint1", "-", revcomp_encoded(codes), len(codes))]
    return [encode(r.seq) for r in reads], combos


def chosen_rows(R, lens, S):
    """(B, L) int32: the profile row of each read's best combo (the
    lowest index on ties), as ``kernels.locate.locate_device`` picks it."""
    prof = start_profile(R, S, lens)
    best = prof.max(dim=2).values
    combo = (best == best.max(dim=1, keepdim=True).values).to(
        torch.int32).argmax(dim=1)
    B, _, L = prof.shape
    return torch.gather(prof, 1, combo.view(B, 1, 1).expand(B, 1, L))[:, 0]


def margin_flags(sm, lens, struct_rel: float) -> torch.Tensor:
    """The margin flags of ``peak_candidates_batch`` with ``STRUCT_REL``
    set to ``struct_rel`` for the call."""
    saved = peaks.STRUCT_REL
    peaks.STRUCT_REL = struct_rel
    try:
        return peaks.peak_candidates_batch(sm, lens)[6]
    finally:
        peaks.STRUCT_REL = saved


def measure(n_reads: int, splint_len: int, seed: int, dev) -> dict:
    enc, combos = bench_reads(n_reads, splint_len, seed)
    return measure_reads(enc, combos, dev)


def measure_reads(enc, combos, dev) -> dict:
    """The errors and flags of ``measure`` on the encoded reads ``enc``
    and their splint ``combos``."""
    S = to_device(splint_array(combos), dev)
    order = sorted(range(len(enc)), key=lambda i: -len(enc[i]))
    splint_len = max(len(c.codes) for c in combos)
    res = dict(reads=len(enc), splint_len=splint_len, max_abs=0.0,
               max_adj=0.0, max_adj_over_height=0.0, height_min=None,
               height_max=None, flagged=0, flagged_floor_only=0)
    heights = []
    for start in range(0, len(order), BATCH):
        chunk = [enc[i] for i in order[start:start + BATCH]]
        L = -(-len(chunk[0]) // 64) * 64
        R = np.full((len(chunk), L), 4, dtype=np.int8)
        lens = np.array([len(c) for c in chunk], dtype=np.int32)
        for b, c in enumerate(chunk):
            R[b, :len(c)] = c
        Rd, ld = to_device(R, dev), to_device(lens, dev)
        rows = chosen_rows(Rd, ld, S)
        sm = smooth3_batch(rows.to(torch.float32), ld)
        res["flagged"] += int(margin_flags(sm, ld, peaks.STRUCT_REL).sum())
        res["flagged_floor_only"] += int(margin_flags(sm, ld, 0.0).sum())
        rows_np, sm_np = rows.cpu().numpy(), sm.cpu().numpy()
        for b in range(len(chunk)):
            n = int(lens[b])
            d = sm_np[b, :n].astype(np.float64) - sg.smooth3(
                rows_np[b, :n].astype(np.float64))
            adj = float(np.abs(np.diff(d)).max())
            h = float(sm_np[b, :n].max())
            heights.append(h)
            res["max_abs"] = max(res["max_abs"], float(np.abs(d).max()))
            res["max_adj"] = max(res["max_adj"], adj)
            res["max_adj_over_height"] = max(res["max_adj_over_height"],
                                             adj / max(h, 1.0))
    res["height_min"], res["height_max"] = min(heights), max(heights)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="smooth_error", description=__doc__)
    ap.add_argument("--reads", type=int, default=24)
    ap.add_argument("--splint-len", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    res = measure(a.reads, a.splint_len, a.seed, dev)
    res["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    res["STRUCT_ATOL"], res["STRUCT_REL"] = peaks.STRUCT_ATOL, peaks.STRUCT_REL
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
