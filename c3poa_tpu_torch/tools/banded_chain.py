"""One pair alone through the banded kernels: their chain floors.

    python -m c3poa_tpu_torch.tools.banded_chain [P=2048] [nq=2048] [W=128]

On nanopore-like pairs (a draft of 0.73-0.98 nq bases and a copy with 5%
substitutions, 3% insertions, 3% deletions; seed 1) it times, with CUDA
events after a warm-up:

- the forward kernel and the walk on the whole batch;
- the forward of one pair alone (P = 1, the batch's longest query): the
  time of one row's dependent chain, which a lone warp cannot hide;
- the walk of one pair alone (P = 1, the batch's longest path): the chain
  floor, the least a design with one dependent chain a pair can take, and
  its clocks a step.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from .. import sim
from ..device import resolve_device
from ..kernels import banded as kb
from ..utils import encode

REPS = 10
ROUNDS = 3


def make_pairs(P: int, nq: int, rng):
    Q = np.full((P, nq), 4, dtype=np.int8)
    T = np.full((P, nq), 4, dtype=np.int8)
    ql = np.zeros(P, dtype=np.int32)
    tl = np.zeros(P, dtype=np.int32)
    for p in range(P):
        draft = sim.random_seq(rng, int(rng.integers(int(0.73 * nq),
                                                     int(0.98 * nq))))
        t = encode(draft)
        q = encode(sim.mutate(rng, draft, 0.05, 0.03, 0.03))[:nq]
        Q[p, :len(q)] = q
        T[p, :len(t)] = t
        ql[p], tl[p] = len(q), len(t)
    return Q, T, ql, tl


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def best_ms(fn) -> float:
    """Best of ROUNDS means over REPS calls of ``fn``, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / REPS)
    return best


def report_one(what: str, p: int, n: int, unit: str, ms: float) -> None:
    clk = float(nvidia_smi("clocks.sm").split()[0])
    print(f"{what} of one pair (P = 1, pair {p}, {n} {unit}s): {ms:.4f} ms "
          f"= {ms * 1e6 / n:.1f} ns a {unit} ({ms * 1e3 * clk / n:.0f} "
          f"clocks at the {clk:.0f} MHz nvidia-smi read after the runs)",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Time the banded kernels on a "
                                             "batch and on one pair alone.")
    ap.add_argument("P", type=int, nargs="?", default=2048)
    ap.add_argument("nq", type=int, nargs="?", default=2048)
    ap.add_argument("W", type=int, nargs="?", default=128)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(f"card: {nvidia_smi('name,power.limit')}; P = {args.P}, nq = "
          f"{args.nq}, W = {args.W}", flush=True)
    Q, T, ql, tl = make_pairs(args.P, args.nq, np.random.default_rng(1))
    Qd, Td, qld, tld = (torch.from_numpy(a).to(dev) for a in (Q, T, ql, tl))
    W = args.W

    ms = best_ms(lambda: kb.banded_fwd_cuda(Qd, Td, qld, tld, band=W))
    print(f"forward: {ms:.4f} ms", flush=True)
    # one pair alone: the longest query of the batch, one warp on the card
    p = int(ql.argmax())
    one = [x[p:p + 1].contiguous() for x in (Qd, Td, qld, tld)]
    report_one("forward", p, int(ql[p]), "row",
               best_ms(lambda: kb.banded_fwd_cuda(*one, band=W)))

    _, je, mv = kb.banded_fwd_cuda(Qd, Td, qld, tld, band=W)
    ms = best_ms(lambda: kb.banded_walk_cuda(mv, qld, tld, je, args.nq, W))
    print(f"walk: {ms:.4f} ms", flush=True)
    # one pair alone: the longest path of the batch
    ops = kb.banded_walk_cuda(mv, qld, tld, je, args.nq, W)[2].to(torch.int32)
    steps = sum(((ops >> (2 * k)) & 3 != 0).sum(dim=1) for k in range(4))
    p = int(steps.argmax())
    one = [x[p:p + 1].contiguous() for x in (mv, qld, tld, je)]
    report_one("walk", p, int(steps[p]), "step",
               best_ms(lambda: kb.banded_walk_cuda(*one, args.nq, W)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
