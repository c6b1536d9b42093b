"""Per-op issue cost of dependent int32 operations on one SM of the card.
(Counterpart of ``tools/mosaic_floor_probe.py``, which measured the same
on one TPU core; the kernel is ``kernels/csrc/floor_probe.cu``.)

    python -m c3poa_tpu_torch.tools.floor_probe [M=64] [NITER=4096] \
        [--device cuda|cpu]

A loop of NITER iterations whose body is M unrolled int32 operations
(pairs ``x = x + c; x = max(x, c - x)``) on an (S, 128) int32 array,
swept over S (S/8 "tiles": on the card, elements a thread of the one
1024-thread block holds) and the dependency: ``chain`` = one chain, each
operation consumes the previous one's result; ``indep2`` / ``indep4`` = 2
/ 4 interleaved independent chains with the same operation count.  If
the hardware overlapped dependent-op latency, indep would be faster per
op; equal times mean the operations are issue-bound.

Columns, as the original's: S, tiles, mode, ms (best of 5 launches after
a warm-up; CUDA events on the card, the host clock on the CPU), ns/op
and ns/op/tile with ops = M * NITER (the original's count, ``:93``, so
the two tables compare).  On the card also ``sass/it``: SASS
instructions in the body of the compiled NITER loop per element, loop
control included, and ``ns/insn/tile``: ms per SASS instruction so
counted and per tile.  The body as written is 1.5 * M operations (add,
sub, max per pair); fewer instructions mean the compiler folded part of
the chain, and ns/op then measures the folded chain.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import _build
from ..kernels.probes import (FLOOR_CHAINS, FLOOR_LANES, floor_pass_elems,
                              floor_probe)

SIZES = (8, 32, 64, 128, 256)
MODES = ("chain", "indep2", "indep4")
REPS = 5


def loop_body_insns(funcs: dict, nch: int, M: int, E: int) -> int:
    """Instructions (branches apart) in the body of the NITER loop of the
    kernel instance (nch, M, E): of the loops that hold no other loop and
    no load or store, the one with the most max instructions."""
    key = f"floor_probe_kernelILi{nch}ELi{M}ELi{E}EE"
    body = next(v for k, v in funcs.items() if key in k)
    loops = []
    for addr, insn in body:
        if _build.sass_mnemonic(insn).startswith("BRA") and "0x" in insn:
            target = int(insn.split("0x")[-1].split()[0], 16)
            if 0 <= target < addr:
                loops.append((target, addr))
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= a < b < hi or lo < a < b <= hi
                        for a, b in loops)]
    ops = [[_build.sass_mnemonic(i) for a, i in body if lo <= a < hi]
           for lo, hi in inner]
    ops = [o for o in ops if not any(op.startswith(("LD", "ST")) for op in o)]
    if not ops:
        raise RuntimeError(f"no loop without memory access in {key}")
    best = max(ops, key=lambda o: sum("MNMX" in op for op in o))
    return sum(1 for op in best if not op.startswith("BRA"))


def time_ms(fn, make, dev) -> float:
    """Best of ``REPS`` timed calls of ``fn`` on fresh inputs, after a
    warm-up call."""
    fn(make())
    best = float("inf")
    for _ in range(REPS):
        x = make()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            fn(x)
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="int32 issue-cost probe.")
    p.add_argument("M", type=int, nargs="?", default=64)
    p.add_argument("NITER", type=int, nargs="?", default=4096)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernel, default) or cpu (its plain "
                        "torch version)")
    args = p.parse_args(argv)
    M, niter = args.M, args.NITER
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain torch version)")
    print(f"device: {name}; M = {M}, NITER = {niter}; the body as "
          f"written: {1.5 * M:g} operations", flush=True)
    funcs = _build.sass("floor_probe") if dev.type == "cuda" else None
    rng = np.random.default_rng(0)
    print(f"{'S':>4} {'tiles':>5} {'mode':>7} {'ms':>8} {'ns/op':>7} "
          f"{'ns/op/tile':>10}" +
          (f" {'sass/it':>8} {'ns/insn/tile':>12}" if funcs else ""))
    for S in SIZES:
        for mode in MODES:
            def make():
                x = rng.integers(1, 7, size=(S, FLOOR_LANES))
                return torch.from_numpy(x.astype(np.int32)).to(dev)

            best = time_ms(lambda x: floor_probe(x, M, niter, mode), make,
                           dev)
            ops = M * niter
            tiles = S // 8
            line = (f"{S:>4} {tiles:>5} {mode:>7} {best:>8.2f} "
                    f"{best / ops * 1e6:>7.2f} "
                    f"{best / ops / tiles * 1e6:>10.3f}")
            if funcs:
                E = floor_pass_elems(S, mode)
                n = loop_body_insns(funcs, FLOOR_CHAINS[mode], M, E)
                per_it = n / E
                line += (f" {per_it:>8.2f} "
                         f"{best / (niter * per_it * tiles) * 1e6:>12.4f}")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
