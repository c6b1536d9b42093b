"""The adapter-hits kernel at the postprocess shape, on the card.

    python -m c3poa_tpu_torch.tools.adapters_time

On 1000 consensus-like reads (cDNA of 500-2000 bases between the default
adapters, 1% errors, both directions; seed 3) against the four default
combos (25, 25, 56 and 56 rows), it times the checkout's kernel
(``csrc/adapters.cu``, through its C interface) with CUDA events after a
warm-up, on each input of ``shapes``:

- ``batch``: the whole batch (B = 1000, L = 2304), every read on the
  packed path;
- ``general``: the same with the adapters padded to 64 rows, which sends
  every read to the general path (the outputs do not change);
- ``long_read``: the batch and one read of over 4095 bases, which alone
  takes the general path;
- ``cut``: every read cut to a multiple of 1024 columns (what the columns
  past a read's last 1024-column tile cost a tiled design);
- ``first_N``: the batch's first N reads (small groups);
- ``alone``: the batch's longest read alone (B = 1), with its time a step
  of the warp's wavefront (its length + 31 steps) in ns and in clocks at
  1.98 GHz.

``measure`` times several kernels on the same inputs, each held to the
plain version on every input first, in the given order and then in
reverse; ``chip_smoke.py --parent-adapters`` puts an earlier revision of
the kernel beside this one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import sim
from ..constants import ADAPTER_OVERLAP_TOL
from ..device import resolve_device
from ..kernels import _build
from ..kernels.adapters import PASS_ROWS, adapter_hits_batch
from ..pipeline.backend import NumpyBackend
from ..state import to_device
from ..utils import encode, revcomp_encoded

SEED = 3
N_READS = 1000
SM_HZ = 1.98e9
SMALL_BATCHES = (16, 64, 128, 256, 512)
NAMES = ("s1", "j1", "qe1", "ts1", "qs1", "s2")


def consensus_like_reads(rng, n: int, indexes=None):
    """``n`` postprocess inputs: cDNA of 500-2000 bases between the
    default adapters, 1% errors, directions alternating; the i-th read
    carries index i % 4 when ``indexes`` are given."""
    out = []
    for i in range(n):
        idx = indexes[f"Index{i % 4 + 1}"] if indexes else None
        name, seq, _ = sim.make_consensus_like(
            rng, f"cl_{i}", cdna_len=int(rng.integers(500, 2001)),
            index=idx, direction="+-"[i % 2], error=0.01)
        out.append((name, seq))
    return out


def adapter_combos():
    """The postprocess combos: each default adapter forward, then
    reverse complemented (pipeline/postprocess.py's order)."""
    combos = []
    for seq in sim.DEFAULT_ADAPTERS.values():
        combos += [encode(seq), revcomp_encoded(encode(seq))]
    return combos


def pack(reads, combos, dev, rows: int = 0):
    """(reads (B, L) int8, lens (B,) int32, adapters (C, m) int8, adapter
    lens (C,) int32) on ``dev``, L the longest read rounded up to 64 (as
    ``TorchBackend.adapter_hits`` batches a postprocess group), m the
    longest combo or ``rows``."""
    L = -(-max(len(r) for r in reads) // 64) * 64
    R = np.full((len(reads), L), 4, dtype=np.int8)
    for b, r in enumerate(reads):
        R[b, :len(r)] = r
    lens = np.array([len(r) for r in reads], dtype=np.int32)
    A = np.full((len(combos), max(rows, *(len(c) for c in combos))), 4,
                dtype=np.int8)
    for c, codes in enumerate(combos):
        A[c, :len(codes)] = codes
    alens = np.array([len(c) for c in combos], dtype=np.int32)
    return [to_device(x, dev) for x in (R, lens, A, alens)]


def postprocess_reads(n: int = N_READS, seed: int = SEED):
    return [encode(s) for _, s in consensus_like_reads(
        np.random.default_rng(seed), n)]


def postprocess_batch(dev, n: int = N_READS, seed: int = SEED):
    """The main path's batch (``pack``) of ``n`` consensus-like reads."""
    return pack(postprocess_reads(n, seed), adapter_combos(), dev)


def shapes(dev) -> dict:
    """{name: the kernel's arguments}: the inputs the module's docstring
    lists."""
    reads, combos = postprocess_reads(), adapter_combos()
    _, long_read, _ = sim.make_consensus_like(
        np.random.default_rng(SEED + 1), "long", cdna_len=4100)
    assert len(long_read) > 4095
    out = dict(batch=pack(reads, combos, dev),
               general=pack(reads, combos, dev, PASS_ROWS),
               long_read=pack(reads + [encode(long_read)], combos, dev),
               cut=pack([r[:len(r) // 1024 * 1024] for r in reads], combos,
                        dev))
    for n in SMALL_BATCHES:
        out[f"first_{n}"] = pack(reads[:n], combos, dev)
    out["alone"] = pack([max(reads, key=len)], combos, dev)
    return out


def batch_stats(lens, alens) -> dict:
    """What the batch asks of a kernel: its DP cells (each read's own
    columns, each combo's own rows), the share of a 1024-column tiling's
    cells that lie past a read's end, the cells left with every read cut
    to a multiple of 1024 columns, and the wavefront's warp steps (a
    read's length plus its combo's lanes less one)."""
    lens = lens.cpu().to(torch.int64)
    alens = alens.cpu().to(torch.int64)
    rows = int(alens.sum())
    tiled = int((-(-lens // 1024) * 1024).sum())
    lanes = torch.where(alens <= 32, alens, -(-alens // 2))
    return dict(cells=int(lens.sum()) * rows,
                tile_cells_past_end=(tiled - int(lens.sum())) / tiled,
                cut_cells=int((lens // 1024 * 1024).sum()) * rows,
                warp_steps=int((lens[:, None] + lanes[None, :] - 1).sum()))


def sweep_loops(insns) -> list:
    """(instructions, PRMT, SHFL, local loads and stores) of each loop of
    a SASS listing [(address, instruction)] that holds a byte permute: the
    wavefront's step loops, one PRMT a row a step (a loop the compiler
    unrolled holds several steps); the packed path's loops shuffle two
    words a step, the general path's four."""
    # loops' back edges: predicated plain branches to an earlier address
    edges = [(int(insn.split()[-1], 16), addr) for addr, insn in insns
             if insn.startswith("@") and _build.sass_mnemonic(insn) == "BRA"
             and int(insn.split()[-1], 16) < addr]
    out = []
    for lo, hi in edges:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in edges):
            continue                         # not innermost
        ops = [_build.sass_mnemonic(i).split(".")[0] for a, i in insns
               if lo <= a <= hi]
        if "PRMT" in ops:
            out.append((len(ops), ops.count("PRMT"), ops.count("SHFL"),
                        ops.count("LDL") + ops.count("STL")))
    return out


def launcher(lib):
    """A function (reads, lens, adapters, alens) -> (6, B, C) int32
    launching ``lib``'s kernel through its C interface."""
    scoring = NumpyBackend.ADAPTER_SCORING

    def run(R, lens, A, alens):
        B, L = R.shape
        C, m = A.shape
        out = torch.empty((6, B, C), dtype=torch.int32, device=R.device)
        scratch = torch.empty((B, C, L), dtype=torch.int32, device=R.device)
        carry = torch.empty((B, C, L, 4) if m > PASS_ROWS else (0,),
                            dtype=torch.int32, device=R.device)
        _build.launch(lib, "c3t_adapter_hits", "adapters_time", R,
                      R.data_ptr(), lens.data_ptr(), A.data_ptr(),
                      alens.data_ptr(), scratch.data_ptr(),
                      carry.data_ptr() if carry.numel() else None,
                      out.data_ptr(), B, L, C, m, *scoring,
                      ADAPTER_OVERLAP_TOL)
        return out
    return run


def ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after a warm-up
    (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def measure(kernels: dict, inputs: dict) -> dict:
    """{label: {input: [ms, ms], ..., "alone_ns_a_step": ns,
    "alone_clocks_a_step": clocks}} for the kernels {label: fn(R, lens,
    A, alens)} on the inputs {name: args} (``shapes``), each kernel first
    held to the plain version on every input; timed in the given order,
    then in reverse."""
    for name, args in inputs.items():
        want = torch.stack(adapter_hits_batch(
            *args, *NumpyBackend.ADAPTER_SCORING))
        for label, fn in kernels.items():
            got = fn(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = [n for k, n in enumerate(NAMES)
                       if not torch.equal(got[k], want[k])]
                raise RuntimeError(f"{label}, {name}: {bad} differ from the "
                                   f"plain version")
    res = {k: {n: [] for n in inputs} for k in kernels}
    for order in (list(kernels), list(kernels)[::-1]):
        for label in order:
            fn = kernels[label]
            for name, args in inputs.items():
                res[label][name].append(ms(lambda: fn(*args)))
    steps = int(inputs["alone"][1][0]) + 31
    for r in res.values():
        best = min(r["alone"])
        r["alone_ns_a_step"] = best * 1e6 / steps
        r["alone_clocks_a_step"] = best * 1e-3 * SM_HZ / steps
    return res


def main(argv=None) -> int:
    import argparse
    argparse.ArgumentParser(prog="adapters_time",
                            description=__doc__).parse_args(argv)
    res = measure({"checkout": launcher(_build.load("adapters"))},
                  shapes(resolve_device("cuda")))
    print([x.strip() for x in _build.build_logs.get("adapters", "")
           .splitlines() if "registers" in x or "spill" in x])
    print(json.dumps(res["checkout"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
