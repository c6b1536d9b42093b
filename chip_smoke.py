#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, nvcc and the
repo's Python dependencies (no JAX needed or imported):

1. prints the card and its power limit;
2. builds the port's CUDA kernels from ``c3poa_tpu_torch/kernels/csrc``;
3. requires the port's native host library (built with gcc at first
   use) to load;
4. runs each kernel and its plain torch version on the card, on the same
   inputs at the shapes of the consensus and postprocess runs, requires
   every int32 output to be equal, and times both with CUDA events; the
   banded forward and walk also at the zero-repeat scoring and the fast
   band, with the forward's SASS instructions a row by pipe and the
   walk's time for one pair alone;
5. runs ``python -m c3poa_tpu_torch.cli --backend cuda`` in-process on
   1000 simulated reads of the bench's shape, requires the consensus
   kernels to have launched during that run, and requires its output
   files to equal the numpy backend's byte for byte;
6. holds the two probe kernels (the counterparts of the TPU probes
   ``tools/int16_probe.py`` and ``tools/mosaic_floor_probe.py``) to
   their plain versions, then runs both probes' entry points in-process
   (``c3poa_tpu_torch.tools.int16_probe``, which must exit 0 and prints
   the SASS it compiled to, and ``.floor_probe 64 4096``, which prints
   its table), each of which must launch its kernel;
7. runs ``python -m c3poa_tpu_torch.cli_postprocess --backend cuda``
   in-process on that run's consensus reads plus 1000 consensus-like
   reads with adapters and oligo-dT indexes, requires the adapter kernel
   to have launched during that run, and requires its output tree to
   equal the numpy backend's byte for byte;
8. prints one JSON line with the kernels (times, launches, and the
   least time the card could take for the same work), the
   ``nvidia-smi`` line, and last the ``{"ok": true, "device": ...}`` line.

Exits non-zero, printing no result line, when there is no CUDA device,
when the repo's packages are missing, or when any phase fails.  Work
files go to ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 0
N_READS = 1000
# consensus-like reads of the postprocess phases
N_POST_READS = 1000

# Peaks of one H100 SXM for the bound (the least time for the same
# work): HBM at 3.35 TB/s (NVIDIA's data sheet); int32 issue at 64 INT32
# lanes per SM (H100 white paper) x 132 SMs x 1.98 GHz, the boost clock
# behind the data sheet's 67 TFLOP/s float32 figure.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# one SM issues at most four warp instructions a clock (one per scheduler,
# 128 lanes), over its ALU and FMA pipes together
SM_LANE_OPS_PER_S = 4 * 32 * 1.98e9
# integer operations a DP cell (or walk step) needs, counted from the
# recurrences: profile — substitution 2, diagonal and up 2, 3-way max 2,
# run shift, max and unshift 3, column max 1; banded forward —
# substitution 2, E 3 and its flag 1, D 1, Ht 1, F prefix 3 and its flag
# 3, H 1, move source 3, nibble 2; walk — nibble decode 2, state and
# source 4, i/j 2; adapters — substitution 2, diagonal with its fresh
# payload 3, up 1, diagonal-or-up 3, floor 3, run shift, join and unshift
# 5, column max with row and payload 4; int16 probe — max, roll, select
# and add per column; floor probe — per (add, max) pair the fewest Hopper
# instructions: one DPX VIADDMNMX does the add and the max, one more
# negates (c - (x + c) is -x), on one SM by design
OPS_PER_CELL = {"start_profile_cuda": 10, "banded_fwd_cuda": 20,
                "banded_walk_cuda": 8, "adapter_hits_cuda": 21,
                "int16_probe_cuda": 4, "floor_probe_cuda": 2}

# the TPU kernel each CUDA kernel replaces
KERNELS = {
    "start_profile_cuda": ("c3poa_tpu_torch/kernels/csrc/profile.cu",
                           "c3poa_tpu/kernels/pallas_profile.py:138"),
    "banded_fwd_cuda": ("c3poa_tpu_torch/kernels/csrc/banded.cu",
                        "c3poa_tpu/kernels/pallas_banded.py:469"),
    "banded_walk_cuda": ("c3poa_tpu_torch/kernels/csrc/banded.cu",
                         "c3poa_tpu/kernels/banded.py:288"),
    "adapter_hits_cuda": ("c3poa_tpu_torch/kernels/csrc/adapters.cu",
                          "c3poa_tpu/kernels/adapters.py:35"),
    "int16_probe_cuda": ("c3poa_tpu_torch/kernels/csrc/int16_probe.cu",
                         "tools/int16_probe.py:34"),
    "floor_probe_cuda": ("c3poa_tpu_torch/kernels/csrc/floor_probe.cu",
                         "tools/mosaic_floor_probe.py:29"),
}
# which run launches which kernel
CONSENSUS_KERNELS = ("start_profile_cuda", "banded_fwd_cuda",
                     "banded_walk_cuda")
POST_KERNELS = ("adapter_hits_cuda",)
# the floor probe's check: every mode at these S, M = 64 and a short loop
# (the plain version launches 3 torch ops a pair)
FLOOR_CHECK_S = (8, 256)
FLOOR_CHECK_NITER = 16
OUTPUT_FILES = ("c3poa.log", "Splint1/R2C2_Consensus.fasta",
                "Splint1/R2C2_Subreads.fastq")


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls,
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_time_once(fn):
    """(fn(), its milliseconds on the card): one call, no warm-up; for
    the plain versions that take seconds."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S
          ) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the integer operations over the issue rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / ops_per_s * 1e3
    if b_ms >= o_ms:
        return dict(bound_ms=b_ms, bound_by="bytes")
    return dict(bound_ms=o_ms, bound_by="operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def require_equal(name: str, got, want) -> int:
    """Exact equality of two tensors; returns max |got - want| (0)."""
    import torch
    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    bad = int((diff != 0).sum())
    if bad:
        raise SmokeFailure(f"{name}: {bad} of {diff.numel()} elements "
                           f"differ (max |diff| {int(diff.max())})")
    return 0


def make_dataset():
    from c3poa_tpu_torch import sim
    os.makedirs(WORK, exist_ok=True)
    reads, splints = sim.make_dataset(
        n_reads=N_READS, seed=SEED, insert_len=(500, 2000),
        copies=(5, 15), error=0.05)
    sim.write_fastq(os.path.join(WORK, "reads.fastq"), reads)
    sim.write_fasta(os.path.join(WORK, "splint.fasta"), splints)
    return reads, splints


def phase_profile(dev, reads, splints, results):
    """Kernel 1 at the locate shape: 128 reads, C = 2, L = 32768."""
    import numpy as np
    import torch

    from c3poa_tpu_torch.kernels.smooth import smooth3_batch
    from c3poa_tpu_torch.kernels.sw_profile import (start_profile_batch,
                                                    start_profile_cuda)
    from c3poa_tpu_torch.pipeline.backend import Combo
    from c3poa_tpu_torch.ref import sg
    from c3poa_tpu_torch.state import splint_array, to_device
    from c3poa_tpu_torch.utils import encode, revcomp_encoded

    B, L = 128, 32768
    codes = encode(next(iter(splints.values())))
    combos = [Combo("s", "+", codes, len(codes)),
              Combo("s", "-", revcomp_encoded(codes), len(codes))]
    S_np = splint_array(combos)
    enc = sorted((encode(r.seq) for r in reads if len(r.seq) <= L),
                 key=len, reverse=True)[:B]
    R = np.full((B, L), 4, dtype=np.int8)
    lens = np.zeros(B, dtype=np.int32)
    for b, c in enumerate(enc):
        R[b, :len(c)] = c
        lens[b] = len(c)
    Rd, Sd, ld = (to_device(a, dev) for a in (R, S_np, lens))
    got = start_profile_cuda(Rd, Sd, ld)
    want = start_profile_batch(Rd, Sd)
    torch.cuda.synchronize()
    err = require_equal("start_profile_cuda", got, want)
    ms = cuda_time_ms(lambda: start_profile_cuda(Rd, Sd, ld), 10)
    plain_ms = cuda_time_ms(lambda: start_profile_batch(Rd, Sd), 2)
    cells = B * S_np.shape[0] * L * S_np.shape[1]
    # what this run's data needs: the splint's own rows over each read's
    # own columns
    need = int(lens.astype(np.int64).sum()) * S_np.shape[0] * len(codes)
    bd = bound(nbytes(Rd, Sd, ld, got),
               OPS_PER_CELL["start_profile_cuda"] * need)
    log(f"profile: B={B} C={S_np.shape[0]} L={L} m={S_np.shape[1]} exact; "
        f"kernel {ms:.3f} ms ({cells / ms / 1e6:.1f} G cells/s), "
        f"plain {plain_ms:.3f} ms, bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']}, {need} cells)")
    results["start_profile_cuda"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=plain_ms, **bd)

    # float32 smoothing on the card: against the CPU torch version, and
    # the f32-vs-f64 error the peak guards are calibrated against
    prof = want.max(dim=2).values.argmax(dim=1)
    rows = torch.gather(want, 1, prof.view(B, 1, 1).expand(B, 1, L))[:, 0]
    sm_gpu = smooth3_batch(rows.float(), ld).cpu()
    sm_cpu = smooth3_batch(rows.float().cpu(), ld.cpu())
    d_cpu = float((sm_gpu - sm_cpu).abs().max())
    e_abs = e_adj = 0.0
    rows_np, sm_np = rows.cpu().numpy(), sm_gpu.numpy()
    for b in range(B):
        n = int(lens[b])
        d = sm_np[b, :n].astype(np.float64) - sg.smooth3(
            rows_np[b, :n].astype(np.float64))
        e_abs = max(e_abs, float(np.abs(d).max()))
        e_adj = max(e_adj, float(np.abs(np.diff(d)).max()))
    log(f"smooth3 f32 on the card: max |gpu - cpu torch| = {d_cpu!r}; "
        f"vs f64 max abs {e_abs!r}, max adjacent-difference {e_adj!r} "
        f"(JAX calibration 7.8e-5 / 8.4e-5; STRUCT_ATOL 2e-4)")
    if d_cpu > 2e-4:
        raise SmokeFailure(f"smooth3 on the card differs from the CPU by "
                           f"{d_cpu} > 2e-4")


def make_pairs(P: int, nq: int, rng):
    """Nanopore-like (subread, draft) pairs: a draft of 1500-2000 bases
    and a copy with 5% substitutions / 3% insertions / 3% deletions."""
    import numpy as np

    from c3poa_tpu_torch import sim
    from c3poa_tpu_torch.utils import encode
    Q = np.full((P, nq), 4, dtype=np.int8)
    T = np.full((P, nq), 4, dtype=np.int8)
    ql = np.zeros(P, dtype=np.int32)
    tl = np.zeros(P, dtype=np.int32)
    for p in range(P):
        draft = sim.random_seq(rng, int(rng.integers(1500, 2000)))
        t = encode(draft)
        q = encode(sim.mutate(rng, draft, 0.05, 0.03, 0.03))[:nq]
        Q[p, :len(q)] = q
        T[p, :len(t)] = t
        ql[p], tl[p] = len(q), len(t)
    return Q, T, ql, tl


# further (P, W, scoring) at which forward and walk are held to their
# plain versions: the zero-repeat overlap scoring and the fast band; P is
# small because the plain versions take seconds whatever P is
BANDED_CHECKS = ((256, 128, (20, -7, 10, 5)), (256, 64, (5, -4, 4, 2)))


def check_banded(Q, T, ql, tl, W, scoring):
    """Forward and walk on the card against their plain versions, every
    output equal.  Returns (forward outputs, walk outputs, {kernel:
    dict(max_abs_err, plain_ms)}), the plain versions timed as they run
    for the comparison."""
    import torch

    from c3poa_tpu_torch.kernels.banded import (banded_align_batch,
                                                banded_fwd_cuda,
                                                banded_walk_batch,
                                                banded_walk_cuda)
    nq = Q.shape[1]
    kw = dict(band=W, match=scoring[0], mismatch=scoring[1],
              gap_open=scoring[2], gap_ext=scoring[3])
    what = f"W={W} scoring={scoring}"
    fwd = banded_fwd_cuda(Q, T, ql, tl, **kw)
    torch.cuda.synchronize()
    fwd0, plain_f = cuda_time_once(
        lambda: banded_align_batch(Q, T, ql, tl, **kw))
    err_f = max(require_equal(f"banded_fwd_cuda {name} ({what})", a, b)
                for name, a, b in zip(("score", "j_end", "moves"), fwd, fwd0))
    walk = banded_walk_cuda(fwd[2], ql, tl, fwd[1], nq, W)
    torch.cuda.synchronize()
    walk0, plain_w = cuda_time_once(
        lambda: banded_walk_batch(fwd0[2], ql, tl, fwd0[1], nq, W))
    err_w = max(require_equal(f"banded_walk_cuda {name} ({what})", a, b)
                for name, a, b in zip(("j_start", "i_rem", "ops", "edge"),
                                      walk, walk0))
    return fwd, walk, {
        "banded_fwd_cuda": dict(max_abs_err=err_f, plain_ms=plain_f),
        "banded_walk_cuda": dict(max_abs_err=err_w, plain_ms=plain_w)}


def phase_banded(dev, results):
    """Kernels 2 and 3 at the align shape: P = 2048, nq = 2048, W = 128;
    then both at the other scoring and band of the consensus run; the
    forward kernel's SASS instructions a row by pipe; the walk of one
    pair alone (its chain floor)."""
    import numpy as np
    import torch

    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.kernels.banded import (banded_fwd_cuda,
                                                banded_walk_cuda)
    from c3poa_tpu_torch.state import to_device
    from c3poa_tpu_torch.tools import banded_sass

    P, nq, W = 2048, 2048, 128
    Q, T, ql, tl = make_pairs(P, nq, np.random.default_rng(SEED + 1))
    Qd, Td, qld, tld = (to_device(a, dev) for a in (Q, T, ql, tl))
    (sc, je, mv), walk, checked = check_banded(Qd, Td, qld, tld, W,
                                               (5, -4, 4, 2))
    ms = cuda_time_ms(lambda: banded_fwd_cuda(Qd, Td, qld, tld, band=W), 5)
    plain_ms = checked["banded_fwd_cuda"]["plain_ms"]
    cells = int(ql.astype(np.int64).sum()) * W
    bd = bound(nbytes(Qd, Td, qld, tld, sc, je, mv),
               OPS_PER_CELL["banded_fwd_cuda"] * cells)
    log(f"banded forward: P={P} nq={nq} W={W} exact; kernel {ms:.3f} ms "
        f"({cells / ms / 1e6:.2f} G cells/s), plain {plain_ms:.3f} ms, "
        f"bound {bd['bound_ms']:.3f} ms ({bd['bound_by']})")
    results["banded_fwd_cuda"] = dict(ms=ms, **checked["banded_fwd_cuda"],
                                      **bd)

    n_rem = int((walk[1] > 0).sum())
    ms = cuda_time_ms(lambda: banded_walk_cuda(mv, qld, tld, je, nq, W), 5)
    plain_ms = checked["banded_walk_cuda"]["plain_ms"]
    # the path's steps (non-zero 2-bit ops) and at least one move word
    # per 8 query rows of each path
    ops = walk[2].to(torch.int32)
    per_pair = sum(((ops >> (2 * k)) & 3 != 0).sum(dim=1) for k in range(4))
    steps = int(per_pair.sum())
    path_words = int((-(-ql.astype(np.int64) // 8)).sum()) * 4
    bd = bound(nbytes(qld, tld, je, *walk) + path_words,
               OPS_PER_CELL["banded_walk_cuda"] * steps)
    log(f"banded walk: P={P} exact ({n_rem} pairs out of steps, {steps} "
        f"steps); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    results["banded_walk_cuda"] = dict(ms=ms, **checked["banded_walk_cuda"],
                                       **bd)

    # the chain floor: the batch's longest path walked alone
    p = int(per_pair.argmax())
    one = [x[p:p + 1].contiguous() for x in (mv, qld, tld, je)]
    ms1 = cuda_time_ms(lambda: banded_walk_cuda(*one, nq, W), 10)
    log(f"banded walk, one pair alone (P=1, pair {p}, "
        f"{int(per_pair[p])} steps): {ms1:.4f} ms = "
        f"{ms1 * 1e6 / int(per_pair[p]):.1f} ns a step (the chain floor)")

    for Pc, Wc, scoring in BANDED_CHECKS:
        args = [x[:Pc].contiguous() for x in (Qd, Td, qld, tld)]
        _, wk, _ = check_banded(*args, Wc, scoring)
        log(f"banded forward and walk: P={Pc} nq={nq} W={Wc} scoring="
            f"{scoring} exact ({int((wk[1] > 0).sum())} pairs out of "
            f"steps, {int(wk[3].sum())} on a band edge)")

    log(f"banded forward, W = {W}: SASS instructions a row and warp by "
        f"pipe (shortest / longest path through the row loop / all of it)")
    for line in banded_sass.format_row_pipes(
            banded_sass.forward_row_pipes(_build.sass("banded"), W)):
        log("  " + line)


def consensus_like_reads(rng, n: int, indexes=None):
    """``n`` postprocess inputs: cDNA of 500-2000 bases between the
    default adapters, 1% errors, directions alternating; the i-th read
    carries index i % 4 when ``indexes`` are given."""
    from c3poa_tpu_torch import sim
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
    from c3poa_tpu_torch import sim
    from c3poa_tpu_torch.utils import encode, revcomp_encoded
    combos = []
    for seq in sim.DEFAULT_ADAPTERS.values():
        combos += [encode(seq), revcomp_encoded(encode(seq))]
    return combos


def phase_adapters(dev, results):
    """The adapter kernel at the postprocess shape: 1000 consensus-like
    reads, C = 4 combos, L = the longest read rounded up to 64."""
    import numpy as np
    import torch

    from c3poa_tpu_torch.kernels.adapters import (adapter_hits_batch,
                                                  adapter_hits_cuda)
    from c3poa_tpu_torch.pipeline.backend import NumpyBackend
    from c3poa_tpu_torch.state import to_device
    from c3poa_tpu_torch.utils import encode

    reads = [encode(s) for _, s in consensus_like_reads(
        np.random.default_rng(SEED + 3), N_POST_READS)]
    combos = adapter_combos()
    B, C = len(reads), len(combos)
    L = -(-max(len(r) for r in reads) // 64) * 64
    R = np.full((B, L), 4, dtype=np.int8)
    lens = np.array([len(r) for r in reads], dtype=np.int32)
    for b, r in enumerate(reads):
        R[b, :len(r)] = r
    m = max(len(c) for c in combos)
    A = np.full((C, m), 4, dtype=np.int8)
    for c, codes in enumerate(combos):
        A[c, :len(codes)] = codes
    alens = np.array([len(c) for c in combos], dtype=np.int32)
    args = [to_device(x, dev) for x in (R, lens, A, alens)]
    scoring = NumpyBackend.ADAPTER_SCORING
    got = adapter_hits_cuda(*args, *scoring)
    want = adapter_hits_batch(*args, *scoring)
    torch.cuda.synchronize()
    for name, a, b in zip(("s1", "j1", "qe1", "ts1", "qs1", "s2"), got,
                          want):
        err = require_equal(f"adapter_hits_cuda {name}", a, b)
    ms = cuda_time_ms(lambda: adapter_hits_cuda(*args, *scoring), 10)
    plain_ms = cuda_time_ms(lambda: adapter_hits_batch(*args, *scoring), 1)
    cells = int(lens.astype(np.int64).sum()) * int(alens.sum())
    bd = bound(nbytes(*args, *got), OPS_PER_CELL["adapter_hits_cuda"] * cells)
    log(f"adapters: B={B} C={C} L={L} m={m} exact; kernel {ms:.3f} ms "
        f"({cells / ms / 1e6:.2f} G cells/s), plain {plain_ms:.3f} ms, "
        f"bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}, {cells} cells); "
        f"s1 > 10 in {int((got[0] > 10).sum())} of {B * C}")
    results["adapter_hits_cuda"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, **bd)


def phase_probes(dev, results):
    """The two probe kernels against their plain versions, then the
    probes' entry points, each of which must launch its kernel: their
    launches are the ones those runs make (no user path runs them)."""
    import numpy as np
    import torch

    from c3poa_tpu_torch.kernels import _build, probes
    from c3poa_tpu_torch.state import to_device
    from c3poa_tpu_torch.tools import floor_probe, int16_probe

    rng = np.random.default_rng(SEED + 4)
    big = [rng.integers(-2 ** 15, 2 ** 15, (4096, 128)).astype(np.int16)
           for _ in range(2)]
    for x, y in (int16_probe.inputs(), big):
        xd, yd = to_device(x, dev), to_device(y, dev)
        got = probes.int16_probe_cuda(xd, yd)
        want = probes.int16_probe_plain(xd, yd)
        torch.cuda.synchronize()
        err = require_equal(f"int16_probe_cuda {tuple(x.shape)}", got, want)
    ms = cuda_time_ms(lambda: probes.int16_probe_cuda(xd, yd), 200)
    plain_ms = cuda_time_ms(lambda: probes.int16_probe_plain(xd, yd), 50)
    bd = bound(nbytes(xd, yd, got),
               OPS_PER_CELL["int16_probe_cuda"] * got.numel())
    log(f"int16 probe: (4096, 128) and the original's (16, 128) exact; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bd['bound_ms']:.5f} ms ({bd['bound_by']})")
    results["int16_probe_cuda"] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms, **bd)

    M, niter = 64, FLOOR_CHECK_NITER
    for S in FLOOR_CHECK_S:
        xd = to_device(rng.integers(1, 7, (S, 128)).astype(np.int32), dev)
        for mode in probes.FLOOR_CHAINS:
            got = probes.floor_probe_cuda(xd, M, niter, mode)
            want = probes.floor_probe_plain(xd, M, niter, mode)
            torch.cuda.synchronize()
            err = require_equal(f"floor_probe_cuda S={S} {mode}", got, want)
    # timed at the largest S, one chain
    ms = cuda_time_ms(lambda: probes.floor_probe_cuda(xd, M, niter, "chain"),
                      20)
    plain_ms = cuda_time_ms(
        lambda: probes.floor_probe_plain(xd, M, niter, "chain"), 2)
    pairs = M // 2 * niter * xd.numel()
    bd = bound(nbytes(xd, got), OPS_PER_CELL["floor_probe_cuda"] * pairs,
               SM_LANE_OPS_PER_S)
    log(f"floor probe: S in {FLOOR_CHECK_S}, M={M}, NITER={niter}, every "
        f"mode exact; chain at S={xd.shape[0]}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}"
        f", one SM)")
    results["floor_probe_cuda"] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms, **bd)

    for name, tool, argv in (
            ("int16_probe_cuda", int16_probe, ["--device", "cuda"]),
            ("floor_probe_cuda", floor_probe, ["64", "4096"])):
        _build.reset_counts()
        t0 = time.time()
        rc = tool.main(argv)
        counts = _build.launch_counts()
        log(f"{tool.__name__} {' '.join(argv)}: exit {rc} in "
            f"{time.time() - t0:.3f} s; launches {json.dumps(counts)}")
        if rc != 0:
            raise SmokeFailure(f"{tool.__name__} exited {rc}")
        if counts.get(name, 0) <= 0:
            raise SmokeFailure(f"{name} was not launched by "
                               f"{tool.__name__}")
        results[name]["launches"] = counts[name]


def phase_end_to_end(results):
    """The consensus run through the CLI on the card, then the numpy
    backend on the same reads; outputs must be byte-identical."""
    from c3poa_tpu_torch import cli
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.pipeline.backend import NumpyBackend
    from c3poa_tpu_torch.pipeline.run import PipelineConfig, run_pipeline

    reads_fq = os.path.join(WORK, "reads.fastq")
    splint_fa = os.path.join(WORK, "splint.fasta")
    out_cuda = os.path.join(WORK, "out_cuda")
    out_np = os.path.join(WORK, "out_numpy")
    for d in (out_cuda, out_np):
        shutil.rmtree(d, ignore_errors=True)

    _build.reset_counts()
    t0 = time.time()
    rc = cli.main(["-r", reads_fq, "-s", splint_fa, "-o", out_cuda,
                   "--backend", "cuda", "-g", str(N_READS)])
    wall = time.time() - t0
    counts = _build.launch_counts()
    if rc != 0:
        raise SmokeFailure(f"cli exited {rc}")
    stats = json.load(open(os.path.join(out_cuda, "c3poa_stats.json")))
    log(f"end-to-end cuda: {N_READS} reads in {wall:.3f} s = "
        f"{N_READS / wall:.3f} reads/s (wall incl. set-up); stats "
        f"reads_per_sec {stats.get('reads_per_sec')}")
    log("stages_s " + json.dumps(stats["stages_s"]))
    log("counters " + json.dumps(stats["counters"]))
    log("launches " + json.dumps(counts))
    for name in CONSENSUS_KERNELS:
        if counts.get(name, 0) <= 0:
            raise SmokeFailure(f"{name} was not launched by the run")
        results[name]["launches"] = counts[name]

    workers = os.cpu_count() or 1
    t0 = time.time()
    run_pipeline(reads_fq, splint_fa, out_np,
                 PipelineConfig(group_size=-(-N_READS // workers),
                                num_threads=workers), NumpyBackend())
    log(f"numpy arm: all {N_READS} reads, {workers} workers, "
        f"{time.time() - t0:.3f} s")
    for rel in OUTPUT_FILES:
        a = open(os.path.join(out_cuda, rel), "rb").read()
        b = open(os.path.join(out_np, rel), "rb").read()
        if a != b:
            raise SmokeFailure(f"{rel} differs from the numpy backend's")
        log(f"  {rel}: {len(a)} bytes, identical")


def tree_bytes(root: str) -> dict:
    """{relative path: bytes} of every output file under ``root``."""
    tree = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            if not f.startswith("."):
                p = os.path.join(d, f)
                tree[os.path.relpath(p, root)] = open(p, "rb").read()
    return tree


def phase_postprocess_end_to_end(results):
    """The postprocess run through its CLI on the card, on the consensus
    run's reads (no adapters: rejected) followed by consensus-like reads
    with adapters and four oligo-dT indexes; then the numpy backend on
    the same input.  The output trees must be byte-identical."""
    import numpy as np

    from c3poa_tpu_torch import cli_postprocess, sim
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.pipeline.backend import NumpyBackend
    from c3poa_tpu_torch.pipeline.postprocess import (PostprocessConfig,
                                                      run_postprocess)
    from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend

    indexes = {f"Index{i}": sim.random_seq(np.random.default_rng(300 + i), 10)
               for i in range(1, 5)}
    cons = open(os.path.join(WORK, "out_cuda", "Splint1",
                             "R2C2_Consensus.fasta")).read()
    n_cons = cons.count(">")
    post_in = os.path.join(WORK, "post_in.fasta")
    adapters_fa = os.path.join(WORK, "adapters.fasta")
    indexes_fa = os.path.join(WORK, "indexes.fasta")
    with open(post_in, "w") as fh:
        fh.write(cons)
        for name, seq in consensus_like_reads(
                np.random.default_rng(SEED + 2), N_POST_READS, indexes):
            fh.write(f">{name}\n{seq}\n")
    sim.write_fasta(adapters_fa, dict(sim.DEFAULT_ADAPTERS))
    sim.write_fasta(indexes_fa, indexes)
    n_in = n_cons + N_POST_READS
    out_cuda = os.path.join(WORK, "post_cuda")
    out_np = os.path.join(WORK, "post_numpy")
    for d in (out_cuda, out_np):
        shutil.rmtree(d, ignore_errors=True)

    # stage times: the device stage (adapter hits, materialized on the
    # host) against the rest (parse, hit extraction, demux, writes)
    spent = []
    device_stage = TorchBackend.adapter_hits

    def timed(self, *args):
        t = time.perf_counter()
        res = device_stage(self, *args)
        spent.append(time.perf_counter() - t)
        return res

    TorchBackend.adapter_hits = timed
    try:
        _build.reset_counts()
        t0 = time.time()
        rc = cli_postprocess.main(["-i", post_in, "-a", adapters_fa,
                                   "-x", indexes_fa, "-o", out_cuda, "-t",
                                   "--backend", "cuda"])
        wall = time.time() - t0
        counts = _build.launch_counts()
    finally:
        TorchBackend.adapter_hits = device_stage
    if rc != 0:
        raise SmokeFailure(f"cli_postprocess exited {rc}")
    log(f"postprocess cuda: {n_in} reads ({n_cons} consensus + "
        f"{N_POST_READS} consensus-like) in {wall:.3f} s = "
        f"{n_in / wall:.3f} reads/s (wall incl. set-up)")
    log(f"postprocess stages_s: adapter_hits {sum(spent):.3f} "
        f"({len(spent)} groups: {', '.join(f'{x:.3f}' for x in spent)}), "
        f"rest {wall - sum(spent):.3f}")
    log("launches " + json.dumps(counts))
    for name in POST_KERNELS:
        if counts.get(name, 0) <= 0:
            raise SmokeFailure(f"{name} was not launched by the run")
        results[name]["launches"] = counts[name]

    workers = os.cpu_count() or 1
    t0 = time.time()
    run_postprocess(post_in, out_np, adapters_fa, indexes_fa,
                    PostprocessConfig(trim=True,
                                      group_size=-(-n_in // workers),
                                      threads=workers), NumpyBackend())
    log(f"postprocess numpy arm: all {n_in} reads, {workers} workers, "
        f"{time.time() - t0:.3f} s")
    a, b = tree_bytes(out_cuda), tree_bytes(out_np)
    if sorted(a) != sorted(b):
        raise SmokeFailure(f"postprocess trees hold different files: "
                           f"{sorted(a)} vs {sorted(b)}")
    for rel in sorted(a):
        if a[rel] != b[rel]:
            raise SmokeFailure(f"postprocess {rel} differs from the numpy "
                               f"backend's")
        log(f"  {rel}: {len(a[rel])} bytes, identical")
    if "R2C2_oligodT_multiplexing.tsv" not in a:
        raise SmokeFailure("no R2C2_oligodT_multiplexing.tsv written")
    written = sum(v.count(b">") for k, v in a.items()
                  if k.endswith("R2C2_full_length_consensus_reads.fasta"))
    log(f"postprocess wrote {written} of {n_in} reads")
    if not written:
        raise SmokeFailure("postprocess wrote no read")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from c3poa_tpu_torch import native
        from c3poa_tpu_torch.device import resolve_device
        from c3poa_tpu_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the repo's packages are missing ({exc})",
              file=sys.stderr)
        return 2

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")
    log(f"nvidia-smi: {smi}")

    results = {k: {} for k in KERNELS}
    t_start = time.time()
    try:
        t0 = time.time()
        built = _build.build_all()
        log(f"kernels built in {time.time() - t0:.3f} s: {built}")
        for lib, text in _build.build_logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {lib}: {line.strip()}")
        t0 = time.time()
        if not native.available():
            raise SmokeFailure(f"the port's native library did not load: "
                               f"{native.build_error}")
        log(f"native library: {native.lib_path()} "
            f"({time.time() - t0:.3f} s)")
        t0 = time.time()
        reads, splints = make_dataset()
        log(f"dataset: {len(reads)} reads in {time.time() - t0:.3f} s")
        for phase, args in (
                (phase_profile, (dev, reads, splints, results)),
                (phase_banded, (dev, results)),
                (phase_adapters, (dev, results)),
                (phase_probes, (dev, results)),
                (phase_end_to_end, (results,)),
                (phase_postprocess_end_to_end, (results,))):
            t0 = time.time()
            phase(*args)
            log(f"{phase.__name__}: {time.time() - t0:.3f} s")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    leaked = sorted(k for k in sys.modules
                    if k.split(".")[0] in ("jax", "c3poa_tpu"))
    if leaked:
        print(f"chip_smoke: FAILED: imported {leaked}", file=sys.stderr)
        return 1

    # no PyTorch call computes these DPs or probes: library_ms is null
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=results[k]["launches"],
                    max_abs_err=results[k]["max_abs_err"],
                    ms=results[k]["ms"], plain_ms=results[k]["plain_ms"],
                    bound_ms=results[k]["bound_ms"],
                    bound_by=results[k]["bound_by"], library_ms=None)
               for k, (src, rep) in KERNELS.items()]
    log(f"chip_smoke: {time.time() - t_start:.3f} s after the imports")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
