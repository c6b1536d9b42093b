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
7. sends a pair with a target one base over the banded forward kernel's
   staging limit, and a combo set of a splint too long for the profile
   kernel's tiles, through ``TorchBackend`` on the card: both take the
   host routes and equal the numpy backend;
8. runs ``python -m c3poa_tpu_torch.cli_postprocess --backend cuda``
   in-process on that run's consensus reads plus 1000 consensus-like
   reads with adapters and oligo-dT indexes, requires the adapter kernel
   to have launched during that run, and requires its output tree to
   equal the numpy backend's byte for byte;
9. prints one JSON line with the kernels (times, launches, and the
   least time the card could take for the same work), the
   ``nvidia-smi`` line, and last the ``{"ok": true, "device": ...}`` line.

Besides, step 4 times the locate step's smoothing and peak candidates
(torch ops) alone with their bound and a conv1d yardstick, measures the
float32 smoothing's error at 200 and 450 bp splints and the peak guard's
extra flags (``tools/smooth_error``), reads the int16 probe's device
time from ``torch.profiler`` at two shapes, and times the adapter kernel
on the inputs of ``c3poa_tpu_torch.tools.adapters_time`` (its general
path, a long read, small batches), each held to its plain version.

    python3 chip_smoke.py --parent-adapters DIR

also builds ``DIR/adapters.cu`` (an earlier revision of the adapter
kernel, with its ``adapters.cuh``, C signature ``c3t_adapter_hits`` of 6
pointers) into a temporary directory and times it beside the current
kernel on the inputs of ``c3poa_tpu_torch.tools.adapters_time`` (the
postprocess shape, the general path, a long read, small batches), in the
order earlier, current, current, earlier.

Exits non-zero, printing no result line, when there is no CUDA device,
when the repo's packages are missing, or when any phase fails.  Work
files go to ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# float32 outside the tensor cores (NVIDIA's data sheet), a multiply and
# an add counted as two operations
F32_OPS_PER_S = 67e12
# one SM issues at most four warp instructions a clock (one per scheduler,
# 128 lanes), over its ALU and FMA pipes together
SM_LANE_OPS_PER_S = 4 * 32 * 1.98e9
# the same on all 132 SMs
LANE_OPS_PER_S = 132 * SM_LANE_OPS_PER_S
# integer operations a DP cell (or walk step) needs, counted from the
# recurrences: profile — substitution 2, diagonal and up 2, 3-way max 2,
# run shift, max and unshift 3, column max 1; banded forward —
# substitution 2, E 3 and its flag 1, D 1, Ht 1, F prefix 3 and its flag
# 3, H 1, move source 3, nibble 2; walk — nibble decode 2, state and
# source 4, i/j 2; int16 probe — max, roll, select and add per column;
# floor probe and adapters — the fewest Hopper instructions, over 128
# lanes an SM (the floor probe issues them at that rate).  Floor probe, per
# (add, max) pair: one DPX VIADDMNMX does the add and the max, one more
# negates (c - (x + c) is -x), on one SM by design.  Adapters, per cell of
# the direct recurrence with its payload and tie order in one word
# (csrc/adapters.cuh, the packed path): the substitution byte (PRMT), the
# diagonal (IADD3), the three-way max of diagonal, up and left (VIMNMX3),
# the floor (VIADDMNMX), the tie rank cleared (LOP3), the cell as the
# next column's left and the next row's up (2 IADD), the column's key
# (VIADDMNMX); the lane's step around the cells is not counted
OPS_PER_CELL = {"start_profile_cuda": 10, "banded_fwd_cuda": 20,
                "banded_walk_cuda": 8, "adapter_hits_cuda": 8,
                "int16_probe_cuda": 4, "floor_probe_cuda": 2}
# the adapter kernel's first count, printed beside the bound: a prefix
# scan of the in-row run (run shift, join and unshift 5 and 16 more a
# cell) on the 64-lane ALU
ADAPTER_SCAN_OPS_PER_CELL = 21

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


def device_activities(fn) -> list:
    """[(name, microseconds)] of the device activities (kernels, copies,
    sets) one call of ``fn`` runs, from ``torch.profiler``; empty when
    the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in p.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


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
    smooth_peaks_row(dev, Rd, Sd, ld, want)

    # the f32 error and the margin guard's flags with and without its
    # relative term (STRUCT_REL): the consensus run's 1000 reads and 200 bp
    # splint, and 128 bench-shaped reads of a 450 bp splint
    from c3poa_tpu_torch.tools import smooth_error
    for res in (smooth_error.measure_reads(
                    [encode(r.seq) for r in reads], combos, dev),
                smooth_error.measure(128, 450, SEED, dev)):
        log(f"smooth_error {res['splint_len']} bp: {json.dumps(res)}")
        if res["flagged"] < res["flagged_floor_only"]:
            raise SmokeFailure("the relative structure margin flags fewer "
                               "reads than its floor alone")


def smooth_peaks_row(dev, Rd, Sd, ld, prof):
    """The locate step's torch ops alone (``kernels/locate.py:51-55``):
    the chosen combo's row gathered and made float, ``smooth3_batch`` and
    ``peak_candidates_batch``; with the device kernels one locate batch
    launches (``torch.profiler``), a bound and three conv1d passes of the
    same 41 taps as a yardstick (not bit-equal: no per-read edge
    padding)."""
    import torch

    from c3poa_tpu_torch.kernels.locate import locate_device
    from c3poa_tpu_torch.kernels.peaks import peak_candidates_batch
    from c3poa_tpu_torch.kernels.smooth import smooth3_batch
    from c3poa_tpu_torch.ref.sg import sg_coeffs

    B, _, L = prof.shape
    combo = prof.max(dim=2).values.argmax(dim=1)
    idx = combo.view(B, 1, 1).expand(B, 1, L)

    def gathered():
        return torch.gather(prof, 1, idx)[:, 0, :].to(torch.float32)

    rows = gathered()
    sm = smooth3_batch(rows, ld)
    cand = peak_candidates_batch(sm, ld, tile=64)

    def both():
        x = smooth3_batch(gathered(), ld)
        return peak_candidates_batch(x, ld, tile=64)

    ms_gather = cuda_time_ms(gathered, 5)
    ms_smooth = cuda_time_ms(lambda: smooth3_batch(rows, ld), 5)
    ms_peaks = cuda_time_ms(lambda: peak_candidates_batch(sm, ld, tile=64),
                            5)
    ms_all = cuda_time_ms(both, 5)
    w = torch.tensor(sg_coeffs(41, 2), dtype=torch.float32,
                     device=dev).view(1, 1, 41)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        def conv3():
            x = rows.view(B, 1, L)
            for _ in range(3):
                x = torch.nn.functional.conv1d(x, w, padding=20)
            return x
        ms_conv = cuda_time_ms(conv3, 5)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    step = device_activities(both)
    batch = device_activities(lambda: locate_device(Rd, ld, Sd, tile=64))
    # the int32 row read once, the candidates and flags written once
    bd = bound(B * L * 4 + nbytes(*cand), 3 * 41 * 2 * B * L, F32_OPS_PER_S)
    row = dict(ms=ms_all, ms_gather=ms_gather, ms_smooth=ms_smooth,
               ms_peaks=ms_peaks, library_ms=ms_conv,
               step_device_activities=len(step),
               step_device_us=sum(a[1] for a in step),
               locate_batch_device_activities=len(batch),
               locate_batch_device_us=sum(a[1] for a in batch), **bd)
    log(f"smoothing and peaks: B={B} L={L}: {json.dumps(row)}")


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


def phase_adapters(dev, results, parent_dir=None):
    """The adapter kernel at the postprocess shape: 1000 consensus-like
    reads, C = 4 combos, L = the longest read rounded up to 64; what the
    batch asks of it; its SASS (a DPX three-way max required) and step
    loops; its times on the inputs of ``tools/adapters_time`` (the general
    path, a long read, small batches), with ``parent_dir`` beside an
    earlier kernel."""
    import numpy as np
    import torch

    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.kernels.adapters import (adapter_hits_batch,
                                                  adapter_hits_cuda)
    from c3poa_tpu_torch.pipeline.backend import NumpyBackend
    from c3poa_tpu_torch.tools import adapters_time

    args = adapters_time.postprocess_batch(dev)
    (B, L), (C, m) = args[0].shape, args[2].shape
    scoring = NumpyBackend.ADAPTER_SCORING
    got = adapter_hits_cuda(*args, *scoring)
    want = adapter_hits_batch(*args, *scoring)
    torch.cuda.synchronize()
    for name, a, b in zip(("s1", "j1", "qe1", "ts1", "qs1", "s2"), got,
                          want):
        err = require_equal(f"adapter_hits_cuda {name}", a, b)
    ms = cuda_time_ms(lambda: adapter_hits_cuda(*args, *scoring), 10)
    plain_ms = cuda_time_ms(lambda: adapter_hits_batch(*args, *scoring), 1)
    lens_t, alens_t = args[1], args[3]
    lens, alens = lens_t.cpu().numpy(), alens_t.cpu().numpy()
    cells = int(lens.astype(np.int64).sum()) * int(alens.sum())
    bd = bound(nbytes(*args, *got), OPS_PER_CELL["adapter_hits_cuda"] * cells,
               LANE_OPS_PER_S)
    scan = bound(nbytes(*args, *got), ADAPTER_SCAN_OPS_PER_CELL * cells)
    log(f"adapters: B={B} C={C} L={L} m={m} exact; kernel {ms:.4f} ms "
        f"({cells / ms / 1e6:.2f} G cells/s), plain {plain_ms:.3f} ms, "
        f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, {cells} cells, "
        f"{OPS_PER_CELL['adapter_hits_cuda']} operations a cell on 128 "
        f"lanes an SM: the kernel at {bd['bound_ms'] / ms:.1%} of it); "
        f"{scan['bound_ms']:.4f} ms with the prefix-scan count "
        f"({ADAPTER_SCAN_OPS_PER_CELL} on 64 lanes); "
        f"s1 > 10 in {int((got[0] > 10).sum())} of {B * C}")
    results["adapter_hits_cuda"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, **bd)
    log(f"adapters batch: {json.dumps(adapters_time.batch_stats(lens_t, alens_t))}")
    for line in _build.build_logs.get("adapters", "").splitlines():
        if "registers" in line or "spill" in line or "stack" in line:
            log(f"  adapters ptxas: {line.strip()}")
    insns = adapter_sass()
    ops = {}
    for _addr, insn in insns:
        op = _build.sass_mnemonic(insn).split(".")[0]
        ops[op] = ops.get(op, 0) + 1
    dpx = {k: v for k, v in ops.items() if k.startswith("VI")}
    local = [(hex(a), i) for a, i in insns
             if _build.sass_mnemonic(i).split(".")[0] in ("LDL", "STL")]
    log(f"adapters SASS: {sum(ops.values())} instructions, DPX {dpx}; "
        f"step loops (instructions, PRMT, SHFL, LDL+STL): "
        f"{adapters_time.sweep_loops(insns)}; local memory {local}; "
        f"{json.dumps(dict(sorted(ops.items(), key=lambda kv: -kv[1])))}")
    # the packed path's cell: a three-way DPX max (__vimax3_s32)
    if not ops.get("VIMNMX3"):
        raise SmokeFailure("no VIMNMX3 (DPX) in the adapter kernel")
    kernels = {"current": adapters_time.launcher(_build.load("adapters"))}
    tmp = tempfile.mkdtemp(prefix="parent_adapters_")
    try:
        if parent_dir:
            kernels = {"earlier": earlier_adapters(parent_dir, tmp),
                       **kernels}
        res = adapters_time.measure(kernels, adapters_time.shapes(dev))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label, r in res.items():
        log(f"adapters, {label} (timed {', '.join(kernels)}, then "
            f"reversed): {json.dumps(r)}")


def earlier_adapters(src_dir: str, tmp: str):
    """The adapter kernel of ``src_dir/adapters.cu`` (with its
    ``adapters.cuh``) of the earlier C interface (six pointers: a (B, C,
    L, 2) scratch, no carry row), built by nvcc into ``tmp``: a function
    (reads, lens, adapters, alens) -> (6, B, C) int32."""
    import ctypes

    import torch

    from c3poa_tpu_torch.constants import ADAPTER_OVERLAP_TOL
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.pipeline.backend import NumpyBackend

    so = os.path.join(tmp, "earlier_adapters.so")
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
         os.path.join(src_dir, "adapters.cu")], capture_output=True,
        text=True, timeout=600)
    if done.returncode:
        raise SmokeFailure(f"earlier adapters: nvcc failed\n{done.stdout}"
                           f"{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line:
            log(f"  earlier adapters ptxas: {line.strip()}")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = _build.bind(ctypes.CDLL(so),
                      {"c3t_adapter_hits": [P] * 6 + [I] * 8 + [P]})

    def run(R, lens, A, alens):
        B, L = R.shape
        C, m = A.shape
        out = torch.empty((6, B, C), dtype=torch.int32, device=R.device)
        scratch = torch.empty((B, C, L, 2), dtype=torch.int32,
                              device=R.device)
        _build.launch(lib, "c3t_adapter_hits", "earlier_adapters", R,
                      R.data_ptr(), lens.data_ptr(), A.data_ptr(),
                      alens.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                      B, L, C, m, *NumpyBackend.ADAPTER_SCORING,
                      ADAPTER_OVERLAP_TOL)
        return out
    return run


def adapter_sass() -> list:
    """The adapter kernel's SASS: [(address, instruction)]."""
    from c3poa_tpu_torch.kernels import _build
    funcs = _build.sass("adapters")
    return funcs[next(k for k in funcs if "adapter_hits_kernel" in k)]


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
    launch_ms = cuda_time_ms(lambda: probes.int16_probe_cuda(xd, yd), 200)
    plain_ms = cuda_time_ms(lambda: probes.int16_probe_plain(xd, yd), 50)
    ms = int16_device_ms(xd, yd)
    bd = bound(nbytes(xd, yd, got),
               OPS_PER_CELL["int16_probe_cuda"] * got.numel())
    log(f"int16 probe: (4096, 128) and the original's (16, 128) exact; "
        f"kernel {ms:.5f} ms on the device (torch.profiler; "
        f"{launch_ms:.4f} ms a launch from the host), plain "
        f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.5f} ms "
        f"({bd['bound_by']})")
    results["int16_probe_cuda"] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms, **bd)
    # a shape where bytes dominate: 64 MiB an input
    x, y = (rng.integers(-2 ** 15, 2 ** 15, (262144, 128)).astype(np.int16)
            for _ in range(2))
    xl, yl = to_device(x, dev), to_device(y, dev)
    big = probes.int16_probe_cuda(xl, yl)
    torch.cuda.synchronize()
    require_equal("int16_probe_cuda (262144, 128)", big,
                  probes.int16_probe_plain(xl, yl))
    ms_big = int16_device_ms(xl, yl)
    bd_big = bound(nbytes(xl, yl, big),
                   OPS_PER_CELL["int16_probe_cuda"] * big.numel())
    log(f"int16 probe (262144, 128): {ms_big:.5f} ms on the device, bound "
        f"{bd_big['bound_ms']:.5f} ms ({bd_big['bound_by']}): "
        f"{bd_big['bound_ms'] / ms_big:.1%} of it")
    del xl, yl, big

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


def int16_device_ms(xd, yd) -> float:
    """Mean device time of the int16 probe kernel over 20 launches, read
    from ``torch.profiler`` (not the host's launch rate); each launch
    follows a 128 MB write that evicts the card's 50 MB L2, so no input is
    read from a cache the launch before left warm."""
    import torch

    from c3poa_tpu_torch.kernels import probes
    flush = torch.empty(32 << 20, dtype=torch.int32, device=xd.device)

    def launches():
        for _ in range(20):
            flush.zero_()
            probes.int16_probe_cuda(xd, yd)
    probes.int16_probe_cuda(xd, yd)
    acts = device_activities(launches)
    us = [t for name, t in acts if "int16_probe" in name]
    if len(us) < 10:
        raise SmokeFailure(f"torch.profiler saw {len(us)} of 20 int16 "
                           f"probe launches ({len(acts)} activities)")
    return sum(us) / len(us) / 1e3


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


def phase_host_routes(dev):
    """The two host routes of ``TorchBackend`` on the card, each against
    the numpy backend: a pair whose target is one base over the forward
    kernel's staging limit beside one the kernel takes, and the combos of
    a 2600-base splint, too long for the profile kernel's tiles."""
    import numpy as np

    from c3poa_tpu_torch import sim
    from c3poa_tpu_torch.consensus.engine import ConsensusParams
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.kernels.banded import FWD_MAX_TARGET
    from c3poa_tpu_torch.pipeline.backend import Combo, NumpyBackend
    from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
    from c3poa_tpu_torch.utils import encode, prof, revcomp_encoded

    rng = np.random.default_rng(SEED + 5)
    pairs = []
    for n in (FWD_MAX_TARGET + 1, 1800):
        t = sim.random_seq(rng, n)
        q = sim.mutate(rng, t, 0.05, 0.03, 0.03)
        pairs.append((encode(q), np.full(len(q), 20, np.int8), encode(t)))
    params = ConsensusParams()
    prof.reset()
    _build.reset_counts()
    got = [tuple(np.array(f) for f in a.rec)
           for a in TorchBackend(dev).align_many(pairs, params)]
    counts = dict(prof.current.counts)
    want = [a.rec for a in NumpyBackend().align_many(pairs, params)]
    if counts.get("align_overlong_host") != 1 or \
            _build.launch_counts().get("banded_fwd_cuda") != 1:
        raise SmokeFailure(f"long-target route: counters {counts}, "
                           f"launches {_build.launch_counts()}")
    for k, (x, y) in enumerate(zip(got, want)):
        if not all(np.array_equal(u, v) for u, v in zip(x, y)):
            raise SmokeFailure(f"long-target route: pair {k} differs from "
                               f"the numpy backend's record")
    log(f"long target ({len(pairs[0][2])} bases, limit {FWD_MAX_TARGET}) on "
        f"the host beside a kernel pair: records equal numpy's; {counts}")

    splint = sim.random_seq(rng, 2600)
    codes = encode(splint)
    combos = [Combo("s", "+", codes, len(codes)),
              Combo("s", "-", revcomp_encoded(codes), len(codes))]
    reads = [encode(sim.random_seq(rng, 500) + splint + sim.random_seq(
        rng, 9000) + splint + sim.random_seq(rng, 9000)),
        encode(sim.random_seq(rng, 4000))]
    prof.reset()
    got = TorchBackend(dev).locate_many(reads, combos, 500)
    counts = dict(prof.current.counts)
    want = NumpyBackend().locate_many(reads, combos, 500)
    if counts.get("long_splint_host_located") != len(reads):
        raise SmokeFailure(f"long-splint route: counters {counts}")
    for x, y in zip(got, want):
        if (x.combo, x.score) != (y.combo, y.score) or \
                not np.array_equal(x.peaks, y.peaks):
            raise SmokeFailure("long-splint route differs from numpy")
    log(f"long splint ({len(splint)} bases): {len(reads)} reads located on "
        f"the host, equal to numpy (peaks "
        f"{[[int(p) for p in x.peaks] for x in got]})")


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
    from c3poa_tpu_torch.tools import adapters_time

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
        for name, seq in adapters_time.consensus_like_reads(
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-adapters", metavar="DIR",
                    help="an earlier adapters.cu (with its adapters.cuh) "
                         "to time beside the current kernel")
    opts = ap.parse_args(argv)
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
                (phase_adapters, (dev, results, opts.parent_adapters)),
                (phase_probes, (dev, results)),
                (phase_end_to_end, (results,)),
                (phase_host_routes, (dev,)),
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
