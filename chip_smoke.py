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
8. runs the consensus CLI on the card on long reads (ROADMAP 1.12): 256
   reads of ``c3poa_tpu_torch.tools.stress_bigreads`` (3.9-57 kb, up to
   30 copies), two of 98-131 kb that stay on the card (a locate batch of
   L > 98304, the peak kernel's cluster of 4 ranks) and two over
   ``MAX_READ_LEN`` (located on the host): the three output files equal
   the numpy backend's byte for byte; prints each locate launch's B, L
   and cluster, the card's peak memory, the padded cells, and times one
   locate batch at the widest L and the forward and walk at the largest
   nq beside their bounds;
9. runs ``c3poa_tpu_torch.tools.poa_stress``'s clean and chimera-heavy
   sets (512 reads, seed 3) through ``TorchBackend`` on the card against
   the numpy backend (ROADMAP 1.13): trees byte-identical, the heavy
   set's reads routed to the POA consensus equal in both arms and at
   least 10%, none in the clean set; then the tool's interleaved rounds
   at 1024 reads (the throughput ratio and verdict printed, not gated);
10. runs ``python -m c3poa_tpu_torch.cli_postprocess --backend cuda``
   in-process on that run's consensus reads plus 1000 consensus-like
   reads with adapters and oligo-dT indexes, requires the adapter kernel
   to have launched during that run, and requires its output tree to
   equal the numpy backend's byte for byte;
11. runs the consensus CLI on the same 1000 reads in 8 groups (``-g
   125``) as 1, 2, 4 and 8 processes that share the one card
   (``--coordinator localhost:<port> --num_processes N``): every merged
   tree must equal the numpy backend's byte for byte, and every process
   must have launched the consensus kernels;
12. kills a consensus CLI on the card (``--backend cuda -g 125
   --resume``, through ``--cli-process``, in a session of its own) with
   SIGKILL once its manifest records 2 of the 8 groups and it has
   launched every consensus kernel, then runs it again to its end: the
   tree must equal the numpy backend's and both sessions must have
   launched every consensus kernel; then runs the consensus CLI (``-g
   250``) and the postprocess CLI (``-g 500``) on the card under
   ``--rss-restart-mb 1``, a restart after every group: at least 3
   restarts each, every consensus group ending a session, both trees
   equal to numpy's; prints each run's wall, its sessions and the wall
   a session beside the uninterrupted runs' (the cost of a restart);
13. runs the consensus and postprocess runs through
   ``TorchBackend("cuda", devices=["cuda:0"] * n)`` for n = 2 and 3 (n
   streams of the one card; no second card is used): byte-identical to
   numpy, each kernel launched at least n times as often as on one
   device;
14. prints one JSON line with the kernels (times, launches, and the
   least time the card could take for the same work), the
   ``nvidia-smi`` line, and last the ``{"ok": true, "device": ...}`` line.

Besides, step 4 reads the profile kernel's row loop from its SASS (its
instructions a cell, beside the fewest its bound counts), requires the
smoothing kernel to equal the CPU plain version bit for bit at the locate
shape, times it beside its plain version, its bound and three conv1d
passes as a yardstick, requires the peak-candidates kernel to equal its
plain version bit for bit on all seven outputs there, times it (C
interface, wrapper, device time) beside the plain version's torch ops and
its bound, prints its cluster (ranks, share, shared memory a CTA),
registers and spills, holds it to the plain version and times it at 16,
64 and 512 reads too (the cluster the kernel picks at each), requires its
SASS to hold no FFMA, counts one
locate batch's device activities (``torch.profiler``; 10 expected),
measures the float32 smoothing's error against float64 at 200 and 450 bp
splints and the peak guard's extra flags (``tools/smooth_error``, through
the kernel), reads the int16 probe's device
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

    python3 chip_smoke.py --parent-peaks DIR [--parent-peaks DIR2 ...]

also builds each ``DIR/peaks.cu`` (an earlier revision of the
peak-candidates kernels, with its ``peaks.cuh``, the same C signature
``c3t_peak_candidates``; the two-kernel design of commit 9091467:
``git show 9091467:c3poa_tpu_torch/kernels/csrc/peaks.cu`` and
``peaks.cuh`` into a git-ignored directory) into a temporary
directory, requires its seven outputs to equal the current kernel's at
the locate shape (and at 16, 64 and 512 reads), and times the two there
in the order earlier, current, current, earlier.

    python3 chip_smoke.py --parent-profile DIR [--parent-profile DIR2 ...]

also builds each ``DIR/profile.cu`` (an earlier revision of the profile
kernel, with its headers, the same C signature ``c3t_start_profile``;
for the parent: ``git show HEAD~:c3poa_tpu_torch/kernels/csrc/profile.cu``
into a git-ignored directory) into a temporary directory, prints its
registers and its row loop's SASS by pipe, requires its output to equal
the current kernel's at the locate shape, and times the two there in the
order earlier, current, current, earlier.

Step 4 also prints the peak candidates' bound: one read of the (B, L)
float32 smoothed rows and the lengths, and the outputs written once, over
the memory rate.

Exits non-zero, printing no result line, when there is no CUDA device,
when the repo's packages are missing, or when any phase fails.  Work
files go to ``build/chip_smoke/`` in the checkout.

    python3 chip_smoke.py --cli-process OUT.json CLI_ARGS...

is one process of steps 9 and 10: ``python -m c3poa_tpu_torch.cli
CLI_ARGS``, then its kernel launches, peak device memory and seconds into
OUT.json (rewritten while it runs).
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
# the process sweep: process counts sharing the card, and the group size
# that gives the 1000 reads 8 groups (one a process at 8)
SWEEP = (1, 2, 4, 8)
SWEEP_GROUP = 125
# seconds one process of the sweep may take
PROCESS_TIMEOUT = 300
# phase_resume: seconds between a --cli-process report's rewrites, the
# group sizes of the supervised runs (4 groups each: the 1000 reads, and
# the ~2000 postprocess reads), the restarts they must make at least, and
# the seconds a supervised run may take
REPORT_EVERY_S = 0.1
RESUME_GROUP = 250
POST_RESUME_GROUP = 500
RESUME_RESTARTS = 3
RESUME_TIMEOUT = 600
# the mesh phase: streams of the one card, in turns with one device
MESH_SHARES = (1, 2, 3, 1)
# phase_long_reads: reads of stress_bigreads.make_big_dataset, and two
# edge reads of each (least length, most length, insert, copies): the
# first pair stays on the card with a locate L in (98304, 131072], where
# the peak kernel's cluster takes 4 ranks; the second is over
# MAX_READ_LEN = 131072 and located on the host
LONG_READS = 256
LONG_EDGE = ((98305, 131072, 4000, 26), (131073, 262144, 4500, 30))
# phase_poa_route: the reads of each poa_stress set held to numpy, and of
# each set of the tool's interleaved rounds
POA_READS = 512
POA_MEASURE_READS = 1024
POA_ROUNDS = 3

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
# integer operations a DP cell (or walk step) needs: banded forward —
# the fewest Hopper instructions a cell, over 128 lanes an SM, in the form
# csrc/banded.cuh keeps (bnd_row_open, bnd_row_gap, bnd_row_moves): the
# row's scores (one PRMT for 4 cells: 0.25), E (IADD for Ep - e, then
# VIADDMNMX), E's extend test (IADD3), D (IDP), Ht (IMNMX), a (IADD), the
# lane's running max of a (IMNMX), F' (VIADDMNMX), H (VIADDMNMX), a - F'
# (IADD), F's extend test (IADD), D - H and its XOR (IADD, LOP3), four
# pushes of the nibble (SHF): 17.25 a cell, 14.25 for a lane's first
# column (no running max, no F' and no extend test from inside the lane),
# so 16.5 at 4 columns a lane (W = 128); the shuffles, loads and stores
# around the row are not counted; walk — nibble decode 2, state and
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
# (VIADDMNMX); the lane's step around the cells is not counted.  Profile,
# the fewest Hopper instructions a cell, over 128 lanes an SM, in the
# form csrc/profile.cuh keeps: the diagonal with its score (IDP, dp4a of
# the row's score bytes and the read's one-hot code), T with the up term
# and the floor 0 (VIADDMNMX.RELU), T less the gap to the thread's first
# column (IMAD) and its share of the thread's total (a VIMNMX3 tree, 8 for
# 16 columns: 0.5), the gap run (VIADDMNMX), the column max (IMNMX); the
# row's shuffles and slots are not counted.  (The a = G - gap * j form,
# with the score from a byte permute, counts as many.)  Smoothing, per column
# of a read (j < n): 3 passes x 41 taps, each one FMUL and one FADD;
# bit-identity with the plain version forbids the FMA (and the
# symmetric-tap shortcut), so these are 246 FP32 instructions on 128
# lanes an SM, not 123 FMAs at the data sheet's 67 TFLOP/s; the edge pads
# (40 a pass a read) are not counted
OPS_PER_CELL = {"start_profile_cuda": 5.5, "banded_fwd_cuda": 16.5,
                "banded_walk_cuda": 8, "adapter_hits_cuda": 8,
                "int16_probe_cuda": 4, "floor_probe_cuda": 2,
                "smooth3_cuda": 246}
# the forward's first count, printed beside the bound: substitution 2, E 3
# and its flag 1, D 1, Ht 1, F prefix 3 and its flag 3, H 1, move source
# 3, nibble 2, from the recurrence, on the 64-lane ALU
FORWARD_RECURRENCE_OPS_PER_CELL = 20
# the adapter kernel's first count, printed beside the bound: a prefix
# scan of the in-row run (run shift, join and unshift 5 and 16 more a
# cell) on the 64-lane ALU
ADAPTER_SCAN_OPS_PER_CELL = 21
# the profile's first count, printed beside the bound: substitution 2,
# diagonal and up 2, 3-way max 2, run shift, max and unshift 3, column
# max 1, on the 64-lane ALU
PROFILE_RECURRENCE_OPS_PER_CELL = 10
# the smoothing's first count, printed beside the bound: the same 246
# float operations an element over all B x L elements at 67 TFLOP/s, as
# if they were FMAs
SMOOTH_FIRST_OPS_PER_ELEMENT = 3 * 41 * 2

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
    "smooth3_cuda": ("c3poa_tpu_torch/kernels/csrc/smooth.cu",
                     "c3poa_tpu/kernels/smooth.py:28"),
    "peak_candidates_cuda": ("c3poa_tpu_torch/kernels/csrc/peaks.cu",
                             "c3poa_tpu/kernels/peaks.py:112"),
}
# the device activities of one locate batch at the locate shape: the
# profile, smoothing and peak-candidates kernels and 7 torch ops of the
# combo choice
LOCATE_BATCH_ACTIVITIES = 10
# which run launches which kernel
CONSENSUS_KERNELS = ("start_profile_cuda", "smooth3_cuda",
                     "peak_candidates_cuda", "banded_fwd_cuda",
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


def phase_profile(dev, reads, splints, results, parent_dirs=(),
                  parent_peaks=()):
    """Kernel 1 at the locate shape: 128 reads, C = 2, L = 32768; beside
    the earlier profile kernels of ``parent_dirs``; then the rest of the
    locate step (``smooth_peaks_row``), the peak-candidates kernel beside
    the earlier ones of ``parent_peaks``."""
    import numpy as np
    import torch

    from c3poa_tpu_torch.kernels.smooth import (combo_rows, smooth3_batch,
                                                smooth3_cuda)
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
               OPS_PER_CELL["start_profile_cuda"] * need, LANE_OPS_PER_S)
    first = bound(nbytes(Rd, Sd, ld, got),
                  PROFILE_RECURRENCE_OPS_PER_CELL * need)
    log(f"profile: B={B} C={S_np.shape[0]} L={L} m={S_np.shape[1]} exact; "
        f"kernel {ms:.3f} ms ({cells / ms / 1e6:.1f} G cells/s), "
        f"plain {plain_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']}, {need} cells, "
        f"{OPS_PER_CELL['start_profile_cuda']} instructions a cell on 128 "
        f"lanes an SM: the kernel at {bd['bound_ms'] / ms:.1%} of it); "
        f"{first['bound_ms']:.4f} ms with the recurrence's count "
        f"({PROFILE_RECURRENCE_OPS_PER_CELL} on 64 lanes)")
    profile_sass(need / ms * 1e3)
    results["start_profile_cuda"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=plain_ms, **bd)
    for src_dir in parent_dirs:
        compare_profiles(src_dir, Rd, Sd, ld, got, bd["bound_ms"])

    # the smoothing kernel on the card against the CPU plain version, bit
    # for bit (-0 against +0 counts), and the f32-vs-f64 error the peak
    # guards are calibrated against, which the kernel must reproduce
    combo = want.max(dim=2).values.argmax(dim=1).to(torch.int32)
    rows = combo_rows(want, combo)
    sm_gpu = smooth3_cuda(want, combo, ld).cpu()
    torch.cuda.synchronize()
    sm_cpu = smooth3_batch(rows.cpu().float(), ld.cpu())
    bad = int((sm_gpu.view(torch.int32) != sm_cpu.view(torch.int32)).sum())
    d_cpu = float((sm_gpu - sm_cpu).abs().max())
    e_abs = e_adj = 0.0
    rows_np, sm_np = rows.cpu().numpy(), sm_gpu.numpy()
    for b in range(B):
        n = int(lens[b])
        d = sm_np[b, :n].astype(np.float64) - sg.smooth3(
            rows_np[b, :n].astype(np.float64))
        e_abs = max(e_abs, float(np.abs(d).max()))
        e_adj = max(e_adj, float(np.abs(np.diff(d)).max()))
    log(f"smooth3_cuda: B={B} L={L}: {bad} of {sm_gpu.numel()} elements "
        f"differ in bits from the CPU plain version (max |diff| "
        f"{d_cpu!r}); vs f64 max abs {e_abs!r}, max adjacent-difference "
        f"{e_adj!r} (the plain version's on the card: 9.547e-05 / "
        f"1.142e-04; STRUCT_ATOL 2e-4)")
    if bad:
        raise SmokeFailure(f"smooth3_cuda differs from the CPU plain "
                           f"version in {bad} elements (max {d_cpu})")
    smooth_row, results["peak_candidates_cuda"] = smooth_peaks_row(
        dev, Rd, Sd, ld, want, combo, parent_peaks)
    results["smooth3_cuda"] = dict(max_abs_err=d_cpu, **smooth_row)

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


def profile_sass(cells_per_s: float) -> None:
    """The profile kernel's row loop from its SASS: instructions a row
    and thread by pipe and by opcode, and a cell's share (a thread holds
    16 columns of a row); beside it what the timed rate of this run's
    cells leaves a cell at four warp instructions a clock an SM (ALU and
    FMA pipes) and at two (the ALU pipe alone); and the registers and
    spills ptxas reports."""
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.tools import banded_sass
    for line in _build.build_logs.get("profile", "").splitlines():
        if "registers" in line or "spill" in line or "stack" in line:
            log(f"  profile ptxas: {line.strip()}")
    # past the kernel's first EXIT: the early return of tiles past a
    # read's end
    res = banded_sass.row_pipes(_build.sass("profile"), "profile_kernel", 1)
    per_cell = {k: res[k]["all"] / 16 for k in ("min", "max", "loop")}
    at_four = LANE_OPS_PER_S / cells_per_s
    log(f"profile row loop SASS (a row and thread, 16 cells): "
        f"{json.dumps({k: res[k] for k in ('min', 'max', 'loop')})}; "
        f"opcodes {json.dumps(res['opcodes'])}; a cell "
        f"{json.dumps(per_cell)}; the timed rate leaves {at_four:.2f} "
        f"instructions a cell at 4 a clock an SM, {at_four / 2:.2f} at 2")
    # the row loop's design: no special-register read, no block barrier,
    # no compare or select for the substitution (its two ISETP are the
    # slot's wait and the loop's end), at most 10 instructions a cell
    ops = res["opcodes"]
    banned = sorted({"S2R", "BAR", "SEL"} & set(ops))
    if banned or ops.get("ISETP", 0) > 2 or per_cell["max"] > 10:
        raise SmokeFailure(f"the profile kernel's row loop holds {banned}, "
                           f"{ops.get('ISETP', 0)} ISETP and "
                           f"{per_cell['max']} instructions a cell")


def compare_earlier(src_dir: str, name: str, prepare, current, want,
                    reps: int, sass=None) -> list:
    """``src_dir/<name>.cu`` (an earlier revision, with its headers; the
    current C signature of ``name``) built by nvcc into a temporary
    directory, its SASS handed to ``sass`` when given.  ``prepare(lib)``
    returns a launch of it (no arguments) and the tensors that launch
    writes, each held in bits to the same one of ``want``; then it and
    ``current`` are timed in turns, ``reps`` launches each: [(label, ms)]
    in the order earlier, current, current, earlier."""
    import torch

    from c3poa_tpu_torch.kernels import _build

    tmp = tempfile.mkdtemp(prefix=f"parent_{name}_")
    try:
        lib, so = build_earlier(src_dir, name, tmp)
        if sass:
            sass(_build.sass_of(so))
        earlier, outs = prepare(_build.bind(lib, _build.SIGNATURES[name]))
        earlier()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(outs, want, strict=True)):
            require_equal(f"earlier {name} output {i}", bits(a), bits(b))
        return [("earlier", cuda_time_ms(earlier, reps)),
                ("current", cuda_time_ms(current, reps)),
                ("current", cuda_time_ms(current, reps)),
                ("earlier", cuda_time_ms(earlier, reps))]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def compare_profiles(src_dir: str, Rd, Sd, ld, want, bound_ms) -> None:
    """The profile kernel of ``src_dir/profile.cu`` beside the current
    one at the locate shape (``compare_earlier``), its row loop's SASS by
    pipe logged."""
    import torch

    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.kernels.sw_profile import (start_profile_cuda,
                                                    tile_overlap)
    from c3poa_tpu_torch.tools import banded_sass

    (B, L), (C, m) = Rd.shape, Sd.shape

    def row_loop(funcs):
        res = banded_sass.row_pipes(funcs, "profile_kernel", 1)
        log(f"  earlier profile row loop SASS (a row and thread): "
            f"{json.dumps({k: res[k] for k in ('min', 'max')})}; opcodes "
            f"{json.dumps(res['opcodes'])}")

    def prepare(lib):
        out = torch.empty((B, C, L), dtype=torch.int32, device=Rd.device)

        def earlier():
            _build.launch(lib, "c3t_start_profile", "earlier_profile", Rd,
                          Rd.data_ptr(), ld.data_ptr(), Sd.data_ptr(),
                          out.data_ptr(), B, L, C, m, tile_overlap(m), 1,
                          -2, 2)
        return earlier, (out,)

    times = compare_earlier(
        src_dir, "profile", prepare,
        lambda: start_profile_cuda(Rd, Sd, ld), (want,), 10, row_loop)
    log(f"profile, earlier ({src_dir}) and current kernel, in turns: "
        f"{json.dumps(times)}; bound {bound_ms:.4f} ms")


def smooth_peaks_row(dev, Rd, Sd, ld, prof, combo, parent_peaks=()):
    """The locate step after the combo choice (``kernels/locate.py``),
    at the locate shape: the smoothing kernel through its wrapper,
    through its C interface (a run of launches the host cannot hold
    back) and by its device time (``torch.profiler``); its plain version
    (the gather, the float copy and ``smooth3_batch``); three conv1d
    passes of the same taps as a yardstick (not bit-equal: no per-read
    edge padding); the peak-candidates kernel held bit for bit to its
    plain version on the card and on the CPU, timed the same three ways
    beside it (``peaks_row``); the step with the kernels and with the
    plain versions; and one locate batch's device activities (expected
    ``LOCATE_BATCH_ACTIVITIES``).  Returns the two kernels' rows of the
    kernels line (ms through the C interface)."""
    import torch

    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.kernels.locate import locate_device
    from c3poa_tpu_torch.kernels.peaks import (masked_median,
                                               peak_candidates_batch,
                                               peak_candidates_cuda)
    from c3poa_tpu_torch.kernels.smooth import (combo_rows, smooth3_batch,
                                                smooth3_cuda, taps)

    B, C, L = prof.shape

    def plain():
        return smooth3_batch(combo_rows(prof, combo).to(torch.float32), ld)

    sm = smooth3_cuda(prof, combo, ld)
    cand = peak_candidates_batch(sm, ld, tile=64)
    out = torch.empty_like(sm)
    args = (prof.data_ptr(), combo.data_ptr(), ld.data_ptr(),
            taps().ctypes.data, out.data_ptr(), B, C, L)

    def direct():
        _build.launch("smooth", "c3t_smooth3", "smooth3_timing", prof, *args)

    ms_wrapper = cuda_time_ms(lambda: smooth3_cuda(prof, combo, ld), 20)
    ms_direct = cuda_time_ms(direct, 50)
    acts = device_activities(lambda: [direct() for _ in range(10)])
    us = [t for name, t in acts if "smooth3_kernel" in name]
    device_ms = sum(us) / len(us) / 1e3 if us else None
    plain_ms = cuda_time_ms(plain, 3)
    ms_peaks = cuda_time_ms(lambda: peak_candidates_batch(sm, ld, tile=64),
                            5)
    ms_step = cuda_time_ms(lambda: peak_candidates_cuda(
        smooth3_cuda(prof, combo, ld), ld, 64), 20)
    ms_step_plain = cuda_time_ms(lambda: peak_candidates_batch(
        plain(), ld, tile=64), 3)
    w = torch.tensor(taps(), device=dev).view(1, 1, 41)
    rows = combo_rows(prof, combo).to(torch.float32)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        def conv3():
            x = rows.view(B, 1, L)
            for _ in range(3):
                x = torch.nn.functional.conv1d(x, w, padding=20)
            return x
        ms_conv = cuda_time_ms(conv3, 20)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    step = device_activities(lambda: peak_candidates_cuda(
        smooth3_cuda(prof, combo, ld), ld, 64))
    peaks = device_activities(lambda: peak_candidates_batch(sm, ld, tile=64))
    median = device_activities(lambda: masked_median(sm, ld))
    batch = device_activities(lambda: locate_device(Rd, ld, Sd, tile=64))
    # this run's data: the columns of each read (outputs past a read are
    # zeros), its row read once, the whole (B, L) output written once
    cols = int(ld.to(torch.int64).sum())
    nbytes_needed = cols * 4 + B * L * 4 + nbytes(combo, ld) + 41 * 4
    bd = bound(nbytes_needed, OPS_PER_CELL["smooth3_cuda"] * cols,
               LANE_OPS_PER_S)
    over_all = bound(nbytes_needed, OPS_PER_CELL["smooth3_cuda"] * B * L,
                     LANE_OPS_PER_S)
    first = bound(B * L * 4 + nbytes(*cand),
                  SMOOTH_FIRST_OPS_PER_ELEMENT * B * L, F32_OPS_PER_S)
    row = dict(ms=ms_direct, ms_wrapper=ms_wrapper, device_ms=device_ms,
               plain_ms=plain_ms, library_ms=ms_conv, ms_step=ms_step,
               ms_step_plain=ms_step_plain,
               step_device_activities=len(step),
               step_device_us=sum(a[1] for a in step),
               plain_peaks_device_activities=len(peaks),
               plain_peaks_device_us=sum(a[1] for a in peaks),
               plain_median_device_us=sum(a[1] for a in median),
               locate_batch_device_activities=len(batch),
               locate_batch_device_us=sum(a[1] for a in batch),
               columns=cols, **bd)
    log(f"smoothing kernel SASS: {json.dumps(smooth_sass())} (no FFMA; "
        f"a pass's group of 8 columns is 328 FMUL and 328 FADD)")
    log(f"smoothing kernel and the step: B={B} L={L} ({cols} read "
        f"columns): {json.dumps(row)}; bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']}: {OPS_PER_CELL['smooth3_cuda']} FP32 "
        f"instructions a read column on 128 lanes an SM; the kernel at "
        f"{bd['bound_ms'] / ms_direct:.1%} of it), {over_all['bound_ms']:.4f}"
        f" ms over all B x L elements, {first['bound_ms']:.4f} ms with the "
        f"first count ({SMOOTH_FIRST_OPS_PER_ELEMENT} float operations an "
        f"element at 67 TFLOP/s, as FMAs); the timed rate leaves "
        f"{LANE_OPS_PER_S * ms_direct / 1e3 / cols:.1f} instructions a read "
        f"column at 4 a clock an SM; the kernel "
        f"{ms_conv / ms_direct:.2f}x faster than three conv1d passes")
    # a locate batch: the profile, smoothing and peak-candidates kernels
    # (one launch each) and the combo choice's torch ops; the profiler has
    # been seen to miss an activity, so a count off 10 is printed, not
    # failed
    log(f"locate batch: {len(batch)} device activities (expected "
        f"{LOCATE_BATCH_ACTIVITIES}), {sum(a[1] for a in batch)} us: "
        f"{json.dumps([name for name, _t in batch])}"
        + ("" if len(batch) == LOCATE_BATCH_ACTIVITIES else
           " -- NOT the expected count"))
    return ({k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by")},
            peaks_row(sm, ld, cand, ms_peaks, parent_peaks))


def bits(t):
    """A tensor to compare bit for bit: float32 as its int32 bits."""
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


PEAK_OUTPUTS = ("cand_pos", "cand_h", "med", "height", "gated", "deep",
                "margin")
# the peak candidates also at these batch sizes (a locate launch takes up
# to 512 reads; its last batch of a run may hold a few)
PEAK_SWEEP_B = (16, 64, 512)
# the peak-candidates kernel's cluster limits (csrc/peaks.cuh: PK_MAX_RANKS,
# PK_MAX_SHARE, PK_SHARE_ALIGN, PK_BINS)
PK_MAX_RANKS, PK_MAX_SHARE, PK_SHARE_ALIGN, PK_BINS = 8, 32768, 4096, 256


def peaks_cluster(B: int, L: int, sms: int) -> dict:
    """The cluster the peak-candidates kernel launches for B reads of L
    columns on a card of ``sms`` SMs, as csrc/peaks.cuh picks it
    (pk_default_ranks, pk_share_width, pk_smem_bytes; a test pins this
    copy to the header): ranks a read, share (columns a CTA) and dynamic
    shared memory a CTA in bytes."""
    def share(R):
        w = PK_SHARE_ALIGN
        while w < -(-L // R):
            w *= 2
        return w

    r = 1
    while r < PK_MAX_RANKS and B * r * 2 <= sms:
        r *= 2
    R = -(-L // share(max(r, -(-L // PK_MAX_SHARE))))
    S = share(R)
    # the keys, the histogram's 32 lane copies, two passes' inboxes, the
    # merged histogram, 4 scalars a rank, 3 a warp, the two halo keys
    words = S + 32 * PK_BINS + 2 * R * PK_BINS + PK_BINS + 4 * R + 3 * 16 + 2
    return dict(ranks=R, share=S, smem_bytes=4 * words)


def peaks_row(sm, ld, want, plain_ms, parent_dirs=()):
    """The peak-candidates kernel at the locate shape (tile 64): every
    output equal in bits to the plain version on the card (``want``) and
    on the CPU; timed through the wrapper, through the C interface and by
    device time (``torch.profiler``) beside the plain version
    (``plain_ms``) and the bound; its cluster (``peaks_cluster``),
    registers and spills, and SASS free of FFMA; the kernels of each of
    ``parent_dirs`` (earlier revisions, the same C entry point) held to
    the current and timed in turns with it (``compare_earlier``); then the
    same at the batch sizes of ``PEAK_SWEEP_B`` (these rows cut or
    repeated), each held to the plain version.  Returns the kernels
    line's row."""
    import torch

    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.kernels.peaks import (peak_candidates_batch,
                                               peak_candidates_cuda)

    (B, L), tile = sm.shape, 64
    sms = torch.cuda.get_device_properties(sm.device).multi_processor_count
    got = peak_candidates_cuda(sm, ld, tile)
    torch.cuda.synchronize()
    cpu = peak_candidates_batch(sm.cpu(), ld.cpu(), tile=tile)
    err = 0
    for name, a, b, c in zip(PEAK_OUTPUTS, got, want, cpu, strict=True):
        err = max(err,
                  require_equal(f"peak_candidates_cuda {name}", bits(a),
                                bits(b)),
                  require_equal(f"peak_candidates_cuda {name} (CPU plain)",
                                bits(a.cpu()), bits(c)))
    outs = [torch.empty_like(t) for t in got]
    tol = torch.empty(B, dtype=torch.float32, device=sm.device)
    args = (sm.data_ptr(), ld.data_ptr(), *(t.data_ptr() for t in outs),
            tol.data_ptr(), B, L, tile)

    def direct():
        _build.launch("peaks", "c3t_peak_candidates",
                      "peak_candidates_timing", sm, *args)

    ms_wrapper = cuda_time_ms(lambda: peak_candidates_cuda(sm, ld, tile), 50)
    ms_direct = cuda_time_ms(direct, 100)
    acts = device_activities(lambda: [direct() for _ in range(10)])
    us = [t for name, t in acts if "pk_kernel" in name]
    device_ms = sum(us) / len(us) / 1e3 if us else None

    for line in _build.build_logs.get("peaks", "").splitlines():
        if "registers" in line or "spill" in line or "stack" in line:
            log(f"  peaks ptxas: {line.strip()}")

    bd = bound(nbytes(sm, ld, *want), 0)
    sass = peaks_sass()
    row = dict(ms=ms_direct, ms_wrapper=ms_wrapper, device_ms=device_ms,
               plain_ms=plain_ms, cluster=peaks_cluster(B, L, sms), sms=sms,
               **bd)
    log(f"peak_candidates_cuda: B={B} L={L} tile={tile}: all seven outputs "
        f"equal in bits to the plain version (card and CPU); "
        f"{json.dumps(row)}; the kernel at "
        f"{bd['bound_ms'] / ms_direct:.1%} of the bound ({bd['bound_by']}); "
        f"SASS instructions {json.dumps(sass)} (no FFMA)")

    def preparing(x, lx, got_x):
        def prepare(lib):
            # its own outputs and scratch, at the shape of x
            outs = [torch.empty_like(t) for t in got_x]
            tol_x = torch.empty(x.shape[0], dtype=torch.float32,
                                device=x.device)
            return (lambda: _build.launch(
                lib, "c3t_peak_candidates", "peak_candidates_timing", x,
                x.data_ptr(), lx.data_ptr(), *(t.data_ptr() for t in outs),
                tol_x.data_ptr(), x.shape[0], L, tile)), outs
        return prepare

    for src_dir in parent_dirs:
        times = compare_earlier(src_dir, "peaks", preparing(sm, ld, got),
                                direct, got, 100)
        log(f"peak_candidates_cuda beside {src_dir}/peaks.cu, in turns "
            f"(ms): {json.dumps(times)}")

    # other batch sizes of a locate launch: these rows cut or repeated,
    # each held to the plain version, timed through the C interface (and
    # beside the earlier kernels in turns)
    for Bx in PEAK_SWEEP_B:
        reps = -(-Bx // B)
        x = sm.repeat(reps, 1)[:Bx].contiguous()
        lx = ld.repeat(reps)[:Bx].contiguous()
        got_x = peak_candidates_cuda(x, lx, tile)
        for name, a, c in zip(PEAK_OUTPUTS, got_x,
                              peak_candidates_batch(x, lx, tile=tile),
                              strict=True):
            require_equal(f"peak_candidates_cuda B={Bx} {name}", bits(a),
                          bits(c))
        current = preparing(x, lx, got_x)(_build.load("peaks"))[0]
        entry = dict(**peaks_cluster(Bx, L, sms),
                     ms=cuda_time_ms(current, 50),
                     bound_ms=bound(nbytes(x, lx, *got_x), 0)["bound_ms"])
        for src_dir in parent_dirs:
            entry[src_dir] = compare_earlier(
                src_dir, "peaks", preparing(x, lx, got_x), current, got_x,
                50)
        log(f"peak_candidates_cuda at B={Bx} L={L}: {json.dumps(entry)}")
    return dict(max_abs_err=err, ms=ms_direct, plain_ms=plain_ms,
                bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                library_ms=None)


def peaks_sass() -> dict:
    """The peak-candidates kernel's SASS instruction count; fails on an
    FFMA (a fused gate or margin would change the bits)."""
    from c3poa_tpu_torch.kernels import _build
    funcs = _build.sass("peaks")
    out = {}
    for kernel in ("pk_kernel",):
        insns = funcs[next(k for k in funcs if kernel in k)]
        fused = sum(1 for _a, i in insns
                    if _build.sass_mnemonic(i).startswith("FFMA"))
        if fused:
            raise SmokeFailure(f"{kernel}'s SASS holds {fused} FFMA")
        out[kernel] = len(insns)
    return out


def smooth_sass() -> dict:
    """The smoothing kernel's float32 arithmetic in its SASS: the count
    of each FMUL, FADD and FFMA form, of the FMULs that read their tap
    from a uniform register or the constant bank (a kernel parameter),
    and of all instructions.  Fails on an FFMA: a fused tap would change
    the bits."""
    from c3poa_tpu_torch.kernels import _build
    funcs = _build.sass("smooth")
    insns = funcs[next(k for k in funcs if "smooth3_kernel" in k)]
    ops = {}
    for _addr, insn in insns:
        op = _build.sass_mnemonic(insn)
        if op.split(".")[0] in ("FMUL", "FADD", "FFMA"):
            ops[op] = ops.get(op, 0) + 1
    fused = sum(n for op, n in ops.items() if op.startswith("FFMA"))
    if fused:
        raise SmokeFailure(f"the smoothing kernel's SASS holds {fused} FFMA")
    uniform = sum(1 for _a, i in insns
                  if _build.sass_mnemonic(i).startswith("FMUL")
                  and re.search(r"c\[|\bUR\d", i))
    return dict(instructions=len(insns), FMUL_uniform_tap=uniform, **ops)


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


def forward_bound(Qd, Td, qld, tld, fwd, W: int):
    """(cells, bound) of a forward launch: the inputs and its outputs
    ``fwd`` moved once, OPS_PER_CELL instructions a cell of each query's
    own rows on 128 lanes an SM."""
    import torch
    cells = int(qld.to(torch.int64).sum()) * W
    return cells, bound(nbytes(Qd, Td, qld, tld, *fwd),
                        OPS_PER_CELL["banded_fwd_cuda"] * cells,
                        LANE_OPS_PER_S)


def walk_bound(qld, tld, je, walk):
    """(steps a pair, bound) of a walk launch: the path's steps (non-zero
    2-bit ops), and at least one move word per 8 query rows of each path
    read beside the walk's inputs and outputs."""
    import torch
    ops = walk[2].to(torch.int32)
    per_pair = sum(((ops >> (2 * k)) & 3 != 0).sum(dim=1) for k in range(4))
    path_words = int((-(-qld.to(torch.int64) // 8)).sum()) * 4
    return per_pair, bound(nbytes(qld, tld, je, *walk) + path_words,
                           OPS_PER_CELL["banded_walk_cuda"] *
                           int(per_pair.sum()))


def phase_banded(dev, results):
    """Kernels 2 and 3 at the align shape: P = 2048, nq = 2048, W = 128;
    then both at the other scoring and band of the consensus run; the
    forward kernel's SASS instructions a row by pipe; the walk of one
    pair alone (its chain floor)."""
    import numpy as np

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
    cells, bd = forward_bound(Qd, Td, qld, tld, (sc, je, mv), W)
    first = bound(nbytes(Qd, Td, qld, tld, sc, je, mv),
                  FORWARD_RECURRENCE_OPS_PER_CELL * cells)
    log(f"banded forward: P={P} nq={nq} W={W} exact; kernel {ms:.4f} ms "
        f"({cells / ms / 1e6:.2f} G cells/s), plain {plain_ms:.3f} ms, "
        f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
        f"{OPS_PER_CELL['banded_fwd_cuda']} instructions a cell on 128 "
        f"lanes an SM; the kernel at {bd['bound_ms'] / ms:.1%} of it); "
        f"{first['bound_ms']:.4f} ms with the recurrence's count "
        f"({FORWARD_RECURRENCE_OPS_PER_CELL} on 64 lanes)")
    results["banded_fwd_cuda"] = dict(ms=ms, **checked["banded_fwd_cuda"],
                                      **bd)

    n_rem = int((walk[1] > 0).sum())
    ms = cuda_time_ms(lambda: banded_walk_cuda(mv, qld, tld, je, nq, W), 5)
    plain_ms = checked["banded_walk_cuda"]["plain_ms"]
    per_pair, bd = walk_bound(qld, tld, je, walk)
    steps = int(per_pair.sum())
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


def build_earlier(src_dir: str, name: str, tmp: str):
    """``src_dir/<name>.cu`` (an earlier revision, with its headers)
    built by nvcc into ``tmp``, its registers and spills logged: (the
    loaded library, its path)."""
    import ctypes

    from c3poa_tpu_torch.kernels import _build

    so = os.path.join(tmp, f"earlier_{name}.so")
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
         os.path.join(src_dir, f"{name}.cu")], capture_output=True,
        text=True, timeout=600)
    if done.returncode:
        raise SmokeFailure(f"earlier {name}: nvcc failed\n{done.stdout}"
                           f"{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line:
            log(f"  earlier {name} ptxas: {line.strip()}")
    return ctypes.CDLL(so), so


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

    P, I = ctypes.c_void_p, ctypes.c_int
    lib = _build.bind(build_earlier(src_dir, "adapters", tmp)[0],
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
    _, counts = consensus_run_and_numpy(
        "end-to-end", WORK, os.path.join(WORK, "out_cuda"),
        os.path.join(WORK, "out_numpy"))
    for name in CONSENSUS_KERNELS:
        results[name]["launches"] = counts[name]


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


def sm_count() -> int:
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


class LaunchLog:
    """The locate and align launches of ``TorchBackend`` while installed:
    each launch's inputs as the backend made them (``locate_device`` and
    ``banded_align_trace`` are looked up in its module at each call), so a
    phase can print their shapes and time the kernels at them after the
    run."""

    def __init__(self):
        self.locates: list = []   # (reads, lens, splints, tile)
        self.aligns: list = []    # (queries, targets, q_lens, t_lens, kw)

    def __enter__(self):
        from c3poa_tpu_torch.pipeline import torch_backend as tb
        self._tb = tb
        self._locate, self._align = tb.locate_device, tb.banded_align_trace

        def locate(r, ln, s, tile):
            self.locates.append((r, ln, s, tile))
            return self._locate(r, ln, s, tile=tile)

        def align(q, t, a, b, **kw):
            self.aligns.append((q, t, a, b, kw))
            return self._align(q, t, a, b, **kw)

        tb.locate_device, tb.banded_align_trace = locate, align
        return self

    def __exit__(self, *exc):
        self._tb.locate_device = self._locate
        self._tb.banded_align_trace = self._align


def long_read_set(path: str):
    """``stress_bigreads.make_big_dataset(path, LONG_READS)`` with the
    edge reads of ``LONG_EDGE`` added on its splint: lengths checked
    against their ranges and printed."""
    import numpy as np

    from c3poa_tpu_torch import sim
    from c3poa_tpu_torch.tools import stress_bigreads

    reads = stress_bigreads.make_big_dataset(path, LONG_READS, seed=SEED)
    splint = open(os.path.join(path, "splint.fasta")).read().split()[1]
    rng = np.random.default_rng(SEED + 6)
    for k, (lo, hi, insert_len, copies) in enumerate(LONG_EDGE):
        for j in range(2):
            r = sim.make_read(rng, f"edge_{k}_{j}", splint,
                              insert_len=insert_len, n_copies=copies,
                              error=0.05)
            log(f"edge read {r.name}: {len(r.seq)} bases ({copies} copies "
                f"of {insert_len}; range {lo}..{hi})")
            if not lo <= len(r.seq) <= hi:
                raise SmokeFailure(f"edge read {r.name} has {len(r.seq)} "
                                   f"bases, outside {lo}..{hi}")
            reads.append(r)
    sim.write_fastq(os.path.join(path, "reads.fastq"), reads)
    return reads


def consensus_run_and_numpy(what: str, path: str, out: str, out_np: str):
    """``python -m c3poa_tpu_torch.cli --backend cuda`` in-process on
    ``path``'s reads in one group, its launches counted from 0 and the
    card's peak memory read, then the numpy backend on the same reads with
    a worker a core: the three output files byte-identical, every
    consensus kernel launched.  Returns (stats, launches)."""
    import torch

    from c3poa_tpu_torch import cli
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.pipeline.backend import NumpyBackend
    from c3poa_tpu_torch.pipeline.run import PipelineConfig, run_pipeline

    reads_fq = os.path.join(path, "reads.fastq")
    splint_fa = os.path.join(path, "splint.fasta")
    n = sum(1 for _ in open(reads_fq)) // 4
    for d in (out, out_np):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.time()
    rc = cli.main(["-r", reads_fq, "-s", splint_fa, "-o", out,
                   "--backend", "cuda", "-g", str(n)])
    wall = time.time() - t0
    counts = _build.launch_counts()
    if rc != 0:
        raise SmokeFailure(f"{what}: cli exited {rc}")
    stats = json.load(open(os.path.join(out, "c3poa_stats.json")))
    log(f"{what} cuda: {n} reads in {wall:.3f} s = {n / wall:.3f} reads/s "
        f"(wall incl. set-up); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    log(f"{what} stages_s " + json.dumps(stats["stages_s"]))
    log(f"{what} counters " + json.dumps(stats["counters"]))
    log(f"{what} launches " + json.dumps(counts))
    for name in CONSENSUS_KERNELS:
        if counts.get(name, 0) <= 0:
            raise SmokeFailure(f"{what}: {name} was not launched")
    workers = os.cpu_count() or 1
    t0 = time.time()
    run_pipeline(reads_fq, splint_fa, out_np,
                 PipelineConfig(group_size=-(-n // workers),
                                num_threads=workers), NumpyBackend())
    log(f"{what} numpy arm: {n} reads, {workers} workers, "
        f"{time.time() - t0:.3f} s")
    require_same_outputs(what, out, out_np)
    log(f"{what}: {', '.join(OUTPUT_FILES)} identical to numpy's")
    return stats, counts


def time_locate_batch(log_: LaunchLog) -> None:
    """The locate launch of the widest L (the most reads among those),
    as launched: its ms and device activities beside the bound of the
    profile's and smoothing's instructions over the batch's real cells
    (the inputs read once and the outputs written once by bytes); then
    its three kernels alone at that shape, each beside its bound as in
    ``phase_profile`` and ``smooth_peaks_row``."""
    import torch

    from c3poa_tpu_torch.kernels.locate import locate_device
    from c3poa_tpu_torch.kernels.peaks import peak_candidates_cuda
    from c3poa_tpu_torch.kernels.smooth import smooth3_cuda
    from c3poa_tpu_torch.kernels.sw_profile import start_profile_cuda

    R, ld, S, tile = max(log_.locates,
                         key=lambda x: (x[0].shape[1], x[0].shape[0]))
    B, L = R.shape
    C = S.shape[0]
    cols = int(ld.to(torch.int64).sum())
    m = int((S != 4).sum(dim=1).max())
    ms = cuda_time_ms(lambda: locate_device(R, ld, S, tile=tile), 5)
    acts = device_activities(lambda: locate_device(R, ld, S, tile=tile))
    out = locate_device(R, ld, S, tile=tile)
    need = {"start_profile_cuda": OPS_PER_CELL["start_profile_cuda"] *
            cols * C * m,
            "smooth3_cuda": OPS_PER_CELL["smooth3_cuda"] * cols}
    bd = bound(nbytes(R, ld, S, *out), sum(need.values()), LANE_OPS_PER_S)
    log(f"locate batch at the widest L: B={B} C={C} L={L} m={m} ({cols} "
        f"read columns, {B * L} padded); cluster "
        f"{json.dumps(peaks_cluster(B, L, sm_count()))}; {ms:.4f} ms, "
        f"{len(acts)} device activities, {sum(t for _n, t in acts)} us; "
        f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: "
        f"{OPS_PER_CELL['start_profile_cuda']} instructions a profile cell "
        f"and {OPS_PER_CELL['smooth3_cuda']} a smoothed column on 128 lanes "
        f"an SM; the batch at {bd['bound_ms'] / ms:.1%} of it)")

    combo = out[0]
    prof = start_profile_cuda(R, S, ld)
    sm = smooth3_cuda(prof, combo, ld)
    cand = peak_candidates_cuda(sm, ld, tile)
    rows = (("start_profile_cuda", lambda: start_profile_cuda(R, S, ld),
             bound(nbytes(R, S, ld, prof), need["start_profile_cuda"],
                   LANE_OPS_PER_S)),
            ("smooth3_cuda", lambda: smooth3_cuda(prof, combo, ld),
             bound(cols * 4 + nbytes(sm, combo, ld) + 41 * 4,
                   need["smooth3_cuda"], LANE_OPS_PER_S)),
            ("peak_candidates_cuda",
             lambda: peak_candidates_cuda(sm, ld, tile),
             bound(nbytes(sm, ld, *cand), 0)))
    for name, fn, kb in rows:
        kms = cuda_time_ms(fn, 5)
        log(f"  {name} alone there: {kms:.4f} ms, bound "
            f"{kb['bound_ms']:.4f} ms ({kb['bound_by']}; the kernel at "
            f"{kb['bound_ms'] / kms:.1%} of it)")


def time_banded(log_: LaunchLog) -> None:
    """The forward and the walk at the align launch of the largest nq (its
    P, band and scoring as launched), each beside its bound as in
    ``phase_banded``."""
    from c3poa_tpu_torch.kernels.banded import (banded_fwd_cuda,
                                                banded_walk_cuda)

    Q, T, ql, tl, kw = max(log_.aligns,
                           key=lambda x: (x[0].shape[1], x[0].shape[0]))
    P, nq = Q.shape
    W = kw["band"]
    sc, je, mv = banded_fwd_cuda(Q, T, ql, tl, **kw)
    walk = banded_walk_cuda(mv, ql, tl, je, nq, W)
    ms_f = cuda_time_ms(lambda: banded_fwd_cuda(Q, T, ql, tl, **kw), 5)
    ms_w = cuda_time_ms(lambda: banded_walk_cuda(mv, ql, tl, je, nq, W), 5)
    cells, bf = forward_bound(Q, T, ql, tl, (sc, je, mv), W)
    per_pair, bw = walk_bound(ql, tl, je, walk)
    steps = int(per_pair.sum())
    log(f"banded forward at the largest nq: P={P} nq={nq} "
        f"nt={T.shape[1]} W={W} ({cells} cells): {ms_f:.4f} ms, bound "
        f"{bf['bound_ms']:.4f} ms ({bf['bound_by']}; the kernel at "
        f"{bf['bound_ms'] / ms_f:.1%} of it)")
    log(f"banded walk there: {steps} steps, {int((walk[1] > 0).sum())} "
        f"pairs out of steps: {ms_w:.4f} ms, bound {bw['bound_ms']:.4f} ms "
        f"({bw['bound_by']})")


def phase_long_reads():
    """Long and overlong reads through the consensus CLI on the card
    (ROADMAP 1.12): the set of ``long_read_set`` against the numpy
    backend; each locate launch's B, L and cluster; then one locate batch
    at the widest L and the forward and walk at the largest nq, timed at
    the shapes the run launched."""
    path = os.path.join(WORK, "long")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    t0 = time.time()
    long_read_set(path)
    log(f"long-read set: {LONG_READS} + {2 * len(LONG_EDGE)} reads in "
        f"{time.time() - t0:.3f} s")

    with LaunchLog() as launches:
        stats, _ = consensus_run_and_numpy(
            "long reads", path, os.path.join(path, "out_cuda"),
            os.path.join(path, "out_numpy"))
    c = stats["counters"]
    log(f"long reads: locate_cells_padded / real = "
        f"{c['locate_cells_padded'] / c['locate_cells_real']:.3f}")
    if c.get("overlong_reads_host_located") != 2:
        raise SmokeFailure(f"overlong_reads_host_located = "
                           f"{c.get('overlong_reads_host_located')}, not 2")
    sms = sm_count()
    for r, _ln, s, _tile in launches.locates:
        cl = peaks_cluster(r.shape[0], r.shape[1], sms)
        log(f"  locate launch B={r.shape[0]} C={s.shape[0]} L={r.shape[1]}: "
            f"cluster {json.dumps(cl)}")
    if not any(r.shape[1] > 98304 and
               peaks_cluster(r.shape[0], r.shape[1], sms)["ranks"] == 4
               for r, *_ in launches.locates):
        raise SmokeFailure("no locate launch with L > 98304 ran a cluster "
                           "of 4 ranks")
    log("  align launches (W, P, nq): " + json.dumps(
        [(a[4]["band"], *a[0].shape) for a in launches.aligns]))

    time_locate_batch(launches)
    time_banded(launches)


def head_reads(src: str, dst: str, n: int) -> None:
    """The first ``n`` reads of ``src``'s set into ``dst``: the set
    ``poa_stress.make_dataset`` writes for ``n`` reads (its reads are
    drawn one after another from one generator)."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(src, "splint.fasta"), dst)
    with open(os.path.join(src, "reads.fastq")) as fh, \
            open(os.path.join(dst, "reads.fastq"), "w") as out:
        for k, line in enumerate(fh):
            if k == 4 * n:
                break
            out.write(line)


def phase_poa_route(dev):
    """The POA route on the card (ROADMAP 1.13): ``poa_stress``'s clean
    and chimera-heavy sets (seed 3) of POA_READS reads through
    ``TorchBackend`` at the tool's group size, each beside the numpy
    backend (the heavy set in one process, as the tool runs it, so its
    ``c3poa_stats.json`` counts the routed reads): trees byte-identical,
    the heavy set's routed reads equal and at least 10% of the reads, the
    clean set's none; then the tool's interleaved rounds at
    POA_MEASURE_READS reads on the card (ratio and verdict printed, not
    gated)."""
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.pipeline.backend import NumpyBackend
    from c3poa_tpu_torch.pipeline.run import PipelineConfig, run_pipeline
    from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
    from c3poa_tpu_torch.tools import poa_stress

    root = os.path.join(WORK, "poa")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    sets = {}
    for tag, frac in (("clean", 0.0), ("heavy", 0.18)):
        big = os.path.join(root, f"{tag}_{POA_MEASURE_READS}")
        os.makedirs(big)
        poa_stress.make_dataset(big, POA_MEASURE_READS, frac, seed=3)
        sets[tag] = os.path.join(root, f"{tag}_{POA_READS}")
        head_reads(big, sets[tag], POA_READS)
    log(f"POA sets: {POA_MEASURE_READS} reads each in "
        f"{time.time() - t0:.3f} s")

    gs = min(512, max(1, POA_READS // 2))
    backend = TorchBackend(dev)
    for tag, d in sets.items():
        out, out_np = os.path.join(d, "out_cuda"), os.path.join(d, "out_np")
        _build.reset_counts()
        rps, counters = poa_stress.run_once(d, out, backend, gs)
        counts = _build.launch_counts()
        log(f"POA {tag} cuda: {rps:.3f} reads/s, {json.dumps(counters)}, "
            f"launches {json.dumps(counts)}")
        for name in CONSENSUS_KERNELS:
            if counts.get(name, 0) <= 0:
                raise SmokeFailure(f"POA {tag}: {name} was not launched")
        routed = counters.get("poa_fallback_reads", 0)
        t0 = time.time()
        if tag == "heavy":
            _, want = poa_stress.run_once(d, out_np, NumpyBackend(), gs)
            if want.get("poa_fallback_reads") != routed or \
                    routed < 0.1 * POA_READS:
                raise SmokeFailure(
                    f"POA heavy: {routed} reads routed on the card, "
                    f"{want.get('poa_fallback_reads')} by numpy, of "
                    f"{POA_READS} (at least 10% required)")
        else:
            workers = os.cpu_count() or 1
            run_pipeline(os.path.join(d, "reads.fastq"),
                         os.path.join(d, "splint.fasta"), out_np,
                         PipelineConfig(group_size=-(-POA_READS // workers),
                                        num_threads=workers),
                         NumpyBackend())
            if routed:
                raise SmokeFailure(f"POA clean: {routed} reads routed")
        log(f"POA {tag} numpy arm: {time.time() - t0:.3f} s")
        require_same_outputs(f"POA {tag}", out, out_np)
        log(f"POA {tag}: {routed} of {POA_READS} reads routed; "
            f"{', '.join(OUTPUT_FILES)} identical to numpy's")

    res = poa_stress.measure(
        os.path.join(root, f"clean_{POA_MEASURE_READS}"),
        os.path.join(root, f"heavy_{POA_MEASURE_READS}"),
        POA_MEASURE_READS, POA_ROUNDS, backend)
    log(f"POA route, {POA_MEASURE_READS} reads, {POA_ROUNDS} rounds on the "
        f"card: medians clean {res['median_clean']:.3f} vs heavy "
        f"{res['median_heavy']:.3f} reads/s -> {res['ratio']:.3f}x (routed "
        f"{res['routed']}/{POA_MEASURE_READS}); target (>=10% routed, <20% "
        f"loss): {'MET' if res['met'] else 'NOT MET'} (recorded, not gated)")


def tree_bytes(root: str) -> dict:
    """{relative path: bytes} of every output file under ``root``."""
    tree = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            if not f.startswith("."):
                p = os.path.join(d, f)
                tree[os.path.relpath(p, root)] = open(p, "rb").read()
    return tree


def phase_postprocess_end_to_end(results, walls):
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
        wall = walls["postprocess"] = time.time() - t0
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


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_processes(cmds, logs, env) -> tuple[float, float]:
    """Start every command (output to its log file), wait for all, each
    within PROCESS_TIMEOUT, and kill whatever is left if one fails or
    hangs.  Returns (the time of the first start, the seconds from it to
    the last exit)."""
    procs = []
    t0 = time.time()
    try:
        for cmd, path in zip(cmds, logs):
            with open(path, "w") as fh:
                procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                              stdout=fh,
                                              stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=PROCESS_TIMEOUT)
        wall = time.time() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, path in zip(procs, logs):
        if p.returncode != 0:
            tail = open(path).read()[-3000:]
            raise SmokeFailure(f"{' '.join(p.args[:4])}... exited "
                               f"{p.returncode}:\n{tail}")
    return t0, wall


def require_same_outputs(what: str, out: str, ref: str) -> None:
    for rel in OUTPUT_FILES:
        a = open(os.path.join(out, rel), "rb").read()
        b = open(os.path.join(ref, rel), "rb").read()
        if a != b:
            raise SmokeFailure(f"{what}: {rel} differs from the numpy "
                               f"backend's")


def phase_processes(walls):
    """The consensus CLI on the 1000 reads in 8 groups as 1, 2, 4 and 8
    processes sharing the card (gloo over localhost; each process its
    round-robin share of the groups, host 0 merging): wall from the
    first start to the last exit; for each process its set-up (start to
    its first line, imports, CUDA context), the CLI's seconds and CPU
    seconds, its run's reads_per_sec and stage seconds, kernel launches
    and peak device memory; the share of the machine's cores the
    processes kept busy.  Each merged tree must equal the numpy arm of
    ``phase_end_to_end``."""
    reads_fq = os.path.join(WORK, "reads.fastq")
    splint_fa = os.path.join(WORK, "splint.fasta")
    out_np = os.path.join(WORK, "out_numpy")
    # every process is on this machine: gloo talks over the loopback
    env = dict(os.environ, C3POA_PROGRESS="0", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=ROOT)
    log(f"process sweep: {N_READS} reads, -g {SWEEP_GROUP} "
        f"({-(-N_READS // SWEEP_GROUP)} groups), every process on cuda:0 "
        f"(no MPS); os.cpu_count() = {os.cpu_count()}")
    for n in SWEEP:
        out = os.path.join(WORK, f"out_procs{n}")
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        multi = ["--coordinator", f"localhost:{free_port()}",
                 "--num_processes", str(n)] if n > 1 else []
        cmds, logs, reports = [], [], []
        for h in range(n):
            reports.append(os.path.join(out, f".process_{h}.json"))
            logs.append(os.path.join(out, f".process_{h}.log"))
            cmds.append([sys.executable, os.path.abspath(__file__),
                         "--cli-process", reports[-1], "-r", reads_fq,
                         "-s", splint_fa, "-o", out, "--backend", "cuda",
                         "-g", str(SWEEP_GROUP), *multi,
                         *(["--process_id", str(h)] if n > 1 else [])])
        t0, wall = run_processes(cmds, logs, env)
        walls[f"processes_{n}"] = wall
        require_same_outputs(f"{n} processes", out, out_np)
        rows = []
        for h in range(n):
            rep = json.load(open(reports[h]))
            host = os.path.join(out, f"host_{h}") if n > 1 else out
            stats = json.load(open(os.path.join(host, "c3poa_stats.json")))
            c = stats["counters"]
            if c.get("locate_launches", 0) <= 0 or \
                    c.get("align_launches", 0) <= 0:
                raise SmokeFailure(f"{n} processes: process {h} made no "
                                   f"locate or align launch ({c})")
            for name in CONSENSUS_KERNELS:
                if rep["launches"].get(name, 0) <= 0:
                    raise SmokeFailure(f"{n} processes: process {h} did "
                                       f"not launch {name}")
            rows.append(dict(process=h, reads=c["reads"],
                             reads_per_sec=stats.get("reads_per_sec"),
                             start_s=round(rep["entered"] - t0, 3),
                             import_s=round(rep["import_s"], 3),
                             context_s=round(rep["context_s"], 3),
                             cli_s=round(rep["cli_s"], 3),
                             run_wall_s=stats["wall_s"],
                             cpu_s=round(rep["cpu_s"], 3),
                             peak_device_mb=round(
                                 rep["max_memory_allocated"] / 2 ** 20, 1),
                             stages_s=stats["stages_s"],
                             launches=rep["launches"]))
        runs = max(r["run_wall_s"] for r in rows)
        busy = sum(r["cpu_s"] for r in rows) / ((os.cpu_count() or 1) * wall)
        log(f"processes {n}: {N_READS} reads in {wall:.3f} s = "
            f"{N_READS / wall:.3f} reads/s (wall from the first start to "
            f"the last exit, set-up included); {N_READS / runs:.3f} reads/s "
            f"over the slowest run ({runs:.3f} s); the processes' CPU time "
            f"in their CLI calls {busy:.1%} of the machine's cores over the "
            f"wall; merged tree identical to numpy; {json.dumps(rows)}")


def cli_process(report: str, argv) -> int:
    """One process of ``phase_processes`` and ``phase_resume``: the
    consensus CLI on ``argv`` after the card's context is made, then into
    ``report`` the time this function was entered, the seconds of the
    imports, of the context and of the CLI call, the CLI's CPU seconds
    (all threads), its kernel launches (counted from 0 here) and peak
    device memory.  The report is also rewritten every REPORT_EVERY_S
    while the CLI runs (``rc`` null), so a process killed mid-run leaves
    its launches so far."""
    import resource
    import threading
    entered = time.time()
    import torch
    sys.path.insert(0, ROOT)
    from c3poa_tpu_torch import cli
    from c3poa_tpu_torch.kernels import _build
    imported = time.time()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.time()
    ru = resource.getrusage(resource.RUSAGE_SELF)

    def write(rc):
        ru2 = resource.getrusage(resource.RUSAGE_SELF)
        with open(report + ".tmp", "w") as fh:
            json.dump(dict(rc=rc, entered=entered,
                           import_s=imported - entered,
                           context_s=t0 - imported, cli_s=time.time() - t0,
                           cpu_s=(ru2.ru_utime + ru2.ru_stime) -
                           (ru.ru_utime + ru.ru_stime),
                           launches=_build.launch_counts(),
                           max_memory_allocated=(
                               torch.cuda.max_memory_allocated())), fh)
        os.replace(report + ".tmp", report)

    stop = threading.Event()

    def progress():
        while not stop.wait(REPORT_EVERY_S):
            write(None)

    reporter = threading.Thread(target=progress, daemon=True)
    reporter.start()
    try:
        rc = cli.main(argv)
    finally:
        stop.set()
        reporter.join()
    write(rc)
    return rc


def read_json(path: str):
    """The JSON in ``path``, or None while it is missing or half
    written."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def supervised(what: str, cmd, env, log_path: str) -> tuple[float, int]:
    """Runs ``cmd`` (a CLI under ``--rss-restart-mb 1``) to its end
    within RESUME_TIMEOUT; requires exit 0 and at least RESUME_RESTARTS
    restarts.  Returns (wall seconds, sessions)."""
    t0 = time.time()
    with open(log_path, "w") as fh:
        try:
            rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=fh,
                                stderr=subprocess.STDOUT,
                                timeout=RESUME_TIMEOUT).returncode
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"{what}: still running after "
                               f"{RESUME_TIMEOUT} s") from None
    wall = time.time() - t0
    text = open(log_path).read()
    if rc != 0:
        raise SmokeFailure(f"{what}: exited {rc}:\n{text[-3000:]}")
    found = re.findall(r"rss supervisor: (\d+) restart\(s\)", text)
    restarts = int(found[-1]) if found else 0
    if restarts < RESUME_RESTARTS:
        raise SmokeFailure(f"{what}: {restarts} restart(s), fewer than "
                           f"{RESUME_RESTARTS}:\n{text[-3000:]}")
    return wall, restarts + 1


def phase_resume(walls):
    """Durability on the card, three runs against the numpy arms:
    (a) the consensus CLI at ``-g 125`` with ``--resume``, in a session
    of its own through ``--cli-process``, SIGKILLed once its manifest
    records 2 groups and its report shows every consensus kernel
    launched, then run again to its end: the tree equals numpy's, and
    both sessions launched every consensus kernel; (b) the consensus CLI
    at ``-g 250`` under ``--rss-restart-mb 1`` (a restart after every
    group); (c) the postprocess CLI at ``-g 500`` under
    ``--rss-restart-mb 1``.  Prints each run's wall, its sessions and the
    wall a session beside the uninterrupted runs' walls."""
    import signal

    reads_fq = os.path.join(WORK, "reads.fastq")
    splint_fa = os.path.join(WORK, "splint.fasta")
    out_np = os.path.join(WORK, "out_numpy")
    env = dict(os.environ, C3POA_PROGRESS="0", PYTHONPATH=ROOT)
    cold = walls["processes_1"]

    # (a) kill -9 after 2 groups, then --resume to the end
    out = os.path.join(WORK, "out_resume")
    shutil.rmtree(out, ignore_errors=True)
    args = ["-r", reads_fq, "-s", splint_fa, "-o", out, "--backend", "cuda",
            "-g", str(SWEEP_GROUP), "--resume"]
    groups = -(-N_READS // SWEEP_GROUP)
    reports = [os.path.join(WORK, f"resume_session_{k}.json")
               for k in (0, 1)]
    logs = [os.path.join(WORK, f"resume_session_{k}.log") for k in (0, 1)]
    for path in reports:
        if os.path.exists(path):
            os.remove(path)
    manifest = os.path.join(out, ".c3poa_progress.json")
    t0 = time.time()
    with open(logs[0], "w") as fh:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--cli-process", reports[0], *args],
                                cwd=ROOT, env=env, stdout=fh,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    try:
        while True:
            if proc.poll() is not None:
                raise SmokeFailure(
                    f"resume: the first session exited "
                    f"{proc.returncode} before the kill:\n"
                    f"{open(logs[0]).read()[-3000:]}")
            if time.time() - t0 > PROCESS_TIMEOUT:
                raise SmokeFailure("resume: no 2 groups recorded within "
                                   f"{PROCESS_TIMEOUT} s")
            done = (read_json(manifest) or {}).get("groups_done", 0)
            rep = read_json(reports[0]) or {}
            if done >= 2 and all(rep.get("launches", {}).get(k, 0) > 0
                                 for k in CONSENSUS_KERNELS):
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=60)
                break
            time.sleep(0.02)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    killed_wall = time.time() - t0
    at_kill = read_json(manifest)["groups_done"]
    if proc.returncode != -signal.SIGKILL or at_kill >= groups:
        raise SmokeFailure(f"resume: the kill did not land mid-run (exit "
                           f"{proc.returncode}, {at_kill} of {groups} "
                           f"groups)")
    first = read_json(reports[0])
    _, resumed_wall = run_processes(
        [[sys.executable, os.path.abspath(__file__), "--cli-process",
          reports[1], *args]], logs[1:], env)
    require_same_outputs("resume", out, out_np)
    rows = []
    for k, rep in enumerate((first, read_json(reports[1]))):
        for name in CONSENSUS_KERNELS:
            if rep["launches"].get(name, 0) <= 0:
                raise SmokeFailure(f"resume: session {k} did not launch "
                                   f"{name}")
        rows.append(dict(session=k, rc=rep["rc"],
                         import_s=round(rep["import_s"], 3),
                         context_s=round(rep["context_s"], 3),
                         cli_s=round(rep["cli_s"], 3),
                         max_memory_allocated_mb=round(
                             rep["max_memory_allocated"] / 2 ** 20, 1),
                         launches=rep["launches"]))
    wall = killed_wall + resumed_wall
    log(f"resume (a): -g {SWEEP_GROUP}, SIGKILL after {at_kill} of {groups} "
        f"groups at {killed_wall:.3f} s, resumed in {resumed_wall:.3f} s; "
        f"{wall:.3f} s over 2 sessions = {wall / 2:.3f} s a session "
        f"(one cold process, uninterrupted: {cold:.3f} s); tree identical "
        f"to numpy; sessions (the first as its report stood at the kill) "
        f"{json.dumps(rows)}")

    # (b) the consensus CLI restarting after every group
    out = os.path.join(WORK, "out_restart")
    shutil.rmtree(out, ignore_errors=True)
    wall, sessions = supervised(
        "rss restart (b)",
        [sys.executable, "-m", "c3poa_tpu_torch.cli", "-r", reads_fq,
         "-s", splint_fa, "-o", out, "--backend", "cuda", "-g",
         str(RESUME_GROUP), "--rss-restart-mb", "1"], env,
        os.path.join(WORK, "restart_consensus.log"))
    require_same_outputs("rss restart (b)", out, out_np)
    log(f"rss restart (b): -g {RESUME_GROUP}, {sessions} sessions in "
        f"{wall:.3f} s = {wall / sessions:.3f} s a session, "
        f"{(wall - cold) / (sessions - 1):.3f} s a restart over one cold "
        f"process uninterrupted ({cold:.3f} s); tree identical to numpy; "
        f"the last session's counters (it finds every group done) "
        f"{json.dumps(json.load(open(os.path.join(out, 'c3poa_stats.json')))['counters'])}")
    done = re.findall(r"after group (\d+); exiting",
                      open(os.path.join(WORK, "restart_consensus.log")).read())
    want = [str(g) for g in range(1, -(-N_READS // RESUME_GROUP) + 1)]
    if done != want:
        raise SmokeFailure(f"rss restart (b): sessions ended after groups "
                           f"{done}, not one each of {want}")

    # (c) the postprocess CLI restarting after every group
    out = os.path.join(WORK, "post_restart")
    shutil.rmtree(out, ignore_errors=True)
    wall, sessions = supervised(
        "postprocess rss restart (c)",
        [sys.executable, "-m", "c3poa_tpu_torch.cli_postprocess",
         "-i", os.path.join(WORK, "post_in.fasta"),
         "-a", os.path.join(WORK, "adapters.fasta"),
         "-x", os.path.join(WORK, "indexes.fasta"), "-o", out, "-t",
         "--backend", "cuda", "-g", str(POST_RESUME_GROUP),
         "--rss-restart-mb", "1"], env,
        os.path.join(WORK, "restart_postprocess.log"))
    if tree_bytes(out) != tree_bytes(os.path.join(WORK, "post_numpy")):
        raise SmokeFailure("postprocess rss restart (c): the tree differs "
                           "from the numpy backend's")
    log(f"postprocess rss restart (c): -g {POST_RESUME_GROUP}, {sessions} "
        f"sessions in {wall:.3f} s = {wall / sessions:.3f} s a session "
        f"(the in-process uninterrupted run: {walls['postprocess']:.3f} "
        f"s); tree identical to numpy")


def phase_mesh(dev, results):
    """The consensus and postprocess runs through ``TorchBackend`` with
    ``devices=[cuda:0] * n``: every launch cut into n shares, each on a
    stream of its own, on the one card, in turns with one device (n = 1,
    2, 3, 1).  Byte-identical to the numpy arms; each kernel launched at
    least n times as often as in the one-device runs of the CLI."""
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.pipeline.postprocess import (PostprocessConfig,
                                                      run_postprocess)
    from c3poa_tpu_torch.pipeline.run import PipelineConfig, run_pipeline
    from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend

    import torch
    first = torch.device(dev.type, 0)
    log(f"mesh: devices = ['{first}'] * n, n streams of the one card; no "
        f"second card was used")
    for n in MESH_SHARES:
        backend = TorchBackend(str(first), devices=[first] * n)
        out = os.path.join(WORK, f"out_mesh{n}")
        shutil.rmtree(out, ignore_errors=True)
        _build.reset_counts()
        t0 = time.time()
        run_pipeline(os.path.join(WORK, "reads.fastq"),
                     os.path.join(WORK, "splint.fasta"), out,
                     PipelineConfig(group_size=N_READS), backend)
        wall = time.time() - t0
        counts = _build.launch_counts()
        require_same_outputs(f"mesh {n}", out, os.path.join(WORK,
                                                            "out_numpy"))
        post = os.path.join(WORK, f"post_mesh{n}")
        shutil.rmtree(post, ignore_errors=True)
        _build.reset_counts()
        t0 = time.time()
        run_postprocess(os.path.join(WORK, "post_in.fasta"), post,
                        os.path.join(WORK, "adapters.fasta"),
                        os.path.join(WORK, "indexes.fasta"),
                        PostprocessConfig(trim=True), backend)
        post_wall = time.time() - t0
        counts.update(_build.launch_counts())
        if tree_bytes(post) != tree_bytes(os.path.join(WORK, "post_numpy")):
            raise SmokeFailure(f"mesh {n}: the postprocess tree differs "
                               f"from the numpy backend's")
        for name in CONSENSUS_KERNELS + POST_KERNELS:
            if counts.get(name, 0) < n * results[name]["launches"]:
                raise SmokeFailure(
                    f"mesh {n}: {name} launched {counts.get(name, 0)} "
                    f"times, one device {results[name]['launches']}")
        n_post = sum(1 for line in open(os.path.join(WORK, "post_in.fasta"))
                     if line.startswith(">"))
        log(f"mesh {n}: consensus {N_READS} reads in {wall:.3f} s = "
            f"{N_READS / wall:.3f} reads/s, postprocess {n_post} reads in "
            f"{post_wall:.3f} s = {n_post / post_wall:.3f} reads/s, both "
            f"identical to numpy; launches {json.dumps(counts)} (one "
            f"device: "
            f"{json.dumps({k: results[k]['launches'] for k in CONSENSUS_KERNELS + POST_KERNELS})})")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--cli-process"]:
        return cli_process(argv[1], argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-adapters", metavar="DIR",
                    help="an earlier adapters.cu (with its adapters.cuh) "
                         "to time beside the current kernel")
    ap.add_argument("--parent-profile", metavar="DIR", action="append",
                    default=[],
                    help="an earlier profile.cu (with its headers) to time "
                         "beside the current kernel (may be repeated)")
    ap.add_argument("--parent-peaks", metavar="DIR", action="append",
                    default=[],
                    help="an earlier peaks.cu (with its headers) to time "
                         "beside the current kernel (may be repeated)")
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
    walls = {}
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
                (phase_profile, (dev, reads, splints, results,
                                 opts.parent_profile, opts.parent_peaks)),
                (phase_banded, (dev, results)),
                (phase_adapters, (dev, results, opts.parent_adapters)),
                (phase_probes, (dev, results)),
                (phase_end_to_end, (results,)),
                (phase_processes, (walls,)),
                (phase_host_routes, (dev,)),
                (phase_long_reads, ()),
                (phase_poa_route, (dev,)),
                (phase_postprocess_end_to_end, (results, walls)),
                (phase_resume, (walls,)),
                (phase_mesh, (dev, results))):
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

    # no PyTorch call computes the DPs or probes: library_ms is null but
    # for the smoothing (three conv1d passes of its taps)
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=results[k]["launches"],
                    max_abs_err=results[k]["max_abs_err"],
                    ms=results[k]["ms"], plain_ms=results[k]["plain_ms"],
                    bound_ms=results[k]["bound_ms"],
                    bound_by=results[k]["bound_by"],
                    library_ms=results[k].get("library_ms"))
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
