#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, nvcc and the
repo's Python dependencies (no JAX needed or imported):

1. prints the card and its power limit;
2. builds the port's CUDA kernels from ``c3poa_tpu_torch/kernels/csrc``;
3. runs each kernel and its plain torch version on the card, on the same
   inputs at the shapes of the consensus run, requires every int32 output
   to be equal, and times both with CUDA events;
4. runs ``python -m c3poa_tpu_torch.cli --backend cuda`` in-process on
   1000 simulated reads of the bench's shape, requires every kernel to
   have launched during that run, and requires its output files to equal
   the numpy backend's byte for byte;
5. prints one JSON line with the kernels, the ``nvidia-smi`` line, and
   last the ``{"ok": true, "device": ...}`` line.

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

# the TPU kernel each CUDA kernel replaces
KERNELS = {
    "start_profile_cuda": ("c3poa_tpu_torch/kernels/csrc/profile.cu",
                           "c3poa_tpu/kernels/pallas_profile.py:138"),
    "banded_fwd_cuda": ("c3poa_tpu_torch/kernels/csrc/banded.cu",
                        "c3poa_tpu/kernels/pallas_banded.py:469"),
    "banded_walk_cuda": ("c3poa_tpu_torch/kernels/csrc/banded.cu",
                         "c3poa_tpu/kernels/banded.py:288"),
}
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
    from c3poa_tpu import sim
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

    from c3poa_tpu.pipeline.backend import Combo
    from c3poa_tpu.ref import sg
    from c3poa_tpu.utils import encode, revcomp_encoded
    from c3poa_tpu_torch.kernels.smooth import smooth3_batch
    from c3poa_tpu_torch.kernels.sw_profile import (start_profile_batch,
                                                    start_profile_cuda)
    from c3poa_tpu_torch.state import splint_array, to_device

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
    log(f"profile: B={B} C={S_np.shape[0]} L={L} m={S_np.shape[1]} exact; "
        f"kernel {ms:.3f} ms ({cells / ms / 1e6:.1f} G cells/s), "
        f"plain {plain_ms:.3f} ms")
    results["start_profile_cuda"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=plain_ms)

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

    from c3poa_tpu import sim
    from c3poa_tpu.utils import encode
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


def phase_banded(dev, results):
    """Kernels 2 and 3 at the align shape: P = 2048, nq = 2048, W = 128."""
    import numpy as np
    import torch

    from c3poa_tpu_torch.kernels.banded import (banded_align_batch,
                                                banded_fwd_cuda,
                                                banded_walk_batch,
                                                banded_walk_cuda)
    from c3poa_tpu_torch.state import to_device

    P, nq, W = 2048, 2048, 128
    Q, T, ql, tl = make_pairs(P, nq, np.random.default_rng(SEED + 1))
    Qd, Td, qld, tld = (to_device(a, dev) for a in (Q, T, ql, tl))
    sc, je, mv = banded_fwd_cuda(Qd, Td, qld, tld, band=W)
    sc0, je0, mv0 = banded_align_batch(Qd, Td, qld, tld, band=W)
    torch.cuda.synchronize()
    require_equal("banded_fwd_cuda score", sc, sc0)
    require_equal("banded_fwd_cuda j_end", je, je0)
    err = require_equal("banded_fwd_cuda moves", mv, mv0)
    ms = cuda_time_ms(lambda: banded_fwd_cuda(Qd, Td, qld, tld, band=W), 5)
    plain_ms = cuda_time_ms(
        lambda: banded_align_batch(Qd, Td, qld, tld, band=W), 1)
    cells = int(ql.astype(np.int64).sum()) * W
    log(f"banded forward: P={P} nq={nq} W={W} exact; kernel {ms:.3f} ms "
        f"({cells / ms / 1e6:.2f} G cells/s), plain {plain_ms:.3f} ms")
    results["banded_fwd_cuda"] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms)

    walk = banded_walk_cuda(mv, qld, tld, je, nq, W)
    walk0 = banded_walk_batch(mv, qld, tld, je, nq, W)
    torch.cuda.synchronize()
    for name, a, b in zip(("j_start", "i_rem", "ops", "edge"), walk, walk0):
        err = require_equal(f"banded_walk_cuda {name}", a, b)
    n_rem = int((walk[1] > 0).sum())
    ms = cuda_time_ms(lambda: banded_walk_cuda(mv, qld, tld, je, nq, W), 5)
    plain_ms = cuda_time_ms(
        lambda: banded_walk_batch(mv, qld, tld, je, nq, W), 1)
    log(f"banded walk: P={P} exact ({n_rem} pairs out of steps); kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    results["banded_walk_cuda"] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms)


def phase_end_to_end(results):
    """The consensus run through the CLI on the card, then the numpy
    backend on the same reads; outputs must be byte-identical."""
    from c3poa_tpu import native
    from c3poa_tpu.pipeline.backend import NumpyBackend
    from c3poa_tpu.pipeline.run import PipelineConfig, run_pipeline
    from c3poa_tpu_torch import cli
    from c3poa_tpu_torch.kernels import _build

    reads_fq = os.path.join(WORK, "reads.fastq")
    splint_fa = os.path.join(WORK, "splint.fasta")
    out_cuda = os.path.join(WORK, "out_cuda")
    out_np = os.path.join(WORK, "out_numpy")
    for d in (out_cuda, out_np):
        shutil.rmtree(d, ignore_errors=True)
    log(f"native library available: {native.available()}")

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
    for name in KERNELS:
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

    t0 = time.time()
    built = _build.build_all()
    log(f"kernels built in {time.time() - t0:.3f} s: {built}")
    for lib, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {lib}: {line.strip()}")

    results = {k: {} for k in KERNELS}
    try:
        t0 = time.time()
        reads, splints = make_dataset()
        log(f"dataset: {len(reads)} reads in {time.time() - t0:.3f} s")
        phase_profile(dev, reads, splints, results)
        phase_banded(dev, results)
        phase_end_to_end(results)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    if "jax" in sys.modules:
        print("chip_smoke: FAILED: jax was imported", file=sys.stderr)
        return 1

    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=results[k]["launches"],
                    max_abs_err=results[k]["max_abs_err"],
                    ms=results[k]["ms"], plain_ms=results[k]["plain_ms"])
               for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
