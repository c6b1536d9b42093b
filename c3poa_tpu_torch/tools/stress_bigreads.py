#!/usr/bin/env python3
"""Bucket-ladder stress: long reads, high copy counts (SURVEY §5), on
the port: a copy of ``tools/stress_bigreads.py`` that runs
``c3poa_tpu_torch``'s pipeline on the card.

Generates the survey's long-context envelope — inserts up to ~5 kb,
up to 30 copies, raw reads up to ~50 kb+ — runs the full pipeline twice
on the selected backend, and reports reads/s plus the launch, padding
and host-route counters from c3poa_stats.json.

Usage: python -m c3poa_tpu_torch.tools.stress_bigreads [n_reads] [backend]

backend: cuda (the default; the card, no fallback), cpu (the plain torch
versions) or numpy (the port's NumpyBackend).
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

from .. import sim
from ..pipeline.run import PipelineConfig, run_pipeline

# tools/stress_bigreads.py:81-82 prints the compile-shape counters, which
# the port has none of: these take their place
COUNTERS = ("locate_launches", "locate_cells_real", "locate_cells_padded",
            "overlong_reads_host_located", "align_overlong_host",
            "align_band_escalated", "align_rewalk")


def make_big_dataset(path, n_reads, seed=0):
    rng = np.random.default_rng(seed)
    splints = {"Splint1": sim.random_seq(rng, 284)}
    reads = []
    for i in range(n_reads):
        insert_len = int(rng.integers(1000, 5000))
        # cap raw length near ~60 kb
        max_copies = max(2, min(30, 55000 // (insert_len + 284)))
        copies = int(rng.integers(2, max_copies + 1))
        reads.append(sim.make_read(
            rng, f"big_{i}", splints["Splint1"], insert_len=insert_len,
            n_copies=copies, error=0.05))
    sim.write_fastq(os.path.join(path, "reads.fastq"), reads)
    sim.write_fasta(os.path.join(path, "splint.fasta"), splints)
    lens = [len(r.seq) for r in reads]
    cps = [r.n_copies for r in reads]
    print(f"reads: n={n_reads} len {min(lens)}..{max(lens)} "
          f"(mean {sum(lens) // n_reads}), copies {min(cps)}..{max(cps)}",
          flush=True)
    return reads


def make_backend(backend_name):
    # tools/stress_bigreads.py:49-54 builds the JAX package's backends
    if backend_name == "numpy":
        from ..pipeline.backend import NumpyBackend
        return NumpyBackend()
    if backend_name not in ("cuda", "cpu"):
        raise ValueError(f"backend {backend_name!r} (cuda, cpu or numpy)")
    from ..pipeline.torch_backend import TorchBackend
    return TorchBackend(backend_name)


def run(path, out, backend):
    t0 = time.time()
    stats = run_pipeline(os.path.join(path, "reads.fastq"),
                         os.path.join(path, "splint.fasta"), out,
                         PipelineConfig(), backend)
    dt = time.time() - t0
    st = json.load(open(os.path.join(out, "c3poa_stats.json")))
    return stats, dt, st


def main(n_reads=128, backend="cuda"):
    with tempfile.TemporaryDirectory() as d:
        make_big_dataset(d, n_reads)
        be = make_backend(backend)  # shared: the second run is warm
        s1, dt1, st1 = run(d, os.path.join(d, "o1"), be)
        s2, dt2, st2 = run(d, os.path.join(d, "o2"), be)
        for tag, s, dt, st in (("warm", s1, dt1, st1),
                               ("steady", s2, dt2, st2)):
            c = st["counters"]
            pad = c.get("align_cells_padded", 0)
            real = max(c.get("align_cells", 1), 1)
            # tools/stress_bigreads.py:81-82: COUNTERS in place of the
            # compile-shape counters
            print(f"{tag}: {s.consensus_written}/{s.total_reads} consensi, "
                  f"{dt:.1f}s = {s.total_reads / dt:.1f} reads/s; "
                  f"stages {st['stages_s']}; "
                  + " ".join(f"{k}={c.get(k, 0)}" for k in COUNTERS)
                  + f" align_pad_ratio={pad / real:.2f}", flush=True)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    b = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    main(n, b)
