#!/usr/bin/env python3
"""Chimera-heavy throughput stress for the POA fallback path, on the
port: a copy of ``tools/poa_stress.py`` that runs ``c3poa_tpu_torch``'s
pipeline on the card.

Round-4 verdict item 2's done-criterion: a workload with >= 10% of reads
divergence-routed to the POA graph path must lose < 20% throughput
versus the same workload with 0% routed, with identical outputs for the
non-routed reads.  This tool builds two same-shaped datasets (clean vs
~10% chimeric reads), runs both through the full pipeline on the same
backend in one process (interleaved rounds, pipe_ab measurement rules),
and reports the ratio plus the routed-read counters.

Usage: python -m c3poa_tpu_torch.tools.poa_stress [n_reads=2048]
    [rounds=3] [backend=cuda]

backend: cuda (the card, no fallback), cpu (the plain torch versions) or
numpy (the port's NumpyBackend).
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

from .. import sim
from ..pipeline.run import PipelineConfig, run_pipeline
from ..utils.seqs import array_to_phred


def make_chimeric_read(rng, name, splint, insert_len, n_copies, error,
                       chimera_frac=0.7):
    """An R2C2 concatemer where ``chimera_frac`` of the copies are
    chimeric (true head + foreign tail) — the structure the divergence
    detector routes (ConsensusParams.poa_fallback)."""
    sub, ins, dele = error * 0.5, error * 0.25, error * 0.25
    insert = sim.random_seq(rng, insert_len)
    parts = [sim.mutate(rng, insert[-insert_len // 2:], sub, ins, dele)]
    for c in range(n_copies):
        parts.append(sim.mutate(rng, splint, sub, ins, dele))
        if rng.random() < chimera_frac:
            body = insert[:int(insert_len * 0.6)] + \
                sim.random_seq(rng, int(insert_len * 0.5))
        else:
            body = insert
        parts.append(sim.mutate(rng, body, sub, ins, dele))
    parts.append(sim.mutate(rng, splint, sub, ins, dele))
    parts.append(sim.mutate(rng, insert[:insert_len // 2], sub, ins, dele))
    seq = "".join(parts)
    if rng.random() < 0.5:
        seq = sim.revcomp(seq) if hasattr(sim, "revcomp") else seq
    q = np.clip(rng.normal(20, 4, size=len(seq)), 2, 40).astype(np.int8)
    # tools/poa_stress.py:51 imports array_to_phred here, from the JAX
    # package's utils
    return sim.SimRead(name=name, seq=seq, qual=array_to_phred(q),
                       insert=insert, splint_name="Splint1", strand="+",
                       n_copies=n_copies)


def make_dataset(path, n_reads, chimera_read_frac, seed=0):
    rng = np.random.default_rng(seed)
    splints = {"Splint1": sim.random_seq(rng, sim.DEFAULT_SPLINT_LEN)}
    reads = []
    for i in range(n_reads):
        il = int(rng.integers(800, 1200))
        nc = int(rng.integers(5, 9))
        if rng.random() < chimera_read_frac:
            reads.append(make_chimeric_read(
                rng, f"simread_{i}", splints["Splint1"], il, nc, 0.05))
        else:
            reads.append(sim.make_read(
                rng, f"simread_{i}", splints["Splint1"],
                insert_len=il, n_copies=nc, error=0.05))
    sim.write_fastq(os.path.join(path, "reads.fastq"), reads)
    sim.write_fasta(os.path.join(path, "splint.fasta"), splints)


def run_once(d, out, backend, gs):
    t0 = time.time()
    stats = run_pipeline(os.path.join(d, "reads.fastq"),
                         os.path.join(d, "splint.fasta"), out,
                         PipelineConfig(group_size=gs), backend)
    dt = time.time() - t0
    counters = {}
    try:
        sp = json.load(open(os.path.join(out, "c3poa_stats.json")))
        counters = {k: v for k, v in sp.get("counters", {}).items()
                    if "poa" in k}
        stages = {k: round(v, 2) for k, v in sp.get("stages_s", {}).items()
                  if "poa" in k}
        counters.update(stages)
    except (OSError, ValueError):
        pass
    return stats.total_reads / dt, counters


def make_backend(which):
    # tools/poa_stress.py:98-103 builds the JAX package's backends
    if which == "numpy":
        from ..pipeline.backend import NumpyBackend
        return NumpyBackend()
    if which not in ("cuda", "cpu"):
        raise ValueError(f"backend {which!r} (cuda, cpu or numpy)")
    from ..pipeline.torch_backend import TorchBackend
    return TorchBackend(which)


def measure(dc, dh, n_reads, rounds, backend):
    """The interleaved rounds of ``tools/poa_stress.py:104-131`` over the
    clean set in ``dc`` and the chimera-heavy set in ``dh`` (both of
    ``n_reads``, made by ``make_dataset``): one warm run of each, then
    ``rounds`` rounds, clean then heavy.  Returns the reads/s of every
    round, their medians, their ratio, the heavy set's routed reads and
    the original's verdict."""
    gs = min(512, max(1, n_reads // 2))
    # warm both datasets' shapes
    run_once(dc, os.path.join(dc, "warm"), backend, gs)
    run_once(dh, os.path.join(dh, "warm"), backend, gs)
    clean, heavy = [], []
    hc = {}
    for r in range(rounds):
        rs_c, _ = run_once(dc, os.path.join(dc, f"o{r}"), backend, gs)
        clean.append(rs_c)
        rs_h, hc = run_once(dh, os.path.join(dh, f"o{r}"), backend, gs)
        heavy.append(rs_h)
        print(f"round {r}: clean {rs_c:7.1f}  chimera-heavy "
              f"{rs_h:7.1f} r/s  ({rs_h / rs_c:.3f}x)  {hc}",
              flush=True)
    mc = sorted(clean)[len(clean) // 2]
    mh = sorted(heavy)[len(heavy) // 2]
    routed = hc.get("poa_fallback_reads", 0)
    return dict(clean=clean, heavy=heavy, median_clean=mc, median_heavy=mh,
                ratio=mh / mc, routed=routed, n_reads=n_reads,
                met=mh / mc >= 0.8 and routed >= 0.1 * n_reads)


def main(argv=None):
    # tools/poa_stress.py:95-97 reads sys.argv itself; the rounds are
    # measure's
    argv = sys.argv[1:] if argv is None else argv
    n_reads = int(argv[0]) if len(argv) > 0 else 2048
    rounds = int(argv[1]) if len(argv) > 1 else 3
    backend = make_backend(argv[2] if len(argv) > 2 else "cuda")

    with tempfile.TemporaryDirectory() as dc, \
            tempfile.TemporaryDirectory() as dh:
        make_dataset(dc, n_reads, 0.0, seed=3)
        make_dataset(dh, n_reads, 0.18, seed=3)
        res = measure(dc, dh, n_reads, rounds, backend)
        routed = res["routed"]
        print(f"\nmedians: clean {res['median_clean']:.1f} vs heavy "
              f"{res['median_heavy']:.1f} r/s -> {res['ratio']:.3f}x  "
              f"(routed {routed}/{n_reads} = "
              f"{100.0 * routed / n_reads:.1f}%)")
        print(f"target (>=10% routed, <20% loss): "
              f"{'MET' if res['met'] else 'NOT MET'}")
    return res


if __name__ == "__main__":
    main()
