"""Adapter-hit inputs shared by the CPU tests (test_torch_adapters.py)
and the card tests (test_torch_cuda.py).  Imports no jax: the card tests
run on a machine without it."""

import numpy as np

from c3poa_tpu_torch import sim
from c3poa_tpu_torch.utils import encode, revcomp, revcomp_encoded

A3 = sim.DEFAULT_ADAPTERS["3Prime_adapter"]
A5 = sim.DEFAULT_ADAPTERS["5Prime_adapter"]
# the default adapters, and a set whose 5' adapter holds Ns
ADAPTER_SETS = {
    "default": {"3Prime_adapter": A3, "5Prime_adapter": A5},
    "with_n": {"3Prime_adapter": A3,
               "5Prime_adapter": A5[:20] + "NNNN" + A5[24:]},
}


def combos(adapters: dict):
    """Postprocess combo codes: each adapter forward, then reverse
    complemented (25 and 56 rows: combos of different lengths)."""
    out = []
    for seq in adapters.values():
        out += [encode(seq), revcomp_encoded(encode(seq))]
    return out


def edge_reads(seed: int = 0, n_random: int = 6) -> list:
    """Encoded reads (each at most 600 bases): planted single adapters in
    both directions, dimers, hits at a read's first and last base, exact
    repeats (ties), N codes, reads shorter than an adapter, and an input on which the JAX backend's padded kernel reports
    another second hit than the spec (ROADMAP section 3)."""
    rng = np.random.default_rng(seed)
    rs = lambda n: sim.random_seq(rng, n)                      # noqa: E731
    seqs = []
    for i in range(n_random):
        _, seq, _ = sim.make_consensus_like(
            rng, f"r{i}", cdna_len=int(rng.integers(60, 300)),
            direction="+-"[i % 2], error=0.01)
        seqs.append(seq)
    seqs += [
        A5 + A5,                                  # dimer
        rs(30) + A5 + rs(7) + A5 + rs(40),        # dimer with a gap
        A5 + rs(120),                             # hit at the first base
        rs(150) + revcomp(A3),                    # hit at the last base
        rs(80) + A3,                              # forward 3' at the end
        A3 + rs(10) + A3 + rs(20),                # exact repeat: tie
        rs(20) + A3 + A3,                         # adjacent repeat
        rs(40) + A5[:30] + "NNN" + A5[33:] + rs(40),   # N inside a hit
        "N" * 50 + A5 + "N" * 20,                 # N runs
        "N" * 30,                                 # all N
        "ACGT",                                   # shorter than adapters
        A3[:10],
        A5[:40],                                  # longer than the 3'
        # s2: spec 14, the JAX backend's padded kernel 6 (combo 0)
        "AAGCAGTGGTATCAAGGCAGAGTACAGCAGAGGTATCAACGCACCAA",
    ]
    return [encode(s) for s in seqs]


def batch(reads, pad_to: int = 64, extra: int = 0):
    """(B, L) int8 padded with 4 and (B,) int32 lengths; L is the longest
    read plus ``extra``, rounded up to ``pad_to``."""
    L = max(pad_to, -(-(max(len(r) for r in reads) + extra) // pad_to)
            * pad_to)
    R = np.full((len(reads), L), 4, dtype=np.int8)
    lens = np.zeros(len(reads), dtype=np.int32)
    for b, r in enumerate(reads):
        R[b, :len(r)] = r
        lens[b] = len(r)
    return R, lens


def adapter_matrix(codes, rows: int = 0):
    """(C, max(rows, longest)) int8 padded with 4, and (C,) int32
    lengths."""
    m = max(rows, max(len(c) for c in codes))
    A = np.full((len(codes), m), 4, dtype=np.int8)
    for c, x in enumerate(codes):
        A[c, :len(x)] = x
    return A, np.array([len(c) for c in codes], dtype=np.int32)
