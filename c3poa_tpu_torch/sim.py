"""Synthetic R2C2 read simulator.

The reference repo ships example inputs but no golden outputs or tests
(SURVEY.md §4).  We generate R2C2 concatemers with *known* inserts so
end-to-end tests can assert consensus identity against ground truth:

    raw read = [frag][splint][copy][splint][copy]...[splint][frag]

where ``copy`` is the insert with nanopore-style errors applied, and the two
edge fragments are partial copies (producing dangling subreads, reference
C3POa.py:145-155).  Strand flips and per-base qualities are simulated too.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from .utils.seqs import decode, revcomp, array_to_phred

DEFAULT_SPLINT_LEN = 200


def random_seq(rng: np.random.Generator, n: int) -> str:
    return decode(rng.integers(0, 4, size=n).astype(np.int8))


def mutate(rng: np.random.Generator, seq: str, sub: float, ins: float, dele: float):
    """Apply independent per-base substitution/insertion/deletion errors."""
    out = []
    bases = "ACGT"
    for ch in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + sub:
            out.append(bases[int(rng.integers(0, 4))])
        else:
            out.append(ch)
        while rng.random() < ins:
            out.append(bases[int(rng.integers(0, 4))])
    return "".join(out)


def mutate_with_quals(rng: np.random.Generator, seq: str, sub: float,
                      ins: float, dele: float, q_spread: float = 6.0):
    """Quality-CORRELATED error channel: each base draws a latent phred
    quality and its error probability derives from it (p = 10^(-q/10),
    rescaled so the batch's mean error rate is exactly sub+ins+dele), so
    errors land preferentially on low-quality bases and the emitted
    qualities carry real signal about where they are — as in nanopore
    data.  ``mutate`` + independent N(20,4) quals deliberately lacks this
    signal, which makes any 2-copy quality-aware merge a coin flip
    (BENCHMARKS.md); this channel is what the reference's gap-run
    quality rule (bin/consensus.py:21-42) exists for.

    Returns (read_str, qual int8 array aligned to read_str).  Inserted
    bases inherit the local latent quality (insertions cluster in
    low-quality stretches)."""
    total = sub + ins + dele
    if total <= 0:
        q = np.clip(rng.normal(30, q_spread, size=len(seq)), 2, 40)
        return seq, q.astype(np.int8)
    n = len(seq)
    q_center = -10.0 * np.log10(total)
    q = np.clip(rng.normal(q_center, q_spread, size=n), 3.0, 40.0)
    p = 10.0 ** (-q / 10.0)
    p *= total / p.mean()             # calibrate the mean error rate
    p = np.clip(p, 0.0, 0.95)
    f_del, f_sub = dele / total, sub / total
    bases = "ACGT"
    out: list = []
    quals: list = []
    for i, ch in enumerate(seq):
        pi = float(p[i])
        qi = int(round(q[i]))
        r = rng.random()
        if r < pi * f_del:
            continue
        if r < pi * (f_del + f_sub):
            out.append(bases[int(rng.integers(0, 4))])
            quals.append(qi)
        else:
            out.append(ch)
            quals.append(qi)
        while rng.random() < pi * (1.0 - f_del - f_sub):
            out.append(bases[int(rng.integers(0, 4))])
            quals.append(qi)
    return "".join(out), np.asarray(quals, dtype=np.int8)


@dataclasses.dataclass
class SimRead:
    name: str
    seq: str
    qual: str
    insert: str          # ground-truth insert (strand of the raw read)
    splint_name: str
    strand: str          # '+' fwd splint, '-' revcomp splint present in read
    n_copies: int        # number of full copies


def make_read(
    rng: np.random.Generator,
    name: str,
    splint: str,
    splint_name: str = "Splint1",
    insert_len: int = 1000,
    n_copies: int = 5,
    error: float = 0.05,
    frag_frac: tuple[float, float] = (0.5, 0.5),
    strand: str | None = None,
    mean_q: int = 20,
) -> SimRead:
    """One R2C2 concatemer.  error is split 50/25/25 into sub/ins/del."""
    sub, ins, dele = error * 0.5, error * 0.25, error * 0.25
    insert = random_seq(rng, insert_len)

    parts = []
    # leading partial copy (tail of the insert), so first splint isn't at pos 0
    lead = int(insert_len * frag_frac[0])
    if lead > 0:
        parts.append(mutate(rng, insert[-lead:], sub, ins, dele))
    for _ in range(n_copies):
        parts.append(mutate(rng, splint, sub, ins, dele))
        parts.append(mutate(rng, insert, sub, ins, dele))
    parts.append(mutate(rng, splint, sub, ins, dele))
    trail = int(insert_len * frag_frac[1])
    if trail > 0:
        parts.append(mutate(rng, insert[:trail], sub, ins, dele))

    seq = "".join(parts)
    if strand is None:
        strand = "+" if rng.random() < 0.5 else "-"
    if strand == "-":
        seq = revcomp(seq)

    q = np.clip(rng.normal(mean_q, 4, size=len(seq)), 2, 40).astype(np.int8)
    return SimRead(
        name=name, seq=seq, qual=array_to_phred(q), insert=insert,
        splint_name=splint_name, strand=strand, n_copies=n_copies,
    )


def make_dataset(
    n_reads: int = 50,
    seed: int = 0,
    splints: dict[str, str] | None = None,
    insert_len: tuple[int, int] = (600, 1500),
    copies: tuple[int, int] = (2, 8),
    error: float = 0.05,
) -> tuple[list[SimRead], dict[str, str]]:
    rng = np.random.default_rng(seed)
    if splints is None:
        splints = {"Splint1": random_seq(rng, DEFAULT_SPLINT_LEN)}
    names = list(splints)
    reads = []
    for i in range(n_reads):
        sp = names[int(rng.integers(0, len(names)))]
        reads.append(
            make_read(
                rng,
                name=f"simread_{i}",
                splint=splints[sp],
                splint_name=sp,
                insert_len=int(rng.integers(*insert_len)),
                n_copies=int(rng.integers(copies[0], copies[1] + 1)),
                error=error,
            )
        )
    return reads, splints


def write_fastq(path: str, reads: list[SimRead]) -> None:
    with open(path, "w") as fh:
        for r in reads:
            fh.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")


def write_fasta(path: str, entries: dict[str, str]) -> None:
    with open(path, "w") as fh:
        for name, seq in entries.items():
            fh.write(f">{name}\n{seq}\n")


DEFAULT_ADAPTERS = {
    # shapes mirror the bundled adapter.fasta (25bp 3', 56bp 5' with Ns)
    "3Prime_adapter": "AAGCAGTGGTATCAACGCAGAGTAC",
    "5Prime_adapter": "AATGATACGGCGACCACCGAGATCTACACTCTTTCCCTACACGACGCTCTTCCGATCT",
}


def make_consensus_like(
    rng: np.random.Generator,
    name: str,
    cdna_len: int = 800,
    adapters: dict[str, str] | None = None,
    index: str | None = None,
    direction: str = "+",
    flank: tuple[int, int] = (90, 110),
    error: float = 0.01,
):
    """A postprocessing input read: a consensus-like sequence

        [left flank][5' adapter][cDNA][rc(index pad)][rc(3' adapter)][right flank]

    laid out so the reference's junction windows (seq[plus-4:plus+16] after
    the '+' adapter, revcomp(seq[minus-16:minus+4]) before the '-' adapter,
    C3POa_postprocessing.py:338-346) contain the oligo-dT index on the 3'
    side.  direction '-' emits the reverse complement.  Returns
    (name, sequence, cdna).
    """
    adapters = adapters or DEFAULT_ADAPTERS
    a5, a3 = adapters["5Prime_adapter"], adapters["3Prime_adapter"]
    sub, ins, dele = error * 0.5, error * 0.25, error * 0.25
    cdna = random_seq(rng, cdna_len)
    if index is not None:
        w = random_seq(rng, 3) + index + random_seq(rng, 3)
        idx_block = revcomp(w)
    else:
        idx_block = random_seq(rng, 16)
    seq = (random_seq(rng, flank[0]) + mutate(rng, a5, sub, ins, dele) +
           cdna + idx_block + mutate(rng, revcomp(a3), sub, ins, dele) +
           random_seq(rng, flank[1]))
    if direction == "-":
        seq = revcomp(seq)
    return name, seq, cdna
