"""Generate a self-contained example dataset (the role of the reference's
bundled splint.fasta / adapter.fasta / oligodt_indexes.fasta plus a raw
read set it never shipped).

    python -m c3poa_tpu_torch.tools.make_example -o example/ [-n 50] [--seed 7]

Writes: reads.fastq (R2C2 concatemers with known inserts), splint.fasta,
adapters.fasta (3Prime_adapter / 5Prime_adapter), oligodt_indexes.fasta,
and truth.tsv (read name, strand, copies, insert sequence) for checking
results.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="Write an example R2C2 dataset.")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-n", "--n_reads", type=int, default=50)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)

    from .. import sim

    os.makedirs(args.out, exist_ok=True)
    reads, splints = sim.make_dataset(
        n_reads=args.n_reads, seed=args.seed,
        insert_len=(500, 2000), copies=(2, 12), error=0.05)
    sim.write_fastq(os.path.join(args.out, "reads.fastq"), reads)
    sim.write_fasta(os.path.join(args.out, "splint.fasta"), splints)
    sim.write_fasta(os.path.join(args.out, "adapters.fasta"),
                    dict(sim.DEFAULT_ADAPTERS))
    rng = np.random.default_rng(args.seed + 1)
    indexes = {f"Index{i}": sim.random_seq(rng, 10) for i in range(1, 13)}
    sim.write_fasta(os.path.join(args.out, "oligodt_indexes.fasta"), indexes)
    with open(os.path.join(args.out, "truth.tsv"), "w") as fh:
        fh.write("name\tstrand\tcopies\tinsert\n")
        for r in reads:
            fh.write(f"{r.name}\t{r.strand}\t{r.n_copies}\t{r.insert}\n")
    print(f"wrote {args.n_reads} reads + references to {args.out}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
