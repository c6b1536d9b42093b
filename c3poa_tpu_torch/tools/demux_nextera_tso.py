"""Nextera + TSO index demultiplexer.

Equivalent of the reference paper script (paper/Demultiplex_R2C2_reads.py):
scans the first 300 bp of each consensus read for the best-matching Nextera
and TSO index by sliding Levenshtein distance and appends ``|Next_TSO`` to
the read name.

Rules mirrored exactly (paper/Demultiplex_R2C2_reads.py:36-82):
- reads <= 300 bp are skipped entirely (not written);
- per index family, best distance over all windows of the first 300 bp;
- accept when best < 4 and best < second_best - 1; otherwise the family's
  field is empty;
- output: ``Indexed_reads.fasta`` in the output directory.

Usage: python -m c3poa_tpu_torch.tools.demux_nextera_tso -i reads.fasta \
           -o out -n Nextera_Indexes.fasta -t TSO_Indexes.fasta
"""

from __future__ import annotations

import argparse
import os
import sys

from ..io.fastx import read_fastx
from ..ref.lev import sliding_min_distance


def best_index(seq300: str, indexes: dict[str, str], max_dist: int = 4) -> str:
    dists = sorted(
        ((name, sliding_min_distance(seq300, iseq))
         for name, iseq in indexes.items()),
        key=lambda x: x[1])
    if not dists:
        return ""
    second = dists[1][1] if len(dists) > 1 else 10 ** 9
    if dists[0][1] < max_dist and dists[0][1] < second - 1:
        return dists[0][0]
    return ""


def demultiplex(input_fasta: str, out_path: str, nextera_fasta: str,
                tso_fasta: str) -> tuple[int, int]:
    nexts = {r.name: r.seq for r in read_fastx(nextera_fasta)}
    tsos = {r.name: r.seq for r in read_fastx(tso_fasta)}
    os.makedirs(out_path, exist_ok=True)
    n_in = n_out = 0
    with open(os.path.join(out_path, "Indexed_reads.fasta"), "w") as out:
        for rec in read_fastx(input_fasta):
            n_in += 1
            if len(rec.seq) <= 300:
                continue
            s = rec.seq[:300]
            name = f"{rec.name}|{best_index(s, nexts)}_{best_index(s, tsos)}"
            out.write(f">{name}\n{rec.seq}\n")
            n_out += 1
    return n_in, n_out


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Demultiplex R2C2 consensus reads by Nextera/TSO indexes.")
    p.add_argument("-i", "--input_fasta_file", type=str, required=True)
    p.add_argument("-o", "--output_path", type=str, required=True)
    p.add_argument("-n", "--nextera_index_file", type=str, required=True)
    p.add_argument("-t", "--tso_index_file", type=str, required=True)
    args = p.parse_args(argv)
    n_in, n_out = demultiplex(args.input_fasta_file, args.output_path,
                              args.nextera_index_file, args.tso_index_file)
    print(f"indexed {n_out}/{n_in} reads", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
