"""Streaming FASTA/FASTQ IO (gzip-aware).

Replaces the reference's use of ``mappy.fastx_read`` (C3POa.py:201,232,239,
bin/determine_consensus.py:98, C3POa_postprocessing.py:88,145).  This
module is the always-available Python implementation and the spec of
the C parser the consensus run streams plain FASTQ through
(``native_src/fastxio.c`` via ``native.read_fastq_encoded``); the C
WRITER (``native.format_fastx``) is what the pipeline's output path
uses.  Semantics:

- FASTA: multi-line sequences concatenated; name is the first whitespace
  token after '>' (mappy's read_comment=False behavior).
- FASTQ: strict 4-line records; '+' line ignored.
- '.gz' suffix or gzip magic bytes -> transparent decompression.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, NamedTuple, Optional

import numpy as np

from ..utils.seqs import encode, phred_to_array


class FastxRecord(NamedTuple):
    name: str
    seq: str
    qual: Optional[str]  # None for FASTA


class Read(NamedTuple):
    """A read as the consensus run holds it: base codes as
    ``utils.seqs.encode`` gives them, phred values as ``phred_to_array``
    gives them (30 for FASTA), and the length."""
    name: str
    codes: np.ndarray   # int8
    quals: np.ndarray   # int8
    length: int


def as_read(rec: FastxRecord) -> Read:
    codes = encode(rec.seq)
    quals = (phred_to_array(rec.qual) if rec.qual is not None
             else np.full(len(codes), 30, dtype=np.int8))
    return Read(rec.name, codes, quals, len(codes))


def open_maybe_gzip(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    # ascii, matching read_fastq_offsets: both parsers must accept/reject
    # the same inputs, or a seek-resume session could fail on a file the
    # original session parsed (ADVICE r3)
    return open(path, "r", encoding="ascii")


def read_fastx(path: str) -> Iterator[FastxRecord]:
    fh = open_maybe_gzip(path)
    try:
        first = fh.read(1)
        if not first:
            return
        if first == ">":
            yield from _read_fasta(fh)
        elif first == "@":
            yield from _read_fastq(fh)
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")
    finally:
        fh.close()


def _read_fasta(fh) -> Iterator[FastxRecord]:
    # fh is positioned just after the first '>'
    name = None
    chunks: list[str] = []
    for line in fh:
        line = line.rstrip()
        if name is None:
            name = line.split()[0] if line.split() else ""
            continue
        if line.startswith(">"):
            yield FastxRecord(name, "".join(chunks), None)
            name = line[1:].split()[0] if line[1:].split() else ""
            chunks = []
        elif line:
            chunks.append(line)
    if name is not None:
        yield FastxRecord(name, "".join(chunks), None)


def _read_fastq(fh) -> Iterator[FastxRecord]:
    # fh is positioned just after the first '@'
    header = fh.readline().rstrip()
    while True:
        name = header.split()[0] if header.split() else ""
        seq = fh.readline().rstrip()
        plus = fh.readline()
        qual = fh.readline().rstrip()
        if not plus:
            raise ValueError("truncated FASTQ record")
        if len(qual) != len(seq):
            raise ValueError(
                f"FASTQ record {name!r}: quality length {len(qual)} != "
                f"sequence length {len(seq)}")
        yield FastxRecord(name, seq, qual)
        nxt = fh.readline()
        if not nxt:
            return
        if not nxt.startswith("@"):
            raise ValueError("malformed FASTQ record separator")
        header = nxt[1:].rstrip()


def is_plain_fastq(path: str) -> bool:
    """True when ``path`` is an uncompressed FASTQ file — the case where
    byte offsets are meaningful for seek-resume (gzip members are not
    seekable without re-decompression)."""
    try:
        with open(path, "rb") as fh:
            magic = fh.read(2)
    except OSError:
        return False
    return magic[:1] == b"@" and magic != b"\x1f\x8b"


def read_fastq_offsets(path: str,
                       start_offset: int = 0
                       ) -> Iterator[tuple]:
    """Plain-FASTQ streaming with exact byte offsets: yields
    ``(FastxRecord, offset_after_record)``.  Record semantics identical
    to ``read_fastx`` (same name token, rstrip, validation errors);
    ``start_offset`` must be a record boundary (a stored
    ``offset_after_record``), which is how a resumed pipeline skips
    gigabytes of completed input without re-parsing it."""
    with open(path, "rb") as fh:
        if start_offset:
            fh.seek(start_offset)
        while True:
            header = fh.readline()
            if not header:
                return
            if not header.startswith(b"@"):
                raise ValueError("malformed FASTQ record separator")
            hs = header[1:].rstrip()
            name = hs.split()[0].decode("ascii") if hs.split() else ""
            seq = fh.readline().rstrip()
            plus = fh.readline()
            qual = fh.readline().rstrip()
            if not plus:
                raise ValueError("truncated FASTQ record")
            if len(qual) != len(seq):
                raise ValueError(
                    f"FASTQ record {name!r}: quality length {len(qual)} "
                    f"!= sequence length {len(seq)}")
            yield (FastxRecord(name, seq.decode("ascii"),
                               qual.decode("ascii")), fh.tell())
