"""Exact 2-row quality merge (the reference's bin/consensus.py).

For reads with exactly two voters — the r==2 core pair and the zero-repeat
overlap splice — the reference does NOT column-vote: it merges the 2-row
MSA with a block rule where *gap runs* are decided as a whole by the
higher average quality over the run (/root/reference/bin/consensus.py:26-42),
with per-column quality synthesized at gap positions by neighbor averaging
(normalizeLen, :50-74).

This module reproduces those semantics on our align-to-draft
representation: the 2-row MSA is reconstructed from the draft and the
query's ``AlignRecord`` (row A = the draft, row B = the query — matching
the reference's sequences[0]/sequences[1] order: the zero-repeat splice
passes [overlap_seq1(=5' fragment), overlap_seq2],
bin/determine_consensus.py:131-134), then the merge loop is a literal port:

- match column -> the base;
- mismatch -> higher per-base quality wins, ties -> row B
  (bin/consensus.py:21-25: strict ``>`` favors seqB);
- gap run -> the side with the higher *average* normalized quality over
  the run emits its whole block, ties -> row B (:26-42); a run that
  touches the final MSA column degrades to per-column steps of length 1
  (the reference's IndexError handler, :35-36).

Qualities compare in phred space: the reference compares ord(char) values,
a constant +33 shift that cancels in every comparison (including
normalizeLen's floor-averaging, since 2*33 is even).
"""

from __future__ import annotations

import numpy as np

from ..ref.banded import AlignRecord

GAP = 5


def build_msa(draft: np.ndarray, rec: AlignRecord, query: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
    """Rows (A=draft, B=query) of the pairwise MSA as int8 codes, GAP=5.

    Uncovered draft columns (semiglobal overhang) become gap-in-B runs,
    exactly what a global 2-row MSA of length-mismatched subreads yields.
    """
    nt = len(draft)
    cols_a: list[int] = []
    cols_b: list[int] = []
    for j in range(nt + 1):
        L = int(rec.ins_len[j])
        if L > 0:
            qs = int(rec.ins_qstart[j])
            for o in range(L):
                cols_a.append(GAP)
                cols_b.append(int(query[qs + o]))
        if j < nt:
            cols_a.append(int(draft[j]))
            if rec.cover[j] == 1:
                cols_b.append(int(query[rec.qpos[j]]))
            else:
                cols_b.append(GAP)
    return (np.asarray(cols_a, dtype=np.int8),
            np.asarray(cols_b, dtype=np.int8))


def normalize_qual(row: np.ndarray, qual: np.ndarray) -> np.ndarray:
    """normalizeLen (bin/consensus.py:50-74) in phred space: synthesize a
    quality for every gap column by averaging the neighboring real
    qualities (leading gaps take the first real quality; trailing gaps
    replicate the last emitted value)."""
    out = np.empty(len(row), dtype=np.int64)
    qual = np.asarray(qual, dtype=np.int64)
    qi = 0
    n_real = len(qual)
    for si in range(len(row)):
        if row[si] != GAP:
            out[si] = qual[qi]
            qi += 1
        elif qi == 0:
            out[si] = qual[0] if n_real else 0
        elif qi < n_real:
            out[si] = (qual[qi - 1] + qual[qi]) // 2
        else:
            out[si] = out[si - 1]
    return out


def merge_rows(A: np.ndarray, B: np.ndarray, qa: np.ndarray, qb: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """The consensus() loop (bin/consensus.py:17-44). Returns (codes,
    quals) with gaps stripped; quals are the winning side's normalized
    values (diagnostic — the reference emits plain FASTA)."""
    out_c: list[int] = []
    out_q: list[int] = []
    n = len(A)
    i = 0
    while i != n:
        a, b = int(A[i]), int(B[i])
        if a != GAP and b != GAP:
            if a == b:
                out_c.append(a)
                out_q.append(max(int(qa[i]), int(qb[i])))
            elif qa[i] > qb[i]:
                out_c.append(a)
                out_q.append(int(qa[i]))
            else:
                out_c.append(b)
                out_q.append(int(qb[i]))
            i += 1
            continue
        # gap run: extend over the gapped row; a run touching the final
        # column processes one column at a time (reference IndexError path)
        gap_row = A if a == GAP else B
        gl = 1
        while True:
            if i + gl >= n:
                gl = 1
                break
            if gap_row[i + gl] == GAP:
                gl += 1
            else:
                break
        if float(np.mean(qa[i:i + gl])) > float(np.mean(qb[i:i + gl])):
            win_row, win_q = A, qa
        else:
            win_row, win_q = B, qb
        for k in range(i, i + gl):
            if win_row[k] != GAP:
                out_c.append(int(win_row[k]))
                out_q.append(int(win_q[k]))
        i += gl
    return (np.asarray(out_c, dtype=np.int8),
            np.clip(np.asarray(out_q, dtype=np.int64), 0, 93).astype(np.int8))


def pairwise_merge(draft: np.ndarray, draft_qual: np.ndarray,
                   rec: AlignRecord, query: np.ndarray, qual: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Merge a draft and one aligned query with the reference's 2-row rule."""
    A, B = build_msa(np.asarray(draft), rec, np.asarray(query))
    qa = normalize_qual(A, draft_qual)
    qb = normalize_qual(B, qual)
    return merge_rows(A, B, qa, qb)
