"""Column-vote consensus extraction.

Given alignments of subreads against a draft (``ref.banded.AlignRecord`` /
the TPU kernel's traceback output), build the consensus by per-column
majority vote with quality tie-breaking, including insertion calling.

This is the TPU-native replacement for the reference's consensus machinery:
- abPOA's heaviest-bundle consensus (bin/determine_consensus.py:43-47) —
  for near-identical tandem-repeat subreads, align-to-draft + column vote is
  the same computation POA performs on its (near-linear) graph;
- racon's window POA polish (bin/determine_consensus.py:92-93) — racon's
  ``-q 5`` quality mask maps to ``qmin=5`` here;
- the reference's 2-row quality merge (bin/consensus.py:4-44): with two
  records, count ties are broken by summed quality, so the higher-quality
  base wins mismatch columns, and gap columns go to the higher-quality side.

Vote rules (deterministic, mirrored by the C++ native path):
- column vote over {A,C,G,T,deletion}: weight 1 per covering record whose
  base quality >= qmin (deletions always weigh 1); if no record passes the
  gate, all covering records vote regardless of quality.
- ties: larger summed quality wins, then smaller base code (bases beat
  deletion on full ties).
- insertion slots (between columns): records whose aligned span covers the
  slot vote on insertion length (majority, ties -> shorter); winning length
  L > 0 votes per-offset bases among records with insertions >= that length,
  same quality gating as columns.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from ..ref.banded import AlignRecord

DEL_CODE = 4
MAX_INS = 30


class SubreadAln(NamedTuple):
    rec: AlignRecord
    query: np.ndarray  # int8 codes
    qual: np.ndarray   # int8 phred values


def record_for_draft(draft: np.ndarray, qual: np.ndarray) -> SubreadAln:
    """The draft aligned trivially to itself (it votes like any subread)."""
    nt = len(draft)
    rec = AlignRecord(
        cover=np.ones(nt, dtype=np.int8),
        base=np.asarray(draft, dtype=np.int8),
        qpos=np.arange(nt, dtype=np.int32),
        ins_len=np.zeros(nt + 1, dtype=np.int32),
        ins_qstart=np.full(nt + 1, -1, dtype=np.int32),
        j_start=0, j_end=nt, score=5 * nt,
    )
    return SubreadAln(rec, np.asarray(draft, dtype=np.int8),
                      np.asarray(qual, dtype=np.int8))


def vote_consensus(nt: int, alns: Sequence[SubreadAln], qmin: int = 5,
                   use_native: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Returns (consensus codes int8, consensus quals int8).

    Consensus quality per emitted base = clipped mean quality of the
    agreeing votes (diagnostic only; the reference emits plain FASTA).
    Uses the C fast path (native/traceback.c:c3_vote) when built.
    """
    if use_native:
        from .. import native
        res = native.vote_consensus_c(nt, alns, qmin)
        if res is not None:
            return res
    counts = np.zeros((nt, 5), dtype=np.int32)       # A C G T del
    counts_all = np.zeros((nt, 5), dtype=np.int32)   # ungated fallback
    qsum = np.zeros((nt, 5), dtype=np.int64)

    ins_lens = np.zeros((len(alns), nt + 1), dtype=np.int32)
    spans = np.zeros((len(alns), 2), dtype=np.int64)

    for a, (rec, query, qual) in enumerate(alns):
        is_base = rec.cover == 1
        is_del = rec.cover == 2
        cols = np.flatnonzero(is_base & (rec.base < 4))  # N bases don't vote
        if len(cols):
            b = rec.base[cols].astype(np.int64)
            q = qual[rec.qpos[cols]].astype(np.int64)
            passed = q >= qmin
            np.add.at(counts, (cols[passed], b[passed]), 1)
            np.add.at(counts_all, (cols, b), 1)
            np.add.at(qsum, (cols, b), q)
        dcols = np.flatnonzero(is_del)
        if len(dcols):
            counts[dcols, DEL_CODE] += 1
            counts_all[dcols, DEL_CODE] += 1
        ins_lens[a] = np.minimum(rec.ins_len, MAX_INS)
        spans[a] = rec.j_start, rec.j_end

    # gate fallback: columns where nothing passed qmin use ungated counts
    no_pass = counts.sum(axis=1) == 0
    counts[no_pass] = counts_all[no_pass]

    # column winners: argmax count, tie -> qsum, tie -> smaller code
    key = (counts.astype(np.int64) << 40) + (np.minimum(qsum, (1 << 39) - 1) << 3) \
        + np.array([4, 3, 2, 1, 0], dtype=np.int64)
    col_winner = np.argmax(key, axis=1)
    covered = counts.sum(axis=1) > 0
    col_q = np.zeros(nt, dtype=np.int64)
    w = col_winner[covered]
    cw = counts[covered, w]
    # clamp like the C path (qsum includes sub-qmin gated votes, so the
    # mean can exceed 93 — or even int8 range, which numpy>=2 rejects)
    col_q[covered] = np.minimum(
        np.where(cw > 0, qsum[covered, w] // np.maximum(cw, 1), 0), 93)

    # insertion slots
    out_codes: list[np.ndarray] = []
    out_quals: list[np.ndarray] = []
    participates = (spans[:, 0:1] <= np.arange(nt + 1)) & \
                   (np.arange(nt + 1) <= spans[:, 1:2])

    # Most slots have zero insertions everywhere; handle those in bulk.
    any_ins = (ins_lens > 0).any(axis=0)
    for j in range(nt + 1):
        if any_ins[j]:
            voters = np.flatnonzero(participates[:, j])
            if len(voters):
                lens = ins_lens[voters, j]
                lc = np.bincount(lens, minlength=MAX_INS + 1)
                L = int(np.argmax(lc))  # argmax takes first (shortest) on tie
                if L > 0:
                    ins_c, ins_q = _vote_insertion(alns, voters, j, L, qmin)
                    out_codes.append(ins_c)
                    out_quals.append(ins_q)
        if j < nt and covered[j] and col_winner[j] != DEL_CODE:
            out_codes.append(np.array([col_winner[j]], dtype=np.int8))
            out_quals.append(np.array([col_q[j]], dtype=np.int8))

    if not out_codes:
        return np.zeros(0, dtype=np.int8), np.zeros(0, dtype=np.int8)
    return (np.concatenate(out_codes).astype(np.int8),
            np.concatenate(out_quals).astype(np.int8))


def _vote_insertion(alns, voters, j, L, qmin):
    codes = np.empty(L, dtype=np.int8)
    quals = np.empty(L, dtype=np.int8)
    for o in range(L):
        cnt = np.zeros(4, dtype=np.int64)
        cnt_all = np.zeros(4, dtype=np.int64)
        qs = np.zeros(4, dtype=np.int64)
        for a in voters:
            rec, query, qual = alns[a]
            if rec.ins_len[j] > o:
                qi = rec.ins_qstart[j] + o
                b = int(query[qi])
                if b < 4:
                    q = int(qual[qi])
                    if q >= qmin:
                        cnt[b] += 1
                    cnt_all[b] += 1
                    qs[b] += q
        if cnt.sum() == 0:
            cnt = cnt_all
        if cnt.sum() == 0:
            codes[o] = DEL_CODE  # all-N insertion: emit N
            quals[o] = 0
            continue
        key = (cnt << 40) + (np.minimum(qs, (1 << 39) - 1) << 3) + \
            np.array([3, 2, 1, 0], dtype=np.int64)
        b = int(np.argmax(key))
        codes[o] = b
        quals[o] = min(qs[b] // max(cnt[b], 1), 93) if cnt[b] else 0
    return codes, quals
