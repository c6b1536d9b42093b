"""Reference (numpy) banded affine-gap semiglobal aligner with traceback.

Executable spec for ``kernels/banded.py`` — the engine that replaces both
abPOA (reference bin/determine_consensus.py:30-47) and racon
(bin/determine_consensus.py:92-93): the consensus stage aligns every subread
to a draft with this aligner and votes per draft column (see
``consensus/``), iterating draft -> align -> vote rounds.

Alignment model
---------------
Semiglobal: the query (a subread) is aligned end-to-end; leading/trailing
gaps in the target (the draft) are free.  Affine gaps: a gap of length k
costs ``gap_open + k * gap_ext``.  Scoring defaults (match 5 / mismatch -4 /
open 4 / ext 2) follow the reference's abPOA parameterisation
(``poa.msa_aligner(match=5)`` with abPOA-1.0.5 defaults for the rest,
bin/determine_consensus.py:30).  Comparisons involving N (code 4) score 0.

DP (i over query 0..nq, j over target 0..nt):
    E[i][j] = max(H[i-1][j] - open - ext, E[i-1][j] - ext)     # consumes query
    F[i][j] = max(Ht[i][j-1] - open - ext, F[i][j-1] - ext)    # consumes target
    Ht[i][j] = max(H[i-1][j-1] + s(q[i-1], t[j-1]), E[i][j])
    H[i][j] = max(Ht[i][j], F[i][j])
    H[0][j] = 0; E[0][j] = -inf; score = max_j H[nq][j]
Using Ht (excluding F) as the F-opening source is exact for open >= 0:
closing an F gap and reopening it within a row always loses to extending.
This makes each row computable with one prefix-max scan — the same
formulation the Pallas kernel uses.

Band: row i covers target DP columns [lo(i), lo(i)+W) with
    lo(i) = clip(round(i * nt / nq) - W//2, 0, max(nt + 1 - W, 0))
(rounding: numpy round — banker's — both here and in the kernel).
Cells outside the band hold -inf.

Tie-breaking (must match the kernel + native traceback bit-for-bit):
- H source priority on equal scores: diag > E > F.
- gap open preferred over extend on equal scores (strict '>' for extend).
- end column: smallest j among maximal H[nq][j].

Move byte per cell: bits 0-1 H source (0 diag, 1 E, 2 F); bit 2 E-extend;
bit 3 F-extend.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

NEG = np.int64(-(2 ** 40))

# move byte layout
SRC_DIAG, SRC_E, SRC_F = 0, 1, 2
BIT_EEXT, BIT_FEXT = 4, 8


def sub_matrix(match: int = 5, mismatch: int = -4) -> np.ndarray:
    s = np.full((5, 5), mismatch, dtype=np.int64)
    np.fill_diagonal(s, match)
    s[4, :] = 0
    s[:, 4] = 0
    return s


def band_starts(nq: int, nt: int, band: int) -> np.ndarray:
    """lo(i) for i in 0..nq.

    Computed in float32 so the host reference and the TPU kernel (f32
    arithmetic) pick identical band placements."""
    i = np.arange(nq + 1, dtype=np.float32)
    ctr = np.round(i * np.float32(nt) / np.float32(max(nq, 1))).astype(np.int64)
    hi = max(nt + 1 - band, 0)
    return np.clip(ctr - band // 2, 0, hi)


def semiglobal_naive(q, t, match=5, mismatch=-4, gap_open=4, gap_ext=2):
    """Scalar-loop unbanded semiglobal DP with the *textbook* affine
    recurrence (F opens from the full H, including F-derived H).  Ground
    truth for scores; validates that the Ht prefix-scan formulation used by
    ``banded_align`` and the kernel is score-equivalent.  Tiny inputs only.

    Returns (score, H, E, F) full matrices.
    """
    s = sub_matrix(match, mismatch)
    nq, nt = len(q), len(t)
    oe, e = gap_open + gap_ext, gap_ext
    H = np.full((nq + 1, nt + 1), NEG, dtype=np.int64)
    E = np.full((nq + 1, nt + 1), NEG, dtype=np.int64)
    F = np.full((nq + 1, nt + 1), NEG, dtype=np.int64)
    H[0, :] = 0
    for i in range(1, nq + 1):
        for j in range(0, nt + 1):
            E[i, j] = max(H[i - 1, j] - oe, E[i - 1, j] - e)
            h = E[i, j]
            if j > 0:
                h = max(H[i - 1, j - 1] + s[q[i - 1], t[j - 1]], h)
                F[i, j] = max(H[i, j - 1] - oe, F[i, j - 1] - e)
                h = max(h, F[i, j])
            H[i, j] = h
    score = H[nq].max()
    return score, H, E, F


def banded_align(q, t, match=5, mismatch=-4, gap_open=4, gap_ext=2, band=128):
    """Row-vectorised banded semiglobal DP over the full (masked) matrix.

    Returns (score, j_end, moves, lo) with moves shaped (nq+1, nt+1) uint8.
    """
    s = sub_matrix(match, mismatch)
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    nq, nt = len(q), len(t)
    oe, e = np.int64(gap_open + gap_ext), np.int64(gap_ext)
    lo = band_starts(nq, nt, band)

    jidx = np.arange(nt + 1, dtype=np.int64)
    in_band0 = (jidx >= lo[0]) & (jidx < lo[0] + band)
    Hprev = np.where(in_band0, np.int64(0), NEG)
    Eprev = np.full(nt + 1, NEG, dtype=np.int64)
    moves = np.zeros((nq + 1, nt + 1), dtype=np.uint8)

    for i in range(1, nq + 1):
        in_band = (jidx >= lo[i]) & (jidx < lo[i] + band)
        Ecur = np.maximum(Hprev - oe, Eprev - e)
        eext = (Eprev - e) > (Hprev - oe)
        s_row = s[q[i - 1], t]  # length nt, for columns 1..nt
        diag = np.concatenate(([NEG], Hprev[:-1] + s_row))
        Ht = np.maximum(diag, Ecur)
        # F via prefix max: F[j] = max(Htm[j-1]-oe, F[j-1]-e), where Htm
        # is Ht CLIPPED TO THE BAND: F-gap chains cannot enter row i's
        # band from columns left of lo(i).  Columns [lo(i-1), lo(i))
        # hold real Ht values (they were in the previous row's band), but
        # letting F chain in from them puts traceback steps on cells the
        # band declares unreachable — the walk would leave the band (the
        # device kernels' band-local layout cannot even express that,
        # and the round-3 C-aligner crash traced to exactly this).  The
        # band-edge clip IS the spec; every implementation (this file,
        # kernels/banded.py scan, pallas, native/align.c, dpbench.c)
        # shares it bit-for-bit.
        Htm = np.where(in_band, Ht, NEG)
        A = Htm + e * jidx
        cm = np.maximum.accumulate(A)
        F = np.concatenate(([NEG], cm[:-1])) - oe - e * jidx + e  # = max_{t<j}(Htm[t]-oe-e*(j-1-t))... see below
        # Derivation: F[j] = max_{u<j} (Htm[u] - oe - e*(j-1-u))
        #           = (max_{u<j} (Htm[u] + e*u)) - oe - e*(j-1)
        fext = np.zeros(nt + 1, dtype=bool)
        if nt >= 1:
            fext[1:] = (F[:-1] - e) > (Htm[:-1] - oe)
        H = np.maximum(Ht, F)
        src = np.where((diag >= Ecur) & (diag >= F), SRC_DIAG,
                       np.where(Ecur >= F, SRC_E, SRC_F)).astype(np.uint8)
        mv = src | (eext.astype(np.uint8) << 2) | (fext.astype(np.uint8) << 3)
        H = np.where(in_band, H, NEG)
        Ecur = np.where(in_band, Ecur, NEG)
        moves[i] = np.where(in_band, mv, 0)
        Hprev, Eprev = H, Ecur

    # clamp: anything below NEG/2 is "unreachable"
    valid = Hprev > NEG // 2
    if not valid.any():
        return NEG, 0, moves, lo
    score = Hprev[valid].max()
    j_end = int(np.flatnonzero((Hprev == score) & valid)[0])
    return int(score), j_end, moves, lo


class AlignRecord(NamedTuple):
    """Per-subread alignment against a draft of length nt (vote input)."""
    cover: np.ndarray      # int8[nt]: 0 uncovered, 1 base, 2 deletion
    base: np.ndarray       # int8[nt]: query code where cover==1, else 4
    qpos: np.ndarray       # int32[nt]: query index aligned, -1 where none
    ins_len: np.ndarray    # int32[nt+1]: insertion length before target col j
    ins_qstart: np.ndarray # int32[nt+1]: query start of that insertion, -1
    j_start: int
    j_end: int
    score: int


def traceback(q, t, moves, j_end, lo=None, band=None):
    """Walk the move matrix from (nq, j_end) back to row 0.

    With ``lo``/``band`` given, also returns whether the path visited
    band-local column 0 or band-1 (the fast-band escalation signal;
    same rule as the device walks and native c3_traceback_edge):
    returns (AlignRecord, edge).  Without them returns the record."""
    nq, nt = len(q), len(t)
    cover = np.zeros(nt, dtype=np.int8)
    base = np.full(nt, 4, dtype=np.int8)
    qpos = np.full(nt, -1, dtype=np.int32)
    ins_len = np.zeros(nt + 1, dtype=np.int32)
    ins_qstart = np.full(nt + 1, -1, dtype=np.int32)

    i, j = nq, j_end
    state = 0  # 0=H, 1=E, 2=F
    edge = False
    while i > 0:
        if lo is not None:
            lo_i = int(lo[i])
            k = j - lo_i
            # interior band edges only (see kernels/banded.py walks)
            if (k == 0 and lo_i > 0) or \
                    (k == band - 1 and lo_i + band <= nt):
                edge = True
        mv = int(moves[i, j])
        if state == 0:
            src = mv & 3
            if src == SRC_DIAG:
                cover[j - 1] = 1
                base[j - 1] = q[i - 1]
                qpos[j - 1] = i - 1
                i -= 1
                j -= 1
            elif src == SRC_E:
                state = 1
            else:
                state = 2
        elif state == 1:
            # E: consume query char (insertion before target column j)
            ins_len[j] += 1
            ins_qstart[j] = i - 1
            ext = mv & BIT_EEXT
            i -= 1
            if not ext:
                state = 0
        else:
            # F: consume target char (deletion at target column j-1)
            cover[j - 1] = 2
            ext = mv & BIT_FEXT
            j -= 1
            if not ext:
                state = 0
    rec = AlignRecord(cover, base, qpos, ins_len, ins_qstart, j, j_end,
                      score=0)
    if lo is not None:
        return rec, edge
    return rec


def embed_record(rec: AlignRecord, offset: int, full_nt: int) -> AlignRecord:
    """Re-express a record aligned against target[offset:offset+nt_win]
    in full-target coordinates (used when a short fragment is aligned
    against an anchored window of the draft)."""
    nt_win = len(rec.cover)
    cover = np.zeros(full_nt, dtype=np.int8)
    base = np.full(full_nt, 4, dtype=np.int8)
    qpos = np.full(full_nt, -1, dtype=np.int32)
    ins_len = np.zeros(full_nt + 1, dtype=np.int32)
    ins_qstart = np.full(full_nt + 1, -1, dtype=np.int32)
    cover[offset:offset + nt_win] = rec.cover
    base[offset:offset + nt_win] = rec.base
    qpos[offset:offset + nt_win] = rec.qpos
    ins_len[offset:offset + nt_win + 1] = rec.ins_len
    ins_qstart[offset:offset + nt_win + 1] = rec.ins_qstart
    return AlignRecord(cover, base, qpos, ins_len, ins_qstart,
                       rec.j_start + offset, rec.j_end + offset, rec.score)


def normalize_record(rec: AlignRecord, q, t) -> AlignRecord:
    """Left-normalize indels within homopolymer runs (canonical gap placement).

    Equivalent alignments place a surplus/missing base anywhere inside a
    homopolymer run; different subreads then vote the same event onto
    different columns/slots and the column vote splits (this is how POA
    graphs win on homopolymers — insertions land on a shared node).  Shifting
    every indel to the leftmost equivalent position makes votes coincide.
    Emitted query strings are unchanged (pure re-labelling of the path).
    """
    cover = rec.cover.copy()
    base = rec.base.copy()
    qpos = rec.qpos.copy()
    ins_len = rec.ins_len.copy()
    ins_qstart = rec.ins_qstart.copy()
    t = np.asarray(t)
    q = np.asarray(q)
    nt = len(t)

    # deletions: del at col j moves left past matched cols with equal draft
    # base (swap del/match labels; emitted chars identical)
    for j in range(nt):
        if cover[j] != 2:
            continue
        jj = j
        while jj > 0 and cover[jj - 1] == 1 and t[jj - 1] == t[jj] \
                and ins_len[jj] == 0:
            cover[jj - 1], cover[jj] = 2, 1
            base[jj] = base[jj - 1]
            qpos[jj] = qpos[jj - 1]
            base[jj - 1] = 4
            qpos[jj - 1] = -1
            jj -= 1

    # insertions: a single-base insertion before col j moves left past an
    # aligned query char of the same base (swap which query char is the
    # "insert"; emitted chars identical).  Only length-1 insertions shift —
    # longer rotations would break query-index contiguity of the record.
    for j in range(1, nt + 1):
        if ins_len[j] != 1:
            continue
        b = q[ins_qstart[j]]
        jj = j
        while jj > 0 and cover[jj - 1] == 1 and base[jj - 1] == b \
                and ins_len[jj - 1] == 0:
            ins_len[jj - 1] = 1
            ins_qstart[jj - 1] = qpos[jj - 1]
            qpos[jj - 1] = ins_qstart[jj]
            ins_len[jj] = 0
            ins_qstart[jj] = -1
            jj -= 1
    return AlignRecord(cover, base, qpos, ins_len, ins_qstart,
                       rec.j_start, rec.j_end, rec.score)


def align_and_trace(q, t, match=5, mismatch=-4, gap_open=4, gap_ext=2,
                    band=128, normalize=True):
    # c3poa_tpu/ref/banded.py:312-323 differs: no with_edge (nothing
    # escalates a band)
    score, j_end, moves, lo = banded_align(
        q, t, match, mismatch, gap_open, gap_ext, band)
    rec, _edge = traceback(q, t, moves, j_end, lo=lo, band=band)
    if normalize:
        rec = normalize_record(rec, q, t)
    return rec._replace(score=int(score))
