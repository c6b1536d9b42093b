"""Reference (numpy) Smith-Waterman score-profile implementations.

This is the executable spec for ``kernels/sw_profile.py``.

Role in the pipeline (SURVEY.md §2.2): replaces both

- **conk** (reference C3POa.py:123 ``conk.conk(splint, seq, penalty)``): a
  score profile over read positions whose peaks mark splint occurrences.
  Downstream shifts peaks by ``len(splint)//2`` to get splint midpoints
  (C3POa.py:127), i.e. peaks index splint *start* positions.
- **BLAT preprocess** (bin/preprocess.py:74): which splint + which strand per
  read, decided here by the max profile score over (splint, strand) combos.

Spec
----
``profile[j]`` = best local-alignment score (linear gap) over all alignments
of any substring of the splint against a read substring *starting* at read
position ``j``.  Scoring: match +1, mismatch -2, gap -2 per base; any
comparison involving code 4 (N/pad) scores 0.  Local floor at 0.
(+-1 scoring sits near the local-alignment linear phase: background scores
reach ~0.15*m and splint-dense reads then fail the 6x-median noise gate.)

Peaks of the (smoothed) profile therefore sit at splint occurrence starts,
matching the reference's ``peak + len(splint)//2`` midpoint geometry.

Start-anchoring is computed by running the standard *end*-anchored local DP
on the reversed splint and reversed read, then flipping the column-max
profile back to forward coordinates.
"""

from __future__ import annotations

import numpy as np

NEG = -(2 ** 30)


def score_matrix(match: int = 1, mismatch: int = -1) -> np.ndarray:
    """5x5 substitution matrix over codes A,C,G,T,N; N scores 0 vs anything."""
    s = np.full((5, 5), mismatch, dtype=np.int32)
    np.fill_diagonal(s, match)
    s[4, :] = 0
    s[:, 4] = 0
    return s


def local_colmax_naive(query: np.ndarray, target: np.ndarray,
                       match: int = 1, mismatch: int = -2, gap: int = 2) -> np.ndarray:
    """O(m*L) scalar-loop local DP; colmax[j] = max_i H[i][j].

    H[i][j] = max(0, H[i-1][j-1]+s, H[i-1][j]-gap, H[i][j-1]-gap).
    Tiny inputs only — this is the ground truth for everything else.
    """
    sub = score_matrix(match, mismatch)
    m, L = len(query), len(target)
    H = np.zeros((m + 1, L + 1), dtype=np.int64)
    colmax = np.zeros(L, dtype=np.int64)
    for i in range(1, m + 1):
        for j in range(1, L + 1):
            H[i, j] = max(
                0,
                H[i - 1, j - 1] + sub[query[i - 1], target[j - 1]],
                H[i - 1, j] - gap,
                H[i, j - 1] - gap,
            )
            colmax[j - 1] = max(colmax[j - 1], H[i, j])
    return colmax


def local_colmax(query: np.ndarray, target: np.ndarray,
                 match: int = 1, mismatch: int = -2, gap: int = 2) -> np.ndarray:
    """Row-vectorised equivalent of ``local_colmax_naive``.

    Uses the in-row running-max identity for linear gaps:
        H[i][j] = max_{t<=j} (T[i][t] - gap*(j-t)),
        T[i][j] = max(0, H[i-1][j-1]+s, H[i-1][j]-gap)
    which is exact because any in-row gap run must start from a T cell.
    This is the same formulation the TPU kernel uses (a cummax per row).
    """
    sub = score_matrix(match, mismatch)
    m, L = len(query), len(target)
    jarr = np.arange(L, dtype=np.int64) * gap
    H = np.zeros(L, dtype=np.int64)
    colmax = np.zeros(L, dtype=np.int64)
    for i in range(m):
        s_row = sub[query[i], target]
        diag = np.concatenate(([0], H[:-1])) + s_row
        T = np.maximum(0, np.maximum(diag, H - gap))
        H = np.maximum.accumulate(T + jarr) - jarr
        np.maximum(colmax, H, out=colmax)
    return colmax


def start_profile(query: np.ndarray, target: np.ndarray,
                  match: int = 1, mismatch: int = -2, gap: int = 2) -> np.ndarray:
    """Start-anchored profile: profile[j] = best local score of query vs an
    alignment starting at target position j (the conk-role profile)."""
    return local_colmax(query[::-1], target[::-1], match, mismatch, gap)[::-1]


def local_hits_naive(query: np.ndarray, target: np.ndarray,
                     match: int = 1, mismatch: int = -2, gap: int = 2):
    """Full local DP with coordinate tracking (BLAT-postprocess role spec).

    Returns per-target-position arrays (length L):
      colmax[j]   best local score over alignments ending at target pos j
      qend[j]     query end index (0-based, inclusive) of that best alignment
      tstart[j]   target start index (0-based, inclusive)
      qstart[j]   query start index (0-based, inclusive)

    Ties resolved by (higher score, then the DP cell with smaller i).
    Tiny inputs only.
    """
    sub = score_matrix(match, mismatch)
    m, L = len(query), len(target)
    H = np.zeros((m + 1, L + 1), dtype=np.int64)
    TS = np.zeros((m + 1, L + 1), dtype=np.int64)  # target start of path
    QS = np.zeros((m + 1, L + 1), dtype=np.int64)  # query start of path
    colmax = np.zeros(L, dtype=np.int64)
    qend = np.zeros(L, dtype=np.int64)
    tstart = np.zeros(L, dtype=np.int64)
    qstart = np.zeros(L, dtype=np.int64)
    for j in range(1, L + 1):
        for i in range(1, m + 1):
            cands = [
                (H[i - 1, j - 1] + sub[query[i - 1], target[j - 1]],
                 TS[i - 1, j - 1] if H[i - 1, j - 1] > 0 else j - 1,
                 QS[i - 1, j - 1] if H[i - 1, j - 1] > 0 else i - 1),
                (H[i - 1, j] - gap, TS[i - 1, j], QS[i - 1, j]),
                (H[i, j - 1] - gap, TS[i, j - 1], QS[i, j - 1]),
            ]
            best = max(cands, key=lambda c: c[0])
            if best[0] < 0:
                H[i, j], TS[i, j], QS[i, j] = 0, j, i
            else:
                H[i, j], TS[i, j], QS[i, j] = best
            if H[i, j] > colmax[j - 1]:
                colmax[j - 1] = H[i, j]
                qend[j - 1] = i - 1
                tstart[j - 1] = TS[i, j]
                qstart[j - 1] = QS[i, j]
    return colmax, qend, tstart, qstart


def local_hits(query: np.ndarray, target: np.ndarray,
               match: int = 1, mismatch: int = -2, gap: int = 2):
    """Row-vectorised equivalent of ``local_hits_naive`` (kernel spec).

    Scans query positions as rows; carries (H, tstart, qstart) state vectors.
    In-row gap runs are resolved with the running-max identity; the carried
    coordinates follow whichever candidate wins the max (ties: the candidate
    order is 0-floor < in-row-run <= T, with T winning ties against the run,
    matching smaller-i preference of the naive version).
    """
    sub = score_matrix(match, mismatch)
    m, L = len(query), len(target)
    H = np.zeros(L + 1, dtype=np.int64)
    TS = np.arange(L + 1, dtype=np.int64)   # empty path starts at own column
    QS = np.zeros(L + 1, dtype=np.int64)
    colmax = np.zeros(L, dtype=np.int64)
    qend = np.zeros(L, dtype=np.int64)
    tstart = np.zeros(L, dtype=np.int64)
    qstart = np.zeros(L, dtype=np.int64)
    for i in range(m):
        s_row = sub[query[i], target]
        diag = H[:-1] + s_row
        dTS = np.where(H[:-1] > 0, TS[:-1], np.arange(L, dtype=np.int64))
        dQS = np.where(H[:-1] > 0, QS[:-1], i)
        # candidates from previous row: diag vs up(-gap)
        upv = H[1:] - gap
        T = np.where(diag >= upv, diag, upv)
        tTS = np.where(diag >= upv, dTS, TS[1:])
        tQS = np.where(diag >= upv, dQS, QS[1:])
        # local floor
        floored = T < 0
        T = np.where(floored, 0, T)
        tTS = np.where(floored, np.arange(1, L + 1, dtype=np.int64), tTS)
        tQS = np.where(floored, i + 1, tQS)
        # in-row gap runs: running max of T[t] - gap*(j-t)
        newH = T.copy()
        newTS = tTS.copy()
        newQS = tQS.copy()
        for j in range(1, L):
            cand = newH[j - 1] - gap
            if cand > newH[j]:
                newH[j] = cand
                newTS[j] = newTS[j - 1]
                newQS[j] = newQS[j - 1]
        H = np.concatenate(([0], newH))
        TS = np.concatenate(([0], newTS))
        QS = np.concatenate(([0], newQS))
        upd = newH > colmax
        colmax = np.where(upd, newH, colmax)
        qend = np.where(upd, i, qend)
        tstart = np.where(upd, newTS, tstart)
        qstart = np.where(upd, newQS, qstart)
    return colmax, qend, tstart, qstart
