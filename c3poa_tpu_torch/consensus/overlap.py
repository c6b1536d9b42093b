"""K-mer diagonal-vote overlap finder.

Replaces mappy's role in the zero-repeat path (reference
bin/determine_consensus.py:117-119: ``mm.Aligner(seq=sub0, preset='map-ont',
scoring=(20,7,10,5)).map(sub1)`` -> r_st, r_en, q_st, q_en): given the 5'
fragment (target) and 3' fragment (query) of a single-peak read, find the
coordinates of their overlap (the shared partial copy of the insert).

Method: exact k-mer matches voted into coarse diagonal bins; the best
diagonal's inlier matches bound the overlap; endpoints are then refined by
extending to the fragment ends along the consensus diagonal.  A C++ fast
path may replace this, but fragments are short enough that numpy is fine.
"""

from __future__ import annotations

import numpy as np


def _kmer_codes(seq: np.ndarray, k: int) -> np.ndarray:
    """Packed 2-bit k-mer codes; positions containing N -> code -1."""
    n = len(seq)
    if n < k:
        return np.zeros(0, dtype=np.int64)
    s = np.asarray(seq, dtype=np.int64)
    bad = s >= 4
    s = np.where(bad, 0, s)
    codes = np.zeros(n - k + 1, dtype=np.int64)
    invalid = np.zeros(n - k + 1, dtype=bool)
    for o in range(k):
        codes = (codes << 2) | s[o:n - k + 1 + o]
        invalid |= bad[o:n - k + 1 + o]
    return np.where(invalid, -1, codes)


def find_overlap(target: np.ndarray, query: np.ndarray, k: int = 15,
                 band: int = 64, min_matches: int = 3,
                 use_native: bool = True):
    """Best-diagonal overlap of query onto target.

    Returns (r_st, r_en, q_st, q_en) half-open coordinates, or None.
    r_* index target, q_* index query (mappy hit convention used by the
    reference zero-repeat splice, bin/determine_consensus.py:119-128).
    A C fast path (native/overlap.c, ~30x) runs when built; results are
    identical (tests/test_overlap.py parity).
    """
    if use_native:
        from .. import native
        res = native.find_overlap_c(target, query, k, band, min_matches)
        if res != "unavailable":
            return res
    tk = _kmer_codes(target, k)
    qk = _kmer_codes(query, k)
    if len(tk) == 0 or len(qk) == 0:
        return None

    order = np.argsort(tk, kind="stable")
    sorted_tk = tk[order]
    # for each query k-mer, locate equal target k-mers
    left = np.searchsorted(sorted_tk, qk, side="left")
    right = np.searchsorted(sorted_tk, qk, side="right")
    n_hits = right - left
    # cap blowup from repetitive k-mers
    n_hits = np.minimum(n_hits, 8)
    # expand (query kmer, target hit) pairs without a Python loop — on
    # near-identical fragments nearly every query k-mer hits, and the old
    # per-kmer loop dominated the whole consensus pairs_build stage
    valid = np.flatnonzero((n_hits > 0) & (qk >= 0))
    if len(valid) == 0:
        return None
    counts = n_hits[valid]
    total = int(counts.sum())
    qpos = np.repeat(valid, counts).astype(np.int64)
    run_starts = np.cumsum(counts) - counts
    intra = np.arange(total, dtype=np.int64) - np.repeat(run_starts, counts)
    tpos = order[np.repeat(left[valid], counts) + intra].astype(np.int64)

    diag = tpos - qpos
    bins = (diag + len(query)) // band
    counts = np.bincount(bins)
    best_bin = int(np.argmax(counts))
    # accept inliers from the best bin and its neighbours
    inlier = np.abs(bins - best_bin) <= 1
    if inlier.sum() < min_matches:
        return None
    qi, ti = qpos[inlier], tpos[inlier]
    q_st, q_en = int(qi.min()), int(qi.max()) + k
    r_st, r_en = int(ti.min()), int(ti.max()) + k
    # extend to the fragment ends along the median diagonal so the splice
    # does not drop unmatched overlap tails
    shift_left = min(q_st, r_st)
    q_st -= shift_left
    r_st -= shift_left
    shift_right = min(len(query) - q_en, len(target) - r_en)
    q_en += shift_right
    r_en += shift_right
    return r_st, r_en, q_st, q_en
