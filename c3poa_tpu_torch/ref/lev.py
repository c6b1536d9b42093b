"""Levenshtein distance (editdistance-role, reference
C3POa_postprocessing.py:277, paper/Demultiplex_R2C2_reads.py:54).

Unit-cost edit distance between short strings, vectorised over many
query windows at once (the demux use case: one index vs all sliding
windows of a 20 bp junction sequence).
"""

from __future__ import annotations

import numpy as np


def levenshtein(a: str, b: str) -> int:
    """Plain scalar edit distance (tests/ground truth)."""
    la, lb = len(a), len(b)
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[lb]


def levenshtein_windows(windows: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Edit distance of ``idx`` (m,) vs each row of ``windows`` (P, m2),
    vectorised over P.  Returns (P,) int32."""
    P, m2 = windows.shape
    m = len(idx)
    jarr = np.arange(m2 + 1, dtype=np.int32)
    dp = np.broadcast_to(jarr, (P, m2 + 1)).copy()
    for i in range(1, m + 1):
        prev = dp
        base = np.empty_like(prev)
        base[:, 0] = i
        base[:, 1:] = np.minimum(prev[:, 1:] + 1,
                                 prev[:, :-1] + (windows != idx[i - 1]))
        # in-row chain dp[j] = min(base[j], dp[j-1] + 1) resolved exactly by
        # dp[j] = min_{t<=j} (base[t] + (j - t)) — a running min
        A = base - jarr
        np.minimum.accumulate(A, axis=1, out=A)
        dp = A + jarr
    return dp[:, m2].astype(np.int32)


def sliding_min_distance(seq: str, idx_seq: str) -> int:
    """min over window positions of levenshtein(seq[p:p+len(idx)], idx)
    (the reference match_index inner loop, C3POa_postprocessing.py:269-278).
    """
    m = len(idx_seq)
    n = len(seq)
    if n < m:
        return m  # no full window fits; worst case
    enc = np.frombuffer(seq.encode(), dtype=np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(enc, m).copy()
    ie = np.frombuffer(idx_seq.encode(), dtype=np.uint8)
    return int(levenshtein_windows(windows, ie).min())
