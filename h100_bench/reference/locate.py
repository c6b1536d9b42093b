"""Plain numpy reference of the locate step: which splint combo a read
carries, its raw profile score and the peaks of its smoothed profile.

A frozen copy of the port's executable spec (``ref/sw.py``
``local_colmax`` / ``start_profile``, ``ref/sg.py`` ``smooth3``,
``ref/peaks.py`` ``call_peaks``), kept here so that nothing the program
ships can change the yardstick; it imports nothing of the program.

The spec smooths in float64.  ``dtype`` exists for the control: the same
reference one precision below (float32), which has to come out as not
correct.
"""

from __future__ import annotations

from math import factorial

import numpy as np


def score_matrix(match: int, mismatch: int) -> np.ndarray:
    s = np.full((5, 5), mismatch, dtype=np.int32)
    np.fill_diagonal(s, match)
    s[4, :] = 0
    s[:, 4] = 0
    return s


def local_colmax(query, target, match=1, mismatch=-2, gap=2) -> np.ndarray:
    """colmax[j] = max_i H[i][j] of the local DP with linear gaps, rows
    by the in-row running-max identity H = cummax(T + j*gap) - j*gap
    (int32: every value stays under 2 * (len(target) + len(query)))."""
    sub = score_matrix(match, mismatch)
    L = len(target)
    jarr = np.arange(L, dtype=np.int32) * np.int32(gap)
    H = np.zeros(L, dtype=np.int32)
    colmax = np.zeros(L, dtype=np.int32)
    for i in range(len(query)):
        s_row = sub[query[i], target]
        diag = np.concatenate((np.zeros(1, np.int32), H[:-1])) + s_row
        T = np.maximum(0, np.maximum(diag, H - np.int32(gap)))
        H = np.maximum.accumulate(T + jarr) - jarr
        np.maximum(colmax, H, out=colmax)
    return colmax


def start_profile(query, target, match=1, mismatch=-2, gap=2) -> np.ndarray:
    """profile[j]: best local score of an alignment starting at j."""
    return local_colmax(query[::-1], target[::-1], match, mismatch, gap)[::-1]


def sg_coeffs(window_size: int, order: int, dtype) -> np.ndarray:
    half = (window_size - 1) // 2
    b = np.array([[k ** i for i in range(order + 1)]
                  for k in range(-half, half + 1)], dtype=np.float64)
    return (np.linalg.pinv(b)[0] * factorial(0)).astype(dtype)


def savitzky_golay(y, window_size: int, order: int, dtype) -> np.ndarray:
    y = np.asarray(y, dtype=dtype)
    half = (window_size - 1) // 2
    m = sg_coeffs(window_size, order, dtype)
    firstvals = y[0] - np.abs(y[1:half + 1][::-1] - y[0])
    lastvals = y[-1] + np.abs(y[-half - 1:-1][::-1] - y[-1])
    y = np.concatenate((firstvals, y, lastvals))
    return np.convolve(m[::-1], y, mode="valid").astype(dtype)


def smooth3(scores, dtype=np.float64, window: int = 41, order: int = 2):
    out = np.asarray(scores, dtype=dtype)
    for _ in range(3):
        out = savitzky_golay(out, window, order, dtype)
    return out


def local_maxima(x: np.ndarray) -> np.ndarray:
    """Plateau midpoints of strict local maxima (scipy's
    _local_maxima_1d); plateaus touching an edge never qualify."""
    if len(x) < 3:
        return np.array([], dtype=np.int64)
    d = np.diff(x)
    nz = np.flatnonzero(d)
    if len(nz) < 2:
        return np.array([], dtype=np.int64)
    rising = d[nz] > 0
    pk = np.flatnonzero(rising[:-1] & ~rising[1:])
    return ((nz[pk] + 1 + nz[pk + 1]) // 2).astype(np.int64)


def select_by_distance(peaks, priority, distance) -> np.ndarray:
    n = len(peaks)
    distance_ = int(np.ceil(distance))
    keep = np.ones(n, dtype=bool)
    order = np.argsort(priority, kind="stable")
    for idx in range(n - 1, -1, -1):
        j = order[idx]
        if not keep[j]:
            continue
        k = j - 1
        while k >= 0 and peaks[j] - peaks[k] < distance_:
            keep[k] = False
            k -= 1
        k = j + 1
        while k < n and peaks[k] - peaks[j] < distance_:
            keep[k] = False
            k += 1
    return keep


def call_peaks(s: np.ndarray, min_dist: int) -> np.ndarray:
    """No peaks when max < 6 x median; else scipy's find_peaks with
    height 3 x median and the distance rule."""
    med = np.median(s)
    if s.max(initial=0.0) < 6 * med:
        return np.array([], dtype=np.int64)
    peaks = local_maxima(s)
    if len(peaks) == 0:
        return peaks
    vals = s[peaks]
    sel = vals >= med * 3
    peaks, vals = peaks[sel], vals[sel]
    if len(peaks) == 0:
        return peaks
    return peaks[select_by_distance(peaks, vals, min_dist)]


def combos_of(splints: dict) -> list:
    """(name, strand, codes, splint_len) per combo, in the order the
    pipeline builds them: each splint forward, then reverse complement."""
    comp = np.array([3, 2, 1, 0, 4], dtype=np.int8)
    out = []
    for name, codes in splints.items():
        codes = np.asarray(codes, dtype=np.int8)
        out.append((name, "+", codes, len(codes)))
        out.append((name, "-", comp[codes][::-1].copy(), len(codes)))
    return out


def locate_read(codes: np.ndarray, combos: list, min_dist: int,
                dtype=np.float64) -> tuple:
    """(combo index, raw score, peaks): the combo of the highest profile
    maximum (first on ties), the peaks of its smoothed profile."""
    best_c, best_score, best_prof = -1, -1, None
    for ci, (_n, _s, scodes, _l) in enumerate(combos):
        prof = start_profile(scodes, codes)
        m = int(prof.max(initial=0))
        if m > best_score:
            best_c, best_score, best_prof = ci, m, prof
    peaks = call_peaks(smooth3(best_prof, dtype), int(min_dist))
    return best_c, best_score, peaks
