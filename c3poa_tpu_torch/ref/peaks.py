"""Reference peak calling: a pure-numpy replication of
``scipy.signal.find_peaks(x, distance=d, height=h)`` as used by the reference
(bin/call_peaks.py:15), plus the noise gates around it (bin/call_peaks.py:13-14).

scipy semantics replicated (verified against scipy in tests):
- local maxima with plateau handling: a maximum is a sample (or plateau)
  strictly greater than its immediate non-equal neighbours on both sides;
  the reported index is ``(left_edge + right_edge) // 2`` of the plateau.
- ``height``: keep peaks with ``x[peak] >= height``.
- ``distance``: peaks sorted by priority (height, ties broken towards the
  *rightmost* peak, matching scipy's stable argsort + highest-first walk);
  each surviving peak removes lower-priority peaks strictly closer than
  ``ceil(distance)`` on either side.
"""

from __future__ import annotations

import numpy as np


def local_maxima_loop(x: np.ndarray) -> np.ndarray:
    """Indices of local maxima (plateau midpoints), scipy
    _local_maxima_1d — the literal loop port, kept as the oracle for
    the vectorized version below."""
    x = np.asarray(x)
    n = len(x)
    out = []
    i = 1
    i_max = n - 1
    while i < i_max:
        if x[i - 1] < x[i]:
            i_ahead = i + 1
            while i_ahead < i_max and x[i_ahead] == x[i]:
                i_ahead += 1
            if x[i_ahead] < x[i]:
                left_edge = i
                right_edge = i_ahead - 1
                out.append((left_edge + right_edge) // 2)
                i = i_ahead
        i += 1
    return np.array(out, dtype=np.int64)


def local_maxima(x: np.ndarray) -> np.ndarray:
    """Vectorized local_maxima_loop (identical output, tested): a
    plateau [l, r] is a peak iff the value strictly rises into l and
    strictly falls after r, reported at (l + r) // 2; plateaus touching
    either edge never qualify.  Consecutive sign changes of the diff
    give exactly those runs."""
    x = np.asarray(x)
    if len(x) < 3:
        return np.array([], dtype=np.int64)
    d = np.diff(x)
    nz = np.flatnonzero(d)
    if len(nz) < 2:
        return np.array([], dtype=np.int64)
    rising = d[nz] > 0
    pk = np.flatnonzero(rising[:-1] & ~rising[1:])
    left = nz[pk] + 1
    right = nz[pk + 1]
    return ((left + right) // 2).astype(np.int64)


def select_by_distance(peaks: np.ndarray, priority: np.ndarray, distance: float) -> np.ndarray:
    """Boolean keep mask, scipy _select_by_peak_distance."""
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


def find_peaks(x: np.ndarray, distance: float, height: float) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    peaks = local_maxima(x)
    if len(peaks) == 0:
        return peaks
    vals = x[peaks]
    sel = vals >= height
    peaks, vals = peaks[sel], vals[sel]
    if len(peaks) == 0:
        return peaks
    keep = select_by_distance(peaks, vals, distance)
    return peaks[keep]


def call_peaks(scores: np.ndarray, min_dist: int, smoothed: np.ndarray | None = None):
    """Noise-gated peak calling (reference bin/call_peaks.py:8-16).

    ``scores`` must already be triple-smoothed (ref.sg.smooth3) if ``smoothed``
    is None.  Returns (peaks, med) where peaks is empty when
    ``max(scores) < 6 * median(scores)``; peak height threshold ``3 * median``.
    """
    s = np.asarray(scores if smoothed is None else smoothed, dtype=np.float64)
    med = np.median(s)
    if s.max(initial=0.0) < 6 * med:
        return np.array([], dtype=np.int64), med
    return find_peaks(s, distance=min_dist, height=med * 3), med


def exact_peaks_rerun(codes: np.ndarray, splint_codes: np.ndarray,
                      min_dist: int, match: int = 1, mismatch: int = -2,
                      gap: int = 2) -> np.ndarray:
    """THE exact host path for deep-flagged reads, shared by every
    device consumer (pipeline/tpu_backend.locate_many,
    kernels/locate.locate_batch): full-precision profile of the chosen
    splint combo -> smooth3 -> scipy-exact selection.  A read is flagged
    when a device tile held >2 surviving local maxima — the only
    geometry where the kernel's top-2 compaction can diverge from
    scipy's find_peaks — and its peaks are recomputed here so the
    device path is scipy-exact at ANY chain depth (the combo itself is
    bit-parity with the host by kernel tests, so only peaks rerun)."""
    from . import sg as ref_sg
    from . import sw as ref_sw

    prof = ref_sw.start_profile(np.asarray(splint_codes, dtype=np.int8),
                                np.asarray(codes, dtype=np.int8),
                                match, mismatch, gap)
    return exact_peaks_from_profile(prof, min_dist)


def exact_peaks_from_profile(profile: np.ndarray,
                             min_dist: int) -> np.ndarray:
    """The exact f64 decision half of ``exact_peaks_rerun`` given an
    already-computed EXACT score profile: smooth3 + scipy-exact
    selection.  The device profile is int32 and bit-exact vs ref/sw
    (kernel parity tests), so device consumers fetch the flagged reads'
    profile rows and redo only the FLOAT decisions here — byte-identical
    to the full host rerun at ~1/200 the cost (no O(m*n) DP)."""
    from . import sg as ref_sg
    sm = ref_sg.smooth3(np.asarray(profile, dtype=np.float64))
    pks, _med = call_peaks(sm, int(min_dist))
    return pks
