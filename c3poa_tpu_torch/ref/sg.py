"""Reference Savitzky-Golay filter with the exact edge semantics of the
reference pipeline (bin/savitzky_golay.py:7-38), ported off the removed
``np.int``/``np.mat`` APIs (it cannot run under numpy>=1.24, SURVEY.md §3.5).

Semantics reproduced exactly:
- coefficients: pinv of the Vandermonde ``b[k,i] = k**i`` for
  k in [-half, half], row ``deriv`` (bin/savitzky_golay.py:30-31)
- edge padding: ``y[0] - |y[1:half+1][::-1] - y[0]|`` at the head and
  ``y[-1] + |y[-half-1:-1][::-1] - y[-1]|`` at the tail
  (bin/savitzky_golay.py:33-35)
- ``np.convolve(m[::-1], y, mode='valid')`` (bin/savitzky_golay.py:36)

The pipeline always calls this with window=41, order=2, deriv=0, iterated
3 times (reference C3POa.py:111, bin/call_peaks.py:10-11).
"""

from __future__ import annotations

from math import factorial

import numpy as np


def sg_coeffs(window_size: int, order: int, deriv: int = 0, rate: float = 1.0) -> np.ndarray:
    half = (window_size - 1) // 2
    b = np.array([[k ** i for i in range(order + 1)] for k in range(-half, half + 1)],
                 dtype=np.float64)
    m = np.linalg.pinv(b)[deriv] * rate ** deriv * factorial(deriv)
    return m


def savitzky_golay(y, window_size: int, order: int, deriv: int = 0, rate: float = 1.0) -> np.ndarray:
    y = np.asarray(y, dtype=np.float64)
    if window_size % 2 != 1 or window_size < 1:
        raise TypeError("window_size size must be a positive odd number")
    if window_size < order + 2:
        raise TypeError("window_size is too small for the polynomials order")
    half = (window_size - 1) // 2
    m = sg_coeffs(window_size, order, deriv, rate)
    firstvals = y[0] - np.abs(y[1:half + 1][::-1] - y[0])
    lastvals = y[-1] + np.abs(y[-half - 1:-1][::-1] - y[-1])
    y = np.concatenate((firstvals, y, lastvals))
    return np.convolve(m[::-1], y, mode="valid")


def smooth3(scores, window: int = 41, order: int = 2) -> np.ndarray:
    """The pipeline's triple smoothing pass (bin/call_peaks.py:10-11)."""
    out = np.asarray(scores, dtype=np.float64)
    for _ in range(3):
        out = savitzky_golay(out, window, order)
    return out
