"""Subread segmentation — exact-parity port of the cut logic in the
reference hot loop (C3POa.py:124-155).

Given peak indices of the smoothed splint-score profile:
- shift peaks by ``len(splint) // 2`` to splint midpoints, drop >= seq_len
  (C3POa.py:127-132)
- multi-peak reads: subread lengths = diff of midpoints, rounded to the
  nearest 50 with banker's rounding (C3POa.py:106-108,137-138); keep
  subreads whose rounded length lies within [0.8, 1.2] x median
  (C3POa.py:139-143); head/tail fragments > 100 bp become dangling subreads
  (C3POa.py:145-150)
- single-peak reads: both halves become dangling subreads (C3POa.py:151-155)
  and the read is a zero-repeat candidate.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.seqs import round_to_base


class Segments(NamedTuple):
    subread_bounds: list      # [(start, end)] core subreads
    dangling_bounds: list     # [(start, end)] dangling fragments
    zero_repeat: bool         # single-peak read (zero-repeat candidate)


def segment_read(seq_len: int, peaks: np.ndarray, splint_len: int) -> Segments | None:
    """Returns None when no usable peaks remain (read dropped,
    mirroring C3POa.py:125-133)."""
    if len(peaks) == 0:
        return None
    shifted = [int(x) + splint_len // 2 for x in peaks]
    shifted = [x for x in shifted if x < seq_len]
    if not shifted:
        return None

    subreads: list = []
    dangling: list = []
    if len(shifted) > 1:
        lens = np.diff(shifted)
        rounded = [round_to_base(x, 50) for x in lens]
        med = np.median(rounded)
        for i in range(len(rounded)):
            if med * 0.8 <= rounded[i] <= med * 1.2:
                subreads.append((shifted[i], shifted[i + 1]))
        if shifted[0] > 100:
            dangling.append((0, shifted[0]))
        if seq_len - shifted[-1] > 100:
            dangling.append((shifted[-1], seq_len))
        return Segments(subreads, dangling, zero_repeat=False)

    dangling.append((0, shifted[0]))
    dangling.append((shifted[0], seq_len))
    return Segments(subreads, dangling, zero_repeat=True)
