"""Plain reference of what follows the locate step on the host: the cut
of a read into subreads at its splint peaks, the records the run writes
for them, the draft each read's subreads are aligned to, and the
consensus header.  Frozen copies of the port's ``pipeline/segment.py``,
``consensus/engine.py:pick_draft`` and the record grammar of
``pipeline/run.py`` (C3POa.py:124-173, bin/determine_consensus.py:57-114);
nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np


def round_to_base(x: float, base: int = 50) -> int:
    return int(base * round(float(x) / base))


def segment_read(seq_len: int, peaks, splint_len: int):
    """(subread bounds, dangling bounds, zero_repeat) or None."""
    if len(peaks) == 0:
        return None
    shifted = [int(x) + splint_len // 2 for x in peaks]
    shifted = [x for x in shifted if x < seq_len]
    if not shifted:
        return None
    subreads, dangling = [], []
    if len(shifted) > 1:
        rounded = [round_to_base(x, 50) for x in np.diff(shifted)]
        med = np.median(rounded)
        for i in range(len(rounded)):
            if med * 0.8 <= rounded[i] <= med * 1.2:
                subreads.append((shifted[i], shifted[i + 1]))
        if shifted[0] > 100:
            dangling.append((0, shifted[0]))
        if seq_len - shifted[-1] > 100:
            dangling.append((shifted[-1], seq_len))
        return subreads, dangling, False
    return [], [(0, shifted[0]), (shifted[0], seq_len)], True


def pick_draft(bounds) -> int:
    """Length medoid: closest to the median length, first on ties."""
    lens = np.array([b - a for a, b in bounds], dtype=np.int64)
    return int(np.argmin(np.abs(lens - np.median(lens))))


def expected(codes: np.ndarray, qual: np.ndarray, name: str, loc: tuple,
             combos: list, cli: dict) -> dict:
    """What the run writes for one read, given its locate answer: the
    subread records (name, sequence, quality), the consensus header's
    fields other than the consensus length, and the core (query, draft)
    pairs as read coordinates.  ``consensus`` False: no consensus record
    may be written."""
    combo, score, peaks = loc
    out = dict(subreads=None, header=None, pairs=[], consensus=False)
    if score < cli.get("splint_min_score", 50):
        return out
    seg = segment_read(len(codes), peaks, combos[combo][3])
    if seg is None:
        return out
    subs, dang, zero = seg
    if zero or (not subs and len(dang) == 2):
        if not cli["zero"]:
            return out
        # zero-repeat splice: name_0, name_1 (its consensus, if any, is
        # the splice's; the header then carries 0 repeats)
        out["subreads"] = [(f"{name}_{i}", a, b)
                           for i, (a, b) in enumerate(dang)]
        out["header"] = (name, len(codes), 0)
        out["consensus"] = None      # may or may not be written
        return out
    if not subs:
        return out
    recs = [(f"{name}_{i + 1}", a, b) for i, (a, b) in enumerate(subs)]
    for j, (a, b) in enumerate(dang):
        recs.append((f"{name}_{0 if j == 0 else len(subs) + 1}", a, b))
    out["subreads"] = recs
    out["header"] = (name, len(codes), len(subs))
    out["consensus"] = True
    if len(subs) >= 2:
        di = pick_draft(subs)
        ta, tb = subs[di]
        out["pairs"] = [((a, b), (ta, tb)) for i, (a, b) in enumerate(subs)
                        if i != di]
    return out


def avg_qual(qual: np.ndarray) -> float:
    return round(float(np.sum(qual.astype(np.int64))) / len(qual), 2)
