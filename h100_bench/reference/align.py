"""Plain numpy reference of the align step: a banded affine-gap
semiglobal alignment of a subread (query) to its read's draft (target),
walked back into the per-column record the vote reads, indels
left-normalised in homopolymers.

A frozen copy of the port's executable spec (``ref/banded.py``:
``band_starts``, ``banded_align``, ``traceback``, ``normalize_record``),
kept here so that nothing the program ships can change the yardstick; it
imports nothing of the program.

The spec places the band with float32 arithmetic.  ``band_dtype`` exists
for the control: the same reference one precision below (bfloat16,
emulated by rounding float32 to 8 significant bits).
"""

from __future__ import annotations

import numpy as np

NEG = np.int64(-(2 ** 40))
SRC_DIAG, SRC_E, SRC_F = 0, 1, 2
BIT_EEXT, BIT_FEXT = 4, 8


def sub_matrix(match: int, mismatch: int) -> np.ndarray:
    s = np.full((5, 5), mismatch, dtype=np.int64)
    np.fill_diagonal(s, match)
    s[4, :] = 0
    s[:, 4] = 0
    return s


def to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to bfloat16 (nearest, ties to even), as float32."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def band_starts(nq: int, nt: int, band: int, band_dtype="float32"):
    """lo(i) = clip(round(i * nt / nq) - band // 2, 0, nt + 1 - band),
    in float32 (numpy's round: half to even)."""
    i = np.arange(nq + 1, dtype=np.float32)
    if band_dtype == "bfloat16":
        x = to_bf16(to_bf16(i * to_bf16(np.float32(nt)))
                    / to_bf16(np.float32(max(nq, 1))))
    else:
        x = i * np.float32(nt) / np.float32(max(nq, 1))
    ctr = np.round(x).astype(np.int64)
    return np.clip(ctr - band // 2, 0, max(nt + 1 - band, 0))


def banded_align(q, t, match, mismatch, gap_open, gap_ext, band,
                 band_dtype="float32"):
    """Row-vectorised banded DP over the full masked matrix: (score,
    j_end, moves, lo).  Ties: diag > E > F; gap open before extend; the
    end column is the smallest j of the best last-row score."""
    s = sub_matrix(match, mismatch)
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    nq, nt = len(q), len(t)
    oe, e = np.int64(gap_open + gap_ext), np.int64(gap_ext)
    lo = band_starts(nq, nt, band, band_dtype)
    jidx = np.arange(nt + 1, dtype=np.int64)
    Hprev = np.where((jidx >= lo[0]) & (jidx < lo[0] + band), np.int64(0), NEG)
    Eprev = np.full(nt + 1, NEG, dtype=np.int64)
    moves = np.zeros((nq + 1, nt + 1), dtype=np.uint8)
    for i in range(1, nq + 1):
        in_band = (jidx >= lo[i]) & (jidx < lo[i] + band)
        Ecur = np.maximum(Hprev - oe, Eprev - e)
        eext = (Eprev - e) > (Hprev - oe)
        diag = np.concatenate(([NEG], Hprev[:-1] + s[q[i - 1], t]))
        Ht = np.maximum(diag, Ecur)
        # F chains only inside row i's band (the band edge clip)
        Htm = np.where(in_band, Ht, NEG)
        cm = np.maximum.accumulate(Htm + e * jidx)
        F = np.concatenate(([NEG], cm[:-1])) - oe - e * jidx + e
        fext = np.zeros(nt + 1, dtype=bool)
        if nt >= 1:
            fext[1:] = (F[:-1] - e) > (Htm[:-1] - oe)
        H = np.maximum(Ht, F)
        src = np.where((diag >= Ecur) & (diag >= F), SRC_DIAG,
                       np.where(Ecur >= F, SRC_E, SRC_F)).astype(np.uint8)
        mv = src | (eext.astype(np.uint8) << 2) | (fext.astype(np.uint8) << 3)
        Hprev = np.where(in_band, H, NEG)
        Eprev = np.where(in_band, Ecur, NEG)
        moves[i] = np.where(in_band, mv, 0)
    valid = Hprev > NEG // 2
    if not valid.any():
        return int(NEG), 0, moves, lo
    score = Hprev[valid].max()
    j_end = int(np.flatnonzero((Hprev == score) & valid)[0])
    return int(score), j_end, moves, lo


def traceback(q, t, moves, j_end, lo, band):
    """Walk from (nq, j_end) to row 0: (cover, base, qpos, ins_len,
    ins_qstart, j_start, edge), edge when the path touched an interior
    band edge."""
    nq, nt = len(q), len(t)
    cover = np.zeros(nt, dtype=np.int8)
    base = np.full(nt, 4, dtype=np.int8)
    qpos = np.full(nt, -1, dtype=np.int32)
    ins_len = np.zeros(nt + 1, dtype=np.int32)
    ins_qstart = np.full(nt + 1, -1, dtype=np.int32)
    i, j, state, edge = nq, j_end, 0, False
    while i > 0:
        lo_i = int(lo[i])
        k = j - lo_i
        if (k == 0 and lo_i > 0) or (k == band - 1 and lo_i + band <= nt):
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
            ins_len[j] += 1
            ins_qstart[j] = i - 1
            ext = mv & BIT_EEXT
            i -= 1
            if not ext:
                state = 0
        else:
            cover[j - 1] = 2
            ext = mv & BIT_FEXT
            j -= 1
            if not ext:
                state = 0
    return cover, base, qpos, ins_len, ins_qstart, j, edge


def normalize(cover, base, qpos, ins_len, ins_qstart, q, t):
    """Indels shifted to the leftmost equivalent place in homopolymer
    runs (deletions, then single-base insertions)."""
    cover, base, qpos = cover.copy(), base.copy(), qpos.copy()
    ins_len, ins_qstart = ins_len.copy(), ins_qstart.copy()
    nt = len(t)
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
    return cover, base, qpos, ins_len, ins_qstart


def align_pair(q, t, params: dict, band: int, band_dtype="float32") -> dict:
    """The record of one pair: the fields the vote reads, with the
    score and the end columns.  A path that touches the band's edge at
    a band narrower than ``params['band']`` is realigned at it (the
    spec's escalation rule)."""
    q = np.asarray(q, dtype=np.int8)
    t = np.asarray(t, dtype=np.int8)
    while True:
        score, j_end, moves, lo = banded_align(
            q, t, params["match"], params["mismatch"], params["gap_open"],
            params["gap_ext"], band, band_dtype)
        cover, base, qpos, ins_len, ins_qstart, j_start, edge = traceback(
            q, t, moves, j_end, lo, band)
        if edge and band < params["band"]:
            band = params["band"]
            continue
        break
    cover, base, qpos, ins_len, ins_qstart = normalize(
        cover, base, qpos, ins_len, ins_qstart, q, t)
    return dict(cover=cover, base=base, qpos=qpos, ins_len=ins_len,
                ins_qstart=ins_qstart, j_start=int(j_start),
                j_end=int(j_end), score=int(score))


RECORD_FIELDS = ("cover", "base", "qpos", "ins_len", "ins_qstart",
                 "j_start", "j_end", "score")


def same_record(a: dict, b: dict) -> bool:
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for k in RECORD_FIELDS)


def _prefix_max(x: np.ndarray) -> np.ndarray:
    """Running max along axis 1, in log2(width) steps (on the
    transpose, whose slices are contiguous)."""
    x = np.ascontiguousarray(x.T)
    y = np.empty_like(x)
    s = 1
    while s < x.shape[0]:
        y[:s] = x[:s]
        np.maximum(x[s:], x[:-s], out=y[s:])
        x, y = y, x
        s *= 2
    return x.T


def forward_ends(pairs, params: dict, band_dtype="float32") -> list:
    """(score, j_end) of each (query, target) pair at the full band, as
    ``banded_align`` gives them, for many pairs at once: the same rows
    held in band coordinates (column j = lo(i) + k), every row one set of
    numpy operations over all the pairs.  Values stay far below 2**31, so
    int32 with its own NEG does."""
    from numpy.lib.stride_tricks import sliding_window_view as windows
    if not pairs:
        return []
    band = int(params["band"])
    neg = np.int32(-(1 << 28))
    oe = np.int32(params["gap_open"] + params["gap_ext"])
    e = np.int32(params["gap_ext"])
    match, mismatch = np.int32(params["match"]), np.int32(params["mismatch"])
    P = len(pairs)
    nq = np.array([len(q) for q, _t in pairs], dtype=np.int64)
    nt = np.array([len(t) for _q, t in pairs], dtype=np.int64)
    R = int(nq.max())
    lo = np.empty((R + 1, P), dtype=np.int64)
    for p in range(P):
        b = band_starts(int(nq[p]), int(nt[p]), band, band_dtype)
        lo[:len(b), p] = b
        lo[len(b):, p] = b[-1]
    D = int(np.diff(lo, axis=0).max(initial=0))
    # query codes by row; targets with a pad slot (slot j: target j - 1)
    Q = np.full((R, P), 4, dtype=np.int8)
    T = np.full((P, int(nt.max()) + band + 2), 4, dtype=np.int8)
    for p, (q, t) in enumerate(pairs):
        Q[:len(q), p] = q
        T[p, 1:len(t) + 1] = t
    Tw = windows(T, band, axis=1)              # (P, slots, band)
    k = np.arange(band, dtype=np.int64)
    ek = (e * k).astype(np.int32)
    pidx = np.arange(P)
    # columns past a short target (only where nt + 1 < band)
    short = bool((nt + 1 < band).any())
    # H and E of the previous row with NEG slots before and after, so
    # that row i reads column j of row i - 1 at slot 1 + k + d (d: how
    # far the band moved) and column j - 1 at slot k + d
    Hb = np.full((P, band + D + 2), neg, dtype=np.int32)
    Eb = np.full((P, band + D + 2), neg, dtype=np.int32)
    Hb[:, 1:band + 1] = np.where(lo[0][:, None] + k <= nt[:, None], 0, neg)
    Hw, Ew = windows(Hb, band, axis=1), windows(Eb, band, axis=1)
    ends: dict = {}
    for p in range(P):
        ends.setdefault(int(nq[p]), []).append(p)
    final = np.full((P, band), neg, dtype=np.int32)
    if 0 in ends:
        final[ends[0]] = Hb[ends[0], 1:band + 1]
    F = np.empty((P, band), dtype=np.int32)
    F[:, 0] = neg
    for i in range(1, R + 1):
        d = lo[i] - lo[i - 1]
        Hd = Hw[pidx, d]
        Hp = Hw[pidx, d + 1]
        Ep = Ew[pidx, d + 1]
        Ecur = np.maximum(Hp - oe, Ep - e)
        t = Tw[pidx, lo[i]]
        q = Q[i - 1][:, None]
        s = mismatch + (match - mismatch) * (t == q).view(np.int8)
        s[(t == 4) | (q == 4)] = 0
        Ht = np.maximum(Hd + s, Ecur)
        if short:
            off = (lo[i][:, None] + k) > nt[:, None]
            Ht[off] = neg
        cm = _prefix_max(Ht + ek)
        np.subtract(cm[:, :-1], oe - e, out=F[:, 1:])
        F[:, 1:] -= ek[1:]
        H = np.maximum(Ht, F)
        if short:
            H[off] = neg
            Ecur[off] = neg
        Hb[:, 1:band + 1] = H
        Eb[:, 1:band + 1] = Ecur
        if i in ends:
            final[ends[i]] = H[ends[i]]
    out = []
    for p in range(P):
        row = final[p]
        ok = row > neg // 2
        if not ok.any():
            out.append((int(NEG), 0))
            continue
        best = row[ok].max()
        kk = int(np.flatnonzero((row == best) & ok)[0])
        out.append((int(best), int(lo[nq[p], p]) + kk))
    return out
