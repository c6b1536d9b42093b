"""The plain reference of a postprocess cell: ``c3poa-postprocess``'s
adapter hits, trim, reorientation and oligo-dT demux in plain torch on
the CPU.

A frozen copy of ``c3poa_tpu_torch/tools/plain_postprocess.py``, equal to
it below this docstring (``h100_bench/tests/test_h100_post.py`` holds
the two equal), kept here so that nothing the program ships can change
the yardstick; it imports nothing of the program.  ``dtype`` exists for
the control: the same reference one precision below (int8), which has to
come out as not correct.
"""

from __future__ import annotations

import torch

# the local alignment's scoring: match, mismatch, gap (linear); N (code
# 4) scores 0 against anything
MATCH, MISMATCH, GAP = 1, -3, 3
# a second hit's span may share at most this many read columns with the
# best hit's span
OVERLAP_TOL = 4
# a hit counts when its local score exceeds this (BLAT's matches > 10)
SCORE_MIN = 10
# s2 where no column qualifies
NO_HIT = -(2 ** 30)

# Semantics, and where they depart from C3POa v2.2.3's
# C3POa_postprocessing.py (the line numbers are that file's):
#
# - Hits (:112-263).  Each adapter is aligned forward ('+') and reverse
#   complemented ('-') to every read by a local alignment with linear
#   gaps at (MATCH, MISMATCH, GAP), keeping per read column j the best
#   score of a path ending there over all adapter rows (the earliest row
#   wins ties), with that path's adapter end row, read start column and
#   adapter start row.  Within a row the diagonal wins ties against the
#   gap from the row above, and a path reaching j along the row keeps the
#   rightmost source column among equals.  A diagonal step from a cell
#   <= 0 starts a new path at (j, row).  Departure: upstream aligns with
#   BLAT and reads its PSL; here a local alignment stands in, a hit
#   counts at score > SCORE_MIN (BLAT's matches > 10), and the '-'
#   strand is the reverse-complemented adapter aligned forward, whose
#   coordinates equal BLAT's minus-strand arithmetic.
# - Best two (no upstream counterpart: BLAT reports every hit).  s1 is
#   the best column score, taken at the first column with it (j1, with
#   its qe1, ts1, qs1); s2 the best score over columns whose span
#   [ts[j], j] shares at most OVERLAP_TOL columns with [ts1, j1]
#   (NO_HIT where none does).  A passing s2 is a second hit of the same
#   adapter, so dimers fail the exactly-one rule below.
# - Positions (:252-263): '+' hit at j1 + 1 + (adapter length - 1 -
#   qe1), '-' hit at ts1 - qs1 (extrapolated to the adapter's ends).
# - Rules (:287-336): exactly one '+' and one '-' hit, the '-' after the
#   '+'; the direction '+' where the '+' hit is the 5' adapter, '-' where
#   it is the other, none where both are one adapter (undirectional: '+').
# - Index (:266-285, :338-362): the junction windows seq[plus-4:plus+16]
#   and revcomp(seq[minus-16:minus+4]) (Python slices, negative starts
#   included); an index matches a window at its least Levenshtein
#   distance over the window's sliding windows of the index's length,
#   index i seeing positions p <= len(window) - (longest index listed up
#   to i); the best index is taken at distance < 2 with a margin > 1 to
#   the next.  A read whose forward window alone matches is '-' with that
#   index, its reverse window alone '+'; else it goes to
#   ``no_index_found``.  Departure: an index with no whole window scores
#   its own length, where upstream raises.
# - Records (:364-384): name_<trimmed length>; the full-length record
#   trimmed (-t) or padded by 40 on each side, reoriented; the splint
#   files; the 10x file with upstream's literal 'plus'/'minus' suffix; the
#   mux TSV line (name, reverse window, forward window) of every read that
#   reached the index step.  Departure: records are written in input
#   order, not through post_tmp_* trees catted in glob order.

FLC = "R2C2_full_length_consensus_reads.fasta"
LEFT = "R2C2_full_length_consensus_reads_left_splint.fasta"
RIGHT = "R2C2_full_length_consensus_reads_right_splint.fasta"
TENX = "R2C2_full_length_consensus_reads_10X_sequences.fasta"
MUX = "R2C2_oligodT_multiplexing.tsv"
NO_INDEX = "no_index_found"

_CODE = torch.full((256,), 4, dtype=torch.int64)
for _k, _b in enumerate(b"ACGT"):
    _CODE[_b] = _k
    _CODE[_b + 32] = _k          # lower case
_SCORE = torch.full((5, 5), MISMATCH, dtype=torch.int64)
_SCORE.fill_diagonal_(MATCH)
_SCORE[4, :] = 0
_SCORE[:, 4] = 0
_COMP = {ord(a): ord(b) for a, b in zip("ACGTacgt", "TGCAtgca")}


def encode(seq: str) -> torch.Tensor:
    """A=0 C=1 G=2 T=3, anything else 4."""
    if not seq:
        return torch.zeros(0, dtype=torch.int64)
    return _CODE[torch.frombuffer(bytearray(seq, "ascii"),
                                  dtype=torch.uint8).long()]


def revcomp(seq: str) -> str:
    """Reverse complement; characters other than ACGT (either case) stay."""
    return seq.translate(_COMP)[::-1]


def revcomp_codes(codes) -> torch.Tensor:
    codes = torch.as_tensor(codes, dtype=torch.int64)
    return torch.tensor([3, 2, 1, 0, 4])[codes].flip(0)


def local_hits(adapter, reads: torch.Tensor, dtype=torch.int32):
    """Per read column of each row of ``reads`` ((B, L) codes, padded
    with 4): the best local score of a path ending there, its adapter end
    row, read start column and adapter start row; (B, L) each, computed
    in ``dtype`` row by row over the adapter, vectorised over the
    columns.  Columns past a read's end do not change its own columns."""
    B, L = reads.shape
    cols = torch.arange(L)
    jd = cols.to(dtype)
    zeros = torch.zeros((B, L), dtype=dtype)
    H, TS, QS = zeros, zeros, zeros          # the row above (row -1: 0)
    colmax, qend, tstart, qstart = zeros, zeros, zeros, zeros
    pad = torch.zeros((B, 1), dtype=dtype)
    for i, a in enumerate(torch.as_tensor(adapter).tolist()):
        s = _SCORE[a][reads].to(dtype)
        Hd = torch.cat([pad, H[:, :-1]], 1)
        live = Hd > 0
        diag = Hd + s
        dTS = torch.where(live, torch.cat([pad, TS[:, :-1]], 1), jd)
        dQS = torch.where(live, torch.cat([pad, QS[:, :-1]], 1),
                          torch.tensor(i, dtype=dtype))
        up = H - GAP
        take = diag >= up
        T = torch.where(take, diag, up).clamp_min(0)
        tTS = torch.where(take, dTS, TS)
        tQS = torch.where(take, dQS, QS)
        # along the row: H[j] = max over k <= j of T[k] - GAP * (j - k),
        # from the rightmost such k
        A = T + GAP * jd
        best = torch.cummax(A, 1).values
        src = torch.where(A == best, cols, 0).cummax(1).values
        H = best - GAP * jd
        TS = tTS.gather(1, src)
        QS = tQS.gather(1, src)
        better = H > colmax
        colmax = torch.where(better, H, colmax)
        qend = torch.where(better, torch.tensor(i, dtype=dtype), qend)
        tstart = torch.where(better, TS, tstart)
        qstart = torch.where(better, QS, qstart)
    return colmax, qend, tstart, qstart


def best_two(colmax, qend, tstart, qstart, lens: torch.Tensor):
    """(s1, j1, qe1, ts1, qs1, s2), (B,) int64 each, over each read's own
    ``lens[b]`` columns."""
    B, L = colmax.shape
    cols = torch.arange(L)
    inside = cols[None, :] < lens[:, None]
    cm = torch.where(inside, colmax.long(), -1)
    s1 = cm.max(1).values
    j1 = torch.where(cm == s1[:, None], cols, L).min(1).values
    at = j1[:, None]
    qe1 = qend.long().gather(1, at)[:, 0]
    ts1 = tstart.long().gather(1, at)[:, 0]
    qs1 = qstart.long().gather(1, at)[:, 0]
    overlap = torch.minimum(cols[None, :], at) - \
        torch.maximum(tstart.long(), ts1[:, None]) + 1
    ok = inside & (overlap <= OVERLAP_TOL)
    s2 = torch.where(ok, cm, NO_HIT).max(1).values
    return s1, j1, qe1, ts1, qs1, s2


def adapter_hits(reads, combos, dtype=torch.int32) -> list:
    """Six (B, C) int64 tensors (s1, j1, qe1, ts1, qs1, s2) of every read
    (code arrays) against every combo (code arrays)."""
    lens = torch.tensor([len(r) for r in reads], dtype=torch.int64)
    if (lens < 1).any():
        raise ValueError("a read with no bases has no best column")
    R = torch.full((len(reads), int(lens.max())), 4, dtype=torch.int64)
    for b, r in enumerate(reads):
        R[b, :len(r)] = torch.as_tensor(r, dtype=torch.int64)
    per = [best_two(*local_hits(c, R, dtype), lens) for c in combos]
    return [torch.stack([p[k] for p in per], 1) for k in range(6)]


def combos_of(adapters) -> list:
    """[(name, strand, length, codes)]: each adapter of ``adapters``
    ([(name, seq)], file order) forward, then reverse complemented."""
    out = []
    for name, seq in adapters:
        codes = encode(seq)
        out.append((name, "+", len(seq), codes))
        out.append((name, "-", len(seq), revcomp_codes(codes)))
    return out


def hits_of(combos, row) -> dict:
    """A read's hits {'+': [(adapter, position)], '-': [...]} from its
    six values ``row`` (each (C,)), combos in order; a passing second
    hit lists the adapter twice."""
    s1, j1, qe1, ts1, qs1, s2 = (r.tolist() for r in row)
    hits = {"+": [], "-": []}
    for c, (name, strand, alen, _codes) in enumerate(combos):
        if s1[c] <= SCORE_MIN:
            continue
        pos = j1[c] + 1 + (alen - 1 - qe1[c]) if strand == "+" \
            else ts1[c] - qs1[c]
        hits[strand].append((name, pos))
        if s2[c] > SCORE_MIN:
            hits[strand].append((name, pos))
    return hits


def levenshtein_windows(seq: str, index: str) -> list:
    """Levenshtein distance of ``index`` to each window of its length in
    ``seq``, vectorised over the windows."""
    m = len(index)
    P = len(seq) - m + 1
    if P < 1:
        return []
    # raw bytes, so that characters other than ACGT compare as themselves
    raw = torch.frombuffer(bytearray(seq, "ascii"), dtype=torch.uint8).long()
    win = torch.stack([raw[p:p + m] for p in range(P)])     # (P, m)
    idx = torch.frombuffer(bytearray(index, "ascii"), dtype=torch.uint8).long()
    cols = torch.arange(m + 1, dtype=torch.int32)
    prev = cols.repeat(P, 1)
    for i in range(1, m + 1):
        cur = torch.empty_like(prev)
        cur[:, 0] = i
        cur[:, 1:] = torch.minimum(prev[:, 1:] + 1,
                                   prev[:, :-1] + (win != idx[i - 1]).int())
        # along the row: cur[j] = min over t <= j of cur[t] + (j - t)
        prev = torch.cummin(cur - cols, 1).values + cols
    return prev[:, m].tolist()


def match_index(window: str, indexes) -> str:
    """The index name ``window`` matches, or '-' (``indexes``: [(name,
    seq)], file order)."""
    if not indexes:
        return "-"
    dists = []
    longest = 0
    for name, seq in indexes:
        longest = max(longest, len(seq))
        seen = window[:max(0, len(window) - longest + len(seq))]
        d = levenshtein_windows(seen, seq)
        dists.append((min(d) if d else len(seq), name))
    dists.sort(key=lambda x: x[0])
    best = dists[0][0]
    second = dists[1][0] if len(dists) > 1 else float("inf")
    return dists[0][1] if best < 2 and second - best > 1 else "-"


def read_records(name: str, seq: str, hits: dict, indexes, trim: bool,
                 undirectional: bool = False, barcoded: bool = False):
    """(outcome, [(file, text)]) of one read: outcome 'written',
    'no_adapter', 'wrong_order' or 'no_direction'; each file relative to
    the output directory."""
    plus, minus = hits["+"], hits["-"]
    if len(plus) != 1 or len(minus) != 1:
        return "no_adapter", []
    (p_name, p), (m_name, m) = plus[0], minus[0]
    if m <= p:
        return "wrong_order", []
    if undirectional:
        direction = "+"
    elif p_name != m_name:
        direction = "+" if p_name == "5Prime_adapter" else "-"
    else:
        return "no_direction", []
    writes = []
    subdir = ""
    if indexes:
        fwd = seq[p - 4:p + 16]
        rev = revcomp(seq[m - 16:m + 4])
        writes.append((MUX, f"{name}\t{rev}\t{fwd}\n"))
        f_idx, r_idx = match_index(fwd, indexes), match_index(rev, indexes)
        names = {n for n, _s in indexes}
        if f_idx in names and r_idx not in names:
            direction, subdir = "-", f_idx
        elif r_idx in names and f_idx not in names:
            direction, subdir = "+", r_idx
        else:
            subdir = NO_INDEX
    where = (subdir + "/") if subdir else ""
    insert = seq[p:m]
    padded = seq[max(p - 40, 0):m + 40]
    head = f">{name}_{len(insert)}\n"
    if direction == "+":
        full = insert if trim else padded
        left, right = seq[m:], revcomp(seq[:p])
        tenx = revcomp(seq[m - 40:m]) + "plus"
    else:
        full = revcomp(insert if trim else padded)
        left, right = revcomp(seq[:p + 40]), seq[m:]
        tenx = seq[p:p + 40] + "minus"
    writes += [(where + FLC, head + full + "\n"),
               (where + LEFT, head + left + "\n"),
               (where + RIGHT, head + right + "\n")]
    if barcoded:
        writes.append((TENX, head + tenx + "\n"))
    return "written", writes


def postprocess(reads, adapters, indexes=None, trim: bool = False,
                undirectional: bool = False, barcoded: bool = False,
                dtype=torch.int32):
    """The whole run over ``reads`` ([(name, seq)]): ({file: text} of
    every file written, {outcome: reads})."""
    combos = combos_of(adapters)
    hits = adapter_hits([encode(s) for _n, s in reads],
                        [c[3] for c in combos], dtype)
    files: dict = {}
    outcomes: dict = {}
    for b, (name, seq) in enumerate(reads):
        outcome, writes = read_records(
            name, seq, hits_of(combos, [h[b] for h in hits]), indexes,
            trim, undirectional, barcoded)
        outcomes[outcome] = outcomes.get(outcome, 0) + 1
        for f, text in writes:
            files[f] = files.get(f, "") + text
    return files, outcomes
