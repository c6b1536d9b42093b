"""The postprocess demux of a group in one C call
(``native_src/demux.c`` through ``pipeline/postprocess.py:_demux_native``)
held to its spec, the Python path (``_demux_python``): the same reads and
adapter hits through both, the same bytes in every destination file and
the same ``PostprocessStats``.  The hits are built here, not by a kernel,
so that every rule's edge is reached: '+' positions 1-3 (where Python's
negative slice start wraps), minus under 16 and under 40, positions past
the read's end and below 0, scores exactly at ``score_min``, second hits,
index ties and margins of exactly 1, single, mixed-length and oddly named
index files, lowercase and N bases, non-ASCII names.  Each fallback (no
library, an index wider than the C DP row, a non-ASCII sequence, an index
named '-') gives the Python path's result, its exception included.  The
index match's distances (``overlap.c``, bit-parallel) are held to the
plain DP of the reference's loop."""

import itertools

import numpy as np
import pytest

from c3poa_tpu_torch import native, sim
from c3poa_tpu_torch.io.fastx import FastxRecord
from c3poa_tpu_torch.pipeline import postprocess
from c3poa_tpu_torch.pipeline.postprocess import (PostprocessConfig,
                                                  PostprocessStats)
from c3poa_tpu_torch.ref.lev import levenshtein

ADAPTERS = list(sim.DEFAULT_ADAPTERS.items())
COMBOS = [(name, strand, len(seq)) for name, seq in ADAPTERS
          for strand in "+-"]
PLUS = [c for c, m in enumerate(COMBOS) if m[1] == "+"]
MINUS = [c for c, m in enumerate(COMBOS) if m[1] == "-"]
SCORE_MIN = 10


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n)) if n else ""


def index_file(kind):
    """[(name, seq)] in file order."""
    rng = np.random.default_rng(5)
    a, b = rand_seq(rng, 10), rand_seq(rng, 10)
    if kind == "none":
        return []
    if kind == "four":
        return [(f"Index{i}", rand_seq(rng, 10)) for i in range(1, 5)]
    if kind == "single":
        return [("Only", a)]
    if kind == "mixed":    # the window truncation; a 22-mer no window fits
        return [("I12", rand_seq(rng, 12)), ("I6", rand_seq(rng, 6)),
                ("I10", a), ("I8", rand_seq(rng, 8)),
                ("I22", rand_seq(rng, 22))]
    if kind == "ties":     # one edit apart (ties, margin 1), two apart
        a1 = a[:4] + "ACGT"[("ACGT".index(a[4]) + 1) % 4] + a[5:]
        b2 = "".join("ACGT"[("ACGT".index(x) + 1) % 4] if k in (2, 7) else x
                     for k, x in enumerate(b))
        return [("A", a), ("A1", a1), ("B", b), ("B2", b2)]
    if kind == "names":    # a name twice, a sequence twice, no_index_found
        return [("Index1", a), ("Index2", b), ("Index1", rand_seq(rng, 10)),
                ("no_index_found", rand_seq(rng, 10)), ("Index3", a),
                ("", rand_seq(rng, 10))]
    raise ValueError(kind)


def tables(indexes):
    """``run_postprocess``'s idx_to_seq and seq_to_idx."""
    idx_to_seq, seq_to_idx = {}, {}
    for name, seq in indexes:
        idx_to_seq[name] = seq
        seq_to_idx[seq] = name
    return idx_to_seq, seq_to_idx


def plant(seq, at, text):
    """seq with text written over it from ``at`` (kept inside seq)."""
    out = list(seq)
    for k, ch in enumerate(text):
        if 0 <= at + k < len(out):
            out[at + k] = ch
    return "".join(out)


def mutate(rng, s, k):
    s = list(s)
    for p in rng.choice(len(s), min(k, len(s)), replace=False):
        s[p] = "ACGT"[("ACGT".index(s[p].upper()) + 1) % 4]
    return "".join(s)


# (plus, minus) as functions of the read's length n: every slice edge
FORCED = [
    lambda n: (1, n // 2), lambda n: (2, 12), lambda n: (3, 30),
    lambda n: (5, 14), lambda n: (20, 39), lambda n: (n - 2, n + 5),
    lambda n: (n + 3, n + 40), lambda n: (-5, 8), lambda n: (0, n),
    lambda n: (n // 3, n + 1), lambda n: (45, 60), lambda n: (30, 30),
    lambda n: (31, 30),
]


def make_group(seed, indexes, n_reads=160):
    """(records, six (B, C) hit arrays)."""
    rng = np.random.default_rng(seed)
    C = len(COMBOS)
    s1 = rng.integers(0, SCORE_MIN + 1, (n_reads, C))
    s2 = np.where(rng.random((n_reads, C)) < 0.5, -(2 ** 30),
                  rng.integers(0, SCORE_MIN + 1, (n_reads, C)))
    qe1 = rng.integers(0, 25, (n_reads, C))
    qs1 = rng.integers(0, 25, (n_reads, C))
    j1 = rng.integers(0, 300, (n_reads, C))
    ts1 = rng.integers(0, 300, (n_reads, C))
    records = []
    for b in range(n_reads):
        n = int(rng.choice([0, 3, 17, 25, 45, 80, 150, 260, 400]))
        seq = rand_seq(rng, n)
        if b % 7 == 3:      # lowercase and N bases
            seq = "".join(ch.lower() if rng.random() < 0.3 else
                          "N" if rng.random() < 0.05 else ch for ch in seq)
        if b < len(FORCED):
            plus, minus = FORCED[b](n)
        else:
            plus = int(rng.choice([1, 2, 3, rng.integers(4, max(n, 5)),
                                   n + int(rng.integers(-3, 30))]))
            minus = plus + int(rng.choice([rng.integers(1, 16),
                                           rng.integers(16, 45),
                                           rng.integers(1, max(n, 2))]))
            if rng.random() < 0.05:
                minus = plus - int(rng.integers(0, 5))
        if indexes and rng.random() < 0.85:
            name, idx = indexes[int(rng.integers(len(indexes)))]
            idx = mutate(rng, idx, int(rng.choice([0, 0, 1, 2])))
            if rng.random() < 0.1:
                idx = idx.lower()
            where = rng.random()
            at = int(rng.integers(0, max(21 - len(idx), 1)))  # in a window
            if where < 0.5 or where > 0.85:        # the 5' junction
                seq = plant(seq, plus - 4 + at, idx)
            if where >= 0.5:                       # the 3' junction
                seq = plant(seq, minus + 4 - at - len(idx), sim.revcomp(idx))
        p_c = int(rng.choice(PLUS))
        m_c = int(rng.choice(MINUS))
        for c, pos in ((p_c, plus), (m_c, minus)):
            s1[b, c] = SCORE_MIN + 1 if b % 5 == 0 else \
                int(rng.integers(SCORE_MIN + 1, 60))
            alen = COMBOS[c][2]
            if c in PLUS:
                j1[b, c] = pos - 1 - (alen - 1 - qe1[b, c])
            else:
                ts1[b, c] = pos + qs1[b, c]
            r = rng.random()
            s2[b, c] = SCORE_MIN + 1 if r < 0.06 else \
                SCORE_MIN if r < 0.3 else s2[b, c]
        r = rng.random()
        if r < 0.04:                     # a hit at exactly score_min
            s1[b, p_c if r < 0.02 else m_c] = SCORE_MIN
        elif r < 0.08:                   # a third hit
            c = int(rng.integers(C))
            if c not in (p_c, m_c):
                s1[b, c] = SCORE_MIN + 1
        name = f"r{b}"
        if b % 11 == 4:
            name += " é读\tx"
        records.append(FastxRecord(name, seq, None))
    return records, [s1, j1, qe1, ts1, qs1, s2]


def run(fn, records, hits, cfg, indexes):
    """Files, stats and the exception of one path over a group."""
    idx_to_seq, seq_to_idx = tables(indexes)
    writers, stats = postprocess._MemWriters(), PostprocessStats()
    err = native_ran = None
    try:
        native_ran = fn(records, hits, COMBOS, cfg, writers, idx_to_seq,
                        seq_to_idx, stats)
    except Exception as e:   # noqa: BLE001 - compared between the paths
        err = (type(e), str(e))
    return writers.blobs(), stats, err, native_ran


FLAGS = list(itertools.product([False, True], repeat=3))
KINDS = ["none", "four", "single", "mixed", "ties", "names"]
CASES = [("parity", kind, flags) for kind in KINDS for flags in FLAGS] + \
    [("half_score", "four", (True, False, False))] + \
    [(fb, "four", (True, False, False))
     for fb in ("no_library", "wide_index", "non_ascii_seq", "dash_name")]


def case_id(case):
    c, kind, flags = case
    return "-".join([c, kind, "".join(f if on else "_"
                                      for f, on in zip("tub", flags))])


@pytest.mark.parametrize("case,kind,flags", CASES,
                         ids=[case_id(c) for c in CASES])
def test_c_demux_equals_the_python_path(monkeypatch, case, kind, flags):
    trim, undirectional, barcoded = flags
    # half_score: a score_min between integers (hits at SCORE_MIN pass)
    cfg = PostprocessConfig(trim=trim, undirectional=undirectional,
                            barcoded=barcoded,
                            score_min=SCORE_MIN - 0.5 * (case == "half_score"))
    indexes = index_file(kind)
    seed = 1000 + KINDS.index(kind) * 8 + FLAGS.index(flags)
    records, hits = make_group(seed, indexes)
    assert native.available()
    if case == "wide_index":
        indexes = indexes + [("Wide", "ACGT" * 16)]
    elif case == "dash_name":
        indexes = indexes + [("-", "GATTACAGAT")]
    elif case == "non_ascii_seq":
        for b, rec in enumerate(records):
            if len(rec.seq) > 100:
                records[b] = rec._replace(seq="é" + rec.seq[1:])
    elif case == "no_library":
        monkeypatch.setattr(native, "get_lib", lambda: None)

    want = run(postprocess._demux_python, records, hits, cfg, indexes)
    calls = []

    def spy(*args):
        calls.append(post_demux_c(*args))
        return calls[-1]

    post_demux_c = native.post_demux_c
    monkeypatch.setattr(native, "post_demux_c", spy)
    got = run(postprocess._demux, records, hits, cfg, indexes)
    assert got[:3] == want[:3]
    # the C call ran, or the Python path did (and raised, for a
    # non-ASCII sequence)
    native_ran = case in ("parity", "half_score")
    assert got[3] is (None if case == "non_ascii_seq" else native_ran)
    if native_ran and indexes:
        # each written read's index is the directory it was filed under
        outcome, chosen, _texts = calls[0]
        names = list(tables(indexes)[1].values())
        for rec, o, x in zip(records, outcome, chosen):
            assert (o == 0) == (x >= 0)
            if o == 0:
                flc = want[0][names[x] + "/" + postprocess._Writers.FLC] \
                    if names[x] else want[0][postprocess._Writers.FLC]
                assert f">{rec.name}_" in flc
    files, stats, err, _ = want
    if case == "non_ascii_seq":
        assert err and err[0] is UnicodeEncodeError
        return
    assert err is None
    # the group reaches every outcome and, with indexes, the mux
    assert stats.total == len(records) and stats.written > 20
    assert min(stats.no_adapter, stats.wrong_order) > 0
    assert stats.no_direction > 0 or undirectional
    assert ("R2C2_oligodT_multiplexing.tsv" in files) == bool(indexes)
    if indexes and case != "dash_name":   # '-' is every no-match's name
        assert 0 < stats.no_index < stats.written
        # reads filed under an index, not only under no_index_found
        assert any(k.count("/") and not k.startswith("no_index_found/")
                   for k in files)
    assert ("R2C2_full_length_consensus_reads_10X_sequences.fasta"
            in files) == barcoded


def test_c_demux_reaches_the_slice_edges():
    """The forced positions are in the hits: plus 1-3 and below 0, minus
    under 16 and past the read, scores and second hits at the limit."""
    records, (s1, j1, qe1, ts1, qs1, s2) = make_group(1000, index_file("four"))
    hits = postprocess.extract_hits
    pos = [hits(COMBOS, s1[b], j1[b], qe1[b], ts1[b], qs1[b], s2[b],
                SCORE_MIN) for b in range(len(records))]
    plus = {h["+"][0].position for h in pos if len(h["+"]) == 1}
    minus = {(h["-"][0].position, len(r.seq)) for h, r in zip(pos, records)
             if len(h["-"]) == 1}
    assert {1, 2, 3, -5} <= plus
    assert any(m < 16 for m, _n in minus) and any(m > n for m, n in minus)
    assert (s1 == SCORE_MIN).any() and (s2 == SCORE_MIN).any()
    assert (s2 == SCORE_MIN + 1).any()


def plain_min_dists(seq, idx_seqs):
    """The reference's distance loop (C3POa_postprocessing.py:269-278):
    positions outer, indexes inner, a break at the first index whose
    window overruns; an index with no window reads its own length."""
    dists = {i: [] for i in range(len(idx_seqs))}
    for position in range(len(seq)):
        for i, idx_seq in enumerate(idx_seqs):
            query = seq[position:position + len(idx_seq)]
            if len(query) != len(idx_seq):
                break
            dists[i].append(levenshtein(query, idx_seq))
    return [min(dists[i]) if dists[i] else len(idx_seqs[i])
            for i in range(len(idx_seqs))]


@pytest.mark.parametrize("lens", [(10, 10, 10, 10), (12, 6, 10, 8, 22),
                                  (1, 2, 3), (0, 5), (63, 40), (33, 64)])
def test_index_distances_equal_the_plain_levenshtein(lens):
    """The C index match (bit-parallel, ``overlap.c``) against the plain
    DP, windows of 0-80 bytes with lowercase and N, indexes planted with
    0-2 edits; an index over 63 bases gives None (the Python path)."""
    rng = np.random.default_rng(sum(lens))
    idx_seqs = tuple(rand_seq(rng, m) for m in lens)
    for trial in range(60):
        n = int(rng.integers(0, 81))
        seq = "".join(rng.choice(list("ACGTACGTacgN"), n))
        if trial % 2:
            idx = mutate(rng, idx_seqs[trial % len(lens)], trial % 3)
            seq = plant(seq, int(rng.integers(0, max(n - len(idx), 0) + 1)),
                        idx)
        got = native.sliding_min_dists_c(seq, idx_seqs)
        if max(lens) > 63:
            assert got is None
            return
        assert got.tolist() == plain_min_dists(seq, idx_seqs), seq
