"""The comparison that decides ``correct`` for a consensus cell.

What the window produced is held to the plain reference of this folder
(``locate.py``, ``align.py``, ``segment.py``), which works everything
out again from the reads and the splint alone:

- ``device_diff``: every locate answer of every call in the window
  (combo, raw score, peaks of each read) that differs from the
  reference's; in one call drawn from the seed, every core alignment (a
  subread against its read's draft, as the reference cuts them) whose
  score or end column differs or that the program never made, and of
  the sampled reads' alignments every one whose whole record differs.
  Limit 0: the configuration states that the card's answers equal the
  spec's.
- ``records_diff``: reads of that call whose written subread records or
  consensus header (name, mean quality, raw length, repeats, consensus
  length) differ from what the reference's cut gives.  Limit 0.
- ``cons_err_pct``: the consensus of sampled reads against the truth
  the generator made: edits of the insert fitted into the written
  consensus (either strand), over the insert's bases, in percent; a
  missing consensus counts them all.  Its limit is the cell's.

The reference runs once the window has closed, in worker processes
(one a core), over the pool's distinct reads: every call feeds the same
pool, so one reference answer serves every call's answer for that read.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import align as ref_align
from . import locate as ref_locate
from . import segment as ref_segment

_DEC = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def decode(codes) -> bytes:
    return _DEC[np.asarray(codes, dtype=np.int64)].tobytes()


def phred(q) -> bytes:
    return (np.clip(np.asarray(q, dtype=np.int16), 0, 93) + 33
            ).astype(np.uint8).tobytes()


def fitting_edit_distance(query: np.ndarray, target: np.ndarray) -> int:
    """Edit distance of ``query`` against its best-matching substring of
    ``target`` (ends free on the target; ``bench.py``'s arithmetic)."""
    m, n = len(query), len(target)
    if m == 0:
        return 0
    if n == 0:
        return m
    j = np.arange(n + 1, dtype=np.int32)
    row = np.zeros(n + 1, dtype=np.int32)
    for i in range(m):
        sub = (target != query[i]).astype(np.int32)
        tmp = np.empty(n + 1, dtype=np.int32)
        tmp[0] = row[0] + 1
        np.minimum(row[:-1] + sub, row[1:] + 1, out=tmp[1:])
        row = np.minimum.accumulate(tmp - j) + j
    return int(row.min())


# ---------------- worker tasks (module level: sent to processes) -------

def _locate_task(args):
    idx, codes, combos, min_dist, dtype = args
    c, s, p = ref_locate.locate_read(codes, combos, min_dist, dtype)
    return idx, (c, s, np.asarray(p, dtype=np.int64))


def _align_task(args):
    key, q, t, params, band, band_dtype = args
    return key, ref_align.align_pair(q, t, params, band, band_dtype)


def _ends_task(args):
    keys, pairs, params, band_dtype = args
    return list(zip(keys, ref_align.forward_ends(pairs, params, band_dtype)))


def _cons_task(args):
    idx, truth, cons = args
    t = np.asarray(truth, dtype=np.int8)
    rc = _COMP[t][::-1]
    return idx, min(fitting_edit_distance(t, cons),
                    fitting_edit_distance(rc, cons))


def run_tasks(fn, tasks, procs: int):
    """Results of ``fn`` over ``tasks``, heaviest first, in ``procs``
    spawned worker processes (all ended before returning)."""
    if procs <= 1 or len(tasks) < 2:
        return [fn(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    # a worker that dies raises BrokenProcessPool here instead of being
    # replaced over and over
    with ProcessPoolExecutor(max_workers=procs, mp_context=ctx) as ex:
        return list(ex.map(fn, tasks))


def default_procs() -> int:
    return max(1, min(os.cpu_count() or 1, 8))


# ---------------- reading what the run wrote ----------------

def read_subreads(path: str) -> dict:
    """read name -> [(record name, seq bytes, qual bytes)] in file order."""
    out: dict = {}
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    for k in range(0, len(lines) - 3, 4):
        name = lines[k][1:].decode()
        out.setdefault(name.rsplit("_", 1)[0], []).append(
            (name, lines[k + 1], lines[k + 3]))
    return out


def read_consensus(path: str) -> dict:
    """read name -> (header, consensus codes)."""
    enc = np.full(256, 4, dtype=np.int8)
    for i, b in enumerate(b"ACGT"):
        enc[b] = i
    out: dict = {}
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    for k in range(0, len(lines) - 1, 2):
        header = lines[k][1:].decode()
        seq = np.frombuffer(lines[k + 1], dtype=np.uint8)
        out[header.rsplit("_", 4)[0]] = (header, enc[seq])
    return out


# ---------------- the comparison ----------------

def reference_locate(pool, combos, min_dist, dtype=np.float64, procs=1):
    tasks = sorted(((i, pool.seqs[i], combos, min_dist, dtype)
                    for i in range(len(pool.seqs))), key=lambda t: -len(t[1]))
    return dict(run_tasks(_locate_task, tasks, procs))


def expected_records(pool, ref_loc, combos, cli, idxs) -> dict:
    return {i: ref_segment.expected(pool.seqs[i], pool.quals[i],
                                    pool.names[i], ref_loc[i], combos, cli)
            for i in idxs}


def records_mismatch(pool, i, exp, subreads, consensus) -> bool:
    """Whether read i's written records differ from the expected ones."""
    name = pool.names[i]
    got_subs = subreads.get(name, [])
    want = [] if exp["subreads"] is None else [
        (n, decode(pool.seqs[i][a:b]), phred(pool.quals[i][a:b]))
        for n, a, b in exp["subreads"]]
    if [(n, s, q) for n, s, q in got_subs] != want:
        return True
    cons = consensus.get(name)
    if cons is None:
        return False          # a missing consensus counts in cons_err_pct
    if exp["header"] is None or exp["consensus"] is False:
        return True
    rname, raw_len, repeats = exp["header"]
    want_header = (f"{rname}_{ref_segment.avg_qual(pool.quals[i])}_"
                   f"{raw_len}_{repeats}_{len(cons[1])}")
    return cons[0] != want_header


def pick_pairs(pool, exp, align_reads, n_pairs, rng) -> list:
    """Core pairs of the sampled reads, as (read, (qa, qb), (ta, tb)):
    the longest always, the rest drawn from the seed."""
    pairs = [(i, qb_, tb_) for i in align_reads
             for qb_, tb_ in exp[i]["pairs"]]
    if len(pairs) <= n_pairs:
        return pairs
    longest = max(range(len(pairs)),
                  key=lambda k: (pairs[k][1][1] - pairs[k][1][0]) *
                  (pairs[k][2][1] - pairs[k][2][0]))
    rest = [k for k in range(len(pairs)) if k != longest]
    pick = [longest] + list(rng.choice(rest, n_pairs - 1, replace=False))
    return [pairs[k] for k in sorted(pick)]


def reference_align(pool, picked, params, band_dtype="float32", procs=1):
    tasks = []
    for i, (qa, qb), (ta, tb) in picked:
        q = pool.seqs[i][qa:qb]
        t = pool.seqs[i][ta:tb]
        tasks.append(((i, qa, qb, ta, tb), q, t, params,
                      params["band"], band_dtype))
    tasks.sort(key=lambda t: -len(t[1]) * len(t[2]))
    return dict(run_tasks(_align_task, tasks, procs))


def reference_ends(pool, exp, params, band_dtype="float32", procs=1) -> dict:
    """{(idx, qa, qb, ta, tb): (score, j_end)} of every core pair of the
    reads ``exp`` holds, in chunks of 192 pairs of like length (the
    batched rows run fastest near that width)."""
    chunk = 192
    keyed = sorted(((i, qa, qb, ta, tb)
                    for i, e in exp.items() for (qa, qb), (ta, tb)
                    in e["pairs"]), key=lambda k: (k[2] - k[1], k[4] - k[3]))
    tasks = []
    for c in range(0, len(keyed), chunk):
        keys = keyed[c:c + chunk]
        tasks.append((keys, [(pool.seqs[i][qa:qb], pool.seqs[i][ta:tb])
                             for i, qa, qb, ta, tb in keys],
                      params, band_dtype))
    tasks.reverse()
    return dict(kv for part in run_tasks(_ends_task, tasks, procs)
                for kv in part)


def cons_errors(pool, idxs, consensus, exp, procs=1) -> tuple:
    """(edits, insert bases) over reads ``idxs`` whose reference cut
    calls for a consensus."""
    tasks, missing, bases = [], 0, 0
    for i in idxs:
        if exp[i]["consensus"] is not True:
            continue
        truth = pool.truth[i]
        bases += len(truth)
        got = consensus.get(pool.names[i])
        if got is None:
            missing += len(truth)
            continue
        tasks.append((i, truth, got[1]))
    tasks.sort(key=lambda t: -len(t[1]) * len(t[2]))
    edits = sum(d for _i, d in run_tasks(_cons_task, tasks, procs))
    return edits + missing, bases


def check_consensus(pool, cli: dict, params: dict, capture, outputs: dict,
                    sample: dict, procs: int) -> dict:
    """The numbers compared, each {value} (the caller adds the limits).

    ``capture``: ``locate`` (one {pool idx: (combo, score, peaks)} a
    call), and of the chosen call ``ends`` ({(idx, qa, qb, ta, tb):
    (score, j_end)} of every alignment) and ``align`` (the same keys:
    whole records, of the sampled reads); ``outputs``: the chosen call's
    parsed ``subreads`` and ``consensus``; ``sample``: ``align_reads``,
    ``align_pairs`` (how many of their pairs to hold whole),
    ``record_reads``, ``cons_reads`` (pool indices) and ``rng``."""
    combos = ref_locate.combos_of(pool.splints)
    ref_loc = reference_locate(pool, combos, cli["mdistcutoff"],
                               procs=procs)
    loc_bad = 0
    for call in capture["locate"]:
        for i, got in call.items():
            want = ref_loc[i]
            if (got[0] != want[0] or got[1] != want[1]
                    or not np.array_equal(np.asarray(got[2]), want[2])):
                loc_bad += 1
    exp = expected_records(pool, ref_loc, combos, cli,
                           range(len(pool.seqs)))
    picked = pick_pairs(pool, exp, sample["align_reads"],
                        sample["align_pairs"], sample["rng"])
    ref_aln = reference_align(pool, picked, params, procs=procs)
    aln_bad = 0
    for key, want in ref_aln.items():
        got = capture["align"].get(key)
        if got is None or not ref_align.same_record(got, want):
            aln_bad += 1
    want_ends = reference_ends(pool, {i: exp[i] for i in
                                      sample["record_reads"]},
                               params, procs=procs)
    ends_bad = sum(capture["ends"].get(key) != want
                   for key, want in want_ends.items())
    rec_bad = sum(records_mismatch(pool, i, exp[i], outputs["subreads"],
                                   outputs["consensus"])
                  for i in sample["record_reads"])
    edits, bases = cons_errors(pool, sample["cons_reads"],
                               outputs["consensus"], exp, procs)
    return dict(
        device_diff=loc_bad + ends_bad + aln_bad,
        records_diff=rec_bad,
        cons_err_pct=100.0 * edits / max(bases, 1),
        parts=dict(locate_answers=sum(len(c) for c in capture["locate"]),
                   locate_diff=loc_bad, ends=len(want_ends),
                   ends_diff=ends_bad, pairs=len(ref_aln),
                   align_diff=aln_bad,
                   record_reads=len(sample["record_reads"]),
                   cons_reads=len(sample["cons_reads"]), cons_bases=bases))
