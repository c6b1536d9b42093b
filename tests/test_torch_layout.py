"""The group vote layout (``consensus/layout.py``): every voter's record
written once, in its draft's coordinates, where the C vote reads it.

Held, byte for byte, to the plain path of the JAX package
(``c3poa_tpu``), which the port does not share: each record aligned
against its window by ``c3poa_tpu/ref/banded.py:align_and_trace`` and
re-expressed in the draft's coordinates by ``embed_record``, then voted by
the numpy ``vote_consensus`` over ``record_for_draft`` and those records
(or merged by ``pairwise_merge``, or routed to the POA graph by the
package's scalar ``_diverged_owner``); a whole run against the package's
``run_pipeline`` with its ``NumpyBackend``."""

import os

import numpy as np
import pytest
import torch
from c3poa_tpu.consensus import engine as jax_pkg_engine
from c3poa_tpu.consensus.pairwise import pairwise_merge
from c3poa_tpu.consensus.vote import (SubreadAln, record_for_draft,
                                      vote_consensus)
from c3poa_tpu.pipeline.backend import NumpyBackend as JaxPkgNumpyBackend
from c3poa_tpu.pipeline.run import PipelineConfig as JaxPkgConfig
from c3poa_tpu.pipeline.run import run_pipeline as jax_pkg_run_pipeline
from c3poa_tpu.ref import banded

from c3poa_tpu_torch import native, sim
from c3poa_tpu_torch.consensus import engine
from c3poa_tpu_torch.consensus import vote as port_vote
from c3poa_tpu_torch.consensus.engine import (ConsensusJob, ConsensusParams,
                                              consensus_align,
                                              consensus_build_pairs,
                                              consensus_many)
from c3poa_tpu_torch.kernels import banded as tbk
from c3poa_tpu_torch.pipeline.backend import NumpyBackend
from c3poa_tpu_torch.pipeline.run import (PipelineConfig,
                                          _device_prepare_group,
                                          run_pipeline)
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
from c3poa_tpu_torch.utils import encode, prof

torch.set_num_threads(1)

FIELDS = ("cover", "base", "qpos", "ins_len", "ins_qstart")


def _piece(rng, seq, err=0.05):
    codes = encode(sim.mutate(rng, seq, err / 2, err / 4, err / 4))
    return codes, rng.integers(3, 40, len(codes)).astype(np.int8)


def _job(rng, kind, with_read):
    """One job of a kind: ``full`` (core copies and two windowed dangling
    fragments), ``pairwise`` (two full copies), ``lone`` (one copy and one
    windowed fragment), ``draft_only`` (one copy and a fragment with no
    anchor), ``chimeric`` (every other copy with a third more bases inside),
    ``empty`` (no copy) or ``single`` (one copy, no fragment)."""
    n = int(rng.integers(200, 420))
    ins = sim.random_seq(rng, n)
    other = sim.random_seq(rng, n // 3)
    core = {"full": int(rng.integers(3, 6)), "pairwise": 2, "lone": 1,
            "draft_only": 1, "chimeric": 4, "empty": 0, "single": 1}[kind]
    subs = []
    for k in range(core):
        seq = ins if kind != "chimeric" or k % 2 == 0 \
            else ins[:n // 2] + other + ins[n // 2:]
        subs.append(_piece(rng, seq))
    dang = []
    if kind in ("full", "lone"):
        dang.append(_piece(rng, ins[-int(n * rng.uniform(0.25, 0.6)):]))
    if kind == "full":
        dang.append(_piece(rng, ins[:int(n * rng.uniform(0.25, 0.6))]))
    if kind in ("draft_only", "empty"):
        dang.append(_piece(rng, sim.random_seq(rng, 150)))
    pieces = subs + dang
    job = ConsensusJob([c for c, _ in subs], [q for _, q in subs],
                       [c for c, _ in dang], [q for _, q in dang])
    if with_read and pieces:
        # the pieces cut from one read, with a few bases between them
        codes, quals, starts = [], [], []
        at = 0
        for c, q in pieces:
            gap = int(rng.integers(0, 5))
            codes.append(encode(sim.random_seq(rng, gap)))
            quals.append(np.full(gap, 9, np.int8))
            starts.append(at + gap)
            codes.append(c)
            quals.append(q)
            at += gap + len(c)
        read_c, read_q = np.concatenate(codes), np.concatenate(quals)
        job = ConsensusJob([read_c[s:s + len(c)] for s, (c, _) in
                            zip(starts, subs)],
                           [read_q[s:s + len(c)] for s, (c, _) in
                            zip(starts, subs)],
                           [read_c[s:s + len(c)] for s, (c, _) in
                            zip(starts[len(subs):], dang)],
                           [read_q[s:s + len(c)] for s, (c, _) in
                            zip(starts[len(subs):], dang)],
                           read=(read_c, read_q), starts=starts)
    return job


def _jobs(seed, kinds):
    rng = np.random.default_rng(seed)
    return [_job(rng, k, with_read=bool(i % 2)) for i, k in enumerate(kinds)]


def _window_records(state0, p):
    """The plain path (the JAX package's): each pair aligned against its
    window, then its record in the draft's coordinates
    (``embed_record``)."""
    layout = state0["layout"]
    out = []
    for v, pr in enumerate(state0["pairs"]):
        rec = banded.align_and_trace(
            pr[0], pr[2], match=p.match, mismatch=p.mismatch,
            gap_open=p.gap_open, gap_ext=p.gap_ext, band=pr[3])
        nt = int(layout.job_nt[layout.owner[v]])
        out.append((rec, banded.embed_record(rec, int(layout.w_off[v]), nt)))
    return out


def _assert_record(got, want, what):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, f"{what} {name}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
    assert (got.j_start, got.j_end) == (want.j_start, want.j_end), what


@pytest.mark.parametrize("route", ["device", "host", "serial"])
def test_placed_records_equal_embedded_window_records(monkeypatch, route):
    """The C record build writes each record at its voter's slot equal to
    ``embed_record`` of the window record in all five arrays and the
    span, over a slot set beforehand to a pattern no record holds;
    ``align_many``'s own record of each pair stays the window record
    (target coordinates, the kernel's score).  ``host``: targets over 320
    columns take the host aligner and are copied in; ``serial``: the
    numpy and CPU backends' aligner copies every record in."""
    if route == "host":
        monkeypatch.setattr(tbk, "FWD_MAX_TARGET", 320)
    p = ConsensusParams()
    state0 = consensus_build_pairs(
        _jobs(11, ["full"] * 4 + ["lone", "pairwise"]), p)
    layout = state0["layout"]
    assert (layout.w_off > 0).any() and (layout.w_off == 0).any()
    prof.reset()
    layout.bind()
    for buf in layout.records():
        buf.fill(0x5A if buf.dtype == np.int8 else 0x5A5A5A5A)
    align = engine.serial_align_many if route == "serial" \
        else TorchBackend("cpu").align_many
    out = align(state0["pairs"], p)
    counts = prof.current.counts
    V = len(state0["pairs"])
    assert len(out) == V and layout.placed.all()
    if route == "serial":
        assert counts["vote_layout_copied"] == V
        assert "vote_layout_placed" not in counts
    elif route == "device":
        assert counts["vote_layout_placed"] == V
        assert "vote_layout_copied" not in counts
    else:
        assert 0 < counts["vote_layout_copied"] < V
        assert counts["vote_layout_placed"] + counts["vote_layout_copied"] \
            == V
    for v, (rec, emb) in enumerate(_window_records(state0, p)):
        _assert_record(layout.voter(v).rec, emb, f"voter {v}")
        _assert_record(out[v].rec, rec, f"pair {v}")
        assert out[v].rec.score == rec.score
        np.testing.assert_array_equal(out[v].query, state0["pairs"][v][0])
        np.testing.assert_array_equal(out[v].qual, state0["pairs"][v][1])


def test_smaller_group_leaves_no_stale_byte():
    """A larger group, then a smaller one in the same arena slot, the
    slot's buffers set between them to a pattern no record holds: every
    byte of the smaller group's layout is the embedded records'."""
    p = ConsensusParams()
    backend = TorchBackend("cpu")
    native.set_arena_slot(0)
    big = consensus_build_pairs(_jobs(12, ["full"] * 6), p)
    consensus_align(big, backend.align_many)
    for (name, slot, phase), buf in native._ARENAS.items():
        if name.startswith("layout_") and slot == 0:
            buf.fill(0x5A if buf.dtype == np.int8 else 0x5A5A5A5A)
    small = consensus_build_pairs(_jobs(13, ["full", "lone"]), p)
    assert len(small["pairs"]) < len(big["pairs"])
    st = consensus_align(small, backend.align_many)
    layout = st["layout"]
    embs = [emb for _rec, emb in _window_records(small, p)]
    for name in FIELDS:
        got = getattr(layout, name)
        want = np.concatenate([getattr(e, name) for e in embs])
        assert len(got) == len(want)
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(
        layout.j_span, [(e.j_start, e.j_end) for e in embs])
    want_codes = np.concatenate(
        [c for job in small["jobs"] for c in
         ([job.read[0]] if job.read is not None
          else job.subreads + job.dangling)])
    np.testing.assert_array_equal(layout.codes, want_codes)


def _plain_align(codes, quals, t, p):
    rec = banded.align_and_trace(
        codes, t, match=p.match, mismatch=p.mismatch, gap_open=p.gap_open,
        gap_ext=p.gap_ext, band=p.band)
    return SubreadAln(rec, codes, quals)


def _plain_consensus(jobs, p, align=_plain_align):
    """The consensus of each job by the JAX package's plain path (see
    module doc); ``align(codes, quals, window, p)`` gives a voter's
    SubreadAln in the window's coordinates."""
    out = []
    for job in jobs:
        r = len(job.subreads)
        if r == 0:
            out.append((np.zeros(0, np.int8), np.zeros(0, np.int8)))
            continue
        if r == 1 and not job.dangling:
            out.append((job.subreads[0], job.sub_quals[0]))
            continue
        di = jax_pkg_engine.pick_draft(job.subreads)
        draft = np.asarray(job.subreads[di], np.int8)
        draft_q = np.asarray(job.sub_quals[di], np.int8)
        members = [(job.subreads[i], job.sub_quals[i], False)
                   for i in range(r) if i != di]
        members += [(c, q, True) for c, q in
                    zip(job.dangling, job.dangling_quals)]
        others = []
        for codes, quals, dang in members:
            win = jax_pkg_engine._window_pair(codes, draft, p, dang)
            if win is None:
                continue
            t, off = win
            a = align(codes, quals, t, p)
            others.append(SubreadAln(banded.embed_record(a.rec, off,
                                                         len(draft)),
                                     a.query, a.qual))
        if jax_pkg_engine._diverged_owner(others, p.poa_fallback):
            out.append(jax_pkg_engine._poa_consensus_read(
                job.subreads, job.sub_quals)[:2])
            continue
        if p.pairwise and r == 2 and len(others) == 1:
            a = others[0]
            out.append(pairwise_merge(draft, draft_q, a.rec, a.query,
                                      a.qual))
            continue
        out.append(vote_consensus(
            len(draft), [record_for_draft(draft, draft_q)] + others,
            qmin=p.qmin, use_native=False))
    return out


KINDS = ["full", "pairwise", "full", "lone", "chimeric", "draft_only",
         "empty", "full", "single", "pairwise", "full", "chimeric"]


@pytest.mark.parametrize("aligner,library", [
    ("torch", "native"), ("torch", "python"), ("serial", "native")])
def test_vote_from_layout_equals_plain_vote(monkeypatch, aligner, library):
    """Jobs with windowed dangling voters, host-copied voters (targets
    over 320 columns), 2-voter pairwise jobs, routed jobs, a job whose
    only voter is its draft and empty jobs: the layout's vote gives each
    job exactly the plain path's consensus; without the native library
    (the records built and voted in Python) too."""
    monkeypatch.setattr(tbk, "FWD_MAX_TARGET", 320)
    if library == "python":
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", True)
    p = ConsensusParams()
    jobs = _jobs(14, KINDS)
    prof.reset()
    align = TorchBackend("cpu").align_many if aligner == "torch" else None
    got = consensus_many(jobs, p, align)
    counts = dict(prof.current.counts)
    want = _plain_consensus(jobs, p)
    for j, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"job {j} codes")
        np.testing.assert_array_equal(g[1], w[1], err_msg=f"job {j} quals")
    assert counts["poa_fallback_reads"] == 2
    assert counts["vote_layout_copied"] > 0
    if aligner == "torch" and library == "native":
        assert counts["vote_layout_placed"] > 0
    else:
        assert "vote_layout_placed" not in counts
    assert ("vote_native" in prof.current.times) == (library == "native")


def _draft_as_record(codes, quals, t, p, make=port_vote.record_for_draft):
    return make(np.asarray(t), np.full(len(t), 20, np.int8))


def test_records_an_aligner_did_not_place_are_copied_in():
    """An aligner that knows nothing of the layout, and returns for each
    pair the window aligned to itself as the record, query and qualities
    (the benchmark's draft control): the vote takes those records and
    query bytes, as it took what ``align_many`` returned before the
    layout, routing included."""
    p = ConsensusParams()
    jobs = _jobs(18, KINDS)
    prof.reset()
    got = consensus_many(jobs, p, lambda pairs, p: [
        _draft_as_record(*pr[:3], p) for pr in pairs])
    assert prof.current.counts["vote_layout_copied"] > 0
    want = _plain_consensus(jobs, p, lambda *a: _draft_as_record(
        *a, make=record_for_draft))
    for j, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"job {j} codes")
        np.testing.assert_array_equal(g[1], w[1], err_msg=f"job {j} quals")


def test_diverged_owner_matches_the_scalar_loop():
    """The per-job divergence test over the layout's spans and query
    lengths routes exactly the jobs the JAX package's scalar
    ``_diverged_owner`` does over the plain path's records, thresholds
    near each job's own mean included."""
    p = ConsensusParams()
    jobs = _jobs(15, KINDS)
    state0 = consensus_build_pairs(jobs, p)
    layout = consensus_align(state0)["layout"]
    by_owner = {}
    for v, (_rec, emb) in enumerate(_window_records(state0, p)):
        pr = state0["pairs"][v]
        by_owner.setdefault(int(layout.owner[v]), []).append(
            SubreadAln(emb, np.asarray(pr[0], np.int8),
                       np.asarray(pr[1], np.int8)))
    means = {}
    for ji, vs in by_owner.items():
        means[ji] = sum(
            min(max(a.rec.j_end - a.rec.j_start, 0), max(len(a.query), 1))
            / max(max(a.rec.j_end - a.rec.j_start, 0),
                  max(len(a.query), 1), 1) for a in vs) / len(vs)
    for f in [0.0, 0.5, 0.97, 1.0] + list(means.values()) \
            + [np.nextafter(m, 2) for m in means.values()]:
        got = engine._diverged_owner(layout, f)
        want = [jax_pkg_engine._diverged_owner(by_owner.get(ji, []), f)
                for ji in range(len(jobs))]
        assert got.tolist() == want, f


def test_pipeline_torch_cpu_matches_numpy(tmp_path):
    """A small run with full, dangling and zero-repeat reads (groups of
    4, so both arena slots turn over): the port's ``TorchBackend("cpu")``
    and ``NumpyBackend`` each write the bytes the JAX package's
    ``run_pipeline`` with its ``NumpyBackend`` writes; the torch run
    placed its records and voted in C, and no ``embed`` stage is left."""
    rng = np.random.default_rng(16)
    splint = sim.random_seq(rng, 100)
    reads = [sim.make_read(rng, f"r{i}", splint,
                           insert_len=int(rng.integers(400, 800)),
                           n_copies=c, frag_frac=f)
             for i, (c, f) in enumerate(
                 [(3, (0.5, 0.5)), (0, (0.8, 0.8)), (2, (0.0, 0.0)),
                  (5, (0.3, 0.7)), (1, (0.6, 0.6)), (0, (0.9, 0.7)),
                  (4, (0.5, 0.2)), (2, (0.4, 0.6)), (6, (0.5, 0.5))])]
    sim.write_fastq(str(tmp_path / "reads.fastq"), reads)
    sim.write_fasta(str(tmp_path / "splint.fasta"), {"Splint1": splint})
    args = (str(tmp_path / "reads.fastq"), str(tmp_path / "splint.fasta"))
    outs = {}
    for name, backend in (("torch", TorchBackend("cpu")),
                          ("numpy", NumpyBackend())):
        outs[name] = str(tmp_path / name)
        run_pipeline(*args, outs[name],
                     PipelineConfig(lencutoff=300, group_size=4), backend)
    outs["jax_package"] = str(tmp_path / "jax_package")
    jax_pkg_run_pipeline(*args, outs["jax_package"],
                         JaxPkgConfig(lencutoff=300, group_size=4),
                         JaxPkgNumpyBackend())
    for rel in ("Splint1/R2C2_Consensus.fasta", "Splint1/R2C2_Subreads.fastq"):
        want = open(os.path.join(outs["jax_package"], rel), "rb").read()
        assert len(want) > 0, rel
        for name in ("torch", "numpy"):
            got = open(os.path.join(outs[name], rel), "rb").read()
            assert got == want, (name, rel)
    import json
    st = json.load(open(os.path.join(outs["torch"], "c3poa_stats.json")))
    assert st["counters"]["vote_layout_placed"] > 0
    assert "embed" not in st["stages_s"] and "vote_native" in st["stages_s"]


def test_two_in_flight_groups_cannot_share_a_layout():
    """A group's device prep claims its arena slot before it binds its
    layout there: a second group on a slot still held raises
    ``ArenaSlotCollision`` and writes nothing."""
    p = ConsensusParams()
    hprep = {"state0": consensus_build_pairs(_jobs(17, ["full"]), p),
             "z_states": []}
    lease = native.claim_arena_slot(1)
    try:
        with pytest.raises(native.ArenaSlotCollision):
            _device_prepare_group(hprep, PipelineConfig(), NumpyBackend(), 1)
        assert not hasattr(hprep["state0"]["layout"], "cover")
    finally:
        native.release_arena_slot(1, lease)
    prep = _device_prepare_group(hprep, PipelineConfig(), NumpyBackend(), 1)
    native.release_arena_slot(1, prep["arena_lease"])
    assert prep["state"]["layout"].placed.all()


def test_a_consensus_over_its_buffer_is_voted_alone():
    """A job whose consensus outgrows the batched vote's buffer (2 nt + 64:
    a 60-base draft and three fragments with three bases inserted after
    each of its bases) is voted again alone and gives the plain path's
    consensus."""
    rng = np.random.default_rng(19)
    draft = sim.random_seq(rng, 60)
    long = "".join(b + sim.random_seq(rng, 3) for b in draft)
    q = np.full(len(long), 30, np.int8)
    job = ConsensusJob([encode(draft)], [np.full(60, 30, np.int8)],
                       [encode(long)] * 3, [q] * 3)
    p = ConsensusParams(poa_fallback=0)   # the fragments look diverged
    got, = consensus_many([job], p)
    want, = _plain_consensus([job], p)
    assert len(want[0]) > 2 * 60 + 64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
