"""A read group's vote layout: every voter's alignment record written
once, at its final place, in its draft's coordinates.

The layout is exactly what the C vote (``native_src/traceback.c:
c3_vote_jobs``) indexes: a job's voters are contiguous, each at stride
``nt`` (its draft's length) for cover, base and qpos and ``nt + 1`` for
ins_len and ins_qstart, with a (j_start, j_end) span a voter in draft
coordinates.  A windowed voter (a dangling fragment aligned against a
draft window) sits at its window offset, the columns outside the window
as ``ref/banded.py:embed_record`` leaves them.  The voters' queries,
qualities and the drafts are read from one blob of the group's reads.

``consensus_build_pairs`` (the locate thread) sizes the layout and gives
each pair its destination; ``consensus_align`` (the align thread, its
record-arena slot claimed) binds it to the slot's grow-only buffers
(``native.slot_arena``); the aligner writes each record there: the C
record build in place (``TorchBackend``), a host-aligned record by a copy
(``serial_align_many``, ``put``).  ``consensus_finalize`` votes from it.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..ref.banded import AlignRecord
from ..utils import prof
from .vote import SubreadAln


class VoteLayout:
    """Job ``ji``'s voters are ``jv_off[ji]:jv_off[ji + 1]``; voter ``v``'s
    cover/base/qpos start at ``vnt_off[v]``, its ins_len/ins_qstart at
    ``vnt_off[v] + v``; its query is ``codes[q_off[v]:][:q_len[v]]``, its
    window the draft's ``[w_off[v], w_off[v] + w_len[v])`` (at ``t_off[v]``
    in the blob); job ``ji``'s draft is ``codes[dr_off[ji]:][:job_nt[ji]]``.
    """

    def __init__(self, n_jobs: int):
        self.n_jobs = n_jobs
        self._codes: list = []   # the blob's pieces, in order
        self._quals: list = []
        self._size = 0
        self.job_nt = np.zeros(n_jobs, dtype=np.int64)
        self.dr_off = np.zeros(n_jobs, dtype=np.int64)

    def _piece(self, codes, quals) -> int:
        at = self._size
        self._codes.append(codes)
        self._quals.append(quals)
        self._size += len(codes)
        return at

    def add_job(self, ji: int, job, di: int) -> list:
        """Put job ``ji``'s read (or, without one, its pieces) in the blob
        and its draft, subread ``di``; returns each piece's blob offset,
        the subreads' then the dangling fragments'."""
        if job.read is not None:
            at = self._piece(*job.read)
            starts = [at + s for s in job.starts]
        else:
            starts = [self._piece(c, q) for c, q in
                      zip(job.subreads + job.dangling,
                          job.sub_quals + job.dangling_quals)]
        self.job_nt[ji] = len(job.subreads[di])
        self.dr_off[ji] = starts[di]
        return starts

    def finish(self, voters: list) -> None:
        """``voters``: one (job, query's blob offset, query length, window
        offset, window length) a voter, in job order."""
        g = np.array(voters, dtype=np.int64).reshape(-1, 5)
        owner, self.q_off, self.q_len, self.w_off, self.w_len = (
            np.ascontiguousarray(c) for c in g.T)
        self.jv_off = np.zeros(self.n_jobs + 1, dtype=np.int64)
        np.cumsum(np.bincount(owner, minlength=self.n_jobs),
                  out=self.jv_off[1:])
        self.vnt_off = np.zeros(len(g) + 1, dtype=np.int64)
        np.cumsum(self.job_nt[owner], out=self.vnt_off[1:])
        self.t_off = self.dr_off[owner] + self.w_off
        self.owner = owner

    def bind(self) -> None:
        """Give the layout the current arena slot's buffers and fill the
        read blob.  Call on the thread that claimed the slot, before the
        records are built."""
        V, tot = len(self.owner), int(self.vnt_off[-1])
        arena = native.slot_arena
        self.cover = arena("layout_cover", tot, np.int8)
        self.base = arena("layout_base", tot, np.int8)
        self.qpos = arena("layout_qpos", tot, np.int32)
        self.ins_len = arena("layout_ins_len", tot + V, np.int32)
        self.ins_qstart = arena("layout_ins_qstart", tot + V, np.int32)
        self.j_span = arena("layout_j_span", 2 * V, np.int32).reshape(V, 2)
        self.score = np.zeros(V, dtype=np.int64)
        self.placed = np.zeros(V, dtype=bool)
        self.codes = arena("layout_codes", self._size, np.int8)
        self.quals = arena("layout_quals", self._size, np.int8)
        if self._codes:
            np.concatenate(self._codes, out=self.codes)
            np.concatenate(self._quals, out=self.quals)

    # ---------------- writing ----------------

    def place(self, ops, rows, voters, j_ends, scores) -> None:
        """One launch's records, built by C at their voters' slots (row
        ``rows[k]`` of the packed walk ``ops`` is voter ``voters[k]``'s)."""
        native.place_records(
            ops, rows, voters, j_ends, self.codes,
            (self.q_off, self.q_len, self.t_off, self.w_len, self.w_off,
             self.vnt_off), self.records())
        self.score[voters] = scores
        self.placed[voters] = True
        prof.current.count("vote_layout_placed", len(voters))

    def put(self, v: int, rec: AlignRecord) -> None:
        """Copy voter ``v``'s record, aligned against its window, into its
        slot (``embed_record``'s result, every byte of the slot written)."""
        a, off = int(self.vnt_off[v]), int(self.w_off[v])
        nt = int(self.vnt_off[v + 1]) - a
        for arr, val, fill, at, end in (
                (self.cover, rec.cover, 0, a, a + nt),
                (self.base, rec.base, 4, a, a + nt),
                (self.qpos, rec.qpos, -1, a, a + nt),
                (self.ins_len, rec.ins_len, 0, a + v, a + v + nt + 1),
                (self.ins_qstart, rec.ins_qstart, -1, a + v,
                 a + v + nt + 1)):
            row = arr[at:end]
            row[:off] = fill
            row[off:off + len(val)] = val
            row[off + len(val):] = fill
        self.j_span[v] = rec.j_start + off, rec.j_end + off
        self.score[v] = rec.score
        self.placed[v] = True
        prof.current.count("vote_layout_copied")

    def fill_missing(self, alns) -> None:
        """Copy in the records an aligner returned without placing them
        (``alns[v]`` is voter ``v``'s, in its window's coordinates).  Where
        such an aligner returned other query bytes than the pair's, the
        vote reads those, from the read blob's end."""
        extra_c, extra_q = [], []
        at = self._size
        for v in np.flatnonzero(~self.placed).tolist():
            rec, query, qual = alns[v]
            self.put(v, rec)
            q0, n = int(self.q_off[v]), int(self.q_len[v])
            if not (np.array_equal(query, self.codes[q0:q0 + n])
                    and np.array_equal(qual, self.quals[q0:q0 + n])):
                self.q_off[v], self.q_len[v] = at, len(query)
                extra_c.append(query)
                extra_q.append(qual)
                at += len(query)
        if extra_c:
            self.codes = np.concatenate([self.codes, *extra_c]).astype(np.int8)
            self.quals = np.concatenate([self.quals, *extra_q]).astype(np.int8)

    # ---------------- reading ----------------

    def records(self) -> tuple:
        """The record buffers as the C record build and vote take them."""
        return (self.cover, self.base, self.qpos, self.ins_len,
                self.ins_qstart, self.j_span.reshape(-1))

    def vote_c(self, jobs, qmin: int) -> list | None:
        """``native.vote_jobs_c`` of jobs ``jobs``, read in place."""
        return native.vote_jobs_c(
            jobs, (self.jv_off, self.vnt_off, self.q_off, self.dr_off,
                   self.job_nt), self.records(), self.codes, self.quals,
            qmin=qmin)

    def view(self, v: int) -> AlignRecord:
        """Voter ``v``'s record in its window's coordinates: views of the
        window's columns (what the aligner's own record held)."""
        a, off, wl = int(self.vnt_off[v]), int(self.w_off[v]), \
            int(self.w_len[v])
        s, s1 = a + off, a + v + off
        return AlignRecord(self.cover[s:s + wl], self.base[s:s + wl],
                           self.qpos[s:s + wl],
                           self.ins_len[s1:s1 + wl + 1],
                           self.ins_qstart[s1:s1 + wl + 1],
                           int(self.j_span[v, 0]) - off,
                           int(self.j_span[v, 1]) - off, int(self.score[v]))

    def voter(self, v: int) -> SubreadAln:
        """Voter ``v``'s record in its draft's coordinates, its query and
        qualities from the read blob (all views)."""
        a, b = int(self.vnt_off[v]), int(self.vnt_off[v + 1])
        q0, q1 = int(self.q_off[v]), int(self.q_off[v] + self.q_len[v])
        rec = AlignRecord(self.cover[a:b], self.base[a:b], self.qpos[a:b],
                          self.ins_len[a + v:b + v + 1],
                          self.ins_qstart[a + v:b + v + 1],
                          int(self.j_span[v, 0]), int(self.j_span[v, 1]),
                          int(self.score[v]))
        return SubreadAln(rec, self.codes[q0:q1], self.quals[q0:q1])

    def voters(self, ji: int) -> list:
        return [self.voter(v) for v in range(int(self.jv_off[ji]),
                                             int(self.jv_off[ji + 1]))]

    def draft(self, ji: int) -> tuple:
        a, b = int(self.dr_off[ji]), int(self.dr_off[ji] + self.job_nt[ji])
        return self.codes[a:b], self.quals[a:b]


class PlacedAln:
    """``align_many``'s record of a pair the C build placed in a vote
    layout: reads as a ``SubreadAln`` (rec, query, qual) whose ``rec`` is
    a view of the window's columns of the voter's slot, built when first
    read."""

    __slots__ = ("layout", "v", "_query", "_qual", "_rec")

    def __init__(self, layout: VoteLayout, v: int, query, qual):
        self.layout, self.v = layout, v
        self._query, self._qual, self._rec = query, qual, None

    @property
    def rec(self) -> AlignRecord:
        if self._rec is None:
            self._rec = self.layout.view(self.v)
        return self._rec

    @property
    def query(self) -> np.ndarray:
        return np.asarray(self._query, dtype=np.int8)

    @property
    def qual(self) -> np.ndarray:
        return np.asarray(self._qual, dtype=np.int8)

    def __iter__(self):
        return iter((self.rec, self.query, self.qual))
