"""PyTorch compute backend (counterpart of
``c3poa_tpu/pipeline/tpu_backend.py``).

Follows the backend contract of this package's ``pipeline/backend.py``,
so ``run_pipeline`` and ``run_postprocess`` drive it unchanged:

- ``locate_many``: reads are sorted by length and batched through the
  fused locate step (``kernels/locate.py``: the splint-profile kernel,
  combo argmax, smoothing, peak candidates); combo ids, scores and the
  compacted candidates return to the host, which runs the distance
  selection and re-decides flagged reads exactly.
- ``align_many``: (query, target) pairs are batched by band, longest
  first, through the banded forward kernel and the path-walk kernel
  (``kernels/banded.py``); the packed ops come back and native C builds
  the records.
- ``adapter_hits``: reads are batched longest first through the
  adapter-hits kernel (``kernels/adapters.py``) for postprocessing.

With several ``devices`` (``parallel/mesh.py``, the role of
``TpuBackend(mesh=...)``), each launch's batch is cut into one
contiguous share a device, each launched on its device and stream, and
the shares' outputs are joined in order before the host uses them.

Batching is this backend's own choice (no fixed compile shapes): a batch
is padded only to its own longest member, and no output depends on how
the items are batched.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import native
from ..consensus.engine import (ConsensusParams, _pair_band,
                                serial_align_many)
from ..consensus.vote import SubreadAln
from ..device import resolve_device
from ..kernels import banded as kbanded
from ..kernels import sw_profile
from ..kernels.adapters import adapter_hits
from ..kernels.banded import (SMAX, banded_align_trace, ops_to_record,
                              unpack_ops_packed)
from ..kernels.locate import locate_device, profile_rows_combo
from ..kernels.peaks import (margin_competitors_host, select_peaks_host,
                             tile_for_distance)
from ..parallel.mesh import Mesh
from ..ref.banded import normalize_record
from ..ref.peaks import exact_peaks_from_profile
from ..state import splint_array
from ..utils import prof
from .backend import LocateResult, NumpyBackend

# Reads longer than this take the exact host path (NumpyBackend) in
# locate and adapter hits, as reads beyond the JAX backend's largest
# length bucket do.
MAX_READ_LEN = 131072
# reads per locate launch and pairs per align launch
MAX_LOCATE_BATCH = 512
MAX_ALIGN_BATCH = 2048
# reads per adapter launch: a postprocess group of 1000 reads is one
# launch of 4000 blocks
MAX_ADAPTER_BATCH = 1024
# int32 profile elements (B * C * L) per locate launch: 256 MB
LOCATE_BUDGET = 64 << 20
# bytes of move words (P * nq * W / 2) per align launch
ALIGN_BUDGET = 1 << 30
# record-arena phases one align_many call may use: the zero-repeat batch
# of a group starts at phase 16 (pipeline/run.py), so the main batch
# must stay below it
MAX_ALIGN_LAUNCHES = 16


def _round_up(n: int, k: int) -> int:
    return max(k, -(-n // k) * k)


class TorchBackend:
    supports_overlap = True

    def __init__(self, device="cuda", devices=None):
        """``device``: "cuda", "cuda:N" or "cpu" (no fallback between
        them).  ``devices``: the devices of this process to cut every
        launch over (of ``device``'s type; may repeat one), default
        ``[device]``."""
        device = resolve_device(device)
        devices = [torch.device(d) for d in devices or [device]]
        if any(d.type != device.type for d in devices):
            raise ValueError(f"devices {[str(d) for d in devices]} are not "
                             f"all {device.type}")
        self.mesh = Mesh(devices)
        self._splint_lock = threading.Lock()
        self._splint_cache: dict = {}

    def _splints(self, combos) -> tuple[np.ndarray, dict]:
        """(C, m) splint codes, and {device: their tensor}."""
        key = tuple(id(c.codes) for c in combos)
        with self._splint_lock:
            hit = self._splint_cache.get(key)
            if hit is None:
                # the combos are kept with the tensors so their ids stay
                # theirs while the entry lives
                S = splint_array(combos)
                hit = (tuple(combos), S, self.mesh.replicate(S))
                self._splint_cache[key] = hit
            return hit[1], hit[2]

    # ---------------- locate ----------------

    def locate_many(self, reads, combos, min_dist) -> list[LocateResult]:
        S_np, S = self._splints(combos)
        C = len(combos)
        if not sw_profile.profile_fits(S_np.shape[1]):
            # splints too long for the profile kernel's tiles: every read
            # takes the exact host path, on both devices
            prof.current.count("long_splint_host_located", len(reads))
            with prof.current.stage("locate_host"):
                return NumpyBackend().locate_many(reads, combos, min_dist)
        out: list = [None] * len(reads)
        overlong = [i for i, r in enumerate(reads) if len(r) > MAX_READ_LEN]
        if overlong:
            prof.current.count("overlong_reads_host_located", len(overlong))
            with prof.current.stage("locate_host"):
                host = NumpyBackend().locate_many(
                    [reads[i] for i in overlong], combos, min_dist)
            for i, r in zip(overlong, host):
                out[i] = r
        # dispatch every batch first (the device runs ahead), then
        # materialize
        tile = tile_for_distance(int(min_dist))
        launches = []
        with prof.current.stage("locate_dispatch"):
            for chunk, R, lens in self._read_batches(
                    reads, [i for i, r in enumerate(reads)
                            if len(r) <= MAX_READ_LEN], C, MAX_LOCATE_BATCH):
                prof.current.count("locate_launches")
                prof.current.count("locate_cells_padded", R.size * C)
                prof.current.count("locate_cells_real", int(lens.sum()) * C)
                launches.append((chunk, self.mesh.dispatch(
                    lambda dev, r, ln: locate_device(r, ln, S[dev],
                                                     tile=tile),
                    R, lens)))

        deep_rerun: list[int] = []
        margin_rerun: list[int] = []
        for chunk, res in launches:
            with prof.current.stage("locate_wait"):
                combo, score, cand_pos, cand_h, _med, deep, marg = \
                    self.mesh.gather(res)
            with prof.current.stage("locate_select"):
                peaks = select_peaks_host(cand_pos, cand_h, int(min_dist))
                marg = marg | margin_competitors_host(cand_pos, cand_h,
                                                      int(min_dist))
                for r, i in enumerate(chunk):
                    out[i] = LocateResult(int(combo[r]), int(score[r]),
                                          peaks[r].astype(np.int64))
                    if deep[r]:
                        deep_rerun.append(i)
                    elif marg[r]:
                        margin_rerun.append(i)
        if deep_rerun or margin_rerun:
            with prof.current.stage("locate_rerun"):
                self._rerun_flagged(reads, out, S, C, deep_rerun,
                                    margin_rerun, min_dist)
        return out

    def _read_batches(self, reads, idxs, C, cap):
        """Longest-first batches of the reads ``idxs``: yields (batch
        idxs, (B, L) int8 codes padded with 4, (B,) int32 lengths), L the
        batch's longest read rounded up to 64, B within ``cap`` and
        LOCATE_BUDGET."""
        order = sorted(idxs, key=lambda i: -len(reads[i]))
        start = 0
        while start < len(order):
            L = _round_up(len(reads[order[start]]), 64)
            B = max(1, min(cap, LOCATE_BUDGET // (C * L)))
            chunk = order[start:start + B]
            start += B
            R = np.full((len(chunk), L), 4, dtype=np.int8)
            lens = np.zeros(len(chunk), dtype=np.int32)
            for r, i in enumerate(chunk):
                R[r, :len(reads[i])] = reads[i]
                lens[r] = len(reads[i])
            yield chunk, R, lens

    def _rerun_flagged(self, reads, out, S, C, deep_rerun, margin_rerun,
                       min_dist):
        """deep: a tile held more than the 2 candidates the compaction
        keeps; margin: an f32 decision sat within the f32-vs-f64 flip
        zone.  Both re-decide the peaks in f64 on the host from the
        chosen combo's exact int32 profile row (combo and score stay as
        the device chose them)."""
        if deep_rerun:
            prof.current.count("peaks_deep_host_rerun", len(deep_rerun))
        if margin_rerun:
            prof.current.count("peaks_margin_host_rerun", len(margin_rerun))
        fetches = []
        for chunk, R, lens in self._read_batches(
                reads, deep_rerun + margin_rerun, C, MAX_LOCATE_BATCH):
            combo = np.asarray([out[i].combo for i in chunk], dtype=np.int32)
            fetches.append((chunk, lens, self.mesh.dispatch(
                lambda dev, r, ln, cb: (profile_rows_combo(r, ln, S[dev],
                                                           cb),),
                R, lens, combo)))
        for chunk, lens, res in fetches:
            (rows,) = self.mesh.gather(res)
            for r, i in enumerate(chunk):
                pks = exact_peaks_from_profile(rows[r, :lens[r]], min_dist)
                out[i] = LocateResult(out[i].combo, out[i].score,
                                      pks.astype(np.int64))

    # ---------------- adapters (postprocessing) ----------------

    def adapter_hits(self, reads, combo_codes, combo_lens):
        """Best-two local hits with coordinates per (read, adapter
        combo): six (B, C) int64 arrays (s1, j1, qe1, ts1, qs1, s2) equal
        to ``NumpyBackend.adapter_hits``.  Like it, each combo runs over
        its own codes (``combo_lens`` is their length).  Reads go longest
        first through the adapter kernel (``kernels/adapters.py``), at
        most MAX_ADAPTER_BATCH a launch; reads over MAX_READ_LEN take
        the exact host path.  Counts each launch's real cells (its reads'
        columns times the combos' rows), padded cells (B x L x the combos'
        rows) and read columns."""
        B, C = len(reads), len(combo_codes)
        outs = [np.zeros((B, C), dtype=np.int64) for _ in range(6)]
        if not B or not C:
            return outs
        A = np.full((C, max(len(c) for c in combo_codes)), 4, dtype=np.int8)
        for c, codes in enumerate(combo_codes):
            A[c, :len(codes)] = codes
        A = self.mesh.replicate(A)
        alens = self.mesh.replicate(np.asarray([len(c) for c in combo_codes],
                                               dtype=np.int32))
        overlong = [i for i, r in enumerate(reads) if len(r) > MAX_READ_LEN]
        if overlong:
            prof.current.count("adapter_host_reads", len(overlong))
            with prof.current.stage("adapter_host"):
                host = NumpyBackend().adapter_hits(
                    [reads[i] for i in overlong], combo_codes, combo_lens)
            for k in range(6):
                outs[k][overlong] = host[k]
        rows = sum(len(c) for c in combo_codes)
        # dispatch every batch first, then materialize
        launches = []
        with prof.current.stage("adapter_dispatch"):
            for chunk, R, lens in self._read_batches(
                    reads, [i for i, r in enumerate(reads)
                            if len(r) <= MAX_READ_LEN], C,
                    MAX_ADAPTER_BATCH):
                prof.current.count("adapter_launches")
                prof.current.count("adapter_cells_padded", R.size * rows)
                prof.current.count("adapter_cells_real",
                                   int(lens.sum()) * rows)
                prof.current.count("adapter_read_columns", int(lens.sum()))
                launches.append((chunk, self.mesh.dispatch(
                    lambda dev, r, ln: adapter_hits(
                        r, ln, A[dev], alens[dev],
                        *NumpyBackend.ADAPTER_SCORING), R, lens)))
        for chunk, res in launches:
            with prof.current.stage("adapter_wait"):
                got = self.mesh.gather(res)
            for k, x in enumerate(got):
                outs[k][chunk] = x
        return outs

    # ---------------- align ----------------

    def align_many(self, pairs, params: ConsensusParams,
                   phase_base: int = 0) -> list[SubreadAln]:
        """``phase_base`` offsets the record-arena phase of this call's
        launches: a second align_many within one group (the zero-repeat
        overlap batch) must not reuse the main call's arena phases while
        both calls' records are alive (native.ops_records_batch)."""
        prof.current.count(
            "align_cells",
            sum(len(pr[0]) * _pair_band(pr, params) for pr in pairs))
        with prof.current.stage("align"):
            return self._align_many(pairs, params, phase_base)

    def _chunks(self, device_items):
        """(band, longest side, pair idx) items -> [(band, [pair idx])]:
        one band per launch, longest pairs first, at most
        MAX_ALIGN_LAUNCHES launches."""
        device_items.sort(key=lambda it: (it[0], -it[1], it[2]))
        n_runs = len({it[0] for it in device_items})
        min_p = -(-len(device_items) // max(1, MAX_ALIGN_LAUNCHES - n_runs))
        chunks = []
        start = 0
        while start < len(device_items):
            W = device_items[start][0]
            run = start
            while run < len(device_items) and device_items[run][0] == W:
                run += 1
            nq = _round_up(device_items[start][1], 64)
            cap = max(1, min(MAX_ALIGN_BATCH,
                             ALIGN_BUDGET // (nq * W // 2)))
            take = min(start + max(cap, min_p), run)
            chunks.append((W, [it[2] for it in device_items[start:take]]))
            start = take
        return chunks

    def _align_many(self, pairs, params: ConsensusParams,
                    phase_base: int = 0) -> list[SubreadAln]:
        out: list = [None] * len(pairs)
        serial: list[int] = []
        device_items = []
        overlong = 0
        for i, pr in enumerate(pairs):
            q, t = pr[0], pr[2]
            if len(t) > (SMAX - 1) * len(q) + 1:
                # extreme length mismatch: the band's shift ladder (SMAX)
                # cannot track the diagonal — the host aligner takes it
                serial.append(i)
                continue
            if _round_up(len(t), 64) > kbanded.FWD_MAX_TARGET:
                # a target row (padded as launched) wider than the forward
                # kernel stages: the host aligner, on both devices
                serial.append(i)
                overlong += 1
                continue
            device_items.append((_pair_band(pr, params),
                                 max(len(q), len(t)), i))
        if overlong:
            prof.current.count("align_overlong_host", overlong)
        if serial:
            with prof.current.stage("align_host"):
                res = serial_align_many([pairs[i] for i in serial], params)
            for i, r in zip(serial, res):
                out[i] = r

        # dispatch every launch first (the device runs ahead of the host
        # record building)
        launches = []
        with prof.current.stage("align_dispatch"):
            for W, chunk in self._chunks(device_items):
                launches.append((chunk,
                                 self._align_launch(pairs, chunk, W, params)))

        leftovers = []            # python-fallback work items
        rewalk: list[int] = []    # walks that ran out of steps
        # materialize and build records launch by launch: the GIL-free C
        # record build of launch k overlaps the device computing k + 1
        for li, (chunk, res) in enumerate(launches):
            with prof.current.stage("align_wait"):
                # one launch's shares joined before its records are built:
                # a share spends no record-arena phase of its own
                scores, j_ends, _j_starts, i_rem, ops, _edge = \
                    self.mesh.gather(res)
            work = []
            for r, i in enumerate(chunk):
                if i_rem[r] > 0:
                    rewalk.append(i)
                    continue
                q, qual, t = pairs[i][0], pairs[i][1], pairs[i][2]
                work.append((i, q, qual, t, ops[r], int(j_ends[r]),
                             int(scores[r])))
            if not work:
                continue
            with prof.current.stage("align_host_records"):
                if not native.available():
                    leftovers.extend(work)
                    continue
                # one GIL-released C call per launch; ``phase`` gives
                # each launch its own arena generation so all of a
                # group's records stay alive together
                recs = native.ops_records_batch(
                    [w[1] for w in work], [w[3] for w in work],
                    np.stack([w[4] for w in work]),
                    [w[5] for w in work], packed=True,
                    phase=li + phase_base)
                for (i, q, qual, _t, _o, _j, score), rec in zip(work, recs):
                    out[i] = SubreadAln(rec._replace(score=score),
                                        np.asarray(q, dtype=np.int8),
                                        np.asarray(qual, dtype=np.int8))
        if leftovers:
            with prof.current.stage("align_host_records"):
                for w in leftovers:
                    self._build_record(out, w)
        if rewalk:
            # paths longer than the walk's step budget: host realign
            prof.current.count("align_rewalk", len(rewalk))
            with prof.current.stage("align_host"):
                res = serial_align_many([pairs[i] for i in rewalk], params)
            for i, r in zip(rewalk, res):
                out[i] = r
        return out

    def _align_launch(self, pairs, chunk, W, params: ConsensusParams):
        """Pack the pairs ``chunk`` into padded (P, nq) / (P, nt) rows,
        upload them and launch one band-``W`` forward and walk."""
        nq = _round_up(max(len(pairs[i][0]) for i in chunk), 64)
        nt = _round_up(max(len(pairs[i][2]) for i in chunk), 64)
        P = len(chunk)
        Q = np.full((P, nq), 4, dtype=np.int8)
        T = np.full((P, nt), 4, dtype=np.int8)
        ql = np.zeros(P, dtype=np.int32)
        tl = np.zeros(P, dtype=np.int32)
        for r, i in enumerate(chunk):
            q, t = pairs[i][0], pairs[i][2]
            Q[r, :len(q)] = q
            T[r, :len(t)] = t
            ql[r], tl[r] = len(q), len(t)
        prof.current.count("align_launches")
        prof.current.count("align_cells_padded", P * nq * W)
        return self.mesh.dispatch(
            lambda _dev, q, t, a, b: banded_align_trace(
                q, t, a, b, band=W, match=params.match,
                mismatch=params.mismatch, gap_open=params.gap_open,
                gap_ext=params.gap_ext), Q, T, ql, tl)

    @staticmethod
    def _build_record(out, work_item):
        """One record from packed ops: the C path, else Python."""
        i, q, qual, t, ops_row, j_end, score = work_item
        rec = native.ops_record_normalize(q, t, ops_row, j_end, packed=True)
        if rec is None:  # no native library
            rec = ops_to_record(q, t, unpack_ops_packed(ops_row), j_end)
            rec = normalize_record(rec, q, t)
        out[i] = SubreadAln(rec._replace(score=score),
                            np.asarray(q, dtype=np.int8),
                            np.asarray(qual, dtype=np.int8))
