"""PyTorch compute backend (counterpart of
``c3poa_tpu/pipeline/tpu_backend.py``).

Follows the backend contract of ``c3poa_tpu/pipeline/backend.py``, so
``run_pipeline`` drives it unchanged:

- ``locate_many``: reads are sorted by length and batched through the
  fused locate step (``kernels/locate.py``: the splint-profile kernel,
  combo argmax, smoothing, peak candidates); combo ids, scores and the
  compacted candidates return to the host, which runs the distance
  selection and re-decides flagged reads exactly.
- ``align_many``: (query, target) pairs are batched by band, longest
  first, through the banded forward kernel and the path-walk kernel
  (``kernels/banded.py``); the packed ops come back and native C builds
  the records.

Batching is this backend's own choice (no fixed compile shapes): a batch
is padded only to its own longest member, and no output depends on how
the items are batched.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from c3poa_tpu import native
from c3poa_tpu.consensus.engine import (ConsensusParams, _pair_band,
                                        serial_align_many)
from c3poa_tpu.consensus.vote import SubreadAln
from c3poa_tpu.pipeline.backend import LocateResult, NumpyBackend
from c3poa_tpu.ref.banded import normalize_record
from c3poa_tpu.ref.peaks import exact_peaks_from_profile
from c3poa_tpu.utils import prof

from ..device import resolve_device
from ..kernels.banded import (SMAX, banded_align_trace, ops_to_record,
                              unpack_ops_packed)
from ..kernels.locate import locate_device, profile_rows_combo
from ..kernels.peaks import (margin_competitors_host, select_peaks_host,
                             tile_for_distance)
from ..state import splint_array, to_device

# Reads longer than this take the exact host locate (NumpyBackend), as
# reads beyond the JAX backend's largest length bucket do.
MAX_READ_LEN = 131072
# reads per locate launch and pairs per align launch
MAX_LOCATE_BATCH = 512
MAX_ALIGN_BATCH = 2048
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

    def __init__(self, device="cuda"):
        """``device``: "cuda", "cuda:N" or "cpu" (no fallback between
        them)."""
        self.device = resolve_device(device)
        self._splint_lock = threading.Lock()
        self._splint_cache: dict = {}

    def _splints(self, combos) -> torch.Tensor:
        key = tuple(id(c.codes) for c in combos)
        with self._splint_lock:
            hit = self._splint_cache.get(key)
            if hit is None:
                # the combos are kept with the tensor so their ids stay
                # theirs while the entry lives
                hit = (tuple(combos),
                       to_device(splint_array(combos), self.device))
                self._splint_cache[key] = hit
            return hit[1]

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return to_device(arr, self.device)

    # ---------------- locate ----------------

    def locate_many(self, reads, combos, min_dist) -> list[LocateResult]:
        S = self._splints(combos)
        C = len(combos)
        out: list = [None] * len(reads)
        overlong = [i for i, r in enumerate(reads) if len(r) > MAX_READ_LEN]
        if overlong:
            prof.current.count("overlong_reads_host_located", len(overlong))
            host = NumpyBackend()
            for i, r in zip(overlong, host.locate_many(
                    [reads[i] for i in overlong], combos, min_dist)):
                out[i] = r
        # dispatch every batch first (the device runs ahead), then
        # materialize
        tile = tile_for_distance(int(min_dist))
        launches = []
        for chunk, R, lens in self._read_batches(
                reads, [i for i, r in enumerate(reads)
                        if len(r) <= MAX_READ_LEN], C):
            prof.current.count("locate_launches")
            prof.current.count("locate_cells_padded", R.size * C)
            prof.current.count("locate_cells_real", int(lens.sum()) * C)
            launches.append((chunk, locate_device(
                self._to_dev(R), self._to_dev(lens), S, tile=tile)))

        deep_rerun: list[int] = []
        margin_rerun: list[int] = []
        for chunk, res in launches:
            combo, score, cand_pos, cand_h, _med, deep, marg = (
                x.cpu().numpy() for x in res)
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
            self._rerun_flagged(reads, out, S, deep_rerun, margin_rerun,
                                min_dist)
        return out

    def _read_batches(self, reads, idxs, C):
        """Longest-first batches of the reads ``idxs``: yields (batch
        idxs, (B, L) int8 codes padded with 4, (B,) int32 lengths), L the
        batch's longest read rounded up to 64, B within the batch cap and
        LOCATE_BUDGET."""
        order = sorted(idxs, key=lambda i: -len(reads[i]))
        start = 0
        while start < len(order):
            L = _round_up(len(reads[order[start]]), 64)
            B = max(1, min(MAX_LOCATE_BATCH, LOCATE_BUDGET // (C * L)))
            chunk = order[start:start + B]
            start += B
            R = np.full((len(chunk), L), 4, dtype=np.int8)
            lens = np.zeros(len(chunk), dtype=np.int32)
            for r, i in enumerate(chunk):
                R[r, :len(reads[i])] = reads[i]
                lens[r] = len(reads[i])
            yield chunk, R, lens

    def _rerun_flagged(self, reads, out, S, deep_rerun, margin_rerun,
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
                reads, deep_rerun + margin_rerun, S.shape[0]):
            combo = np.asarray([out[i].combo for i in chunk], dtype=np.int32)
            fetches.append((chunk, lens, profile_rows_combo(
                self._to_dev(R), self._to_dev(lens), S,
                self._to_dev(combo))))
        for chunk, lens, rows in fetches:
            rows = rows.cpu().numpy()
            for r, i in enumerate(chunk):
                pks = exact_peaks_from_profile(rows[r, :lens[r]], min_dist)
                out[i] = LocateResult(out[i].combo, out[i].score,
                                      pks.astype(np.int64))

    # ---------------- adapters (postprocessing) ----------------

    def adapter_hits(self, reads, combo_codes, combo_lens):
        raise NotImplementedError(
            "TorchBackend.adapter_hits is not ported yet (ROADMAP.md, "
            "queue 1 item 6: postprocess slice with adapter_hits_batch)")

    # ---------------- align ----------------

    def align_many(self, pairs, params: ConsensusParams,
                   phase_base: int = 0) -> list[SubreadAln]:
        """``phase_base`` offsets the record-arena phase of this call's
        launches: a second align_many within one group (the zero-repeat
        overlap batch) must not reuse the main call's arena phases while
        both calls' records are alive (native.ops_records_batch)."""
        prof.current.count("align_pairs", len(pairs))
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
        for i, pr in enumerate(pairs):
            q, t = pr[0], pr[2]
            if len(t) > (SMAX - 1) * len(q) + 1:
                # extreme length mismatch: the band's shift ladder (SMAX)
                # cannot track the diagonal — the host aligner takes it
                serial.append(i)
                continue
            device_items.append((_pair_band(pr, params),
                                 max(len(q), len(t)), i))
        if serial:
            res = serial_align_many([pairs[i] for i in serial], params)
            for i, r in zip(serial, res):
                out[i] = r

        # dispatch every launch first (the device runs ahead of the host
        # record building)
        launches = []
        for W, chunk in self._chunks(device_items):
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
            res = banded_align_trace(
                self._to_dev(Q), self._to_dev(T), self._to_dev(ql),
                self._to_dev(tl), band=W, match=params.match,
                mismatch=params.mismatch, gap_open=params.gap_open,
                gap_ext=params.gap_ext)
            launches.append((W, chunk, res))

        leftovers = []            # python-fallback work items
        rewalk: list[int] = []    # walks that ran out of steps
        escalate: list[int] = []  # fast-band paths that touched the edge
        # materialize and build records launch by launch: the GIL-free C
        # record build of launch k overlaps the device computing k + 1
        for li, (W, chunk, res) in enumerate(launches):
            with prof.current.stage("align_wait"):
                scores, j_ends, _j_starts, i_rem, ops, edge = (
                    x.cpu().numpy() for x in res)
            fast = W < params.band
            work = []
            for r, i in enumerate(chunk):
                if i_rem[r] > 0:
                    rewalk.append(i)
                    continue
                if fast and edge[r]:
                    # fast-band path touched band column 0 / W-1: realign
                    # at the full band (the spec's escalation rule)
                    escalate.append(i)
                    continue
                q, qual, t = pairs[i][0], pairs[i][1], pairs[i][2]
                work.append((i, q, qual, t, ops[r], int(j_ends[r]),
                             int(scores[r])))
            if not work:
                continue
            with prof.current.stage("align_host_records"):
                recs = None
                if native.available():
                    # one GIL-released C call per launch; ``phase`` gives
                    # each launch its own arena generation so all of a
                    # group's records stay alive together
                    recs = native.ops_records_batch(
                        [w[1] for w in work], [w[3] for w in work],
                        np.stack([w[4] for w in work]),
                        [w[5] for w in work], packed=True,
                        phase=li + phase_base)
                if recs is not None:
                    for (i, q, qual, _t, _o, _j, score), rec in zip(work,
                                                                    recs):
                        out[i] = SubreadAln(rec._replace(score=score),
                                            np.asarray(q, dtype=np.int8),
                                            np.asarray(qual, dtype=np.int8))
                else:
                    leftovers.extend(work)
        if leftovers:
            with prof.current.stage("align_host_records"):
                for w in leftovers:
                    self._build_record(out, w)
        if escalate:
            # identical escalation to serial_align_many: realign at the
            # full band on the host
            prof.current.count("align_band_escalated", len(escalate))
            res = serial_align_many([pairs[i][:3] for i in escalate], params)
            for i, r in zip(escalate, res):
                out[i] = r
        if rewalk:
            # paths longer than the walk's step budget: host realign
            prof.current.count("align_rewalk", len(rewalk))
            res = serial_align_many([pairs[i] for i in rewalk], params)
            for i, r in zip(rewalk, res):
                out[i] = r
        return out

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
