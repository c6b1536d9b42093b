"""Pipeline compute backends.

``NumpyBackend`` runs the reference (numpy) implementations — always
available, used for tests and as the CPU fallback.  ``TpuBackend`` (in
``pipeline/tpu_backend.py``) substitutes the batched JAX/Pallas kernels; the
pipeline code is backend-agnostic.

A backend provides:
- ``locate_many(reads, combos, min_dist)``: per read, pick the best
  (splint, strand) combo by raw profile score and return the smoothed-profile
  peaks (the conk + BLAT-preprocess + call_peaks roles in one call).
- ``align_many(pairs, params)``: batched banded alignment for the consensus
  engine (``consensus.engine.AlignMany``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from ..consensus.engine import ConsensusParams, serial_align_many
from ..constants import ADAPTER_OVERLAP_TOL
from ..ref import peaks as ref_peaks
from ..ref import sg as ref_sg
from ..ref import sw as ref_sw


class Combo(NamedTuple):
    splint_name: str
    strand: str          # '+' or '-'
    codes: np.ndarray    # int8; for '-' this is the revcomp of the splint
    splint_len: int      # length of the original splint (for the peak shift)


class LocateResult(NamedTuple):
    combo: int           # index into combos
    score: int           # raw profile max (no-splint decision input)
    peaks: np.ndarray    # smoothed-profile peak indices


class NumpyBackend:
    def __init__(self, match: int = 1, mismatch: int = -2, gap: int = 2):
        self.match, self.mismatch, self.gap = match, mismatch, gap

    def locate_many(self, reads: Sequence[np.ndarray], combos: Sequence[Combo],
                    min_dist: int) -> list[LocateResult]:
        out = []
        for codes in reads:
            best_c, best_score, best_prof = -1, -1, None
            for ci, combo in enumerate(combos):
                prof = ref_sw.start_profile(
                    combo.codes, codes, self.match, self.mismatch, self.gap)
                m = int(prof.max(initial=0))
                if m > best_score:
                    best_c, best_score, best_prof = ci, m, prof
            sm = ref_sg.smooth3(best_prof)
            pks, _med = ref_peaks.call_peaks(sm, min_dist)
            out.append(LocateResult(best_c, best_score, pks))
        return out

    def align_many(self, pairs, params: ConsensusParams,
                   phase_base: int = 0):
        # phase_base: arena-phase offset, meaningful only for the device
        # backend's shared record arenas (tpu_backend.align_many)
        from ..consensus.engine import _pair_band
        from ..utils import prof
        prof.current.count(
            "align_cells",
            sum(len(pr[0]) * _pair_band(pr, params) for pr in pairs))
        with prof.current.stage("align"):
            return serial_align_many(pairs, params)

    # Adapter scoring is stricter than the splint profile's +-1: BLAT's
    # tile seeds only fire on near-exact matches (tileSize=6, oneOff=1),
    # so sloppy chance alignments must not reach the matches>10 threshold.
    ADAPTER_SCORING = (1, -3, 3)  # match, mismatch, gap penalty

    # span-disjointness tolerance for second adapter hits; canonical
    # value lives in the import-free constants module so numpy-only mp
    # workers never touch the kernels layer (whose module scope creates
    # jnp scalars and would initialize the accelerator backend)
    OVERLAP_TOL = ADAPTER_OVERLAP_TOL

    def adapter_hits(self, reads, combo_codes, combo_lens):
        """Best-two local hits with coords per (read, adapter combo).

        Returns six (B, C) arrays (s1, j1, qe1, ts1, qs1, s2) with the same
        semantics as kernels.adapters.adapter_hits_batch."""
        B, C = len(reads), len(combo_codes)
        mt, mm, gp = self.ADAPTER_SCORING
        out = [np.zeros((B, C), dtype=np.int64) for _ in range(6)]
        for b, codes in enumerate(reads):
            for c, (acodes, alen) in enumerate(zip(combo_codes, combo_lens)):
                colmax, qend, tstart, qstart = ref_sw.local_hits(
                    acodes, codes, mt, mm, gp)
                j1 = int(np.argmax(colmax))
                s1 = int(colmax[j1])
                jj = np.arange(len(colmax))
                # second hit = best end column whose alignment span
                # [tstart[j], j] is (near-)disjoint from the best span —
                # so genuine nearby copies (dimers) surface and the
                # exactly-one-hit rule rejects the read, while shifted
                # self-alignments of the same occurrence stay suppressed
                overlap = np.minimum(jj, j1) - \
                    np.maximum(tstart, int(tstart[j1])) + 1
                masked = np.where(overlap > self.OVERLAP_TOL,
                                  -(2 ** 30), colmax)
                s2 = int(masked.max(initial=-(2 ** 30)))
                vals = (s1, j1, int(qend[j1]), int(tstart[j1]),
                        int(qstart[j1]), s2)
                for k in range(6):
                    out[k][b, c] = vals[k]
        return out
