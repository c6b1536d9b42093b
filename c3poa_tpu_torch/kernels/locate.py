"""Fused splint locate: profile -> combo select -> smooth -> peak
candidates (counterpart of ``c3poa_tpu/kernels/locate.py``); on the card
the profile, the smoothing and the candidates are hand-written kernels.

One call per batch of reads; only O(B) scalars and the O(B * L/tile)
candidate slots need to leave the device.  The distance selection
finishes on the host (``kernels.peaks.select_peaks_host``).
"""

from __future__ import annotations

import torch

from .peaks import peak_candidates
from .smooth import combo_rows, smooth3
from .sw_profile import start_profile


def profile_rows(reads: torch.Tensor, lens: torch.Tensor,
                 splints: torch.Tensor) -> torch.Tensor:
    """(B, C, L) int32 exact profiles (for flagged-read reruns)."""
    return start_profile(reads, splints, lens)


def profile_rows_combo(reads: torch.Tensor, lens: torch.Tensor,
                       splints: torch.Tensor,
                       combo: torch.Tensor) -> torch.Tensor:
    """(B, L) int32: the chosen combo's exact profile row per read —
    ``profile_rows(...)[arange(B), combo]``.  combo (B,) int."""
    return combo_rows(start_profile(reads, splints, lens), combo)


def locate_device(reads: torch.Tensor, lens: torch.Tensor,
                  splints: torch.Tensor, tile: int = 64):
    """reads (B, L) int8 pad 4; lens (B,) int32; splints (C, m) int8 pad 4.

    Returns (combo (B,) int32, best_score (B,) int32,
             cand_pos (B, 2L/tile) int32, cand_h (B, 2L/tile) float32,
             med (B,) float32, deep (B,) bool, margin (B,) bool).
    ``combo`` is the argmax of the per-combo profile max, lowest index
    on ties."""
    prof = start_profile(reads, splints, lens)               # (B, C, L)
    C = prof.shape[1]
    per_combo = torch.max(prof, dim=2).values                # (B, C)
    best_score = torch.max(per_combo, dim=1).values
    carr = torch.arange(C, dtype=torch.int32, device=prof.device)[None, :]
    combo = torch.min(torch.where(per_combo == best_score[:, None], carr, C),
                      dim=1).values
    sm = smooth3(prof, combo, lens)                           # (B, L)
    cand_pos, cand_h, med, _height, _gated, deep, margin = \
        peak_candidates(sm, lens, tile=tile)
    return combo, best_score, cand_pos, cand_h, med, deep, margin
