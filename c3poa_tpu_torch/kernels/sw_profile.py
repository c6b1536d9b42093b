"""Start-anchored local SW score profiles (counterpart of
``c3poa_tpu/kernels/sw_profile.py`` and ``pallas_profile.py``).

For every read and every (splint, strand) combo, the per-column best
local score of a splint suffix starting there (spec:
``c3poa_tpu/ref/sw.py:start_profile``), computed in forward coordinates
by scanning splint rows last to first:

    G[i][j] = max(0, G[i+1][j+1] + s(i,j), G[i+1][j] - gap, G[i][j+1] - gap)
    profile[j] = max_i G[i][j]

The in-row term is a reverse running max: G[i] = revcummax(T - gap*j) +
gap*j with T = max(0, diag, up).  Code 4 (N / pad) scores 0 against
everything, so the profile past each read's end is exactly 0.

``start_profile_batch`` is the plain torch version; ``start_profile_cuda``
launches the hand-written kernel ``csrc/profile.cu``; ``start_profile``
dispatches on the tensors' device.
"""

from __future__ import annotations

import torch

from . import _build

# tile width of csrc/profile.cu (256 threads x 16 columns)
TILE_WIDTH = 4096
# the widest right overlap a tile takes (at least 256 new columns a tile):
# splints of up to ~2550 bases
MAX_OVERLAP = TILE_WIDTH - 256


def substitution(a: torch.Tensor, b: torch.Tensor, match: int,
                 mismatch: int) -> torch.Tensor:
    """int32 substitution scores of code tensors (broadcast): match or
    mismatch, and 0 where either side is 4 (N / pad)."""
    s = (a == b).to(torch.int32) * (match - mismatch) + mismatch
    return torch.where((a == 4) | (b == 4), 0, s)


def start_profile_batch(reads: torch.Tensor, splints: torch.Tensor,
                        match: int = 1, mismatch: int = -2, gap: int = 2
                        ) -> torch.Tensor:
    """Plain torch version.  reads (B, L) int8 pad 4; splints (C, m) int8
    pad 4 at the end.  Returns (B, C, L) int32."""
    B, L = reads.shape
    C, m = splints.shape
    dev = reads.device
    r = reads.to(torch.int32)[:, None, :]                    # (B, 1, L)
    S = splints.to(torch.int32)
    jarr = torch.arange(L, dtype=torch.int32, device=dev) * gap
    G = torch.zeros((B, C, L), dtype=torch.int32, device=dev)
    colmax = torch.zeros_like(G)
    zcol = torch.zeros((B, C, 1), dtype=torch.int32, device=dev)
    for i in range(m - 1, -1, -1):
        q = S[:, i][None, :, None]                           # (1, C, 1)
        sub = substitution(q, r, match, mismatch)
        diag = torch.cat([G[:, :, 1:], zcol], dim=2) + sub   # G[i+1][j+1]
        T = torch.clamp(torch.maximum(diag, G - gap), min=0)
        A = torch.flip(torch.cummax(torch.flip(T - jarr, [2]), dim=2).values,
                       [2])
        G = A + jarr
        colmax = torch.maximum(colmax, G)
    return colmax


def tile_overlap(m: int, match: int = 1, gap: int = 2) -> int:
    """Right overlap of a profile tile: the column reach of a local
    alignment of an m-char splint, m * (1 + match / gap), plus slack,
    rounded up to 16 columns (the kernel's vector width)."""
    return -(-(int(m * (gap + match) / gap) + 8) // 16) * 16


def profile_fits(m: int, match: int = 1, gap: int = 2) -> bool:
    """Whether the kernel takes splints of width m (the backend sends a
    combo set it does not take to the exact host path)."""
    return tile_overlap(m, match, gap) <= MAX_OVERLAP


def start_profile_cuda(reads: torch.Tensor, splints: torch.Tensor,
                       lens: torch.Tensor, match: int = 1,
                       mismatch: int = -2, gap: int = 2) -> torch.Tensor:
    """Kernel 1 (``csrc/profile.cu``).  reads (B, L) int8 pad 4 with
    L % 16 == 0; splints (C, m) int8 pad 4; lens (B,) int32 read lengths
    (tiles past a read's end are written as zeros).  Returns (B, C, L)
    int32, bit-identical to ``start_profile_batch``."""
    dev = reads.device
    _build.require(reads, torch.int8, 2, "reads")
    _build.require(splints, torch.int8, 2, "splints", dev)
    _build.require(lens, torch.int32, 1, "lens", dev)
    B, L = reads.shape
    C, m = splints.shape
    if lens.shape[0] != B:
        raise ValueError(f"lens has {lens.shape[0]} rows, reads {B}")
    if L % 16:
        raise ValueError(f"L = {L} must be a multiple of 16")
    if not profile_fits(m, match, gap):
        raise ValueError(f"splint length {m} too long for the profile "
                         f"kernel's {TILE_WIDTH}-column tiles")
    ov = tile_overlap(m, match, gap)
    out = torch.empty((B, C, L), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    _build.launch("profile", "c3t_start_profile", "start_profile_cuda",
                  reads, reads.data_ptr(), lens.data_ptr(),
                  splints.data_ptr(), out.data_ptr(), B, L, C, m, ov, match,
                  mismatch, gap)
    return out


def start_profile(reads: torch.Tensor, splints: torch.Tensor,
                  lens: torch.Tensor, match: int = 1, mismatch: int = -2,
                  gap: int = 2) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if reads.device.type == "cuda":
        return start_profile_cuda(reads, splints, lens, match, mismatch, gap)
    if reads.device.type == "cpu":
        return start_profile_batch(reads, splints, match, mismatch, gap)
    raise ValueError(f"unsupported device {reads.device}")
