"""Batched peak candidates in torch ops, plus the host-side selection
(counterpart of ``c3poa_tpu/kernels/peaks.py``).

Device half (``peak_candidates_batch``): the numpy median (mean of the
two middle order statistics), the 6x-median noise gate and 3x-median
height cut of the reference (bin/call_peaks.py:13-15), plateau-aware
local maxima (scipy semantics), and a per-tile top-2 compaction with
tile <= min_dist: two candidates of one tile lie within min_dist of each
other, so scipy's selection keeps at most the best of them anyway — a
third survivor in a tile sets the ``deep`` flag and the read takes the
exact host path.  The ``margin`` flag marks reads whose float32
decisions sit within the measured f32-vs-f64 error of flipping.

Host half: jax-free copies of ``select_peaks_host``,
``margin_competitors_host`` and ``tile_for_distance``, and the guard
constants, each pinned to its original by a test.  On the GPU sort and
``gather`` are cheap, so the median is a sort, not the TPU's bitwise
order-statistic search; the values are the same order statistics.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_F = float(np.float32(-3.0e38))

# f32-vs-f64 guard margins (the JAX package's calibration, PARITY.md
# section 12): smoothed values differ from f64 by at most 7.8e-5
# absolute, adjacent differences by at most 8.4e-5.
MARGIN_REL = 1e-4
ORDER_REL = 4e-6
STRUCT_ATOL = 2e-4


def _pow2_at_most(n: int, lo: int = 1) -> int:
    b = lo
    while b * 2 <= n:
        b *= 2
    return b


def tile_for_distance(min_dist: int, cap: int = 64) -> int:
    return max(1, min(cap, _pow2_at_most(max(int(min_dist), 1))))


def masked_median(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """numpy median over the first lens[b] (>= 1) entries of each row."""
    B, L = x.shape
    valid = torch.arange(L, device=x.device)[None, :] < lens[:, None]
    xs = torch.sort(torch.where(valid, x.to(torch.float32), float("inf")),
                    dim=1).values
    k1 = ((lens.to(torch.int64) - 1) // 2)[:, None]
    k2 = (lens.to(torch.int64) // 2)[:, None]
    lo = torch.gather(xs, 1, k1)[:, 0]
    hi = torch.gather(xs, 1, k2)[:, 0]
    return (lo + hi) * 0.5


def peak_candidates_batch(smoothed: torch.Tensor, lens: torch.Tensor,
                          tile: int = 64):
    """smoothed (B, L) float32 (zero past lens); lens (B,).

    Returns (cand_pos (B, 2L/tile) int32 plateau midpoints, -1 where
    none; cand_h (B, 2L/tile) float32; med (B,); height (B,);
    gated (B,) bool; deep (B,) bool; margin (B,) bool) — the JAX
    version's outputs, tile winners first, then runners-up."""
    B, L = smoothed.shape
    if L % tile:
        raise ValueError(f"L = {L} is not a multiple of tile = {tile}")
    dev = smoothed.device
    lens = lens.to(torch.int32)
    x = smoothed.to(torch.float32)
    jidx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    valid = jidx < lens[:, None]
    xm = torch.where(valid, x, NEG_F)

    med = masked_median(x, lens)
    xmax = torch.max(xm, dim=1).values
    gated = xmax < 6.0 * med
    height = 3.0 * med
    # f32 margin guard, gate half
    near_gate = (xmax > 0) & (
        torch.abs(xmax - 6.0 * med)
        <= MARGIN_REL * torch.maximum(torch.abs(xmax), torch.abs(6.0 * med)))

    # local maxima: equal-value run [l, r] with a strict rise into l and
    # a strict drop after r (scipy plateau semantics)
    negcol = torch.full((B, 1), NEG_F, dtype=torch.float32, device=dev)
    x_prev = torch.cat([negcol, xm[:, :-1]], dim=1)
    x_next = torch.cat([xm[:, 1:], negcol], dim=1)
    is_start = xm != x_prev
    rise_prev = xm > x_prev
    drop_next = x_next < xm
    packed = torch.where(is_start, (jidx << 1) | rise_prev.to(torch.int32),
                         -1)
    packed = torch.cummax(packed, dim=1).values    # latest run start
    l_run = packed >> 1
    rise_at_l = (packed & 1) == 1

    is_peak = rise_at_l & (l_run >= 1) & drop_next & \
        (jidx <= lens[:, None] - 2)
    ok = is_peak & (xm >= height[:, None]) & ~gated[:, None]
    # f32 margin guard, height half
    near_h = is_peak & (xm > 0) & (
        torch.abs(xm - height[:, None])
        <= MARGIN_REL * torch.maximum(torch.abs(xm),
                                      torch.abs(height)[:, None]))
    # f32 margin guard, structure half: adjacent above-threshold values
    # whose difference sits inside the f32 flip zone
    near_struct = (valid & (x_next > NEG_F / 2)
                   & (xm >= height[:, None]) & (x_next >= height[:, None])
                   & (torch.abs(x_next - xm) <= STRUCT_ATOL))
    margin = near_gate | torch.any(near_h | near_struct, dim=1)
    h = torch.where(ok, xm, NEG_F)
    midpoint = torch.div(l_run + jidx, 2, rounding_mode="floor")

    M = L // tile
    h_t = h.reshape(B, M, tile)
    mid_t = torch.where(ok, midpoint, -1).reshape(B, M, tile)

    def tile_best(h_t):
        hmax = torch.max(h_t, dim=2).values
        pos_sel = torch.max(torch.where(h_t == hmax[:, :, None], mid_t, -1),
                            dim=2).values
        return hmax, torch.where(hmax > NEG_F / 2, pos_sel, -1)

    h1, p1 = tile_best(h_t)
    # runner-up: drop only the winner's position, re-reduce
    h_t2 = torch.where(mid_t == p1[:, :, None], NEG_F, h_t)
    h2, p2 = tile_best(h_t2)
    # third surviving candidate in any tile -> exact host rerun
    h_t3 = torch.where(mid_t == p2[:, :, None], NEG_F, h_t2)
    deep = torch.any(torch.max(h_t3, dim=2).values > NEG_F / 2, dim=1)

    cand_pos = torch.cat([p1, p2], dim=1)
    cand_h = torch.cat([h1, h2], dim=1)
    return cand_pos, cand_h, med, height, gated, deep, margin


def margin_competitors_host(cand_pos: np.ndarray, cand_h: np.ndarray,
                            min_dist: int = 0) -> np.ndarray:
    """Reads where two surviving candidates' by-height selection order
    could flip between f32 and f64 (within ORDER_REL) and the flip can
    change the output: they join the exact host rerun.

    Interaction filter (min_dist > 0): swapping the processing order of
    a near-equal pair (A, B) can only change the distance selection
    through peaks within ceil(distance) of A or B; if |A - B| >=
    ceil(distance) and no other candidate lies that close to either,
    both survive in either order and the flag is dropped."""
    h = np.where(cand_pos >= 0, cand_h.astype(np.float32), np.nan)
    hs = np.sort(h, axis=1)               # NaNs (empty slots) sort last
    d = np.diff(hs, axis=1)
    scale = np.maximum(np.abs(hs[:, :-1]), np.abs(hs[:, 1:]))
    with np.errstate(invalid="ignore"):
        near = d <= np.float32(ORDER_REL) * scale  # NaN cmp -> False
    out = np.any(near, axis=1)
    if min_dist <= 0 or not out.any():
        return out
    dist = int(np.ceil(min_dist))
    for b in np.flatnonzero(out):
        sel = cand_pos[b] >= 0
        pos = np.sort(cand_pos[b][sel].astype(np.int64))
        hb = np.sort(h[b][sel])
        gaps = np.diff(hb)
        sc = np.maximum(np.abs(hb[:-1]), np.abs(hb[1:]))
        pairs = np.flatnonzero(gaps <= ORDER_REL * sc)
        spaced = np.diff(pos)
        if len(pos) >= 2 and spaced.min() >= dist:
            # every candidate is >= dist from every other
            out[b] = False
            continue
        safe = True
        for pi_ in pairs:
            v1, v2 = hb[pi_], hb[pi_ + 1]
            members = np.flatnonzero((h[b][sel] == v1) | (h[b][sel] == v2))
            mpos = cand_pos[b][sel][members].astype(np.int64)
            if len(mpos) != 2 or abs(int(mpos[0]) - int(mpos[1])) < dist:
                safe = False
                break
            for q in cand_pos[b][sel].astype(np.int64):
                if q in (mpos[0], mpos[1]):
                    continue
                if (abs(q - int(mpos[0])) < dist
                        or abs(q - int(mpos[1])) < dist):
                    safe = False
                    break
            if not safe:
                break
        if safe:
            out[b] = False
    return out


def select_peaks_host(cand_pos: np.ndarray, cand_h: np.ndarray,
                      min_dist: int):
    """Exact scipy distance selection per read on the compacted
    candidates.  Returns a list of int64 arrays (ascending positions)."""
    from c3poa_tpu.ref.peaks import select_by_distance

    out = []
    for b in range(cand_pos.shape[0]):
        sel = cand_pos[b] >= 0
        pos = cand_pos[b][sel].astype(np.int64)
        h = cand_h[b][sel].astype(np.float64)
        if len(pos) == 0:
            out.append(np.zeros(0, dtype=np.int64))
            continue
        # candidates arrive (winners, runners-up): sort by position
        o = np.argsort(pos, kind="stable")
        pos, h = pos[o], h[o]
        keep = select_by_distance(pos, h, min_dist)
        out.append(pos[keep])
    return out
