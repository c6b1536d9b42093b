"""Batched banded affine-gap semiglobal aligner: forward pass and path
walk (counterpart of ``c3poa_tpu/kernels/banded.py`` and
``pallas_banded.py``; spec ``c3poa_tpu/ref/banded.py``).

Band-local layout: row i holds W columns j = lo(i) + k, lo following the
length-interpolated diagonal (``band_lo``).  The forward pass emits one
move nibble per cell (bits 0-1 source diag/E/F, bit 2 E extends, bit 3
F extends; 0 outside the band and on rows past the query), packed as
(P, ceil(nq/8), W) 32-bit words — row i is nibble (i-1) % 8 of word
(i-1) // 8.  The walk follows the path back from (ql, j_end) and emits
ops (1 diag, 2 insertion, 3 deletion) 2 bits each, four per byte, with
no gaps; it stops after ``walk_steps(nq, W)`` steps, and a pair whose
path is longer finishes with ``i_rem > 0`` (the caller realigns it on
the host).

Plain torch versions: ``banded_align_batch`` (forward) and
``banded_walk_batch``.  CUDA kernels (``csrc/banded.cu``):
``banded_fwd_cuda`` (kernel 2) and ``banded_walk_cuda`` (kernel 3).
``banded_align_trace`` dispatches both on the tensors' device.

Also jax-free copies of the host helpers ``band_starts_np``, ``SMAX``,
``unpack_ops_packed`` and ``ops_to_record``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .sw_profile import substitution

NEG = -(2 ** 28)
# max band shift per DP row; the backend sends only pairs with
# len(t) <= (SMAX - 1) * len(q) + 1, which keep every shift <= SMAX
SMAX = 3
OP_NONE, OP_DIAG, OP_INS, OP_DEL = 0, 1, 2, 3
# band widths csrc/banded.cu is instantiated for (W / 32 columns a lane)
CUDA_BANDS = (32, 64, 128, 256)
# the forward stages each pair's target in shared memory, 4 bits a base,
# in max(nt + 1, W) / 8 + 2 words (csrc/banded.cuh:bnd_target_words)
# under csrc/banded.cu's FWD_SHARED_BYTES: the widest target row it takes
FWD_SHARED_BYTES = 96 * 1024
FWD_MAX_TARGET = (FWD_SHARED_BYTES // 4 - 2) * 8 + 6


def band_starts_np(nq: int, nt: int, band: int) -> np.ndarray:
    """Host-side lo(i), i = 0..nq (equal to ``band_lo`` bit for bit)."""
    i = np.arange(nq + 1, dtype=np.float32)
    ctr = np.round(i * np.float32(nt) / np.float32(max(nq, 1))).astype(
        np.int32)
    hi = max(nt + 1 - band, 0)
    return np.clip(ctr - band // 2, 0, hi)


def band_lo(i, ql: torch.Tensor, tl: torch.Tensor, band: int) -> torch.Tensor:
    """lo(i) per pair: float32 multiply and divide, round half to even
    (``torch.round``), as in band_lo_fn / band_starts_np /
    native/traceback.c:band_lo / csrc/band_lo.cuh.  ``i`` is an int or
    a (P,) int32 tensor."""
    if isinstance(i, int):
        i = torch.full_like(ql, i)
    ie = torch.minimum(i, ql).to(torch.float32)
    ctr = torch.round(ie * tl.to(torch.float32)
                      / torch.clamp(ql, min=1).to(torch.float32))
    hi = torch.clamp(tl + 1 - band, min=0)
    return torch.minimum(torch.clamp(ctr.to(torch.int32) - band // 2, min=0),
                         hi)


def walk_steps(nq: int, band: int) -> int:
    """The walk's step budget for a batch of query width nq."""
    return -(-(nq + band + 64) // 4) * 4


def ops_bytes(n_steps: int) -> int:
    """Bytes of one pair's packed ops: whole 32-bit words of 16 ops."""
    return -(-n_steps // 16) * 4


def _wrap32(acc: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> int32 with the same bits."""
    return torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc).to(torch.int32)


def banded_align_batch(queries: torch.Tensor, targets: torch.Tensor,
                       q_lens: torch.Tensor, t_lens: torch.Tensor,
                       band: int = 128, match: int = 5, mismatch: int = -4,
                       gap_open: int = 4, gap_ext: int = 2):
    """Plain torch forward pass.  queries (P, nq) int8 and targets
    (P, nt) int8, pad 4; q_lens, t_lens (P,) int.

    Returns (scores (P,) int32, j_end (P,) int32, moves (P, ceil(nq/8),
    W) int32 move words)."""
    P, nq = queries.shape
    nt = targets.shape[1]
    W = band
    dev = queries.device
    oe, e = gap_open + gap_ext, gap_ext
    ql = q_lens.to(torch.int32)
    tl = t_lens.to(torch.int32)
    Qi = queries.to(torch.int32)
    Ti = targets.to(torch.int32)
    karr = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    negs = torch.full((P, W), NEG, dtype=torch.int32, device=dev)
    negcol = negs[:, :1]
    falsecol = torch.zeros((P, 1), dtype=torch.bool, device=dev)
    nq8 = -(-nq // 8)
    moves = torch.zeros((P, nq8, W), dtype=torch.int32, device=dev)
    acc = torch.zeros((P, W), dtype=torch.int64, device=dev)

    lo_prev = band_lo(0, ql, tl, W)
    H = torch.where(lo_prev[:, None] + karr <= tl[:, None], 0, negs)
    E = negs
    for i in range(1, nq + 1):
        lo_i = band_lo(i, ql, tl, W)
        src_k = karr + (lo_i - lo_prev)[:, None]        # k + s
        Hp = torch.where(src_k < W, torch.gather(
            H, 1, torch.clamp(src_k, max=W - 1).to(torch.int64)), NEG)
        Ep = torch.where(src_k < W, torch.gather(
            E, 1, torch.clamp(src_k, max=W - 1).to(torch.int64)), NEG)
        d_k = src_k - 1
        Hd = torch.where((d_k >= 0) & (d_k < W), torch.gather(
            H, 1, torch.clamp(d_k, 0, W - 1).to(torch.int64)), NEG)

        jcol = lo_i[:, None] + karr
        tj = jcol - 1
        tc = torch.gather(Ti, 1, torch.clamp(tj, 0, nt - 1).to(torch.int64))
        tc = torch.where((tj >= 0) & (tj < tl[:, None]), tc, 4)
        sub = substitution(Qi[:, i - 1:i], tc, match, mismatch)

        En = torch.maximum(Hp - oe, Ep - e)
        eext = (Ep - e) > (Hp - oe)
        diag = torch.where(jcol >= 1, Hd + sub, NEG)
        Ht = torch.maximum(diag, En)
        # F[k] = max_{u<k} (Ht[u] - oe - e*(k-1-u)) via a prefix max
        cm = torch.cummax(Ht + e * karr, dim=1).values
        F = torch.cat([negcol, cm[:, :-1]], dim=1) - oe - e * karr + e
        fext = torch.cat([falsecol, (F[:, :-1] - e) > (Ht[:, :-1] - oe)],
                         dim=1)
        Hn = torch.maximum(Ht, F)
        from_diag = (diag >= En) & (diag >= F)
        src = (~from_diag).to(torch.int32) * (2 - (En >= F).to(torch.int32))
        mv = src | (eext.to(torch.int32) << 2) | (fext.to(torch.int32) << 3)

        in_band = jcol <= tl[:, None]
        active = (i <= ql)[:, None]
        H = torch.where(active, torch.where(in_band, Hn, NEG), Hp)
        E = torch.where(active, torch.where(in_band, En, NEG), Ep)
        mv = torch.where(active & in_band, mv, 0)
        acc |= mv.to(torch.int64) << (4 * ((i - 1) % 8))
        if i % 8 == 0 or i == nq:
            moves[:, (i - 1) // 8, :] = _wrap32(acc)
            acc.zero_()
        lo_prev = lo_i

    score = torch.max(H, dim=1).values
    k_end = torch.min(torch.where(H == score[:, None], karr, W), dim=1).values
    return score, lo_prev + k_end, moves


def banded_walk_batch(moves: torch.Tensor, q_lens: torch.Tensor,
                      t_lens: torch.Tensor, j_end: torch.Tensor, nq: int,
                      band: int):
    """Plain torch walk over the forward pass's move words.

    Returns (j_start (P,) int32, i_rem (P,) int32, ops (P,
    ops_bytes(walk_steps(nq, W))) uint8, edge (P,) bool — the path
    visited band column 0 (with columns cut off to its left) or W-1
    (with columns beyond it))."""
    P, nq8, W = moves.shape
    dev = moves.device
    n_steps = walk_steps(nq, W)
    nbytes = ops_bytes(n_steps)
    ql = q_lens.to(torch.int32)
    tl = t_lens.to(torch.int32)
    flat = moves.reshape(P, nq8 * W)
    i = ql.clone()
    j = j_end.to(torch.int32).clone()
    st = torch.zeros(P, dtype=torch.int32, device=dev)
    edge = torch.zeros(P, dtype=torch.bool, device=dev)
    ops = torch.zeros((P, nbytes * 4), dtype=torch.uint8, device=dev)
    for step in range(n_steps):
        if step % 64 == 0 and not bool((i > 0).any()):
            break
        active = i > 0
        lo_i = band_lo(i, ql, tl, W)
        k = j - lo_i
        edge |= active & (((k == 0) & (lo_i > 0)) |
                          ((k == W - 1) & (lo_i + W <= tl)))
        im1 = torch.clamp(i - 1, 0, nq8 * 8 - 1)
        idx = (im1 >> 3) * W + torch.clamp(k, 0, W - 1)
        word = torch.gather(flat, 1, idx.to(torch.int64)[:, None])[:, 0]
        mv = (word >> (4 * (im1 & 7))) & 0xF
        src = mv & 3
        is_e = (st == 1) | ((st == 0) & (src == 1))
        is_f = (st == 2) | ((st == 0) & (src == 2))
        is_d = (st == 0) & (src == 0)
        op = 3 - 2 * is_d.to(torch.int32) - is_e.to(torch.int32)
        ops[:, step] = torch.where(active, op, 0).to(torch.uint8)
        st_next = (is_e & ((mv & 4) != 0)).to(torch.int32) + \
            2 * (is_f & ((mv & 8) != 0)).to(torch.int32)
        st = torch.where(active, st_next, st)
        i = i - (active & (is_d | is_e)).to(torch.int32)
        j = j - (active & (is_d | is_f)).to(torch.int32)
    o = ops.view(P, nbytes, 4)
    packed = o[:, :, 0] | (o[:, :, 1] << 2) | (o[:, :, 2] << 4) | \
        (o[:, :, 3] << 6)
    return j, i, packed, edge


def banded_fwd_cuda(queries: torch.Tensor, targets: torch.Tensor,
                    q_lens: torch.Tensor, t_lens: torch.Tensor,
                    band: int = 128, match: int = 5, mismatch: int = -4,
                    gap_open: int = 4, gap_ext: int = 2):
    """Kernel 2: the forward pass on the card.  int8 queries/targets
    (codes 0-4), int32 lengths with q_lens <= nq and t_lens <= nt; same
    outputs as ``banded_align_batch``.  The kernel writes every move
    word, zero past each query, so the moves are allocated uncleared.
    A target row wider than ``FWD_MAX_TARGET`` (the kernel's
    shared-memory staging) is refused."""
    dev = queries.device
    _build.require(queries, torch.int8, 2, "queries")
    _build.require(targets, torch.int8, 2, "targets", dev)
    _build.require(q_lens, torch.int32, 1, "q_lens", dev)
    _build.require(t_lens, torch.int32, 1, "t_lens", dev)
    P, nq = queries.shape
    nt = targets.shape[1]
    if targets.shape[0] != P or q_lens.shape[0] != P or \
            t_lens.shape[0] != P:
        raise ValueError("queries, targets and lengths disagree on P")
    if band not in CUDA_BANDS:
        raise ValueError(f"band {band} not in {CUDA_BANDS}")
    if nt > FWD_MAX_TARGET:
        raise ValueError(f"target width {nt} > {FWD_MAX_TARGET}")
    if not (-128 <= match <= 127 and -128 <= mismatch <= 127):
        raise ValueError(f"match {match} and mismatch {mismatch} must fit "
                         f"a signed byte (the kernel's substitution table)")
    score = torch.empty(P, dtype=torch.int32, device=dev)
    j_end = torch.empty(P, dtype=torch.int32, device=dev)
    moves = torch.empty((P, -(-nq // 8), band), dtype=torch.int32,
                        device=dev)
    if P == 0:
        return score, j_end, moves
    _build.launch(
        "banded", "c3t_banded_fwd", "banded_fwd_cuda", queries,
        queries.data_ptr(), targets.data_ptr(), q_lens.data_ptr(),
        t_lens.data_ptr(), score.data_ptr(), j_end.data_ptr(),
        moves.data_ptr(), P, nq, nt, band, match, mismatch, gap_open,
        gap_ext)
    return score, j_end, moves


def banded_walk_cuda(moves: torch.Tensor, q_lens: torch.Tensor,
                     t_lens: torch.Tensor, j_end: torch.Tensor, nq: int,
                     band: int):
    """Kernel 3: the walk on the card; same outputs as
    ``banded_walk_batch``.  The kernel writes every word of ops."""
    dev = moves.device
    _build.require(moves, torch.int32, 3, "moves")
    for name, t in (("q_lens", q_lens), ("t_lens", t_lens),
                    ("j_end", j_end)):
        _build.require(t, torch.int32, 1, name, dev)
    P, nq8, W = moves.shape
    if W != band or nq8 != -(-nq // 8):
        raise ValueError(f"moves {tuple(moves.shape)} do not match nq = "
                         f"{nq}, band = {band}")
    if band not in CUDA_BANDS:
        raise ValueError(f"band {band} not in {CUDA_BANDS}")
    if q_lens.shape[0] != P or t_lens.shape[0] != P or j_end.shape[0] != P:
        raise ValueError("moves, lengths and j_end disagree on P")
    n_steps = walk_steps(nq, W)
    words = ops_bytes(n_steps) // 4
    j_start = torch.empty(P, dtype=torch.int32, device=dev)
    i_rem = torch.empty(P, dtype=torch.int32, device=dev)
    edge = torch.empty(P, dtype=torch.uint8, device=dev)
    ops = torch.empty((P, words), dtype=torch.int32, device=dev)
    if P:
        _build.launch(
            "banded", "c3t_banded_walk", "banded_walk_cuda", moves,
            moves.data_ptr(), q_lens.data_ptr(), t_lens.data_ptr(),
            j_end.data_ptr(), j_start.data_ptr(), i_rem.data_ptr(),
            edge.data_ptr(), ops.data_ptr(), P, nq8, W, n_steps, words)
    return j_start, i_rem, ops.view(torch.uint8), edge.to(torch.bool)


def banded_fwd(queries, targets, q_lens, t_lens, band: int = 128,
               match: int = 5, mismatch: int = -4, gap_open: int = 4,
               gap_ext: int = 2):
    """Forward pass: the plain version for CPU tensors, kernel 2 for
    CUDA tensors."""
    if queries.device.type == "cuda":
        return banded_fwd_cuda(queries, targets, q_lens, t_lens, band,
                               match, mismatch, gap_open, gap_ext)
    if queries.device.type == "cpu":
        return banded_align_batch(queries, targets, q_lens, t_lens, band,
                                  match, mismatch, gap_open, gap_ext)
    raise ValueError(f"unsupported device {queries.device}")


def banded_walk(moves, q_lens, t_lens, j_end, nq: int, band: int):
    """Walk: the plain version for CPU tensors, kernel 3 for CUDA."""
    if moves.device.type == "cuda":
        return banded_walk_cuda(moves, q_lens, t_lens, j_end, nq, band)
    if moves.device.type == "cpu":
        return banded_walk_batch(moves, q_lens, t_lens, j_end, nq, band)
    raise ValueError(f"unsupported device {moves.device}")


def banded_align_trace(queries, targets, q_lens, t_lens, band: int = 128,
                       match: int = 5, mismatch: int = -4,
                       gap_open: int = 4, gap_ext: int = 2):
    """Forward pass + walk.  Returns (scores, j_end, j_start, i_rem,
    ops (packed 2-bit, no gaps), edge), the tuple of the JAX package's
    banded_align_trace_batch with its ops packed."""
    scores, j_end, moves = banded_fwd(queries, targets, q_lens, t_lens,
                                      band, match, mismatch, gap_open,
                                      gap_ext)
    j_start, i_rem, ops, edge = banded_walk(
        moves, q_lens, t_lens, j_end, queries.shape[1], band)
    return scores, j_end, j_start, i_rem, ops, edge


def unpack_moves(moves: torch.Tensor, nq: int) -> torch.Tensor:
    """(P, nq8, W) move words -> (P, nq, W) uint8 move nibbles (row r =
    DP row r + 1), the JAX package's unpacked layout."""
    P, nq8, W = moves.shape
    rows = [((moves >> (4 * u)) & 0xF).to(torch.uint8) for u in range(8)]
    return torch.stack(rows, dim=2).reshape(P, nq8 * 8, W)[:, :nq, :]


def unpack_ops_packed(row: np.ndarray) -> np.ndarray:
    """2-bit packed ops -> dense uint8 op stream (zero gaps removed)."""
    row = np.asarray(row, dtype=np.uint8)
    all_ops = np.zeros(4 * len(row), dtype=np.uint8)
    for s in range(4):
        all_ops[s::4] = (row >> (2 * s)) & 3
    return all_ops[all_ops != 0]


def ops_to_record(q: np.ndarray, t: np.ndarray, ops: np.ndarray,
                  j_end: int):
    """Python fallback: rebuild an AlignRecord from the walk ops."""
    from ..ref.banded import AlignRecord

    nq, nt = len(q), len(t)
    cover = np.zeros(nt, dtype=np.int8)
    base = np.full(nt, 4, dtype=np.int8)
    qpos = np.full(nt, -1, dtype=np.int32)
    ins_len = np.zeros(nt + 1, dtype=np.int32)
    ins_qstart = np.full(nt + 1, -1, dtype=np.int32)
    i, j = nq, int(j_end)
    for op in ops:
        if op == OP_NONE:
            break
        if op == OP_DIAG:
            cover[j - 1] = 1
            base[j - 1] = q[i - 1]
            qpos[j - 1] = i - 1
            i -= 1
            j -= 1
        elif op == OP_INS:
            ins_len[j] += 1
            ins_qstart[j] = i - 1
            i -= 1
        else:
            cover[j - 1] = 2
            j -= 1
    return AlignRecord(cover, base, qpos, ins_len, ins_qstart, j, int(j_end),
                       score=0)
