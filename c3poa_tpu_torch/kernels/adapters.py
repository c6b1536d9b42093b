"""Adapter hits for postprocessing (counterpart of
``c3poa_tpu/kernels/adapters.py:adapter_hits_batch``; spec
``c3poa_tpu/ref/sw.py:local_hits`` as ``NumpyBackend.adapter_hits`` runs
it).

For every read and every adapter combo (each adapter forward and reverse
complemented), an end-anchored local alignment of the adapter (rows)
against the read (columns) that carries, besides H, the path's read
start and adapter start as payloads.  Per row i:

    T[j]  = max(H[i-1][j-1] + s(i, j), H[i-1][j] - gap)   (diagonal wins ties;
            a diagonal from H <= 0 starts a fresh path at (j, i))
    T[j]  = 0 with payload (j+1, i+1) where T[j] < 0      (local floor)
    H[i][j] = max_{k <= j} (T[k] - gap * (j - k))           (in-row gap runs;
            the rightmost source wins ties)
    colmax[j] updates on a strict '>' (the earliest row wins)

The in-row run is a prefix max of ``A = T + gap * j`` whose payloads
follow the values.  Outputs per (read, combo): the best hit ``s1`` at the
first column ``j1`` with the maximum, its adapter end ``qe1``, read start
``ts1`` and adapter start ``qs1``; and ``s2``, the best score over end
columns whose span ``[ts[j], j]`` shares at most ``ADAPTER_OVERLAP_TOL``
columns with the best hit's span, -2**30 where none does.

Scoring: both backends pass ``NumpyBackend.ADAPTER_SCORING`` = (match 1,
mismatch -3, gap 3), with N (code 4) scoring 0 against anything and a
local floor of 0.

Two differences from the JAX kernel, where the port follows the spec:
each combo runs its own ``adapter_lens[c]`` rows (the JAX kernel runs all
``m`` rows of the padded adapter matrix, ``adapters.py:125``), and the
reductions see each read's own ``lens[b]`` columns (the JAX kernel
reduces over the padded width).  Padding rows and columns score 0 and
carry diagonal shadows of earlier cells into the reductions; here no
output depends on how reads or adapters are padded.

``adapter_hits_batch`` is the plain torch version; ``adapter_hits_cuda``
launches the hand-written kernel ``csrc/adapters.cu``; ``adapter_hits``
dispatches on the tensors' device.
"""

from __future__ import annotations

import torch

from ..constants import ADAPTER_OVERLAP_TOL
from . import _build
from .sw_profile import substitution

NEG = -(2 ** 30)
# limits of csrc/adapters.cuh: the (t_start, q_start) payload packs into
# one 32-bit word (18 + 14 bits), and a column's maximum and its adapter
# row share one (13 + 13 bits)
MAX_COLUMNS = (1 << 18) - 1
MAX_ADAPTER_LEN = 4096
MAX_SCORE = (1 << 13) - 1
# rows one pass of the kernel's warp covers (32 lanes, 2 rows a lane); a
# longer combo hands its last row to the next pass through a carry row
PASS_ROWS = 64


def adapter_hits_batch(reads: torch.Tensor, lens: torch.Tensor,
                       adapters: torch.Tensor, adapter_lens: torch.Tensor,
                       match: int, mismatch: int, gap: int):
    """Plain torch version.  reads (B, L) int8 padded with 4; lens (B,)
    int32 read lengths; adapters (C, m) int8 padded with 4; adapter_lens
    (C,) int32.  Returns six (B, C) int32 tensors (s1, j1, qe1, ts1, qs1,
    s2): read coordinates j/t, adapter coordinates q, 0-based, inclusive
    ends."""
    B, L = reads.shape
    C, m = adapters.shape
    dev = reads.device
    i32 = torch.int32
    r = reads.to(i32)[:, None, :]                              # (B, 1, L)
    A8 = adapters.to(i32)
    alens = adapter_lens.to(device=dev, dtype=i32)
    jarr = torch.arange(L, dtype=i32, device=dev)
    gj = gap * jarr
    zcol = torch.zeros((B, C, 1), dtype=i32, device=dev)

    H = torch.zeros((B, C, L + 1), dtype=i32, device=dev)
    TS = torch.arange(L + 1, dtype=i32, device=dev).expand(B, C, L + 1)
    QS = torch.zeros((B, C, L + 1), dtype=i32, device=dev)
    colmax = torch.zeros((B, C, L), dtype=i32, device=dev)
    qend = torch.zeros_like(colmax)
    tsb = torch.zeros_like(colmax)
    qsb = torch.zeros_like(colmax)
    n_rows = int(alens.max()) if C else 0
    for i in range(min(n_rows, m)):
        live = (alens > i)[None, :, None]                      # (1, C, 1)
        q = A8[:, i][None, :, None]                            # (1, C, 1)
        diag = H[:, :, :-1] + substitution(q, r, match, mismatch)
        fresh = H[:, :, :-1] <= 0
        dTS = torch.where(fresh, jarr, TS[:, :, :-1])
        dQS = torch.where(fresh, i, QS[:, :, :-1])
        upv = H[:, :, 1:] - gap
        take_diag = diag >= upv
        T = torch.where(take_diag, diag, upv)
        pTS = torch.where(take_diag, dTS, TS[:, :, 1:])
        pQS = torch.where(take_diag, dQS, QS[:, :, 1:])
        floored = T < 0
        T = torch.where(floored, 0, T)
        pTS = torch.where(floored, jarr + 1, pTS)
        pQS = torch.where(floored, i + 1, pQS)
        # in-row gap runs: doubling prefix max of A = T + gap*j, payloads
        # follow; strict '>' keeps the unshifted value on ties
        A = T + gj
        d = 1
        while d < L:
            A_s = torch.cat([torch.full((B, C, d), NEG, dtype=i32,
                                        device=dev), A[:, :, :-d]], dim=2)
            better = A_s > A
            A = torch.where(better, A_s, A)
            pTS = torch.where(better, torch.cat(
                [pTS[:, :, :d], pTS[:, :, :-d]], dim=2), pTS)
            pQS = torch.where(better, torch.cat(
                [pQS[:, :, :d], pQS[:, :, :-d]], dim=2), pQS)
            d *= 2
        # a combo past its own length keeps its state
        newH = torch.where(live, A - gj, H[:, :, 1:])
        pTS = torch.where(live, pTS, TS[:, :, 1:])
        pQS = torch.where(live, pQS, QS[:, :, 1:])
        H = torch.cat([zcol, newH], dim=2)
        TS = torch.cat([zcol, pTS], dim=2)
        QS = torch.cat([zcol, pQS], dim=2)
        upd = live & (newH > colmax)
        colmax = torch.where(upd, newH, colmax)
        qend = torch.where(upd, i, qend)
        tsb = torch.where(upd, pTS, tsb)
        qsb = torch.where(upd, pQS, qsb)

    valid = (jarr[None, :] < lens.to(device=dev, dtype=i32)[:, None]
             )[:, None, :]                                     # (B, 1, L)
    j1 = torch.where(valid, colmax, -1).argmax(dim=2, keepdim=True)
    take = lambda M: torch.gather(M, 2, j1)                    # noqa: E731
    s1, qe1, ts1, qs1 = take(colmax), take(qend), take(tsb), take(qsb)
    j1 = j1.to(i32)
    overlap = torch.minimum(jarr, j1) - torch.maximum(tsb, ts1) + 1
    masked = torch.where(valid & (overlap <= ADAPTER_OVERLAP_TOL), colmax,
                         NEG)
    s2 = masked.max(dim=2, keepdim=True).values
    return tuple(x[:, :, 0].to(i32) for x in (s1, j1, qe1, ts1, qs1, s2))


def adapter_hits_cuda(reads: torch.Tensor, lens: torch.Tensor,
                      adapters: torch.Tensor, adapter_lens: torch.Tensor,
                      match: int, mismatch: int, gap: int):
    """The kernel (``csrc/adapters.cu``).  The arguments as
    ``adapter_hits_batch``, whose outputs it equals exactly."""
    dev = reads.device
    _build.require(reads, torch.int8, 2, "reads")
    _build.require(lens, torch.int32, 1, "lens", dev)
    _build.require(adapters, torch.int8, 2, "adapters", dev)
    _build.require(adapter_lens, torch.int32, 1, "adapter_lens", dev)
    B, L = reads.shape
    C, m = adapters.shape
    if lens.shape[0] != B or adapter_lens.shape[0] != C:
        raise ValueError("lens / adapter_lens disagree with reads / "
                         "adapters")
    if L > MAX_COLUMNS:
        raise ValueError(f"L = {L} is over {MAX_COLUMNS}")
    if m > MAX_ADAPTER_LEN:
        raise ValueError(f"adapter width {m} > {MAX_ADAPTER_LEN}")
    if not (-128 <= match <= 127 and -128 <= mismatch <= 127) or gap < 0:
        raise ValueError(f"match {match} and mismatch {mismatch} must fit "
                         f"a signed byte and gap {gap} be >= 0")
    if max(match, 0) * m > MAX_SCORE:
        raise ValueError(f"scores up to {match} * {m} exceed {MAX_SCORE}")
    if C and int(adapter_lens.max()) > m:
        raise ValueError(f"adapter_lens exceed the adapter width {m}")
    out = torch.empty((6, B, C), dtype=torch.int32, device=dev)
    if B and C:
        # one word a (read, combo, column) for the s2 reduction, written
        # and read at each read's own columns only
        scratch = torch.empty((B, C, L), dtype=torch.int32, device=dev)
        carry = torch.empty((B, C, L, 4) if m > PASS_ROWS else (0,),
                            dtype=torch.int32, device=dev)
        _build.launch(
            "adapters", "c3t_adapter_hits", "adapter_hits_cuda", reads,
            reads.data_ptr(), lens.data_ptr(), adapters.data_ptr(),
            adapter_lens.data_ptr(), scratch.data_ptr(),
            carry.data_ptr() if carry.numel() else None, out.data_ptr(),
            B, L, C, m, match, mismatch, gap, ADAPTER_OVERLAP_TOL)
    return tuple(out.unbind(0))


def adapter_hits(reads, lens, adapters, adapter_lens, match: int,
                 mismatch: int, gap: int):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if reads.device.type == "cuda":
        return adapter_hits_cuda(reads, lens, adapters, adapter_lens, match,
                                 mismatch, gap)
    if reads.device.type == "cpu":
        return adapter_hits_batch(reads, lens, adapters, adapter_lens,
                                  match, mismatch, gap)
    raise ValueError(f"unsupported device {reads.device}")
