"""Batched, length-masked Savitzky-Golay smoothing in float32 torch ops
(counterpart of ``c3poa_tpu/kernels/smooth.py:smooth3_batch``).

Three passes of the 41-tap order-2 filter of the reference
(``c3poa_tpu/ref/sg.py``), with the edge padding at each read's own
length:
- head: y[0] - |y[k] - y[0]|            for k = half..1
- tail: y[n-1] + |y[2n-2-k] - y[n-1]|   for k = n..n+half-1
- zeros past n.
The taps are summed in the JAX version's order (k = 0..40, one multiply
and one add each), so the float32 result tracks it closely; the
f32-vs-f64 error this leaves is what the guards in ``kernels.peaks``
are calibrated against.  Only elementwise ops: no TF32 path exists here.

``smooth3_batch`` is the plain torch version; ``smooth3_cuda`` launches
the hand-written kernel ``csrc/smooth.cu``, which reads the chosen
combo's int32 profile row itself and equals the plain version bit for
bit; ``smooth3`` dispatches on the profile's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ref.sg import sg_coeffs
from . import _build

WINDOW, ORDER = 41, 2
HALF = (WINDOW - 1) // 2


def smooth3_batch(scores: torch.Tensor, lens: torch.Tensor,
                  window: int = 41, order: int = 2,
                  iters: int = 3) -> torch.Tensor:
    """scores (B, L) float32; lens (B,) valid lengths (>= window + 1).
    Returns (B, L) float32, zero past each read's length."""
    B, L = scores.shape
    dev = scores.device
    half = (window - 1) // 2
    m = torch.tensor(sg_coeffs(window, order), dtype=torch.float32,
                     device=dev)
    x = scores.to(torch.float32)
    n = lens.to(torch.int64)[:, None]                         # (B, 1)
    oarr = torch.arange(half, device=dev)[None, :]            # (1, half)
    valid = torch.arange(L, device=dev)[None, :] < n
    for _ in range(iters):
        y0 = x[:, :1]
        yn = torch.gather(x, 1, torch.clamp(n - 1, min=0))
        head = y0 - torch.abs(torch.flip(x[:, 1:half + 1], [1]) - y0)
        tail_src = torch.gather(x, 1, torch.clamp(n - 2 - oarr, 0, L - 1))
        tail = yn + torch.abs(tail_src - yn)
        ext = torch.cat([head, x, torch.zeros((B, half), dtype=x.dtype,
                                              device=dev)], dim=1)
        # tail pad at per-row positions n + half + o (n <= L: in range)
        ext.scatter_(1, n + half + oarr, tail)
        out = torch.zeros_like(x)
        for k in range(window):
            out = out + m[k] * ext[:, k:k + L]
        x = torch.where(valid, out, 0.0)
    return x


def combo_rows(prof: torch.Tensor, combo: torch.Tensor) -> torch.Tensor:
    """(B, L): row ``combo[b]`` of ``prof[b]`` for each read; prof (B, C,
    L), combo (B,) int."""
    B, _C, L = prof.shape
    idx = combo.to(torch.int64).view(B, 1, 1).expand(B, 1, L)
    return torch.gather(prof, 1, idx)[:, 0, :]


@functools.lru_cache(maxsize=None)
def taps() -> np.ndarray:
    """The 41 float32 taps (read-only), made once on the host; the kernel
    takes them by value with each launch and never recomputes them."""
    m = np.ascontiguousarray(sg_coeffs(WINDOW, ORDER), np.float32)
    m.setflags(write=False)
    return m


def smooth3_cuda(prof: torch.Tensor, combo: torch.Tensor,
                 lens: torch.Tensor) -> torch.Tensor:
    """The kernel (``csrc/smooth.cu``): prof (B, C, L) int32, combo (B,)
    int32 in [0, C), lens (B,) int32 in [0, L], all on the card; returns
    (B, L) float32, ``smooth3_batch(combo_rows(prof, combo).float(),
    lens)`` bit for bit."""
    _build.require(prof, torch.int32, 3, "prof")
    dev = prof.device
    _build.require(combo, torch.int32, 1, "combo", dev)
    _build.require(lens, torch.int32, 1, "lens", dev)
    B, C, L = prof.shape
    if combo.shape[0] != B or lens.shape[0] != B:
        raise ValueError(f"combo {tuple(combo.shape)} / lens "
                         f"{tuple(lens.shape)} disagree with prof "
                         f"{tuple(prof.shape)} on B")
    if L <= HALF or C < 1:
        raise ValueError(f"prof {tuple(prof.shape)}: the edge pads need "
                         f"L > {HALF} and C >= 1")
    out = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B:
        _build.launch("smooth", "c3t_smooth3", "smooth3_cuda", prof,
                      prof.data_ptr(), combo.data_ptr(), lens.data_ptr(),
                      taps().ctypes.data, out.data_ptr(), B, C, L)
    return out


def smooth3(prof: torch.Tensor, combo: torch.Tensor,
            lens: torch.Tensor) -> torch.Tensor:
    """The smoothed chosen-combo rows: the kernel for CUDA tensors, the
    gather and ``smooth3_batch`` for CPU tensors."""
    if prof.device.type == "cuda":
        return smooth3_cuda(prof, combo, lens)
    if prof.device.type == "cpu":
        return smooth3_batch(combo_rows(prof, combo).to(torch.float32),
                             lens)
    raise ValueError(f"unsupported device {prof.device}")
