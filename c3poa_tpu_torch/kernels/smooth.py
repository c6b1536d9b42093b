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
"""

from __future__ import annotations

import torch

from ..ref.sg import sg_coeffs


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
