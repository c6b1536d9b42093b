"""The two probe kernels: counterparts of the TPU probes
``tools/int16_probe.py`` (packed int16 max / roll / select / add) and
``tools/mosaic_floor_probe.py`` (the issue cost of dependent int32
operations), each beside its plain torch version.

- ``int16_probe_plain`` / ``int16_probe_cuda`` (``csrc/int16_probe.cu``):
  for x, y (B, 128) int16, ``where(col >= 3, roll(max(x, y), 3, 1),
  -16000) + 1`` in int16 (the add wraps, as jnp int16's does).
- ``floor_probe_plain`` / ``floor_probe_cuda`` (``csrc/floor_probe.cu``):
  for x (S, 128) int32, ``niter`` iterations of ``M`` operations over
  1, 2 or 4 chains (``mode`` chain / indep2 / indep4), then the max over
  the chains; int32 arithmetic wraps.

``int16_probe`` and ``floor_probe`` take the plain version for CPU
tensors and the kernel for CUDA tensors.  The probes' entry points are
``c3poa_tpu_torch.tools.int16_probe`` and ``.floor_probe``.
"""

from __future__ import annotations

import torch

from . import _build

INT16_WIDTH = 128
INT16_SHIFT = 3
INT16_FILL = -16000

FLOOR_LANES = 128
FLOOR_CHAINS = {"chain": 1, "indep2": 2, "indep4": 4}
# the M values csrc/floor_probe.cu is built for (its launch_m)
FLOOR_M = (8, 16, 32, 64, 128)
# threads of the kernel's one block, and chains a thread runs at once
FLOOR_THREADS = 1024
FLOOR_MAX_CHAINS = 8


def int16_probe_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain torch version: x, y (B, W) int16 -> (B, W) int16."""
    r = torch.roll(torch.maximum(x, y), INT16_SHIFT, dims=1)
    col = torch.arange(x.shape[1], device=x.device)
    fill = torch.tensor(INT16_FILL, dtype=torch.int16, device=x.device)
    return torch.where(col >= INT16_SHIFT, r, fill) + 1


def int16_probe_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel (``csrc/int16_probe.cu``): x, y (B, 128) int16 on the
    card; equals ``int16_probe_plain``."""
    _build.require(x, torch.int16, 2, "x")
    _build.require(y, torch.int16, 2, "y", x.device)
    if x.shape != y.shape or x.shape[1] != INT16_WIDTH:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must "
                         f"both be (B, {INT16_WIDTH})")
    if x.data_ptr() % 8 or y.data_ptr() % 8:
        raise ValueError("x and y must be 8-byte aligned (8-byte loads)")
    B = x.shape[0]
    out = torch.empty_like(x)
    if B:
        _build.launch("int16_probe", "c3t_int16_probe", "int16_probe_cuda",
                      x, x.data_ptr(), y.data_ptr(), out.data_ptr(), B)
    return out


def int16_probe(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if x.device.type == "cuda":
        return int16_probe_cuda(x, y)
    if x.device.type == "cpu":
        return int16_probe_plain(x, y)
    raise ValueError(f"unsupported device {x.device}")


def _chains(M: int, mode: str) -> int:
    if mode not in FLOOR_CHAINS:
        raise ValueError(f"mode {mode!r}: one of {sorted(FLOOR_CHAINS)}")
    nch = FLOOR_CHAINS[mode]
    if M <= 0 or M % (2 * nch):
        raise ValueError(f"M = {M} must be a positive multiple of "
                         f"{2 * nch} for mode {mode!r}")
    return nch


def floor_probe_plain(x: torch.Tensor, M: int, niter: int,
                      mode: str) -> torch.Tensor:
    """Plain torch version (the loop of ``tools/mosaic_floor_probe.py``,
    ``:41-56``): x (S, W) int32 -> (S, W) int32."""
    nch = _chains(M, mode)
    c = x
    xs = [c + h for h in range(nch)]
    for _ in range(niter):
        for _k in range(M // (2 * nch)):
            for h in range(nch):
                xs[h] = xs[h] + c
                xs[h] = torch.maximum(xs[h], c - xs[h])
    acc = xs[0]
    for h in range(1, nch):
        acc = torch.maximum(acc, xs[h])
    return acc


def floor_pass_elems(S: int, mode: str) -> int:
    """Elements a thread of ``csrc/floor_probe.cu`` runs at once: the
    largest power of two that divides its S/8 elements with at most
    ``FLOOR_MAX_CHAINS`` chains in all."""
    per, e = S * FLOOR_LANES // FLOOR_THREADS, 1
    while per % (2 * e) == 0 and 2 * e * FLOOR_CHAINS[mode] <= \
            FLOOR_MAX_CHAINS:
        e *= 2
    return e


def floor_probe_cuda(x: torch.Tensor, M: int, niter: int,
                     mode: str) -> torch.Tensor:
    """The kernel (``csrc/floor_probe.cu``): x (S, 128) int32 on the card
    with S a positive multiple of 8, M in ``FLOOR_M``; equals
    ``floor_probe_plain``.  One block on one SM."""
    nch = _chains(M, mode)
    if M not in FLOOR_M:
        raise ValueError(f"M = {M}: the kernel is built for M in {FLOOR_M}")
    _build.require(x, torch.int32, 2, "x")
    S, lanes = x.shape
    if lanes != FLOOR_LANES or S <= 0 or S % 8:
        raise ValueError(f"x {tuple(x.shape)} must be (S, {FLOOR_LANES}) "
                         f"with S a positive multiple of 8")
    if not 0 <= niter < 2 ** 31 or S * FLOOR_LANES >= 2 ** 31:
        raise ValueError(f"niter = {niter} or S = {S} out of range")
    out = torch.empty_like(x)
    _build.launch("floor_probe", "c3t_floor_probe", "floor_probe_cuda", x,
                  x.data_ptr(), out.data_ptr(),
                  S * FLOOR_LANES // FLOOR_THREADS, M, niter, nch,
                  floor_pass_elems(S, mode))
    return out


def floor_probe(x: torch.Tensor, M: int, niter: int,
                mode: str) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if x.device.type == "cuda":
        return floor_probe_cuda(x, M, niter, mode)
    if x.device.type == "cpu":
        return floor_probe_plain(x, M, niter, mode)
    raise ValueError(f"unsupported device {x.device}")
