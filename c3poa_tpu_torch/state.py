"""The state the port carries across from the JAX backend.

The system has no weights: its device-side state is the splint reference
(one row per (splint, strand) combo) and the scoring constants.  The
array layout is the JAX backend's (``TpuBackend._splint_array``): int8
codes, padded with 4 (N) at the end to a multiple of 32 columns.
"""

from __future__ import annotations

import numpy as np
import torch


def splint_array(combos) -> np.ndarray:
    """(C, m) int8 splint codes, pad 4, m rounded up to a multiple of 32."""
    m = -(-max(len(c.codes) for c in combos) // 32) * 32
    S = np.full((len(combos), m), 4, dtype=np.int8)
    for i, c in enumerate(combos):
        S[i, :len(c.codes)] = c.codes
    return S


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> contiguous tensor on ``device`` (same dtype)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
