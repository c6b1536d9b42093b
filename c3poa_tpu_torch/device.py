"""Device selection for the port (the role of the jax cache set-up in
``c3poa_tpu/kernels/__init__.py``).

There is no global device state: every function takes an explicit
``device``.  ``resolve_device`` never degrades — asking for ``cuda`` on a
machine without a usable card is an error, not a silent CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` -> ``torch.device``.

    Also turns TF32 off for float32 convolutions and matmuls, so any
    float32 math on the card runs at full float32 precision (the f32
    smoothing guards in ``kernels.peaks`` were calibrated on it)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but torch.cuda.is_available()"
                f" is False (torch {torch.__version__})")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(name)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r} (cuda or cpu)")
    return dev
