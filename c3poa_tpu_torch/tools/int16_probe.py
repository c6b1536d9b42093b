"""Probe: does the card run int16 max / roll / select / add as packed
16-bit instructions?  (Counterpart of ``tools/int16_probe.py``, which asks
the TPU toolchain whether Mosaic compiles them: int16 DP state would
halve the DP kernels' tiles.)

    python -m c3poa_tpu_torch.tools.int16_probe [--device cuda|cpu]

Runs the probe kernel (``kernels/csrc/int16_probe.cu``; on ``--device
cpu`` its plain torch version) on the original's (16, 128) int16 inputs
and compares with numpy.  On the card it also prints the SASS the kernel
compiled to (``cuobjdump``): a packed ``...16x2`` opcode for an operation
answers the question for that operation.

Exit 0 = it builds, runs and matches ("INT16 OK"); 1 = the kernel did
not build or launch ("INT16 NOT SUPPORTED"); 2 = wrong output ("INT16
MISCOMPILES").
"""

from __future__ import annotations

import argparse
import collections
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import _build
from ..kernels.probes import int16_probe

KERNEL = "int16_probe_kernel"


def inputs(B: int = 16, W: int = 128, seed: int = 0):
    """The original's inputs (``tools/int16_probe.py:35-38``)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-10000, 10000, (B, W)).astype(np.int16)
    y = rng.integers(-10000, 10000, (B, W)).astype(np.int16)
    return x, y


def expected(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The original's numpy check (``tools/int16_probe.py:49-52``)."""
    W = x.shape[1]
    m = np.maximum(x, y)
    r = np.roll(m, 3, axis=1)
    return np.where(np.arange(W)[None, :] >= 3, r,
                    np.int16(-16000)).astype(np.int16) + 1


def sass_summary() -> list[str]:
    """Lines naming each SASS opcode of the probe kernel with its count,
    and the packed 16x2 ones."""
    funcs = _build.sass("int16_probe")
    body = next(v for k, v in funcs.items() if KERNEL in k)
    ops = collections.Counter(_build.sass_mnemonic(i) for _, i in body)
    packed = sorted(op for op in ops if "16X2" in op.upper())
    return [f"SASS of {KERNEL}: " +
            ", ".join(f"{op} x{n}" for op, n in sorted(ops.items())),
            "packed 16x2 opcodes: " + (", ".join(packed) if packed
                                       else "none")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="int16 packed-op probe.")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernel, default) or cpu (its plain "
                        "torch version)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    x, y = inputs()
    try:
        got = int16_probe(torch.from_numpy(x).to(dev),
                          torch.from_numpy(y).to(dev)).cpu().numpy()
    except (RuntimeError, OSError) as exc:
        print(f"INT16 NOT SUPPORTED: {type(exc).__name__}: "
              f"{str(exc).splitlines()[0][:200]}")
        return 1
    if dev.type == "cuda":
        for line in sass_summary():
            print(line)
    if np.array_equal(got, expected(x, y)):
        print(f"INT16 OK: max/roll/select/add compile and match "
              f"(on {dev.type})")
        return 0
    print("INT16 MISCOMPILES: output mismatch")
    return 2


if __name__ == "__main__":
    sys.exit(main())
