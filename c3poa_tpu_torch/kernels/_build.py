"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` at first use into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under ``build/c3poa_tpu_torch/`` beside the package,
named by a hash of the sources and flags — an edited source builds
anew, an unchanged one loads the library already built.  The library is
loaded with ``ctypes``: pointers and the CUDA stream go in as
``c_void_p``, and every C entry point returns ``cudaGetLastError()``,
which ``check`` raises on.

Every launch goes through ``launch``, which makes the tensor's device
current around the C call and passes that device's current stream: a
``<<<>>>`` launch runs on the current device, which must own the
stream.  Launch counts: ``launch`` counts each kernel where it launches
it and nowhere else.  ``run_pipeline`` calls locate and align from
two host threads, so the counters sit behind a lock.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from ..utils import prof

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "c3poa_tpu_torch")
# one library per source; never --use_fast_math (band_lo needs IEEE
# f32 division and round-half-even, see csrc/band_lo.cuh)
SOURCES = ("profile", "banded", "adapters", "int16_probe", "floor_probe",
           "smooth", "peaks")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry points of each library: pointers, then ints, then the stream
SIGNATURES = {
    "profile": {"c3t_start_profile": [_P] * 4 + [_I] * 8 + [_P]},
    "banded": {"c3t_banded_fwd": [_P] * 7 + [_I] * 8 + [_P],
               "c3t_banded_walk": [_P] * 8 + [_I] * 5 + [_P]},
    "adapters": {"c3t_adapter_hits": [_P] * 7 + [_I] * 8 + [_P]},
    "int16_probe": {"c3t_int16_probe": [_P] * 3 + [_I] + [_P]},
    "floor_probe": {"c3t_floor_probe": [_P] * 2 + [_I] * 5 + [_P]},
    "smooth": {"c3t_smooth3": [_P] * 5 + [_I] * 3 + [_P]},
    "peaks": {"c3t_peak_candidates": [_P] * 10 + [_I] * 3 + [_P]},
}

_LOCK = threading.Lock()
_LIBS: dict = {}
# nvcc's output per library (ptxas register / shared-memory report)
build_logs: dict = {}

_COUNT_LOCK = threading.Lock()
_COUNTS: dict = {}


def count(name: str) -> None:
    with _COUNT_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + 1


def reset_counts() -> None:
    with _COUNT_LOCK:
        _COUNTS.clear()


def launch_counts() -> dict:
    with _COUNT_LOCK:
        return dict(_COUNTS)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                       "the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC, name + ".cu"), "rb") as fh:
        h.update(fh.read())
    for hdr in sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, hdr), "rb") as fh:
            h.update(hdr.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; returns (path, tmp, Popen) or None when
    the library is already built."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    return path, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)


def _finish(name: str, job) -> None:
    path, tmp, proc = job
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, path)


def build_all() -> dict:
    """Build every library not built yet, one nvcc per source, all
    started together.  Returns {name: seconds} for the ones built."""
    with _LOCK:
        t0 = time.time()
        jobs = {n: _start(n) for n in SOURCES}
        took = {}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
                took[n] = round(time.time() - t0, 3)
        return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            with prof.current.stage("kernel_load"):
                job = _start(name)
                if job is not None:
                    _finish(name, job)
                lib = bind(ctypes.CDLL(_lib_path(name)), SIGNATURES[name])
            _LIBS[name] = lib
        return lib


def bind(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    """Declare the C entry points of a loaded kernel library: {name:
    argument types}, each returning a CUDA error code, and its error
    string."""
    lib.c3t_error_string.argtypes = [_I]
    lib.c3t_error_string.restype = ctypes.c_char_p
    for fn, args in signatures.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = _I
    return lib


_SASS_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_SASS_INSN = re.compile(r"/\*([0-9a-fA-F]{4,})\*/\s+(.*?)\s*;")


def sass(name: str) -> dict:
    """The SASS of ``csrc/<name>.cu`` (``cuobjdump -sass`` on its built
    library), as ``parse_sass`` gives it."""
    load(name)
    return sass_of(_lib_path(name))


def sass_of(path: str) -> dict:
    """The SASS of the kernel library at ``path``, as ``sass`` gives it."""
    found = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_nvcc()), "cuobjdump")
    return parse_sass(subprocess.run(
        [found, "-sass", path], check=True, capture_output=True,
        text=True, timeout=120).stdout)


def parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` output by kernel: {mangled name: [(address,
    instruction), ...]}, the predicate kept (a branch names its target's
    address: ``@P0 BRA 0x1b0``)."""
    insns, func = {}, None
    for line in text.splitlines():
        m = _SASS_FUNC.search(line)
        if m:
            func = m.group(1)
            insns[func] = []
            continue
        m = _SASS_INSN.search(line)
        if m and func is not None:
            insns[func].append((int(m.group(1), 16), m.group(2)))
    return insns


def sass_mnemonic(insn: str) -> str:
    """The opcode of one SASS instruction, modifiers kept, predicate
    dropped: ``@!P0 BRA 0x90`` -> ``BRA``."""
    parts = insn.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def require(t, dtype, ndim: int, name: str, device=None):
    """Validate a kernel argument: a contiguous CUDA tensor of ``dtype``
    with ``ndim`` dimensions (on ``device`` when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_of(t) -> int:
    """Handle of the calling thread's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(lib, entry: str, what: str, t, *args) -> None:
    """Call the C entry point ``entry`` of ``lib`` (``csrc/<lib>.cu`` by
    name, or a library ``bind`` declared) with ``args`` and the current
    stream of ``t``'s device, that device being current; count the launch
    as ``what`` and raise on a CUDA error."""
    import torch
    if isinstance(lib, str):
        lib = load(lib)
    with torch.cuda.device(t.device):
        count(what)
        rc = getattr(lib, entry)(*args, stream_of(t))
    check(lib, rc, what)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.c3t_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
