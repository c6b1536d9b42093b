"""The port's adapter hits on the CPU against the JAX package: the plain
torch ``adapter_hits_batch`` against the JAX kernel (XLA on the CPU) and
the numpy spec ``NumpyBackend.adapter_hits``, ``TorchBackend("cpu")``
against the spec under other length limits and batch caps, and a g++
build of the CUDA kernel's arithmetic (``csrc/adapters.cuh``) against
``ref/sw.local_hits``.  All six int32 outputs must be equal."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from c3poa_tpu.kernels.adapters import adapter_hits_batch as jax_hits
from c3poa_tpu.pipeline.backend import NumpyBackend
from c3poa_tpu_torch.kernels import adapters as ka
from c3poa_tpu_torch.pipeline import torch_backend as tbe
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
from torch_adapter_cases import (ADAPTER_SETS, adapter_matrix, batch, combos,
                                 edge_reads)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "c3poa_tpu_torch", "kernels", "csrc")
SCORING = NumpyBackend.ADAPTER_SCORING
NAMES = ("s1", "j1", "qe1", "ts1", "qs1", "s2")


@pytest.fixture(scope="module", params=sorted(ADAPTER_SETS))
def case(request):
    """(reads, combo codes, the spec's six (B, C) outputs)."""
    reads = edge_reads(seed=len(request.param))
    codes = combos(ADAPTER_SETS[request.param])
    want = NumpyBackend().adapter_hits(reads, codes, [len(c) for c in codes])
    return reads, codes, want


def _assert_same(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}: {name}")


def _plain(reads, codes, pad_to=64, extra=0, rows=0):
    R, lens = batch(reads, pad_to, extra)
    A, alens = adapter_matrix(codes, rows)
    return ka.adapter_hits_batch(*(torch.from_numpy(x) for x in
                                   (R, lens, A, alens)), *SCORING)


def test_plain_matches_numpy_spec(case):
    reads, codes, want = case
    _assert_same(_plain(reads, codes), want, "plain vs spec")


def test_plain_matches_jax_kernel(case):
    """The JAX kernel at each read's and each adapter's own size (its
    padding rows and columns change s2, see ROADMAP section 3)."""
    reads, codes, _ = case
    got = _plain(reads, codes)
    lens = sorted({len(c) for c in codes})
    for b, r in enumerate(reads):
        R = np.asarray(r, dtype=np.int8)[None]
        for m in lens:
            idx = [c for c in range(len(codes)) if len(codes[c]) == m]
            A = np.stack([codes[c] for c in idx]).astype(np.int8)
            res = jax_hits(R, A, np.full(len(idx), m, np.int32),
                           match=SCORING[0], mismatch=SCORING[1],
                           gap=SCORING[2])
            for k, name in enumerate(NAMES):
                np.testing.assert_array_equal(
                    got[k][b, idx].numpy(), np.asarray(res[k])[0],
                    err_msg=f"read {b} adapter length {m}: {name}")


@pytest.mark.parametrize("pad_to,extra,rows", [(8, 0, 0), (64, 200, 0),
                                               (64, 0, 64), (16, 77, 100)])
def test_plain_does_not_depend_on_padding(case, pad_to, extra, rows):
    """Padding columns and padding adapter rows (as the JAX backend pads
    every adapter to 64 rows) change no output."""
    reads, codes, want = case
    _assert_same(_plain(reads, codes, pad_to, extra, rows), want,
                 f"padded to {pad_to}, +{extra} columns, {rows} rows")


@pytest.mark.parametrize("limit,cap", [(None, None), (None, 1), (None, 3),
                                       (64, 2), (30, None)])
def test_torch_backend_cpu_matches_numpy(case, monkeypatch, limit, cap):
    """Other read-length limits (the exact host path) and batch caps give
    the spec's outputs."""
    reads, codes, want = case
    if limit is not None:
        monkeypatch.setattr(tbe, "MAX_READ_LEN", limit)
        assert any(len(r) > limit for r in reads)
    if cap is not None:
        monkeypatch.setattr(tbe, "MAX_ADAPTER_BATCH", cap)
    got = TorchBackend("cpu").adapter_hits(reads, codes,
                                           [len(c) for c in codes])
    for g in got:
        assert g.dtype == np.int64 and g.shape == want[0].shape
    _assert_same(got, want, f"limit {limit}, cap {cap}")


def test_empty_read_has_no_hit():
    """An empty read (the spec's argmax raises on it) reports no hit."""
    codes = combos(ADAPTER_SETS["default"])
    reads = [np.zeros(0, np.int8), edge_reads(n_random=1)[0]]
    got = TorchBackend("cpu").adapter_hits(reads, codes,
                                           [len(c) for c in codes])
    assert [int(g[0, 0]) for g in got] == [0, 0, 0, 0, 0, ka.NEG]
    want = NumpyBackend().adapter_hits(reads[1:], codes,
                                       [len(c) for c in codes])
    _assert_same([g[1:] for g in got], want, "beside an empty read")


def test_dispatch_never_falls_back():
    R = torch.full((1, 64), 4, dtype=torch.int8)
    lens = torch.tensor([10], dtype=torch.int32)
    A = torch.full((1, 8), 0, dtype=torch.int8)
    alens = torch.tensor([8], dtype=torch.int32)
    got = ka.adapter_hits(R, lens, A, alens, *SCORING)
    _assert_same(got, ka.adapter_hits_batch(R, lens, A, alens, *SCORING),
                 "dispatch on the CPU")
    with pytest.raises(ValueError, match="CUDA"):
        ka.adapter_hits_cuda(R, lens, A, alens, *SCORING)
    with pytest.raises(ValueError, match="unsupported device"):
        ka.adapter_hits(R.to("meta"), lens, A, alens, *SCORING)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """tests/adapters_host_driver.cpp over csrc/adapters.cuh, built with
    g++ (the CUDA kernel's control flow, run serially)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    so = str(tmp_path_factory.mktemp("adp") / "adp_host.so")
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                    "-Wextra", "-Werror", "-I", CSRC, "-o", so,
                    os.path.join(ROOT, "tests", "adapters_host_driver.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.adp_hits_host.argtypes = [P, P, I, I, P, P, I, I] + [I] * 6 + [P]
    lib.adp_hits_host.restype = I
    return lib


@pytest.mark.parametrize("nt,warp", [(128, 32), (8, 4), (4, 2), (2, 1)])
def test_kernel_header_matches_spec(case, host_lib, nt, warp):
    """The kernel's arithmetic with tile and warp seams inside the reads
    (a tile is nt * 8 columns)."""
    reads, codes, want = case
    R, lens = batch(reads)
    A, alens = adapter_matrix(codes)
    B, C = len(reads), len(codes)
    out = np.zeros((6, B, C), dtype=np.int32)
    rc = host_lib.adp_hits_host(
        R.ctypes.data, lens.ctypes.data, B, R.shape[1], A.ctypes.data,
        alens.ctypes.data, C, A.shape[1], *SCORING, ka.ADAPTER_OVERLAP_TOL,
        nt, warp, out.ctypes.data)
    assert rc == 0
    _assert_same(out, want, f"g++ header, {nt} threads, warps of {warp}")
