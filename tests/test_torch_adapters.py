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
from c3poa_tpu_torch import sim
from c3poa_tpu_torch.utils import encode
from torch_adapter_cases import (A3, A5, ADAPTER_SETS, adapter_matrix, batch,
                                 combos, edge_reads)

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
    g++ (the CUDA kernel's wavefront, run lane by lane)."""
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
    lib.adp_hits_host.argtypes = [P, P, I, I, P, P, I, I] + [I] * 5 + [P]
    lib.adp_hits_host.restype = I
    return lib


def _host_hits(lib, reads, codes, warp):
    R, lens = batch(reads)
    A, alens = adapter_matrix(codes)
    B, C = len(reads), len(codes)
    out = np.zeros((6, B, C), dtype=np.int32)
    rc = lib.adp_hits_host(
        R.ctypes.data, lens.ctypes.data, B, R.shape[1], A.ctypes.data,
        alens.ctypes.data, C, A.shape[1], *SCORING, ka.ADAPTER_OVERLAP_TOL,
        warp, out.ctypes.data)
    assert rc == 0
    return out


def _tie_case(seed):
    """Reads and adapters over two letters (and some N): many equal
    scores, so every tie rule decides some output."""
    rng = np.random.default_rng(seed)
    codes = [rng.choice([0, 1, 1, 4], n).astype(np.int8)
             for n in (3, 7, 12, 40)]
    reads = [rng.choice([0, 1, 1, 1, 4], n).astype(np.int8)
             for n in rng.integers(1, 80, 120)]
    return reads, codes, NumpyBackend().adapter_hits(
        reads, codes, [len(c) for c in codes])


@pytest.mark.parametrize("warp", [0, 32, 8, 4, 2])
def test_kernel_header_matches_spec(case, host_lib, warp):
    """The kernel's wavefront: warp 0 is the packed path (one word a
    cell), the one the postprocess run takes; otherwise the general path
    with warps of ``warp`` lanes: the 56-row combos take 2 rows a lane,
    and narrow warps run them (and the 25-row ones) in passes joined by
    the carry row.  Then two-letter reads and adapters, where ties decide
    the payloads."""
    reads, codes, want = case
    _assert_same(_host_hits(host_lib, reads, codes, warp), want,
                 f"g++ header, warps of {warp}")
    reads, codes, want = _tie_case(len(reads) + warp)
    _assert_same(_host_hits(host_lib, reads, codes, warp), want,
                 f"g++ header, two letters, warps of {warp}")


@pytest.mark.parametrize("warp", [32, 3])
def test_kernel_header_long_combo(host_lib, warp):
    """A combo longer than one pass of the real warp (150 rows: three
    passes of 64), planted whole, cut, with N codes and twice (ties), and
    an empty read beside it, against the plain version."""
    rng = np.random.default_rng(warp)
    long = sim.random_seq(rng, 150)
    codes = [encode(long), encode(long[:70] + "NN" + long[72:]),
             encode(A5)]
    rs = lambda n: sim.random_seq(rng, n)                      # noqa: E731
    reads = [encode(s) for s in (
        rs(40) + long + rs(30), long[:90] + rs(20) + long[60:],
        long + long, rs(10) + long[:100], "", rs(200))]
    R, lens = batch(reads)
    A, alens = adapter_matrix(codes)
    want = ka.adapter_hits_batch(*(torch.from_numpy(x) for x in
                                   (R, lens, A, alens)), *SCORING)
    _assert_same(_host_hits(host_lib, reads, codes, warp), want,
                 f"g++ header, long combo, warps of {warp}")
    assert int(want[0][0, 0]) == 150


def test_kernel_header_chooses_the_path_read_by_read(host_lib):
    """warp 0 is the kernel's choice, made read by read: reads of 4095
    columns and less take the packed path, longer ones (4096 and 4200
    here) the general path, in one batch; adapters planted across column
    4095, at both ends, and an empty read beside them."""
    rng = np.random.default_rng(4095)
    rs = lambda n: sim.random_seq(rng, n)                      # noqa: E731
    reads = [encode(s) for s in (
        rs(4095 - len(A5)) + A5, A5 + rs(4096 - len(A5) - len(A3)) + A3,
        rs(4080) + A5 + rs(100), A3 + rs(4200 - len(A3) - len(A5)) + A5, "",
        rs(300) + A5)]
    assert [len(r) for r in reads[:4]] == [4095, 4096, 4180 + len(A5), 4200]
    codes = combos(ADAPTER_SETS["default"])
    R, lens = batch(reads)
    A, alens = adapter_matrix(codes)
    want = ka.adapter_hits_batch(*(torch.from_numpy(x) for x in
                                   (R, lens, A, alens)), *SCORING)
    _assert_same(_host_hits(host_lib, reads, codes, 0), want,
                 "g++ header, reads either side of the packed limit")
    assert int(want[1][2].max()) > 4095


def test_timing_tool_counts_the_batch_and_reads_step_loops():
    """tools/adapters_time: the batch's cells, its 1024-column tail and
    wavefront steps; the step loops of a SASS listing (innermost loops
    with a byte permute), with their shuffles and local memory ops."""
    from c3poa_tpu_torch.tools import adapters_time
    lens = torch.tensor([1500, 1024, 10, 0], dtype=torch.int32)
    alens = torch.tensor([25, 56], dtype=torch.int32)
    st = adapters_time.batch_stats(lens, alens)
    assert st["cells"] == 2534 * 81 and st["cut_cells"] == 2048 * 81
    assert st["tile_cells_past_end"] == (4096 - 2534) / 4096
    assert st["warp_steps"] == sum(n + 24 + n + 27 for n in (1500, 1024,
                                                             10, 0))
    listing = [(0x00, "MOV R1, R2"), (0x10, "PRMT R3, R4, R5, 0x80"),
               (0x20, "SHFL.UP PT, R6, R3, 0x1, RZ"),
               (0x30, "LDL R7, [R1+0x4]"), (0x40, "@P0 BRA 0x10"),
               (0x50, "@P1 BRA 0x0"), (0x60, "@P1 BRA 0x70"),
               (0x70, "EXIT")]
    assert adapters_time.sweep_loops(listing) == [(4, 1, 1, 1)]
