"""The splint-profile kernel's row arithmetic (``csrc/profile.cuh`` under
``tests/profile_host_driver.cpp``, built with g++) held bit for bit to the
plain torch version ``c3poa_tpu_torch.kernels.sw_profile.
start_profile_batch``: splints of every width the kernel takes, reads that
end at a tile's seams, short, empty and all-N reads, N codes on both
sides, an occurrence across a seam, other scorings, and several
interleavings of the kernel's warps; two mutants of the header must fail.
One case also against the JAX package's ``start_profile_batch`` and the
numpy spec ``ref/sw.py:start_profile``."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from c3poa_tpu.kernels.sw_profile import start_profile_batch as jax_profile
from c3poa_tpu.ref import sw
from c3poa_tpu_torch.kernels import sw_profile as tp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "c3poa_tpu_torch", "kernels", "csrc")
GARBAGE = 0x5A5A5A5A


def _build_driver(out_dir, *defines):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    so = str(out_dir / "profile_host.so")
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                    "-Wextra", "-Werror", *defines, "-I", CSRC, "-o", so,
                    os.path.join(ROOT, "tests", "profile_host_driver.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.pf_host.argtypes = [P] * 4 + [I] * 9
    lib.pf_host.restype = I
    lib.pf_host_dot.argtypes = [U, U, I]
    lib.pf_host_dot.restype = I
    lib.pf_host_addmax_relu.argtypes = [I] * 3
    lib.pf_host_addmax_relu.restype = I
    lib.pf_tile_width.restype = I
    lib.pf_host_smem_bytes.argtypes = [I]
    lib.pf_host_smem_bytes.restype = U
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The header's arithmetic run in the kernel's control flow."""
    return _build_driver(tmp_path_factory.mktemp("pf"))


def _max_fit_m():
    m = 1
    while tp.profile_fits(m + 1):
        m += 1
    return m


def _host(lib, R, S, lens, scoring=(1, -2, 2), order=0):
    """The host driver's output, into a buffer of garbage: every element
    must be written."""
    R, S = (np.ascontiguousarray(a, np.int8) for a in (R, S))
    lens = np.ascontiguousarray(lens, np.int32)
    (B, L), (C, m) = R.shape, S.shape
    match, _mismatch, gap = scoring
    out = np.full((B, C, L), GARBAGE, np.int32)
    rc = lib.pf_host(R.ctypes.data, lens.ctypes.data, S.ctypes.data,
                     out.ctypes.data, B, L, C, m,
                     tp.tile_overlap(m, match, gap), *scoring, order)
    assert rc == 0, rc
    return out


def _plain(R, S, scoring=(1, -2, 2)):
    return tp.start_profile_batch(torch.from_numpy(R), torch.from_numpy(S),
                                  *scoring).numpy()


def _assert_same(got, want, what):
    bad = np.argwhere(got != want)
    assert bad.size == 0, (f"{what}: {len(bad)} elements differ, first at "
                           f"{tuple(bad[0])}: {got[tuple(bad[0])]} vs "
                           f"{want[tuple(bad[0])]}")


def _case(seed, lens, L, m, C=2, n_rate=0.02, plant=None):
    """Random reads of the given lengths (pad 4 past each), C random
    splints of width m with their last quarter cut short by pad, N codes
    at ``n_rate`` inside both; ``plant`` = (read, column): splint 0's
    real part written into that read from that column."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    R = np.full((B, L), 4, np.int8)
    for b, n in enumerate(lens):
        R[b, :n] = rng.integers(0, 4, n)
        R[b, :n][rng.random(n) < n_rate] = 4
    S = np.full((C, m), 4, np.int8)
    slens = []
    for c in range(C):
        k = max(1, m - int(rng.integers(0, m // 4 + 1)))
        S[c, :k] = rng.integers(0, 4, k)
        S[c, :k][rng.random(k) < n_rate] = 4
        slens.append(k)
    if plant is not None:
        b, a = plant
        k = min(slens[0], lens[b] - a)
        R[b, a:a + k] = S[0, :k]
    return R, S, np.array(lens, np.int32), slens


@pytest.mark.parametrize("m", [1, 31, 32, 33, 224, 480, "max"])
def test_header_matches_plain_at_every_splint_width(host_lib, m):
    """Splints from one row to the widest the kernel takes (its overlap
    leaves 256 new columns a tile), over reads of several tiles."""
    if m == "max":
        m = _max_fit_m()
        assert not tp.profile_fits(m + 1)
    core = tp.TILE_WIDTH - tp.tile_overlap(m)
    L = -(-(2 * core + 40) // 16) * 16
    R, S, lens, _ = _case(m, [L, core + 7, 5], L, m,
                          C=1 if m > 1000 else 2)
    _assert_same(_host(host_lib, R, S, lens), _plain(R, S), f"m={m}")


@pytest.mark.parametrize("m", [33, 224])
def test_header_matches_plain_at_tile_seams(host_lib, m):
    """Reads that end one column before, at and after the end of a
    tile's core (the next tile starts there, and is all zeros when it
    starts at or past the read's end), and at the next seam."""
    core = tp.TILE_WIDTH - tp.tile_overlap(m)
    L = -(-(2 * core + 16) // 16) * 16
    lens = [core - 1, core, core + 1, 2 * core - 1, 2 * core, 2 * core + 1,
            L]
    R, S, lens, _ = _case(100 + m, lens, L, m)
    _assert_same(_host(host_lib, R, S, lens), _plain(R, S), f"m={m}")


def test_header_matches_plain_on_short_empty_and_n_reads(host_lib):
    """L = 16 (one thread's columns), a read of length 0, an all-N read
    (length L, every code 4), reads of 1 and 15 columns, reads with N
    codes at 30%."""
    R, S, lens, _ = _case(7, [16, 0, 16, 1, 15], 16, 20)
    R[2, :] = 4
    _assert_same(_host(host_lib, R, S, lens), _plain(R, S), "L=16")
    R, S, lens, _ = _case(8, [0, 300, 300], 304, 64, n_rate=0.3)
    R[1, :] = 4
    got = _host(host_lib, R, S, lens)
    _assert_same(got, _plain(R, S), "N reads")
    assert not got[:2].any()


def test_header_matches_plain_on_n_splints(host_lib):
    """A combo of N codes only (no row scores: the kernel runs no row),
    one whose real codes end at its first row, and one whose last code
    is real (no row skipped)."""
    R, S, lens, _ = _case(16, [900, 512], 912, 40, C=3)
    S[0, :] = 4
    S[1, 1:] = 4
    S[2, :] = np.random.default_rng(16).integers(0, 4, 40)
    got = _host(host_lib, R, S, lens)
    _assert_same(got, _plain(R, S), "N splints")
    assert not got[:, 0].any() and got[:, 1].any()


def test_header_matches_plain_across_a_seam(host_lib):
    """A splint occurrence planted across the first seam scores its full
    length on both sides of it."""
    m = 224
    core = tp.TILE_WIDTH - tp.tile_overlap(m)
    L = 2 * core + 64
    R, S, lens, slens = _case(9, [L, L], L, m, n_rate=0.0,
                              plant=(0, core - 100))
    got = _host(host_lib, R, S, lens)
    _assert_same(got, _plain(R, S), "seam")
    assert got[0, 0, core - 100] == slens[0]


@pytest.mark.parametrize("scoring", [(1, -2, 2), (2, -3, 3), (1, -3, 1),
                                     (5, -4, 4), (127, -128, 3), (3, 1, 1)])
def test_header_matches_plain_at_other_scorings(host_lib, scoring):
    """Table bytes of either sign up to the signed byte's ends (dp4a
    multiplies signed bytes) and a positive mismatch."""
    R, S, lens, _ = _case(11, [700, 333, 1024], 1024, 48, n_rate=0.05,
                          plant=(0, 200))
    _assert_same(_host(host_lib, R, S, lens, scoring), _plain(R, S, scoring),
                 f"scoring={scoring}")


def test_header_refuses_scorings_beyond_a_byte(host_lib):
    """Scores beyond a signed byte, a negative gap (the scan past lane 31
    and the edge need gap >= 0) and one beyond 2^16."""
    R, S, lens, _ = _case(12, [64], 64, 8)
    out = np.zeros((1, 2, 64), np.int32)
    for scoring in ((200, -2, 2), (1, -140, 2), (1, -2, 70000), (1, -2, -1)):
        assert host_lib.pf_host(R.ctypes.data, lens.ctypes.data,
                                S.ctypes.data, out.ctypes.data, 1, 64, 2, 8,
                                tp.tile_overlap(8), *scoring, 0) == -1


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_result_does_not_depend_on_the_warps_interleaving(host_lib, order):
    """Row by row, and seeded random choices among the warps whose slot
    is written: the result of warp by warp, which is the plain version's."""
    m = 40
    R, S, lens, _ = _case(13, [1500, 4096, 64], 4096, m, plant=(1, 3000))
    want = _host(host_lib, R, S, lens, order=0)
    _assert_same(want, _plain(R, S), "order 0")
    _assert_same(_host(host_lib, R, S, lens, order=order), want,
                 f"order {order}")


def test_header_matches_jax_and_the_spec(host_lib):
    """The header against the JAX package's XLA scan and ``ref/sw.py``."""
    m = 96
    R, S, lens, slens = _case(14, [1200, 700, 1024], 1216, m, plant=(2, 500))
    got = _host(host_lib, R, S, lens)
    _assert_same(got, np.asarray(jax_profile(R, S)), "jax")
    for b in range(R.shape[0]):
        for c in range(S.shape[0]):
            want = sw.start_profile(S[c][:slens[c]], R[b][:lens[b]])
            _assert_same(got[b, c, :lens[b]], want, f"spec {b} {c}")
            assert not got[b, c, lens[b]:].any()


@pytest.mark.parametrize("a,b,c,want", [
    (0x03FE02FF, 0x00000001, 10, 9),          # byte 0: -1
    (0x03FE02FF, 0x00000100, 10, 12),         # byte 1: 2
    (0x03FE02FF, 0x00010000, -5, -7),         # byte 2: -2
    (0x03FE02FF, 0x01000000, 0, 3),           # byte 3: 3
    (0x03FE02FF, 0x00000000, 77, 77),         # no byte: read code 4
    (0x80808080, 0x01010101, 0, -512),        # signed bytes
    (0x7F7F7F7F, 0xFFFFFFFF, 1000, 492),
])
def test_dot_twin_follows_dp4a(host_lib, a, b, c, want):
    """The host twin of ``__dp4a`` on int (``dp4a.s32.s32``): c plus the
    products of the signed bytes; a one-hot byte picks its table byte."""
    assert host_lib.pf_host_dot(a, b, c) == want


@pytest.mark.parametrize("a,b,c,want", [
    (5, -2, 1, 3), (5, -2, 4, 4), (1, -2, -7, 0), (-3, 0, -1, 0),
    (0, 0, 0, 0)])
def test_relu_twin_follows_viaddmax_relu(host_lib, a, b, c, want):
    """The host twin of ``__viaddmax_s32_relu``: max(a + b, c, 0)."""
    assert host_lib.pf_host_addmax_relu(a, b, c) == want


def test_driver_reports_the_kernels_tile(host_lib):
    assert host_lib.pf_tile_width() == tp.TILE_WIDTH == 256 * 16


def test_kernel_shared_memory_is_all_dynamic(host_lib):
    """The launch opts in above 48 KB by ``pf_smem_bytes`` alone, so the
    kernel declares no static shared memory: every ``__shared__`` in
    ``profile.cu`` is the one ``extern`` array.  Splints of 1185-1216
    bases (m = 1216) need the opt-in only with the kernel's word a thread
    counted."""
    with open(os.path.join(CSRC, "profile.cu")) as f:
        decls = [ln.strip() for ln in f if "__shared__" in ln
                 and not ln.lstrip().startswith("//")]
    assert decls == ["extern __shared__ uint32_t smem[];"]
    assert tp.profile_fits(1216)
    words = 1217 + 1216 * 9 + 256 + 1
    assert host_lib.pf_host_smem_bytes(1216) == 4 * words > 48 * 1024
    assert host_lib.pf_host_smem_bytes(1) == 4 * (2 + 9 + 257)


@pytest.mark.parametrize("mutant", ["PROFILE_MUTANT_N",
                                    "PROFILE_MUTANT_CARRY"])
def test_mutants_fail(tmp_path, mutant):
    """A read N taken as code 0 (A), and a warp's carry taken from two
    warps on (skipping its neighbour): each differs from the plain
    version where the faithful header equals it."""
    lib = _build_driver(tmp_path, f"-D{mutant}")
    m = 64
    R, S, lens, _ = _case(15, [4096, 2000], 4096, m, n_rate=0.05,
                          plant=(0, 1800))
    got = _host(lib, R, S, lens)
    assert (got != _plain(R, S)).any(), mutant
