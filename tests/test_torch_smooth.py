"""The smoothing kernel's arithmetic and tile schedule (``csrc/smooth.cuh``
under ``tests/smooth_host_driver.cpp``, built with g++ and
``-ffp-contract=off``) held bit for bit to the plain torch version
``c3poa_tpu_torch.kernels.smooth.smooth3_batch``, for every edge length,
several tile and group widths, random and bench-shaped rows; an FMA mutant
of the tap must fail that.  The dispatcher's CPU route against the JAX
package's ``smooth3_batch``."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from c3poa_tpu.kernels.smooth import smooth3_batch as jax_smooth
from c3poa_tpu_torch.kernels import locate as tloc
from c3poa_tpu_torch.kernels import peaks as tpk
from c3poa_tpu_torch.kernels import smooth as tsm
from c3poa_tpu_torch.ref.sg import sg_coeffs
from test_torch_locate import bench_profiles  # noqa: F401 (a fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "c3poa_tpu_torch", "kernels", "csrc")
GARBAGE = np.float32(np.frombuffer(np.int32(0x5A5A5A5A).tobytes(),
                                   np.float32)[0])


def _build_driver(out_dir, *defines):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    so = str(out_dir / "smooth_host.so")
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-Wall", "-Wextra", "-Werror", *defines, "-I",
                    CSRC, "-o", so,
                    os.path.join(ROOT, "tests", "smooth_host_driver.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sm_host.argtypes = [P] * 5 + [I] * 5
    lib.sm_host.restype = I
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The header's arithmetic run in the kernel's tile schedule."""
    return _build_driver(tmp_path_factory.mktemp("sm"))


@pytest.fixture(scope="module")
def mutant_lib(tmp_path_factory):
    """The same with the tap fused: fmaf(m, e, acc)."""
    return _build_driver(tmp_path_factory.mktemp("smfma"),
                         "-DSMOOTH_MUTANT_FMA")


def _host(lib, prof, combo, lens, T, R):
    """The host driver's output, into a buffer of garbage: every element
    must be written."""
    B, C, L = prof.shape
    prof, combo, lens = (np.ascontiguousarray(a, np.int32)
                         for a in (prof, combo, lens))
    m = tsm.taps()
    out = np.full((B, L), GARBAGE, np.float32)
    assert lib.sm_host(prof.ctypes.data, combo.ctypes.data, lens.ctypes.data,
                       m.ctypes.data, out.ctypes.data, B, C, L, T, R) == 0
    return out


def _plain(prof, combo, lens):
    p, c, n = (torch.from_numpy(np.ascontiguousarray(a, np.int32))
               for a in (prof, combo, lens))
    return tsm.smooth3_batch(tsm.combo_rows(p, c).to(torch.float32),
                             n).numpy()


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _assert_bitwise(got, want, what):
    bad = np.argwhere(_bits(got) != _bits(want))
    assert bad.size == 0, (f"{what}: {len(bad)} elements differ, first at "
                           f"{tuple(bad[0])}: {got[tuple(bad[0])]!r} vs "
                           f"{want[tuple(bad[0])]!r}")


def _edge_lens(T, L):
    return [0, 1, 2, 5, 20, 21, 22, 41, 42, 43, 63, 64, 65, T - 1, T, T + 1,
            L - 1, L]


def _random_rows(rng, B, C, L):
    """Profile-like int32 rows: small scores with runs of zeros and
    plateaus, and some rows of large values (exact in float32)."""
    prof = rng.integers(0, 230, (B, C, L)).astype(np.int32)
    for b in range(B):
        for c in range(C):
            a = int(rng.integers(0, L))
            prof[b, c, a:a + int(rng.integers(0, 200))] = 0
            a = int(rng.integers(0, L))
            prof[b, c, a:a + int(rng.integers(0, 60))] = int(
                rng.integers(0, 230))
    prof[::5] = rng.integers(-(1 << 20), 1 << 20, prof[::5].shape)
    return prof


def _random_case(seed, T):
    rng = np.random.default_rng(seed)
    L = 2 * T + 64
    lens = np.array(_edge_lens(T, L), np.int32)
    B, C = len(lens), 2
    return _random_rows(rng, B, C, L), rng.integers(0, C, B), lens


def _bench_case(profs, seed=0):
    """The bench profiles as rows of a (B, 2, L) block, at a random combo,
    the other combo random scores; zero past each read, as the profile
    kernel leaves it."""
    rng = np.random.default_rng(seed)
    L = -(-max(len(p) for p in profs) // 64) * 64
    B = len(profs)
    prof = np.zeros((B, 2, L), np.int32)
    combo = rng.integers(0, 2, B)
    for b, p in enumerate(profs):
        prof[b, combo[b], :len(p)] = p
        prof[b, 1 - combo[b], :len(p)] = rng.integers(0, 40, len(p))
    return prof, combo, np.array([len(p) for p in profs], np.int32)


def _tile(lib, T):
    """T, or the kernel's own tile width for "kernel"."""
    if T != "kernel":
        return T
    lib.sm_kernel_tile.restype = ctypes.c_int
    return lib.sm_kernel_tile()


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("T", [64, 256, 1024, "kernel"])
def test_header_matches_plain_bitwise(host_lib, T, R):
    """Every listed edge length n on random rows: the tile schedule equals
    the plain version bit for bit (-0 against +0 counts)."""
    T = _tile(host_lib, T)
    prof, combo, lens = _random_case(T + R, T)
    _assert_bitwise(_host(host_lib, prof, combo, lens, T, R),
                    _plain(prof, combo, lens), f"T={T} R={R}")


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("T", [64, 256, 1024, "kernel"])
def test_header_matches_plain_on_bench_profiles(host_lib, bench_profiles,
                                                T, R):
    T = _tile(host_lib, T)
    prof, combo, lens = _bench_case(bench_profiles[2])
    _assert_bitwise(_host(host_lib, prof, combo, lens, T, R),
                    _plain(prof, combo, lens), f"T={T} R={R}")


def test_kernel_taps_are_the_plain_versions():
    """The host taps the kernel is launched with are the float32 taps
    ``smooth3_batch`` multiplies by, bit for bit, and stay read-only."""
    want = torch.tensor(sg_coeffs(41, 2), dtype=torch.float32).numpy()
    assert tsm.taps().dtype == np.float32 and tsm.taps().shape == (41,)
    np.testing.assert_array_equal(_bits(tsm.taps()), _bits(want))
    assert tsm.taps() is tsm.taps() and not tsm.taps().flags.writeable


def test_driver_reports_the_kernels_launch_shape(host_lib):
    """The kernel's tile: its widest pass (T + 80 columns) is one group
    of 8 a thread of 128, and tile starts stay 16-byte aligned."""
    host_lib.sm_kernel_r.restype = ctypes.c_int
    T = _tile(host_lib, "kernel")
    assert host_lib.sm_kernel_r() == 8
    assert T + 80 == 128 * 8 and T % 16 == 0
    assert host_lib.sm_host(None, None, None, None, None, 0, 1, 64, 64,
                            3) == -1


def test_result_does_not_depend_on_tiling(host_lib, bench_profiles):
    """Tile widths down to 1 column and every group width give one
    result, the kernel's own shape included; so does the batch around a
    read (each read alone)."""
    prof, combo, lens = _bench_case(bench_profiles[2], seed=1)
    want = _host(host_lib, prof, combo, lens, _tile(host_lib, "kernel"), 8)
    for T, R in ((1, 1), (7, 8), (13, 2), (40, 4), (64, 8), (500, 1),
                 (4096, 8), (prof.shape[2], 4)):
        _assert_bitwise(_host(host_lib, prof, combo, lens, T, R), want,
                        f"T={T} R={R}")
    for b in range(len(lens)):
        one = _host(host_lib, prof[b:b + 1], combo[b:b + 1], lens[b:b + 1],
                    64, 8)
        _assert_bitwise(one[0], want[b], f"read {b} alone")


def test_zero_rows_smooth_to_positive_zero(host_lib):
    """Runs of zero scores: the products with the negative taps are -0,
    and the smoothed zeros must come out +0, as the plain version's."""
    L = 300
    prof = np.zeros((3, 1, L), np.int32)
    prof[2, 0, 150:] = 7
    lens = np.array([L, 100, 280], np.int32)
    combo = np.zeros(3, np.int64)
    want = _plain(prof, combo, lens)
    assert (_bits(want[:2]) == 0).all()
    _assert_bitwise(_host(host_lib, prof, combo, lens, 64, 8), want, "zeros")


def test_fma_mutant_fails(host_lib, mutant_lib, bench_profiles):
    """Fusing the tap changes the bits on bench-shaped rows: the bitwise
    check can fail."""
    prof, combo, lens = _bench_case(bench_profiles[2])
    want = _plain(prof, combo, lens)
    _assert_bitwise(_host(host_lib, prof, combo, lens, 256, 8), want, "ok")
    got = _host(mutant_lib, prof, combo, lens, 256, 8)
    assert (_bits(got) != _bits(want)).sum() > 0


def test_dispatcher_cpu_route_matches_jax(bench_profiles):
    """``smooth3`` on CPU tensors: the gather and the plain version, at
    the JAX package's tolerance (its own f32 sums differ in rounding)."""
    prof, combo, lens = _bench_case(bench_profiles[2], seed=2)
    p, c, n = (torch.from_numpy(a.astype(np.int32))
               for a in (prof, combo, lens))
    got = tsm.smooth3(p, c, n).numpy()
    _assert_bitwise(got, _plain(prof, combo, lens), "dispatcher")
    rows = prof[np.arange(len(lens)), combo].astype(np.float32)
    np.testing.assert_allclose(got, np.asarray(jax_smooth(rows, lens)),
                               rtol=0, atol=2e-4)


def test_locate_device_cpu_route_is_unchanged():
    """``locate_device`` on the CPU: the same outputs as the gather,
    float copy and ``smooth3_batch`` it ran before the dispatcher."""
    rng = np.random.default_rng(4)
    B, L = 5, 640
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    lens = np.array([L, 600, 300, 64, 21], np.int32)
    splints = rng.integers(0, 4, (2, 40)).astype(np.int8)
    for b, n in enumerate(lens):
        reads[b, n:] = 4
    reads[0, 100:140] = splints[0]
    reads[1, 400:440] = splints[1]
    R, n, S = (torch.from_numpy(a) for a in (reads, lens, splints))
    got = tloc.locate_device(R, n, S, tile=64)
    prof = tloc.profile_rows(R, n, S)
    combo = got[0]
    rows = torch.gather(prof, 1, combo.to(torch.int64).view(B, 1, 1).expand(
        B, 1, L))[:, 0, :]
    sm = tsm.smooth3_batch(rows.to(torch.float32), n)
    cand_pos, cand_h, med, _h, _g, deep, margin = \
        tpk.peak_candidates_batch(sm, n, tile=64)
    for a, b in zip(got[2:], (cand_pos, cand_h, med, deep, margin)):
        assert torch.equal(a, b)


def test_wrappers_refuse_what_they_cannot_take():
    prof = torch.zeros((2, 2, 64), dtype=torch.int32)
    combo = torch.zeros(2, dtype=torch.int32)
    lens = torch.full((2,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tsm.smooth3_cuda(prof, combo, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        tsm.smooth3(prof.to("meta"), combo.to("meta"), lens.to("meta"))


def test_smooth_error_tool_goes_through_the_dispatcher(monkeypatch):
    """``tools/smooth_error`` smooths through ``smooth3`` (on the card,
    the kernel) and measures an f32 error inside the guards' scale."""
    from c3poa_tpu_torch.tools import smooth_error
    seen = []

    def spy(prof, combo, lens):
        seen.append(tuple(prof.shape))
        return tsm.smooth3(prof, combo, lens)

    monkeypatch.setattr(smooth_error, "smooth3", spy)
    enc, combos = smooth_error.bench_reads(2, 60, seed=3)
    res = smooth_error.measure_reads([c[:1500] for c in enc], combos,
                                     torch.device("cpu"))
    assert seen and seen[0][1] == 2
    assert res["reads"] == 2 and 0 < res["max_abs"] < tpk.STRUCT_ATOL


def test_chip_smoke_refuses_a_fused_tap(monkeypatch):
    """``chip_smoke.smooth_sass`` counts the kernel's float32 forms and
    fails on an FFMA (read here from a stand-in for ``cuobjdump``)."""
    import importlib.util
    from c3poa_tpu_torch.kernels import _build
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    insns = [(0, "FMUL R1, R2, c[0x0][0x210]"), (16, "FADD R4, R4, R1"),
             (32, "@!P0 FADD R5, -R6, R7"), (48, "FMUL R3, R2, UR4"),
             (64, "FMUL R3, R2, R5"), (80, "LDS.128 R8, [R9]")]
    funcs = {"_ZN4some5other6kernelEv": [(0, "FFMA R1, R2, R3, R4")],
             "_ZN12_GLOBAL__N_114smooth3_kernelEPKi": insns}
    monkeypatch.setattr(_build, "sass", lambda name: funcs)
    assert smoke.smooth_sass() == {"instructions": 6, "FMUL": 3,
                                   "FADD": 2, "FMUL_uniform_tap": 2}
    insns.append((64, "FFMA R1, R2, R3, R1"))
    with pytest.raises(smoke.SmokeFailure, match="1 FFMA"):
        smoke.smooth_sass()
