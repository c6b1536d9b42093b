"""The peak-candidates kernels' arithmetic and schedule (``csrc/peaks.cuh``
under ``tests/peaks_host_driver.cpp``, built with g++ and
``-ffp-contract=off``) held bit for bit, on all seven outputs, to the plain
torch version ``c3poa_tpu_torch.kernels.peaks.peak_candidates_batch``: the
edge rows of ``torch_peaks_cases``, random and bench-shaped rows, tiles of
1, 16 and 64 columns (every width on random rows), chunks of the kernel's
2048 columns and smaller ones.  Three mutants must fail it: the smallest
midpoint on ties, an FMA in the gate, the plateau start not carried across
a chunk.  Also the dispatcher's CPU route, its refusals, and
``locate_device`` through it."""

import ast
import ctypes
import inspect
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from c3poa_tpu_torch.kernels import _build
from c3poa_tpu_torch.kernels import locate as tloc
from c3poa_tpu_torch.kernels import peaks as tpk
from c3poa_tpu_torch.kernels.smooth import smooth3_batch
from test_torch_locate import _profile_block
from test_torch_locate import bench_profiles  # noqa: F401 (a fixture)
from torch_peaks_cases import edge_rows, random_rows

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "c3poa_tpu_torch", "kernels", "csrc")
OUTPUTS = ("cand_pos", "cand_h", "med", "height", "gated", "deep", "margin")
MUTANTS = ("PEAKS_MUTANT_TIES", "PEAKS_MUTANT_FMA", "PEAKS_MUTANT_CARRY")


def _build_driver(out_dir, *defines):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    so = str(out_dir / "peaks_host.so")
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-Wall", "-Wextra", "-Werror", *defines, "-I",
                    CSRC, "-o", so,
                    os.path.join(ROOT, "tests", "peaks_host_driver.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pk_host.argtypes = [P, P, I, I, I, I] + [P] * 7
    lib.pk_host.restype = I
    lib.pk_kernel_chunk.restype = I
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build_driver(tmp_path_factory.mktemp("pk"))


@pytest.fixture(scope="module")
def mutant_libs(tmp_path_factory):
    return {m: _build_driver(tmp_path_factory.mktemp(m.lower()), f"-D{m}")
            for m in MUTANTS}


def _host(lib, sm, lens, tile, chunk):
    """The host driver's seven outputs, into buffers of garbage: every
    element must be written."""
    sm = np.ascontiguousarray(sm, np.float32)
    lens = np.ascontiguousarray(lens, np.int32)
    B, L = sm.shape
    M = L // tile
    pos = np.full((B, 2 * M), 0x5A5A5A5A, np.int32)
    h = pos.view(np.float32).copy()
    med, height = (np.full(B, np.nan, np.float32) for _ in range(2))
    gated, deep, margin = (np.full(B, 7, np.uint8) for _ in range(3))
    if chunk == "kernel":
        chunk = lib.pk_kernel_chunk()
    rc = lib.pk_host(sm.ctypes.data, lens.ctypes.data, B, L, tile, chunk,
                     pos.ctypes.data, h.ctypes.data, med.ctypes.data,
                     height.ctypes.data, gated.ctypes.data,
                     deep.ctypes.data, margin.ctypes.data)
    assert rc == 0
    for flag in (gated, deep, margin):
        assert set(np.unique(flag)) <= {0, 1}
    return pos, h, med, height, gated.astype(bool), deep.astype(bool), \
        margin.astype(bool)


def _plain(sm, lens, tile):
    out = tpk.peak_candidates_batch(torch.from_numpy(sm),
                                    torch.from_numpy(lens), tile=tile)
    return tuple(t.numpy() for t in out)


def _mismatch(got, want):
    """The first output that differs in bits, with where, or None."""
    for name, a, b in zip(OUTPUTS, got, want):
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert a.shape == b.shape, name
        bad = np.argwhere(a != b)
        if bad.size:
            return f"{name}: {len(bad)} differ, first at {tuple(bad[0])}"
    return None


def _assert_same(got, want, what):
    bad = _mismatch(got, want)
    assert bad is None, f"{what}: {bad}"


def _bench_rows(profs, L=4096):
    """The bench profiles smoothed by the plain version, cut to L
    columns."""
    X, lens = _profile_block(profs)
    sm = smooth3_batch(torch.from_numpy(X), torch.from_numpy(lens)).numpy()
    out = np.zeros((len(lens), L), np.float32)
    w = min(L, sm.shape[1])
    out[:, :w] = sm[:, :w]
    return out, np.minimum(lens, L).astype(np.int32)


@pytest.mark.parametrize("chunk", [64, 128, "kernel"])
@pytest.mark.parametrize("tile", [1, 16, 64])
@pytest.mark.parametrize("L", [64, 4096])
def test_header_matches_plain_on_edge_rows(host_lib, L, tile, chunk):
    sm, lens = edge_rows(L)
    _assert_same(_host(host_lib, sm, lens, tile, chunk),
                 _plain(sm, lens, tile), f"L={L} tile={tile} chunk={chunk}")


@pytest.mark.parametrize("tile", [1, 2, 4, 8, 16, 32, 64])
def test_header_matches_plain_on_random_rows(host_lib, tile):
    """Every tile width, random lengths, chunks of 64 and the kernel's."""
    rng = np.random.default_rng(tile)
    L = 3072
    sm = random_rows(rng, 8, L)
    lens = np.array([L, L - 1, 1500, 1023, 1025, 2047, 2049, 3], np.int32)
    want = _plain(sm, lens, tile)
    for chunk in (64, "kernel"):
        _assert_same(_host(host_lib, sm, lens, tile, chunk), want,
                     f"tile={tile} chunk={chunk}")


@pytest.mark.parametrize("tile", [1, 16, 64])
def test_header_matches_plain_on_bench_rows(host_lib, bench_profiles, tile):
    sm, lens = _bench_rows(bench_profiles[2])
    got = _host(host_lib, sm, lens, tile, "kernel")
    _assert_same(got, _plain(sm, lens, tile), f"tile={tile}")
    assert (got[0] >= 0).any(), "bench rows hold candidates"


def test_header_matches_jax_on_bench_rows(host_lib, bench_profiles):
    """Against the JAX package's ``peak_candidates_batch``: every output
    but ``margin`` equal, and ``margin`` a superset (the port's structure
    margin is never narrower, ``STRUCT_REL``)."""
    from c3poa_tpu.kernels import peaks as jpk
    sm, lens = _bench_rows(bench_profiles[2])
    got = _host(host_lib, sm, lens, 64, "kernel")
    want = [np.asarray(a) for a in jpk.peak_candidates_batch(sm, lens,
                                                             tile=64)]
    assert _mismatch(got[:6], want[:6]) is None
    assert not (want[6] & ~got[6]).any()


@pytest.mark.parametrize("mutant", MUTANTS)
def test_mutants_fail(host_lib, mutant_libs, mutant):
    """Each mutant disagrees with the plain version on the edge rows at
    the kernel's chunk, and the header does not."""
    sm, lens = edge_rows(4096)
    want = _plain(sm, lens, 64)
    _assert_same(_host(host_lib, sm, lens, 64, "kernel"), want, "header")
    assert _mismatch(_host(mutant_libs[mutant], sm, lens, 64, "kernel"),
                     want) is not None


def test_edge_rows_reach_every_branch():
    """The edge rows make the plain version take what the mutants and
    the margins test: a gated read and an ungated one, ``deep`` and
    ``margin`` both ways, a tie of heights in a tile, and a candidate at
    the plateau that spans the read."""
    L = 4096
    sm, lens = edge_rows(L)
    pos, h, _med, _height, gated, deep, margin = _plain(sm, lens, 64)
    assert gated.any() and not gated.all()
    assert deep.any() and not deep.all()
    assert margin.any() and not margin.all()
    M = L // 64
    assert (h[:, :M] == h[:, M:]).any() & (pos[:, :M] >= 0).any()
    assert ((L - 1) // 2 == pos).any()


def test_driver_refuses_what_the_kernel_cannot_take(host_lib):
    sm, lens = edge_rows(64)
    for tile, chunk in ((3, 64), (128, 128), (16, 24), (64, 32), (4, 20)):
        assert host_lib.pk_host(sm.ctypes.data, lens.ctypes.data, 1, 64,
                                tile, chunk, *([None] * 7)) == -1
    assert host_lib.pk_kernel_chunk() == 2048


def test_dispatcher_takes_the_plain_version_on_the_cpu():
    sm, lens = edge_rows(256)
    args = (torch.from_numpy(sm), torch.from_numpy(lens))
    for tile in (1, 64):
        got = tpk.peak_candidates(*args, tile=tile)
        for name, a, b in zip(OUTPUTS, got,
                              tpk.peak_candidates_batch(*args, tile=tile)):
            assert torch.equal(a, b), name


def test_wrappers_refuse_what_they_cannot_take():
    sm = torch.zeros((2, 64), dtype=torch.float32)
    lens = torch.full((2,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tpk.peak_candidates_cuda(sm, lens, 64)
    for tile in (3, 0, 128, 16.0):
        with pytest.raises(ValueError, match="power of two"):
            tpk.peak_candidates_cuda(sm, lens, tile)
    with pytest.raises(ValueError, match="unsupported device"):
        tpk.peak_candidates(sm.to("meta"), lens.to("meta"))


def test_wrapper_passes_the_c_signature(monkeypatch):
    """The wrapper's launch passes the C entry point's pointers and ints
    in order (the stream is ``_build.launch``'s), allocating each output
    at its shape and type."""
    seen = {}

    def fake_launch(lib, entry, what, t, *args):
        seen.update(lib=lib, entry=entry, what=what, args=args)

    monkeypatch.setattr(_build, "require", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", fake_launch)
    sm = torch.zeros((3, 128), dtype=torch.float32)
    lens = torch.full((3,), 100, dtype=torch.int32)
    out = tpk.peak_candidates_cuda(sm, lens, 16)
    sig = _build.SIGNATURES["peaks"]["c3t_peak_candidates"]
    assert (seen["lib"], seen["entry"], seen["what"]) == (
        "peaks", "c3t_peak_candidates", "peak_candidates_cuda")
    assert len(seen["args"]) == len(sig) - 1
    assert seen["args"][-3:] == (3, 128, 16)
    ptrs = seen["args"][:10]
    assert ptrs[:2] == (sm.data_ptr(), lens.data_ptr())
    assert ptrs[2:9] == tuple(t.data_ptr() for t in out)
    assert [(tuple(t.shape), t.dtype) for t in out] == [
        ((3, 16), torch.int32), ((3, 16), torch.float32),
        ((3,), torch.float32), ((3,), torch.float32), ((3,), torch.bool),
        ((3,), torch.bool), ((3,), torch.bool)]
    assert "peaks" in _build.SOURCES


def test_wrapper_makes_no_host_sync():
    """No ``int()``, ``float()``, ``bool()``, ``.item()``, ``.tolist()``,
    ``.cpu()`` or ``.numpy()`` in the wrapper: nothing waits for the
    card."""
    tree = ast.parse(inspect.getsource(tpk.peak_candidates_cuda))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", "")
            assert name not in ("int", "float", "bool", "item", "tolist",
                                "cpu", "numpy"), name


def test_locate_device_goes_through_the_dispatcher(monkeypatch):
    """``locate_device`` takes its candidates from ``peak_candidates``
    (on the card, the kernels), with the tile it was given."""
    seen = []

    def spy(sm, lens, tile):
        seen.append((tuple(sm.shape), tile))
        return tpk.peak_candidates(sm, lens, tile)

    monkeypatch.setattr(tloc, "peak_candidates", spy)
    rng = np.random.default_rng(5)
    reads = rng.integers(0, 4, (2, 256)).astype(np.int8)
    lens = np.array([256, 200], np.int32)
    reads[1, 200:] = 4
    splints = rng.integers(0, 4, (2, 30)).astype(np.int8)
    tloc.locate_device(*(torch.from_numpy(a)
                         for a in (reads, lens, splints)), tile=16)
    assert seen == [((2, 256), 16)]


def test_chip_smoke_refuses_an_fma_in_the_peaks_kernels(monkeypatch):
    """``chip_smoke.peaks_sass`` counts the two kernels' instructions and
    fails on an FFMA (read here from a stand-in for ``cuobjdump``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    stats = [(0, "FMUL R1, R2, 6"), (16, "FADD R4, R4, -R1"),
             (32, "MATCH.ANY R5, R6")]
    funcs = {"_ZN12_GLOBAL__N_115pk_stats_kernelEPKf": stats,
             "_ZN12_GLOBAL__N_114pk_cand_kernelEPKf": [(0, "SHFL.BFLY R1")]}
    monkeypatch.setattr(_build, "sass", lambda name: funcs)
    assert smoke.peaks_sass() == {"pk_stats_kernel": 3, "pk_cand_kernel": 1}
    stats.append((48, "FFMA R1, R2, 6, R1"))
    with pytest.raises(smoke.SmokeFailure, match="1 FFMA"):
        smoke.peaks_sass()
