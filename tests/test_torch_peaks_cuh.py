"""The peak-candidates kernel's arithmetic and cluster schedule
(``csrc/peaks.cuh`` under ``tests/peaks_host_driver.cpp``, built with g++
and ``-ffp-contract=off``) held bit for bit, on all seven outputs, to the
plain torch version ``c3poa_tpu_torch.kernels.peaks.peak_candidates_batch``:
the edge rows and share-seam rows of ``torch_peaks_cases``, random and
bench-shaped rows, tiles of 1, 16 and 64 columns (every width on random
rows), clusters of 1, 2, 8 and 16 ranks, the kernel's own and one a
4096-column share (the narrowest), shares that do not divide L.  Five
mutants must fail it: the smallest midpoint on ties, an FMA in the gate,
the carry from the left neighbour rank alone, a merge that drops a rank's
histogram, a skip test that lets a near-height column go unflagged.
Also the skip test's floor, the dispatcher's CPU route, the wrapper's
refusals and its C call, ``locate_device`` through it, and chip_smoke's
copy of the kernel's cluster choice."""

import ast
import ctypes
import inspect
import os
import re
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
from torch_peaks_cases import edge_rows, near, random_rows, share_rows, up

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "c3poa_tpu_torch", "kernels", "csrc")
OUTPUTS = ("cand_pos", "cand_h", "med", "height", "gated", "deep", "margin")
MUTANTS = ("PEAKS_MUTANT_TIES", "PEAKS_MUTANT_FMA", "PEAKS_MUTANT_CARRY",
           "PEAKS_MUTANT_MERGE", "PEAKS_MUTANT_SKIP")
# cluster shapes: the kernel's own for L, R ranks of its share width, or
# shares of 4096 columns (the narrowest: a step of 256 columns a warp)
SHAPES = ("kernel", 1, 2, 8, 16, "4096")


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
    lib.pk_host.argtypes = [P, P, I, I, I, I, I] + [P] * 7
    lib.pk_host.restype = I
    for fn, args in (("pk_kernel_ranks", [I, I, I]),
                     ("pk_kernel_share", [I, I]),
                     ("pk_kernel_max_l", []), ("pk_kernel_smem", [I, I])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = I
    lib.pk_kernel_floor.argtypes = [ctypes.c_float]
    lib.pk_kernel_floor.restype = ctypes.c_float
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _build_driver(tmp_path_factory.mktemp("pk"))


@pytest.fixture(scope="module")
def mutant_libs(tmp_path_factory):
    return {m: _build_driver(tmp_path_factory.mktemp(m.lower()), f"-D{m}")
            for m in MUTANTS}


def _shape(lib, L, shape):
    """(R, S) of a cluster shape for rows of L columns."""
    if shape == "kernel":
        # the launch's own choice for a few reads on an H100 (132 SMs)
        R = lib.pk_kernel_ranks(L, 40, 132)
    elif shape == "4096":
        return -(-L // 4096), 4096
    else:
        R = shape
    return R, lib.pk_kernel_share(L, R)


def _host_rc(lib, sm, lens, tile, shape):
    """The host driver's return code and seven outputs, into buffers of
    garbage: every element must be written."""
    sm = np.ascontiguousarray(sm, np.float32)
    lens = np.ascontiguousarray(lens, np.int32)
    B, L = sm.shape
    M = L // tile
    R, S = _shape(lib, L, shape)
    pos = np.full((B, 2 * M), 0x5A5A5A5A, np.int32)
    h = pos.view(np.float32).copy()
    med, height = (np.full(B, np.nan, np.float32) for _ in range(2))
    gated, deep, margin = (np.full(B, 7, np.uint8) for _ in range(3))
    rc = lib.pk_host(sm.ctypes.data, lens.ctypes.data, B, L, tile, R, S,
                     pos.ctypes.data, h.ctypes.data, med.ctypes.data,
                     height.ctypes.data, gated.ctypes.data,
                     deep.ctypes.data, margin.ctypes.data)
    return rc, (pos, h, med, height, gated, deep, margin)


def _host(lib, sm, lens, tile, shape):
    rc, (pos, h, med, height, gated, deep, margin) = _host_rc(
        lib, sm, lens, tile, shape)
    assert rc == 0
    for flag in (gated, deep, margin):
        assert set(np.unique(flag)) <= {0, 1}
    return pos, h, med, height, gated.astype(bool), deep.astype(bool), \
        margin.astype(bool)


def _rows(lib, L, shape, seed=0):
    """The edge rows and the share-seam rows of the cluster shape."""
    sm, lens = edge_rows(L, seed)
    sm2, lens2 = share_rows(L, _shape(lib, L, shape)[1])
    return np.concatenate([sm, sm2]), np.concatenate([lens, lens2])


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


@pytest.mark.parametrize("chunk", SHAPES)
@pytest.mark.parametrize("tile", [1, 16, 64])
@pytest.mark.parametrize("L", [64, 4160, 16448])
def test_header_matches_plain_on_edge_rows(host_lib, L, tile, chunk):
    """The edge rows and the share-seam rows at every cluster shape
    (``chunk``: the kernel's, 1, 2, 8 and 16 ranks, 4096-column shares;
    at L = 4160 and 16448 the shares do not divide L, and at 16448 a
    plateau spans three 4096-column shares)."""
    sm, lens = _rows(host_lib, L, chunk)
    _assert_same(_host(host_lib, sm, lens, tile, chunk),
                 _plain(sm, lens, tile), f"L={L} tile={tile} shape={chunk}")


@pytest.mark.parametrize("tile", [1, 2, 4, 8, 16, 32, 64])
def test_header_matches_plain_on_random_rows(host_lib, tile):
    """Every tile width, random lengths, 4096-column shares, the kernel's
    cluster, 8 and 16 ranks."""
    rng = np.random.default_rng(tile)
    L = 3072
    sm = random_rows(rng, 8, L)
    lens = np.array([L, L - 1, 1500, 1023, 1025, 2047, 2049, 3], np.int32)
    want = _plain(sm, lens, tile)
    for shape in ("4096", "kernel", 8, 16):
        _assert_same(_host(host_lib, sm, lens, tile, shape), want,
                     f"tile={tile} shape={shape}")


@pytest.mark.parametrize("tile", [1, 16, 64])
def test_header_matches_plain_on_bench_rows(host_lib, bench_profiles, tile):
    sm, lens = _bench_rows(bench_profiles[2])
    want = _plain(sm, lens, tile)
    for shape in ("kernel", 8):
        got = _host(host_lib, sm, lens, tile, shape)
        _assert_same(got, want, f"tile={tile} shape={shape}")
    assert (got[0] >= 0).any(), "bench rows hold candidates"


def test_header_matches_jax_on_bench_rows(host_lib, bench_profiles):
    """Against the JAX package's ``peak_candidates_batch``: every output
    but ``margin`` equal, and ``margin`` a superset (the port's structure
    margin is never narrower, ``STRUCT_REL``)."""
    from c3poa_tpu.kernels import peaks as jpk
    sm, lens = _bench_rows(bench_profiles[2])
    got = _host(host_lib, sm, lens, 64, 8)
    want = [np.asarray(a) for a in jpk.peak_candidates_batch(sm, lens,
                                                             tile=64)]
    assert _mismatch(got[:6], want[:6]) is None
    assert not (want[6] & ~got[6]).any()


@pytest.mark.parametrize("mutant", MUTANTS)
def test_mutants_fail(host_lib, mutant_libs, mutant):
    """Each mutant disagrees with the plain version (or fails a pick) on
    the edge and share-seam rows of a cluster of 4 ranks of 4096 columns
    (none of them empty), and the header does not."""
    sm, lens = _rows(host_lib, 16384, 4)
    want = _plain(sm, lens, 64)
    _assert_same(_host(host_lib, sm, lens, 64, 4), want, "header")
    rc, got = _host_rc(mutant_libs[mutant], sm, lens, 64, 4)
    assert rc != 0 or _mismatch(
        (*got[:4], *(f.astype(bool) for f in got[4:])), want) is not None


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


def test_share_rows_reach_the_seams():
    """The share-seam rows at 8 shares of 512 columns put candidates where
    the cluster's carry and seams decide them: a plateau from share 1 to
    share 3, a run from column 5 to the last share, the last column of a
    share, a tie of heights beside a seam."""
    L, S = 4096, 512
    sm, lens = share_rows(L, S)
    pos, h, *_ = _plain(sm, lens, 16)
    M = L // 16
    assert ((S + S // 2 + 3 * S + S // 2 - 1) // 2 == pos[0]).any()
    assert ((5 + L - 3) // 2 == pos[1]).any()
    assert not (pos[2] >= 0).any(), "a run cut inside the read: no drop"
    assert ((2 * S + 2 * S + 3) // 2 == pos[3]).any()
    assert ((3 * S - 4 + 3 * S - 1) // 2 == pos[4]).any()
    ties = (h[3, :M] == h[3, M:]) & (pos[3, M:] >= 0)
    assert ties.any()


def test_driver_refuses_what_the_kernel_cannot_take(host_lib):
    """Bad tiles and cluster shapes; and the driver's view of the kernel's
    cluster (its limits pinned to the wrapper's constants)."""
    sm, lens = edge_rows(64)
    for tile, R, S in ((3, 1, 4096), (128, 1, 4096), (16, 0, 4096),
                       (64, 1, 2048), (4, 1, 6144), (16, 2, 1)):
        assert host_lib.pk_host(sm.ctypes.data, lens.ctypes.data, 1, 64,
                                tile, R, S, *([None] * 7)) == -1
    assert host_lib.pk_host(sm.ctypes.data, lens.ctypes.data, 1, 16384, 16,
                            3, 4096, *([None] * 7)) == -1
    # the kernel's: B * R <= the SMs, R a power of two up to 8, shares of
    # at most 32768 columns, no rank past the row's end
    assert [host_lib.pk_kernel_ranks(L, B, 132) for L, B in (
        (64, 1), (32768, 1), (32768, 16), (32768, 17), (32768, 64),
        (32768, 128), (32768, 512), (131072, 128), (131072, 16),
        (35008, 512), (262144, 1))] == [1, 8, 8, 4, 2, 1, 1, 4, 8, 2, 8]
    assert host_lib.pk_kernel_share(35008, 8) == 8192
    assert host_lib.pk_kernel_share(4160, 16) == 4096
    assert host_lib.pk_kernel_share(4160, 1) == 8192
    assert host_lib.pk_kernel_max_l() == tpk.MAX_L
    with open(os.path.join(CSRC, "peaks.cuh")) as f:
        text = f.read()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (PK_\w+) = (\d+);", text)}
    # the largest portable cluster
    assert consts["PK_MAX_RANKS"] == 8
    assert tpk.MAX_L == consts["PK_MAX_RANKS"] * consts["PK_MAX_SHARE"]
    # the widest share's CTA of the largest cluster fits the card's 227 KB
    # of shared memory
    assert host_lib.pk_kernel_smem(consts["PK_MAX_SHARE"],
                                   consts["PK_MAX_RANKS"]) <= 232448 - 1024


def test_skip_floor_is_below_every_flagged_column(host_lib):
    """The skip test's floor (``pk_matter_floor``) over heights from 1e-38
    to 1e30, both signs: the float32 just below it is never near the
    height (nor at or above it), so a skipped column sets no flag; and the
    SKIP mutant's floor, the height itself, would skip a near column."""
    rng = np.random.default_rng(3)
    mags = np.float32(10.0) ** rng.uniform(-38, 30, 4000).astype(np.float32)
    heights = np.concatenate([mags, -mags, [np.float32(0)],
                              np.float32([30, 1e-30, 1e-31])])
    for hgt in heights.astype(np.float32):
        cut = np.float32(host_lib.pk_kernel_floor(float(hgt)))
        assert cut <= hgt
        below = up(cut, -1)
        assert not (below > 0 and near(below, hgt)), (hgt, cut)
    assert near(up(np.float32(30), -1), np.float32(30))


def test_dispatcher_takes_the_plain_version_on_the_cpu():
    sm, lens = edge_rows(256)
    args = (torch.from_numpy(sm), torch.from_numpy(lens))
    for tile in (1, 64):
        got = tpk.peak_candidates(*args, tile=tile)
        for name, a, b in zip(OUTPUTS, got,
                              tpk.peak_candidates_batch(*args, tile=tile)):
            assert torch.equal(a, b), name


def test_wrappers_refuse_what_they_cannot_take(monkeypatch):
    sm = torch.zeros((2, 64), dtype=torch.float32)
    lens = torch.full((2,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tpk.peak_candidates_cuda(sm, lens, 64)
    for tile in (3, 0, 128, 16.0):
        with pytest.raises(ValueError, match="power of two"):
            tpk.peak_candidates_cuda(sm, lens, tile)
    with pytest.raises(ValueError, match="unsupported device"):
        tpk.peak_candidates(sm.to("meta"), lens.to("meta"))
    # past the device checks (shapes only, on the meta device): the
    # kernel's row limit
    monkeypatch.setattr(_build, "require", lambda *a, **k: None)
    big = torch.zeros((1, tpk.MAX_L + 64), device="meta")
    one = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=f"limit of {tpk.MAX_L} columns"):
        tpk.peak_candidates_cuda(big, one, 64)


def test_wrapper_passes_the_c_signature(monkeypatch):
    """The wrapper's launch passes the C entry point's pointers and ints
    in order (the stream is ``_build.launch``'s), each output a view of
    one allocation at its shape and type."""
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
    assert all(t.is_contiguous() for t in out)
    base = {t.untyped_storage().data_ptr() for t in out}
    assert len(base) == 1, "one allocation"
    # the tol scratch lies in it too, apart from the outputs
    spans = sorted((t.data_ptr(), t.data_ptr() + t.nbytes)
                   for t in out) + [(ptrs[9], ptrs[9] + 12)]
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert "peaks" in _build.SOURCES
    assert list(_build.SIGNATURES["peaks"]) == ["c3t_peak_candidates"]


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_cluster_matches_the_header(host_lib):
    """``chip_smoke.peaks_cluster`` (the cluster it prints, and the card
    tests build their share-seam rows for) equals the header's choice:
    ranks (``pk_default_ranks``), share (``pk_share_width``) and shared
    memory a CTA (``pk_smem_bytes``), over batch sizes, row widths and SM
    counts; and its constants are the header's."""
    smoke = _chip_smoke()
    for sms in (132, 114, 16, 1):
        for B in (1, 8, 16, 17, 33, 40, 66, 67, 128, 512):
            for L in (64, 4160, 8192, 32768, 35008, 65600, 131072,
                      tpk.MAX_L):
                R = host_lib.pk_kernel_ranks(L, B, sms)
                S = host_lib.pk_kernel_share(L, R)
                assert smoke.peaks_cluster(B, L, sms) == dict(
                    ranks=R, share=S,
                    smem_bytes=host_lib.pk_kernel_smem(S, R)), (sms, B, L)
    with open(os.path.join(CSRC, "peaks.cuh")) as f:
        consts = dict(re.findall(r"constexpr int (PK_\w+) = (\d+);",
                                 f.read()))
    assert (smoke.PK_MAX_RANKS, smoke.PK_MAX_SHARE) == (
        int(consts["PK_MAX_RANKS"]), int(consts["PK_MAX_SHARE"]))
    assert smoke.PK_SHARE_ALIGN == host_lib.pk_kernel_share(1, 1)


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
    """``chip_smoke.peaks_sass`` counts the kernel's instructions and
    fails on an FFMA (read here from a stand-in for ``cuobjdump``)."""
    smoke = _chip_smoke()
    insns = [(0, "FMUL R1, R2, 6"), (16, "FADD R4, R4, -R1"),
             (32, "ATOMS.ADD RZ, [R5], R6")]
    funcs = {"_ZN12_GLOBAL__N_19pk_kernelEPKfPKiPiPfS4_S4_PhS5_S5_S4_iii":
             insns}
    monkeypatch.setattr(_build, "sass", lambda name: funcs)
    assert smoke.peaks_sass() == {"pk_kernel": 3}
    insns.append((48, "FFMA R1, R2, 6, R1"))
    with pytest.raises(smoke.SmokeFailure, match="1 FFMA"):
        smoke.peaks_sass()


def test_peaks_kernel_is_one_cluster_launch():
    """``csrc/peaks.cu`` holds one kernel, launched once through
    ``cudaLaunchKernelEx`` with a cluster dimension (no ``<<<>>>``), with
    every ``__shared__`` byte in the dynamic allocation (so the opt-in
    above 48 KB is exact); no walk left in global memory."""
    with open(os.path.join(CSRC, "peaks.cu")) as f:
        cu = f.read()
    with open(os.path.join(CSRC, "peaks.cuh")) as f:
        cuh = f.read()
    assert len(re.findall(r"__global__", cu)) == 1
    assert "<<<" not in cu
    assert len(re.findall(r"cudaLaunchKernelEx\(", cu)) == 1
    assert "cudaLaunchAttributeClusterDimension" in cu
    assert [ln.strip() for ln in cu.splitlines() if "__shared__" in ln
            and not ln.strip().startswith("//")] == \
        ["extern __shared__ uint4 smem4[];"]
    for text in (cu, cuh):
        assert "PkWalk" not in text and "pk_cand_kernel" not in text
