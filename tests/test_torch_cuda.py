"""The port's CUDA kernels against their plain torch versions, on the
card, at shapes and edge cases the consensus and postprocess runs rarely
reach: every band width the forward kernel is built for, both scorings,
dummy and empty pairs, band shifts beyond SMAX, long splints, tile seams,
the adapter hits' ties, dimers, N codes, short and empty reads, combos
longer than one pass and a read of the widest payload, the host routes
for long targets and long splints, the two probe kernels at the int16 extremes, every mode at the smallest and
largest M they are built for, and int32 overflow, the smoothing
kernel bit for bit at every edge length of a read and its tiles, and the
peak-candidates kernel bit for bit on all seven outputs at every tile
width the locate step takes, on the edge rows and share-seam rows of
``torch_peaks_cases``, at one read and 128, under every cluster size.

Needs a CUDA card and nvcc; skips without them.  This file imports no
jax, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import shutil

import numpy as np
import pytest
import torch

from c3poa_tpu_torch import sim
from c3poa_tpu_torch.pipeline.backend import Combo, NumpyBackend
from c3poa_tpu_torch.utils import encode, revcomp_encoded
from torch_adapter_cases import (ADAPTER_SETS, adapter_matrix, batch, combos,
                                 edge_reads)
from torch_banded_cases import ragged_pairs
from torch_peaks_cases import edge_rows, random_rows, share_rows

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not \
            __import__("os").path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc")
    from c3poa_tpu_torch.device import resolve_device
    return resolve_device("cuda")


def _same(a, b, what):
    assert a.shape == b.shape, what
    assert torch.equal(a.cpu(), b.cpu()), what


def _max_fit_m():
    from c3poa_tpu_torch.kernels.sw_profile import profile_fits
    m = 1
    while profile_fits(m + 1):
        m += 1
    return m


@pytest.mark.parametrize("B,L,splint_len,seed,width,ends", [
    (3, 64, 20, 0, None, None),        # one tile, tiny splint
    (5, 12288, 224, 1, None, None),    # tile seams
    (4, 8192 + 64, 480, 2, None, None),  # long splint: wide overlap
    (2, 4096, 200, 3, None, None),
    (3, 64, 1, 4, 1, None),            # one splint row
    (4, 8192, 33, 5, 33, "seams"),     # a warp and one row
    (2, 1024, "max", 6, "max", None),  # the widest splint: 256 new
                                       # columns a tile, > 48 KB of slots
    (8, 7504, 200, 7, None, "seams"),  # reads ending at core - 1, core,
                                       # core + 1 and length 0
    (200, 8192, 200, 8, None, None),   # 1200 blocks: several waves
    (2, 8192, 1200, 9, None, None),    # m = 1216: just past 48 KB of
                                       # shared memory with the kernel's
                                       # word a thread
])
def test_profile_kernel_matches_plain(dev, B, L, splint_len, seed, width,
                                      ends):
    from c3poa_tpu_torch.kernels.sw_profile import (start_profile_batch,
                                                    start_profile_cuda,
                                                    tile_overlap, TILE_WIDTH)
    from c3poa_tpu_torch.state import splint_array
    rng = np.random.default_rng(seed)
    if splint_len == "max":
        splint_len = width = _max_fit_m()
    codes = encode(sim.random_seq(rng, splint_len))
    S = splint_array([Combo("s", "+", codes, len(codes)),
                      Combo("s", "-", revcomp_encoded(codes), len(codes))])
    if width is not None:      # the splint's own width, not a multiple of 32
        S = np.ascontiguousarray(S[:, :width])
    R = np.full((B, L), 4, np.int8)
    lens = np.zeros(B, np.int32)
    core = TILE_WIDTH - tile_overlap(S.shape[1])
    for b in range(B):
        n = int(rng.integers(0, L + 1)) if b else L
        if ends == "seams":
            n = min(L, [L, 0, core - 1, core, core + 1, 2 * core - 1,
                        2 * core, 2 * core + 1][b % 8])
        R[b, :n] = rng.integers(0, 4, n)
        R[b, :n][rng.random(n) < 0.01] = 4       # N inside the reads
        lens[b] = n
    if L > core + splint_len:   # an occurrence across the first seam
        a = core - splint_len // 2
        R[0, a:a + splint_len] = codes
    Rd, Sd, ld = (torch.from_numpy(x).to(dev) for x in (R, S, lens))
    got = start_profile_cuda(Rd, Sd, ld)
    _same(got, start_profile_batch(Rd, Sd), "profile")


def _pairs(rng, P, W, shapes):
    """shapes: list of (ql, tl) or "dummy"."""
    nq = max((s[0] for s in shapes if s != "dummy"), default=1)
    nt = max((s[1] for s in shapes if s != "dummy"), default=1)
    Q = np.full((P, nq), 4, np.int8)
    T = np.full((P, nt), 4, np.int8)
    ql = np.ones(P, np.int32)
    tl = np.ones(P, np.int32)
    for p, s in enumerate(shapes):
        if s == "dummy":
            continue
        a, b = s
        t = sim.random_seq(rng, b)
        q = (sim.mutate(rng, t, 0.05, 0.03, 0.03) + "A" * a)[:a]
        Q[p, :a] = encode(q)
        T[p, :b] = encode(t)
        ql[p], tl[p] = a, b
    return Q, T, ql, tl


@pytest.mark.parametrize("W", [32, 64, 128, 256])
@pytest.mark.parametrize("scoring", [(5, -4, 4, 2), (20, -7, 10, 5)])
def test_banded_kernels_match_plain(dev, W, scoring):
    from c3poa_tpu_torch.kernels import banded as tb
    rng = np.random.default_rng(W)
    shapes = [(700, 650), (650, 700), (300, 601), "dummy", (1, 1),
              (50, 300),       # shifts beyond SMAX (the generic path)
              (0, 40), (9, 3), (500, 500)]
    Q, T, ql, tl = _pairs(rng, len(shapes), W, shapes)
    args = [torch.from_numpy(x).to(dev) for x in (Q, T, ql, tl)]
    mt, mm, go, ge = scoring
    kw = dict(band=W, match=mt, mismatch=mm, gap_open=go, gap_ext=ge)
    got = tb.banded_fwd_cuda(*args, **kw)
    want = tb.banded_align_batch(*args, **kw)
    for name, a, b in zip(("score", "j_end", "moves"), got, want):
        _same(a, b, name)
    nq = Q.shape[1]
    wk = tb.banded_walk_cuda(want[2], args[2], args[3], want[1], nq, W)
    wp = tb.banded_walk_batch(want[2], args[2], args[3], want[1], nq, W)
    for name, a, b in zip(("j_start", "i_rem", "ops", "edge"), wk, wp):
        _same(a, b, name)


def _dirty_allocator(dev, nbytes):
    """Leave garbage in the blocks the next torch.empty calls reuse."""
    junk = [torch.full((max(n, 1),), 0x5a5a5a5a, dtype=torch.int32,
                       device=dev) for n in (nbytes // 4, 4096, 64, 64, 64)]
    torch.cuda.synchronize()
    del junk


@pytest.mark.parametrize("W", [32, 64, 128, 256])
@pytest.mark.parametrize("scoring", [(5, -4, 4, 2), (20, -7, 10, 5)])
def test_banded_kernels_ragged_pairs(dev, W, scoring):
    """The CPU tests' ragged pairs on the card: 15 pairs (no multiple of
    the warps in a block), a query width that is no multiple of 8, and
    output buffers that held garbage before the launch (rows past each
    query and ops past each path must come back zero)."""
    from c3poa_tpu_torch.kernels import banded as tb
    Q, T, ql, tl, names = ragged_pairs(W, seed=W)
    assert len(names) % 4 and Q.shape[1] % 8
    args = [torch.from_numpy(x).to(dev) for x in (Q, T, ql, tl)]
    mt, mm, go, ge = scoring
    kw = dict(band=W, match=mt, mismatch=mm, gap_open=go, gap_ext=ge)
    want = tb.banded_align_batch(*args, **kw)
    nq = Q.shape[1]
    wp = tb.banded_walk_batch(want[2], args[2], args[3], want[1], nq, W)
    _dirty_allocator(dev, want[2].numel() * 4)
    got = tb.banded_fwd_cuda(*args, **kw)
    for name, a, b in zip(("score", "j_end", "moves"), got, want):
        _same(a, b, name)
    _dirty_allocator(dev, wp[2].numel())
    wk = tb.banded_walk_cuda(got[2], args[2], args[3], got[1], nq, W)
    for name, a, b in zip(("j_start", "i_rem", "ops", "edge"), wk, wp):
        _same(a, b, name)
    assert bool((wp[1] > 0).any()) and bool((wp[1] == 0).any())


@pytest.mark.parametrize("P,nq", [(1, 40), (5, 33), (131, 64), (7, 8)])
def test_banded_kernels_odd_batches(dev, P, nq):
    """P below, at no multiple of and above a block's warps; nq no
    multiple of 32."""
    from c3poa_tpu_torch.kernels import banded as tb
    rng = np.random.default_rng(P)
    shapes = [(int(rng.integers(0, nq + 1)), int(rng.integers(0, 2 * nq)))
              for _ in range(P)]
    shapes[0] = (nq, 2 * nq - 1)
    Q, T, ql, tl = _pairs(rng, P, 64, shapes)
    args = [torch.from_numpy(x).to(dev) for x in (Q, T, ql, tl)]
    want = tb.banded_align_batch(*args, band=64)
    _dirty_allocator(dev, want[2].numel() * 4)
    got = tb.banded_fwd_cuda(*args, band=64)
    for name, a, b in zip(("score", "j_end", "moves"), got, want):
        _same(a, b, name)
    nq_ = Q.shape[1]
    wk = tb.banded_walk_cuda(got[2], args[2], args[3], got[1], nq_, 64)
    wp = tb.banded_walk_batch(want[2], args[2], args[3], want[1], nq_, 64)
    for name, a, b in zip(("j_start", "i_rem", "ops", "edge"), wk, wp):
        _same(a, b, name)


def test_kernel_wrappers_reject_what_they_cannot_take(dev):
    from c3poa_tpu_torch.kernels import banded as tb
    from c3poa_tpu_torch.kernels.sw_profile import start_profile_cuda
    Q = torch.full((2, 64), 4, dtype=torch.int8, device=dev)
    lens = torch.full((2,), 64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="band"):
        tb.banded_fwd_cuda(Q, Q, lens, lens, band=96)
    with pytest.raises(ValueError, match="signed byte"):
        tb.banded_fwd_cuda(Q, Q, lens, lens, band=64, match=200)
    mv = torch.zeros((2, 8, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="do not match"):
        tb.banded_walk_cuda(mv, lens, lens, lens, 64, 128)
    with pytest.raises(ValueError, match="disagree on P"):
        tb.banded_walk_cuda(mv, lens[:1], lens, lens, 64, 64)
    S = torch.full((1, 32), 4, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        start_profile_cuda(Q[:, :40].contiguous(), S, lens)
    with pytest.raises(ValueError, match="int8"):
        start_profile_cuda(Q.to(torch.int32), S, lens)
    with pytest.raises(ValueError, match="target width"):
        T = torch.full((2, tb.FWD_MAX_TARGET + 1), 4, dtype=torch.int8,
                       device=dev)
        tb.banded_fwd_cuda(Q, T, lens, lens, band=64)
    from c3poa_tpu_torch.kernels.adapters import adapter_hits_cuda
    alens = torch.full((1,), 32, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="signed byte"):
        adapter_hits_cuda(Q, lens, S, alens, 200, -3, 3)
    with pytest.raises(ValueError, match="exceed 8191"):
        wide = torch.full((1, 128), 4, dtype=torch.int8, device=dev)
        adapter_hits_cuda(Q, lens, wide, alens, 127, -3, 3)
    with pytest.raises(ValueError, match="exceed"):
        adapter_hits_cuda(Q, lens, S, alens + 1, 1, -3, 3)


def test_backend_on_card_matches_cpu(dev):
    from c3poa_tpu_torch.consensus.engine import ConsensusParams
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
    reads, splints = sim.make_dataset(n_reads=6, seed=5,
                                      insert_len=(500, 900), copies=(3, 6))
    codes = encode(next(iter(splints.values())))
    combos = [Combo("s", "+", codes, len(codes)),
              Combo("s", "-", revcomp_encoded(codes), len(codes))]
    enc = [encode(r.seq) for r in reads]
    gpu, cpu = TorchBackend(dev), TorchBackend("cpu")
    _build.reset_counts()
    a = gpu.locate_many(enc, combos, 500)
    assert _build.launch_counts().get("start_profile_cuda", 0) >= 1
    b = cpu.locate_many(enc, combos, 500)
    for x, y in zip(a, b):
        assert (x.combo, x.score) == (y.combo, y.score)
        np.testing.assert_array_equal(x.peaks, y.peaks)
    rng = np.random.default_rng(6)
    pairs = []
    for _ in range(5):
        t = sim.random_seq(rng, int(rng.integers(400, 800)))
        q = sim.mutate(rng, t, 0.05, 0.03, 0.03)
        pairs.append((encode(q), np.full(len(q), 20, np.int8), encode(t)))
    p = ConsensusParams()
    ra = [tuple(np.array(f) for f in x.rec) for x in gpu.align_many(pairs, p)]
    counts = _build.launch_counts()
    assert counts["banded_fwd_cuda"] >= 1 and counts["banded_walk_cuda"] >= 1
    rb = [tuple(np.array(f) for f in x.rec) for x in cpu.align_many(pairs, p)]
    for x, y in zip(ra, rb):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def _adapter_args(dev, reads, codes, extra=0, rows=0):
    R, lens = batch(reads, 64, extra)
    A, alens = adapter_matrix(codes, rows)
    return [torch.from_numpy(x).to(dev) for x in (R, lens, A, alens)]


@pytest.mark.parametrize("adapters", sorted(ADAPTER_SETS))
@pytest.mark.parametrize("extra,rows", [(0, 0), (1100, 64)])
def test_adapter_kernel_matches_plain(dev, adapters, extra, rows):
    """Edge-case reads, also with padding columns past a tile (1024) and
    padding adapter rows; the spec's outputs on the host."""
    from c3poa_tpu_torch.kernels import adapters as ka
    reads = edge_reads(seed=len(adapters))
    codes = combos(ADAPTER_SETS[adapters])
    args = _adapter_args(dev, reads, codes, extra, rows)
    sc = NumpyBackend.ADAPTER_SCORING
    got = ka.adapter_hits_cuda(*args, *sc)
    want = ka.adapter_hits_batch(*args, *sc)
    spec = NumpyBackend().adapter_hits(reads, codes, [len(c) for c in codes])
    for name, a, b, c in zip("s1 j1 qe1 ts1 qs1 s2".split(), got, want,
                             spec):
        _same(a, b, name)
        np.testing.assert_array_equal(a.cpu().numpy(), c, err_msg=name)


@pytest.mark.parametrize("L,seed", [(0, 0), (1024, 1), (5000, 2),
                                    (131072, 3)])
def test_adapter_kernel_long_and_empty_reads(dev, L, seed):
    """Hits planted across 1024-column seams, a read at the backend's
    length limit, and an empty read beside them: a read over 4095 columns
    takes the general path while the short ones beside it take the packed
    path."""
    from c3poa_tpu_torch.kernels import adapters as ka
    rng = np.random.default_rng(seed)
    codes = combos(ADAPTER_SETS["default"])
    seq = list(sim.random_seq(rng, L))
    a5 = sim.DEFAULT_ADAPTERS["5Prime_adapter"]
    for at in (1000, 2040, 4990, L - len(a5)):
        if 0 <= at <= L - len(a5):
            seq[at:at + len(a5)] = a5
    reads = [encode("".join(seq)), encode(""), encode(a5)]
    args = _adapter_args(dev, reads, codes)
    sc = NumpyBackend.ADAPTER_SCORING
    got = ka.adapter_hits_cuda(*args, *sc)
    want = ka.adapter_hits_batch(*args, *sc)
    for name, a, b in zip("s1 j1 qe1 ts1 qs1 s2".split(), got, want):
        _same(a, b, name)


@pytest.mark.parametrize("rows", [65, 150])
def test_adapter_kernel_combo_longer_than_one_pass(dev, rows):
    """Combos of 65 and 150 rows (two and three passes of the warp's 64
    rows, the carry row between them) beside the 25- and 56-row ones,
    planted whole, cut and twice."""
    from c3poa_tpu_torch.kernels import adapters as ka
    rng = np.random.default_rng(rows)
    long = sim.random_seq(rng, rows)
    codes = combos(ADAPTER_SETS["default"]) + [encode(long),
                                               revcomp_encoded(encode(long))]
    rs = lambda n: sim.random_seq(rng, n)                      # noqa: E731
    reads = [encode(x) for x in (rs(40) + long + rs(300), long + long,
                                 long[:50] + rs(9) + long[40:], rs(900), "")]
    reads += edge_reads(seed=rows)
    args = _adapter_args(dev, reads, codes)
    sc = NumpyBackend.ADAPTER_SCORING
    got = ka.adapter_hits_cuda(*args, *sc)
    want = ka.adapter_hits_batch(*args, *sc)
    for name, a, b in zip("s1 j1 qe1 ts1 qs1 s2".split(), got, want):
        _same(a, b, name)
    assert int(want[0][0, 4]) == rows


def test_adapter_kernel_one_read_at_max_columns(dev):
    """B = 1, a read of MAX_COLUMNS bases (the payload's 18 bits full)
    with adapters planted near both ends."""
    from c3poa_tpu_torch.kernels import adapters as ka
    rng = np.random.default_rng(11)
    L = ka.MAX_COLUMNS
    seq = list(sim.random_seq(rng, L))
    a5 = sim.DEFAULT_ADAPTERS["5Prime_adapter"]
    for at in (3, L - len(a5) - 1):
        seq[at:at + len(a5)] = a5
    R = torch.from_numpy(np.array([encode("".join(seq))], dtype=np.int8))
    A, alens = adapter_matrix(combos(ADAPTER_SETS["default"]))
    args = [x.to(dev) for x in (R, torch.tensor([L], dtype=torch.int32),
                                torch.from_numpy(A), torch.from_numpy(alens))]
    sc = NumpyBackend.ADAPTER_SCORING
    got = ka.adapter_hits_cuda(*args, *sc)
    want = ka.adapter_hits_batch(*args, *sc)
    for name, a, b in zip("s1 j1 qe1 ts1 qs1 s2".split(), got, want):
        _same(a, b, name)
    assert int(want[0][0, 2]) == len(a5) and int(want[3][0, 2]) == 3


def test_backend_long_target_and_long_splint_on_card(dev):
    """A pair whose target is one base over the forward kernel's staging
    limit goes to the host aligner beside a pair the kernel takes; a
    splint too long for the profile kernel's tiles is located on the
    host; both equal the numpy backend."""
    from c3poa_tpu_torch.consensus.engine import ConsensusParams
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.kernels.banded import FWD_MAX_TARGET
    from c3poa_tpu_torch.kernels.sw_profile import profile_fits
    from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
    from c3poa_tpu_torch.utils import prof
    rng = np.random.default_rng(12)
    pairs = []
    for n in (FWD_MAX_TARGET + 1, 700):
        t = sim.random_seq(rng, n)
        q = sim.mutate(rng, t, 0.02, 0.01, 0.01)
        pairs.append((encode(q), np.full(len(q), 20, np.int8), encode(t)))
    p = ConsensusParams()
    prof.reset()
    _build.reset_counts()
    got = [tuple(np.array(f) for f in x.rec)
           for x in TorchBackend(dev).align_many(pairs, p)]
    assert prof.current.counts["align_overlong_host"] == 1
    assert _build.launch_counts()["banded_fwd_cuda"] == 1
    want = [tuple(np.array(f) for f in x.rec)
            for x in NumpyBackend().align_many(pairs, p)]
    for x, y in zip(got, want):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)

    splint = sim.random_seq(rng, 2600)
    assert not profile_fits(-(-len(splint) // 32) * 32)
    codes = encode(splint)
    cmb = [Combo("s", "+", codes, len(codes)),
           Combo("s", "-", revcomp_encoded(codes), len(codes))]
    reads = [encode(sim.random_seq(rng, 400) + splint[:1500] +
                    sim.random_seq(rng, 9000) + splint + sim.random_seq(
                        rng, 9000)), encode(sim.random_seq(rng, 5000))]
    prof.reset()
    a = TorchBackend(dev).locate_many(reads, cmb, 500)
    assert prof.current.counts["long_splint_host_located"] == 2
    for x, y in zip(a, NumpyBackend().locate_many(reads, cmb, 500)):
        assert (x.combo, x.score) == (y.combo, y.score)
        np.testing.assert_array_equal(x.peaks, y.peaks)


def test_adapter_backend_on_card_matches_numpy(dev):
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
    reads = edge_reads(seed=9, n_random=40)
    codes = combos(ADAPTER_SETS["default"])
    lens = [len(c) for c in codes]
    _build.reset_counts()
    got = TorchBackend(dev).adapter_hits(reads, codes, lens)
    assert _build.launch_counts().get("adapter_hits_cuda", 0) >= 1
    want = NumpyBackend().adapter_hits(reads, codes, lens)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _int16_pair(rng, B):
    """(B, 128) int16 inputs over the whole range, with both extremes
    and 32767 where the max must wrap to -32768 after the + 1."""
    x = rng.integers(-2 ** 15, 2 ** 15, (B, 128)).astype(np.int16)
    y = rng.integers(-2 ** 15, 2 ** 15, (B, 128)).astype(np.int16)
    x[:, 2::11] = -32768
    y[:, 2::11] = -32768
    y[:, 1::7] = -32768
    x[:, ::5] = 32767
    return x, y


@pytest.mark.parametrize("B", [1, 16, 4096])
def test_int16_probe_kernel_matches_plain(dev, B):
    from c3poa_tpu_torch.kernels import probes
    x, y = _int16_pair(np.random.default_rng(B), B)
    xd, yd = (torch.from_numpy(a).to(dev) for a in (x, y))
    got = probes.int16_probe_cuda(xd, yd)
    want = probes.int16_probe_plain(xd, yd)
    _same(got, want, "int16 probe")
    assert (got.cpu().numpy()[:, 3::5] == -32768).all()   # 32767 + 1 wraps


@pytest.mark.parametrize("mode", ["chain", "indep2", "indep4"])
@pytest.mark.parametrize("M", [8, 128])
@pytest.mark.parametrize("S", [8, 256])
def test_floor_probe_kernel_matches_plain(dev, mode, M, S):
    from c3poa_tpu_torch.kernels import probes
    rng = np.random.default_rng(S + M)
    x = torch.from_numpy(rng.integers(1, 7, (S, 128)).astype(np.int32))
    xd = x.to(dev)
    _same(probes.floor_probe_cuda(xd, M, 5, mode),
          probes.floor_probe_plain(xd, M, 5, mode), "floor probe")


@pytest.mark.parametrize("mode", ["chain", "indep4"])
def test_floor_probe_kernel_wraps_as_int32(dev, mode):
    """Values near 2**30: the adds overflow and wrap in both versions."""
    from c3poa_tpu_torch.kernels import probes
    rng = np.random.default_rng(7)
    x = rng.integers(2 ** 29, 2 ** 30, (24, 128)).astype(np.int32)
    xd = torch.from_numpy(x).to(dev)
    _same(probes.floor_probe_cuda(xd, 16, 3, mode),
          probes.floor_probe_plain(xd, 16, 3, mode), "floor probe wrap")


def test_probe_wrappers_reject_what_they_cannot_take(dev):
    from c3poa_tpu_torch.kernels import probes
    x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=r"\(8, 16, 32, 64, 128\)"):
        probes.floor_probe_cuda(x, 24, 2, "chain")
    with pytest.raises(ValueError, match="multiple of 8"):
        probes.floor_probe_cuda(x, 12, 2, "indep4")
    with pytest.raises(ValueError, match="multiple of 8"):
        probes.floor_probe_cuda(x[:4].contiguous(), 8, 2, "chain")
    h = torch.zeros((4, 64), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError, match="128"):
        probes.int16_probe_cuda(h, h)
    with pytest.raises(ValueError, match="CUDA"):
        probes.int16_probe_cuda(h.cpu(), h.cpu())


# the smoothing kernel's tile width (csrc/smooth.cuh: SM_TILE)
SMOOTH_TILE = 944


def _smooth_case(rng, lens, C, L):
    """Profile-like int32 rows (small scores, runs of zeros, some rows of
    large values) and a random combo a read."""
    prof = rng.integers(0, 230, (len(lens), C, L)).astype(np.int32)
    prof[:, :, L // 3:L // 3 + 150] = 0
    prof[::4] = rng.integers(-(1 << 20), 1 << 20, prof[::4].shape)
    combo = rng.integers(0, C, len(lens)).astype(np.int32)
    return prof, combo, np.asarray(lens, np.int32)


def _smooth_plain_cpu(prof, combo, lens):
    from c3poa_tpu_torch.kernels.smooth import combo_rows, smooth3_batch
    p, c, n = (torch.from_numpy(a) for a in (prof, combo, lens))
    return smooth3_batch(combo_rows(p, c).to(torch.float32), n)


@pytest.mark.parametrize("L", [64, 2 * SMOOTH_TILE + 64, 4099, 32768])
def test_smooth_kernel_matches_plain_bitwise(dev, L):
    """Every edge length of a read and of the kernel's tiles (n = 0, 1,
    2, 5, 20-22, 41-43, 63-65, T - 1 .. T + 1, L - 1, L, those <= L), a
    width that is no multiple of 4 (scalar stores) and the locate
    shape's: bit for bit (-0 against +0 counts) the CPU plain version."""
    from c3poa_tpu_torch.kernels.smooth import smooth3_cuda
    T = SMOOTH_TILE
    lens = [n for n in (0, 1, 2, 5, 20, 21, 22, 41, 42, 43, 63, 64, 65,
                        T - 1, T, T + 1, L - 1, L) if n <= L]
    prof, combo, lens = _smooth_case(np.random.default_rng(L), lens, 2, L)
    got = smooth3_cuda(*(torch.from_numpy(a).to(dev)
                         for a in (prof, combo, lens)))
    want = _smooth_plain_cpu(prof, combo, lens)
    _same(got.view(torch.int32), want.view(torch.int32), f"smooth L={L}")


@pytest.mark.parametrize("L", [21, 944, 32768])
def test_smooth_kernel_one_read_of_full_length(dev, L):
    """B = 1 and n = L, three combos, the chosen one last."""
    from c3poa_tpu_torch.kernels.smooth import smooth3_cuda
    rng = np.random.default_rng(L + 1)
    prof, _combo, lens = _smooth_case(rng, [L], 3, L)
    combo = np.array([2], np.int32)
    got = smooth3_cuda(*(torch.from_numpy(a).to(dev)
                         for a in (prof, combo, lens)))
    _same(got.view(torch.int32),
          _smooth_plain_cpu(prof, combo, lens).view(torch.int32),
          f"one read L={L}")


def test_locate_device_on_card_launches_smooth_kernel(dev):
    """``locate_device`` on the card goes through the smoothing kernel
    once a batch, and its outputs equal the CPU route's."""
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.kernels.locate import locate_device
    from c3poa_tpu_torch.state import splint_array
    reads, splints = sim.make_dataset(n_reads=5, seed=8,
                                      insert_len=(500, 900), copies=(3, 6))
    codes = encode(next(iter(splints.values())))
    S = splint_array([Combo("s", "+", codes, len(codes)),
                      Combo("s", "-", revcomp_encoded(codes), len(codes))])
    enc = [encode(r.seq) for r in reads]
    L = -(-max(len(c) for c in enc) // 64) * 64
    R = np.full((len(enc), L), 4, np.int8)
    lens = np.array([len(c) for c in enc], np.int32)
    for b, c in enumerate(enc):
        R[b, :len(c)] = c
    args = [torch.from_numpy(a) for a in (R, lens, S)]
    _build.reset_counts()
    got = locate_device(*(a.to(dev) for a in args), tile=64)
    assert _build.launch_counts().get("smooth3_cuda", 0) == 1
    for name, a, b in zip(("combo", "score", "cand_pos", "cand_h", "med",
                           "deep", "margin"), got,
                          locate_device(*args, tile=64)):
        _same(a, b, name)


def test_smooth_wrapper_rejects_what_it_cannot_take(dev):
    from c3poa_tpu_torch.kernels.smooth import smooth3, smooth3_cuda
    prof = torch.zeros((2, 2, 64), dtype=torch.int32, device=dev)
    combo = torch.zeros(2, dtype=torch.int32, device=dev)
    lens = torch.full((2,), 64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        smooth3_cuda(prof.float(), combo, lens)
    with pytest.raises(ValueError, match="int32"):
        smooth3(prof, combo.long(), lens)
    with pytest.raises(ValueError, match="disagree"):
        smooth3_cuda(prof, combo[:1], lens)
    with pytest.raises(ValueError, match="L > 20"):
        smooth3_cuda(prof[:, :, :20].contiguous(), combo, lens)
    with pytest.raises(ValueError, match="CUDA"):
        smooth3_cuda(prof.cpu(), combo.cpu(), lens.cpu())


PEAK_OUTPUTS = ("cand_pos", "cand_h", "med", "height", "gated", "deep",
                "margin")


def _peaks_same_bits(got, want, what):
    for name, a, b in zip(PEAK_OUTPUTS, got, want):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        _same(a, b, f"{what}: {name}")


def _peaks_plain_cpu(sm, lens, tile):
    from c3poa_tpu_torch.kernels.peaks import peak_candidates_batch
    return peak_candidates_batch(torch.from_numpy(sm),
                                 torch.from_numpy(lens), tile=tile)


def _peaks_cluster(dev, B, L):
    """The cluster the kernel launches for B reads of L columns on this
    card (``chip_smoke.peaks_cluster``, pinned to csrc/peaks.cuh by a CPU
    test): ranks, share, shared memory a CTA."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return smoke.peaks_cluster(B, L, sms)


def _peaks_rows(dev, L, seed):
    """The edge rows and the share-seam rows of the kernel's shares for
    them (the edge rows and seam rows are 46 reads)."""
    sm, lens = edge_rows(L, seed=seed)
    sm2, lens2 = share_rows(L, _peaks_cluster(dev, len(sm) + 8, L)["share"])
    return np.concatenate([sm, sm2]), np.concatenate([lens, lens2])


@pytest.mark.parametrize("tile", [1, 16, 64])
@pytest.mark.parametrize("L", [64, 4160, 35008, 131072])
def test_peaks_kernel_matches_plain_bitwise(dev, L, tile):
    """The edge rows (plateaus across tiles and rounds and one as long as
    the read, ties, survivors, values an ulp around the cuts and margins,
    zeros, n = 1, 2, L - 1, L) and the share-seam rows (a plateau across
    three shares, a run from share 0 into the last, ties and plateaus at
    the seams, reads ending inside a share) on the card against the CPU
    plain version, all seven outputs bit for bit, outputs allocated over
    garbage."""
    from c3poa_tpu_torch.kernels.peaks import peak_candidates_cuda
    sm, lens = _peaks_rows(dev, L, L + tile)
    _dirty_allocator(dev, sm.nbytes)
    got = peak_candidates_cuda(torch.from_numpy(sm).to(dev),
                               torch.from_numpy(lens).to(dev), tile)
    torch.cuda.synchronize()
    _peaks_same_bits(got, _peaks_plain_cpu(sm, lens, tile),
                     f"L={L} tile={tile}")


@pytest.mark.parametrize("B", [1, 128])
def test_peaks_kernel_one_read_and_many(dev, B):
    """One read of each share-seam row alone, and 128 reads (random rows
    of random lengths with the seam rows among them): more clusters than
    the card holds at once."""
    from c3poa_tpu_torch.kernels.peaks import peak_candidates_cuda
    L = 35008
    seam, seam_lens = share_rows(L, _peaks_cluster(dev, 1, L)["share"])
    if B == 1:
        cases = [(seam[i:i + 1], seam_lens[i:i + 1])
                 for i in range(len(seam))]
    else:
        rng = np.random.default_rng(17)
        sm = random_rows(rng, B - len(seam), L)
        lens = rng.integers(1, L + 1, len(sm)).astype(np.int32)
        cases = [(np.concatenate([sm, seam]),
                  np.concatenate([lens, seam_lens]))]
    for sm, lens in cases:
        for tile in (16, 64):
            got = peak_candidates_cuda(torch.from_numpy(sm).to(dev),
                                       torch.from_numpy(lens).to(dev), tile)
            _peaks_same_bits(got, _peaks_plain_cpu(sm, lens, tile),
                             f"B={len(sm)} tile={tile}")


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_peaks_kernel_same_under_cluster_sizes(dev, ranks):
    """The clusters the kernel picks by batch size (the most ranks up to 8
    with B * R <= the SMs: on an H100 SXM, 132 reads for 1 rank, 66 for 2,
    33 for 4, 16 for 8) at L = 32768, on each size's own share-seam rows
    and the edge rows, in batches of that many reads (random rows fill
    the last): all seven outputs bit for bit against the CPU plain
    version."""
    from c3poa_tpu_torch.kernels.peaks import peak_candidates_cuda
    L = 32768
    B = torch.cuda.get_device_properties(dev).multi_processor_count // ranks
    plan = _peaks_cluster(dev, B, L)
    assert (plan["ranks"], plan["share"]) == (ranks, L // ranks), plan
    sm, lens = edge_rows(L, seed=ranks)
    sm2, lens2 = share_rows(L, plan["share"])
    rng = np.random.default_rng(ranks)
    fill = -(len(sm) + len(sm2)) % B
    sm = np.concatenate([sm, sm2, random_rows(rng, fill, L)])
    lens = np.concatenate([lens, lens2,
                           rng.integers(1, L + 1, fill).astype(np.int32)])
    for b0 in range(0, len(sm), B):
        x, lx = sm[b0:b0 + B], lens[b0:b0 + B]
        for tile in (1, 64):
            got = peak_candidates_cuda(torch.from_numpy(x).to(dev),
                                       torch.from_numpy(lx).to(dev), tile)
            _peaks_same_bits(got, _peaks_plain_cpu(x, lx, tile),
                             f"ranks={ranks} B={B} reads {b0}.. tile={tile}")


@pytest.mark.parametrize("L,tile,shift", [(4098, 2, 0), (4096, 64, 1)])
def test_peaks_kernel_rows_without_16_byte_loads(dev, L, tile, shift):
    """Rows the kernel loads a float at a time: L not a multiple of 4, and
    rows that start 4 bytes past a 16-byte boundary (a view at an
    offset); bit for bit against the CPU plain version."""
    from c3poa_tpu_torch.kernels.peaks import peak_candidates_cuda
    sm, lens = edge_rows(L - L % 64, seed=3)
    sm = np.pad(sm, ((0, 0), (0, L - sm.shape[1])), constant_values=7.0)
    lens[0] = L
    flat = torch.zeros(sm.size + shift, dtype=torch.float32, device=dev)
    rows = flat[shift:].view(sm.shape)
    rows.copy_(torch.from_numpy(sm))
    assert rows.is_contiguous() and (rows.data_ptr() % 16 != 0) == bool(shift)
    got = peak_candidates_cuda(rows, torch.from_numpy(lens).to(dev), tile)
    _peaks_same_bits(got, _peaks_plain_cpu(sm, lens, tile),
                     f"L={L} tile={tile} shift={shift}")


def test_peaks_kernel_takes_every_launch_of_the_main_path(dev):
    """The card takes the kernel's cluster for every launch the main path
    makes (L up to 131072, B from 1 to 512) and for the widest row it
    takes, MAX_L (8 ranks of 32768 columns, the most shared memory a
    CTA): random rows (four, repeated to B) of random lengths, all seven
    outputs bit for bit against the plain version run on the card."""
    from c3poa_tpu_torch.kernels.peaks import (MAX_L, peak_candidates_batch,
                                               peak_candidates_cuda)
    rng = np.random.default_rng(23)
    for B, L in ((1, 64), (1, 4160), (16, 32768), (128, 32768),
                 (512, 32768), (128, 131072), (1, MAX_L)):
        plan = _peaks_cluster(dev, B, L)
        assert 1 <= plan["ranks"] <= 8 and \
            plan["share"] * plan["ranks"] >= L, (B, L, plan)
        base = random_rows(rng, min(B, 4), L)
        sm = torch.from_numpy(np.resize(base, (B, L))).to(dev)
        lens = torch.from_numpy(
            rng.integers(1, L + 1, B).astype(np.int32)).to(dev)
        _peaks_same_bits(peak_candidates_cuda(sm, lens, 64),
                         peak_candidates_batch(sm, lens, 64),
                         f"B={B} L={L} {plan}")


def test_peaks_kernel_many_reads(dev):
    """300 random reads of random lengths: more clusters than the card
    runs at once, every read's flags set by many CTAs."""
    from c3poa_tpu_torch.kernels.peaks import peak_candidates_cuda
    rng = np.random.default_rng(13)
    L = 8192
    sm = random_rows(rng, 300, L)
    lens = rng.integers(1, L + 1, 300).astype(np.int32)
    for tile in (16, 64):
        got = peak_candidates_cuda(torch.from_numpy(sm).to(dev),
                                   torch.from_numpy(lens).to(dev), tile)
        _peaks_same_bits(got, _peaks_plain_cpu(sm, lens, tile),
                         f"tile={tile}")


def test_locate_device_on_card_launches_peak_kernel(dev):
    """``locate_device`` on the card goes through the peak-candidates
    kernel once a batch, and its outputs equal the CPU route's."""
    from c3poa_tpu_torch.kernels import _build
    from c3poa_tpu_torch.kernels.locate import locate_device
    from c3poa_tpu_torch.state import splint_array
    reads, splints = sim.make_dataset(n_reads=6, seed=9,
                                      insert_len=(500, 900), copies=(3, 6))
    codes = encode(next(iter(splints.values())))
    S = splint_array([Combo("s", "+", codes, len(codes)),
                      Combo("s", "-", revcomp_encoded(codes), len(codes))])
    enc = [encode(r.seq) for r in reads]
    L = -(-max(len(c) for c in enc) // 64) * 64
    R = np.full((len(enc), L), 4, np.int8)
    lens = np.array([len(c) for c in enc], np.int32)
    for b, c in enumerate(enc):
        R[b, :len(c)] = c
    args = [torch.from_numpy(a) for a in (R, lens, S)]
    for tile in (16, 64):
        _build.reset_counts()
        got = locate_device(*(a.to(dev) for a in args), tile=tile)
        assert _build.launch_counts().get("peak_candidates_cuda", 0) == 1
        for name, a, b in zip(("combo", "score", "cand_pos", "cand_h",
                               "med", "deep", "margin"), got,
                              locate_device(*args, tile=tile)):
            _same(a, b, f"tile={tile}: {name}")


def test_peaks_wrapper_rejects_what_it_cannot_take(dev):
    from c3poa_tpu_torch.kernels.peaks import (MAX_L, peak_candidates,
                                               peak_candidates_cuda)
    sm = torch.zeros((2, 128), dtype=torch.float32, device=dev)
    lens = torch.full((2,), 128, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        peak_candidates_cuda(sm.double(), lens, 64)
    with pytest.raises(ValueError, match="int32"):
        peak_candidates(sm, lens.long(), 64)
    with pytest.raises(ValueError, match="disagrees"):
        peak_candidates_cuda(sm, lens[:1], 64)
    with pytest.raises(ValueError, match="multiple of tile"):
        peak_candidates_cuda(sm[:, :96].contiguous(), lens, 64)
    with pytest.raises(ValueError, match="power of two"):
        peak_candidates_cuda(sm, lens, 3)
    with pytest.raises(ValueError, match="contiguous"):
        peak_candidates_cuda(sm[:, ::2], lens, 64)
    with pytest.raises(ValueError, match="CUDA"):
        peak_candidates_cuda(sm.cpu(), lens.cpu(), 64)
    big = torch.zeros((1, MAX_L + 64), dtype=torch.float32, device=dev)
    one = torch.full((1,), 100, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=f"limit of {MAX_L} columns"):
        peak_candidates_cuda(big, one, 64)
    # the C entry point refuses what the wrapper would (nothing launched)
    from c3poa_tpu_torch.kernels import _build
    lib = _build.load("peaks")
    with torch.cuda.device(dev):
        rc = lib.c3t_peak_candidates(*([big.data_ptr()] * 10), 1,
                                     MAX_L + 64, 64,
                                     torch.cuda.current_stream().cuda_stream)
    assert rc != 0
