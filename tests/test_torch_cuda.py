"""The port's CUDA kernels against their plain torch versions, on the
card, at shapes and edge cases the consensus and postprocess runs rarely
reach: every band width the forward kernel is built for, both scorings,
dummy and empty pairs, band shifts beyond SMAX, long splints, tile seams,
the adapter hits' ties, dimers, N codes, short and empty reads, and the
two probe kernels at the int16 extremes, every mode at the smallest and
largest M they are built for, and int32 overflow.

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


@pytest.mark.parametrize("B,L,splint_len,seed", [
    (3, 64, 20, 0),            # one tile, tiny splint
    (5, 12288, 224, 1),        # tile seams
    (4, 8192 + 64, 480, 2),    # long splint: wide overlap
    (2, 4096, 200, 3),
])
def test_profile_kernel_matches_plain(dev, B, L, splint_len, seed):
    from c3poa_tpu_torch.kernels.sw_profile import (start_profile_batch,
                                                    start_profile_cuda,
                                                    tile_overlap, TILE_WIDTH)
    from c3poa_tpu_torch.state import splint_array
    rng = np.random.default_rng(seed)
    codes = encode(sim.random_seq(rng, splint_len))
    S = splint_array([Combo("s", "+", codes, len(codes)),
                      Combo("s", "-", revcomp_encoded(codes), len(codes))])
    R = np.full((B, L), 4, np.int8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(0, L + 1)) if b else L
        R[b, :n] = rng.integers(0, 4, n)
        lens[b] = n
    core = TILE_WIDTH - tile_overlap(S.shape[1])
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
    from c3poa_tpu_torch.kernels.adapters import adapter_hits_cuda
    alens = torch.full((1,), 32, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        adapter_hits_cuda(Q[:, :60].contiguous(), lens, S, alens, 1, -3, 3)
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
    """Tile seams (hits planted across 1024-column tiles), a read at the
    backend's length limit, and an empty read beside them."""
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
