"""The port's CUDA kernels against their plain torch versions, on the
card, at shapes and edge cases the consensus run rarely reaches: every
band width the forward kernel is built for, both scorings, dummy and
empty pairs, band shifts beyond SMAX, long splints and tile seams.

Needs a CUDA card and nvcc; skips without them.  This file imports no
jax, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import shutil

import numpy as np
import pytest
import torch

from c3poa_tpu import sim
from c3poa_tpu.pipeline.backend import Combo
from c3poa_tpu.utils import encode, revcomp_encoded

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


def test_kernel_wrappers_reject_what_they_cannot_take(dev):
    from c3poa_tpu_torch.kernels import banded as tb
    from c3poa_tpu_torch.kernels.sw_profile import start_profile_cuda
    Q = torch.full((2, 64), 4, dtype=torch.int8, device=dev)
    lens = torch.full((2,), 64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="band"):
        tb.banded_fwd_cuda(Q, Q, lens, lens, band=96)
    S = torch.full((1, 32), 4, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        start_profile_cuda(Q[:, :40].contiguous(), S, lens)
    with pytest.raises(ValueError, match="int8"):
        start_profile_cuda(Q.to(torch.int32), S, lens)


def test_backend_on_card_matches_cpu(dev):
    from c3poa_tpu.consensus.engine import ConsensusParams
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
