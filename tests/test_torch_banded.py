"""The port's banded aligner (plain torch forward pass and walk) against
the JAX package's XLA scan, its Pallas kernel in interpret mode, and
the host helpers it copies.

The CUDA kernels run only on a card: chip_smoke.py holds them against
these plain versions there."""

import numpy as np
import pytest
import torch

from c3poa_tpu import sim
from c3poa_tpu.kernels import banded as jb
from c3poa_tpu.kernels.pallas_banded import banded_fwd_pallas
from c3poa_tpu.utils import encode
from c3poa_tpu_torch.kernels import banded as tb

torch.set_num_threads(1)

SCORINGS = {"main": (5, -4, 4, 2), "zero": (20, -7, 10, 5)}


def _pairs(seed, P, nq, nt, err=0.05, dummy=0):
    rng = np.random.default_rng(seed)
    Q = np.full((P, nq), 4, np.int8)
    T = np.full((P, nt), 4, np.int8)
    ql = np.ones(P, np.int32)
    tl = np.ones(P, np.int32)
    for p in range(P - dummy):
        n = int(rng.integers(nt // 2, nt))
        t = sim.random_seq(rng, n)
        q = sim.mutate(rng, t, err, 0.6 * err, 0.6 * err)[:nq]
        T[p, :len(t)] = encode(t)
        Q[p, :len(q)] = encode(q)
        tl[p], ql[p] = len(t), len(q)
    return Q, T, ql, tl


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("W,scoring,seed", [
    (64, "main", 1), (128, "zero", 2), (32, "main", 3)])
def test_forward_matches_jax(W, scoring, seed):
    mt, mm, go, ge = SCORINGS[scoring]
    Q, T, ql, tl = _pairs(seed, 6, 320, 320, dummy=1)
    s, je, mv = tb.banded_align_batch(*_t(Q, T, ql, tl), band=W, match=mt,
                                      mismatch=mm, gap_open=go, gap_ext=ge)
    s1, j1, m1 = jb.banded_align_batch(Q, T, ql, tl, band=W, match=mt,
                                       mismatch=mm, gap_open=go, gap_ext=ge)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(je.numpy(), np.asarray(j1))
    moves = tb.unpack_moves(mv, Q.shape[1]).numpy()
    m1 = np.asarray(m1)
    for p in range(len(ql)):
        np.testing.assert_array_equal(moves[p, :ql[p]], m1[p, :ql[p]],
                                      err_msg=f"pair {p}")
        # rows past the query are 0 in the port's layout
        assert not moves[p, ql[p]:].any()


def test_forward_matches_pallas_interpret():
    Q, T, ql, tl = _pairs(4, 8, 256, 256)
    s1, j1, m1 = banded_fwd_pallas(Q, T, ql, tl, band=64, interpret=True,
                                   p_tile=8, superblock=True, fold=True)
    s, je, mv = tb.banded_fwd(*_t(Q, T, ql, tl), band=64)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(je.numpy(), np.asarray(j1))
    moves = tb.unpack_moves(mv, Q.shape[1]).numpy()
    m1 = np.asarray(m1)
    for p in range(len(ql)):
        np.testing.assert_array_equal(moves[p, :ql[p]], m1[p, :ql[p]])


@pytest.mark.parametrize("W,scoring,seed,err", [
    (64, "main", 5, 0.05), (128, "zero", 6, 0.05), (64, "main", 7, 0.12)])
def test_walk_matches_jax(W, scoring, seed, err):
    mt, mm, go, ge = SCORINGS[scoring]
    Q, T, ql, tl = _pairs(seed, 6, 320, 320, err=err, dummy=1)
    sc, je, js, ir, ops, edge = tb.banded_align_trace(
        *_t(Q, T, ql, tl), band=W, match=mt, mismatch=mm, gap_open=go,
        gap_ext=ge)
    r = jb.banded_align_trace_batch(Q, T, ql, tl, band=W, match=mt,
                                    mismatch=mm, gap_open=go, gap_ext=ge)
    for got, want in zip((sc, je, js, ir, edge),
                         (r[0], r[1], r[2], r[3], r[5])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.dtype == torch.uint8
    assert ops.shape[1] == tb.ops_bytes(tb.walk_steps(Q.shape[1], W))
    jops = np.asarray(r[4])
    for p in range(len(ql)):
        dense = tb.unpack_ops_packed(ops[p].numpy())
        np.testing.assert_array_equal(dense, jops[p][jops[p] != 0])
        # no gaps in the port's stream: ops then zeros
        n = len(dense)
        flat = np.stack([(ops[p].numpy() >> (2 * s)) & 3
                         for s in range(4)], axis=1).reshape(-1)
        assert flat[:n].all() and not flat[n:].any()


def test_walk_dispatch_and_cuda_wrapper_checks():
    Q, T, ql, tl = _pairs(8, 2, 64, 64)
    args = _t(Q, T, ql, tl)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tb.banded_fwd_cuda(*args, band=64)
    s, je, mv = tb.banded_fwd(*args, band=64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tb.banded_walk_cuda(mv, args[2], args[3], je, 64, 64)
    plain = tb.banded_walk_batch(mv, args[2], args[3], je, 64, 64)
    disp = tb.banded_walk(mv, args[2], args[3], je, 64, 64)
    for a, b in zip(plain, disp):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("nq,nt,W", [
    (4, 2, 2), (2000, 1900, 128), (777, 1555, 64), (1000, 999, 32),
    (5, 11, 4), (1, 1, 128), (3, 0, 8)])
def test_band_lo_matches_host_twins(nq, nt, W):
    want = jb.band_starts_np(nq, nt, W)
    np.testing.assert_array_equal(tb.band_starts_np(nq, nt, W), want)
    P = nq + 1
    got = tb.band_lo(torch.arange(P, dtype=torch.int32),
                     torch.full((P,), nq, dtype=torch.int32),
                     torch.full((P,), nt, dtype=torch.int32), W)
    np.testing.assert_array_equal(got.numpy(), want)


def test_host_helper_copies_match_originals():
    assert tb.SMAX == jb.SMAX
    assert tb.NEG == int(jb.NEG)
    rng = np.random.default_rng(9)
    row = rng.integers(0, 256, 40).astype(np.uint8)
    np.testing.assert_array_equal(tb.unpack_ops_packed(row),
                                  jb.unpack_ops_packed(row))
    Q, T, ql, tl = _pairs(10, 3, 128, 128)
    r = jb.banded_align_trace_batch(Q, T, ql, tl, band=64)
    ops = np.asarray(r[4])
    for p in range(3):
        q, t = Q[p, :ql[p]], T[p, :tl[p]]
        a = tb.ops_to_record(q, t, ops[p], int(np.asarray(r[1])[p]))
        b = jb.ops_to_record(q, t, ops[p], int(np.asarray(r[1])[p]))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_unpack_moves_layout():
    words = torch.tensor([[[0x76543210, -1]]], dtype=torch.int32)
    got = tb.unpack_moves(words, 8).numpy()
    assert got.shape == (1, 8, 2)
    np.testing.assert_array_equal(got[0, :, 0], np.arange(8))
    np.testing.assert_array_equal(got[0, :, 1], np.full(8, 15))
