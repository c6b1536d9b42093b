"""The port's locate step (smoothing, peak candidates, fused locate, the
exact-row fetch) against the JAX package and the f64 spec, and its
jax-free copies of the host peak helpers."""

import numpy as np
import pytest
import torch

from c3poa_tpu import sim
from c3poa_tpu.kernels import locate as jloc
from c3poa_tpu.kernels import peaks as jpk
from c3poa_tpu.kernels.smooth import smooth3_batch as jax_smooth
from c3poa_tpu.pipeline.backend import Combo, NumpyBackend
from c3poa_tpu.ref import sg, sw
from c3poa_tpu.utils import encode, revcomp_encoded
from c3poa_tpu_torch.kernels import locate as tloc
from c3poa_tpu_torch.kernels import peaks as tpk
from c3poa_tpu_torch.kernels.smooth import smooth3_batch
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
from c3poa_tpu_torch.state import splint_array

torch.set_num_threads(1)


def _bench_reads(n, seed, splint_len=200, insert_len=(500, 2000),
                 copies=(5, 15)):
    """Bench-shaped reads (bench.py's dataset) and their combos."""
    rng = np.random.default_rng(seed + 100)
    splints = {"Splint1": sim.random_seq(rng, splint_len)}
    reads, splints = sim.make_dataset(n_reads=n, seed=seed, splints=splints,
                                      insert_len=insert_len, copies=copies,
                                      error=0.05)
    codes = encode(splints["Splint1"])
    combos = [Combo("Splint1", "+", codes, len(codes)),
              Combo("Splint1", "-", revcomp_encoded(codes), len(codes))]
    return [encode(r.seq) for r in reads], combos


def _block(enc, L=None):
    L = L or -(-max(len(c) for c in enc) // 64) * 64
    R = np.full((len(enc), L), 4, dtype=np.int8)
    lens = np.zeros(len(enc), dtype=np.int32)
    for b, c in enumerate(enc):
        R[b, :len(c)] = c
        lens[b] = len(c)
    return R, lens


def _profile_block(profs):
    """(B, L) float32 block of int32 profile rows, zero past each."""
    L = -(-max(len(p) for p in profs) // 64) * 64
    X = np.zeros((len(profs), L), dtype=np.float32)
    for b, p in enumerate(profs):
        X[b, :len(p)] = p
    return X, np.array([len(p) for p in profs], dtype=np.int32)


def _chosen_profiles(enc, combos):
    """Exact int32 profile row of the best combo per read (ref/sw)."""
    out = []
    for c in enc:
        profs = [sw.start_profile(k.codes, c) for k in combos]
        out.append(max(profs, key=lambda p: p.max(initial=0)))
    return out


@pytest.fixture(scope="module")
def bench_profiles():
    enc, combos = _bench_reads(8, seed=11, insert_len=(500, 1200),
                               copies=(5, 9))
    return enc, combos, _chosen_profiles(enc, combos)


def test_smooth_matches_jax_and_f64(bench_profiles):
    """Against the JAX f32 smoothing: atol 2e-4.  Against the f64 spec:
    the port's f32 error stays within 1.25x the JAX package's own f32
    error on the same profiles (the error the peak guards were
    calibrated on) and inside STRUCT_ATOL for adjacent differences."""
    _enc, _combos, profs = bench_profiles
    X, lens = _profile_block(profs)
    got = smooth3_batch(torch.from_numpy(X), torch.from_numpy(lens)).numpy()
    ref32 = np.asarray(jax_smooth(X, lens))
    np.testing.assert_allclose(got, ref32, rtol=0, atol=2e-4)
    err = {"port": [0.0, 0.0], "jax": [0.0, 0.0]}
    for b, p in enumerate(profs):
        want = sg.smooth3(p.astype(np.float64))
        assert not got[b, len(p):].any()
        for k, arr in (("port", got), ("jax", ref32)):
            d = arr[b, :len(p)].astype(np.float64) - want
            err[k][0] = max(err[k][0], float(np.abs(d).max()))
            err[k][1] = max(err[k][1], float(np.abs(np.diff(d)).max()))
    assert err["port"][0] <= 1.25 * err["jax"][0]
    assert err["port"][1] <= 1.25 * err["jax"][1]
    assert err["port"][1] < tpk.STRUCT_ATOL


def test_masked_median_matches_numpy():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 70)).astype(np.float32)
    x[1, :10] = 2.0  # ties
    lens = np.array([70, 1, 2, 33, 64], dtype=np.int32)
    got = tpk.masked_median(torch.from_numpy(x), torch.from_numpy(lens))
    for b in range(5):
        assert got[b].item() == np.float32(np.median(x[b, :lens[b]]))


@pytest.mark.parametrize("tile", [64, 16, 1])
def test_peak_candidates_match_jax(bench_profiles, tile):
    """Same float32 input -> identical candidates and flags."""
    _enc, _combos, profs = bench_profiles
    X, lens = _profile_block(profs)
    sm = np.array(jax_smooth(X, lens))
    got = tpk.peak_candidates_batch(torch.from_numpy(sm),
                                    torch.from_numpy(lens), tile=tile)
    want = jpk.peak_candidates_batch(sm, lens, tile=tile)
    for name, a, b in zip(("cand_pos", "cand_h", "med", "height", "gated",
                           "deep", "margin"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def test_locate_device_matches_jax():
    enc, combos = _bench_reads(6, seed=12, insert_len=(500, 1000),
                               copies=(3, 8))
    # a read without any splint (combo ties at score 0 -> lowest index),
    # and a JAX-backend dummy row (len 64, all pad)
    enc.append(np.zeros(3000, dtype=np.int8))
    enc.append(np.full(64, 4, dtype=np.int8))
    R, lens = _block(enc, L=4096 * 4)
    S = splint_array(combos)
    got = [x.numpy() for x in tloc.locate_device(
        torch.from_numpy(R), torch.from_numpy(lens), torch.from_numpy(S),
        tile=64)]
    want = [np.asarray(x) for x in jloc.locate_device(R, lens, S, tile=64)]
    np.testing.assert_array_equal(got[0], want[0])          # combo
    np.testing.assert_array_equal(got[1], want[1])          # best score
    flagged = got[5] | got[6] | want[5] | want[6]
    for b in np.flatnonzero(~flagged):
        np.testing.assert_array_equal(got[2][b], want[2][b])  # cand_pos


def test_profile_rows_combo_identity():
    enc, combos = _bench_reads(4, seed=13, insert_len=(500, 900),
                               copies=(2, 4))
    R, lens = _block(enc)
    S = splint_array(combos)
    c = np.array([1, 0, 1, 1], dtype=np.int32)
    Rt, lt, St, ct = (torch.from_numpy(a) for a in (R, lens, S, c))
    rows = tloc.profile_rows_combo(Rt, lt, St, ct).numpy()
    full = tloc.profile_rows(Rt, lt, St).numpy()
    np.testing.assert_array_equal(rows, full[np.arange(len(c)), c])
    np.testing.assert_array_equal(
        rows, np.asarray(jloc.profile_rows_combo(R, lens, S, c)))


def test_long_splint_locate_matches_numpy():
    """A 450 bp splint: peak heights ~2x the bench's, where the absolute
    STRUCT_ATOL guard has the least room.  The backend's results (with
    its host reruns) must still equal the exact numpy path."""
    enc, combos = _bench_reads(6, seed=14, splint_len=450,
                               insert_len=(500, 900), copies=(3, 6))
    got = TorchBackend("cpu").locate_many(enc, combos, 500)
    want = NumpyBackend().locate_many(enc, combos, 500)
    for g, w in zip(got, want):
        assert (g.combo, g.score) == (w.combo, w.score)
        np.testing.assert_array_equal(g.peaks, w.peaks)


def test_host_helper_copies_match_originals():
    assert (tpk.MARGIN_REL, tpk.ORDER_REL, tpk.STRUCT_ATOL) == \
        (jpk.MARGIN_REL, jpk.ORDER_REL, jpk.STRUCT_ATOL)
    assert tpk.NEG_F == float(jpk.NEG_F)
    for d in (0, 1, 2, 3, 40, 64, 65, 500, 10 ** 6):
        assert tpk.tile_for_distance(d) == jpk.tile_for_distance(d)
    rng = np.random.default_rng(5)
    B, M = 40, 24
    pos = np.sort(rng.integers(0, 2000, (B, M)), axis=1).astype(np.int32)
    pos[rng.random((B, M)) < 0.3] = -1
    h = rng.uniform(100, 101, (B, M)).astype(np.float32)
    # near-equal heights so the order guard has something to find
    h[:, 1] = h[:, 0] * np.float32(1 + 1e-7)
    for d in (0, 30, 200, 500):
        np.testing.assert_array_equal(
            tpk.margin_competitors_host(pos, h, d),
            jpk.margin_competitors_host(pos, h, d))
        for a, b in zip(tpk.select_peaks_host(pos, h, d),
                        jpk.select_peaks_host(pos, h, d)):
            np.testing.assert_array_equal(a, b)
