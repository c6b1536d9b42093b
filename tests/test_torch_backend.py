"""TorchBackend on the CPU (plain torch versions) against the numpy
backend and the JAX backend: locate results and alignment records,
including forced host reruns, overlong reads, the zero-repeat scoring,
a path along a band-64 edge and the batching."""

import os
import re

import numpy as np
import pytest
import torch

from c3poa_tpu import sim
from c3poa_tpu.consensus.engine import ConsensusParams, _pair_band, zero_params
from c3poa_tpu.pipeline.backend import Combo, NumpyBackend
from c3poa_tpu.pipeline.tpu_backend import TpuBackend
from c3poa_tpu.ref import banded
from c3poa_tpu.utils import encode, revcomp_encoded
from c3poa_tpu_torch.kernels import banded as tbk
from c3poa_tpu_torch.kernels import peaks as tpk
from c3poa_tpu_torch.kernels import sw_profile as tsw
from c3poa_tpu_torch.pipeline import torch_backend as tbe
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend
from c3poa_tpu_torch.utils import prof

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def located_reads():
    reads, splints = sim.make_dataset(
        n_reads=8, seed=21, insert_len=(600, 800), copies=(2, 5), error=0.05)
    combos = []
    for name, seq in splints.items():
        codes = encode(seq)
        combos.append(Combo(name, "+", codes, len(codes)))
        combos.append(Combo(name, "-", revcomp_encoded(codes), len(codes)))
    enc = [encode(r.seq) for r in reads]
    # a read with no splint at all
    enc.append(encode(sim.random_seq(np.random.default_rng(1), 2500)))
    return enc, combos, NumpyBackend().locate_many(enc, combos, 500)


def _assert_same_located(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.combo, g.score) == (w.combo, w.score)
        assert g.peaks.dtype == np.int64
        np.testing.assert_array_equal(g.peaks, w.peaks)


def test_locate_many_matches_numpy_and_tpu(located_reads, monkeypatch):
    enc, combos, want = located_reads
    got = TorchBackend("cpu").locate_many(enc, combos, 500)
    _assert_same_located(got, want)
    # the JAX backend's XLA path on the CPU, with a short length bucket
    # (its default 32 k bucket costs a minute of CPU here)
    monkeypatch.setenv("C3POA_LOCATE_BUCKETS", "8192")
    assert max(len(c) for c in enc) <= 8192
    _assert_same_located(got, TpuBackend().locate_many(enc, combos, 500))


def test_locate_many_forced_margin_reruns(located_reads, monkeypatch):
    """Every read with a candidate is margin-flagged: all take the exact
    host rerun from their device profile row, with the same result."""
    enc, combos, want = located_reads
    monkeypatch.setattr(tpk, "MARGIN_REL", 10.0)
    prof.reset()
    got = TorchBackend("cpu").locate_many(enc, combos, 500)
    assert prof.current.counts["peaks_margin_host_rerun"] >= len(enc) - 1
    _assert_same_located(got, want)


def test_locate_many_overlong_reads_host_path(located_reads, monkeypatch):
    enc, combos, want = located_reads
    limit = int(np.median([len(c) for c in enc]))
    monkeypatch.setattr(tbe, "MAX_READ_LEN", limit)
    prof.reset()
    got = TorchBackend("cpu").locate_many(enc, combos, 500)
    n_long = sum(len(c) > limit for c in enc)
    assert n_long and \
        prof.current.counts["overlong_reads_host_located"] == n_long
    _assert_same_located(got, want)


def test_locate_many_long_splint_host_path(located_reads, monkeypatch):
    """A combo set the profile kernel's tiles do not take (here: the
    limit lowered under the 200 bp splints) is located on the host, on
    the CPU as on the card."""
    enc, combos, want = located_reads
    assert tsw.profile_fits(224)
    monkeypatch.setattr(tsw, "MAX_OVERLAP", 256)
    assert not tsw.profile_fits(224)
    prof.reset()
    got = TorchBackend("cpu").locate_many(enc, combos, 500)
    assert prof.current.counts["long_splint_host_located"] == len(enc)
    assert "locate_launches" not in prof.current.counts
    _assert_same_located(got, want)


def _pairs(seed):
    """Subread/draft-shaped pairs: core copies, anchored fragments (device
    and serial routes), and two pairs that carry band 64: one with a
    100-base insertion, whose path runs along the band's edge, and one
    that stays inside it."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(7):
        t = sim.random_seq(rng, int(rng.integers(500, 900)))
        q = sim.mutate(rng, t, 0.05, 0.03, 0.03)
        pairs.append((encode(q), rng.integers(5, 40, len(q)).astype(np.int8),
                      encode(t)))
    t = sim.random_seq(rng, 700)
    for a, b in ((0, 420), (150, 400)):   # device route, serial route
        q = sim.mutate(rng, t[a:b], 0.05, 0.03, 0.03)
        pairs.append((encode(q), np.full(len(q), 20, np.int8), encode(t)))
    t = sim.random_seq(rng, 600)
    q = t[:300] + sim.random_seq(rng, 100) + t[300:]  # 100-base insertion
    pairs.append((encode(q), np.full(len(q), 20, np.int8), encode(t), 64))
    q = sim.mutate(rng, t, 0.02, 0.01, 0.01)
    pairs.append((encode(q), np.full(len(q), 20, np.int8), encode(t), 64))
    return pairs


def _snap(alns):
    """Copies of the records (the native ones are views into arenas that
    the next call of the same phase reuses)."""
    return [(tuple(np.array(f) for f in a.rec), np.array(a.query),
             np.array(a.qual)) for a in alns]


def _spec(pairs, p):
    """The JAX package's numpy spec, each pair aligned once at its own
    band (its ``serial_align_many`` would realign a band-64 path that
    touches the band's edge at ``p.band``)."""
    out = []
    for pr in pairs:
        rec = banded.align_and_trace(
            pr[0], pr[2], match=p.match, mismatch=p.mismatch,
            gap_open=p.gap_open, gap_ext=p.gap_ext, band=_pair_band(pr, p))
        out.append((tuple(np.array(f) for f in rec), np.array(pr[0]),
                    np.array(pr[1])))
    return out


def _assert_same_records(got, want):
    assert len(got) == len(want)
    for k, ((rg, qg, sg), (rw, qw, sw)) in enumerate(zip(got, want)):
        for name, a, b in zip(("cover", "base", "qpos", "ins_len",
                               "ins_qstart", "j_start", "j_end", "score"),
                              rg, rw):
            np.testing.assert_array_equal(a, b, err_msg=f"pair {k} {name}")
        np.testing.assert_array_equal(qg, qw)
        np.testing.assert_array_equal(sg, sw)


@pytest.mark.parametrize("scoring", ["main", "zero"])
def test_align_many_matches_numpy(scoring):
    p = ConsensusParams()
    phase = 0
    if scoring == "zero":
        p, phase = zero_params(p, p.band), 16
    pairs = _pairs(3)
    prof.reset()
    got = _snap(TorchBackend("cpu").align_many(pairs, p, phase_base=phase))
    counts = dict(prof.current.counts)
    _assert_same_records(got, _spec(pairs, p))
    assert counts["align_launches"] == 2      # one per band
    if scoring == "main":
        q, _qual, t, band = pairs[9]
        _rec, edge = banded.align_and_trace(
            q, t, match=p.match, mismatch=p.mismatch, gap_open=p.gap_open,
            gap_ext=p.gap_ext, band=band, with_edge=True)
        assert edge


def test_output_does_not_depend_on_batching(located_reads, monkeypatch):
    enc, combos, want = located_reads
    p = ConsensusParams()
    pairs = _pairs(4)
    a = _snap(TorchBackend("cpu").align_many(pairs, p))
    monkeypatch.setattr(tbe, "MAX_LOCATE_BATCH", 2)
    monkeypatch.setattr(tbe, "MAX_ALIGN_BATCH", 3)
    small = TorchBackend("cpu")
    _assert_same_located(small.locate_many(enc, combos, 500), want)
    prof.reset()
    b = _snap(small.align_many(pairs, p))
    assert prof.current.counts["align_launches"] >= 4
    _assert_same_records(a, b)


def test_fwd_max_target_is_the_kernel_staging_limit():
    """FWD_MAX_TARGET is the widest target row whose 4-bit staging
    (csrc/banded.cuh:bnd_target_words) fits csrc/banded.cu's
    FWD_SHARED_BYTES, at every band."""
    src = open(os.path.join(ROOT, "c3poa_tpu_torch", "kernels", "csrc",
                            "banded.cu")).read()
    m = re.search(r"FWD_SHARED_BYTES = (\d+) \* 1024;", src)
    assert int(m.group(1)) * 1024 == tbk.FWD_SHARED_BYTES

    def staged_bytes(nt, W):
        return (max(nt + 1, W) // 8 + 2) * 4

    for W in tbk.CUDA_BANDS:
        assert staged_bytes(tbk.FWD_MAX_TARGET, W) <= tbk.FWD_SHARED_BYTES
        assert staged_bytes(tbk.FWD_MAX_TARGET + 1, W) > \
            tbk.FWD_SHARED_BYTES


@pytest.mark.parametrize("scoring", ["main", "zero"])
def test_align_many_overlong_targets_host_path(monkeypatch, scoring):
    """Pairs whose target (padded as launched) is wider than the forward
    kernel stages take the host aligner, on the CPU as on the card (here:
    the limit lowered to 640 columns)."""
    p = ConsensusParams()
    if scoring == "zero":
        p = zero_params(p, p.band)
    pairs = _pairs(5)
    monkeypatch.setattr(tbk, "FWD_MAX_TARGET", 640)
    n_long = sum(-(-len(pr[2]) // 64) * 64 > 640 and
                 len(pr[2]) <= 2 * len(pr[0]) + 1 for pr in pairs)
    assert 0 < n_long < len(pairs)
    prof.reset()
    got = _snap(TorchBackend("cpu").align_many(pairs, p))
    assert prof.current.counts["align_overlong_host"] == n_long
    _assert_same_records(got, _spec(pairs, p))
