"""TorchBackend on the CPU (plain torch versions) against the numpy
backend and the JAX backend: locate results and alignment records,
including forced host reruns, overlong reads, the zero-repeat scoring,
fast-band escalation and the batching."""

import numpy as np
import pytest
import torch

from c3poa_tpu import sim
from c3poa_tpu.consensus.engine import ConsensusParams, zero_params
from c3poa_tpu.pipeline.backend import Combo, NumpyBackend
from c3poa_tpu.pipeline.tpu_backend import TpuBackend
from c3poa_tpu.utils import encode, prof, revcomp_encoded
from c3poa_tpu_torch.kernels import peaks as tpk
from c3poa_tpu_torch.pipeline import torch_backend as tbe
from c3poa_tpu_torch.pipeline.torch_backend import TorchBackend

torch.set_num_threads(1)


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


def _pairs(seed):
    """Subread/draft-shaped pairs: core copies, anchored fragments (device
    and serial routes), a fast-band pair that must escalate, and one
    fast-band pair that stays."""
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
    want = _snap(NumpyBackend().align_many(pairs, p))
    _assert_same_records(got, want)
    assert counts["align_launches"] == 2      # one per band
    if scoring == "main":
        assert counts.get("align_band_escalated", 0) >= 1


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


def test_adapter_hits_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchBackend("cpu").adapter_hits([np.zeros(10, np.int8)],
                                         [np.zeros(5, np.int8)], [5])
