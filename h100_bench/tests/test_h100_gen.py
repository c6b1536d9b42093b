"""The benchmark's generator held to the port's own generator's
parameters at a small size: lengths, copy counts, error rates, and the
same sizes for every seed."""

import json
import os

import numpy as np
import pytest

from c3poa_tpu_torch import sim
from c3poa_tpu_torch.utils.seqs import encode, phred_to_array
from h100_bench import gen
from h100_bench.reference.check import fitting_edit_distance

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind, name):
    with open(os.path.join(HERE, kind, name + ".json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("error", [0.05, 0.01])
def test_mutate_many_matches_sim_mutate(error):
    rng = np.random.default_rng(0)
    template = rng.integers(0, 4, 40000, dtype=np.int8)
    out, pos = gen.mutate_many(np.random.default_rng(1), template, error)
    ref = encode(sim.mutate(np.random.default_rng(2),
                            gen.decode(template).decode(),
                            error * 0.5, error * 0.25, error * 0.25))
    # expected length: n (1 - del) + n ins / (1 - ins)
    want = len(template) * (1 - error / 4 + (error / 4) / (1 - error / 4))
    for got in (len(out), len(ref)):
        assert abs(got - want) < 4 * np.sqrt(len(template) * error)
    assert pos[-1] == len(out) and pos[0] == 0
    # edits per base of a stretch, both ways near the error rate
    for seq in (out, ref):
        d = fitting_edit_distance(template[1000:3000], seq)
        assert 0.5 * error * 2000 <= d <= 1.5 * error * 2000 + 5


def test_r2c2_pool_shape_matches_make_dataset():
    cfg = load("configs", "r2c2_cdna")
    mix = dict(load("traffic", "clean"), reads=200)
    pool = gen.make_pool(cfg, mix, 7)
    sizes = gen.r2c2_sizes(cfg["read_shape"], mix)
    assert sizes["insert_len"].min() >= 500 and sizes["insert_len"].max() < 2000
    assert sizes["copies"].min() >= 5 and sizes["copies"].max() <= 15
    assert set(pool.strand) == {"+", "-"}
    reads, _ = sim.make_dataset(n_reads=200, seed=7, insert_len=(500, 2000),
                                copies=(5, 15), error=0.05)
    mean_ref = np.mean([len(r.seq) for r in reads])
    mean_got = np.mean([len(s) for s in pool.seqs])
    assert abs(mean_got - mean_ref) / mean_ref < 0.1
    q = np.concatenate(pool.quals)
    q_ref = np.concatenate([phred_to_array(r.qual) for r in reads])
    assert q.min() >= 2 and q.max() <= 40
    assert abs(q.mean() - q_ref.mean()) < 0.1
    for t in pool.truth:
        assert len(t) in sizes["insert_len"]


def test_same_sizes_every_seed():
    cfg = load("configs", "r2c2_cdna")
    mix = dict(load("traffic", "clean"), reads=60)
    a = gen.make_pool(cfg, mix, 1)
    b = gen.make_pool(cfg, mix, 2 ** 31 + 11)
    assert sorted(len(t) for t in a.truth) == sorted(len(t) for t in b.truth)
    assert not all(np.array_equal(x, y) for x, y in zip(a.truth, b.truth))
    c = gen.make_pool(cfg, mix, 1)
    assert all(np.array_equal(x, y) for x, y in zip(a.seqs, c.seqs))
