"""Ragged (query, target) pairs for the banded aligner's tests, shared by
the CPU tests of the kernels' arithmetic (tests/test_torch_banded.py) and
the card tests (tests/test_torch_cuda.py); imports no jax."""

import numpy as np

from c3poa_tpu_torch import sim
from c3poa_tpu_torch.utils import encode


def ragged_pairs(W: int, seed: int = 0):
    """(Q, T, ql, tl, names) for band W: query width 2 W + 27 (no multiple
    of 8), target width three times that.  The pairs: empty and tiny
    queries, targets shorter than the band, a target of 2 * ql + 1 bases
    (band shifts of 2 and 3), one of 3 * ql (shifts of 3 on every row,
    and a path longer than the walk's step budget), N codes on both
    sides, a deletion of 40 bases (more than a lane's reach inside one
    row), an insertion of 20, and plain noisy copies of several lengths."""
    rng = np.random.default_rng(seed)
    nq = 2 * W + 27
    nt = 3 * nq
    pairs, names = [], []

    def add(name, q, t):
        pairs.append((np.asarray(q, np.int8)[:nq], np.asarray(t, np.int8)[:nt]))
        names.append(name)

    def noisy(n, err=0.05):
        t = sim.random_seq(rng, n)
        q = sim.mutate(rng, t, err, 0.6 * err, 0.6 * err)
        return encode(q), encode(t)

    for a, b in ((0, 40), (1, 1), (7, 9), (9, 3), (33, 30)):
        t = encode(sim.random_seq(rng, b))
        q = (list(t) + [0] * a)[:a]
        add(f"ql {a} tl {b}", q, t)
    add("dummy", [4], [4])
    # every other target base: deletions all along, shifts of 2 and 3
    t = encode(sim.random_seq(rng, 2 * nq + 1))
    add("tl = 2 ql + 1", t[::2][:nq], t)
    t = encode(sim.random_seq(rng, 3 * nq))
    add("tl = 3 ql", t[::3][:nq], t)
    q, t = noisy(nq - 10)
    add("noisy, full width", q, t)
    q, t = noisy(nq // 2, 0.12)
    add("noisy, half width", q, t)
    q, t = noisy(50)
    add("target shorter than the band", q[:60], t[:max(W - 5, 8)])
    q, t = noisy(nq - 20)
    q, t = q.copy(), t.copy()
    q[5::17] = 4
    t[3::23] = 4
    add("N codes", q, t)
    base = sim.random_seq(rng, nq - 50)
    cut = len(base) // 2
    add("deletion of 40",
        encode(sim.mutate(rng, base, 0.03, 0.01, 0.01)),
        encode(base[:cut] + sim.random_seq(rng, 40) + base[cut:]))
    add("insertion of 20",
        encode(base[:cut] + sim.random_seq(rng, 20) + base[cut:]),
        encode(base))
    q, t = noisy(nq + 30)
    add("query cut at the width", q, t)

    P = len(pairs)
    Q = np.full((P, nq), 4, np.int8)
    T = np.full((P, nt), 4, np.int8)
    ql = np.zeros(P, np.int32)
    tl = np.zeros(P, np.int32)
    for p, (q, t) in enumerate(pairs):
        Q[p, :len(q)] = q
        T[p, :len(t)] = t
        ql[p], tl[p] = len(q), len(t)
    return Q, T, ql, tl, names
