"""The reference's batched forward (score and end column of many pairs
at once) held to its row-by-row banded DP, at the float32 band and the
control's bfloat16 one, on pairs of the cell's kind and on edge cases:
targets shorter than the band, a query cut short, a long tail."""

import numpy as np
import pytest

from h100_bench import gen
from h100_bench.reference import align as A

PARAMS = dict(match=5, mismatch=-4, gap_open=4, gap_ext=2, band=128)


def pairs(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for n in range(40):
        L = int(rng.integers(1, 140)) if n % 3 == 0 else \
            int(rng.integers(100, 600))
        insert = rng.integers(0, 4, L, dtype=np.int8)
        q, _ = gen.mutate_many(rng, insert, 0.08)
        t, _ = gen.mutate_many(rng, insert, 0.08)
        if n % 7 == 0:
            t = np.concatenate([t, rng.integers(0, 5, int(rng.integers(1, 300)),
                                                dtype=np.int8)])
        if n % 11 == 0:
            q = q[:max(1, len(q) // 2)]
        out.append((q, t))
    return out


@pytest.mark.parametrize("band_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_forward_ends_equal_the_row_by_row_dp(seed, band_dtype):
    ps = pairs(seed)
    got = A.forward_ends(ps, PARAMS, band_dtype)
    for (q, t), g in zip(ps, got):
        score, j_end, _moves, _lo = A.banded_align(
            q, t, 5, -4, 4, 2, 128, band_dtype)
        assert g == (score, j_end)


def test_forward_ends_equal_the_records():
    ps = pairs(17)[:12]
    for (q, t), g in zip(ps, A.forward_ends(ps, PARAMS)):
        rec = A.align_pair(q, t, PARAMS, PARAMS["band"])
        assert g == (rec["score"], rec["j_end"])
