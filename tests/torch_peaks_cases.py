"""Rows for holding the peak-candidates kernels (``csrc/peaks.cu``, and
``csrc/peaks.cuh`` under ``tests/peaks_host_driver.cpp``) to the plain
``peak_candidates_batch``: random rows with plateaus, plateaus across tile
and chunk seams and one as long as the read, equal heights and three or
more survivors in a tile, values one ulp either side of 3x and 6x the
median and of the margin limits, all-zero rows, and n = 1, 2, L - 1, L.
No jax: the card tests import it too.

Every value is finite, above NEG_F / 2 and no -0.0: the kernels' domain,
and what the smoothing writes."""

import numpy as np

F = np.float32
# columns where the kernel's chunks (2048) and the host driver's smaller
# chunks meet
SEAMS = (64, 128, 1024, 2048, 4096, 32768)


def up(x, k=1):
    """The float32 k ulps above x (below for k < 0)."""
    x = F(x)
    for _ in range(abs(k)):
        x = np.nextafter(x, F(np.inf) if k > 0 else F(-np.inf), dtype=F)
    return F(x)


def near(a, b):
    """The plain version's margin test |a - b| <= 1e-4 * max(|a|, |b|),
    in float32."""
    a, b = F(a), F(b)
    return bool(np.abs(a - b) <= F(1e-4) * np.maximum(np.abs(a), np.abs(b)))


def margin_limit(b, side):
    """The float32 a nearest b on ``side`` (+1 above, -1 below) with
    near(a, b) false, next to one with near true."""
    a = b
    step = F(abs(b)) * F(1e-5)
    while near(a + side * step * 8, b):
        a = F(a + side * step * 8)
    while near(up(a, side), b):
        a = up(a, side)
    return up(a, side)


def fma_gate_case():
    """(med, xmax): a median whose 6x is rounded and an xmax whose gate
    margin test flips when xmax - 6 * med is one fused multiply-add (what
    nvcc makes of it unless told otherwise)."""
    for m in np.linspace(7.1, 13.9, 200).astype(F):
        six = F(6) * m
        if float(six) == 6.0 * float(m):
            continue
        x = margin_limit(six, 1)
        for xmax in (up(x, k) for k in range(-40, 41)):
            plain = near(xmax, six)
            fused = bool(abs(F(float(xmax) - 6.0 * float(m)))
                         <= F(1e-4) * max(abs(xmax), abs(six)))
            if plain != fused:
                return F(m), F(xmax)
    raise AssertionError("no float32 case separates the fused gate")


def _background(L, m=10.0):
    return np.full(L, F(m), F)


def _spike(x, j, v):
    x[j] = F(v)


def random_rows(rng, B, L):
    """Profile-like smoothed rows: bumps over a low background with
    noise, some stretches rounded to quarters (plateaus), a few negative
    values; full length."""
    rows = np.zeros((B, L), F)
    j = np.arange(L)
    for b in range(B):
        x = rng.normal(0, 0.7, L) + 4.0
        for c in rng.integers(0, L, max(2, L // 200)):
            x += rng.uniform(20, 300) * np.exp(
                -0.5 * ((j - c) / rng.uniform(3, 40)) ** 2)
        for _ in range(max(1, L // 300)):
            a = int(rng.integers(0, L))
            e = a + int(rng.integers(1, 200))
            x[a:e] = np.round(x[a:e] * 4) / 4
        x[rng.integers(0, L, max(1, L // 500))] = -2.5
        rows[b] = x.astype(F)
    rows[rows == 0] = F(0.0)            # no -0.0
    return rows


def edge_rows(L, seed=0):
    """(sm (B, L) float32, lens (B,) int32) of the edge cases, L a
    multiple of 64 and >= 64."""
    rng = np.random.default_rng(seed)
    rows, lens = [], []

    def add(x, n=L):
        rows.append(np.asarray(x, F))
        lens.append(n)

    # random rows at n = L, L - 1, 2, 1 (values past n stay: masked)
    for n in (L, L - 1, 2, 1):
        add(random_rows(rng, 1, L)[0], n)
    # all zeros, full and cut
    add(np.zeros(L, F))
    add(np.zeros(L, F), L // 2 + 1)

    # plateaus across tile and chunk seams: [s - 7, s + 4], and ones
    # ending at a seam's last column or starting at its first
    x = _background(L)
    for s in sorted({16, 48, *SEAMS}):
        if 8 <= s <= L - 8:
            x[s - 7:s + 5] = F(100.0 + s % 7)
    if L >= 512:
        x[192:256] = 90.0                      # ends at 255: tile and chunk
        x[320:324] = 95.0                      # starts at 320
    add(x)
    # a peak at the last column that can hold one, n - 2
    for n in (L, L - 1):
        x = _background(L)
        _spike(x, n - 2, 100.0)
        add(x, n)
    # a plateau as long as the read, which is a peak (negative values:
    # the median, and so the height cut, lies below it)
    x = np.full(L, F(-5.0), F)
    x[0] = x[-1] = -100.0
    add(x)
    # the same plateau, positive: no candidate, and pairs of equal values
    x = np.full(L, F(7.0), F)
    x[0] = x[-1] = 0.5
    add(x)

    # equal heights in a tile (the largest midpoint wins), and three or
    # more survivors in a tile; a plateau peak beside a spike of its height
    x = _background(L)
    for j in (5, 20, 40):
        _spike(x, j, 100.0)
    if L >= 128:
        x[80:84] = 100.0
        _spike(x, 90, 100.0)
        for j, v in ((100, 50.0), (105, 60.0), (110, 70.0), (115, 80.0)):
            _spike(x, j, v)
    _spike(x, L - 10, 100.0)
    _spike(x, L - 3, 100.0)
    add(x)

    # the height cut 3 * med = 30: one ulp either side, and either side of
    # its margin limits (each its own read: the flag is a read's)
    hcut = F(3) * F(10)
    for v in (up(hcut, -1), hcut, up(hcut, 1), margin_limit(hcut, 1),
              up(margin_limit(hcut, 1), -1), margin_limit(hcut, -1),
              up(margin_limit(hcut, -1), 1)):
        x = _background(L)
        _spike(x, L // 4, v)
        _spike(x, 3 * L // 4, 400.0)
        add(x)
    # the gate 6 * med = 60: xmax one ulp either side and at its margin
    # limits
    gate = F(6) * F(10)
    for v in (up(gate, -1), gate, up(gate, 1), margin_limit(gate, 1),
              up(margin_limit(gate, 1), -1), margin_limit(gate, -1),
              up(margin_limit(gate, -1), 1)):
        x = _background(L)
        _spike(x, L // 3, v)
        add(x)
    # the gate's margin where a fused multiply-add would flip it
    m, xmax = fma_gate_case()
    x = np.full(L, m, F)
    _spike(x, L // 2, xmax)
    add(x)
    # the structure margin: two adjacent values above the cut, k ulps
    # apart around the tolerance 2e-4 (50 has ulps of 3.8e-6)
    for k in (52, 53):
        x = _background(L)
        x[L // 2] = 50.0
        x[L // 2 + 1] = up(50.0, k)
        _spike(x, L // 4, 90.0)                # xmax 90: tol 2e-4
        add(x)
    # a read whose tolerance is relative (2e-6 * xmax > 2e-4)
    x = _background(L)
    _spike(x, 7, 3000.0)
    x[L // 2] = 50.0
    x[L // 2 + 1] = up(50.0, 1000)
    add(x)
    return np.stack(rows), np.asarray(lens, np.int32)
