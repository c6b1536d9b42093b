"""The port's splint profile (plain torch version) against the JAX
package's XLA scan, its Pallas kernel in interpret mode and the numpy
spec; the carried-across splint state; device selection.

The CUDA kernel itself runs only on a card: chip_smoke.py holds it
against the plain version there."""

import numpy as np
import pytest
import torch

from c3poa_tpu import sim
from c3poa_tpu.kernels.pallas_profile import start_profile_pallas
from c3poa_tpu.kernels.sw_profile import start_profile_batch as jax_profile
from c3poa_tpu.pipeline.backend import Combo
from c3poa_tpu.pipeline.tpu_backend import TpuBackend
from c3poa_tpu.ref import sw
from c3poa_tpu.utils import encode, revcomp_encoded
from c3poa_tpu_torch.device import resolve_device
from c3poa_tpu_torch.kernels import sw_profile as tp
from c3poa_tpu_torch.state import splint_array, to_device

torch.set_num_threads(1)


def _inputs(seed, B, L, C, m):
    rng = np.random.default_rng(seed)
    R = np.full((B, L), 4, dtype=np.int8)
    lens = np.zeros(B, dtype=np.int32)
    for b in range(B):
        n = int(rng.integers(L // 2, L + 1))
        R[b, :n] = rng.integers(0, 4, n)
        lens[b] = n
    S = np.full((C, m), 4, dtype=np.int8)
    slens = []
    for c in range(C):
        k = int(rng.integers(m // 2, m + 1))
        S[c, :k] = rng.integers(0, 4, k)
        slens.append(k)
    # a planted occurrence, and an N inside a read
    R[0, 100:100 + slens[0]] = S[0, :slens[0]]
    R[B - 1, 7] = 4
    return R, S, lens, slens


@pytest.mark.parametrize("seed,B,L,C,m", [
    (0, 6, 1024, 2, 96),
    (1, 3, 704, 3, 64),
    (2, 2, 2048, 1, 160),
])
def test_profile_matches_jax_and_spec(seed, B, L, C, m):
    R, S, lens, slens = _inputs(seed, B, L, C, m)
    got = tp.start_profile_batch(torch.from_numpy(R),
                                 torch.from_numpy(S)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jax_profile(R, S)))
    for b in range(B):
        for c in range(C):
            want = sw.start_profile(S[c][:slens[c]], R[b][:lens[b]])
            np.testing.assert_array_equal(got[b, c, :lens[b]], want)
            assert not got[b, c, lens[b]:].any()


def test_profile_matches_pallas_interpret():
    R, S, lens, _ = _inputs(3, 8, 2048, 2, 128)
    want = np.asarray(start_profile_pallas(R, S, lens, interpret=True))
    got = tp.start_profile(torch.from_numpy(R), torch.from_numpy(S),
                           torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, want)


def test_profile_dispatch_and_cuda_wrapper_checks():
    R, S, lens, _ = _inputs(4, 2, 256, 2, 32)
    Rt, St, lt = (torch.from_numpy(a) for a in (R, S, lens))
    np.testing.assert_array_equal(tp.start_profile(Rt, St, lt).numpy(),
                                  tp.start_profile_batch(Rt, St).numpy())
    # the kernel wrapper never falls back to the plain version
    with pytest.raises(ValueError, match="CUDA tensor"):
        tp.start_profile_cuda(Rt, St, lt)


@pytest.mark.parametrize("m", [1, 32, 200, 224, 480, 1000])
def test_tile_overlap_covers_alignment_reach(m):
    ov = tp.tile_overlap(m)
    assert ov % 16 == 0 and ov >= m * 1.5
    assert ov <= tp.TILE_WIDTH - 256 or m > 2000


@pytest.mark.parametrize("lens", [(200,), (200, 450), (31, 32, 33)])
def test_splint_array_matches_tpu_backend(lens):
    rng = np.random.default_rng(len(lens))
    combos = []
    for k, n in enumerate(lens):
        codes = encode(sim.random_seq(rng, n))
        combos.append(Combo(f"S{k}", "+", codes, n))
        combos.append(Combo(f"S{k}", "-", revcomp_encoded(codes), n))
    got = splint_array(combos)
    want = TpuBackend()._splint_array(combos)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    t = to_device(got, torch.device("cpu"))
    assert t.dtype == torch.int8 and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), want)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_resolve_device_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")


def test_launch_counts_are_thread_safe():
    """run_pipeline calls locate and align from two threads: the launch
    counters must not lose increments."""
    import sys
    import threading

    from c3poa_tpu_torch.kernels import _build
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _build.reset_counts()

        def work():
            for _ in range(2000):
                _build.count("stress")

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert _build.launch_counts()["stress"] == 16 * 2000
    finally:
        sys.setswitchinterval(old)
        _build.reset_counts()
