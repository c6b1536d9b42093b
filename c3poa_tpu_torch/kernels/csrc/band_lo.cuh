// Band placement lo(i) of the banded aligner, shared by the forward
// kernel and the walk in banded.cu, and by the g++ host driver of the CPU
// tests.
//
// It must equal, bit for bit, its host twins: band_lo_fn / band_starts_np
// in c3poa_tpu/kernels/banded.py, band_lo in native/traceback.c, and
// band_lo in c3poa_tpu_torch/kernels/banded.py:
//
//   lo(i) = clip(round_half_even(f32(min(i, ql)) * f32(tl) / f32(max(ql, 1)))
//                - W/2, 0, max(tl + 1 - W, 0))
//
// Every step is an IEEE float32 operation with round-to-nearest-even:
// __fmul_rn and __fdiv_rn cannot be contracted into an FMA or replaced by
// an approximate division, and rintf rounds halves to even (roundf would
// round them away from zero).  Never build with --use_fast_math.  A one-
// ulp slip moves the band by a column and desynchronises the forward
// pass's moves from the walk that reads them.  On the host the same steps
// are plain float operations: build with -ffp-contract=off, never
// -ffast-math, in the default rounding mode.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define BAND_LO_HD __host__ __device__ __forceinline__
#else
#define BAND_LO_HD inline
#endif

BAND_LO_HD int32_t band_lo(int32_t i, int32_t ql, int32_t tl, int32_t W) {
    const int32_t ie = i < ql ? i : ql;
#ifdef __CUDA_ARCH__
    const float num = __fmul_rn(__int2float_rn(ie), __int2float_rn(tl));
    const float x = __fdiv_rn(num, __int2float_rn(ql > 1 ? ql : 1));
#else
    volatile float num = (float)ie * (float)tl;
    const float x = num / (float)(ql > 1 ? ql : 1);
#endif
    const int32_t ctr = (int32_t)rintf(x);
    int32_t hi = tl + 1 - W;
    if (hi < 0) hi = 0;
    int32_t lo = ctr - W / 2;
    if (lo < 0) lo = 0;
    if (lo > hi) lo = hi;
    return lo;
}
