// Lane arithmetic of the int16 probe (csrc/int16_probe.cu), written once
// for the device and the host: a g++ build of a host driver over this
// header holds it against the TPU probe's kernel in the CPU tests.  On
// the host the packed intrinsics are emulated, so that build checks the
// lanes, the byte selectors and the column mask, not the intrinsics.
//
// A row of 128 int16 columns sits in one warp: lane l holds columns
// 4l..4l+3 as two packed words, (4l, 4l+1) and (4l+2, 4l+3), the lower
// column in the low halfword.  roll(m, 3) gives column c the value of
// column c - 3 (mod 128): lane l's columns 4l..4l+3 take 4l-3..4l, i.e.
// the upper three columns of lane l-1 (lane 31 for lane 0: the roll
// wraps) and its own first column.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define I16P_HD __host__ __device__ __forceinline__
#else
#define I16P_HD inline
#endif

constexpr int I16P_SHIFT = 3;              // roll(., 3, axis=1)
// -16000 in both halfwords: the select's value for columns 0..2
constexpr uint32_t I16P_FILL2 = 0xC180C180u;
// __byte_perm selector of (x.hi, y.lo): bytes 2, 3 of x, then 4, 5
// (bytes 0, 1 of y)
constexpr uint32_t I16P_HI_LO = 0x5432u;

// the lane whose words lane ``lane`` rolls in
I16P_HD int i16p_src_lane(int lane) { return (lane + 31) & 31; }

// __byte_perm: byte n of the result is byte (s >> 4n) & 7 of {y, x}
I16P_HD uint32_t i16p_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
    return __byte_perm(x, y, s);
#else
    const uint64_t v = ((uint64_t)y << 32) | x;
    uint32_t r = 0;
    for (int n = 0; n < 4; ++n)
        r |= (uint32_t)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xffu) << (8 * n);
    return r;
#endif
}

// packed signed 16-bit max
I16P_HD uint32_t i16p_max(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    return __vmaxs2(a, b);
#else
    uint32_t r = 0;
    for (int h = 0; h < 2; ++h) {
        const int16_t x = (int16_t)(a >> (16 * h));
        const int16_t y = (int16_t)(b >> (16 * h));
        r |= (uint32_t)(uint16_t)(x > y ? x : y) << (16 * h);
    }
    return r;
#endif
}

// packed 16-bit + 1, wrapping (32767 + 1 = -32768, as jnp int16)
I16P_HD uint32_t i16p_add1(uint32_t a) {
#ifdef __CUDA_ARCH__
    return __vadd2(a, 0x00010001u);
#else
    const uint32_t lo = (a + 1u) & 0xffffu;
    const uint32_t hi = ((a >> 16) + 1u) & 0xffffu;
    return (hi << 16) | lo;
#endif
}

// the select of the word holding columns c0 and c0 + 1: a column below
// I16P_SHIFT takes -16000
I16P_HD uint32_t i16p_select(uint32_t w, int c0) {
    const uint32_t keep = (c0 >= I16P_SHIFT ? 0x0000ffffu : 0u) |
                          (c0 + 1 >= I16P_SHIFT ? 0xffff0000u : 0u);
    return (w & keep) | (I16P_FILL2 & ~keep);
}

// lane ``lane``'s two output words from the source lane's max words
// (p0, p1) and its own first max word o0
I16P_HD void i16p_lane(int lane, uint32_t p0, uint32_t p1, uint32_t o0,
                       uint32_t* r0, uint32_t* r1) {
    const uint32_t w0 = i16p_perm(p0, p1, I16P_HI_LO);   // columns 4l-3, 4l-2
    const uint32_t w1 = i16p_perm(p1, o0, I16P_HI_LO);   // columns 4l-1, 4l
    *r0 = i16p_add1(i16p_select(w0, 4 * lane));
    *r1 = i16p_add1(i16p_select(w1, 4 * lane + 2));
}
