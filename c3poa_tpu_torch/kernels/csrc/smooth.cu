// The locate step's smoothing: three passes of the 41-tap order-2
// Savitzky-Golay filter over each read's chosen-combo profile row, with
// the edge padding at the read's own length.
//
// Replaces the jitted XLA step c3poa_tpu/kernels/smooth.py:smooth3_batch
// (inside _locate_device_jit, c3poa_tpu/kernels/locate.py); plain twin
// c3poa_tpu_torch/kernels/smooth.py:smooth3_batch, which it equals bit
// for bit.  The function, the tile schedule and the proof that a tile
// sees every value it reads are in smooth.cuh.
//
// What bounds it on an H100: float32 issue.  Bit-identity forbids the
// FMA, so a column costs 3 x 41 FMUL and 3 x 41 FADD, 246 instructions
// on 128 FP32 lanes an SM; bytes are the int32 row in and the float32 row
// out, a tenth of that time at B = 128, L = 32768.
//
// Design: one block of 128 threads a (read, tile of SM_TILE = 944 output
// columns).  The block reads the chosen combo's int32 row straight from
// the (B, C, L) profile (no gather, no float copy in device memory), the
// tile and a 60-column halo each side, into shared memory as float; the
// three passes ping-pong between two shared buffers, each pass over 20
// columns fewer each side, so the widest pass (944 + 80 = 1024 columns)
// is one group of 8 columns a thread.  A thread loads its group's window
// of 48 values with twelve 16-byte shared loads into registers and runs
// the 41 taps over its 8 columns as 8 independent chains, so a tap is one
// FMUL and one FADD and nothing else.  The taps come from the host by
// value, as a kernel parameter: each FMUL reads its tap from the constant
// bank, which leaves the registers to the window and the sums: at most 85
// a thread, so 6 blocks (24 warps) fit an SM.
// The 40 pad positions a pass are filled by 40 threads between barriers.
// A tile at or past the read's end writes zeros and returns.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "smooth.cuh"

namespace {

constexpr int BUF = SM_TILE + 2 * SM_HALO + SM_R;
static_assert(SM_TILE % 16 == 0, "tile starts keep 16-byte alignment");
static_assert(BUF % 4 == 0, "the second buffer starts 16-byte aligned");
static_assert((SM_TAPS - 1 + SM_R) % 4 == 0, "a window is whole float4s");
static_assert(SM_TILE + 2 * (SM_HALO - SM_HALF) == SM_THREADS * SM_R,
              "the widest pass is one group a thread");

struct Taps {
    float m[SM_TAPS];
};

__global__ void __launch_bounds__(SM_THREADS, 6)
smooth3_kernel(const int32_t* __restrict__ prof,
               const int32_t* __restrict__ combo,
               const int32_t* __restrict__ lens,
               const __grid_constant__ Taps taps, float* __restrict__ out,
               int C, int L, int tiles) {
    __shared__ __align__(16) float buf[2][BUF];
    const int b = blockIdx.x / tiles;
    const int t0 = (blockIdx.x % tiles) * SM_TILE;
    const int tid = threadIdx.x;
    float* orow = out + (size_t)b * L;
    // the wrapper's callers keep 0 <= n <= L and 0 <= combo < C; clamped
    // so that no input can send a load or a store outside the tensors
    int n = lens[b];
    n = n < 0 ? 0 : (n > L ? L : n);
    if (t0 >= n) {
        const int end = t0 + SM_TILE < L ? t0 + SM_TILE : L;
        for (int j = t0 + tid; j < end; j += SM_THREADS)
            orow[j] = 0.0f;
        return;
    }
    int c = combo[b];
    c = c < 0 ? 0 : (c >= C ? C - 1 : c);
    const int32_t* row = prof + ((size_t)b * C + c) * L;
    const SmTile t{t0, SM_TILE, n, L};

    for (int i = tid; i < BUF; i += SM_THREADS)
        buf[0][i] = sm_load_value(t, row, i);
    __syncthreads();

#pragma unroll 1
    for (int k = 1; k <= SM_PASSES; ++k) {
        float* x = buf[(k - 1) & 1];
        float* y = buf[k & 1];
        int pos = 0;
        float val = 0.0f;
        const bool pad = tid < SM_PADS && sm_pad(t, k, x, tid, &pos, &val);
        __syncthreads();
        if (pad)
            x[pos] = val;
        __syncthreads();
        const int lo = t.lo(k), hi = t.hi(k);
        for (int g = tid; g < t.groups(k, SM_R); g += SM_THREADS) {
            const int j0 = lo + g * SM_R;
            float acc[SM_R];
            if (j0 >= n) {
#pragma unroll
                for (int r = 0; r < SM_R; ++r)
                    acc[r] = 0.0f;
            } else {
                float e[SM_TAPS - 1 + SM_R];
                const float4* w = reinterpret_cast<const float4*>(
                    x + t.idx(j0 - SM_HALF));
#pragma unroll
                for (int q = 0; q < (SM_TAPS - 1 + SM_R) / 4; ++q) {
                    const float4 v = w[q];
                    e[4 * q] = v.x;
                    e[4 * q + 1] = v.y;
                    e[4 * q + 2] = v.z;
                    e[4 * q + 3] = v.w;
                }
                sm_group<SM_R>(e, taps.m, j0, n, acc);
            }
            if (k < SM_PASSES) {
#pragma unroll
                for (int r = 0; r < SM_R; ++r)
                    if (j0 + r < hi)
                        y[t.idx(j0 + r)] = acc[r];
            } else if ((L & 3) == 0 && j0 + SM_R <= L) {
                float4* o = reinterpret_cast<float4*>(orow + j0);
#pragma unroll
                for (int q = 0; q < SM_R / 4; ++q)
                    o[q] = make_float4(acc[4 * q], acc[4 * q + 1],
                                       acc[4 * q + 2], acc[4 * q + 3]);
            } else {
#pragma unroll
                for (int r = 0; r < SM_R; ++r)
                    if (j0 + r < L)
                        orow[j0 + r] = acc[r];
            }
        }
        if (k < SM_PASSES)
            __syncthreads();
    }
}

}  // namespace

extern "C" {

const char* c3t_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// prof (B, C, L) int32, combo (B,) int32, lens (B,) int32 and out (B, L)
// float32, contiguous on the device, out 16-byte aligned; coeffs the 41
// float32 taps in host memory (copied into the launch); B > 0, L > 20.
// Launches on ``stream``.
int c3t_smooth3(const void* prof, const void* combo, const void* lens,
                const void* coeffs, void* out, int B, int C, int L,
                void* stream) {
    const int tiles = (L + SM_TILE - 1) / SM_TILE;
    Taps taps;
    memcpy(taps.m, coeffs, sizeof(taps.m));
    smooth3_kernel<<<B * tiles, SM_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)prof, (const int32_t*)combo, (const int32_t*)lens,
        taps, (float*)out, C, L, tiles);
    return (int)cudaGetLastError();
}

}  // extern "C"
