// Splint score profile: start-anchored local alignment of every splint
// combo against every read, reduced to a column max.
//
// Replaces the TPU kernel c3poa_tpu/kernels/pallas_profile.py
// (start_profile_pallas, body _kernel); XLA twin
// c3poa_tpu/kernels/sw_profile.py:start_profile_batch; spec
// c3poa_tpu/ref/sw.py:start_profile.  Output is bit-identical (int32).
//
// Recurrence, splint rows i = m-1 .. 0 (pad rows, code 4, leave G at 0):
//   T[j]    = max(0, G[i+1][j+1] + s(i, j), G[i+1][j] - gap)
//   G[i][j] = max_{k >= j} (T[k] - gap * (k - j))      (in-row gap runs)
//   out[j]  = max_i G[i][j]
// with s = +match / mismatch, and 0 wherever either char is 4 (N / pad).
//
// What bounds it on an H100: integer issue, not memory.  A launch of
// B = 128 reads x C = 2 combos x L = 32 k columns x m = 224 rows is
// ~1.9 G cells, ~10 integer ops each, against 34 MB of output.  The
// serial chain is the m rows; the in-row reverse running max is the
// only cross-column dependency.
//
// Design: tiles of TW = 4096 columns are independent (the Pallas
// kernel's overlapping-tile argument): a local alignment of an m-char
// splint spans at most m * (1 + match / gap) columns, so a tile whose
// last OV >= that columns are only read (not written) computes its core
// [0, TW - OV) exactly with a zero right boundary.  One block of 256
// threads per (tile, combo, read); each thread keeps 16 consecutive
// columns of G, of the column max and of the read in registers for all
// m rows, so the DP never touches memory after the first load.  Per row:
// T with one DPX __vimax3_s32 per column, the reverse running max
// in-thread, then across the warp with five __shfl_down_sync steps and
// across the 8 warps through 8 words of shared memory: one
// __syncthreads per row (the warp totals are double-buffered by row
// parity).  The neighbour value G[i+1][j+1] of a thread's last column
// comes from the next lane by shuffle, or, at a warp edge, from the
// warp-suffix carry it already holds.  Tiles that start past a read's
// end are exact zeros and only write them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int K = 16;          // consecutive columns per thread
constexpr int TW = NT * K;     // tile width, core + overlap
constexpr int NW = NT / 32;    // warps per block
constexpr int32_t NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(NT)
profile_kernel(const int8_t* __restrict__ reads,
               const int32_t* __restrict__ lens,
               const int8_t* __restrict__ splints,
               int32_t* __restrict__ out,
               int L, int C, int m, int core,
               int match, int mismatch, int gap) {
    extern __shared__ int8_t sp[];           // this combo's m splint chars
    __shared__ int32_t wtot[2][NW];          // warp suffix totals, by parity

    const int tile = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int col0 = tile * core;            // global column of local 0
    const int jl0 = tid * K;                 // this thread's first local col
    int32_t* orow = out + ((size_t)b * C + c) * (size_t)L;

    if (col0 >= lens[b]) {
        // past the read's end: pad chars score 0 and local scores clamp
        // at 0, so the profile there is exactly 0
        #pragma unroll
        for (int k = 0; k < K; k += 4) {
            const int jl = jl0 + k, j = col0 + jl;
            if (jl < core && j < L)
                *reinterpret_cast<int4*>(orow + j) = make_int4(0, 0, 0, 0);
        }
        return;
    }

    for (int i = tid; i < m; i += NT) sp[i] = splints[(size_t)c * m + i];

    // this thread's 16 read chars (pad 4 past L); L % 16 == 0 and
    // col0 + jl0 % 16 == 0, so one aligned 16-byte load or none
    int rc[K];
    {
        const int j = col0 + jl0;
        if (j < L) {
            const int4 v = *reinterpret_cast<const int4*>(
                reads + (size_t)b * L + j);
            const int w[4] = {v.x, v.y, v.z, v.w};
            #pragma unroll
            for (int k = 0; k < K; ++k)
                rc[k] = (int8_t)((w[k >> 2] >> (8 * (k & 3))) & 0xff);
        } else {
            #pragma unroll
            for (int k = 0; k < K; ++k) rc[k] = 4;
        }
    }

    int32_t G[K], cm[K];
    #pragma unroll
    for (int k = 0; k < K; ++k) { G[k] = 0; cm[k] = 0; }
    int32_t gnext = 0;   // previous row's G at local column jl0 + K
    __syncthreads();

    for (int t = 0; t < m; ++t) {
        const int sc = sp[m - 1 - t];
        int32_t A[K];
        #pragma unroll
        for (int k = 0; k < K; ++k) {
            const int32_t gn = (k + 1 < K) ? G[k + 1] : gnext;
            const int32_t s = (sc == 4 || rc[k] == 4)
                ? 0 : (sc == rc[k] ? match : mismatch);
            const int32_t T = __vimax3_s32(gn + s, G[k] - gap, 0);
            A[k] = T - gap * (jl0 + k);
        }
        #pragma unroll
        for (int k = K - 2; k >= 0; --k) A[k] = max(A[k], A[k + 1]);

        // inclusive suffix max over the warp's lanes
        int32_t s = A[0];
        #pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int32_t o = __shfl_down_sync(FULL, s, d);
            if (lane + d < 32) s = max(s, o);
        }
        int32_t ex = __shfl_down_sync(FULL, s, 1);
        if (lane == 31) ex = NEG;
        const int par = t & 1;
        if (lane == 0) wtot[par][warp] = s;
        __syncthreads();
        int32_t carry = NEG;   // max over all columns of later warps
        #pragma unroll
        for (int w = 0; w < NW; ++w)
            if (w > warp) carry = max(carry, wtot[par][w]);
        const int32_t cin = max(ex, carry);

        #pragma unroll
        for (int k = 0; k < K; ++k) {
            G[k] = max(A[k], cin) + gap * (jl0 + k);
            cm[k] = max(cm[k], G[k]);
        }
        // G at column jl0 + K for the next row: the next lane's first
        // column, or across a warp edge max_{k >= jl0+K} A[k] + gap*(jl0+K)
        // = carry + gap*(jl0+K); zero past the tile's right end
        const int32_t nb = __shfl_down_sync(FULL, G[0], 1);
        gnext = (lane < 31) ? nb
              : (warp < NW - 1 ? carry + gap * (jl0 + K) : 0);
    }

    #pragma unroll
    for (int k = 0; k < K; k += 4) {
        const int jl = jl0 + k, j = col0 + jl;
        if (jl < core && j < L)
            *reinterpret_cast<int4*>(orow + j) =
                make_int4(cm[k], cm[k + 1], cm[k + 2], cm[k + 3]);
    }
}

}  // namespace

extern "C" {

const char* c3t_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int c3t_tile_width() { return TW; }

// reads (B, L) int8, lens (B,) int32, splints (C, m) int8, out (B, C, L)
// int32; all contiguous on the device.  L % 16 == 0; ov = the tile
// overlap (multiple of 16, < TW).  Launches on ``stream``.
int c3t_start_profile(const void* reads, const void* lens,
                      const void* splints, void* out,
                      int B, int L, int C, int m, int ov,
                      int match, int mismatch, int gap, void* stream) {
    const int core = TW - ov;
    const dim3 grid((L + core - 1) / core, C, B);
    profile_kernel<<<grid, NT, m, (cudaStream_t)stream>>>(
        (const int8_t*)reads, (const int32_t*)lens, (const int8_t*)splints,
        (int32_t*)out, L, C, m, core, match, mismatch, gap);
    return (int)cudaGetLastError();
}

}  // extern "C"
