// The locate step's peak candidates: each read's median, its 6x-median
// gate and 3x-median height, the plateau-aware local maxima, a per-tile
// top-2 compaction, and the `deep` and `margin` flags.
//
// Replaces the jitted XLA step c3poa_tpu/kernels/peaks.py:112
// (peak_candidates_batch, inside _locate_device_jit,
// c3poa_tpu/kernels/locate.py); plain twin
// c3poa_tpu_torch/kernels/peaks.py:peak_candidates_batch, which it equals
// bit for bit on every output.  The function, its domain and the proofs
// are in peaks.cuh.
//
// What bounds it on an H100: bytes.  One read of the (B, L) float32 rows
// and the lengths and the outputs written once: 0.00532 ms at B = 128,
// L = 32768 (chip_smoke.py:smooth_peaks_row); the operations, a few a
// column and a few a column for each pass of the median, fall below that.
//
// Design: two kernels, launched in order on one stream.
// (a) pk_stats_kernel, one block of 1024 threads a read: the median by a
//     radix select over the order-preserving uint32 keys, PK_PASSES = 4
//     passes of 8-bit digits.  Each pass reads the read's n values (from
//     L2: the smoothing kernel has just written the 16 MB of rows of the
//     locate shape, and the L2 holds 50 MB), 8 loads in flight a thread,
//     and counts the digits of the keys in the group chosen so far in a
//     256-bin shared histogram, one atomic a value.  Warp 0 then scans the
//     bins and picks the digit of rank k.  When n is even the second rank,
//     k + 1, is in the last histogram or, when k's key ends its group, is
//     the least key above it (a fifth pass).  Pass 0 also takes xmax.
//     Thread 0 writes med, height, gated, the structure tolerance, the
//     gate half of `margin`, and deep = 0.
// (b) pk_cand_kernel, one block of 256 threads a (read, chunk of 2048
//     columns), 8 columns a thread; the chunk holds whole tiles (tile <= 64
//     divides 2048 and L).  It stages xm of the chunk, two columns before
//     it and one after in shared memory (a padding word every 8, so that
//     each thread loads its window of 11 into registers without a bank
//     conflict); where column c0 - 1 starts no run
//     it walks left in global memory for the latest run start before the
//     chunk (PkWalk).  A max-scan of the threads' latest starts (shuffles,
//     then the 8 warps' totals) gives each thread the run entering its
//     columns; each column's key goes into its tile's top three, a tile of
//     at most 8 columns is written by its thread, a wider one is merged
//     over its tile / 8 lanes of one warp (a shuffle butterfly).  Threads
//     that find a third entry or a margin store 1 into their read's `deep`
//     or `margin`: every store writes the same byte, so no order of the
//     threads or blocks changes the result.  A chunk past the read's last
//     possible peak (c0 > n - 2) writes empty slots and returns.
// So a row is read about five times, once from HBM at most.  No FFMA
// anywhere: every float operation goes through __fmul_rn / __fadd_rn /
// __fsub_rn (chip_smoke.py checks the SASS).
#include <cuda_runtime.h>
#include <stdint.h>

#include "peaks.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STATS_WARPS = PK_STATS_THREADS / 32;
constexpr int CAND_WARPS = PK_THREADS / 32;
constexpr int STATS_STEP = PK_STATS_THREADS * PK_STATS_LOADS;
static_assert(PK_BINS == 32 * 8, "warp 0 scans 8 bins a lane");
static_assert(PK_CHUNK % PK_MAX_TILE == 0, "a chunk holds whole tiles");
static_assert(PK_MAX_TILE / PK_COLS <= 32, "a tile's lanes are one warp's");
static_assert(PK_COLS == 8 && PK_WINDOW <= 16, "xs_at: one pad a window");
constexpr int STAGED = PK_CHUNK + PK_LEFT + 1;

// The staged chunk in shared memory with one padding word after every 8:
// a thread's window starts 8 columns after its left neighbour's, which
// puts the 32 lanes' loads of one v[k] on 32 banks (without the padding
// they would share 4).
__device__ __forceinline__ int xs_at(int p) { return p + (p >> 3); }

// Warp 0 after a pass: the bin of rank k into pick[0] and the count below
// it into pick[1]; with `two`, whether rank k + 1 lies in this histogram
// into pick[2] and its bin into pick[3].
__device__ void pick_bins(const uint32_t* hist, uint32_t k, bool two,
                          int* pick) {
    const int lane = threadIdx.x & 31;
    const uint32_t* h = hist + 8 * lane;
    uint32_t own = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
        own += h[i];
    uint32_t incl = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const uint32_t v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off)
            incl += v;
    }
    const uint32_t below = incl - own;
    int d;
    uint32_t below_d;
    if (pk_pick(h, 8, below, k, &d, &below_d)) {
        pick[0] = 8 * lane + d;
        pick[1] = (int)below_d;
    }
    if (two && pk_pick(h, 8, below, k + 1, &d, &below_d)) {
        pick[2] = 1;
        pick[3] = 8 * lane + d;
    }
}

__device__ float block_max(float v, float* scratch) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
    if (lane == 0)
        scratch[warp] = v;
    __syncthreads();
    v = scratch[0];
    for (int w = 1; w < STATS_WARPS; ++w)
        v = fmaxf(v, scratch[w]);
    return v;
}

__device__ uint32_t block_min(uint32_t v, uint32_t* scratch) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = min(v, __shfl_xor_sync(FULL, v, off));
    if (lane == 0)
        scratch[warp] = v;
    __syncthreads();
    v = scratch[0];
    for (int w = 1; w < STATS_WARPS; ++w)
        v = min(v, scratch[w]);
    return v;
}

__global__ void __launch_bounds__(PK_STATS_THREADS)
pk_stats_kernel(const float* __restrict__ sm,
                const int32_t* __restrict__ lens, float* __restrict__ med,
                float* __restrict__ height, uint8_t* __restrict__ gated,
                uint8_t* __restrict__ deep, uint8_t* __restrict__ margin,
                float* __restrict__ tol, int L) {
    __shared__ uint32_t hist[PK_BINS];
    __shared__ int pick[4];
    __shared__ float fscratch[STATS_WARPS];
    __shared__ uint32_t uscratch[STATS_WARPS];
    const int b = blockIdx.x, tid = threadIdx.x;
    const float* row = sm + (size_t)b * L;
    // the wrapper's callers keep 0 <= n <= L; clamped so that no input
    // can send a load outside the row
    int n = lens[b];
    n = n < 0 ? 0 : (n > L ? L : n);
    float xmax = pk_xmax_start(n, L);
    uint32_t klo = PK_EMPTY_KEY, khi = PK_EMPTY_KEY;
    if (n > 0) {
        uint32_t k = pk_rank_lo(n);
        const bool two = pk_rank_hi(n) != pk_rank_lo(n);
        uint32_t prefix = 0;
#pragma unroll 1
        for (int p = 0; p < PK_PASSES; ++p) {
            if (tid < PK_BINS)
                hist[tid] = 0;
            if (tid == 0)
                pick[2] = 0;
            __syncthreads();
            // a thread's PK_STATS_LOADS loads issued before any is used
            for (int base = 0; base < n; base += STATS_STEP) {
                float v[PK_STATS_LOADS];
#pragma unroll
                for (int u = 0; u < PK_STATS_LOADS; ++u) {
                    const int i = base + u * PK_STATS_THREADS + tid;
                    v[u] = i < n ? row[i] : 0.0f;
                }
#pragma unroll
                for (int u = 0; u < PK_STATS_LOADS; ++u) {
                    int digit = -1;
                    if (base + u * PK_STATS_THREADS + tid < n) {
                        if (p == 0)
                            xmax = fmaxf(xmax, v[u]);
                        const uint32_t key = pk_key(v[u]);
                        if (pk_in_group(key, prefix, p))
                            digit = pk_digit(key, p);
                    }
                    // one shared atomic a value (measured faster at the
                    // locate shape than one a distinct digit of a warp)
                    if (digit >= 0)
                        atomicAdd(&hist[digit], 1u);
                }
            }
            __syncthreads();
            if (tid < 32)
                pick_bins(hist, k, two && p == PK_PASSES - 1, pick);
            __syncthreads();
            prefix = (prefix << PK_DIGIT) | (uint32_t)pick[0];
            k -= (uint32_t)pick[1];
        }
        klo = khi = prefix;
        if (two) {
            if (pick[2]) {
                khi = ((prefix >> PK_DIGIT) << PK_DIGIT) | (uint32_t)pick[3];
            } else {
                uint32_t least = 0xffffffffu;
#pragma unroll PK_STATS_LOADS
                for (int i = tid; i < n; i += PK_STATS_THREADS) {
                    const uint32_t key = pk_key(row[i]);
                    if (key > klo && key < least)
                        least = key;
                }
                khi = block_min(least, uscratch);
            }
        }
    }
    xmax = block_max(xmax, fscratch);
    if (tid == 0) {
        const float m = pk_median(klo, khi);
        const PkGate g = pk_gate(xmax, m);
        med[b] = m;
        height[b] = g.height;
        gated[b] = g.gated;
        tol[b] = g.tol;
        margin[b] = g.near_gate;
        deep[b] = 0;
    }
}

__device__ __forceinline__ PkTop3 shfl_xor3(PkTop3 t, int off) {
    return PkTop3{__shfl_xor_sync(FULL, t.a, off),
                  __shfl_xor_sync(FULL, t.b, off),
                  __shfl_xor_sync(FULL, t.c, off)};
}

__global__ void __launch_bounds__(PK_THREADS)
pk_cand_kernel(const float* __restrict__ sm,
               const int32_t* __restrict__ lens,
               const float* __restrict__ height_in,
               const uint8_t* __restrict__ gated_in,
               const float* __restrict__ tol_in,
               int32_t* __restrict__ cand_pos, float* __restrict__ cand_h,
               uint8_t* __restrict__ deep, uint8_t* __restrict__ margin,
               int L, int tile, int chunks) {
    __shared__ float xs[STAGED + STAGED / 8 + 1];
    __shared__ int warp_run[CAND_WARPS];
    __shared__ int carry_s;
    const int b = blockIdx.x / chunks;
    const int c0 = (blockIdx.x % chunks) * PK_CHUNK;
    const int w = L - c0 < PK_CHUNK ? L - c0 : PK_CHUNK;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int M = L / tile;
    int32_t* pos = cand_pos + (size_t)b * 2 * M;
    float* hs = cand_h + (size_t)b * 2 * M;
    const float* row = sm + (size_t)b * L;
    int n = lens[b];
    n = n < 0 ? 0 : (n > L ? L : n);
    if (!pk_chunk_live(c0, n)) {
        const PkTop3 none{0, 0, 0};
        for (int m = c0 / tile + tid; m < (c0 + w) / tile; m += PK_THREADS)
            pk_write_tile(pos, hs, M, m, none);
        return;
    }
    const float height = height_in[b];
    const bool is_gated = gated_in[b] != 0;
    const float tl = tol_in[b];
    for (int i = tid; i < w + PK_LEFT + 1; i += PK_THREADS)
        xs[xs_at(i)] = pk_xm(row, c0 - PK_LEFT + i, n);
    __syncthreads();
    // the carry: start(c0 - 1) from the staged columns, else the walk
    int carry = c0 > 0 ? pk_start(c0 - 1, xs[xs_at(PK_LEFT - 1)],
                                  xs[xs_at(PK_LEFT - 2)])
                       : -1;
    if (carry < 0 && c0 > 1) {
        if (tid == 0)
            carry_s = -1;
        __syncthreads();
        PkWalk walk(c0 - 1);
        do {
            const int best =
                pk_latest_start(row, n, walk.lo, walk.hi, tid, PK_THREADS);
            if (best >= 0)
                atomicMax(&carry_s, best);
            if (__syncthreads_or(best >= 0))
                break;
        } while (walk.next());
        carry = carry_s;
    }

    // the latest run start before the thread's columns: the threads
    // before it in the chunk (a max-scan), and the carry
    const int i0 = tid * PK_COLS;
    float v[PK_WINDOW];
#pragma unroll
    for (int k = 0; k < PK_WINDOW; ++k)
        v[k] = xs[xs_at(i0 + k)];
    int incl = pk_thread_latest(v, c0 + i0, w - i0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off)
            incl = pk_latest(incl, v);
    }
    int run = __shfl_up_sync(FULL, incl, 1);
    if (lane == 31)
        warp_run[warp] = incl;
    __syncthreads();
    if (lane == 0)
        run = -1;
    run = pk_latest(run, carry);
    for (int q = 0; q < warp; ++q)
        run = pk_latest(run, warp_run[q]);

    const PkThread o = pk_thread(v, c0 + i0, w - i0, n, run, height,
                                 is_gated, tl, tile, M, pos, hs);
    bool third = o.third;
    if (tile > PK_COLS) {
        const int lanes = tile / PK_COLS;
        PkTop3 t = o.top;
        for (int off = 1; off < lanes; off <<= 1)
            t = pk_top3_merge(t, shfl_xor3(t, off));
        if (lane % lanes == 0 && i0 < w) {
            pk_write_tile(pos, hs, M, (c0 + i0) / tile, t);
            third = t.c != 0;
        }
    }
    // every store writes the same byte: no order of threads or blocks
    // changes the result
    if (third)
        deep[b] = 1;
    if (o.margin)
        margin[b] = 1;
}

}  // namespace

extern "C" {

const char* c3t_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// sm (B, L) float32 and lens (B,) int32, contiguous on the device;
// cand_pos (B, 2L/tile) int32, cand_h (B, 2L/tile) float32, med, height
// and tol (B,) float32, gated, deep and margin (B,) bytes (torch.bool);
// B > 0, L >= 1, tile a power of two <= 64 dividing L.  Launches both
// kernels on ``stream``, in order; refuses a grid of more than 2^31 - 1
// chunks.
int c3t_peak_candidates(const void* sm, const void* lens, void* cand_pos,
                        void* cand_h, void* med, void* height, void* gated,
                        void* deep, void* margin, void* tol, int B, int L,
                        int tile, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    pk_stats_kernel<<<B, PK_STATS_THREADS, 0, s>>>(
        (const float*)sm, (const int32_t*)lens, (float*)med, (float*)height,
        (uint8_t*)gated, (uint8_t*)deep, (uint8_t*)margin, (float*)tol, L);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess)
        return (int)err;
    const int chunks = (L + PK_CHUNK - 1) / PK_CHUNK;
    if ((long long)B * chunks > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    pk_cand_kernel<<<B * chunks, PK_THREADS, 0, s>>>(
        (const float*)sm, (const int32_t*)lens, (const float*)height,
        (const uint8_t*)gated, (const float*)tol, (int32_t*)cand_pos,
        (float*)cand_h, (uint8_t*)deep, (uint8_t*)margin, L, tile, chunks);
    return (int)cudaGetLastError();
}

}  // extern "C"
