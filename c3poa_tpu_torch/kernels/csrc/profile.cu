// Splint score profile: start-anchored local alignment of every splint
// combo against every read, reduced to a column max.
//
// Replaces the TPU kernel c3poa_tpu/kernels/pallas_profile.py
// (start_profile_pallas, body _kernel); XLA twin
// c3poa_tpu/kernels/sw_profile.py:start_profile_batch; spec
// c3poa_tpu/ref/sw.py:start_profile.  Output is bit-identical (int32).
// The row arithmetic, which instruction goes to which pipe, and the proof
// of the warps' wavefront are in profile.cuh, which a g++ driver runs in
// the CPU tests.
//
// What bounds it on an H100: integer issue, not memory.  A launch of
// B = 128 reads x C = 2 combos x L = 32 k columns x m = 224 rows is
// ~1.9 G cells against 34 MB of output; the fewest Hopper instructions a
// cell are 5.5 (an IDP for the diagonal and its score, a DPX add-max with
// the floor, an IMAD and half a VIMNMX3 for the thread's total, the gap
// run's add-max, the column max), 3.5 of them on the 16-lane ALU pipe.
// The serial chain is the m rows; the in-row gap run is the only
// cross-column dependency.
//
// Design: tiles of TW = 4096 columns are independent (the Pallas
// kernel's overlapping-tile argument): a local alignment of an m-char
// splint spans at most m * (1 + match / gap) columns, so a tile whose
// last OV >= that columns are only read (not written) computes its core
// [0, TW - OV) exactly with a zero right boundary.  One block of 256
// threads per (tile, combo, read); each thread keeps 16 consecutive
// columns of G, of the column max and of the read's one-hot codes in
// registers for all m rows, so the DP touches only shared memory after
// the first load: a row's table word, one slot read and one written a
// warp.  The row's gap run crosses threads by a total a thread, five
// shuffles across the warp, and across the 8 warps as a wavefront: warp w
// waits only for warp w + 1's slot of the same row, never for a block
// barrier.  The rows of the splint's trailing pad are skipped (they leave
// G = 0).  Tiles that start past a read's end are exact zeros and only
// write them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "profile.cuh"

namespace {

constexpr int NT = PF_THREADS;
constexpr int K = PF_K;
constexpr int TW = PF_TW;
constexpr int NW = PF_WARPS;
constexpr unsigned FULL = 0xffffffffu;

// v read back from this thread's word of shared memory: a value the
// compiler cannot recompute, so it stays in a register across the row
// loop (left to itself, nvcc rebuilds the one-hot codes, spans and lane
// mask from the loaded words, the thread index and the parameters every
// row: 235 instructions a row with an S2R, against 120)
__device__ __forceinline__ int32_t kept(volatile int32_t* word, int32_t v) {
    *word = v;
    return *word;
}

__global__ void __launch_bounds__(NT, 2)
profile_kernel(const int8_t* __restrict__ reads,
               const int32_t* __restrict__ lens,
               const int8_t* __restrict__ splints,
               int32_t* __restrict__ out,
               int L, int C, int m, int core,
               int match, int mismatch, int gap) {
    // m + 1 row tables (row t: splint row m - 1 - t), m rows of slots, a
    // word a thread and the first row of a real code (pf_smem_bytes)
    extern __shared__ uint32_t smem[];
    uint32_t* tab = smem;
    volatile int32_t* cum = reinterpret_cast<volatile int32_t*>(smem + m + 1);
    int32_t* keep = reinterpret_cast<int32_t*>(smem + pf_keep_word(m));
    int& first = *reinterpret_cast<int*>(keep + NT);

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

    if (tid == 0) first = m;
    __syncthreads();
    int my_first = m;
    for (int t = tid; t <= m; t += NT) {
        const int qc = t < m ? splints[(size_t)c * m + m - 1 - t] : 4;
        tab[t] = pf_sub_table(qc, match, mismatch);
        if (pf_real_code(qc)) my_first = min(my_first, t);
    }
    my_first = __reduce_min_sync(FULL, my_first);
    if (lane == 0 && my_first < m) atomicMin(&first, my_first);
    for (int t = tid; t < m; t += NT) {
        #pragma unroll
        for (int w = 0; w < NW; ++w) cum[pf_slot(t, w)] = PF_EMPTY;
        cum[pf_slot(t, NW)] = 0;
    }

    // this thread's 16 read codes as one-hot bytes (pad 4 past L); L % 16
    // == 0 and col0 + jl0 % 16 == 0, so one aligned 16-byte load or none
    volatile int32_t* word = keep + tid;
    uint32_t hot[K];
    {
        const int j = col0 + jl0;
        int4 v = make_int4(0x04040404, 0x04040404, 0x04040404, 0x04040404);
        if (j < L)
            v = *reinterpret_cast<const int4*>(reads + (size_t)b * L + j);
        const int w[4] = {v.x, v.y, v.z, v.w};
        #pragma unroll
        for (int k = 0; k < K; ++k)
            hot[k] = (uint32_t)kept(
                word, (int32_t)pf_hot((w[k >> 2] >> (8 * (k & 3))) & 0xff));
    }

    // the row below the splint: G = 0
    int32_t G[K], cm[K];
    #pragma unroll
    for (int k = 0; k < K; ++k) { G[k] = 0; cm[k] = 0; }
    int32_t right = 0;
    const int32_t ngap = kept(word, -gap);
    int32_t span[5];                         // the scan's steps, d = 2^n
    #pragma unroll
    for (int n = 0; n < 5; ++n) span[n] = kept(word, pf_span(1 << n, gap));
    const int32_t dist = kept(word, pf_span(31 - lane, gap));
    const int32_t lane_mask = kept(word, pf_lane_mask(lane));
    const int32_t warp_span = kept(word, pf_span(32, gap));
    const bool publisher = kept(word, lane) == 0;
    __syncthreads();

    const int t0 = first;
    const uint32_t* tabp = tab + t0;
    volatile int32_t* src = cum + pf_slot(t0, pf_source(warp));
    volatile int32_t* dst = cum + pf_slot(t0, warp);
    uint32_t tabt = tabp[0];
    for (int t = t0; t < m; ++t) {
        const uint32_t tabn = *++tabp;
        int32_t Y[K];
        pf_cells<K>(G, right, tabt, hot, ngap, Y);

        // inclusive suffix max over the warp's lanes
        int32_t s = pf_total(Y);
        #pragma unroll
        for (int n = 0; n < 5; ++n)
            s = pf_scan(s, __shfl_down_sync(FULL, s, 1 << n), span[n]);
        const int32_t ex = __shfl_down_sync(FULL, s, 1);

        // what lies right of this warp: its right neighbour's slot
        int32_t carry;
        do {
            carry = *src;
        } while (carry == PF_EMPTY);
        if (publisher) *dst = pf_publish(s, carry, warp_span);
        src += PF_CUM_STRIDE;
        dst += PF_CUM_STRIDE;

        // G at the next thread's first column: what this thread's gap run
        // starts from, and the next row's right neighbour of its last
        // column
        right = pf_cin(ex, lane_mask, carry, dist);
        pf_finish<K>(G, right, ngap, cm);
        tabt = tabn;
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
// overlap (multiple of 16, < TW); match and mismatch signed bytes and
// 0 <= gap <= 2^16 (else cudaErrorInvalidValue).  Launches on ``stream``.
int c3t_start_profile(const void* reads, const void* lens,
                      const void* splints, void* out,
                      int B, int L, int C, int m, int ov,
                      int match, int mismatch, int gap, void* stream) {
    if (!pf_scoring_fits(match, mismatch, gap))
        return (int)cudaErrorInvalidValue;
    const int core = TW - ov;
    const dim3 grid((L + core - 1) / core, C, B);
    const unsigned smem = pf_smem_bytes(m);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            profile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    profile_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
        (const int8_t*)reads, (const int32_t*)lens, (const int8_t*)splints,
        (int32_t*)out, L, C, m, core, match, mismatch, gap);
    return (int)cudaGetLastError();
}

}  // extern "C"
