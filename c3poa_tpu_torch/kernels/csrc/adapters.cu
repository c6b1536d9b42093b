// Adapter hits: end-anchored local alignment of every adapter combo
// (rows) against every consensus read (columns), carrying each path's
// read start and adapter start, reduced to the best hit and the best
// span-disjoint second hit.
//
// Replaces the jitted XLA kernel c3poa_tpu/kernels/adapters.py
// (adapter_hits_batch); spec c3poa_tpu/ref/sw.py:local_hits as
// c3poa_tpu/pipeline/backend.py:NumpyBackend.adapter_hits reduces it.
// Plain twin: c3poa_tpu_torch/kernels/adapters.py:adapter_hits_batch.
// Outputs are equal to the spec's (int32), with each combo run over its
// own adapter length and each read over its own length.  The cell and
// strip arithmetic lives in adapters.cuh.
//
// What bounds it on an H100: integer issue, not memory.  A postprocess
// group of 1000 reads of ~1.5 kb against 4 combos of 25 and 56 rows is
// ~2.4e8 cells at ~20 integer operations each; the reads are ~2 MB and
// the outputs 24 KB.  The serial chain is the adapter rows; the in-row
// gap run is the only dependency across columns.
//
// Design: one block of NT = 128 threads per (combo, read).  The read's
// columns go in tiles of NT * ADP_K = 1024, each thread holding 8
// consecutive columns of H, the packed (t_start, q_start) payload, the
// column maximum and its adapter row and payload in registers for all
// of the combo's rows.  Per row: the strip prefix in-thread, then the
// in-row run joined across the warp by five __shfl_up_sync steps on
// (A, payload) and across the four warps through one shared (A, payload)
// pair per warp (double-buffered by row parity: one __syncthreads per
// row).  The value at column j0-1 that a strip's diagonal needs is the
// strip's own carry-in of the previous row, so no neighbour exchange is
// needed.  A tile passes its last column of every row to the next tile
// through shared memory (m pairs).  Tiles stop at the read's end.  The
// epilogue reduces each thread's best column to (s1, j1) by shuffles and
// shared memory, and then s2 from the per-column (colmax, t_start) each
// tile left in a global scratch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "adapters.cuh"

namespace {

constexpr int NT = 128;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int TW = NT * ADP_K;     // tile width
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(NT)
adapter_hits_kernel(const int8_t* __restrict__ reads,
                    const int32_t* __restrict__ lens,
                    const int8_t* __restrict__ adapters,
                    const int32_t* __restrict__ alens,
                    int2* __restrict__ scratch,
                    int32_t* __restrict__ out,
                    int B, int L, int C, int m,
                    int match, int mismatch, int gap, int tol) {
    extern __shared__ int32_t smem[];
    int32_t* bA = smem;                          // tile boundary, per row
    uint32_t* bP = reinterpret_cast<uint32_t*>(smem + m);
    int8_t* qrow = reinterpret_cast<int8_t*>(smem + 2 * m);
    __shared__ int32_t wA[2][NW];
    __shared__ uint32_t wP[2][NW];
    __shared__ int32_t rS[NW], rJ[NW], rQ[NW];
    __shared__ uint32_t rP[NW];

    const int c = blockIdx.x, b = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int len = lens[b], mc = alens[c];
    const int8_t* rrow = reads + (size_t)b * L;
    int2* scr = scratch + ((size_t)b * C + c) * L;

    for (int i = tid; i < mc; i += NT) {
        qrow[i] = adapters[(size_t)c * m + i];
        // column -1: H = 0, i.e. A = -gap
        bA[i] = -gap;
        bP[i] = 0;
    }
    __syncthreads();

    // this thread's best column so far: score, column, adapter end,
    // payload (first column on ties: columns come in increasing order)
    int32_t bs = -1, bj = 0, bq = 0;
    uint32_t bp = 0;
    int par = 0;

    for (int t0 = 0; t0 < len; t0 += TW) {
        const int j0 = t0 + tid * ADP_K;
        int rc[ADP_K];
        if (j0 < L) {   // L % 8 == 0, so the strip is inside the row
            const int2 v = *reinterpret_cast<const int2*>(rrow + j0);
            #pragma unroll
            for (int k = 0; k < ADP_K; ++k)
                rc[k] = (int8_t)(((k < 4 ? v.x : v.y) >> (8 * (k & 3)))
                                 & 0xff);
        } else {
            #pragma unroll
            for (int k = 0; k < ADP_K; ++k) rc[k] = 4;
        }
        int32_t H[ADP_K], cm[ADP_K], qe[ADP_K];
        uint32_t P[ADP_K], cp[ADP_K];
        #pragma unroll
        for (int k = 0; k < ADP_K; ++k) {
            // the row before the first: H = 0, t_start = j + 1
            H[k] = 0; P[k] = adp_pack(j0 + k + 1, 0);
            cm[k] = 0; qe[k] = 0; cp[k] = 0;
        }
        int32_t hl = 0;      // previous row's H at column j0 - 1
        uint32_t pl = 0;

        for (int i = 0; i < mc; ++i) {
            int32_t cA = bA[i];              // row i at column t0 - 1
            uint32_t cP = bP[i];
            int32_t A[ADP_K];
            uint32_t Q[ADP_K];
            adp_strip_prefix(rc, qrow[i], j0, i, match, mismatch, gap, hl,
                             pl, H, P, A, Q);
            // inclusive scan of the strips' totals over the warp
            int32_t sA = A[ADP_K - 1];
            uint32_t sP = Q[ADP_K - 1];
            #pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int32_t oA = __shfl_up_sync(FULL, sA, d);
                const uint32_t oP = __shfl_up_sync(FULL, sP, d);
                if (lane >= d) adp_join(oA, oP, &sA, &sP);
            }
            int32_t eA = __shfl_up_sync(FULL, sA, 1);
            uint32_t eP = __shfl_up_sync(FULL, sP, 1);
            if (lane == 31) { wA[par][warp] = sA; wP[par][warp] = sP; }
            __syncthreads();
            // carry-in: the tile's left boundary, then the earlier warps,
            // then the earlier lanes of this warp
            for (int w = 0; w < warp; ++w) {
                int32_t a = wA[par][w];
                uint32_t p = wP[par][w];
                adp_join(cA, cP, &a, &p);
                cA = a; cP = p;
            }
            if (lane > 0) {
                adp_join(cA, cP, &eA, &eP);
                cA = eA; cP = eP;
            }
            adp_strip_finish(cA, cP, j0, i, gap, len, A, Q, H, P, cm, qe, cp);
            hl = cA - gap * (j0 - 1);
            pl = cP;
            if (tid == NT - 1) {
                bA[i] = A[ADP_K - 1];
                bP[i] = Q[ADP_K - 1];
            }
            par ^= 1;
        }

        #pragma unroll
        for (int k = 0; k < ADP_K; ++k) {
            const int j = j0 + k;
            if (j < len) {
                scr[j] = make_int2(cm[k], adp_ts(cp[k]));
                if (cm[k] > bs) { bs = cm[k]; bj = j; bq = qe[k]; bp = cp[k]; }
            }
        }
    }

    // best hit over the block: the higher score, then the earlier column
    #pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        const int32_t os = __shfl_down_sync(FULL, bs, d);
        const int32_t oj = __shfl_down_sync(FULL, bj, d);
        const int32_t oq = __shfl_down_sync(FULL, bq, d);
        const uint32_t op = __shfl_down_sync(FULL, bp, d);
        if (adp_better(os, oj, bs, bj)) { bs = os; bj = oj; bq = oq; bp = op; }
    }
    if (lane == 0) { rS[warp] = bs; rJ[warp] = bj; rQ[warp] = bq; rP[warp] = bp; }
    __syncthreads();   // also makes the scratch columns visible
    bs = rS[0]; bj = rJ[0]; bq = rQ[0]; bp = rP[0];
    for (int w = 1; w < NW; ++w)
        if (adp_better(rS[w], rJ[w], bs, bj)) {
            bs = rS[w]; bj = rJ[w]; bq = rQ[w]; bp = rP[w];
        }
    // an empty read: no column, the zeros of the plain version
    if (bs < 0) { bs = 0; bj = 0; bq = 0; bp = 0; }
    const int32_t ts1 = adp_ts(bp);

    int32_t s2 = ADP_NEG;
    for (int j = tid; j < len; j += NT) {
        const int2 v = scr[j];
        s2 = max(s2, adp_second(v.x, v.y, j, bj, ts1, tol));
    }
    #pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        s2 = max(s2, __shfl_down_sync(FULL, s2, d));
    __syncthreads();   // every thread has read rS before it is reused
    if (lane == 0) rS[warp] = s2;
    __syncthreads();
    if (tid == 0) {
        for (int w = 1; w < NW; ++w) s2 = max(s2, rS[w]);
        const size_t o = (size_t)b * C + c, BC = (size_t)B * C;
        out[o] = bs;
        out[BC + o] = bj;
        out[2 * BC + o] = bq;
        out[3 * BC + o] = ts1;
        out[4 * BC + o] = adp_qs(bp);
        out[5 * BC + o] = s2;
    }
}

}  // namespace

extern "C" {

const char* c3t_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// reads (B, L) int8 with L % 8 == 0, lens (B,) int32, adapters (C, m)
// int8, alens (C,) int32, scratch (B, C, L) int2, out (6, B, C) int32;
// all contiguous on the device.  Launches on ``stream``.
int c3t_adapter_hits(const void* reads, const void* lens,
                     const void* adapters, const void* alens, void* scratch,
                     void* out, int B, int L, int C, int m, int match,
                     int mismatch, int gap, int tol, void* stream) {
    const dim3 grid(C, B);
    const size_t shmem = (size_t)m * 2 * sizeof(int32_t) + m;
    adapter_hits_kernel<<<grid, NT, shmem, (cudaStream_t)stream>>>(
        (const int8_t*)reads, (const int32_t*)lens, (const int8_t*)adapters,
        (const int32_t*)alens, (int2*)scratch, (int32_t*)out, B, L, C, m,
        match, mismatch, gap, tol);
    return (int)cudaGetLastError();
}

}  // extern "C"
