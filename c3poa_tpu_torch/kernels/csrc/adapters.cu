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
// lane arithmetic lives in adapters.cuh.
//
// What bounds it on an H100: integer issue on the ALU pipe (64 lanes an
// SM a clock), not memory.  A postprocess group of 1000 reads of ~1.6 kb
// against 4 combos of 25 and 56 rows is ~2.6e8 cells; the reads are ~2 MB
// and the outputs 96 KB.  Each row's in-row gap run is a serial chain
// along the read.
//
// Design: one warp a (read, combo), a wavefront.  Lane l owns R adapter
// rows (R = 1 for a combo of at most 32 rows, else 2) and at step s
// computes them at column s - l: the row above comes from lane l - 1 by
// __shfl_up_sync, the row's left cell is the lane's own register.  No
// scan, no barrier, no column past the read: a warp stops after len +
// lanes - 1 steps.  The combo's last lane finishes one column a step and
// writes one word for it to a scratch row, which the warp reads back for
// the best and the span-disjoint second hit.  A block is one read's
// combos, one warp each; the warps read the read's codes through L1, each
// lane one byte a step, fetched a step ahead (a read of up to 2^18 columns
// does not fit in shared memory).  At most 64 registers, so 8 blocks fit
// an SM and a group of 1000 reads runs in one wave.
//
// Two paths, chosen per read from its length, the adapter width and the
// scoring (adpk_fits), so a long read takes the general path alone:
// - packed (reads <= 4095 columns, combos <= 63 rows: the postprocess
//   run's): a cell and its payload in one word, with the tie order in two
//   rank bits, so each max-with-winner is one max; two words a step go
//   down the lanes (the row's cell, the column's key), and the key is the
//   scratch word;
// - general (any read the wrapper takes, combos of up to 4096 rows): H
//   and the payload in two words, each max with a compare and selects;
//   four words a step go down the lanes; the last lane keeps the best hit
//   as a running scalar; a combo longer than 64 rows runs in passes of 64,
//   each handing its last row and every column's maximum to the next
//   through a carry row.
#include <cuda_runtime.h>
#include <stdint.h>

#include "adapters.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 32;
// warps a block at most; a block takes one read
constexpr int MAX_WARPS = 8;

__device__ __forceinline__ AdpFlow shfl_up(AdpFlow f) {
    return AdpFlow{__shfl_up_sync(FULL, f.hg, 1),
                   __shfl_up_sync(FULL, f.p, 1),
                   __shfl_up_sync(FULL, f.key, 1),
                   __shfl_up_sync(FULL, f.kp, 1)};
}

__device__ __forceinline__ int code_at(const int8_t* rrow, int len, int j) {
    return (unsigned)j < (unsigned)len ? (int)__ldg(rrow + j) : 4;
}

// One pass of a combo's rows first_row .. over the whole read.  CARRY:
// the rows above come from the carry row of the pass before.  FINAL: the
// last lane finishes the columns (scratch word and best hit), else it
// fills the carry row for the next pass.
template <int R, bool CARRY, bool FINAL>
__device__ void sweep_pass(const int8_t* __restrict__ rrow, int len,
                           const int8_t* __restrict__ q, int mc,
                           int first_row, int match, int mismatch, int gap,
                           int4* __restrict__ carry,
                           uint32_t* __restrict__ scr, int32_t& bs,
                           int32_t& bj, int32_t& bk, uint32_t& bp) {
    const int lane = threadIdx.x & (LANES - 1);
    const int rows = min(LANES * R, mc - first_row);
    const int last = (rows + R - 1) / R - 1;
    AdpLane<R> st;
    adp_lane_init<R>(st, q, mc, first_row + lane * R, match, mismatch, gap);
    // column -1: the lane's last row passes down H = 0; the row above
    // the pass holds H = 0 there too
    AdpFlow out = adp_edge(first_row + lane * R + R - 1, gap);
    int32_t dhg = -gap;
    uint32_t dp = adp_edge(first_row - 1, gap).p;
    int code = code_at(rrow, len, -lane);
    const int8_t* next = rrow + 1 - lane;   // column j + 1
    int4 nxt = make_int4(0, 0, 0, 0);
    if (CARRY && lane == 0 && len > 0) nxt = carry[0];
    const int steps = len + last;
    for (int s = 0; s < steps; ++s) {
        const int j = s - lane;
        AdpFlow up = shfl_up(out);
        // lane 0: the row above the pass, at column j = s
        AdpFlow top = adp_top(j, gap);
        if (CARRY && j < len)
            top = AdpFlow{nxt.x, (uint32_t)nxt.y, nxt.z, (uint32_t)nxt.w};
        if (lane == 0) up = top;
        if (CARRY && lane == 0 && j + 1 < len) nxt = carry[j + 1];
        const int c = code;
        code = (unsigned)(j + 1) < (unsigned)len ? (int)__ldg(next) : 4;
        ++next;
        out = adp_lane_step<R>(st, c, j, dhg, dp, up, gap);
        dhg = up.hg;
        dp = up.p;
        const bool done = lane == last && j >= 0;
        if (FINAL) {
            if (done) scr[j] = adp_word(out.key, out.kp);
            const int32_t cm = adp_colmax(out.key);
            const bool better = done && cm > bs;
            bs = better ? cm : bs;
            bj = better ? j : bj;
            bk = better ? out.key : bk;
            bp = better ? out.kp : bp;
        } else if (done) {
            carry[j] = make_int4(out.hg, (int)out.p, out.key, (int)out.kp);
        }
    }
    // the carry row and the scratch row are read by other lanes next
    __syncwarp();
    if (FINAL) {
        bs = __shfl_sync(FULL, bs, last);
        bj = __shfl_sync(FULL, bj, last);
        bk = __shfl_sync(FULL, bk, last);
        bp = __shfl_sync(FULL, bp, last);
    }
}

// The packed path (adapters.cuh): one pass, every cell one word; the last
// lane writes each finished column's key to the scratch row.
template <int R>
__device__ void packed_sweep(const int8_t* __restrict__ rrow, int len,
                             const int8_t* __restrict__ q, int mc, int match,
                             int mismatch, int gap,
                             uint32_t* __restrict__ scr) {
    const int lane = threadIdx.x & (LANES - 1);
    const int last = (mc + R - 1) / R - 1;
    AdpkLane<R> st;
    adpk_lane_init<R>(st, q, mc, lane * R, match, mismatch, gap);
    AdpkFlow out = adpk_edge(lane * R + R - 1, gap);
    int32_t dup = adpk_edge(-1, gap).up;
    int code = code_at(rrow, len, -lane);
    // running pointers: the code of column j + 1, the scratch word of the
    // column the last lane finishes (s - last)
    const uint8_t* next = reinterpret_cast<const uint8_t*>(rrow) + 1 - lane;
    uint32_t* done = scr - last;
    AdpkFlow top = adpk_top(0, gap);
    const int steps = len + last;
    for (int s = 0; s < steps; ++s, ++next, ++done) {
        const int j = s - lane;
        AdpkFlow up{__shfl_up_sync(FULL, out.up, 1),
                    __shfl_up_sync(FULL, out.key, 1)};
        if (lane == 0) up = top;
        top.up += 1 << ADPK_TS;
        const int c = code;
        code = (unsigned)(j + 1) < (unsigned)len ? (int)__ldg(next) : 4;
        out = adpk_lane_step<R>(st, c, j, dup, up, gap);
        dup = up.up;
        if (lane == last && j >= 0) *done = (uint32_t)out.key;
    }
    __syncwarp();
}

// The packed path's outputs from the scratch row of keys.
__device__ void packed_hits(const uint32_t* __restrict__ scr, int len,
                            int tol, int32_t* res) {
    const int lane = threadIdx.x & (LANES - 1);
    int32_t best = -1;
    for (int j = lane; j < len; j += LANES)
        best = max(best, adpk_best((int32_t)scr[j], j));
    #pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        best = max(best, __shfl_xor_sync(FULL, best, d));
    int32_t s2 = ADP_NEG;
    if (best < 0) {   // an empty read
        res[0] = res[1] = res[2] = res[3] = res[4] = 0;
    } else {
        const int32_t j1 = adpk_best_column(best);
        const int32_t k1 = (int32_t)scr[j1];
        res[0] = adpk_colmax(k1);
        res[1] = j1;
        res[2] = adpk_qe(k1);
        res[3] = adpk_ts(k1);
        res[4] = adpk_qs(k1);
        for (int j = lane; j < len; j += LANES)
            s2 = max(s2, adpk_second((int32_t)scr[j], j, j1, res[3], tol));
    }
    #pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        s2 = max(s2, __shfl_xor_sync(FULL, s2, d));
    res[5] = s2;
}

template <int R>
__device__ void sweep(const int8_t* rrow, int len, const int8_t* q, int mc,
                      int match, int mismatch, int gap, int4* carry,
                      uint32_t* scr, int32_t& bs, int32_t& bj, int32_t& bk,
                      uint32_t& bp) {
    const int per_pass = LANES * R;
    if (mc <= per_pass) {
        sweep_pass<R, false, true>(rrow, len, q, mc, 0, match, mismatch, gap,
                                   carry, scr, bs, bj, bk, bp);
        return;
    }
    sweep_pass<R, false, false>(rrow, len, q, mc, 0, match, mismatch, gap,
                                carry, scr, bs, bj, bk, bp);
    int first = per_pass;
    for (; first + per_pass < mc; first += per_pass)
        sweep_pass<R, true, false>(rrow, len, q, mc, first, match, mismatch,
                                   gap, carry, scr, bs, bj, bk, bp);
    sweep_pass<R, true, true>(rrow, len, q, mc, first, match, mismatch, gap,
                              carry, scr, bs, bj, bk, bp);
}

// The general path: any read up to 2^18 - 1 columns, any combo up to
// 4096 rows (in passes), any scoring the wrapper takes.
__device__ void general_hits(const int8_t* rrow, int len, const int8_t* q,
                             int mc, int match, int mismatch, int gap,
                             int tol, int4* carry, uint32_t* scr,
                             int32_t* res) {
    const int lane = threadIdx.x & (LANES - 1);
    // best hit: the higher score, then the earlier column
    int32_t bs = -1, bj = 0, bk = ADP_CM0;
    uint32_t bp = 0;
    if (mc > 0 && adp_rows_per_lane(mc, LANES) == 1)
        sweep<1>(rrow, len, q, mc, match, mismatch, gap, carry, scr, bs, bj,
                 bk, bp);
    else if (mc > 0)
        sweep<ADP_MAX_R>(rrow, len, q, mc, match, mismatch, gap, carry, scr,
                         bs, bj, bk, bp);
    // no column (an empty read), or no row: the zeros of the plain
    // version (an empty combo's columns all hold colmax 0)
    if (mc <= 0 && len > 0) { bs = 0; }
    if (bs < 0) { bs = 0; bj = 0; bk = ADP_CM0; bp = 0; }
    const int32_t ts1 = adp_ts(bp);
    int32_t s2 = ADP_NEG;
    for (int j = lane; j < len; j += LANES) {
        const uint32_t w = mc > 0 ? scr[j] : 0u;
        s2 = max(s2, adp_second(w, j, bj, ts1, tol));
    }
    #pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        s2 = max(s2, __shfl_xor_sync(FULL, s2, d));
    res[0] = bs; res[1] = bj; res[2] = adp_qe(bk); res[3] = ts1;
    res[4] = adp_qs(bp); res[5] = s2;
}

// at most 64 registers: 8 blocks of 4 warps an SM, so a postprocess
// group of 1000 reads runs in one wave
__global__ void __launch_bounds__(LANES * MAX_WARPS, 4)
adapter_hits_kernel(const int8_t* __restrict__ reads,
                    const int32_t* __restrict__ lens,
                    const int8_t* __restrict__ adapters,
                    const int32_t* __restrict__ alens,
                    uint32_t* __restrict__ scratch,
                    int4* __restrict__ carry,
                    int32_t* __restrict__ out,
                    int B, int L, int C, int m,
                    int match, int mismatch, int gap, int tol) {
    const int b = blockIdx.x;
    const int lane = threadIdx.x & (LANES - 1);
    const int nw = blockDim.x / LANES;
    const int len = lens[b];
    const bool packed = adpk_fits(len, m, match, mismatch, gap);
    const int8_t* rrow = reads + (size_t)b * L;
    for (int c = threadIdx.x / LANES; c < C; c += nw) {
        const int mc = alens[c];
        const int8_t* q = adapters + (size_t)c * m;
        uint32_t* scr = scratch + ((size_t)b * C + c) * L;
        int32_t res[6];
        if (packed && mc > 0) {
            if (adp_rows_per_lane(mc, LANES) == 1)
                packed_sweep<1>(rrow, len, q, mc, match, mismatch, gap, scr);
            else
                packed_sweep<ADP_MAX_R>(rrow, len, q, mc, match, mismatch,
                                        gap, scr);
            packed_hits(scr, len, tol, res);
        } else {
            general_hits(rrow, len, q, mc, match, mismatch, gap, tol,
                         carry ? carry + ((size_t)b * C + c) * L : nullptr,
                         scr, res);
        }
        if (lane == 0) {
            const size_t o = (size_t)b * C + c, BC = (size_t)B * C;
            for (int k = 0; k < 6; ++k) out[k * BC + o] = res[k];
        }
    }
}

}  // namespace

extern "C" {

const char* c3t_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// reads (B, L) int8, lens (B,) int32, adapters (C, m) int8, alens (C,)
// int32, scratch (B, C, L) int32, carry (B, C, L) int4 or null when no
// combo is longer than one pass (64 rows), out (6, B, C) int32; all
// contiguous on the device.  Launches on ``stream``.
int c3t_adapter_hits(const void* reads, const void* lens,
                     const void* adapters, const void* alens, void* scratch,
                     void* carry, void* out, int B, int L, int C, int m,
                     int match, int mismatch, int gap, int tol,
                     void* stream) {
    const int warps = C < MAX_WARPS ? C : MAX_WARPS;
    adapter_hits_kernel<<<B, LANES * warps, 0, (cudaStream_t)stream>>>(
        (const int8_t*)reads, (const int32_t*)lens, (const int8_t*)adapters,
        (const int32_t*)alens, (uint32_t*)scratch, (int4*)carry,
        (int32_t*)out, B, L, C, m, match, mismatch, gap, tol);
    return (int)cudaGetLastError();
}

}  // extern "C"
