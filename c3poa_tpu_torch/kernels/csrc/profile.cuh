// Row arithmetic of the splint-profile kernel (csrc/profile.cu), written
// once for the device and the host: a g++ build of
// tests/profile_host_driver.cpp runs the kernel's blocks serially over
// these functions (8 warps x 32 lanes, the shuffles as array shifts, the
// warps' carries through the same slots) and the CPU tests hold it bit for
// bit to c3poa_tpu_torch/kernels/sw_profile.py:start_profile_batch.
//
// The function.  Splint rows i = m-1 .. 0, read columns j of one tile:
//   G[i][j] = max(0, G[i+1][j+1] + s(i, j), G[i+1][j] - gap, G[i][j+1] - gap)
//   out[j]  = max_i G[i][j]
// with s = match / mismatch, and 0 wherever either code is 4 (N / pad);
// G = 0 on the row below the splint and on the column right of the tile.
// A row is T[j] = max(0, G'[j+1] + s, G'[j] - gap) (G' the row below),
// then the in-row gap run G[j] = max(T[j], G[j+1] - gap).
//
// Where the instructions go.  On sm_90 the max and add-max instructions
// (IMNMX, the DPX VIADDMNMX and VIMNMX3) and PRMT issue on the 16-lane
// ALU pipe, a warp instruction every 2 clocks; IMAD and IDP (dp4a) on
// the FMA pipe beside it.  A cell here is two FMA-pipe instructions and
// three and a half ALU ones:
//   - the diagonal with its score, one IDP: the row's table holds s(i, t)
//     in byte t for read codes t = 0..3 (0 in every byte for a splint N),
//     and the cell's read code is a one-hot byte (no byte for read code 4,
//     which scores 0), so dp4a(table, hot, G'[j+1]) = G'[j+1] + s;
//   - T, one DPX add-max with the floor 0 (VIADDMNMX.RELU): max(G'[j] -
//     gap, diagonal, 0);
//   - T[j] - gap * (j - jl0), one IMAD, for the thread's total (the G its
//     own columns give its first column jl0), a tree of three-way maxes
//     (VIMNMX3, half an instruction a cell);
//   - after the carry: the gap run, one VIADDMNMX, and the column max.
// (A form that kept a = G - gap * j and took the score from a byte
// permute had 100 of its 120 instructions a row on the ALU pipe, which
// set its time.)
//
// Across the thread's lanes.  s, the total, is the G its columns give the
// column jl0; the warp's inclusive suffix max of it, in which lane l + d's
// value reaches lane l less the gap of 16 d columns, takes five shuffles
// down, unpredicated: past lane 31 a shuffle returns the caller's own
// value, and max(s, s - 16 d gap) = s for gap >= 0.  The lane's carry in
// cin = G of this row at the next thread's first column jl0 + 16: the
// next lane's inclusive value (the exclusive shuffle), and what lies right
// of the warp (carry, G at the next warp's first column) less the gap of
// the columns between; the last lane's own shuffled value is sunk by a
// lane mask (PF_NEG on lane 31, 0 elsewhere), so one IMAD and one add-max.
// cin is also the next row's G' at jl0 + 16, the right neighbour of the
// thread's last column: no shuffle for it.
//
// Rows of a trailing run of N / pad codes of the splint (its first rows
// in this order) leave G = 0 (every score is 0 and G below is 0), so the
// kernel starts at the first row of a real code (pf_real_code).
//
// The wavefront across the block's warps.  Let c(w) be warp w's first
// column and cum[t][w] = G_t[c(w)] (all columns right of it counted), with
// cum[t][PF_WARPS] = G_t[TW] = 0, the tile's zero right boundary (as a
// carry it gives 0 - gap * d, below every T >= 0).  Then
//   cum[t][w] = max(s0, cum[t][w + 1] - gap * 512)
// (s0 lane 0's inclusive value) and warp w at row t needs, besides its own
// registers of row t - 1:
//   - G_{t-1} at c(w + 1), its last lane's right neighbour: that is
//     cum[t-1][w + 1], its last lane's cin of row t - 1;
//   - cum[t][w + 1], what lies right of it in row t.
// So warp w depends on warp w + 1 alone, and on it only through the slots
// cum[t][w + 1]; warp PF_WARPS - 1 reads the edge and never waits.  Each
// slot is written once (by lane 0 of its warp) into shared memory that was
// filled with PF_EMPTY before the row loop, and a reader waits until its
// slot holds something else (no published value is PF_EMPTY: G >= 0).
// The slots are never reused, so no write can overtake a read, the
// dependency graph has no cycle (no deadlock), and every interleaving of
// the warps computes the same values: a warp runs as far ahead of the warp
// on its left as it likes, and the fill is PF_WARPS - 1 rows of m.  (The
// host driver runs several interleavings: each warp through all rows from
// the last warp down, row by row, and seeded random choices among the
// warps whose slot is written.)  The slots cost m x (PF_WARPS + 1) words
// of shared memory.
//
// Range: 0 <= G <= m * match; the scan's offsets reach gap * 16 * 32.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define PF_HD __host__ __device__ __forceinline__
#else
#define PF_HD inline
#endif

constexpr int PF_THREADS = 256;                 // threads a block
constexpr int PF_K = 16;                        // consecutive columns a thread
constexpr int PF_TW = PF_THREADS * PF_K;        // tile width, core + overlap
constexpr int PF_WARPS = PF_THREADS / 32;
// slots a row: one a warp and the edge
constexpr int PF_CUM_STRIDE = PF_WARPS + 1;
constexpr int32_t PF_NEG = -(1 << 30);
// a slot no warp has written yet
constexpr int32_t PF_EMPTY = INT32_MIN;

// ---- twins of the device intrinsics -----------------------------------
PF_HD int32_t pf_max(int32_t a, int32_t b) {
#ifdef __CUDA_ARCH__
    return max(a, b);
#else
    return a > b ? a : b;
#endif
}

// max(a, b, c)
PF_HD int32_t pf_max3(int32_t a, int32_t b, int32_t c) {
#ifdef __CUDA_ARCH__
    return __vimax3_s32(a, b, c);
#else
    return pf_max(pf_max(a, b), c);
#endif
}

// max(a + b, c)
PF_HD int32_t pf_addmax(int32_t a, int32_t b, int32_t c) {
#ifdef __CUDA_ARCH__
    return __viaddmax_s32(a, b, c);
#else
    const int32_t s = a + b;
    return s > c ? s : c;
#endif
}

// max(a + b, c, 0)
PF_HD int32_t pf_addmax_relu(int32_t a, int32_t b, int32_t c) {
#ifdef __CUDA_ARCH__
    return __viaddmax_s32_relu(a, b, c);
#else
    return pf_max(pf_addmax(a, b, c), 0);
#endif
}

// c + the dot product of the signed bytes of a and b
PF_HD int32_t pf_dot(uint32_t a, uint32_t b, int32_t c) {
#ifdef __CUDA_ARCH__
    return __dp4a((int)a, (int)b, c);
#else
    for (int n = 0; n < 4; ++n)
        c += (int32_t)(int8_t)(a >> (8 * n)) * (int32_t)(int8_t)(b >> (8 * n));
    return c;
#endif
}

// ---- the substitution ---------------------------------------------------
// whether match and mismatch are signed bytes and 0 <= gap <= 2^16 (the
// scan's lanes past 31 and the edge need gap >= 0)
PF_HD bool pf_scoring_fits(int match, int mismatch, int gap) {
    return match >= -128 && match <= 127 && mismatch >= -128 &&
           mismatch <= 127 && gap >= 0 && gap <= (1 << 16);
}

// whether a splint code scores (a row of any other code scores 0)
PF_HD bool pf_real_code(int qc) { return qc >= 0 && qc <= 3; }

// a row's table: byte t = s(qc, t) for read codes t = 0..3; a splint code
// other than 0..3 (N / pad) scores 0 against everything
PF_HD uint32_t pf_sub_table(int qc, int match, int mismatch) {
    uint32_t w = 0;
    for (int t = 0; t < 4; ++t) {
        const int s = pf_real_code(qc) ? (qc == t ? match : mismatch) : 0;
        w |= (uint32_t)(s & 0xFF) << (8 * t);
    }
    return w;
}

// a read code's one-hot byte: 1 in byte code for codes 0..3, none for 4
PF_HD uint32_t pf_hot(int code) {
#ifdef PROFILE_MUTANT_N
    // a read N taken as code 0
    if (code == 4)
        return 1u;
#endif
    return code >= 0 && code <= 3 ? 1u << (8 * code) : 0u;
}

// ---- a thread's columns -----------------------------------------------
// One row's T over the thread's K columns, in place: G[k] holds the row
// below at column jl0 + k, right the row below at jl0 + K; ngap = -gap.
// Y[k] = T[k] - gap * k, what column k gives column jl0.  The row below at
// column k + 1 is read before it is overwritten (k rises).
template <int K>
PF_HD void pf_cells(int32_t* G, int32_t right, uint32_t tab,
                    const uint32_t* hot, int32_t ngap, int32_t* Y) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int k = 0; k < K; ++k) {
        const int32_t diag = pf_dot(tab, hot[k], k + 1 < K ? G[k + 1] : right);
        G[k] = pf_addmax_relu(G[k], ngap, diag);
        Y[k] = k ? G[k] + ngap * k : G[k];
    }
}

// the max of a thread's 16 Y, a tree of three-way maxes
PF_HD int32_t pf_total(const int32_t* Y) {
    const int32_t n0 = pf_max3(pf_max3(Y[0], Y[1], Y[2]),
                               pf_max3(Y[3], Y[4], Y[5]),
                               pf_max3(Y[6], Y[7], Y[8]));
    const int32_t n1 = pf_max3(pf_max3(Y[9], Y[10], Y[11]),
                               pf_max3(Y[12], Y[13], Y[14]), Y[15]);
    return pf_max(n0, n1);
}

// ---- across the lanes and warps -----------------------------------------
// the gap of d threads' columns, negated
PF_HD int32_t pf_span(int d, int gap) { return -gap * PF_K * d; }

// one step of the warp's suffix max: the value of the lane d on, less the
// gap of its d threads' columns (span = pf_span(d, gap))
PF_HD int32_t pf_scan(int32_t s, int32_t from_right, int32_t span) {
    return pf_addmax(from_right, span, s);
}

// the lane mask: PF_NEG on the warp's last lane, 0 elsewhere
PF_HD int32_t pf_lane_mask(int lane) { return lane == 31 ? PF_NEG : 0; }

// a lane's carry in, G at the next thread's first column: the lanes right
// of it in its warp (ex, the next lane's inclusive value; none for the
// last lane, whose mask sinks its own value below any carry) and what
// lies right of its warp (carry, G at the next warp's first column) less
// the gap of the columns between (dist = pf_span(31 - lane, gap))
PF_HD int32_t pf_cin(int32_t ex, int32_t lane_mask, int32_t carry,
                     int32_t dist) {
    return pf_addmax(carry, dist, ex + lane_mask);
}

// This row's G from its T and the lane's carry in (the gap run, right to
// left), and the column max.
template <int K>
PF_HD void pf_finish(int32_t* G, int32_t cin, int32_t ngap, int32_t* cm) {
    int32_t g = cin;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int k = K - 1; k >= 0; --k) {
        g = pf_addmax(g, ngap, G[k]);
        G[k] = g;
        cm[k] = pf_max(cm[k], g);
    }
}

// the slot of warp w's row t (w = PF_WARPS: the edge, G = 0)
PF_HD int pf_slot(int t, int w) { return t * PF_CUM_STRIDE + w; }

// the warp whose slot warp w reads: the one right of it
PF_HD int pf_source(int w) {
#ifdef PROFILE_MUTANT_CARRY
    // the carry from two warps on, skipping the neighbour
    return w + 2 < PF_WARPS ? w + 2 : PF_WARPS;
#else
    return w + 1;
#endif
}

// what warp w publishes at row t: G at its first column, from lane 0's
// inclusive value and what lies right of the warp, less the gap of its
// 32 threads' columns (span = pf_span(32, gap))
PF_HD int32_t pf_publish(int32_t s0, int32_t carry, int32_t span) {
    return pf_addmax(carry, span, s0);
}

// A block's shared memory, all of it dynamic (so the launch's opt-in
// above 48 KB sees every byte), in words: m + 1 row tables (the last one
// read only by the prefetch of the row after the last), m rows of slots,
// then a word a thread (the kernel's read-back of its invariants) and the
// first row of a real code.
PF_HD int pf_keep_word(int m) { return (m + 1) + m * PF_CUM_STRIDE; }

PF_HD unsigned pf_smem_bytes(int m) {
    return (unsigned)(pf_keep_word(m) + PF_THREADS + 1) * 4u;
}
