// Banded affine-gap semiglobal alignment: the forward pass (kernel 2)
// and the reverse path walk (kernel 3) of the consensus aligner.
//
// Forward replaces the TPU kernel c3poa_tpu/kernels/pallas_banded.py
// (banded_fwd_pallas_packed, bodies _kernel_sb and _kernel); XLA twin
// c3poa_tpu/kernels/banded.py:banded_align_batch; spec
// c3poa_tpu/ref/banded.py:banded_align.  The walk replaces the jitted
// XLA walks of c3poa_tpu/kernels/banded.py (walk_ops_cached, and the
// plain walk in banded_align_trace_batch).  Scores, end columns, moves
// and walk outputs equal the plain torch versions in
// c3poa_tpu_torch/kernels/banded.py bit for bit.
//
// Band: row i holds W columns j = lo(i) + k (band_lo.cuh); lo advances
// by s = lo(i) - lo(i-1), at most SMAX = 3 per row for the pairs the
// backend sends here.  The recurrences, the move nibble (bits 0-1 source:
// 0 diag, 1 E, 2 F; bit 2 E extends; bit 3 F extends; 0 outside the band
// and on rows past ql) and how both are computed are in banded.cuh.
// Moves are stored as (P, ceil(nq/8), W) 32-bit words: row i's nibble is
// nibble (i-1) % 8 of word (i-1) / 8, the JAX package's layout.
//
// What bounds the forward on an H100: instruction issue together with
// the latency of a row's dependent chain (band shift, cells, prefix max,
// next row), which 4 warps a scheduler cover only in part: a launch of
// P = 2048 pairs is one warp a pair, 15.5 warps an SM.  Bytes are far from
// the limit (moves are P * nq * W / 2 bytes, written once).  So the design
// spends as few instructions a cell as it can and keeps the chain short:
//  - one warp per pair, W / 32 consecutive band columns per lane in
//    registers; the band shift is a warp-uniform s, so the realignment is
//    a branch over s with compile-time register indices and at most s
//    shuffles per array;
//  - lo(i) (a float divide) and the row's substitution table are computed
//    for 32 rows at a time, one row a lane, and reach the row by one
//    shuffle each; the next 32 query codes are loaded a chunk ahead;
//  - targets are staged in shared memory as 4-bit codes, padded, so a
//    lane's row needs two aligned word loads, one funnel shift and one
//    byte permute for all its substitution scores: no compare, no bounds
//    test; dp4a adds a cell's score to its diagonal on the multiply pipe;
//  - no masks on the row: every column of every row is inside the band
//    unless the target is shorter than the band, which is known per pair
//    (a second instantiation);
//  - the move nibble comes from the signs of four differences, pushed by
//    one funnel shift each, bit-reversed once per 8 rows;
//  - the F prefix max is an in-thread scan plus a shuffle scan without
//    predicates in three rounds of independent shuffles, and F's extend
//    flag reuses the difference that decided the previous column's source;
//  - the row's body is instantiated once per shift, so the shifted row is
//    a renaming of registers, and a row's lo, table and target codes are
//    fetched one row ahead;
//  - each lane writes its 8-row words as one 16-byte store, and zero
//    words for the rows past ql, so the caller allocates without clearing.
//
// What bounds the walk: P dependent chains of ~ql + a few hundred steps,
// one move-word lookup a step; no design with one chain a pair can beat
// the longest path's steps times the time of one step of a lone warp,
// which on this in-order machine is every instruction of the step, not
// only the dependent ones (tools/banded_chain.py measures it: P = 1).
// Design: WALK_LANES = 16 lanes per pair, two pairs a warp (the fastest of
// 8, 16 and 32 at every band), every lane of a pair carrying the same (i,
// j, state), so that a warp instruction serves two steps and the card
// holds fewer, fuller warps.  The move words of a chunk of 32 rows (4 row
// groups of W words) are fetched by the pair's lanes with 16-byte
// asynchronous copies into one half of a ring in shared memory while the
// chunk below them is walked out of the other half, so a step's lookup is
// a shared-memory broadcast load and never waits for device memory; every
// move word is read once, coalesced (a window around the path would read
// a quarter but needs a second, slow path for long deletions; at 268 MB a
// launch the whole read is below a tenth of a millisecond).  lo(i) of the
// chunk's 32 rows is computed once, one or more rows a lane; one barrier
// of the pair's lanes a chunk.  The step itself is branch-free arithmetic
// on the nibble, two steps a loop iteration (banded.cuh).  Sources are
// packed 2 bits each, turned into ops 16 at a time and stored by one
// lane; the tail of the ops row is zeroed by the kernel.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "banded.cuh"

namespace {

constexpr int32_t NEG = BND_NEG;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMAX = 3;

template <int CPL>
__device__ __forceinline__ void store_words(uint32_t* dst,
                                            const uint32_t (&w)[CPL]) {
    if constexpr (CPL % 4 == 0) {
        #pragma unroll
        for (int c = 0; c < CPL; c += 4)
            *reinterpret_cast<uint4*>(dst + c) =
                make_uint4(w[c], w[c + 1], w[c + 2], w[c + 3]);
    } else {
        #pragma unroll
        for (int c = 0; c < CPL; ++c) dst[c] = w[c];
    }
}

// value of band column (lane * CPL + c + S + D) of ``v`` as held by the
// warp (columns outside [0, W) read as NEG); S, D and c compile-time
template <int CPL, int X>
__device__ __forceinline__ int32_t col_at(const int32_t (&v)[CPL], int lane) {
    if constexpr (X < 0) {
        // from the previous lane's last column
        constexpr int off = (-X + CPL - 1) / CPL;
        constexpr int slot = X + off * CPL;
        const int32_t o = __shfl_up_sync(FULL, v[slot], off);
        return lane >= off ? o : NEG;
    } else if constexpr (X < CPL) {
        return v[X];
    } else {
        constexpr int off = X / CPL;
        constexpr int slot = X % CPL;
        const int32_t o = __shfl_down_sync(FULL, v[slot], off);
        return lane + off < 32 ? o : NEG;
    }
}

template <int CPL, int S, int... C>
__device__ __forceinline__ void shift_fixed(
        const int32_t (&H)[CPL], const int32_t (&E)[CPL], int32_t (&Hp)[CPL],
        int32_t (&Ep)[CPL], int32_t (&Hd)[CPL], int lane,
        std::integer_sequence<int, C...>) {
    ((Hp[C] = col_at<CPL, C + S>(H, lane)), ...);
    ((Ep[C] = col_at<CPL, C + S>(E, lane)), ...);
    ((Hd[C] = col_at<CPL, C + S - 1>(H, lane)), ...);
}

// any s >= 0 (never taken for the pairs the backend sends: s <= SMAX)
template <int CPL>
__device__ void shift_any(const int32_t (&H)[CPL], const int32_t (&E)[CPL],
                          int32_t (&Hp)[CPL], int32_t (&Ep)[CPL],
                          int32_t (&Hd)[CPL], int lane, int s) {
    #pragma unroll
    for (int c = 0; c < CPL; ++c) {
        const int x = c + s, xd = c + s - 1;
        int32_t hp = NEG, ep = NEG, hd = NEG;
        #pragma unroll
        for (int sl = 0; sl < CPL; ++sl) {
            const int32_t h1 = __shfl_sync(FULL, H[sl], (lane + x / CPL) & 31);
            const int32_t e1 = __shfl_sync(FULL, E[sl], (lane + x / CPL) & 31);
            const int32_t h2 = __shfl_sync(FULL, H[sl], (lane + xd / CPL) & 31);
            if (sl == x % CPL) { hp = h1; ep = e1; }
            if (sl == xd % CPL) hd = h2;
        }
        const int gx = lane * CPL + x, gxd = lane * CPL + xd;
        Hp[c] = gx < 32 * CPL ? hp : NEG;
        Ep[c] = gx < 32 * CPL ? ep : NEG;
        Hd[c] = gxd < 32 * CPL ? hd : NEG;
    }
}

// Exclusive prefix max over the lanes of each lane's v (NEG in lane 0).
// A lane below the shuffle distance gets its own value back, which a max
// absorbs, so no step is predicated.  Three rounds of independent
// shuffles (distances 1-3, 4-12, 16) instead of five dependent ones: the
// scan is the longest dependent chain of a row.
__device__ __forceinline__ int32_t scan_max_exclusive(int32_t v, int lane) {
    #pragma unroll
    for (int d = 1; d < 16; d <<= 2) {
        const int32_t a1 = __shfl_up_sync(FULL, v, d);
        const int32_t a2 = __shfl_up_sync(FULL, v, 2 * d);
        const int32_t a3 = __shfl_up_sync(FULL, v, 3 * d);
        v = max(max(v, a1), max(a2, a3));
    }
    v = max(v, __shfl_up_sync(FULL, v, 16));
    const int32_t ex = __shfl_up_sync(FULL, v, 1);
    return lane == 0 ? NEG : ex;
}

// One DP row of a lane's columns, for a band shift S known at compile
// time (S < 0: any shift, passed in s), so that the shifted previous row
// is a renaming of registers plus at most S shuffles per array.
template <int CPL, bool MASKED, int S>
__device__ __forceinline__ void fwd_row(
        int32_t (&H)[CPL], int32_t (&E)[CPL], uint32_t (&acc)[CPL],
        const int32_t (&ek)[CPL], const uint32_t (&inb)[CPL], int lane,
        int s, uint32_t table, uint32_t window, int32_t oe, int32_t e,
        int32_t go) {
    int32_t Hp[CPL], Ep[CPL], Hd[CPL];
    if constexpr (S >= 0)
        shift_fixed<CPL, S>(H, E, Hp, Ep, Hd, lane,
                            std::make_integer_sequence<int, CPL>{});
    else
        shift_any<CPL>(H, E, Hp, Ep, Hd, lane, s);
    BndRow<CPL> row;
    bnd_row_open<CPL>(Hp, Ep, Hd, table, window, ek, oe, e, go, row);
    bnd_row_gap<CPL>(scan_max_exclusive(row.pm[CPL - 1], lane), ek, go, row);
    const int32_t bl = __shfl_up_sync(FULL, row.b[CPL - 1], 1);
    bnd_row_moves<CPL>(row, bl, lane == 0, go, acc);
    #pragma unroll
    for (int c = 0; c < CPL; ++c) {
        H[c] = (!MASKED || inb[c]) ? row.Hn[c] : NEG;
        E[c] = (!MASKED || inb[c]) ? row.En[c] : NEG;
    }
}

// One pair's forward pass by one warp.  MASKED: the target is shorter
// than the band (tl + 1 < W), so lo(i) = 0 on every row and band columns
// k > tl are outside the target: they hold NEG and a zero nibble.  In every
// other pair every column of every row is inside (lo(i) <= tl + 1 - W), and
// the one cell left of the target (j = 0, only at k = 0 with lo = 0) gets
// D = NEG without a test: its Hd is the band's left edge (NEG) and its
// staged target slot is the pad (score 0).
template <int CPL, bool MASKED>
__device__ __forceinline__ void fwd_pair(
        const int8_t* __restrict__ qrow, const uint32_t* ts, int32_t ql,
        int32_t tl, int nq, int nq8, uint32_t* __restrict__ mrow, int lane,
        int match, int mismatch, int gap_open, int gap_ext,
        int32_t* score_out, int32_t* jend_out) {
    constexpr int W = 32 * CPL;
    const int32_t go = gap_open, e = gap_ext, oe = gap_open + gap_ext;
    const int k0 = lane * CPL;

    int32_t H[CPL], E[CPL], ek[CPL];
    uint32_t acc[CPL], inb[CPL];
    int32_t lo_prev = band_lo(0, ql, tl, W);
    #pragma unroll
    for (int c = 0; c < CPL; ++c) {
        inb[c] = (!MASKED || k0 + c <= tl) ? 0xffffffffu : 0u;
        H[c] = inb[c] ? 0 : NEG;
        E[c] = NEG;
        ek[c] = e * (k0 + c);
        acc[c] = 0;
    }
    // 32 rows at a time, one row a lane: lo(i) and the row's substitution
    // table; the query codes of the 32 rows after those are loaded
    // meanwhile.  A row's lo, table and target window are fetched one row
    // ahead, so that no row waits for them.
    int qnext = lane < nq ? qrow[lane] : 4;
    int32_t lo_reg = band_lo(1 + lane, ql, tl, W);
    uint32_t tab_reg = bnd_sub_table(qnext, match, mismatch);
    qnext = 32 + lane < nq ? qrow[32 + lane] : 4;
    int32_t lo_i = __shfl_sync(FULL, lo_reg, 0);
    uint32_t table = __shfl_sync(FULL, tab_reg, 0);
    uint32_t window = bnd_target_window(ts, lo_i + k0);

    #pragma unroll 1
    for (int i = 1; i <= ql; ++i) {
        const int s = lo_i - lo_prev;
        const uint32_t table_i = table, window_i = window;
        lo_prev = lo_i;
        // row i + 1
        const int rn = i & 31;
        if (rn == 0) {
            lo_reg = band_lo(i + 1 + lane, ql, tl, W);
            tab_reg = bnd_sub_table(qnext, match, mismatch);
            const int qi = i + 32 + lane;
            qnext = qi < nq ? qrow[qi] : 4;
        }
        lo_i = __shfl_sync(FULL, lo_reg, rn);
        table = __shfl_sync(FULL, tab_reg, rn);

        if (s == 1)
            fwd_row<CPL, MASKED, 1>(H, E, acc, ek, inb, lane, s, table_i,
                                    window_i, oe, e, go);
        else if (s == 0)
            fwd_row<CPL, MASKED, 0>(H, E, acc, ek, inb, lane, s, table_i,
                                    window_i, oe, e, go);
        else if (s == 2)
            fwd_row<CPL, MASKED, 2>(H, E, acc, ek, inb, lane, s, table_i,
                                    window_i, oe, e, go);
        else if (s == SMAX)
            fwd_row<CPL, MASKED, SMAX>(H, E, acc, ek, inb, lane, s, table_i,
                                       window_i, oe, e, go);
        else
            fwd_row<CPL, MASKED, -1>(H, E, acc, ek, inb, lane, s, table_i,
                                     window_i, oe, e, go);
        // after the row, when the shuffled lo has long arrived
        window = bnd_target_window(ts, lo_i + k0);

        if ((i & 7) == 0 || i == ql) {
            const int rows = ((i - 1) & 7) + 1;
            uint32_t w[CPL];
            #pragma unroll
            for (int c = 0; c < CPL; ++c)
                w[c] = bnd_moves_word(acc[c], rows) & inb[c];
            store_words<CPL>(mrow + (size_t)((i - 1) >> 3) * W + k0, w);
        }
    }
    // rows past the query: zero move words, written here so that the
    // caller need not clear the buffer
    {
        uint32_t w[CPL];
        #pragma unroll
        for (int c = 0; c < CPL; ++c) w[c] = 0;
        for (int g = (ql + 7) >> 3; g < nq8; ++g)
            store_words<CPL>(mrow + (size_t)g * W + k0, w);
    }

    // score = max of the last row; k_end = smallest argmax
    int32_t mx = H[0];
    #pragma unroll
    for (int c = 1; c < CPL; ++c) mx = max(mx, H[c]);
    #pragma unroll
    for (int d = 16; d; d >>= 1) mx = max(mx, __shfl_xor_sync(FULL, mx, d));
    int32_t kb = W;
    #pragma unroll
    for (int c = CPL - 1; c >= 0; --c) if (H[c] == mx) kb = k0 + c;
    #pragma unroll
    for (int d = 16; d; d >>= 1) kb = min(kb, __shfl_xor_sync(FULL, kb, d));
    if (lane == 0) {
        *score_out = mx;
        *jend_out = lo_prev + kb;
    }
}

template <int CPL>
__global__ void banded_fwd_kernel(
        const int8_t* __restrict__ Q, const int8_t* __restrict__ T,
        const int32_t* __restrict__ qlens, const int32_t* __restrict__ tlens,
        int32_t* __restrict__ score_out, int32_t* __restrict__ jend_out,
        uint32_t* __restrict__ moves, int P, int nq, int nt, int ts_words,
        int match, int mismatch, int gap_open, int gap_ext) {
    constexpr int W = 32 * CPL;
    extern __shared__ __align__(16) uint32_t smem[];
    const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int p = blockIdx.x * (blockDim.x >> 5) + wib;
    if (p >= P) return;   // the whole warp leaves together
    uint32_t* ts = smem + (size_t)wib * ts_words;

    int32_t ql = qlens[p];
    const int32_t tl = tlens[p];
    if (ql > nq) ql = nq;
    const int8_t* trow = T + (size_t)p * nt;
    for (int w = lane; w < ts_words; w += 32)
        ts[w] = bnd_target_word(trow, tl < nt ? tl : nt, w);
    __syncwarp();

    const int nq8 = (nq + 7) >> 3;
    uint32_t* mrow = moves + (size_t)p * nq8 * W;
    const int8_t* qrow = Q + (size_t)p * nq;
    if (tl + 1 < W)
        fwd_pair<CPL, true>(qrow, ts, ql, tl, nq, nq8, mrow, lane, match,
                            mismatch, gap_open, gap_ext, score_out + p,
                            jend_out + p);
    else
        fwd_pair<CPL, false>(qrow, ts, ql, tl, nq, nq8, mrow, lane, match,
                             mismatch, gap_open, gap_ext, score_out + p,
                             jend_out + p);
}

// The walk: WALK_LANES lanes a pair, so a warp walks WALK_PAIRS pairs and
// each of its instructions serves that many steps; one warp a block.  A
// pair's ring holds two chunks of BND_WALK_ROWS rows of move words: the
// one being walked and the one above it, which is fetched meanwhile.
constexpr int WALK_LANES = 16;
constexpr int WALK_PAIRS = 32 / WALK_LANES;
constexpr int WALK_CHUNK_GROUPS = BND_WALK_ROWS / 8;

__global__ void banded_walk_kernel(
        const uint32_t* __restrict__ moves, const int32_t* __restrict__ qlens,
        const int32_t* __restrict__ tlens, const int32_t* __restrict__ jend,
        int32_t* __restrict__ jstart, int32_t* __restrict__ irem,
        uint8_t* __restrict__ edge_out, uint32_t* __restrict__ ops,
        int P, int nq8, int W, int n_steps, int ops_words) {
    extern __shared__ __align__(16) uint32_t smem[];
    __shared__ int32_t lo_all[WALK_PAIRS][2][BND_WALK_ROWS];
    const int lane = threadIdx.x;
    const int sl = lane % WALK_LANES;          // lane within the pair
    const int slot = lane / WALK_LANES;        // pair within the block
    const int p = blockIdx.x * WALK_PAIRS + slot;
    if (p >= P) return;   // the pair's lanes leave together
    // the lanes of this pair: every barrier below is theirs alone, the
    // pairs of a warp walk paths of different lengths
    const unsigned mask = ((1u << WALK_LANES) - 1u) << (lane - sl);
    const int chunk_words = WALK_CHUNK_GROUPS * W;
    uint32_t* ring = smem + (size_t)slot * 2 * chunk_words;

    const int32_t tl = tlens[p];
    int32_t ql = qlens[p];
    if (ql > nq8 * 8) ql = nq8 * 8;
    const uint32_t* mrow = moves + (size_t)p * nq8 * W;
    const int pair_words = nq8 * W;
    uint32_t* orow = ops + (size_t)p * ops_words;

    // chunk c of the pair's move words (clipped at their end) into ring
    // slot c & 1, 16 bytes a lane and copy
    auto fetch = [&](int c) {
        if (c >= 0) {
            const int first = c * chunk_words;
            const uint32_t* src = mrow + first;
            uint32_t* dst = ring + (c & 1) * chunk_words;
            const int n = min(chunk_words, pair_words - first);
            #pragma unroll 1
            for (int o = 4 * sl; o < n; o += 4 * WALK_LANES)
                __pipeline_memcpy_async(dst + o, src + o, 16);
        }
        __pipeline_commit();
    };

    BndWalk s;
    bnd_walk_init(s, ql, jend[p]);
    if (s.i > 0) fetch((s.i - 1) / BND_WALK_ROWS);
    // One barrier a chunk: past it every lane of the pair has left the
    // chunk before, so that chunk's ring slot can be refilled, and its lo
    // sits in the other half of lo_all.
    while (s.i > 0 && s.step < n_steps) {
        const int c = (s.i - 1) / BND_WALK_ROWS;
        int32_t* lo = lo_all[slot][c & 1];
        #pragma unroll
        for (int u = sl; u < BND_WALK_ROWS; u += WALK_LANES)
            lo[u] = band_lo(BND_WALK_ROWS * c + 1 + u, ql, tl, W);
        __pipeline_wait_prior(0);
        __syncwarp(mask);
        fetch(c - 1);
        bnd_walk_chunk(ring + (c & 1) * chunk_words, lo, W, tl, n_steps,
                       sl == 0, orow, s);
    }
    __pipeline_wait_prior(0);
    // the last, partial word of ops, then zero words to the end
    if (sl == 0 && (s.step & 15))
        orow[s.step >> 4] = bnd_walk_tail(s.cur, s.step);
    for (int w = ((s.step + 15) >> 4) + sl; w < ops_words; w += WALK_LANES)
        orow[w] = 0;
    if (sl == 0) {
        jstart[p] = s.j;
        irem[p] = s.i;
        edge_out[p] = s.emin == 0;
    }
}

constexpr size_t FWD_SHARED_BYTES = 96 * 1024;

template <int CPL>
int launch_fwd(const void* Q, const void* T, const void* ql, const void* tl,
               void* score, void* jend, void* moves, int P, int nq, int nt,
               int match, int mismatch, int gap_open, int gap_ext,
               cudaStream_t stream) {
    // staged target: ts_words 32-bit words per warp; 8 pairs (warps) a
    // block, the fastest of 1, 2, 4 and 8 at every band, fewer when their
    // targets would not fit FWD_SHARED_BYTES
    const int ts_words = bnd_target_words(nt, 32 * CPL);
    const size_t pair_bytes = (size_t)ts_words * sizeof(uint32_t);
    if (pair_bytes > FWD_SHARED_BYTES) return (int)cudaErrorInvalidValue;
    const int fit = (int)(FWD_SHARED_BYTES / pair_bytes);
    const int wpb = fit < 8 ? fit : 8;
    const size_t smem = wpb * pair_bytes;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            banded_fwd_kernel<CPL>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (P + wpb - 1) / wpb;
    banded_fwd_kernel<CPL><<<blocks, 32 * wpb, smem, stream>>>(
        (const int8_t*)Q, (const int8_t*)T, (const int32_t*)ql,
        (const int32_t*)tl, (int32_t*)score, (int32_t*)jend,
        (uint32_t*)moves, P, nq, nt, ts_words, match, mismatch, gap_open,
        gap_ext);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* c3t_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Q (P, nq) int8 and T (P, nt) int8 pad 4; ql <= nq, tl <= nt (P,) int32;
// outputs score, jend (P,) int32 and moves (P, ceil(nq/8), W) 32-bit
// words, every one of which is written (zero past ql).  match and
// mismatch must fit a signed byte.  W in {32, 64, 128, 256}; an
// unsupported band, or a target too wide for the shared-memory staging
// (4 bits a base, 96 KB), returns cudaErrorInvalidValue.
int c3t_banded_fwd(const void* Q, const void* T, const void* ql,
                   const void* tl, void* score, void* jend, void* moves,
                   int P, int nq, int nt, int W, int match, int mismatch,
                   int gap_open, int gap_ext, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (match < -128 || match > 127 || mismatch < -128 || mismatch > 127)
        return (int)cudaErrorInvalidValue;
    switch (W) {
        case 32: return launch_fwd<1>(Q, T, ql, tl, score, jend, moves, P,
                                      nq, nt, match, mismatch, gap_open,
                                      gap_ext, st);
        case 64: return launch_fwd<2>(Q, T, ql, tl, score, jend, moves, P,
                                      nq, nt, match, mismatch, gap_open,
                                      gap_ext, st);
        case 128: return launch_fwd<4>(Q, T, ql, tl, score, jend, moves, P,
                                       nq, nt, match, mismatch, gap_open,
                                       gap_ext, st);
        case 256: return launch_fwd<8>(Q, T, ql, tl, score, jend, moves, P,
                                       nq, nt, match, mismatch, gap_open,
                                       gap_ext, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// moves (P, nq8, W) words from c3t_banded_fwd, W a multiple of 32 up to
// 256; jend (P,) int32; outputs jstart, irem (P,) int32, edge (P,) uint8
// and ops (P, ops_words) 32-bit words of 2-bit ops (1 diag, 2 ins, 3
// del), every one of which is written (zero past the path).
int c3t_banded_walk(const void* moves, const void* ql, const void* tl,
                    const void* jend, void* jstart, void* irem, void* edge,
                    void* ops, int P, int nq8, int W, int n_steps,
                    int ops_words, void* stream) {
    if (W < 32 || W > 256 || W % 32) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)WALK_PAIRS * 2 * WALK_CHUNK_GROUPS * W *
                        sizeof(uint32_t);
    banded_walk_kernel<<<(P + WALK_PAIRS - 1) / WALK_PAIRS, 32, smem,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)moves, (const int32_t*)ql, (const int32_t*)tl,
        (const int32_t*)jend, (int32_t*)jstart, (int32_t*)irem,
        (uint8_t*)edge, (uint32_t*)ops, P, nq8, W, n_steps, ops_words);
    return (int)cudaGetLastError();
}

}  // extern "C"
