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
// backend sends here.  Per cell (k >= 1 for F):
//   E  = max(Hp - oe, Ep - e)                Hp, Ep = previous row at j
//   D  = H[i-1][j-1] + sub   (NEG at j = 0)
//   Ht = max(D, E);  F[k] = max_{u<k} (Ht[u] - oe - e*(k-1-u))
//   H  = max(Ht, F)
// move nibble: bits 0-1 source (0 diag, 1 E, 2 F), bit 2 E extends,
// bit 3 F extends; 0 outside the band (j > tl) and on rows past ql.
// Moves are stored as (P, ceil(nq/8), W) 32-bit words: row i's nibble is
// nibble (i-1) % 8 of word (i-1) / 8, the JAX package's layout.
//
// What bounds the forward on an H100: the serial row chain.  A pair's
// rows are dependent, each row is a handful of integer ops per cell
// plus one prefix max across the band, and a launch of P = 2048 pairs
// x 2048 rows x W = 128 is only 0.5 G cells — the card runs out of rows
// in flight before it runs out of issue slots or bandwidth (moves are
// P * nq * W / 2 bytes, written once).
// Design: one warp per pair, W / 32 consecutive band columns per lane in
// registers, so a row costs no memory traffic beyond one query char
// (32 rows per coalesced load, broadcast by shuffle) and the target
// chars (staged once per pair in shared memory).  The band shift is a
// warp-uniform s, so the realignment is a switch over s with
// compile-time register indices and at most s __shfl_down_sync per
// array; the F prefix max is an in-thread scan plus a five-step
// __shfl_up_sync scan.  Each lane packs 8 rows of its columns into 32-bit
// words and writes them as one 16-byte store per 8 rows.
//
// What bounds the walk: one dependent 4-byte load per path step (a path
// is ~ql + a few hundred steps).  Design: one thread per pair; the move
// word is reused while the path stays in it (8 rows x 1 column), and ops
// are packed 2 bits each into a register word stored every 16 steps.
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "band_lo.cuh"

namespace {

constexpr int32_t NEG = -(1 << 28);
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMAX = 3;

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

template <int CPL>
__global__ void banded_fwd_kernel(
        const int8_t* __restrict__ Q, const int8_t* __restrict__ T,
        const int32_t* __restrict__ qlens, const int32_t* __restrict__ tlens,
        int32_t* __restrict__ score_out, int32_t* __restrict__ jend_out,
        uint32_t* __restrict__ moves, int P, int nq, int nt, int nt_pad,
        int match, int mismatch, int gap_open, int gap_ext) {
    constexpr int W = 32 * CPL;
    extern __shared__ int8_t smem[];
    const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int p = blockIdx.x * (blockDim.x >> 5) + wib;
    if (p >= P) return;   // the whole warp leaves together
    int8_t* ts = smem + (size_t)wib * nt_pad;

    const int32_t ql = qlens[p], tl = tlens[p];
    const int8_t* trow = T + (size_t)p * nt;
    for (int j = lane; j < tl; j += 32) ts[j] = trow[j];
    __syncwarp();

    const int32_t oe = gap_open + gap_ext, e = gap_ext;
    const int k0 = lane * CPL;
    const int nq8 = (nq + 7) >> 3;
    uint32_t* mrow = moves + (size_t)p * nq8 * W + k0;
    const int8_t* qrow = Q + (size_t)p * nq;

    int32_t H[CPL], E[CPL];
    uint32_t acc[CPL];
    int32_t lo_prev = band_lo(0, ql, tl, W);
    #pragma unroll
    for (int c = 0; c < CPL; ++c) {
        H[c] = (lo_prev + k0 + c <= tl) ? 0 : NEG;
        E[c] = NEG;
        acc[c] = 0;
    }
    int qreg = 4;

    for (int i = 1; i <= ql; ++i) {
        const int r = (i - 1) & 31;
        if (r == 0) {
            const int qi = i - 1 + lane;
            qreg = qi < nq ? qrow[qi] : 4;
        }
        const int qc = __shfl_sync(FULL, qreg, r);
        const int32_t lo_i = band_lo(i, ql, tl, W);
        const int s = lo_i - lo_prev;

        int32_t Hp[CPL], Ep[CPL], Hd[CPL];
        const auto seq = std::make_integer_sequence<int, CPL>{};
        switch (s) {
            case 0: shift_fixed<CPL, 0>(H, E, Hp, Ep, Hd, lane, seq); break;
            case 1: shift_fixed<CPL, 1>(H, E, Hp, Ep, Hd, lane, seq); break;
            case 2: shift_fixed<CPL, 2>(H, E, Hp, Ep, Hd, lane, seq); break;
            case SMAX: shift_fixed<CPL, 3>(H, E, Hp, Ep, Hd, lane, seq); break;
            default: shift_any<CPL>(H, E, Hp, Ep, Hd, lane, s); break;
        }

        int32_t En[CPL], Ht[CPL], D[CPL], pm[CPL];
        uint32_t eext = 0;
        #pragma unroll
        for (int c = 0; c < CPL; ++c) {
            const int32_t jcol = lo_i + k0 + c;
            const int32_t tj = jcol - 1;
            const int tc = (tj >= 0 && tj < tl) ? ts[tj] : 4;
            const int32_t sub = (qc == 4 || tc == 4)
                ? 0 : (qc == tc ? match : mismatch);
            const int32_t eo = Hp[c] - oe, ee = Ep[c] - e;
            En[c] = __viaddmax_s32(Hp[c], -oe, ee);   // max(Hp-oe, Ep-e)
            eext |= (uint32_t)(ee > eo) << c;
            D[c] = jcol >= 1 ? Hd[c] + sub : NEG;
            Ht[c] = max(D[c], En[c]);
            const int32_t a = Ht[c] + e * (k0 + c);
            pm[c] = c ? max(pm[c - 1], a) : a;
        }
        // exclusive prefix max over lanes of the in-thread maxima
        int32_t v = pm[CPL - 1];
        #pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int32_t o = __shfl_up_sync(FULL, v, d);
            if (lane >= d) v = max(v, o);
        }
        int32_t ex = __shfl_up_sync(FULL, v, 1);
        if (lane == 0) ex = NEG;

        int32_t F[CPL];
        #pragma unroll
        for (int c = 0; c < CPL; ++c) {
            const int32_t cmprev = c ? max(ex, pm[c - 1]) : ex;
            F[c] = cmprev - oe - e * (k0 + c) + e;
        }
        const int32_t Fl = __shfl_up_sync(FULL, F[CPL - 1], 1);
        const int32_t Htl = __shfl_up_sync(FULL, Ht[CPL - 1], 1);
        const int sh = 4 * ((i - 1) & 7);
        #pragma unroll
        for (int c = 0; c < CPL; ++c) {
            const int32_t jcol = lo_i + k0 + c;
            bool fext;
            if (c) fext = (F[c - 1] - e) > (Ht[c - 1] - oe);
            else fext = lane > 0 && (Fl - e) > (Htl - oe);
            const int32_t Hn = max(Ht[c], F[c]);
            const uint32_t src = (D[c] >= En[c] && D[c] >= F[c])
                ? 0u : (En[c] >= F[c] ? 1u : 2u);
            const uint32_t mv = src | (((eext >> c) & 1u) << 2) |
                                ((uint32_t)fext << 3);
            const bool in_band = jcol <= tl;
            H[c] = in_band ? Hn : NEG;
            E[c] = in_band ? En[c] : NEG;
            acc[c] |= (in_band ? mv : 0u) << sh;
        }
        if ((i & 7) == 0 || i == ql) {
            uint32_t* dst = mrow + (size_t)((i - 1) >> 3) * W;
            if constexpr (CPL % 4 == 0) {
                #pragma unroll
                for (int c = 0; c < CPL; c += 4)
                    *reinterpret_cast<uint4*>(dst + c) =
                        make_uint4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
            } else {
                #pragma unroll
                for (int c = 0; c < CPL; ++c) dst[c] = acc[c];
            }
            #pragma unroll
            for (int c = 0; c < CPL; ++c) acc[c] = 0;
        }
        lo_prev = lo_i;
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
        score_out[p] = mx;
        jend_out[p] = lo_prev + kb;
    }
}

__global__ void banded_walk_kernel(
        const uint32_t* __restrict__ moves, const int32_t* __restrict__ qlens,
        const int32_t* __restrict__ tlens, const int32_t* __restrict__ jend,
        int32_t* __restrict__ jstart, int32_t* __restrict__ irem,
        uint8_t* __restrict__ edge_out, uint32_t* __restrict__ ops,
        int P, int nq8, int W, int n_steps, int ops_words) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const int32_t ql = qlens[p], tl = tlens[p];
    const uint32_t* mrow = moves + (size_t)p * nq8 * W;
    uint32_t* orow = ops + (size_t)p * ops_words;
    const int32_t imax = nq8 * 8 - 1;

    int32_t i = ql, j = jend[p];
    int st = 0;
    bool edge = false;
    int64_t cached = -1;      // flat index of the word in ``word``
    uint32_t word = 0, cur = 0;
    int step = 0;
    for (; step < n_steps && i > 0; ++step) {
        const int32_t lo_i = band_lo(i, ql, tl, W);
        const int32_t k = j - lo_i;
        // interior band edges only (the rule of kernels/banded.py)
        edge |= (k == 0 && lo_i > 0) || (k == W - 1 && lo_i + W <= tl);
        const int32_t im1 = min(max(i - 1, 0), imax);
        const int32_t kc = min(max(k, 0), W - 1);
        const int64_t flat = (int64_t)(im1 >> 3) * W + kc;
        if (flat != cached) { word = mrow[flat]; cached = flat; }
        const uint32_t mv = (word >> (4 * (im1 & 7))) & 0xFu;
        const uint32_t src = mv & 3u;
        const bool is_e = st == 1 || (st == 0 && src == 1u);
        const bool is_f = st == 2 || (st == 0 && src == 2u);
        const bool is_d = st == 0 && src == 0u;
        const uint32_t op = is_d ? 1u : (is_e ? 2u : 3u);
        st = (is_e && (mv & 4u)) ? 1 : ((is_f && (mv & 8u)) ? 2 : 0);
        i -= (is_d || is_e);
        j -= (is_d || is_f);
        cur |= op << (2 * (step & 15));
        if ((step & 15) == 15) { orow[step >> 4] = cur; cur = 0; }
    }
    if (step & 15) orow[step >> 4] = cur;
    jstart[p] = j;
    irem[p] = i;
    edge_out[p] = edge;
}

template <int CPL>
int launch_fwd(const void* Q, const void* T, const void* ql, const void* tl,
               void* score, void* jend, void* moves, int P, int nq, int nt,
               int match, int mismatch, int gap_open, int gap_ext,
               cudaStream_t stream) {
    // target staging: nt_pad bytes per warp; up to 4 pairs per block
    const int nt_pad = (nt + 15) & ~15;
    int wpb = 4;
    while (wpb > 1 && (size_t)wpb * nt_pad > 96 * 1024) wpb >>= 1;
    const size_t smem = (size_t)wpb * nt_pad;
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
        (uint32_t*)moves, P, nq, nt, nt_pad, match, mismatch, gap_open,
        gap_ext);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* c3t_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Q (P, nq) int8 and T (P, nt) int8 pad 4; ql, tl (P,) int32; outputs
// score, jend (P,) int32 and moves (P, ceil(nq/8), W) 32-bit words,
// which must be zeroed by the caller (rows past ql are not written).
// W in {32, 64, 128, 256}; 11 = unsupported band (cudaErrorInvalidValue).
int c3t_banded_fwd(const void* Q, const void* T, const void* ql,
                   const void* tl, void* score, void* jend, void* moves,
                   int P, int nq, int nt, int W, int match, int mismatch,
                   int gap_open, int gap_ext, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
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

// moves (P, nq8, W) words from c3t_banded_fwd; jend (P,) int32; outputs
// jstart, irem (P,) int32, edge (P,) uint8 and ops (P, ops_words) 32-bit
// words of 2-bit ops (1 diag, 2 ins, 3 del), zeroed by the caller.
int c3t_banded_walk(const void* moves, const void* ql, const void* tl,
                    const void* jend, void* jstart, void* irem, void* edge,
                    void* ops, int P, int nq8, int W, int n_steps,
                    int ops_words, void* stream) {
    const int nthr = 128;
    banded_walk_kernel<<<(P + nthr - 1) / nthr, nthr, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)moves, (const int32_t*)ql, (const int32_t*)tl,
        (const int32_t*)jend, (int32_t*)jstart, (int32_t*)irem,
        (uint8_t*)edge, (uint32_t*)ops, P, nq8, W, n_steps, ops_words);
    return (int)cudaGetLastError();
}

}  // extern "C"
