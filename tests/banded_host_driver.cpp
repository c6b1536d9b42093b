// Host driver of the banded aligner's kernels, for the CPU tests
// (tests/test_torch_banded.py builds it with g++ -ffp-contract=off).
//
// It runs the control flow of c3poa_tpu_torch/kernels/csrc/banded.cu
// serially over the functions of banded.cuh and band_lo.cuh: a pair's
// forward pass as 32 lanes of CPL band columns, every warp shuffle a loop
// over the lanes (the band shift as a gather over the flat band, the
// prefix max by __shfl_up_sync steps in which a lane below the shuffle
// distance keeps its own value; max is exact, so any order of steps
// gives the same bits), lo(i) and the substitution table fetched 32 rows
// at a time, the move words pushed, bit-reversed and stored per 8 rows,
// zero words past the query; and a pair's walk chunk by chunk over
// bnd_walk_chunk.  Outputs are written
// into caller-filled buffers, so a word the kernel would leave unwritten
// shows.
#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "banded.cuh"

namespace {

constexpr int LANES = 32;

template <int CPL>
void fwd_pair(const int8_t* qrow, const int8_t* trow, int32_t ql, int32_t tl,
              int nq, int nt, int match, int mismatch, int gap_open,
              int gap_ext, int32_t* score_out, int32_t* jend_out,
              uint32_t* mrow) {
    constexpr int W = LANES * CPL;
    const int32_t go = gap_open, e = gap_ext, oe = gap_open + gap_ext;
    const int nq8 = (nq + 7) >> 3;
    const bool masked = tl + 1 < W;
    if (ql > nq) ql = nq;

    const int ts_words = bnd_target_words(nt, W);
    std::vector<uint32_t> ts(ts_words);
    for (int w = 0; w < ts_words; ++w)
        ts[w] = bnd_target_word(trow, tl < nt ? tl : nt, w);

    int32_t H[LANES][CPL], E[LANES][CPL], ek[LANES][CPL];
    uint32_t acc[LANES][CPL], inb[LANES][CPL];
    int32_t lo_prev = band_lo(0, ql, tl, W);
    for (int l = 0; l < LANES; ++l)
        for (int c = 0; c < CPL; ++c) {
            const int k = l * CPL + c;
            inb[l][c] = (!masked || k <= tl) ? 0xffffffffu : 0u;
            H[l][c] = inb[l][c] ? 0 : BND_NEG;
            E[l][c] = BND_NEG;
            ek[l][c] = e * k;
            acc[l][c] = 0;
        }
    int32_t lo_reg[LANES] = {0};
    uint32_t tab_reg[LANES] = {0};
    int qnext[LANES];
    for (int l = 0; l < LANES; ++l) qnext[l] = l < nq ? qrow[l] : 4;

    for (int i = 1; i <= ql; ++i) {
        const int r = (i - 1) & 31;
        if (r == 0)
            for (int l = 0; l < LANES; ++l) {
                lo_reg[l] = band_lo(i + l, ql, tl, W);
                tab_reg[l] = bnd_sub_table(qnext[l], match, mismatch);
                const int qi = i + 31 + l;
                qnext[l] = qi < nq ? qrow[qi] : 4;
            }
        const int32_t lo_i = lo_reg[r];
        const uint32_t table = tab_reg[r];
        const int s = lo_i - lo_prev;
        lo_prev = lo_i;

        BndRow<CPL> row[LANES];
        int32_t v[LANES], nv[LANES];
        for (int l = 0; l < LANES; ++l) {
            int32_t Hp[CPL], Ep[CPL], Hd[CPL];
            for (int c = 0; c < CPL; ++c) {
                const int x = l * CPL + c + s, xd = x - 1;
                Hp[c] = x < W ? H[x / CPL][x % CPL] : BND_NEG;
                Ep[c] = x < W ? E[x / CPL][x % CPL] : BND_NEG;
                Hd[c] = (xd >= 0 && xd < W) ? H[xd / CPL][xd % CPL] : BND_NEG;
            }
            bnd_row_open<CPL>(Hp, Ep, Hd, table,
                              bnd_target_window(ts.data(), lo_i + l * CPL),
                              ek[l], oe, e, go, row[l]);
            v[l] = row[l].pm[CPL - 1];
        }
        for (int d = 1; d < LANES; d <<= 1) {
            for (int l = 0; l < LANES; ++l)
                nv[l] = bnd_max(v[l], l >= d ? v[l - d] : v[l]);
            for (int l = 0; l < LANES; ++l) v[l] = nv[l];
        }
        for (int l = 0; l < LANES; ++l)
            bnd_row_gap<CPL>(l ? v[l - 1] : BND_NEG, ek[l], go, row[l]);
        for (int l = 0; l < LANES; ++l) {
            const int32_t bl = row[l ? l - 1 : 0].b[CPL - 1];
            bnd_row_moves<CPL>(row[l], bl, l == 0, go, acc[l]);
            for (int c = 0; c < CPL; ++c) {
                H[l][c] = inb[l][c] ? row[l].Hn[c] : BND_NEG;
                E[l][c] = inb[l][c] ? row[l].En[c] : BND_NEG;
            }
        }
        if ((i & 7) == 0 || i == ql) {
            const int rows = ((i - 1) & 7) + 1;
            uint32_t* dst = mrow + (size_t)((i - 1) >> 3) * W;
            for (int l = 0; l < LANES; ++l)
                for (int c = 0; c < CPL; ++c)
                    dst[l * CPL + c] =
                        bnd_moves_word(acc[l][c], rows) & inb[l][c];
        }
    }
    for (int g = (ql + 7) >> 3; g < nq8; ++g)
        for (int k = 0; k < W; ++k) mrow[(size_t)g * W + k] = 0;

    int32_t mx = H[0][0];
    for (int l = 0; l < LANES; ++l)
        for (int c = 0; c < CPL; ++c) mx = bnd_max(mx, H[l][c]);
    int32_t kb = W;
    for (int l = LANES - 1; l >= 0; --l)
        for (int c = CPL - 1; c >= 0; --c)
            if (H[l][c] == mx) kb = l * CPL + c;
    *score_out = mx;
    *jend_out = lo_prev + kb;
}

void walk_pair(const uint32_t* mrow, int32_t ql, int32_t tl, int32_t jend,
               int nq8, int W, int n_steps, int ops_words, int32_t* jstart,
               int32_t* irem, uint8_t* edge, uint32_t* orow) {
    if (ql > nq8 * 8) ql = nq8 * 8;
    BndWalk s;
    bnd_walk_init(s, ql, jend);
    while (s.i > 0 && s.step < n_steps) {
        const int c = (s.i - 1) / BND_WALK_ROWS;
        int32_t lo[BND_WALK_ROWS];
        for (int u = 0; u < BND_WALK_ROWS; ++u)
            lo[u] = band_lo(BND_WALK_ROWS * c + 1 + u, ql, tl, W);
        bnd_walk_chunk(mrow + (size_t)c * (BND_WALK_ROWS / 8) * W, lo, W, tl,
                       n_steps, true, orow, s);
    }
    if (s.step & 15) orow[s.step >> 4] = bnd_walk_tail(s.cur, s.step);
    for (int w = (s.step + 15) >> 4; w < ops_words; ++w) orow[w] = 0;
    *jstart = s.j;
    *irem = s.i;
    *edge = s.emin == 0;
}

}  // namespace

extern "C" {

// lo(i) for i = 0 .. n - 1
void bnd_band_lo_host(int32_t ql, int32_t tl, int32_t W, int n, int32_t* out) {
    for (int i = 0; i < n; ++i) out[i] = band_lo(i, ql, tl, W);
}

// The forward kernel's arguments; returns 0, or 1 for an unsupported band.
int bnd_fwd_host(const int8_t* Q, const int8_t* T, const int32_t* ql,
                 const int32_t* tl, int P, int nq, int nt, int W, int match,
                 int mismatch, int gap_open, int gap_ext, int32_t* score,
                 int32_t* jend, uint32_t* moves) {
    const int nq8 = (nq + 7) >> 3;
    for (int p = 0; p < P; ++p) {
        const int8_t* q = Q + (size_t)p * nq;
        const int8_t* t = T + (size_t)p * nt;
        uint32_t* m = moves + (size_t)p * nq8 * W;
        switch (W) {
            case 32: fwd_pair<1>(q, t, ql[p], tl[p], nq, nt, match, mismatch,
                                 gap_open, gap_ext, score + p, jend + p, m);
                     break;
            case 64: fwd_pair<2>(q, t, ql[p], tl[p], nq, nt, match, mismatch,
                                 gap_open, gap_ext, score + p, jend + p, m);
                     break;
            case 128: fwd_pair<4>(q, t, ql[p], tl[p], nq, nt, match, mismatch,
                                  gap_open, gap_ext, score + p, jend + p, m);
                      break;
            case 256: fwd_pair<8>(q, t, ql[p], tl[p], nq, nt, match, mismatch,
                                  gap_open, gap_ext, score + p, jend + p, m);
                      break;
            default: return 1;
        }
    }
    return 0;
}

// The walk kernel's arguments.
int bnd_walk_host(const uint32_t* moves, const int32_t* ql, const int32_t* tl,
                  const int32_t* jend, int P, int nq8, int W, int n_steps,
                  int ops_words, int32_t* jstart, int32_t* irem,
                  uint8_t* edge, uint32_t* ops) {
    for (int p = 0; p < P; ++p)
        walk_pair(moves + (size_t)p * nq8 * W, ql[p], tl[p], jend[p], nq8, W,
                  n_steps, ops_words, jstart + p, irem + p, edge + p,
                  ops + (size_t)p * ops_words);
    return 0;
}

}  // extern "C"
