// Host driver of the splint-profile kernel's row arithmetic, for the CPU
// tests (tests/test_torch_profile_cuh.py builds it with g++).
//
// It runs the control flow of c3poa_tpu_torch/kernels/csrc/profile.cu
// serially over the functions of profile.cuh, one block at a time: the
// zero tiles past a read's end, the row tables and the slots filled as
// the kernel fills them, each thread's one-hot read codes and registers,
// and per (warp, row) the 32 lanes' cells, the five shuffles of the warp
// scan and the exclusive shuffle as array shifts (a lane past 31 reads
// its own value, as __shfl_down_sync does), the carry from the slot the
// kernel reads, the slot it publishes, and each lane's carry in, which is
// its next row's right neighbour; the rows start where the kernel's do,
// at the splint's last real code.  The warps run in one of several
// interleavings, each of
// which the kernel's wavefront may take: each warp through all rows from
// the last warp down, row by row, or a seeded random choice among the
// warps whose slot is written; reading a slot no warp has written fails.
#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "profile.cuh"

namespace {

constexpr int K = PF_K;
constexpr int NW = PF_WARPS;

struct Thread {
    uint32_t hot[K];
    int32_t G[K], cm[K];
    int32_t right;
};

struct Block {
    std::vector<uint32_t> tab;
    std::vector<int32_t> cum;
    std::vector<Thread> th;
    int gap;
    int t0;      // the first row of a real code
};

// one row of one warp; false when its slot was not written yet
bool warp_row(Block& blk, int w, int t) {
    int32_t s[32], o[32];
    Thread* th = &blk.th[w * 32];
    for (int l = 0; l < 32; ++l) {
        int32_t Y[K];
        pf_cells<K>(th[l].G, th[l].right, blk.tab[t], th[l].hot, -blk.gap, Y);
        s[l] = pf_total(Y);
    }
    for (int d = 1; d < 32; d <<= 1) {
        for (int l = 0; l < 32; ++l) o[l] = s[l + d < 32 ? l + d : l];
        for (int l = 0; l < 32; ++l)
            s[l] = pf_scan(s[l], o[l], pf_span(d, blk.gap));
    }
    int32_t ex[32];
    for (int l = 0; l < 32; ++l) ex[l] = s[l + 1 < 32 ? l + 1 : l];
    const int32_t carry = blk.cum[pf_slot(t, pf_source(w))];
    if (carry == PF_EMPTY) return false;
    blk.cum[pf_slot(t, w)] = pf_publish(s[0], carry, pf_span(32, blk.gap));
    for (int l = 0; l < 32; ++l) {
        th[l].right = pf_cin(ex[l], pf_lane_mask(l), carry,
                             pf_span(31 - l, blk.gap));
        pf_finish<K>(th[l].G, th[l].right, -blk.gap, th[l].cm);
    }
    return true;
}

// all rows of a block in interleaving ``order``; false on a slot read
// before it was written
bool run_rows(Block& blk, int m, int order) {
    if (order == 0) {
        for (int w = NW - 1; w >= 0; --w)
            for (int t = blk.t0; t < m; ++t)
                if (!warp_row(blk, w, t)) return false;
        return true;
    }
    if (order == 1) {
        for (int t = blk.t0; t < m; ++t)
            for (int w = NW - 1; w >= 0; --w)
                if (!warp_row(blk, w, t)) return false;
        return true;
    }
    // a seeded choice among the warps that can go on
    uint64_t x = 0x9E3779B97F4A7C15ull * (uint64_t)order;
    int next[NW];
    for (int w = 0; w < NW; ++w) next[w] = blk.t0;
    for (int left = NW * (m - blk.t0); left > 0; --left) {
        int ready[NW], n = 0;
        for (int w = 0; w < NW; ++w)
            if (next[w] < m &&
                blk.cum[pf_slot(next[w], pf_source(w))] != PF_EMPTY)
                ready[n++] = w;
        if (n == 0) return false;
        x = x * 6364136223846793005ull + 1442695040888963407ull;
        const int w = ready[(x >> 33) % (uint64_t)n];
        if (!warp_row(blk, w, next[w]++)) return false;
    }
    return true;
}

// one block (tile, combo c, read b); false on a slot read too early
bool block(const int8_t* reads, const int32_t* lens, const int8_t* splints,
           int32_t* out, int L, int C, int m, int core, int match,
           int mismatch, int gap, int tile, int c, int b, int order) {
    const int col0 = tile * core;
    int32_t* orow = out + ((size_t)b * C + c) * (size_t)L;
    if (col0 >= lens[b]) {
        for (int jl = 0; jl < PF_TW; ++jl)
            if (jl < core && col0 + jl < L) orow[col0 + jl] = 0;
        return true;
    }
    Block blk;
    blk.tab.resize(m + 1);
    blk.t0 = m;
    for (int t = 0; t <= m; ++t) {
        const int qc = t < m ? splints[(size_t)c * m + m - 1 - t] : 4;
        blk.tab[t] = pf_sub_table(qc, match, mismatch);
        if (pf_real_code(qc) && t < blk.t0) blk.t0 = t;
    }
    blk.cum.assign((size_t)m * PF_CUM_STRIDE, PF_EMPTY);
    for (int t = 0; t < m; ++t) blk.cum[pf_slot(t, NW)] = 0;
    blk.gap = gap;
    blk.th.resize(PF_THREADS);
    for (int tid = 0; tid < PF_THREADS; ++tid) {
        Thread& th = blk.th[tid];
        for (int k = 0; k < K; ++k) {
            const int j = col0 + tid * K + k;
            th.hot[k] = pf_hot(j < L ? reads[(size_t)b * L + j] : 4);
            th.G[k] = 0;
            th.cm[k] = 0;
        }
        th.right = 0;
    }
    if (!run_rows(blk, m, order)) return false;
    for (int tid = 0; tid < PF_THREADS; ++tid)
        for (int k = 0; k < K; ++k) {
            const int jl = tid * K + k, j = col0 + jl;
            if (jl < core && j < L)
                orow[j] = blk.th[tid].cm[k];
        }
    return true;
}

}  // namespace

extern "C" {

// the kernel's tile width
int pf_tile_width(void) { return PF_TW; }

// a block's shared memory in bytes, all of it dynamic
unsigned pf_host_smem_bytes(int m) { return pf_smem_bytes(m); }

// pf_dot and pf_addmax_relu, for the tests' check of their semantics
int32_t pf_host_dot(uint32_t a, uint32_t b, int32_t c) {
    return pf_dot(a, b, c);
}
int32_t pf_host_addmax_relu(int32_t a, int32_t b, int32_t c) {
    return pf_addmax_relu(a, b, c);
}

// As c3t_start_profile, with the warps' interleaving chosen by the
// caller (0: warp by warp from the last, 1: row by row, >= 2: a seeded
// choice).  Returns 0; -1 for a scoring whose bytes do not fit; -2 when a
// warp would read a slot no warp has written.
int pf_host(const int8_t* reads, const int32_t* lens, const int8_t* splints,
            int32_t* out, int B, int L, int C, int m, int ov, int match,
            int mismatch, int gap, int order) {
    if (!pf_scoring_fits(match, mismatch, gap)) return -1;
    const int core = PF_TW - ov;
    const int tiles = (L + core - 1) / core;
    for (int b = 0; b < B; ++b)
        for (int c = 0; c < C; ++c)
            for (int tile = 0; tile < tiles; ++tile)
                if (!block(reads, lens, splints, out, L, C, m, core, match,
                           mismatch, gap, tile, c, b, order))
                    return -2;
    return 0;
}

}  // extern "C"
