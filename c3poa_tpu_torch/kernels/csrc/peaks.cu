// The locate step's peak candidates: each read's median, its 6x-median
// gate and 3x-median height, the plateau-aware local maxima, a per-tile
// top-2 compaction, and the `deep` and `margin` flags.
//
// Replaces the jitted XLA step c3poa_tpu/kernels/peaks.py:112
// (peak_candidates_batch, inside _locate_device_jit,
// c3poa_tpu/kernels/locate.py); plain twin
// c3poa_tpu_torch/kernels/peaks.py:peak_candidates_batch, which it equals
// bit for bit on every output.  The function, its domain, the schedule's
// helpers and the proofs are in peaks.cuh.
//
// What bounds it on an H100: bytes.  One read of the (B, L) float32 rows
// and the lengths and the outputs written once: 0.00532 ms at B = 128,
// L = 32768 (chip_smoke.py:peaks_row); the operations, a few a column for
// each pass of the median and a few a column for the candidates, fall
// below that.  So the row is read from global memory once.
//
// Design: one kernel, one launch, a cluster of R CTAs (ranks) of 512
// threads a read (cudaLaunchKernelEx with a cluster dimension).  R is
// pk_default_ranks: the largest power of two up to 8 (the largest portable
// cluster) with B * R <= the SMs, at least what shares of 32768 columns
// need, so rows up to PK_MAX_L = 262144 columns.  Rank r holds its
// share of the row, S columns (a power of two, at least 4096), as
// order-preserving uint32 keys (pk_key; NEG_F's past the read) in its
// dynamic shared memory, loaded once with 16-byte loads (four in flight a
// thread) where the row allows them; everything after reads the share
// there, and the ranks meet only through stores into each other's shared
// memory (DSMEM, cluster.map_shared_rank) and cluster barriers:
// (a) the median, a radix select over the keys, PK_PASSES = 4 passes of
//     8-bit digits (the pass loop unrolled, so each pass's digit and
//     group test are constants).  A pass sweeps the share's 16-byte chunks
//     in order, four a thread loaded before any is counted, counting the
//     digits of the keys in the group chosen so far into 32 lane copies of
//     the histogram (a predicated shared add a key, never two lanes of a
//     warp on one word), folds them into the rank's histogram
//     and stores it into every rank's inbox (two passes' inboxes kept
//     apart, so one cluster barrier a pass is enough); then each rank
//     sums the R histograms and every warp picks the digit of rank k from
//     the sum: every rank makes the same pick.  When n is even the second
//     rank, k + 1, is in the last histogram or, when k's key ends its
//     group, is the least key above it (one more sweep and barrier).  The
//     first pass also publishes the share's max key and latest run start.
// (b) the candidates.  Warp w owns S / 16 consecutive columns and goes over
//     them a step of 256 at a time, 8 consecutive columns a lane (two
//     16-byte loads; the chunks are swizzled, peaks.cuh:pk_chunk_at, so the
//     32 lanes' loads use every bank), the neighbours' columns by
//     shuffles.  The run entering the share is the latest start that the
//     ranks below it published, the one entering a warp adds the warps
//     before it, and a step's lanes take theirs by a max-scan of shuffles.
//     A step none of whose columns passes the skip test (at or above 0.999
//     x height, peaks.cuh:pk_matter_floor) writes its tiles empty; in the
//     others each passing column pays the peak and margin tests
//     (pk_column), a tile of at most 8 columns is written by its lane, a
//     wider one is merged over its tile / 8 lanes (a shuffle butterfly,
//     where a lane holds an entry).
// (c) `deep` and `margin`: each rank ORs its threads' flags and stores
//     them into rank 0's shared memory; after the last cluster barrier
//     rank 0 writes the read's two bytes once, and med, height, gated and
//     tol.  No CTA touches another's shared memory after that barrier, and
//     none touches another's before the first (the arrive at the kernel's
//     start, the wait before the first store), so none exits while
//     another may still use its shared memory, and none is written before
//     it runs.
// No FFMA anywhere: every float operation goes through __fmul_rn /
// __fadd_rn / __fsub_rn (chip_smoke.py checks the SASS).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "peaks.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
static_assert(PK_THREADS >= PK_BINS, "thread t < PK_BINS folds bin t");
static_assert(PK_BINS == 32 * 8, "a warp picks over 8 bins a lane");
static_assert(PK_SHARE_ALIGN % PK_MAX_TILE == 0, "whole tiles a share");
static_assert(PK_SHARE_ALIGN % (PK_WARPS * PK_STEP) == 0,
              "warps' segments of whole steps");
static_assert(PK_MAX_TILE / PK_COLS <= 32, "a tile's lanes are one warp's");
static_assert(PK_COLS == 8, "a lane's columns are two 16-byte chunks");
static_assert(PK_MAX_RANKS <= 32, "a warp's lanes read the ranks' scalars");

// the k-th key's digit of the merged histogram, picked by a whole warp:
// each lane takes 8 bins and the count below them, the lane that finds k
// (pk_pick) broadcasts it; with `two`, whether k + 1 also lies in this
// histogram and its digit
struct Pick {
    int d;
    uint32_t below;
    bool found2;
    int d2;
};

__device__ Pick warp_pick(const uint32_t* hg, uint32_t k, bool two) {
    const int lane = threadIdx.x & 31;
    const uint32_t* h = hg + 8 * lane;
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
    int d = 0, d2 = 0;
    uint32_t below_d = 0, below2;
    const unsigned at = __ballot_sync(FULL, pk_pick(h, 8, below, k, &d,
                                                    &below_d));
    const int src = at ? __ffs(at) - 1 : 0;
    Pick p;
    p.d = 8 * src + __shfl_sync(FULL, d, src);
    p.below = __shfl_sync(FULL, below_d, src);
    const unsigned at2 =
        two ? __ballot_sync(FULL, pk_pick(h, 8, below, k + 1, &d2, &below2))
            : 0u;
    const int src2 = at2 ? __ffs(at2) - 1 : 0;
    p.found2 = at2 != 0;
    p.d2 = 8 * src2 + __shfl_sync(FULL, d2, src2);
    return p;
}

__device__ __forceinline__ PkTop3 shfl_xor3(PkTop3 t, int off) {
    return PkTop3{__shfl_xor_sync(FULL, t.a, off),
                  __shfl_xor_sync(FULL, t.b, off),
                  __shfl_xor_sync(FULL, t.c, off)};
}

// the warp's max (unsigned) and min (unsigned) of one value a lane
__device__ __forceinline__ uint32_t warp_umax(uint32_t v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = max(v, __shfl_xor_sync(FULL, v, off));
    return v;
}

__device__ __forceinline__ uint32_t warp_umin(uint32_t v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = min(v, __shfl_xor_sync(FULL, v, off));
    return v;
}

// The latest run start among the share's columns [lo, hi) (pk_start_at_n,
// else 32 columns a step from the right: the first start found is the
// latest), or -1; for the whole warp, lo and hi the same in every lane.
__device__ int warp_latest_start(const uint32_t* xs, uint32_t left, int c0,
                                 int lo, int hi, int n) {
    const int lane = threadIdx.x & 31;
    int lat = pk_start_at_n(c0 + lo, hi - lo, n);
    for (int e = lo + pk_valid_cols(c0 + lo, hi - lo, n); e > lo && lat < 0;
         e -= 32) {
        const int i = e - 1 - lane;
        const int st = i >= lo ? pk_start(c0 + i, pk_share_key(xs, left, i),
                                          pk_share_key(xs, left, i - 1))
                               : -1;
        const unsigned at = __ballot_sync(FULL, st >= 0);
        if (at)
            lat = __shfl_sync(FULL, st, __ffs(at) - 1);
    }
    return lat;
}

// one shared-memory add of 1 where `count` holds (a predicated red, no
// branch; a memory clobber, so it stays before the barrier that ends the
// sweep)
__device__ __forceinline__ void count_if(bool count, uint32_t* at) {
    asm volatile(
        "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %0, 0;\n\t"
        "@q red.shared.add.u32 [%1], 1;\n\t}" ::"r"((uint32_t)count),
        "r"((uint32_t)__cvta_generic_to_shared(at))
        : "memory");
}

// a word stored into the same place of every rank's shared memory
__device__ __forceinline__ void to_all(cg::cluster_group& cluster,
                                       uint32_t* at, int R, uint32_t v) {
    for (int q = 0; q < R; ++q)
        *cluster.map_shared_rank(at, q) = v;
}

__global__ void __launch_bounds__(PK_THREADS, PK_MIN_CTAS)
pk_kernel(const float* __restrict__ sm, const int32_t* __restrict__ lens,
          int32_t* __restrict__ cand_pos, float* __restrict__ cand_h,
          float* __restrict__ med_out, float* __restrict__ height_out,
          uint8_t* __restrict__ gated_out, uint8_t* __restrict__ deep_out,
          uint8_t* __restrict__ margin_out, float* __restrict__ tol_out,
          int L, int tile, int S) {
    extern __shared__ uint4 smem4[];
    uint32_t* smem = (uint32_t*)smem4;
    cg::cluster_group cluster = cg::this_cluster();
    // every rank has started before any stores into another's shared
    // memory (the wait is just before the first such store)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    const int R = (int)cluster.num_blocks();
    const int r = (int)cluster.block_rank();
    const int b = blockIdx.x / R;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wseg = S / PK_WARPS;  // a warp's segment
    const PkSmem lay = pk_smem(S, R);
    uint32_t* xs = smem + lay.xs;
    const uint4* xs4 = smem4;
    uint32_t* rep = smem + lay.rep;
    uint32_t* inbox = smem + lay.inbox;
    uint32_t* hg = smem + lay.hg;
    uint32_t* pub = smem + lay.pub;
    uint32_t* wmax = smem + lay.scratch;
    uint32_t* wmin = wmax + PK_WARPS;
    int* wlat = (int*)(wmin + PK_WARPS);
    uint32_t* halo = smem + lay.halo;

    const float* row = sm + (size_t)b * L;
    // the wrapper's callers keep 0 <= n <= L; clamped so that no input
    // can send a load outside the row
    int n = lens[b];
    n = n < 0 ? 0 : (n > L ? L : n);
    const int c0 = r * S;
    const int w = pk_share_cols(L, S, r);
    const int wn = pk_valid_cols(c0, w, n);
    const uint32_t kneg = pk_key(PK_NEG_F);

    // the share's keys (NEG_F's past the read), and each thread's max key
    uint32_t kmax = 0;
    if ((L & 3) == 0 && ((uintptr_t)sm & 15) == 0) {
        // PK_LOADS 16-byte loads a thread issued before any is used
        const float4* row4 = (const float4*)(row + c0);
        for (int q0 = tid; q0 < S / 4; q0 += PK_LOADS * PK_THREADS) {
            float4 f[PK_LOADS];
#pragma unroll
            for (int u = 0; u < PK_LOADS; ++u) {
                const int q = q0 + u * PK_THREADS;
                f[u] = q < S / 4 && 4 * q < wn
                           ? __ldg(row4 + q)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
#pragma unroll
            for (int u = 0; u < PK_LOADS; ++u) {
                const int q = q0 + u * PK_THREADS, i = 4 * q;
                if (q < S / 4) {
                    const uint4 kk = make_uint4(
                        i < wn ? pk_key(f[u].x) : kneg,
                        i + 1 < wn ? pk_key(f[u].y) : kneg,
                        i + 2 < wn ? pk_key(f[u].z) : kneg,
                        i + 3 < wn ? pk_key(f[u].w) : kneg);
                    kmax = max(kmax, max(max(kk.x, kk.y), max(kk.z, kk.w)));
                    smem4[lay.xs / 4 + pk_chunk_at(q)] = kk;
                }
            }
        }
    } else {
        for (int i = tid; i < S; i += PK_THREADS) {
            const uint32_t k = i < wn ? pk_key(row[c0 + i]) : kneg;
            kmax = max(kmax, k);
            xs[pk_key_at(i)] = k;
        }
    }
    if (tid == 0)
        halo[0] = pk_key(pk_xm(row, c0 - 1, n));
    if (tid == 32)
        halo[1] = pk_key(pk_xm(row, c0 + S, n));
    for (int i = tid; i < PK_REP_WORDS; i += PK_THREADS)
        rep[i] = 0;
    kmax = warp_umax(kmax);
    if (lane == 0)
        wmax[warp] = kmax;
    __syncthreads();

    // each warp's latest run start over its segment; the CTA's latest is
    // the share's
    const int wseg0 = warp * wseg;
    {
        const int lat = warp_latest_start(
            xs, halo[0], c0, wseg0, wseg0 + pk_share_cols(w, wseg, warp), n);
        if (lane == 0)
            wlat[warp] = lat;
    }

    // (a) the median, sweeping the chunks that hold the read's columns
    const int chunks = pk_sweep_chunks(wn);
    const bool any = n > 0;
    const uint32_t k0 = pk_rank_lo(n);
    const bool two = any && pk_rank_hi(n) != k0;
    uint32_t k = k0, prefix = 0;
    Pick pk{0, 0, false, 0};
    uint32_t xmax_key = 0;
    int carry = -1;
    // the pass index a constant in each copy of the unrolled loop
#pragma unroll
    for (int p = 0; p < PK_PASSES; ++p) {
        // PK_LOADS chunks a thread loaded before any is counted
        for (int q0 = tid; q0 < chunks; q0 += PK_LOADS * PK_THREADS) {
            uint4 c[PK_LOADS];
#pragma unroll
            for (int u = 0; u < PK_LOADS; ++u) {
                const int q = q0 + u * PK_THREADS;
                c[u] = q < chunks ? xs4[q]
                                  : make_uint4(kneg, kneg, kneg, kneg);
            }
#pragma unroll
            for (int u = 0; u < PK_LOADS; ++u) {
                const uint32_t kk[4] = {c[u].x, c[u].y, c[u].z, c[u].w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    count_if(pk_counted(kk[e], prefix, p, kneg),
                             rep + pk_rep_word(pk_digit(kk[e], p), lane));
            }
        }
        __syncthreads();
        if (p == 0)
            asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
        // fold the lane copies into bin tid of this pass's histogram,
        // clear them for the next pass, and store the bin into every
        // rank's inbox
        if (tid < PK_BINS) {
            uint32_t bin = 0;
            uint32_t* rw = rep + tid * 32;
#pragma unroll
            for (int q = 0; q < 32; ++q) {
                const int at = pk_rep_lane(tid, q);
                bin += rw[at];
                rw[at] = 0;
            }
            to_all(cluster, inbox + ((p & 1) * R + r) * PK_BINS + tid, R,
                   bin);
        }
        if (p == 0 && tid < 2) {
            // the share's max key and latest start, into every rank
            uint32_t v = 0;
            int l = -1;
            for (int q = 0; q < PK_WARPS; ++q) {
                v = max(v, wmax[q]);
                l = pk_latest(l, wlat[q]);
            }
            to_all(cluster, pub + PK_PUB_WORDS * r + tid, R,
                   tid ? (uint32_t)l : v);
        }
        cluster.sync();
        if (p == 0) {
            // the row's max, and the carry into this share
            for (int q = 0; q < R; ++q) {
                xmax_key = max(xmax_key, pub[PK_PUB_WORDS * q]);
                if (pk_carries(q, r))
                    carry = pk_latest(carry, (int)pub[PK_PUB_WORDS * q + 1]);
            }
        }
        if (!any)
            break;
        if (tid < PK_BINS) {
            const uint32_t* box = inbox + (p & 1) * R * PK_BINS + tid;
            uint32_t sum = 0;
            for (int q = 0; q < R; ++q)
                if (pk_merges(q, R))
                    sum += box[q * PK_BINS];
            hg[tid] = sum;
        }
        __syncthreads();
        pk = warp_pick(hg, k, two && p == PK_PASSES - 1);
        prefix = (prefix << PK_DIGIT) | (uint32_t)pk.d;
        k -= pk.below;
    }
    uint32_t klo = PK_EMPTY_KEY, khi = PK_EMPTY_KEY;
    if (any) {
        klo = khi = prefix;
        if (two && pk.found2) {
            khi = ((prefix >> PK_DIGIT) << PK_DIGIT) | (uint32_t)pk.d2;
        } else if (two) {
            // the least key above klo (NEG_F's lie below it): each rank's,
            // then the cluster's
            uint32_t least = 0xffffffffu;
            for (int q = tid; q < chunks; q += PK_THREADS) {
                const uint4 c = xs4[q];
                const uint32_t kk[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (kk[e] > klo && kk[e] < least)
                        least = kk[e];
            }
            least = warp_umin(least);
            if (lane == 0)
                wmin[warp] = least;
            __syncthreads();
            if (tid == 0) {
                for (int q = 0; q < PK_WARPS; ++q)
                    least = min(least, wmin[q]);
                to_all(cluster, pub + PK_PUB_WORDS * r + 2, R, least);
            }
            cluster.sync();
            khi = 0xffffffffu;
            for (int q = 0; q < R; ++q)
                khi = min(khi, pub[PK_PUB_WORDS * q + 2]);
        }
    }
    const float med = pk_median(klo, khi);
    const PkGate g = pk_gate(pk_unkey(xmax_key), med);

    // (b) the candidates: each warp its segment, a step at a time
    const int M = L / tile;
    int32_t* pos = cand_pos + (size_t)b * 2 * M;
    float* hs = cand_h + (size_t)b * 2 * M;
    const PkRead rd = pk_read(g);
    int before = carry;  // the latest start before the warp's step
    for (int q = 0; q < warp; ++q)
        before = pk_latest(before, wlat[q]);
    bool third = false, marg = false;
    uint32_t prev = pk_share_key(xs, halo[0], wseg0 - 1);
    for (int base = wseg0; base < wseg0 + wseg; base += PK_STEP) {
        const int i0 = base + PK_COLS * lane;
        const uint4 a = xs4[pk_chunk_at(i0 >> 2)];
        const uint4 z = xs4[pk_chunk_at((i0 >> 2) + 1)];
        // the column after the step: the next step's first, or the
        // share's right neighbour
        const uint32_t after = base + PK_STEP < S
                                   ? xs[pk_key_at(base + PK_STEP)]
                                   : halo[1];
        uint32_t before_key = __shfl_up_sync(FULL, z.w, 1);
        uint32_t next = __shfl_down_sync(FULL, a.x, 1);
        if (lane == 0)
            before_key = prev;
        if (lane == 31)
            next = after;
        prev = __shfl_sync(FULL, z.w, 31);
        const uint32_t v[PK_WINDOW] = {before_key, a.x, a.y, a.z, a.w,
                                       z.x, z.y, z.z, z.w, next};
        const int live = w - i0, j0 = c0 + i0;
        int incl = pk_thread_latest(v, j0, live);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int u = __shfl_up_sync(FULL, incl, off);
            if (lane >= off)
                incl = pk_latest(incl, u);
        }
        int run = __shfl_up_sync(FULL, incl, 1);
        if (lane == 0)
            run = -1;
        run = pk_latest(run, before);
        before = pk_latest(before, __shfl_sync(FULL, incl, 31));
        if (__any_sync(FULL, pk_thread_may(v, live, rd.cut))) {
            const PkThread o =
                pk_thread(v, j0, live, n, run, rd, tile, M, pos, hs);
            third = third || o.third;
            marg = marg || o.margin;
            if (tile > PK_COLS) {
                // the butterfly, where a lane of the step holds an entry
                const int lanes = tile / PK_COLS;
                PkTop3 t = o.top;
                if (__any_sync(FULL, t.a != 0))
                    for (int off = 1; off < lanes; off <<= 1)
                        t = pk_top3_merge(t, shfl_xor3(t, off));
                if (lane % lanes == 0 && live > 0) {
                    pk_write_tile(pos, hs, M, j0 / tile, t);
                    third = third || t.c != 0;
                }
            }
        } else {
            pk_thread_empty(j0, live, tile, M, pos, hs);
        }
    }

    // (c) the flags, ORed over the cluster into rank 0
    const uint32_t f = (__syncthreads_or(third) ? 1u : 0u) |
                       (__syncthreads_or(marg) ? 2u : 0u);
    if (tid == 0)
        *cluster.map_shared_rank(pub + PK_PUB_WORDS * r + 3, 0) = f;
    cluster.sync();
    if (r == 0 && tid == 0) {
        uint32_t all = 0;
        for (int q = 0; q < R; ++q)
            all |= pub[PK_PUB_WORDS * q + 3];
        med_out[b] = med;
        height_out[b] = g.height;
        gated_out[b] = g.gated;
        tol_out[b] = g.tol;
        deep_out[b] = (all & 1) != 0;
        margin_out[b] = g.near_gate || (all & 2) != 0;
    }
}

// the launch of B reads over R ranks a read
cudaLaunchConfig_t pk_config(int B, int L, int R, cudaStream_t s,
                             cudaLaunchAttribute* attr) {
    const int S = pk_share_width(L, R);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(B * R));
    cfg.blockDim = dim3(PK_THREADS);
    cfg.dynamicSmemBytes = (size_t)pk_smem_bytes(S, R);
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)R;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// Once a device: the kernel's opt-in to the widest share's shared memory,
// whether the card holds one cluster of the widest launch (8 ranks of the
// widest share), which every launch needs at most (a launch the card
// refuses returns its error), and its SM count.
std::atomic<unsigned long long> ready_devices{0};
int device_sms[64];

cudaError_t pk_prepare(int* sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess)
        return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (ready_devices.load() & bit) {
        *sms = device_sms[dev & 63];
        return cudaSuccess;
    }
    err = cudaFuncSetAttribute(pk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               pk_smem_bytes(PK_MAX_SHARE, PK_MAX_RANKS));
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess)
        return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        pk_config(1, PK_MAX_L, PK_MAX_RANKS, 0, attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, pk_kernel, &cfg);
    if (err != cudaSuccess)
        return err;
    if (clusters < 1)
        return cudaErrorInvalidConfiguration;
    device_sms[dev & 63] = *sms;
    ready_devices.fetch_or(bit);
    return cudaSuccess;
}

}  // namespace

extern "C" {

const char* c3t_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// sm (B, L) float32 and lens (B,) int32, contiguous on the device;
// cand_pos (B, 2L/tile) int32, cand_h (B, 2L/tile) float32, med, height
// and tol (B,) float32, gated, deep and margin (B,) bytes (torch.bool);
// B > 0, 1 <= L <= PK_MAX_L, tile a power of two <= 64 dividing L.  One
// launch of pk_default_ranks CTAs a read on ``stream``; returns the CUDA
// error of a launch the card refuses, and cudaErrorInvalidValue for a
// shape it cannot take.
int c3t_peak_candidates(const void* sm, const void* lens, void* cand_pos,
                        void* cand_h, void* med, void* height, void* gated,
                        void* deep, void* margin, void* tol, int B, int L,
                        int tile, void* stream) {
    int sms = 0;
    cudaError_t err = pk_prepare(&sms);
    if (err != cudaSuccess)
        return (int)err;
    if (B < 1 || L < 1 || L > PK_MAX_L || tile < 1 || tile > PK_MAX_TILE ||
        (tile & (tile - 1)) || L % tile)
        return (int)cudaErrorInvalidValue;
    const int R = pk_default_ranks(L, B, sms);
    if ((long long)B * R > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        pk_config(B, L, R, (cudaStream_t)stream, attr);
    err = cudaLaunchKernelEx(
        &cfg, pk_kernel, (const float*)sm, (const int32_t*)lens,
        (int32_t*)cand_pos, (float*)cand_h, (float*)med, (float*)height,
        (uint8_t*)gated, (uint8_t*)deep, (uint8_t*)margin, (float*)tol, L,
        tile, pk_share_width(L, R));
    if (err != cudaSuccess)
        return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
