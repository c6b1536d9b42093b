// Issue-cost probe: NITER iterations of M dependent int32 operations
// over 1, 2 or 4 independent register chains, on one SM.
//
// Replaces the TPU probe tools/mosaic_floor_probe.py (build :29,
// pallas_call :60, body :38-56), which measured the per-op issue cost of
// Mosaic vector ops on one TPU core.  Plain twin:
// c3poa_tpu_torch/kernels/probes.py:floor_probe_plain.
//
// Semantics (the TPU body's), elementwise over x (S, 128) int32: c = x;
// chain h starts at c + h; each iteration runs M/2 pairs round-robin
// over the NCH chains,
//   x_h = x_h + c;  x_h = max(x_h, c - x_h)
// and the result is the max over the chains.  Additions and subtractions
// are done in unsigned arithmetic, so they wrap as jnp int32 does (a
// signed overflow would be undefined in C++).
//
// What bounds it: integer issue on ONE SM, by design (64 INT32 lanes a
// clock on Hopper; three operations a pair as written).  The TPU probe
// measured one core; this measures one block of 1024 threads on one SM.
//
// Design: thread t holds the S/8 elements k * 1024 + t (an (8, 128) tile
// is one element per thread), each with NCH chains.  A thread can hold
// at most 64 registers at 1024 threads, fewer than the TPU's vector
// memory holds, so a thread runs its elements in passes of E (E * NCH <=
// 8 chains, E dividing S/8): each pass runs all NITER iterations over
// its E elements, the M operations of an iteration interleaved over
// them as the TPU's vector op spans its tiles.  The M operations are
// unrolled at compile time (a template over NCH, M and E); the NITER loop
// stays a loop (#pragma unroll 1), so that the SASS of its body shows
// what the compiler made of the chain (c3poa_tpu_torch/tools/
// floor_probe.py counts it: c - (x + c) folds to -x, for one).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;           // threads: one block on one SM
constexpr int MAX_CHAINS = 8;      // E * NCH per pass

template <int NCH, int M, int E>
__global__ void __launch_bounds__(NT, 1)
floor_probe_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                   int per_thread, int niter) {
    static_assert(M % (2 * NCH) == 0, "M % (2 * NCH) != 0");
    static_assert(E * NCH <= MAX_CHAINS, "too many chains a pass");
    const int t = threadIdx.x;
    for (int p = 0; p < per_thread; p += E) {
        uint32_t c[E], v[E][NCH];
        #pragma unroll
        for (int e = 0; e < E; ++e) {
            c[e] = (uint32_t)x[(size_t)(p + e) * NT + t];
            #pragma unroll
            for (int h = 0; h < NCH; ++h) v[e][h] = c[e] + (uint32_t)h;
        }
        #pragma unroll 1
        for (int it = 0; it < niter; ++it) {
            #pragma unroll
            for (int k = 0; k < M / (2 * NCH); ++k) {
                #pragma unroll
                for (int h = 0; h < NCH; ++h) {
                    #pragma unroll
                    for (int e = 0; e < E; ++e) {
                        const uint32_t s = v[e][h] + c[e];
                        v[e][h] = (uint32_t)max((int32_t)s,
                                                (int32_t)(c[e] - s));
                    }
                }
            }
        }
        #pragma unroll
        for (int e = 0; e < E; ++e) {
            int32_t acc = (int32_t)v[e][0];
            #pragma unroll
            for (int h = 1; h < NCH; ++h) acc = max(acc, (int32_t)v[e][h]);
            out[(size_t)(p + e) * NT + t] = acc;
        }
    }
}

template <int NCH, int M, int E>
int launch(const int32_t* x, int32_t* out, int per_thread, int niter,
           cudaStream_t stream) {
    floor_probe_kernel<NCH, M, E><<<1, NT, 0, stream>>>(x, out, per_thread,
                                                        niter);
    return 0;
}

template <int NCH, int M>
int launch_e(int e, const int32_t* x, int32_t* out, int per_thread,
             int niter, cudaStream_t stream) {
    switch (e) {
    case 1: return launch<NCH, M, 1>(x, out, per_thread, niter, stream);
    case 2: return launch<NCH, M, 2>(x, out, per_thread, niter, stream);
    case 4:
        if constexpr (4 * NCH <= MAX_CHAINS)
            return launch<NCH, M, 4>(x, out, per_thread, niter, stream);
        break;
    case 8:
        if constexpr (8 * NCH <= MAX_CHAINS)
            return launch<NCH, M, 8>(x, out, per_thread, niter, stream);
        break;
    }
    return (int)cudaErrorInvalidValue;
}

// the M values the probe is built for (kernels/probes.py:FLOOR_M)
template <int NCH>
int launch_m(int m, int e, const int32_t* x, int32_t* out, int per_thread,
             int niter, cudaStream_t stream) {
    switch (m) {
    case 8: return launch_e<NCH, 8>(e, x, out, per_thread, niter, stream);
    case 16: return launch_e<NCH, 16>(e, x, out, per_thread, niter, stream);
    case 32: return launch_e<NCH, 32>(e, x, out, per_thread, niter, stream);
    case 64: return launch_e<NCH, 64>(e, x, out, per_thread, niter, stream);
    case 128: return launch_e<NCH, 128>(e, x, out, per_thread, niter,
                                        stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* c3t_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// x, out (S, 128) int32, contiguous on the device, S a positive multiple
// of 8; per_thread = S / 8 elements a thread, in passes of e (a divisor
// of per_thread with e * nch <= 8).  Launches one block on ``stream``.
int c3t_floor_probe(const void* x, void* out, int per_thread, int m,
                    int niter, int nch, int e, void* stream) {
    const int32_t* xi = (const int32_t*)x;
    int32_t* o = (int32_t*)out;
    const cudaStream_t st = (cudaStream_t)stream;
    int rc = (int)cudaErrorInvalidValue;
    switch (nch) {
    case 1: rc = launch_m<1>(m, e, xi, o, per_thread, niter, st); break;
    case 2: rc = launch_m<2>(m, e, xi, o, per_thread, niter, st); break;
    case 4: rc = launch_m<4>(m, e, xi, o, per_thread, niter, st); break;
    }
    if (rc != 0) return rc;
    return (int)cudaGetLastError();
}

}  // extern "C"
