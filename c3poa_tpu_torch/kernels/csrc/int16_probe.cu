// int16 probe: does the card run int16 max / roll / select / add as
// packed 16-bit instructions?  For x, y (B, 128) int16,
//   out[b, c] = (c >= 3 ? max(x, y)[b, (c - 3) mod 128] : -16000) + 1
// in int16 arithmetic (the add wraps).
//
// Replaces the TPU probe tools/int16_probe.py (kernel :24-31, launched
// by main :34-39), which asked whether Mosaic compiles int16
// max/roll/select: int16 DP state would halve the DP kernels' tiles.
// Plain twin: c3poa_tpu_torch/kernels/probes.py:int16_probe_plain.
// c3poa_tpu_torch/tools/int16_probe.py prints the SASS this compiles to,
// which is the probe's answer on Hopper.
//
// What bounds it on an H100: bytes (two int16 inputs read, one output
// written, four packed operations a word pair); at the tool's (16, 128)
// one launch is all latency.
//
// Design: one warp per row.  Lane l loads columns 4l..4l+3 as two packed
// s16x2 words (one 8-byte load a lane), takes the packed max (__vmaxs2:
// no DPX s16x2 intrinsic is a plain two-input max), fetches the previous
// lane's two words with one __shfl_sync each (lane 0 from lane 31: the
// roll wraps), builds its rolled words with __byte_perm, selects on the
// column index and adds 1 to both halfwords with __vadd2.  The lane
// arithmetic is in int16_probe.cuh.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int16_probe.cuh"

namespace {

constexpr int ROWS = 8;            // rows (warps) per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(ROWS * 32)
int16_probe_kernel(const uint2* __restrict__ x, const uint2* __restrict__ y,
                   uint2* __restrict__ out, int B) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
    if (row >= B) return;          // a whole warp leaves together
    const size_t at = (size_t)row * 32 + lane;
    const uint2 a = x[at], b = y[at];
    const uint32_t m0 = i16p_max(a.x, b.x), m1 = i16p_max(a.y, b.y);
    const int src = i16p_src_lane(lane);
    const uint32_t p0 = __shfl_sync(FULL, m0, src);
    const uint32_t p1 = __shfl_sync(FULL, m1, src);
    uint2 r;
    i16p_lane(lane, p0, p1, m0, &r.x, &r.y);
    out[at] = r;
}

}  // namespace

extern "C" {

const char* c3t_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// x, y, out (B, 128) int16, contiguous and 8-byte aligned on the device,
// B > 0.  Launches on ``stream``.
int c3t_int16_probe(const void* x, const void* y, void* out, int B,
                    void* stream) {
    const int grid = (B + ROWS - 1) / ROWS;
    int16_probe_kernel<<<grid, ROWS * 32, 0, (cudaStream_t)stream>>>(
        (const uint2*)x, (const uint2*)y, (uint2*)out, B);
    return (int)cudaGetLastError();
}

}  // extern "C"
