// Host driver of the int16 probe's lane arithmetic, for the CPU tests
// (tests/test_torch_probes.py builds it with g++).
//
// It runs the control flow of c3poa_tpu_torch/kernels/csrc/int16_probe.cu
// serially over the functions of int16_probe.cuh: per row, every lane's
// two packed max words, then each lane's output from the words of
// i16p_src_lane(lane) (the kernel's __shfl_sync) and its own first word.
// The packed intrinsics are the header's host emulations.
#include <stdint.h>
#include <string.h>

#include "int16_probe.cuh"

extern "C" int i16p_host(const int16_t* x, const int16_t* y, int16_t* out,
                         int B) {
    for (int b = 0; b < B; ++b) {
        uint32_t m[32][2];
        for (int lane = 0; lane < 32; ++lane) {
            for (int w = 0; w < 2; ++w) {
                uint32_t xa, ya;
                memcpy(&xa, x + b * 128 + 4 * lane + 2 * w, 4);
                memcpy(&ya, y + b * 128 + 4 * lane + 2 * w, 4);
                m[lane][w] = i16p_max(xa, ya);
            }
        }
        for (int lane = 0; lane < 32; ++lane) {
            const int src = i16p_src_lane(lane);
            uint32_t r[2];
            i16p_lane(lane, m[src][0], m[src][1], m[lane][0], &r[0], &r[1]);
            memcpy(out + b * 128 + 4 * lane, r, 8);
        }
    }
    return 0;
}
