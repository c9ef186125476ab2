// Shared definitions of the bucket-grid kernels (bucket_step.cu,
// bucket_dest.cu, bucket_place.cu).
//
// Layout: every field is a contiguous (BY, BX, CAP) array; slot i lives in
// bucket b = i / CAP, row b / BX, column b % BX. Positions arrive as int32
// tensors that hold u32 fixed-point bit patterns; the kernels read them as
// uint32_t. Every entry point is extern "C", launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// f32 params vector, the order of engine/state.py SimParams.vector
enum : int {
  P_SIGMA = 0, P_EPS, P_N, P_M, P_CURX, P_CURY, P_CURSZ, P_DT, P_BW, P_BH,
  P_COUNT
};

#define PS_U32_MAX_F 4294967295.0f
#define PS_PARTICLE_MASS 6.63352599e-26f
#define PS_F32_TINY 1.1754944e-38f
#define PS_F32_HUGE 3.4028235e38f

static inline unsigned ps_blocks(long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// top `log2` bits of a u32 coordinate: the bucket index along one axis
__device__ __forceinline__ int ps_bucket_of(uint32_t v, int log2) {
  return (int)(v >> (32 - log2));
}
