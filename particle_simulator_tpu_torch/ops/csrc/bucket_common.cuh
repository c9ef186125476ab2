// Shared definitions of the bucket-grid kernels (bucket_step.cu,
// bucket_dest.cu, bucket_place.cu).
//
// Layout: every field is a contiguous (BY, BX, CAP) array; slot i lives in
// bucket b = i / CAP, row b / BX, column b % BX.
#pragma once

#include "ps_common.cuh"

// top `log2` bits of a u32 coordinate: the bucket index along one axis
__device__ __forceinline__ int ps_bucket_of(uint32_t v, int log2) {
  return (int)(v >> (32 - log2));
}
