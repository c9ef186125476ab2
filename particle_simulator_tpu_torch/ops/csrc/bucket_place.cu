// Rebucket placement: the port of
// particle_simulator_tpu/ops/bucket_pallas.py:_place_kernel (reached through
// bucket_move_pallas, fed there by _move_pass_aux). Plain version:
// particle_simulator_tpu_torch/physics/bucket.py:bucket_place.
//
// What it computes: every kept source slot (destid >= 0) moves its five
// fields to slot destid; every other output slot is a tombstone
// (x = y = 0, vx = vy = 0, ty = -1).
//
// What bounds it on the H100: memory traffic. 24 bytes read and 20 written
// per slot, plus the 20-byte tombstone fill of the output: ~64 bytes a slot
// and no arithmetic to speak of.
//
// What the design does about it: a fill pass writes the tombstones, then one
// thread per source slot scatters its fields straight to destid. Dest ids
// are unique, so the scatter has no conflicts and no order: the result is
// bit-identical to the plain version and to the Pallas pull-place. The
// Pallas kernel pulls instead (each output slot searches its neighbourhood
// for the id that names it) because XLA's scatter was slow on the TPU; a
// GPU scatter by unique index is cheap, so the pull passes and their
// per-tile bounds (_move_pass_aux) are not carried over.
#include "bucket_common.cuh"

namespace {

__global__ void tombstone_fill_kernel(
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    float* __restrict__ ovx, float* __restrict__ ovy,
    int32_t* __restrict__ oty, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ox[i] = 0u;
  oy[i] = 0u;
  ovx[i] = 0.0f;
  ovy[i] = 0.0f;
  oty[i] = -1;
}

__global__ void place_scatter_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const int32_t* __restrict__ ty, const int32_t* __restrict__ destid,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    float* __restrict__ ovx, float* __restrict__ ovy,
    int32_t* __restrict__ oty, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t d = destid[i];
  if (d < 0) return;
  ox[d] = x[i];
  oy[d] = y[i];
  ovx[d] = vx[i];
  ovy[d] = vy[i];
  oty[d] = ty[i];
}

}  // namespace

extern "C" int ps_bucket_place(
    const void* x, const void* y, const void* vx, const void* vy,
    const void* ty, const void* destid,
    void* ox, void* oy, void* ovx, void* ovy, void* oty,
    long n, void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  tombstone_fill_kernel<<<ps_blocks(n, threads), threads, 0, s>>>(
      (uint32_t*)ox, (uint32_t*)oy, (float*)ovx, (float*)ovy, (int32_t*)oty, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  place_scatter_kernel<<<ps_blocks(n, threads), threads, 0, s>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const float*)vx,
      (const float*)vy, (const int32_t*)ty, (const int32_t*)destid,
      (uint32_t*)ox, (uint32_t*)oy, (float*)ovx, (float*)ovy, (int32_t*)oty, n);
  return (int)cudaGetLastError();
}
