// Rebucket placement: the port of
// particle_simulator_tpu/ops/bucket_pallas.py:_place_kernel (reached through
// bucket_move_pallas, fed there by _move_pass_aux), and of the sharded
// place, bucket_pallas.py:_place_edge_kernel (reached through
// bucket_move_pallas_halo). Plain versions:
// particle_simulator_tpu_torch/physics/bucket.py:bucket_place and
// bucket_place_halo.
//
// What it computes, for each of n_grids stacked grids: every kept source
// slot (destid >= 0) moves its five fields to slot destid of that grid's
// output; every other output slot is a tombstone (x = y = 0, vx = vy = 0,
// ty = -1). A grid's source and output slot counts differ in the sharded
// place: the source is a halo-padded shard (its ring's particles migrate
// in), the output its interior. The Pallas kernel's neighbour-shard rows,
// appended -2 lanes and pull passes exist for the TPU and are not carried
// over.
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

// one thread per source slot (blockIdx.y = the grid g); grid g's slot i
// goes to output slot g * n_out + destid[i]
__global__ void place_scatter_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const int32_t* __restrict__ ty, const int32_t* __restrict__ destid,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    float* __restrict__ ovx, float* __restrict__ ovy,
    int32_t* __restrict__ oty, long n_src, long n_out) {
  const long li = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (li >= n_src) return;
  const long i = blockIdx.y * n_src + li;
  const int32_t d = destid[i];
  if (d < 0) return;
  const long o = blockIdx.y * n_out + d;
  ox[o] = x[i];
  oy[o] = y[i];
  ovx[o] = vx[i];
  ovy[o] = vy[i];
  oty[o] = ty[i];
}

}  // namespace

// n_grids grids of n_src source slots each, placed into n_out output slots
// each (n_src == n_out on one device)
extern "C" int ps_bucket_place(
    const void* x, const void* y, const void* vx, const void* vy,
    const void* ty, const void* destid,
    void* ox, void* oy, void* ovx, void* ovy, void* oty,
    int n_grids, long n_src, long n_out, void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  const long n_fill = n_grids * n_out;
  tombstone_fill_kernel<<<ps_blocks(n_fill, threads), threads, 0, s>>>(
      (uint32_t*)ox, (uint32_t*)oy, (float*)ovx, (float*)ovy, (int32_t*)oty, n_fill);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  place_scatter_kernel<<<dim3(ps_blocks(n_src, threads), n_grids), threads, 0, s>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const float*)vx,
      (const float*)vy, (const int32_t*)ty, (const int32_t*)destid,
      (uint32_t*)ox, (uint32_t*)oy, (float*)ovx, (float*)ovy, (int32_t*)oty,
      n_src, n_out);
  return (int)cudaGetLastError();
}
