// One leapfrog step of the bucket grid: the port of
// particle_simulator_tpu/ops/bucket_pallas.py:_step_kernel / _step_block
// (reached through bucket_step_pallas, and in its halo mode through the
// sharded frame of parallel/domain.py:_local_frame). Plain versions:
// particle_simulator_tpu_torch/physics/bucket.py:bucket_step and
// bucket_step_halo.
//
// Halo mode (ring = 1): the input is a stack of shards, each padded with one
// ring of its neighbour shards' buckets, (n, LY+2, LX+2, CAP). Receivers are
// the interior slots; the ring only supplies candidates and passes through,
// so every interior receiver sees its full 3x3 neighbourhood in bounds and
// in the same order as on one device, which makes the sharded step
// bit-identical to the single-device one. The Pallas kernel's edge_rows /
// halo_cols splice and col_xpad keep its 8/16-row VMEM blocks; a CUDA
// thread reads the padded grid directly, so neither is carried over.
//
// What it computes, per live slot i: cursor force (+-8e-12/(d^2+1) inside
// cursor_size/2), the repulsive Mie wall force per axis, and Mie pair forces
// from every live slot of the 3x3 neighbour buckets (self excluded, no
// periodic wrap): F/r = s1*exp(A1 - B1*lu) - s2*exp(A2 - B2*lu) with
// lu = log(d^2/sigma^2); then v += F/m*dt and x += round(v*dt/box*2^32)
// as a wrapping u32 add. Dead slots pass through; ty is not written.
//
// What bounds it on the H100: arithmetic, not bytes. Each live slot
// evaluates ~9*CAP candidates, each one logf and two expf (full precision:
// the library's polynomial forms, not the SFU approximations) plus ~15 f32
// multiplies and adds, against 20 bytes of its own state. At 1M particles and CAP 8 that is
// ~75M pair evaluations per step, so the FP32/SFU pipes set the time.
//
// What the design does about it: one thread per receiver slot, a fixed
// candidate order (dy outer, dx inner, slots ascending) and a per-thread
// f32 accumulator, so there are no float atomics and the result is the same
// on every run. Candidates are read through the read-only cache; the threads
// of one warp cover a few neighbouring buckets, so their candidate reads hit
// the same lines. Tombstoned candidates and dead receivers skip all math.
// The per-dispatch scalars (log-domain pair constants, wall constant) are
// computed once per block by one thread, from the params tensor on the
// device, so a metadata edit changes a tensor and never the launch. The
// Pallas kernel's lane rolls, lane-validity table, lane chunking and
// occupancy pass skips exist for the TPU's vector unit and are not carried
// over. Shared-memory tiling of the neighbourhood is left for later work.
// The force law itself (cursor, wall, pair term, leapfrog) is shared with
// the all-pairs kernel in ps_common.cuh.
#include "bucket_common.cuh"

namespace {

// One thread per slot of n_grids stacked (gy, gx, cap) grids (blockIdx.y
// = the grid). Without HALO every live slot steps
// and candidates outside the grid (the box edge) are skipped; with HALO
// only the live interior slots step, the ring passes through, and every
// candidate is in bounds. A template parameter, so the single-device step
// carries none of the halo mode's checks.
template <bool HALO>
__global__ void bucket_step_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const int32_t* __restrict__ ty, const float* __restrict__ params,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    float* __restrict__ ovx, float* __restrict__ ovy,
    int gy, int gx, int cap) {
  __shared__ StepScalars sc;
  if (threadIdx.x == 0) step_scalars(params, sc);
  __syncthreads();

  // slot i of the stack, its grid's first slot, its bucket in the grid
  long i, grid_base;
  int b;
  if (HALO) {
    const int grid_slots = gy * gx * cap;
    const int li = blockIdx.x * blockDim.x + threadIdx.x;
    if (li >= grid_slots) return;
    grid_base = (long)blockIdx.y * grid_slots;
    i = grid_base + li;
    b = li / cap;
  } else {  // 64-bit indices: on one grid, 1% faster than the above on the H100
    i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long)gy * gx * cap) return;
    grid_base = 0;
    b = (int)(i / cap);
  }
  const int cbx = b % gx, cby = b / gx;
  const uint32_t xi = x[i], yi = y[i];
  const float vxi = vx[i], vyi = vy[i];
  if (ty[i] < 0 || (HALO && (cby < 1 || cby >= gy - 1 || cbx < 1 || cbx >= gx - 1))) {
    ox[i] = xi;  // tombstone or ring slot: pass through
    oy[i] = yi;
    ovx[i] = vxi;
    ovy[i] = vyi;
    return;
  }

  float fx, fy;
  external_force(sc, xi, yi, fx, fy);

  // 3x3 neighbourhood pair forces, fixed candidate order
  for (int dy = -1; dy <= 1; ++dy) {
    const int nby = cby + dy;
    if (!HALO && (nby < 0 || nby >= gy)) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int nbx = cbx + dx;
      if (!HALO && (nbx < 0 || nbx >= gx)) continue;
      const long base = grid_base + ((long)nby * gx + nbx) * cap;
      for (int s = 0; s < cap; ++s) {
        const long j = base + s;
        if (j == i || __ldg(ty + j) < 0) continue;
        const float ddx = __fmul_rn(__int2float_rn((int32_t)(__ldg(x + j) - xi)), sc.scale_x);
        const float ddy = __fmul_rn(__int2float_rn((int32_t)(__ldg(y + j) - yi)), sc.scale_y);
        const float f = pair_f_over_r(sc, __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)));
        fx = __fadd_rn(fx, __fmul_rn(f, ddx));
        fy = __fadd_rn(fy, __fmul_rn(f, ddy));
      }
    }
  }

  leapfrog(sc, xi, yi, vxi, vyi, fx, fy, ox[i], oy[i], ovx[i], ovy[i]);
}

}  // namespace

// n_grids stacked (gy, gx, cap) grids; ring = 0 steps every live slot of a
// single grid (the box edge clamps the neighbourhood), ring = 1 steps the
// interior of halo-padded shards
extern "C" int ps_bucket_step(
    const void* x, const void* y, const void* vx, const void* vy,
    const void* ty, const void* params,
    void* ox, void* oy, void* ovx, void* ovy,
    int n_grids, int gy, int gx, int cap, int ring, void* stream) {
  const int threads = 128;
  const dim3 blocks(ps_blocks((long)gy * gx * cap, threads), n_grids);
  const cudaStream_t s = (cudaStream_t)stream;
  if (ring) {
    bucket_step_kernel<true><<<blocks, threads, 0, s>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const float*)vx,
        (const float*)vy, (const int32_t*)ty, (const float*)params,
        (uint32_t*)ox, (uint32_t*)oy, (float*)ovx, (float*)ovy, gy, gx, cap);
  } else {
    bucket_step_kernel<false><<<blocks, threads, 0, s>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const float*)vx,
        (const float*)vy, (const int32_t*)ty, (const float*)params,
        (uint32_t*)ox, (uint32_t*)oy, (float*)ovx, (float*)ovy, gy, gx, cap);
  }
  return (int)cudaGetLastError();
}
