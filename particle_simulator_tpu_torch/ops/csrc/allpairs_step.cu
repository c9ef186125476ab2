// One all-pairs leapfrog step of the CompactArray layout: the port of
// particle_simulator_tpu/ops/allpairs_pallas.py:_allpairs_kernel (reached
// through allpairs_step_pallas). Plain version:
// particle_simulator_tpu_torch/physics/step.py:allpairs_step.
//
// What it computes, per live slot i of a flat (N,) state: cursor force and
// the repulsive Mie wall force, then the Mie pair force of every slot j
// (j != i, ty[j] >= 0): F/r = s1*exp(A1 - B1*lu) - s2*exp(A2 - B2*lu) with
// lu = log(d^2/sigma^2); then v += F/m*dt and x += round(v*dt/box*2^32) as a
// wrapping u32 add. Dead slots pass through; ty is not written.
//
// What bounds it on the H100: arithmetic. N = 16,384 live particles make
// 2.68e8 pairs a step, each one logf, two expf (full precision) and ~20
// other f32 operations, against 20 bytes of state per particle (328 KB at
// 16k, resident in L2). So the FP32 and MUFU pipes set the time, not bytes.
//
// What the design does about it:
// - One thread per receiver i keeps its force sum in registers for the whole
//   sweep over j: the loop inside the block takes the place of the Pallas
//   grid's sequential j dimension and its VMEM accumulator. There are no
//   atomics and no reduction across threads, so the result is the same on
//   every run.
// - The j sweep goes tile by tile: the block stages AP_TILE sources (x, y,
//   ty) in shared memory, and every thread reads each one as a broadcast.
// - The sum starts from the cursor + wall force and adds the pair terms of
//   j = 0, 1, ..., N-1 one at a time, each add its own rounded f32 op: the
//   plain version's order. The self pair and tombstoned j add +0 * dx, as
//   the plain version does, so the two agree to the bit.
// - Within a tile, AP_UNROLL pairs' terms are computed independently before
//   their adds, so the transcendentals of neighbouring j overlap (a 16k
//   scene gives only ~4 warps per SM, too few to hide latency otherwise).
// - Any N >= 1: the last tile is ragged and masked by its count (the Pallas
//   kernel requires N to be a multiple of 128).
// The per-dispatch scalars are computed once per block from the params
// tensor on the device, so a metadata edit never changes the launch.
#include "ps_common.cuh"

namespace {

constexpr int AP_THREADS = 128;  // receivers per block
constexpr int AP_TILE = 512;     // sources staged in shared memory at a time
constexpr int AP_UNROLL = 4;     // pairs per iteration of the inner loop

// the force terms of one pair, as physics/mie.py:pair_terms computes them
__device__ __forceinline__ void pair_term(const StepScalars& s, uint32_t xi, uint32_t yi,
                                          uint32_t xj, uint32_t yj, bool valid, float& tx,
                                          float& ty) {
  const float ddx = __fmul_rn(__int2float_rn((int32_t)(xj - xi)), s.scale_x);
  const float ddy = __fmul_rn(__int2float_rn((int32_t)(yj - yi)), s.scale_y);
  const float d2 = valid ? __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)) : 1.0f;
  const float f = valid ? pair_f_over_r(s, d2) : 0.0f;
  tx = __fmul_rn(f, ddx);
  ty = __fmul_rn(f, ddy);
}

__global__ void __launch_bounds__(AP_THREADS) allpairs_step_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const int32_t* __restrict__ ty, const float* __restrict__ params,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    float* __restrict__ ovx, float* __restrict__ ovy, int n) {
  __shared__ StepScalars sc;
  __shared__ uint32_t sx[AP_TILE];
  __shared__ uint32_t sy[AP_TILE];
  __shared__ int32_t sty[AP_TILE];
  if (threadIdx.x == 0) step_scalars(params, sc);

  const int i = blockIdx.x * AP_THREADS + threadIdx.x;
  const bool in_range = i < n;
  const uint32_t xi = in_range ? x[i] : 0u;
  const uint32_t yi = in_range ? y[i] : 0u;
  const bool live = in_range && ty[i] >= 0;
  __syncthreads();  // sc is ready

  float fx = 0.0f, fy = 0.0f;
  if (live) external_force(sc, xi, yi, fx, fy);

  for (int t0 = 0; t0 < n; t0 += AP_TILE) {
    const int cnt = min(AP_TILE, n - t0);
    for (int k = threadIdx.x; k < cnt; k += AP_THREADS) {
      sx[k] = x[t0 + k];
      sy[k] = y[t0 + k];
      sty[k] = ty[t0 + k];
    }
    __syncthreads();
    if (live) {
      const int self = i - t0;  // the receiver's own index in this tile, if any
      int k = 0;
#pragma unroll 1
      for (; k + AP_UNROLL <= cnt; k += AP_UNROLL) {
        float tx[AP_UNROLL], tyv[AP_UNROLL];
#pragma unroll
        for (int u = 0; u < AP_UNROLL; ++u) {
          pair_term(sc, xi, yi, sx[k + u], sy[k + u], sty[k + u] >= 0 && k + u != self,
                    tx[u], tyv[u]);
        }
#pragma unroll
        for (int u = 0; u < AP_UNROLL; ++u) {
          fx = __fadd_rn(fx, tx[u]);
          fy = __fadd_rn(fy, tyv[u]);
        }
      }
#pragma unroll 1
      for (; k < cnt; ++k) {  // the ragged end of the last tile
        float tx, tyv;
        pair_term(sc, xi, yi, sx[k], sy[k], sty[k] >= 0 && k != self, tx, tyv);
        fx = __fadd_rn(fx, tx);
        fy = __fadd_rn(fy, tyv);
      }
    }
    __syncthreads();  // the tile is consumed before the next one lands
  }

  if (!in_range) return;
  const float vxi = vx[i], vyi = vy[i];
  if (!live) {  // tombstone: pass through
    ox[i] = xi;
    oy[i] = yi;
    ovx[i] = vxi;
    ovy[i] = vyi;
    return;
  }
  leapfrog(sc, xi, yi, vxi, vyi, fx, fy, ox[i], oy[i], ovx[i], ovy[i]);
}

}  // namespace

extern "C" int ps_allpairs_step(
    const void* x, const void* y, const void* vx, const void* vy,
    const void* ty, const void* params,
    void* ox, void* oy, void* ovx, void* ovy, int n, void* stream) {
  allpairs_step_kernel<<<ps_blocks(n, AP_THREADS), AP_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const float*)vx,
      (const float*)vy, (const int32_t*)ty, (const float*)params,
      (uint32_t*)ox, (uint32_t*)oy, (float*)ovx, (float*)ovy, n);
  return (int)cudaGetLastError();
}

// pairs per iteration of the kernel's main inner loop: chip_smoke.py divides
// that loop's SASS instruction counts by it to get the count per pair
extern "C" int ps_allpairs_pairs_per_iter() { return AP_UNROLL; }
