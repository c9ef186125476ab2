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
// The sum, defined once for this kernel and the plain version
// (physics/step.py:segmented_sum): the j range is cut into segments of
// AP_SEGMENT sources, segment k = [k*L, min(N, (k+1)*L)). Segment 0's
// accumulator starts at the receiver's cursor + wall force, every other at
// +0.0f; each adds its pair terms one j at a time in ascending j (the self
// pair and a tombstoned j add +0 * dx). The receiver's force is accumulator
// 0, plus partial 1, plus partial 2, ..., one rounded add each in ascending
// k. L depends on nothing (not on N, the card or the launch), so padding a
// scene with tombstones changes no live result, and with N <= L the sum is
// the one-at-a-time sum.
//
// What bounds it on the H100: arithmetic. N = 16,384 live particles make
// 2.68e8 pairs a step, each one logf, two expf (full precision) and ~20
// other f32 operations, against 20 bytes of state per particle (328 KB at
// 16k, resident in L2). So the FP32 and MUFU pipes set the time, not bytes,
// and the kernel's job is to keep every SM's schedulers fed.
//
// What the design does about it:
// - A thread is one (receiver, segment) at a time, so a step has N * N / L
//   independent sweeps instead of N: a block is AP_RECV receivers x AP_LANES
//   segment lanes; lane q sweeps segments q, q + AP_LANES, ... With one
//   thread per receiver a 16,384-slot step gave an SM ~4 warps of its 64 and
//   a 2,048-slot step reached 16 of the 132 SMs; now 16,384 slots are 1,024
//   blocks of 8 warps, and 2,048 slots 128 blocks.
// - A warp holds AP_RECV receivers x AP_GROUPS segments. It stages its own
//   segments' x, y, ty in its own slice of shared memory (coalesced loads,
//   __syncwarp only), then every lane reads its segment 16 bytes at a time;
//   the lanes of one segment read the same address (a broadcast) and the
//   slices of a warp's segments are offset by 4 banks.
// - After each round of AP_LANES segments the lanes leave their partials in
//   shared memory and, behind one __syncthreads, lane 0 of each receiver
//   adds them in ascending segment order. No atomics, no shuffles that
//   would reorder the sum: the result is the same on every run and equal
//   to the plain version's to the bit.
// - Within a segment, AP_UNROLL pairs' terms are computed independently
//   before their adds, so the transcendentals of neighbouring j overlap.
// - Any N >= 1: the last segment is ragged and masked by its count (the
//   Pallas kernel requires N to be a multiple of 128).
// The per-dispatch scalars are computed once per block from the params
// tensor on the device, so a metadata edit never changes the launch.
#include "ps_common.cuh"

namespace {

// L, the segment length of the sum: mirrors SEGMENT in physics/step.py.
// 128 gives a 2,048-slot scene 16 segments a receiver (1,024 warps, ~8 an
// SM) and a 16,384-slot scene 128; one more rounded add per 128 pair terms
// costs nothing. Measured on an H100 (PERF.md): 128 with 16 receivers x 8
// warps a block is the fastest of the shapes tried at both sizes (63
// registers, no spills, 27 KB of shared memory: 4 blocks, 32 warps an SM);
// 256 and 512 are 2-10% slower at 16,384 and 1.6-2.9x slower at 2,048.
constexpr int AP_SEGMENT = 128;
constexpr int AP_RECV = 16;                        // receivers per block
constexpr int AP_GROUPS = 32 / AP_RECV;            // segments a warp sweeps at once
constexpr int AP_WARPS = 8;                        // warps per block
constexpr int AP_LANES = AP_WARPS * AP_GROUPS;     // segment lanes per receiver
constexpr int AP_THREADS = 32 * AP_WARPS;
constexpr int AP_UNROLL = 4;                       // pairs per iteration of the inner loop
constexpr int AP_STRIDE = AP_SEGMENT + 4;          // words from one slice to the next

static_assert(32 % AP_RECV == 0, "a warp holds whole groups of receivers");
static_assert(AP_SEGMENT % AP_UNROLL == 0 && AP_UNROLL == 4, "the inner loop reads 16 bytes");

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
  __shared__ __align__(16) uint32_t sx[AP_LANES][AP_STRIDE];
  __shared__ __align__(16) uint32_t sy[AP_LANES][AP_STRIDE];
  __shared__ __align__(16) int32_t sty[AP_LANES][AP_STRIDE];
  __shared__ float px[AP_LANES][AP_RECV];  // the round's partials
  __shared__ float py[AP_LANES][AP_RECV];
  if (threadIdx.x == 0) step_scalars(params, sc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane % AP_RECV;                     // receiver of the block
  const int q = warp * AP_GROUPS + lane / AP_RECV;  // segment lane
  const int i = blockIdx.x * AP_RECV + r;
  const bool in_range = i < n;
  const uint32_t xi = in_range ? x[i] : 0u;
  const uint32_t yi = in_range ? y[i] : 0u;
  const bool live = in_range && ty[i] >= 0;
  __syncthreads();  // sc is ready

  const int n_seg = (n + AP_SEGMENT - 1) / AP_SEGMENT;
  float fx = 0.0f, fy = 0.0f;  // the receiver's sum, kept by its lane q == 0

  for (int s0 = 0; s0 < n_seg; s0 += AP_LANES) {  // a round: AP_LANES segments
    // the warp stages its AP_GROUPS segments of the round
#pragma unroll
    for (int g = 0; g < AP_GROUPS; ++g) {
      const int slice = warp * AP_GROUPS + g;
      const int seg = s0 + slice;
      if (seg < n_seg) {
        const int j0 = seg * AP_SEGMENT;
        const int cnt = min(AP_SEGMENT, n - j0);
        for (int k = lane; k < cnt; k += 32) {
          sx[slice][k] = x[j0 + k];
          sy[slice][k] = y[j0 + k];
          sty[slice][k] = ty[j0 + k];
        }
      }
    }
    __syncwarp();

    const int seg = s0 + q;
    float ax = 0.0f, ay = 0.0f;
    if (live && seg < n_seg) {
      if (seg == 0) external_force(sc, xi, yi, ax, ay);
      const int j0 = seg * AP_SEGMENT;
      const int cnt = min(AP_SEGMENT, n - j0);
      const int self = i - j0;  // the receiver's own index in this segment, if any
      const uint32_t* jx = sx[q];
      const uint32_t* jy = sy[q];
      const int32_t* jt = sty[q];
      int k = 0;
#pragma unroll 1
      for (; k + AP_UNROLL <= cnt; k += AP_UNROLL) {
        const uint4 cx = *reinterpret_cast<const uint4*>(jx + k);
        const uint4 cy = *reinterpret_cast<const uint4*>(jy + k);
        const int4 ct = *reinterpret_cast<const int4*>(jt + k);
        float tx[AP_UNROLL], tyv[AP_UNROLL];
        pair_term(sc, xi, yi, cx.x, cy.x, ct.x >= 0 && k != self, tx[0], tyv[0]);
        pair_term(sc, xi, yi, cx.y, cy.y, ct.y >= 0 && k + 1 != self, tx[1], tyv[1]);
        pair_term(sc, xi, yi, cx.z, cy.z, ct.z >= 0 && k + 2 != self, tx[2], tyv[2]);
        pair_term(sc, xi, yi, cx.w, cy.w, ct.w >= 0 && k + 3 != self, tx[3], tyv[3]);
#pragma unroll
        for (int u = 0; u < AP_UNROLL; ++u) {
          ax = __fadd_rn(ax, tx[u]);
          ay = __fadd_rn(ay, tyv[u]);
        }
      }
#pragma unroll 1
      for (; k < cnt; ++k) {  // the ragged end of the last segment
        float tx, tyv;
        pair_term(sc, xi, yi, jx[k], jy[k], jt[k] >= 0 && k != self, tx, tyv);
        ax = __fadd_rn(ax, tx);
        ay = __fadd_rn(ay, tyv);
      }
    }
    px[q][r] = ax;
    py[q][r] = ay;
    __syncthreads();  // the round's partials are in place
    if (q == 0 && live) {  // ascending segment order, one rounded add each
      const int cnt = min(AP_LANES, n_seg - s0);
      int k = 0;
      if (s0 == 0) {  // accumulator 0 is the sum's first operand
        fx = px[0][r];
        fy = py[0][r];
        k = 1;
      }
      for (; k < cnt; ++k) {
        fx = __fadd_rn(fx, px[k][r]);
        fy = __fadd_rn(fy, py[k][r]);
      }
    }
    __syncthreads();  // partials and slices are consumed before the next round
  }

  if (q != 0 || !in_range) return;
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
  allpairs_step_kernel<<<ps_blocks(n, AP_RECV), AP_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const float*)vx,
      (const float*)vy, (const int32_t*)ty, (const float*)params,
      (uint32_t*)ox, (uint32_t*)oy, (float*)ovx, (float*)ovy, n);
  return (int)cudaGetLastError();
}

// pairs per iteration of the kernel's main inner loop: chip_smoke.py divides
// that loop's SASS instruction counts by it to get the count per pair
extern "C" int ps_allpairs_pairs_per_iter() { return AP_UNROLL; }

// the segment length the library was built with (physics/step.py:SEGMENT)
extern "C" int ps_allpairs_segment() { return AP_SEGMENT; }
