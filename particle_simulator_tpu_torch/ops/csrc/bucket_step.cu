// One leapfrog step of the bucket grid: the port of
// particle_simulator_tpu/ops/bucket_pallas.py:_step_kernel / _step_block
// (reached through bucket_step_pallas). Plain version:
// particle_simulator_tpu_torch/physics/bucket.py:bucket_step.
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

__global__ void bucket_step_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const int32_t* __restrict__ ty, const float* __restrict__ params,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    float* __restrict__ ovx, float* __restrict__ ovy,
    int by, int bx, int cap) {
  __shared__ StepScalars sc;
  if (threadIdx.x == 0) step_scalars(params, sc);
  __syncthreads();

  const long n_slots = (long)by * bx * cap;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;

  const uint32_t xi = x[i], yi = y[i];
  const float vxi = vx[i], vyi = vy[i];
  if (ty[i] < 0) {  // tombstone: pass through
    ox[i] = xi;
    oy[i] = yi;
    ovx[i] = vxi;
    ovy[i] = vyi;
    return;
  }

  float fx, fy;
  external_force(sc, xi, yi, fx, fy);

  // 3x3 neighbourhood pair forces, fixed candidate order
  const int b = (int)(i / cap);
  const int cbx = b % bx, cby = b / bx;
  for (int dy = -1; dy <= 1; ++dy) {
    const int nby = cby + dy;
    if (nby < 0 || nby >= by) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int nbx = cbx + dx;
      if (nbx < 0 || nbx >= bx) continue;
      const long base = ((long)nby * bx + nbx) * cap;
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

extern "C" int ps_bucket_step(
    const void* x, const void* y, const void* vx, const void* vy,
    const void* ty, const void* params,
    void* ox, void* oy, void* ovx, void* ovy,
    int by, int bx, int cap, void* stream) {
  const long n = (long)by * bx * cap;
  const int threads = 128;
  bucket_step_kernel<<<ps_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const float*)vx,
      (const float*)vy, (const int32_t*)ty, (const float*)params,
      (uint32_t*)ox, (uint32_t*)oy, (float*)ovx, (float*)ovy, by, bx, cap);
  return (int)cudaGetLastError();
}
