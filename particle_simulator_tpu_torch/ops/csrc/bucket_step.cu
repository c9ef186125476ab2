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
#include "bucket_common.cuh"

namespace {

struct StepScalars {
  float A1, B1, A2, B2, inv_s2, sg1, sg2;  // log-domain pair constants
  float ce_m;                               // C*eps*m of the wall force
  float sigma, m, dt, bw, bh, curx, cury, cur_r2;
};

// physics/mie.py:mie_log_coeffs_scalars, with its degenerate-sigma clamps
__device__ void step_scalars(const float* p, StepScalars& s) {
  const float sigma = p[P_SIGMA], eps = p[P_EPS], n = p[P_N], m = p[P_M];
  const float C = __fmul_rn(__fdiv_rn(n, __fsub_rn(n, m)),
                            expf(__fmul_rn(__fdiv_rn(m, __fsub_rn(n, m)), logf(__fdiv_rn(n, m)))));
  const float s2_raw = __fmul_rn(sigma, sigma);
  const bool degenerate = s2_raw < PS_F32_TINY;
  const float s2 = fmaxf(s2_raw, PS_F32_TINY);
  const float ce_s2 = __fdiv_rn(__fmul_rn(C, eps), s2);
  const float t1 = __fmul_rn(ce_s2, m), t2 = __fmul_rn(ce_s2, n);
  s.A1 = degenerate ? -INFINITY : logf(fminf(fabsf(t1), PS_F32_HUGE));
  s.A2 = degenerate ? -INFINITY : logf(fminf(fabsf(t2), PS_F32_HUGE));
  s.B1 = __fmul_rn(__fadd_rn(m, 2.0f), 0.5f);
  s.B2 = __fmul_rn(__fadd_rn(n, 2.0f), 0.5f);
  s.inv_s2 = __fdiv_rn(1.0f, s2);
  s.sg1 = t1 < 0.0f ? -1.0f : 1.0f;
  s.sg2 = t2 < 0.0f ? -1.0f : 1.0f;
  s.ce_m = __fmul_rn(__fmul_rn(C, eps), m);
  s.sigma = sigma;
  s.m = m;
  s.dt = p[P_DT];
  s.bw = p[P_BW];
  s.bh = p[P_BH];
  s.curx = p[P_CURX];
  s.cury = p[P_CURY];
  s.cur_r2 = __fmul_rn(__fmul_rn(p[P_CURSZ], p[P_CURSZ]), 0.25f);
}

// repulsive-only Mie wall force at distance `dist`
__device__ __forceinline__ float wall_rep(const StepScalars& s, float dist) {
  return __fdiv_rn(__fmul_rn(s.ce_m, expf(__fmul_rn(s.m, logf(__fdiv_rn(s.sigma, dist))))),
                   dist);
}

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

  const float xf = __uint2float_rn(xi), yf = __uint2float_rn(yi);

  // Every f32 operation below is an explicit round-to-nearest intrinsic, in
  // the plain version's order: no multiply-add contracts into an FMA, so the
  // kernel rounds exactly where the plain version does. That matters: the
  // pair forces on a relaxed lattice cancel to nearly zero, and the cursor
  // radius test is a threshold.

  // cursor force
  const float dxc = __fsub_rn(sc.curx, __fdiv_rn(xf, PS_U32_MAX_F));
  const float dyc = __fsub_rn(sc.cury, __fdiv_rn(yf, PS_U32_MAX_F));
  const float sq = __fadd_rn(__fmul_rn(dxc, dxc), __fmul_rn(dyc, dyc));
  float fx = 0.0f, fy = 0.0f;
  if (sq < sc.cur_r2) {
    const float mag = __fdiv_rn(8e-12f, __fadd_rn(sq, 1.0f));
    fx = dxc > 0.0f ? -mag : mag;
    fy = dyc > 0.0f ? -mag : mag;
  }

  // wall force, from whichever half of the box the particle is in
  const bool left = xi < 2147483647u;
  const bool bottom = yi < 2147483647u;
  const float dist_x =
      __fmul_rn(__fdiv_rn(left ? xf : __fsub_rn(PS_U32_MAX_F, xf), PS_U32_MAX_F), sc.bw);
  const float dist_y =
      __fmul_rn(__fdiv_rn(bottom ? yf : __fsub_rn(PS_U32_MAX_F, yf), PS_U32_MAX_F), sc.bh);
  fx = __fadd_rn(fx, __fmul_rn(left ? 1.0f : -1.0f, wall_rep(sc, dist_x)));
  fy = __fadd_rn(fy, __fmul_rn(bottom ? 1.0f : -1.0f, wall_rep(sc, dist_y)));

  // 3x3 neighbourhood pair forces, fixed candidate order
  const float scale_x = __fdiv_rn(sc.bw, PS_U32_MAX_F);
  const float scale_y = __fdiv_rn(sc.bh, PS_U32_MAX_F);
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
        const float ddx = __fmul_rn(__int2float_rn((int32_t)(__ldg(x + j) - xi)), scale_x);
        const float ddy = __fmul_rn(__int2float_rn((int32_t)(__ldg(y + j) - yi)), scale_y);
        const float d2 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
        const float lu = logf(__fmul_rn(d2, sc.inv_s2));
        const float f = __fsub_rn(__fmul_rn(sc.sg1, expf(__fsub_rn(sc.A1, __fmul_rn(sc.B1, lu)))),
                                  __fmul_rn(sc.sg2, expf(__fsub_rn(sc.A2, __fmul_rn(sc.B2, lu)))));
        fx = __fadd_rn(fx, __fmul_rn(f, ddx));
        fy = __fadd_rn(fy, __fmul_rn(f, ddy));
      }
    }
  }

  // leapfrog kick-drift in u32 fixed point; __float2int_rn rounds half to
  // even like torch.round, saturates and maps NaN to 0 like XLA's f32->s32
  const float nvx = __fadd_rn(vxi, __fmul_rn(__fdiv_rn(fx, PS_PARTICLE_MASS), sc.dt));
  const float nvy = __fadd_rn(vyi, __fmul_rn(__fdiv_rn(fy, PS_PARTICLE_MASS), sc.dt));
  const int ddx = __float2int_rn(
      __fmul_rn(__fdiv_rn(__fmul_rn(nvx, sc.dt), sc.bw), PS_U32_MAX_F));
  const int ddy = __float2int_rn(
      __fmul_rn(__fdiv_rn(__fmul_rn(nvy, sc.dt), sc.bh), PS_U32_MAX_F));
  ox[i] = xi + (uint32_t)ddx;
  oy[i] = yi + (uint32_t)ddy;
  ovx[i] = nvx;
  ovy[i] = nvy;
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
