// Shared definitions of every kernel of the port: the params layout, the
// constants, and the per-particle force law (cursor, wall, Mie pair term,
// leapfrog) that the step kernels (bucket_step.cu, allpairs_step.cu) share.
//
// Positions arrive as int32 tensors that hold u32 fixed-point bit patterns;
// the kernels read them as uint32_t. Every entry point is extern "C",
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// Every f32 operation of the force law is an explicit round-to-nearest
// intrinsic in the plain PyTorch version's order (physics/mie.py): no
// multiply-add contracts into an FMA, so a kernel rounds exactly where the
// plain version does. That matters: the pair forces on a relaxed lattice
// cancel to nearly zero, and the cursor radius test is a threshold. logf
// and expf are the full-precision library functions (no fast math).
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

struct StepScalars {
  float A1, B1, A2, B2, inv_s2, sg1, sg2;  // log-domain pair constants
  float ce_m;                               // C*eps*m of the wall force
  float sigma, m, dt, bw, bh, curx, cury, cur_r2;
  float scale_x, scale_y;                   // meters per u32 unit
};

// physics/mie.py:mie_log_coeffs_scalars, with its degenerate-sigma clamps
static __device__ void step_scalars(const float* p, StepScalars& s) {
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
  s.scale_x = __fdiv_rn(s.bw, PS_U32_MAX_F);
  s.scale_y = __fdiv_rn(s.bh, PS_U32_MAX_F);
}

// repulsive-only Mie wall force at distance `dist`
static __device__ __forceinline__ float wall_rep(const StepScalars& s, float dist) {
  return __fdiv_rn(__fmul_rn(s.ce_m, expf(__fmul_rn(s.m, logf(__fdiv_rn(s.sigma, dist))))),
                   dist);
}

// cursor force plus the wall force of whichever half of the box the
// particle is in: physics/step.py:external_forces for one live slot
static __device__ __forceinline__ void external_force(const StepScalars& s, uint32_t xi,
                                                      uint32_t yi, float& fx, float& fy) {
  const float xf = __uint2float_rn(xi), yf = __uint2float_rn(yi);
  const float dxc = __fsub_rn(s.curx, __fdiv_rn(xf, PS_U32_MAX_F));
  const float dyc = __fsub_rn(s.cury, __fdiv_rn(yf, PS_U32_MAX_F));
  const float sq = __fadd_rn(__fmul_rn(dxc, dxc), __fmul_rn(dyc, dyc));
  fx = 0.0f;
  fy = 0.0f;
  if (sq < s.cur_r2) {
    const float mag = __fdiv_rn(8e-12f, __fadd_rn(sq, 1.0f));
    fx = dxc > 0.0f ? -mag : mag;
    fy = dyc > 0.0f ? -mag : mag;
  }
  const bool left = xi < 2147483647u;
  const bool bottom = yi < 2147483647u;
  const float dist_x =
      __fmul_rn(__fdiv_rn(left ? xf : __fsub_rn(PS_U32_MAX_F, xf), PS_U32_MAX_F), s.bw);
  const float dist_y =
      __fmul_rn(__fdiv_rn(bottom ? yf : __fsub_rn(PS_U32_MAX_F, yf), PS_U32_MAX_F), s.bh);
  fx = __fadd_rn(fx, __fmul_rn(left ? 1.0f : -1.0f, wall_rep(s, dist_x)));
  fy = __fadd_rn(fy, __fmul_rn(bottom ? 1.0f : -1.0f, wall_rep(s, dist_y)));
}

// F/r of one pair at squared distance d2:
// s1*exp(A1 - B1*lu) - s2*exp(A2 - B2*lu), lu = log(d2/sigma^2)
static __device__ __forceinline__ float pair_f_over_r(const StepScalars& s, float d2) {
  const float lu = logf(__fmul_rn(d2, s.inv_s2));
  return __fsub_rn(__fmul_rn(s.sg1, expf(__fsub_rn(s.A1, __fmul_rn(s.B1, lu)))),
                   __fmul_rn(s.sg2, expf(__fsub_rn(s.A2, __fmul_rn(s.B2, lu)))));
}

// leapfrog kick-drift in u32 fixed point; __float2int_rn rounds half to
// even like torch.round, saturates and maps NaN to 0 like XLA's f32->s32
static __device__ __forceinline__ void leapfrog(const StepScalars& s, uint32_t xi, uint32_t yi,
                                                float vxi, float vyi, float fx, float fy,
                                                uint32_t& ox, uint32_t& oy, float& ovx,
                                                float& ovy) {
  const float nvx = __fadd_rn(vxi, __fmul_rn(__fdiv_rn(fx, PS_PARTICLE_MASS), s.dt));
  const float nvy = __fadd_rn(vyi, __fmul_rn(__fdiv_rn(fy, PS_PARTICLE_MASS), s.dt));
  const int ddx = __float2int_rn(__fmul_rn(__fdiv_rn(__fmul_rn(nvx, s.dt), s.bw), PS_U32_MAX_F));
  const int ddy = __float2int_rn(__fmul_rn(__fdiv_rn(__fmul_rn(nvy, s.dt), s.bh), PS_U32_MAX_F));
  ox = xi + (uint32_t)ddx;
  oy = yi + (uint32_t)ddy;
  ovx = nvx;
  ovy = nvy;
}
