// Staged, compacted candidates for a bucket-grid step: device functions a
// block calls to step the live receivers of a rectangle of buckets. Used by
// every kernel of bucket_step.cu: they take the grid's geometry, so the
// classic step (a whole grid), the halo step (the interior of a stack of
// padded shards) and the tile-scheduled step share them.
//
// A region is a rectangle of buckets plus one ring of buckets around it.
// stage_region() reads ty (then x, y of the live slots) of the region's
// buckets, slots below `width` only, and writes the live candidates into
// shared memory compacted in (bucket row, bucket, slot) order, with every
// bucket's start offset. The step's candidate order is dy outer, dx inner,
// slots ascending, so a receiver's candidates are then three contiguous
// runs, one per dy: from the start of bucket bx-1 to the end of bucket bx+1
// of row by+dy, in exactly the classic order with the tombstones left out.
// A tombstone adds nothing to the classic sum, so the sum is the same to the
// bit. Buckets past the box edge stage as empty, which clamps the runs. The
// receiver itself is skipped by its position in the middle run.
//
// The interior's live slots are themselves contiguous pieces of the
// compacted array, one per interior row, so receiver number k of the region
// is found from a per-row prefix and every thread that takes a receiver has
// a live particle; neighbouring threads hold receivers of the same or
// adjacent buckets and read the same runs (shared-memory broadcasts).
#pragma once

#include "bucket_common.cuh"

// one region of one (gy, gx, cap) grid in a stack of grids
struct StageGeom {
  long grid_base;        // first slot of the grid in the arrays
  int gy, gx, cap;       // the grid, in buckets and slots a bucket
  int row0, col0;        // grid row and column of the region's first (ring) bucket; may be -1
  int rows, cols;        // the region in buckets, ring included
  int in_rows, in_cols;  // receivers: region rows 1..in_rows, columns 1..in_cols
  int width;             // slots at or past it are tombstones (omax, or cap)
};

// the block's shared memory; stage_bytes() sizes it
struct StageBuffers {
  uint2* cand;     // (x, y) of the live candidates, compacted
  uint32_t* info;  // region bucket << 16 | slot of each candidate
  int* start;      // rows * cols + 1 start offsets into cand
  int* row_recv;   // in_rows + 1: receivers before each interior row
  int* scratch;    // 32 ints of the block scan
};

static inline size_t stage_bytes(int rows, int cols, int cap) {
  const size_t nb = (size_t)rows * cols;
  return nb * cap * (sizeof(uint2) + sizeof(uint32_t)) + (nb + 1 + rows + 32) * sizeof(int);
}

static __device__ __forceinline__ StageBuffers stage_buffers(unsigned char* smem, int rows,
                                                             int cols, int cap) {
  const int nb = rows * cols;
  StageBuffers sm;
  sm.cand = reinterpret_cast<uint2*>(smem);
  sm.info = reinterpret_cast<uint32_t*>(sm.cand + (size_t)nb * cap);
  sm.start = reinterpret_cast<int*>(sm.info + (size_t)nb * cap);
  sm.row_recv = sm.start + nb + 1;
  sm.scratch = sm.row_recv + rows;
  return sm;
}

// Stage the region; every thread of the block calls it, and the block has at
// least rows * cols threads (one per bucket). Returns the number of
// receivers. Ends with a __syncthreads; the caller syncs again before the
// next stage overwrites the buffers.
static __device__ __forceinline__ int stage_region(const uint32_t* __restrict__ x,
                                                   const uint32_t* __restrict__ y,
                                                   const int32_t* __restrict__ ty,
                                                   const StageGeom& g, const StageBuffers& sm) {
  const int nb = g.rows * g.cols;
  const int b = threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long base = 0;
  int cnt = 0;
  if (b < nb) {
    const int rr = b / g.cols;
    const int by = g.row0 + rr, bx = g.col0 + (b - rr * g.cols);
    if (by >= 0 && by < g.gy && bx >= 0 && bx < g.gx) {
      base = g.grid_base + ((long)by * g.gx + bx) * g.cap;
      for (int s = 0; s < g.width; ++s) cnt += __ldg(ty + base + s) >= 0;
    }
  }
  // exclusive scan of cnt over the block's threads, in bucket order
  int inc = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) sm.scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    const int total = lane < n_warps ? sm.scratch[lane] : 0;
    int w = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    sm.scratch[lane] = w - total;
  }
  __syncthreads();
  int pos = inc - cnt + sm.scratch[warp];
  if (b < nb) sm.start[b] = pos;
  if (b == nb - 1) sm.start[nb] = pos + cnt;
  if (cnt) {
    const uint32_t tag = (uint32_t)b << 16;
    for (int s = 0; s < g.width; ++s) {
      if (__ldg(ty + base + s) < 0) continue;
      sm.cand[pos] = make_uint2(__ldg(x + base + s), __ldg(y + base + s));
      sm.info[pos] = tag | (uint32_t)s;
      ++pos;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int r = 0; r < g.in_rows; ++r) {
      sm.row_recv[r] = acc;
      const int* st = sm.start + (r + 1) * g.cols + 1;
      acc += st[g.in_cols] - st[0];
    }
    sm.row_recv[g.in_rows] = acc;
  }
  __syncthreads();
  return sm.row_recv[g.in_rows];
}

struct Receiver {
  int pos;     // its place in cand
  int rr, rb;  // its region row and column
  long slot;   // its slot in the arrays
};

// receiver number k (0 <= k < stage_region()'s count) of the staged region
static __device__ __forceinline__ Receiver staged_receiver(int k, const StageGeom& g,
                                                           const StageBuffers& sm) {
  int r = 0;
  while (r + 1 < g.in_rows && k >= sm.row_recv[r + 1]) ++r;
  Receiver rc;
  rc.pos = sm.start[(r + 1) * g.cols + 1] + (k - sm.row_recv[r]);
  const uint32_t info = sm.info[rc.pos];
  const int b = (int)(info >> 16);
  rc.rr = r + 1;
  rc.rb = b - rc.rr * g.cols;
  rc.slot = g.grid_base + ((long)(g.row0 + rc.rr) * g.gx + (g.col0 + rc.rb)) * g.cap +
            (long)(info & 0xffffu);
  return rc;
}

// pairs per iteration of the run loop (its unroll)
constexpr int PS_RUN_UNROLL = 2;

// add the pair forces of candidates [a, b) onto (fx, fy), one at a time in
// ascending order; with SKIP, candidate `self` adds nothing
template <bool SKIP>
static __device__ __forceinline__ void add_run(const StepScalars& sc, const uint2* cand, int a,
                                               int b, int self, uint32_t xi, uint32_t yi,
                                               float& fx, float& fy) {
#pragma unroll PS_RUN_UNROLL
  for (int q = a; q < b; ++q) {
    if (SKIP && q == self) continue;
    const uint2 c = cand[q];
    const float ddx = __fmul_rn(__int2float_rn((int32_t)(c.x - xi)), sc.scale_x);
    const float ddy = __fmul_rn(__int2float_rn((int32_t)(c.y - yi)), sc.scale_y);
    const float f = pair_f_over_r(sc, __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)));
    fx = __fadd_rn(fx, __fmul_rn(f, ddx));
    fy = __fadd_rn(fy, __fmul_rn(f, ddy));
  }
}

// the pair forces of a staged receiver's 3x3 neighbourhood, in the classic
// step's order: dy outer, dx inner, slots ascending
static __device__ __forceinline__ void staged_pair_forces(const StepScalars& sc,
                                                          const StageGeom& g,
                                                          const StageBuffers& sm,
                                                          const Receiver& rc, uint32_t xi,
                                                          uint32_t yi, float& fx, float& fy) {
  const int* st = sm.start + rc.rr * g.cols + rc.rb;  // the receiver's bucket
  add_run<false>(sc, sm.cand, st[-g.cols - 1], st[-g.cols + 2], 0, xi, yi, fx, fy);
  add_run<true>(sc, sm.cand, st[-1], st[2], rc.pos, xi, yi, fx, fy);
  add_run<false>(sc, sm.cand, st[g.cols - 1], st[g.cols + 2], 0, xi, yi, fx, fy);
}

// step the staged region's n_recv receivers (stage_region()'s count): a
// thread takes a live receiver, adds its 3x3 neighbourhood's pair forces
// onto its cursor and wall force, and leapfrogs into the outputs
static __device__ __forceinline__ void step_staged_receivers(
    const StepScalars& sc, const StageGeom& g, const StageBuffers& sm, int n_recv,
    const float* __restrict__ vx, const float* __restrict__ vy, uint32_t* __restrict__ ox,
    uint32_t* __restrict__ oy, float* __restrict__ ovx, float* __restrict__ ovy) {
  for (int r = threadIdx.x; r < n_recv; r += blockDim.x) {
    const Receiver rc = staged_receiver(r, g, sm);
    const uint2 self = sm.cand[rc.pos];
    const float vxi = vx[rc.slot], vyi = vy[rc.slot];
    float fx, fy;
    external_force(sc, self.x, self.y, fx, fy);
    staged_pair_forces(sc, g, sm, rc, self.x, self.y, fx, fy);
    leapfrog(sc, self.x, self.y, vxi, vyi, fx, fy, ox[rc.slot], oy[rc.slot], ovx[rc.slot],
             ovy[rc.slot]);
  }
}

// Pass-through of a rectangle of `rows` grid rows x `row_slots` contiguous
// slots (first slot `first`, `row_stride` slots from a row to the next):
// every slot that cannot be live (its index in the bucket at or past
// `width`; width 0 = a dead tile) or whose ty < 0 is copied from the inputs
// to the outputs. With `vec` (cap a multiple of 4, every pointer 16-byte
// aligned) a thread moves 4 slots of a field at a time, neighbouring threads
// on neighbouring 16 bytes.
static __device__ __forceinline__ void copy_dead_slots(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const int32_t* __restrict__ ty, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    float* __restrict__ ovx, float* __restrict__ ovy, long first, long row_stride, int rows,
    int row_slots, int cap, int width, bool vec) {
  if (vec) {
    const int groups = row_slots >> 2;
    for (int k = threadIdx.x; k < rows * groups; k += blockDim.x) {
      const int r = k / groups, c = (k - r * groups) << 2;
      const long i = first + r * row_stride + c;
      bool dead = c % cap >= width;
      int4 t = make_int4(-1, -1, -1, -1);
      if (!dead) {
        t = *reinterpret_cast<const int4*>(ty + i);
        dead = t.x < 0 && t.y < 0 && t.z < 0 && t.w < 0;
      }
      if (dead) {
        *reinterpret_cast<uint4*>(ox + i) = *reinterpret_cast<const uint4*>(x + i);
        *reinterpret_cast<uint4*>(oy + i) = *reinterpret_cast<const uint4*>(y + i);
        *reinterpret_cast<float4*>(ovx + i) = *reinterpret_cast<const float4*>(vx + i);
        *reinterpret_cast<float4*>(ovy + i) = *reinterpret_cast<const float4*>(vy + i);
        continue;
      }
      const int te[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (te[e] >= 0) continue;
        ox[i + e] = x[i + e];
        oy[i + e] = y[i + e];
        ovx[i + e] = vx[i + e];
        ovy[i + e] = vy[i + e];
      }
    }
    return;
  }
  for (int k = threadIdx.x; k < rows * row_slots; k += blockDim.x) {
    const int r = k / row_slots, c = k - r * row_slots;
    const long i = first + r * row_stride + c;
    if (c % cap < width && ty[i] >= 0) continue;
    ox[i] = x[i];
    oy[i] = y[i];
    ovx[i] = vx[i];
    ovy[i] = vy[i];
  }
}
