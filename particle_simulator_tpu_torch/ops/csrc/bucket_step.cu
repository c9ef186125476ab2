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
// over. The tile-scheduled kernel below stages and compacts the
// neighbourhood in shared memory (bucket_stage.cuh); this kernel does not yet.
// The force law itself (cursor, wall, pair term, leapfrog) is shared with
// the all-pairs kernel in ps_common.cuh.
#include "bucket_stage.cuh"

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

// The ext-layout step: the port of bucket_pallas.py:bucket_step_pallas_ext,
// whose two pallas_calls are _step_kernel_compact (compact=True, the grid
// visits ExtStepAux.order: live tiles first, then repeats of the last one)
// and _step_kernel with out_off=0 (compact=False, the natural tile grid, a
// dead tile copied through). Plain version: physics/bucket.py:
// bucket_step_ext; aux: physics/bucket.py:ext_step_aux.
//
// Tile t is row block t / n_chunks (ty_rows bucket rows) x lane chunk
// t % n_chunks (gx / n_chunks buckets), all cap slots: on the 1M user scene
// 8 x 128 x 16 = 16,384 slots. A block owns one sub-tile (sub_r rows x sub_b
// buckets, blockIdx.x) of the tiles it visits; the blocks of one blockIdx.x
// walk the tile list from blockIdx.y with stride gridDim.y, so a launch
// sized for the card covers every live tile without the host learning how
// many there are.
//
// What bounds it: the pair math of the live slots (operations). On a sparse
// cap-16 grid (the user scene: ~4 live slots in an occupied bucket, one
// bucket in five occupied, omax 6-8) a thread per slot leaves three of four
// lanes of a live warp on tombstones while the fourth walks 9 x omax
// candidate slots, most of them tombstones behind a 4-byte load and a
// branch. What the design does about it (bucket_stage.cuh):
// - the block stages its sub-tile plus one ring of buckets, slots below omax
//   only (params[P_OMAX], the largest live slot index + 1 over the grid;
//   exact, every slot at or past it is a tombstone), and compacts the live
//   candidates into shared memory in (row, bucket, slot) order with each
//   bucket's start offset (a count, a block scan, a write);
// - threads take receivers from the staged interior's live slots only, so
//   every lane of every warp but the last holds a live particle, and a
//   receiver's candidates are three contiguous runs of shared memory read
//   with no ty test: the classic candidate order (dy outer, dx inner, slots
//   ascending) with the tombstones left out, the same rounding, so the
//   result is bit-identical to the classic step;
// - pass-through is a copy of its own, never the receiver threads' work:
//   without COMPACT the block first copies its sub-tile's tombstones (every
//   slot of a dead tile, without reading ty) 16 bytes a thread; with COMPACT
//   nothing but live slots is written.
//
// COMPACT: the walk ends at sizes[0]; a dead tile (only the all-dead grid's
// one visit) and a dead slot write nothing. The wrapper steps between two
// buffers that hold the same bytes on every slot no step of the chunk
// writes (the counterpart of the Pallas call's input/output aliasing, at
// slot grain). Otherwise every tile is visited and every slot written.
constexpr int P_OMAX = P_COUNT;  // the aux appends omax to the params vector
constexpr int TILE_THREADS = 256;  // at least one thread per staged bucket
constexpr int TILE_SUB_ROWS = 8;   // a sub-tile: at most 8 rows x 16 buckets,
constexpr int TILE_SUB_COLS = 16;  // staged as 10 x 18 buckets with its ring

template <bool COMPACT>
__global__ void __launch_bounds__(TILE_THREADS) bucket_step_tiles_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const int32_t* __restrict__ ty, const float* __restrict__ params,
    const int32_t* __restrict__ flags, const int32_t* __restrict__ order,
    const int32_t* __restrict__ sizes,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    float* __restrict__ ovx, float* __restrict__ ovy,
    int gy, int gx, int cap, int ty_rows, int n_chunks, int sub_r, int sub_b, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StepScalars sc;
  const int n_visits = COMPACT ? __ldg(sizes) : (gy / ty_rows) * n_chunks;
  if ((int)blockIdx.y >= n_visits) return;
  if (threadIdx.x == 0) step_scalars(params, sc);
  __syncthreads();

  const int omax = min(max((int)__ldg(params + P_OMAX), 0), cap);
  const int row_buckets = gx / n_chunks;
  const int subs_x = (row_buckets + sub_b - 1) / sub_b;
  const int sub_y = blockIdx.x / subs_x, sub_x = blockIdx.x - sub_y * subs_x;
  StageGeom g;
  g.grid_base = 0;
  g.gy = gy;
  g.gx = gx;
  g.cap = cap;
  g.rows = sub_r + 2;
  g.cols = sub_b + 2;
  g.in_rows = min(sub_r, ty_rows - sub_y * sub_r);  // the tile's edge cuts the sub-tile
  g.in_cols = min(sub_b, row_buckets - sub_x * sub_b);
  g.width = omax;
  const StageBuffers sm = stage_buffers(smem, g.rows, g.cols, cap);

  for (int k = blockIdx.y; k < n_visits; k += gridDim.y) {
    // tiles in their natural order without COMPACT: a walk that spreads
    // live and dead tiles over the blocks in flight was measured slower
    // (PERF.md), the copies stream best through neighbouring tiles
    const int tile = COMPACT ? __ldg(order + k) : k;
    const bool live = __ldg(flags + tile) != 0;
    const int row = (tile / n_chunks) * ty_rows + sub_y * sub_r;
    const int col = (tile % n_chunks) * row_buckets + sub_x * sub_b;
    if (!COMPACT) {
      copy_dead_slots(x, y, vx, vy, ty, ox, oy, ovx, ovy, ((long)row * gx + col) * cap,
                      (long)gx * cap, g.in_rows, g.in_cols * cap, cap, live ? omax : 0,
                      vec != 0);
    }
    if (!live) continue;
    g.row0 = row - 1;
    g.col0 = col - 1;
    const int n_recv = stage_region(x, y, ty, g, sm);
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
    __syncthreads();  // the stage is consumed before the next visit overwrites it
  }
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

// The ext-layout step of one (gy, gx, cap) grid over its tiles (ty_rows
// rows x gx / n_chunks buckets). compact = 1 visits order[0 .. sizes[0])
// and writes only live slots; compact = 0 visits every tile and writes
// every slot. A tile is cut into sub-tiles of at most TILE_SUB_ROWS x
// TILE_SUB_COLS buckets (fewer columns where cap is large, so the staged
// region fits shared memory), one block each. The launch has about
// block_budget blocks: each tile's sub-tiles span gridDim.x blocks, and
// gridDim.y (at most the tile count) block columns walk the tile list.
extern "C" int ps_bucket_step_tiles(
    const void* x, const void* y, const void* vx, const void* vy,
    const void* ty, const void* params, const void* flags, const void* order,
    const void* sizes, void* ox, void* oy, void* ovx, void* ovy,
    int gy, int gx, int cap, int ty_rows, int n_chunks, int compact,
    int block_budget, void* stream) {
  const size_t smem_budget = 40 * 1024, smem_limit = 200 * 1024;
  const int row_buckets = gx / n_chunks;
  const int sub_r = ty_rows < TILE_SUB_ROWS ? ty_rows : TILE_SUB_ROWS;
  int sub_b = row_buckets < TILE_SUB_COLS ? row_buckets : TILE_SUB_COLS;
  while (sub_b > 1 && stage_bytes(sub_r + 2, sub_b + 2, cap) > smem_budget) --sub_b;
  const size_t smem = stage_bytes(sub_r + 2, sub_b + 2, cap);
  if (smem > smem_limit || cap > 0xffff) return (int)cudaErrorInvalidValue;
  const unsigned tile_x = ps_blocks(ty_rows, sub_r) * ps_blocks(row_buckets, sub_b);
  const int n_tiles = (gy / ty_rows) * n_chunks;
  const int walkers = (int)((block_budget + tile_x - 1) / tile_x);
  const dim3 blocks(tile_x, walkers < 1 ? 1 : (walkers > n_tiles ? n_tiles : walkers));
  const cudaStream_t s = (cudaStream_t)stream;
  // 16 bytes a thread in the pass-through copy needs aligned rows of slots
  const void* fields[] = {x, y, vx, vy, ty, ox, oy, ovx, ovy};
  int vec = cap % 4 == 0;
  for (const void* f : fields) vec = vec && ((uintptr_t)f & 15) == 0;
  auto kernel = compact ? bucket_step_tiles_kernel<true> : bucket_step_tiles_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, TILE_THREADS, smem, s>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const float*)vx,
      (const float*)vy, (const int32_t*)ty, (const float*)params,
      (const int32_t*)flags, (const int32_t*)order, (const int32_t*)sizes,
      (uint32_t*)ox, (uint32_t*)oy, (float*)ovx, (float*)ovy,
      gy, gx, cap, ty_rows, n_chunks, sub_r, sub_b, vec);
  return (int)cudaGetLastError();
}

// pairs per iteration of the tile-scheduled kernel's run loop, for the
// per-pair instruction counts chip_smoke.py reads from its SASS
extern "C" int ps_bucket_tiles_pairs_per_iter() { return PS_RUN_UNROLL; }
