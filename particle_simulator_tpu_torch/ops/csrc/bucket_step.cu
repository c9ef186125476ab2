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
// What bounds it on the H100: the pair math (operations), and how many
// lanes do it. Each live slot evaluates its live 3x3-neighbourhood
// candidates, each one logf and two expf (full precision: the library's
// polynomial forms, not the SFU approximations) plus ~15 f32 multiplies and
// adds, against 20 bytes of its own state: ~75M pair evaluations a step at
// 1M particles and CAP 8. On a sparse cap-16 grid (a scene drawn in part of
// its box: a few live slots in an occupied bucket, most buckets empty) a
// thread per slot leaves most lanes of a live warp on tombstones while one
// walks 9 x CAP candidate slots behind a 4-byte load and a branch each, and
// the dead slots' 32 bytes of pass-through become the larger part of the
// traffic.
//
// What the design does about it (bucket_stage.cuh, shared with the
// tile-scheduled kernel below):
// - a block owns sub-tiles of at most TILE_SUB_ROWS x TILE_SUB_COLS receiver
//   buckets of one grid of the stack (the last sub-tile of a row or column
//   is cut, so the grid's sides need no multiple of anything). It stages the
//   sub-tile plus one ring of buckets and compacts the live candidates into
//   shared memory in (row, bucket, slot) order with each bucket's start;
// - threads take receivers from the staged interior's live slots only, so
//   every lane of every warp but the last holds a live particle, and a
//   receiver's candidates are three contiguous runs of shared memory read
//   with no ty test: the fixed candidate order (dy outer, dx inner, slots
//   ascending) with the tombstones left out, one f32 accumulator a thread,
//   explicit round-to-nearest operations. No float atomics, no shuffles
//   across receivers, and the same result on every run and as the plain
//   version to the bit (a tombstone adds nothing to that sum);
// - pass-through is a copy of its own, 16 bytes a thread where CAP allows:
//   the sub-tile's dead slots (all of them without reading ty again when the
//   stage found no receiver, none when it found every slot live), and in
//   halo mode the ring strips next to the sub-tiles on the interior's edge,
//   whole, so every slot of the output is written exactly once;
// - buckets past the box edge stage as empty (no periodic wrap); in halo
//   mode the staged ring is the padded shard's own ring, always in bounds.
// The per-dispatch scalars (log-domain pair constants, wall constant) are
// computed once per block by one thread, from the params tensor on the
// device, so a metadata edit changes a tensor and never the launch. The
// Pallas kernel's lane rolls, lane-validity table, lane chunking and
// occupancy pass skips exist for the TPU's vector unit and are not carried
// over. The force law itself (cursor, wall, pair term, leapfrog) is shared
// with the all-pairs kernel in ps_common.cuh. Limits: CAP <= 0xffff and a
// staged 3 x 3 buckets must fit 200 KB of shared memory (CAP <= 1896).
#include <initializer_list>

#include "bucket_stage.cuh"

namespace {

constexpr int TILE_THREADS = 256;  // at least one thread per staged bucket
constexpr int TILE_SUB_ROWS = 8;   // a sub-tile: at most 8 rows x 16 buckets,
constexpr int TILE_SUB_COLS = 16;  // staged as 10 x 18 buckets with its ring

// n_grids stacked (gy, gx, cap) grids, cut into sub-tiles of sub_r x sub_b
// receiver buckets (the last of a row or column cut); a block takes the
// sub-tiles blockIdx.x, + gridDim.x, ... of all grids (the launch gives it
// one). Without HALO every live slot of a grid is a receiver and
// candidates past the grid's edge (the box edge) do not exist; with HALO
// the receivers are the live interior slots (rows 1..gy-2, columns
// 1..gx-2) and the ring supplies candidates and passes through whole. A
// template parameter, so the single-device step carries none of the halo
// mode's strips.
template <bool HALO>
__global__ void __launch_bounds__(TILE_THREADS) bucket_step_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const float* __restrict__ vx, const float* __restrict__ vy,
    const int32_t* __restrict__ ty, const float* __restrict__ params,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    float* __restrict__ ovx, float* __restrict__ ovy,
    int n_grids, int gy, int gx, int cap, int sub_r, int sub_b, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ StepScalars sc;
  if (threadIdx.x == 0) step_scalars(params, sc);
  __syncthreads();

  constexpr int ring = HALO ? 1 : 0;
  const int ry = gy - 2 * ring, rx = gx - 2 * ring;  // the receivers' rectangle
  const int subs_y = (ry + sub_r - 1) / sub_r, subs_x = (rx + sub_b - 1) / sub_b;
  const long per_grid = (long)subs_y * subs_x, n_subs = per_grid * n_grids;
  const long row_stride = (long)gx * cap;
  StageGeom g;
  g.gy = gy;
  g.gx = gx;
  g.cap = cap;
  g.rows = sub_r + 2;
  g.cols = sub_b + 2;
  g.width = cap;
  const StageBuffers sm = stage_buffers(smem, g.rows, g.cols, cap);

  for (long t = blockIdx.x; t < n_subs; t += gridDim.x) {
    const long grid = t / per_grid;
    const int sub = (int)(t - grid * per_grid);
    const int sy = sub / subs_x, sx = sub - sy * subs_x;
    const int row = ring + sy * sub_r, col = ring + sx * sub_b;  // first receiver bucket
    g.grid_base = grid * gy * row_stride;
    g.row0 = row - 1;
    g.col0 = col - 1;
    g.in_rows = min(sub_r, ry - sy * sub_r);  // the grid's edge cuts the sub-tile
    g.in_cols = min(sub_b, rx - sx * sub_b);
    const int n_recv = stage_region(x, y, ty, g, sm);

    // pass-through of the sub-tile's dead slots: none when every slot is a
    // receiver, all of them (ty not read again) when there is none
    if (n_recv < g.in_rows * g.in_cols * cap) {
      copy_dead_slots(x, y, vx, vy, ty, ox, oy, ovx, ovy,
                      g.grid_base + ((long)row * gx + col) * cap, row_stride, g.in_rows,
                      g.in_cols * cap, cap, n_recv ? cap : 0, vec != 0);
    }
    if (HALO) {
      // the ring strips beside a sub-tile on the interior's edge, live slots
      // and all (width 0 copies a rectangle whole); the row strips take the
      // corners, so every ring slot is written by exactly one block
      const bool last_y = sy == subs_y - 1, last_x = sx == subs_x - 1;
      const int c_lo = sx == 0 ? 0 : col, c_hi = last_x ? gx : col + g.in_cols;
      if (sy == 0) {
        copy_dead_slots(x, y, vx, vy, ty, ox, oy, ovx, ovy, g.grid_base + (long)c_lo * cap,
                        row_stride, 1, (c_hi - c_lo) * cap, cap, 0, vec != 0);
      }
      if (last_y) {
        copy_dead_slots(x, y, vx, vy, ty, ox, oy, ovx, ovy,
                        g.grid_base + ((long)(gy - 1) * gx + c_lo) * cap, row_stride, 1,
                        (c_hi - c_lo) * cap, cap, 0, vec != 0);
      }
      if (sx == 0) {
        copy_dead_slots(x, y, vx, vy, ty, ox, oy, ovx, ovy, g.grid_base + (long)row * gx * cap,
                        row_stride, g.in_rows, cap, cap, 0, vec != 0);
      }
      if (last_x) {
        copy_dead_slots(x, y, vx, vy, ty, ox, oy, ovx, ovy,
                        g.grid_base + ((long)row * gx + gx - 1) * cap, row_stride, g.in_rows,
                        cap, cap, 0, vec != 0);
      }
    }

    step_staged_receivers(sc, g, sm, n_recv, vx, vy, ox, oy, ovx, ovy);
    __syncthreads();  // the stage is consumed before the next sub-tile overwrites it
  }
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
    step_staged_receivers(sc, g, sm, n_recv, vx, vy, ox, oy, ovx, ovy);
    __syncthreads();  // the stage is consumed before the next visit overwrites it
  }
}

// The sub-tile of a launch: at most TILE_SUB_ROWS x TILE_SUB_COLS buckets of
// a rows x cols rectangle, with fewer columns where cap is large, so the
// staged region fits shared memory; false when even one column does not
struct SubTile {
  int rows, cols;
  size_t smem;
};

static bool pick_sub_tile(int rows, int cols, int cap, SubTile& st) {
  const size_t smem_budget = 40 * 1024, smem_limit = 200 * 1024;
  st.rows = rows < TILE_SUB_ROWS ? rows : TILE_SUB_ROWS;
  st.cols = cols < TILE_SUB_COLS ? cols : TILE_SUB_COLS;
  while (st.cols > 1 && stage_bytes(st.rows + 2, st.cols + 2, cap) > smem_budget) --st.cols;
  st.smem = stage_bytes(st.rows + 2, st.cols + 2, cap);
  return st.smem <= smem_limit && cap <= 0xffff;
}

// 16 bytes a thread in the pass-through copy needs cap a multiple of 4 and
// aligned arrays: every bucket then starts on 16 bytes
static int copies_vectorize(int cap, std::initializer_list<const void*> fields) {
  int vec = cap % 4 == 0;
  for (const void* f : fields) vec = vec && ((uintptr_t)f & 15) == 0;
  return vec;
}

template <typename Kernel>
static cudaError_t allow_shared_memory(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  const int ry = gy - (ring ? 2 : 0), rx = gx - (ring ? 2 : 0);
  SubTile st;
  if (n_grids < 1 || ry < 1 || rx < 1 || !pick_sub_tile(ry, rx, cap, st)) {
    return (int)cudaErrorInvalidValue;
  }
  // one block a sub-tile: fewer blocks striding over the sub-tiles timed the
  // same on a dense grid and slower on a sparse one (PERF.md)
  const long blocks = (long)ps_blocks(ry, st.rows) * ps_blocks(rx, st.cols) * n_grids;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int vec = copies_vectorize(cap, {x, y, vx, vy, ty, ox, oy, ovx, ovy});
  auto kernel = ring ? bucket_step_kernel<true> : bucket_step_kernel<false>;
  const cudaError_t err = allow_shared_memory(kernel, st.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, TILE_THREADS, st.smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const float*)vx,
      (const float*)vy, (const int32_t*)ty, (const float*)params,
      (uint32_t*)ox, (uint32_t*)oy, (float*)ovx, (float*)ovy,
      n_grids, gy, gx, cap, st.rows, st.cols, vec);
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
  const int row_buckets = gx / n_chunks;
  SubTile st;
  if (!pick_sub_tile(ty_rows, row_buckets, cap, st)) return (int)cudaErrorInvalidValue;
  const unsigned tile_x = ps_blocks(ty_rows, st.rows) * ps_blocks(row_buckets, st.cols);
  const int n_tiles = (gy / ty_rows) * n_chunks;
  const int walkers = (int)((block_budget + tile_x - 1) / tile_x);
  const dim3 blocks(tile_x, walkers < 1 ? 1 : (walkers > n_tiles ? n_tiles : walkers));
  const int vec = copies_vectorize(cap, {x, y, vx, vy, ty, ox, oy, ovx, ovy});
  auto kernel = compact ? bucket_step_tiles_kernel<true> : bucket_step_tiles_kernel<false>;
  const cudaError_t err = allow_shared_memory(kernel, st.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, TILE_THREADS, st.smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const float*)vx,
      (const float*)vy, (const int32_t*)ty, (const float*)params,
      (const int32_t*)flags, (const int32_t*)order, (const int32_t*)sizes,
      (uint32_t*)ox, (uint32_t*)oy, (float*)ovx, (float*)ovy,
      gy, gx, cap, ty_rows, n_chunks, st.rows, st.cols, vec);
  return (int)cudaGetLastError();
}

// pairs per iteration of the tile-scheduled kernel's run loop, for the
// per-pair instruction counts chip_smoke.py reads from its SASS
extern "C" int ps_bucket_tiles_pairs_per_iter() { return PS_RUN_UNROLL; }
