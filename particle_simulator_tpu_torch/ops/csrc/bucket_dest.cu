// Destination slot of every source slot for the rebucket pass: the port of
// particle_simulator_tpu/ops/bucket_pallas.py:_dest_kernel (reached through
// move_dest_pallas), and of its halo mode (_dest_kernel(halo=True), reached
// through move_dest_pallas_halo). Plain versions:
// particle_simulator_tpu_torch/physics/bucket.py:move_dest_direct and
// move_dest_direct_halo.
//
// Halo mode (ring = 1): the input is a stack of shards, each padded with one
// ring of its neighbours' buckets. Every slot, ring included, computes its
// target from the global top bits minus its shard's (row, column) bucket
// offsets; it is kept when it is live, targets an interior bucket, lies
// within one bucket of it and ranks below CAP. Its id is numbered in the
// shard's interior, (tgt_by*LX + tgt_bx)*CAP + rank. The ring's ids are what
// the place pulls in from the neighbours (migration). The Pallas kernel
// numbers its ids in the padded lane layout and computes the two y-halo
// rows' ids outside the kernel on 3-row slices; here the blocks cover the
// whole padded shard.
//
// What it computes: destid[p] = (tgt_by*BX + tgt_bx)*CAP + rank, or -1 when
// p is dead, drifted more than one bucket from its target (the top bits of
// its coordinates), or overflowed (rank >= CAP). The rank follows the
// target's pull scan: source buckets T + (dy, dx), dy outer then dx, from -1
// to 1, slots ascending; out-of-grid source buckets hold nothing.
//
// What bounds it on the H100: bytes (12 read and 4 written a slot, ~5 us at
// 1M slots), so the time is what the kernel adds on top: re-reads and
// integer work. A thread per source slot that counts the candidates ahead
// of it re-reads ty, x, y of up to 9*CAP candidates and derives each one's
// target again, so a bucket's targets are computed ~9*CAP times over; a
// warp per target that scans 9*CAP staged keys with ballots reads each
// array once but does as much integer work (both took 0.045 ms at 1M slots
// on an NVIDIA H100 80GB HBM3 at 700 W; this form 0.015 ms).
//
// What the design does about it: the scan is turned round, so that a
// slot's target is derived once and every target's scan is nine additions.
// - A block owns a sub-tile of at most DEST_SUB_ROWS x DEST_SUB_COLS target
//   buckets (fewer where CAP is large, so the block fits shared memory) and
//   stages its sub-tile plus one ring of source buckets. ty, x and y are
//   read once a slot (plus the ring's overlap) with coalesced loads: a
//   region row is one contiguous piece of each array. A slot's code is the
//   scan block k = (dy + 1) * 3 + (dx + 1) at which its target T meets its
//   bucket S = T + (dy, dx), where it is pullable (live, T inside the grid's
//   interior in halo mode and within one bucket of S), else -1.
// - A thread per staged bucket walks its CAP codes in slot order and gives
//   each pullable slot its rank among the bucket's slots of the same scan
//   block, leaving the bucket's nine counts.
// - A thread per target bucket adds the counts in pull order (the count of
//   bucket T + (dy, dx) for scan block k, k = 0..8) and leaves each one's
//   sum before it: the rank at which that bucket's slots start in T.
// - Every staged slot whose target lies in the sub-tile gets T's id with
//   rank = start + its rank in its bucket while that is below CAP, -1 after;
//   every slot of the sub-tile with no target gets -1. A pullable slot lies
//   within one bucket of its target, so its target's block has it staged:
//   every slot of destid is written exactly once, in slot order.
// Integers only and the plain version's scan order (it forms the same
// per-block prefix), so the result is bit-identical to it by construction.
// The Pallas kernel's bit-packed in-VMEM prefix sums and row-window blocking
// exist for the TPU's vector unit and are not carried over. Limits: CAP <
// 2^27 (a code packs the rank above 4 bits) and 3 x 3 staged buckets must
// fit 200 KB of shared memory (CAP <= 5677).
#include "bucket_common.cuh"

namespace {

constexpr int DEST_THREADS = 256;
constexpr int DEST_SUB_ROWS = 8;   // a sub-tile: at most 8 rows x 16 buckets,
constexpr int DEST_SUB_COLS = 16;  // staged as 10 x 18 buckets with its ring

// ints of shared memory a staged bucket takes: its slots' codes, its nine
// counts, its grid row and column
static inline size_t dest_bucket_ints(int cap) { return (size_t)cap + 11; }

// One block per sub-tile (sub_r x sub_b buckets, the last of a row or column
// cut) of n_grids stacked (gy, gx, cap) grids. HALO: each grid is a shard
// with a ring of one bucket around its (gy - 2, gx - 2) interior, at the
// global (row, column) bucket offsets `offsets` (int32, n_grids x 2); only
// interior buckets are targets. Otherwise the grid is the whole box: every
// target lies inside it and the offsets are (0, 0). A template parameter, so
// the single-device pass carries none of the halo mode's checks.
template <bool HALO>
__global__ void __launch_bounds__(DEST_THREADS) bucket_dest_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const int32_t* __restrict__ ty, const int32_t* __restrict__ offsets,
    int32_t* __restrict__ destid, int gy, int gx, int cap,
    int bx_log2, int by_log2, int sub_r, int sub_b) {
  extern __shared__ int32_t shared[];
  constexpr int ring = HALO ? 1 : 0;
  const int subs_y = (gy + sub_r - 1) / sub_r, subs_x = (gx + sub_b - 1) / sub_b;
  const long per_grid = (long)subs_y * subs_x;
  const long grid = blockIdx.x / per_grid;
  const int sub = (int)(blockIdx.x - grid * per_grid);
  const int sy = sub / subs_x, sx = sub - sy * subs_x;
  const int row = sy * sub_r, col = sx * sub_b;  // the sub-tile's first bucket
  const int in_rows = min(sub_r, gy - row), in_cols = min(sub_b, gx - col);
  const int cols = sub_b + 2, nb = (in_rows + 2) * cols;  // the staged region
  const int nb_max = (sub_r + 2) * cols;
  int32_t* code = shared;               // nb x cap: scan block | rank in bucket << 4, or -1
  int32_t* count = code + (size_t)nb_max * cap;  // nb x 9: slots a scan block, then their start
  int32_t* brow = count + nb_max * 9;   // nb: the bucket's grid row
  int32_t* bcol = brow + nb_max;        // and column
  const long grid_base = grid * gy * gx * cap;
  // the global bucket (row, column) of this grid's bucket (0, 0)
  const int row_off = HALO ? offsets[2 * grid] - ring : 0;
  const int col_off = HALO ? offsets[2 * grid + 1] - ring : 0;
  const int lx = gx - 2 * ring;

  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int rr = b / cols;
    brow[b] = row - 1 + rr;
    bcol[b] = col - 1 + (b - rr * cols);
    for (int k = 0; k < 9; ++k) count[b * 9 + k] = 0;
  }
  __syncthreads();

  // a thread's slots i = threadIdx.x, + blockDim.x, ... as (bucket, slot in
  // it), advanced without a division a slot
  const int b0 = threadIdx.x / cap, s0 = threadIdx.x - b0 * cap;
  const int b_step = blockDim.x / cap, s_step = blockDim.x - b_step * cap;

  // 1. a code a slot of the region
  for (int i = threadIdx.x, b = b0, s = s0; i < nb * cap; i += blockDim.x) {
    const int by = brow[b], bx = bcol[b];
    int c = -1;
    if (by >= 0 && by < gy && bx >= 0 && bx < gx) {
      const long j = grid_base + ((long)by * gx + bx) * cap + s;
      if (ty[j] >= 0) {
        // the slot's bucket relative to its target, in this grid's coordinates
        const int tby = ps_bucket_of(y[j], by_log2) - row_off;
        const int tbx = ps_bucket_of(x[j], bx_log2) - col_off;
        const int dy = by - tby, dx = bx - tbx;
        if (tby >= ring && tby < gy - ring && tbx >= ring && tbx < gx - ring &&
            dy >= -1 && dy <= 1 && dx >= -1 && dx <= 1) {
          c = (dy + 1) * 3 + (dx + 1);
        }
      }
    }
    code[i] = c;
    b += b_step, s += s_step;
    if (s >= cap) ++b, s -= cap;
  }
  __syncthreads();

  // 2. a slot's rank among its bucket's slots of the same scan block
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    for (int s = 0; s < cap; ++s) {
      const int c = code[b * cap + s];
      if (c < 0) continue;
      const int w = count[b * 9 + c];
      count[b * 9 + c] = w + 1;
      code[b * cap + s] = c | (w << 4);
    }
  }
  __syncthreads();

  // 3. a target's pull scan: where each of its nine source buckets starts
  for (int t = threadIdx.x; t < in_rows * in_cols; t += blockDim.x) {
    const int tr = t / in_cols, tc = t - tr * in_cols;  // T is region bucket (tr + 1, tc + 1)
    int start = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int at = ((tr + k / 3) * cols + tc + k % 3) * 9 + k;
      const int n = count[at];
      count[at] = start;
      start += n;
    }
  }
  __syncthreads();

  // 4. ids: a slot pulled by a target of the sub-tile, or a slot of the
  // sub-tile that no target pulls
  for (int i = threadIdx.x, b = b0, s = s0; i < nb * cap; i += blockDim.x) {
    const int c = code[i];
    const int by = brow[b], bx = bcol[b];
    const int k = c & 15;
    const int dy = c < 0 ? 0 : k / 3 - 1, dx = c < 0 ? 0 : k % 3 - 1;
    const int tr = by - dy - row, tc = bx - dx - col;  // the target (or the slot) in the sub-tile
    if (tr >= 0 && tr < in_rows && tc >= 0 && tc < in_cols) {
      int id = -1;
      if (c >= 0) {
        const int rank = count[b * 9 + k] + (c >> 4);
        if (rank < cap) id = ((by - dy - ring) * lx + (bx - dx - ring)) * cap + rank;
      }
      destid[grid_base + ((long)by * gx + bx) * cap + s] = id;
    }
    b += b_step, s += s_step;
    if (s >= cap) ++b, s -= cap;
  }
}

}  // namespace

// ring = 0: the single-device grid (offsets unused, may be null); ring = 1:
// halo-padded shards with their global bucket offsets
extern "C" int ps_bucket_dest(
    const void* x, const void* y, const void* ty, const void* offsets, void* destid,
    int n_grids, int gy, int gx, int cap, int bx_log2, int by_log2, int ring,
    void* stream) {
  if (n_grids < 1 || gy < 1 || gx < 1 || cap < 1 || cap >= (1 << 27)) {
    return (int)cudaErrorInvalidValue;
  }
  // the sub-tile: fewer columns, then fewer rows, until the block fits
  const size_t smem_budget = 40 * 1024, smem_limit = 200 * 1024;
  int sub_r = gy < DEST_SUB_ROWS ? gy : DEST_SUB_ROWS;
  int sub_b = gx < DEST_SUB_COLS ? gx : DEST_SUB_COLS;
  auto bytes = [&]() {
    return (size_t)(sub_r + 2) * (sub_b + 2) * dest_bucket_ints(cap) * sizeof(int32_t);
  };
  while (sub_b > 1 && bytes() > smem_budget) --sub_b;
  while (sub_r > 1 && bytes() > smem_budget) --sub_r;
  const size_t smem = bytes();
  const long blocks = (long)ps_blocks(gy, sub_r) * ps_blocks(gx, sub_b) * n_grids;
  if (smem > smem_limit || blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  auto kernel = ring ? bucket_dest_kernel<true> : bucket_dest_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, DEST_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const int32_t*)ty,
      (const int32_t*)offsets, (int32_t*)destid, gy, gx, cap, bx_log2, by_log2, sub_r, sub_b);
  return (int)cudaGetLastError();
}
