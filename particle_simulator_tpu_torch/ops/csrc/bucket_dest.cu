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
// rows' ids outside the kernel on 3-row slices; here one thread per slot
// covers the whole padded shard.
//
// What it computes: destid[p] = (tgt_by*BX + tgt_bx)*CAP + rank, or -1 when
// p is dead, drifted more than one bucket from its target (the top bits of
// its coordinates), or overflowed (rank >= CAP). The rank follows the
// target's pull scan: source buckets T + (dy, dx), dy outer then dx, from -1
// to 1, slots ascending; out-of-grid source buckets hold nothing.
//
// What bounds it on the H100: integer work and L1/L2 reads. A pullable slot
// scans at most 9*CAP candidates (three 4-byte loads and a few integer ops
// each) and stops as soon as it knows it overflowed; it writes 4 bytes.
// It runs once per 16 steps.
//
// What the design does about it: one thread per source slot computes its
// own rank directly by counting the pullable, same-target candidates that
// precede it in the scan, so no cross-thread prefix sum, atomics or second
// pass is needed and the result is bit-identical to the plain version by
// construction (integers only, the same order). The Pallas kernel's
// bit-packed in-VMEM prefix sums and row-window blocking exist for the
// TPU's vector unit and are not carried over.
#include "bucket_common.cuh"

namespace {

// One thread per slot of n_grids stacked (gy, gx, cap) grids (blockIdx.y =
// the grid). HALO: each grid is a shard with a ring of one bucket around its
// (gy - 2, gx - 2) interior, at the global (row, column) bucket offsets
// `offsets` (int32, n_grids x 2). Otherwise the grid is the whole box: every
// target lies inside it and the offsets are (0, 0). A template parameter, so
// the single-device pass carries none of the halo mode's checks.
template <bool HALO>
__global__ void bucket_dest_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const int32_t* __restrict__ ty, const int32_t* __restrict__ offsets,
    int32_t* __restrict__ destid, int gy, int gx, int cap,
    int bx_log2, int by_log2) {
  constexpr int ring = HALO ? 1 : 0;
  // slot i of the stack and its grid's first slot
  const int g = blockIdx.y;
  long i, grid_base;
  if (HALO) {
    const int grid_slots = gy * gx * cap;
    const int li = blockIdx.x * blockDim.x + threadIdx.x;
    if (li >= grid_slots) return;
    grid_base = (long)g * grid_slots;
    i = grid_base + li;
  } else {  // 64-bit indices: on one grid, 2% faster than the above on the H100
    i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long)gy * gx * cap) return;
    grid_base = 0;
  }
  const int ly = gy - 2 * ring, lx = gx - 2 * ring;
  const int row_off = HALO ? offsets[2 * g] : 0;
  const int col_off = HALO ? offsets[2 * g + 1] : 0;
  const int slot = (int)((i - grid_base) % cap);
  const int b = (int)((i - grid_base) / cap);
  const int cbx = b % gx - ring, cby = b / gx - ring;  // interior coordinates
  const int tbx = ps_bucket_of(x[i], bx_log2) - col_off;
  const int tby = ps_bucket_of(y[i], by_log2) - row_off;
  const int dy = cby - tby, dx = cbx - tbx;
  if (ty[i] < 0 || (HALO && (tby < 0 || tby >= ly || tbx < 0 || tbx >= lx)) ||
      dy < -1 || dy > 1 || dx < -1 || dx > 1) {
    destid[i] = -1;
    return;
  }
  const int my_block = (dy + 1) * 3 + (dx + 1);

  int rank = 0;
  for (int k = 0; k <= my_block && rank < cap; ++k) {
    // source bucket T + (dy, dx) in grid coordinates
    const int sby = tby + ring + k / 3 - 1, sbx = tbx + ring + k % 3 - 1;
    if (!HALO && (sby < 0 || sby >= gy || sbx < 0 || sbx >= gx)) continue;
    const long base = grid_base + ((long)sby * gx + sbx) * cap;
    const int n = k < my_block ? cap : slot;  // own bucket: earlier slots only
    for (int s = 0; s < n; ++s) {
      const long j = base + s;
      // a live candidate of bucket T + (dy, dx) that targets T is pullable
      if (__ldg(ty + j) >= 0 && ps_bucket_of(__ldg(x + j), bx_log2) - col_off == tbx &&
          ps_bucket_of(__ldg(y + j), by_log2) - row_off == tby) {
        ++rank;
      }
    }
  }
  destid[i] = rank < cap ? (tby * lx + tbx) * cap + rank : -1;
}

}  // namespace

// ring = 0: the single-device grid (offsets unused, may be null); ring = 1:
// halo-padded shards with their global bucket offsets
extern "C" int ps_bucket_dest(
    const void* x, const void* y, const void* ty, const void* offsets, void* destid,
    int n_grids, int gy, int gx, int cap, int bx_log2, int by_log2, int ring,
    void* stream) {
  const int threads = 256;
  const dim3 blocks(ps_blocks((long)gy * gx * cap, threads), n_grids);
  const cudaStream_t s = (cudaStream_t)stream;
  if (ring) {
    bucket_dest_kernel<true><<<blocks, threads, 0, s>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const int32_t*)ty,
        (const int32_t*)offsets, (int32_t*)destid, gy, gx, cap, bx_log2, by_log2);
  } else {
    bucket_dest_kernel<false><<<blocks, threads, 0, s>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const int32_t*)ty,
        (const int32_t*)offsets, (int32_t*)destid, gy, gx, cap, bx_log2, by_log2);
  }
  return (int)cudaGetLastError();
}
