// Destination slot of every source slot for the rebucket pass: the port of
// particle_simulator_tpu/ops/bucket_pallas.py:_dest_kernel (reached through
// move_dest_pallas). Plain version:
// particle_simulator_tpu_torch/physics/bucket.py:move_dest_direct.
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

__global__ void bucket_dest_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const int32_t* __restrict__ ty, int32_t* __restrict__ destid,
    int by, int bx, int cap, int bx_log2, int by_log2) {
  const long n_slots = (long)by * bx * cap;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;

  const int slot = (int)(i % cap);
  const int b = (int)(i / cap);
  const int cbx = b % bx, cby = b / bx;
  const int tbx = ps_bucket_of(x[i], bx_log2);
  const int tby = ps_bucket_of(y[i], by_log2);
  const int dy = cby - tby, dx = cbx - tbx;
  if (ty[i] < 0 || dy < -1 || dy > 1 || dx < -1 || dx > 1) {
    destid[i] = -1;
    return;
  }
  const int my_block = (dy + 1) * 3 + (dx + 1);

  int rank = 0;
  for (int k = 0; k <= my_block && rank < cap; ++k) {
    const int sby = tby + k / 3 - 1, sbx = tbx + k % 3 - 1;
    if (sby < 0 || sby >= by || sbx < 0 || sbx >= bx) continue;
    const long base = ((long)sby * bx + sbx) * cap;
    const int n = k < my_block ? cap : slot;  // own bucket: earlier slots only
    for (int s = 0; s < n; ++s) {
      const long j = base + s;
      // a live candidate of bucket T + (dy, dx) that targets T is pullable
      if (__ldg(ty + j) >= 0 && ps_bucket_of(__ldg(x + j), bx_log2) == tbx &&
          ps_bucket_of(__ldg(y + j), by_log2) == tby) {
        ++rank;
      }
    }
  }
  destid[i] = rank < cap ? (tby * bx + tbx) * cap + rank : -1;
}

}  // namespace

extern "C" int ps_bucket_dest(
    const void* x, const void* y, const void* ty, void* destid,
    int by, int bx, int cap, int bx_log2, int by_log2, void* stream) {
  const long n = (long)by * bx * cap;
  const int threads = 256;
  bucket_dest_kernel<<<ps_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const int32_t*)ty,
      (int32_t*)destid, by, bx, cap, bx_log2, by_log2);
  return (int)cudaGetLastError();
}
