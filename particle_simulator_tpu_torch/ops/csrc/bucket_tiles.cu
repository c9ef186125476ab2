// The tile bookkeeping of the live-tile frame (ops/bucket_cuda.py:
// run_frame_bucket_cuda with lane chunks): what each run of steps needs
// before its first live-tile step (bucket_step.cu:bucket_step_kernel_tiles
// <true>), on the card and with no host sync.
//
// ps_tile_aux: the tile aux of a (gy, gx, cap) grid, the port of
// bucket_pallas.py:ext_step_aux. Plain version: physics/bucket.py:
// ext_step_aux, which this matches to the bit. A tile is ty_rows bucket rows
// x gx / n_chunks buckets, all cap slots; tile t is row block t / n_chunks,
// lane chunk t % n_chunks. Out: params with omax appended (the largest live
// slot index + 1 over the grid), the tile flags (1 where the tile holds a
// live slot), order (the live tiles ascending, then the last live tile
// repeated; all zeros on an all-dead grid), sizes[0] = max(live tiles, 1),
// and each bucket's largest live slot + 1 (bucket_max, for the retire of the
// next run).
//
// What bounds it: reading ty once (67 MB on the served 1M lattice, 20 us at
// 3.35 TB/s) and writing bucket_max (4 MB). The design: one block a tile
// reduces the buckets' and the tile's largest live slot + 1 (0 = dead) with
// 16-byte loads where it can, a thread a bucket (at cap 16 and 8 every load
// of a bucket in flight before any is used), and parks the tile's in
// order[t]; then one block reads those maxima (omax is their max), and
// writes order as a stable partition of the flags, a block-wide scan of
// blockDim tiles at a time, no sort. PyTorch took ~10 launches for this
// (two reductions over ty, a cat, a stable argsort, a gather, a where).
//
// The retire, in the same pass: after a rebucket the frame steps its next
// run between the place kernel's output and the buffer the previous run
// stepped in, where no copy makes them agree. The live-tile step writes
// live slots only, so the two buffers must hold the same bytes on every slot
// that is dead in the new ty: tombstones, x = y = vx = vy = 0
// (bucket_place.cu). The old buffer holds them wherever the old ty was dead,
// so only the slots below each bucket's old bucket_max can be stale; the
// kernel writes tombstones on those that are dead in the new ty, which it
// reads anyway, and skips the tiles dead under the old aux. On the placed
// grids the frame runs, a bucket's live slots come first, so those writes
// are the slots that emptied (10,000-18,000 a run on the served lattice). Plain
// version: physics/bucket.py:tile_retire.
//
// On an NVIDIA H100 80GB HBM3 (700 W), the served 1M lattice's grid
// (1024 x 1024 x 16, 1,024 tiles): 0.032 ms a call, 0.035-0.036 with the
// retire, against 0.23 for the PyTorch aux it replaces. Timed slower there: a thread four
// slots (a warp's loads one run of 512 bytes, a bucket's maximum a butterfly
// of shuffles; 0.040 ms), a retire kernel of its own that read the new ty
// again (0.011-0.039 ms more a run), the old ty read in this pass instead of
// bucket_max (0.013-0.033 ms more), and tombstones written on every slot dead
// in the new ty below the old omax (0.164 ms once the drag had spread the
// lattice).
#include "bucket_common.cuh"

namespace {

constexpr int AUX_THREADS = 256;    // a tile's block of the reduction
constexpr int ORDER_THREADS = 1024; // the one block of the partition

template <int THREADS>
static __device__ __forceinline__ int block_max(int v, int* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < THREADS / 32 ? scratch[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // scratch is free again
  return v;
}

struct Retire {  // the buffer to retire and its old aux's; x == nullptr: none
  uint32_t *x, *y;
  float *vx, *vy;
  const int32_t* old_bucket_max;
  const int32_t* old_flags;
};

static __device__ __forceinline__ void retire_slot(const Retire& rt, long slot) {
  rt.x[slot] = 0u;
  rt.y[slot] = 0u;
  rt.vx[slot] = 0.0f;
  rt.vy[slot] = 0.0f;
}

// a bucket's largest live slot + 1, and the retire of its stale slots:
// slots dead in ty below old_max. GROUPS > 0: cap = 4 * GROUPS, every load of
// the bucket issued before any is used; else any cap, four slots a load
// where vec says the bucket starts on 16 bytes
template <int GROUPS>
static __device__ __forceinline__ int bucket_pass(const int32_t* __restrict__ ty, long slot0,
                                                  int cap, int vec, int old_max,
                                                  const Retire& rt) {
  int bm = 0;
  if (GROUPS > 0 || vec) {
    constexpr int kMax = GROUPS > 0 ? GROUPS : 1;
    const int groups = GROUPS > 0 ? GROUPS : cap / 4;
    for (int g0 = 0; g0 < groups; g0 += kMax) {
      int4 v[kMax];
#pragma unroll
      for (int g = 0; g < kMax; ++g) {
        v[g] = __ldg(reinterpret_cast<const int4*>(ty + slot0) + g0 + g);
      }
#pragma unroll
      for (int g = 0; g < kMax; ++g) {
        const int s = 4 * (g0 + g);
        if (v[g].x >= 0) bm = s + 1;
        if (v[g].y >= 0) bm = s + 2;
        if (v[g].z >= 0) bm = s + 3;
        if (v[g].w >= 0) bm = s + 4;
        if (s < old_max) {
          if (v[g].x < 0) retire_slot(rt, slot0 + s);
          if (v[g].y < 0 && s + 1 < old_max) retire_slot(rt, slot0 + s + 1);
          if (v[g].z < 0 && s + 2 < old_max) retire_slot(rt, slot0 + s + 2);
          if (v[g].w < 0 && s + 3 < old_max) retire_slot(rt, slot0 + s + 3);
        }
      }
    }
  } else {
    for (int s = 0; s < cap; ++s) {
      const int v = __ldg(ty + slot0 + s);
      if (v >= 0) bm = s + 1;
      else if (s < old_max) retire_slot(rt, slot0 + s);
    }
  }
  return bm;
}

// blockIdx.x = tile, a thread a bucket: bucket_max, tile_max[t] = the tile's
// largest live slot + 1 (0: dead), and the retire of the tile's stale slots
template <int GROUPS>
__global__ void __launch_bounds__(AUX_THREADS) tile_aux_max_kernel(
    const int32_t* __restrict__ ty, int32_t* __restrict__ flags, int32_t* __restrict__ tile_max,
    int32_t* __restrict__ bucket_max, Retire rt, int gx, int cap, int ty_rows, int n_chunks,
    int vec) {
  __shared__ int scratch[32];
  const int t = blockIdx.x;
  const int row_buckets = gx / n_chunks;
  const long bucket0 = (long)(t / n_chunks) * ty_rows * gx + (long)(t % n_chunks) * row_buckets;
  // every bucket of a tile dead under the old aux was dead in the old ty
  const bool retire = rt.x != nullptr && __ldg(rt.old_flags + t) != 0;
  int m = 0;
  for (int j = threadIdx.x; j < ty_rows * row_buckets; j += AUX_THREADS) {
    const int r = j / row_buckets;
    const long b = bucket0 + (long)r * gx + (j - r * row_buckets);
    const int old_max = retire ? min(max(__ldg(rt.old_bucket_max + b), 0), cap) : 0;
    const int bm = bucket_pass<GROUPS>(ty, b * cap, cap, vec, old_max, rt);
    bucket_max[b] = bm;
    m = max(m, bm);
  }
  m = block_max<AUX_THREADS>(m, scratch);
  if (threadIdx.x == 0) {
    flags[t] = m > 0;
    tile_max[t] = m;
  }
}

// one block: omax from the tile maxima parked in order, then order as the
// stable partition of the flags, sizes and the params with omax
__global__ void __launch_bounds__(ORDER_THREADS) tile_aux_order_kernel(
    const float* __restrict__ params, const int32_t* __restrict__ flags,
    float* __restrict__ params_out, int32_t* __restrict__ order, int32_t* __restrict__ sizes,
    int n_tiles) {
  __shared__ int scratch[32];
  __shared__ int warp_off[32];
  __shared__ int chunk_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int m = 0;
  for (int t = threadIdx.x; t < n_tiles; t += ORDER_THREADS) m = max(m, order[t]);
  const int omax = block_max<ORDER_THREADS>(m, scratch);  // every read of order is done
  int base = 0;
  for (int start = 0; start < n_tiles; start += ORDER_THREADS) {
    const int t = start + threadIdx.x;
    const bool live = t < n_tiles && flags[t] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) scratch[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the warps' counts
      const int c = lane < ORDER_THREADS / 32 ? scratch[lane] : 0;
      int incl = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      warp_off[lane] = incl - c;
      if (lane == 31) chunk_total = incl;
    }
    __syncthreads();
    if (live) order[base + warp_off[warp] + __popc(ballot & ((1u << lane) - 1u))] = t;
    base += chunk_total;
    __syncthreads();  // scratch, warp_off and chunk_total are read before the next chunk
  }
  const int last = base > 0 ? order[base - 1] : 0;  // written above, before a __syncthreads
  for (int t = base + threadIdx.x; t < n_tiles; t += ORDER_THREADS) order[t] = last;
  if (threadIdx.x < P_COUNT) params_out[threadIdx.x] = params[threadIdx.x];
  if (threadIdx.x == 0) {
    params_out[P_COUNT] = (float)omax;
    sizes[0] = max(base, 1);
  }
}

static bool tiles_fit(int gy, int gx, int cap, int ty_rows, int n_chunks) {
  return gy > 0 && gx > 0 && cap > 0 && ty_rows > 0 && n_chunks > 0 && gy % ty_rows == 0
         && gx % n_chunks == 0 && (long)gy * gx * cap < 0x7fffffffL;
}

}  // namespace

// The tile aux of one (gy, gx, cap) grid: two launches, no host sync.
// params: the SimParams vector (P_COUNT floats); params_out: P_COUNT + 1;
// flags, order: gy / ty_rows * n_chunks ints; sizes: 1 int; bucket_max: gy
// * gx ints. With x, y, vx, vy given (non-null), also tombstones there every
// slot that is dead in ty and lies below old_bucket_max in its bucket, on the
// tiles old_flags marks live (the old aux's bucket_max and flags, same tiles).
extern "C" int ps_tile_aux(const void* ty, const void* params, void* params_out, void* flags,
                           void* order, void* sizes, void* bucket_max, void* x, void* y,
                           void* vx, void* vy, const void* old_bucket_max,
                           const void* old_flags, int gy, int gx, int cap, int ty_rows,
                           int n_chunks, void* stream) {
  if (!tiles_fit(gy, gx, cap, ty_rows, n_chunks)) return (int)cudaErrorInvalidValue;
  const int n_tiles = gy / ty_rows * n_chunks;
  const Retire rt{(uint32_t*)x, (uint32_t*)y, (float*)vx, (float*)vy,
                  (const int32_t*)old_bucket_max, (const int32_t*)old_flags};
  const int vec = cap % 4 == 0 && ((uintptr_t)ty & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  // the served grids' caps, 16 and 8, with every load of a bucket in flight
  auto kernel = !vec ? tile_aux_max_kernel<0> : cap == 16 ? tile_aux_max_kernel<4>
                : cap == 8 ? tile_aux_max_kernel<2> : tile_aux_max_kernel<0>;
  kernel<<<n_tiles, AUX_THREADS, 0, s>>>(
      (const int32_t*)ty, (int32_t*)flags, (int32_t*)order, (int32_t*)bucket_max, rt, gx, cap,
      ty_rows, n_chunks, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_aux_order_kernel<<<1, ORDER_THREADS, 0, s>>>(
      (const float*)params, (const int32_t*)flags, (float*)params_out, (int32_t*)order,
      (int32_t*)sizes, n_tiles);
  return (int)cudaGetLastError();
}
