// Stable segmented compaction of a batch of vertex lists: for each case b,
// the vertices whose keep flag is set land in order in slots 0..n-1 of a
// cap-slot output, slots from min(n, cap) on hold zeros and a False mask,
// survivors past cap are dropped, and n counts every survivor.
//
// Replaces the TPU kernel repro/kernels/compact.py::_compact_kernel
// (compact_batch_pallas).  It computes the same function, not the same
// way: the TPU scattered each block's survivors with a one-hot matmul on
// its matrix unit (no per-element dynamic stores there) and carried the
// running offset in SMEM across a case's sequential grid steps.  Here a
// store to any address is cheap, so each survivor is written straight to
// its slot, and the running offset becomes a sum over tiles.
//
// Bound on the H100: device memory in principle (each flag read once, a
// vertex only where it survives below cap, each output slot written
// once), but at the pipeline's sizes (a few hundred KB a launch) the
// floor is launch latency.  One block per case walking its list in order
// used 5 of 132 SMs at the largest launch and paid two barriers a chunk.
// So each case is split into tiles of `tile` flags, one block a tile, on a
// grid of tiles x batch blocks, in two launches with no waiting between
// blocks:
//
//   1. compact_count_kernel: each thread reads 16 flags as one 16-byte
//      vector and counts them; the block writes its tile's count into a
//      (batch, tiles) int32 scratch.
//   2. compact_scatter_kernel, the same grid: each block sums the counts
//      of its case's earlier tiles (its base) and of all of them (n); a
//      thread ranks its 16 flags by a warp scan of the per-thread counts
//      and one shared scan of the warp counts (one barrier) and writes
//      each survivor below cap straight to its slot with that slot's
//      mask.  Block t writes the t-th of T even shares of the pad slots
//      [min(n, cap), cap); block 0 writes n.
//
// Every output slot is written by exactly one block (tests/
// test_torch_tile_models.py holds a numpy model of this to the reference).
// The output is an exact copy of input bits, so the kernel equals the
// plain version (kernels/ref.py compact_batch) bitwise at every tile.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kFlagsPerThread = 16;
constexpr unsigned kFull = 0xffffffffu;

// Bit j set where flag i0 + j (< m) is non-zero: one 16-byte load where the
// 16 flags lie whole and aligned, else byte loads.
__device__ __forceinline__ unsigned load_flags(const unsigned char* __restrict__ k, int i0,
                                               int m) {
  unsigned bits = 0;
  if (i0 + kFlagsPerThread <= m && (reinterpret_cast<uintptr_t>(k + i0) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(k + i0);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned nz = __vcmpne4(w[q], 0u);  // 0xff in each non-zero byte
#pragma unroll
      for (int j = 0; j < 4; ++j) bits |= ((nz >> (8 * j)) & 1u) << (4 * q + j);
    }
  } else {
    for (int j = 0; j < kFlagsPerThread && i0 + j < m; ++j)
      bits |= (unsigned)(k[i0 + j] != 0) << j;
  }
  return bits;
}

__global__ void __launch_bounds__(1024)
    compact_count_kernel(const unsigned char* __restrict__ keep, int m, int tile, int tiles,
                         int* __restrict__ counts) {
  __shared__ int warp_counts[32];
  const int b = blockIdx.x / tiles, t = blockIdx.x - b * tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int i0 = t * tile + kFlagsPerThread * threadIdx.x;
  const int c = __reduce_add_sync(kFull, __popc(load_flags(keep + (size_t)b * m, i0, m)));
  if (lane == 0) warp_counts[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < nwarps; ++w) s += warp_counts[w];
    counts[(size_t)b * tiles + t] = s;
  }
}

__global__ void __launch_bounds__(1024)
    compact_scatter_kernel(const float* __restrict__ verts, const unsigned char* __restrict__ keep,
                           const int* __restrict__ counts, int m, int cap, int tile, int tiles,
                           float* __restrict__ out, unsigned char* __restrict__ out_mask,
                           int* __restrict__ count) {
  __shared__ int s_below[32], s_total[32], s_warp[32];
  const int b = blockIdx.x / tiles, t = blockIdx.x - b * tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  // this thread's flags (their load in flight beside the counts' loads)
  const int i0 = t * tile + kFlagsPerThread * threadIdx.x;
  unsigned flags = load_flags(keep + (size_t)b * m, i0, m);

  // the case's survivors in tiles before this one, and in all of them
  const int* cnt = counts + (size_t)b * tiles;
  int below = 0, total = 0;
  for (int j = threadIdx.x; j < tiles; j += blockDim.x) {
    const int v = cnt[j];
    total += v;
    below += j < t ? v : 0;
  }
  below = __reduce_add_sync(kFull, below);
  total = __reduce_add_sync(kFull, total);

  // the flags' rank in the warp (inclusive scan of the per-thread counts)
  const int mine = __popc(flags);
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 0) {
    s_below[warp] = below;
    s_total[warp] = total;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();  // the warps' sums and counts are in
  int base = 0, n = 0;
  for (int w = 0; w < nwarps; ++w) {
    base += s_below[w] + (w < warp ? s_warp[w] : 0);
    n += s_total[w];
  }

  // each survivor below cap to its slot, in order
  const float* v = verts + (size_t)b * m * 3;
  float* o = out + (size_t)b * cap * 3;
  unsigned char* om = out_mask + (size_t)b * cap;
  for (int slot = base + incl - mine; flags && slot < cap; ++slot) {
    const int i = i0 + __ffs(flags) - 1;
    flags &= flags - 1;
    o[3 * (size_t)slot] = v[3 * (size_t)i];
    o[3 * (size_t)slot + 1] = v[3 * (size_t)i + 1];
    o[3 * (size_t)slot + 2] = v[3 * (size_t)i + 2];
    om[slot] = 1;
  }

  // this block's share of the pad slots [min(n, cap), cap)
  const int filled = n < cap ? n : cap;
  const int share = (cap - filled + tiles - 1) / tiles;
  const int s0 = filled + t * share;
  const int s1 = min(s0 + share, cap);
  for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
    o[3 * (size_t)s] = 0.0f;
    o[3 * (size_t)s + 1] = 0.0f;
    o[3 * (size_t)s + 2] = 0.0f;
    om[s] = 0;
  }
  if (t == 0 && threadIdx.x == 0) count[b] = n;
}

__global__ void compact_empty_kernel() {}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// verts: (batch, m, 3) float32, keep: (batch, m) bool (one byte each), both
// C order on the device.  out: (batch, cap, 3) float32, out_mask: (batch,
// cap) bool, count: (batch,) int32, tile_counts: (batch, tiles) int32
// scratch with tiles = max(1, ceil(m / tile)), batch x tiles < 2^31.
// tile: a multiple of 512 up to 16384 (tile / 16 threads a block).
// Launches both passes on `stream`, does not wait.
int compact_batch_launch(const float* verts, const unsigned char* keep, int batch, int m,
                         int cap, float* out, unsigned char* out_mask, int* count,
                         int* tile_counts, int tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = m > 0 ? (m + tile - 1) / tile : 1;
  const int threads = tile / kFlagsPerThread;
  compact_count_kernel<<<tiles * batch, threads, 0, s>>>(keep, m, tile, tiles, tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  compact_scatter_kernel<<<tiles * batch, threads, 0, s>>>(verts, keep, tile_counts, m, cap, tile,
                                                           tiles, out, out_mask, count);
  return cudaGetLastError();
}

// One launch of an empty kernel on the grid compact_batch_launch uses: its
// device time, twice, is the floor of the two passes.
int compact_floor_launch(int batch, int m, int tile, void* stream) {
  const int blocks = (m > 0 ? (m + tile - 1) / tile : 1) * batch;
  compact_empty_kernel<<<blocks, tile / kFlagsPerThread, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

}  // extern "C"
