// Packed first-order statistics of a batch of intensity volumes: per case
// [count, sum x, sum x^2, hist[n_bins], lo, hi, bin_width] over the masked
// voxels, x = image where mask > 0 and 0 elsewhere.
//
// Replaces the TPU kernel repro/kernels/firstorder.py::_fo_kernel
// (firstorder_packed_batch_pallas).  It computes the same function, not
// the same way: the TPU built each chunk's histogram as a one-hot matrix
// summed on its vector unit and carried one accumulator across its
// sequential grid.  Blocks on the H100 run in no order and nothing
// carries over between them, so the work is split in two passes over the
// canonical 1024-voxel chunks (kernels/firstorder.py):
//
//   1. fo_partials_kernel, grid (ceil(chunks / chunks_per_block), batch):
//      one warp a chunk, min(chunks_per_block, 8) warps a block, each warp
//      walking its block's chunks in turn.  Lane l holds voxels
//      4l..4l+3 + 128r, r = 0..7, read as 16-byte loads of the mask and,
//      where one of the four is masked, of the image.  The chunk's
//      halving tree y[:h] + y[h:] then maps onto the warp exactly: levels
//      h = 512, 256, 128 add registers in-lane (r with r + h/128), levels
//      h = 64 ... 4 add the lane h/4 above by __shfl_down_sync, and h = 2,
//      1 add in-lane again in lane 0.  No shared memory, no barrier.  The
//      count is __reduce_add_sync of the lanes' counts, the histogram
//      warp-private shared-memory int counters (integer atomics: exact in
//      any order).  The warp writes the chunk's (3 + n_bins) partial row.
//   2. fo_fold_kernel, one block per case: the left fold of the partial
//      rows in chunk order from zeros is one FADD per chunk per column, a
//      dependent chain that no reordering may shorten.  The block stages
//      the rows through shared memory in coalesced tiles of kFoldTile rows
//      (cp.async, double-buffered), so each column's thread folds from
//      shared memory at the FADD chain's pace, the loads of a tile
//      unrolled ahead of its adds, rather than at one device-memory
//      latency a row.  Every column is folded as float,
//      count and histogram included: above 2^24 masked voxels a float fold
//      of integer counts rounds, and the plain version's and the
//      reference's bits round the same way.  Then [lo, hi, bin_width].
//
// That is the plain version's arithmetic step for step
// (kernels/firstorder.py firstorder_packed_batch_ref), with every product
// and sum an explicitly rounded intrinsic, so the two agree bitwise.  A
// chunk past the volume's end would add exact zeros, and which warp or
// block sums a chunk changes no bit, so the result does not depend on
// chunks_per_block.
//
// Bound on the H100: device memory.  The function needs the mask at every
// voxel and the image at the masked ones, each once; the partial rows,
// written and read once, are this design's own traffic (35 floats a 1024-
// voxel chunk at 32 bins, under 1% of the mask).  The fold's chain of
// chunks x 4 cycles is the floor of the second pass: ~10 us at 4,800
// chunks, longer than the first pass's bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "quantize.cuh"

namespace {

constexpr int kChunk = 1024;
constexpr int kRows = kChunk / 128;  // 16-byte loads a lane per chunk
constexpr int kMaxWarps = 8;
constexpr int kMaxBins = 64;
constexpr int kFoldThreads = 256;
constexpr int kFoldTile = 256;  // chunk rows per shared-memory stage
constexpr int kFoldStages = 2;
constexpr int kFoldBatch = 32;  // rows a fold thread holds in registers ahead
constexpr unsigned kFull = 0xffffffffu;

// Four consecutive voxels of a case from i on; zeros past `voxels`.
__device__ __forceinline__ float4 load4(const float* __restrict__ p, long long i,
                                        long long voxels, bool vec) {
  if (vec && i + 3 < voxels) return __ldg(reinterpret_cast<const float4*>(p + i));
  float4 v;
  v.x = i < voxels ? __ldg(p + i) : 0.0f;
  v.y = i + 1 < voxels ? __ldg(p + i + 1) : 0.0f;
  v.z = i + 2 < voxels ? __ldg(p + i + 2) : 0.0f;
  v.w = i + 3 < voxels ? __ldg(p + i + 3) : 0.0f;
  return v;
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    fo_partials_kernel(const float* __restrict__ image, const float* __restrict__ mask,
                       const float* __restrict__ lo_, const float* __restrict__ hi_,
                       long long voxels, int chunks, int n_bins, int chunks_per_block,
                       float* __restrict__ partials) {
  __shared__ int hist_all[kMaxWarps][kMaxBins];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int b = blockIdx.y;
  const float lo = lo_[b];
  const float safe = safe_width(lo, hi_[b], n_bins);
  const float* im = image + (size_t)b * voxels;
  const float* mk = mask + (size_t)b * voxels;
  const bool vec = ((reinterpret_cast<uintptr_t>(im) | reinterpret_cast<uintptr_t>(mk)) & 15) == 0;
  const int width = 3 + n_bins;
  int* hist = hist_all[warp];
  for (int k = lane; k < n_bins; k += 32) hist[k] = 0;
  __syncwarp();

  const long long first = (long long)blockIdx.x * chunks_per_block;
  const long long end = min(first + chunks_per_block, (long long)chunks);
  for (long long c = first + warp; c < end; c += warps) {
    float x[kRows][4], q[kRows][4];
    int count = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = c * kChunk + 128 * r + 4 * lane;
      const float4 m4 = load4(mk, i, voxels, vec);
      const bool in[4] = {m4.x > 0.0f, m4.y > 0.0f, m4.z > 0.0f, m4.w > 0.0f};
      float4 v4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in[0] || in[1] || in[2] || in[3]) v4 = load4(im, i, voxels, vec);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[r][j] = in[j] ? v[j] : 0.0f;
        q[r][j] = __fmul_rn(x[r][j], x[r][j]);
        if (in[j]) {
          ++count;
          atomicAdd(&hist[quantize(v[j], lo, safe, n_bins)], 1);
        }
      }
    }
    // the canonical tree: h = 512, 256, 128 in-lane ...
#pragma unroll
    for (int h = kRows / 2; h >= 1; h >>= 1) {
#pragma unroll
      for (int r = 0; r < h; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[r][j] = __fadd_rn(x[r][j], x[r + h][j]);
          q[r][j] = __fadd_rn(q[r][j], q[r + h][j]);
        }
      }
    }
    // ... h = 64 ... 4 across lanes (h / 4 apart) ...
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[0][j] = __fadd_rn(x[0][j], __shfl_down_sync(kFull, x[0][j], off));
        q[0][j] = __fadd_rn(q[0][j], __shfl_down_sync(kFull, q[0][j], off));
      }
    }
    // ... and h = 2, 1 in lane 0
    const float s1 = __fadd_rn(__fadd_rn(x[0][0], x[0][2]), __fadd_rn(x[0][1], x[0][3]));
    const float s2 = __fadd_rn(__fadd_rn(q[0][0], q[0][2]), __fadd_rn(q[0][1], q[0][3]));
    count = __reduce_add_sync(kFull, count);
    __syncwarp();  // every histogram atomic of the chunk is done
    float* row = partials + ((size_t)b * chunks + c) * width;
    if (lane == 0) {
      row[0] = (float)count;
      row[1] = s1;
      row[2] = s2;
    }
    for (int k = lane; k < n_bins; k += 32) {
      row[3 + k] = (float)hist[k];
      hist[k] = 0;
    }
    __syncwarp();  // the counters are clear before the next chunk
  }
}

// A 16-byte copy into shared memory; zeros where !ok (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies the rows of tile t (kFoldTile chunk rows) into stage buffer
// t % kFoldStages, all threads, 16 bytes each, coalesced; rows past the
// last chunk are zeros.  The fold adds them: acc is never -0 (it starts at
// +0, and a sum is -0 only of two -0s), so acc + 0 is acc, bit for bit.
// chunks is a multiple of 4, so every tile starts 16-byte aligned.
__device__ __forceinline__ void stage_tile(float* stage, const float* __restrict__ p, int t,
                                           int chunks, int width) {
  if ((long long)t * kFoldTile >= chunks) return;
  const int n4 = min(kFoldTile, chunks - t * kFoldTile) * width / 4;
  float* dst = stage + (size_t)(t % kFoldStages) * kFoldTile * width;
  const float* src = p + (size_t)t * kFoldTile * width;
  for (int q = threadIdx.x; q < kFoldTile * width / 4; q += blockDim.x)
    cp_async16(dst + 4 * q, q < n4 ? src + 4 * q : p, q < n4);
}

__global__ void __launch_bounds__(kFoldThreads)
    fo_fold_kernel(const float* __restrict__ partials, const float* __restrict__ lo_,
                   const float* __restrict__ hi_, int chunks, int n_bins,
                   float* __restrict__ out) {
  extern __shared__ float stage[];  // kFoldStages x kFoldTile x width
  const int b = blockIdx.x, col = threadIdx.x;
  const int width = 3 + n_bins;
  const float* p = partials + (size_t)b * chunks * width;
  const int tiles = (chunks + kFoldTile - 1) / kFoldTile;
#pragma unroll
  for (int s = 0; s < kFoldStages - 1; ++s) {
    stage_tile(stage, p, s, chunks, width);
    cp_async_commit();
  }
  float acc = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    stage_tile(stage, p, t + kFoldStages - 1, chunks, width);
    cp_async_commit();  // possibly empty: one group per tile keeps the count
    cp_async_wait<kFoldStages - 1>();  // this thread's copies of tile t landed
    __syncthreads();                   // and every thread's
    if (col < width) {
      // a fixed trip count, fully unrolled, each batch of rows loaded
      // while the one before it is added: the chain waits on no load
      const float* s = stage + (size_t)(t % kFoldStages) * kFoldTile * width + col;
      float cur[kFoldBatch];
#pragma unroll
      for (int r = 0; r < kFoldBatch; ++r) cur[r] = s[r * width];
#pragma unroll
      for (int r0 = kFoldBatch; r0 <= kFoldTile; r0 += kFoldBatch) {
        float nxt[kFoldBatch];
#pragma unroll
        for (int r = 0; r < kFoldBatch; ++r)
          nxt[r] = r0 < kFoldTile ? s[(r0 + r) * width] : 0.0f;
#pragma unroll
        for (int r = 0; r < kFoldBatch; ++r) acc = __fadd_rn(acc, cur[r]);
#pragma unroll
        for (int r = 0; r < kFoldBatch; ++r) cur[r] = nxt[r];
      }
    }
    __syncthreads();  // tile t's buffer is free before it is staged again
  }
  float* o = out + (size_t)b * (width + 3);
  if (col < width) {
    o[col] = acc;
  } else if (col == width) {
    o[col] = lo_[b];
  } else if (col == width + 1) {
    o[col] = hi_[b];
  } else if (col == width + 2) {
    o[col] = bin_width(lo_[b], hi_[b], n_bins);
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// image, mask: (batch, voxels) float32, C order on the device; lo, hi:
// (batch,) float32 masked ranges.  partials: (batch, chunks, 3 + n_bins)
// float32 scratch, chunks = ceil(voxels / 1024) rounded up to a multiple
// of 4 (the rows past the volume are exact zeros); out: (batch, 6 +
// n_bins) float32.  n_bins in [1, 64]; chunks_per_block >= 1.  Launches
// both passes on `stream`, does not wait.
int firstorder_packed_launch(const float* image, const float* mask, const float* lo,
                             const float* hi, int batch, long long voxels, int n_bins,
                             int chunks_per_block, float* partials, float* out, void* stream) {
  const int chunks = (int)((voxels + kChunk - 1) / kChunk + 3) / 4 * 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((chunks + chunks_per_block - 1) / chunks_per_block, batch);
  const int threads = 32 * (chunks_per_block < kMaxWarps ? chunks_per_block : kMaxWarps);
  fo_partials_kernel<<<grid, threads, 0, s>>>(image, mask, lo, hi, voxels, chunks, n_bins,
                                             chunks_per_block, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = kFoldStages * kFoldTile * (3 + n_bins) * (int)sizeof(float);
  err = cudaFuncSetAttribute(fo_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fo_fold_kernel<<<batch, kFoldThreads, smem, s>>>(partials, lo, hi, chunks, n_bins, out);
  return cudaGetLastError();
}

}  // extern "C"
