// Packed first-order statistics of a batch of intensity volumes: per case
// [count, sum x, sum x^2, hist[n_bins], lo, hi, bin_width] over the masked
// voxels, x = image where mask > 0 and 0 elsewhere.
//
// Replaces the TPU kernel repro/kernels/firstorder.py::_fo_kernel
// (firstorder_packed_batch_pallas).  It computes the same function, not
// the same way: the TPU built each chunk's histogram as a one-hot matrix
// summed on its vector unit and carried one accumulator across its
// sequential grid.  Blocks on the H100 run in no order and nothing
// carries over between them, so the work is split in two passes:
//
//   1. fo_partials_kernel, grid (ceil(chunks / chunks_per_block), batch),
//      512 threads: for each canonical 1024-voxel chunk it owns, a block
//      quantises in place, counts the histogram with shared-memory int
//      atomics and the masked voxels with __syncthreads_count (integers:
//      exact in any order), and sums x and x^2 by the canonical pairwise
//      tree: thread t adds [t] + [t + 512], then for s = 256 ... 1 [t] +
//      [t + s].  It writes the chunk's (3 + n_bins) partial row.
//   2. fo_fold_kernel, one block per case, one thread per column:
//      left-folds the partial rows in chunk order from zeros and appends
//      [lo, hi, bin_width].
//
// That is the plain version's arithmetic step for step
// (kernels/firstorder.py firstorder_packed_batch_ref), with every product
// and sum an explicitly rounded intrinsic, so the two agree bitwise.  A
// chunk past the volume's end would add exact zeros, so the result does
// not depend on chunks_per_block.
//
// Bound on the H100: device memory.  The function needs the mask at every
// voxel and the image at the masked ones, each once (the kernel reads the
// image under the mask only); the partial rows, written and read once,
// are this design's own traffic.  At 512 threads per 1024 voxels a block
// issues 8 bytes a thread per pass, coalesced; the reduction tree and the
// folds are the overhead a later pass could shave (warp shuffles, a wider
// fold).

#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

constexpr int kChunk = 1024;
constexpr int kThreads = kChunk / 2;
constexpr int kMaxBins = 64;

__global__ void __launch_bounds__(kThreads)
    fo_partials_kernel(const float* __restrict__ image, const float* __restrict__ mask,
                       const float* __restrict__ lo_, const float* __restrict__ hi_,
                       long long voxels, int chunks, int n_bins, int chunks_per_block,
                       float* __restrict__ partials) {
  __shared__ float s1[kThreads], s2[kThreads];
  __shared__ int hist[kMaxBins];
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const float lo = lo_[b];
  const float safe = safe_width(lo, hi_[b], n_bins);
  const float* im = image + (size_t)b * voxels;
  const float* mk = mask + (size_t)b * voxels;
  const int width = 3 + n_bins;

  for (int j = 0; j < chunks_per_block; ++j) {
    const long long c = (long long)blockIdx.x * chunks_per_block + j;
    if (c >= chunks) break;  // the same for every thread: the barriers stay safe
    if (t < n_bins) hist[t] = 0;
    __syncthreads();  // the histogram is clear
    const long long i0 = c * kChunk + t, i1 = i0 + kThreads;
    const bool m0 = i0 < voxels && mk[i0] > 0.0f;
    const bool m1 = i1 < voxels && mk[i1] > 0.0f;
    const float x0 = m0 ? im[i0] : 0.0f;
    const float x1 = m1 ? im[i1] : 0.0f;
    if (m0) atomicAdd(&hist[quantize(x0, lo, safe, n_bins)], 1);
    if (m1) atomicAdd(&hist[quantize(x1, lo, safe, n_bins)], 1);
    const int count = __syncthreads_count(m0) + __syncthreads_count(m1);
    s1[t] = __fadd_rn(x0, x1);
    s2[t] = __fadd_rn(__fmul_rn(x0, x0), __fmul_rn(x1, x1));
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (t < s) {
        s1[t] = __fadd_rn(s1[t], s1[t + s]);
        s2[t] = __fadd_rn(s2[t], s2[t + s]);
      }
      __syncthreads();
    }
    float* row = partials + ((size_t)b * chunks + c) * width;
    if (t == 0) {
      row[0] = (float)count;
      row[1] = s1[0];
      row[2] = s2[0];
    }
    if (t < n_bins) row[3 + t] = (float)hist[t];
    __syncthreads();  // every read of s1, s2 and hist is done before the next chunk
  }
}

__global__ void fo_fold_kernel(const float* __restrict__ partials,
                               const float* __restrict__ lo_, const float* __restrict__ hi_,
                               int chunks, int n_bins, float* __restrict__ out) {
  const int b = blockIdx.x, col = threadIdx.x;
  const int width = 3 + n_bins;
  float* o = out + (size_t)b * (width + 3);
  if (col < width) {
    const float* p = partials + (size_t)b * chunks * width + col;
    float acc = 0.0f;
#pragma unroll 16
    for (int c = 0; c < chunks; ++c) acc = __fadd_rn(acc, p[(size_t)c * width]);
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
// (batch,) float32 masked ranges.  partials: (batch, ceil(voxels / 1024),
// 3 + n_bins) float32 scratch; out: (batch, 6 + n_bins) float32.  n_bins in
// [1, 64]; chunks_per_block >= 1.  Launches both passes on `stream`, does
// not wait.
int firstorder_packed_launch(const float* image, const float* mask, const float* lo,
                             const float* hi, int batch, long long voxels, int n_bins,
                             int chunks_per_block, float* partials, float* out, void* stream) {
  const int chunks = (int)((voxels + kChunk - 1) / kChunk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((chunks + chunks_per_block - 1) / chunks_per_block, batch);
  fo_partials_kernel<<<grid, kThreads, 0, s>>>(image, mask, lo, hi, voxels, chunks, n_bins,
                                              chunks_per_block, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int fold_threads = ((6 + n_bins) + 31) / 32 * 32;
  fo_fold_kernel<<<batch, fold_threads, 0, s>>>(partials, lo, hi, chunks, n_bins, out);
  return cudaGetLastError();
}

}  // extern "C"
