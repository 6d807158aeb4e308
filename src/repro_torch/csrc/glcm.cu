// Symmetrised gray-level co-occurrence counts of a batch of intensity
// volumes: for each case, g[q(v), q(v + o)] counts the voxels v and
// neighbours v + o, o in {+X, +Y, +Z} of the (X, Y, Z) volume, that are
// both in the mask; the output is g + g^T as float32.
//
// Replaces the TPU kernel repro/kernels/glcm.py::_glcm_kernel
// (glcm_matrix_batch_pallas).  It computes the same function, not the same
// way: the TPU had no cheap scatter, so it flattened every (voxel,
// neighbour) pair into concatenated pair arrays and scattered them with a
// one-hot matrix product on its matrix unit, accumulating across its
// sequential grid.  On the H100 a shared-memory integer atomic is the
// scatter, and nothing is flattened:
//
//   1. glcm_counts_kernel, grid (ceil(voxels / tile), batch), 256 threads:
//      each thread takes voxels of the block's tile in turn; where the
//      voxel is in the mask, it quantises it and each in-bounds, in-mask
//      neighbour in place (quantize.cuh, the plain version's operations)
//      and adds 1 to a shared int32 n_bins x n_bins histogram.  The block
//      then adds its non-zero bins to the case's global int32 counts.
//   2. glcm_symmetrise_kernel, one block per case: g + g^T as float32.
//
// Integer additions are exact in any order, so the counts, and the result,
// are the same on every run and for every tile.  A symmetrised count is at
// most twice the case's pairs, at most 3 per masked voxel, so it stays
// below 2^24, and the float32 is exact, for fewer than 2^24 / 6
// (2,796,202) masked voxels per case; the reference's float32 counts hold
// to the same 2^24.  Above it the cast rounds once, where the reference
// rounds at every step, and the two may differ; the wrapper keeps 6 x the
// voxels below 2^31, so the int32 counts never overflow.  The plain
// version (kernels/glcm.py glcm_matrix_batch_ref) counts the same pairs
// with a bincount and rounds once too: the two agree exactly.
//
// Bound on the H100: device memory, the mask at every voxel and the image
// at the masked ones, each once (the neighbours' reads hit the same lines,
// in L1 or L2).  What the simple design pays for: shared atomics that
// collide on the few bins of a narrow CT histogram's diagonal, and one
// flush of the whole histogram per block.  Warp-private histograms would
// cut the first.

#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    glcm_counts_kernel(const float* __restrict__ image, const float* __restrict__ mask,
                       const float* __restrict__ lo_, const float* __restrict__ hi_, int nx,
                       int ny, int nz, int n_bins, int tile, int* __restrict__ counts) {
  extern __shared__ int hist[];  // n_bins * n_bins
  const int nb2 = n_bins * n_bins;
  for (int k = threadIdx.x; k < nb2; k += blockDim.x) hist[k] = 0;
  __syncthreads();  // the histogram is clear

  const int b = blockIdx.y;
  const int voxels = nx * ny * nz;
  const int sx = ny * nz, sy = nz;  // strides of +X and +Y; +Z is 1
  const float lo = lo_[b];
  const float safe = safe_width(lo, hi_[b], n_bins);
  const float* im = image + (size_t)b * voxels;
  const float* mk = mask + (size_t)b * voxels;
  const int start = blockIdx.x * tile;
  const int end = min(start + tile, voxels);
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    if (!(mk[i] > 0.0f)) continue;
    const int z = i % nz, y = (i / nz) % ny, x = i / sx;
    const int row = quantize(im[i], lo, safe, n_bins) * n_bins;
    if (x + 1 < nx && mk[i + sx] > 0.0f)
      atomicAdd(&hist[row + quantize(im[i + sx], lo, safe, n_bins)], 1);
    if (y + 1 < ny && mk[i + sy] > 0.0f)
      atomicAdd(&hist[row + quantize(im[i + sy], lo, safe, n_bins)], 1);
    if (z + 1 < nz && mk[i + 1] > 0.0f)
      atomicAdd(&hist[row + quantize(im[i + 1], lo, safe, n_bins)], 1);
  }
  __syncthreads();  // every count of the tile is in

  int* g = counts + (size_t)b * nb2;
  for (int k = threadIdx.x; k < nb2; k += blockDim.x) {
    const int c = hist[k];
    if (c) atomicAdd(&g[k], c);
  }
}

__global__ void glcm_symmetrise_kernel(const int* __restrict__ counts, int n_bins,
                                       float* __restrict__ out) {
  const int nb2 = n_bins * n_bins;
  const int* g = counts + (size_t)blockIdx.x * nb2;
  float* o = out + (size_t)blockIdx.x * nb2;
  for (int k = threadIdx.x; k < nb2; k += blockDim.x) {
    const int i = k / n_bins, j = k % n_bins;
    o[k] = (float)(g[i * n_bins + j] + g[j * n_bins + i]);
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// image, mask: (batch, nx, ny, nz) float32, C order on the device, fewer
// than 2^31 voxels per case; lo, hi: (batch,) float32 masked ranges.
// counts: (batch, n_bins, n_bins) int32 scratch, zeroed by the caller;
// out: (batch, n_bins, n_bins) float32.  n_bins in [1, 64]; tile a
// positive multiple of 256.  Launches both passes on `stream`, does not
// wait.
int glcm_matrix_launch(const float* image, const float* mask, const float* lo,
                       const float* hi, int batch, int nx, int ny, int nz, int n_bins,
                       int tile, int* counts, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long voxels = (long long)nx * ny * nz;
  const dim3 grid((unsigned)((voxels + tile - 1) / tile), batch);
  const size_t shared = sizeof(int) * n_bins * n_bins;
  glcm_counts_kernel<<<grid, kThreads, shared, s>>>(image, mask, lo, hi, nx, ny, nz, n_bins,
                                                    tile, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  glcm_symmetrise_kernel<<<batch, kThreads, 0, s>>>(counts, n_bins, out);
  return cudaGetLastError();
}

}  // extern "C"
