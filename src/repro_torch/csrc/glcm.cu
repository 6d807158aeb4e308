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
// scatter, and nothing is flattened.
//
// Bound on the H100: device memory, the mask at every voxel and the image
// at the masked ones, each once.  The first design (one thread a voxel)
// paid instead for instructions: three integer divisions a voxel, each
// masked voxel quantised up to four times (as itself and as the neighbour
// of three others, each an IEEE division), a global-atomic flush from
// thousands of blocks, a memset and a separate symmetrise launch.  This
// design:
//
//   1. glcm_tile_kernel, one block a tile of one case: the tile is d
//      x-planes by ry y-rows by rz z-columns (the wrapper's glcm.tiling:
//      a few blocks an SM over the whole launch, the tile with its halo
//      within kTileBytes of shared memory).  The block walks the tile's
//      planes and loads each plane's rows along z, contiguous in memory,
//      as 16-byte vectors where the rows are whole and aligned, four loads
//      in flight a thread (the mask's, then the image's under it); each
//      masked voxel is quantised once (quantize.cuh) into an int8 bin in
//      shared memory, -1 outside the mask.  The tile's planes all stay in
//      shared memory, so one barrier separates loading from counting.  A
//      pair belongs to the tile of its lower voxel, so a tile also loads
//      the plane, row and column past its end (the halo) and counts each
//      pair once.  Counting reads the bins from shared memory, +X, +Y and
//      +Z of every voxel the tile owns, a warp a row, with no per-voxel
//      division (plane, row and column come from the loops), into one
//      int32 histogram in shared memory.  The block writes it, symmetrised
//      (rows of an odd stride: a row and a column fall in distinct banks),
//      as one row of a (batch, tiles, n_bins^2) int32 partial buffer: no
//      global atomic, no memset.
//   2. glcm_sum_kernel: per case and bin, the sum over its tiles' rows, as
//      float32.
//
// What the card showed (experiments/torch_glcm_probe.py, PERF.md): the
// launch is about one wave, so its time is its heaviest tiles': a tile
// under the mask loads its image too and counts three pairs a voxel, a
// tile outside loads only its mask.  The counting is bound by the number
// of its shared atomics (ATOMS.POPC.INC), not by their addresses: one
// pair a voxel instead of three saves a sixth of the kernel, every lane
// on a bin of its own almost nothing.  So histogram copies, a lane a copy
// and each a bank apart, gained nothing and cost their clearing and
// merging; there is one.
//
// Integer additions are exact in any order, so the counts, and the result,
// are the same on every run and for every tiling.  A symmetrised count is
// at most twice the case's pairs, at most 3 per masked voxel, so it stays
// below 2^24, and the float32 is exact, for fewer than 2^24 / 6
// (2,796,202) masked voxels per case; the reference's float32 counts hold
// to the same 2^24.  Above it the cast rounds once, where the reference
// rounds at every step, and the two may differ; the wrapper keeps 6 x the
// voxels below 2^31, so the int32 counts never overflow.  The plain
// version (kernels/glcm.py glcm_matrix_batch_ref) counts the same pairs
// with a bincount and rounds once too: the two agree exactly.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 16384;  // a tile's int8 bins, halo included (glcm.TILE_BYTES)
constexpr int kSumThreads = 1024;

// The histogram's row stride in shared memory: odd, so that a row (the
// write's reads of g) and a column (its reads of g^T) both fall in
// distinct banks.
__host__ __device__ inline int hist_row(int n_bins) { return n_bins | 1; }

struct Tiling {
  int nx, ny, nz;  // the volume
  int d, ry, rz;   // a tile's planes, rows and columns (its halo aside)
  int ty, tz;      // tiles along y and z
};

// The bin of a voxel: -1 outside the mask.
__device__ __forceinline__ signed char bin_of(float m, float v, float lo, float safe, int nb) {
  return m > 0.0f ? (signed char)quantize(v, lo, safe, nb) : (signed char)-1;
}

__device__ __forceinline__ bool any_in(float m) { return m > 0.0f; }
__device__ __forceinline__ bool any_in(float4 m) {
  return m.x > 0.0f || m.y > 0.0f || m.z > 0.0f || m.w > 0.0f;
}
__device__ __forceinline__ void put(signed char* out, int e, float m, float v, float lo,
                                    float safe, int nb) {
  out[e] = bin_of(m, v, lo, safe, nb);
}
__device__ __forceinline__ void put(signed char* out, int e, float4 m, float4 v, float lo,
                                    float safe, int nb) {
  char4 q;
  q.x = bin_of(m.x, v.x, lo, safe, nb);
  q.y = bin_of(m.y, v.y, lo, safe, nb);
  q.z = bin_of(m.z, v.z, lo, safe, nb);
  q.w = bin_of(m.w, v.w, lo, safe, nb);
  reinterpret_cast<char4*>(out)[e] = q;
}

// Quantises a tile whose planes are each one contiguous span of `per` units
// (V = float4: 4 voxels, 16-byte loads; V = float: one voxel) into `bins`,
// plane p's units at p * per.  Unit e of plane p is at first + p *
// plane_stride + e in memory, in V units.  Each thread takes units tid,
// tid + kThreads, ... of the tile, kBatch at a time: the batch's mask loads
// first, then the image under the masked ones, so each batch costs two
// round trips to memory.  Plane and unit advance by steps, no division.
template <typename V>
__device__ __forceinline__ void quantise_spans(const V* __restrict__ mk,
                                               const V* __restrict__ im, size_t first,
                                               size_t plane_stride, int planes, int per,
                                               float lo, float safe, int nb, signed char* bins) {
  constexpr int kBatch = 4;
  int p = 0, e = threadIdx.x;
  while (e >= per && p < planes) e -= per, ++p;
  while (p < planes) {
    V m[kBatch], v[kBatch];
    int pp[kBatch], ee[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      pp[k] = p;
      ee[k] = e;
      if (p < planes) {
        m[k] = mk[first + p * plane_stride + e];
        e += kThreads;
        while (e >= per && p < planes) e -= per, ++p;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      v[k] = V{};
      if (pp[k] < planes && any_in(m[k])) v[k] = im[first + pp[k] * plane_stride + ee[k]];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (pp[k] < planes) put(bins + (size_t)pp[k] * per * (sizeof(V) / 4), ee[k], m[k], v[k],
                              lo, safe, nb);
  }
}

__global__ void __launch_bounds__(kThreads)
    glcm_tile_kernel(const float* __restrict__ image, const float* __restrict__ mask,
                     const float* __restrict__ lo_, const float* __restrict__ hi_, Tiling t,
                     int tiles, int n_bins, int* __restrict__ partials) {
  extern __shared__ int smem[];
  const int nb2 = n_bins * n_bins, hrow = hist_row(n_bins);
  int* hist = smem;  // n_bins rows of hrow
  signed char* bins = reinterpret_cast<signed char*>(smem + n_bins * hrow);
  for (int k = threadIdx.x; k < n_bins * hrow; k += kThreads) hist[k] = 0;

  // this block's tile: owned planes, rows, columns, and those with the halo
  const int b = blockIdx.x / tiles, g = blockIdx.x - b * tiles;
  const int gz = g % t.tz, gy = (g / t.tz) % t.ty, gx = g / (t.tz * t.ty);
  const int x0 = gx * t.d, y0 = gy * t.ry, z0 = gz * t.rz;
  const int pd = min(t.d, t.nx - x0), rd = min(t.ry, t.ny - y0), cd = min(t.rz, t.nz - z0);
  const int planes = pd + (x0 + pd < t.nx), rows = rd + (y0 + rd < t.ny);
  const int cols = cd + (z0 + cd < t.nz);
  const int plane_bins = rows * cols;

  const size_t voxels = (size_t)t.nx * t.ny * t.nz, plane = (size_t)t.ny * t.nz;
  const float* im = image + b * voxels;
  const float* mk = mask + b * voxels;
  const float lo = lo_[b];
  const float safe = safe_width(lo, hi_[b], n_bins);
  const size_t first = ((size_t)x0 * t.ny + y0) * t.nz + z0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // whole rows of 16-byte vectors: each plane's rows are one aligned span
  const bool vec = cols == t.nz && (t.nz & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(im) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(mk) & 15) == 0;

  // quantise every voxel of the tile once into shared memory
  if (vec)
    quantise_spans(reinterpret_cast<const float4*>(mk), reinterpret_cast<const float4*>(im),
                   first / 4, plane / 4, planes, plane_bins / 4, lo, safe, n_bins, bins);
  else if (cols == t.nz)  // whole rows: a voxel a thread a step
    quantise_spans(mk, im, first, plane, planes, plane_bins, lo, safe, n_bins, bins);
  else  // a z-split: a warp a row
    for (int pr = warp; pr < planes * rows; pr += kWarps) {
      const int p = pr / rows, r = pr - p * rows;
      const size_t at = first + p * plane + (size_t)r * t.nz;
      signed char* out = bins + p * plane_bins + r * cols;
      for (int c = lane; c < cols; c += 32) {
        const float m = mk[at + c];
        out[c] = m > 0.0f ? bin_of(m, im[at + c], lo, safe, n_bins) : (signed char)-1;
      }
    }
  __syncthreads();  // the histogram is clear and every bin is in

  // count each owned voxel's +X, +Y and +Z pairs: a warp a row
  for (int pr = warp; pr < pd * rd; pr += kWarps) {
    const int p = pr / rd, r = pr - p * rd;
    const signed char* s = bins + p * plane_bins + r * cols;
    const bool px = p + 1 < planes, py = r + 1 < rows;
    for (int c = lane; c < cd; c += 32) {
      const int q = s[c];
      if (q < 0) continue;
      int* h = hist + q * hrow;
      if (c + 1 < cols) {
        const int q2 = s[c + 1];
        if (q2 >= 0) atomicAdd(&h[q2], 1);
      }
      if (py) {
        const int q2 = s[c + cols];
        if (q2 >= 0) atomicAdd(&h[q2], 1);
      }
      if (px) {
        const int q2 = s[c + plane_bins];
        if (q2 >= 0) atomicAdd(&h[q2], 1);
      }
    }
  }
  __syncthreads();  // every count of the tile is in

  // the histogram, symmetrised, as this tile's row of the partials
  int* row = partials + ((size_t)b * tiles + g) * nb2;
  for (int k = threadIdx.x; k < nb2; k += kThreads) {
    const int i = k / n_bins, j = k - i * n_bins;
    row[k] = hist[i * hrow + j] + hist[j * hrow + i];
  }
}

// grid (ceil(nb2 / 32), batch), kSumThreads: lane l of every warp takes
// bin 32 blockIdx.x + l; warp w sums the tiles' rows w, w + 32, ...
__global__ void __launch_bounds__(kSumThreads)
    glcm_sum_kernel(const int* __restrict__ partials, int rows, int nb2,
                    float* __restrict__ out) {
  __shared__ int part[32][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * 32 + lane, b = blockIdx.y;
  int s = 0;
  if (k < nb2) {
    const int* p = partials + (size_t)b * rows * nb2 + k;
    for (int g = warp; g < rows; g += 32) s += p[(size_t)g * nb2];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && k < nb2) {
    int total = 0;
    for (int w = 0; w < 32; ++w) total += part[w][lane];
    out[(size_t)b * nb2 + k] = (float)total;
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// image, mask: (batch, nx, ny, nz) float32, C order on the device, 6 x the
// voxels of a case below 2^31; lo, hi: (batch,) float32 masked ranges.
// The tiling (d, ry, rz) is glcm.tiling's: (d+1) x (ry+1) x (rz+1) clipped
// to the volume at most kTileBytes.  partials: (batch, tiles, n_bins^2)
// int32 scratch, tiles = ceil(nx/d) ceil(ny/ry) ceil(nz/rz), batch x tiles
// below 2^31; out: (batch, n_bins, n_bins) float32.  n_bins in [1, 64].
// Launches both passes on `stream`, does not wait.
int glcm_matrix_launch(const float* image, const float* mask, const float* lo,
                       const float* hi, int batch, int nx, int ny, int nz, int n_bins, int d,
                       int ry, int rz, int* partials, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tiling t{nx, ny, nz, d, ry, rz, (ny + ry - 1) / ry, (nz + rz - 1) / rz};
  const int tiles = ((nx + d - 1) / d) * t.ty * t.tz;
  const int tile_bins = std::min(d + 1, nx) * std::min(ry + 1, ny) * std::min(rz + 1, nz);
  if (tile_bins > kTileBytes) return cudaErrorInvalidValue;
  const int nb2 = n_bins * n_bins;
  // at most 64 x 65 ints and kTileBytes: below the 48 KB a block takes unasked
  const size_t shared = sizeof(int) * n_bins * hist_row(n_bins) + tile_bins;
  glcm_tile_kernel<<<tiles * batch, kThreads, shared, s>>>(image, mask, lo, hi, t, tiles, n_bins,
                                                           partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  glcm_sum_kernel<<<dim3((nb2 + 31) / 32, batch), kSumThreads, 0, s>>>(partials, tiles, nb2,
                                                                        out);
  return cudaGetLastError();
}

}  // extern "C"
