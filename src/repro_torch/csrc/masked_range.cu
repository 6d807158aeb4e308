// Masked intensity range: (lo, hi) of each case of a (batch, L) float32
// stack of images over the voxels whose mask is > 0, (0, 0) for a case with
// no such voxel.  The first-order and GLCM kernels quantise with it; the
// batched executor takes it once per shape pool for both families.
//
// Replaces no TPU kernel: the reference computes the range outside any
// Pallas kernel (repro/kernels/ref.py intensity_range, under jax.vmap), and
// the port's plain version is kernels/ref.py intensity_range (two
// masked_fills, amin, amax and any over the whole stack).
//
// Bound on the H100: device memory.  The range needs every mask value (4
// bytes a voxel) and the image only where the mask is set; a few
// comparisons a voxel are far below the FP32 rate.  So the design serves
// the read:
//   * range_partials_kernel, a (chunks, batch) grid: each block reads one
//     run of kChunk voxels of one case; a thread loads its kGroups mask
//     values as 16-byte vectors, all in flight together, then the image's
//     16 bytes of only those groups with a set mask value, and folds a
//     min, a max and a count of masked voxels in registers; warp shuffles
//     and one shared row fold them into the block's partial;
//   * range_fold_kernel, one block a case, folds the case's partials and
//     writes (lo, hi), or (0, 0) where the count is 0.
// No float atomics and no memset.  Min and max are exact in any order, so
// the result equals the plain version by value, but for the sign of a tie
// of -0.0 and +0.0 at an extremum.  A NaN at a masked voxel makes both
// ends NaN, as amin/amax propagate it, so the fold is a compare-and-select
// that keeps a NaN and not fminf/fmaxf (which drop one); a NaN at an
// unmasked voxel is never read into the fold.  Where the image and mask
// rows are not equally aligned to 16 bytes, the same partials are read one
// voxel at a time.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 8;                      // 16-byte mask groups a thread reads
constexpr int kChunk = 4 * kGroups * kThreads;  // voxels a block: 8192
constexpr unsigned kFull = 0xffffffffu;

struct Range {
  float lo, hi;
  int n;  // masked voxels
};

__device__ __forceinline__ Range empty_range() { return {CUDART_INF_F, -CUDART_INF_F, 0}; }

// min and max that keep a NaN of either argument (amin/amax semantics)
__device__ __forceinline__ float min_nan(float a, float b) { return b < a || isnan(b) ? b : a; }
__device__ __forceinline__ float max_nan(float a, float b) { return b > a || isnan(b) ? b : a; }

// Folds voxel value x in where its mask value m is > 0, with no branch.
__device__ __forceinline__ void take(Range& r, float x, float m) {
  const bool in = m > 0.0f;
  r.lo = in ? min_nan(r.lo, x) : r.lo;
  r.hi = in ? max_nan(r.hi, x) : r.hi;
  r.n += in;
}

__device__ __forceinline__ void merge(Range& r, const Range& o) {
  r.lo = min_nan(r.lo, o.lo);
  r.hi = max_nan(r.hi, o.hi);
  r.n += o.n;
}

__device__ __forceinline__ void warp_range(Range& r) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Range o{__shfl_down_sync(kFull, r.lo, off), __shfl_down_sync(kFull, r.hi, off),
                  __shfl_down_sync(kFull, r.n, off)};
    merge(r, o);
  }
}

// The block's range (blockDim.x a multiple of 32); valid in thread 0.
__device__ __forceinline__ Range block_range(Range r) {
  __shared__ Range warps[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_range(r);
  if (lane == 0) warps[warp] = r;
  __syncthreads();
  if (warp == 0) {
    r = lane < (int)(blockDim.x >> 5) ? warps[lane] : empty_range();
    warp_range(r);
  }
  return r;
}

// Block x of case y: voxels [x kChunk, (x + 1) kChunk) of the case, one
// partial (lo, hi, n) into lo_p, hi_p, n_p at y * gridDim.x + x.  kVec: the
// case's rows read as the 16-byte groups from the mask row's first aligned
// voxel on (`head` voxels before it, at most 3, and at most 3 after the
// last whole group, read by block 0 one at a time); block x reads groups
// [x, x + 1) kChunk / 4 of them.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    range_partials_kernel(const float* __restrict__ images, const float* __restrict__ masks,
                          long long voxels, float* __restrict__ lo_p, float* __restrict__ hi_p,
                          int* __restrict__ n_p) {
  const size_t b = blockIdx.y;
  const float* ib = images + b * voxels;
  const float* mb = masks + b * voxels;
  Range r = empty_range();
  if constexpr (kVec) {
    const long long head =
        min(voxels, (long long)(((16 - (reinterpret_cast<uintptr_t>(mb) & 15)) & 15) >> 2));
    const long long ng = (voxels - head) >> 2;
    const float4* m4 = reinterpret_cast<const float4*>(mb + head);
    const float4* i4 = reinterpret_cast<const float4*>(ib + head);
    const long long g0 = (long long)blockIdx.x * (kChunk / 4) + threadIdx.x;
    float4 m[kGroups], x[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long g = g0 + k * kThreads;
      m[k] = g < ng ? __ldcs(m4 + g) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {  // the image only where a mask value is set
      const bool any = m[k].x > 0.0f || m[k].y > 0.0f || m[k].z > 0.0f || m[k].w > 0.0f;
      x[k] = any ? __ldcs(i4 + g0 + k * kThreads) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      take(r, x[k].x, m[k].x);
      take(r, x[k].y, m[k].y);
      take(r, x[k].z, m[k].z);
      take(r, x[k].w, m[k].w);
    }
    if (blockIdx.x == 0 && threadIdx.x < 8) {  // the head, then the tail
      const long long t = threadIdx.x < 4 ? threadIdx.x : head + 4 * ng + (threadIdx.x - 4);
      if (threadIdx.x < 4 ? t < head : t < voxels) take(r, ib[t], mb[t]);
    }
  } else {
    const long long v1 = min(voxels, (long long)(blockIdx.x + 1) * kChunk);
    for (long long t = (long long)blockIdx.x * kChunk + threadIdx.x; t < v1; t += kThreads)
      take(r, ib[t], mb[t]);
  }
  r = block_range(r);
  if (threadIdx.x == 0) {
    const size_t p = b * gridDim.x + blockIdx.x;
    lo_p[p] = r.lo;
    hi_p[p] = r.hi;
    n_p[p] = r.n;
  }
}

// Case blockIdx.x: the fold of its `chunks` partials; out[b] = lo and
// out[batch + b] = hi, both 0 where no voxel of the case is masked.
__global__ void __launch_bounds__(kThreads)
    range_fold_kernel(const float* __restrict__ lo_p, const float* __restrict__ hi_p,
                      const int* __restrict__ n_p, int chunks, float* __restrict__ out) {
  const size_t b = blockIdx.x, p0 = b * chunks;
  Range r = empty_range();
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    merge(r, Range{lo_p[p0 + c], hi_p[p0 + c], n_p[p0 + c]});
  r = block_range(r);
  if (threadIdx.x == 0) {
    out[b] = r.n ? r.lo : 0.0f;
    out[gridDim.x + b] = r.n ? r.hi : 0.0f;
  }
}

// Does nothing: launched on each grid of masked_range_launch, its device
// time is the two launches' floor.
__global__ void range_empty_kernel() {}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// images, masks: (batch, voxels) float32 on the device, contiguous;
// chunks = ceil(voxels / kChunk) (the wrapper's CHUNK, 8192); partials:
// 3 * batch * chunks words of scratch; out: (2, batch) float32, row 0 lo,
// row 1 hi.  Two launches on `stream`, no wait.
int masked_range_launch(const float* images, const float* masks, int batch, long long voxels,
                        int chunks, float* partials, float* out, void* stream) {
  if (batch < 1 || batch >= 65536 || voxels < 1 || chunks < 1 ||
      (long long)chunks * kChunk < voxels || (long long)(chunks - 1) * kChunk >= voxels)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)batch * chunks;
  float* lo_p = partials;
  float* hi_p = partials + n;
  int* n_p = reinterpret_cast<int*>(partials + 2 * n);
  const dim3 grid(chunks, batch);
  const bool vec = ((reinterpret_cast<uintptr_t>(images) - reinterpret_cast<uintptr_t>(masks)) &
                    15) == 0;
  if (vec) {
    range_partials_kernel<true><<<grid, kThreads, 0, s>>>(images, masks, voxels, lo_p, hi_p, n_p);
  } else {
    range_partials_kernel<false><<<grid, kThreads, 0, s>>>(images, masks, voxels, lo_p, hi_p, n_p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  range_fold_kernel<<<batch, kThreads, 0, s>>>(lo_p, hi_p, n_p, chunks, out);
  return cudaGetLastError();
}

// The empty kernel on masked_range_launch's two grids, for measurement.
int masked_range_floor_launch(int batch, int chunks, void* stream) {
  if (batch < 1 || batch >= 65536 || chunks < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  range_empty_kernel<<<dim3(chunks, batch), kThreads, 0, s>>>();
  range_empty_kernel<<<batch, kThreads, 0, s>>>();
  return cudaGetLastError();
}

}  // extern "C"
