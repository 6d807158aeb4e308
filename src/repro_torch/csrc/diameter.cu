// Maximum squared pairwise vertex distance for the four combos
// [3D, xy, xz, yz] over one centred, filled and padded SoA vertex list.
//
// Replaces the TPU kernel repro/kernels/diameter.py::_kernel_seqacc, the
// body of max_diameters_sq_pallas's default variant 'seqacc'.
//
// Bound on the H100: FP32 operations.  A pair costs 14 (3 sub, 3 mul,
// 4 add, 4 max) and the sweep visits M(M+1)/2 pairs against 12 bytes of
// input per vertex.  The TPU walked the upper-triangle tiles in order and
// carried one accumulator across its sequential grid; blocks on the H100
// run in no order, so here the grid's x dimension covers exactly the
// nb(nb+1)/2 upper-triangle (row tile, column tile) pairs, decoded from
// blockIdx.x.
// Each block stages its column tile in shared memory (every thread reads
// the same element, a broadcast), each thread keeps its row vertex and 4
// running maxima in registers, and a second pass takes the max of the
// per-block partials.  Max is order-free, so the result is deterministic.
//
// One launch sweeps a (batch, 3, mp) stack of lists, one per grid row: the
// single-case path is its batch of one, and pass 2b of the batched pipeline
// (where the reference maps max_diameters_sq_pallas over a stack with
// lax.map) its batch of many.  Max is order-free, so a list's result is the
// same bits alone or in a stack.
//
// Each per-pair operation is an explicitly rounded intrinsic in the plain
// version's order (kernels/ref.py diameter_sweep), never contracted to an
// FMA, so the kernel's maxima equal the plain version's bitwise.

#include <cuda_runtime.h>

#include "block_reduce.cuh"

namespace {

constexpr float kNeg = -1e30f;

// Row-major index t over the upper triangle of an nb x nb tile grid ->
// (i, j) with i <= j.  Counted from the end, row nb-1-k holds k+1 tiles.
__device__ __forceinline__ void tile_of(long long t, long long nb, int& i, int& j) {
  const long long u = nb * (nb + 1) / 2 - 1 - t;
  long long k = (long long)((sqrt(8.0 * (double)u + 1.0) - 1.0) * 0.5);
  while (k * (k + 1) / 2 > u) --k;
  while ((k + 1) * (k + 2) / 2 <= u) ++k;
  i = (int)(nb - 1 - k);
  j = (int)(nb - 1 - (u - k * (k + 1) / 2));
}

// This block's (4,) maxima over upper-triangle tile `tile` of one (3, mp)
// SoA list; the result is valid in thread 0.
__device__ __forceinline__ void tile_maxima(const float* __restrict__ v, int mp, int nb,
                                            long long tile, float4* col, float (&m)[4]) {
  int i, j;
  tile_of(tile, nb, i, j);
  const int r = i * blockDim.x + threadIdx.x, c = j * blockDim.x + threadIdx.x;
  col[threadIdx.x] = make_float4(v[c], v[mp + c], v[2 * mp + c], 0.0f);
  const float rx = v[r], ry = v[mp + r], rz = v[2 * mp + r];
  __syncthreads();

#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = kNeg;  // 3D, xy, xz, yz
#pragma unroll 8
  for (int q = 0; q < (int)blockDim.x; ++q) {
    const float4 p = col[q];
    const float dx = __fsub_rn(rx, p.x), dy = __fsub_rn(ry, p.y), dz = __fsub_rn(rz, p.z);
    const float qx = __fmul_rn(dx, dx), qy = __fmul_rn(dy, dy), qz = __fmul_rn(dz, dz);
    const float qxy = __fadd_rn(qx, qy);
    m[0] = fmaxf(m[0], __fadd_rn(qxy, qz));
    m[1] = fmaxf(m[1], qxy);
    m[2] = fmaxf(m[2], __fadd_rn(qx, qz));
    m[3] = fmaxf(m[3], __fadd_rn(qy, qz));
  }
  block_reduce<4>(m, MaxOp{}, kNeg);
}

// The max over one list's per-tile partials, clamped at 0.
__device__ __forceinline__ void finalize(const float* __restrict__ partials, long long ntiles,
                                         float* __restrict__ out) {
  float m[4] = {kNeg, kNeg, kNeg, kNeg};
  for (long long t = threadIdx.x; t < ntiles; t += blockDim.x) {
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = fmaxf(m[q], partials[4 * t + q]);
  }
  block_reduce<4>(m, MaxOp{}, kNeg);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = fmaxf(m[q], 0.0f);
  }
}

// List b = blockIdx.y of a (batch, 3, mp) stack: its tiles on blockIdx.x
// and its partials in their own row.
__global__ void __launch_bounds__(1024)
    diameter_tiles_kernel(const float* __restrict__ v, int mp, int nb,
                          float* __restrict__ partials) {
  extern __shared__ float4 col[];
  const size_t b = blockIdx.y;
  float m[4];
  tile_maxima(v + 3 * (size_t)mp * b, mp, nb, blockIdx.x, col, m);
  if (threadIdx.x == 0) {
    float* pb = partials + 4 * (size_t)gridDim.x * b;
#pragma unroll
    for (int q = 0; q < 4; ++q) pb[4 * (size_t)blockIdx.x + q] = m[q];
  }
}

__global__ void diameter_finalize_kernel(const float* __restrict__ partials, long long ntiles,
                                         float* __restrict__ out) {
  const size_t b = blockIdx.x;
  finalize(partials + 4 * ntiles * b, ntiles, out + 4 * b);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// v: (batch, 3, mp) float32 SoA on the device, each list centred, filled
// and padded, mp a multiple of `block`.  partials: 4 * batch * nb(nb+1)/2
// floats of scratch, nb = mp / block.  out: (batch, 4).  Launches on
// `stream`, does not wait.
int max_diameters_sq_launch(const float* v, int batch, int mp, int block, float* partials,
                            float* out, void* stream) {
  const long long nb = mp / block, ntiles = nb * (nb + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  diameter_tiles_kernel<<<dim3((unsigned)ntiles, batch), block, block * sizeof(float4), s>>>(
      v, mp, (int)nb, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  diameter_finalize_kernel<<<batch, 256, 0, s>>>(partials, ntiles, out);
  return cudaGetLastError();
}

}  // extern "C"
