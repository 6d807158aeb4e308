// Deterministic block reductions shared by the port's kernels: a fixed
// shuffle tree inside each warp, then one warp over the per-warp results.
// The order of operations depends only on blockDim, never on timing, so a
// reduction gives the same bits on every run.
#pragma once

#include <cuda_runtime.h>

struct SumOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

template <int N, typename Op>
__device__ __forceinline__ void warp_reduce(float (&x)[N], Op op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < N; ++q) x[q] = op(x[q], __shfl_down_sync(0xffffffffu, x[q], off));
  }
}

// Reduces each x[q] over the block; the result is valid in thread 0.
// blockDim.x must be a multiple of 32 and at most 1024.  `identity` stands
// in for the warps a smaller block does not have.  One call per kernel:
// the shared scratch is not reset between calls.
template <int N, typename Op>
__device__ __forceinline__ void block_reduce(float (&x)[N], Op op, float identity) {
  __shared__ float scratch[32][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce<N>(x, op);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < N; ++q) scratch[warp][q] = x[q];
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
#pragma unroll
    for (int q = 0; q < N; ++q) x[q] = lane < nwarps ? scratch[lane][q] : identity;
    warp_reduce<N>(x, op);
  }
}
