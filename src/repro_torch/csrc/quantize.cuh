// Fixed-bin-count discretisation shared by the intensity kernels
// (firstorder.cu, glcm.cu): the operations, and their order, of
// kernels/ref.py quantize_intensity, each an explicitly rounded IEEE
// intrinsic, so a bin edge falls exactly where the plain version and the
// reference put it.  Never a reciprocal multiply.
#pragma once

#include <cuda_runtime.h>

// width = (hi - lo) / n_bins, the bin width the packed row carries.
__device__ __forceinline__ float bin_width(float lo, float hi, int n_bins) {
  return __fdiv_rn(__fsub_rn(hi, lo), (float)n_bins);
}

// The divisor of quantize: the width where positive, else 1.
__device__ __forceinline__ float safe_width(float lo, float hi, int n_bins) {
  const float w = bin_width(lo, hi, n_bins);
  return w > 0.0f ? w : 1.0f;
}

// clip(floor((v - lo) / safe), 0, n_bins - 1) of one masked voxel.
__device__ __forceinline__ int quantize(float v, float lo, float safe, int n_bins) {
  const float q = floorf(__fdiv_rn(__fsub_rn(v, lo), safe));
  return (int)fminf(fmaxf(q, 0.0f), (float)(n_bins - 1));
}
