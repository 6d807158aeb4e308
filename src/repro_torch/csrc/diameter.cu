// Maximum squared pairwise vertex distance for the four combos
// [3D, xy, xz, yz] over one centred, filled and padded SoA vertex list:
// every diameter variant of the reference, the paper's Fig. 1 axis.
//
// Replaces the TPU kernels of repro/kernels/diameter.py:
//   max_diameters_sq_launch  <- _kernel_seqacc     ('seqacc', the default)
//   diameter_partial_launch  <- _kernel_partial    ('fused', 'tri', 'naive')
//   diameter_sched_launch    <- _kernel_tri_prefetch with _pairwise_combos
//                               ('tri_prefetch') or _pairwise_combos_gram
//                               ('gram'), and _kernel_nomask ('nomask')
//
// Bound on the H100: FP32 operations.  A pair costs 14 (3 sub, 3 mul,
// 4 add, 4 max) and the sweep visits M(M+1)/2 pairs against 12 bytes of
// input per vertex.  The TPU walked the tiles in order and carried one
// accumulator across its sequential grid; blocks on the H100 run in no
// order, so every variant here gives each block one (row tile, column
// tile) pair: the block stages its column tile in shared memory (every
// thread reads the same element, a broadcast), each thread keeps its row
// vertex and 4 running maxima in registers, the block writes its (4,)
// partial, and a second pass takes the max of the partials.  Max is
// order-free, so every result is deterministic, and a list's result is the
// same bits alone or in a (batch, 3, mp) stack (one list per grid row y).
//
// The variants differ in the grid and the streams, as on the TPU:
//   seqacc        the nb(nb+1)/2 upper-triangle tiles decoded from blockIdx.x,
//                 no mask: invalid slots hold a copy of a valid vertex
//   fused         the full nb x nb grid with the mask stream: both triangles
//   tri           the full grid; a block below the diagonal writes an empty
//                 partial and returns (the TPU still ran its DMA there)
//   naive         'fused' once per combo, four launches (combo_mask)
//   tri_prefetch  the upper-triangle tiles read from a (2, T) schedule in
//                 device memory (the TPU's scalar prefetch), with the mask
//   nomask        that schedule on the filled input, no mask stream
//   gram          that schedule and mask, each tile's per-axis squared
//                 differences on the tensor cores (see gram_tile_maxima)
// A masked pair with an invalid end counts kNeg, as the plain version's
// where(valid, s, NEG).  Each per-pair operation is an explicitly rounded
// intrinsic in the plain version's order (kernels/ref.py pair_sweep),
// never contracted to an FMA, so the direct variants' maxima equal the
// plain version's bitwise; a filled slot duplicates a valid vertex, so
// they also equal each other's.

#include <cuda_runtime.h>

#include "block_reduce.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kAll = 4;  // every combo; 0..3 picks one of [3D, xy, xz, yz]

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

// Folds one pair's squared axis differences into the running maxima:
// [3D, xy, xz, yz] in the plain version's order, kNeg where !ok.
template <int kCombo>
__device__ __forceinline__ void fold_pair(float qx, float qy, float qz, bool ok,
                                          float (&m)[4]) {
  const float qxy = __fadd_rn(qx, qy);
  if (kCombo == kAll || kCombo == 0) m[0] = fmaxf(m[0], ok ? __fadd_rn(qxy, qz) : kNeg);
  if (kCombo == kAll || kCombo == 1) m[1] = fmaxf(m[1], ok ? qxy : kNeg);
  if (kCombo == kAll || kCombo == 2) m[2] = fmaxf(m[2], ok ? __fadd_rn(qx, qz) : kNeg);
  if (kCombo == kAll || kCombo == 3) m[3] = fmaxf(m[3], ok ? __fadd_rn(qy, qz) : kNeg);
}

// This block's (4,) maxima over tile (i, j) of one (3, mp) SoA list, with
// the (mp,) mask stream when kMasked; the result is valid in thread 0.
template <bool kMasked, int kCombo>
__device__ __forceinline__ void tile_maxima(const float* __restrict__ v,
                                            const unsigned char* __restrict__ mask, int mp,
                                            int i, int j, float4* col, float (&m)[4]) {
  const int r = i * blockDim.x + threadIdx.x, c = j * blockDim.x + threadIdx.x;
  col[threadIdx.x] =
      make_float4(v[c], v[mp + c], v[2 * mp + c], kMasked && mask[c] ? 1.0f : 0.0f);
  const float rx = v[r], ry = v[mp + r], rz = v[2 * mp + r];
  const bool rv = !kMasked || mask[r];
  __syncthreads();

#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = kNeg;
#pragma unroll 8
  for (int q = 0; q < (int)blockDim.x; ++q) {
    const float4 p = col[q];
    const float dx = __fsub_rn(rx, p.x), dy = __fsub_rn(ry, p.y), dz = __fsub_rn(rz, p.z);
    const float qx = __fmul_rn(dx, dx), qy = __fmul_rn(dy, dy), qz = __fmul_rn(dz, dz);
    fold_pair<kCombo>(qx, qy, qz, !kMasked || (rv && p.w != 0.0f), m);
  }
  block_reduce<4>(m, MaxOp{}, kNeg);
}

// One m8n8k4 FP64 product on the tensor cores: d = a * b for this lane's
// fragments (A row-major 8x4: lane holds A[lane/4][lane%4]; B column-major
// 4x8: B[lane%4][lane/4]; D 8x8: D[lane/4][2*(lane%4) + e], e = 0, 1).
__device__ __forceinline__ void dmma_8x8x4(double a, double b, double& d0, double& d1) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%4, %5};\n"
      : "=d"(d0), "=d"(d1)
      : "d"(a), "d"(b), "d"(0.0), "d"(0.0));
}

// 'gram': tile (i, j) through the augmented Gram identity.  Per axis the
// tile's squared differences are one K = 3 product,
//   [r^2, 1, -2r] @ [1, c^2, c]^T = r^2 + c^2 - 2rc = (r - c)^2,
// padded to the m8n8k4 shape's K = 4 with a zero.  The FP64 tensor cores
// (mma.sync .f64, which Hopper has) take it: float32 coordinates square
// and multiply exactly in float64, so each entry is (r - c)^2 to float64
// rounding, and __double2float_rn rounds it once to float32.  Plain TF32
// would keep about 3 decimal digits, too few for the 1e-3 the reference
// allows at paper-scale coordinates (tests/test_gram_precision.py); FP64
// needs no split-precision (3xTF32) correction.  The combos then add in
// float32 as in every variant.  Each warp takes four 8-row groups of the
// tile and walks the tile's 8-column groups: three products (x, y, z) per
// 8 x 8 sub-tile, two pairs a lane.  24 tensor-core FLOP a pair against
// the direct sweep's 14 FP32 operations: 'gram' is slower on this card.
__device__ __forceinline__ void gram_tile_maxima(const float* __restrict__ v,
                                                 const unsigned char* __restrict__ mask,
                                                 int mp, int i, int j, float4* col,
                                                 float (&m)[4]) {
  const int nblk = blockDim.x, c = j * nblk + threadIdx.x;
  col[threadIdx.x] = make_float4(v[c], v[mp + c], v[2 * mp + c], mask[c] ? 1.0f : 0.0f);
  __syncthreads();

#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = kNeg;
  const int lane = threadIdx.x & 31, g = lane >> 2, k = lane & 3;
  const int groups = nblk / 8, nwarps = nblk / 32;
  for (int rg = threadIdx.x >> 5; rg < groups; rg += nwarps) {
    const int r = i * nblk + rg * 8 + g;  // this lane's A row and D row
    double a[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const double x = v[ax * mp + r];
      a[ax] = k == 0 ? x * x : k == 1 ? 1.0 : k == 2 ? -2.0 * x : 0.0;
    }
    const bool rv = mask[r];
    for (int cg = 0; cg < groups; ++cg) {
      const float4 p = col[cg * 8 + g];  // this lane's B column
      const float pc[3] = {p.x, p.y, p.z};
      double d[3][2];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const double x = pc[ax];
        const double b = k == 0 ? 1.0 : k == 1 ? x * x : k == 2 ? x : 0.0;
        dmma_8x8x4(a[ax], b, d[ax][0], d[ax][1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool cv = col[cg * 8 + 2 * k + e].w != 0.0f;
        fold_pair<kAll>(__double2float_rn(d[0][e]), __double2float_rn(d[1][e]),
                        __double2float_rn(d[2][e]), rv && cv, m);
      }
    }
  }
  block_reduce<4>(m, MaxOp{}, kNeg);
}

// 'seqacc': this block's (4,) maxima over upper-triangle tile `tile` of one
// (3, mp) SoA list; the result is valid in thread 0.  The same per-pair
// operations as tile_maxima<false, kAll>, kept as written before the other
// variants came: routed through that template, this kernel ran 3.7% slower
// on the card (PERF.md, section 6).
__device__ __forceinline__ void seqacc_tile_maxima(const float* __restrict__ v, int mp,
                                                   int nb, long long tile, float4* col,
                                                   float (&m)[4]) {
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

__device__ __forceinline__ void write_partial(float* __restrict__ p, const float (&m)[4]) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = m[q];
  }
}

// 'seqacc': list b = blockIdx.y of a (batch, 3, mp) stack, its
// upper-triangle tiles on blockIdx.x and its partials in their own row.
__global__ void __launch_bounds__(1024)
    diameter_tiles_kernel(const float* __restrict__ v, int mp, int nb,
                          float* __restrict__ partials) {
  extern __shared__ float4 col[];
  const size_t b = blockIdx.y;
  float m[4];
  seqacc_tile_maxima(v + 3 * (size_t)mp * b, mp, nb, blockIdx.x, col, m);
  write_partial(partials + 4 * ((size_t)gridDim.x * b + blockIdx.x), m);
}

// 'fused', 'tri', 'naive': the full nb x nb grid, tile (x / nb, x % nb).
template <int kCombo>
__global__ void __launch_bounds__(1024)
    diameter_partial_kernel(const float* __restrict__ v, const unsigned char* __restrict__ mask,
                            int mp, int nb, int triangular, float* __restrict__ partials) {
  extern __shared__ float4 col[];
  const size_t b = blockIdx.y;
  const int i = blockIdx.x / nb, j = blockIdx.x % nb;
  float m[4] = {kNeg, kNeg, kNeg, kNeg};
  float* p = partials + 4 * ((size_t)gridDim.x * b + blockIdx.x);
  if (triangular && j < i) {  // the whole block leaves together
    write_partial(p, m);
    return;
  }
  tile_maxima<true, kCombo>(v + 3 * (size_t)mp * b, mask + (size_t)mp * b, mp, i, j, col, m);
  write_partial(p, m);
}

// 'tri_prefetch' (kMasked), 'nomask' (!kMasked), 'gram' (kGram): tile t's
// (i, j) read from the (2, T) schedule ij.
template <bool kMasked, bool kGram>
__global__ void __launch_bounds__(1024)
    diameter_sched_kernel(const float* __restrict__ v, const unsigned char* __restrict__ mask,
                          const int* __restrict__ ij, int mp, float* __restrict__ partials) {
  extern __shared__ float4 col[];
  const size_t b = blockIdx.y;
  const int i = ij[blockIdx.x], j = ij[gridDim.x + blockIdx.x];
  const float* vb = v + 3 * (size_t)mp * b;
  const unsigned char* mb = kMasked ? mask + (size_t)mp * b : nullptr;
  float m[4];
  if constexpr (kGram) {
    gram_tile_maxima(vb, mb, mp, i, j, col, m);
  } else {
    tile_maxima<kMasked, kAll>(vb, mb, mp, i, j, col, m);
  }
  write_partial(partials + 4 * ((size_t)gridDim.x * b + blockIdx.x), m);
}

// The max over one list's per-tile partials, clamped at 0.
__global__ void diameter_finalize_kernel(const float* __restrict__ partials, long long ntiles,
                                         float* __restrict__ out) {
  const size_t b = blockIdx.x;
  const float* pb = partials + 4 * ntiles * b;
  float m[4] = {kNeg, kNeg, kNeg, kNeg};
  for (long long t = threadIdx.x; t < ntiles; t += blockDim.x) {
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = fmaxf(m[q], pb[4 * t + q]);
  }
  block_reduce<4>(m, MaxOp{}, kNeg);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) out[4 * b + q] = fmaxf(m[q], 0.0f);
  }
}

int finalize(const float* partials, long long ntiles, int batch, float* out, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  diameter_finalize_kernel<<<batch, 256, 0, s>>>(partials, ntiles, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Every entry takes v: (batch, 3, mp) float32 SoA on the device, each list
// centred, filled and padded, mp a multiple of `block` (nb = mp / block
// tiles a side), and writes out: (batch, 4).  partials: 4 floats of
// scratch per launched tile and list.  Each launches on `stream` and does
// not wait.

// 'seqacc': partials for nb(nb+1)/2 tiles.
int max_diameters_sq_launch(const float* v, int batch, int mp, int block, float* partials,
                            float* out, void* stream) {
  const long long nb = mp / block, ntiles = nb * (nb + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  diameter_tiles_kernel<<<dim3((unsigned)ntiles, batch), block, block * sizeof(float4), s>>>(
      v, mp, (int)nb, partials);
  return finalize(partials, ntiles, batch, out, s);
}

// 'fused' (triangular 0), 'tri' (triangular 1) and one launch of 'naive':
// mask (batch, mp) bool, padding false; partials for nb * nb tiles.
// combo_mask 0xF computes every combo, a single bit 1 << c combo c only
// (the others stay at 0 in `out`).
int diameter_partial_launch(const float* v, const unsigned char* mask, int batch, int mp,
                            int block, int triangular, int combo_mask, float* partials,
                            float* out, void* stream) {
  const long long nb = mp / block, ntiles = nb * nb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)ntiles, batch);
  const size_t smem = block * sizeof(float4);
  switch (combo_mask) {
    case 0xF: diameter_partial_kernel<kAll><<<grid, block, smem, s>>>(v, mask, mp, (int)nb, triangular, partials); break;
    case 0x1: diameter_partial_kernel<0><<<grid, block, smem, s>>>(v, mask, mp, (int)nb, triangular, partials); break;
    case 0x2: diameter_partial_kernel<1><<<grid, block, smem, s>>>(v, mask, mp, (int)nb, triangular, partials); break;
    case 0x4: diameter_partial_kernel<2><<<grid, block, smem, s>>>(v, mask, mp, (int)nb, triangular, partials); break;
    case 0x8: diameter_partial_kernel<3><<<grid, block, smem, s>>>(v, mask, mp, (int)nb, triangular, partials); break;
    default: return cudaErrorInvalidValue;
  }
  return finalize(partials, ntiles, batch, out, s);
}

// 'tri_prefetch' (kind 0), 'nomask' (kind 1, mask unused) and 'gram'
// (kind 2): ij the (2, ntiles) int32 upper-triangle schedule on the
// device; partials for ntiles tiles.
int diameter_sched_launch(const float* v, const unsigned char* mask, const int* ij, int ntiles,
                          int batch, int mp, int block, int kind, float* partials, float* out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)ntiles, batch);
  const size_t smem = block * sizeof(float4);
  switch (kind) {
    case 0: diameter_sched_kernel<true, false><<<grid, block, smem, s>>>(v, mask, ij, mp, partials); break;
    case 1: diameter_sched_kernel<false, false><<<grid, block, smem, s>>>(v, mask, ij, mp, partials); break;
    case 2: diameter_sched_kernel<true, true><<<grid, block, smem, s>>>(v, mask, ij, mp, partials); break;
    default: return cudaErrorInvalidValue;
  }
  return finalize(partials, ntiles, batch, out, s);
}

}  // extern "C"
