// Maximum squared pairwise vertex distance for the four combos
// [3D, xy, xz, yz] over one filled and padded SoA vertex list: every
// diameter variant of the reference, the paper's Fig. 1 axis.
//
// Replaces the TPU kernels of repro/kernels/diameter.py:
//   diameter_sweep_launch    <- _kernel_seqacc     ('seqacc', the default, kind 0)
//                               _kernel_nomask     ('nomask', kind 1)
//   diameter_partial_launch  <- _kernel_partial    ('fused', 'tri', 'naive')
//   diameter_sched_launch    <- _kernel_tri_prefetch with _pairwise_combos
//                               ('tri_prefetch') or _pairwise_combos_gram
//                               ('gram')
//
// Bound on the H100: FP32 operations.  A pair costs 14 (3 sub, 3 mul,
// 4 add, 4 max) and the sweep visits M(M+1)/2 pairs against 12 bytes of
// input per vertex.  None of the 14 can be an FMA (the per-pair order is
// pinned, see below), so the sweep is bound by instruction dispatch: 14
// instructions a pair at one warp instruction per clock on each of an
// SM's 4 schedulers, twice the time the 67 TFLOP/s peak (which counts an
// FMA as two) allows.  The TPU walked the tiles in order and carried one
// accumulator across its sequential grid; blocks on the H100 run in no
// order, so every block writes a (4,) partial and a second pass takes the
// max of the partials.  Max is order-free, so every result is
// deterministic, and a list's result is the same bits alone or in a
// (batch, 3, mp) stack (one list per grid row y) and under any grid.
//
// The main path's sweep ('seqacc', 'nomask': diameter_sweep_kernel):
//   * only the list's valid extent.  extent[b] is 1 + the index of list
//     b's last valid slot, read by the kernel from the device (no host
//     sync, no grid that depends on it).  The tiles are ordered column by
//     column (colex: t = j(j+1)/2 + i, i <= j), so the tiles of the k x k
//     corner are the first k(k+1)/2 and a list of extent e sweeps the
//     prefix k = ceil(e / tile).  Every slot past the extent is a filled
//     copy of a valid vertex, so the skipped tiles cannot raise a maximum;
//   * persistent blocks: a fixed grid of about the SM count x resident
//     blocks per SM, split over the lists; each block walks one contiguous
//     run of its list's prefix, carries its maxima in registers across
//     tiles and writes one partial at the end;
//   * register-tiled rows: each thread holds R row vertices, so one
//     shared load serves R pairs (3 LDS.128 for 4 columns x R rows), and
//     the warps of a block split the tile's columns;
//   * double-buffered tiles: the next tile's rows and columns are staged
//     in shared memory with cp.async while the current one is swept.
//   'seqacc' steps from tile to tile arithmetically; 'nomask' reads each
//   tile's (i, j) from the (2, T) colex schedule in device memory (the
//   TPU's scalar prefetch): the Fig. 1 difference between the two.
//
// The other variants give each block one (row tile, column tile) pair:
//   fused         the full nb x nb grid with the mask stream: both triangles
//   tri           the full grid; a block below the diagonal writes an empty
//                 partial and returns (the TPU still ran its DMA there)
//   naive         'fused' once per combo, four launches (combo_mask)
//   tri_prefetch  the upper-triangle tiles read from the (2, T) schedule in
//                 device memory, with the mask
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

// This block's (4,) maxima over tile (i, j) of one (3, mp) SoA list and
// its (mp,) mask stream, one thread a row; the result is valid in thread 0.
template <int kCombo>
__device__ __forceinline__ void tile_maxima(const float* __restrict__ v,
                                            const unsigned char* __restrict__ mask, int mp,
                                            int i, int j, float4* col, float (&m)[4]) {
  const int r = i * blockDim.x + threadIdx.x, c = j * blockDim.x + threadIdx.x;
  col[threadIdx.x] = make_float4(v[c], v[mp + c], v[2 * mp + c], mask[c] ? 1.0f : 0.0f);
  const float rx = v[r], ry = v[mp + r], rz = v[2 * mp + r];
  const bool rv = mask[r];
  __syncthreads();

#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = kNeg;
#pragma unroll 8
  for (int q = 0; q < (int)blockDim.x; ++q) {
    const float4 p = col[q];
    const float dx = __fsub_rn(rx, p.x), dy = __fsub_rn(ry, p.y), dz = __fsub_rn(rz, p.z);
    const float qx = __fmul_rn(dx, dx), qy = __fmul_rn(dy, dy), qz = __fmul_rn(dz, dz);
    fold_pair<kCombo>(qx, qy, qz, rv && p.w != 0.0f, m);
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

__device__ __forceinline__ void write_partial(float* __restrict__ p, const float (&m)[4]) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = m[q];
  }
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
  tile_maxima<kCombo>(v + 3 * (size_t)mp * b, mask + (size_t)mp * b, mp, i, j, col, m);
  write_partial(p, m);
}

// 'tri_prefetch', 'gram' (kGram): tile t's (i, j) read from the (2, T)
// schedule ij.
template <bool kGram>
__global__ void __launch_bounds__(1024)
    diameter_sched_kernel(const float* __restrict__ v, const unsigned char* __restrict__ mask,
                          const int* __restrict__ ij, int mp, float* __restrict__ partials) {
  extern __shared__ float4 col[];
  const size_t b = blockIdx.y;
  const int i = ij[blockIdx.x], j = ij[gridDim.x + blockIdx.x];
  const float* vb = v + 3 * (size_t)mp * b;
  const unsigned char* mb = mask + (size_t)mp * b;
  float m[4];
  if constexpr (kGram) {
    gram_tile_maxima(vb, mb, mp, i, j, col, m);
  } else {
    tile_maxima<kAll>(vb, mb, mp, i, j, col, m);
  }
  write_partial(partials + 4 * ((size_t)gridDim.x * b + blockIdx.x), m);
}

// ---- the main path's sweep: 'seqacc' and 'nomask' -----------------------

constexpr int kSweepThreads = 128;  // threads a block aims at (see sweep_shape)

// Tile t of the colex order over the upper triangle, t = j(j+1)/2 + i with
// i <= j: one float square root and an integer correction, once per block
// (kernels/ref.py colex_tiles is its plain mirror).
__device__ __forceinline__ void colex_tile(long long t, int& i, int& j) {
  long long k = (long long)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (k > 0 && k * (k + 1) / 2 > t) --k;
  while ((k + 1) * (k + 2) / 2 <= t) ++k;
  j = (int)k;
  i = (int)(t - k * (k + 1) / 2);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Queues the copy of tile (i, j) of one (3, mp) list into one stage:
// [row x, row y, row z, column x, column y, column z], `tile` floats each,
// 16 bytes a copy (mp and every tile offset are multiples of 32 floats).
__device__ __forceinline__ void stage_tile(float* __restrict__ st, const float* __restrict__ v,
                                           int mp, int tile, int i, int j) {
  const int per = tile / 4;  // 16-byte chunks in one axis of one tile
  for (int c = threadIdx.x; c < 6 * per; c += blockDim.x) {
    const int which = c / per, off = 4 * (c - which * per);
    const int axis = which % 3, t = which < 3 ? i : j;
    cp_async16(st + which * tile + off, v + (size_t)axis * mp + (size_t)t * tile + off);
  }
  cp_async_commit();
}

// One column point against this thread's R rows: the plain version's
// per-pair operations and order (row minus column), into row r's maxima.
template <int R>
__device__ __forceinline__ void sweep_column(const float (&rx)[R], const float (&ry)[R],
                                             const float (&rz)[R], float px, float py, float pz,
                                             float (&m)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float dx = __fsub_rn(rx[r], px), dy = __fsub_rn(ry[r], py), dz = __fsub_rn(rz[r], pz);
    const float qx = __fmul_rn(dx, dx), qy = __fmul_rn(dy, dy), qz = __fmul_rn(dz, dz);
    const float qxy = __fadd_rn(qx, qy);
    m[r][0] = fmaxf(m[r][0], __fadd_rn(qxy, qz));
    m[r][1] = fmaxf(m[r][1], qxy);
    m[r][2] = fmaxf(m[r][2], __fadd_rn(qx, qz));
    m[r][3] = fmaxf(m[r][3], __fadd_rn(qy, qz));
  }
}

// 'seqacc' (!kSched) and 'nomask' (kSched): list b = blockIdx.y of a
// (batch, 3, mp) stack; block g = blockIdx.x of gridDim.x walks the run
// [g n / G, (g + 1) n / G) of the list's n = k(k+1)/2 prefix tiles, k =
// ceil(extent[b] / tile), and writes one (4,) partial.  Threads: `tile / R`
// row threads (a multiple of 32) times S column groups; thread (s, u) holds
// rows u + r tile / R (r < R) and sweeps columns [s tile / S, (s+1) tile / S)
// of each tile, all lanes of a warp on the same column (a broadcast).
// At most 1024 / R threads (sweep_shape), so R = 8 may hold its 3R row
// coordinates and 4R maxima in registers without spilling.
template <int R, bool kSched>
__global__ void __launch_bounds__(1024 / R)
    diameter_sweep_kernel(const float* __restrict__ v, const int* __restrict__ extent,
                          const int* __restrict__ ij, long long ij_len, int mp, int tile,
                          float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);  // 2 stages of 6 * tile floats
  const size_t b = blockIdx.y;
  const float* vb = v + 3 * (size_t)mp * b;
  const long long nb = mp / tile;
  const long long k = min(nb, max(0LL, ((long long)extent[b] + tile - 1) / tile));
  const long long n = k * (k + 1) / 2, g = blockIdx.x, G = gridDim.x;
  const long long t0 = n * g / G, t1 = n * (g + 1) / G;

  const int row_threads = tile / R, groups = blockDim.x / row_threads;
  const int s = threadIdx.x / row_threads, u = threadIdx.x - s * row_threads;
  const int cols = tile / groups;

  float m[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) m[r][q] = kNeg;
  }
  if (t0 < t1) {
    int i, j;
    if constexpr (kSched) {
      i = ij[t0];
      j = ij[ij_len + t0];
    } else {
      colex_tile(t0, i, j);
    }
    stage_tile(smem, vb, mp, tile, i, j);
    for (long long t = t0; t < t1; ++t) {
      float* const cur = smem + 6 * tile * ((t - t0) & 1);
      cp_async_wait_all();
      __syncthreads();  // this tile is in `cur`; nobody reads the other stage
      if (t + 1 < t1) {
        if constexpr (kSched) {
          i = ij[t + 1];
          j = ij[ij_len + t + 1];
        } else if (i < j) {
          ++i;
        } else {
          i = 0;
          ++j;
        }
        stage_tile(smem + 6 * tile * ((t + 1 - t0) & 1), vb, mp, tile, i, j);
      }
      float rx[R], ry[R], rz[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        rx[r] = cur[u + r * row_threads];
        ry[r] = cur[tile + u + r * row_threads];
        rz[r] = cur[2 * tile + u + r * row_threads];
      }
      const float4* cx = reinterpret_cast<const float4*>(cur + 3 * tile + s * cols);
      const float4* cy = reinterpret_cast<const float4*>(cur + 4 * tile + s * cols);
      const float4* cz = reinterpret_cast<const float4*>(cur + 5 * tile + s * cols);
#pragma unroll 2
      for (int q = 0; q < cols / 4; ++q) {
        const float4 x = cx[q], y = cy[q], z = cz[q];
        sweep_column<R>(rx, ry, rz, x.x, y.x, z.x, m);
        sweep_column<R>(rx, ry, rz, x.y, y.y, z.y, m);
        sweep_column<R>(rx, ry, rz, x.z, y.z, z.z, m);
        sweep_column<R>(rx, ry, rz, x.w, y.w, z.w, m);
      }
    }
  }
  float out[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    out[q] = m[0][q];
#pragma unroll
    for (int r = 1; r < R; ++r) out[q] = fmaxf(out[q], m[r][q]);
  }
  block_reduce<4>(out, MaxOp{}, kNeg);
  write_partial(partials + 4 * ((size_t)gridDim.x * b + blockIdx.x), out);
}

// The sweep's shape at tile side `tile` (a multiple of 32): R, the largest
// of 8, 4, 2, 1 with tile / R a multiple of 32, and the block's threads,
// tile / R times the column groups that bring it to kSweepThreads where
// that divides evenly.
struct SweepShape {
  int rows, threads;
  size_t smem;
};

SweepShape sweep_shape(int tile) {
  const int rows = tile % 256 == 0 ? 8 : tile % 128 == 0 ? 4 : tile % 64 == 0 ? 2 : 1;
  const int row_threads = tile / rows;
  const int groups =
      row_threads < kSweepThreads && kSweepThreads % row_threads == 0 ? kSweepThreads / row_threads
                                                                     : 1;
  return {rows, row_threads * groups, 2 * 6 * (size_t)tile * sizeof(float)};
}

template <int R, bool kSched>
int sweep_resident(const SweepShape& sh, int* resident) {
  const auto kernel = diameter_sweep_kernel<R, kSched>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sh.smem);
  if (err != cudaSuccess) return err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, sh.threads, sh.smem);
  if (err != cudaSuccess) return err;
  *resident = sms * per_sm;
  return cudaSuccess;
}

template <int R, bool kSched>
void sweep(const SweepShape& sh, dim3 grid, cudaStream_t s, const float* v, const int* extent,
           const int* ij, long long ij_len, int mp, int tile, float* partials) {
  diameter_sweep_kernel<R, kSched>
      <<<grid, sh.threads, sh.smem, s>>>(v, extent, ij, ij_len, mp, tile, partials);
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
// filled and padded, mp a multiple of `block` (nb = mp / block tiles a
// side), and writes out: (batch, 4).  partials: 4 floats of scratch per
// launched block (or tile) and list.  Each launches on `stream` and does
// not wait.

// Blocks of the 'seqacc' / 'nomask' sweep (kind 0 / 1) at tile side
// `block` that the card holds at once (SMs x resident blocks per SM):
// the caller's persistent grid, split over the lists.
int diameter_sweep_resident(int block, int kind, int* resident) {
  if (block % 32 || block < 32 || block > 1024 || (kind != 0 && kind != 1))
    return cudaErrorInvalidValue;
  const SweepShape sh = sweep_shape(block);
  switch (sh.rows * 2 + kind) {
    case 2: return sweep_resident<1, false>(sh, resident);
    case 3: return sweep_resident<1, true>(sh, resident);
    case 4: return sweep_resident<2, false>(sh, resident);
    case 5: return sweep_resident<2, true>(sh, resident);
    case 8: return sweep_resident<4, false>(sh, resident);
    case 9: return sweep_resident<4, true>(sh, resident);
    case 16: return sweep_resident<8, false>(sh, resident);
    case 17: return sweep_resident<8, true>(sh, resident);
    default: return cudaErrorInvalidValue;
  }
}

// 'seqacc' (kind 0) and 'nomask' (kind 1): extent (batch,) int32 on the
// device, 1 + the index of each list's last valid slot (0 sweeps nothing);
// ij the (2, nb(nb+1)/2) int32 colex schedule ('nomask' only, else unused);
// grid_x persistent blocks per list, partials for grid_x blocks.  Call
// diameter_sweep_resident at this block and kind first: it also raises the
// kernel's shared-memory limit.
int diameter_sweep_launch(const float* v, const int* extent, const int* ij, int batch, int mp,
                          int block, int grid_x, int kind, float* partials, float* out,
                          void* stream) {
  if (block % 32 || block < 32 || block > 1024 || mp % block || grid_x < 1 ||
      (kind != 0 && kind != 1))
    return cudaErrorInvalidValue;
  const SweepShape sh = sweep_shape(block);
  const long long nb = mp / block, ij_len = nb * (nb + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, batch);
  switch (sh.rows * 2 + kind) {
    case 2: sweep<1, false>(sh, grid, s, v, extent, ij, ij_len, mp, block, partials); break;
    case 3: sweep<1, true>(sh, grid, s, v, extent, ij, ij_len, mp, block, partials); break;
    case 4: sweep<2, false>(sh, grid, s, v, extent, ij, ij_len, mp, block, partials); break;
    case 5: sweep<2, true>(sh, grid, s, v, extent, ij, ij_len, mp, block, partials); break;
    case 8: sweep<4, false>(sh, grid, s, v, extent, ij, ij_len, mp, block, partials); break;
    case 9: sweep<4, true>(sh, grid, s, v, extent, ij, ij_len, mp, block, partials); break;
    case 16: sweep<8, false>(sh, grid, s, v, extent, ij, ij_len, mp, block, partials); break;
    case 17: sweep<8, true>(sh, grid, s, v, extent, ij, ij_len, mp, block, partials); break;
    default: return cudaErrorInvalidValue;
  }
  return finalize(partials, grid_x, batch, out, s);
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

// 'tri_prefetch' (gram 0) and 'gram' (gram 1): ij the (2, ntiles) int32
// upper-triangle schedule on the device; partials for ntiles tiles.
int diameter_sched_launch(const float* v, const unsigned char* mask, const int* ij, int ntiles,
                          int batch, int mp, int block, int gram, float* partials, float* out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)ntiles, batch);
  const size_t smem = block * sizeof(float4);
  if (gram) {
    diameter_sched_kernel<true><<<grid, block, smem, s>>>(v, mask, ij, mp, partials);
  } else {
    diameter_sched_kernel<false><<<grid, block, smem, s>>>(v, mask, ij, mp, partials);
  }
  return finalize(partials, ntiles, batch, out, s);
}

}  // extern "C"
