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
// The other variants give each block one (row tile, column tile) pair
// and read the mask stream:
//   fused         the full nb x nb grid: both triangles
//   tri           the full grid; a block below the diagonal writes an empty
//                 partial and returns (the TPU still ran its DMA there)
//   naive         'fused' once per combo, four launches (combo_mask), each
//                 computing only its combo's axes
//   tri_prefetch  'tri''s tile body, one block a tile of the upper triangle
//                 only, its (i, j) read from the (2, T) schedule in device
//                 memory (the TPU's scalar prefetch): no block is launched
//                 below the diagonal
//   gram          that schedule, each tile's per-axis squared differences
//                 on the FP64 tensor cores (diameter_gram_kernel)
// A pair with an invalid end counts kNeg, as the plain version's
// where(valid, s, NEG).  Every masked variant applies the mask outside the
// pair loop (plan_tile).  Each per-pair operation is an
// explicitly rounded intrinsic in the plain version's order
// (kernels/ref.py pair_sweep), never contracted to an FMA, so the direct
// variants' maxima equal the plain version's bitwise; a filled slot
// duplicates a valid vertex, so they also equal each other's.

#include <cuda_runtime.h>

#include "block_reduce.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kAll = 4;  // every combo; 0..3 picks one of [3D, xy, xz, yz]

// Folds one pair's squared axis differences into the running maxima:
// [3D, xy, xz, yz] in the plain version's order.
__device__ __forceinline__ void fold_pair(float qx, float qy, float qz, float (&m)[4]) {
  const float qxy = __fadd_rn(qx, qy);
  m[0] = fmaxf(m[0], __fadd_rn(qxy, qz));
  m[1] = fmaxf(m[1], qxy);
  m[2] = fmaxf(m[2], __fadd_rn(qx, qz));
  m[3] = fmaxf(m[3], __fadd_rn(qy, qz));
}

// A work counter, compiled only where DIAMETER_COUNT_WORK is defined (the
// normal build leaves count_pairs empty, so its code is unchanged): each
// block adds the pairs of every tile it computes, rows times the columns
// its pair loop sweeps, with one integer atomicAdd a tile, into a device
// counter that diameter_work_take reads and resets.  chip_smoke.py builds
// it into a library of its own and holds every variant's count to
// kernels/diameter.py computed_pairs, in normal and in traced launches.
#ifdef DIAMETER_COUNT_WORK
__device__ unsigned long long g_pairs_computed;
__device__ __forceinline__ void count_pairs(long long rows, long long cols) {
  if (threadIdx.x == 0) atomicAdd(&g_pairs_computed, (unsigned long long)(rows * cols));
}
#else
__device__ __forceinline__ void count_pairs(long long, long long) {}
#endif

__device__ __forceinline__ void write_partial(float* __restrict__ p, const float (&m)[4]) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = m[q];
  }
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
      count_pairs(row_threads * R, groups * cols);
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

// ---- the Fig. 1 variants' tiles: 'fused', 'tri', 'naive', 'tri_prefetch'
// and 'gram' -----------------------------------------------------------------
//
// One block a (row tile i, column tile j) pair and one (4,) partial a
// tile, as the reference's grid; the mask stream is read, but outside the
// pair loop.  A pair with an invalid end counts kNeg, and a maximum does
// not depend on the order of its terms or on a term repeated, so these
// rules give the maxima of a select on every pair, bit for bit:
//   * a tile with no valid row or no valid column writes the empty
//     partial and returns, the whole block together (__syncthreads_or over
//     its mask bytes): padding tiles cost the load of their mask, and for
//     'tri', 'tri_prefetch' and 'gram' every tile past the list's valid
//     region returns
//     at once, with no extent argument and no host sync;
//   * only the tile's valid columns are staged, in order, into a dense
//     list in shared memory, padded to the loop's unit with copies of its
//     first valid column (a repeated pair cannot raise a maximum): an
//     invalid column is skipped by every lane of the block alike, and the
//     pair loop reads no mask;
//   * a thread's maxima of an invalid row are reset to kNeg once, after
//     the loop: every pair of that row is then kNeg, as the select makes it.
// tests/test_torch_variant_tiles.py holds a model of these rules bitwise
// to the plain version's select on every pair.

// The column tile's valid columns: the bit c % 32 of words[c / 32] is
// column c's; before[w] counts the valid columns of the words before w
// (before[32] all of them), first is the first valid column.
struct TileColumns {
  unsigned words[32];
  int before[33];
  int first;
};

// Reads the mask bytes of row tile rmask and column tile cmask (tile <= 1024
// slots; blockDim.x a multiple of 32) into tc.  False, for the whole block,
// where either tile has no valid slot.
__device__ __forceinline__ bool plan_tile(const unsigned char* __restrict__ rmask,
                                          const unsigned char* __restrict__ cmask, int tile,
                                          TileColumns& tc) {
  bool row_any = false;
  for (int c = threadIdx.x; c < tile; c += blockDim.x) {  // a warp covers 32 columns
    row_any |= rmask[c] != 0;
    const unsigned w = __ballot_sync(0xffffffffu, cmask[c] != 0);
    if ((threadIdx.x & 31) == 0) tc.words[c >> 5] = w;
  }
  if (!__syncthreads_or(row_any)) return false;
  if (threadIdx.x < 32) {  // an exclusive scan of the words' counts
    const int lane = threadIdx.x;
    const unsigned w = lane < (tile >> 5) ? tc.words[lane] : 0u;
    int n = __popc(w);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, n, off);
      if (lane >= off) n += up;
    }
    tc.before[lane] = n - __popc(w);
    if (lane == 31) tc.before[32] = n;
    const unsigned nonzero = __ballot_sync(0xffffffffu, w != 0u);
    if (nonzero) {
      const int f = __ffs(nonzero) - 1;
      const unsigned wf = __shfl_sync(0xffffffffu, w, f);
      if (lane == 0) tc.first = 32 * f + __ffs(wf) - 1;
    }
  }
  __syncthreads();
  return tc.before[32] > 0;
}

// Stages column tile j of one (3, mp) SoA list: its valid columns, dense
// and in order, then copies of the first valid column up to n_pad slots.
// Each 4-column chunk with a valid column is one 16-byte load an axis;
// put(slot, axis, value) stores one coordinate.
template <typename Put>
__device__ __forceinline__ void stage_columns(const float* __restrict__ v, int mp, int tile,
                                              int j, const TileColumns& tc, int n_pad, Put put) {
  const float* base = v + (size_t)j * tile;
  for (int t = threadIdx.x; t < tile / 4; t += blockDim.x) {
    const int c = 4 * t, sh = c & 31;
    const unsigned w = tc.words[c >> 5], nib = (w >> sh) & 0xFu;
    if (!nib) continue;
    int slot = tc.before[c >> 5] + __popc(w & ((1u << sh) - 1u));
    float q[3][4];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float4 x = *reinterpret_cast<const float4*>(base + (size_t)ax * mp + c);
      q[ax][0] = x.x;
      q[ax][1] = x.y;
      q[ax][2] = x.z;
      q[ax][3] = x.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (nib >> k & 1u) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) put(slot, ax, q[ax][k]);
        ++slot;
      }
    }
  }
  for (int slot = tc.before[32] + threadIdx.x; slot < n_pad; slot += blockDim.x) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) put(slot, ax, base[(size_t)ax * mp + tc.first]);
  }
  __syncthreads();
}

__device__ __forceinline__ int round_up(int n, int unit) { return (n + unit - 1) / unit * unit; }

// One column point against this thread's R rows, combo kCombo of [3D, xy,
// xz, yz] (kAll: every combo, sweep_column's arithmetic): only the
// combo's axes, in the plain version's order (3D: 3 sub, 3 mul, 2 add and
// a max; a plane 2, 2, 1 and a max).
template <int R, int kCombo>
__device__ __forceinline__ void tile_column(const float (&rx)[R], const float (&ry)[R],
                                            const float (&rz)[R], float px, float py, float pz,
                                            float (&m)[R][4]) {
  if constexpr (kCombo == kAll) {
    sweep_column<R>(rx, ry, rz, px, py, pz, m);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s;
      if constexpr (kCombo == 0) {
        const float dx = __fsub_rn(rx[r], px), dy = __fsub_rn(ry[r], py),
                    dz = __fsub_rn(rz[r], pz);
        s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      } else if constexpr (kCombo == 1) {
        const float dx = __fsub_rn(rx[r], px), dy = __fsub_rn(ry[r], py);
        s = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      } else if constexpr (kCombo == 2) {
        const float dx = __fsub_rn(rx[r], px), dz = __fsub_rn(rz[r], pz);
        s = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz));
      } else {
        const float dy = __fsub_rn(ry[r], py), dz = __fsub_rn(rz[r], pz);
        s = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dz, dz));
      }
      m[r][kCombo] = fmaxf(m[r][kCombo], s);
    }
  }
}

// 'fused' and 'tri' (kCombo kAll) and one launch of 'naive' (kCombo 0..3):
// tile (x / nb, x % nb) of list blockIdx.y, x = blockIdx.x; 'tri_prefetch'
// (kSched, kCombo kAll): scheduled tile x, its (i, j) read from the (2, T)
// schedule ij, so only the upper triangle is launched (the TPU kernel's
// scalar-prefetched walk; 'tri' steps the full grid and returns below the
// diagonal).  The block is sweep_shape's:
// `tile / R` row threads (a multiple of 32) times S column groups; thread
// (s, u) holds rows u + r tile / R (r < R) in registers and sweeps the
// s-th of S equal runs of the staged columns, all lanes of a warp on the
// same column (a broadcast), 3 LDS.128 for 4 columns x R rows.
template <int R, int kCombo, bool kSched>
__global__ void __launch_bounds__(1024 / R)
    diameter_tile_kernel(const float* __restrict__ v, const unsigned char* __restrict__ mask,
                         const int* __restrict__ ij, int mp, int nb, int tile, int triangular,
                         float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* const cols = reinterpret_cast<float*>(smem4);  // [x, y, z] x tile floats
  __shared__ TileColumns tc;
  const size_t b = blockIdx.y;
  const int i = kSched ? ij[blockIdx.x] : blockIdx.x / nb;
  const int j = kSched ? ij[gridDim.x + blockIdx.x] : blockIdx.x % nb;
  const float* vb = v + 3 * (size_t)mp * b;
  const unsigned char* mb = mask + (size_t)mp * b;
  float* const p = partials + 4 * ((size_t)gridDim.x * b + blockIdx.x);
  float out[4] = {kNeg, kNeg, kNeg, kNeg};
  if ((triangular && j < i) || !plan_tile(mb + (size_t)i * tile, mb + (size_t)j * tile, tile, tc)) {
    write_partial(p, out);  // the whole block leaves together
    return;
  }
  const int row_threads = tile / R, groups = blockDim.x / row_threads;
  const int s = threadIdx.x / row_threads, u = threadIdx.x - s * row_threads;
  const int n_pad = round_up(tc.before[32], 4 * groups), per = n_pad / groups;
  stage_columns(vb, mp, tile, j, tc, n_pad,
                [cols, tile](int slot, int ax, float x) { cols[ax * tile + slot] = x; });

  float rx[R], ry[R], rz[R], m[R][4];
  bool rv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = i * tile + u + r * row_threads;
    rx[r] = vb[row];
    ry[r] = vb[mp + row];
    rz[r] = vb[2 * mp + row];
    rv[r] = mb[row] != 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) m[r][q] = kNeg;
  }
  count_pairs(row_threads * R, groups * per);
  const float4* cx = reinterpret_cast<const float4*>(cols + s * per);
  const float4* cy = reinterpret_cast<const float4*>(cols + tile + s * per);
  const float4* cz = reinterpret_cast<const float4*>(cols + 2 * tile + s * per);
#pragma unroll 2
  for (int q = 0; q < per / 4; ++q) {
    const float4 x = cx[q], y = cy[q], z = cz[q];
    tile_column<R, kCombo>(rx, ry, rz, x.x, y.x, z.x, m);
    tile_column<R, kCombo>(rx, ry, rz, x.y, y.y, z.y, m);
    tile_column<R, kCombo>(rx, ry, rz, x.z, y.z, z.z, m);
    tile_column<R, kCombo>(rx, ry, rz, x.w, y.w, z.w, m);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = fmaxf(out[q], rv[r] ? m[r][q] : kNeg);  // the row reset
  }
  block_reduce<4>(out, MaxOp{}, kNeg);
  write_partial(p, out);
}

// A tile kernel launch: 'tri_prefetch' where ij is given (every combo),
// else the full grid of combo_mask's combo(s).
template <int R>
int tile_launch(int combo_mask, dim3 grid, int threads, cudaStream_t s, const float* v,
                const unsigned char* mask, const int* ij, int mp, int nb, int tile,
                int triangular, float* partials) {
  const size_t smem = 3 * (size_t)tile * sizeof(float);
  if (ij) {
    if (combo_mask != 0xF) return cudaErrorInvalidValue;
    diameter_tile_kernel<R, kAll, true><<<grid, threads, smem, s>>>(v, mask, ij, mp, nb, tile, 0, partials);
    return cudaSuccess;
  }
  switch (combo_mask) {
    case 0xF: diameter_tile_kernel<R, kAll, false><<<grid, threads, smem, s>>>(v, mask, ij, mp, nb, tile, triangular, partials); break;
    case 0x1: diameter_tile_kernel<R, 0, false><<<grid, threads, smem, s>>>(v, mask, ij, mp, nb, tile, triangular, partials); break;
    case 0x2: diameter_tile_kernel<R, 1, false><<<grid, threads, smem, s>>>(v, mask, ij, mp, nb, tile, triangular, partials); break;
    case 0x4: diameter_tile_kernel<R, 2, false><<<grid, threads, smem, s>>>(v, mask, ij, mp, nb, tile, triangular, partials); break;
    case 0x8: diameter_tile_kernel<R, 3, false><<<grid, threads, smem, s>>>(v, mask, ij, mp, nb, tile, triangular, partials); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// tile_launch at sweep_shape(tile)'s rows and threads.
int tile_dispatch(int combo_mask, dim3 grid, cudaStream_t s, const float* v,
                  const unsigned char* mask, const int* ij, int mp, int nb, int tile,
                  int triangular, float* partials) {
  const SweepShape sh = sweep_shape(tile);
  switch (sh.rows) {
    case 1: return tile_launch<1>(combo_mask, grid, sh.threads, s, v, mask, ij, mp, nb, tile, triangular, partials);
    case 2: return tile_launch<2>(combo_mask, grid, sh.threads, s, v, mask, ij, mp, nb, tile, triangular, partials);
    case 4: return tile_launch<4>(combo_mask, grid, sh.threads, s, v, mask, ij, mp, nb, tile, triangular, partials);
    case 8: return tile_launch<8>(combo_mask, grid, sh.threads, s, v, mask, ij, mp, nb, tile, triangular, partials);
    default: return cudaErrorInvalidValue;
  }
}

// 'gram': per axis, the tile's squared differences are one K = 3 product
// on the augmented Gram identity,
//   [r^2, 1, -2r] @ [1, c^2, c]^T = r^2 + c^2 - 2rc = (r - c)^2,
// padded to K = 4 with a zero term, on the FP64 tensor cores with sm_90's
// mma.sync m16n8k4 .f64 shape.  float32 coordinates square and multiply
// exactly in float64, so each entry is (r - c)^2 to float64 rounding, and
// __double2float_rn rounds it once to float32 (the plain version's
// arithmetic, kernels/ref.py _axis_squares); the combos then add in
// float32 as in every variant.  Plain TF32 would keep about 3 decimal
// digits, too few for the 1e-3 the reference allows at paper-scale
// coordinates (tests/test_gram_precision.py); FP64 needs no
// split-precision correction.
//
// The tile's staged columns hold [1, c^2, c, 0] per axis in float64, formed
// once a tile; each warp holds the A fragments of kGramGroups 16-row groups in
// registers and reuses each column group's B fragments for all of them.
// A pair costs 3 float64 -> float32 conversions (F2F, 16 a clock an SM on
// compute capability 9.0: the kernel's ceiling), 4 adds and 4 max; the
// products are 24 tensor-core FLOP a pair (8 an axis, the zero term
// included).
constexpr int kGramWarps = 4;
constexpr int kGramGroups = 2;

// d = a * b for this lane's fragments of one m16n8k4 FP64 product: A
// row-major 16 x 4, the lane holds A[g][k] (a0) and A[g + 8][k] (a1); B
// column-major 4 x 8, B[k][g]; D 16 x 8, D[g][2k + e] (d[e]) and
// D[g + 8][2k + e] (d[2 + e]), e = 0, 1; g = lane / 4, k = lane % 4.
__device__ __forceinline__ void dmma_16x8x4(double a0, double a1, double b, double (&d)[4]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%7, %8, %9, %10};\n"
      : "=d"(d[0]), "=d"(d[1]), "=d"(d[2]), "=d"(d[3])
      : "d"(a0), "d"(a1), "d"(b), "d"(0.0), "d"(0.0), "d"(0.0), "d"(0.0));
}

// The augmented Gram factor of row coordinate x at K index k: [x^2, 1, -2x, 0].
__device__ __forceinline__ double gram_row(double x, int k) {
  return k == 0 ? x * x : k == 1 ? 1.0 : k == 2 ? -2.0 * x : 0.0;
}

// 'gram': scheduled tile t = blockIdx.x of list blockIdx.y, (i, j) read
// from the (2, T) schedule ij; kGramWarps warps.  At least 4 blocks an SM
// caps a thread at 128 registers: left to itself ptxas settles at 96 and
// spills.
__global__ void __launch_bounds__(32 * kGramWarps, 4)
    diameter_gram_kernel(const float* __restrict__ v, const unsigned char* __restrict__ mask,
                         const int* __restrict__ ij, int mp, int tile,
                         float* __restrict__ partials) {
  extern __shared__ double2 gcols[];  // [x, y, z] x tile of [1, c^2, c, 0]: 2 double2 each
  __shared__ TileColumns tc;
  const size_t b = blockIdx.y;
  const int i = ij[blockIdx.x], j = ij[gridDim.x + blockIdx.x];
  const float* vb = v + 3 * (size_t)mp * b;
  const unsigned char* mb = mask + (size_t)mp * b;
  float* const p = partials + 4 * ((size_t)gridDim.x * b + blockIdx.x);
  float out[4] = {kNeg, kNeg, kNeg, kNeg};
  if (!plan_tile(mb + (size_t)i * tile, mb + (size_t)j * tile, tile, tc)) {
    write_partial(p, out);  // the whole block leaves together
    return;
  }
  const int n_pad = round_up(tc.before[32], 8);
  stage_columns(vb, mp, tile, j, tc, n_pad, [tile](int slot, int ax, float x) {
    const double c = x;
    gcols[2 * (ax * tile + slot)] = make_double2(1.0, c * c);
    gcols[2 * (ax * tile + slot) + 1] = make_double2(c, 0.0);
  });
  const double* const bcols = reinterpret_cast<const double*>(gcols);
  count_pairs(tile / (16 * kGramGroups) * 16 * kGramGroups, n_pad);

  const int lane = threadIdx.x & 31, g = lane >> 2, k = lane & 3;
  for (int set = threadIdx.x >> 5; set < tile / (16 * kGramGroups); set += kGramWarps) {
    double a[kGramGroups][3][2];
    bool rv[kGramGroups][2];
    float m[kGramGroups][2][4];
#pragma unroll
    for (int gg = 0; gg < kGramGroups; ++gg) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = i * tile + (set * kGramGroups + gg) * 16 + g + 8 * h;
        rv[gg][h] = mb[row] != 0;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) a[gg][ax][h] = gram_row(vb[(size_t)ax * mp + row], k);
#pragma unroll
        for (int q = 0; q < 4; ++q) m[gg][h][q] = kNeg;
      }
    }
    for (int cg = 0; cg < n_pad / 8; ++cg) {
      double bf[3];  // B[k][g] of each axis: one conflict-free LDS.64
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) bf[ax] = bcols[4 * (ax * tile + cg * 8 + g) + k];
#pragma unroll
      for (int gg = 0; gg < kGramGroups; ++gg) {
        float q[3][4];  // each product rounded once to float32 as it lands
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          double d[4];
          dmma_16x8x4(a[gg][ax][0], a[gg][ax][1], bf[ax], d);
#pragma unroll
          for (int e = 0; e < 4; ++e) q[ax][e] = __double2float_rn(d[e]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) fold_pair(q[0][e], q[1][e], q[2][e], m[gg][e >> 1]);
      }
    }
#pragma unroll
    for (int gg = 0; gg < kGramGroups; ++gg) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q] = fmaxf(out[q], rv[gg][h] ? m[gg][h][q] : kNeg);
      }
    }
  }
  block_reduce<4>(out, MaxOp{}, kNeg);
  write_partial(p, out);
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
  if (block % 32 || block < 32 || block > 1024 || mp % block) return cudaErrorInvalidValue;
  const long long nb = mp / block, ntiles = nb * nb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)ntiles, batch);
  const int err = tile_dispatch(combo_mask, grid, s, v, mask, nullptr, mp, (int)nb, block,
                                triangular, partials);
  if (err != cudaSuccess) return err;
  return finalize(partials, ntiles, batch, out, s);
}

// 'tri_prefetch' (gram 0: diameter_tile_kernel<R, kAll, true>) and 'gram'
// (gram 1): ij the (2, ntiles) int32 upper-triangle schedule on the device;
// mask (batch, mp) bool, padding false; partials for ntiles tiles.
int diameter_sched_launch(const float* v, const unsigned char* mask, const int* ij, int ntiles,
                          int batch, int mp, int block, int gram, float* partials, float* out,
                          void* stream) {
  if (block % 32 || block < 32 || block > 1024 || mp % block) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)ntiles, batch);
  if (gram) {
    const size_t smem = 3 * (size_t)block * 2 * sizeof(double2);  // 96 KB at block 1024
    if (smem > 40 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          diameter_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    diameter_gram_kernel<<<grid, 32 * kGramWarps, smem, s>>>(v, mask, ij, mp, block, partials);
  } else {
    const int err = tile_dispatch(0xF, grid, s, v, mask, ij, mp, mp / block, block, 0, partials);
    if (err != cudaSuccess) return err;
  }
  return finalize(partials, ntiles, batch, out, s);
}

#ifdef DIAMETER_COUNT_WORK
// The counting build only: the pairs counted since the last call into
// *pairs, and the counter reset to 0.  Call it once the launches have
// finished (it copies through the legacy default stream).
int diameter_work_take(unsigned long long* pairs) {
  cudaError_t err = cudaMemcpyFromSymbol(pairs, g_pairs_computed, sizeof(*pairs));
  if (err != cudaSuccess) return err;
  const unsigned long long zero = 0;
  return cudaMemcpyToSymbol(g_pairs_computed, &zero, sizeof(zero));
}
#endif

}  // extern "C"
