// Marching-cubes mesh volume and surface area of (nx, ny, nz) float32
// volumes: (|sum of signed tetrahedron volumes|, sum of triangle areas).
//
// Replaces the TPU kernel repro/kernels/marching_cubes.py::_mc_kernel as
// mc_volume_area_pallas calls it: the same cube index (value > iso), edge
// interpolation, edge numbering, triangle table and per-triangle formulas,
// against the centred origin -0.5 * shape * spacing that the caller passes.
//
// Bound on the H100: device memory.  Every voxel is read once (4 bytes per
// voxel at 3.35 TB/s); only the cells the surface crosses do arithmetic.
// The design reads each cell's 8 corners in place, one thread per cell (the
// neighbours' loads hit L1), drops empty and full cells at once, and keeps
// the triangle table in shared memory, where a warp's different lookups do
// not serialise as constant-cache reads would.  The TPU kernel's overlapping
// brick restack and one-hot matmul lookup have no use here.
//
// One launch runs a stack of same-shape volumes, one per grid row: the
// single-case path is its batch of one, and pass 2a of the batched pipeline
// (marching_cubes.py::mc_volume_area_batch_pallas, the TPU kernel under
// lax.map) its batch of many.
//
// Determinism: each thread sums its cells in grid-stride order, each block
// reduces with a fixed shuffle tree to one (volume, area) partial, and one
// block per case sums its partials in a fixed order.  Every case gets the
// grid of its volume alone, so a case's result is the same bits alone or
// in a stack.  No float atomics, so two runs on one input are bitwise
// equal.  Built with -fmad=false, every product and sum is rounded as in
// the plain version (kernels/ref.py), so the two differ only in the order
// of the final sums.

#include <cuda_runtime.h>

#include "block_reduce.cuh"
#include "mc_tri_table.cuh"  // kTriTable[256 * 15], from core/mc_tables.py

namespace {

constexpr int kSlots = 15;  // 3 * MAX_TRIS edge ids per case, -1 padded
constexpr int kMaxTris = 5;

struct Geometry {
  float iso;
  float sp[3];   // voxel spacing
  float org[3];  // centred origin
};

__device__ __forceinline__ float interp(float v0, float v1, float iso) {
  float den = v1 - v0;
  if (fabsf(den) < 1e-30f) den = 1.0f;
  return fminf(fmaxf((iso - v0) / den, 0.0f), 1.0f);
}

// Vertex on the grid edge along `axis` anchored at grid point (x, y, z);
// v0 is the value at the anchor, v1 at its neighbour along `axis`.
__device__ __forceinline__ float3 edge_vertex(int axis, int x, int y, int z, float v0,
                                              float v1, const Geometry& g) {
  const float t = interp(v0, v1, g.iso);
  float px = (float)x, py = (float)y, pz = (float)z;
  if (axis == 0) px += t;
  else if (axis == 1) py += t;
  else pz += t;
  return make_float3(px * g.sp[0] + g.org[0], py * g.sp[1] + g.org[1],
                     pz * g.sp[2] + g.org[2]);
}

// The 12 cube edges of cell (i, j, k), numbered as marching_cubes.py:81-93,
// ref.py:117-129 and mc_tables.EDGE_CELL_AXIS / EDGE_CELL_OFFSET.  v[] holds
// the corners in mc_tables.CORNERS order:
//   0 (0,0,0)  1 (1,0,0)  2 (1,1,0)  3 (0,1,0)
//   4 (0,0,1)  5 (1,0,1)  6 (1,1,1)  7 (0,1,1)
__device__ __forceinline__ float3 cell_edge_vertex(int e, const float (&v)[8], int i, int j,
                                                   int k, const Geometry& g) {
  switch (e) {
    case 0: return edge_vertex(0, i, j, k, v[0], v[1], g);
    case 1: return edge_vertex(1, i + 1, j, k, v[1], v[2], g);
    case 2: return edge_vertex(0, i, j + 1, k, v[3], v[2], g);
    case 3: return edge_vertex(1, i, j, k, v[0], v[3], g);
    case 4: return edge_vertex(0, i, j, k + 1, v[4], v[5], g);
    case 5: return edge_vertex(1, i + 1, j, k + 1, v[5], v[6], g);
    case 6: return edge_vertex(0, i, j + 1, k + 1, v[7], v[6], g);
    case 7: return edge_vertex(1, i, j, k + 1, v[4], v[7], g);
    case 8: return edge_vertex(2, i, j, k, v[0], v[4], g);
    case 9: return edge_vertex(2, i + 1, j, k, v[1], v[5], g);
    case 10: return edge_vertex(2, i + 1, j + 1, k, v[2], v[6], g);
    default: return edge_vertex(2, i, j + 1, k, v[3], v[7], g);  // 11
  }
}

// area = 0.5 * sqrt(|ab x ac|^2 + 1e-30), signed volume = a . (b x c) / 6,
// in the operation order of marching_cubes.py:151-155.
__device__ __forceinline__ void add_triangle(float3 a, float3 b, float3 c, float& vol,
                                             float& area) {
  const float abx = b.x - a.x, aby = b.y - a.y, abz = b.z - a.z;
  const float acx = c.x - a.x, acy = c.y - a.y, acz = c.z - a.z;
  const float nx = aby * acz - abz * acy;
  const float ny = abz * acx - abx * acz;
  const float nz = abx * acy - aby * acx;
  area += 0.5f * sqrtf(nx * nx + ny * ny + nz * nz + 1e-30f);
  const float bcx = b.y * c.z - b.z * c.y;
  const float bcy = b.z * c.x - b.x * c.z;
  const float bcz = b.x * c.y - b.y * c.x;
  vol += (a.x * bcx + a.y * bcy + a.z * bcz) / 6.0f;
}

// Copies the triangle table into shared memory; every thread of the block
// calls it before the first lookup.
__device__ __forceinline__ void load_table(signed char* tri) {
  for (int q = threadIdx.x; q < 256 * kSlots; q += blockDim.x) tri[q] = kTriTable[q];
  __syncthreads();
}

// This block's (signed volume, area) partial of one volume: each thread sums
// its cells in grid-stride order over gridDim.x blocks, then a fixed shuffle
// tree reduces the block.  The result is valid in thread 0.
__device__ __forceinline__ void block_partial(const float* __restrict__ vol, int nx, int ny,
                                              int nz, const Geometry& g,
                                              const signed char* tri, float (&acc)[2]) {
  const unsigned cy = ny - 1, cz = nz - 1;
  const unsigned ncells = (unsigned)(nx - 1) * cy * cz;  // < 2^31, checked by the wrapper
  const size_t sx = (size_t)ny * nz, sy = nz;
  acc[0] = 0.0f;  // signed volume
  acc[1] = 0.0f;  // area
  for (unsigned c = blockIdx.x * blockDim.x + threadIdx.x; c < ncells;
       c += gridDim.x * blockDim.x) {
    const int k = c % cz, j = (c / cz) % cy, i = c / cz / cy;
    const float* p = vol + i * sx + j * sy + k;
    const float v[8] = {p[0], p[sx], p[sx + sy], p[sy],
                        p[1], p[sx + 1], p[sx + sy + 1], p[sy + 1]};
    int idx = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) idx |= (v[q] > g.iso) << q;
    if (idx == 0 || idx == 255) continue;
    const signed char* row = tri + idx * kSlots;
    for (int t = 0; t < kMaxTris && row[3 * t] >= 0; ++t) {
      add_triangle(cell_edge_vertex(row[3 * t], v, i, j, k, g),
                   cell_edge_vertex(row[3 * t + 1], v, i, j, k, g),
                   cell_edge_vertex(row[3 * t + 2], v, i, j, k, g), acc[0], acc[1]);
    }
  }
  block_reduce<2>(acc, SumOp{}, 0.0f);
}

// Sums one case's per-block partials in a fixed order: (|volume|, area).
__device__ __forceinline__ void finalize(const float* __restrict__ partials, int nparts,
                                         float* __restrict__ out) {
  float acc[2] = {0.0f, 0.0f};
  for (int b = threadIdx.x; b < nparts; b += blockDim.x) {
    acc[0] += partials[b];
    acc[1] += partials[nparts + b];
  }
  block_reduce<2>(acc, SumOp{}, 0.0f);
  if (threadIdx.x == 0) {
    out[0] = fabsf(acc[0]);
    out[1] = acc[1];
  }
}

// Case b = blockIdx.y of a stack: its own volume, spacing and origin
// (geo[6b..6b+5]), over gridDim.x blocks.  The wrapper gives every case the
// grid of its volume alone, so a case's partials, and with them its result,
// are the same bits alone or in a stack.
__global__ void __launch_bounds__(1024)
    mc_partials_kernel(const float* __restrict__ vols, int nx, int ny, int nz, float iso,
                       const float* __restrict__ geo, float* __restrict__ partials) {
  __shared__ signed char tri[256 * kSlots];
  load_table(tri);
  const size_t b = blockIdx.y;
  const float* gb = geo + 6 * b;
  const Geometry g{iso, {gb[0], gb[1], gb[2]}, {gb[3], gb[4], gb[5]}};
  float acc[2];
  block_partial(vols + b * nx * ny * (size_t)nz, nx, ny, nz, g, tri, acc);
  if (threadIdx.x == 0) {
    float* pb = partials + 2 * gridDim.x * b;
    pb[blockIdx.x] = acc[0];
    pb[gridDim.x + blockIdx.x] = acc[1];
  }
}

__global__ void mc_finalize_kernel(const float* __restrict__ partials, int nparts,
                                   float* __restrict__ out) {
  const size_t b = blockIdx.x;
  finalize(partials + 2 * nparts * b, nparts, out + 2 * b);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// vols: (batch, nx, ny, nz) float32, C order, on the device.  geo: (batch, 6)
// float32 [spacing, centred origin] per case.  partials: 2 * nblocks * batch
// floats of scratch.  out: (batch, 2).  Launches on `stream`, does not
// wait.
int mc_volume_area_launch(const float* vols, int batch, int nx, int ny, int nz, float iso,
                          const float* geo, float* partials, int nblocks, int threads,
                          float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mc_partials_kernel<<<dim3(nblocks, batch), threads, 0, s>>>(vols, nx, ny, nz, iso, geo,
                                                              partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mc_finalize_kernel<<<batch, 256, 0, s>>>(partials, nblocks, out);
  return cudaGetLastError();
}

}  // extern "C"
