// Marching-cubes mesh volume and surface area of (nx, ny, nz) float32
// volumes: (|sum of signed tetrahedron volumes|, sum of triangle areas).
//
// Replaces the TPU kernel repro/kernels/marching_cubes.py::_mc_kernel in
// both of its uses: as mc_volume_area_pallas calls it (whole volumes; and
// under lax.map, mc_volume_area_batch_pallas) and with z_scal, as
// mc_brick_partials_pallas calls it for one z-window of a tiled volume,
// its per-brick partials returned unreduced and folded by
// mc_partials_finalize.  The same cube index (value > iso), edge
// interpolation, edge numbering, triangle table and per-triangle formulas,
// against the centred origin -0.5 * shape * spacing of the whole volume,
// which the caller passes.
//
// Bound on the H100: device memory.  Every voxel is read once (4 bytes per
// voxel at 3.35 TB/s); only the cells the surface crosses do arithmetic.
// The design reads each cell's 8 corners in place (the neighbours' loads
// hit L1), drops empty and full cells at once, and keeps the triangle
// table in shared memory, where a warp's different lookups do not
// serialise as constant-cache reads would.  The TPU kernel's overlapping
// brick restack and one-hot matmul lookup have no use here.
//
// The partial layout, shared by the in-core and the tiled paths: the cells
// of a volume are cut along z into granules of cz cell planes (granule g
// holds the cells with k in [g*cz, (g+1)*cz)).  A granule's cells, in
// granule-local order l = (i * (ny-1) + j) * cz + (k - g*cz), are split
// into runs of kCellsPerThread * blockDim.x; block b of the granule sums
// run b, thread t the cells l = b*run + r*blockDim.x + t for r = 0, 1, ...
// in turn, and a fixed shuffle tree reduces the block to one (volume,
// area) partial.  So a granule's partials depend on (nx-1, ny-1, cz), the
// local cell index and the thread count alone: not on how many granules
// one launch covers, nor on the card's SM count.  A cell past the volume's
// last cell plane (the short last granule, or the zero planes a tile stages
// past the frame) counts as empty, and an empty cell adds nothing, so a
// z-window covering granules k0..k1 computes exactly the partials the
// whole volume computes for them.  The z index is the global cell plane,
// an exact integer, converted to float once.
//
// Launches: mc_volume_area_launch runs the partials of every granule of a
// stack of same-shape volumes (grid (blocks per granule, granules, batch))
// and then the finalize, which sums one case's (granules x blocks) partials
// in a fixed order and takes |volume|.  The single-case path is its batch
// of one, pass 2a of the batched pipeline its batch of many.
// mc_slab_partials_launch runs the partials of one z-window with its z
// offset and returns them unreduced; the tiled engine assembles every
// window's partials into the whole granule grid (skipped windows stay
// +0.0, the bits an empty granule gives) and calls mc_finalize_launch, the
// same finalize.  So tiled and in-core agree bitwise.
//
// No float atomics, so two runs on one input are bitwise equal.  Built
// with -fmad=false, every product and sum is rounded as in the plain
// version (kernels/ref.py), so the two differ only in the order of the
// sums inside a granule and in the final fold.

#include <cuda_runtime.h>

#include "block_reduce.cuh"
#include "mc_tri_table.cuh"  // kTriTable[256 * 15], from core/mc_tables.py

namespace {

constexpr int kSlots = 15;  // 3 * MAX_TRIS edge ids per case, -1 padded
constexpr int kMaxTris = 5;
constexpr int kCellsPerThread = 8;  // granule-local cells one thread sums
constexpr int kFinalizeThreads = 512;

struct Geometry {
  float iso;
  float sp[3];   // voxel spacing
  float org[3];  // centred origin of the whole volume
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
// k is the global cell plane.
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

// Block (blockIdx.x, blockIdx.y) of case blockIdx.z: run blockIdx.x of
// granule blockIdx.y of a window whose planes start at global cell plane
// kz0 (see the head of this file).  vols: (batch, nx, ny, nz) float32;
// cells with a global plane >= kz_end, or past the window's last plane,
// are empty.  partials: (batch, 2, gridDim.y, gridDim.x), volume then area.
__global__ void __launch_bounds__(1024)
    mc_partials_kernel(const float* __restrict__ vols, int nx, int ny, int nz, int cz,
                       int kz0, int kz_end, float iso, const float* __restrict__ geo,
                       float* __restrict__ partials) {
  __shared__ signed char tri[256 * kSlots];
  load_table(tri);
  const size_t b = blockIdx.z;
  const float* gb = geo + 6 * b;
  const Geometry g{iso, {gb[0], gb[1], gb[2]}, {gb[3], gb[4], gb[5]}};
  const float* vol = vols + b * nx * ny * (size_t)nz;
  const int cy = ny - 1;
  const int gran_cells = (nx - 1) * cy * cz;  // < 2^31, checked by the wrapper
  const int k_base = blockIdx.y * cz;         // window-local first plane of the granule
  const size_t sx = (size_t)ny * nz, sy = nz;
  float acc[2] = {0.0f, 0.0f};  // signed volume, area
  const int run0 = blockIdx.x * kCellsPerThread * blockDim.x + threadIdx.x;
  for (int r = 0; r < kCellsPerThread; ++r) {
    const int l = run0 + r * blockDim.x;
    if (l >= gran_cells) break;
    const int kk = l % cz, j = (l / cz) % cy, i = l / cz / cy;
    const int k = k_base + kk;  // window-local cell plane
    if (k >= nz - 1 || kz0 + k >= kz_end) continue;
    const float* p = vol + i * sx + j * sy + k;
    const float v[8] = {p[0], p[sx], p[sx + sy], p[sy],
                        p[1], p[sx + 1], p[sx + sy + 1], p[sy + 1]};
    int idx = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) idx |= (v[q] > g.iso) << q;
    if (idx == 0 || idx == 255) continue;
    const signed char* row = tri + idx * kSlots;
    const int kg = kz0 + k;  // global cell plane, exact
    for (int t = 0; t < kMaxTris && row[3 * t] >= 0; ++t) {
      add_triangle(cell_edge_vertex(row[3 * t], v, i, j, kg, g),
                   cell_edge_vertex(row[3 * t + 1], v, i, j, kg, g),
                   cell_edge_vertex(row[3 * t + 2], v, i, j, kg, g), acc[0], acc[1]);
    }
  }
  block_reduce<2>(acc, SumOp{}, 0.0f);
  if (threadIdx.x == 0) {
    const size_t nparts = (size_t)gridDim.x * gridDim.y;
    const size_t at = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    partials[2 * nparts * b + at] = acc[0];
    partials[2 * nparts * b + nparts + at] = acc[1];
  }
}

// Case blockIdx.x: sums its nparts volume and nparts area partials in a
// fixed order (thread t takes t, t + blockDim.x, ... then the block tree),
// then (|volume|, area).
__global__ void __launch_bounds__(kFinalizeThreads)
    mc_finalize_kernel(const float* __restrict__ partials, int nparts,
                       float* __restrict__ out) {
  const size_t b = blockIdx.x;
  const float* pb = partials + 2 * (size_t)nparts * b;
  float acc[2] = {0.0f, 0.0f};
  for (int q = threadIdx.x; q < nparts; q += blockDim.x) {
    acc[0] += pb[q];
    acc[1] += pb[nparts + q];
  }
  block_reduce<2>(acc, SumOp{}, 0.0f);
  if (threadIdx.x == 0) {
    out[2 * b] = fabsf(acc[0]);
    out[2 * b + 1] = acc[1];
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Partials of one z-window: vols (batch, nx, ny, nz) float32, C order, on
// the device, its planes starting at global cell plane kz0; cells at global
// planes >= kz_end are empty.  ngran granules of cz planes, bpg blocks of
// `threads` per granule.  geo: (batch, 6) float32 [spacing, centred origin
// of the whole volume] per case.  partials: (batch, 2, ngran, bpg).
// Launches on `stream`, does not wait.
int mc_slab_partials_launch(const float* vols, int batch, int nx, int ny, int nz, int cz,
                            int kz0, int kz_end, float iso, const float* geo, int ngran,
                            int bpg, int threads, float* partials, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mc_partials_kernel<<<dim3(bpg, ngran, batch), threads, 0, s>>>(vols, nx, ny, nz, cz, kz0,
                                                                 kz_end, iso, geo, partials);
  return cudaGetLastError();
}

// partials: (batch, 2, nparts) -> out: (batch, 2) [|volume|, area].
int mc_finalize_launch(const float* partials, int batch, int nparts, float* out,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mc_finalize_kernel<<<batch, kFinalizeThreads, 0, s>>>(partials, nparts, out);
  return cudaGetLastError();
}

// Whole volumes: the partials of all ngran granules, then the finalize.
// partials: (batch, 2, ngran, bpg) scratch; out: (batch, 2).
int mc_volume_area_launch(const float* vols, int batch, int nx, int ny, int nz, int cz,
                          float iso, const float* geo, int ngran, int bpg, int threads,
                          float* partials, float* out, void* stream) {
  int err = mc_slab_partials_launch(vols, batch, nx, ny, nz, cz, 0, nz - 1, iso, geo, ngran,
                                    bpg, threads, partials, stream);
  if (err != cudaSuccess) return err;
  return mc_finalize_launch(partials, batch, ngran * bpg, out, stream);
}

}  // extern "C"
