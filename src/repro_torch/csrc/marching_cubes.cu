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
// voxel at 3.35 TB/s); only the cells the surface crosses do arithmetic,
// and few cells do.  So the design reads each voxel from device memory
// once, coalesced, into shared memory, classifies whole columns of cells
// with bit operations, and then works only on the surface:
//
//   * Items.  The x-y plane is cut into kTX x kTY tiles of cell columns,
//     z into runs of at most kPZ = 32 cell planes: kPZ / cz whole granules
//     (granule g holds the cells with k in [g*cz, (g+1)*cz)), or, for cz >
//     kPZ, one sub-slab of kPZ planes of a granule.  One item is (tile,
//     z-run): 8 x 8 cell columns of up to 32 cells, one block each.  A
//     block issues its item's loads first and copies the triangle table
//     (16-byte words) while they land.
//   * Stage and classify.  A warp reads a corner column's 33 planes as one
//     z-run (z is the contiguous axis: coalesced, each voxel read from
//     device memory once), eleven columns in flight a warp, and stages
//     them in shared memory; a ballot gives the column's inside bits.
//     A cell column's surface cells, not all 8 corners on one side, are
//     then a few 64-bit ANDs and ORs of four columns' bits, a cell's cube
//     index the same bits gathered.  No per-cell division, no per-cell
//     compare.
//   * Work densely.  A block scan over (partial, cell column) units lays
//     each partial's surface cells out as a dense shared-memory list in
//     cell order (cell column (i, j) row-major, then k), each partial's
//     list starting at a multiple of 32.  All threads take 32 consecutive
//     cells a warp; the warp expands their triangles (a shuffle scan of
//     the cells' triangle counts) and takes them 32 a round, a lane each,
//     so no lane idles while another works through a cell.  A
//     triangle's edge takes its axis and anchor from the generated
//     kEdgeCode (mc_edge_table.cuh) instead of a switch, and its vertex
//     from the two staged values on that edge: the plain version computes
//     each edge vertex once (kernels/ref.py vertex_fields), and the bits of
//     a vertex depend only on its edge, not on the cell.
//   * Order.  A round's 32 triangles add by a shuffle tree (y[:16] +
//     y[16:] ... in lane 0), a group's rounds by a left fold, lane l then
//     folds the partial's group sums l, l + 32, ... in order and a second
//     shuffle tree ends the partial.  That order depends on the partial's
//     cells alone: not on the thread count, the grid, the SM count, the
//     batch or which item holds the granule.
//
// The partial layout, shared by the in-core and the tiled paths: per case
// (2, granules, parts per granule), parts per granule = ceil(cz / kPZ)
// sub-slabs x tiles, (granule g, sub-slab s, tile t) at column s * tiles +
// t of row g.  It depends on the x-y extent, cz and the tile constants
// alone.  A cell past the volume's last cell plane (the short last
// granule, or the zero planes a tile stages past the frame) counts as
// empty, and an empty cell adds nothing, so a z-window covering granules
// k0..k1 computes exactly the partials the whole volume computes for them,
// though its items group them differently.  The z index is the global cell
// plane, an exact integer, converted to float once.
//
// Launches: mc_volume_area_launch runs the partials of every item of a
// stack of same-shape volumes and then the finalize, which sums one case's
// partials in a fixed order and takes |volume|.  The single-case path is
// its batch of one, pass 2a of the batched pipeline its batch of many.
// mc_slab_partials_launch runs the partials of one z-window with its z
// offset and returns them unreduced; the tiled engine assembles every
// window's partials into the whole granule grid (skipped windows stay
// +0.0, the bits an empty granule gives) and calls mc_finalize_launch, the
// same finalize, on the volume and area grids in place.  So tiled and
// in-core agree bitwise.
//
// No float atomics, so two runs on one input are bitwise equal.  Built
// with -fmad=false, every product and sum is rounded as in the plain
// version (kernels/ref.py), so the two differ only in the order of the
// sums inside a granule and in the final fold.

#include <cuda_runtime.h>

#include "block_reduce.cuh"
#include "mc_edge_table.cuh"  // kEdgeCode, from core/mc_tables.py
#include "mc_tri_table.cuh"   // kTriTable[256 * 15], from core/mc_tables.py

namespace {

constexpr int kSlots = 15;  // 3 * MAX_TRIS edge ids per case, -1 padded
constexpr int kMaxTris = 5;
constexpr int kTX = 8, kTY = 8;       // cell columns of a tile along x, y
constexpr int kPZ = 32;               // cell planes an item spans at most
constexpr int kBX = kTX + 1, kBY = kTY + 1;
constexpr int kCols = kBX * kBY;      // corner columns staged per item
constexpr int kColZ = kPZ + 1;        // corner planes a column holds
constexpr int kCellCols = kTX * kTY;
constexpr int kMaxParts = kPZ;        // partials an item makes (cz = 1)
constexpr int kMaxItemCells = kCellCols * kPZ + 31 * kMaxParts;  // parts 32-aligned
constexpr int kColBatch = 11;               // corner columns a warp loads at once (8 warps)
constexpr int kTopPer = (kCols + 31) / 32;  // plane-32 values a thread loads (32 threads)
constexpr int kMaxGroups = kMaxItemCells / 32;
constexpr int kFinalizeThreads = 512;
constexpr int kFinalizeBatch = 8;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTX == 8 && kTY == 8 && kPZ == 32, "cell decode by shifts, a warp a column");

struct Geometry {
  float iso;
  float sp[3];   // voxel spacing
  float org[3];  // centred origin of the whole volume
};

// The launch's shape: volumes (batch, nx, ny, nz) whose planes start at
// global cell plane kz0; cells at global planes >= kz_end are empty.
// Granules of cz planes; cz <= kPZ: an item spans `group` whole granules;
// cz > kPZ: a granule is nsub sub-slabs of kPZ planes, one an item.
struct Layout {
  int nx, ny, nz, cz, kz0, kz_end;
  int ngran, nsub, group, zgroups, tiles_x, tiles_y;
  int items;  // per case: tiles * zgroups
};

// Item r of a case: z-group fastest, so neighbouring items share the
// z-plane between them.  parts: its partials, each pp planes (the last
// shorter), part j of granule g0 + j (cz <= kPZ) or sub-slab s + j of
// granule g0.
struct Item {
  int tile, g0, s, x0, y0, kz, planes, pp, parts;
};

__device__ __forceinline__ Item decode(const Layout& L, int r) {
  Item it;
  it.tile = r / L.zgroups;
  const int q = r - it.tile * L.zgroups;
  it.x0 = (it.tile / L.tiles_y) * kTX;
  it.y0 = (it.tile % L.tiles_y) * kTY;
  if (L.nsub == 1) {
    it.g0 = q * L.group;
    it.s = 0;
    it.pp = L.cz;
    it.parts = min(L.group, L.ngran - it.g0);
    it.kz = it.g0 * L.cz;
    it.planes = it.parts * L.cz;
  } else {
    it.g0 = q / L.nsub;
    it.s = q - it.g0 * L.nsub;
    it.pp = kPZ;
    it.parts = 1;
    it.kz = it.g0 * L.cz + it.s * kPZ;
    it.planes = min(kPZ, L.cz - it.s * kPZ);
  }
  return it;
}

__device__ __forceinline__ float interp(float v0, float v1, float iso) {
  float den = v1 - v0;
  if (fabsf(den) < 1e-30f) den = 1.0f;
  return fminf(fmaxf((iso - v0) / den, 0.0f), 1.0f);
}

// Vertex on cube edge e of the cell at item position (ix, iy, iz): the grid
// edge along the edge's axis from its anchor (the cell origin plus the
// edge's offset); (gx, gy, gz) is the cell origin's global grid point.
__device__ __forceinline__ float3 edge_vertex(int e, const float* box, int ix, int iy, int iz,
                                              int gx, int gy, int gz, const Geometry& g) {
  const unsigned code = static_cast<unsigned>(kEdgeCode >> (5 * e)) & 31u;
  const int axis = code & 3, ox = (code >> 2) & 1, oy = (code >> 3) & 1, oz = (code >> 4) & 1;
  const float* p = box + ((ix + ox) * kBY + iy + oy) * kColZ + iz + oz;
  const int step = axis == 0 ? kBY * kColZ : (axis == 1 ? kColZ : 1);
  const float t = interp(p[0], p[step], g.iso);
  float px = (float)(gx + ox), py = (float)(gy + oy), pz = (float)(gz + oz);
  if (axis == 0) px += t;
  else if (axis == 1) py += t;
  else pz += t;
  return make_float3(px * g.sp[0] + g.org[0], py * g.sp[1] + g.org[1],
                     pz * g.sp[2] + g.org[2]);
}

// One triangle's area = 0.5 * sqrt(|ab x ac|^2 + 1e-30) and signed volume
// = a . (b x c) / 6, in the operation order of marching_cubes.py:151-155.
__device__ __forceinline__ void triangle(float3 a, float3 b, float3 c, float& vol,
                                         float& area) {
  const float abx = b.x - a.x, aby = b.y - a.y, abz = b.z - a.z;
  const float acx = c.x - a.x, acy = c.y - a.y, acz = c.z - a.z;
  const float nx = aby * acz - abz * acy;
  const float ny = abz * acx - abx * acz;
  const float nz = abx * acy - aby * acx;
  area = 0.5f * sqrtf(nx * nx + ny * ny + nz * nz + 1e-30f);
  const float bcx = b.y * c.z - b.z * c.y;
  const float bcy = b.z * c.x - b.x * c.z;
  const float bcz = b.x * c.y - b.y * c.x;
  vol = (a.x * bcx + a.y * bcy + a.z * bcz) / 6.0f;
}

// Lane 0 gets the halving tree y[:16] + y[16:] ... of the warp's values.
__device__ __forceinline__ void warp_tree(float& v, float& a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFull, v, off);
    a += __shfl_down_sync(kFull, a, off);
  }
}

struct Shared {
  signed char tri[256 * kSlots];  // first: 16-byte aligned for the table's copy
  float box[kCols * kColZ];       // corner values, column (bx, by) at (bx * 9 + by) * 33
  unsigned long long inside[kCols];  // bit z: corner plane z of the column > iso
  unsigned active[kCellCols];     // bit iz: cell (ix, iy, iz) is on the surface
  unsigned short list[kMaxItemCells];  // (cell column << 5) | iz
  unsigned char group_part[kMaxGroups];
  unsigned char ntri[256];
  float gsum[2][kMaxGroups];
  int part_start[kMaxParts + 1];  // the scan at each part's first unit
  int part_base[kMaxParts + 1];   // each part's first list slot (32-aligned)
  int warp_tot[32];
};

// Cube index of cell (ix, iy, iz) from the corner columns' inside bits, in
// mc_tables.CORNERS order.
__device__ __forceinline__ int cube_index(const Shared& sh, int ix, int iy, int iz) {
  const unsigned long long m00 = sh.inside[ix * kBY + iy] >> iz;
  const unsigned long long m10 = sh.inside[(ix + 1) * kBY + iy] >> iz;
  const unsigned long long m11 = sh.inside[(ix + 1) * kBY + iy + 1] >> iz;
  const unsigned long long m01 = sh.inside[ix * kBY + iy + 1] >> iz;
  return (int)((m00 & 1) | (m10 & 1) << 1 | (m11 & 1) << 2 | (m01 & 1) << 3 |
               (m00 >> 1 & 1) << 4 | (m10 >> 1 & 1) << 5 | (m11 >> 1 & 1) << 6 |
               (m01 >> 1 & 1) << 7);
}

// The surface cells of unit u = (part j, cell column c), u = j * 64 + c.
__device__ __forceinline__ unsigned unit_bits(const Shared& sh, const Item& m, int u) {
  const int j = u >> 6, c = u & 63;
  const int lo = j * m.pp, len = min(m.pp, m.planes - lo);
  return sh.active[c] & ((len >= 32 ? kFull : (1u << len) - 1u) << lo);
}

// A warp's batch of corner columns c0, c0 + nwarps, ... (kColBatch of them):
// lane z loads plane z of each (coalesced z-runs; z is the contiguous axis,
// so each voxel comes from device memory once), zeros past the volume or
// the item.
__device__ __forceinline__ void load_columns(float (&v)[kColBatch], int c0, int nwarps,
                                             const float* __restrict__ vol, const Layout& L,
                                             const Item& m) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kColBatch; ++k) {
    const int col = c0 + k * nwarps;
    const int x = m.x0 + col / kBY, y = m.y0 + col % kBY, z = m.kz + lane;
    v[k] = 0.0f;
    if (col < kCols && x < L.nx && y < L.ny && lane <= m.planes && z < L.nz)
      v[k] = __ldg(vol + ((size_t)x * L.ny + y) * L.nz + z);
  }
}

// Stores a batch of load_columns into the box; a ballot gives each
// column's inside bits for planes 0-31.
__device__ __forceinline__ void store_columns(Shared& sh, const float (&v)[kColBatch], int c0,
                                              int nwarps, float iso) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kColBatch; ++k) {
    const int col = c0 + k * nwarps;
    if (col < kCols) {  // the same for the whole warp
      sh.box[col * kColZ + lane] = v[k];
      const unsigned bits = __ballot_sync(kFull, v[k] > iso);
      if (lane == 0) sh.inside[col] = bits;
    }
  }
}

// Block blockIdx.x: the partials of flat item blockIdx.x of batch x items.
// partials: (batch, 2, ngran, nsub * tiles), volume then area.
__global__ void __launch_bounds__(1024)
    mc_partials_kernel(const float* __restrict__ vols, Layout L, float iso,
                       const float* __restrict__ geo, float* __restrict__ partials) {
  __shared__ __align__(16) Shared sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int it = blockIdx.x;
  const int b = it / L.items;
  const Item m = decode(L, it - b * L.items);
  const float* vol = vols + (size_t)b * L.nx * L.ny * L.nz;
  const float* box = sh.box;
  const float* gb = geo + 6 * (size_t)b;  // read now: its latency hides under the loads
  const Geometry g{iso, {gb[0], gb[1], gb[2]}, {gb[3], gb[4], gb[5]}};

  // 1. the item's loads first: its first batch of corner columns and
  //    plane 32 (a thread a column) in flight together, then the triangle
  //    table, as 16-byte words, while they land
  float v[kColBatch], v32[kTopPer];
  load_columns(v, warp, nwarps, vol, L, m);
  const bool top = m.planes == kPZ;  // plane 32 is a corner plane of the item
#pragma unroll
  for (int k = 0; k < kTopPer; ++k) {
    const int col = threadIdx.x + k * blockDim.x;
    const int x = m.x0 + col / kBY, y = m.y0 + col % kBY, z = m.kz + kPZ;
    v32[k] = 0.0f;
    if (top && col < kCols && x < L.nx && y < L.ny && z < L.nz)
      v32[k] = __ldg(vol + ((size_t)x * L.ny + y) * L.nz + z);
  }
  for (int q = threadIdx.x; q < 256 * kSlots / 16; q += blockDim.x)
    reinterpret_cast<uint4*>(sh.tri)[q] = reinterpret_cast<const uint4*>(kTriTable)[q];
  store_columns(sh, v, warp, nwarps, iso);
  for (int c0 = warp + nwarps * kColBatch; c0 < kCols; c0 += nwarps * kColBatch) {
    load_columns(v, c0, nwarps, vol, L, m);
    store_columns(sh, v, c0, nwarps, iso);
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 256; q += blockDim.x) {
    int nt = 0;
    while (nt < kMaxTris && sh.tri[q * kSlots + 3 * nt] >= 0) ++nt;
    sh.ntri[q] = (unsigned char)nt;
  }
#pragma unroll
  for (int k = 0; k < kTopPer; ++k) {
    const int col = threadIdx.x + k * blockDim.x;
    if (col < kCols) {
      sh.box[col * kColZ + kPZ] = v32[k];
      sh.inside[col] |= (unsigned long long)(v32[k] > iso) << kPZ;
    }
  }
  __syncthreads();

  // 2. the surface cells of each cell column: not all 8 corners on one side
  const int valid_planes = max(0, min(min(m.planes, L.nz - 1 - m.kz), L.kz_end - L.kz0 - m.kz));
  const unsigned plane_mask = valid_planes >= 32 ? kFull : (1u << valid_planes) - 1u;
  for (int c = threadIdx.x; c < kCellCols; c += blockDim.x) {
    const int ix = c >> 3, iy = c & 7;
    unsigned act = 0;
    if (m.x0 + ix < L.nx - 1 && m.y0 + iy < L.ny - 1) {
      const unsigned long long a = sh.inside[ix * kBY + iy], bq = sh.inside[(ix + 1) * kBY + iy],
                               cq = sh.inside[(ix + 1) * kBY + iy + 1],
                               d = sh.inside[ix * kBY + iy + 1];
      const unsigned long long any = a | bq | cq | d, all = a & bq & cq & d;
      act = (unsigned)((any | any >> 1) & ~(all & all >> 1)) & plane_mask;
    }
    sh.active[c] = act;
  }
  __syncthreads();

  // 3. a block scan of the surface cells over units u = (part, cell
  //    column), this thread's units [u0, u1) in order
  const int units = m.parts * kCellCols;
  const int per = (units + blockDim.x - 1) / blockDim.x;
  const int u0 = min((int)threadIdx.x * per, units), u1 = min(u0 + per, units);
  int mine = 0;
  for (int u = u0; u < u1; ++u) mine += __popc(unit_bits(sh, m, u));
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) sh.warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? sh.warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    if (lane < nwarps) sh.warp_tot[lane] = w;
  }
  __syncthreads();
  const int excl = (warp ? sh.warp_tot[warp - 1] : 0) + incl - mine;
  {
    int at = excl;
    for (int u = u0; u < u1; ++u) {
      if ((u & 63) == 0) sh.part_start[u >> 6] = at;
      at += __popc(unit_bits(sh, m, u));
    }
    if (threadIdx.x == 0) sh.part_start[m.parts] = sh.warp_tot[nwarps - 1];
  }
  __syncthreads();
  // each part's list starts at a multiple of 32: a warp's group is one part's
  if (threadIdx.x == 0) {
    int base = 0;
    for (int j = 0; j < m.parts; ++j) {
      sh.part_base[j] = base;
      const int n = sh.part_start[j + 1] - sh.part_start[j];
      for (int k = base >> 5; k < (base + n + 31) >> 5; ++k) sh.group_part[k] = (unsigned char)j;
      base += (n + 31) & ~31;
    }
    sh.part_base[m.parts] = base;
  }
  __syncthreads();

  // 4. the list: each part's surface cells in cell order (cell column, then z)
  {
    int at = excl;
    for (int u = u0; u < u1; ++u) {
      const int j = u >> 6, c = u & 63;
      int q = sh.part_base[j] + at - sh.part_start[j];
      for (unsigned bits = unit_bits(sh, m, u); bits; bits &= bits - 1, ++at)
        sh.list[q++] = (unsigned short)(c << 5 | (__ffs(bits) - 1));
    }
  }
  __syncthreads();

  // 5. 32 consecutive cells of one part a warp (a group); its triangles,
  //    in cell then table order, 32 a round, a lane each: a shuffle tree
  //    sums a round, and the group sum is the left fold of its rounds
  const int groups = sh.part_base[m.parts] >> 5;
  for (int k = warp; k < groups; k += nwarps) {
    const int j = sh.group_part[k];
    const int q = k * 32 + lane;
    int c = 0, iz = 0, idx = 0, nt = 0;
    if (q < sh.part_base[j] + sh.part_start[j + 1] - sh.part_start[j]) {
      const int e = sh.list[q];
      c = e >> 5;
      iz = e & 31;
      idx = cube_index(sh, c >> 3, c & 7, iz);
      nt = sh.ntri[idx];
    }
    int excl = nt;  // this lane's first triangle in the group
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, excl, off);
      if (lane >= off) excl += y;
    }
    const int total = __shfl_sync(kFull, excl, 31);
    excl -= nt;
    float gv = 0.0f, ga = 0.0f;
    for (int r0 = 0; r0 < total; r0 += 32) {
      const int qt = r0 + lane;
      // the cell of triangle qt: the last lane whose first triangle is <= qt
      int src = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kFull, excl, src + step) <= qt) src += step;
      const int sc = __shfl_sync(kFull, c, src), sz = __shfl_sync(kFull, iz, src);
      const int sidx = __shfl_sync(kFull, idx, src);
      const int t = qt - __shfl_sync(kFull, excl, src);
      float v = 0.0f, a = 0.0f;
      if (qt < total) {
        const int ix = sc >> 3, iy = sc & 7;
        const int gx = m.x0 + ix, gy = m.y0 + iy, gz = L.kz0 + m.kz + sz;
        const signed char* row = sh.tri + sidx * kSlots + 3 * t;
        triangle(edge_vertex(row[0], box, ix, iy, sz, gx, gy, gz, g),
                 edge_vertex(row[1], box, ix, iy, sz, gx, gy, gz, g),
                 edge_vertex(row[2], box, ix, iy, sz, gx, gy, gz, g), v, a);
      }
      warp_tree(v, a);
      gv += v;
      ga += a;
    }
    if (lane == 0) {
      sh.gsum[0][k] = gv;
      sh.gsum[1][k] = ga;
    }
  }
  __syncthreads();

  // 6. a warp a part: lane l folds the part's groups l, l + 32, ... in
  //    order, then a tree; (volume, area) at (granule, sub-slab x tile)
  const int tiles = L.tiles_x * L.tiles_y;
  const size_t nparts = (size_t)tiles * L.ngran * L.nsub;
  for (int j = warp; j < m.parts; j += nwarps) {
    const int k0 = sh.part_base[j] >> 5, k1 = sh.part_base[j + 1] >> 5;
    float v = 0.0f, a = 0.0f;
    for (int k = k0 + lane; k < k1; k += 32) {
      v += sh.gsum[0][k];
      a += sh.gsum[1][k];
    }
    warp_tree(v, a);
    if (lane == 0) {
      const int gran = m.g0 + (L.nsub == 1 ? j : 0);
      const size_t at_p = ((size_t)gran * L.nsub + m.s) * tiles + m.tile;
      partials[2 * nparts * b + at_p] = v;
      partials[2 * nparts * b + nparts + at_p] = a;
    }
  }
}

// Case blockIdx.x: sums its nparts volume and nparts area partials in a
// fixed order (thread t takes t, t + blockDim.x, ... then the block tree),
// then (|volume|, area).  Case b's partials start at vol_p + b * stride and
// area_p + b * stride.
__global__ void __launch_bounds__(kFinalizeThreads)
    mc_finalize_kernel(const float* __restrict__ vol_p, const float* __restrict__ area_p,
                       long long stride, int nparts, float* __restrict__ out) {
  const size_t b = blockIdx.x;
  const float* pv = vol_p + stride * b;
  const float* pa = area_p + stride * b;
  float acc[2] = {0.0f, 0.0f};
  int q = threadIdx.x;
  // kFinalizeBatch of a thread's partials loaded at once, added in order
  for (; q + (kFinalizeBatch - 1) * (int)blockDim.x < nparts; q += kFinalizeBatch * blockDim.x) {
    float v[kFinalizeBatch], a[kFinalizeBatch];
#pragma unroll
    for (int k = 0; k < kFinalizeBatch; ++k) {
      v[k] = pv[q + k * blockDim.x];
      a[k] = pa[q + k * blockDim.x];
    }
#pragma unroll
    for (int k = 0; k < kFinalizeBatch; ++k) {
      acc[0] += v[k];
      acc[1] += a[k];
    }
  }
  for (; q < nparts; q += blockDim.x) {
    acc[0] += pv[q];
    acc[1] += pa[q];
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
// planes >= kz_end are empty.  ngran granules of cz planes, ppg parts per
// granule (kernels/marching_cubes.py layout: sub-slabs x tiles; refused
// unless it matches), `threads` a block.  geo: (batch, 6) float32
// [spacing, centred origin of the whole volume] per case.  partials:
// (batch, 2, ngran, ppg).  Launches on `stream`, does not wait.
int mc_slab_partials_launch(const float* vols, int batch, int nx, int ny, int nz, int cz,
                            int kz0, int kz_end, float iso, const float* geo, int ngran,
                            int ppg, int threads, float* partials, void* stream) {
  Layout L;
  L.nx = nx, L.ny = ny, L.nz = nz, L.cz = cz, L.kz0 = kz0, L.kz_end = kz_end;
  L.ngran = ngran;
  L.nsub = (cz + kPZ - 1) / kPZ;
  L.group = L.nsub == 1 ? kPZ / cz : 1;
  L.zgroups = L.nsub == 1 ? (ngran + L.group - 1) / L.group : ngran * L.nsub;
  L.tiles_x = nx > 1 ? (nx - 1 + kTX - 1) / kTX : 1;
  L.tiles_y = ny > 1 ? (ny - 1 + kTY - 1) / kTY : 1;
  if (cz < 1 || ngran < 1 || threads % 32 || threads < 32 || threads > 1024 ||
      ppg != L.nsub * L.tiles_x * L.tiles_y)
    return cudaErrorInvalidValue;
  L.items = L.tiles_x * L.tiles_y * L.zgroups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mc_partials_kernel<<<batch * L.items, threads, 0, s>>>(vols, L, iso, geo, partials);
  return cudaGetLastError();
}

// vol_p, area_p: nparts partials each, one case -> out: (2,) [|volume|, area].
int mc_finalize_launch(const float* vol_p, const float* area_p, int nparts, float* out,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mc_finalize_kernel<<<1, kFinalizeThreads, 0, s>>>(vol_p, area_p, 0, nparts, out);
  return cudaGetLastError();
}

// Whole volumes: the partials of every item, then the finalize.
// partials: (batch, 2, ngran, ppg) scratch; out: (batch, 2).
int mc_volume_area_launch(const float* vols, int batch, int nx, int ny, int nz, int cz,
                          float iso, const float* geo, int ngran, int ppg, int threads,
                          float* partials, float* out, void* stream) {
  int err = mc_slab_partials_launch(vols, batch, nx, ny, nz, cz, 0, nz - 1, iso, geo, ngran,
                                    ppg, threads, partials, stream);
  if (err != cudaSuccess) return err;
  const int nparts = ngran * ppg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mc_finalize_kernel<<<batch, kFinalizeThreads, 0, s>>>(partials, partials + nparts,
                                                        2LL * nparts, nparts, out);
  return cudaGetLastError();
}

}  // extern "C"
