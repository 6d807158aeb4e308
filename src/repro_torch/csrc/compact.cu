// Stable segmented compaction of a batch of vertex lists: for each case b,
// the vertices whose keep flag is set land in order in slots 0..n-1 of a
// cap-slot output, slots from min(n, cap) on hold zeros and a False mask,
// survivors past cap are dropped, and n counts every survivor.
//
// Replaces the TPU kernel repro/kernels/compact.py::_compact_kernel
// (compact_batch_pallas).  It computes the same function, not the same
// way: the TPU scattered each block's survivors with a one-hot matmul on
// its matrix unit (no per-element dynamic stores there) and carried the
// running offset in SMEM across a case's sequential grid steps.  Here a
// store to any address is cheap, so each survivor is written straight to
// its slot.
//
// Bound on the H100: device memory.  Each input flag is read once (1
// byte), a vertex (12 bytes) only where it survives below cap, and each
// output slot is written once (12 + 1 bytes).  The design is the
// simple one: one block per case walks the case's M slots in chunks of
// blockDim; a warp ballot and popc rank each survivor inside its warp, a
// scan of the per-warp counts ranks the warps, and a running base carries
// the count from chunk to chunk.  With one block per case a small batch
// leaves most SMs idle; splitting a case over several blocks (a decoupled
// look-back scan) is the next step if the card's numbers call for it.
//
// The output is an exact copy of input bits, so the kernel equals the
// plain version (kernels/ref.py compact_batch) bitwise.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(1024)
    compact_kernel(const float* __restrict__ verts, const unsigned char* __restrict__ keep,
                   int m, int cap, float* __restrict__ out, unsigned char* __restrict__ out_mask,
                   int* __restrict__ count) {
  __shared__ int warp_counts[32];
  __shared__ int s_base;
  const size_t b = blockIdx.x;
  const float* v = verts + b * m * 3;
  const unsigned char* k = keep + b * m;
  float* o = out + b * cap * 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) s_base = 0;

  // The trip count is the same for every thread, so the barriers are safe.
  for (int start = 0; start < m; start += blockDim.x) {
    const int i = start + threadIdx.x;
    const bool kept = i < m && k[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, kept);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();  // warp counts and s_base are visible
    int slot = s_base + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) slot += warp_counts[w];
    int next = 0;
    if (threadIdx.x == 0) {
      next = s_base;
      for (int w = 0; w < nwarps; ++w) next += warp_counts[w];
    }
    if (kept && slot < cap) {
      o[3 * (size_t)slot] = v[3 * (size_t)i];
      o[3 * (size_t)slot + 1] = v[3 * (size_t)i + 1];
      o[3 * (size_t)slot + 2] = v[3 * (size_t)i + 2];
    }
    __syncthreads();  // every read of warp_counts and s_base is done
    if (threadIdx.x == 0) s_base = next;
  }
  __syncthreads();
  const int n = s_base;
  const int filled = n < cap ? n : cap;
  for (int s = filled + threadIdx.x; s < cap; s += blockDim.x) {
    o[3 * (size_t)s] = 0.0f;
    o[3 * (size_t)s + 1] = 0.0f;
    o[3 * (size_t)s + 2] = 0.0f;
  }
  for (int s = threadIdx.x; s < cap; s += blockDim.x) out_mask[b * cap + s] = s < filled;
  if (threadIdx.x == 0) count[b] = n;
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// verts: (batch, m, 3) float32, keep: (batch, m) bool (one byte each), both
// C order on the device.  out: (batch, cap, 3) float32, out_mask: (batch,
// cap) bool, count: (batch,) int32.  threads: a multiple of 32 up to 1024.
// Launches on `stream`, does not wait.
int compact_batch_launch(const float* verts, const unsigned char* keep, int batch, int m,
                         int cap, float* out, unsigned char* out_mask, int* count, int threads,
                         void* stream) {
  compact_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      verts, keep, m, cap, out, out_mask, count);
  return cudaGetLastError();
}

}  // extern "C"
