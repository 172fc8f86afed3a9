// Hyperedge connectivity and cut size from a padded pin matrix.
//
// Replaces the TPU kernels repro/kernels/connectivity.py::connectivity_pallas
// and ::cutsize_pallas:
//
//   lambda[e] = popcount(OR over the valid pins v of e of 1u << part[v])
//   cut       = sum of w[e] over the edges with lambda[e] > 1
//
// with pins[M, S] int32 (pad = -1), part[N] int32 and k <= 32 blocks (one
// bit of a uint32 mask per block).  A pin id >= N reads part[N - 1], and a
// block id outside [0, k) sets no bit, as in the plain version.
//
// What bounds it on Hopper: bytes.  Per pin it reads 4 bytes of the pin
// matrix and gathers 4 bytes of the partition (which stays in L2), and per
// edge it does a handful of integer operations; there is no float work
// except the cut's one add per cut edge.  The Pallas kernel keeps the
// partition whole in VMEM and ORs a lane axis of pins; here one warp owns
// one edge at a time, its lanes read consecutive pins (coalesced 128-byte
// rows), and the warp's masks meet in one __reduce_or_sync.
//
// The cut needs a sum across blocks, which the TPU's sequential grid got
// for free.  Without float atomics: every warp adds the contributions of
// its edges in edge order, each block adds its 8 warps in warp order and
// writes one partial, and the last block to finish (an integer ticket)
// adds the partials in a fixed tree.  The grid depends on M alone, so the
// order of every addition depends on M alone: reruns are bit-identical,
// and integer weights (exact in any order below 2**24) give the plain
// version's value exactly.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;              // warps of one block
constexpr int kThreads = 32 * kWarps;

// The block mask of edge e, reduced over the warp (every lane gets it).
__device__ __forceinline__ unsigned edge_mask(const int32_t* __restrict__ pins,
                                              long long e, int s,
                                              const int32_t* __restrict__ part,
                                              int n, int k, int lane) {
  unsigned mask = 0u;
  const int32_t* row = pins + e * (long long)s;
  for (int j = lane; j < s; j += 32) {
    const int v = row[j];
    if (v >= 0) {
      const int b = part[v < n ? v : n - 1];
      if (b >= 0 && b < k) mask |= 1u << b;
    }
  }
  return __reduce_or_sync(0xffffffffu, mask);
}

__global__ void connectivity_kernel(const int32_t* __restrict__ pins, int m,
                                    int s, const int32_t* __restrict__ part,
                                    int n, int k, int32_t* __restrict__ lam) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long e = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       e < m; e += warps) {
    const unsigned mask = edge_mask(pins, e, s, part, n, k, lane);
    if (lane == 0) lam[e] = __popc(mask);
  }
}

__global__ void cutsize_kernel(const int32_t* __restrict__ pins, int m, int s,
                               const int32_t* __restrict__ part, int n, int k,
                               const float* __restrict__ w,
                               float* __restrict__ partials,
                               unsigned* __restrict__ ticket,
                               float* __restrict__ out) {
  __shared__ float warp_sum[kWarps];
  __shared__ float tree[kThreads];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warps = (long long)gridDim.x * kWarps;
  float acc = 0.f;  // meaningful in lane 0: the warp's edges, in order
  for (long long e = (long long)blockIdx.x * kWarps + warp; e < m;
       e += warps) {
    const unsigned mask = edge_mask(pins, e, s, part, n, k, lane);
    if (__popc(mask) > 1) acc += w[e];
  }
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.f;
    for (int i = 0; i < kWarps; ++i) b += warp_sum[i];
    partials[blockIdx.x] = b;
    __threadfence();  // the partial is visible before the ticket says so
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: thread t adds partials t, t + kThreads, ... in order,
  // then a fixed tree over the threads
  __threadfence();
  float t = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads)
    t += ((volatile float*)partials)[i];
  tree[threadIdx.x] = t;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) tree[threadIdx.x] += tree[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *out = tree[0];
    *ticket = 0u;  // ready for the next launch on the same buffer
  }
}

// Blocks of the cut kernel for m edges: one warp per edge up to 132 SMs x
// 16 blocks, a grid-stride loop beyond.  A function of m alone.
int cut_blocks(int m) {
  const int want = (m + kWarps - 1) / kWarps;
  const int cap = 132 * 16;
  return want < 1 ? 1 : (want > cap ? cap : want);
}

}  // namespace

extern "C" int connectivity_launch(const void* pins, int m, int s,
                                   const void* part, int n, int k, void* lam,
                                   void* stream) {
  if (m <= 0 || s <= 0 || n <= 0 || k <= 0 || k > 32)
    return (int)cudaErrorInvalidValue;
  long long blocks = ((long long)m + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  connectivity_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pins, m, s, (const int32_t*)part, n, k, (int32_t*)lam);
  return (int)cudaGetLastError();
}

// Scratch: partials holds cutsize_partials(m) floats; ticket is one
// unsigned that must arrive zeroed (the kernel leaves it zeroed).
extern "C" int cutsize_partials(int m) { return cut_blocks(m); }

extern "C" int cutsize_launch(const void* pins, int m, int s,
                              const void* part, int n, int k, const void* w,
                              void* partials, void* ticket, void* out,
                              void* stream) {
  if (m <= 0 || s <= 0 || n <= 0 || k <= 0 || k > 32)
    return (int)cudaErrorInvalidValue;
  cutsize_kernel<<<cut_blocks(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pins, m, s, (const int32_t*)part, n, k,
      (const float*)w, (float*)partials, (unsigned*)ticket, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
