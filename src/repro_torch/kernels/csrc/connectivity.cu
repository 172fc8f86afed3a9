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
// What bounds it on Hopper: bytes.  The pin matrix is read once (13 MB at
// ibm08's 50,688 x 64, more than a quarter of L2, so from device memory);
// the partition (4 bytes a vertex) is gathered per valid pin and stays in
// L2; per edge there are a handful of integer operations, and no float
// work except the cut's one add per cut edge.  The Pallas kernel keeps the
// partition whole in VMEM and ORs a lane axis of pins.  The work per byte
// is tiny, so what counts here is how many bytes each SM has in flight.
//
// Design.  A group of G lanes owns a row, with V ids a lane: V = 4 (one
// 16-byte load) when S is a multiple of 4 and the pins are 16-byte
// aligned, else V = 1; G is the smallest power of two that covers the row
// in one round of G * V slots, at most 32 (S = 64: 16 lanes, 2 rows a
// warp; S = 8: 2 lanes; S = 256: 32 lanes in 2 rounds).  Each group takes
// kRows rows a step and issues all of their pin loads before its first
// gather; it gathers `part` only for the valid ids, through the read-only
// path, and ORs its lanes' masks in log2 G shuffles (a whole-warp
// __reduce_or_sync would mix rows when G < 32).  Two rows a step: on the
// H100 one row was slower with the pins in L2, and four spilled under the
// 32-register cap (the cut kernel then ran a quarter slower).  The grid is
// at most one resident wave (132 SMs x 8 blocks of 256 threads, held to 32
// registers by __launch_bounds__) with a grid-stride loop beyond it; the
// caller sizes it from (M, S) alone (repro_torch/kernels/common.py::
// conn_grid).
//
// The cut needs a sum across blocks, which the TPU's sequential grid got
// for free.  Without float atomics: each group adds the weights of its cut
// rows in row order, each warp adds its groups in a fixed tree and each
// block its warps in order, and writes one partial; the last block to
// finish (an integer ticket) adds the partials in the same fixed way (each
// thread a strided run in order, a shuffle tree per warp, the warps in
// order) and resets the ticket.  The grid and the path depend on the operands alone, so the
// order of every addition does: reruns (and CUDA-graph replays) are
// bit-identical, and integer weights (exact in any order below 2**24)
// give the plain version's value exactly.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;         // common.py: CONN_BLOCK_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 8;         // common.py: CONN_BLOCKS_PER_SM
constexpr int kRows = 2;              // common.py: CONN_ROWS
constexpr unsigned kFull = 0xffffffffu;

// V ids a lane per round.
template <int V> struct Ids;
template <> struct Ids<1> {
  using T = int;
  __device__ static T load(const int32_t* p) { return *p; }
  __device__ static T none() { return -1; }
  __device__ static int get(const T& e, int) { return e; }
};
template <> struct Ids<4> {
  using T = int4;
  __device__ static T load(const int32_t* p) {
    return *reinterpret_cast<const int4*>(p);
  }
  __device__ static T none() { return make_int4(-1, -1, -1, -1); }
  __device__ static int get(const T& e, int i) {
    return i == 0 ? e.x : i == 1 ? e.y : i == 2 ? e.z : e.w;
  }
};

// The block masks of rows row0 + r * stride (r < kRows), owned by this
// lane's group of G lanes (gl: the lane's place in it); every lane of the
// group ends with them.  Rows >= m read nothing and give 0.  Every lane of
// the warp must call it (the shuffles take the whole warp).
template <int V, int G>
__device__ __forceinline__ void row_masks(
    const int32_t* __restrict__ pins, unsigned m, int s,
    const int32_t* __restrict__ part, int n, int k, unsigned row0,
    unsigned stride, int gl, unsigned (&mask)[kRows]) {
  using I = Ids<V>;
#pragma unroll
  for (int r = 0; r < kRows; ++r) mask[r] = 0u;
  for (int j0 = 0; j0 < s; j0 += G * V) {
    const int j = j0 + gl * V;  // j < s means all V slots are in the row
    typename I::T ids[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const unsigned row = row0 + r * stride;
      ids[r] = row < m && j < s ? I::load(pins + row * s + j) : I::none();
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int v = I::get(ids[r], i);
        const int b = v >= 0 ? __ldg(part + (v < n ? v : n - 1)) : -1;
        if ((unsigned)b < (unsigned)k) mask[r] |= 1u << b;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
      mask[r] |= __shfl_xor_sync(kFull, mask[r], off);
  }
}

// The rows of a warp's steps: in a step, rows base + r * (32 / G) + its
// group, r < kRows, so the loads of one r cover 32 / G consecutive rows.
// `first` is the warp's first row, the same in all its lanes, so a loop
// bounded by it keeps the warp together for the shuffles.  Rows and pin
// offsets are 32-bit (the caller keeps M * S below 2**31; a step past M
// stays below 2**32).
template <int G>
struct Walk {
  static constexpr int kGroups = 32 / G;
  static constexpr int kStep = kGroups * kRows;
  int lane, gl;  // gl: the lane's place in its group
  unsigned first, stride;
  __device__ Walk()
      : lane(threadIdx.x & 31), gl(lane % G),
        first((blockIdx.x * kWarps + (threadIdx.x >> 5)) * kStep),
        stride(gridDim.x * kWarps * kStep) {}
};

// Lane 0 gets the sum of lanes 0, G, 2G, ... of the warp, in a fixed tree
// (lane 0 + lane G, then + the pair of 2G and 3G, ...).
template <int G>
__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int off = G; off < 32; off <<= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

template <int V, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
connectivity_kernel(const int32_t* __restrict__ pins, unsigned m, int s,
                    const int32_t* __restrict__ part, int n, int k,
                    int32_t* __restrict__ lam) {
  const Walk<G> at;
  for (unsigned w0 = at.first; w0 < m; w0 += at.stride) {
    const unsigned row0 = w0 + at.lane / G;
    unsigned mask[kRows];
    row_masks<V, G>(pins, m, s, part, n, k, row0, at.kGroups, at.gl, mask);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const unsigned row = row0 + r * at.kGroups;
      if (at.gl == 0 && row < m) lam[row] = __popc(mask[r]);
    }
  }
}

template <int V, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cutsize_kernel(const int32_t* __restrict__ pins, unsigned m, int s,
               const int32_t* __restrict__ part, int n, int k,
               const float* __restrict__ w, float* __restrict__ partials,
               unsigned* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float warp_sum[kWarps];
  __shared__ bool last;
  const Walk<G> at;
  float acc = 0.f;  // meaningful in a group's lane 0: its rows, in order
  for (unsigned w0 = at.first; w0 < m; w0 += at.stride) {
    const unsigned row0 = w0 + at.lane / G;
    float wr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const unsigned row = row0 + r * at.kGroups;
      wr[r] = at.gl == 0 && row < m ? __ldg(w + row) : 0.f;
    }
    unsigned mask[kRows];
    row_masks<V, G>(pins, m, s, part, n, k, row0, at.kGroups, at.gl, mask);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (__popc(mask[r]) > 1) acc += wr[r];
  }
  // the warp's groups in a fixed tree: lane 0 gets lane G's, 2G's, ...
  acc = warp_tree<G>(acc);
  if (at.lane == 0) warp_sum[threadIdx.x >> 5] = acc;
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
  // then a fixed tree over each warp's lanes, then the warps in order
  float t = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads)
    t += ((volatile float*)partials)[i];
  t = warp_tree<1>(t);
  if (at.lane == 0) warp_sum[threadIdx.x >> 5] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int i = 0; i < kWarps; ++i) c += warp_sum[i];
    *out = c;
    *ticket = 0u;  // ready for the next launch on the same buffer
  }
}

struct Args {
  const int32_t* pins;
  int m, s;
  const int32_t* part;
  int n, k;
  int32_t* lam;        // connectivity
  const float* w;      // cut
  float* partials;
  unsigned* ticket;
  float* out;
  int blocks;
  cudaStream_t stream;
};

// G: the smallest power of two from G up with G * V >= S, or 32.
template <int V, int G = 1>
int launch(const Args& a, bool cut) {
  if constexpr (G < 32) {
    if (G * V < a.s) return launch<V, 2 * G>(a, cut);
  }
  if (cut)
    cutsize_kernel<V, G><<<a.blocks, kThreads, 0, a.stream>>>(
        a.pins, a.m, a.s, a.part, a.n, a.k, a.w, a.partials, a.ticket,
        a.out);
  else
    connectivity_kernel<V, G><<<a.blocks, kThreads, 0, a.stream>>>(
        a.pins, a.m, a.s, a.part, a.n, a.k, a.lam);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, bool cut) {
  if (a.m <= 0 || a.s <= 0 || (long long)a.m * a.s >= (1LL << 31) ||
      a.n <= 0 || a.k <= 0 || a.k > 32 || a.blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (a.s % 4 == 0 && (uintptr_t)a.pins % 16 == 0) return launch<4>(a, cut);
  return launch<1>(a, cut);
}

}  // namespace

// blocks: the grid, at most one resident wave (common.py::conn_grid).
extern "C" int connectivity_launch(const void* pins, int m, int s,
                                   const void* part, int n, int k, void* lam,
                                   int blocks, void* stream) {
  Args a{(const int32_t*)pins, m, s, (const int32_t*)part, n, k,
         (int32_t*)lam, nullptr, nullptr, nullptr, nullptr, blocks,
         (cudaStream_t)stream};
  return dispatch(a, false);
}

// Scratch of a cut launch of `blocks` blocks: partials holds
// cutsize_partials(blocks) floats; ticket is one unsigned that must arrive
// zeroed (the kernel leaves it zeroed).
extern "C" int cutsize_partials(int blocks) { return blocks; }

extern "C" int cutsize_launch(const void* pins, int m, int s,
                              const void* part, int n, int k, const void* w,
                              void* partials, void* ticket, void* out,
                              int blocks, void* stream) {
  Args a{(const int32_t*)pins, m, s, (const int32_t*)part, n, k, nullptr,
         (const float*)w, (float*)partials, (unsigned*)ticket, (float*)out,
         blocks, (cudaStream_t)stream};
  return dispatch(a, true);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
