// EmbeddingBag: a row gather with a reduction over each bag.
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py::embedding_bag_pallas:
//
//   out[b, :] = sum over l of table[idx[b, l], :]     (ids < 0 skipped)
//   mode mean: the sum divided by L (pads counted, a fixed-length bag)
//
// with table[R, D] f32 or bf16, idx[B, L] int32, out[B, D] in the table's
// dtype.  An id >= R reads row R - 1, as in the plain version.  The sum
// accumulates in f32 in bag order (j = 0 .. L-1, pads skipped) and is
// rounded to the table's dtype once, at the store: a sequential bag-order
// sum, the same bits on every launch.
//
// What bounds it on Hopper: bytes.  It reads a row of D values per valid
// id and writes one row per bag; one add per value read.  The bound counts
// each distinct row once, but the kernel reads every id's row: at the DLRM
// shape (65,536 bags x 26 ids, D 128, zipf ids) 5.2 times the bound's
// bytes pass from L2 or L1 to the SMs.  The Pallas kernel DMAs one row per
// grid step with scalar-prefetched ids.  The probe of `chip_smoke.py
// --kernel-compare` (PERF.md §6) times three id draws at that shape: ids
// that all name one row (every read an L1 hit after the first) take about
// half the time of the zipf draw, and uniform ids (no reuse) run near the
// device-memory rate.  So the zipf draw sits between the L1 floor and the
// misses to L2 and device memory, and L1 already serves the hot rows.
// What helps is many row loads in flight per SM and few instructions a
// row:
//
// - A group of G lanes owns a bag, each lane a 16-byte piece of the row
//   (float4 for f32, 8 x bf16), G the smallest power of two covering the
//   row, at most a warp (f32 D 128: a warp a bag; bf16 D 128: half a warp,
//   so no lane idles); a wider row takes several passes.  Where D or the
//   table's or the output's address does not allow 16-byte pieces, a lane
//   takes one value.
// - Lane j of the group loads id j of the bag (one coalesced load per G
//   ids) and the lanes take each id from it with a shuffle; a pad or a
//   finished row masks the load and the add instead of branching.
// - One id a step and __launch_bounds__(256, 8): 32 registers a thread, so
//   8 blocks (64 warps) stay resident on each SM, and the SM keeps up to 64
//   row loads in flight.  In trials on the H100, issuing the loads of
//   several ids before their adds needed 48 registers or more and lost more
//   to the lower occupancy than it gained, and a shared-memory cache of hot
//   rows lost to the L1 it displaced.
// - One block per 8 warps of bags, every warp one step of bags.  A grid of
//   one resident wave striding over the bags was slower in trials: it
//   fixes each warp's share of bags, while the block scheduler hands the
//   next blocks to the SMs whose bags' rows hit.
// - The output is stored with the streaming hint (written once, never read
//   here), so it does not push reused rows out of L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 8;  // 2,048 resident threads an SM / 256
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// What one lane reads of a row and adds: a 16-byte piece (VEC) or one
// value.
template <typename T, bool VEC>
struct Piece {
  static constexpr int n = 1;
  using Raw = T;
  __device__ static Raw load(const T* p) { return __ldg(p); }
  __device__ static void add(const Raw r, float* acc) { acc[0] += to_f32(r); }
  __device__ static void store(T* p, const float* v) { store_one(p, v[0]); }
};

template <>
struct Piece<float, true> {
  static constexpr int n = 4;
  using Raw = uint4;
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void add(const Raw r, float* acc) {
    acc[0] += __uint_as_float(r.x);
    acc[1] += __uint_as_float(r.y);
    acc[2] += __uint_as_float(r.z);
    acc[3] += __uint_as_float(r.w);
  }
  __device__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3])));
  }
};

template <>
struct Piece<__nv_bfloat16, true> {
  static constexpr int n = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void add(const Raw r, float* acc) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), raw);
  }
};

// A group of 1 << glog2 lanes a bag, 32 >> glog2 bags a warp; every lane
// of a warp runs the same pass and id loops (the shuffles need the whole
// warp).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
embedding_bag_kernel(const T* __restrict__ table, int r, int d,
                     const int32_t* __restrict__ idx, int b, int l, int mean,
                     int glog2, T* __restrict__ out) {
  using P = Piece<T, VEC>;
  constexpr int V = P::n;
  const int g = 1 << glog2;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (g - 1);
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long bag = (warp << (5 - glog2)) + (lane >> glog2);
  const bool live = bag < b;
  const int32_t* ids = idx + bag * (long long)l;
  for (int p0 = 0; p0 < d; p0 += g * V) {
    const int d0 = p0 + gl * V;
    const bool on = live && d0 < d;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int j0 = 0; j0 < l; j0 += g) {
      int mine = -1;
      if (live && j0 + gl < l) mine = __ldg(ids + j0 + gl);
      if (mine >= r) mine = r - 1;
      const int n = min(g, l - j0);
      for (int j = 0; j < n; ++j) {
        const int id = __shfl_sync(kFull, mine, j, g);
        if (on && id >= 0) P::add(P::load(table + (long long)id * d + d0), acc);
      }
    }
    if (on) {
      if (mean) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] /= (float)l;
      }
      P::store(out + bag * (long long)d + d0, acc);
    }
  }
}

template <typename T, bool VEC>
int launch_as(const T* table, int r, int d, const int32_t* idx, int b, int l,
              int mean, T* out, cudaStream_t stream) {
  const int pieces = d / Piece<T, VEC>::n;  // VEC only where n divides d
  int glog2 = 0;
  while (glog2 < 5 && (1 << glog2) < pieces) ++glog2;
  const long long bags_per_block = (long long)kWarps << (5 - glog2);
  const long long blocks = ((long long)b + bags_per_block - 1) / bags_per_block;
  embedding_bag_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      table, r, d, idx, b, l, mean, glog2, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* table, int r, int d, const void* idx, int b, int l,
           int mean, void* out, cudaStream_t stream) {
  constexpr int V = Piece<T, true>::n;
  const bool vec = (d % V == 0) && ((uintptr_t)table % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (vec)
    return launch_as<T, true>((const T*)table, r, d, (const int32_t*)idx, b,
                              l, mean, (T*)out, stream);
  return launch_as<T, false>((const T*)table, r, d, (const int32_t*)idx, b,
                             l, mean, (T*)out, stream);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  mean: 0 = sum, 1 = mean.
extern "C" int embedding_bag_launch(const void* table, int r, int d,
                                    const void* idx, int b, int l, int dtype,
                                    int mean, void* out, void* stream) {
  if (r <= 0 || d <= 0 || b <= 0 || l <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(table, r, d, idx, b, l, mean, out,
                         (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, r, d, idx, b, l, mean, out,
                                 (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
