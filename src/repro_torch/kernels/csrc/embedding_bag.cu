// EmbeddingBag: a row gather with a reduction over each bag.
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py::embedding_bag_pallas:
//
//   out[b, :] = sum over l of table[idx[b, l], :]     (ids < 0 skipped)
//   mode mean: the sum divided by L (pads counted, a fixed-length bag)
//
// with table[R, D] f32 or bf16, idx[B, L] int32, out[B, D] in the table's
// dtype.  An id >= R reads row R - 1, as in the plain version.  The sum
// accumulates in f32 in bag order and is rounded to the table's dtype once,
// at the store.
//
// What bounds it on Hopper: bytes.  It reads L rows of D values per bag and
// writes one; one add per value read.  The Pallas kernel DMAs one row per
// grid step with scalar-prefetched ids and revisits the output block L
// times; here one warp owns one bag: every lane reads the bag's ids (one
// broadcast transaction each), and the lanes split the row into 16-byte
// pieces (float4 for f32, 8 x bf16), so each row is read as whole 128-byte
// lines.  Where D or the table's address does not allow 16-byte pieces,
// the lanes take one value each.  The rows a bag reads depend on the data,
// so nothing is staged in shared memory; hot rows (skewed ids) stay in L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

template <typename T>
struct Vec;  // VEC values of T as one 16-byte load

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float* acc) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] += v.x; acc[1] += v.y; acc[2] += v.z; acc[3] += v.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float* acc) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
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
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One warp per bag; `vec` selects the 16-byte path (D % VEC == 0 and a
// 16-byte-aligned table and output).
template <typename T>
__global__ void embedding_bag_kernel(const T* __restrict__ table, int r,
                                     int d, const int32_t* __restrict__ idx,
                                     int b, int l, int mean, int vec,
                                     T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long bag = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= b) return;
  const int32_t* ids = idx + bag * (long long)l;
  T* dst = out + bag * (long long)d;
  if (vec) {
    constexpr int V = Vec<T>::n;
    for (int d0 = lane * V; d0 < d; d0 += 32 * V) {
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      for (int j = 0; j < l; ++j) {
        int id = ids[j];
        if (id < 0) continue;
        if (id >= r) id = r - 1;
        Vec<T>::load(table + (long long)id * d + d0, acc);
      }
      if (mean) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] /= (float)l;
      }
      Vec<T>::store(dst + d0, acc);
    }
  } else {
    for (int d0 = lane; d0 < d; d0 += 32) {
      float acc = 0.f;
      for (int j = 0; j < l; ++j) {
        int id = ids[j];
        if (id < 0) continue;
        if (id >= r) id = r - 1;
        acc += to_f32(table[(long long)id * d + d0]);
      }
      if (mean) acc /= (float)l;
      store_one(dst + d0, acc);
    }
  }
}

template <typename T>
int launch(const void* table, int r, int d, const void* idx, int b, int l,
           int mean, void* out, cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  const int vec = (d % V == 0) && ((uintptr_t)table % 16 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  const long long blocks = ((long long)b + kWarps - 1) / kWarps;
  embedding_bag_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)table, r, d, (const int32_t*)idx, b, l, mean, vec, (T*)out);
  return (int)cudaGetLastError();
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
