// Population gain assembly for the LP refinement tier.
//
// Replaces the TPU kernels repro/kernels/gain.py::gain_gather_batch_pallas
// (entry point "table") and ::gain_stream_batch_pallas (entry point
// "stream").  Both compute, for every member a and vertex v,
//
//   out[a, v, j] = sum_d bi[a, inc[v, d], j] - sum_d wi[a, inc[v, d]]
//
// over the shared dense incidence rows inc[N, D] (pad -1 skipped) and the
// member's per-edge tables bi[alpha, M, k], wi[alpha, M] (f32).
//
// What bounds it on Hopper: bytes.  Each (a, v, valid d) reads one k-wide
// row of bi and does k adds, far below the card's f32 rate per byte.  The
// function must write alpha*N*k*4 bytes, read inc once and read the table
// rows the incidence references (L2-resident when alpha*M*k*4 <= 50 MB;
// at ibm08, k = 64 and alpha = 7 the tables are 92 MB, but the rows are
// walked member by member, and one member's 13 MB stays in L2 while its
// pins gather it, about 2.7 times per row).  There is no reduction across
// threads: each output element is owned by one thread, the loop over d
// runs in ascending order and there are no atomics, so the result is
// deterministic (and, with the integer-valued tables of the partitioner,
// bit-equal to any summation order).
//
// Design.  The TPU split table/stream existed because of VMEM; here the
// tables come from device memory or L2 either way, and what changes with
// k is the mapping to threads:
//  * table  (k <= 32): one warp per (member, vertex) row, lanes over j.
//    Reads of a bi row are coalesced across the lanes; the edge ids are
//    one broadcast load per d.
//  * stream (k > 32, up to 1024): one group of G = 8, 16 or 32 lanes per
//    (member, vertex) row, the lanes over the columns with VEC = 4 (or 2,
//    or 1, as k's alignment allows) columns each, so a table row arrives
//    as 16-byte loads; G is the smallest that covers k in one pass, up to
//    32 (k = 64: G = 16, two rows a warp; k = 1024: 8 passes of 128).  The
//    group reads its incidence row once, coalesced, and a ballot of the
//    valid slots drives the loop: only valid slots are visited, in
//    ascending d, each edge id broadcast by a shuffle.  Every lane also
//    adds wi over the same slots (one broadcast load), so the loss needs
//    no serial phase, no shared memory and no block barrier, and there is
//    no limit on D.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void gain_table_kernel(const int32_t* __restrict__ inc,
                                  const float* __restrict__ bi,
                                  const float* __restrict__ wi,
                                  float* __restrict__ out,
                                  int alpha, int n, int d, int m, int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= (long long)alpha * n) return;
  const int a = (int)(row / n);
  const int v = (int)(row - (long long)a * n);
  const int32_t* irow = inc + (long long)v * d;
  const float* bia = bi + (long long)a * m * k;
  const float* wia = wi + (long long)a * m;
  float loss = 0.f;
  for (int dd = 0; dd < d; ++dd) {
    const int e = irow[dd];
    if (e >= 0) loss += wia[e];
  }
  float* orow = out + row * k;
  for (int j = lane; j < k; j += 32) {
    float acc = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      const int e = irow[dd];
      if (e >= 0) acc += bia[(long long)e * k + j];
    }
    orow[j] = acc - loss;
  }
}

template <int N> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static void add(T& a, T b) { a += b; }
  __device__ static T zero() { return 0.f; }
  __device__ static T sub(T a, float l) { return a - l; }
};
template <> struct Vec<2> {
  using T = float2;
  __device__ static void add(T& a, T b) { a.x += b.x; a.y += b.y; }
  __device__ static T zero() { return make_float2(0.f, 0.f); }
  __device__ static T sub(T a, float l) { return make_float2(a.x - l, a.y - l); }
};
template <> struct Vec<4> {
  using T = float4;
  __device__ static void add(T& a, T b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T sub(T a, float l) {
    return make_float4(a.x - l, a.y - l, a.z - l, a.w - l);
  }
};

// G lanes per (member, vertex) row, VEC columns per lane and pass.
template <int VEC, int G>
__global__ void __launch_bounds__(256)
gain_stream_kernel(const int32_t* __restrict__ inc,
                   const float* __restrict__ bi, const float* __restrict__ wi,
                   float* __restrict__ out, int alpha, int n, int d, int m,
                   int k) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;                      // lane within the row's group
  const unsigned gbits =
      G == 32 ? FULL : ((1u << (G % 32)) - 1u) << (lane - gl);
  const long long rows = (long long)alpha * n;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if ((first - lane) / G >= rows) return;       // the whole warp is past
  const long long row = first / G;
  const bool live = row < rows;
  const int a = live ? (int)(row / n) : 0;
  const int v = live ? (int)(row - (long long)a * n) : 0;
  const int32_t* irow = inc + (long long)v * d;
  const float* bia = bi + (long long)a * m * k;
  const float* wia = wi + (long long)a * m;
  float* orow = out + row * k;
  float loss = 0.f;
  for (int j0 = 0; j0 < k; j0 += G * VEC) {
    const int j = j0 + gl * VEC;
    const bool col = live && j < k;
    T acc = V::zero();
    for (int d0 = 0; d0 < d; d0 += G) {
      const int e = live && d0 + gl < d ? irow[d0 + gl] : -1;
      unsigned slots = __ballot_sync(FULL, e >= 0) & gbits;
      const int steps = __reduce_max_sync(FULL, __popc(slots));
      for (int i = 0; i < steps; ++i) {
        const int src = slots ? __ffs(slots) - 1 : lane;
        const int eb = __shfl_sync(FULL, e, src);
        if (slots) {
          slots &= slots - 1;
          if (j0 == 0) loss += wia[eb];
          if (col) V::add(acc, *reinterpret_cast<const T*>(
                                   bia + (long long)eb * k + j));
        }
      }
    }
    if (col) *reinterpret_cast<T*>(orow + j) = V::sub(acc, loss);
  }
}

}  // namespace

extern "C" int gain_table_launch(const void* inc, const void* bi,
                                 const void* wi, void* out, int alpha, int n,
                                 int d, int m, int k, int threads,
                                 void* stream) {
  const long long rows = (long long)alpha * n;
  const int rows_per_block = threads / 32;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  gain_table_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)inc, (const float*)bi, (const float*)wi, (float*)out,
      alpha, n, d, m, k);
  return (int)cudaGetLastError();
}

namespace {

template <int VEC, int G>
int stream_launch(const int32_t* inc, const float* bi, const float* wi,
                  float* out, int alpha, int n, int d, int m, int k,
                  int threads, cudaStream_t stream) {
  const long long lanes = (long long)alpha * n * G;
  const long long blocks = (lanes + threads - 1) / threads;
  gain_stream_kernel<VEC, G><<<(unsigned)blocks, threads, 0, stream>>>(
      inc, bi, wi, out, alpha, n, d, m, k);
  return (int)cudaGetLastError();
}

template <int VEC>
int stream_launch_vec(const int32_t* inc, const float* bi, const float* wi,
                      float* out, int alpha, int n, int d, int m, int k,
                      int threads, cudaStream_t stream) {
  const int lanes_needed = (k + VEC - 1) / VEC;
  if (lanes_needed <= 8)
    return stream_launch<VEC, 8>(inc, bi, wi, out, alpha, n, d, m, k,
                                 threads, stream);
  if (lanes_needed <= 16)
    return stream_launch<VEC, 16>(inc, bi, wi, out, alpha, n, d, m, k,
                                  threads, stream);
  return stream_launch<VEC, 32>(inc, bi, wi, out, alpha, n, d, m, k, threads,
                                stream);
}

}  // namespace

// threads: a multiple of 32.  VEC is the widest of 4, 2, 1 that divides
// k and the alignment of bi and out.
extern "C" int gain_stream_launch(const void* inc, const void* bi,
                                  const void* wi, void* out, int alpha, int n,
                                  int d, int m, int k, int threads,
                                  void* stream) {
  if (threads <= 0 || threads % 32 != 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)bi | (uintptr_t)out;
  const int32_t* ip = (const int32_t*)inc;
  const float* bp = (const float*)bi;
  const float* wp = (const float*)wi;
  float* op = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (k % 4 == 0 && align % 16 == 0)
    return stream_launch_vec<4>(ip, bp, wp, op, alpha, n, d, m, k, threads,
                                st);
  if (k % 2 == 0 && align % 8 == 0)
    return stream_launch_vec<2>(ip, bp, wp, op, alpha, n, d, m, k, threads,
                                st);
  return stream_launch_vec<1>(ip, bp, wp, op, alpha, n, d, m, k, threads, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
