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
// pins gather it, about 2.7 times per row).  The incidence is sparse: at
// ibm01 a row has 3.0 valid slots of D = 16, so a walk over D costs five
// times the work.  There is no reduction across threads: each output
// element is owned by one thread, the loop over d runs in ascending order
// and there are no atomics, so the result is deterministic (and, with the
// integer-valued tables of the partitioner, bit-equal to any summation
// order).
//
// Design.  The TPU split table/stream existed because of VMEM; here the
// tables come from device memory or L2 either way, and both entries run
// one kernel.  A group of G lanes owns one (member, vertex) row, with VEC
// = 4, 2 or 1 columns a lane (the widest that k's and the pointers'
// alignment allow), so a table row and an output row move as 16-byte
// accesses.  G is the smallest power of two that covers k in one pass, up
// to 32: k = 16 takes 4 lanes (8 rows a warp), k = 32 takes 8, k = 1, 2
// or 4 one lane, k = 1024 32 lanes in 8 passes; no lane idles at k = 16
// or 32.  The group reads its incidence row in rounds of G*SV slots:
// SV = 4 ids a lane (one 16-byte load where D and the pointer allow) for
// G <= 8, one for G >= 16, so D = 16 is one round at G = 4.  The group's
// valid slots of a round form one 32-bit mask (a ballot, or each lane's
// 4 bits OR-ed across the group by shuffles) that drives the loop: only
// valid slots are visited, in ascending d, each edge id broadcast by a
// shuffle.  Every lane also adds wi over the same slots (one broadcast
// load), so the loss needs no serial phase, no shared memory and no block
// barrier, and there is no limit on D.  Issuing the table loads of 4
// slots before their adds cost registers (43 against 32 at k = 64, so
// fewer warps an SM) and made the k = 64 entry slower on the H100.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

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

// SV incidence slots a lane holds per round.
template <int SV> struct Ids;
template <> struct Ids<1> {
  using T = int;
  __device__ static T load(const int32_t* p, int left, bool) {
    return left > 0 ? *p : -1;
  }
  __device__ static int get(T e, int) { return e; }
};
template <> struct Ids<4> {
  using T = int4;
  // ``left`` slots of the row remain from p on; ``wide``: p is 16-byte
  // aligned and D % 4 == 0, so the 4 slots are one load
  __device__ static T load(const int32_t* p, int left, bool wide) {
    if (wide && left > 0) return *reinterpret_cast<const int4*>(p);
    return make_int4(left > 0 ? p[0] : -1, left > 1 ? p[1] : -1,
                     left > 2 ? p[2] : -1, left > 3 ? p[3] : -1);
  }
  __device__ static int get(T e, int s) {
    return s == 0 ? e.x : s == 1 ? e.y : s == 2 ? e.z : e.w;
  }
  __device__ static unsigned valid(T e) {
    return (unsigned)(e.x >= 0) | (unsigned)(e.y >= 0) << 1 |
           (unsigned)(e.z >= 0) << 2 | (unsigned)(e.w >= 0) << 3;
  }
};

// G lanes per (member, vertex) row, VEC columns per lane and pass.
template <int VEC, int G>
__global__ void __launch_bounds__(256)
gain_kernel(const int32_t* __restrict__ inc, const float* __restrict__ bi,
            const float* __restrict__ wi, float* __restrict__ out, int alpha,
            int n, int d, int m, int k, bool wide_ids) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr int SV = G <= 8 ? 4 : 1;
  using I = Ids<SV>;
  constexpr int ROUND = G * SV;                 // slots a round reads
  static_assert(ROUND <= 32, "a round's slots must fit one mask");
  constexpr unsigned FULL = 0xffffffffu;
  constexpr unsigned GMASK = G == 32 ? FULL : (1u << (G % 32)) - 1u;
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;                      // lane within the row's group
  const int base = lane - gl;                   // the group's first lane
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
    for (int d0 = 0; d0 < d; d0 += ROUND) {
      const int dl = d0 + gl * SV;
      const typename I::T e = I::load(irow + dl, live ? d - dl : 0, wide_ids);
      // bit b of slots: slot d0 + b of the row is valid
      unsigned slots;
      if constexpr (SV == 1) {
        slots = (__ballot_sync(FULL, e >= 0) >> base) & GMASK;
      } else {
        slots = I::valid(e) << (gl * SV);
#pragma unroll
        for (int off = 1; off < G; off <<= 1)
          slots |= __shfl_xor_sync(FULL, slots, off);
      }
      const int steps = __reduce_max_sync(FULL, __popc(slots));
      for (int i = 0; i < steps; ++i) {
        const int b = slots ? __ffs(slots) - 1 : 0;
        const int eb = __shfl_sync(FULL, I::get(e, b % SV), base + b / SV);
        const bool has = slots != 0;
        slots &= slots - 1;
        // the loads go out predicated, ahead of the branch that adds them
        // (the form timed on the H100)
        const T part = has && col ? *reinterpret_cast<const T*>(
                                        bia + (long long)eb * k + j)
                                  : V::zero();
        const float w = has && j0 == 0 ? wia[eb] : 0.f;
        if (has) {
          V::add(acc, part);
          if (j0 == 0) loss += w;
        }
      }
    }
    if (col) *reinterpret_cast<T*>(orow + j) = V::sub(acc, loss);
  }
}

template <int VEC, int G>
int launch(const int32_t* inc, const float* bi, const float* wi, float* out,
           int alpha, int n, int d, int m, int k, bool wide_ids, int threads,
           cudaStream_t stream) {
  const long long lanes = (long long)alpha * n * G;
  const long long blocks = (lanes + threads - 1) / threads;
  gain_kernel<VEC, G><<<(unsigned)blocks, threads, 0, stream>>>(
      inc, bi, wi, out, alpha, n, d, m, k, wide_ids);
  return (int)cudaGetLastError();
}

// G: the smallest power of two from G up that covers k's columns at VEC
// a lane, or 32.
template <int VEC, int G = 1>
int launch_vec(const int32_t* inc, const float* bi, const float* wi,
               float* out, int alpha, int n, int d, int m, int k,
               bool wide_ids, int threads, cudaStream_t stream) {
  if constexpr (G < 32) {
    if (G * VEC < k)
      return launch_vec<VEC, 2 * G>(inc, bi, wi, out, alpha, n, d, m, k,
                                    wide_ids, threads, stream);
  }
  return launch<VEC, G>(inc, bi, wi, out, alpha, n, d, m, k, wide_ids,
                        threads, stream);
}

}  // namespace

// Both entries ("table" for k <= 32, "stream" above; the routing is the
// caller's) launch the one kernel.  threads: a multiple of 32.  VEC is
// the widest of 4, 2, 1 that divides k and the alignment of bi and out.
extern "C" int gain_launch(const void* inc, const void* bi, const void* wi,
                           void* out, int alpha, int n, int d, int m, int k,
                           int threads, void* stream) {
  if (threads <= 0 || threads % 32 != 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)bi | (uintptr_t)out;
  const bool wide_ids = d % 4 == 0 && (uintptr_t)inc % 16 == 0;
  const int32_t* ip = (const int32_t*)inc;
  const float* bp = (const float*)bi;
  const float* wp = (const float*)wi;
  float* op = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (k % 4 == 0 && align % 16 == 0)
    return launch_vec<4>(ip, bp, wp, op, alpha, n, d, m, k, wide_ids,
                         threads, st);
  if (k % 2 == 0 && align % 8 == 0)
    return launch_vec<2>(ip, bp, wp, op, alpha, n, d, m, k, wide_ids,
                         threads, st);
  return launch_vec<1>(ip, bp, wp, op, alpha, n, d, m, k, wide_ids, threads,
                       st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
