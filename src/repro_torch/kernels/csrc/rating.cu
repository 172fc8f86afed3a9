// Sorted-segment sum of the device coarsener's pair ratings.
//
// Replaces the TPU kernel repro/kernels/rating.py::rating_scatter_pallas:
//
//   out[s] = sum of vals[c] over segs[c] == s   (segs ascending,
//                                                 ids outside [0, S) dropped)
//
// with vals[C] f32, segs[C] int32; out[S] must arrive zeroed (segments
// with no candidate stay 0).
//
// What bounds it on Hopper: bytes (8 bytes read per candidate, one add).
// The Pallas kernel is a one-hot matmul over a dense (segment x candidate)
// grid, quadratic in C, which only the TPU's MXU makes affordable; here
// the reduction is linear and deterministic, without float atomics.
//
// Design: a segmented reduction over fixed chunks, applied level by level.
// One thread reduces `chunk` consecutive candidates in order.  A run of
// equal ids that lies inside the chunk and does not touch a chunk edge
// that it continues across is complete: the thread writes its sum (each
// segment has exactly one writer).  The at most two pieces that continue
// into the neighbouring chunks are emitted, in order, as (id, partial)
// pairs into the next level's arrays, which keep equal ids contiguous;
// the next level reduces those the same way.  Every level shrinks the
// problem chunk/2-fold, and the last level is a single chunk, where every
// piece is complete.  The summation order depends only on C and `chunk`,
// so reruns are bit-identical, and a long run (the ghost pairs, about half
// of C) is split over many threads instead of being walked by one.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

__global__ void segsum_level_kernel(const int32_t* __restrict__ segs,
                                    const float* __restrict__ vals, int c,
                                    int chunk, float* __restrict__ out, int s,
                                    int32_t* __restrict__ seg_next,
                                    float* __restrict__ val_next) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int nchunks = (c + chunk - 1) / chunk;
  if (t >= nchunks) return;
  const int lo = t * chunk;
  const int hi = min(lo + chunk, c);
  const int prev = lo > 0 ? segs[lo - 1] : INT_MIN;
  const int next = hi < c ? segs[hi] : INT_MIN;
  // the two pieces handed to the next level: (-1, 0) = nothing
  int e0s = -1, e1s = -1;
  float e0v = 0.f, e1v = 0.f;
  int cur = segs[lo];
  float acc = vals[lo];
  int start = lo;
  for (int i = lo + 1; i <= hi; ++i) {
    const int sg = i < hi ? segs[i] : INT_MIN;
    if (i < hi && sg == cur) {
      acc += vals[i];
      continue;
    }
    // the piece [start, i) of id `cur` ends here
    if (cur >= 0) {
      const bool open_l = (start == lo) && (prev == cur);
      const bool open_r = (i == hi) && (next == cur);
      if (!open_l && !open_r) {
        if (cur < s) out[cur] = acc;
      } else if (start == lo && i == hi) {
        // the whole chunk is one open piece: (id, 0) keeps the id's
        // entries contiguous in the next level
        e0s = cur; e0v = acc; e1s = cur; e1v = 0.f;
      } else if (open_l) {
        e0s = cur; e0v = acc;
      } else {
        e1s = cur; e1v = acc;
      }
    }
    if (i < hi) {
      cur = sg;
      acc = vals[i];
      start = i;
    }
  }
  seg_next[2 * t] = e0s;
  val_next[2 * t] = e0v;
  seg_next[2 * t + 1] = e1s;
  val_next[2 * t + 1] = e1v;
}

}  // namespace

// Scratch: seg_a/val_a and seg_b/val_b each hold 2 * ceil(c / chunk)
// entries; the levels ping-pong between them.
extern "C" int rating_segsum_launch(const void* segs, const void* vals, int c,
                                    void* out, int s, void* seg_a,
                                    void* val_a, void* seg_b, void* val_b,
                                    int chunk, int threads, void* stream) {
  // each level must shrink the problem: 2 * ceil(c / chunk) < c needs
  // chunk >= 4 once c > chunk
  if (chunk < 4 || c <= 0) return (int)cudaErrorInvalidValue;
  const int32_t* sp = (const int32_t*)segs;
  const float* vp = (const float*)vals;
  int32_t* seg_buf[2] = {(int32_t*)seg_a, (int32_t*)seg_b};
  float* val_buf[2] = {(float*)val_a, (float*)val_b};
  int which = 0;
  int cc = c;
  while (true) {
    const int nchunks = (cc + chunk - 1) / chunk;
    const int blocks = (nchunks + threads - 1) / threads;
    segsum_level_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        sp, vp, cc, chunk, (float*)out, s, seg_buf[which], val_buf[which]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (nchunks == 1) break;
    sp = seg_buf[which];
    vp = val_buf[which];
    cc = 2 * nchunks;
    which ^= 1;
  }
  return 0;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
