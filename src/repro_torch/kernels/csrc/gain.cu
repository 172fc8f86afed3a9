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
// rows the incidence references (L2-resident when alpha*M*k*4 <= 50 MB).
// There is no reduction across threads: each output element is owned by
// one thread, the loop over d runs in a fixed order and there are no
// atomics, so the result is deterministic (and, with the integer-valued
// tables of the partitioner, bit-equal to any summation order).
//
// Design.  The TPU split table/stream existed because of VMEM; here the
// tables come from device memory or L2 either way, and what changes with
// k is the mapping to threads:
//  * table  (k <= 32): one warp per (member, vertex) row, lanes over j.
//    Reads of a bi row are coalesced across the lanes; the edge ids are
//    one broadcast load per d.
//  * stream (k > 32, up to 1024): one block per (member, tile of vertices).
//    The tile's edge-id rows are staged once in shared memory, the
//    per-vertex loss is computed once, and the block's threads stride over
//    the tile's (vertex, column) pairs, coalesced over j.
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

__global__ void gain_stream_kernel(const int32_t* __restrict__ inc,
                                   const float* __restrict__ bi,
                                   const float* __restrict__ wi,
                                   float* __restrict__ out,
                                   int n, int d, int m, int k, int tile) {
  extern __shared__ int32_t s_inc[];               // [tile * d]
  float* s_loss = reinterpret_cast<float*>(s_inc + tile * d);  // [tile]
  const int a = blockIdx.y;
  const int v0 = blockIdx.x * tile;
  const int nv = min(tile, n - v0);
  const float* bia = bi + (long long)a * m * k;
  const float* wia = wi + (long long)a * m;
  const int32_t* itile = inc + (long long)v0 * d;
  for (int i = threadIdx.x; i < nv * d; i += blockDim.x) s_inc[i] = itile[i];
  __syncthreads();
  for (int vl = threadIdx.x; vl < nv; vl += blockDim.x) {
    float loss = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      const int e = s_inc[vl * d + dd];
      if (e >= 0) loss += wia[e];
    }
    s_loss[vl] = loss;
  }
  __syncthreads();
  float* otile = out + ((long long)a * n + v0) * k;
  const int total = nv * k;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int vl = idx / k;
    const int j = idx - vl * k;
    const int32_t* r = s_inc + vl * d;
    float acc = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      const int e = r[dd];
      if (e >= 0) acc += bia[(long long)e * k + j];
    }
    otile[idx] = acc - s_loss[vl];
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

extern "C" int gain_stream_launch(const void* inc, const void* bi,
                                  const void* wi, void* out, int alpha, int n,
                                  int d, int m, int k, int tile, int threads,
                                  void* stream) {
  const dim3 grid((unsigned)((n + tile - 1) / tile), (unsigned)alpha);
  const size_t smem = (size_t)tile * (d + 1) * sizeof(int32_t);
  gain_stream_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)inc, (const float*)bi, (const float*)wi, (float*)out,
      n, d, m, k, tile);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
