// Sorted-segment sum of the device coarsener's pair ratings and of the
// mutation cohort's per-member rows.
//
// Replaces the TPU kernels repro/kernels/rating.py::rating_scatter_pallas
// (scalar entry) and ::rating_scatter_batch_pallas (batched entry):
//
//   out[a, s] = sum of vals[a, c] over segs[c] == s   (segs ascending,
//                                                      ids outside [0, S)
//                                                      dropped)
//
// with vals[R, C] f32 (R = 1 for the scalar entry), one shared segs[C]
// int32 and out[R, S] f32; ids with no candidate get 0.  The Pallas
// kernels are a one-hot matmul over a dense (segment x candidate) grid,
// quadratic in C, which only the TPU's MXU makes affordable.  Here the
// reduction is linear and has no float atomics: the order of every sum
// depends only on segs, C and the constants below, so reruns give the
// same bits, and each row of the batch is summed by the same program as
// the scalar entry, so it equals the scalar entry on that row bit for bit.
//
// What bounds it on Hopper: bytes (vals and out once, segs once per row
// group; one add per candidate).  Two callers set the shapes: the
// coarsener and the cohort's pair ratings (C about 10^6, R <= 7, the
// ghost pairs' run of zeros 87% of C long at ibm08, and the ids after the
// last pair's zeroed), and mutation's graphed FM steps (R = alpha *
// (k + 1) = 119 rows of 16,384 pins, the ghost vertex's run of pad pins
// last), where each call is a node of a CUDA graph and the parent design's
// level chain, memset and scratch cost more than the payload.
//
// Design: two launches per call, whatever C, no memset, no float atomics.
//
// Pass 1 (segsum_tiles): a block of 8 warps owns a tile of 1,024
// consecutive candidates and ROWS rows; each lane owns 4 consecutive
// candidates, read as one 16-byte load of ids and one of each row's values.
//  * The lane adds its candidates in order, starting afresh at each
//    segment start.  A segment that ends inside the lane where it began is
//    written from there.
//  * A segmented scan over the warp's lanes (5 shuffle steps, whose shape
//    depends on the starts alone) gives each lane the part of its first
//    segment that lies in the lanes before it; the warps' open parts are
//    exchanged in shared memory and added in warp order.  So a segment
//    ending in the tile is written by the lane where it ends, without a
//    walk or a second barrier, whatever its length.
//  * A segment that began before the tile leaves its part as the tile's
//    head piece, one that goes on after it as the tile's tail piece, in
//    scratch.
//  * Each start also writes the zeros of the ids between its segment's
//    id and the previous one; the ids after the last valid one are
//    zeroed by all the blocks of a row group, a slice each.
// Pass 2 (segsum_carry): one warp per 32 tiles and row.  A segment that
// crosses one tile edge (most that cross one: a vertex's pins, a pair's
// candidates) is finished by the lane of its first tile, tail piece plus
// head piece.  For a longer one the warp adds the later tiles' head
// pieces, 16 x 32 at a time, each 32 through a fixed xor tree, in tile
// order: a run of length L costs L / (512 * 1,024) steps, 2 for the ghost
// pairs at C = 10^6.
//
// The order of every sum is fixed by segs and C: in order within a lane,
// then a fixed scan tree over lanes, warp order over warps and batches of
// trees over tiles.  The rows do not mix, so a row of the batch has the
// bits of the scalar entry on that row.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// "no piece" id in the tile scratch; valid ids are >= 0
constexpr int NONE = INT_MIN;
// consecutive candidates of one lane (one 16-byte load of ids and of
// each row's values), warps of a pass-1 block, and candidates of a tile
constexpr int ITEMS = 4;
constexpr int TILE_WARPS = 8;
constexpr int TILE = 32 * ITEMS * TILE_WARPS;
// tile pieces pass 2 reads at once: 16 batches of 32
constexpr int CARRY_BATCHES = 16;

// id at position q: q < 0 reads as below every id, q >= c as above
__device__ __forceinline__ int seg_at(const int32_t* __restrict__ segs,
                                      long long q, int c) {
  if (q < 0) return INT_MIN;
  if (q >= c) return INT_MAX;
  return segs[q];
}

__device__ __forceinline__ float warp_tree_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// First id after the last valid one (``last`` = segs[c - 1]): ids in
// [return, s) have no candidate.
__device__ int trailing_gap_start(const int32_t* __restrict__ segs, int c,
                                  int s, int last) {
  if (last >= s) {  // trailing ids >= s: find the first of them
    int lo = 0, hi = c - 1;
    while (lo < hi) {
      const int mid = lo + (hi - lo) / 2;
      if (segs[mid] >= s) hi = mid; else lo = mid + 1;
    }
    if (lo == 0) return 0;
    last = segs[lo - 1];
  }
  return last < 0 ? 0 : last + 1;
}

// Pass 1.  blockIdx.x = tile, blockIdx.y = row group (rows ROWS * y ..).
// piece[row][2 * t] is tile t's head piece (the part in the tile of a
// segment that began before it), piece[row][2 * t + 1] its tail piece
// (the part of a segment that begins in the tile and goes on after it);
// tail_id[t] is the tail piece's id or NONE.  vec: segs and vals rows
// may be read as 16-byte vectors (c % 4 == 0, both 16-byte aligned).
template <int ROWS>
__global__ void __launch_bounds__(32 * TILE_WARPS, 4)
segsum_tiles(const int32_t* __restrict__ segs, const float* __restrict__ vals,
             int c, int nrows, int s, float* __restrict__ out,
             float* __restrict__ piece, int32_t* __restrict__ tail_id,
             int ntiles, bool vec) {
  __shared__ float s_tail[ROWS][TILE_WARPS];  // each warp's open segment
  __shared__ int s_start[TILE_WARPS];         // whether a warp has a start
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int t = blockIdx.x;
  const int row0 = blockIdx.y * ROWS;
  const int nr = min(ROWS, nrows - row0);
  const long long tile_base = (long long)t * TILE;
  const long long q0 = tile_base + (long long)(w * 32 + lane) * ITEMS;
  const bool tile_last_lane = w == TILE_WARPS - 1 && lane == 31;

  // One round trip for everything: the ids at q0 - 1 .. q0 + ITEMS, the
  // last id (for the trailing zeros) and the lane's values of each row.
  int id[ITEMS + 2];
  id[0] = seg_at(segs, q0 - 1, c);
  id[ITEMS + 1] = seg_at(segs, q0 + ITEMS, c);
  if (vec && q0 < c) {
    const int4 x = *reinterpret_cast<const int4*>(segs + q0);
    id[1] = x.x; id[2] = x.y; id[3] = x.z; id[4] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) id[i + 1] = seg_at(segs, q0 + i, c);
  }
  const int id_last = segs[c - 1];
  float v[ROWS][ITEMS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float* row = vals + (long long)(row0 + r) * c;
    if (vec && q0 < c && r < nr) {
      const float4 x = *reinterpret_cast<const float4*>(row + q0);
      v[r][0] = x.x; v[r][1] = x.y; v[r][2] = x.z; v[r][3] = x.w;
    } else {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        v[r][i] = r < nr && q0 + i < c ? row[q0 + i] : 0.f;
    }
  }

  // bit i of st: position q0 + i starts a segment (q == 0, q >= c, or an
  // id change); bit ITEMS is the next lane's first position
  unsigned st = 0;
#pragma unroll
  for (int i = 0; i <= ITEMS; ++i) {
    const long long q = q0 + i;
    if (q == 0 || q >= c || id[i + 1] != id[i]) st |= 1u << i;
  }
  const bool has_start = (st & ((1u << ITEMS) - 1)) != 0;
  const unsigned warp_starts = __ballot_sync(FULL, has_start);
  // G: a lane before this one in the warp holds a start
  const bool g = (warp_starts & ((1u << lane) - 1)) != 0;
  // the steps of a segmented inclusive scan over the lanes, fixed by the
  // starts alone: at step d a lane adds the value d lanes back unless a
  // start lies in between
  unsigned take = 0;
  {
    bool f = has_start;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int d = 1 << k;
      const bool fu = __shfl_up_sync(FULL, f, d);
      if (lane >= d && !f) take |= 1u << k;
      if (lane >= d) f = f || fu;
    }
  }

  // per row: the lane's open tail (from its last start, or all of it),
  // then the scan: y = the open segment's sum from its start in the warp
  // (or the warp's first lane) to this lane's end
  float y[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      run = ((st >> i) & 1u) || i == 0 ? v[r][i] : run + v[r][i];
    float x = run;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float up = __shfl_up_sync(FULL, x, 1 << k);
      if ((take >> k) & 1u) x = up + x;
    }
    y[r] = x;
    if (lane == 31) s_tail[r][w] = x;
  }
  if (lane == 31) s_start[w] = warp_starts != 0;
  __syncthreads();

  // the part of the lane's first segment before it: e = the scan up to the
  // lane before, plus (when no lane before it in the warp has a start)
  // the part in earlier warps of the tile, added in warp order
  bool tile_start_before = false;   // a start in an earlier warp
#pragma unroll
  for (int k = 0; k < TILE_WARPS - 1; ++k)
    if (k < w && s_start[k]) tile_start_before = true;
  const bool first_before_tile = !g && !tile_start_before && !(st & 1u);
  int tid = NONE;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float e = __shfl_up_sync(FULL, y[r], 1);
    if (lane == 0) e = 0.f;
    if (!g) {
      float wsum = 0.f;
#pragma unroll
      for (int k = 0; k < TILE_WARPS - 1; ++k) {
        if (k < w) wsum = s_start[k] ? s_tail[r][k] : wsum + s_tail[r][k];
      }
      e = wsum + e;
    }
    if (r >= nr) continue;
    float* orow = out + (long long)(row0 + r) * s;
    float* prow = piece + (long long)(row0 + r) * 2 * ntiles;
    float run = 0.f;
    bool own = false;   // the open segment began in this lane
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const bool start_i = (st >> i) & 1u;
      if (start_i || i == 0) run = v[r][i]; else run = run + v[r][i];
      own = own || start_i;
      const bool ends = (st >> (i + 1)) & 1u;
      const bool last = tile_last_lane && i == ITEMS - 1;
      const int sid = id[i + 1];
      if ((ends || last) && q0 + i < c && sid >= 0 && sid < s) {
        const float total = own ? run : e + run;
        if (!own && first_before_tile) {
          prow[2 * t] = total;                 // began before the tile
        } else if (!ends) {
          prow[2 * t + 1] = total;             // goes on after the tile
          tid = sid;
        } else {
          orow[sid] = total;
        }
      }
    }
  }
  if (tile_last_lane && blockIdx.y == 0) tail_id[t] = tid;

  // zeros of the ids skipped before each start's id (not the trailing ids
  // after the last valid one: those are sliced over the grid below)
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    int glo = 0, ghi = 0;
    const int cur = id[i + 1];
    if (((st >> i) & 1u) && q0 + i < c && cur > 0 && cur < s) {
      glo = (q0 + i == 0 ? -1 : max(id[i], -1)) + 1;
      ghi = cur;
    }
    if (ghi - glo <= 32) {
      for (int x = glo; x < ghi; ++x) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (r < nr) out[(long long)(row0 + r) * s + x] = 0.f;
      }
    }
    unsigned wide = __ballot_sync(FULL, ghi - glo > 32);
    while (wide) {
      const int src = __ffs(wide) - 1;
      wide &= wide - 1;
      const int lo = __shfl_sync(FULL, glo, src);
      const int hi = __shfl_sync(FULL, ghi, src);
      for (int x = lo + lane; x < hi; x += 32) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (r < nr) out[(long long)(row0 + r) * s + x] = 0.f;
      }
    }
  }

  // the trailing ids, a slice per tile
  const int tg = trailing_gap_start(segs, c, s, id_last);
  const long long span = ((long long)s - tg + ntiles - 1) / ntiles;
  const long long lo = tg + span * t;
  const long long hi = min((long long)s, lo + span);
  for (long long x = lo + threadIdx.x; x < hi; x += blockDim.x) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < nr) out[(long long)(row0 + r) * s + x] = 0.f;
  }
}

// Pass 2.  blockIdx.x = group of 32 tiles (lane = tile), blockIdx.y = row.
__global__ void __launch_bounds__(32)
segsum_carry(const int32_t* __restrict__ segs, int c, int s, int tile,
             float* __restrict__ out, const float* __restrict__ piece,
             const int32_t* __restrict__ tail_id, int ntiles) {
  const int lane = threadIdx.x;
  const int row = blockIdx.y;
  const int t = blockIdx.x * 32 + lane;
  const int id = t < ntiles ? tail_id[t] : NONE;
  const float* prow = piece + (long long)row * 2 * ntiles;
  // a segment that ends in the next tile: the lane adds the two pieces
  // (what the warp's batches below would add, with no other piece)
  const long long after = (long long)(t + 2) * tile;
  const bool short_run =
      id != NONE && !(after < c && t + 2 < ntiles && segs[after] == id);
  if (short_run)
    out[(long long)row * s + id] = prow[2 * t + 1] + prow[2 * (t + 1)];
  unsigned owners = __ballot_sync(FULL, id != NONE && !short_run);
  while (owners) {
    const int src = __ffs(owners) - 1;
    owners &= owners - 1;
    const int seg = __shfl_sync(FULL, id, src);
    const int t0 = blockIdx.x * 32 + src;
    float sum = prow[2 * t0 + 1];
    bool more = true;
    for (long long next = t0 + 1; more; next += 32 * CARRY_BATCHES) {
      // later tiles whose first candidate is in the segment (a prefix of
      // the tiles, segs being ascending), CARRY_BATCHES batches of 32
      // loaded at once and added batch by batch
      float h[CARRY_BATCHES];
      bool in[CARRY_BATCHES];
#pragma unroll
      for (int b = 0; b < CARRY_BATCHES; ++b) {
        const long long q = next + 32 * b + lane;
        const bool ok = q < ntiles && q * tile < c;
        const int qid = ok ? segs[q * tile] : NONE;
        const float hv = ok ? prow[2 * q] : 0.f;
        in[b] = ok && qid == seg;
        h[b] = in[b] ? hv : 0.f;
      }
#pragma unroll
      for (int b = 0; b < CARRY_BATCHES; ++b) {
        if (!more) break;
        sum += warp_tree_sum(h[b]);
        more = __ballot_sync(FULL, in[b]) == FULL;
      }
    }
    if (lane == 0) out[(long long)row * s + seg] = sum;
  }
}

template <int ROWS>
int launch_rows(const int32_t* segs, const float* vals, int c, int nrows,
                int s, float* out, float* piece, int32_t* tail_id,
                cudaStream_t stream) {
  const int ntiles = (int)(((long long)c + TILE) / TILE);  // covers c itself
  const bool vec = c % 4 == 0 && (uintptr_t)segs % 16 == 0 &&
                   (uintptr_t)vals % 16 == 0;
  const dim3 grid1((unsigned)ntiles, (unsigned)((nrows + ROWS - 1) / ROWS));
  segsum_tiles<ROWS><<<grid1, 32 * TILE_WARPS, 0, stream>>>(
      segs, vals, c, nrows, s, out, piece, tail_id, ntiles, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((unsigned)((ntiles + 31) / 32), (unsigned)nrows);
  segsum_carry<<<grid2, 32, 0, stream>>>(segs, c, s, TILE, out, piece,
                                         tail_id, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

// vals [nrows, c] (row stride c), one shared segs [c], out [nrows, s]
// (every entry written).  Scratch: piece [nrows, 2 * ntiles] f32 and
// tail_id [ntiles] int32, ntiles = c / tile + 1.  tile must be TILE (the
// caller sizes the scratch with it); rows: the most rows one pass-1 block
// sums (1, 2 or 4), fewer when nrows is smaller.
extern "C" int rating_segsum_launch(const void* segs, const void* vals,
                                    int nrows, int c, void* out, int s,
                                    void* piece, void* tail_id, int tile,
                                    int rows, void* stream) {
  if (c <= 0 || s <= 0 || nrows <= 0 || nrows > 65535 || tile != TILE)
    return (int)cudaErrorInvalidValue;
  const int32_t* sp = (const int32_t*)segs;
  const float* vp = (const float*)vals;
  float* op = (float*)out;
  float* pp = (float*)piece;
  int32_t* tp = (int32_t*)tail_id;
  cudaStream_t st = (cudaStream_t)stream;
  while (rows > 1 && rows / 2 >= nrows) rows /= 2;
  switch (rows) {
    case 1: return launch_rows<1>(sp, vp, c, nrows, s, op, pp, tp, st);
    case 2: return launch_rows<2>(sp, vp, c, nrows, s, op, pp, tp, st);
    case 4: return launch_rows<4>(sp, vp, c, nrows, s, op, pp, tp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
